"""The port's concurrency lint (``tpu_cluster_torch.conlint``) against
the reference's (``tpu_cluster/conlint.py``).

Compared exactly: both analyzers' findings (rule, path, line, message,
hint) on the same sources — every inline fixture of the reference's
``tests/test_conlint.py`` (read from that file, never edited), and
seeded violations in copies of real modules of both packages (a guard
renamed to a lock that does not exist, every guard annotation stripped,
a ``with`` lock block dropped, I/O moved under a lock). Then the port's
tool finds both packages clean, agrees with the reference's tool on the
port's package, and its CLI surfaces keep the reference's rcs (0 clean,
1 findings, 2 bad path)."""

import ast
import json
import os
import re
import textwrap

import pytest

from torch_apply_helpers import REPO, run_port_cli
from tpu_cluster import conlint as ref_conlint
from tpu_cluster_torch import conlint


def _reference_fixtures():
    """Every multi-line source literal of the reference's conlint tests,
    in file order."""
    with open(os.path.join(REPO, "tests", "test_conlint.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value and ("def " in node.value
                                            or "class " in node.value):
            out.append((node.lineno, textwrap.dedent(node.value)))
    return sorted(out)


FIXTURES = _reference_fixtures()


def findings_both(source, path="fixture.py"):
    """The port's findings as dicts, after asserting they equal the
    reference's."""
    ref = [f.to_dict() for f in ref_conlint.analyze_source(source, path)]
    port = [f.to_dict() for f in conlint.analyze_source(source, path)]
    assert port == ref
    return port


def test_rule_ids_equal_the_reference():
    assert conlint.ALL_RULES == ref_conlint.ALL_RULES
    assert conlint.RULE_PARSE == ref_conlint.RULE_PARSE


@pytest.mark.parametrize("lineno,source", FIXTURES,
                         ids=[f"L{n}" for n, _ in FIXTURES])
def test_reference_fixture_gives_equal_findings(lineno, source):
    findings_both(source)


def test_fixture_corpus_exercises_every_rule():
    fired = {f["rule"] for _, src in FIXTURES for f in findings_both(src)}
    assert set(conlint.ALL_RULES) <= fired
    assert len(FIXTURES) >= 25


def test_unparseable_source_gives_equal_findings():
    assert [f["rule"] for f in findings_both("def broken(:\n", "x.py")] \
        == [conlint.RULE_PARSE]


_MODULES = ["admission.py", "informer.py", "events.py", "metricsdb.py",
            "maintenance.py", "autoscale.py"]


def _mutations(source):
    yield "rename-guard", source.replace("# guarded-by: _lock",
                                         "# guarded-by: _lokc", 1)
    yield "strip-guards", re.sub(r"#\s*guarded-by:[^\n]*", "", source)
    m = re.search(r"\n( +)with self\._lock:\n", source)
    if m:
        indent = m.group(1)
        head, tail = source[:m.start()], source[m.end():]
        lines = tail.split("\n")
        body = []
        while lines and (lines[0].startswith(indent + " ")
                         or not lines[0].strip()):
            body.append(lines.pop(0))
        yield "drop-with", head + "\n" + "\n".join(
            line[4:] if line.strip() else line for line in body) \
            + "\n" + "\n".join(lines)
    yield "io-under-lock", source.replace(
        "with self._lock:\n",
        "with self._lock:\n        open('/dev/null').close()\n", 1)


@pytest.mark.parametrize("package", ["tpu_cluster", "tpu_cluster_torch"])
@pytest.mark.parametrize("module", _MODULES)
def test_seeded_violations_in_real_modules_give_equal_findings(package,
                                                               module):
    path = os.path.join(REPO, package, module)
    with open(path, encoding="utf-8") as f:
        source = f.read()
    assert findings_both(source, module) == []
    fired = 0
    for label, mutated in _mutations(source):
        if mutated == source:
            continue
        fired += bool(findings_both(mutated, module))
    assert fired >= 2, (package, module)


def test_port_tool_finds_both_packages_clean():
    for package in ("tpu_cluster_torch", "tpu_cluster"):
        findings = conlint.analyze_paths([os.path.join(REPO, package)])
        assert findings == [], "\n" + conlint.format_findings(findings)
    ref = ref_conlint.analyze_paths([os.path.join(REPO,
                                                  "tpu_cluster_torch")])
    assert ref == []


def test_cli_default_path_is_the_port_package_and_clean():
    proc = run_port_cli("conlint")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "conlint: clean\n"
    proc = run_port_cli("conlint", "--format", "json")
    assert proc.returncode == 0
    assert json.loads(proc.stdout) == {"ok": True, "findings": []}


def test_cli_on_a_violation_and_a_bad_path(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(dict(FIXTURES)[min(dict(FIXTURES))])
    want = [f.to_dict() for f in ref_conlint.analyze_paths([str(bad)])]
    assert want
    proc = run_port_cli("conlint", bad, "--format", "json")
    assert proc.returncode == 1
    assert json.loads(proc.stdout) == {"ok": False, "findings": want}
    proc = run_port_cli("conlint", bad)
    assert proc.returncode == 1
    assert proc.stderr.rstrip().endswith(f"conlint: {len(want)} finding(s)")
    proc = run_port_cli("conlint", tmp_path / "absent.py")
    assert proc.returncode == 2
    assert "no such path" in proc.stderr


def test_generated_pb2_sources_are_skipped(tmp_path):
    gen = tmp_path / "thing_pb2.py"
    gen.write_text(dict(FIXTURES)[min(dict(FIXTURES))])
    assert conlint.analyze_paths([str(tmp_path)]) == []
