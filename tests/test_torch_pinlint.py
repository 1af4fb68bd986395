"""The port's contract registry and pin analyzer
(``tpu_cluster_torch.contracts``/``pinlint``) against the reference's.

Compared exactly: every contract the two registries share (by name)
has the same value; the port's names that differ are the GPU's
(ConfigMaps, labels, the resource) or its added C++ pins (plurals,
retryable statuses, operand workload kinds) and Event components; both
packages' C++ extractors read the same rows and lines; the harvest finds
what the reference's finds, plus ``nvidia.com/gpu`` names and
``component=`` literals. Each rule PL01-PL06 fires on a seeded drift in
a small temp repo and not on its fix; the port's tree is clean under
``--strict``; a drifted row of a temp copy of
``native/operator/kubeapi.cc`` is a PL01 from both tools, naming the
same C++ line; an undeclared ``*_CONFIGMAP`` in a temp copy of a port
module is a PL04. The tree itself is never touched."""

import json
import os
import shutil
import textwrap

import pytest

from torch_apply_helpers import REPO, run_port_cli
from tpu_cluster import contracts as ref_contracts
from tpu_cluster import pinlint as ref_pinlint
from tpu_cluster_torch import kubeapply, pinlint
from tpu_cluster_torch.contracts import (
    ALL_KINDS, CHAOS_KINDS, Contract, CppPin, Registry, build_registry,
)


def rules(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# the registry


def test_registry_builds_with_unique_names_and_known_kinds():
    reg = build_registry()
    assert len({c.name for c in reg.contracts}) == len(reg.contracts)
    for c in reg.contracts:
        assert c.kind in ALL_KINDS, c.name
        assert c.value, c.name
        assert c.py_file.startswith("tpu_cluster_torch/"), c.name
        assert c.py_file.endswith(".py"), c.name
    tables = reg.cpp_tables()
    for symbol in ("OperatorMetricNames", "OperatorTraceEventNames",
                   "OperandWorkloadKinds"):
        assert ("native/operator/kubeapi.cc", symbol) in tables
    assert set(CHAOS_KINDS) == reg.values("chaos-kind")
    assert {c.cpp.key for c in reg.cpp_map_entries()} == \
        set(kubeapply._KINDS) - {"Node", "CustomResourceDefinition",
                                 "TpuStackPolicy"}
    cases = reg.cpp_case_sets()[("native/operator/kubeclient.cc",
                                 "RetryableStatus")]
    assert {int(c.value) for c in cases} == kubeapply.RETRYABLE_STATUSES


def test_shared_contracts_equal_the_reference_by_name_and_value():
    port = {c.name: c for c in build_registry().contracts}
    ref = {c.name: c for c in ref_contracts.build_registry().contracts}
    shared = set(port) & set(ref)
    assert len(shared) >= 100
    for name in shared:
        assert port[name].value == ref[name].value, name
        assert port[name].kind == ref[name].kind, name
    # what only the reference has: its TPU names, pinned to tpud/TFD
    assert sorted(set(ref) - set(port)) == sorted(
        ["configmap/tpu-autoscale-state", "configmap/tpu-gang-reservations",
         "configmap/tpu-maintenance-state", "configmap/tpu-operator-bundle",
         "resource/tpu"]
        + [n for n in ref if n.startswith("label/google.com/tpu.")])
    # what only the port has: the GPU's names and its added C++ pins
    only_port = set(port) - set(ref)
    assert {n for n in only_port if not n.startswith(
        ("plural/", "retryable-status/", "workload-kind/",
         "event-component/"))} == {
        "configmap/gpu-autoscale-state", "configmap/gpu-gang-reservations",
        "configmap/gpu-maintenance-state", "configmap/gpu-operator-bundle",
        "resource/gpu", "metric/tpu_hbm_used_bytes",
        "label/nvidia.com/gpu.present",
        "label/nvidia.com/gpu.product", "label/nvidia.com/gpu.family",
        "label/nvidia.com/gpu.topology", "label/nvidia.com/gpu.count",
        "label/nvidia.com/gpu.nvlink-domain"}
    # the C++ pins the reference keeps for what the GPU stack still runs
    # (the native operator) stay; none points at tpud or the native TFD
    for name, c in port.items():
        if c.cpp is not None:
            assert c.cpp.file.startswith("native/operator/"), name
        assert not any(e.startswith(("native/plugin/", "native/discovery/"))
                       for e in c.enforcers), name
    for name in shared:
        pin = ref[name].cpp
        if pin is not None and pin.file.startswith("native/operator/"):
            got = port[name].cpp
            assert (got.file, got.symbol, got.index, got.integer) == \
                (pin.file, pin.symbol, pin.index, pin.integer), name


def test_registry_json_dump_round_trips():
    doc = build_registry().to_json()
    assert doc["version"] == 1
    parsed = json.loads(json.dumps(doc))
    assert len(parsed["contracts"]) == len(build_registry().contracts)
    sample = next(c for c in parsed["contracts"]
                  if c["name"] == "configmap/gpu-gang-reservations")
    assert sample["value"] == "gpu-gang-reservations"
    assert "cpp" not in sample
    assert sample["docs"] == ["README.md"]


# ---------------------------------------------------------------------------
# extractors


CPP_FIXTURE = textwrap.dedent("""\
    #include <map>
    #include <string>
    #include <vector>

    // OperandNames() — not a real table, just a comment trap: "ghost"
    const std::vector<std::string>& Names() {
      static const auto* n = new std::vector<std::string>{
          "alpha",          // first
          "beta_\\"quoted\\"",  // escaped quote stays one row
          "gamma",
      };
      return *n;
    }

    const char* Key() { return "state.json"; }
    int Version() { return 3; }

    const std::map<std::string, std::string>& Plurals() {
      static const auto* m = new std::map<std::string, std::string>{
          {"Namespace", "namespaces"},
          // {"Ghost", "ghosts"},
          {"Job",
           "jobs"},
      };
      return *m;
    }

    bool Retryable(int status) {
      switch (status) {
        case 0:    // transport
        case 429:
        case 503:
          return true;
        default:
          return false;  // case 404 is terminal
      }
    }
    """)


def _rows(found):
    if found is None:
        return None
    if isinstance(found, list):
        return [(r.value, r.line) for r in found]
    return (found.value, found.line)


def test_shared_extractors_read_what_the_reference_reads():
    for symbol in ("Names", "NoSuch"):
        assert _rows(pinlint.cpp_string_table(CPP_FIXTURE, symbol)) == \
            _rows(ref_pinlint.cpp_string_table(CPP_FIXTURE, symbol))
    table = pinlint.cpp_string_table(CPP_FIXTURE, "Names")
    assert [r.value for r in table] == ["alpha", 'beta_"quoted"', "gamma"]
    for fn in ("cpp_string_literal", "cpp_int_literal"):
        for symbol in ("Key", "Version", "NoSuch"):
            assert _rows(getattr(pinlint, fn)(CPP_FIXTURE, symbol)) == \
                _rows(getattr(ref_pinlint, fn)(CPP_FIXTURE, symbol))
    with open(os.path.join(REPO, "native", "operator", "kubeapi.cc"),
              encoding="utf-8") as f:
        src = f.read()
    for symbol in ("OperatorMetricNames", "OperatorTraceEventNames",
                   "OperandWorkloadKinds"):
        assert _rows(pinlint.cpp_string_table(src, symbol)) == \
            _rows(ref_pinlint.cpp_string_table(src, symbol))
    for symbol in ("FieldManager", "TraceparentAnnotation"):
        assert _rows(pinlint.cpp_string_literal(src, symbol)) == \
            _rows(ref_pinlint.cpp_string_literal(src, symbol))


def test_map_and_case_extractors():
    plurals = pinlint.cpp_string_map(CPP_FIXTURE, "Plurals")
    assert {k: v.value for k, v in plurals.items()} == {
        "Namespace": "namespaces", "Job": "jobs"}
    lines = CPP_FIXTURE.split("\n")
    assert '"jobs"' in lines[plurals["Job"].line - 1]
    assert pinlint.cpp_string_map(CPP_FIXTURE, "Names") is None
    assert pinlint.cpp_string_map(CPP_FIXTURE, "NoSuch") is None
    cases = pinlint.cpp_case_labels(CPP_FIXTURE, "Retryable")
    assert [c.value for c in cases] == ["0", "429", "503"]
    assert "case 429" in lines[cases[1].line - 1]
    assert pinlint.cpp_case_labels(CPP_FIXTURE, "Key") is None
    with open(os.path.join(REPO, "native", "operator", "kubeclient.cc"),
              encoding="utf-8") as f:
        got = pinlint.cpp_case_labels(f.read(), "RetryableStatus")
    assert {int(c.value) for c in got} == kubeapply.RETRYABLE_STATUSES


HARVEST_SRC = textwrap.dedent("""\
    SOME_ANNOTATION = "tpu-stack.dev/brand-new"
    EVENT_THING = "ThingHappened"
    FAMILIES = ("tpu_operator_new_total", "unrelated word")
    TIMEOUT = "30s"
    _PRIVATE_ANNOTATION = "tpu-stack.dev/hidden"
    NEW_LABEL_KEY = "nvidia.com/gpu.brand-new"
    RESOURCE = "nvidia.com/gpu"
    SELECTOR = "nvidia.com/gpu.present=true"

    def wire(reg, client):
        reg.counter("tpuctl_fresh_total", "help")
        reg.counter(name, "not a literal")
        EventRecorder(client, component="gpu-newcomer")
        EventRecorder(client, component=name)
    """)


def test_harvest_finds_the_references_constants_and_the_gpu_names():
    ref = {v for _a, v, _l in ref_pinlint.harvest_python_constants(
        HARVEST_SRC, "mod.py")}
    port = {v for _a, v, _l in pinlint.harvest_python_constants(
        HARVEST_SRC, "mod.py")}
    assert ref == {"tpu-stack.dev/brand-new", "ThingHappened",
                   "tpu_operator_new_total", "tpuctl_fresh_total"}
    assert port == ref | {"nvidia.com/gpu.brand-new", "nvidia.com/gpu",
                          "gpu-newcomer"}


def test_py_constant_line_resolves_tuple_rows():
    src = 'X = 1\nNAMES = (\n    "a",\n    "b",\n)\nKEY = "k"\n'
    for mod in (pinlint, ref_pinlint):
        assert mod.py_constant_line(src, "NAMES[1]") == 4
        assert mod.py_constant_line(src, "KEY") == 6
        assert mod.py_constant_line(src, "MISSING") == 0


# ---------------------------------------------------------------------------
# per-rule seeded drift (minimal registries over a temp repo)


def _mini_repo(tmp_path, files):
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return str(tmp_path)


def _contract(**kw):
    base = dict(name="annotation/x", kind="annotation",
                value="tpu-stack.dev/x", py_file="tpu_cluster_torch/mod.py",
                py_attr="X_ANNOTATION")
    base.update(kw)
    return Contract(**base)


PY_DECL = 'X_ANNOTATION = "tpu-stack.dev/x"\n'


@pytest.mark.parametrize("pin,bad,good", [
    (CppPin("native/x.cc", "XAnn"),
     'const char* XAnn() { return "tpu-stack.dev/DRIFTED"; }\n',
     'const char* XAnn() { return "tpu-stack.dev/x"; }\n'),
    (CppPin("native/x.cc", "Plurals", key="Thing"),
     'const std::map<std::string, std::string>& Plurals() {\n'
     '  static const auto* m = new std::map<std::string, std::string>{\n'
     '      {"Thing", "tpu-stack.dev/DRIFTED"},\n  };\n  return *m;\n}\n',
     'const std::map<std::string, std::string>& Plurals() {\n'
     '  static const auto* m = new std::map<std::string, std::string>{\n'
     '      {"Thing", "tpu-stack.dev/x"},\n  };\n  return *m;\n}\n'),
])
def test_pl01_mismatch_names_both_loci(tmp_path, pin, bad, good):
    root = _mini_repo(tmp_path, {"tpu_cluster_torch/mod.py": PY_DECL,
                                 "native/x.cc": bad})
    reg = Registry([_contract(cpp=pin)])
    auditor = pinlint.Auditor(root, registry=reg)
    auditor.check_cpp_twins()
    assert rules(auditor.findings) == [pinlint.RULE_TWIN_MISMATCH]
    msg = auditor.findings[0].message
    assert "tpu_cluster_torch/mod.py:1" in msg and "DRIFTED" in msg
    assert auditor.findings[0].path == "native/x.cc"
    assert auditor.findings[0].line == bad.count("\n", 0,
                                                 bad.index("DRIFTED")) + 1
    (tmp_path / "native" / "x.cc").write_text(good)
    clean = pinlint.Auditor(root, registry=reg)
    clean.check_cpp_twins()
    assert clean.findings == []


def test_pl01_and_pl02_on_a_case_set(tmp_path):
    switch = ("bool R(int s) {\n  switch (s) {\n    case 0:\n"
              "    case 503:\n      return true;\n    default:\n"
              "      return false;\n  }\n}\n")
    root = _mini_repo(tmp_path, {"tpu_cluster_torch/mod.py": PY_DECL,
                                 "native/x.cc": switch})
    reg = Registry([_contract(name=f"retryable-status/{v}",
                              kind="retryable-status", value=v,
                              cpp=CppPin("native/x.cc", "R", case=True))
                    for v in ("0", "429", "503")])
    auditor = pinlint.Auditor(root, registry=reg)
    auditor.check_cpp_twins()
    assert rules(auditor.findings) == [pinlint.RULE_TWIN_MISMATCH]
    assert "no case 429" in auditor.findings[0].message
    (tmp_path / "native" / "x.cc").write_text(
        switch.replace("case 503:", "case 429:\n    case 503:\n"
                       "    case 504:"))
    extra = pinlint.Auditor(root, registry=reg)
    extra.check_cpp_twins()
    assert [f.message for f in extra.findings] == [
        "R() case 504 has no registry twin (extra C++ case)"]
    (tmp_path / "native" / "x.cc").write_text("// gone\n")
    gone = pinlint.Auditor(root, registry=reg)
    gone.check_cpp_twins()
    assert rules(gone.findings) == [pinlint.RULE_MISSING_TWIN]


def test_pl02_missing_accessor_and_map_entry(tmp_path):
    root = _mini_repo(tmp_path, {
        "tpu_cluster_torch/mod.py": PY_DECL,
        "native/x.cc":
            'const std::map<std::string, std::string>& Plurals() {\n'
            '  static const auto* m = new std::map<std::string, '
            'std::string>{\n      {"Other", "others"},\n  };\n}\n',
    })
    reg = Registry([_contract(cpp=CppPin("native/x.cc", "XAnn")),
                    _contract(name="plural/Thing", kind="plural",
                              value="things",
                              cpp=CppPin("native/x.cc", "Plurals",
                                         key="Thing"))])
    auditor = pinlint.Auditor(root, registry=reg)
    auditor.check_cpp_twins()
    assert [f.rule for f in auditor.findings] == \
        [pinlint.RULE_MISSING_TWIN] * 2
    text = " ".join(f.message for f in auditor.findings)
    assert "XAnn" in text and "'Thing'" in text


def test_pl03_enforcer_must_contain_value(tmp_path):
    root = _mini_repo(tmp_path, {
        "tpu_cluster_torch/mod.py": PY_DECL,
        "tpu_cluster_torch/writer.py": "# nothing written here\n",
    })
    reg = Registry([_contract(enforcers=("tpu_cluster_torch/writer.py",))])
    auditor = pinlint.Auditor(root, registry=reg)
    auditor.check_enforcers()
    assert rules(auditor.findings) == [pinlint.RULE_UNENFORCED]
    (tmp_path / "tpu_cluster_torch" / "writer.py").write_text(
        'ANN = "tpu-stack.dev/x"\n')
    clean = pinlint.Auditor(root, registry=reg)
    clean.check_enforcers()
    assert clean.findings == []


def test_pl04_undeclared_constant_and_component(tmp_path):
    root = _mini_repo(tmp_path, {
        "tpu_cluster_torch/mod.py":
            'X_ANNOTATION = "tpu-stack.dev/x"\n'
            'NEW_ANNOTATION = "tpu-stack.dev/unregistered"\n'
            'rec = EventRecorder(None, component="gpu-stranger")\n',
        "tpu_cluster/ignored.py": 'Y_ANNOTATION = "tpu-stack.dev/y"\n',
    })
    reg = Registry([_contract()])
    auditor = pinlint.Auditor(root, registry=reg)
    auditor.check_python_declarations()
    assert [(f.rule, f.line) for f in auditor.findings] == \
        [(pinlint.RULE_UNDECLARED, 2), (pinlint.RULE_UNDECLARED, 3)]
    assert "tpu-stack.dev/unregistered" in auditor.findings[0].message
    assert "gpu-stranger" in auditor.findings[1].message


def test_pl05_docs_claim_checked(tmp_path):
    root = _mini_repo(tmp_path, {
        "tpu_cluster_torch/mod.py": PY_DECL,
        "README.md": "# readme\nno mention\n",
    })
    reg = Registry([_contract(docs=("README.md",))])
    auditor = pinlint.Auditor(root, registry=reg)
    auditor.check_docs()
    assert rules(auditor.findings) == [pinlint.RULE_DOC_DRIFT]
    assert pinlint.RULE_DOC_DRIFT in pinlint.WARN_RULES
    (tmp_path / "README.md").write_text(
        "# readme\n`tpu-stack.dev/x` does things\n")
    clean = pinlint.Auditor(root, registry=reg)
    clean.check_docs()
    assert clean.findings == []


def test_pl06_ci_greps_must_reference_live_port_names(tmp_path):
    root = _mini_repo(tmp_path, {
        "tpu_cluster_torch/mod.py": PY_DECL,
        ".github/workflows/ci.yaml":
            "      - run: |\n"
            "          grep tpu_operator_gone_total out.txt\n"
            "          python -c 'telemetry.NO_SUCH_NAME'\n"
            "          python -c 'telemetry.OPERATOR_TRACE_EVENTS'\n",
    })
    reg = Registry([_contract()])
    auditor = pinlint.Auditor(root, registry=reg)
    auditor.check_ci()
    assert rules(auditor.findings) == [pinlint.RULE_CI_DRIFT]
    msgs = "\n".join(f.message for f in auditor.findings)
    assert "tpu_operator_gone_total" in msgs
    assert "tpu_cluster_torch.telemetry.NO_SUCH_NAME" in msgs
    assert "OPERATOR_TRACE_EVENTS" not in msgs


# ---------------------------------------------------------------------------
# acceptance pins


def test_port_tree_is_clean_in_strict_mode():
    findings = pinlint.audit_repo(REPO)
    assert findings == [], "\n".join(f.text() for f in findings)


def test_drifted_operator_table_is_pl01_from_both_tools(tmp_path):
    native = tmp_path / "native"
    shutil.copytree(os.path.join(REPO, "native"), native,
                    ignore=shutil.ignore_patterns("build"))
    kubeapi = native / "operator" / "kubeapi.cc"
    src = kubeapi.read_text()
    assert '"tpu_operator_objects"' in src
    kubeapi.write_text(src.replace('"tpu_operator_objects"',
                                   '"tpu_operator_objectz"', 1))
    drifts = []
    for mod, py in ((ref_pinlint, "tpu_cluster/telemetry.py:"),
                    (pinlint, "tpu_cluster_torch/telemetry.py:")):
        findings = mod.audit_repo(REPO, native_root=str(native))
        drift = [f for f in findings
                 if f.rule == mod.RULE_TWIN_MISMATCH]
        assert len(drift) == 1, "\n".join(f.text() for f in findings)
        assert "tpu_operator_objectz" in drift[0].message
        assert py in drift[0].message
        drifts.append((drift[0].path, drift[0].line))
    assert drifts[0] == drifts[1]
    assert drifts[1][0] == "native/operator/kubeapi.cc" and drifts[1][1] > 0
    proc = run_port_cli("pinlint", "--native-root", native)
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert "tpu_operator_objectz" in proc.stderr
    assert "tpu_cluster_torch/telemetry.py:" in proc.stderr


def test_drifted_plural_and_retry_case_are_pl01(tmp_path):
    native = tmp_path / "native"
    shutil.copytree(os.path.join(REPO, "native", "operator"),
                    native / "operator")
    kubeapi = native / "operator" / "kubeapi.cc"
    kubeapi.write_text(kubeapi.read_text().replace(
        '{"Job", "jobs"}', '{"Job", "jobz"}', 1))
    client = native / "operator" / "kubeclient.cc"
    client.write_text(client.read_text().replace("case 502:\n", "", 1))
    findings = pinlint.audit_repo(REPO, native_root=str(native))
    drift = sorted(f.message for f in findings
                   if f.rule == pinlint.RULE_TWIN_MISMATCH)
    assert len(drift) == 2, drift
    assert "Plurals()['Job'] is 'jobz'" in drift[0]
    assert "RetryableStatus() has no case 502" in drift[1]


def test_undeclared_configmap_in_a_copy_of_a_port_module(tmp_path):
    pkg = tmp_path / "tpu_cluster_torch"
    shutil.copytree(os.path.join(REPO, "tpu_cluster_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    mod = pkg / "maintenance.py"
    src = mod.read_text()
    anchor = 'MAINTENANCE_KEY = "state.json"\n'
    assert anchor in src
    mod.write_text(src.replace(
        anchor, anchor + 'DRAIN_LOG_CONFIGMAP = "gpu-drain-log"\n', 1))
    line = src[:src.index(anchor)].count("\n") + 2
    auditor = pinlint.Auditor(str(tmp_path))
    auditor.check_python_declarations()
    assert [(f.rule, f.path, f.line) for f in auditor.findings] == [
        (pinlint.RULE_UNDECLARED, "tpu_cluster_torch/maintenance.py", line)]
    assert "gpu-drain-log" in auditor.findings[0].message


def test_cli_strict_clean_dump_and_json():
    proc = run_port_cli("pinlint", "--strict")
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert proc.stdout == "pinlint: clean\n"
    dump = run_port_cli("pinlint", "--dump")
    assert dump.returncode == 0
    doc = json.loads(dump.stdout)
    assert doc == json.loads(json.dumps(build_registry().to_json()))
    ref = {c.name: c.value
           for c in ref_contracts.build_registry().contracts}
    port = {c["name"]: c["value"] for c in doc["contracts"]}
    assert {n: port[n] for n in set(port) & set(ref)} == \
        {n: ref[n] for n in set(port) & set(ref)}
    js = run_port_cli("pinlint", "--strict", "--format", "json")
    assert json.loads(js.stdout) == {"ok": True, "strict": True,
                                     "findings": []}
