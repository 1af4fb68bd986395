"""Cross-language contract pin analyzer (``python -m tpu_cluster_torch
pinlint``). The port's own copy of ``tpu_cluster/pinlint.py``, over the
port's registry and sources.

The checking half of :mod:`tpu_cluster_torch.contracts` (read its
docstring first): an AST+regex static pass, conlint-shaped —
structured :class:`~tpu_cluster_torch.conlint.Finding` results with file:line
loci, a ``--strict`` CI gate, ``--format json`` for artifacts, and
``--dump`` to print the registry itself.

WHAT IT CHECKS (rule ids are PLxx, mirroring conlint's CLxx):

  PL01  cross-language mismatch: a C++ twin accessor (a
        ``new std::vector<std::string>{...}`` table like
        ``kubeapi::OperatorMetricNames()``, a single-literal accessor
        like ``kubeapi::FieldManager()``, an entry of a string map like
        ``Plurals()``, or the ``case`` labels of a switch like
        ``kubeclient::RetryableStatus``) disagrees with the registry —
        wrong spelling, wrong order, missing or extra table rows or
        cases. The finding names BOTH loci
        (Python declaration and C++ line).
  PL02  missing twin: a registry contract claims a C++ accessor that
        no longer exists (file or symbol gone) — the C++ side was
        deleted or renamed out from under the contract.
  PL03  unenforced pin: a contract value is absent from a file the
        registry says must mention it verbatim (``operator_main.cc``
        must emit every pinned metric family, ``selftest.cc`` must
        re-pin it compiler-only, the labels module must write every
        feature label, the fake apiserver must implement every chaos
        kind).
  PL04  undeclared constant: a contract-shaped constant exists in the
        port's Python sources but not in the registry — a new
        ``tpu-stack.dev/...`` annotation, ``tpu*_...`` metric family,
        ``nvidia.com/gpu...`` label or resource,
        ``EVENT_``/``STATUS_``/``PHASE_`` constant, a metric family
        registered with a string literal, an Event component passed as
        a ``component="..."`` literal, or a chaos kind added to the
        fake's ``_NODE_FAULT_KINDS`` that nobody registered. This is
        the rule that makes the NEXT constant pinned by construction.
  PL05  docs drift: a contract value is missing from a doc that its
        registry entry claims coverage in (GUIDE's contract-registry
        tables, TESTING's chaos vocabulary, README's table of the GPU's
        names).
  PL06  CI drift: ``.github/workflows/ci.yaml`` greps a pinned name or
        references a ``telemetry.NAME``-style symbol that no longer
        exists — a CI step silently grepping for nothing.

SEVERITY: PL01-PL04 are errors (exit 1 always); PL05/PL06 are
warnings — reported, but only ``--strict`` fails on them. The port
must stay clean in strict mode.

SCOPE AND LIMITS: C++ extraction is textual (comment-stripped brace
matching, not a parser) — exactly strong enough for the accessor-table
idiom the native sources commit to, which the selftests pin
compiler-side. Docs/CI checks are substring checks: they catch
deletions and renames, not prose accuracy.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from tpu_cluster_torch.conlint import Finding
from tpu_cluster_torch.contracts import (
    CHAOS_KINDS, FAKE_APISERVER_PATH, KIND_CHAOS_KIND, Contract,
    Registry, build_registry,
)

RULE_TWIN_MISMATCH = "PL01"
RULE_MISSING_TWIN = "PL02"
RULE_UNENFORCED = "PL03"
RULE_UNDECLARED = "PL04"
RULE_DOC_DRIFT = "PL05"
RULE_CI_DRIFT = "PL06"
RULE_PARSE = "PL00"

ALL_RULES = (RULE_TWIN_MISMATCH, RULE_MISSING_TWIN, RULE_UNENFORCED,
             RULE_UNDECLARED, RULE_DOC_DRIFT, RULE_CI_DRIFT)

# Warnings: reported always, fatal only under --strict.
WARN_RULES = frozenset({RULE_DOC_DRIFT, RULE_CI_DRIFT})

CI_WORKFLOW = ".github/workflows/ci.yaml"
_PACKAGE = "tpu_cluster_torch"

# ---------------------------------------------------------------------------
# C++ extraction helpers: one extractor, one set of bugs.


@dataclass(frozen=True)
class CppString:
    """One extracted C++ string literal, anchored to its source line."""

    value: str
    line: int


_CPP_STRING_RE = re.compile(r'"((?:\\.|[^"\\])*)"')


def _strip_line_comments(src: str) -> str:
    """Blank out ``// ...`` comments, preserving offsets/line numbers
    (so literal positions keep pointing at the real source)."""
    out: List[str] = []
    for line in src.split("\n"):
        idx = _comment_start(line)
        out.append(line if idx is None else line[:idx] + " " * (len(line) - idx))
    return "\n".join(out)


def _comment_start(line: str) -> Optional[int]:
    """Offset of a ``//`` comment on ``line``, ignoring ones inside
    string literals."""
    in_str = False
    i = 0
    while i < len(line) - 1:
        c = line[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == "/" and line[i + 1] == "/":
            return i
        i += 1
    return None


def _cpp_fn_body(src: str, symbol: str) -> Optional[Tuple[str, int]]:
    """(body text, offset of body start) for ``<symbol>(...) { ... }``,
    by brace matching from the first opening brace after the symbol's
    parameter list; None when the symbol is not defined in ``src``."""
    m = re.search(re.escape(symbol) + r"\s*\([^)]*\)\s*\{", src)
    if m is None:
        return None
    depth = 1
    i = m.end()
    while i < len(src) and depth > 0:
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
        i += 1
    return src[m.end():i - 1], m.end()


def cpp_string_table(src: str, symbol: str) -> Optional[List[CppString]]:
    """The ordered string literals of ``symbol()``'s
    ``new std::vector<std::string>{...}`` initializer, with line
    numbers; None when the symbol or the initializer is missing.
    Comment text is ignored (a family name MENTIONED in a comment is
    not a table row)."""
    found = _cpp_fn_body(_strip_line_comments(src), symbol)
    if found is None:
        return None
    body, offset = found
    m = re.search(r"new\s+std::vector<std::string>\s*\{", body)
    if m is None:
        return None
    tail = body[m.end():]
    end = tail.find("}")
    if end < 0:
        return None
    out: List[CppString] = []
    for lit in _CPP_STRING_RE.finditer(tail[:end]):
        pos = offset + m.end() + lit.start()
        out.append(CppString(lit.group(1).replace('\\"', '"'),
                             src.count("\n", 0, pos) + 1))
    return out


def cpp_string_literal(src: str, symbol: str) -> Optional[CppString]:
    """The literal of a ``return "...";`` accessor, with its line;
    None when the symbol (or a string return) is missing."""
    found = _cpp_fn_body(_strip_line_comments(src), symbol)
    if found is None:
        return None
    body, offset = found
    m = re.search(r"return\s+\"((?:\\.|[^\"\\])*)\"", body)
    if m is None:
        return None
    pos = offset + m.start(1)
    return CppString(m.group(1).replace('\\"', '"'),
                     src.count("\n", 0, pos) + 1)


def cpp_string_map(src: str, symbol: str
                   ) -> Optional[Dict[str, CppString]]:
    """``{key: value}`` of ``symbol()``'s ``new std::map<std::string,
    std::string>{{"k", "v"}, ...}`` initializer, each value with its
    line; None when the symbol or the initializer is missing."""
    found = _cpp_fn_body(_strip_line_comments(src), symbol)
    if found is None:
        return None
    body, offset = found
    m = re.search(r"new\s+std::map<std::string,\s*std::string>\s*\{",
                  body)
    if m is None:
        return None
    out: Dict[str, CppString] = {}
    pair = re.compile(r'\{\s*"((?:\\.|[^"\\])*)"\s*,\s*'
                      r'"((?:\\.|[^"\\])*)"\s*\}')
    for lit in pair.finditer(body, m.end()):
        pos = offset + lit.start(2)
        out[lit.group(1)] = CppString(lit.group(2).replace('\\"', '"'),
                                      src.count("\n", 0, pos) + 1)
    return out


def cpp_case_labels(src: str, symbol: str) -> Optional[List[CppString]]:
    """The integer ``case N:`` labels of ``symbol()``'s switch (the
    idiom of a predicate whose cases fall through to ``return true``);
    None when the symbol or its switch is missing."""
    found = _cpp_fn_body(_strip_line_comments(src), symbol)
    if found is None:
        return None
    body, offset = found
    if re.search(r"\bswitch\s*\(", body) is None:
        return None
    out: List[CppString] = []
    for lit in re.finditer(r"\bcase\s+(\d+)\s*:", body):
        pos = offset + lit.start(1)
        out.append(CppString(lit.group(1), src.count("\n", 0, pos) + 1))
    return out


def cpp_int_literal(src: str, symbol: str) -> Optional[CppString]:
    """The literal of a ``return <int>;`` accessor (value as str)."""
    found = _cpp_fn_body(_strip_line_comments(src), symbol)
    if found is None:
        return None
    body, offset = found
    m = re.search(r"return\s+(\d+)\s*;", body)
    if m is None:
        return None
    pos = offset + m.start(1)
    return CppString(m.group(1), src.count("\n", 0, pos) + 1)


# ---------------------------------------------------------------------------
# Python-side loci and harvesting.


def py_constant_line(source: str, attr: str) -> int:
    """Line of ``attr``'s module-level assignment (``NAME[i]`` indexes
    into a tuple initializer's i-th element); 0 when not found."""
    name = attr
    index = -1
    m = re.fullmatch(r"(\w+)\[(\d+)\]", attr)
    if m is not None:
        name, index = m.group(1), int(m.group(2))
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return 0
    for node in tree.body:
        target: Optional[ast.expr] = None
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        if index >= 0 and isinstance(value, (ast.Tuple, ast.List)) \
                and index < len(value.elts):
            return value.elts[index].lineno
        return node.lineno
    return 0


# What "contract-shaped" means for the PL04 harvest: a module-level
# UPPER_CASE constant whose NAME or VALUE matches the registry's
# vocabulary. Names first (they catch empty-string drafts too), then
# value patterns for names outside the naming conventions.
_HARVEST_NAME_SUFFIXES = ("_ANNOTATION", "_CONFIGMAP", "_LABEL")
_HARVEST_NAME_PREFIXES = ("EVENT_", "STATUS_", "PHASE_")
_HARVEST_VALUE_RES = (
    re.compile(r"tpu-stack\.dev/[\w.-]+"),
    re.compile(r"tpu(?:ctl)?_[a-z][a-z0-9_]*"),
    re.compile(r"google\.com/tpu[\w.-]*"),
    re.compile(r"nvidia\.com/gpu[\w.-]*"),
)

# Metric-registration call names whose literal first argument is a
# family name (the MetricsRegistry surface).
_FAMILY_CALLS = frozenset({"counter", "gauge", "histogram"})


def _contract_shaped(name: str, value: str) -> bool:
    if name.endswith(_HARVEST_NAME_SUFFIXES):
        return True
    if name.startswith(_HARVEST_NAME_PREFIXES):
        return True
    return any(r.fullmatch(value) for r in _HARVEST_VALUE_RES)


def harvest_python_constants(
        source: str, path: str) -> List[Tuple[str, str, int]]:
    """Every contract-shaped ``(attr or call-site, value, line)`` a
    Python module declares: module-level UPPER_CASE string (or
    string-tuple) assignments, string-literal metric family
    registrations (``reg.counter("...", ...)``), and every
    ``component="..."`` keyword literal (an Event source component)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []
    out: List[Tuple[str, str, int]] = []
    for node in tree.body:
        target: Optional[ast.expr] = None
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        if not isinstance(target, ast.Name) or value is None:
            continue
        name = target.id
        if not name.isupper() or name.startswith("_"):
            continue
        elements: List[Tuple[ast.expr, str]] = []
        if isinstance(value, ast.Constant) and isinstance(value.value, str):
            elements = [(value, value.value)]
        elif isinstance(value, (ast.Tuple, ast.List)):
            elements = [(e, e.value) for e in value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
        for elt, text in elements:
            if _contract_shaped(name, text):
                out.append((name, text, elt.lineno))
    for sub in ast.walk(tree):
        if not (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _FAMILY_CALLS and sub.args):
            continue
        first = sub.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            if _contract_shaped("", first.value):
                out.append((f".{sub.func.attr}()", first.value,
                            first.lineno))
    for sub in ast.walk(tree):
        if not isinstance(sub, ast.Call):
            continue
        for kw in sub.keywords:
            if kw.arg == "component" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                out.append(("component=", kw.value.value,
                            kw.value.lineno))
    return out


def extract_fake_node_kinds(source: str) -> List[Tuple[str, int]]:
    """The fake apiserver's ``_NODE_FAULT_KINDS`` tuple entries (value,
    line) — the chaos-kind spellings the engine dispatches on."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "_NODE_FAULT_KINDS" \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return [(e.value, e.lineno) for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
    return []


# ---------------------------------------------------------------------------
# The audit.


class Auditor:
    """One repo audit run: reads sources relative to ``repo_root``
    (``native_root`` overrides where ``native/``-prefixed paths resolve,
    which is how the drift test points the analyzer at a mutated temp
    copy without touching the tree)."""

    def __init__(self, repo_root: str,
                 native_root: Optional[str] = None,
                 registry: Optional[Registry] = None) -> None:
        self.repo_root = os.path.abspath(repo_root)
        self.native_root = native_root
        self.registry = registry if registry is not None else \
            build_registry()
        self.findings: List[Finding] = []
        self._sources: Dict[str, Optional[str]] = {}

    # ------------------------------------------------------------ plumbing

    def _resolve(self, rel: str) -> str:
        if self.native_root is not None and rel.startswith("native/"):
            return os.path.join(self.native_root, rel[len("native/"):])
        return os.path.join(self.repo_root, rel)

    def _read(self, rel: str) -> Optional[str]:
        if rel not in self._sources:
            try:
                with open(self._resolve(rel), encoding="utf-8") as f:
                    self._sources[rel] = f.read()
            except OSError:
                self._sources[rel] = None
        return self._sources[rel]

    def _emit(self, rule: str, path: str, line: int, message: str,
              hint: str = "") -> None:
        self.findings.append(Finding(rule, path, line, message, hint))

    def _py_locus(self, contract: Contract) -> str:
        src = self._read(contract.py_file)
        line = py_constant_line(src, contract.py_attr) if src else 0
        return f"{contract.py_file}:{line}"

    # ------------------------------------------------------- PL01 / PL02

    def check_cpp_twins(self) -> None:
        for (cpp_file, symbol), rows in sorted(
                self.registry.cpp_tables().items()):
            src = self._read(cpp_file)
            if src is None:
                self._emit(RULE_MISSING_TWIN, cpp_file, 0,
                           f"cannot read {cpp_file} (pinned table "
                           f"{symbol}() for {len(rows)} contract(s))",
                           "restore the file or re-home the contracts")
                continue
            table = cpp_string_table(src, symbol)
            if table is None:
                self._emit(RULE_MISSING_TWIN, cpp_file, 0,
                           f"{symbol}() string table not found (pins "
                           f"{len(rows)} contract(s), first: "
                           f"{rows[0].name} at {self._py_locus(rows[0])})",
                           "restore the accessor or update the registry")
                continue
            self._diff_table(cpp_file, symbol, rows, table)
        self._check_cpp_maps()
        self._check_cpp_cases()
        for contract in self.registry.cpp_literals():
            pin = contract.cpp
            assert pin is not None
            src = self._read(pin.file)
            if src is None:
                self._emit(RULE_MISSING_TWIN, pin.file, 0,
                           f"cannot read {pin.file} (pinned literal "
                           f"{pin.symbol}() for {contract.name})",
                           "restore the file or update the registry")
                continue
            got = (cpp_int_literal(src, pin.symbol) if pin.integer
                   else cpp_string_literal(src, pin.symbol))
            if got is None:
                self._emit(RULE_MISSING_TWIN, pin.file, 0,
                           f"{pin.symbol}() not found — the C++ twin of "
                           f"{contract.name} "
                           f"({self._py_locus(contract)}) is gone",
                           "restore the accessor or update the registry")
            elif got.value != contract.value:
                self._emit(RULE_TWIN_MISMATCH, pin.file, got.line,
                           f"{pin.symbol}() returns {got.value!r} but "
                           f"{contract.name} is {contract.value!r} at "
                           f"{self._py_locus(contract)}",
                           "make the two spellings agree (both processes "
                           "read this name)")

    def _check_cpp_maps(self) -> None:
        maps: Dict[Tuple[str, str], Optional[Dict[str, CppString]]] = {}
        for contract in self.registry.cpp_map_entries():
            pin = contract.cpp
            assert pin is not None
            src = self._read(pin.file)
            if src is None:
                self._emit(RULE_MISSING_TWIN, pin.file, 0,
                           f"cannot read {pin.file} (pinned map "
                           f"{pin.symbol}() for {contract.name})",
                           "restore the file or update the registry")
                continue
            if (pin.file, pin.symbol) not in maps:
                maps[(pin.file, pin.symbol)] = cpp_string_map(
                    src, pin.symbol)
            table = maps[(pin.file, pin.symbol)]
            got = None if table is None else table.get(pin.key)
            if got is None:
                self._emit(RULE_MISSING_TWIN, pin.file, 0,
                           f"{pin.symbol}() has no entry for "
                           f"{pin.key!r} — the C++ twin of "
                           f"{contract.name} "
                           f"({self._py_locus(contract)}) is gone",
                           "restore the entry or update the registry")
            elif got.value != contract.value:
                self._emit(RULE_TWIN_MISMATCH, pin.file, got.line,
                           f"{pin.symbol}()[{pin.key!r}] is "
                           f"{got.value!r} but {contract.name} is "
                           f"{contract.value!r} at "
                           f"{self._py_locus(contract)}",
                           "make the two spellings agree (both processes "
                           "read this name)")

    def _check_cpp_cases(self) -> None:
        for (cpp_file, symbol), rows in sorted(
                self.registry.cpp_case_sets().items()):
            src = self._read(cpp_file)
            labels = None if src is None else cpp_case_labels(src, symbol)
            if labels is None:
                self._emit(RULE_MISSING_TWIN, cpp_file, 0,
                           f"{symbol}() switch not found (pins "
                           f"{len(rows)} contract(s), first: "
                           f"{rows[0].name} at {self._py_locus(rows[0])})",
                           "restore the accessor or update the registry")
                continue
            want = {c.value: c for c in rows}
            got = {lab.value: lab for lab in labels}
            for value in sorted(set(want) - set(got), key=int):
                self._emit(RULE_TWIN_MISMATCH, cpp_file,
                           labels[-1].line if labels else 0,
                           f"{symbol}() has no case {value} "
                           f"({want[value].name} at "
                           f"{self._py_locus(want[value])})",
                           "make the two sets agree")
            for value in sorted(set(got) - set(want), key=int):
                self._emit(RULE_TWIN_MISMATCH, cpp_file, got[value].line,
                           f"{symbol}() case {value} has no registry "
                           "twin (extra C++ case)",
                           "register it in tpu_cluster_torch/contracts.py "
                           "or delete the case")

    def _diff_table(self, cpp_file: str, symbol: str,
                    rows: Sequence[Contract],
                    table: Sequence[CppString]) -> None:
        for i in range(max(len(rows), len(table))):
            if i >= len(table):
                self._emit(
                    RULE_TWIN_MISMATCH, cpp_file, table[-1].line if table
                    else 0,
                    f"{symbol}() is missing row {i}: {rows[i].value!r} "
                    f"(declared at {self._py_locus(rows[i])})",
                    "append the row — table order is part of the "
                    "contract")
            elif i >= len(rows):
                self._emit(
                    RULE_TWIN_MISMATCH, cpp_file, table[i].line,
                    f"{symbol}() row {i} {table[i].value!r} has no "
                    "registry twin (extra/renamed C++ entry)",
                    "register the constant in "
                    "tpu_cluster_torch/contracts.py or delete the row")
            elif rows[i].value != table[i].value:
                self._emit(
                    RULE_TWIN_MISMATCH, cpp_file, table[i].line,
                    f"{symbol}() row {i} is {table[i].value!r} but the "
                    f"registry pins {rows[i].value!r} at "
                    f"{self._py_locus(rows[i])}",
                    "make the two tables agree, same order")

    # -------------------------------------------------------------- PL03

    def check_enforcers(self) -> None:
        for contract in self.registry.contracts:
            for rel in contract.enforcers:
                src = self._read(rel)
                if src is None:
                    self._emit(RULE_UNENFORCED, rel, 0,
                               f"cannot read {rel}, which must mention "
                               f"{contract.value!r} ({contract.name})",
                               "restore the file or update the registry")
                elif contract.value not in src:
                    self._emit(RULE_UNENFORCED, rel, 0,
                               f"{contract.value!r} ({contract.name}, "
                               f"{self._py_locus(contract)}) does not "
                               f"appear in {rel}",
                               "emit/pin the value there, or drop the "
                               "enforcement claim in contracts.py")

    # -------------------------------------------------------------- PL04

    def check_python_declarations(self) -> None:
        known = self.registry.values()
        pkg = os.path.join(self.repo_root, _PACKAGE)
        for root, _dirs, files in os.walk(pkg):
            for fname in sorted(files):
                if not fname.endswith(".py") or fname.endswith("_pb2.py"):
                    continue
                path = os.path.join(root, fname)
                rel = os.path.relpath(path, self.repo_root)
                if rel == os.path.join(_PACKAGE, "contracts.py"):
                    continue  # the registry itself
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                for attr, value, line in harvest_python_constants(
                        source, rel):
                    if value not in known:
                        self._emit(
                            RULE_UNDECLARED, rel, line,
                            f"contract-shaped constant {attr} = "
                            f"{value!r} is not in the contract registry",
                            "add a Contract entry in "
                            "tpu_cluster_torch/contracts.py (or rename "
                            "the constant out of the contract "
                            "vocabulary)")
        # the chaos engine's dispatch tuple must stay registered too
        fake = self._read(FAKE_APISERVER_PATH)
        if fake is not None:
            chaos = self.registry.values(KIND_CHAOS_KIND)
            for value, line in extract_fake_node_kinds(fake):
                if value not in chaos:
                    self._emit(
                        RULE_UNDECLARED, FAKE_APISERVER_PATH, line,
                        f"chaos kind {value!r} (in _NODE_FAULT_KINDS) "
                        "is not in the contract registry",
                        "add it to contracts.CHAOS_KINDS")

    # -------------------------------------------------------------- PL05

    def check_docs(self) -> None:
        for contract in self.registry.contracts:
            for rel in contract.docs:
                text = self._read(rel)
                if text is None:
                    self._emit(RULE_DOC_DRIFT, rel, 0,
                               f"cannot read {rel}, which claims "
                               f"coverage of {contract.name}",
                               "restore the doc or drop the claim")
                elif contract.value not in text:
                    self._emit(RULE_DOC_DRIFT, rel, 0,
                               f"{contract.value!r} ({contract.name}, "
                               f"{self._py_locus(contract)}) is not "
                               f"documented in {rel}",
                               "add it to the doc's contract table, or "
                               "drop the docs claim in contracts.py")

    # -------------------------------------------------------------- PL06

    # Symbol references CI scripts make into the package (`telemetry.
    # OPERATOR_METRIC_NAMES`), and bare pinned-name grep patterns.
    _CI_SYMBOL_RE = re.compile(
        r"\b(telemetry|admission|maintenance|kubeapply|contracts)"
        r"\.([A-Z][A-Z0-9_]*)\b")
    _CI_VALUE_RES = (
        re.compile(r"\btpu_(?:operator|maintenance)_[a-z0-9_]+\b"),
        re.compile(r"\btpuctl_[a-z0-9_]+\b"),
        re.compile(r"\btpu-stack\.dev/[\w.-]+\b"),
    )

    def check_ci(self) -> None:
        text = self._read(CI_WORKFLOW)
        if text is None:
            self._emit(RULE_CI_DRIFT, CI_WORKFLOW, 0,
                       "cannot read the CI workflow",
                       "restore it (the pinlint gate lives there)")
            return
        import importlib
        lines = text.split("\n")
        known = self.registry.values()
        for i, line in enumerate(lines, start=1):
            for m in self._CI_SYMBOL_RE.finditer(line):
                module_name, attr = m.group(1), m.group(2)
                module = importlib.import_module(
                    f"{_PACKAGE}.{module_name}")
                if not hasattr(module, attr):
                    self._emit(
                        RULE_CI_DRIFT, CI_WORKFLOW, i,
                        f"CI references {_PACKAGE}.{module_name}."
                        f"{attr}, which does not exist",
                        "the constant was renamed/deleted — update the "
                        "CI step")
            for pattern in self._CI_VALUE_RES:
                for vm in pattern.finditer(line):
                    if vm.group(0) not in known:
                        self._emit(
                            RULE_CI_DRIFT, CI_WORKFLOW, i,
                            f"CI greps pinned-looking name "
                            f"{vm.group(0)!r}, which is not a "
                            "registered contract value",
                            "register it or fix the CI grep — a grep "
                            "for a dead name passes vacuously")

    # --------------------------------------------------------------- run

    def run(self) -> List[Finding]:
        self.check_cpp_twins()
        self.check_enforcers()
        self.check_python_declarations()
        self.check_docs()
        self.check_ci()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings


def audit_repo(repo_root: str, native_root: Optional[str] = None
               ) -> List[Finding]:
    """Run the full audit; returns sorted findings."""
    return Auditor(repo_root, native_root=native_root).run()


def errors_only(findings: Sequence[Finding]) -> List[Finding]:
    """The PL01-PL04 subset (what fails a non-strict run)."""
    return [f for f in findings if f.rule not in WARN_RULES]


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "pinlint: clean"
    lines = [f.text() for f in findings]
    warns = sum(1 for f in findings if f.rule in WARN_RULES)
    lines.append(f"pinlint: {len(findings)} finding(s)"
                 + (f" ({warns} warning(s))" if warns else ""))
    return "\n".join(lines)


def _default_repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry (``python -m tpu_cluster_torch pinlint``). Exit 0 =
    clean, 1 = findings
    (non-strict: errors only), 2 = bad invocation."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="pinlint",
        description="cross-language contract pin analyzer (rules "
                    "PL01-PL06); the registry lives in "
                    "tpu_cluster_torch/contracts.py")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings (docs/CI drift) too — the "
                         "gate")
    ap.add_argument("--dump", action="store_true",
                    help="print the contract registry as JSON and exit")
    ap.add_argument("--format", choices=("table", "json"),
                    default="table")
    ap.add_argument("--repo-root", default=_default_repo_root(),
                    help="repository root (default: the checkout this "
                         "package sits in)")
    ap.add_argument("--native-root", default=None,
                    help="override where native/ sources are read from "
                         "(drift tests point this at a mutated copy)")
    args = ap.parse_args(argv)
    if args.dump:
        print(json.dumps(build_registry().to_json(), indent=2,
                         sort_keys=True))
        return 0
    if not os.path.isdir(args.repo_root):
        print(f"pinlint: no such repo root: {args.repo_root}",
              file=sys.stderr)
        return 2
    findings = audit_repo(args.repo_root, native_root=args.native_root)
    failing = findings if args.strict else errors_only(findings)
    if args.format == "json":
        print(json.dumps({
            "ok": not failing,
            "strict": bool(args.strict),
            "findings": [f.to_dict() for f in findings]}))
    else:
        print(format_findings(findings),
              file=sys.stderr if failing else sys.stdout)
    return 1 if failing else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
