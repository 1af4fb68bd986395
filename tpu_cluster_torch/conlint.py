"""Concurrency correctness lint (conlint): guarded-by annotations for
hand-rolled ``threading`` discipline, checked statically. The port's own
copy of ``tpu_cluster/conlint.py``: the grammar, rules CL01-CL05, their
messages and exit codes are the reference's; with no paths it audits
the ``tpu_cluster_torch`` package.

The rollout stack is built on explicit locks — ``kubeapply.Client`` alone
carries a connection-pool lock, a retry-accounting lock, an SSA probe
lock, a per-wait stats lock and the pipelined engine's cache lock — and
until now the discipline ("``_conns`` is only touched under
``_conns_lock``") lived in comments and reviewers' heads. This module
makes it machine-checked, following the Clang Thread Safety Analysis
model (GUARDED_BY / REQUIRES as annotations the compiler enforces),
adapted to Python: annotations are trailing comments, the checker is an
AST pass, and CI fails on violations — a data race becomes a lint error
at authoring time instead of a chaos-soak flake.

ANNOTATION GRAMMAR (trailing ``#`` comments; free prose may follow):

  ``# guarded-by: <lockexpr>``
      On an attribute assignment (``self.X = ...`` in ``__init__`` /
      ``__post_init__``, or a class-level/dataclass field). Every later
      read or write of ``X`` must be inside a ``with <recv>.<lockexpr>:``
      block, where ``<recv>`` is the receiver of the access — attr
      ``store`` guarded by ``_lock`` means ``self.store`` needs ``with
      self._lock:`` and ``fake.store`` needs ``with fake._lock:``.
      ``<lockexpr>`` may be dotted (``tracer.lock``: the lock lives on a
      sub-object of the owner).

  ``# thread-owned``
      The attribute is confined to a single thread (or mutated only
      before any thread can see it); no lock is required.

  ``# requires: <lockexpr>[, <lockexpr>...]``
      On a ``def``: the function body runs with these locks held, and
      every CALLER must hold them. ``self.``-relative entries are
      remapped to the call receiver at call sites (``fake._note_change``
      with ``# requires: self._lock`` obliges the caller to hold
      ``fake._lock``). Entries naming a closure variable (``fake._lock``)
      are matched verbatim.

  ``# conlint: ignore[CLxx]``
      Suppress one rule on this line (the NO_THREAD_SAFETY_ANALYSIS
      escape hatch — justify it in the surrounding comment).

RULES:

  CL01  a guarded attribute is read/written without its lock held
        (lexically: no enclosing ``with`` on the matching lock text and
        no satisfying ``# requires:`` on the enclosing function), or a
        ``# requires:`` function is called without its locks held.
  CL02  annotation hygiene: a ``guarded-by:``/``requires:`` names a lock
        that is not an attribute of the class (typo guard — a misspelt
        lock would silently disable CL01).
  CL03  a class that owns a lock or spawns threads
        (``threading.Thread``/``Timer``, ``ThreadPoolExecutor``,
        ``.submit``) has a mutable-container attribute (list/dict/set
        literal or constructor) with no ``guarded-by:`` /
        ``thread-owned`` annotation: shared mutable state reached from
        thread targets must declare its discipline.
  CL04  a span-creating call (``maybe_span(...)`` / ``<x>.span(...)``)
        inside a thread-entry function (a ``Thread``/``Timer`` target or
        a ``.submit`` callee) without an explicit ``parent=``: the
        per-thread span stack does not cross threads, so an implicit
        parent silently reparents the span to a new root (the telemetry
        rule the tracer otherwise enforces only by convention).
  CL05  blocking I/O lexically inside a ``with <lock>:`` body — a
        request through a client/session/socket attribute, ``urlopen``,
        a ``subprocess`` call, ``open()``/``os.replace``-style file
        traffic — the "leaf-only locks, I/O outside" discipline every
        controller module documents (admission/maintenance/events hold
        ``_lock`` for state transitions only and do LIST/PATCH wire
        traffic outside it). I/O under a lock turns every waiter's
        latency into the server's tail latency and is how lock-order
        deadlocks recruit their second lock. A ``with`` counts as a
        lock body when its context expression's final segment is
        lock-ish (ends in ``lock``) or is a known Lock/RLock/Condition
        attribute in this file. Deliberate I/O-under-lock (a connection
        mux serializing writes on its OWN socket) uses the ignore
        pragma with a justification.

SCOPE AND LIMITS (deliberate, Clang-TSA-shaped):

  - Analysis is per FILE: annotations in one module do not constrain
    another (``client.retries`` read by the CLI is out of scope unless
    the CLI module annotates it). Cross-module contracts belong to the
    runtime lock-order detector (tpu_cluster_torch.lockorder) and TSan.
  - Guard matching is by receiver TEXT, not alias analysis: ``with
    api._lock:`` does not satisfy an access through ``fake.store`` even
    when ``api is fake``. Write the receiver consistently (the annotated
    modules do), or use the ignore pragma with a justification.
  - ``__init__``/``__post_init__`` bodies are exempt from CL01:
    construction happens-before publication.
  - ``threading.Condition(self.X)`` registers an ALIAS: holding the
    condition is holding ``X``.
  - Local-variable locks guarding local state (the per-wait ``stats``
    lock, the pipelined ``cache_lock``) are out of static scope — they
    are typed via :class:`kubeapply.LockLike` and covered at runtime by
    the lock-order monitor.
  - CL04 resolves thread-entry targets by NAME (plain names and
    bound-method attributes); a callable reached through a subscript or
    a variable (``pool.submit(CHECKS[n], ...)``) cannot be resolved
    statically and is not checked.

Surfaces: ``python -m tpu_cluster_torch conlint`` (the dev
subcommand) and ``python -m tpu_cluster_torch.conlint``, both over the
port's package by default, and the parity tests (every rule shown by a
seeded-violation fixture, plus the repo self-audit).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# Rule ids (one place, so tests and pragmas cannot drift on spelling).
RULE_UNGUARDED = "CL01"
RULE_UNKNOWN_LOCK = "CL02"
RULE_UNANNOTATED_SHARED = "CL03"
RULE_SPAN_PARENT = "CL04"
RULE_IO_UNDER_LOCK = "CL05"
RULE_PARSE = "CL00"  # unparseable input (kept out of the rule docs)

ALL_RULES = (RULE_UNGUARDED, RULE_UNKNOWN_LOCK, RULE_UNANNOTATED_SHARED,
             RULE_SPAN_PARENT, RULE_IO_UNDER_LOCK)

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")
_OWNED_RE = re.compile(r"#\s*thread-owned\b")
_REQUIRES_RE = re.compile(
    r"#\s*requires:\s*([A-Za-z_][\w.]*(?:\s*,\s*[A-Za-z_][\w.]*)*)")
_IGNORE_RE = re.compile(r"#\s*conlint:\s*ignore\[(CL\d{2})\]")

# Constructors whose result is a mutable container (CL03's definition of
# "shared mutable state"). Immutable containers (tuple/frozenset) and
# plain objects are exempt: the rule is about unsynchronized mutation.
_MUTABLE_CALLS = frozenset({
    "list", "dict", "set", "bytearray", "defaultdict", "deque",
    "OrderedDict",
})

# threading.* factories that make an attribute a synchronization object
# (never flagged by CL03) — and the subset that counts as "owning a
# lock" for the CL03 trigger.
_LOCKISH = frozenset({"Lock", "RLock", "Condition"})
_SYNC_CALLS = _LOCKISH | frozenset({
    "Event", "Semaphore", "BoundedSemaphore", "Barrier", "local",
})

# Functions whose first positional callable argument (or target= kwarg)
# runs on another thread.
_SPAWN_NAMES = frozenset({"Thread", "Timer", "ThreadPoolExecutor"})

# --- CL05's definition of "blocking I/O" -----------------------------
# A call counts when its RECEIVER's final segment (leading underscores
# stripped) names a wire/socket object: `self._client.get(...)`,
# `api.patch_merge(...)`, `self._sock.sendall(...)`. Receiver-based on
# purpose — terminal names like `get`/`list`/`run` are far too generic
# to classify alone.
_IO_RECEIVERS = frozenset({
    "client", "api", "http", "session", "sock", "socket", "conn",
    "connection", "subprocess", "shutil",
})
# Terminal call names that are I/O regardless of receiver (socket verbs
# and the unambiguous subprocess/urllib entry points).
_IO_TERMINALS = frozenset({
    "urlopen", "urlretrieve", "sendall", "recv", "recv_into", "accept",
    "connect", "getresponse", "makefile", "create_connection",
    "check_call", "check_output", "Popen",
})
# os.<name> calls that hit the filesystem (the atomic-write/journal
# vocabulary this repo uses); only flagged with receiver text `os`.
_OS_IO_TERMINALS = frozenset({
    "replace", "rename", "unlink", "remove", "fsync", "makedirs",
    "mkdir", "rmdir", "mkstemp", "fdopen", "truncate", "write", "open",
})

_CTOR_NAMES = ("__init__", "__post_init__", "__new__")


@dataclass(frozen=True)
class Finding:
    """One conlint result, anchored to a file and line."""

    rule: str
    path: str
    line: int
    message: str
    hint: str = ""

    def text(self) -> str:
        hint = f" (fix: {self.hint})" if self.hint else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{hint}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint}


@dataclass
class _Annotations:
    """Per-line annotation marks extracted from the raw source."""

    guarded: Dict[int, str] = field(default_factory=dict)
    owned: Set[int] = field(default_factory=set)
    requires: Dict[int, List[str]] = field(default_factory=dict)
    ignores: Dict[int, Set[str]] = field(default_factory=dict)
    # lines that are nothing but a comment: an annotation there may
    # attach to the statement directly below (long assignments)
    comment_only: Set[int] = field(default_factory=set)

    @classmethod
    def scan(cls, source: str) -> "_Annotations":
        """Extract annotation marks from REAL comments via tokenize — a
        ``#`` inside a string literal must not register a phantom guard
        (``x = "see # guarded-by: sig"`` is data, not discipline)."""
        import io
        import tokenize

        out = cls()
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(source).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out  # analyze_source reports the parse failure
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            i = tok.start[0]
            comment = tok.string
            if tok.line[:tok.start[1]].strip() == "":
                out.comment_only.add(i)
            m = _GUARDED_RE.search(comment)
            if m:
                out.guarded[i] = m.group(1)
            if _OWNED_RE.search(comment):
                out.owned.add(i)
            m = _REQUIRES_RE.search(comment)
            if m:
                out.requires[i] = [e.strip()
                                   for e in m.group(1).split(",")]
            m = _IGNORE_RE.search(comment)
            if m:
                out.ignores.setdefault(i, set()).add(m.group(1))
        return out

    def ignored(self, line: int, rule: str) -> bool:
        return rule in self.ignores.get(line, set())


def _expr_text(node: ast.expr) -> Optional[str]:
    """Canonical dotted text for a Name/Attribute chain; None for
    anything else (calls, subscripts — receivers conlint cannot name)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_text(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _call_terminal(node: ast.expr) -> Optional[str]:
    """Final name of a call's func (``threading.Lock`` -> ``Lock``)."""
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name):
            return node.func.id
        if isinstance(node.func, ast.Attribute):
            return node.func.attr
    return None


def _is_threading_call(node: ast.expr, names: Iterable[str]) -> bool:
    """Call of ``threading.<name>`` (or bare ``<name>``) for any name.
    A terminal name ending in ``lock`` (case-insensitive) also counts as
    a lock constructor — ``lockorder.py`` keeps a saved ``_RAW_LOCK``
    factory so its bookkeeping lock can never be its own instrument."""
    term = _call_terminal(node)
    if term is None:
        return False
    return term in set(names) or (
        "Lock" in names and term.lower().endswith("lock"))


def _is_mutable_value(node: Optional[ast.expr]) -> bool:
    if node is None:
        return False
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.SetComp, ast.DictComp)):
        return True
    term = _call_terminal(node)
    return term is not None and term in _MUTABLE_CALLS


def _node_lines(node: ast.stmt) -> range:
    return range(node.lineno, (node.end_lineno or node.lineno) + 1)


@dataclass
class _ClassInfo:
    name: str
    node: ast.ClassDef
    attrs: Set[str] = field(default_factory=set)
    lock_attrs: Set[str] = field(default_factory=set)
    # attr -> guarding lock expr (relative to the owning object)
    guarded: Dict[str, str] = field(default_factory=dict)
    guarded_lines: Dict[str, int] = field(default_factory=dict)
    owned: Set[str] = field(default_factory=set)
    # Condition alias: attr -> underlying lock attr
    aliases: Dict[str, str] = field(default_factory=dict)
    # attr -> (line, value-is-threading-object) for CL03
    mutable_attrs: Dict[str, int] = field(default_factory=dict)
    sync_attrs: Set[str] = field(default_factory=set)
    spawns: bool = False


def _walk_class(node: ast.ClassDef) -> Iterable[ast.AST]:
    """ast.walk over one class, stopping at NESTED ClassDef boundaries
    (a class defined inside a method is its own analysis unit)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if isinstance(cur, ast.ClassDef):
            continue
        stack.extend(ast.iter_child_nodes(cur))


def _collect_class(node: ast.ClassDef, ann: _Annotations) -> _ClassInfo:
    info = _ClassInfo(name=node.name, node=node)
    for stmt in node.body:  # class-level (dataclass) fields
        target: Optional[ast.expr] = None
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.AnnAssign):
            target, value = stmt.target, stmt.value
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target, value = stmt.targets[0], stmt.value
        if isinstance(target, ast.Name):
            _note_attr(info, target.id, stmt, value, ann)
    for sub in _walk_class(node):
        if isinstance(sub, ast.Call):
            term = _call_terminal(sub)
            if term in _SPAWN_NAMES:
                info.spawns = True
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "submit":
                info.spawns = True
        target2: Optional[ast.expr] = None
        value2: Optional[ast.expr] = None
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
            target2, value2 = sub.targets[0], sub.value
        elif isinstance(sub, ast.AnnAssign):
            target2, value2 = sub.target, sub.value
        elif isinstance(sub, ast.Assign):
            # multi-target: note every self.X without value analysis
            for t in sub.targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    info.attrs.add(t.attr)
            continue
        if isinstance(target2, ast.Attribute) \
                and isinstance(target2.value, ast.Name) \
                and target2.value.id == "self" \
                and isinstance(sub, ast.stmt):
            _note_attr(info, target2.attr, sub, value2, ann)
    return info


def _note_attr(info: _ClassInfo, attr: str, stmt: ast.stmt,
               value: Optional[ast.expr], ann: _Annotations) -> None:
    info.attrs.add(attr)
    if value is not None and _is_threading_call(value, _LOCKISH):
        term = _call_terminal(value)
        if term == "Condition" and isinstance(value, ast.Call) \
                and value.args:
            under = value.args[0]
            if isinstance(under, ast.Attribute):
                info.aliases[attr] = under.attr
            else:
                info.lock_attrs.add(attr)
        else:
            info.lock_attrs.add(attr)
    if value is not None and _is_threading_call(value, _SYNC_CALLS):
        info.sync_attrs.add(attr)
    lines = list(_node_lines(stmt))
    if stmt.lineno - 1 in ann.comment_only:
        # a pure-comment line directly above the assignment carries the
        # annotation when the statement line itself is too long
        lines.append(stmt.lineno - 1)
    for line in lines:
        guard = ann.guarded.get(line)
        if guard is not None and attr not in info.guarded:
            info.guarded[attr] = guard
            info.guarded_lines[attr] = line
        if line in ann.owned:
            info.owned.add(attr)
    if _is_mutable_value(value) and attr not in info.mutable_attrs:
        info.mutable_attrs[attr] = stmt.lineno


def _func_requires(node: ast.AST, ann: _Annotations) -> List[str]:
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    first_body = node.body[0].lineno if node.body else node.lineno
    out: List[str] = []
    for line in range(node.lineno - 1, first_body):
        out.extend(ann.requires.get(line, []))
    return out


class _Analyzer:
    def __init__(self, source: str, path: str) -> None:
        self.path = path
        self.source = source
        self.ann = _Annotations.scan(source)
        self.tree = ast.parse(source, filename=path)
        self.findings: List[Finding] = []
        self.classes: List[_ClassInfo] = [
            _collect_class(n, self.ann) for n in ast.walk(self.tree)
            if isinstance(n, ast.ClassDef)]
        # file-level attr -> set of lock exprs (union across classes; an
        # access is satisfied by ANY of them — same-named attrs in one
        # file should share a discipline, see module docstring)
        self.guards: Dict[str, Set[str]] = {}
        self.owned_attrs: Set[str] = set()
        self.aliases: Dict[str, str] = {}
        for cls in self.classes:
            for attr, lock in cls.guarded.items():
                self.guards.setdefault(attr, set()).add(lock)
            self.owned_attrs |= cls.owned
            self.aliases.update(cls.aliases)
        # file-level name -> requires list (method/function names)
        self.requires_funcs: Dict[str, List[str]] = {}
        for n in ast.walk(self.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                reqs = _func_requires(n, self.ann)
                if reqs:
                    self.requires_funcs[n.name] = reqs
        # file-level final-segment names known to BE locks (CL05):
        # Lock/RLock/Condition attributes plus Condition aliases
        self.lock_names: Set[str] = set()
        for cls in self.classes:
            self.lock_names |= cls.lock_attrs
            self.lock_names |= set(cls.aliases)

    # ------------------------------------------------------------- helpers

    def _emit(self, rule: str, line: int, message: str,
              hint: str = "") -> None:
        if not self.ann.ignored(line, rule):
            self.findings.append(
                Finding(rule, self.path, line, message, hint))

    def _expand_held(self, text: str) -> Set[str]:
        """A held lock text plus its Condition-alias expansion
        (holding ``fake._changed`` is holding ``fake._lock``)."""
        out = {text}
        head, _, last = text.rpartition(".")
        resolved = self.aliases.get(last)
        if resolved is not None:
            out.add(f"{head}.{resolved}" if head else resolved)
        return out

    # --------------------------------------------------------------- CL02

    def check_annotations(self) -> None:
        for cls in self.classes:
            for attr, lock in cls.guarded.items():
                first = lock.split(".")[0]
                line = cls.guarded_lines.get(attr, cls.node.lineno)
                if first not in cls.attrs:
                    self._emit(
                        RULE_UNKNOWN_LOCK, line,
                        f"{cls.name}.{attr} is guarded-by {lock!r}, but "
                        f"{first!r} is not an attribute of {cls.name}",
                        "fix the annotation or create the lock in "
                        "__init__")
                elif "." not in lock and first not in cls.lock_attrs \
                        and first not in cls.aliases:
                    self._emit(
                        RULE_UNKNOWN_LOCK, line,
                        f"{cls.name}.{attr} is guarded-by {lock!r}, but "
                        f"{first!r} is not a threading.Lock/RLock/"
                        f"Condition attribute of {cls.name}",
                        "guard with a real lock attribute")
            for fn in _walk_class(cls.node):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                for req in _func_requires(fn, self.ann):
                    if not req.startswith("self."):
                        continue  # closure-named lock: not verifiable
                    first = req.split(".")[1]
                    if first not in cls.attrs:
                        self._emit(
                            RULE_UNKNOWN_LOCK, fn.lineno,
                            f"{cls.name}.{fn.name} requires {req!r}, "
                            f"but {first!r} is not an attribute of "
                            f"{cls.name}",
                            "fix the annotation or create the lock")

    # --------------------------------------------------------------- CL03

    def check_shared_mutables(self) -> None:
        for cls in self.classes:
            if not (cls.lock_attrs or cls.spawns):
                continue
            why = ("spawns threads" if cls.spawns else
                   "owns a lock")
            for attr, line in sorted(cls.mutable_attrs.items()):
                if attr in cls.guarded or attr in cls.owned \
                        or attr in cls.sync_attrs:
                    continue
                self._emit(
                    RULE_UNANNOTATED_SHARED, line,
                    f"{cls.name}.{attr} is a mutable container on a "
                    f"class that {why}, with no concurrency "
                    "annotation",
                    "annotate '# guarded-by: <lock>' or "
                    "'# thread-owned'")

    # --------------------------------------------------------------- CL01

    def check_guarded_access(self) -> None:
        for fn in ast.walk(self.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                held: Set[str] = set()
                for req in _func_requires(fn, self.ann):
                    held |= self._expand_held(req)
                self._check_body(fn, list(fn.body), held)

    def _check_body(self, fn: ast.AST, stmts: Sequence[ast.stmt],
                    held: Set[str]) -> None:
        for stmt in stmts:
            self._check_stmt(fn, stmt, held)

    def _check_stmt(self, fn: ast.AST, stmt: ast.stmt,
                    held: Set[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separate scope: withs here do not guard it
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in stmt.items:
                self._check_expr(fn, item.context_expr, held)
                text = _expr_text(item.context_expr)
                if text is not None:
                    inner |= self._expand_held(text)
            self._check_body(fn, stmt.body, inner)
            return
        # every other statement: check contained expressions, recurse
        # into child statement blocks with the SAME held set
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._check_stmt(fn, child, held)
            elif isinstance(child, ast.expr):
                self._check_expr(fn, child, held)
            else:
                # structural carriers (excepthandler, match_case,
                # keyword, withitem...): recurse one level generically
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.stmt):
                        self._check_stmt(fn, sub, held)
                    elif isinstance(sub, ast.expr):
                        self._check_expr(fn, sub, held)

    def _check_expr(self, fn: ast.AST, expr: ast.expr,
                    held: Set[str]) -> None:
        # lambda bodies are checked with the ENCLOSING held set — most
        # lambdas here run synchronously under the same locks (sort
        # keys, filters); a lambda smuggled across a thread boundary is
        # CL04's territory, not CL01's
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute):
                self._check_attribute(fn, node, held)
            elif isinstance(node, ast.Call):
                self._check_requires_call(node, held)

    def _check_attribute(self, fn: ast.AST, node: ast.Attribute,
                         held: Set[str]) -> None:
        locks = self.guards.get(node.attr)
        if not locks:
            return
        func_name = getattr(fn, "name", "")
        if func_name in _CTOR_NAMES:
            return  # construction happens-before publication
        recv = _expr_text(node.value)
        if recv is None:
            return  # unnameable receiver: out of textual-matching scope
        required = {f"{recv}.{lock}" for lock in locks}
        if required & held:
            return
        self._emit(
            RULE_UNGUARDED, node.lineno,
            f"access to guarded attribute {recv}.{node.attr} without "
            f"holding {' or '.join(sorted(required))}",
            f"wrap in 'with {sorted(required)[0]}:' or annotate the "
            "enclosing function '# requires: ...'")

    def _check_requires_call(self, node: ast.Call,
                             held: Set[str]) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        reqs = self.requires_funcs.get(node.func.attr)
        if not reqs:
            return
        recv = _expr_text(node.func.value)
        if recv is None:
            return
        for req in reqs:
            target = (recv + req[len("self"):]
                      if req.startswith("self.") else req)
            if not (self._expand_held(target) & held
                    or target in held):
                self._emit(
                    RULE_UNGUARDED, node.lineno,
                    f"call to {recv}.{node.func.attr}() requires "
                    f"{target} held",
                    f"wrap the call in 'with {target}:'")

    # --------------------------------------------------------------- CL04

    def _thread_entry_functions(self) -> List[ast.AST]:
        entry_names: Set[str] = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            term = _call_terminal(node)
            candidate: Optional[ast.expr] = None
            if term in ("Thread",):
                for kw in node.keywords:
                    if kw.arg == "target":
                        candidate = kw.value
            elif term in ("Timer",):
                if len(node.args) >= 2:
                    candidate = node.args[1]
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "submit" and node.args:
                candidate = node.args[0]
            if isinstance(candidate, ast.Name):
                entry_names.add(candidate.id)
            elif isinstance(candidate, ast.Attribute):
                # bound-method targets (Thread(target=self._run)) match
                # any same-named def in this file — name-based, like the
                # requires-call check; subscripted/indirect callables
                # (pool.submit(TABLE[k], ...)) remain out of scope
                entry_names.add(candidate.attr)
        return [n for n in ast.walk(self.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name in entry_names]

    def check_span_parents(self) -> None:
        for fn in self._thread_entry_functions():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                is_span = (
                    (isinstance(node.func, ast.Name)
                     and node.func.id == "maybe_span")
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("maybe_span", "span")))
                if not is_span:
                    continue
                if any(kw.arg == "parent" for kw in node.keywords):
                    continue
                fn_name = getattr(fn, "name", "?")
                self._emit(
                    RULE_SPAN_PARENT, node.lineno,
                    f"span created in thread-entry function "
                    f"{fn_name!r} without explicit parent=: the "
                    "per-thread span stack does not cross threads",
                    "capture the parent span before spawning and pass "
                    "parent=...")

    # --------------------------------------------------------------- CL05

    def _lockish_with_item(self, expr: ast.expr) -> Optional[str]:
        """The context expression's dotted text when it names a lock —
        final segment ends in ``lock`` (``self._lock``, ``cache_lock``,
        ``tracer.lock``) or is a known Lock/Condition attribute of a
        class in this file; None for everything else (files, sockets,
        span scopes, ExitStack...)."""
        text = _expr_text(expr)
        if text is None:
            return None
        last = text.split(".")[-1]
        if last.lower().endswith("lock") or last in self.lock_names:
            return text
        return None

    def _io_call_desc(self, node: ast.Call) -> Optional[str]:
        """Short description when ``node`` is blocking I/O by CL05's
        definition, else None."""
        func = node.func
        if isinstance(func, ast.Name):
            if func.id == "open" or func.id in _IO_TERMINALS:
                return f"{func.id}()"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv = _expr_text(func.value)
        if func.attr in _IO_TERMINALS:
            return f"{recv or '...'}.{func.attr}()"
        if recv is None:
            return None
        if recv == "os":
            return (f"os.{func.attr}()"
                    if func.attr in _OS_IO_TERMINALS else None)
        if recv.split(".")[-1].lstrip("_").lower() in _IO_RECEIVERS:
            return f"{recv}.{func.attr}()"
        return None

    def check_io_under_lock(self) -> None:
        for fn in ast.walk(self.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._io_walk(list(fn.body), None)

    def _io_walk(self, stmts: Sequence[ast.stmt],
                 lock: Optional[Tuple[str, int]]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # separate scope, visited as its own unit
            inner = lock
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._io_check_exprs(item.context_expr, lock)
                    text = self._lockish_with_item(item.context_expr)
                    if text is not None and inner is None:
                        inner = (text, stmt.lineno)
                self._io_walk(stmt.body, inner)
                continue
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    self._io_walk([child], lock)
                elif isinstance(child, ast.expr):
                    self._io_check_exprs(child, lock)
                else:
                    for sub in ast.iter_child_nodes(child):
                        if isinstance(sub, ast.stmt):
                            self._io_walk([sub], lock)
                        elif isinstance(sub, ast.expr):
                            self._io_check_exprs(sub, lock)

    def _io_check_exprs(self, expr: ast.expr,
                        lock: Optional[Tuple[str, int]]) -> None:
        if lock is None:
            return
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            desc = self._io_call_desc(node)
            if desc is None:
                continue
            self._emit(
                RULE_IO_UNDER_LOCK, node.lineno,
                f"blocking I/O {desc} inside 'with {lock[0]}:' "
                f"(line {lock[1]}): locks are for state transitions, "
                "not wire/disk traffic",
                "hoist the I/O out of the lock body and publish its "
                "result under the lock")

    # ---------------------------------------------------------------- run

    def run(self) -> List[Finding]:
        self.check_annotations()
        self.check_shared_mutables()
        self.check_guarded_access()
        self.check_span_parents()
        self.check_io_under_lock()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings


def analyze_source(source: str, path: str = "<string>") -> List[Finding]:
    """Analyze one Python source text; returns sorted findings."""
    try:
        analyzer = _Analyzer(source, path)
    except SyntaxError as exc:
        return [Finding(RULE_PARSE, path, exc.lineno or 0,
                        f"cannot parse: {exc.msg}")]
    return analyzer.run()


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, _dirs, files in os.walk(path):
                for name in sorted(files):
                    if name.endswith(".py") \
                            and not name.endswith("_pb2.py"):
                        out.append(os.path.join(root, name))
        else:
            out.append(path)
    return out


def analyze_paths(paths: Sequence[str]) -> List[Finding]:
    """Analyze every ``.py`` under ``paths`` (dirs walked recursively;
    generated ``*_pb2.py`` skipped)."""
    findings: List[Finding] = []
    for file_path in _iter_py_files(paths):
        with open(file_path, encoding="utf-8") as f:
            findings.extend(analyze_source(f.read(), file_path))
    return findings


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "conlint: clean"
    lines = [f.text() for f in findings]
    lines.append(f"conlint: {len(findings)} finding(s)")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry (``python -m tpu_cluster_torch conlint``).
    Exit 0 = clean, 1 = findings, 2 = bad invocation."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="concurrency_lint",
        description="guarded-by concurrency lint (rules CL01-CL05); "
                    "see tpu_cluster_torch/conlint.py for the annotation "
                    "grammar")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the "
                         "tpu_cluster_torch package)")
    ap.add_argument("--format", choices=("table", "json"),
                    default="table")
    args = ap.parse_args(argv)
    paths = list(args.paths)
    if not paths:
        paths = [os.path.dirname(os.path.abspath(__file__))]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"conlint: no such path(s): {missing}", file=sys.stderr)
        return 2
    findings = analyze_paths(paths)
    if args.format == "json":
        print(json.dumps({"ok": not findings,
                          "findings": [f.to_dict() for f in findings]}))
    else:
        print(format_findings(findings),
              file=sys.stderr if findings else sys.stdout)
    return 1 if findings else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
