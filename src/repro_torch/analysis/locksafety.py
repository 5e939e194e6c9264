"""Lock-discipline pass: ``# guarded-by:`` annotation checker.

Fields are declared guarded where they are first assigned::

    class IndexWriter:
        def __init__(self):
            self._lock = make_lock("writer")
            self._segments = []   # guarded-by: _lock

After that, every ``self._segments`` read or write anywhere in the class
must happen lexically inside ``with self._lock:`` (rule
``lock/unguarded-read`` / ``lock/unguarded-write``).  Module-level names
work the same way (``_pending = []  # guarded-by: _pending_lock`` in
``dist/checkpoint.py``), guarded by a module-level ``with _pending_lock:``.

Escapes, both explicit and narrow:

* ``def _helper(self):  # holds-lock: _lock`` — the caller owns the lock;
  the body is checked as if the lock were held.
* ``x = self._segments  # analysis-ok: lock/unguarded-read <reason>`` —
  per-line suppression for intentional racy reads.
* ``__init__`` / ``__post_init__`` are construction, exempt.

The port carries the reference's annotations on its own copies:
``core/{query,lifecycle}.py``, ``dist/{serve_plane,checkpoint}.py``,
``workload/stats.py`` and ``launch/serve.py``.  A copy of the
reference's ``src/repro/analysis/locksafety.py``.

The checker is lexical, not interprocedural: a nested ``def`` inside a
method starts with no held locks (it may run later, on another thread)
unless it carries its own ``holds-lock`` annotation.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize

from .findings import Finding

_GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"holds-lock:\s*([A-Za-z_]\w*)")
_OK_RE = re.compile(r"analysis-ok\b")

_CTOR_NAMES = ("__init__", "__post_init__")


def _comments_by_line(source: str) -> dict[int, str]:
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenError:
        pass
    return out


class _Annotations:
    def __init__(self, source: str):
        self.comments = _comments_by_line(source)

    def guard_for(self, line: int):
        m = _GUARDED_RE.search(self.comments.get(line, ""))
        return m.group(1) if m else None

    def holds_for(self, line: int):
        m = _HOLDS_RE.search(self.comments.get(line, ""))
        return m.group(1) if m else None

    def suppressed(self, line: int) -> bool:
        return bool(_OK_RE.search(self.comments.get(line, "")))


def _assign_targets(node):
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        return [node.target]
    return []


def _self_attr(node):
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"):
        return node.attr
    return None


def _with_locks(node, *, for_self: bool):
    """Lock names entered by a ``with`` statement (self-attribute locks
    for methods, bare names at module level; both always collected)."""
    names = []
    for item in node.items:
        expr = item.context_expr
        attr = _self_attr(expr)
        if attr is not None:
            names.append(attr)
        elif isinstance(expr, ast.Name):
            names.append(expr.id)
    return names


class _FunctionChecker(ast.NodeVisitor):
    """Walk one function body tracking the lexically-held lock set."""

    def __init__(self, pass_, guarded: dict[str, str], *, self_based: bool,
                 held: frozenset):
        self.pass_ = pass_
        self.guarded = guarded   # field name -> lock name
        self.self_based = self_based
        self.held = held

    def _check(self, name: str | None, node, ctx):
        if name is None or name not in self.guarded:
            return
        lock = self.guarded[name]
        if lock in self.held:
            return
        if self.pass_.ann.suppressed(node.lineno):
            return
        kind = "read" if isinstance(ctx, ast.Load) else "write"
        self.pass_.report(
            f"lock/unguarded-{kind}", node.lineno,
            f"access to {name!r} outside `with {lock}`",
            detail=f"{self.pass_.scope}:{name}:{kind}",
        )

    def visit_Attribute(self, node):
        if self.self_based:
            self._check(_self_attr(node), node, node.ctx)
        self.generic_visit(node)

    def visit_Name(self, node):
        if not self.self_based:
            self._check(node.id, node, node.ctx)
        # no children

    def visit_With(self, node):
        entered = _with_locks(node, for_self=self.self_based)
        for item in node.items:  # the lock expression itself is exempt
            self.generic_visit(item)
        inner = _FunctionChecker(self.pass_, self.guarded,
                                 self_based=self.self_based,
                                 held=self.held | frozenset(entered))
        for stmt in node.body:
            inner.visit(stmt)

    visit_AsyncWith = visit_With

    def _nested_scope(self, node):
        held = frozenset()
        holds = self.pass_.ann.holds_for(node.lineno)
        if holds:
            held = frozenset({holds})
        inner = _FunctionChecker(self.pass_, self.guarded,
                                 self_based=self.self_based, held=held)
        for stmt in node.body:
            inner.visit(stmt)

    def visit_FunctionDef(self, node):
        self._nested_scope(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        pass


class LockPass:
    def __init__(self, path: str, source: str):
        self.path = path
        self.ann = _Annotations(source)
        self.tree = ast.parse(source)
        self.findings: list[Finding] = []
        self.scope = ""

    def report(self, rule, line, message, detail=""):
        self.findings.append(
            Finding(rule, self.path, line, message, detail))

    # -- collection ------------------------------------------------------

    def _collect_class_guards(self, cls: ast.ClassDef) -> dict[str, str]:
        guarded: dict[str, str] = {}
        for stmt in ast.walk(cls):
            if (isinstance(stmt, ast.FunctionDef)
                    and stmt.name in _CTOR_NAMES):
                for sub in ast.walk(stmt):
                    for tgt in _assign_targets(sub):
                        name = _self_attr(tgt)
                        if name is None:
                            continue
                        lock = self.ann.guard_for(sub.lineno)
                        if lock:
                            guarded[name] = lock
        for stmt in cls.body:  # class-level declarations too
            for tgt in _assign_targets(stmt):
                if isinstance(tgt, ast.Name):
                    lock = self.ann.guard_for(stmt.lineno)
                    if lock:
                        guarded[tgt.id] = lock
        return guarded

    def _collect_module_guards(self) -> dict[str, str]:
        guarded: dict[str, str] = {}
        for stmt in self.tree.body:
            for tgt in _assign_targets(stmt):
                if isinstance(tgt, ast.Name):
                    lock = self.ann.guard_for(stmt.lineno)
                    if lock:
                        guarded[tgt.id] = lock
        return guarded

    # -- checking --------------------------------------------------------

    def _check_function(self, fn, guarded, *, self_based: bool):
        held = frozenset()
        holds = self.ann.holds_for(fn.lineno)
        if holds:
            held = frozenset({holds})
        checker = _FunctionChecker(self, guarded, self_based=self_based,
                                   held=held)
        for stmt in fn.body:
            checker.visit(stmt)

    def run(self) -> list[Finding]:
        module_guards = self._collect_module_guards()
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                guarded = self._collect_class_guards(node)
                if guarded:
                    self.scope = node.name
                    for stmt in node.body:
                        if (isinstance(stmt, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                                and stmt.name not in _CTOR_NAMES):
                            self._check_function(stmt, guarded,
                                                 self_based=True)
            elif (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and module_guards):
                self.scope = "<module>"
                self._check_function(node, module_guards, self_based=False)
        return self.findings


def check_source(path: str, source: str) -> list[Finding]:
    return LockPass(path, source).run()


def check_file(path: str) -> list[Finding]:
    with open(path) as fh:
        return check_source(path, fh.read())
