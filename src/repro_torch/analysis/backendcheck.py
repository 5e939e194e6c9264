"""Backend-exhaustiveness pass.

Plan nodes are plain tuples whose first element is the kind tag
(``("fold", ops, children)``, ``("leaf", i)``, ...).  The planner side
(the port's ``core/query.py`` + ``core/encodings.py``) declares the closed set in
``PLAN_NODE_KINDS`` and this pass cross-checks three things:

* every kind tag *constructed* by planner code appears in
  ``PLAN_NODE_KINDS`` (``backend/undeclared-kind`` — you added a node
  type without declaring it);
* every declared kind is *dispatched on* by every registered backend
  class (``backend/missing-kind`` — the bug class where a new node
  silently falls through one backend's combine loop);
* the declaration itself exists (``backend/missing-declaration``).

"Dispatched on" means the kind string appears in a comparison
(``==/!=/in/not in``) inside the backend class body; the explicit
``raise ValueError`` guards on the generic and/or arms exist so this
lexical test is sound.  The port registers ``NumpyBackend`` and
``TorchBackend``; both are checked.

Cache/structure-key helpers (``_sig``, ``_node_key``) build look-alike
tuples that are not plan nodes; they are excluded by name, as are the
backend class bodies themselves (consuming a kind is not emitting it).
"""

from __future__ import annotations

import ast
import re

from .findings import Finding

DECL_NAME = "PLAN_NODE_KINDS"

# helper functions that build tuple keys which are not plan nodes
_EXCLUDED_FUNCS = {"_sig", "_node_key"}

_KIND_RE = re.compile(r"^[a-z][a-z_]{0,15}$")


def _is_backend_class(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = getattr(target, "id", getattr(target, "attr", ""))
        if name == "register_backend":
            return True
    return node.name.endswith("Backend")


def _declared_kinds(tree: ast.Module):
    for node in ast.walk(tree):
        for tgt in (node.targets if isinstance(node, ast.Assign) else
                    [node.target] if isinstance(node, ast.AnnAssign) else []):
            if isinstance(tgt, ast.Name) and tgt.id == DECL_NAME:
                value = node.value
                if isinstance(value, (ast.Tuple, ast.List)):
                    return [e.value for e in value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)], node.lineno
    return None, 0


class _EmitCollector(ast.NodeVisitor):
    """Kind tags constructed by planner code (excluding key helpers and
    backend class bodies)."""

    def __init__(self):
        self.kinds: dict[str, int] = {}  # kind -> first line seen

    def visit_ClassDef(self, node):
        if not _is_backend_class(node):
            self.generic_visit(node)

    def visit_FunctionDef(self, node):
        if node.name not in _EXCLUDED_FUNCS:
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Tuple(self, node):
        all_str = all(isinstance(e, ast.Constant)
                      and isinstance(e.value, str) for e in node.elts)
        if (len(node.elts) >= 2 and not all_str  # all-string = __slots__ etc.
                and isinstance(node.elts[0], ast.Constant)
                and isinstance(node.elts[0].value, str)
                and _KIND_RE.match(node.elts[0].value)):
            self.kinds.setdefault(node.elts[0].value, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node):
        # _fanin("and", ...) constructs an ("and", children) node
        fn = getattr(node.func, "id", getattr(node.func, "attr", ""))
        if fn == "_fanin" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self.kinds.setdefault(arg.value, node.lineno)
        self.generic_visit(node)


def _dispatched_kinds(cls: ast.ClassDef) -> set[str]:
    kinds: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Compare):
            continue
        for expr in [node.left, *node.comparators]:
            if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
                kinds.add(expr.value)
            elif isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
                kinds.update(e.value for e in expr.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, str))
    return kinds


def check_sources(sources: dict[str, str]) -> list[Finding]:
    """``sources`` maps display path -> source text; the declaration is
    looked up across all of them (it lives in query.py)."""
    findings: list[Finding] = []
    trees = {path: ast.parse(src) for path, src in sources.items()}

    declared, decl_path = None, ""
    for path, tree in trees.items():
        kinds, line = _declared_kinds(tree)
        if kinds is not None:
            declared, decl_path = kinds, path
            break
    if declared is None:
        first = next(iter(sources))
        findings.append(Finding(
            "backend/missing-declaration", first, 1,
            f"no {DECL_NAME} declaration found", detail=DECL_NAME))
        return findings

    emitted: dict[str, tuple[str, int]] = {}
    for path, tree in trees.items():
        col = _EmitCollector()
        col.visit(tree)
        for kind, line in col.kinds.items():
            emitted.setdefault(kind, (path, line))

    for kind, (path, line) in sorted(emitted.items()):
        if kind not in declared:
            findings.append(Finding(
                "backend/undeclared-kind", path, line,
                f"plan-node kind {kind!r} constructed but not in "
                f"{DECL_NAME}", detail=kind))

    for path, tree in trees.items():
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and _is_backend_class(node):
                dispatched = _dispatched_kinds(node)
                for kind in declared:
                    if kind not in dispatched:
                        findings.append(Finding(
                            "backend/missing-kind", path, node.lineno,
                            f"{node.name} does not dispatch on plan-node "
                            f"kind {kind!r}", detail=f"{node.name}:{kind}"))
    return findings


def check_files(paths) -> list[Finding]:
    sources = {}
    for path in paths:
        with open(path) as fh:
            sources[str(path)] = fh.read()
    return check_sources(sources)
