"""Container-class exhaustiveness pass.

Roaring container dispatch is positional: ``ContainerSet.classes`` stores
small integer class ids and every consumer branches on the named constants
(``ARRAY`` / ``BITMAP`` / ``RUN``, derived from the ``CONTAINER_CLASSES``
declaration in ``core/containers.py``).  A new container class added to the
declaration but not to every dispatch site would silently fall through —
the exact bug class ``backendcheck`` guards for plan-node kinds, one level
down.

The rule: in the covered files (``core/containers.py`` and
``core/query.py``, which hosts the torch backend's batched container
fold, ``TorchBackend._container_fold_many``),
**any function that compares against a container-class constant must
either compare against all declared classes or contain a ``raise``** (the
unknown-class guard).  Partial dispatch with a trailing raise is fine —
``_merge_chunk`` fast-paths array/bitmap pairs and raises on unknown ops —
but partial dispatch that falls through silently is a finding
(``container/missing-class``).  A missing or malformed declaration is
``container/missing-declaration``.

Class constants are recognized both as bare names (``cls == ARRAY``) and
as module attributes (``{ca, cb} == {C.ARRAY, C.BITMAP}``), including
inside tuple/list/set comparators.
"""

from __future__ import annotations

import ast

from .findings import Finding

DECL_NAME = "CONTAINER_CLASSES"


def _declared_classes(tree: ast.Module):
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


def _compared_classes(fn: ast.FunctionDef, class_names: set) -> set:
    """Class-constant names this function compares against."""
    seen: set = set()

    def collect(expr):
        if isinstance(expr, ast.Name) and expr.id in class_names:
            seen.add(expr.id)
        elif isinstance(expr, ast.Attribute) and expr.attr in class_names:
            seen.add(expr.attr)
        elif isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            for e in expr.elts:
                collect(e)

    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            collect(node.left)
            for comp in node.comparators:
                collect(comp)
    return seen


def _has_raise(fn: ast.FunctionDef) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(fn))


def check_sources(sources: dict[str, str]) -> list[Finding]:
    """``sources`` maps display path -> source text; the declaration is
    looked up across all of them (it lives in containers.py)."""
    findings: list[Finding] = []
    trees = {path: ast.parse(src) for path, src in sources.items()}

    declared = None
    for path, tree in trees.items():
        classes, _line = _declared_classes(tree)
        if classes is not None:
            declared = classes
            break
    if not declared:
        first = next(iter(sources))
        findings.append(Finding(
            "container/missing-declaration", first, 1,
            f"no {DECL_NAME} declaration found", detail=DECL_NAME))
        return findings
    class_names = {c.upper() for c in declared}

    for path, tree in trees.items():
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            compared = _compared_classes(node, class_names)
            if not compared:
                continue
            if compared == class_names or _has_raise(node):
                continue
            missing = ", ".join(sorted(class_names - compared))
            findings.append(Finding(
                "container/missing-class", path, node.lineno,
                f"{node.name} dispatches on container classes "
                f"{sorted(compared)} without covering {missing} or "
                f"raising on the fall-through", detail=node.name))
    return findings


def check_files(paths) -> list[Finding]:
    sources = {}
    for path in paths:
        with open(path) as fh:
            sources[str(path)] = fh.read()
    return check_sources(sources)
