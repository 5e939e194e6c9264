"""Kernel ruleset over ``src/repro_torch/kernels/*.py``, copied from the
reference's Pallas ruleset.

Kernel bodies are identified structurally: any function with a parameter
named ``*_ref`` (the Pallas ref-passing convention).  Rules:

* ``kernel/traced-branch`` — Python ``if``/``while``/ternary on a value
  read from a ref (or derived from ``program_id``).  Tracing would bake
  one branch in; use ``jnp.where`` / ``lax.select`` instead.  Taint is a
  simple forward pass: ref reads and ``program_id`` results taint names,
  assignments propagate.  Keyword-only params are static-by-convention
  (closure-bound Python ints) and never taint.
* ``kernel/host-callback`` — ``print`` / ``debug.print`` /
  ``debug.callback`` / ``io_callback`` / ``pure_callback`` /
  ``host_callback`` inside a kernel body.
* ``kernel/nonstatic-grid`` — ``jnp.``/``jax.`` calls inside a
  ``pallas_call`` ``grid=`` expression or a ``BlockSpec`` shape (grids
  must be Python ints at trace time).  One level of local-variable
  indirection is followed (``grid = (...); pallas_call(..., grid=grid)``).
* ``kernel/ceil-div`` — padding must use the two-step ceil-div form
  (``rows = -(-n // lanes)`` then ``-(-rows // RT) * RT``), not a nested
  ``-(-(-(-n // lanes)) // RT)`` one-liner; the nested form invites
  sign/precedence mistakes and is hard to review.  Checked module-wide
  (padding lives in host wrappers).

In the port only ``kernel/ceil-div`` has a subject: it covers the
wrappers' padding in ``kernels/*.py``.  The kernel bodies are CUDA C++
(``csrc/*.cu``), so no Python function has a ``*_ref`` parameter and
the three kernel-body rules (``traced-branch``, ``host-callback``,
``nonstatic-grid``) find nothing to check; they stay so that a Python
kernel body added later is checked as the reference's are.  The CUDA
side's counterpart is ``chip_smoke.py``'s ptxas check
(``PTXAS_CHECKED``: no stack frame or spill in any kernel).
"""

from __future__ import annotations

import ast

from .findings import Finding

_HOST_CALLS = {"print", "debug_print", "io_callback", "pure_callback",
               "host_callback", "callback"}


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _is_kernel_fn(fn) -> bool:
    args = fn.args
    params = [*args.posonlyargs, *args.args]
    return any(p.arg.endswith("_ref") for p in params)


def _names_in(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _jax_calls_in(node) -> list[ast.Call]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            root = fn
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id in ("jnp", "jax",
                                                          "lax", "pl"):
                out.append(sub)
    return out


def _is_ceil_div(node) -> bool:
    return (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.BinOp)
            and isinstance(node.operand.op, ast.FloorDiv)
            and isinstance(node.operand.left, ast.UnaryOp)
            and isinstance(node.operand.left.op, ast.USub))


class _KernelChecker:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.findings: list[Finding] = []

    def report(self, rule, line, message, detail=""):
        self.findings.append(Finding(rule, self.path, line, message, detail))

    # -- traced branches + host callbacks (kernel bodies only) ----------

    def _taint(self, fn) -> set[str]:
        args = fn.args
        tainted = {p.arg for p in [*args.posonlyargs, *args.args]
                   if p.arg.endswith("_ref")}

        def expr_tainted(expr) -> bool:
            if _names_in(expr) & tainted:
                return True
            return any(_call_name(c) == "program_id"
                       for c in ast.walk(expr) if isinstance(c, ast.Call))

        for _ in range(2):  # two passes reach a fixpoint for simple chains
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and expr_tainted(node.value):
                    for tgt in node.targets:
                        tainted.update(_names_in(tgt))
                elif (isinstance(node, (ast.AnnAssign, ast.AugAssign))
                        and node.value is not None
                        and expr_tainted(node.value)):
                    tainted.update(_names_in(node.target))
        return tainted

    def _check_kernel_fn(self, fn):
        tainted = self._taint(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                hot = sorted(_names_in(node.test) & tainted)
                if hot:
                    kind = ("ternary" if isinstance(node, ast.IfExp) else
                            "while" if isinstance(node, ast.While) else "if")
                    self.report(
                        "kernel/traced-branch", node.lineno,
                        f"Python {kind} on traced value(s) "
                        f"{', '.join(hot)} in kernel {fn.name!r}; use "
                        f"jnp.where/lax.select",
                        detail=f"{fn.name}:{','.join(hot)}")
            elif isinstance(node, ast.Call):
                name = _call_name(node)
                if name in _HOST_CALLS or (
                        name == "print" and isinstance(node.func, ast.Name)):
                    self.report(
                        "kernel/host-callback", node.lineno,
                        f"host callback {name!r} inside kernel body "
                        f"{fn.name!r}", detail=f"{fn.name}:{name}")

    # -- static grids / BlockSpecs ---------------------------------------

    def _check_grid_exprs(self, fn):
        local_assigns: dict[str, ast.expr] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    local_assigns[tgt.id] = node.value

        def resolve(expr):
            if isinstance(expr, ast.Name) and expr.id in local_assigns:
                return local_assigns[expr.id]
            return expr

        def flag_dynamic(expr, what, line):
            for call in _jax_calls_in(resolve(expr)):
                self.report(
                    "kernel/nonstatic-grid", line,
                    f"{what} uses a traced computation "
                    f"({ast.unparse(call.func)}(...)); grids and block "
                    f"shapes must be static Python ints",
                    detail=f"{fn.name}:{what}")

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "pallas_call":
                for kw in node.keywords:
                    if kw.arg == "grid":
                        flag_dynamic(kw.value, "pallas_call grid",
                                     kw.value.lineno)
            elif name == "BlockSpec":
                if node.args:
                    flag_dynamic(node.args[0], "BlockSpec shape",
                                 node.args[0].lineno)
                for kw in node.keywords:
                    if kw.arg in ("block_shape", "shape"):
                        flag_dynamic(kw.value, "BlockSpec shape",
                                     kw.value.lineno)

    # -- ceil-div form (module-wide) -------------------------------------

    def _check_ceil_div(self):
        flagged: set[int] = set()
        for node in ast.walk(self.tree):
            if not _is_ceil_div(node):
                continue
            inner = node.operand.left.operand  # the x in -(-x // y)
            for sub in ast.walk(inner):
                if _is_ceil_div(sub):
                    if node.lineno not in flagged:
                        flagged.add(node.lineno)
                        self.report(
                            "kernel/ceil-div", node.lineno,
                            "nested ceil-div one-liner; use the two-step "
                            "form: rows = -(-n // lanes); "
                            "rows_p = -(-rows // RT) * RT",
                            detail=f"line-pattern:{ast.unparse(node)}")
                    break

    def run(self) -> list[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _is_kernel_fn(node):
                    self._check_kernel_fn(node)
                self._check_grid_exprs(node)
        self._check_ceil_div()
        return self.findings


def check_source(path: str, source: str) -> list[Finding]:
    # nested defs are walked from both the enclosing function and their
    # own FunctionDef node; dedupe identical reports
    seen, out = set(), []
    for f in _KernelChecker(path, ast.parse(source)).run():
        ident = (f.rule, f.line, f.detail)
        if ident not in seen:
            seen.add(ident)
            out.append(f)
    return out


def check_file(path: str) -> list[Finding]:
    with open(path) as fh:
        return check_source(path, fh.read())
