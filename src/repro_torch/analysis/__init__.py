"""`repro_torch.analysis` — the port's invariant lint passes and runtime
sanitizers.

Static half (``python -m repro_torch.analysis``): AST passes, copied from
the reference's ``repro.analysis`` and pointed at ``src/repro_torch``,
that machine-check the contracts the tests can only sample — lock
discipline around the writer/compactor/admission/serve-plane/checkpoint
state, plan-node exhaustiveness across ``NumpyBackend`` and
``TorchBackend``, container-class dispatch, the kernel wrappers' padding
form, and API hygiene.  Pure stdlib ``ast``/``tokenize``.  The CUDA
kernels' counterpart is ``chip_smoke.py``'s ptxas check.

Runtime half (``REPRO_SANITIZE=1``): :func:`repro_torch.analysis.runtime.
maybe_validate` structural EWAH checks and
:func:`repro_torch.analysis.runtime.make_lock` order-tracked locks, copied
from the reference.

See ``docs/analysis.md`` for the rule catalog and baseline workflow; the
port's baseline is ``analysis_torch_baseline.json``.
"""

from __future__ import annotations

import os

from .findings import (Finding, load_baseline, new_findings,
                       render_findings, save_baseline)

__all__ = ["Finding", "RULES", "load_baseline", "new_findings",
           "render_findings", "run_analysis", "save_baseline"]

RULES = {
    "lock/unguarded-read":
        "read of a `# guarded-by:` field outside its `with <lock>` scope",
    "lock/unguarded-write":
        "write of a `# guarded-by:` field outside its `with <lock>` scope",
    "backend/missing-kind":
        "a registered backend does not dispatch on a declared plan-node "
        "kind",
    "backend/undeclared-kind":
        "planner code constructs a plan-node kind absent from "
        "PLAN_NODE_KINDS",
    "backend/missing-declaration":
        "PLAN_NODE_KINDS declaration not found",
    "container/missing-class":
        "a container-class dispatch covers only some CONTAINER_CLASSES "
        "and has no raise on the fall-through",
    "container/missing-declaration":
        "CONTAINER_CLASSES declaration not found",
    "kernel/traced-branch":
        "Python if/while/ternary on a traced value inside a kernel body",
    "kernel/host-callback":
        "host callback (print/debug.print/io_callback/...) inside a "
        "kernel body",
    "kernel/nonstatic-grid":
        "jnp/jax computation inside a pallas_call grid or BlockSpec shape",
    "kernel/ceil-div":
        "nested ceil-div one-liner instead of the two-step padding form",
    "api/deprecated-shim":
        "DeprecationWarning (removed compat shim) resurrected in src/",
    "budget/unbudgeted-cell":
        "dryrun cell has no collective-budget entry (report-only)",
}

_PKG = "src/repro_torch"

# files the lock pass covers are discovered by annotation, so it is safe
# (and cheap) to run it over the whole package
_BACKEND_FILES = (f"{_PKG}/core/query.py", f"{_PKG}/core/encodings.py")

# container-class dispatch sites: the numpy container module plus the
# torch backend's batched container fold (core/query.py)
_CONTAINER_FILES = (f"{_PKG}/core/containers.py", f"{_PKG}/core/query.py")


def _iter_py(root, rel):
    base = os.path.join(root, rel)
    for dirpath, _dirnames, filenames in os.walk(base):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _read(path):
    with open(path) as fh:
        return fh.read()


def run_analysis(root: str = ".") -> list[Finding]:
    """Run every static pass over the port at ``root``
    (``root/src/repro_torch``; the reference's ``src/repro`` is never
    opened); returns findings with paths relative to ``root``."""
    from . import (apicheck, backendcheck, containercheck, kernelcheck,
                   locksafety)

    findings: list[Finding] = []

    def relocated(path, found):
        rel = os.path.relpath(path, root)
        return [Finding(f.rule, rel, f.line, f.message, f.detail)
                for f in found]

    own = os.path.join(root, _PKG, "analysis") + os.sep
    for path in _iter_py(root, _PKG):
        if path.startswith(own):
            continue  # the analyzer does not lint itself
        source = _read(path)
        findings += relocated(path, locksafety.check_source(path, source))
        findings += relocated(path,
                              apicheck.check_deprecated_shims(path, source))

    for check, files in ((backendcheck.check_sources, _BACKEND_FILES),
                         (containercheck.check_sources, _CONTAINER_FILES)):
        sources = {rel: _read(os.path.join(root, rel)) for rel in files
                   if os.path.exists(os.path.join(root, rel))}
        findings += check(sources)

    for path in _iter_py(root, f"{_PKG}/kernels"):
        findings += relocated(path,
                              kernelcheck.check_source(path, _read(path)))
    return findings
