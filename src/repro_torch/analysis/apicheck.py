"""Deprecation / API-hygiene pass over ``src/repro_torch``.

* ``api/deprecated-shim`` — the bare-kwarg ``search(...)`` and
  ``_backend=`` compatibility shims were removed after their one-release
  deprecation window; any ``DeprecationWarning`` reappearing in ``src/``
  means a shim was resurrected instead of the call sites being fixed.
  Checked via AST (a comment merely *mentioning* the class is fine).

The reference's other API rule, ``api/unseeded-random``, scans every file
under ``tests/`` (the port's ``tests/test_torch_*.py`` included) from the
reference's own ``run_analysis``, so the port does not repeat it.
"""

from __future__ import annotations

import ast

from .findings import Finding


def check_deprecated_shims(path: str, source: str) -> list[Finding]:
    findings = []
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return findings
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id == "DeprecationWarning":
            findings.append(Finding(
                "api/deprecated-shim", path, node.lineno,
                "DeprecationWarning in src/ — compatibility shims were "
                "removed, do not resurrect them",
                detail="DeprecationWarning"))
    return findings
