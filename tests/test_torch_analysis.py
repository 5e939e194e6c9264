"""The port's static lint (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the same sources.

* Every fixture source of ``tests/test_analysis.py`` (each source literal
  it passes through ``textwrap.dedent`` or assigns, and the sources it
  composes from them), and the reference's and the port's lifecycle
  modules with every ``with self._lock:`` removed: each pass of the port
  (lock, backend, container, kernel, api) gives the reference pass's
  ``(rule, path, line, message, detail)`` list.
* The baseline round trip and ``new_findings`` agree; the CLI's exit
  codes and lines agree for a clean tree and for a new finding (the
  package name aside).
* The port's tree is clean against ``analysis_torch_baseline.json``
  (``{}``), and the run opens no file under ``src/repro/``.
* A mutation is caught: each ``with self._lock:`` of
  ``src/repro_torch/core/lifecycle.py`` removed in turn, in memory.
"""

import ast
import builtins
import json
import os
import textwrap
from pathlib import Path

import pytest

from repro import analysis as ref
from repro.analysis import __main__ as ref_main
from repro.analysis import apicheck as ref_api
from repro.analysis import backendcheck as ref_backend
from repro.analysis import containercheck as ref_container
from repro.analysis import kernelcheck as ref_kernel
from repro.analysis import locksafety as ref_lock
from repro_torch import analysis as port
from repro_torch.analysis import __main__ as port_main
from repro_torch.analysis import (apicheck, backendcheck, containercheck,
                                  kernelcheck, locksafety)

REPO = Path(__file__).resolve().parents[1]
LOCKED = "with self._lock:"


def _fixture_sources():
    """{name: source} of every fixture in tests/test_analysis.py."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    out, consts = {}, {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and isinstance(node.value.args[0], ast.Constant)):
            consts[node.targets[0].id] = textwrap.dedent(
                node.value.args[0].value)
            out[node.targets[0].id] = consts[node.targets[0].id]
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for i, node in enumerate(ast.walk(fn)):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and "\n" in node.value and len(node.value) > 20):
                out[f"{fn.name}:{i}"] = textwrap.dedent(node.value)
    # the sources the tests compose from the module-level fixtures
    out["lock+peek"] = consts["LOCK_FIXTURE"] + textwrap.dedent("""
        def peek(self):
            return self._segments
    """).replace("\n", "\n    ")
    out["backend+undeclared"] = consts["BACKEND_FIXTURE"].replace(
        'PLAN_NODE_KINDS = ("leaf", "not", "fold")',
        'PLAN_NODE_KINDS = ("leaf", "not", "fold", "xor")') + textwrap.dedent(
        """
        def sneak(c):
            return ("shiny", (c,))
    """)
    for pkg in ("repro", "repro_torch"):
        src = (REPO / "src" / pkg / "core" / "lifecycle.py").read_text()
        out[f"{pkg}.lifecycle"] = src
        out[f"{pkg}.lifecycle-unlocked"] = src.replace(
            LOCKED, "if True:  # lock removed")
    return out


FIXTURES = _fixture_sources()


def rows(findings):
    return [(f.rule, f.path, f.line, f.message, f.detail) for f in findings]


def _passes(mod_lock, mod_backend, mod_container, mod_kernel, mod_api,
            source):
    out = {}
    for name, fn in (
            ("lock", lambda: mod_lock.check_source("fix.py", source)),
            ("backend", lambda: mod_backend.check_sources({"fix.py": source})),
            ("container",
             lambda: mod_container.check_sources({"fix.py": source})),
            ("kernel", lambda: mod_kernel.check_source("fix.py", source)),
            ("api", lambda: mod_api.check_deprecated_shims("fix.py",
                                                           source))):
        try:
            out[name] = rows(fn())
        except SyntaxError as exc:  # both parse the same source
            out[name] = f"SyntaxError: {exc.msg}"
    return out


def test_fixtures_found():
    names = set(FIXTURES)
    assert {"LOCK_FIXTURE", "BACKEND_FIXTURE", "KERNEL_FIXTURE"} <= names
    assert len(names) >= 20


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_passes_match_reference(name):
    src = FIXTURES[name]
    got = _passes(locksafety, backendcheck, containercheck, kernelcheck,
                  apicheck, src)
    want = _passes(ref_lock, ref_backend, ref_container, ref_kernel,
                   ref_api, src)
    assert got == want
    if name.endswith("lifecycle-unlocked"):
        assert any(r[0] == "lock/unguarded-write" for r in got["lock"])
        assert any("_segments" in r[3] for r in got["lock"])


def test_baseline_roundtrip_and_new_findings_match_reference(tmp_path):
    results = []
    for mod in (port, ref):
        old = [mod.Finding("lock/unguarded-read", "a.py", 10, "m",
                           "W:_x:read"),
               mod.Finding("lock/unguarded-read", "a.py", 44, "m",
                           "W:_x:read")]
        path = tmp_path / f"{mod.__name__}.json"
        saved = mod.save_baseline(path, old)
        baseline = mod.load_baseline(path)
        drifted = [mod.Finding("lock/unguarded-read", "a.py", 12, "m",
                               "W:_x:read"),
                   mod.Finding("lock/unguarded-read", "a.py", 46, "m",
                               "W:_x:read"),
                   mod.Finding("lock/unguarded-write", "a.py", 50, "m",
                               "W:_y:write")]
        results.append((saved, baseline, path.read_text(),
                        rows(mod.new_findings(drifted[:2], baseline)),
                        rows(mod.new_findings(drifted, baseline)),
                        mod.render_findings(drifted),
                        mod.load_baseline(tmp_path / "missing.json")))
    assert results[0] == results[1]
    assert results[0][4] == [("lock/unguarded-write", "a.py", 50, "m",
                              "W:_y:write")]


def test_rule_catalog():
    assert set(port.RULES) == set(ref.RULES) - {"api/unseeded-random"}


def _cli(main, argv, capsys):
    code = main(argv)
    cap = capsys.readouterr()
    return code, cap.out.replace("repro_torch", "repro"), cap.err


def test_cli_clean_tree_matches_reference(capsys):
    got = _cli(port_main.main, ["--root", "."], capsys)
    want = _cli(ref_main.main, ["--root", "."], capsys)
    assert got == want
    assert got[0] == 0 and "clean" in got[1]
    code, out, _ = _cli(port_main.main, ["--list-rules"], capsys)
    assert code == 0
    assert "lock/unguarded-write" in out and "kernel/ceil-div" in out


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_cli_new_finding_matches_reference(tmp_path, capsys, pkg):
    """The reference's CLI test tree, under each package's own path, run
    by both CLIs: the one whose package it is flags it, the other sees a
    tree without its package."""
    bad = tmp_path / "src" / pkg / "kernels"
    bad.mkdir(parents=True)
    (tmp_path / "src" / pkg / "core").mkdir()
    (bad / "k.py").write_text(
        "def k(x_ref, o_ref):\n"
        "    v = x_ref[0]\n"
        "    if v:\n"
        "        o_ref[0] = v\n")
    (tmp_path / "src" / pkg / "core" / "query.py").write_text(
        'PLAN_NODE_KINDS = ()\n')
    own, other = ((ref_main, port_main) if pkg == "repro"
                  else (port_main, ref_main))
    root = ["--root", str(tmp_path)]
    got = _cli(own.main, root, capsys)
    assert got[0] == 1 and "kernel/traced-branch" in got[1]
    # the same tree under the other package's path, through its CLI
    mirror = tmp_path / "mirror"
    other_pkg = "repro_torch" if pkg == "repro" else "repro"
    (mirror / "src").mkdir(parents=True)
    os.rename(tmp_path / "src" / pkg, mirror / "src" / other_pkg)
    want = _cli(other.main, ["--root", str(mirror)], capsys)
    assert got == want
    base = tmp_path / "b.json"
    for main, r in ((other, str(mirror)),):
        assert main.main(["--root", r, "--baseline", str(base),
                          "--update-baseline"]) == 0
        assert main.main(["--root", r, "--baseline", str(base)]) == 0


def test_port_tree_is_clean_and_never_opens_the_reference(monkeypatch):
    opened = []
    real_open = builtins.open

    def spy(path, *args, **kwargs):
        opened.append(os.path.abspath(str(path)))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy)
    findings = port.run_analysis(str(REPO))
    monkeypatch.undo()
    assert findings == []
    assert port.load_baseline(REPO / "analysis_torch_baseline.json") == {}
    assert port.new_findings(findings, port.load_baseline(
        REPO / "analysis_torch_baseline.json")) == []
    ref_dir = str(REPO / "src" / "repro") + os.sep
    assert opened and not [p for p in opened if p.startswith(ref_dir)]
    assert any(p.endswith(os.path.join("repro_torch", "core", "query.py"))
               for p in opened)
    assert not [p for p in opened if os.sep + "analysis" + os.sep in p]


def test_baseline_file_is_empty():
    assert json.loads((REPO / "analysis_torch_baseline.json").read_text()) \
        == {}


def _locked_sites():
    src = (REPO / "src" / "repro_torch" / "core" /
           "lifecycle.py").read_text()
    return src, [i for i in range(len(src)) if src.startswith(LOCKED, i)]


def test_lifecycle_has_locked_sites():
    assert len(_locked_sites()[1]) >= 5


@pytest.mark.parametrize("site", range(len(_locked_sites()[1])))
def test_removing_a_lock_is_flagged(site):
    """Delete one ``with self._lock:`` (its body kept, as the body of an
    ``if True:``) from a copy of the port's lifecycle source: the lock
    pass flags an unguarded access, and the reference pass agrees."""
    src, sites = _locked_sites()
    at = sites[site]
    mutated = src[:at] + "if True:  # lock removed" + src[at + len(LOCKED):]
    assert locksafety.check_source("lifecycle.py", src) == []
    found = rows(locksafety.check_source("lifecycle.py", mutated))
    assert found and all(r[0].startswith("lock/unguarded-") for r in found)
    assert found == rows(ref_lock.check_source("lifecycle.py", mutated))
