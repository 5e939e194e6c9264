"""``kernels/build.py`` builds each library once across processes.

There is no nvcc here, so a stub compiler (a Python script that records
its call, sleeps, prints a ptxas-like line and writes its ``-o`` file)
stands in for it.  Two processes call ``build_all`` at once over the same
build directory: the lock makes the second wait and find the first one's
libraries, so the stub runs once per library, both processes get the
same paths, and every ``<library>.log`` is whole (no temporary left
beside it).  A failing compile raises with its log and leaves no
library.  Every subprocess has its own timeout.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro_torch
from repro_torch.kernels import build

SRC = Path(repro_torch.__file__).resolve().parents[1]

STUB = """\
#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
name = os.path.basename(sys.argv[-1])
with open({calls!r}, "a") as f:
    f.write(f"{{os.getppid()}} {{name}}\\n")
if "broken" in name:
    print("error: the stub refuses " + name)
    sys.exit(2)
time.sleep(1.0)
print(f"ptxas info    : Used 12 registers, compiling {{name}}")
with open(out, "wb") as f:
    f.write(b"library")
"""


def stub_tree(tmp_path, names):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "common.cuh").write_text("// shared\n")
    for n in names:
        (csrc / f"{n}.cu").write_text(f"// {n}\n")
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc_stub.py"
    stub.write_text(STUB.format(python=sys.executable, calls=str(calls)))
    stub.chmod(0o755)
    return csrc, tmp_path / "build", stub, calls


def use_stub(monkeypatch, csrc, build_dir, stub):
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(build, "nvcc", lambda: str(stub))


def test_two_processes_build_each_library_once(tmp_path):
    names = ("alpha", "beta")
    csrc, build_dir, stub, calls = stub_tree(tmp_path, names)
    script = textwrap.dedent(f"""
        import json
        from pathlib import Path
        from repro_torch.kernels import build
        build.CSRC = Path({str(csrc)!r})
        build.BUILD_DIR = Path({str(build_dir)!r})
        build.nvcc = lambda: {str(stub)!r}
        paths = build.build_all({names!r})
        print(json.dumps({{k: str(v) for k, v in paths.items()}}))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    made = calls.read_text().split()
    assert sorted(made[1::2]) == ["alpha.cu", "beta.cu"]  # once each
    assert len(set(made[0::2])) == 1     # both by the process that won
    for name, path in outs[0].items():
        lib = Path(path)
        assert lib.read_bytes() == b"library"
        log = lib.with_suffix(".log").read_text()
        assert log.count("Used 12 registers") == 1 and f"{name}.cu" in log
    left = sorted(p.name for p in build_dir.iterdir()
                  if p.suffix in (".tmp",) or p.name.count(".") > 1)
    assert left == [], left


def test_built_library_is_not_compiled_again(tmp_path, monkeypatch):
    csrc, build_dir, stub, calls = stub_tree(tmp_path, ("gamma",))
    use_stub(monkeypatch, csrc, build_dir, stub)
    first = build.build_all(("gamma",))
    assert build.build_log("gamma").count("Used 12 registers") == 1
    assert build.resources("gamma") == {}    # no entry-function line
    again = build.build_all(("gamma",))
    assert first == again
    assert len(calls.read_text().splitlines()) == 1


def test_failed_build_raises_with_its_log(tmp_path, monkeypatch):
    csrc, build_dir, stub, calls = stub_tree(tmp_path, ("broken",))
    use_stub(monkeypatch, csrc, build_dir, stub)
    with pytest.raises(RuntimeError, match="the stub refuses broken.cu"):
        build.build_all(("broken",))
    assert not build.library_path("broken").exists()
    assert "refuses" in build.build_log("broken")
    assert [p.name for p in build_dir.iterdir()
            if p.suffix == ".tmp" or p.name.count(".") > 1] == []


def test_editing_any_header_rebuilds(tmp_path, monkeypatch):
    """A library's hash covers every csrc/*.cuh, not only common.cuh: an
    edit to another shared header gives a new library path, and the next
    build_all compiles it; a header added beside them does too."""
    csrc, build_dir, stub, calls = stub_tree(tmp_path, ("delta",))
    (csrc / "chain.cuh").write_text("// chain v1\n")
    use_stub(monkeypatch, csrc, build_dir, stub)
    first = build.build_all(("delta",))["delta"]
    (csrc / "chain.cuh").write_text("// chain v2\n")
    second = build.build_all(("delta",))["delta"]
    (csrc / "other.cuh").write_text("// new\n")
    third = build.build_all(("delta",))["delta"]
    assert len({first, second, third}) == 3
    assert all(p.exists() for p in (first, second, third))
    assert len(calls.read_text().splitlines()) == 3
    assert build.build_all(("delta",))["delta"] == third
    assert len(calls.read_text().splitlines()) == 3
