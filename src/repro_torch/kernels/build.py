"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each source ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

The hash covers the source, every shared header (``csrc/*.cuh``) and the
flags, so an edited kernel or header rebuilds and an unchanged one loads
from the previous build.  All
missing libraries build in parallel, one nvcc process each.  Nothing is
compiled when this module is imported: only a kernel's first launch (or
:func:`build_all`) calls nvcc, and a failed build raises.

Processes share the build: :func:`build_all` holds an exclusive
``fcntl.flock`` on ``BUILD_DIR/build.lock`` while it checks for and
compiles the missing libraries, so a second process (a serve-plane worker
beside another) waits and then loads what the first one built.  Each
compiler log is written beside a pid-suffixed temporary and moved into
place with its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from . import planfuse

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("planfuse", "recompress", "wordops", "slicefold", "ewah_decode",
           "containers", "bitpack", "gray", "histmm", "moe_route",
           "ewah_and_popcount", "ewah_encode")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOCK = threading.Lock()
_LIBS: dict = {}


def _flags() -> list:
    return [*ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v",
            f"-DMAX_TAPE_LEN={planfuse.MAX_TAPE_LEN}"]


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin directory on PATH)")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes at once; returns {name: library path}.  The compiler's
    output (ptxas register and shared-memory use) lands in
    ``<library>.log`` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    with open(BUILD_DIR / "build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        _compile_missing(paths)
    return paths


def _compile_missing(paths: dict) -> None:
    """The locked section of :func:`build_all`."""
    missing = [n for n, path in paths.items() if not path.exists()]
    if not missing:
        return
    compiler = nvcc()
    procs = {}
    for name in missing:
        path = paths[name]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log_tmp = path.with_suffix(f".{os.getpid()}.log")
        log = open(log_tmp, "w")
        procs[name] = (subprocess.Popen(
            [compiler, *_flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log, log_tmp)
    failed = []
    for name, (proc, tmp, log, log_tmp) in procs.items():
        rc = proc.wait()
        log.close()
        # atomic: readers never see a partial library or log
        os.replace(log_tmp, paths[name].with_suffix(".log"))
        if rc != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        details = "\n".join(
            f"--- {n}\n{paths[n].with_suffix('.log').read_text()}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{details}")


def build_log(name: str) -> str:
    """What nvcc printed when it built ``name`` (ptxas resource use)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def resources(name: str) -> dict:
    """Per-kernel resource use from ptxas's report in ``name``'s build log:
    ``{mangled name: {"registers", "stack_frame", "spill_stores",
    "spill_loads", "smem"}}`` (bytes; ``smem`` is the static shared
    memory)."""
    out: dict = {}
    current = None
    for line in build_log(name).splitlines():
        hit = re.search(r"(?:entry function|Function properties for) "
                        r"'?([\w$]+)'?", line)
        if hit:
            current = out.setdefault(hit.group(1), {})
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            current.update(zip(("stack_frame", "spill_stores", "spill_loads"),
                               map(int, frame.groups())))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(smem.group(1)) if smem else 0
    return out


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of library ``name``, built on first use,
    with its argument types declared (pointers and the stream as
    ``c_void_p``, so ctypes never narrows them to 32 bits)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError != 0)."""
    if code != 0:
        msg = _LIBS[name].repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")
