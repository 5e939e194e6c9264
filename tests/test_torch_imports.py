"""Every module of the port imports on its own, star-imports cleanly, and
names in ``__all__`` only what it defines; the port as a whole loads
neither JAX nor anything of the reference package."""

import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

MODULES = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch."))


def test_modules_found():
    assert "repro_torch.core.ewah_stream" in MODULES
    assert "repro_torch.kernels.histmm" in MODULES
    assert {"repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.tinyllama_1_1b",
            "repro_torch.models.common", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.train.step",
            "repro_torch.serve.prefill",
            "repro_torch.launch.serve"} <= set(MODULES)


def test_training_modules_found():
    assert {"repro_torch.data.tokens", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.pytree", "repro_torch.launch.train",
            "repro_torch.dist.checkpoint"} <= set(MODULES)


def test_mesh_modules_found():
    assert {"repro_torch.launch.mesh", "repro_torch.launch.shapes",
            "repro_torch.dist.sharding", "repro_torch.models.common"} <= \
        set(MODULES)
    from repro_torch.models import attention, moe, ssm, transformer

    for fn in (attention.attention_axes, moe.moe_axes, ssm.mamba2_axes,
               transformer.layer_axes, transformer.params_axes,
               transformer.cache_axes):
        assert callable(fn)


def test_last_modules_found():
    assert {"repro_torch.analysis.findings", "repro_torch.analysis.locksafety",
            "repro_torch.analysis.apicheck",
            "repro_torch.analysis.backendcheck",
            "repro_torch.analysis.containercheck",
            "repro_torch.analysis.kernelcheck",
            "repro_torch.analysis.__main__",
            "repro_torch.launch.dryrun"} <= set(MODULES)
    from repro_torch.analysis import RULES, run_analysis
    from repro_torch.launch.dryrun import run_cell

    assert callable(run_analysis) and callable(run_cell) and RULES


@pytest.mark.parametrize("name", MODULES)
def test_star_import_and_all_names(name):
    mod = importlib.import_module(name)
    missing = [n for n in getattr(mod, "__all__", ()) if not hasattr(mod, n)]
    assert not missing, f"{name}.__all__ names undefined {missing}"
    namespace = {}
    exec(f"from {name} import *", namespace)
    for n in getattr(mod, "__all__", ()):
        assert namespace[n] is getattr(mod, n)


def test_port_loads_no_jax_and_no_reference_module():
    """In a fresh interpreter, star-import every module of the port and
    list what landed in ``sys.modules``."""
    src = Path(repro_torch.__file__).resolve().parents[1]
    script = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    exec(f'from {m.name} import *', {})\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith"
        "('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= len(MODULES)
    assert bad == "[]"
