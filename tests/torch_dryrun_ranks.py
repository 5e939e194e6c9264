"""The world side of ``tests/test_torch_dryrun.py``: the dry run's smoke
steps on a fake process group and on 4 real gloo ranks.

    python tests/torch_dryrun_ranks.py WORKDIR fake
    python tests/torch_dryrun_ranks.py WORKDIR gloo

``fake`` runs in this one process: tinyllama-1.1b's smoke config, a train,
a prefill and a decode step (``CELLS``) on ``meta`` tensors, on a fake
(2, 2) world and on a fake world of one rank, and the same steps without
a mesh under ``FlopCounterMode``.  ``gloo`` spawns 4 gloo ranks (a
``FileStore`` under WORKDIR, no fixed port) that run the same steps on
real CPU tensors on a (2, 2) mesh under the same counters.  Each writes
``WORKDIR/<mode>.json``.  Imports torch and ``repro_torch`` only.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "tinyllama-1.1b"
CELLS = (("train", 32, 8), ("prefill", 32, 8), ("decode", 32, 8))
WORLD = (2, 2)


def cells(mesh, device):
    """{kind: the dry run's measured record} on ``mesh``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec, specs_for

    cfg = get_config(ARCH).smoke()
    out = {}
    for kind, seq, batch in CELLS:
        specs = specs_for(cfg, ShapeSpec(kind, kind, seq, batch))
        rec = dryrun.measure_step(cfg, kind, specs, mesh, device=device)
        out[kind] = {k: rec[k] for k in ("cost", "collectives", "memory")}
        out[kind]["dims"] = sorted({op["dim"] for op in rec["ops"]})
    return out


def unmeshed_flops():
    """``FlopCounterMode``'s total of each step without a mesh."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import ShapeSpec, specs_for
    from repro_torch.models import transformer
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import prefill_step, serve_step, train_step

    cfg = get_config(ARCH).smoke()
    out = {}
    for kind, seq, batch in CELLS:
        specs = specs_for(cfg, ShapeSpec(kind, kind, seq, batch))
        model = transformer.init_params(cfg, device="meta")
        counter = FlopCounterMode(display=False)
        with counter:
            if kind == "train":
                train_step(model, init_opt_state(model), specs["batch"],
                           cfg=cfg, opt_cfg=OptConfig())
            elif kind == "prefill":
                prefill_step(model, specs["batch"], cfg=cfg)
            else:
                serve_step(model, specs["tokens"], specs["cache"], seq - 1,
                           cfg=cfg)
        out[kind] = counter.get_total_flops()
    return out


def fake(workdir):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    res = {}
    for shape in (WORLD, (1, 1)):
        dryrun.fake_world(shape[0] * shape[1])
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        res["x".join(map(str, shape))] = cells(mesh, "meta")
    dist.destroy_process_group()
    res["unmeshed_flops"] = unmeshed_flops()
    with open(os.path.join(workdir, "fake.json"), "w") as f:
        json.dump(res, f)


def _rank(rank, workdir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), 4)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=4)
    try:
        from repro_torch.launch.mesh import make_mesh

        res = {"2x2": cells(make_mesh(WORLD, ("data", "model"), "cpu"),
                            "cpu")}
        if rank == 0:
            with open(os.path.join(workdir, "gloo.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    workdir, mode = sys.argv[1], sys.argv[2]
    if mode == "fake":
        fake(workdir)
    else:
        mp.spawn(_rank, args=(workdir,), nprocs=4, join=True)
