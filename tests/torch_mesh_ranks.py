"""The rank side of ``tests/test_torch_mesh.py``: one 4-rank gloo group
on the host, a (2, 2) ("data", "model") mesh and then a (4, 1) one.

    python tests/torch_mesh_ranks.py WORKDIR

reads ``WORKDIR/inputs.pt`` (written by the test: tinyllama-1.1b's smoke
weights in float32 as a ``state_dict``, reference-layout flat optimizer
states for zero_pad 2 and 4, a batch), spawns the ranks with a
``FileStore`` under WORKDIR (no fixed port), and rank 0 writes
``WORKDIR/results.pt``.  Imports torch and ``repro_torch`` only.
"""

from __future__ import annotations

import contextlib
import copy
import io
import os
import sys
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 4
FAMILIES = ["tinyllama-1.1b", "olmoe-1b-7b", "qwen2-moe-a2.7b", "mamba2-1.3b",
            "zamba2-1.2b", "qwen2-vl-7b", "musicgen-medium"]
DECODED = ["tinyllama-1.1b", "mamba2-1.3b"]
B, S = 4, 16


def _cfg(arch, **changes):
    from repro_torch.configs import get_config

    return replace(get_config(arch).smoke(), dtype="float32", **changes)


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return result, buf.getvalue().splitlines()


def family_batch(cfg, seed=3):
    """Token ids and the frontend inputs a family takes, as tensors."""
    r = np.random.default_rng(seed)
    out = {"inputs": torch.from_numpy(
        r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.frontend != "none":
        out["patches"] = torch.from_numpy(
            r.standard_normal((B, 4, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        out["mrope_positions"] = torch.from_numpy(
            np.stack([pos, pos // 2, pos % 5]))
    return out


def families(mesh):
    """Each family's forward logits on the mesh and on this rank alone,
    and for ``DECODED`` a prefill and three greedy decode steps."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import transformer
    from repro_torch.models.common import ShardingCtx
    from repro_torch.serve.prefill import prefill_with_cache
    from repro_torch.train import serve_step

    out = {}
    for arch in FAMILIES:
        cfg = _cfg(arch)
        one = transformer.init_params(cfg, device="cpu")
        placed = copy.deepcopy(one)
        batch = family_batch(cfg)
        want, _ = transformer.forward(one, cfg, **batch)
        with ShardingCtx(mesh):
            sh.shard_params(placed, sh.param_shardings(mesh, cfg))
            b_sh = sh.batch_shardings(mesh, cfg, "prefill")
            got, _ = transformer.forward(
                placed, cfg, **sh.distribute(batch, b_sh))
        rec = {"logits_err": float((got.full_tensor() - want).abs().max()),
               "logits_placements": [str(p) for p in got.placements]}
        if arch in DECODED:
            def generate(model, tokens):
                logits, cache = prefill_with_cache(model, cfg, tokens, 24)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                toks = [tok]
                for t in range(3):
                    tok, cache = serve_step(model, tok, cache, S + t, cfg=cfg)
                    toks.append(tok)
                return (torch.cat([sh.gather(t) for t in toks], 1),
                        {k: sh.gather(v) for k, v in cache.items()})

            toks_1, cache_1 = generate(one, batch["inputs"])
            with ShardingCtx(mesh):
                toks_m, cache_m = generate(placed, sh.distribute(
                    {"inputs": batch["inputs"]}, b_sh)["inputs"])
            rec["tokens_equal"] = bool(torch.equal(toks_1, toks_m))
            rec["cache_err"] = max(float((cache_m[k] - cache_1[k]).abs().max())
                                   for k in cache_1)
        out[arch] = rec
    return out


def train_once(mesh, inp, workdir):
    """One ``train_step`` at microbatches 2 with the ZeRO moment
    shardings as gradient shardings, from the test's weights and flat
    state; the checkpoint save (on (2, 2)) or restore (on (4, 1))."""
    from repro_torch import convert
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.train import place_state
    from repro_torch.models import transformer
    from repro_torch.models.common import ShardingCtx, mesh_axes
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.pytree import tree_leaves, tree_map
    from repro_torch.train import train_step

    cfg = _cfg("tinyllama-1.1b")
    zp = sh.zero_pad_for(mesh)
    out = {"zero_pad": zp, "mesh": mesh_axes(mesh)}
    with ShardingCtx(mesh):
        p_sh = sh.param_shardings(mesh, cfg)
        o_sh = sh.opt_shardings(mesh, cfg)
        out["ffn_spec"] = p_sh["layers.0.ffn.w_gate"].spec
        model = transformer.Transformer(cfg, device="meta")
        # a copy: a replicated DTensor may share its parameter's storage,
        # and the step updates it in place
        model.load_state_dict({k: v.clone() for k, v in
                               inp["state_dict"].items()}, assign=True)
        opt = convert.opt_state_from_reference(inp["opt_ref"][zp], model,
                                               "cpu", zero_pad=zp)
        opt = place_state(model, opt, mesh, cfg)
        out["moments"] = [(tuple(t.shape), [str(p) for p in t.placements])
                          for t in opt["m"].values()]
        batch = sh.distribute(inp["batch"],
                              sh.batch_shardings(mesh, cfg, "train"))
        model, new_opt, m = train_step(
            model, opt, batch, cfg=cfg, opt_cfg=OptConfig(**inp["opt_cfg"]),
            microbatches=2, grad_shardings=o_sh["m"])
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["params"] = convert.params_to_reference(model)
        out["opt"] = convert.opt_state_to_reference(new_opt, model)
        tree = {"params": out["params"], "opt": out["opt"]}
        ck = os.path.join(workdir, "ckpt")
        if zp == 2:
            out["saved_bytes"] = ckpt.save(ck, 1, tree)
        else:
            like = {"params": convert.params_to_reference(model, "meta"),
                    "opt": convert.opt_state_to_reference(
                        init_opt_state(model, zero_pad=zp), model, "meta",
                        zero_pad=zp)}
            restored, step, _ = ckpt.restore(
                ck, like, device="cpu",
                shardings=tree_map(lambda _: sh.replicated(mesh), like))
            out["restored_step"] = step
            out["restored_dtensor"] = all(
                hasattr(t, "device_mesh") for t in tree_leaves(restored))
            out["restored"] = tree_map(sh.gather, restored)
    return out


def launchers(workdir):
    """Both launchers' ``main`` on the host with ``--mesh 2,2``, then a
    resume of the training run's checkpoint on a (4, 1) mesh."""
    from repro_torch.launch import serve, train

    ck = os.path.join(workdir, "launcher_ckpt")
    train_argv = ["--device", "cpu", "--seq", "32", "--log-every", "1",
                  "--ckpt-dir", ck, "--ckpt-every", "100"]
    metrics, lines = _capture(train.main,
                              [*train_argv, "--mesh", "2,2", "--steps", "2"])
    resumed, r_lines = _capture(
        train.main, [*train_argv, "--mesh", "4,1", "--steps", "3",
                     "--resume"])
    served, s_lines = _capture(serve.main, [
        "--device", "cpu", "--mesh", "2,2", "--requests", "4", "--batch",
        "4", "--gen-tokens", "3"])
    return {"train": metrics, "train_lines": lines, "resumed": resumed,
            "resumed_lines": r_lines, "serve_outputs": served["outputs"],
            "serve_lines": s_lines}


def _rank(rank, workdir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_debug_mesh

        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        results = {}
        for shape in ((2, 2), (4, 1)):
            mesh = make_debug_mesh(*shape)
            results[shape] = train_once(mesh, inp, workdir)
            if shape == (2, 2):
                results["families"] = families(mesh)
        results["launchers"] = launchers(workdir)
        if rank == 0:
            torch.save(results, os.path.join(workdir, "results.pt"))
        else:
            # what the other ranks printed: nothing, if rank 0 alone prints
            torch.save([x for k in ("train_lines", "resumed_lines",
                                    "serve_lines")
                        for x in results["launchers"][k]],
                       os.path.join(workdir, f"printed_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=WORLD, join=True)
