"""End-to-end training launcher with fault tolerance, on one card or a mesh.

The port of ``src/repro/launch/train.py``: atomic checkpoints and
auto-resume, heartbeat files for the cluster monitor, straggler detection,
simulated-failure injection for restart testing, and the data plane's
metadata index, whose closing curation query runs on the port's bitmap
query surfaces (``--query-backend torch``, the default: ``ewah_decode``
and ``planfuse`` on the card once the index has sealed a segment).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 50 --ckpt-dir /tmp/ckpt --resume                # host, smoke
  PYTHONPATH=src python -m repro_torch.launch.train --no-smoke  # card, full
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --mesh 2,2                                 # 4 gloo ranks
  PYTHONPATH=src python -m repro_torch.launch.train --no-smoke --mesh 1,1

The model is the port's ``Transformer`` in eager PyTorch on ``--device``
(default: the CUDA card, which raises where there is none), with
``cfg.remat`` forced on as in the reference.  Checkpoints hold the
reference's tree (``convert.params_to_reference``), so either package
resumes the other's run.

``--mesh data,model`` (or a ``torchrun`` world of several ranks) trains
on a ``DeviceMesh`` (``launch/mesh.py``; NCCL on cards, gloo on the
host), one process a rank: the parameters are made on the one-card
path's generator, seeded 0, and placed by ``param_shardings``; the
moments are flat ZeRO-1 leaves (``zero_pad_for(mesh)``) placed by
``opt_shardings``; each batch is placed by ``batch_shardings(...,
"train")``.  A resume restores into the unplaced state and then places
it.  Rank 0 alone prints, writes the heartbeat, the metrics and the
checkpoints, and runs the curation query.  Without ``--mesh`` and
without a ``torchrun`` world no process group starts.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from contextlib import nullcontext
from dataclasses import replace
from functools import partial

import numpy as np
import torch

from .. import convert
from ..configs import get_config
from ..data.metadata_index import MetadataIndex
from ..data.tokens import TokenPipeline
from ..dist import checkpoint as ckpt
from ..dist import sharding
from ..models import transformer
from ..models.common import ShardingCtx, resolve_device
from ..optim import OptConfig, init_opt_state
from ..pytree import tree_leaves
from ..train import train_step
from . import mesh as mesh_mod

__all__ = ["Heartbeat", "StragglerMonitor", "main"]


class Heartbeat:
    """Per-host liveness + progress file for the cluster monitor.

    A real deployment points this at shared storage; the monitor restarts
    hosts whose heartbeat goes stale and triggers elastic re-entry."""

    def __init__(self, path, host_id=0):
        self.path = path
        self.host_id = host_id

    def beat(self, step, status="ok", **kv):
        rec = {"host": self.host_id, "step": step, "t": time.time(),
               "status": status, **kv}
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)


class StragglerMonitor:
    """Flags steps slower than ``factor`` x the running median.

    On a cluster the mitigation is to exclude the slow host at the next
    checkpoint boundary (elastic re-entry with n-1 hosts); here we record
    the event so the launcher can act."""

    def __init__(self, factor=3.0, warmup=5):
        self.durations = []
        self.factor = factor
        self.warmup = warmup
        self.events = []

    def observe(self, step, dt):
        self.durations.append(dt)
        if len(self.durations) <= self.warmup:
            return False
        med = float(np.median(self.durations[-50:]))
        if dt > self.factor * med:
            self.events.append({"step": step, "dt": dt, "median": med})
            return True
        return False


def _state(params, opt_state, device=None, zero_pad=1):
    """The checkpoint tree: the reference's ``{"params", "opt"}`` tree of
    the model and its optimizer state, on ``device`` (default: theirs;
    DTensors are gathered)."""
    return {"params": convert.params_to_reference(params, device),
            "opt": convert.opt_state_to_reference(
                opt_state, params, device=device, zero_pad=zero_pad)}


def place_state(params, opt_state, mesh, cfg):
    """Place the model's parameters (in place) and the optimizer state on
    ``mesh``: ``param_shardings`` and ``opt_shardings``.  Returns the
    placed optimizer state."""
    sharding.shard_params(params, sharding.param_shardings(mesh, cfg))
    o_sh = sharding.opt_shardings(mesh, cfg)
    placed = {k: sharding.distribute(opt_state[k], o_sh[k])
              for k in ("m", "v")}
    placed["step"] = sharding.distribute(
        {"step": opt_state["step"]}, {"step": o_sh["step"]})["step"]
    return placed


def main(argv=None):
    """Train for ``--steps``; prints what the reference prints (and the
    bytes and seconds of a restore and of the closing save) and returns
    the per-step metrics: step, loss, grad_norm, dt (host clock; reading
    the loss synchronises with the device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train the arch's reduced smoke config (default); "
                         "--no-smoke trains its published widths")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="data,model: train on a DeviceMesh of that shape, "
                         "one process a rank (torchrun); default: one card "
                         "without a process group, or every torchrun rank "
                         "data-parallel")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and of the torch query "
                         "backend (default: the CUDA card)")
    ap.add_argument("--query-backend", default="torch",
                    choices=("numpy", "torch"),
                    help="query-plane backend for the metadata index's "
                         "curation query")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--simulate-failure-at", type=int, default=0,
                    help="crash at this step (restart/fault-tolerance test)")
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = replace(cfg, remat=True)
    mesh, device, rank = mesh_mod.setup(args.mesh, resolve_device(args.device))
    with nullcontext() if mesh is None else ShardingCtx(mesh):
        return _train(args, cfg, device, mesh, rank)


def _train(args, cfg, device, mesh, rank):
    say = partial(print, flush=True) if rank == 0 else (lambda *a: None)
    query_opts = ({"device": str(device)} if args.query_backend == "torch"
                  else {})

    opt_cfg = OptConfig(lr=args.lr, total_steps=max(args.steps, 10),
                        warmup_steps=max(2, args.steps // 20))
    params = transformer.init_params(cfg, device=device)
    zero_pad = 1 if mesh is None else sharding.zero_pad_for(mesh)
    opt_state = init_opt_state(params, zero_pad=zero_pad)
    step_fn = partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                      microbatches=args.microbatches)

    pipeline = TokenPipeline(cfg.vocab_size, args.batch, args.seq)
    meta_index = MetadataIndex()
    start_step = 0

    if args.resume and args.ckpt_dir and ckpt.available_steps(args.ckpt_dir):
        # shapes only; the leaves come back on the host and are carried
        # into the model's own (not yet placed) tensors
        t0 = time.time()
        restored, start_step, extra = ckpt.restore(
            args.ckpt_dir, _state(params, opt_state, "meta", zero_pad),
            device="cpu")
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(restored))
        params.load_state_dict(convert.params_from_reference(
            restored["params"], cfg, device))
        opt_state = convert.opt_state_from_reference(
            restored["opt"], params, device, zero_pad=zero_pad)
        del restored
        if "pipeline" in extra:
            pipeline.restore(extra["pipeline"])
        say(f"[train] resumed from step {start_step}")
        say(f"[train] restored {nbytes} B in {time.time() - t0:.2f} s")
        if start_step >= args.steps:
            # restart of an already-finished run (cluster monitors do
            # this); exit cleanly instead of entering an empty loop
            say(f"[train] already at step {start_step} >= --steps "
                f"{args.steps}; nothing to do")
            return []

    b_sh = None
    if mesh is not None:
        say(f"[train] {mesh_mod.describe(mesh)}")
        opt_state = place_state(params, opt_state, mesh, cfg)
        b_sh = sharding.batch_shardings(mesh, cfg, "train")
    hb = Heartbeat(args.heartbeat) if args.heartbeat and rank == 0 else None
    straggler = StragglerMonitor()
    metrics_log = []
    t_start = time.time()

    for step in range(start_step, args.steps):
        if args.simulate_failure_at and step == args.simulate_failure_at:
            say(f"[train] simulating failure at step {step}")
            os._exit(42)
        t0 = time.time()
        batch_np, meta = pipeline.next_batch()
        if rank == 0:
            meta_index.add_batch(meta)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_np.items()}
        if b_sh is not None:
            batch = sharding.distribute(batch, b_sh)
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])
        gnorm = float(m["grad_norm"])
        dt = time.time() - t0
        if straggler.observe(step, dt):
            say(f"[train] straggler step {step}: {dt:.2f}s")
        if hb:
            hb.beat(step, loss=loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d}  loss {loss:.4f}  "
                f"gnorm {gnorm:.3f}  {dt*1e3:.0f} ms")
        metrics_log.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "dt": dt})
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(
                args.ckpt_dir, step + 1,
                _state(params, opt_state, zero_pad=zero_pad),
                extra={"pipeline": pipeline.snapshot()})

    ckpt.wait_pending()
    if args.ckpt_dir:
        t0 = time.time()
        nbytes = ckpt.save(args.ckpt_dir, args.steps,
                           _state(params, opt_state, zero_pad=zero_pad),
                           extra={"pipeline": pipeline.snapshot()})
        say(f"[train] saved step {args.steps}: {nbytes} B in "
            f"{time.time() - t0:.2f} s")

    if rank == 0:
        # data-plane bitmap index demo: curation query over trained
        # batches (add_batch sealed segments incrementally)
        rows, scanned = meta_index.query(where={"domain": 3},
                                         backend=args.query_backend,
                                         **query_opts)
        elapsed = time.time() - t_start
        say(f"[train] done in {elapsed:.1f}s; metadata index "
            f"{meta_index.size_words()} words; domain=3 -> {len(rows)} rows "
            f"({scanned} compressed words scanned)")
    if args.metrics_out and rank == 0:
        with open(args.metrics_out, "w") as f:
            json.dump({"metrics": metrics_log,
                       "stragglers": straggler.events}, f)
    first, last = metrics_log[0]["loss"], metrics_log[-1]["loss"]
    say(f"[train] loss {first:.4f} -> {last:.4f}")
    return metrics_log


if __name__ == "__main__":
    main()
    mesh_mod.shutdown()
