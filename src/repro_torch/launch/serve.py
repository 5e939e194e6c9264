"""Batched serving driver with histogram-aware request packing.

Requests arrive with varying prompt lengths; batching equal-length-bin
requests together minimizes padding waste.  We sort the admission queue by
(length-bin frequency, length) — Gray-Frequency (paper §4.2) applied to the
serving plane: popular length classes form dense runs and batches.

  PYTHONPATH=src python -m repro_torch.launch.serve               # card, smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke    # full width
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu  # host

The port of ``src/repro/launch/serve.py``.  Admission packing runs on the
port's bitmap query surfaces with the ``torch`` backend by default: each
``Eq(bin)`` plan goes through ``TorchBackend`` (``ewah_decode`` then
``planfuse`` on the card), and ``device`` travels as a backend option into
every ``query_many``, the ``ShardedIndex`` fan-out and the ``ServePlane``
workers.  The model is the ``Transformer`` in eager PyTorch on one card,
or on a mesh: ``--mesh data,model`` (or a ``torchrun`` world of several
ranks, one process a rank) places the parameters by ``param_shardings``,
the decode cache by ``cache_shardings`` and the prompts by
``batch_shardings(..., "prefill")``, with the batch replicated when the
data axis does not divide it.  Admission packing then runs on rank 0
alone and its batches are broadcast, so every rank serves the same
batches; rank 0 alone prints.  ``--smoke`` can be turned off
(``--no-smoke``).

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --device cpu --mesh 2,2                     # 4 gloo ranks, host
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke --mesh 1,1
"""

from __future__ import annotations

import argparse
import os
import time
from contextlib import nullcontext
from functools import partial

import numpy as np
import torch

from .. import tracing
from ..analysis.runtime import make_lock
from ..configs import get_config
from ..core import BitmapIndex, Eq, IndexSpec, IndexWriter
from ..core.lifecycle import BackgroundCompactor
from ..dist import sharding
from ..models import transformer
from ..models.common import ShardingCtx, mesh_axes, resolve_device
from ..serve.prefill import prefill_with_cache
from ..train import serve_step
from ..workload import WORKLOAD_STATS
from . import mesh as mesh_mod

__all__ = ["BIN_WIDTH", "SegmentedAdmission", "main",
           "make_requests", "pack_batches", "padding_waste"]


def make_requests(n, rng, max_len=96):
    """Synthetic request stream with a skewed length distribution."""
    bins = np.array([16, 24, 32, 48, 64, 96])
    probs = np.array([0.35, 0.25, 0.2, 0.1, 0.07, 0.03])
    lens = bins[rng.choice(len(bins), size=n, p=probs)]
    jitter = rng.integers(-4, 4, size=n)
    return np.clip(lens + jitter, 8, max_len)


BIN_WIDTH = 8  # length-bin granularity for admission packing


def _backend_opts(backend, device):
    """The options a query surface passes to ``backend``: the torch
    backend's device (``None`` is the card); numpy takes none."""
    return {"device": device} if backend == "torch" else {}


class SegmentedAdmission:
    """In-flight re-binning admission queue (the streaming serving plane).

    New requests ``admit`` into the **open segment** of an
    :class:`~repro_torch.core.lifecycle.IndexWriter` — queryable
    immediately, no index rebuild — and every ``seal_rows`` admitted
    requests the word-aligned prefix seals into an immutable segment.
    Each ``pack`` re-bins the *entire* queue against the live length-bin
    histogram (bins in descending frequency, the paper's Gray-Frequency
    order applied to serving), so admission order is re-derived in
    flight, never frozen at arrival.

    With ``compactor=True`` a
    :class:`~repro_torch.core.lifecycle.BackgroundCompactor` merges the
    sealed admission segments off-thread; ``retire(row_ids)`` tombstones
    served requests; ``close()`` drains the compactor.

    With ``hosts >= 2`` the sealed segments serve through a
    :class:`~repro_torch.dist.serve_plane.ServePlane` of worker processes
    (``plane_opts``: its ``connect_timeout`` / ``reply_timeout``); packs
    are identical to the in-process path.

    ``backend="torch"`` (the default) answers on ``device`` (``None`` is
    the card, which raises where there is none).
    """

    def __init__(self, backend: str = "torch", seal_rows: int = 256,
                 compactor: bool = False, compact_interval: float = 0.02,
                 hosts: int = 0, device=None, plane_opts: dict | None = None):
        self.spec = IndexSpec(row_order="unsorted", column_order="given")
        # the process-wide workload telemetry feeds compactions: the
        # background compactor re-encodes merged admission segments toward
        # the live predicate mix once enough samples accumulate
        self.writer = IndexWriter(self.spec, seal_rows=seal_rows,
                                  workload_stats=WORKLOAD_STATS)
        self._plane = None
        if hosts >= 2:
            from ..dist.serve_plane import ServePlane

            self._plane = ServePlane(self.writer, n_hosts=hosts,
                                     **(plane_opts or {}))
        self.backend = backend
        self.backend_opts = _backend_opts(backend, device)
        # _lock keeps the shadow length store and the writer append one
        # atomic admission (a pack between the two would otherwise see a
        # row the histogram doesn't, and index row ids would drift from
        # _lengths positions); ordered before the writer's own lock
        self._lock = make_lock("admission._lock")
        self._lengths: list = []       # guarded-by: _lock
        self._compactor = (BackgroundCompactor(self.writer,  # guarded-by: _lock
                                               interval=compact_interval)
                           if compactor else None)

    def admit(self, lengths) -> None:
        """Append arriving request lengths to the open segment."""
        lengths = np.asarray(lengths)
        if len(lengths):
            with self._lock:
                self._lengths.append(lengths)
                self.writer.append([lengths // BIN_WIDTH])

    def retire(self, row_ids) -> int:
        """Tombstone served requests so later packs skip them; returns the
        newly-retired count."""
        row_ids = np.asarray(row_ids, dtype=np.int64)
        if self._plane is not None:
            # the plane broadcasts the tombstones to owning workers too
            return self._plane.delete(row_ids=row_ids)
        return self.writer.delete(row_ids=row_ids)

    def close(self) -> None:
        """Drain and stop the background compactor, if one is running,
        then shut down the serve-plane worker fleet (plane mode)."""
        with self._lock:
            comp, self._compactor = self._compactor, None
        if comp is not None:
            # off-lock: draining joins the scheduler thread, whose
            # compactions must not wait on an admission-held lock
            comp.close()
        if self._plane is not None:
            self._plane.close()

    @property
    def lengths(self) -> np.ndarray:
        with self._lock:
            return (np.concatenate(self._lengths) if self._lengths
                    else np.zeros(0, dtype=np.int64))

    @property
    def n_segments(self) -> int:
        return len(self.writer.segments)

    def pack(self, batch_size: int) -> list:
        """Re-bin the whole queue and emit index-batches (one Eq(bin) plan
        per bin over sealed segments + the open buffer, bins in descending
        frequency, lengths ascending within a bin)."""
        # _lock spans the lengths snapshot AND the index query: an admit
        # landing between the two would return row ids the snapshot does
        # not cover yet
        with self._lock:
            lengths = (np.concatenate(self._lengths) if self._lengths
                       else np.zeros(0, dtype=np.int64))
            if not len(lengths):
                return []
            bins = lengths // BIN_WIDTH
            uniq, counts = np.unique(bins, return_counts=True)
            by_freq = uniq[np.lexsort((uniq, -counts))]
            preds = [Eq(0, int(b)) for b in by_freq]
            surface = (self._plane if self._plane is not None
                       else self.writer.index)
            results = surface.query_many(preds, backend=self.backend,
                                         **self.backend_opts)
        order = np.concatenate(
            [rows[np.argsort(lengths[rows], kind="stable")]
             for rows, _ in results])
        return [order[i : i + batch_size]
                for i in range(0, len(order), batch_size)]


def pack_batches(lengths, batch_size, histogram_aware=True, backend="torch",
                 query_fanout=0, admission="rebuild", compactor=False,
                 hosts=0, device=None, plane_opts=None):
    """Return list of index-batches; histogram-aware = Gray-Frequency order.

    The histogram-aware path runs through the bitmap query plane: a bitmap
    index over the length-bin column, one Eq(bin) plan per bin, bins
    admitted in descending frequency (paper §4.2 applied to serving),
    lengths ascending within a bin.  On ``backend="torch"`` all per-bin
    plans share batched device launches on ``device`` (``None`` is the
    card).  With query_fanout > 1 the admission index shards over
    word-aligned row ranges (``dist.query_fanout``) and every per-bin plan
    fans out.

    ``admission="segmented"`` streams the lengths in waves through
    :class:`SegmentedAdmission`; ``compactor=True`` (segmented only) runs
    a background compactor during the waves; ``hosts >= 2`` (segmented
    only) serves the sealed segments through a ``ServePlane`` worker fleet
    (``plane_opts``: its timeouts).  Batches are identical in every mode
    and on every backend.
    """
    lengths = np.asarray(lengths)
    n = len(lengths)
    if compactor and admission != "segmented":
        raise ValueError(
            "compactor=True requires admission='segmented' (the rebuild "
            "path has no writer to compact)")
    if hosts >= 2 and admission != "segmented":
        raise ValueError(
            "hosts>=2 requires admission='segmented' (the serve plane "
            "wraps the segmented writer)")
    if not histogram_aware:
        order = np.arange(n)
        return [order[i : i + batch_size] for i in range(0, n, batch_size)]
    if admission == "segmented":
        if query_fanout > 1:
            raise ValueError(
                "segmented admission and query_fanout are separate "
                "topologies; pick one")
        q = SegmentedAdmission(backend=backend, compactor=compactor,
                               hosts=hosts, device=device,
                               plane_opts=plane_opts)
        try:
            waves = max(1, min(4, n // max(batch_size, 1)))
            for chunk in np.array_split(lengths, waves):
                q.admit(chunk)
            return q.pack(batch_size)
        finally:
            q.close()
    if admission != "rebuild":
        raise ValueError(f"unknown admission mode {admission!r}; "
                         "known: rebuild, segmented")
    bins = lengths // BIN_WIDTH
    spec = IndexSpec(row_order="unsorted", column_order="given")
    uniq, counts = np.unique(bins, return_counts=True)
    by_freq = uniq[np.lexsort((uniq, -counts))]
    preds = [Eq(0, int(b)) for b in by_freq]
    opts = _backend_opts(backend, device)
    if query_fanout > 1:
        from ..dist.query_fanout import ShardedIndex

        # unsorted row order keeps row_perm the identity, so fan-out's
        # original-space ids are directly comparable to the single path
        sidx = ShardedIndex.build([bins], spec, n_shards=query_fanout)
        results = sidx.query_many(preds, backend=backend, **opts)
    else:
        idx = BitmapIndex.build([bins], spec)
        results = idx.query_many(preds, backend=backend, **opts)
    order = np.concatenate(
        [rows[np.argsort(lengths[rows], kind="stable")]
         for rows, _ in results])
    return [order[i : i + batch_size] for i in range(0, n, batch_size)]


def _phases(before: dict) -> dict:
    """Seconds of each ``serve.<phase>`` span recorded since ``before``
    (a ``tracing.snapshot()["spans"]``).  Unprofiled, a span times the
    enqueue: only ``--profile`` synchronises with the device inside it, so
    the phases never perturb the unprofiled path's asynchronous launches."""
    out = {}
    for name, t in tracing.snapshot()["spans"].items():
        was = before.get(name, {"s": 0.0, "n": 0})
        if name.startswith("serve.") and t["n"] > was["n"]:
            out[name[len("serve."):]] = t["s"] - was["s"]
    return out


def _report(phases: dict) -> None:
    """The top-phases summary ``serve --profile`` prints."""
    tot = sum(phases.values()) or 1.0
    print("# top serving phases (wall-clock)")
    for name, s in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<12} {s * 1e3:9.1f} ms  {s / tot:6.1%}")


def padding_waste(lengths, batches):
    total = 0
    used = 0
    for b in batches:
        l = lengths[b]
        total += int(l.max()) * len(b)
        used += int(l.sum())
    return 1.0 - used / max(total, 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Serve ``--requests`` synthetic requests; prints what the reference
    prints and returns a summary: padding waste by mode, requests, tokens,
    seconds (host clock after a device synchronise), the phase profile
    and ``outputs``, each packed batch's greedy tokens (its rows, the
    generated tokens) as a numpy array."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the arch's reduced smoke config (default); "
                         "--no-smoke serves its published widths")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--mesh", default=None,
                    help="data,model: serve on a DeviceMesh of that shape, "
                         "one process a rank (torchrun); default: one card "
                         "without a process group, or every torchrun rank "
                         "data-parallel")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and of the torch query "
                         "backend (default: the CUDA card)")
    ap.add_argument("--query-backend", default="torch",
                    choices=("numpy", "torch"),
                    help="query-plane backend for admission packing")
    ap.add_argument("--query-fanout", type=int, default=0,
                    help="shard the admission index over N word-aligned row "
                         "ranges and fan every packing query out across "
                         "them (0/1 = single index)")
    ap.add_argument("--admission", default="rebuild",
                    choices=("rebuild", "segmented"),
                    help="'segmented' streams requests through an "
                         "IndexWriter (in-flight re-binning) instead of "
                         "rebuilding the admission index per pack")
    ap.add_argument("--compactor", action="store_true",
                    help="run a background compactor thread over the "
                         "segmented admission writer while requests stream "
                         "in (requires --admission segmented)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="serve sealed admission segments through a "
                         "multi-process ServePlane with N worker processes "
                         "(requires --admission segmented; 0/1 = "
                         "in-process)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the serving loop "
                         "to DIR/serve_trace.json plus a wall-clock "
                         "top-phase summary on stdout")
    ap.add_argument("--workload-stats", default=None, metavar="PATH",
                    help="persist the workload telemetry recorder "
                         "(workload.WORKLOAD_STATS): load at startup so "
                         "compaction's cost model starts warm, save at exit")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    rng = np.random.default_rng(0)

    if args.workload_stats:
        warm = WORKLOAD_STATS.load(args.workload_stats)
        print(f"workload-stats {'loaded from' if warm else 'cold start at'} "
              f"{args.workload_stats}: {WORKLOAD_STATS.stats()}")

    mesh, device, rank = mesh_mod.setup(args.mesh, resolve_device(args.device))
    rules = None
    if mesh is not None:
        # batches the data axis does not divide are replicated
        rules = {"batch": None} if args.batch % mesh_axes(mesh)["data"] \
            else None
    # the phases are the serving loop's own spans (``serve.*``), recorded
    # on every run; the backend's spans record beside them.  The switch is
    # process-wide: a second run in this process that ends first turns the
    # spans off under this one (docs/tracing_torch.md)
    prev = tracing.enable()
    try:
        with nullcontext() if mesh is None else ShardingCtx(mesh, rules):
            return _serve(args, cfg, rng, device, mesh, rank, rules)
    finally:
        tracing.enable(prev)


def _broadcast(obj, mesh):
    """Rank 0's ``obj`` on every rank of ``mesh``'s group."""
    if mesh is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _serve(args, cfg, rng, device, mesh, rank, rules):
    say = partial(print, flush=True) if rank == 0 else (lambda *a: None)
    params = transformer.init_params(cfg, device=device)
    tok_sh = None
    if mesh is not None:
        say(f"[serve] {mesh_mod.describe(mesh)}"
            + (", batch replicated" if rules else ""))
        sharding.shard_params(params,
                              sharding.param_shardings(mesh, cfg, rules))
        tok_sh = sharding.batch_shardings(mesh, cfg, "prefill", rules)
    pack = dict(backend=args.query_backend, query_fanout=args.query_fanout,
                admission=args.admission, compactor=args.compactor,
                device=str(device))

    lengths = make_requests(args.requests, rng)
    waste = {}
    before = tracing.snapshot()["spans"]
    batches = None
    if rank == 0:
        # admission runs on rank 0; the packed batches are broadcast
        for mode in (False, True):
            batches = pack_batches(lengths, args.batch, histogram_aware=mode,
                                   hosts=args.hosts if mode else 0, **pack)
            waste[mode] = padding_waste(lengths, batches)
            say(f"packing histogram_aware={mode} "
                f"(query backend {args.query_backend}, "
                f"fanout {args.query_fanout}, "
                f"admission {args.admission}, "
                f"hosts {args.hosts}): "
                f"padding waste {waste[mode]:.1%}")
        with tracing.span("serve.pack", device=True):
            batches = pack_batches(lengths, args.batch, histogram_aware=True,
                                   hosts=args.hosts, **pack)
    waste, batches = _broadcast((waste, batches), mesh)
    trace_cm = nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        trace_cm = profile(activities=acts)
    t0 = time.time()
    generated = 0
    outputs = []
    with trace_cm as trace:
        for idx in batches:
            b = len(idx)
            # ragged tail: pad to the full batch (one shape); surplus rows
            # are dropped on count
            if b < args.batch:
                idx = np.concatenate(
                    [idx, np.repeat(idx[-1], args.batch - b)])
            # pad to a 16-token bucket, as the reference does for its
            # compiled prefill variants
            prompt_len = min(-(-int(lengths[idx].max()) // 16) * 16,
                             args.max_len - args.gen_tokens)
            prompts = rng.integers(0, cfg.vocab_size,
                                   size=(args.batch, prompt_len),
                                   dtype=np.int32)
            tokens = torch.from_numpy(prompts).to(device)
            if tok_sh is not None:
                tokens = sharding.distribute({"inputs": tokens},
                                             tok_sh)["inputs"]
            # fused prefill: one forward pass fills the whole KV cache
            with tracing.span("serve.prefill", device=True):
                logits, cache = prefill_with_cache(params, cfg, tokens,
                                                   args.max_len)
                if args.profile:
                    _sync(device)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            steps = [tok]
            cache_len = prompt_len
            generated += b
            for _ in range(args.gen_tokens - 1):
                with tracing.span("serve.decode", device=True):
                    tok, cache = serve_step(params, tok, cache, cache_len,
                                            cfg=cfg)
                    if args.profile:
                        _sync(device)
                steps.append(tok)
                cache_len += 1
                generated += b
            outputs.append((b, steps))
        # the clock stops after the device has finished, not at the enqueue
        _sync(device)
    dt = time.time() - t0
    phases = _phases(before)
    outputs = [torch.cat([sharding.gather(t) for t in steps], 1)[:b]
               .cpu().numpy() for b, steps in outputs
               if device.type != "meta"]
    say(f"served {len(lengths)} requests, {generated} tokens "
        f"in {dt:.1f}s ({generated/dt:.1f} tok/s)")
    if args.profile and rank == 0:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "serve_trace.json")
        trace.export_chrome_trace(path)
        say(f"profiler trace written to {path}")
        _report(phases)
    if args.workload_stats and rank == 0:
        WORKLOAD_STATS.save(args.workload_stats)
        say(f"workload-stats saved to {args.workload_stats}: "
            f"{WORKLOAD_STATS.stats()}")
    return {"waste": waste, "requests": len(lengths), "tokens": generated,
            "seconds": dt, "phases": phases, "outputs": outputs}


if __name__ == "__main__":
    main()
    mesh_mod.shutdown()
