#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port (``src/repro_torch``) and nothing of JAX or of the
reference package, and:

1. builds the thirteen CUDA libraries from ``src/repro_torch/csrc`` with nvcc
   for sm_90a, prints the card's name and power limit, and prints ptxas's
   registers, stack frame, spills and shared memory for every
   instantiation of every kernel of the thirteen (``PTXAS_CHECKED``),
   failing if any has a stack frame or a spill beyond ``PTXAS_ALLOWED``,
   which names one kernel (``ewah_decode_kernel_markers``) with its bytes
   as ceilings; then runs the port's static lint, ``python -m
   repro_torch.analysis --baseline analysis_torch_baseline.json``, in a
   subprocess, which must exit 0 (``[analysis]``);
2. builds the dbgen-like (1,000,000 rows, seed 1) and census-like (199,523
   rows, seed 0) indexes with ``IndexSpec(row_order="lex",
   encoding="auto")`` and compiles a 64-predicate mix for each;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card, on the inputs the dbgen mix's largest batch gives it, bit for bit,
   and times both with CUDA events (median, L2 flushed before each run);
   then, on the mix's median (one-query) batch, holds ``ewah_decode`` and
   each of its two phases (``ewah_markers``, ``ewah_expand``) against
   their plain versions, prints its markers a stream (max and mean),
   times it beside its bound, and profiles that batch's device program
   for decode's share of it and its device launches a decode call; and
   holds and times ``ewah_decode`` on a synthetic worst-case batch (55
   streams in which every word is a marker) with the same bound; and
   holds and times ``ewah_encode`` on the largest batch's answers and on
   one answer of the DBGEN cell's 436,812 words; and holds ``rowids``
   (``ops.rowids``, its two phases) against its plain version and the
   host's ``unpack_bits`` + ``flatnonzero`` on seven answers of the DBGEN
   cell's 436,812 words at the TPC-H stream's seven densities
   (``ROWID_DENSITIES``), padding bits set, and times each answer alone
   beside its bound;
4. path phase: answers both mixes through ``BitmapIndex.query_many`` and
   ``query_compressed`` on ``TorchBackend()`` and ``TorchBackend(fuse=False)``,
   requires EWAH streams identical to the host ``NumpyBackend`` and row ids
   identical to ``evaluate_mask`` over the raw columns, requires each
   kernel's launch counter to rise on the path that uses it, and prints
   queries/s, host-to-device bytes per batch and the time split;
5. container phase: holds the ``containerops`` kernel's pairwise form
   (``container_pairs``, P = 16 chunk pairs of Roaring containers over
   1,000,000 rows, densities 0.002 / 0.05 / 0.3) against its plain
   version and times it beside ``torch.bitwise_and`` / ``bitwise_or``;
   drives ``member`` once a shape through ``ops.container_gallop`` (no
   path of the port launches it) against the host intersection, then
   holds and times it against its plain version at P = 16 x 145 and at
   one "and" round over a TPC-H lineitem column at scale factor 10 (916
   chunks x 4096 positions against density-0.3 bitmaps); and requires
   ``TorchBackend()._container_fold_many`` over ten folds, "and" folds
   included, to give the streams of the host ``containers.fold`` in one
   ``containerops`` launch and no ``member`` launch, that launch held and
   timed against its bound;
6. lifecycle phase: ingests the dbgen-like table through an
   ``IndexWriter`` fed a fixed point-query workload (4 sealed segments and
   an open buffer), deletes about 1 % of the rows on the card, compacts
   the first two segments (their two small columns become Roaring), and
   answers the 64-predicate mix through ``SegmentedIndex.query_many`` and
   ``execute_compressed_many``, fused and per stage, against
   ``evaluate_mask`` over the live rows and ``backend="numpy"``; then
   splits the time of the per-segment plans into compile, container fold
   (``lower_containers_many``: every fold of the mix in one
   ``containerops`` launch, which it requires) and device program, and
   holds and times that one launch (``ops.container_fold``, the whole
   fold) against its plain version, with its bound;
7. serve-plane phase: ``ServePlane`` over the lifecycle writer with two
   worker processes, each with its own CUDA context on the card, syncs
   (ships the segments), answers the mix (rows, merged streams and
   counts identical to the in-process ``SegmentedIndex`` on the card,
   ``backend="numpy"`` and ``evaluate_mask``), broadcasts a delete of a
   range of the large column and answers again, saves a two-phase
   checkpoint, and answers again restored at three workers; the workers'
   replies must report ``ewah_decode``, ``planfuse`` and ``containerops``
   launches; it prints spawn, sync, mix, save and restore seconds and the
   compressed against dense result bytes;
8. metadata phase: ``MetadataIndex`` over 1,048,576 documents' metadata
   (16 batches at ``TokenPipeline``'s cardinalities, seed 0) in its three
   topologies (segmented, ``query_fanout=4``, ``hosts=2``) on the card,
   two queries each identical to a numpy mask;
9. AND-popcount phase at two shapes: ``and_popcount_many`` over the 77
   pairs of the dbgen-like index's equality bitmaps plus the reference
   tests' sparse and all-ones pairs (the short route: one launch), and
   over the 77 pairs of a TPC-H SF 1 lineitem cross-tab (``l_shipmode`` x
   ``l_discount``: ``uniform_column`` at cardinalities 7 and 11, 6,001,215
   rows, seed 1, equality bitmaps in table order; the wide route: two
   launches); counts against ``np.bitwise_count`` of the decompressed
   AND; the kernels held against their plain versions (counts and
   iterations; on the wide route phase by phase, and not the step walk,
   which syncs with the host every step), launches a call, times, bounds
   and shares of bound printed;
10. MoE dispatch phase: ``models.moe_dispatch.run`` at 16,384 tokens for
   qwen2-moe-a2.7b (4-of-60) and olmoe-1b-7b (8-of-64) and the example's
   8,192 tokens (8-of-64), packing on the card through ``moe_route_bitmap``;
   requires both ``validate`` checks, words identical to ``ref.moe_route``
   and ``routing_bitmap_words(...).T``, and times ``moe_route`` at
   1,048,576 tokens of olmoe's (8-of-64) and qwen2-moe's (4-of-60)
   routing, each call profiled as one kernel launch;
11. build-primitives phase on the dbgen-like index: ``bitpack`` of the two
   small columns' one-hot in row order against the index's own equality
   bitmaps, ``histogram`` of all four columns and census-like's widest
   against ``column_histogram``, ``gray`` forward and back against
   ``to_gray`` / ``from_gray``; each held bit for bit against its plain
   version; ``histogram`` calls profiled, one kernel launch a call (no
   memset, no conversion); each primitive timed
   (``histogram`` beside ``torch.bincount``);
12. model-serving phase (``[lm_serve]``): tinyllama-1.1b at its published
   widths (22 layers, d_model 2048, 32 heads, 4 KV heads, head_dim 64,
   d_ff 5632, vocab 32000, bf16: 1,100,048,384 parameters,
   2,200,096,768 B) built on the card from a seeded generator; then the
   server's own entry point, ``repro_torch.launch.serve.main`` with the
   reference's defaults and ``--no-smoke`` (64 requests, batch 8, 16
   generated tokens, max length 128, query backend torch): padding waste
   in arrival order and histogram-aware, requests and tokens served,
   tok/s on the host clock after a synchronise, peak device memory, and
   the packing's kernel launches, which must include ``ewah_decode`` and
   ``planfuse``; the same run with ``--profile`` for the synchronised
   phase split (pack, prefill, decode); admission batches on the card
   identical to numpy in five topologies (rebuild, ``query_fanout=2``,
   segmented, segmented with the compactor, segmented behind a
   two-worker plane whose workers run on the card); a float32 copy (TF32
   off) whose fused prefill must agree with a token-by-token decode loop
   and whose logits and 4 greedy tokens must agree with the same port on
   the CPU, at ``rtol = atol = 2e-3``; and CUDA-event times of prefill at
   (8, 32) and (8, 112) and of one decode step at batch 8 with 128 cache
   slots beside their bounds, and a profiler window over one packed
   batch (device busy, idle share, top kernels); then the other families
   (``LM_FAMILIES``), parameters and weight bytes counted on ``meta``:
   olmoe-1b-7b (16 layers, d_model 2048, 64 experts top-8, bf16:
   6,919,096,320 parameters) through ``main --no-smoke --arch`` with the
   same defaults and again with ``--profile``, its prefills and decode
   step timed beside the all-expert bound (every expert's weights read
   each step, as the reference's capacity buffer does) and the
   routed-only one (k/E_pad of the expert bytes), and one packed batch
   profiled; qwen2-moe-a2.7b, mamba2-1.3b (one packed batch profiled),
   zamba2-1.2b, qwen2-vl-7b and musicgen-medium one packed batch of 8
   each; every one's packing must launch ``ewah_decode`` and
   ``planfuse``; tok/s, seconds and peak memory of each; and the float32
   gate above for each family at full width and the depth of
   ``LM_F32_DEPTH`` (vlm and audio with frontend embeddings, vlm with
   M-RoPE positions, MoE with capacity factor E / k, so that the prefill
   drops no token);
13. model-training phase (``[lm_train]``): tinyllama-1.1b at its
   published widths and depth through the trainer's own entry point,
   ``repro_torch.launch.train.main --no-smoke`` (``LM_TRAIN_ARGV``: 6
   steps of batch 8 x 128 tokens, remat on, the closing save of the
   reference's {"params", "opt"} tree, about 11.0 GB, under ``build/``):
   the first step's and the median later step's milliseconds (host clock;
   the loss read synchronises) beside the step's bound worked out from the
   config, tokens/s, peak device memory, every step's loss and grad norm
   (finite), the checkpoint's bytes and seconds, and the launches of the
   closing curation query, which must include ``ewah_decode`` and
   ``planfuse`` and whose row count must equal a numpy ``MetadataIndex``
   fed the same metadata; then ``main --resume`` for 2 more steps, which
   must print ``resumed from step 6``; the checkpoint directory is removed
   after (the phase fails if the disk cannot hold two steps); one more
   full-width step split with CUDA events into the forward and backward
   pass and the AdamW update, and profiled (device busy, idle share,
   device records, top kernels); at smoke size on the card, a corrupted
   newest leaf resumes from the older step
   and ``--simulate-failure-at`` exits 42 (a subprocess); and the float32
   gate: the full-width config at 2 layers, one ``train_step`` of 2 x 64
   tokens on the card against the same step on the CPU from the same
   weights and moments, TF32 off, at ``LM_TRAIN_TOL``;
14. mesh phase (``[lm_mesh]``): both launchers with ``--mesh 1,1`` on a
   one-rank NCCL ``DeviceMesh``, tinyllama-1.1b at full width and depth
   as DTensors: ``launch.train.main`` with ``[lm_train]``'s argv for
   ``LM_MESH_STEPS`` steps, whose first three losses must agree with
   ``[lm_train]``'s to a relative ``LM_MESH_TOL`` (the largest difference
   printed; one rank is expected to be bitwise equal), its median step
   beside the one-card median, and its curation query's launches, which
   must include ``ewah_decode`` and ``planfuse``; then
   ``launch.serve.main`` over one packed batch (``LM_ONE_BATCH_ARGV``) on
   one card and on the mesh, whose greedy tokens must be identical and
   whose packing (rank 0) must launch ``ewah_decode`` and ``planfuse``;
   each run must print a mesh on the ``nccl`` backend;
15. dry-run phase (``[dryrun]``): the port's dry run
   (``launch/dryrun.py``'s ``main``) over ``DRYRUN_CELLS`` in one
   subprocess, on a fake 256- or 512-rank world and a fake ``cuda`` mesh
   with ``meta`` DTensors: tinyllama-1.1b train_4k on 16x16 with
   ``--grad-zero``, olmoe-1b-7b decode_32k on 2x16x16, zamba2-1.2b
   long_500k on 16x16 (B = 1) and qwen2-vl-7b train_4k on 16x16, each
   cell's status, seconds, per-rank FLOPs and collective counts and bytes
   by kind printed; fails unless every cell is ``ok``;
16. profiles one fused dbgen batch with ``torch.profiler`` (fails if it
   records no device time);
17. prints the card line, the ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any mismatch or error exits non-zero before the last line.  The full
measurements also go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --timings

holds and times only ``member`` (both shapes), ``moe_route``,
``histogram``, ``ewah_and_popcount`` (both shapes of phase 9) and
``ewah_decode`` (the dbgen mix's largest and median batches and the
worst-case batch) at their timed shapes through
``ops`` and prints the card line and their numbers as one JSON line;
copied into another checkout (the parent commit's), it times that
checkout's kernels, so that two versions compare on one card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores,
#                              the table's rate for scalar work
N_PREDICATES = 64
TABLES = (("dbgen", 1_000_000, 1), ("census", 199_523, 0))
# [in_list]: one TPC-H Q17-shaped IN-list on the dbgen table's widest
# (bit-sliced) column: this many scattered keys, drawn with this seed
IN_LIST_KEYS = 400
IN_LIST_SEED = 17
KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "planfuse": ("src/repro_torch/csrc/planfuse.cu",
                 "src/repro/kernels/planfuse.py:91"),
    "recompress": ("src/repro_torch/csrc/recompress.cu",
                   "src/repro/kernels/recompress.py:47"),
    "wordops": ("src/repro_torch/csrc/wordops.cu",
                "src/repro/kernels/wordops.py:43"),
    "slicefold": ("src/repro_torch/csrc/slicefold.cu",
                  "src/repro/kernels/slicefold.py:44"),
    # no Pallas counterpart: the reference decodes with lax.scan
    "ewah_decode": ("src/repro_torch/csrc/ewah_decode.cu",
                    "src/repro/core/ewah_jax.py:129"),
    "containerops": ("src/repro_torch/csrc/containers.cu",
                     "src/repro/kernels/containers.py:46"),
    "member": ("src/repro_torch/csrc/containers.cu",
               "src/repro/kernels/containers.py:71"),
    "bitpack": ("src/repro_torch/csrc/bitpack.cu",
                "src/repro/kernels/bitpack.py:30"),
    "gray": ("src/repro_torch/csrc/gray.cu", "src/repro/kernels/gray.py:30"),
    "histogram": ("src/repro_torch/csrc/histmm.cu",
                  "src/repro/kernels/histmm.py:40"),
    "moe_route": ("src/repro_torch/csrc/moe_route.cu",
                  "src/repro/kernels/moe_route.py:37"),
    # no Pallas counterpart: the reference walks with lax.while_loop
    "ewah_and_popcount": ("src/repro_torch/csrc/ewah_and_popcount.cu",
                          "src/repro/core/ewah_stream.py:520"),
    # no Pallas counterpart: the reference encodes with jnp scans and
    # scatters up to MAX_DIRTY words a row, and on the host past that
    "ewah_encode": ("src/repro_torch/csrc/ewah_encode.cu",
                    "src/repro/core/ewah_jax.py:50"),
    # no TPU kernel: the reference unpacks row ids on the host
    "rowids": ("src/repro_torch/csrc/rowids.cu",
               "src/repro/core/query.py:1181 (ewah.unpack_bits + "
               "np.flatnonzero on the host)"),
}
CONTAINER_ROWS = 1_000_000           # 16 Roaring chunks of 65,536 rows
CONTAINER_DENSITIES = (0.002, 0.05, 0.3)
LINEITEM_SF10_ROWS = 59_986_052      # TPC-H lineitem at scale factor 10
DBGEN_CELL_WORDS = 436_812           # a bitmap of DBGEN's 13,977,980 rows
DBGEN_CELL_ROWS = 13_977_980
# the share of rows each predicate of the tpch-stream mix answers on the
# DBGEN cell: Q1, Q3, Q7, Q12, Q6, Q15, Q14
ROWID_DENSITIES = (0.964, 0.536, 0.289, 0.041, 0.039, 0.036, 0.012)
# the lifecycle phase's sealed batches; the rest of the table stays open
LIFECYCLE_SEALS = (262_144, 262_144, 262_144, 200_000)
SF1_ROWS = 6_001_215                 # TPC-H SF 1 lineitem
SF1_CARDS = (7, 11)                  # l_shipmode, l_discount
SF1_SEED = 1
MOE_TOKENS = 16_384                  # bench_moe_dispatch.run's own T
MOE_EXAMPLE = (8192, 64, 8)          # examples/moe_bitmap_dispatch.py
# 256 sequences x 4096 tokens: olmoe's (E, k), then qwen2-moe's
MOE_TIMED = ((256 * 4096, 64, 8), (256 * 4096, 60, 4))
BITPACK_TIMED_VALUES = 512           # one-hot width of the timed bitpack
GRAY_TIMED_WORDS = 2**26
# the serve plane's workers, then the workers of its restore
PLANE_HOSTS = (2, 3)
PLANE_TIMEOUTS = {"connect_timeout": 300.0, "reply_timeout": 900.0}
# training-data metadata: TokenPipeline's cardinalities, 16 batches
METADATA_DOCS = 1_048_576
METADATA_BATCHES = 16
METADATA_CARDS = {"source": 8, "domain": 32, "quality_bin": 10,
                  "length_bin": 8}
# [lm_serve]: tinyllama-1.1b at its published widths behind the serving
# launcher, with the reference server's defaults and smoke off
LM_ARCH = "tinyllama-1.1b"
LM_PARAMS = 1_100_048_384
LM_WEIGHT_BYTES = 2_200_096_768      # bf16
LM_SERVE_ARGV = ["--no-smoke", "--requests", "64", "--batch", "8",
                 "--gen-tokens", "16", "--max-len", "128"]
LM_PREFILLS = ((8, 32), (8, 112))    # (batch, prompt): the 16-token buckets
LM_DECODE = (8, 128)                 # (batch, cache slots)
LM_TOL = 2e-3                        # tests/test_prefill.py's rtol = atol
LM_SEED = 20
BF16_OPS_PER_S = 989e12              # H100 SXM tensor cores, dense bf16
# [lm_serve], the other families at their published widths: olmoe-1b-7b
# (arXiv:2409.02060) served as tinyllama-1.1b is, at full depth, then one
# packed batch of each other family's config; (parameters, weight bytes)
LM_FAMILIES = {
    "olmoe-1b-7b": (6_919_096_320, 13_842_386_944),
    "qwen2-moe-a2.7b": (15_146_059_776, 30_298_017_792),
    "mamba2-1.3b": (1_343_757_312, 2_687_533_056),
    "zamba2-1.2b": (1_170_473_856, 2_340_962_304),
    "qwen2-vl-7b": (7_615_616_512, 15_231_233_024),
    "musicgen-medium": (1_818_379_776, 3_636_759_552),
}
LM_MOE_ARCH = "olmoe-1b-7b"
LM_ONE_BATCH_ARGV = ["--no-smoke", "--requests", "8", "--batch", "8",
                     "--gen-tokens", "16", "--max-len", "128"]
# the float32 card-against-CPU gate at full width cuts depth to what the
# host holds in float32 (olmoe at 16 layers would be 27.7 GB there); the
# hybrid keeps 7 layers, so that one shared-block slot runs
LM_F32_DEPTH = {"olmoe-1b-7b": 2, "qwen2-moe-a2.7b": 2, "mamba2-1.3b": 4,
                "zamba2-1.2b": 7, "qwen2-vl-7b": 2, "musicgen-medium": 4}
# one packed batch profiled: MoE and SSM serving (olmoe also timed)
LM_PROFILED = ("olmoe-1b-7b", "mamba2-1.3b")
# [lm_train]: tinyllama-1.1b trained at its published widths and depth
# through launch.train.main: 6 steps of 8 x 128 tokens (at batch 8 the
# metadata index seals a 32-row word from the fourth step on, so the
# closing curation query reaches the card's kernels), the closing save,
# then 2 more steps resumed from it
LM_TRAIN_ARGV = ["--no-smoke", "--batch", "8", "--seq", "128", "--steps",
                 "6", "--log-every", "1", "--ckpt-every", "1000"]
LM_TRAIN_MORE = 2
# the float32 card-against-CPU gate: full width, (layers, batch, seq); lr
# 1e-2 from random moments at step 3, so that a gradient's last places move
# an update by ~1e-8 while a wrong sign, bias correction or weight decay
# moves it by ~1e-4; the card and the host sum in other orders:
# loss and grad norm at rtol 1e-4, parameters at atol 1e-5, m at 1e-6
LM_TRAIN_F32 = (2, 2, 64)
LM_TRAIN_TOL = {"loss": 1e-4, "params": 1e-5, "m": 1e-6}
# [lm_mesh]: both launchers with --mesh on a 1x1 mesh (NCCL on the card):
# training with [lm_train]'s argv for LM_MESH_STEPS steps (the schedule is
# the same for any --steps up to 10; at batch 8 the eighth step seals the
# metadata index's second 32-row segment, which no earlier phase queried,
# and the torch backend caches results by content, so the curation query
# reaches the card), its first three losses held against [lm_train]'s at
# a relative LM_MESH_TOL; serving one packed batch (LM_ONE_BATCH_ARGV), its greedy
# tokens identical to the one-card server's
LM_MESH = "1,1"
LM_MESH_STEPS = 8
LM_MESH_TOL = 1e-3
# [dryrun]: full-width cells of the port's dry run on a fake 256- or
# 512-rank world, (arch, shape, flags); the 32k prefill cells take about
# four minutes each of host time and are left to a full --all sweep
DRYRUN_CELLS = (
    ("tinyllama-1.1b", "train_4k", ["--grad-zero"]),  # dense, ZeRO-1 grads
    ("olmoe-1b-7b", "decode_32k", ["--multi-pod"]),   # MoE decode, pod axis
    ("zamba2-1.2b", "long_500k", []),     # hybrid, B = 1: replicated batch
    ("qwen2-vl-7b", "train_4k", []),      # M-RoPE and the patch frontend
)
DRYRUN_TIMEOUT = 600



class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# the query mix
# ---------------------------------------------------------------------------


def make_predicates(T, cards, seed, n=N_PREDICATES):
    """A seeded mix over all four columns: half of it one dashboard template
    (equality on the smallest column AND a fixed range on the largest, so
    those plans share a root and batch together), half random Eq / In /
    Range / Not / nested And-Or."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = sorted(range(len(cards)), key=lambda c: cards[c])
    small, large = order[0], order[-1]
    lo, hi = cards[large] // 25, cards[large] // 25 + cards[large] * 7 // 10

    def leaf(depth=0):
        col = int(rng.integers(0, len(cards)))
        card = cards[col]
        kind = int(rng.integers(0, 5 if depth < 2 else 3))
        if kind == 0:
            return T.Eq(col, int(rng.integers(0, card)))
        if kind == 1:
            vals = rng.integers(0, card, size=int(rng.integers(2, 5)))
            return T.In(col, [int(v) for v in vals])
        if kind == 2:
            a = int(rng.integers(0, card))
            return T.Range(col, a, a + int(rng.integers(1, max(2, card // 3))))
        if kind == 3:
            return T.Not(leaf(depth + 1))
        cls = T.And if rng.random() < 0.5 else T.Or
        return cls(*(leaf(depth + 1) for _ in range(int(rng.integers(2, 4)))))

    preds = []
    for i in range(n):
        if i % 2 == 0:
            preds.append(T.And(T.Eq(small, int(rng.integers(0, cards[small]))),
                               T.Range(large, lo, hi)))
        else:
            cls = T.And if i % 4 == 1 else T.Or
            preds.append(cls(leaf(1), leaf(1), leaf(1)))
    return preds


def build_table(T, tables, name, n_rows, seed):
    make = {"dbgen": tables.make_dbgen_like,
            "census": tables.make_census_like}[name]
    t0 = time.perf_counter()
    cols = make(n_rows, seed=seed)
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="lex",
                                                encoding="auto"))
    secs = time.perf_counter() - t0
    cards = [int(c.max()) + 1 for c in cols]
    log(f"[index] {name}: {n_rows} rows, cards {cards}, encodings "
        f"{list(idx.encodings())}, {idx.size_words()} words, built in "
        f"{secs:.3f} s")
    return cols, idx, cards


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def event_ms(torch, fn, reps, flush, rounds=5):
    """Device time of one ``fn`` call with a cold L2: CUDA events around a
    run of ``reps`` (L2 flush, ``fn``) pairs, minus the same run of flushes
    alone, over the count; the median of ``rounds`` such runs.  The 256 MB
    flush keeps the card busy while the host enqueues the next call, so
    the host's launch overhead does not show as device time."""
    fn()  # warm-up
    torch.cuda.synchronize()

    def per_call(body):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    times = []
    for _ in range(rounds):
        base = per_call(flush.zero_)
        both = per_call(lambda: (flush.zero_(), fn()))
        times.append(max(both - base, 0.0))
    return statistics.median(times)


def bound(nbytes, nops):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = nops / ALU_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def max_err(torch, got, want):
    errs = []
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        errs.append(int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    return max(errs)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def padded_words(kv):
    """A group's padded words as the backend pads them: its plans, its
    distinct streams (planes) and its capacity."""
    (_, share, cap, _), idxs = kv
    return len(idxs) * (max(share) + 1) * cap


def largest_group(be, plans):
    """The group of most padded words: its key, its plans and the number
    of groups."""
    groups = be._group(plans)
    key, idxs = max(groups.items(), key=padded_words)
    return key, idxs, len(groups)


def find_fold(node):
    """The first ("fold", ops, leaves) node: a bit-sliced comparison."""
    if node[0] == "fold" and all(c[0] == "leaf" for c in node[2]):
        return node
    kids = (node[2] if node[0] == "fold" else
            (node[1],) if node[0] == "not" else
            node[1] if node[0] in ("and", "or") else ())
    for c in kids:
        hit = find_fold(c)
        if hit is not None:
            return hit
    return None


# ptxas-checked kernels: library -> (mangled-name pattern, instantiations);
# every instantiation must have no stack frame and no spill
PTXAS_CHECKED = {
    "planfuse": (r"planfuse_kernelILi(\d+)ELi(\d+)E", None),  # D x V classes
    "moe_route": (r"moe_route_kernelILi(\d+)ELb(\d)E", 6),      # NC x VEC
    "histmm": (r"hist_(\w+?)_kernelILi(\d)EEv", 4),        # regime x VEC
    # containerops_kernel<V = 1, 4> and member_kernel
    "containers": (r"(containerops_kernelILi\dE|member_kernel)", 3),
    # the short route's kernel and the wide route's two
    "ewah_and_popcount": (r"(ewah_and_popcount_kernel|ewah_pair_chain_kernel"
                          r"|ewah_pair_tiles_kernel)", 3),
    # the decode's two phases, the encoder's two
    "ewah_decode": (r"ewah_decode_kernel_(markers|expand)", 2),
    "ewah_encode": (r"ewah_encode_kernel_(tiles|write)", 2),
    "rowids": (r"rowids_kernel_(count|write)", 2),
    "bitpack": (r"bitpack_kernelILi(\d+)E", 2),  # 16 or 1 columns a thread
    # the elementwise kernels: 16-byte (V = 4) and 4-byte (V = 1) accesses
    "gray": (r"gray_kernelILi(\d)E", 2),
    "recompress": (r"recompress_kernelILi(\d)E", 2),
    "slicefold": (r"slicefold_kernelILi(\d)E", 2),
    "wordops": (r"wordops_kernelILi(\d)E", 2),
}


# The one kernel allowed a stack frame and spills, with the byte counts
# ptxas reports for it as ceilings (any growth fails):
# ewah_decode_kernel_markers at __launch_bounds__(512, 2), which caps it at
# 64 registers.  At (512, 1) it took 106 registers and no spill, but held
# one block an SM, half the resident clusters, and decoded the median
# dbgen batch 1.18x and the worst-case batch 1.26x slower on the card
# (PERF.md, Findings).
PTXAS_ALLOWED = {"ewah_decode markers": {"stack_frame": 40,
                                         "spill_stores": 44,
                                         "spill_loads": 64}}


def kernel_resources(build, planfuse):
    """ptxas's report for every kernel of the thirteen libraries, each
    instantiation: planfuse_kernel (depth class D, V words a thread; its
    shared memory is all static: code, push list and ring),
    moe_route_kernel (NC mask words, 16-byte reads), the histogram kernels
    (regime, template arguments), the container kernels
    (containerops_kernel's words a thread, and member_kernel), the three
    ewah_and_popcount kernels, the decode's two, the encoder's two,
    bitpack_kernel (16 or 1
    columns a thread) and the elementwise gray, recompress, slicefold and
    wordops kernels (16- and 4-byte accesses); fails unless every stack
    frame and spill is 0 bytes, or within ``PTXAS_ALLOWED`` for the kernel
    it names."""
    import re

    out = {}
    for lib, (pattern, count) in PTXAS_CHECKED.items():
        if count is None:
            count = len(planfuse.DEPTH_CLASSES) * 3
        found = {}
        for name, res in build.resources(lib).items():
            hit = re.search(pattern, name)
            if hit:
                found[f"{lib} {'/'.join(hit.groups())}"] = entry = dict(res)
                log(f"[kernels] {name}: {entry.get('registers')} registers, "
                    f"{entry.get('stack_frame')} bytes stack frame, "
                    f"{entry.get('spill_stores')} + {entry.get('spill_loads')}"
                    f" bytes spill stores + loads, {entry.get('smem')} bytes "
                    f"shared memory")
        check(len(found) == count, f"ptxas reported {len(found)} {lib} "
              f"instantiations, expected {count}")
        out.update(found)
    for key, e in out.items():
        ceiling = PTXAS_ALLOWED.get(key, {})
        check(all(e.get(k) is not None and e[k] <= ceiling.get(k, 0)
                  for k in ("stack_frame", "spill_stores", "spill_loads")),
              f"{key} has a stack frame or spills beyond {ceiling or 0}: "
              f"{e}")
    return out


def kernel_phase(torch, T, idx, plans, device, reps):
    """Each kernel against its plain version on the dbgen mix's largest
    batch: its streams, their decoded planes, the plan's tape, and the
    per-stage path's inputs."""
    from repro_torch.core import ewah
    from repro_torch.core.query import lower_plan
    from repro_torch.kernels import ops, ref

    be = T.TorchBackend(device=device)
    (root, share, cap, n_rows), idxs, n_groups = largest_group(be, plans)
    batch_np, lengths_np = be._pad_group(plans, idxs, cap, share)
    batch, lengths = be._to_device(batch_np, lengths_np)
    B, m, C = batch.shape
    W = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
    # the program the backend runs: its tape pushes plane share[i]
    prog = be._fused_program(root, share)
    check(prog is not None, "the dbgen mix's largest batch does not fuse")
    tape, depth = prog.tape, lower_plan(root)[1]
    log(f"[kernels] dbgen largest batch: B={B} queries x m={m} planes for "
        f"{len(share)} leaves, capacity {C}, W={W} words, tape {len(tape)} "
        f"entries, depth {depth} ({len(prog.code)} steps, {prog.depth} "
        f"register slots; {n_groups} batches in the mix)")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)

    planes = ops.ewah_decode(batch, lengths, W)
    x = planes.reshape(m, -1)
    n = x.shape[1]
    r, _ = ref.plan_fuse(x, prog)
    words = r.reshape(B, W)
    sent = torch.where(words[:, :1] == 0, -1, 0).to(torch.int32)
    prev = torch.cat([sent, words[:, :-1]], dim=1).reshape(-1)
    w_flat = words.reshape(-1)
    fold = find_fold(root)
    if fold is not None:
        f_ops = fold[1]
        f_x = torch.stack([planes[share[c[1]]] for c in fold[2]]).reshape(
            len(fold[2]), -1)
    else:
        f_ops = tuple("and" if i % 2 else "or" for i in range(min(m, 8) - 1))
        f_x = x[: len(f_ops) + 1].contiguous()
    a, b = x[0], x[1 % m]
    stream_bytes = int(lengths_np.sum()) * 4 + lengths_np.nbytes

    cases = {
        "ewah_decode": (lambda: (ops.ewah_decode(batch, lengths, W),),
                        lambda: (ref.ewah_decode(batch, lengths, W),),
                        stream_bytes + m * B * W * 4, m * B * W, 1),
        "planfuse": (lambda: ops.plan_fuse(x, prog),
                     lambda: ref.plan_fuse(x, prog),
                     (m + 2) * n * 4 + len(tape) * 8,
                     (len(tape) + 2) * n, reps),
        "recompress": (lambda: ops.recompress_flags(w_flat, prev),
                       lambda: ref.recompress(w_flat, prev),
                       4 * n * 4, 4 * n, reps),
        "wordops": (lambda: ops.wordops(a, b, "and"),
                    lambda: ref.wordops(a, b, "and"),
                    4 * n * 4, 3 * n, reps),
        "slicefold": (lambda: (ops.slice_fold(f_x, f_ops),),
                      lambda: (ref.slice_fold(f_x, f_ops),),
                      (f_x.shape[0] + 1) * n * 4 + len(f_ops),
                      len(f_ops) * n, reps),
    }
    out = {}
    for name, (kern, plain, nbytes, nops, plain_reps) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max_err(torch, got, want)
        ms = event_ms(torch, kern, reps, flush)
        plain_ms = event_ms(torch, plain, plain_reps, flush,
                            rounds=3 if plain_reps == 1 else 5)
        bound_ms, bound_by = bound(nbytes, nops)
        out[name] = {"max_abs_err": err, "mismatches": mism, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes,
                     "shape": ([B, m, C] if name == "ewah_decode" else
                               list(f_x.shape) if name == "slicefold" else
                               [m, n] if name == "planfuse" else [n])}
        log(f"[kernels] {name}: mismatches {mism}, max_abs_err {err} "
            f"(tolerance 0: bit identity), "
            f"{ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}; "
            f"{bound_ms / max(ms, 1e-9):.1%} of it), plain {plain_ms:.4f} ms")
        check(mism == 0 and err == 0,
              f"{name} kernel disagrees with its plain version")
    out["ewah_decode"]["split_ms"] = split = decode_split(
        torch, batch, lengths, W, reps, flush)
    log(f"[kernels] ewah_decode on the largest batch, by kernel: {split}")
    # the encoder on the batch's answers, then on one answer of the DBGEN
    # cell's width (the batch's first answer repeated to 436,812 words)
    out["ewah_encode"] = encode_timed(torch, "largest batch", words, reps,
                                      flush)
    row = words[0].repeat(-(-DBGEN_CELL_WORDS // W))[:DBGEN_CELL_WORDS]
    out["ewah_encode"]["dbgen_cell_answer"] = encode_timed(
        torch, "one DBGEN-cell answer", row[None].contiguous(), reps, flush)
    out["rowids"] = rowids_timed(torch, device, reps, flush)
    return out


def rowid_answers(torch, device, seed=30):
    """(7, 436,812) int32 answer words of the DBGEN cell, answer b's bits
    set at random with ``ROWID_DENSITIES[b]``, the padding bits past the
    last row included (a "not" in a plan sets them)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    out = torch.empty(len(ROWID_DENSITIES), DBGEN_CELL_WORDS,
                      dtype=torch.int32, device=device)
    for b, d in enumerate(ROWID_DENSITIES):
        bits = torch.rand(DBGEN_CELL_WORDS, 32, generator=g,
                          device=device) < d
        w = (bits.to(torch.int64) << shifts).sum(1)
        out[b] = (w - ((w >> 31) << 32)).to(torch.int32)   # the bit-view
    return out


def rowids_timed(torch, device, reps, flush):
    """``rowids`` on the DBGEN cell's shape: the seven answers in one
    call, held against the plain version (offsets, totals, ids) and, for
    each answer, against the host's ``np.flatnonzero(unpack_bits(...))``;
    then each answer alone, as the cell's one-query groups run it, its
    two kernels timed beside the bound (the words read twice, 8 B an id
    written) and beside the plain version on the card and the host's
    unpack."""
    import numpy as np

    from repro_torch.core import ewah
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rowids as kr

    words = rowid_answers(torch, device)
    B, W = words.shape
    n = DBGEN_CELL_ROWS
    host_words = words.cpu().numpy().view(np.uint32)
    ids, totals = ops.rowids(words, n)
    offsets, _ = ops.rowid_counts(words, n)
    want_off, want_tot = ref.rowid_counts(words, n, kr.TILE)
    mism = (int((ids != ref.rowid_write(words, n)).sum())
            + int((offsets != want_off).sum())
            + int((totals != want_tot.cpu()).sum()))
    ends = np.cumsum(totals.numpy())
    host = ids.cpu().numpy()
    per = []
    for b in range(B):
        t0 = time.perf_counter()
        want = np.flatnonzero(ewah.unpack_bits(host_words[b], n))
        host_ms = (time.perf_counter() - t0) * 1e3
        got = host[ends[b] - int(totals[b]): ends[b]]
        mism += int(not np.array_equal(got, want))
        one = words[b: b + 1]
        off1, tot1 = ops.rowid_counts(one, n)
        n_ids = int(tot1.cpu()[0])
        count_ms = event_ms(torch, lambda: ops.rowid_counts(one, n), reps,
                            flush)
        write_ms = event_ms(torch, lambda: ops.rowid_write(one, n, off1,
                                                           n_ids),
                            reps, flush)
        plain_ms = event_ms(torch, lambda: (ref.rowid_counts(one, n, kr.TILE),
                                            ref.rowid_write(one, n)),
                            max(1, reps // 4), flush, rounds=3)
        nbytes = 8 * W + 8 * n_ids
        bound_ms, bound_by = bound(nbytes, 0)
        per.append({"density": ROWID_DENSITIES[b], "ids": n_ids,
                    "ms": count_ms + write_ms, "count_ms": count_ms,
                    "write_ms": write_ms, "plain_ms": plain_ms,
                    "host_unpack_ms": host_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes})
        log(f"[kernels] rowids, one answer at {ROWID_DENSITIES[b]:.1%} "
            f"({n_ids} ids of {W} words): {count_ms + write_ms:.5f} ms "
            f"(count {count_ms:.5f}, write {write_ms:.5f}; bound "
            f"{bound_ms:.5f} ms, {bound_ms / max(count_ms + write_ms, 1e-9):.1%}"
            f" of it), plain {plain_ms:.4f} ms, host unpack {host_ms:.1f} ms")
    check(mism == 0, "rowids disagrees with its plain version or the "
          "host's unpack")
    log(f"[kernels] rowids on {B} x {W} words ({int(totals.sum())} ids): "
        f"mismatches 0 (tolerance 0: identity) against the plain version "
        f"and np.flatnonzero(unpack_bits)")
    largest = max(per, key=lambda e: e["ids"])
    return {**largest, "max_abs_err": 0, "mismatches": mism,
            "shape": [1, W], "answers": per}


def encode_timed(torch, label, words, reps, flush):
    """``ewah_encode`` on (B, n) words and their classes, held against its
    plain version (``ewah_torch.compress_from_runs`` on the card: streams
    within their lengths, lengths, overflow flags) and timed beside it and
    its bound: the words and classes read once, the streams written
    once."""
    from repro_torch.core import ewah_torch
    from repro_torch.kernels import ops

    B, n = words.shape
    kind = ewah_torch.classify(words)
    cap = ewah_torch.stream_capacity(n)
    kern = lambda: ops.ewah_encode(words, kind, cap)  # noqa: E731
    plain = lambda: ewah_torch.compress_from_runs(words, kind, cap)  # noqa
    got, want = kern(), plain()
    torch.cuda.synchronize()
    keep = torch.arange(cap, device=words.device)[None, :] < want[1][:, None]
    mism = (int(((got[0] != want[0]) & keep).sum())
            + int((got[1] != want[1]).sum()) + int((got[2] != want[2]).sum()))
    check(mism == 0, f"ewah_encode ({label}) disagrees with its plain version")
    nbytes = 8 * B * n + 4 * int(want[1].sum()) + 8 * B
    bound_ms, bound_by = bound(nbytes, 0)
    entry = {"max_abs_err": 0, "mismatches": mism,
             "ms": event_ms(torch, kern, reps, flush),
             "plain_ms": event_ms(torch, plain, max(1, reps // 4), flush,
                                  rounds=3),
             "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
             "shape": [B, n], "stream_words": int(want[1].sum()),
             "overflow_rows": int(want[2].sum())}
    log(f"[kernels] ewah_encode on {label} ({B} x {n} words, "
        f"{entry['stream_words']} stream words, {entry['overflow_rows']} "
        f"rows past one marker a group): mismatches 0 (tolerance 0: bit "
        f"identity), {entry['ms']:.5f} ms (bound {bound_ms:.5f} ms, "
        f"{bound_ms / max(entry['ms'], 1e-9):.1%} of it), plain "
        f"{entry['plain_ms']:.5f} ms")
    return entry


def path_phase(torch, T, name, cols, idx, preds, device):
    """Drive the mix through the user entry points, fused then per stage,
    and hold every answer against the host oracle and evaluate_mask."""
    import numpy as np

    from repro_torch.core.query import NumpyBackend, compile_plan, get_backend
    from repro_torch.kernels import ops

    plans = [compile_plan(idx, p) for p in preds]
    t0 = time.perf_counter()
    oracle = NumpyBackend()
    want_streams = [oracle.execute_compressed(p).data for p in plans]
    t1 = time.perf_counter()
    want_rows = [np.flatnonzero(T.evaluate_mask(p, cols)) for p in preds]
    log(f"[path] {name}: host oracles: NumpyBackend {t1 - t0:.3f} s, "
        f"evaluate_mask {time.perf_counter() - t1:.3f} s")
    result = {"numpy_backend_s": t1 - t0}
    for mode, fuse in (("fused", True), ("per_stage", False)):
        # the entry points run on the card unless told otherwise
        opts = {"fuse": fuse} if device == "cuda" else {"fuse": fuse,
                                                       "device": device}
        get_backend("torch", **opts).result_cache.clear()
        ops.reset_launches()
        rows = idx.query_many(preds, **opts)
        streams = [idx.query_compressed(p, **opts) for p in preds]
        sync(torch, device)
        launches = dict(ops.LAUNCHES)
        bad = 0
        for i, p in enumerate(preds):
            ok = (np.array_equal(streams[i].data, want_streams[i])
                  and np.array_equal(np.sort(idx.row_perm[rows[i][0]]),
                                     want_rows[i])
                  and np.array_equal(streams[i].to_rows(), rows[i][0]))
            if not ok:
                bad += 1
                log(f"[path] {name} {mode}: MISMATCH on {p!r}")
        check(bad == 0, f"{name} {mode}: {bad} predicates disagree")
        need = (["ewah_decode", "planfuse", "ewah_encode", "rowids"]
                if fuse else
                ["ewah_decode", "wordops", "slicefold", "recompress",
                 "ewah_encode", "rowids"])
        for k in need:  # CPU tensors take the plain versions: no launches
            check(device == "cpu" or launches[k] > 0,
                  f"{name} {mode}: {k} never launched")
        log(f"[path] {name} {mode}: {len(preds)} predicates identical to "
            f"NumpyBackend and evaluate_mask; launches {launches}")
        result[mode] = {"launches": launches}

        # throughput: batched calls on a fresh backend, caches cleared
        be = T.TorchBackend(device=device, fuse=fuse)
        be.execute_compressed_many(plans)             # warm-up
        be.result_cache.clear()
        t0 = time.perf_counter()
        be.execute_compressed_many(plans)
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        be.execute_many(plans)
        t_rows = time.perf_counter() - t0
        result[mode].update(
            compressed_qps=len(plans) / t_comp, rows_qps=len(plans) / t_rows,
            compressed_s=t_comp, rows_s=t_rows)
        log(f"[path] {name} {mode}: execute_compressed_many "
            f"{len(plans) / t_comp:.1f} queries/s ({t_comp:.4f} s), "
            f"execute_many {len(plans) / t_rows:.1f} queries/s "
            f"({t_rows:.4f} s)")
    result["split"] = time_split(torch, T, plans, device)
    return result


def in_list_phase(torch, T, cols, idx, device):
    """One TPC-H Q17-shaped IN-list through both entries of a default
    (fused) backend: ``IN_LIST_KEYS`` scattered keys of the dbgen table's
    widest column, each an equality over every slice, so thousands of
    leaves read a few planes and the tape is past planfuse's gate.  The
    answers must equal NumpyBackend's and evaluate_mask's, each distinct
    plane must be padded once, and the per-stage path must launch
    wordops, recompress and ewah_encode (the compressed entry) and
    planfuse never."""
    import numpy as np

    from repro_torch import tracing
    from repro_torch.core.query import NumpyBackend, compile_plan
    from repro_torch.kernels import ops, planfuse

    col = max(range(len(cols)), key=lambda c: int(cols[c].max()))
    card = int(cols[col].max()) + 1
    rng = np.random.default_rng(IN_LIST_SEED)
    keys = np.sort(rng.choice(card // 3, size=min(IN_LIST_KEYS, card // 3),
                              replace=False)) * 3     # no two adjacent
    pred = T.In(col, [int(k) for k in keys])
    plan = compile_plan(idx, pred)
    planes = len({id(s) for s in plan.streams})
    check(2 * len(plan.streams) - 1 > planfuse.MAX_TAPE_LEN
          and planes * 10 < len(plan.streams),
          f"[in_list] {len(plan.streams)} leaves on {planes} planes: not an "
          f"IN-list past planfuse's gate")
    want = NumpyBackend().execute_compressed(plan)
    want_rows = np.flatnonzero(T.evaluate_mask(pred, cols))
    be = T.TorchBackend(device=device, cache_size=0)
    prev = tracing.enable()
    tracing.reset()
    try:
        launches = {}
        for entry, call in (("compressed", be.execute_compressed_many),
                            ("rows", be.execute_many)):
            ops.reset_launches()
            got = call([plan])[0]
            sync(torch, device)
            launches[entry] = dict(ops.LAUNCHES)
            if entry == "compressed":
                check(np.array_equal(got.data, want.data),
                      "[in_list] compressed answer differs from NumpyBackend")
            else:
                check(np.array_equal(np.sort(idx.row_perm[got[0]]),
                                     want_rows),
                      "[in_list] row ids differ from evaluate_mask")
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.enable(prev)
        tracing.reset()
    check(counters["backend.planes"] == 2 * planes
          and counters["backend.leaf_refs"] == 2 * len(plan.streams),
          f"[in_list] padded {counters['backend.planes']} planes for "
          f"{counters['backend.leaf_refs']} leaves over two calls, not "
          f"{2 * planes} for {2 * len(plan.streams)}")
    need = {"compressed": ("ewah_decode", "wordops", "recompress",
                           "ewah_encode"),
            "rows": ("ewah_decode", "wordops", "rowids")}
    for entry, names in need.items():
        check(launches[entry]["planfuse"] == 0,
              f"[in_list] {entry}: planfuse launched past its gate")
        for k in names:  # CPU tensors take the plain versions: no launches
            check(device == "cpu" or launches[entry][k] > 0,
                  f"[in_list] {entry}: {k} never launched")
    log(f"[in_list] In(col {col}, {len(keys)} keys): {len(plan.streams)} "
        f"leaves on {planes} planes, identical to NumpyBackend and "
        f"evaluate_mask ({len(want_rows)} rows); launches "
        f"{ {e: {k: v for k, v in n.items() if v} for e, n in launches.items()} }")
    return {"keys": len(keys), "leaves": len(plan.streams), "planes": planes,
            "launches": launches}


def time_split(torch, T, plans, device):
    """One fused compressed batch of the mix on a fresh backend, split by
    the backend's own spans (``repro_torch.tracing``): grouping and
    padding, the host-to-device copy, and the device program (decode,
    evaluate, encode) with its copy back; and the answers the device
    encoder wrote."""
    from repro_torch import tracing

    be = T.TorchBackend(device=device)
    prev = tracing.enable()
    tracing.reset()
    try:
        be.execute_compressed_many(plans)
        snap = tracing.snapshot()
    finally:
        tracing.enable(prev)
        tracing.reset()
    spans, counters = snap["spans"], snap["counters"]
    split = {f"{k[len('backend.'):]}_s": v["s"] for k, v in spans.items()
             if k.startswith("backend.")}
    split["call_self_s"] = spans["backend.call"]["self_s"]
    split["batches"] = counters["backend.groups"]
    split["h2d_bytes_total"] = counters["backend.h2d_bytes"]
    split["stream_bytes_total"] = counters["backend.stream_bytes"]
    split["h2d_bytes_per_batch_mean"] = (counters["backend.h2d_bytes"]
                                         / max(1, split["batches"]))
    split["encoded"] = counters["backend.encoded"]
    split["leaf_refs"] = counters["backend.leaf_refs"]
    split["planes"] = counters["backend.planes"]
    log("[split] " + ", ".join(f"{k} {v:.6g}" for k, v in split.items()))
    return split


def sync(torch, device):
    if device != "cpu":
        torch.cuda.synchronize()


def container_sets(seed=7):
    """The three Roaring sets over CONTAINER_ROWS rows (array, array and
    bitmap containers) and the generator that goes on to draw the folds."""
    import numpy as np

    from repro_torch.core import containers as C

    rng = np.random.default_rng(seed)
    sets = [C.from_positions(np.flatnonzero(rng.random(CONTAINER_ROWS) < d),
                             CONTAINER_ROWS) for d in CONTAINER_DENSITIES]
    return sets, rng


def member_small(torch, sets, device):
    """member's launch-sized shape: the 0.002 set's array positions
    (P = 16 chunks, right-padded with -1) against the 0.3 set's bitmaps.
    Returns (label, positions, words, distinct words touched, oracle):
    the oracle gives each chunk's hits as the host intersection does."""
    import numpy as np

    from repro_torch.core import containers as C

    sparse, _, dense = sets
    words = torch.from_numpy(np.stack([
        C.chunk_words(c, p) for c, p in zip(dense.classes, dense.payloads)
    ]).view(np.int32)).to(device)
    P, L = len(sparse), max(len(p) for p in sparse.payloads)
    pos = np.full((P, L), -1, dtype=np.int32)
    touched = 0
    for i, p in enumerate(sparse.payloads):
        pos[i, : len(p)] = p
        touched += len(np.unique(np.asarray(p, dtype=np.int64) >> 5))

    def oracle(hits):
        hits = hits.cpu().numpy()
        check(not hits[pos < 0].any(), "member reported a padding lane")
        for i, p in enumerate(sparse.payloads):
            check(np.array_equal(
                np.asarray(p)[hits[i, : len(p)].astype(bool)],
                np.intersect1d(p, C.chunk_positions(dense.classes[i],
                                                    dense.payloads[i]))),
                f"member hits of chunk {i} differ from the dense "
                f"intersection")

    return (f"P={P} x L={L}", torch.from_numpy(pos).to(device), words,
            touched, oracle)


def member_lineitem(torch, device, scale=1.0, seed=17):
    """member where its work is real: one "and" round over a TPC-H
    ``lineitem`` column at scale factor 10 (LINEITEM_SF10_ROWS rows, 916
    Roaring chunks, the last one partial).  Each chunk's array holds
    ARRAY_MAX = 4096 distinct uniform positions of the chunk's rows, each
    bitmap a density-0.3 draw; both drawn on the device from ``seed``.
    ``scale`` cuts the chunk count (a CPU rehearsal).  Returns what
    :func:`member_small` returns; the oracle reads each position's bit
    from the dense draw itself, not from the packed words."""
    from repro_torch.core import containers as C
    from repro_torch.kernels import ref

    n_rows = LINEITEM_SF10_ROWS
    P = -(-n_rows // C.CHUNK_ROWS)
    last = n_rows - (P - 1) * C.CHUNK_ROWS     # rows of the partial chunk
    P = max(1, int(P * scale))
    L = C.ARRAY_MAX
    g = torch.Generator(device=device).manual_seed(seed)
    keys = torch.rand(P, C.CHUNK_ROWS, generator=g, device=device)
    keys[-1, last:] = 2.0           # rows past the table sort last
    pos = keys.argsort(dim=1)[:, :L].sort(dim=1).values.to(torch.int32)
    del keys
    bits = torch.rand(P, C.CHUNK_ROWS, generator=g, device=device) < 0.3
    bits[-1, last:] = False
    words = ref.bitpack(bits.T.contiguous()).T.contiguous()
    wid = pos >> 5                  # sorted positions: sorted word ids
    touched = P + int((wid[:, 1:] != wid[:, :-1]).sum())

    def oracle(hits):
        want = bits.gather(1, pos.long()).to(torch.int32)
        check(bool(torch.equal(hits, want)),
              "member hits differ from the dense draw's bits")

    return f"P={P} x L={L}", pos, words, touched, oracle


def member_timed(torch, label, pos, words, touched, reps, flush):
    """``member`` on one shape held bit for bit against its plain version
    and, on the card, timed beside it.  Bound: bytes, each position read
    and each flag written once (8 B a position) and each distinct word
    touched read once."""
    from repro_torch.kernels import ops, ref

    got = ops.container_gallop(pos, words)
    want = ref.container_gallop(pos, words)
    sync(torch, pos.device.type)
    mism = int((got != want).sum())
    err = max_err(torch, (got,), (want,))
    check(mism == 0 and err == 0,
          f"member {label} disagrees with its plain version")
    P, L = pos.shape
    nbytes = 2 * P * L * 4 + touched * 4
    bound_ms, bound_by = bound(nbytes, 4 * P * L)
    entry = {"max_abs_err": err, "mismatches": mism, "bound_ms": bound_ms,
             "bound_by": bound_by, "bytes": nbytes, "shape": [P, L],
             "valid": int((pos >= 0).sum()), "touched_words": touched,
             "library_ms": None}
    if flush is not None:
        entry["ms"] = event_ms(torch, lambda: ops.container_gallop(
            pos, words), reps, flush)
        entry["plain_ms"] = event_ms(torch, lambda: ref.container_gallop(
            pos, words), reps, flush)
    share = bound_ms / max(entry.get("ms", float("inf")), 1e-9)
    log(f"[containers] member {label} ({entry['valid']} valid, {touched} "
        f"distinct words, {nbytes} B): mismatches {mism}, max_abs_err {err} "
        f"(tolerance 0: bit identity), "
        f"{entry.get('ms', float('nan')):.5f} ms (bound {bound_ms:.5f} ms, "
        f"{bound_by}; {share:.1%} of it), plain "
        f"{entry.get('plain_ms', float('nan')):.5f} ms")
    return entry


def container_phase(torch, T, device, reps, scale=1.0):
    """The container kernels: ``containerops``'s pairwise form (all three
    ops, every chunk of the 0.05 set against the 0.3 set, beside
    ``torch.bitwise_and`` / ``bitwise_or``) and ``member`` at two shapes
    (:func:`member_small`, :func:`member_lineitem`), driven once each
    through ``ops.container_gallop`` against the host oracle, held
    against their plain versions and timed on the card; then
    ``TorchBackend._container_fold_many`` over ten folds of the three sets
    ("and" folds included) against the host ``containers.fold``, which
    must take one ``containerops`` launch and no ``member`` launch, that
    launch event-timed against its bound."""
    import numpy as np

    from repro_torch.core import containers as C
    from repro_torch.kernels import ops, ref

    n = CONTAINER_ROWS
    sets, rng = container_sets()
    for d, cs in zip(CONTAINER_DENSITIES, sets):
        kinds = [C.CONTAINER_CLASSES[c] for c in cs.classes]
        log(f"[containers] density {d}: {len(cs)} chunks, classes "
            f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }, "
            f"{cs.n_set()} rows set")
    sparse, mid, dense = sets
    check(len(dense) == len(mid) == len(sparse) == -(-n // C.CHUNK_ROWS),
          "every chunk holds rows at every density")
    check(all(c == C.ARRAY for c in sparse.classes)
          and all(c == C.BITMAP for c in dense.classes),
          "0.002 gives array containers and 0.3 bitmap containers")

    a = torch.from_numpy(np.stack([
        C.chunk_words(c, p) for c, p in zip(mid.classes, mid.payloads)
    ]).view(np.int32)).to(device)
    small = member_small(torch, sets, device)
    bitmaps = small[2]
    P = a.shape[0]
    log(f"[containers] containerops on P={P} x {C.CHUNK_WORDS} words")

    out = {"kernels": {}}
    flush = (torch.empty(64 * 2**20, dtype=torch.int32, device=device)
             if device != "cpu" else None)
    library = {"and": torch.bitwise_and, "or": torch.bitwise_or}
    per_op = {}
    for op in ("and", "or", "andnot"):
        got = ops.container_pairs(a, bitmaps, op)
        want = ref.container_pairs(a, bitmaps, op)
        sync(torch, device)
        mism = int((got != want).sum())
        err = max_err(torch, (got,), (want,))
        check(mism == 0 and err == 0,
              f"containerops {op} disagrees with its plain version")
        entry = {"mismatches": mism, "max_abs_err": err}
        if flush is not None:
            entry["ms"] = event_ms(
                torch, lambda: ops.container_pairs(a, bitmaps, op), reps,
                flush)
            entry["plain_ms"] = event_ms(
                torch, lambda: ref.container_pairs(a, bitmaps, op), reps,
                flush)
            fn = library.get(op)
            entry["library_ms"] = (None if fn is None else event_ms(
                torch, lambda: fn(a, bitmaps), reps, flush))
        per_op[op] = entry
        log(f"[containers] containerops {op}: mismatches {mism}, "
            f"max_abs_err {err} (tolerance 0: bit identity); "
            + ", ".join(f"{k} {v:.5f}" for k, v in entry.items()
                        if k.endswith("ms") and v is not None))
    nbytes = 3 * P * C.CHUNK_WORDS * 4
    bound_ms, bound_by = bound(nbytes, P * C.CHUNK_WORDS)
    out["kernels"]["containerops"] = {
        **{k: per_op["and"].get(k) for k in ("ms", "plain_ms", "library_ms")},
        "max_abs_err": max(e["max_abs_err"] for e in per_op.values()),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "shape": [P, C.CHUNK_WORDS], "per_op": per_op,
        "timed_op": "and"}

    # member: no path of the port launches it (the fold below intersects
    # inside containerops), so it is driven directly, as a caller of
    # ops.container_gallop would, once a shape; those calls are its count
    shapes = [small, member_lineitem(torch, device, scale)]
    ops.reset_launches()
    for _, pos, words, _, oracle in shapes:
        oracle(ops.container_gallop(pos, words))
    out["member_direct_calls"] = ops.LAUNCHES["member"]
    check(device == "cpu" or out["member_direct_calls"] == len(shapes),
          f"{len(shapes)} direct container_gallop calls launched member "
          f"{out['member_direct_calls']} times")
    timed = [member_timed(torch, label, pos, words, touched, reps, flush)
             for label, pos, words, touched, _ in shapes]
    del shapes
    # the row of the final line: the shape whose work is real
    out["kernels"]["member"] = {**timed[1], "small": timed[0]}

    # the fold drive: "and" folds too, all in one containerops launch
    folds = [((0, 2), ("and",)), ((2, 0), ("and",)), ((1, 2), ("or",)),
             ((2, 1), ("andnot",)), ((0, 2, 1, 2), ("and", "or", "andnot")),
             ((0, 1, 2), ("or", "and"))]
    for _ in range(4):
        k = int(rng.integers(2, 5))
        folds.append((tuple(int(i) for i in rng.integers(0, 3, size=k)),
                      tuple(str(o) for o in rng.choice(
                          ["and", "or", "andnot"], size=k - 1))))
    drive = [([sets[i] for i in ids], fops, n) for ids, fops in folds]
    be = T.TorchBackend(device=device)
    ops.reset_launches()
    t0 = time.perf_counter()
    fold_out = be._container_fold_many(drive)
    sync(torch, device)
    fold_s = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in ("containerops", "member")}
    for (sets_, fops, _), got in zip(drive, fold_out):
        check(np.array_equal(got, C.fold(sets_, fops, n)),
              f"container fold {fops} differs from containers.fold")
    check(device == "cpu" or launches == {"containerops": 1, "member": 0},
          f"the fold drive took {launches} launches, not one containerops "
          f"launch and no member launch")
    log(f"[containers] {len(folds)} folds identical to containers.fold in "
        f"{fold_s:.4f} s host clock (the per-round route it replaced: 13 "
        f"launches, 0.1155-0.2045 s on an H100 80GB HBM3 at 700 W); "
        f"launches {launches}")
    out.update(folds=len(folds), fold_s=fold_s, launches=launches,
               fold_launch=fold_launch_phase(torch, drive, device, reps,
                                             "fold drive"))
    return out


def lifecycle_phase(torch, T, cols, cards, preds, device, scale):
    """The segmented LSM path: ingest through an IndexWriter with a fixed
    point-query workload on the two small columns, delete about 1 % of the
    rows on the card, compact the first two segments (their small columns
    become Roaring), and answer the mix through the SegmentedIndex, fused
    and per stage."""
    import numpy as np

    from repro_torch.core.query import (compile_plan, get_backend,
                                        lower_containers_many, with_live_mask)
    from repro_torch.kernels import ops
    from repro_torch.workload import WorkloadStats

    n = len(cols[0])
    order = sorted(range(len(cards)), key=lambda c: cards[c])
    small, large = order[:2], order[-1]
    stats = WorkloadStats()
    for i in range(64):
        stats.record(small[i % 2], "eq", 1, "equality", 1, 40.0 + i % 3)
    seals = [max(32, int(s * scale) // 32 * 32) for s in LIFECYCLE_SEALS]
    check(sum(seals) < n, "the lifecycle leaves rows in the open buffer")
    result = {}
    t0 = time.perf_counter()
    w = T.IndexWriter(T.IndexSpec(row_order="lex", encoding="auto"),
                      workload_stats=stats)
    lo = 0
    for size in seals:
        w.append([c[lo : lo + size] for c in cols])
        w.seal()
        lo += size
    w.append([c[lo:] for c in cols])
    result["ingest_s"] = time.perf_counter() - t0
    check(w.buffered_rows == n - lo, "open buffer size")
    width = max(1, cards[large] // 100)
    a = cards[large] // 3
    doomed = T.Range(large, a, a + width - 1)
    dead = T.evaluate_mask(doomed, cols)
    ops.reset_launches()
    t0 = time.perf_counter()
    # on the card unless rehearsing on the CPU (delete takes no device)
    deleted = w.delete(doomed, backend="torch" if device != "cpu" else "numpy")
    sync(torch, device)
    result["delete_s"] = time.perf_counter() - t0
    result["delete_launches"] = dict(ops.LAUNCHES)
    check(deleted == int(dead.sum()),
          f"delete tombstoned {deleted} rows, evaluate_mask says "
          f"{int(dead.sum())}")
    t0 = time.perf_counter()
    merged = w.compact(span=(0, 2))
    result["compact_s"] = time.perf_counter() - t0
    enc = merged.index.encodings()
    check(all(enc[c] == "roaring" for c in small),
          f"compaction did not re-encode the small columns {small} to "
          f"roaring: {enc}")
    segs = w.segments
    result["segments"] = [{"rows": s.n_rows, "span": [s.row_start,
                                                      s.row_stop],
                           "encodings": list(s.index.encodings())}
                          for s in segs]
    result["buffered_rows"] = w.buffered_rows
    log(f"[lifecycle] {len(seals)} seals of {seals} rows, "
        f"{w.buffered_rows} rows open; deleted {deleted} rows "
        f"({deleted / n:.2%}) in {result['delete_s']:.3f} s; compacted "
        f"segments 0-1 in {result['compact_s']:.3f} s")
    for i, sg in enumerate(result["segments"]):
        log(f"[lifecycle] segment {i}: {sg['rows']} rows, span {sg['span']},"
            f" encodings {sg['encodings']}")

    alive = ~dead
    want_rows = [np.flatnonzero(T.evaluate_mask(p, cols) & alive)
                 for p in preds]
    t0 = time.perf_counter()
    want_comp = [m.data for _, m in
                 w.index.execute_compressed_many(preds, backend="numpy")]
    result["numpy_backend_s"] = time.perf_counter() - t0
    for mode, fuse in (("fused", True), ("per_stage", False)):
        opts = {"fuse": fuse} if device != "cpu" else {"fuse": fuse,
                                                       "device": device}
        be = get_backend("torch", **opts)
        be.result_cache.clear()
        ops.reset_launches()
        t0 = time.perf_counter()
        rows = w.index.query_many(preds, **opts)
        sync(torch, device)
        t_rows = time.perf_counter() - t0
        be.result_cache.clear()
        t0 = time.perf_counter()
        comp = w.index.execute_compressed_many(preds, **opts)
        sync(torch, device)
        t_comp = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        bad = 0
        for i, p in enumerate(preds):
            if not (np.array_equal(rows[i][0], want_rows[i])
                    and np.array_equal(comp[i][1].data, want_comp[i])):
                bad += 1
                log(f"[lifecycle] {mode}: MISMATCH on {p!r}")
        check(bad == 0, f"lifecycle {mode}: {bad} predicates disagree")
        need = ["containerops", "ewah_decode"] + (
            ["planfuse"] if fuse else ["wordops", "slicefold", "recompress"])
        for k in need:
            check(device == "cpu" or launches[k] > 0,
                  f"lifecycle {mode}: {k} never launched")
        result[mode] = {"launches": launches, "rows_s": t_rows,
                        "compressed_s": t_comp,
                        "rows_qps": len(preds) / t_rows,
                        "compressed_qps": len(preds) / t_comp}
        log(f"[lifecycle] {mode}: {len(preds)} predicates identical to "
            f"evaluate_mask over the live rows and backend='numpy'; "
            f"query_many {len(preds) / t_rows:.1f} queries/s, "
            f"execute_compressed_many {len(preds) / t_comp:.1f} queries/s; "
            f"launches {launches}")

    # the container fold's wall time against the batched device program,
    # on the SegmentedIndex's own per-segment plans
    be = T.TorchBackend(device=device)
    t0 = time.perf_counter()
    plans = [with_live_mask(compile_plan(s.index, p), s.live_stream())
             for p in preds for s in segs if s.n_rows]
    t1 = time.perf_counter()
    n_cfold = sum(1 for p in plans if p.containers)
    folds = []

    def fold_many(batch):
        folds.extend(batch)
        return be._container_fold_many(batch)

    ops.reset_launches()
    t1 = time.perf_counter()
    plans = lower_containers_many(plans, fold_many)
    sync(torch, device)
    t2 = time.perf_counter()
    fold_launches = ops.LAUNCHES["containerops"]
    be.execute_compressed_many(plans)
    sync(torch, device)
    t3 = time.perf_counter()
    check(device == "cpu" or fold_launches == 1,
          f"the batched lowering took {fold_launches} containerops "
          f"launches, not 1")
    result["split"] = {"plans": len(plans), "plans_with_cfold": n_cfold,
                       "folds": len(folds), "compile_s": t1 - t0,
                       "container_fold_s": t2 - t1,
                       "device_program_s": t3 - t2,
                       "fold_share": (t2 - t1) / (t3 - t1),
                       "containerops_launches_per_call": fold_launches}
    log("[lifecycle] split: " + ", ".join(
        f"{k} {v:.6g}" for k, v in result["split"].items()))
    result["folds"] = folds
    # the serve-plane phase serves this writer
    result["writer"], result["dead"] = w, dead
    return result


def fold_launch_phase(torch, folds, device, reps, label):
    """``folds`` in one ``containerops`` launch, as the backend packs
    them: held bit for bit against the plain version and the host
    ``containers.merge`` fold, and timed on the card.  Bound: the packed
    buffer (tables and compact payloads) read once and the planes written
    once."""
    import numpy as np

    from repro_torch.core import containers as C
    from repro_torch.kernels import containers as KC
    from repro_torch.kernels import ops, ref

    packed = KC.pack_folds(folds)
    buf = torch.from_numpy(packed.buf).to(device)
    classes = {C.CONTAINER_CLASSES[c]: 0 for c in range(3)}
    for sets, _, _ in folds:
        for cs in sets:
            for c in cs.classes:
                classes[C.CONTAINER_CLASSES[c]] += 1
    got = ops.container_fold(buf, packed)
    want = ref.container_fold(buf, packed)
    sync(torch, device)
    mism = int((got != want).sum())
    err = max_err(torch, (got,), (want,))
    check(mism == 0 and err == 0,
          f"containerops ({label}) disagrees with its plain version")
    host = got.cpu().numpy().view(np.uint32)
    for (sets, fops, n), (off, W) in zip(folds, packed.planes):
        acc = sets[0]
        for op, nxt in zip(fops, sets[1:]):
            acc = C.merge(acc, nxt, op)
        check(np.array_equal(host[off: off + W], C.to_words(acc)),
              f"a {label} plane differs from the folded set's words")
    nbytes = packed.buf.nbytes + packed.n_out * 4
    bound_ms, bound_by = bound(nbytes, packed.n_chunks * C.CHUNK_WORDS)
    entry = {"max_abs_err": err, "mismatches": mism, "bound_ms": bound_ms,
             "bound_by": bound_by, "bytes": nbytes, "library_ms": None,
             "folds": len(folds), "chunks": packed.n_chunks,
             "steps": packed.n_steps, "out_words": packed.n_out,
             "containers": classes}
    if device != "cpu":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
        entry["ms"] = event_ms(torch, lambda: ops.container_fold(buf, packed),
                               reps, flush)
        entry["plain_ms"] = event_ms(
            torch, lambda: ref.container_fold(buf, packed), reps, flush,
            rounds=3)
    log(f"[containers] {label}: {len(folds)} folds, "
        f"{packed.n_chunks} chunks, {packed.n_steps} steps, containers "
        f"{classes}, {packed.buf.nbytes} B packed + {packed.n_out * 4} B "
        f"planes; mismatches {mism}, max_abs_err {err} (tolerance 0: bit "
        f"identity), {entry.get('ms', float('nan')):.5f} ms (bound "
        f"{bound_ms:.5f} ms, {bound_by}; "
        f"{bound_ms / max(entry.get('ms', float('inf')), 1e-9):.1%} of it), "
        f"plain {entry.get('plain_ms', float('nan')):.5f} ms")
    return entry


def plane_answers(plane, preds, opts, want_rows, want_comp, label, device,
                  need=("ewah_decode", "planfuse", "containerops")):
    """The mix through a serve plane's three surfaces, held against the
    host answers; requires the workers to report launches of the kernels
    in ``need``.  Returns the mix's wall time and the workers' launches."""
    import numpy as np

    before = plane.stats()["worker_launches"]
    t0 = time.perf_counter()
    comp = plane.execute_compressed_many(preds, **opts)
    mix_s = time.perf_counter() - t0
    rows = plane.query_many(preds, **opts)
    counts = plane.count_many(preds, **opts)
    after = plane.stats()["worker_launches"]
    launches = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
    bad = 0
    for i, p in enumerate(preds):
        if not (np.array_equal(comp[i][1].data, want_comp[i])
                and np.array_equal(rows[i][0], want_rows[i])
                and counts[i] == len(want_rows[i])):
            bad += 1
            log(f"[serve_plane] {label}: MISMATCH on {p!r}")
    check(bad == 0, f"serve plane {label}: {bad} predicates disagree")
    for k in need:
        check(device == "cpu" or launches.get(k, 0) > 0,
              f"serve plane {label}: the workers never launched {k}")
    log(f"[serve_plane] {label}: {len(preds)} predicates identical to the "
        f"in-process index and backend='numpy' (rows, streams, counts); "
        f"execute_compressed_many {mix_s:.4f} s on the host clock; worker "
        f"launches {launches}")
    return {"mix_s": mix_s, "worker_launches": launches}


def serve_plane_phase(torch, T, w, cols, dead, cards, preds, device):
    """The lifecycle writer served by ServePlane(w, n_hosts=2): each
    worker process opens its own CUDA context on the card.  The mix
    before and after a broadcast delete, then a two-phase checkpoint and
    a restore at 3 workers, each held against the in-process index on
    the card, backend='numpy' and evaluate_mask over the live rows."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core.query import get_backend
    from repro_torch.dist.serve_plane import ServePlane

    opts = {} if device != "cpu" else {"device": "cpu"}
    large = max(range(len(cards)), key=lambda c: cards[c])
    result = {"launches": {}}

    def host_answers(alive):
        rows = [np.flatnonzero(T.evaluate_mask(p, cols) & alive)
                for p in preds]
        comp = [m.data for _, m in
                w.index.execute_compressed_many(preds, backend="numpy")]
        get_backend("torch", **opts).result_cache.clear()
        t0 = time.perf_counter()
        mine = w.index.execute_compressed_many(preds, **opts)
        sync(torch, device)
        inproc_s = time.perf_counter() - t0
        check(all(np.array_equal(m.data, c) for (_, m), c in zip(mine, comp)),
              "the in-process index disagrees with backend='numpy'")
        return rows, comp, inproc_s

    def add_launches(plane):
        for k, v in plane.stats()["worker_launches"].items():
            result["launches"][k] = result["launches"].get(k, 0) + v

    alive = ~dead
    want_rows, want_comp, result["inproc_mix_s"] = host_answers(alive)
    t0 = time.perf_counter()
    plane = ServePlane(w, n_hosts=PLANE_HOSTS[0], **PLANE_TIMEOUTS)
    result["spawn_s"] = time.perf_counter() - t0
    ckpt_dir = tempfile.mkdtemp(prefix="serve_plane_ckpt.")
    try:
        t0 = time.perf_counter()
        result["sync_ship_bytes"] = plane.sync()
        result["sync_s"] = time.perf_counter() - t0
        result["owners"] = dict(plane._owner_of)
        # the workers' first query: CUDA contexts and kernel libraries
        t0 = time.perf_counter()
        plane.count(T.Not(T.Eq(large, 0)), **opts)
        result["first_query_s"] = time.perf_counter() - t0
        log(f"[serve_plane] {PLANE_HOSTS[0]} workers spawned in "
            f"{result['spawn_s']:.3f} s; sync shipped "
            f"{result['sync_ship_bytes']} B in {result['sync_s']:.3f} s "
            f"(owners by generation {result['owners']}); first query "
            f"{result['first_query_s']:.3f} s; the in-process index's mix "
            f"{result['inproc_mix_s']:.4f} s")
        result["before_delete"] = plane_answers(
            plane, preds, opts, want_rows, want_comp, "before delete",
            device)

        width = max(1, cards[large] // 100)
        a = cards[large] * 2 // 3
        doomed = T.Range(large, a, a + width - 1)
        hit = T.evaluate_mask(doomed, cols) & alive
        t0 = time.perf_counter()
        deleted = plane.delete(doomed, **({} if device != "cpu"
                                          else {"backend": "numpy"}))
        result["delete_s"] = time.perf_counter() - t0
        check(deleted == int(hit.sum()),
              f"the plane's delete tombstoned {deleted} rows, "
              f"evaluate_mask says {int(hit.sum())}")
        alive &= ~hit
        log(f"[serve_plane] delete of {doomed!r} broadcast: {deleted} rows "
            f"in {result['delete_s']:.3f} s")
        want_rows, want_comp, result["inproc_mix_after_delete_s"] = \
            host_answers(alive)
        # a delete leaves the Roaring folds as they were: the workers'
        # result caches hold them, so no containerops launch is due
        result["after_delete"] = plane_answers(
            plane, preds, opts, want_rows, want_comp, "after delete", device,
            need=("ewah_decode", "planfuse"))
        stats = plane.stats()
        result["stats"] = stats
        result["result_bytes_ratio"] = (stats["result_bytes_compressed"]
                                        / stats["result_bytes_dense"])
        log(f"[serve_plane] ship_bytes {stats['ship_bytes']}, "
            f"result_bytes_compressed {stats['result_bytes_compressed']} "
            f"against result_bytes_dense {stats['result_bytes_dense']} "
            f"({result['result_bytes_ratio']:.4f})")

        t0 = time.perf_counter()
        plane.save_checkpoint(ckpt_dir, 1)
        result["save_s"] = time.perf_counter() - t0
        add_launches(plane)
        plane.close()
        t0 = time.perf_counter()
        plane = ServePlane.restore(ckpt_dir, n_hosts=PLANE_HOSTS[1],
                                   **PLANE_TIMEOUTS)
        result["restore_ship_bytes"] = plane.sync()
        result["restore_s"] = time.perf_counter() - t0
        result["restored_owners"] = dict(plane._owner_of)
        check(plane.restored_step == 1 and plane.world_size == PLANE_HOSTS[1],
              "the restore did not come up at step 1 on 3 workers")
        log(f"[serve_plane] two-phase checkpoint saved in "
            f"{result['save_s']:.3f} s; restored at {PLANE_HOSTS[1]} "
            f"workers (re-seal, spawn, ship {result['restore_ship_bytes']} "
            f"B) in {result['restore_s']:.3f} s; owners by generation "
            f"{result['restored_owners']}")
        plane.count(T.Not(T.Eq(large, 0)), **opts)
        result["restored"] = plane_answers(
            plane, preds, opts, want_rows, want_comp, "restored at 3",
            device)
        add_launches(plane)
    finally:
        plane.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return result


def metadata_phase(torch, T, device, scale):
    """MetadataIndex over METADATA_DOCS documents' metadata (16 batches
    drawn uniformly at TokenPipeline's cardinalities, seed 0; the default
    spec: k=1, grayfreq rows, heuristic columns, equality) in its three
    topologies, each query held against a numpy mask."""
    import numpy as np

    from repro_torch.data.metadata_index import MetadataIndex
    from repro_torch.kernels import ops

    opts = {} if device != "cpu" else {"device": "cpu"}
    batch = max(64, int(METADATA_DOCS * scale) // METADATA_BATCHES)
    rng = np.random.default_rng(0)
    batches = [{c: rng.integers(0, card, batch)
                for c, card in METADATA_CARDS.items()}
               for _ in range(METADATA_BATCHES)]
    cols = {c: np.concatenate([b[c] for b in batches])
            for c in METADATA_CARDS}
    queries = (
        ("where domain=3, quality_bin=8",
         lambda mi: mi.query(where={"domain": 3, "quality_bin": 8}, **opts),
         (cols["domain"] == 3) & (cols["quality_bin"] == 8)),
        ("In(domain, [1, 3])",
         lambda mi: mi.query_pred(T.In("domain", [1, 3]), **opts),
         np.isin(cols["domain"], [1, 3])),
    )
    result = {"docs": batch * METADATA_BATCHES, "launches": {}}
    for topo, kw in (("hosts=0", {"hosts": 0}),
                     ("query_fanout=4", {"query_fanout": 4}),
                     ("hosts=2", {"hosts": 2,
                                  "plane_opts": PLANE_TIMEOUTS})):
        mi = MetadataIndex(**kw)
        try:
            t0 = time.perf_counter()
            for b in batches:
                mi.add_batch(b)
            entry = {"ingest_s": time.perf_counter() - t0}
            before = {}
            if mi.hosts >= 2:
                t0 = time.perf_counter()
                entry["plane_ship_bytes"] = mi.plane.sync()
                entry["plane_start_s"] = time.perf_counter() - t0
                before = mi.plane.stats()["worker_launches"]
            ops.reset_launches()
            for label, run_query, mask in queries:
                t0 = time.perf_counter()
                rows, _ = run_query(mi)
                entry[label] = {"s": time.perf_counter() - t0,
                                "rows": len(rows)}
                check(np.array_equal(rows, np.flatnonzero(mask)),
                      f"metadata {topo}: {label} differs from the numpy mask")
            if mi.hosts >= 2:
                after = mi.plane.stats()["worker_launches"]
                launches = {k: v - before.get(k, 0) for k, v in after.items()}
            else:
                launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            for k in ("ewah_decode", "planfuse"):
                check(device == "cpu" or launches.get(k, 0) > 0,
                      f"metadata {topo}: {k} never launched")
            for k, v in launches.items():
                result["launches"][k] = result["launches"].get(k, 0) + v
            entry["launches"] = launches
            result[topo] = entry
            log(f"[metadata] {topo}: {result['docs']} documents in "
                f"{METADATA_BATCHES} batches ingested in "
                f"{entry['ingest_s']:.3f} s"
                + (f", plane spawned and synced in "
                   f"{entry['plane_start_s']:.3f} s" if mi.hosts >= 2
                   else "") + "; "
                + "; ".join(f"{lb} {entry[lb]['rows']} rows in "
                            f"{entry[lb]['s']:.4f} s" for lb, _, _ in queries)
                + f", identical to the numpy masks; launches {launches}")
        finally:
            mi.close()
    return result


def popcount_np(x):
    """np.bitwise_count where numpy has it."""
    import numpy as np

    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    return np.unpackbits(x.view(np.uint8)).reshape(len(x), -1).sum(axis=1)


def dbgen_pairs(idx):
    """The 79 short pairs: every pair of the dbgen-like index's two
    equality columns' bitmaps (lex row order, a few markers a stream), and
    the reference tests' sparse and all-ones pairs; with each pair's count
    from np.bitwise_count of the decompressed AND."""
    import numpy as np

    from repro_torch.core import ewah

    eq = [c.encoding for c in idx.columns if c.encoding.kind == "equality"]
    check(len(eq) == 2, f"the dbgen-like index has {len(eq)} equality "
          "columns, expected 2")
    pairs = [(a, len(a), b, len(b)) for a in eq[0].streams
             for b in eq[1].streams]
    sparse_a = np.zeros(100_000, dtype=np.uint32)
    sparse_b = np.zeros(100_000, dtype=np.uint32)
    sparse_a[5000:5010] = 0xDEADBEEF
    sparse_b[5005:5020] = 0xFFFFFFFF
    ones = np.full(320, 0xFFFFFFFF, dtype=np.uint32)
    for a, b in ((sparse_a, sparse_b), (ones, ones)):
        sa, sb = ewah.compress(a), ewah.compress(b)
        pairs.append((sa, len(sa), sb, len(sb)))
    want = [int(popcount_np(ewah.decompress(sa) & ewah.decompress(sb)).sum())
            for sa, _, sb, _ in pairs]
    return pairs, want


def sf1_pairs(n_rows=SF1_ROWS):
    """The cross-tab ``count(*) GROUP BY l_shipmode, l_discount`` over a
    TPC-H SF 1 lineitem: ``uniform_column`` at cardinalities 7 and 11,
    6,001,215 rows (``n_rows``), seed 1 (the dbgen-like table's two small
    columns at that scale), equality bitmaps in table order compressed by
    ``ewah.compress``: 7 x 11 = 77 pairs of mostly dirty streams.  With
    each pair's count from np.bitwise_count of the AND of the words."""
    import numpy as np

    from repro_torch.core import ewah
    from repro_torch.data import tables

    rng = np.random.default_rng(SF1_SEED)
    words = []
    for card in SF1_CARDS:
        col = tables.uniform_column(n_rows, card, rng)
        words.append([ewah.positions_to_words(np.flatnonzero(col == v),
                                              n_rows) for v in range(card)])
    streams = [[ewah.compress(w) for w in side] for side in words]
    pairs = [(a, len(a), b, len(b)) for a in streams[0] for b in streams[1]]
    want = [int(popcount_np(wa & wb).sum()) for wa in words[0]
            for wb in words[1]]
    return pairs, want


def and_popcount_shape(torch, label, pairs, want, device, reps):
    """``and_popcount_many`` over ``pairs`` once, its counts against
    ``want``; then the kernel held against its plain versions on the same
    device tensors, counts and iterations (the wide route phase by phase:
    the chain kernel's tables against ``ref.ewah_pair_chain``, the tile
    kernel on the plain tables against ``ref.ewah_pair_tiles``; the step
    walk only on the short route, since it syncs with the host every
    step), and timed beside its bound."""
    from repro_torch.core.ewah_stream import and_popcount_many, pack_pairs
    from repro_torch.kernels import ewah_and_popcount as launcher
    from repro_torch.kernels import ops, ref

    where = None if device != "cpu" else "cpu"
    args = pack_pairs(pairs, where)
    short = launcher.is_short(args[0], args[3])
    ops.reset_launches()
    t0 = time.perf_counter()
    counts, iters = and_popcount_many(pairs, device=where)
    wall_s = time.perf_counter() - t0
    launches = ops.LAUNCHES["ewah_and_popcount"]
    check(device == "cpu" or launches == (1 if short else 2),
          f"and_popcount_many took {launches} launches on the "
          f"{'short' if short else 'wide'} route")
    for k, (sa, _, sb, _) in enumerate(pairs):
        check(int(counts[k]) & 0xFFFFFFFF == want[k] & 0xFFFFFFFF,
              f"and_popcount {label} pair {k}: {int(counts[k])} against "
              f"{want[k]} from the decompressed AND")
        check(iters[k] <= len(sa) + len(sb) + 4,
              f"and_popcount {label} pair {k} took {iters[k]} steps")
    N, T = launcher.N_WORDS, launcher.TILE
    if short:
        plain = lambda: ref.ewah_and_popcount(*args)  # noqa: E731
    else:
        sa, la, na, sb, lb, nb = args
        tables = (ref.ewah_pair_chain(sa, la, N, T),
                  ref.ewah_pair_chain(sb, lb, N, T))
        bad = 0
        for got, want_t in zip(ops.ewah_pair_chain(sa, la, sb, lb), tables):
            bad += int((got[2] != want_t[2]).sum() + (got[3] != want_t[3])
                       .sum())
            for r, k in enumerate(want_t[2][:, 0].tolist()):
                bad += int((got[0][r, :k] != want_t[0][r, :k]).sum()
                           + (got[1][r, :k] != want_t[1][r, :k]).sum())
        check(bad == 0, "ewah_pair_chain_kernel disagrees with "
                        "ref.ewah_pair_chain")
        held(torch, "ewah_pair_tiles",
             lambda: ops.ewah_pair_tiles(*args, *tables),
             lambda: ref.ewah_pair_tiles(*args, *tables, N))
        markers = [t[2][:, 0] for t in tables]  # each stream's table count
        plain = lambda: ref.ewah_pair_tiles(  # noqa: E731
            *args, ref.ewah_pair_chain(sa, la, N, T),
            ref.ewah_pair_chain(sb, lb, N, T), N)
    err, mism = held(torch, "ewah_and_popcount",
                     lambda: ops.ewah_and_popcount(*args), plain)
    words = sum(p[1] + p[3] for p in pairs)
    nbytes = 4 * words + 4 * 4 * len(pairs) + 8 * len(pairs)
    bound_ms, bound_by = bound(nbytes, int(iters.sum()))
    entry = {"max_abs_err": err, "mismatches": mism, "bound_ms": bound_ms,
             "bound_by": bound_by, "bytes": nbytes, "library_ms": None,
             "route": "short" if short else "wide",
             "launches_per_call": launches, "pairs": len(pairs),
             "stream_words": int(words), "iterations": int(iters.sum()),
             "max_iterations": int(iters.max()), "wall_s": wall_s}
    if not short:
        entry["markers_a_stream"] = {
            side: [int(m.min()), int(m.max())]
            for side, m in zip(("a", "b"), markers)}
    if device != "cpu":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
        entry["ms"] = event_ms(torch, lambda: ops.ewah_and_popcount(*args),
                               reps, flush)
        entry["plain_ms"] = event_ms(torch, plain, 3, flush, rounds=3)
        if not short:  # each launch of the wide route alone
            made = ops.ewah_pair_chain(sa, la, sb, lb)
            entry["split_ms"] = {
                "chain_ms": event_ms(
                    torch, lambda: ops.ewah_pair_chain(sa, la, sb, lb), reps,
                    flush),
                "tiles_ms": event_ms(
                    torch, lambda: ops.ewah_pair_tiles(*args, *made), reps,
                    flush)}
    log(f"[and_popcount] {label}: {len(pairs)} pairs, {words} stream words, "
        f"{int(iters.sum())} steps (at most {int(iters.max())} a pair); "
        f"{entry['route']} route, {launches} launch(es) a call; "
        f"and_popcount_many {wall_s:.4f} s; counts identical to "
        f"np.bitwise_count of the decompressed AND; against the plain "
        f"version{'' if short else 's of both phases'}: mismatches {mism}, "
        f"max_abs_err {err} (tolerance 0); "
        f"{entry.get('ms', float('nan')):.6f} ms (bound {bound_ms:.7f} ms, "
        f"{bound_by}; "
        f"{bound_ms / max(entry.get('ms', float('inf')), 1e-9):.2%} of it), "
        f"plain {entry.get('plain_ms', float('nan')):.5f} ms; by launch "
        f"{entry.get('split_ms')}; markers a stream (min, max) "
        f"{entry.get('markers_a_stream')}")
    return entry, counts, iters, launches


def and_popcount_phase(torch, T, idx, device, reps, scale=1.0):
    """The AND-popcount walk at two shapes: the 79 short pairs (the short
    route, one launch) and the SF 1 lineitem cross-tab (the wide route,
    two launches; cut by ``scale`` in a CPU rehearsal), each through
    :func:`and_popcount_shape`."""
    out = {"launches": 0}
    shapes = (("79 pairs", dbgen_pairs(idx)),
              ("SF 1 cross-tab", sf1_pairs(max(64, int(SF1_ROWS * scale)))))
    for key, (label, (pairs, want)) in zip(("dbgen", "sf1"), shapes):
        entry, counts, iters, launches = and_popcount_shape(
            torch, label, pairs, want, device, reps)
        out[key] = {"kernel": entry, "counts": counts.tolist(),
                    "iterations": iters.tolist()}
        out["launches"] += launches
    out["kernel"] = out["sf1"]["kernel"]
    return out


def held(torch, name, kern, plain):
    """Run a kernel and its plain version on the same inputs; fail unless
    they agree bit for bit.  Returns (max_abs_err, mismatches)."""
    got, want = kern(), plain()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    sync(torch, got[0].device.type)
    mism = sum(int((g != w).sum()) for g, w in zip(got, want))
    err = max_err(torch, got, want)
    check(mism == 0 and err == 0,
          f"{name} kernel disagrees with its plain version")
    return err, mism


def timed_entry(torch, name, kern, plain, nbytes, nops, reps, flush,
                library=None, shape=None):
    """Hold ``kern`` against ``plain`` and time both (and ``library``, one
    PyTorch call computing the same function) with CUDA events."""
    err, mism = held(torch, name, kern, plain)
    bound_ms, bound_by = bound(nbytes, nops)
    entry = {"max_abs_err": err, "mismatches": mism,
             "ms": event_ms(torch, kern, reps, flush),
             "plain_ms": event_ms(torch, plain, reps, flush),
             "library_ms": (None if library is None else
                            event_ms(torch, library, reps, flush)),
             "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
             "shape": shape}
    share = bound_ms / max(entry["ms"], 1e-9)
    log(f"[timing] {name} {shape}: mismatches {mism}, max_abs_err {err} "
        f"(tolerance 0: bit identity), {entry['ms']:.5f} ms (bound "
        f"{bound_ms:.5f} ms, {bound_by}; {share:.1%} of it), plain "
        f"{entry['plain_ms']:.5f} ms, library {entry['library_ms']}")
    return entry


def moe_dispatch_phase(torch, device, reps):
    """The MoE dispatch-bitmap path: ``moe_dispatch.run`` at
    bench_moe_dispatch's T for both architectures and the example's
    8192 x 8-of-64, through ``moe_route_bitmap`` on the card; the words
    held against ``ref.moe_route`` and ``routing_bitmap_words``, both
    ``validate`` checks required; then ``moe_route`` timed at a million
    tokens of olmoe's routing."""
    from repro_torch.core import ewah
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe_dispatch as MD
    from repro_torch.models.moe import routing_bitmap_words

    out = {}
    T_ex, E_ex, k_ex = MOE_EXAMPLE
    ex_eids = MD.routed_assignments(T_ex, E_ex, k_ex, skew=1.2)
    ops.reset_launches()
    t0 = time.perf_counter()
    rows = MD.run(T=MOE_TOKENS, device=device)
    example = {o: MD.compressed_dispatch_size(ex_eids, E_ex, order, device)
               for o, order in MD.token_orders(ex_eids, E_ex, device).items()}
    sync(torch, device)
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = launches = ops.LAUNCHES["moe_route"]
    check(device == "cpu" or launches > 0,
          "the MoE dispatch path never launched moe_route")
    checks = MD.validate(rows)
    for r in rows:
        log(f"[moe_dispatch] {r['arch']} T={r['T']} E={r['E']} k={r['k']}: "
            f"compressed words unsorted {r['words_unsorted']}, expert-sorted "
            f"{r['words_expert_sorted']}, gray-frequency "
            f"{r['words_grayfreq']} (uncompressed {r['uncompressed_words']})")
    log(f"[moe_dispatch] example T={T_ex} E={E_ex} k={k_ex}: compressed "
        f"words {example} (uncompressed {(T_ex // 32) * E_ex})")
    for c in checks:
        log(f"[moe_dispatch] {c}")
    check(all(c.endswith("PASS") for c in checks),
          "a bench_moe_dispatch validate check failed")
    out.update(rows=rows, example=example, checks=checks)
    log(f"[moe_dispatch] run in {out['run_s']:.3f} s; moe_route launches "
        f"{launches}")

    # where run()'s time goes, on olmoe's table
    name, E, k = MD.ARCHS[-1]
    t0 = time.perf_counter()
    eids_np = MD.routed_assignments(MOE_TOKENS, E, k)
    t1 = time.perf_counter()
    orders = MD.token_orders(eids_np, E, device)
    t2 = time.perf_counter()
    packed = [MD.dispatch_words(eids_np, E, o, device) for o in orders.values()]
    t3 = time.perf_counter()
    for words in packed:
        for e in range(E):
            ewah.compress(words[:, e])
    t4 = time.perf_counter()
    out["split"] = {"arch": name, "assignments_s": t1 - t0,
                    "token_orders_s": t2 - t1, "pack_and_copy_s": t3 - t2,
                    "host_compress_s": t4 - t3}
    log("[moe_dispatch] split: " + ", ".join(
        f"{k_} {v}" for k_, v in out["split"].items()))

    # the words of each routing table against both plain forms
    for name, E, k in MD.ARCHS:
        eids = torch.from_numpy(MD.routed_assignments(MOE_TOKENS, E, k)).to(
            device)
        words = ops.moe_route_bitmap(eids, E)
        check(torch.equal(words, ref.moe_route(eids, E)),
              f"{name}: moe_route words differ from ref.moe_route")
        check(torch.equal(words, routing_bitmap_words(eids, E).T),
              f"{name}: moe_route words differ from routing_bitmap_words")
    log("[moe_dispatch] words of both architectures identical to "
        "ref.moe_route and routing_bitmap_words(...).T")
    if device == "cpu":
        return out

    per_shape = time_moe_route(torch, device, reps)
    # the kernels line reports olmoe's routing, the first shape
    first = next(iter(per_shape.values()))
    out["kernels"] = {"moe_route": {**first, "per_shape": per_shape}}
    return out


def time_moe_route(torch, device, reps, profiled=True):
    """``moe_route`` held and timed at each of ``MOE_TIMED``'s routings,
    drawn on the card from a seed; ``profiled``: each shape's call also
    profiled as one kernel launch."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    per_shape = {}
    for T_t, E_t, k_t in MOE_TIMED:
        pop = torch.arange(1, E_t + 1, device=device,
                           dtype=torch.float32) ** -1.2
        u = torch.rand(T_t, E_t, generator=gen, device=device).clamp_(1e-12, 1)
        # Gumbel top-k: k distinct experts per token drawn ~ zipf popularity
        eids = (pop.log() - (-u.log()).log()).topk(k_t, dim=1).indices.to(
            torch.int32).contiguous()
        del u
        W = -(-T_t // 32)
        per_shape[f"{T_t}x{k_t}of{E_t}"] = entry = timed_entry(
            torch, "moe_route", lambda: ops.moe_route_bitmap(eids, E_t),
            lambda: ref.moe_route(eids, E_t), T_t * k_t * 4 + W * E_t * 4,
            T_t * k_t + W * E_t, reps, flush, shape=[T_t, k_t, E_t])
        if profiled:
            entry["profile"] = one_kernel_a_call(
                torch, f"moe_route {T_t}x{k_t}of{E_t}",
                lambda: ops.moe_route_bitmap(eids, E_t), "moe_route_kernel")
        del eids
    return per_shape


PROFILER_WARMUP = 256  # device records a window starts with, then ignores


def one_kernel_a_call(torch, what, fn, kernel, calls=4, windows=12):
    """Profile windows of ``calls`` calls of ``fn``.  Fail unless in every
    window the host made exactly one kernel launch a call and no memset or
    copy, and every device record is a kernel whose name contains
    ``kernel``; and unless a window hands over exactly ``calls`` device
    records.  The profiler can lose the first device records of each
    window: none in a fresh process, up to ~40 later in this script (a
    window of 200 small additions handed over 163, then every later
    record), which empties a window of 4 short calls.  So a window first runs ``PROFILER_WARMUP``
    additions to a scratch tensor, synchronises and pauses 50 ms, and then
    marks the calls with ``record_function``; the counts take only the host
    events inside the mark and the device records from 25 ms before it on
    (the additions ended 50 ms before it).  A window with fewer records is
    profiled again, after a pause, up to ``windows`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()  # warm: first calls may allocate (a zeroed output, a scratch)
    scratch = torch.zeros(256, device="cuda")
    torch.cuda.synchronize()
    short = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_WARMUP):
                scratch.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
            with record_function("one_kernel_a_call"):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        mark = next(e.time_range for e in events
                    if e.name == "one_kernel_a_call"
                    and e.device_type == DeviceType.CPU)
        host = [e.name for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith("cuda")
                and any(w in e.name for w in ("Launch", "Memset", "Memcpy"))
                and mark.start <= e.time_range.start <= mark.end]
        # the mark's own device-side annotation is not device activity
        device = [e.name for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.name not in ("Activity Buffer Request",
                                     "one_kernel_a_call")
                  and e.time_range.start >= mark.start - 25_000]
        check(len(host) == calls and all("Launch" in n for n in host),
              f"{what}: one kernel launch a call expected over {calls} "
              f"calls, the host made {host}")
        check(len(device) <= calls and all(kernel in n for n in device),
              f"{what}: device activity other than the kernel: {device}")
        if len(device) == calls:
            break
        short.append(len(device))
        time.sleep(0.2)
    check(len(device) == calls, f"{what}: no window of {windows} handed over "
          f"one device record a call (records a window: {short})")
    log(f"[profile] {what}: one device kernel ({kernel}) a call over {calls} "
        f"calls, no memset or copy (windows with records dropped before: "
        f"{short})")
    return {"host": host, "device": device, "short_windows": short}


def histogram_inputs(torch, cols, census, device):
    """The timed histogram columns as (name, int32 values on the device,
    V): the dbgen-like table's four and census-like's widest."""
    import numpy as np

    named = [(f"dbgen col {c}", col) for c, col in enumerate(cols)]
    wide = max(range(len(census)), key=lambda c: int(census[c].max()))
    named.append((f"census col {wide}", census[wide]))
    return [(name, torch.from_numpy(col.astype(np.int32)).to(device),
             int(col.max()) + 1) for name, col in named]


def time_histograms(torch, hist_in, reps, flush):
    """``histogram`` of each column held and timed beside its plain
    version and ``torch.bincount``."""
    from repro_torch.kernels import ops, ref

    out = {}
    for name, x, V in hist_in:
        out[name] = timed_entry(
            torch, f"histogram {name} V={V}", lambda: ops.histogram(x, V),
            lambda: ref.histogram(x, V), x.numel() * 4 + V * 4, x.numel(),
            reps, flush, library=lambda: torch.bincount(x, minlength=V),
            shape=[x.numel(), V])
    return out


def timings_only(reps=20):
    """``python3 chip_smoke.py --timings``: only ``member``, ``moe_route``,
    ``histogram``, ``ewah_and_popcount`` (79 pairs and the SF 1 cross-tab)
    and ``ewah_decode`` (the largest, median and worst-case batches) at
    their timed shapes,
    through ``ops`` (so that the same script times another checkout's
    kernels, e.g. the parent commit's, on the same card)."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as T
    from repro_torch.core.ewah_stream import pack_pairs
    from repro_torch.data import tables
    from repro_torch.kernels import ops

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    member = {}
    for label, pos, words, touched, oracle in (
            member_small(torch, container_sets()[0], "cuda"),
            member_lineitem(torch, "cuda")):
        oracle(ops.container_gallop(pos, words))
        member[label] = member_timed(torch, label, pos, words, touched,
                                     reps, flush)
    (_, n_db, seed_db), (_, n_ce, seed_ce) = TABLES
    hist_in = histogram_inputs(
        torch, tables.make_dbgen_like(n_db, seed=seed_db),
        tables.make_census_like(n_ce, seed=seed_ce), "cuda")
    _, idx, cards = build_table(T, tables, "dbgen", n_db, seed_db)
    plans = [T.query.compile_plan(idx, p)
             for p in make_predicates(T, cards, seed_db)]
    decode = decode_timings(torch, T, plans, reps, flush)
    and_popcount = {}
    for label, (pairs, want) in (("79 pairs", dbgen_pairs(idx)),
                                 ("SF 1 cross-tab", sf1_pairs())):
        args = pack_pairs(pairs, "cuda")
        counts = ops.ewah_and_popcount(*args)[0].cpu().tolist()
        check([c & 0xFFFFFFFF for c in counts]
              == [w & 0xFFFFFFFF for w in want],
              f"ewah_and_popcount {label}: counts differ from the "
              "decompressed AND")
        and_popcount[label] = event_ms(
            torch, lambda: ops.ewah_and_popcount(*args), reps, flush)
        log(f"[timing] ewah_and_popcount {label}: "
            f"{and_popcount[label]:.6f} ms")
    return {"member": member,
            "moe_route": time_moe_route(torch, "cuda", reps, profiled=False),
            "histogram": time_histograms(torch, hist_in, reps, flush),
            "ewah_and_popcount": and_popcount,
            "ewah_decode": decode}


def decode_timings(torch, T, plans, reps, flush):
    """``ewah_decode`` at the three shapes ``[kernels]`` times: the dbgen
    mix's largest and median batches and the worst-case batch, each held
    bit for bit against its plain version; ms by shape."""
    from repro_torch.core import ewah
    from repro_torch.kernels import ops, ref

    be = T.TorchBackend(device="cuda")
    groups = sorted(be._group(plans).items(), key=padded_words)
    out = {}
    for label, ((_, share, cap, n_rows), idxs) in (
            ("largest", groups[-1]), ("median", groups[len(groups) // 2])):
        batch, lengths = be._to_device(*be._pad_group(plans, idxs, cap,
                                                      share))
        W = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
        kern = lambda: ops.ewah_decode(batch, lengths, W)  # noqa: E731
        held(torch, f"ewah_decode ({label} batch)", kern,
             lambda: ref.ewah_decode(batch, lengths, W))
        out[label] = event_ms(torch, kern, reps, flush)
        log(f"[timing] ewah_decode {label} batch: {out[label]:.6f} ms")
    out["worst"] = worst_case_decode(torch, "cuda", reps)["ms"]
    return out


def build_primitives_phase(torch, data, device, reps):
    """The paper's build primitives on the card over the dbgen-like index:
    ``bitpack`` of the two small columns' one-hot in row order against the
    index's own equality bitmaps, ``histogram`` of every column (and
    census-like's largest) against ``column_histogram``, ``gray`` forward
    and back against ``to_gray`` / ``from_gray``; then each timed."""
    import numpy as np

    from repro_torch.core import ewah
    from repro_torch.core.encoding import from_gray, to_gray
    from repro_torch.core.histogram import column_histogram
    from repro_torch.kernels import ops, ref

    cols, idx = data["dbgen"][0], data["dbgen"][1]
    census = data["census"][0]
    n = idx.n_rows
    W = (n + ewah.WORD_BITS - 1) // ewah.WORD_BITS
    eq = [i for i, e in enumerate(idx.encodings()) if e == "equality"]
    check(len(eq) == 2, f"two equality columns expected, got {eq}")
    on_card = {}
    for i in eq:
        enc = idx.columns[i].encoding
        check(enc.k == 1 and enc.n_streams == enc.card,
              "one bitmap per value on the small columns")
        col = cols[idx.col_perm[i]][idx.row_perm]
        value_of = np.empty(enc.card, dtype=np.int64)
        value_of[enc.codes[:, 0]] = np.arange(enc.card)   # bitmap -> value
        on_card[i] = (torch.from_numpy(col).to(device),
                      torch.from_numpy(value_of).to(device))
    hist_in = histogram_inputs(torch, cols, census, device)
    big = max(range(len(cols)), key=lambda c: int(cols[c].max()))
    gray_in = torch.from_numpy(cols[big].astype(np.int32)).to(device)

    # the path: every call a user of the index would make, counted
    ops.reset_launches()
    t0 = time.perf_counter()
    packed = {i: ops.bitpack(c[:, None] == v[None, :])
              for i, (c, v) in on_card.items()}
    hists = [ops.histogram(x, V) for _, x, V in hist_in]
    g = ops.gray(gray_in)
    back = ops.gray(g, inverse=True)
    sync(torch, device)
    out = {"path_s": time.perf_counter() - t0}
    out["launches"] = launches = {k: ops.LAUNCHES[k]
                                  for k in ("bitpack", "histogram", "gray")}
    for k, v in launches.items():
        check(device == "cpu" or v > 0, f"the build primitives never "
              f"launched {k}")

    for i, words in packed.items():
        enc = idx.columns[i].encoding
        got = words.cpu().numpy().view(np.uint32)
        check(got.shape == (W, enc.card), f"bitpack shape {got.shape}")
        for b, stream in enumerate(enc.streams):
            check(np.array_equal(got[:, b], ewah.decompress(stream, W)),
                  f"bitpack column {i} bitmap {b} differs from the index's "
                  f"equality stream")
    n_maps = sum(w.shape[1] for w in packed.values())
    log(f"[build_primitives] bitpack: {n_maps} bitmaps of {n} rows identical "
        f"to the index's decompressed equality streams")
    for (name, x, V), h in zip(hist_in, hists):
        want = column_histogram(x.cpu().numpy(), V)
        check(np.array_equal(h.cpu().numpy().astype(np.int64), want),
              f"histogram of {name} (V={V}) differs from column_histogram")
    log(f"[build_primitives] histogram: {len(hists)} columns (V = "
        f"{[V for _, _, V in hist_in]}) identical to column_histogram")
    host = cols[big].astype(np.uint32)
    check(np.array_equal(g.cpu().numpy().view(np.uint32),
                         to_gray(host).astype(np.uint32)),
          "gray differs from to_gray")
    check(np.array_equal(back.cpu().numpy().view(np.uint32),
                         from_gray(to_gray(host)).astype(np.uint32))
          and torch.equal(back, gray_in), "inverse gray is not the identity")
    log(f"[build_primitives] gray: {len(host)} ids of the "
        f"{int(cols[big].max()) + 1}-value column identical to to_gray / "
        f"from_gray, round trip the identity")
    log(f"[build_primitives] path {out['path_s']:.4f} s; launches {launches}")

    # every kernel bit for bit against its plain version on the path's inputs
    out["held"] = {}
    for i, (c, v) in on_card.items():
        bits = c[:, None] == v[None, :]
        out["held"][f"bitpack col {i}"] = held(
            torch, "bitpack", lambda: ops.bitpack(bits),
            lambda: ref.bitpack(bits))[0]
    for name, x, V in hist_in:
        out["held"][f"histogram {name}"] = held(
            torch, "histogram", lambda: ops.histogram(x, V),
            lambda: ref.histogram(x, V))[0]
    for inverse in (False, True):
        out["held"][f"gray inverse={inverse}"] = held(
            torch, "gray", lambda: ops.gray(gray_in, inverse),
            lambda: ref.gray(gray_in, inverse))[0]
    if device == "cpu":
        return out

    # one histogram call is one device kernel: no memset, no conversion
    out["histogram_profile"] = {
        name: one_kernel_a_call(torch, f"histogram {name} (V={V})",
                                lambda: ops.histogram(x, V), "hist_")
        for name, x, V in hist_in}

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    # the first values of the second-widest column (2526 values)
    mid = sorted(range(len(cols)), key=lambda c: int(cols[c].max()))[-2]
    x_mid = torch.from_numpy(cols[mid].astype(np.int32)).to(device)
    bits = x_mid[:, None] == torch.arange(BITPACK_TIMED_VALUES,
                                          device=device, dtype=torch.int32)
    R, C = bits.shape
    kernels = {"bitpack": timed_entry(
        torch, "bitpack", lambda: ops.bitpack(bits),
        lambda: ref.bitpack(bits), R * C + (-(-R // 32)) * C * 4,
        R * C, reps, flush, shape=[R, C])}
    del bits
    per_column = time_histograms(torch, hist_in, reps, flush)
    # the kernels line reports the dbgen-like table's largest column
    kernels["histogram"] = {**per_column[f"dbgen col {big}"],
                            "per_column": per_column}
    gen = torch.Generator(device=device).manual_seed(0)
    words = torch.randint(-2**31, 2**31, (GRAY_TIMED_WORDS,), generator=gen,
                          device=device, dtype=torch.int32)
    kernels["gray"] = timed_entry(
        torch, "gray", lambda: ops.gray(words), lambda: ref.gray(words),
        words.numel() * 8, words.numel() * 2, reps, flush,
        shape=[words.numel()])
    kernels["gray"]["inverse"] = timed_entry(
        torch, "gray inverse", lambda: ops.gray(words, inverse=True),
        lambda: ref.gray(words, inverse=True), words.numel() * 8,
        words.numel() * 10, reps, flush, shape=[words.numel()])
    out["kernels"] = kernels
    return out


def device_profile(torch, fn):
    """Device activity of one ``fn()`` call from torch.profiler: time by
    kernel or copy, by category (the port's kernels, copies, PyTorch's own
    kernels), and the device's idle share of the wall time (1 - union of
    activity intervals / wall).  None where the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            # CUPTI's own buffer bookkeeping, not device work
            and e.name != "Activity Buffer Request"]
    if not acts:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in acts)
    busy_us, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name, by_cat = {}, {"port_kernels": 0.0, "copies": 0.0, "torch": 0.0}
    for e in acts:
        ms = e.time_range.elapsed_us() / 1e3
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
        cat = ("port_kernels" if any(f"{k}_kernel" in e.name
                                     for k in (*KERNELS, "hist_shared",
                                               "hist_global"))
               else "copies" if "Memcpy" in e.name or "Memset" in e.name
               else "torch")
        by_cat[cat] += ms
    rows = sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                  key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "by_category_ms": by_cat, "by_kernel": rows}


def profile_kernels(torch, T, plans, device):
    """Device activity of one fused compressed batch of the mix (see
    :func:`device_profile`)."""
    be = T.TorchBackend(device=device)
    be.execute_compressed_many(plans)
    be.result_cache.clear()
    return device_profile(torch, lambda: be.execute_compressed_many(plans))


def decode_split(torch, batch, lengths, W, reps, flush):
    """CUDA-event time of each phase of the decode alone: the markers
    kernel, and the expansion kernel from the table it wrote."""
    from repro_torch.kernels import ops

    table = ops.ewah_markers(batch, lengths, W)
    return {"markers_ms": event_ms(
                torch, lambda: ops.ewah_markers(batch, lengths, W), reps,
                flush),
            "expand_ms": event_ms(
                torch, lambda: ops.ewah_expand(batch, lengths, W, *table),
                reps, flush)}


def decode_bound(lengths_np, m, B, W):
    """Bound of one decode call: the streams' words and lengths read once,
    m * B * W words written once; one operation an output word."""
    return bound(int(lengths_np.sum()) * 4 + lengths_np.nbytes + m * B * W * 4,
                 m * B * W)


def decode_phases_held(torch, batch, lengths, W):
    """Hold each phase of the decode against its plain version: the marker
    table (up to each row's count), then the expansion of the plain table.
    Returns the markers a stream (the table's counts)."""
    from repro_torch.kernels import ewah_decode as launcher
    from repro_torch.kernels import ops, ref

    tab, tab_n, first = ops.ewah_markers(batch, lengths, W)
    p_tab, p_n, p_first = ref.ewah_markers(batch, lengths, W, launcher.TILE)
    sync(torch, batch.device.type)
    bad = int((tab_n != p_n).sum()) + int((first != p_first).sum())
    for r, k in enumerate(p_n.tolist()):
        bad += int((tab[r, :k] != p_tab[r, :k]).sum())
    check(bad == 0, "the ewah_decode markers kernel disagrees with "
                    "ref.ewah_markers")
    held(torch, "ewah_decode (expansion)",
         lambda: ops.ewah_expand(batch, lengths, W, p_tab, p_n, p_first),
         lambda: ref.ewah_expand(batch, lengths, W, p_tab, p_n, p_first))
    return p_n


def median_batch_decode(torch, T, plans, device, reps):
    """``ewah_decode`` on the dbgen mix's median batch (batches ranked by
    their padded stream words; a one-query batch): held against its plain
    version, phase by phase too, timed beside its bound, and its share of
    that batch's profiled device program (decode, evaluate, re-encode)."""
    from repro_torch.core import ewah
    from repro_torch.kernels import ops, ref

    be = T.TorchBackend(device=device)
    groups = sorted(be._group(plans).items(), key=padded_words)
    (root, share, cap, n_rows), idxs = groups[len(groups) // 2]
    batch_np, lengths_np = be._pad_group(plans, idxs, cap, share)
    batch, lengths = be._to_device(batch_np, lengths_np)
    B, m, C = batch.shape
    W = (n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    kern = lambda: ops.ewah_decode(batch, lengths, W)  # noqa: E731
    err, mism = held(torch, "ewah_decode", kern,
                     lambda: ref.ewah_decode(batch, lengths, W))
    markers = decode_phases_held(torch, batch, lengths, W).double()
    bound_ms, bound_by = decode_bound(lengths_np, m, B, W)
    entry = {"max_abs_err": err, "mismatches": mism,
             "ms": event_ms(torch, kern, reps, flush), "bound_ms": bound_ms,
             "bound_by": bound_by, "shape": [B, m, C],
             "markers_max": int(markers.max()),
             "markers_mean": float(markers.mean())}
    args = (be._fused_program(root, share), root, share, batch, lengths, W,
            True)
    be._run(*args)
    prof = device_profile(torch, lambda: be._run(*args))
    check(prof is not None, "torch.profiler recorded no device time")
    decode = [(ms, n) for name, ms, n in prof["by_kernel"]
              if "ewah_decode_kernel" in name]
    entry.update(profile=prof, decode_profiled_ms=sum(d[0] for d in decode),
                 decode_launches_per_call=sum(d[1] for d in decode),
                 split_ms=decode_split(torch, batch, lengths, W, reps, flush))
    entry["decode_share"] = (entry["decode_profiled_ms"]
                             / max(prof["device_busy_ms"], 1e-9))
    check(entry["decode_launches_per_call"] == 2,
          f"the profile shows {entry['decode_launches_per_call']} ewah_decode "
          f"launches for one decode call, not 2")
    log(f"[kernels] ewah_decode on the median batch (B={B}, m={m}, C={C}, "
        f"W={W}; markers a stream max {entry['markers_max']}, mean "
        f"{entry['markers_mean']:.1f}): {entry['ms']:.5f} ms, "
        f"{entry['bound_ms'] / max(entry['ms'], 1e-9):.1%} of bound; profiled "
        f"{entry['decode_profiled_ms']:.5f} ms in "
        f"{entry['decode_launches_per_call']} device launches a decode call, "
        f"of {prof['device_busy_ms']:.5f} ms device busy "
        f"({entry['decode_share']:.1%}) in that batch's device program; by "
        f"kernel {entry['split_ms']}")
    return entry


def worst_case_decode(torch, device, reps, m=55, n=31_250, C=32_768):
    """``ewah_decode`` on a synthetic worst-case one-query batch: m streams
    of n one-word clean runs of alternating fill, so every word is a marker
    (n markers a stream, the most n words can hold), at the median batch's
    capacity; held against its plain version and timed beside the same
    bound as the median batch."""
    import numpy as np

    from repro_torch.kernels import ops, ref

    t = (np.arange(n)[None, :] + np.arange(m)[:, None]) % 2
    streams = ((t.astype(np.uint32) << 31) | np.uint32(1 << 15))
    batch_np = np.zeros((1, m, C), dtype=np.uint32)
    batch_np[0, :, :n] = streams
    lengths_np = np.full((1, m), n, dtype=np.int32)
    batch = torch.from_numpy(batch_np.view(np.int32)).to(device)
    lengths = torch.from_numpy(lengths_np).to(device)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    kern = lambda: ops.ewah_decode(batch, lengths, n)  # noqa: E731
    err, mism = held(torch, "ewah_decode", kern,
                     lambda: ref.ewah_decode(batch, lengths, n))
    words = kern()[:, 0].cpu().numpy().view(np.uint32)
    check(np.array_equal(words, np.where(t == 1, np.uint32(0xFFFFFFFF),
                                         np.uint32(0))),
          "ewah_decode of the worst-case batch is not its words")
    markers = decode_phases_held(torch, batch, lengths, n)
    check(int(markers.min()) == n, "the worst-case streams lost markers")
    bound_ms, bound_by = decode_bound(lengths_np, m, 1, n)
    entry = {"max_abs_err": err, "mismatches": mism,
             "ms": event_ms(torch, kern, reps, flush), "bound_ms": bound_ms,
             "bound_by": bound_by, "shape": [1, m, C], "markers_max": n,
             "markers_mean": float(n),
             "split_ms": decode_split(torch, batch, lengths, n, reps, flush)}
    log(f"[kernels] ewah_decode on the worst-case batch (B=1, m={m}, C={C}, "
        f"W={n}; {n} markers a stream): mismatches {mism}, max_abs_err "
        f"{err} (tolerance 0: bit identity), {entry['ms']:.5f} ms (bound "
        f"{bound_ms:.5f} ms, {bound_by}; "
        f"{bound_ms / max(entry['ms'], 1e-9):.1%} of it); by kernel "
        f"{entry['split_ms']}")
    return entry


# ---------------------------------------------------------------------------
# model serving
# ---------------------------------------------------------------------------


def step_ms(torch, fn, reps):
    """CUDA-event time of each of ``reps`` calls of ``fn`` after a
    warm-up, each call's events around it alone: (median, min, max).
    Eager PyTorch launches many small kernels, so a call's time includes
    the gaps in which the card waits for the host."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in pairs]
    return statistics.median(times), min(times), max(times)


def lm_main(serve, argv, tag="[lm_serve]"):
    """``serve.main(argv)`` with its printed lines logged under ``tag``
    (the lines land in the result's ``"lines"``)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = serve.main(argv)
    result["lines"] = buf.getvalue().splitlines()
    for line in result["lines"]:
        log(f"{tag} main: {line}")
    return result


def lm_correctness(torch, cfg, device):
    """float32 at full width, TF32 off: (a) the fused prefill against a
    token-by-token decode of the same 16-token prompt, batch 2 (the audio
    family's decode loop is fed the embeddings with their sinusoidal
    positions, which its ``decode_step``, like the reference's, does not
    add); (b) the card's prefill logits and 4 greedy tokens against the
    same port on the CPU with the same weights, with 8 frontend
    embeddings for vlm and audio and M-RoPE positions for vlm."""
    import numpy as np

    from repro_torch.models import transformer
    from repro_torch.serve.prefill import prefill_with_cache
    from repro_torch.train import serve_step

    tag = f"[lm_serve] {cfg.name} ({cfg.n_layers} layers)"
    model = transformer.init_params(cfg, device=device)
    rng = np.random.default_rng(LM_SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    front = {}
    if cfg.frontend != "none":
        front["patches"] = torch.from_numpy(
            rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
        front["mrope_positions"] = torch.stack([pos, pos // 2, pos % 5])
    max_len = 32

    def err(a, b):
        return float((a.float().cpu() - b.float().cpu()).abs().max())

    def prompt_part(cache, k):
        """The prompt's part of a cache entry: K/V up to 16 tokens; the
        recurrent conv tail and state whole."""
        return cache[k][:, :, :16] if k in ("k", "v") else cache[k]

    def generate(m, dev):
        logits, cache = prefill_with_cache(
            m, cfg, prompt.to(dev), max_len,
            **{k: v.to(dev) for k, v in front.items()})
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        toks = [tok]
        for t in range(16, 19):
            tok, cache = serve_step(m, tok, cache, t, cfg=cfg)
            toks.append(tok)
        return logits, torch.cat(toks, 1).cpu()

    with torch.no_grad():
        logits_p, cache_p = prefill_with_cache(model, cfg, prompt.to(device),
                                               max_len)
        inputs = prompt.to(device)
        if cfg.family == "audio":
            pos = torch.arange(16, dtype=torch.int32, device=device).expand(
                2, 16)
            inputs = (model.embed[inputs.long()]
                      + transformer._sinusoid(pos, cfg.d_model))
        cache = transformer.init_decode_cache(cfg, 2, max_len, device=device)
        for t in range(16):
            logits_d, cache = transformer.decode_step(
                model, cfg, inputs[:, t:t + 1], cache, t)
    out = {"layers": cfg.n_layers,
           "prefill_vs_decode_logits_err": err(logits_p, logits_d),
           "prefill_vs_decode_cache_err": max(
               err(prompt_part(cache_p, k), prompt_part(cache, k))
               for k in cache)}
    check(torch.allclose(logits_p, logits_d, rtol=LM_TOL, atol=LM_TOL)
          and all(torch.allclose(prompt_part(cache_p, k),
                                 prompt_part(cache, k),
                                 rtol=LM_TOL, atol=LM_TOL) for k in cache),
          f"{tag} full-width prefill and decode loop disagree: {out}")
    del cache, cache_p
    logits_c, toks_c = generate(model, device)
    cpu = transformer.Transformer(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        assign=True)
    del model
    logits_h, toks_h = generate(cpu, torch.device("cpu"))
    out["card_vs_cpu_logits_err"] = err(logits_c, logits_h)
    out["tokens_card"] = toks_c.tolist()
    out["tokens_cpu"] = toks_h.tolist()
    check(torch.equal(toks_c, toks_h),
          f"{tag} greedy tokens on the card {toks_c.tolist()} != CPU "
          f"{toks_h.tolist()}")
    check(torch.allclose(logits_c.cpu(), logits_h, rtol=LM_TOL, atol=LM_TOL),
          f"{tag} card and CPU logits disagree: "
          f"{out['card_vs_cpu_logits_err']}")
    log(f"{tag} float32 full width, TF32 off (tolerance rtol = atol = "
        f"{LM_TOL}): prefill vs decode loop max abs err logits "
        f"{out['prefill_vs_decode_logits_err']:.3g}, cache "
        f"{out['prefill_vs_decode_cache_err']:.3g}; card vs CPU logits "
        f"{out['card_vs_cpu_logits_err']:.3g}, greedy tokens identical "
        f"{out['tokens_card']}")
    return out


def lm_work(model, cfg, b, s, cached=0):
    """(bytes, operations, routed-only (bytes, operations)) of a prefill
    of (b, s), or with ``cached`` slots a decode step (s = 1): every
    weight but the embedding read once, the activations in and, for a
    decode step, the K/V cache read; two operations a weight a token.  An
    MoE layer reads and computes every expert's weights over its (E_pad,
    cap) slot buffer, as the reference's design does; the routed-only
    figures count k / E_pad of the expert weights, each token through its
    k experts, instead (None for the other families)."""
    from repro_torch.models import transformer

    nonembed = transformer.n_params(model) - model.embed.numel()
    item = model.embed.element_size()
    kv_bytes = (2 * cfg.n_layers * b * cached * cfg.n_kv_heads
                * cfg.head_dim * item)
    act = b * s * cfg.d_model
    if cfg.family != "moe":
        return ((nonembed + act) * item + kv_bytes, 2 * nonembed * b * s,
                None)
    e = model.layers[0].ffn.w_gate.shape[0]
    expert = cfg.n_layers * 3 * e * cfg.d_model * cfg.moe_d_ff
    k = cfg.top_k
    cap = max(8, min(int(cfg.moe_capacity_factor * s * k / cfg.n_experts
                         + 0.5), s))
    ops = (2 * (nonembed - expert) * b * s
           + 2 * expert // e * b * e * cap)
    routed = ((nonembed - expert + expert * k // e + act) * item + kv_bytes,
              2 * (nonembed - expert + expert * k // e) * b * s)
    return (nonembed + act) * item + kv_bytes, ops, routed


def lm_timing(torch, model, cfg, device, reps, tag="[lm_serve]"):
    """Prefill and one decode step of the bf16 model beside their bounds
    (for MoE the routed-only bound beside it), and a profiler window over
    one packed batch."""
    from repro_torch.models import transformer
    from repro_torch.serve.prefill import prefill_with_cache
    from repro_torch.train import serve_step

    gen = torch.Generator(device).manual_seed(LM_SEED)
    out = {}

    def timed(name, fn, work):
        nbytes, nops, routed = work
        med, lo, hi = step_ms(torch, fn, reps)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = nops / BF16_OPS_PER_S * 1e3
        bound_ms, by = ((byte_ms, "bytes") if byte_ms >= op_ms
                        else (op_ms, "operations"))
        out[name] = {"ms": med, "min_ms": lo, "max_ms": hi, "reps": reps,
                     "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
                     "ops": nops}
        line = (f"{tag} {name}: median {med:.4f} ms (min {lo:.4f}, max "
                f"{hi:.4f}, {reps} calls); bound {bound_ms:.4f} ms ({by}: "
                f"{nbytes} B, {nops:.4g} ops), {bound_ms / med:.1%} of it")
        if routed is not None:
            routed_ms = max(routed[0] / HBM_BYTES_PER_S,
                            routed[1] / BF16_OPS_PER_S) * 1e3
            out[name].update(routed_bytes=routed[0], routed_ops=routed[1],
                             routed_bound_ms=routed_ms)
            line += (f"; routed-only bound {routed_ms:.4f} ms ({routed[0]} "
                     f"B, {routed[1]:.4g} ops: k/E_pad of the experts), "
                     f"{routed_ms / med:.1%}")
        log(line)

    for b, s in LM_PREFILLS:
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=device, dtype=torch.int32)
        timed(f"prefill {b}x{s}",
              lambda: prefill_with_cache(model, cfg, toks, LM_DECODE[1]),
              lm_work(model, cfg, b, s))
    b, slots = LM_DECODE
    toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                         device=device, dtype=torch.int32)
    cache = transformer.init_decode_cache(cfg, b, slots, device=device)
    timed(f"decode step {b}x{slots}",
          lambda: serve_step(model, toks, cache, slots - 1, cfg=cfg),
          lm_work(model, cfg, b, 1, slots))
    del cache
    out["profile_one_batch"] = lm_profile(torch, model, cfg, device, tag)
    return out


def lm_profile(torch, model, cfg, device, tag="[lm_serve]"):
    """A profiler window over one packed batch: prefill (8, 32), then 15
    decode steps."""
    from repro_torch.serve.prefill import prefill_with_cache
    from repro_torch.train import serve_step

    gen = torch.Generator(device).manual_seed(LM_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen,
                           device=device, dtype=torch.int32)

    def one_batch():
        logits, cache = prefill_with_cache(model, cfg, prompt, 128)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for t in range(32, 47):
            tok, cache = serve_step(model, tok, cache, t, cfg=cfg)

    one_batch()
    prof = device_profile(torch, one_batch)
    check(prof is not None, f"{tag} torch.profiler recorded no device "
          "time for one packed batch")
    launches = sum(c for _, _, c in prof["by_kernel"])
    log(f"{tag} profile, one packed batch (prefill 8x32 + 15 decode "
        f"steps): wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_busy_ms']:.3f} ms, idle share "
        f"{prof['idle_share']:.1%}, {launches} device records "
        f"({launches / 16:.1f} a step)")
    for key, ms, count in prof["by_kernel"][:10]:
        log(f"{tag} {ms:10.4f} ms  x{count:<5d} {key[:100]}")
    return prof


def lm_admission(torch, serve, ops, device):
    """Admission batches on the torch backend identical to numpy in the
    same topology, for the server's 64 requests and for 1,500 (seed 5),
    whose waves seal five segments of 256 so that the segmented
    topologies answer on the card too; each call starts from a cold
    result cache, and on the card the 1,500 queue must launch
    ``ewah_decode`` and ``planfuse`` in every topology (behind the plane,
    in its workers)."""
    import numpy as np

    from repro_torch.core.query import get_backend

    modes = {"rebuild": {}, "query_fanout=2": {"query_fanout": 2},
             "segmented": {"admission": "segmented"},
             "segmented+compactor": {"admission": "segmented",
                                     "compactor": True},
             "segmented hosts=2": {"admission": "segmented", "hosts": 2}}
    queues = {"64 requests": serve.make_requests(64, np.random.default_rng(0)),
              "1500 requests": serve.make_requests(
                  1500, np.random.default_rng(5))}
    out = {}
    for qname, lengths in queues.items():
        for name, kw in modes.items():
            get_backend("torch", device=str(device)).result_cache.clear()
            ops.reset_launches()
            if "hosts" in kw:
                # the plane's workers count their launches: pack through
                # SegmentedAdmission as pack_batches does, and read them
                q = serve.SegmentedAdmission(hosts=2, device=str(device),
                                             plane_opts=PLANE_TIMEOUTS)
                try:
                    for chunk in np.array_split(
                            lengths, max(1, min(4, len(lengths) // 8))):
                        q.admit(chunk)
                    got = q.pack(8)
                    workers = q._plane.stats()["worker_launches"]
                finally:
                    q.close()
            else:
                got = serve.pack_batches(lengths, 8, backend="torch",
                                         device=str(device), **kw)
                workers = None
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            want = serve.pack_batches(lengths, 8, backend="numpy", **kw)
            same = (len(got) == len(want) and
                    all(np.array_equal(g, w) for g, w in zip(got, want)))
            check(same, f"[lm_serve] admission {name}, {qname}: torch "
                  "batches differ from numpy")
            seen = workers if workers is not None else launches
            if device != "cpu" and qname == "1500 requests":
                check(seen.get("ewah_decode", 0) > 0
                      and seen.get("planfuse", 0) > 0,
                      f"[lm_serve] admission {name}, {qname}: launches "
                      f"{seen}, want ewah_decode and planfuse")
            out[f"{name}, {qname}"] = {"identical": same,
                                       "launches": launches,
                                       "worker_launches": workers}
            log(f"[lm_serve] admission {name}, {qname}: {len(got)} batches "
                f"identical to numpy; launches {launches}"
                + ("" if workers is None else f", in the workers {workers}"))
    return out


def lm_serve_phase(torch, device, reps):
    """The model-serving launcher: tinyllama-1.1b at full width on the card
    (the smoke config in a CPU rehearsal) behind histogram-aware admission
    (see the module docstring, phase 12)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    card = device != "cpu"
    # float32 products stay full float32 on the card (PyTorch's default,
    # set here because (a) and (b) below compare float32 at 2e-3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH) if card else get_config(LM_ARCH).smoke()
    argv = (LM_SERVE_ARGV if card else
            [a for a in LM_SERVE_ARGV if a != "--no-smoke"])
    argv = [*argv, "--device", str(device)]
    out = {"arch": cfg.name, "argv": argv}

    model = transformer.init_params(cfg, device=device)
    out["params"] = transformer.n_params(model)
    out["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    log(f"[lm_serve] {cfg.name} {'full width' if card else 'smoke'}: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} KV heads, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{out['params']} parameters, {out['weight_bytes']} B")
    if card:
        check(out["params"] == LM_PARAMS and
              out["weight_bytes"] == LM_WEIGHT_BYTES,
              f"[lm_serve] {out['params']} parameters / "
              f"{out['weight_bytes']} B, want {LM_PARAMS} / "
              f"{LM_WEIGHT_BYTES}")
        del model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the main path: the server's own entry point, counts read around it
    ops.reset_launches()
    res = lm_main(serve, argv)
    out["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    tok_s = res["tokens"] / res["seconds"]
    out.update(waste={str(k): v for k, v in res["waste"].items()},
               requests=res["requests"], tokens=res["tokens"],
               seconds=res["seconds"], tok_per_s=tok_s,
               phases_unsynced_s=res["phases"])
    check(res["requests"] == 64 and res["tokens"] == 64 * 16,
          f"[lm_serve] served {res['requests']} requests, {res['tokens']} "
          "tokens; want 64 and 1024")
    check(res["waste"][True] < res["waste"][False],
          "[lm_serve] histogram-aware packing wastes no less padding")
    if card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        check(out["launches"].get("ewah_decode", 0) > 0
              and out["launches"].get("planfuse", 0) > 0,
              f"[lm_serve] packing launched {out['launches']}: want "
              "ewah_decode and planfuse")
    log(f"[lm_serve] padding waste {res['waste'][False]:.4f} arrival order, "
        f"{res['waste'][True]:.4f} histogram-aware; {res['requests']} "
        f"requests, {res['tokens']} tokens in {res['seconds']:.3f} s "
        f"(host clock after a synchronise): {tok_s:.1f} tok/s; peak memory "
        f"{out.get('peak_memory_bytes', 'not measured')} (B); packing "
        f"launches {out['launches']}")

    # the same run with --profile: spans synchronise, so the split is the
    # device's; its trace stays in build/ (tens of MB)
    trace_dir = ROOT / "build" / "lm_serve_trace"
    res = lm_main(serve, [*argv, "--profile", str(trace_dir)])
    out["phases_s"] = res["phases"]
    out["profiled_tok_per_s"] = res["tokens"] / res["seconds"]

    out["admission"] = lm_admission(torch, serve, ops, device)
    if card:
        out["float32"] = lm_correctness(
            torch, replace(cfg, dtype="float32"), device)
        torch.cuda.empty_cache()
        model = transformer.init_params(cfg, device=device)
        out["timing"] = lm_timing(torch, model, cfg, device, reps)
        del model
        torch.cuda.empty_cache()
    out["families"] = fams = {}
    for arch in LM_FAMILIES:
        fams[arch] = lm_family(torch, serve, ops, arch, device, reps)
        for k, v in fams[arch]["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    return out


def lm_family(torch, serve, ops, arch, device, reps):
    """One more config at its published widths (the smoke config in a CPU
    rehearsal) through the server's entry point: olmoe-1b-7b with the
    reference server's defaults, then with ``--profile`` for the split,
    timed beside its bounds; every other config one packed batch of 8.
    Parameters and weight bytes from the ``meta`` device, checked against
    ``LM_FAMILIES``; on the card the packing must launch ``ewah_decode``
    and ``planfuse``, and the float32 gate (``lm_correctness``) runs at
    ``LM_F32_DEPTH``."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    card = device != "cpu"
    cfg = get_config(arch) if card else get_config(arch).smoke()
    tag = f"[lm_serve] {arch}"
    served = LM_SERVE_ARGV if arch == LM_MOE_ARCH else LM_ONE_BATCH_ARGV
    argv = [a for a in served if card or a != "--no-smoke"]
    argv = [*argv, "--arch", arch, "--device", str(device)]
    shapes = transformer.Transformer(cfg, device="meta")
    out = {"arch": arch, "argv": argv,
           "params": transformer.n_params(shapes),
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in shapes.parameters())}
    del shapes
    log(f"{tag} {'full width' if card else 'smoke'}: {cfg.family}, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}: "
        f"{out['params']} parameters, {out['weight_bytes']} B")
    if card:
        check((out["params"], out["weight_bytes"]) == LM_FAMILIES[arch],
              f"{tag} {out['params']} parameters / {out['weight_bytes']} B, "
              f"want {LM_FAMILIES[arch]}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the main path: the server's own entry point, counts read around it
    ops.reset_launches()
    t0 = time.perf_counter()
    res = lm_main(serve, argv)
    out["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    n = int(argv[argv.index("--requests") + 1])
    gen = int(argv[argv.index("--gen-tokens") + 1])
    out.update(requests=res["requests"], tokens=res["tokens"],
               seconds=res["seconds"], main_s=time.perf_counter() - t0,
               tok_per_s=res["tokens"] / res["seconds"],
               waste={str(k): v for k, v in res["waste"].items()},
               phases_unsynced_s=res["phases"])
    check(res["requests"] == n and res["tokens"] == n * gen,
          f"{tag} served {res['requests']} requests, {res['tokens']} "
          f"tokens; want {n} and {n * gen}")
    if card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        check(out["launches"].get("ewah_decode", 0) > 0
              and out["launches"].get("planfuse", 0) > 0,
              f"{tag} packing launched {out['launches']}: want ewah_decode "
              "and planfuse")
    log(f"{tag} {res['requests']} requests, {res['tokens']} tokens in "
        f"{res['seconds']:.3f} s (host clock after a synchronise): "
        f"{out['tok_per_s']:.1f} tok/s; main {out['main_s']:.3f} s; peak "
        f"memory {out.get('peak_memory_bytes', 'not measured')} (B); "
        f"packing launches {out['launches']}")
    steps = out["step_s"] = {"main": out["main_s"]}
    t0 = time.perf_counter()
    if arch == LM_MOE_ARCH:
        res = lm_main(serve, [*argv, "--profile",
                              str(ROOT / "build" / "lm_serve_trace")])
        steps["profiled main"] = time.perf_counter() - t0
        out["phases_s"] = res["phases"]
        out["profiled_tok_per_s"] = res["tokens"] / res["seconds"]
        log(f"{tag} synchronised split (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in res["phases"].items()))
    if not card:
        return out
    if arch == LM_MOE_ARCH or arch in LM_PROFILED:
        t0 = time.perf_counter()
        model = transformer.init_params(cfg, device=device)
        if arch == LM_MOE_ARCH:
            out["timing"] = lm_timing(torch, model, cfg, device, reps, tag)
        else:
            out["profile_one_batch"] = lm_profile(torch, model, cfg, device,
                                                  tag)
        del model
        torch.cuda.empty_cache()
        steps["timing and profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # every expert's capacity the whole prompt (E / k), so that the
    # prefill drops no MoE token: olmoe's 8, as tests/test_prefill.py
    # sets; qwen2-moe's 15
    f32 = replace(cfg, dtype="float32", n_layers=LM_F32_DEPTH[arch])
    if cfg.family == "moe":
        f32 = replace(f32, moe_capacity_factor=cfg.n_experts / cfg.top_k)
    out["float32"] = lm_correctness(torch, f32, device)
    torch.cuda.empty_cache()
    steps["float32 gate"] = time.perf_counter() - t0
    log(f"{tag} wall clock of its steps (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in steps.items()))
    return out


def train_main(train, argv, tag="[lm_train]"):
    """``train.main(argv)`` with its printed lines logged under ``tag``:
    (metrics, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        metrics = train.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"{tag} main: {line}")
    return metrics, lines


def printed(lines, prefix):
    """The numbers in the first printed line that starts with ``prefix``."""
    import re

    line = next((x for x in lines if x.startswith(prefix)), None)
    check(line is not None, f"[lm_train] main printed no {prefix!r} line")
    return [float(x) for x in re.findall(r"[-+]?\d+(?:\.\d+)?", line)]


def lm_train_bound(model, cfg, tokens, b, s):
    """The least time of one training step of ``tokens`` tokens, from the
    config: (bound_ms, bound_by, parts).  Operations: 6 per matrix-product
    weight a token (forward and backward; the embedding gather is no
    product), plus the attention products (QK^T and PV, 3x for the
    backward), plus, with ``remat_policy="full"``, a second forward of the
    products (the "dots" policy keeps their outputs).  Bytes: each input
    read once and each output written once: the parameters (read and
    written), the float32 moments m and v (read and written) and the
    tokens.  ``parts`` also carries the optimizer update's traffic alone
    (parameters and gradients in the model's type, m and v), and the
    figure with every weight counted as a product."""
    n = sum(p.numel() for p in model.parameters())
    item = model.embed.element_size()
    products = n - model.embed.numel()
    attn = 3 * cfg.n_layers * 2 * 2 * b * s * s * cfg.n_heads * cfg.head_dim
    recompute = 2 * products * tokens if cfg.remat_policy == "full" else 0
    ops = 6 * products * tokens + attn + recompute
    nbytes = 2 * (n * item + 8 * n) + 2 * 4 * tokens
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    update_bytes = n * (2 * item + item + 2 * 8)
    parts = {"ops": ops, "ops_ms": ops_ms, "bytes": nbytes,
             "bytes_ms": bytes_ms, "params": n, "product_weights": products,
             "update_bytes": update_bytes,
             "update_ms": update_bytes / HBM_BYTES_PER_S * 1e3,
             "all_weights_full_remat_ops": 8 * n * tokens,
             "all_weights_full_remat_ms": 8 * n * tokens / BF16_OPS_PER_S
             * 1e3}
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), parts


def lm_train_gate(torch, cfg, device):
    """float32 at full width, depth ``LM_TRAIN_F32[0]``, TF32 off: one
    ``train_step`` on the card against the same step on the CPU from the
    same weights, moments and batch."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.models import transformer
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import train_step

    layers, b, s = LM_TRAIN_F32
    cfg = replace(cfg, dtype="float32", n_layers=layers, remat=True)
    tag = f"[lm_train] float32 gate ({layers} layers, {b} x {s})"
    card = transformer.init_params(cfg, device=device)
    host = transformer.Transformer(cfg, device="meta")
    host.load_state_dict({k: v.to("cpu", copy=True)
                          for k, v in card.state_dict().items()}, assign=True)
    opt_host = init_opt_state(host)
    g = torch.Generator().manual_seed(LM_SEED)
    for key, scale in (("m", 1e-3), ("v", 1e-2)):
        for t in opt_host[key].values():
            t.copy_(scale * (0.5 + torch.rand(t.shape, generator=g)))
    opt_host["step"].fill_(3)
    opt_card = {k: ({n: t.to(device) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(device))
                for k, v in opt_host.items()}
    rng = np.random.default_rng(LM_SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                 .astype(np.int32))
             for k in ("inputs", "labels")}
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    _, new_card, m_card = train_step(
        card, opt_card, {k: v.to(device) for k, v in batch.items()},
        cfg=cfg, opt_cfg=oc)
    _, new_host, m_host = train_step(host, opt_host, batch, cfg=cfg,
                                     opt_cfg=oc)
    host_sd, card_sd = host.state_dict(), card.state_dict()
    out = {"layers": layers, "batch": b, "seq": s, "tol": LM_TRAIN_TOL,
           "loss_card": float(m_card["loss"]),
           "loss_cpu": float(m_host["loss"]),
           "grad_norm_card": float(m_card["grad_norm"]),
           "grad_norm_cpu": float(m_host["grad_norm"]),
           "params_err": max(float((card_sd[k].cpu() - v).abs().max())
                             for k, v in host_sd.items()),
           "m_err": max(float((new_card["m"][k].cpu() - v).abs().max())
                        for k, v in new_host["m"].items())}
    rel = lambda a, w: abs(a - w) / abs(w)
    ok = (rel(out["loss_card"], out["loss_cpu"]) <= LM_TRAIN_TOL["loss"]
          and rel(out["grad_norm_card"], out["grad_norm_cpu"])
          <= LM_TRAIN_TOL["loss"]
          and out["params_err"] <= LM_TRAIN_TOL["params"]
          and out["m_err"] <= LM_TRAIN_TOL["m"])
    check(ok, f"{tag}: card and CPU disagree: {out}")
    log(f"{tag}: loss card {out['loss_card']:.7f} / CPU "
        f"{out['loss_cpu']:.7f}, grad norm {out['grad_norm_card']:.7f} / "
        f"{out['grad_norm_cpu']:.7f} (rtol {LM_TRAIN_TOL['loss']}); "
        f"updated parameters max abs err {out['params_err']:.3g} (atol "
        f"{LM_TRAIN_TOL['params']}), m {out['m_err']:.3g} (atol "
        f"{LM_TRAIN_TOL['m']})")
    return out


def lm_train_drills(torch, train, device):
    """At smoke size on ``device``: a corrupted newest leaf resumes from
    the older step; ``--simulate-failure-at`` exits 42 in a subprocess."""
    import os
    import shutil

    import numpy as np

    from repro_torch.dist import checkpoint as ckpt

    root = ROOT / "build" / "lm_train_drills"
    shutil.rmtree(root, ignore_errors=True)
    d = str(root / "corrupt")
    base = ["--device", str(device), "--seq", "32", "--ckpt-every", "2",
            "--ckpt-dir"]
    train_main(train, ["--steps", "4", *base, d])
    victim = root / "corrupt" / "step_00000004" / "leaf_00000.npy"
    np.save(victim, np.zeros_like(np.load(victim)))
    metrics, lines = train_main(train, ["--steps", "6", "--resume", *base, d])
    check("[train] resumed from step 2" in lines
          and [m["step"] for m in metrics] == [2, 3, 4, 5],
          "[lm_train] a corrupted step 4 did not resume from step 2")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "5",
         "--simulate-failure-at", "3", *base, str(root / "crash")],
        env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 42
          and "[train] simulating failure at step 3" in proc.stdout,
          f"[lm_train] --simulate-failure-at 3 exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    out = {"corrupt_resumed_from": 2, "crash_exit_code": proc.returncode,
           "crash_s": time.perf_counter() - t0,
           "crash_steps_saved": ckpt.available_steps(str(root / "crash"))}
    shutil.rmtree(root, ignore_errors=True)
    log(f"[lm_train] smoke drills on {device}: corrupted step 4 resumed "
        f"from step 2; --simulate-failure-at 3 exited 42 in "
        f"{out['crash_s']:.1f} s with steps {out['crash_steps_saved']} "
        "saved")
    return out


def lm_train_profile(torch, cfg, device, b, s, reps=3):
    """One full-width step of ``b`` x ``s`` tokens (remat on, a fresh model
    seeded 0): CUDA-event times of the forward and
    backward pass (``train.step._grads``) and of the AdamW update
    (``optim.apply_updates``), medians of ``reps``, and a profiler window
    over one whole ``train_step``."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    from repro_torch.train import step as tstep

    model = transformer.init_params(cfg, device=device)
    state = {"opt": init_opt_state(model)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             TokenPipeline(cfg.vocab_size, b, s).next_batch()[0].items()}
    oc = OptConfig(lr=3e-3, total_steps=10, warmup_steps=2)

    def step():
        _, state["opt"], _ = tstep.train_step(model, state["opt"], batch,
                                              cfg=cfg, opt_cfg=oc)

    step()
    torch.cuda.synchronize()
    split = {"forward_backward": [], "update": []}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        grads, _, _ = tstep._grads(model, cfg, batch)
        ev[1].record()
        _, state["opt"], _ = apply_updates(oc, model, grads, state["opt"])
        ev[2].record()
        torch.cuda.synchronize()
        split["forward_backward"].append(ev[0].elapsed_time(ev[1]))
        split["update"].append(ev[1].elapsed_time(ev[2]))
        del grads
    out = {k: statistics.median(v) for k, v in split.items()}
    prof = device_profile(torch, step)
    check(prof is not None, "[lm_train] torch.profiler recorded no device "
          "time for one training step")
    out["profile_one_step"] = prof
    records = sum(c for _, _, c in prof["by_kernel"])
    log(f"[lm_train] one step split (CUDA events, median of {reps}): "
        f"forward and backward {out['forward_backward']:.3f} ms, AdamW "
        f"update {out['update']:.3f} ms; profile of one step: wall "
        f"{prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f}"
        f" ms, idle share {prof['idle_share']:.1%}, {records} device "
        "records")
    for key, ms, count in prof["by_kernel"][:10]:
        log(f"[lm_train] {ms:10.4f} ms  x{count:<5d} {key[:100]}")
    del model, state
    return out


def lm_train_phase(torch, device):
    """The training launcher: tinyllama-1.1b at full width and depth on the
    card (the smoke config in a CPU rehearsal), checkpoint and resume,
    fault drills and the float32 gate (see the module docstring, phase
    13)."""
    import shutil
    from dataclasses import replace

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.metadata_index import MetadataIndex
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import transformer

    card = device != "cpu"
    cfg = get_config(LM_ARCH) if card else get_config(LM_ARCH).smoke()
    argv = [a for a in LM_TRAIN_ARGV if card or a != "--no-smoke"]
    ckpt_dir = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    argv = [*argv, "--device", str(device), "--ckpt-dir", str(ckpt_dir)]
    b = int(argv[argv.index("--batch") + 1])
    s = int(argv[argv.index("--seq") + 1])
    steps = int(argv[argv.index("--steps") + 1])
    shapes = transformer.Transformer(cfg, device="meta")
    n = transformer.n_params(shapes)
    step_bytes = sum(p.numel() * (p.element_size() + 8)
                     for p in shapes.parameters()) + 4
    free = shutil.disk_usage(ckpt_dir).free
    out = {"arch": cfg.name, "argv": argv, "params": n,
           "checkpoint_step_bytes": step_bytes, "disk_free_bytes": free}
    log(f"[lm_train] {cfg.name} {'full width' if card else 'smoke'}: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, remat "
        f"{cfg.remat_policy}: {n} parameters; a checkpoint step "
        f"{step_bytes} B, {free} B free on the disk")
    if card:
        check(n == LM_PARAMS, f"[lm_train] {n} parameters, want {LM_PARAMS}")
    check(free >= 2 * step_bytes, f"[lm_train] {free} B free, a resumed "
          f"run holds two steps of {step_bytes} B")
    bound_ms, bound_by, parts = lm_train_bound(shapes, cfg, b * s, b, s)
    del shapes
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the main path: the trainer's own entry point, counts read around it
    ops.reset_launches()
    t0 = time.perf_counter()
    metrics, lines = train_main(train, argv)
    out["main_s"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    if card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    check([m["step"] for m in metrics] == list(range(steps)),
          f"[lm_train] ran steps {[m['step'] for m in metrics]}")
    losses = [m["loss"] for m in metrics]
    gnorms = [m["grad_norm"] for m in metrics]
    check(bool(np.isfinite(losses + gnorms).all()),
          f"[lm_train] losses {losses}, grad norms {gnorms}")
    dts = [m["dt"] * 1e3 for m in metrics]
    later = statistics.median(dts[1:])
    saved = printed(lines, "[train] saved step")
    done = printed(lines, "[train] done in")
    out.update(losses=losses, grad_norms=gnorms, step_ms=dts,
               first_step_ms=dts[0], median_step_ms=later,
               tokens_per_step=b * s, tok_per_s=b * s / later * 1e3,
               bound_ms=bound_ms, bound_by=bound_by, bound_parts=parts,
               save_bytes=int(saved[1]), save_s=saved[2],
               curation={"index_words": int(done[1]), "rows": int(done[3]),
                         "scanned_words": int(done[4])})
    check(out["save_bytes"] == step_bytes,
          f"[lm_train] saved {out['save_bytes']} B, want {step_bytes}")
    # the curation query's rows: a numpy index fed the same metadata
    pipe = TokenPipeline(cfg.vocab_size, b, s)
    want = MetadataIndex()
    for _ in range(steps):
        want.add_batch(pipe.next_batch()[1])
    rows, _ = want.query(where={"domain": 3}, backend="numpy")
    check(len(rows) == out["curation"]["rows"],
          f"[lm_train] curation query gave {out['curation']['rows']} rows, "
          f"numpy {len(rows)}")
    if card:
        check(out["launches"].get("ewah_decode", 0) > 0
              and out["launches"].get("planfuse", 0) > 0,
              f"[lm_train] the curation query launched {out['launches']}: "
              "want ewah_decode and planfuse")
    log(f"[lm_train] {steps} steps of {b} x {s} tokens: first step "
        f"{dts[0]:.1f} ms, median of the rest {later:.2f} ms (host clock, "
        f"the loss read synchronises): {out['tok_per_s']:.0f} tok/s; bound "
        f"{bound_ms:.3f} ms ({bound_by}: {parts['ops']:.4g} ops, "
        f"{parts['bytes']} B), {bound_ms / later:.1%} of it; the update's "
        f"traffic alone {parts['update_bytes']} B, {parts['update_ms']:.3f} "
        f"ms; every weight as a product with a full remat forward "
        f"{parts['all_weights_full_remat_ops']:.4g} ops, "
        f"{parts['all_weights_full_remat_ms']:.3f} ms")
    log(f"[lm_train] each step (ms, share of the {bound_ms:.3f} ms bound): "
        + ", ".join(f"{ms:.1f} ({bound_ms / ms:.2%})" for ms in dts))
    log(f"[lm_train] losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}; peak memory "
        f"{out.get('peak_memory_bytes', 'not measured')} (B); checkpoint "
        f"{out['save_bytes']} B in {out['save_s']} s; curation query "
        f"{out['curation']}, launches {out['launches']} (numpy: "
        f"{len(rows)} rows)")

    # resume from the closing save and train LM_TRAIN_MORE more steps
    more = steps + LM_TRAIN_MORE
    t0 = time.perf_counter()
    resumed, lines = train_main(
        train, [*argv[:argv.index("--steps") + 1], str(more),
                *argv[argv.index("--steps") + 2:], "--resume"])
    out["resume_main_s"] = time.perf_counter() - t0
    check(f"[train] resumed from step {steps}" in lines
          and [m["step"] for m in resumed] == list(range(steps, more)),
          f"[lm_train] the resumed run printed {lines[:3]}")
    restored = printed(lines, "[train] restored")
    check(bool(np.isfinite([m["loss"] for m in resumed]).all()),
          "[lm_train] the resumed steps' losses are not finite")
    out["resume"] = {"restore_bytes": int(restored[0]),
                     "restore_s": restored[1],
                     "losses": [m["loss"] for m in resumed],
                     "step_ms": [m["dt"] * 1e3 for m in resumed]}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[lm_train] resumed from step {steps}: restore {int(restored[0])} "
        f"B in {restored[1]} s, {LM_TRAIN_MORE} more steps, losses "
        f"{[round(x, 4) for x in out['resume']['losses']]}; main "
        f"{out['resume_main_s']:.1f} s; checkpoint directory removed")
    if card:
        torch.cuda.empty_cache()
        out["split"] = lm_train_profile(torch, replace(cfg, remat=True),
                                        device, b, s)
        torch.cuda.empty_cache()
        out["drills"] = lm_train_drills(torch, train, device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out["float32"] = lm_train_gate(torch, cfg, device)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def lm_mesh_phase(torch, device, train_out=None):
    """Both launchers on a ``DeviceMesh`` (see the module docstring,
    phase 14).  ``train_out`` is ``[lm_train]``'s result; without it (a
    run of this phase alone) the one-card losses come from a one-card run
    of the same argv."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve, train

    card = device != "cpu"
    tag = "[lm_mesh]"
    argv = [a for a in LM_TRAIN_ARGV if card or a != "--no-smoke"]
    i = argv.index("--steps")
    argv = [*argv[:i + 1], str(LM_MESH_STEPS), *argv[i + 2:],
            "--device", str(device)]
    if train_out is None:
        ref, _ = train_main(train, argv, tag)
        train_out = {"losses": [m["loss"] for m in ref],
                     "median_step_ms": statistics.median(
                         m["dt"] * 1e3 for m in ref[1:])}
    if card:
        torch.cuda.empty_cache()
    out = {"mesh": LM_MESH, "train_argv": [*argv, "--mesh", LM_MESH]}

    # the main path: training on the mesh, counts read around it
    ops.reset_launches()
    t0 = time.perf_counter()
    metrics, lines = train_main(train, out["train_argv"], tag)
    out["train_main_s"] = time.perf_counter() - t0
    out["train_launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    mesh_line = next((x for x in lines if x.startswith("[train] mesh")), "")
    out["train_mesh"] = mesh_line
    want_backend = "nccl" if card else "gloo"
    check(f"backend {want_backend}" in mesh_line,
          f"{tag} the trainer printed {mesh_line!r}: want a {LM_MESH} "
          f"mesh on {want_backend}")
    losses = [m["loss"] for m in metrics]
    one = train_out["losses"][:3]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:3], one)]
    dts = [m["dt"] * 1e3 for m in metrics]
    out.update(losses=losses, one_card_losses=one, loss_rel_diff=rel,
               max_loss_rel_diff=max(rel), bitwise=losses[:3] == one,
               step_ms=dts, median_step_ms=statistics.median(dts[1:]),
               one_card_median_step_ms=train_out["median_step_ms"])
    check(len(losses) == LM_MESH_STEPS and max(rel) <= LM_MESH_TOL,
          f"{tag} mesh losses {losses}, one card {one}: relative "
          f"differences {rel} (limit {LM_MESH_TOL})")
    if card:
        check(out["train_launches"].get("ewah_decode", 0) > 0
              and out["train_launches"].get("planfuse", 0) > 0,
              f"{tag} the curation query launched {out['train_launches']}: "
              "want ewah_decode and planfuse")
    log(f"{tag} {mesh_line[len('[train] '):]}: losses "
        f"{[round(x, 6) for x in losses]}, one card {[round(x, 6) for x in one]}"
        f": largest relative difference {max(rel):.3g} (bitwise "
        f"{'equal' if out['bitwise'] else 'different'}); median step "
        f"{out['median_step_ms']:.2f} ms on the mesh, "
        f"{out['one_card_median_step_ms']:.2f} ms on one card (host clock);"
        f" curation query launches {out['train_launches']}")
    if card:
        torch.cuda.empty_cache()

    # serving one packed batch: one card, then the mesh (counted)
    sargv = [a for a in LM_ONE_BATCH_ARGV if card or a != "--no-smoke"]
    sargv = [*sargv, "--device", str(device)]
    single = lm_main(serve, sargv, tag)
    if card:
        torch.cuda.empty_cache()
    ops.reset_launches()
    meshed = lm_main(serve, [*sargv, "--mesh", LM_MESH], tag)
    out["serve_launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    mesh_line = next((x for x in meshed["lines"]
                      if x.startswith("[serve] mesh")), "")
    out["serve_mesh"] = mesh_line
    check(f"backend {want_backend}" in mesh_line,
          f"{tag} the server printed {mesh_line!r}")
    same = (len(single["outputs"]) == len(meshed["outputs"]) and all(
        np.array_equal(a, b) for a, b in zip(single["outputs"],
                                              meshed["outputs"])))
    out.update(serve_tokens=meshed["tokens"], serve_s=meshed["seconds"],
               one_card_serve_s=single["seconds"], tokens_identical=same,
               batches=len(meshed["outputs"]))
    check(same, f"{tag} the mesh server's greedy tokens differ from the "
                "one-card server's")
    if card:
        check(out["serve_launches"].get("ewah_decode", 0) > 0
              and out["serve_launches"].get("planfuse", 0) > 0,
              f"{tag} the mesh server's packing launched "
              f"{out['serve_launches']}: want ewah_decode and planfuse")
    log(f"{tag} {mesh_line[len('[serve] '):]}: {len(meshed['outputs'])} "
        f"packed batch(es), {meshed['tokens']} tokens, greedy tokens "
        f"identical to one card: {same}; {meshed['seconds']:.2f} s on the "
        f"mesh, {single['seconds']:.2f} s on one card; packing launches "
        f"{out['serve_launches']}")
    out["launches"] = dict(out["train_launches"])
    for k, v in out["serve_launches"].items():
        out["launches"][k] = out["launches"].get(k, 0) + v
    mesh_mod.shutdown()
    return out


def analysis_phase():
    """``[analysis]``: the port's static lint, ``python -m
    repro_torch.analysis --baseline analysis_torch_baseline.json``, in a
    subprocess; fails unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--baseline",
         "analysis_torch_baseline.json"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    log(f"[analysis] {proc.stdout.strip()} (exit {proc.returncode})")
    check(proc.returncode == 0, f"repro_torch.analysis exited "
          f"{proc.returncode}: {proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return {"exit": proc.returncode, "stdout": proc.stdout}


def dryrun_phase():
    """``[dryrun]``: the port's dry run (``launch/dryrun.py``'s ``main``,
    once a cell of ``DRYRUN_CELLS``) in one subprocess, since a process
    holds one default group and ``[lm_mesh]`` started an NCCL one here:
    a fake 256- or 512-rank world, a fake mesh on ``cuda`` where a card
    is present (else ``cpu``), ``meta`` DTensors.  Prints each cell's
    status, seconds, per-rank FLOPs and collective counts and bytes by
    kind; fails on a non-zero exit or any cell not ``ok``."""
    out_dir = ROOT / "build" / "dryrun"
    argvs = [["--arch", arch, "--shape", shape, *flags, "--out",
              str(out_dir / f"{arch}__{shape}")]
             for arch, shape, flags in DRYRUN_CELLS]
    script = ("import json, sys\n"
              "from repro_torch.launch.dryrun import main\n"
              "sys.exit(max([main(a) for a in json.loads(sys.argv[1])]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(argvs)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"the dry run exited {proc.returncode}: "
          f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    cells = []
    for argv in argvs:
        summary = json.loads((Path(argv[-1]) / "summary.json").read_text())
        check(len(summary) == 1, f"{argv}: {len(summary)} records, not 1")
        rec = summary[0]
        cells.append(rec)
        check(rec["status"] == "ok", f"[dryrun] {rec['mesh']} {rec['arch']} "
              f"{rec['shape']}: {rec['status']} {rec.get('error')}")
        coll = rec["collectives"]
        log(f"[dryrun] {rec['mesh']} {rec['arch']} {rec['shape']} on a fake "
            f"{rec['mesh_device']} mesh of {rec['n_devices']} ranks: "
            f"{rec['status']}, placing {rec['lower_s']:.2f} s, step "
            f"{rec['compile_s']:.2f} s, per-rank FLOPs "
            f"{rec['cost']['flops']:.4e}, argument bytes a rank "
            f"{rec['memory']['argument_bytes']}, collectives "
            f"{coll['counts']}, bytes {coll['bytes']}, total "
            f"{coll['total_bytes']:.4e} B")
    log(f"[dryrun] {len(cells)} cells in {secs:.1f} s (one process)")
    return {"seconds": secs, "cells": cells}


def run(device="cuda", scale=1.0, reps=20):
    """All phases; ``scale`` shrinks the tables for a rehearsal on the CPU
    with the kernels' plain versions (``device="cpu"``)."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as T
    from repro_torch.data import tables
    from repro_torch.kernels import build, ops

    report = {"device": str(device)}
    if device != "cpu":
        t0 = time.perf_counter()
        build.build_all()
        report["build_s"] = time.perf_counter() - t0
        log(f"[build] {len(build.KERNELS)} libraries built in "
            f"{report['build_s']:.1f} s")
        for name in build.KERNELS:
            for line in build.build_log(name).splitlines():
                if "registers" in line or "stack frame" in line:
                    log(f"[build] {name}: {line.strip()}")
        from repro_torch.kernels import planfuse

        report["kernel_resources"] = kernel_resources(build, planfuse)
    report["analysis"] = analysis_phase()

    data = {}
    for name, n_rows, seed in TABLES:
        cols, idx, cards = build_table(T, tables, name,
                                       max(64, int(n_rows * scale)), seed)
        t0 = time.perf_counter()
        preds = make_predicates(T, cards, seed)
        plans = [T.query.compile_plan(idx, p) for p in preds]
        plan_s = time.perf_counter() - t0
        log(f"[plan] {name}: {len(preds)} predicates compiled in "
            f"{plan_s:.4f} s, {sum(len(p.streams) for p in plans)} leaves")
        data[name] = (cols, idx, preds, plans, plan_s)

    if device != "cpu":
        report["kernels"] = kernel_phase(torch, T, data["dbgen"][1],
                                         data["dbgen"][3], device, reps)
        report["decode_median_batch"] = median_batch_decode(
            torch, T, data["dbgen"][3], device, reps)
        report["decode_worst_case"] = worst_case_decode(torch, device, reps)
    totals = dict.fromkeys(ops.LAUNCHES, 0)
    report["path"] = {}
    for name, (cols, idx, preds, plans, plan_s) in data.items():
        res = path_phase(torch, T, name, cols, idx, preds, device)
        res["plan_s"] = plan_s
        report["path"][name] = res
        for mode in ("fused", "per_stage"):
            for k, v in res[mode]["launches"].items():
                totals[k] += v
    cols, idx = data["dbgen"][:2]
    report["in_list"] = res = in_list_phase(torch, T, cols, idx, device)
    for launches in res["launches"].values():
        for k, v in launches.items():
            totals[k] += v
    report["containers"] = container_phase(torch, T, device, reps, scale)
    cols, idx, preds, plans, plan_s = data["dbgen"]
    cards = [int(c.max()) + 1 for c in cols]
    report["lifecycle"] = life = lifecycle_phase(torch, T, cols, cards, preds,
                                                 device, scale)
    for mode in ("fused", "per_stage"):
        for k, v in life[mode]["launches"].items():
            totals[k] += v
    folds = life.pop("folds")
    writer, dead = life.pop("writer"), life.pop("dead")
    check(folds and all("and" not in f[1] for f in folds),
          "the lifecycle mix folds Roaring columns with 'or' only")
    report["containers"]["whole_fold"] = fold_launch_phase(
        torch, folds, device, reps, "whole fold")
    report["serve_plane"] = plane = serve_plane_phase(
        torch, T, writer, cols, dead, cards, preds, device)
    report["metadata"] = meta = metadata_phase(torch, T, device, scale)
    for k, v in [*plane["launches"].items(), *meta["launches"].items()]:
        totals[k] += v
    report["and_popcount"] = andpop = and_popcount_phase(
        torch, T, idx, device, reps, scale)
    totals["ewah_and_popcount"] = andpop["launches"]
    # the fold drive's one launch; member: the direct calls (no path
    # launches it, see container_phase)
    totals["containerops"] += report["containers"]["launches"]["containerops"]
    totals["member"] = report["containers"]["member_direct_calls"]
    report["moe_dispatch"] = moe = moe_dispatch_phase(torch, device, reps)
    totals["moe_route"] = moe["launches"]
    report["build_primitives"] = prim = build_primitives_phase(
        torch, data, device, reps)
    totals.update(prim["launches"])
    report["lm_serve"] = lm = lm_serve_phase(torch, device, reps)
    for k, v in lm["launches"].items():
        totals[k] += v
    report["lm_train"] = lm = lm_train_phase(torch, device)
    for k, v in lm["launches"].items():
        totals[k] += v
    report["lm_mesh"] = lm = lm_mesh_phase(torch, device, lm)
    for k, v in lm["launches"].items():
        totals[k] += v
    report["dryrun"] = dryrun_phase()
    report["launches"] = totals
    if device != "cpu":
        prof = profile_kernels(torch, T, data["dbgen"][3], device)
        check(prof is not None, "torch.profiler recorded no device time")
        report["profile_dbgen_fused"] = prof
        log(f"[profile] dbgen fused batch: wall {prof['wall_ms']:.3f} ms,"
            f" device busy {prof['device_busy_ms']:.3f} ms, idle share "
            f"{prof['idle_share']:.1%}; by category (ms) "
            f"{prof['by_category_ms']}")
        for key, ms, count in prof["by_kernel"][:12]:
            log(f"[profile] {ms:10.4f} ms  x{count:<5d} {key[:100]}")
    return report


def main():
    import torch

    timings = sys.argv[1:] == ["--timings"]
    if sys.argv[1:] and not timings:
        print("usage: chip_smoke.py [--timings]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = card[0] if card else "unknown"
    log(f"[card] {card}")
    t_start = time.perf_counter()
    try:
        report = timings_only() if timings else run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    if timings:
        print(card)
        print(json.dumps(report))
        return 0
    report["card"] = card
    report["total_s"] = time.perf_counter() - t_start
    kernels = []
    # containerops: the whole fold, the form the main path launches (its
    # pairwise form is in chip_smoke.json under containers.kernels)
    timed = {**report["kernels"], **report["containers"]["kernels"],
             "containerops": report["containers"]["whole_fold"],
             **report["moe_dispatch"]["kernels"],
             **report["build_primitives"]["kernels"],
             "ewah_and_popcount": report["and_popcount"]["kernel"]}
    for name, (source, replaces) in KERNELS.items():
        k = timed[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": report["launches"][name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k.get("library_ms")})
    # no path launches member: its count is the container phase's direct
    # ops.container_gallop calls, and its times the lineitem shape's
    kernels[list(KERNELS).index("member")]["launches_are"] = (
        "direct ops.container_gallop calls in [containers], one a shape; "
        "the container fold path launches member 0 times")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['total_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
