"""Multi-pod dry run on a fake process group: place every (arch x shape x
mesh) cell's state and run one step of it, with no device and no
allocation.

The port of ``src/repro/launch/dryrun.py``.  The reference AOT-compiles
each cell for 256 or 512 fake TPU devices; here one process holds a fake
``torch.distributed`` group of 256 (16x16) or 512 (2x16x16) ranks
(``FakeStore`` and the ``"fake"`` backend: every collective returns at
once and moves nothing), ``launch/mesh.py``'s ``make_production_mesh``
builds the ``DeviceMesh`` on it, and the model, the optimizer state and
the inputs are ``meta``-device DTensors placed by ``dist/sharding.py``.
Each rank's shard is a ``meta`` tensor of the local shape, so a cell runs
the step's whole dispatch (sharding propagation, redistributions, the
local-shard paths) for rank 0 without touching a byte.  Proves the
distribution config is coherent without hardware: a placement without a
DTensor rule, a shape that does not divide, or a collective the step did
not expect fails here.

Each cell writes one JSON record with the reference's keys:

* ``lower_s``: seconds to place the meta state (parameters, optimizer
  state, inputs); ``compile_s``: seconds to run the step under the
  counters.  There is no compiler: these are host seconds of DTensor's
  dispatch, not XLA's.
* ``memory``: ``argument_bytes`` and ``output_bytes`` per rank, the bytes
  of the step's inputs' and outputs' local shards; ``temp_bytes`` and
  ``generated_code_bytes`` are null (no compiler, no buffer assignment).
* ``cost``: ``flops`` per rank, as the reference's ``cost_analysis`` of
  the SPMD module is.  Only products are counted (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions, attention: the ops
  ``torch.utils.flop_counter`` has formulas for), where XLA counts every
  op.  A ``FlopCounterMode`` at the top level would see DTensor ops at
  their global shapes; :class:`StepCounter` instead declines DTensor ops
  (returns ``NotImplemented``), so DTensor dispatches them and runs each
  rank-local op through the counter again, at the shape one rank
  computes (the local-shard paths are plain tensors already).  The ops
  DTensor's sharding propagation runs on ``FakeTensor``s to learn output
  shapes are not counted.  ``bytes_accessed`` is null.
* ``collectives``: ``counts`` and ``bytes`` under the reference's five
  names and ``total_bytes``; a collective's bytes are its result's bytes
  on one rank, as the reference sums the per-device result shapes of the
  post-SPMD HLO.  Both kinds of collective are caught: the functional
  ones DTensor's redistributions issue (``_c10d_functional.*``) and the
  in-place c10d calls of the local-shard decode
  (``attention._sharded_decode``'s all-reduces).  The step also runs
  under ``torch.distributed.tensor.debug.CommDebugMode``, whose count of
  each kind must equal the counter's (else the cell is an error).
* ``mesh_device``: the mesh's device type, ``"cuda"`` where a card is
  present, else ``"cpu"`` (nothing is placed on it).  On a ``"cpu"``
  mesh DTensor has no all-to-all (the gloo path): it redistributes
  ``Shard(i)`` to ``Shard(j)`` with an all-gather and a local chunk, so a
  host mesh counts all-gathers where a ``"cuda"`` mesh counts
  all-to-alls (``_dtensor::shard_dim_alltoall``).  Every other
  collective is the same on both.

Divergences from the reference's cells: a decode cell's ``cache_len`` is
a host int (the port's ``decode_attention`` takes one), ``S - 1``, where
every cache slot is valid; the reference compiles one program for every
value of its traced scalar.  ``--save-hlo`` has no HLO to save: it
writes each cell's list of collectives instead (op, mesh dimension,
bytes), gzipped JSON, under ``OUT/hlo``.

A full-width cell takes seconds to minutes of host time (a 32k prefill
cell about four); ``--all`` (64 runnable cells, 16 skipped) takes hours
in one process, so a sweep is better run a cell a process.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
import traceback
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..analysis.findings import Finding, render_findings
from ..configs import list_archs
from ..dist import sharding
from ..models import transformer
from ..models.common import ShardingCtx, mesh_axes
from ..optim import OptConfig, init_opt_state
from ..train import prefill_step, serve_step, train_step
from .mesh import make_production_mesh
from .shapes import SHAPES, input_specs, runnable

__all__ = ["COLLECTIVES", "StepCounter", "budget_key", "build_step",
           "check_budget", "collective_kind", "fake_world", "main",
           "measure_step", "run_cell", "update_budget"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name -> the reference's collective, for the ops of _COLLECTIVE_NS
_KIND = {
    **dict.fromkeys(("all_reduce", "all_reduce_", "all_reduce_coalesced",
                     "all_reduce_coalesced_", "allreduce_",
                     "allreduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_gather_into_tensor_coalesced", "allgather_",
                     "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_"), "all-gather"),
    **dict.fromkeys(("reduce_scatter_tensor",
                     "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                     "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "alltoall_", "alltoall_base_",
                     "shard_dim_alltoall"), "all-to-all"),
    **dict.fromkeys(("send", "recv_"), "collective-permute"),
}
# every op of these moves data, but for _QUIET's: functional collectives,
# their autograd forms and in-place c10d calls
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# CommDebugMode's name for the functional ops, and DTensor's own
# all-to-all (a "cuda" mesh's Shard(i) -> Shard(j) redistribution)
_OTHER_NS = ("c10d_functional", "_dtensor")
_QUIET = {"wait_tensor", "_wrap_tensor_autograd"}


def collective_kind(qualified: str):
    """The reference's name for the op ``ns::name`` (or ``ns.name``);
    None for an op that moves no data; raises for a collective that the
    counter does not know."""
    ns, _, name = qualified.replace("::", ".").rpartition(".")
    ns = ns.rpartition(".")[2]
    if name in _KIND and ns in _COLLECTIVE_NS + _OTHER_NS:
        return _KIND[name]
    if ns in _COLLECTIVE_NS and name not in _QUIET:
        raise RuntimeError(f"uncounted collective {qualified}")
    return None


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (a
    ``Transformer`` counts its ``state_dict``)."""
    leaves = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            leaves += list(x.state_dict().values())
        else:
            leaves.append(x)
    return _nbytes([t.to_local() if hasattr(t, "to_local") else t
                    for t in leaves])


class StepCounter(TorchDispatchMode):
    """Per-rank FLOPs of every product and the result bytes of every
    collective, under one step (see the module docstring).

    ``groups`` maps a process group's name to its mesh dimension's name;
    ``ops`` lists each collective as ``{"op", "dim", "bytes"}``."""

    def __init__(self, groups: dict):
        super().__init__()
        self.groups = groups
        self.flops = 0
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor dispatches it and runs the local op through here
            return NotImplemented
        out = func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in leaves):
            return out  # sharding propagation learning an output shape
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = collective_kind(packet._qualified_op_name)
        if kind is not None:
            # in-place c10d ops write their first argument
            inplace = packet._qualified_op_name.startswith("c10d::")
            result = args[0] if inplace else out
            self.ops.append({"op": kind, "dim": self._dim(leaves),
                             "bytes": _nbytes(result)})
        return out

    def _dim(self, leaves) -> str:
        """The mesh dimension of a collective's group: functional ops
        name it, in-place c10d ops pass the group boxed."""
        from torch.distributed import ProcessGroup

        for x in leaves:
            if isinstance(x, torch.ScriptObject):
                x = ProcessGroup.unbox(x)
            name = x if isinstance(x, str) else getattr(x, "group_name",
                                                        None)
            if name in self.groups:
                return self.groups[name]
        return "world"

    def collectives(self) -> dict:
        """``{"counts", "bytes", "total_bytes"}`` in the reference's
        shape."""
        counts = dict.fromkeys(COLLECTIVES, 0)
        nbytes = dict.fromkeys(COLLECTIVES, 0)
        for op in self.ops:
            counts[op["op"]] += 1
            nbytes[op["op"]] += op["bytes"]
        return {"counts": counts, "bytes": nbytes,
                "total_bytes": sum(nbytes.values())}


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks (this
    process is rank 0); a fake group of another size is replaced.  Raises
    when a real group runs: the dry run needs a process of its own."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group runs in this process; "
                               "run the dry run in a process of its own")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _materialize(tree, device):
    """``meta`` specs as zero tensors on ``device`` (ids 0 are valid)."""
    if device == "meta":
        return tree
    if isinstance(tree, dict):
        return {k: _materialize(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def _decode_rules(specs, mesh):
    """The reference's decode choice: a batch the data axes do not divide
    (long_500k has B=1) is replicated (``{"batch": None}``)."""
    sizes = mesh_axes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    return {"batch": None} if specs["tokens"].shape[0] % dp else None


def build_step(cfg, kind, specs, mesh, microbatches: int = 1,
               grad_zero: bool = False, device="meta"):
    """Place one cell's state on ``mesh`` (made on ``device``; ``meta``
    allocates nothing) with the reference's ``build_step`` choices, and
    return (step, state, rules): ``step()`` runs the cell's step and
    returns its outputs, ``state`` holds its inputs, ``rules`` are the
    sharding-rule overrides the step runs under."""
    rules = _decode_rules(specs, mesh) if kind == "decode" else None
    with ShardingCtx(mesh, rules):
        model = transformer.init_params(cfg, device=device)
        if kind == "train":
            from .train import place_state

            opt = place_state(model, init_opt_state(
                model, zero_pad=sharding.zero_pad_for(mesh)), mesh, cfg)
            batch = sharding.distribute(
                _materialize(specs["batch"], device),
                sharding.batch_shardings(mesh, cfg, "train"))
            g_sh = (sharding.grad_shardings_zero(mesh, cfg) if grad_zero
                    else None)
            return (lambda: train_step(
                model, opt, batch, cfg=cfg, opt_cfg=OptConfig(),
                microbatches=microbatches, grad_shardings=g_sh)), \
                (model, opt, batch), rules
        sharding.shard_params(model, sharding.param_shardings(mesh, cfg,
                                                              rules=rules))
        if kind == "prefill":
            batch = sharding.distribute(
                _materialize(specs["batch"], device),
                sharding.batch_shardings(mesh, cfg, "prefill"))
            return (lambda: prefill_step(model, batch, cfg=cfg)), \
                (model, batch), rules
        cache = sharding.distribute(_materialize(specs["cache"], device),
                                    sharding.cache_shardings(mesh, cfg,
                                                             rules=rules))
        tokens = sharding.distribute(
            {"tokens": _materialize(specs["tokens"], device)},
            sharding.batch_shardings(mesh, cfg, "decode", rules=rules))
    # a host int where the reference traces a scalar: the last slot, so
    # every cache position is valid (an SSM-only cache has no positions)
    cache_len = (specs["cache"]["k"].shape[2] - 1 if "k" in specs["cache"]
                 else 0)
    return (lambda: serve_step(model, tokens["tokens"], cache, cache_len,
                               cfg=cfg)), (model, tokens, cache), rules


def measure_step(cfg, kind, specs, mesh, microbatches: int = 1,
                 grad_zero: bool = False, device="meta") -> dict:
    """Place one cell and run its step under the counters: the record's
    ``lower_s``, ``compile_s``, ``memory``, ``cost`` and ``collectives``,
    with ``ops`` (the collectives one by one) beside them."""
    from torch.distributed.tensor.debug import CommDebugMode

    t0 = time.perf_counter()
    step, state, rules = build_step(cfg, kind, specs, mesh, microbatches,
                                    grad_zero, device)
    t_place = time.perf_counter()
    groups = {mesh.get_group(d).group_name: name
              for d, name in enumerate(mesh.mesh_dim_names)}
    counter = StepCounter(groups)
    with ShardingCtx(mesh, rules), CommDebugMode() as comm, counter:
        out = step()
    t_step = time.perf_counter()
    coll = counter.collectives()
    debug = dict.fromkeys(COLLECTIVES, 0)
    for op, n in comm.get_comm_counts().items():
        name = getattr(op, "_qualified_op_name", str(op))
        kind = collective_kind(name)
        if kind is None:
            raise RuntimeError(f"CommDebugMode counted {name}, which the "
                               "step counter does not know")
        debug[kind] += n
    if debug != coll["counts"]:
        raise RuntimeError(f"CommDebugMode counted {debug}, the step "
                           f"counter {coll['counts']}")
    return {
        "lower_s": t_place - t0,
        "compile_s": t_step - t_place,
        "memory": {"argument_bytes": _local_bytes(state),
                   "output_bytes": _local_bytes(out),
                   "temp_bytes": None, "generated_code_bytes": None},
        "cost": {"flops": counter.flops, "bytes_accessed": None},
        "collectives": coll,
        "ops": counter.ops,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, hlo_dir=None,
             microbatches: int = 1, remat_policy: str | None = None,
             moe_dispatch: str | None = None, grad_zero: bool = False) -> dict:
    """One cell's record (the reference's keys, plus ``mesh_device`` for
    a cell that ran: ``"cuda"`` where a card is present, else ``"cpu"``).
    A cell ``runnable`` skips needs no process group; any other starts a
    fake world of the mesh's size."""
    cfg, kind, specs = input_specs(arch, shape_name)
    if remat_policy:
        cfg = replace(cfg, remat_policy=remat_policy)
    if moe_dispatch:
        cfg = replace(cfg, moe_dispatch=moe_dispatch)
    ok, reason = runnable(cfg, SHAPES[shape_name])
    rec = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": 512 if multi_pod else 256,
        "microbatches": microbatches, "remat_policy": cfg.remat_policy,
        "moe_dispatch": cfg.moe_dispatch, "grad_zero": grad_zero,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    rec["mesh_device"] = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        fake_world(rec["n_devices"])
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=rec["mesh_device"])
        res = measure_step(cfg, kind, specs, mesh, microbatches, grad_zero)
        rec.update(status="ok", **{k: v for k, v in res.items()
                                   if k != "ops"})
        if hlo_dir:
            os.makedirs(hlo_dir, exist_ok=True)
            fname = f"{arch}_{shape_name}_{rec['mesh']}.collectives.json.gz"
            with gzip.open(os.path.join(hlo_dir, fname), "wt") as f:
                json.dump(res["ops"], f)
            rec["hlo_file"] = fname
    except Exception as e:  # noqa: BLE001 — report the failure in results
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def budget_key(rec: dict) -> str:
    return f"{rec['mesh']}__{rec['arch']}__{rec['shape']}"


def check_budget(rec: dict, budget: dict) -> str:
    """Assert a cell's collective volume against its committed ceiling.

    Returns 'ok' (within budget), 'exceeded', or 'unbudgeted' (no entry for
    this cell yet — informational, so the budget file can grow cell by cell
    via ``--update-budget``).  Only collective *bytes* are gated: op counts
    are a placement choice (e.g. all-reduce vs reduce-scatter+all-gather),
    bytes moved are the cost model.
    """
    entry = budget.get(budget_key(rec))
    if entry is None:
        return "unbudgeted"
    got = rec["collectives"]["total_bytes"]
    limit = entry["total_bytes"]
    rec["budget"] = {"total_bytes_limit": limit, "total_bytes": got}
    return "exceeded" if got > limit else "ok"


def update_budget(path: str, results: list, slack: float) -> None:
    """Write observed collective volumes (x ``slack``) as the new ceilings,
    merging over any existing entries so partial sweeps extend the file."""
    budget = {}
    if os.path.exists(path):
        with open(path) as f:
            budget = json.load(f)
    for rec in results:
        if rec.get("status") == "ok":
            budget[budget_key(rec)] = {
                "total_bytes": int(rec["collectives"]["total_bytes"] * slack),
                "counts": rec["collectives"]["counts"],
            }
    with open(path, "w") as f:
        json.dump(dict(sorted(budget.items())), f, indent=1)
    print(f"budget {path}: {len(budget)} cells "
          f"(ceilings = observed bytes x {slack})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's collectives (op, mesh "
                         "dimension, bytes) as gzipped JSON under OUT/hlo; "
                         "there is no HLO")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "dots", "full"])
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "gather", "scatter"])
    ap.add_argument("--grad-zero", action="store_true")
    ap.add_argument("--budget", default=None,
                    help="collective budget json: fail any cell whose "
                         "collective bytes exceed its committed ceiling; "
                         "cells without an entry are reported but don't "
                         "fail")
    ap.add_argument("--update-budget", default=None, metavar="PATH",
                    help="after the sweep, write observed collective "
                         "volumes x --budget-slack as the new ceilings "
                         "(merges over existing entries)")
    ap.add_argument("--budget-slack", type=float, default=1.25)
    args = ap.parse_args(argv)

    budget = None
    if args.budget:
        with open(args.budget) as f:
            budget = json.load(f)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])

    os.makedirs(args.out, exist_ok=True)
    results = []
    unbudgeted = []  # report-only, rendered in repro_torch.analysis format
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp,
                               hlo_dir=os.path.join(args.out, "hlo")
                               if args.save_hlo else None,
                               microbatches=args.microbatches,
                               remat_policy=args.remat_policy,
                               moe_dispatch=args.moe_dispatch,
                               grad_zero=args.grad_zero)
                results.append(rec)
                tag = f"{rec['mesh']} {arch} {shape}"
                if rec["status"] == "ok":
                    note = ""
                    if budget is not None:
                        verdict = check_budget(rec, budget)
                        rec["budget_status"] = verdict
                        if verdict == "exceeded":
                            limit = rec["budget"]["total_bytes_limit"]
                            note = f"  BUDGET EXCEEDED (limit {limit:.3e}B)"
                        elif verdict == "unbudgeted":
                            note = "  (no budget entry)"
                            unbudgeted.append(Finding(
                                rule="budget/unbudgeted-cell",
                                path=args.budget, line=1,
                                message=("cell ran but has no "
                                         "collective-bytes ceiling; accept "
                                         "with --update-budget"),
                                detail=budget_key(rec)))
                    print(f"[ok]   {tag}  lower={rec['lower_s']:.2f}s "
                          f"compile={rec['compile_s']:.2f}s "
                          f"flops={rec['cost']['flops']:.3e} "
                          f"coll={rec['collectives']['total_bytes']:.3e}B"
                          f"{note}", flush=True)
                elif rec["status"] == "skipped":
                    print(f"[skip] {tag}  {rec['reason']}", flush=True)
                else:
                    print(f"[ERR]  {tag}  {rec['error']}", flush=True)
                fname = f"{rec['mesh'].replace('x','_')}__{arch}__{shape}.json"
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(rec, f, indent=1)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    if args.update_budget:
        update_budget(args.update_budget, results, args.budget_slack)
    n_err = sum(r["status"] == "error" for r in results)
    n_over = sum(r.get("budget_status") == "exceeded" for r in results)
    n_unbudgeted = sum(r.get("budget_status") == "unbudgeted"
                       for r in results)
    if unbudgeted:
        # same file:line [rule] shape the static analyzer prints, so a
        # sweep's log is greppable with one pattern; still report-only
        print("\n".join(render_findings(unbudgeted)), flush=True)
    msg = f"done: {len(results)} cells, {n_err} errors"
    if budget is not None:
        msg += (f", {n_over} over collective budget "
                f"({n_unbudgeted} unbudgeted)")
    print(msg, flush=True)
    return 1 if (n_err or n_over) else 0


if __name__ == "__main__":
    sys.exit(main())
