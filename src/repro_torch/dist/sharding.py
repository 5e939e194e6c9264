"""Distributed placement over the ("data", "model") mesh: the port of
``src/repro/dist/sharding.py``.

Translates the models' *logical* axis annotations (``models/common.py``
``DEFAULT_RULES``) into trees of ``NamedSharding``: a mesh and a spec,
per tensor dimension the mesh axis (or tuple of axes, or None) that the
reference's ``PartitionSpec`` holds, and the DTensor ``placements`` that
spec gives on a ``DeviceMesh``.  The trees are keyed like the port's
state: parameters by ``state_dict`` name (``layers.{i}.*``, one entry a
layer where the reference stacks them), the optimizer state by ``m``,
``v`` and ``step``.

  * ``param_shardings`` -- tensor parallelism: FFN ("ff"), attention heads
    ("heads"), vocab/embedding ("vocab") and expert ("experts") dims land
    on the "model" axis; everything else is replicated.
  * ``opt_shardings``   -- ZeRO-1: AdamW moments are stored **1-D
    flattened and zero-padded** to a multiple of the "data"-axis size
    (``init_opt_state(params, zero_pad=zero_pad_for(mesh))``) and
    ``Shard(0)`` over that axis, so every leaf shards whatever its
    dimensions.  ``grad_shardings_zero`` keeps the param-shaped dim-based
    placement for gradient constraints.
  * ``batch_shardings`` -- train / prefill / decode batches split on the
    data axes (("pod", "data") when a pod axis exists).
  * ``cache_shardings`` -- decode KV cache / SSM state placement per
    ``transformer.cache_axes``.

Everything here is metadata: no tensor is allocated (shapes come from a
``meta``-device model), so an ``AbstractMesh`` serves as well as a
``DeviceMesh``; ``distribute`` and ``gather`` move tensors in and out.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models import transformer
from ..models.common import (DEFAULT_RULES, ShardingCtx, is_dtensor,
                             logical_to_spec, mesh_axes, spec_to_placements)

__all__ = ["NamedSharding", "batch_shardings", "cache_shardings",
           "distribute", "gather", "grad_shardings_zero", "opt_shardings",
           "param_shardings", "replicated", "shard_params", "zero_pad_for"]


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        """DTensor placements of the spec on the mesh."""
        return spec_to_placements(self.spec, self.mesh)


def replicated(mesh) -> NamedSharding:
    """Fully-replicated placement (scalars, small broadcast state)."""
    return NamedSharding(mesh, ())


def _shardings_from_axes(mesh, axes: dict, rules=None) -> dict:
    """``{name: logical axes}`` -> ``{name: NamedSharding}``."""
    with ShardingCtx(mesh, rules):
        return {name: NamedSharding(mesh, logical_to_spec(ax))
                for name, ax in axes.items()}


def param_shardings(mesh, cfg, rules=None) -> dict:
    """``{state_dict name: NamedSharding}`` of ``init_params(cfg)``."""
    return _shardings_from_axes(mesh, transformer.params_axes(cfg), rules)


def _mesh_axes_size(mesh, axis) -> int:
    sizes = mesh_axes(mesh)
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= sizes[a]
    return size


def _zero_axis(mesh, rules):
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    names = tuple(mesh.mesh_dim_names)
    zero = merged.get("opt_zero")
    if isinstance(zero, tuple):
        zero = tuple(a for a in zero if a in names) or None
    elif zero is not None and zero not in names:
        zero = None
    return zero


def _zero1_sharding(sharding, shape, mesh, zero):
    """Extend a param sharding with the ZeRO axis on the first replicated
    dimension it divides (the dim-based placement, kept for *gradient*
    constraints, which must keep the parameter shape)."""
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    dsize = _mesh_axes_size(mesh, zero)
    if dsize > 1:
        for i, dim in enumerate(shape):
            if spec[i] is None and dim % dsize == 0:
                spec[i] = zero
                break
    return NamedSharding(mesh, tuple(spec))


def zero_pad_for(mesh, rules=None) -> int:
    """The ZeRO-1 flatten multiple: size of the mesh's ZeRO axis (1 when
    the mesh has no such axis; moments then keep the parameter shape).
    Pass it as ``init_opt_state(params, zero_pad=...)`` so the moment
    shapes match :func:`opt_shardings`."""
    zero = _zero_axis(mesh, rules)
    return _mesh_axes_size(mesh, zero) if zero is not None else 1


def opt_shardings(mesh, cfg, rules=None) -> dict:
    """``{"m", "v", "step"}`` placements of
    ``init_opt_state(params, zero_pad=zero_pad_for(mesh))``: ZeRO-1
    moments, ``Shard(0)`` on the ZeRO axis over the flat zero-padded
    leaves (param-shaped and placed as the parameters when that axis has
    one rank), and a replicated step counter."""
    p_sh = param_shardings(mesh, cfg, rules)
    zero = _zero_axis(mesh, rules)
    if zero is None or _mesh_axes_size(mesh, zero) <= 1:
        m_sh = p_sh
    else:
        flat = NamedSharding(mesh, (zero,))
        m_sh = {name: flat for name in p_sh}
    return {"m": m_sh, "v": dict(m_sh), "step": replicated(mesh)}


def grad_shardings_zero(mesh, cfg, rules=None) -> dict:
    """Param-shaped ZeRO placements for *gradient* constraints
    (``train_step(grad_shardings=...)``): the ZeRO axis lands on the first
    replicated dimension it divides; leaves with none stay as the
    parameter.  Shapes come from a ``meta``-device model."""
    p_sh = param_shardings(mesh, cfg, rules)
    zero = _zero_axis(mesh, rules)
    if zero is None:
        return p_sh
    shapes = {n: tuple(p.shape) for n, p in
              transformer.init_params(cfg, device="meta").named_parameters()}
    return {n: _zero1_sharding(sh, shapes[n], mesh, zero)
            for n, sh in p_sh.items()}


def batch_shardings(mesh, cfg, kind: str, rules=None) -> dict:
    """Input-batch placements for one step kind.

    kind: "train" (inputs+labels), "prefill" (inputs only), or
    "decode"/"serve" (single-token ids).  Optional modality keys
    (patches / mrope_positions) appear exactly when the config uses them;
    callers with plainer batches pop what they don't feed.
    """
    with ShardingCtx(mesh, rules):
        def ns(*axes):
            return NamedSharding(mesh, logical_to_spec(axes))

        if kind in ("train", "prefill"):
            sh = {"inputs": ns("batch", "seq")}
            if kind == "train":
                sh["labels"] = ns("batch", "seq")
            if cfg.frontend != "none":
                sh["patches"] = ns("batch", None, "embed")
            if cfg.family == "vlm":
                sh["mrope_positions"] = ns(None, "batch", "seq")
            return sh
        if kind in ("decode", "serve"):
            return {"tokens": ns("batch", None)}
        raise ValueError(f"unknown batch kind: {kind!r}")


def cache_shardings(mesh, cfg, rules=None) -> dict:
    """``{leaf: NamedSharding}`` of ``transformer.init_decode_cache``."""
    return _shardings_from_axes(mesh, transformer.cache_axes(cfg), rules)


def distribute(tensors: dict, shardings: dict) -> dict:
    """Each tensor of ``tensors`` as a DTensor placed by the sharding of
    the same key (``distribute_tensor``; rank 0's values win)."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(t, shardings[k].mesh,
                                 shardings[k].placements)
            for k, t in tensors.items()}


def gather(t):
    """The full value of a DTensor on every rank; a plain tensor passes."""
    return t.full_tensor() if is_dtensor(t) else t


def shard_params(model, shardings: dict):
    """Replace each parameter of ``model`` (a ``Transformer``), in place,
    by a DTensor parameter placed by ``shardings[name]``; returns the
    model."""
    from torch import nn

    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        sh = shardings[name]
        from torch.distributed.tensor import distribute_tensor

        setattr(mod, leaf, nn.Parameter(
            distribute_tensor(p.detach(), sh.mesh, sh.placements),
            requires_grad=p.requires_grad))
    return model
