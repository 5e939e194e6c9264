"""Shared model components: logical sharding, initialisers, norms,
activations and RoPE.

A copy of the reference's ``src/repro/models/common.py`` in PyTorch, with
the reference's order of operations and casts so that the numbers agree:
``rms_norm`` normalises in float32 and casts back before the weight,
``apply_rope`` rotates halves (not interleaved pairs) with float32 angles
from integer positions, and ``silu`` is ``x * sigmoid(x)`` in the input's
type.  Initialisers draw from an explicit ``torch.Generator`` on the
target device.

Logical-axis sharding, as in the reference: models annotate activations
and parameters with *logical* axis names, and a ``ShardingCtx`` maps them
to the axes of a mesh (``DEFAULT_RULES``, dropping mesh axes the mesh
lacks).  It comes in two halves.  The spec half (``logical_to_spec``,
``spec_for``) is metadata: it reads only the mesh's axis names, so an
``AbstractMesh`` (names and sizes, no process group) serves, and it gives
per tensor dimension the mesh axis (or tuple of axes, or None) that the
reference's ``PartitionSpec`` holds.  The placement half
(``spec_to_placements``) turns such a spec into DTensor placements on a
``DeviceMesh``, and ``lshard`` redistributes a DTensor to them.  Outside
a context, or on a plain tensor, ``lshard`` is a no-op, so the same model
code runs on one card and on a mesh.  A mesh's forward runs under
DTensor's ``implicit_replication``, so the plain tensors a model makes
itself (positions, masks, zeros) count as replicated.  Where an op has no
DTensor rule on every PyTorch release, the model either redistributes
its operands right before it (``replicated``, ``unsharded``; GSPMD does
the same implicitly) or runs the op sequence on this rank's shards as
plain tensors and wraps the result (``on_local_rows``, ``from_local``,
``set_layer``, and the attention and embedding paths), naming the op in
a comment.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch

__all__ = ["AbstractMesh", "DEFAULT_RULES", "ShardingCtx", "apply_mrope",
           "apply_rope", "causal_mask", "current_ctx", "dense_init",
           "embed_init", "from_local", "is_dtensor", "logical_to_spec",
           "lshard", "mesh_axes", "mesh_region", "on_local_rows", "placed_as",
           "replicated", "resolve_device", "rms_norm", "rope_freqs",
           "set_layer", "shard_count", "shard_span", "silu", "softplus",
           "spec_for", "spec_to_placements", "swiglu", "unsharded"]


# ---------------------------------------------------------------------------
# Logical-axis sharding
# ---------------------------------------------------------------------------

_ctx = threading.local()

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,        # GQA kv replicated across the model axis
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",      # expert parallelism
    "expert_cap": None,
    "kv_seq": "model",       # decode-time KV cache sequence sharding
    "ssm_inner": "model",
    "ssm_heads": "model",    # decode SSM state sharded by heads
    "ssm_state": None,
    "opt_zero": "data",      # ZeRO-1 axis for optimizer moments
    "conv_k": None,
}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without devices or a process group
    (``jax.sharding.AbstractMesh``): enough for the spec half and for
    ``dist.sharding``'s trees of specs."""

    shape: tuple
    mesh_dim_names: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class ShardingCtx:
    """Context manager activating logical->physical sharding on a mesh;
    re-entrant (the previous context comes back on exit)."""

    def __init__(self, mesh, rules=None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def __enter__(self):
        self._prev = current_ctx()
        _ctx.current = self
        return self

    def __exit__(self, *a):
        _ctx.current = self._prev


def current_ctx():
    return getattr(_ctx, "current", None)


def logical_to_spec(axes) -> tuple:
    """The mesh axis of each logical axis under the current context: a
    name, a tuple of names, or None (the reference's ``PartitionSpec``
    entries).  Outside a context, ``()``."""
    ctx = current_ctx()
    if ctx is None:
        return ()
    names = tuple(ctx.mesh.mesh_dim_names)
    phys = []
    for ax in axes:
        m = ctx.rules.get(ax) if ax is not None else None
        # drop mesh axes the current mesh doesn't have ("pod" on 2-D)
        if isinstance(m, tuple):
            m = tuple(x for x in m if x in names)
            m = m if m else None
        elif m is not None and m not in names:
            m = None
        phys.append(m)
    return tuple(phys)


def spec_for(axes) -> tuple:
    """The spec of a parameter with the given logical axes."""
    return logical_to_spec(axes)


def spec_to_placements(spec, mesh) -> list:
    """DTensor placements on ``mesh`` of a spec: ``Shard(d)`` on every
    mesh axis that tensor dimension ``d`` names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            out[names.index(a)] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def lshard(x, *axes):
    """Redistribute the DTensor ``x`` to the logical sharding; a no-op
    outside a mesh context, for a plain tensor, or on a rank mismatch."""
    ctx = current_ctx()
    if ctx is None or x.dim() != len(axes) or not is_dtensor(x):
        return x
    target = _dividing(spec_to_placements(logical_to_spec(axes),
                                          x.device_mesh), x)
    if list(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def shard_count(x, dim: int) -> int:
    """Ranks that split dimension ``dim`` of the DTensor ``x``."""
    count = 1
    for md, p in enumerate(x.placements):
        if p.is_shard(dim % x.dim()):
            count *= x.device_mesh.size(md)
    return count


def _dividing(placements, x) -> list:
    """``placements`` for ``x`` with a dimension that its mesh axes do
    not divide left replicated: DTensor's uneven shards have no view rule
    and the local-shard paths need even ones (GSPMD pads the dimension
    instead, e.g. 28 heads over 16 ranks)."""
    from torch.distributed.tensor import Replicate

    mesh, counts = x.device_mesh, {}
    for md, p in enumerate(placements):
        if p.is_shard():
            counts[p.dim] = counts.get(p.dim, 1) * mesh.size(md)
    return [Replicate() if p.is_shard() and x.shape[p.dim] % counts[p.dim]
            else p for p in placements]


def replicated(x):
    """The DTensor ``x`` redistributed to ``Replicate()`` on every mesh
    axis (a plain tensor passes): called right before an op that has no
    DTensor sharding rule for a sharded operand."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return placed_as(x, [Replicate()] * x.device_mesh.ndim)


def _on_mesh(x) -> bool:
    if isinstance(x, torch.nn.Module):
        x = next(x.parameters(), None)
    return is_dtensor(x)


def shard_span(x, dim: int) -> tuple:
    """(offset, length) of this rank's piece of dimension ``dim`` of the
    DTensor ``x``: the mesh axes that shard it, in mesh order, index an
    even split (the local shard must have that length)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    index, count = 0, 1
    for md, pl in enumerate(x.placements):
        if pl.is_shard(dim):
            index = index * mesh.size(md) + coord[md]
            count *= mesh.size(md)
    length = x.shape[dim] // count
    if x.to_local().shape[dim] != length or x.shape[dim] % count:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split evenly over {count} ranks")
    return index * length, length


def placed_as(x, placements):
    """The DTensor ``x`` redistributed to ``placements`` (unchanged when it
    has them already)."""
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) whose shard on this rank
    is ``local``; differentiable, no communication."""
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False,
                              shape=torch.Size(shape), stride=stride)


def set_layer(dst, i: int, value) -> None:
    """``dst[i] = value`` in place (a cache's layer slice).  On a mesh
    each rank writes its own shard: ``value`` placed as ``dst`` without
    its leading (layer) dimension, which is never sharded."""
    if not is_dtensor(dst):
        dst[i] = value
        return
    from torch.distributed.tensor import Shard

    if any(p.is_shard(0) for p in dst.placements):
        raise ValueError("a cache's layer dimension is not sharded")
    placements = [Shard(p.dim - 1) if p.is_shard() else p
                  for p in dst.placements]
    with torch.no_grad():
        dst.to_local()[i] = placed_as(value, placements).to_local()


def on_local_rows(fn, rows, shared=()):
    """``fn(*rows, *shared)`` on this rank's batch rows, as plain tensors.

    ``rows`` have the batch on dimension 0: on a mesh each is placed with
    the first DTensor's batch shard only (every other dimension whole);
    ``shared`` (parameters, no batch dimension) are replicated, and their
    gradient adds over the ranks that split the batch.  ``fn`` returns a
    tuple of batch-first tensors, which come back as DTensors with that
    batch shard.  For an op sequence that is independent across batch
    rows and has no DTensor rule on every PyTorch release (the SSD scan's
    cumulative sums, whose backward flips; products whose batch flatten
    spans two sharded dimensions).  Without a DTensor it is ``fn``."""
    ref = next((t for t in rows if is_dtensor(t)), None)
    if ref is None:
        return fn(*rows, *shared)
    from torch.distributed.tensor import Partial, Replicate

    mesh = ref.device_mesh
    batch = [p if p.is_shard(0) else Replicate() for p in ref.placements]
    grad = [Partial() if p.is_shard(0) else Replicate() for p in batch]
    local = [placed_as(t, batch).to_local() if is_dtensor(t) else t
             for t in rows]
    local += [placed_as(t, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad) if is_dtensor(t) else t for t in shared]
    return tuple(from_local(o, mesh, batch, (ref.shape[0], *o.shape[1:]))
                 for o in fn(*local))


def unsharded(x, dim: int):
    """The DTensor ``x`` with dimension ``dim`` replicated and its other
    shards kept (a plain tensor passes): for an op with no DTensor rule
    along a sharded ``dim``."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim %= x.dim()
    return placed_as(x, [Replicate() if p.is_shard(dim) else p
                         for p in x.placements])


def mesh_region(*tensors):
    """DTensor's ``implicit_replication`` when any of ``tensors`` (or a
    module's parameters) is a DTensor: the plain
    tensors a model makes count as replicated there.  Else a null
    context."""
    if any(_on_mesh(t) for t in tensors):
        return _implicit_replication()
    return nullcontext()


@contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``, but
    re-entrant: the flag it sets comes back to its previous value on exit
    (the library's sets it to False), so a forward inside a training
    step's region leaves the backward pass in it."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device, and a CUDA device without a card
    raises; the CPU (or ``meta``, for shapes only) is used only when the
    caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the model runs on a CUDA device and none is available; pass "
            "device='cpu' to run it on the host")
    return dev


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(generator, shape, device):
    """float32 standard normals on ``device`` (by default the generator's;
    uninitialised on ``meta``, which allocates nothing)."""
    if device is None:
        device = (generator.device if generator is not None
                  else resolve_device(None))
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def dense_init(generator, shape, in_axis=0, dtype=torch.float32, scale=1.0,
               device=None):
    """N(0, scale^2 / fan_in) drawn in float32, then cast to ``dtype``."""
    std = scale / float(shape[in_axis]) ** 0.5
    return (_normal(generator, shape, device) * std).to(dtype)


def embed_init(generator, shape, dtype=torch.float32, device=None):
    return (_normal(generator, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * weight


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """``log(exp(x) + 1)`` with no linear cut-off (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def swiglu(x, w_gate, w_up, w_down):
    h = silu(x @ w_gate) * (x @ w_up)
    h = lshard(h, "batch", "seq", "ff")
    # on a mesh the down projection's partial sums over the model axis
    # are reduced here, where GSPMD reduces them in the reference; a
    # partial residual stream would make DTensor gather the next layer's
    # weights instead and repeat their products on every model rank
    return lshard(h @ w_down, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions, sections=(16, 24, 24), theta: float = 1e4):
    """Qwen2-VL multimodal RoPE.

    positions: (3, ..., seq) temporal / height / width position ids.  The
    rotary half-dim is split into ``sections`` (sum = head_dim / 2); each
    section rotates by its own position component.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    angles = positions.float()[..., None] * freqs  # (3, ..., seq, hd/2)
    angles = torch.movedim(angles, 0, -1)  # (..., seq, hd/2, 3)
    # per rotary frequency, the position component (t/h/w) that drives it
    index = sec[:, None].expand(*angles.shape[:-1], 1)
    angles = torch.gather(angles, -1, index)[..., 0]  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_mask(q_len, kv_len, q_offset=0, window: int | None = None,
                device=None):
    q = torch.arange(q_len, device=device)[:, None] + q_offset
    k = torch.arange(kv_len, device=device)[None, :]
    m = k <= q
    if window is not None and window > 0:
        m &= k > q - window
    return m
