"""Shared model components: initialisers, norms, activations and RoPE.

A copy of the reference's ``src/repro/models/common.py`` in PyTorch, with
the reference's order of operations and casts so that the numbers agree:
``rms_norm`` normalises in float32 and casts back before the weight,
``apply_rope`` rotates halves (not interleaved pairs) with float32 angles
from integer positions, and ``silu`` is ``x * sigmoid(x)`` in the input's
type.  Initialisers draw from an explicit ``torch.Generator`` on the
target device.

The reference's logical-axis sharding (``ShardingCtx``, ``lshard``,
``logical_to_spec``) is not here: the port serves on one card with no
mesh (``launch/mesh.py`` and ``dist/sharding.py`` are later work).
"""

from __future__ import annotations

import torch

__all__ = ["apply_mrope", "apply_rope", "causal_mask", "dense_init",
           "embed_init", "resolve_device", "rms_norm", "rope_freqs", "silu",
           "softplus", "swiglu"]


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
    return h @ w_down


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
