"""Mamba2 SSD (state-space duality) block in the chunked, matmul form.

A copy of the reference's ``src/repro/models/ssm.py`` in plain PyTorch:
the 'minimal SSD' algorithm (Dao & Gu 2024, arXiv:2405.21060), a
within-chunk quadratic (attention-like) term plus an inter-chunk
recurrent state pass, in float32 ``torch.einsum``; the reference's
``lax.scan`` over chunks is a Python loop.  The decode path keeps a
per-head float32 state (b, h, p, N) and a depthwise-conv tail in the
model's type.

Where JAX promotes a bfloat16 operand against a float32 one inside a
product, the port casts it to float32 first (``torch.einsum`` takes one
type).  ``mamba2_block`` pads a sequence that is not a multiple of
``ssm_chunk`` with zeros at the end and drops the padded outputs: the scan
is causal, so the first ``s`` outputs and (with ``dt = 0`` on the padding)
the final state are those of the unpadded sequence.  The reference asserts
instead; the padding lets a served prompt of any length prefill.  The backward
pass flows through the padding (``F.pad``) and the chunk loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (dense_init, is_dtensor, lshard, on_local_rows, rms_norm,
                     silu, softplus)

__all__ = ["CONV_K", "Mamba2", "mamba2_axes", "mamba2_block",
           "mamba2_decode", "ssd_chunked"]

CONV_K = 4  # depthwise causal conv width (mamba2 default)


class Mamba2(nn.Module):
    """The mixer's parameters (the reference's ``init_mamba2``): the fused
    input projection ``w_in`` ([z | x | B | C | dt]), ``conv_w`` (K,
    conv_dim), ``conv_b``, ``A_log``, ``D`` and ``dt_bias`` (float32),
    ``norm_w`` and ``w_out``."""

    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        nh, N, ng = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
        conv_dim = d_in + 2 * ng * N

        def dense(shape, **kw):
            return nn.Parameter(dense_init(generator, shape, dtype=dtype,
                                           device=device, **kw))

        def const(t):
            return nn.Parameter(t.to(device))

        self.w_in = dense((d, 2 * d_in + 2 * ng * N + nh))
        self.conv_w = dense((CONV_K, conv_dim), scale=1.0)
        self.w_out = dense((d_in, d))
        self.conv_b = const(torch.zeros(conv_dim, dtype=dtype))
        self.A_log = const(torch.log(torch.arange(1, nh + 1,
                                                  dtype=torch.float32)))
        self.D = const(torch.ones(nh, dtype=torch.float32))
        self.dt_bias = const(torch.zeros(nh, dtype=torch.float32))
        self.norm_w = const(torch.ones(d_in, dtype=dtype))


def mamba2_axes(cfg):
    """The logical axes of each Mamba2 mixer parameter."""
    return {
        "w_in": ("embed", "ssm_inner"),
        "conv_w": ("conv_k", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm_w": ("ssm_inner",),
        "w_out": ("ssm_inner", "embed"),
    }


def _pad_seq(x, before: int, after: int):
    """``x`` zero-padded on its sequence dimension (1): ``F.pad``, or on a
    mesh a concatenation of zero rows (the pad rule of some PyTorch
    releases mis-sizes a DTensor's padded dimension)."""
    if not is_dtensor(x):
        return F.pad(x, (0, 0) * (x.dim() - 2) + (before, after))
    z = torch.zeros_like(x[:, :1])
    return torch.cat([z] * before + [x] + [z] * after, dim=1)


def _causal_conv(xBC, conv_w, conv_b):
    """Depthwise causal conv over seq: xBC (b, s, C), conv_w (K, C)."""
    K = conv_w.shape[0]
    s = xBC.shape[1]
    out = xBC * conv_w[K - 1]
    for i in range(1, K):
        shifted = _pad_seq(xBC[:, :max(s - i, 0)], min(i, s), 0)
        out = out + shifted * conv_w[K - 1 - i]
    return silu(out + conv_b)


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """SSD scan. x: (b, s, h, p), dt: (b, s, h), A: (h,) negative,
    B, C: (b, s, g, N).  Returns (b, s, h, p) and the final state
    (b, h, p, N)."""
    b, s, h, p = x.shape
    g, N = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence of {s} is not a multiple of the chunk "
                         f"{chunk}")
    nc = s // chunk
    rep = h // g

    # discretize
    dA = dt * A  # (b, s, h), negative
    xdt = x * dt[..., None]

    cA = dA.reshape(b, nc, chunk, h)
    cx = xdt.reshape(b, nc, chunk, h, p)
    cB = B.reshape(b, nc, chunk, g, N)
    cC = C.reshape(b, nc, chunk, g, N)

    # cumulative decay within each chunk
    csum = torch.cumsum(cA, dim=2)  # (b, nc, Q, h)
    total = csum[:, :, -1]  # (b, nc, h)

    # ---- intra-chunk (quadratic, attention-like) term ----
    # L[i, j] = exp(csum_i - csum_j) for i >= j
    li = csum[:, :, :, None, :]
    lj = csum[:, :, None, :, :]
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    # masked before the exp (the reference masks after it: the same values,
    # but exp of a long chunk's i < j entries overflows and 0 * inf makes
    # its gradient NaN)
    L = torch.exp(torch.where(mask[None, None, :, :, None], li - lj,
                              float("-inf")))
    cBg = cB.reshape(b, nc, chunk, g, 1, N)
    cCg = cC.reshape(b, nc, chunk, g, 1, N)
    scores = torch.einsum("bnigrN,bnjgrN->bnijg", cCg, cBg)
    scores = torch.repeat_interleave(scores, rep, dim=-1)  # (b,nc,Q,Q,h)
    y_diag = torch.einsum("bnijh,bnijh,bnjhp->bnihp", scores, L, cx)

    # ---- inter-chunk states ----
    decay_b = torch.exp(total[:, :, None] - csum)  # (b, nc, Q, h)
    Bh = torch.repeat_interleave(cB, rep, dim=3)  # (b, nc, Q, h, N)
    chunk_state = torch.einsum("bnqh,bnqhN,bnqhp->bnhpN", decay_b, Bh, cx)

    # recurrence across chunks: S_{c+1} = exp(total_c) * S_c + state_c,
    # each chunk reading the state before it
    S = torch.zeros((b, h, p, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(S)
        S = S * torch.exp(total[:, c])[:, :, None, None] + chunk_state[:, c]
    S_prev = torch.stack(prev, dim=1)  # (b, nc, h, p, N)

    # ---- inter-chunk output: C_i . S_prev, decayed ----
    Ch = torch.repeat_interleave(cC, rep, dim=3)
    decay_c = torch.exp(csum)
    y_off = torch.einsum("bnqhN,bnhpN,bnqh->bnqhp", Ch, S_prev, decay_c)

    y = (y_diag + y_off).reshape(b, s, h, p) + x * D[None, None, :, None]
    return y, S


def _mamba2(p, cfg, x):
    """The mixer over x (b, s, d): (output (b, s, d), conv tail (b, K-1,
    conv_dim) of pre-activation inputs, final state (b, h, p, N))."""
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    ng, N, nh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    hp = d_in // nh

    zxbcdt = x @ p.w_in
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * ng * N]
    # the decode tail: the last K-1 inputs, zeros before a short prompt
    tail = _pad_seq(xBC[:, max(0, s - (CONV_K - 1)):],
                    max(0, CONV_K - 1 - s), 0)
    xBC1 = _causal_conv(xBC, p.conv_w, p.conv_b)
    xs = xBC1[..., :d_in].reshape(b, s, nh, hp)
    B = xBC1[..., d_in:d_in + ng * N].reshape(b, s, ng, N)
    C = xBC1[..., d_in + ng * N:].reshape(b, s, ng, N)
    dt = softplus(zxbcdt[..., -nh:].float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    pad = (-s) % cfg.ssm_chunk
    if pad:
        xs, dt, B, C = (_pad_seq(t, 0, pad) for t in (xs, dt, B, C))
    # on a mesh the scan runs on each rank's batch rows (torch.cumsum's
    # backward flips, and aten.flip has no DTensor rule on every release)
    y, S = on_local_rows(
        lambda xs, dt, B, C, A, D: ssd_chunked(
            xs.float(), dt, A, B.float(), C.float(), D, cfg.ssm_chunk),
        (xs, dt, B, C), (A, p.D))
    y = y[:, :s].reshape(b, s, d_in).to(x.dtype)
    y = rms_norm(y * silu(z), p.norm_w)
    y = lshard(y, "batch", "seq", "ssm_inner")
    return y @ p.w_out, tail, S


def mamba2_block(p, cfg, x):
    """Full mamba2 mixer. x: (b, s, d) -> (b, s, d)."""
    return _mamba2(p, cfg, x)[0]


def mamba2_decode(p, cfg, x, conv_state, ssm_state):
    """One-token decode. x: (b, 1, d); conv_state: (b, K-1, conv_dim);
    ssm_state: (b, h, p, N) float32.  Returns (y, new_conv_state,
    new_ssm_state)."""
    b, _, d = x.shape
    d_in = cfg.ssm_expand * d
    ng, N, nh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    hp = d_in // nh

    zxbcdt = x @ p.w_in
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * ng * N]  # (b, 1, conv_dim)
    dt = zxbcdt[..., -nh:]

    window = torch.cat([conv_state, xBC], dim=1)  # (b, K, C)
    conv = (window * p.conv_w[None]).sum(1, keepdim=True) + p.conv_b
    xBC1 = silu(conv)
    new_conv_state = window[:, 1:]

    xs = xBC1[..., :d_in].reshape(b, nh, hp)
    B = xBC1[..., d_in:d_in + ng * N].reshape(b, ng, N)
    C = xBC1[..., d_in + ng * N:].reshape(b, ng, N)

    def update(xs, dt, B, C, ssm_state, dt_bias, A_log, D):
        dt = softplus(dt[:, 0].float() + dt_bias)  # (b, h)
        A = -torch.exp(A_log)
        dA = torch.exp(dt * A)
        rep = nh // ng
        Bh = torch.repeat_interleave(B, rep, dim=1).float()  # (b, h, N)
        Ch = torch.repeat_interleave(C, rep, dim=1).float()
        xdt = xs * dt[..., None]  # (b, h, p) float32
        new_state = (ssm_state * dA[..., None, None]
                     + torch.einsum("bhp,bhN->bhpN", xdt, Bh))
        y = (torch.einsum("bhpN,bhN->bhp", new_state, Ch)
             + xs * D[None, :, None])
        return y, new_state

    # on a mesh the update runs on each rank's batch rows: its products'
    # batch flatten spans two sharded dimensions (batch, "ssm_heads"),
    # which has no view rule on every PyTorch release
    y, new_state = on_local_rows(update, (xs, dt, B, C, ssm_state),
                                 (p.dt_bias, p.A_log, p.D))
    new_state = lshard(new_state, "batch", "ssm_heads", None, None)
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rms_norm(y * silu(z), p.norm_w)
    return y @ p.w_out, new_conv_state, new_state
