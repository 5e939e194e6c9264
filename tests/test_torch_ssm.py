"""The port's Mamba2 SSD against the reference's on the CPU.

``repro_torch.models.ssm`` (``Mamba2``, ``_causal_conv``, ``ssd_chunked``,
``mamba2_block``, ``mamba2_decode``) and ``serve.prefill._ssm_tail_state``
run beside ``repro.models.ssm`` and ``repro.serve.prefill`` on the same
inputs, drawn with numpy from fixed seeds, and the reference's
``init_mamba2`` weights carried across by name (``conv_b``, ``D``,
``dt_bias`` and ``norm_w`` redrawn so that they are not constant).  The
scan is checked at ``tests/test_ssm.py``'s (s, chunk) pairs against the
reference and against its token-by-token oracle, and the decode loop
against the block.  float32 at ``rtol = atol = 2e-3`` (bfloat16 blocks at
0.15), as ``tests/test_ssm.py`` and the LM tests state.  The port pads a
sequence that is not a whole number of chunks; the reference asserts, so
the padded block is held against the reference's block over a longer,
whole-chunk sequence (the scan is causal) and its final state against the
reference's ``_ssm_tail_state``, which pads.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import ssm as rssm
from repro.serve import prefill as rprefill
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import ssm
from repro_torch.serve import prefill

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.15)}


def close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def setup(dtype, arch="mamba2-1.3b"):
    cfg_r = replace(rconfigs.get_config(arch).smoke(), dtype=dtype)
    cfg = replace(configs.get_config(arch).smoke(), dtype=dtype)
    p_r = rssm.init_mamba2(jax.random.PRNGKey(0), cfg_r, DTYPES[dtype][0])
    r = np.random.default_rng(3)
    for name, base in (("conv_b", 0.0), ("D", 1.0), ("dt_bias", 0.0),
                       ("norm_w", 1.0)):
        leaf = p_r[name]
        p_r[name] = jnp.asarray(base + 0.1 * r.standard_normal(leaf.shape),
                                leaf.dtype)
    p = ssm.Mamba2(cfg, DTYPES[dtype][1], "meta")
    p.load_state_dict(params_from_reference({"layers": {}, **p_r}, cfg,
                                            "cpu"), assign=True)
    return cfg_r, p_r, cfg, p


def activations(cfg, shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((*shape, cfg.d_model))
    return (jnp.asarray(x, DTYPES[dtype][0]),
            torch.from_numpy(x).to(DTYPES[dtype][1]))


def scan_inputs(s, seed, b=2, h=4, p=8, g=1, N=16):
    """``tests/test_ssm.py``'s scan inputs."""
    r = np.random.default_rng(seed)
    return [r.normal(size=(b, s, h, p)), r.uniform(0.1, 0.9, size=(b, s, h)),
            -r.uniform(0.5, 2.0, size=(h,)), r.normal(size=(b, s, g, N)),
            r.normal(size=(b, s, g, N)), np.ones(h)]


def naive_ssd(x, dt, A, B, C, D):
    """``tests/test_ssm.py``'s token-by-token recurrence."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh = np.repeat(B, rep, axis=2)
    Ch = np.repeat(C, rep, axis=2)
    S = np.zeros((b, h, p, B.shape[3]))
    y = np.zeros_like(x)
    for t in range(s):
        dA = np.exp(dt[:, t] * A)
        xdt = x[:, t] * dt[:, t][..., None]
        S = S * dA[..., None, None] + np.einsum("bhp,bhN->bhpN", xdt, Bh[:, t])
        y[:, t] = np.einsum("bhpN,bhN->bhp", S, Ch[:, t]) + x[:, t] * D[
            None, :, None]
    return y, S


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (64, 64), (128, 32)])
def test_ssd_chunked_matches_reference_and_naive(s, chunk):
    args = scan_inputs(s, 0)
    got_y, got_S = ssm.ssd_chunked(
        *(torch.from_numpy(a).float() for a in args), chunk)
    want_y, want_S = rssm.ssd_chunked(
        *(jnp.asarray(a, jnp.float32) for a in args), chunk)
    close(got_y, want_y, 2e-3, "y")
    close(got_S, want_S, 2e-3, "state")
    naive_y, naive_S = naive_ssd(*args)
    close(got_y, naive_y, 2e-4, "y (naive)")
    close(got_S, naive_S, 2e-4, "state (naive)")


def test_ssd_chunked_wants_whole_chunks():
    args = [torch.from_numpy(a).float() for a in scan_inputs(24, 0)]
    with pytest.raises(ValueError, match="multiple of the chunk 16"):
        ssm.ssd_chunked(*args, 16)


def test_mamba2_params_match_init_mamba2():
    cfg_r = rconfigs.get_config("mamba2-1.3b")
    want = jax.eval_shape(lambda: rssm.init_mamba2(
        jax.random.PRNGKey(0), cfg_r, jnp.bfloat16))
    got = ssm.Mamba2(configs.get_config("mamba2-1.3b"), torch.bfloat16,
                     "meta").state_dict()
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
    cfg = configs.get_config("mamba2-1.3b").smoke()
    p = ssm.Mamba2(cfg, torch.bfloat16, "cpu", torch.Generator())
    p_r = rssm.init_mamba2(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
        close(getattr(p, name).detach(), p_r[name], 0.0, name)
    assert ssm.CONV_K == rssm.CONV_K


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv(dtype):
    cfg_r, p_r, cfg, p = setup(dtype)
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 11, p.conv_w.shape[1]))
    want = rssm._causal_conv(jnp.asarray(x, DTYPES[dtype][0]), p_r["conv_w"],
                             p_r["conv_b"])
    got = ssm._causal_conv(torch.from_numpy(x).to(DTYPES[dtype][1]),
                           p.conv_w.detach(), p.conv_b.detach())
    close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("s", [16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_block(dtype, s):
    cfg_r, p_r, cfg, p = setup(dtype)
    x_r, x = activations(cfg, (2, s), dtype, 6)
    with torch.no_grad():
        close(ssm.mamba2_block(p, cfg, x), rssm.mamba2_block(p_r, cfg_r, x_r),
              DTYPES[dtype][2])


@pytest.mark.parametrize("s", [1, 2, 12, 21])
def test_mamba2_block_pads_to_the_chunk(s):
    """The port's block over s tokens equals the reference's over the next
    whole chunk, cut to s; its final state and conv tail equal the
    reference's ``_ssm_tail_state`` (which pads) over the s tokens."""
    cfg_r, p_r, cfg, p = setup("float32")
    whole = -(-s // cfg.ssm_chunk) * cfg.ssm_chunk
    x_r, x = activations(cfg, (2, whole), "float32", 7)
    want = rssm.mamba2_block(p_r, cfg_r, x_r)[:, :s]
    want_tail, want_S = rprefill._ssm_tail_state(p_r, cfg_r, x_r[:, :s])
    with torch.no_grad():
        close(ssm.mamba2_block(p, cfg, x[:, :s]), want, 2e-3, "block")
        tail, S = prefill._ssm_tail_state(p, cfg, x[:, :s])
    close(tail, want_tail, 2e-3, "conv tail")
    close(S, want_S, 2e-3, "state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_matches_reference(dtype):
    cfg_r, p_r, cfg, p = setup(dtype)
    r = np.random.default_rng(8)
    conv_dim = p.conv_w.shape[1]
    d_in = cfg.ssm_expand * cfg.d_model
    x = r.standard_normal((3, 1, cfg.d_model))
    conv = r.standard_normal((3, ssm.CONV_K - 1, conv_dim))
    state = r.standard_normal((3, cfg.ssm_heads, d_in // cfg.ssm_heads,
                               cfg.ssm_state))
    jt, tt = DTYPES[dtype][:2]
    want = rssm.mamba2_decode(p_r, cfg_r, jnp.asarray(x, jt),
                              jnp.asarray(conv, jt),
                              jnp.asarray(state, jnp.float32))
    with torch.no_grad():
        got = ssm.mamba2_decode(p, cfg, torch.from_numpy(x).to(tt),
                                torch.from_numpy(conv).to(tt),
                                torch.from_numpy(state).float())
    assert got[2].dtype == torch.float32 and got[1].dtype == tt
    for g, w, what in zip(got, want, ("y", "conv", "state")):
        close(g, w, DTYPES[dtype][2], what)


def test_mamba2_decode_matches_block():
    """``tests/test_ssm.py``: a token-by-token decode equals the chunked
    block."""
    _, _, cfg, p = setup("float32")
    _, x = activations(cfg, (1, 16), "float32", 9)
    d_in = cfg.ssm_expand * cfg.d_model
    conv = torch.zeros(1, ssm.CONV_K - 1, p.conv_w.shape[1])
    state = torch.zeros(1, cfg.ssm_heads, d_in // cfg.ssm_heads,
                        cfg.ssm_state)
    outs = []
    with torch.no_grad():
        for t in range(16):
            y, conv, state = ssm.mamba2_decode(p, cfg, x[:, t:t + 1], conv,
                                               state)
            outs.append(y)
        torch.testing.assert_close(torch.cat(outs, 1),
                                   ssm.mamba2_block(p, cfg, x),
                                   rtol=2e-3, atol=2e-3)
