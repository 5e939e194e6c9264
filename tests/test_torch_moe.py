"""The port's MoE FFN against the reference's on the CPU.

``repro_torch.models.moe`` (``padded_experts``, ``MoE``, ``_route``,
``moe_ffn``) runs beside ``repro.models.moe`` on the reference's
``init_moe`` weights, carried across by name, and on activations drawn
with numpy from fixed seeds: both dispatch modes ("gather": a plan per
sequence; "scatter": one plan over the batch) times the three
``route_sort`` values, for olmoe-1b-7b's and qwen2-moe-a2.7b's smoke
configs (the latter with its fused shared experts), at the default
capacity factor (1.25, which drops tokens at these shapes), at 0.25
(``tests/test_moe.py``'s capacity-drop case) and with 60 experts padded to
64 (qwen2-moe's own counts).  Output and aux loss agree in float32 at
``rtol = atol = 2e-3`` and in bfloat16 at 0.15 (the reference's bf16
tolerance; the router runs in float32 in both, so the routes agree).
``tests/test_moe.py``'s dense oracle and its route-sort invariance hold
on the port too.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import moe

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.15)}
ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
DISPATCH = ["gather", "scatter"]
ROUTE_SORTS = ["none", "expert", "grayfreq"]


def setup(arch, dtype, seed=0, **changes):
    """(reference cfg, reference params, port cfg, port ``MoE`` holding
    the same weights)."""
    cfg_r = replace(rconfigs.get_config(arch).smoke(), dtype=dtype,
                    **changes)
    cfg = replace(configs.get_config(arch).smoke(), dtype=dtype, **changes)
    p_r = rmoe.init_moe(jax.random.PRNGKey(seed), cfg_r, DTYPES[dtype][0])
    p = moe.MoE(cfg, DTYPES[dtype][1], "meta")
    p.load_state_dict(params_from_reference({"layers": {}, **p_r}, cfg,
                                            "cpu"), assign=True)
    return cfg_r, p_r, cfg, p


def activations(cfg, shape, dtype, seed):
    x = 0.3 * np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model))
    return (jnp.asarray(x, DTYPES[dtype][0]),
            torch.from_numpy(x).to(DTYPES[dtype][1]))


def check(arch, dtype, shape, seed, capacity_factor=None, **kw):
    cfg_r, p_r, cfg, p = setup(arch, dtype, **kw.pop("changes", {}))
    x_r, x = activations(cfg, shape, dtype, seed)
    want, want_aux = rmoe.moe_ffn(p_r, cfg_r, x_r, capacity_factor, **kw)
    with torch.no_grad():
        got, aux = moe.moe_ffn(p, cfg, x, capacity_factor, **kw)
    tol = DTYPES[dtype][2]
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg="output")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-3,
                               atol=2e-3, err_msg="aux")
    return got


def test_padded_experts():
    for n in (1, 8, 16, 17, 60, 64, 100):
        assert moe.padded_experts(n) == rmoe.padded_experts(n)
    assert moe.padded_experts(60) == 64


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_match_init_moe(arch):
    cfg = configs.get_config(arch)
    cfg_r = rconfigs.get_config(arch)
    want = jax.eval_shape(lambda: rmoe.init_moe(jax.random.PRNGKey(0), cfg_r,
                                                jnp.bfloat16))
    got = moe.MoE(cfg, torch.bfloat16, "meta").state_dict()
    flat = {".".join(k.key for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == flat


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route_sort", ROUTE_SORTS)
@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dispatch, route_sort, dtype):
    check(arch, dtype, (2, 16), 1, route_sort=route_sort, dispatch=dispatch)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_capacity_drops_match_reference(dispatch, dtype):
    """``tests/test_moe.py::test_capacity_drops_overflow``'s shape, held
    to the reference's output: a quarter of the capacity drops most
    assignments."""
    got = check("olmoe-1b-7b", dtype, (2, 64), 1, capacity_factor=0.25,
                dispatch=dispatch, route_sort="grayfreq")
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("route_sort", ROUTE_SORTS)
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_padded_experts_match_reference(dispatch, route_sort):
    """qwen2-moe's 60 experts padded to 64 (and its 4-of-60 routing):
    the capacity counts 60, the slots 64, and no token reaches a padded
    expert."""
    check("qwen2-moe-a2.7b", "float32", (2, 24), 2, dispatch=dispatch,
          route_sort=route_sort, changes={"n_experts": 60, "top_k": 4})


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_decode_shape_matches_reference(dispatch):
    """One token a sequence, as at decode: the capacity is 8."""
    check("olmoe-1b-7b", "bfloat16", (8, 1), 3, dispatch=dispatch)


def test_route_takes_the_lower_expert_on_ties():
    """``lax.top_k``'s order: descending, the lower index first on ties.
    Router columns 1, 3 and 6 are equal, so every token ties there."""
    cfg_r, p_r, cfg, p = setup("olmoe-1b-7b", "float32")
    router = np.array(p_r["router"])
    router[:, 3] = router[:, 6] = router[:, 1]
    p_r = {**p_r, "router": jnp.asarray(router)}
    p.router.data = torch.from_numpy(router)
    for k in (1, 2, 3):
        cfg_k = replace(cfg, top_k=k)
        x_r, x = activations(cfg, (40,), "float32", 4)
        want, wgates, _ = rmoe._route(p_r, replace(cfg_r, top_k=k), x_r)
        with torch.no_grad():
            got, gates, _ = moe._route(p, cfg_k, x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(gates.numpy(), np.asarray(wgates),
                                   rtol=1e-6, atol=1e-6)


def dense_moe_oracle(p, cfg, x):
    """``tests/test_moe.py``'s oracle: every expert computes every token,
    combined with the top-k gates."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf @ p.router.numpy()
    eids = np.argsort(-logits, axis=1, kind="stable")[:, :cfg.top_k]
    gv = np.take_along_axis(logits, eids, axis=1)
    gates = np.exp(gv - gv.max(1, keepdims=True))
    gates /= gates.sum(1, keepdims=True)
    y = np.zeros_like(xf)
    for e in range(cfg.n_experts):
        h = xf @ p.w_gate[e].numpy()
        h = h / (1 + np.exp(-h)) * (xf @ p.w_up[e].numpy())
        out = h @ p.w_down[e].numpy()
        for j in range(cfg.top_k):
            sel = eids[:, j] == e
            y[sel] += out[sel] * gates[sel, j:j + 1]
    if cfg.n_shared_experts:
        sp = p.shared
        sh = xf @ sp.w_gate.numpy()
        sh = sh / (1 + np.exp(-sh)) * (xf @ sp.w_up.numpy())
        y += sh @ sp.w_down.numpy()
    return y.reshape(b, s, d)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_dense_oracle(arch, dispatch):
    _, _, cfg, p = setup(arch, "float32")
    _, x = activations(cfg, (2, 16), "float32", 1)
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, cfg, x, capacity_factor=8.0,
                             dispatch=dispatch)
        want = dense_moe_oracle(p, cfg, x.numpy())
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("route_sort", ["expert", "grayfreq"])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_route_sort_does_not_change_output(dispatch, route_sort):
    """Without drops the slot order is a locality choice only."""
    _, _, cfg, p = setup("olmoe-1b-7b", "float32")
    _, x = activations(cfg, (2, 16), "float32", 1)
    with torch.no_grad():
        y0, _ = moe.moe_ffn(p, cfg, x, 8.0, "none", dispatch)
        y1, _ = moe.moe_ffn(p, cfg, x, 8.0, route_sort, dispatch)
    torch.testing.assert_close(y0, y1, rtol=1e-5, atol=1e-5)
