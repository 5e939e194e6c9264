"""The port's training path against the reference's on the CPU.

``repro_torch.{data.tokens, optim, train.step}`` and remat in
``models.transformer`` run beside ``repro.{data.tokens, optim,
train.step}`` on the same inputs, made with numpy from fixed seeds, and
the same weights: the reference's ``init_params`` tree (its constant
leaves redrawn, as ``tests/test_torch_lm.py`` does) carried across by
``convert.params_from_reference``, with optimizer states carried by
``convert.opt_state_from_reference``.  Models are the ``.smoke()``
configs in float32.

Tolerances, float32 (measured differences are an order of magnitude or
more below them):

* loss, aux loss and grad norm at rtol 1e-5: the two frameworks sum in
  other orders, a few units in the last place of a value near 6;
* updated parameters at atol 1e-6 and moments ``m`` at atol 1e-7, ``v``
  at rtol 1e-5, from a state whose moments are random and whose step is
  3, at lr 1e-2.  There the Adam term of an element moves by ~2e-4 with a
  wrong sign and by a factor ~3 without bias correction, and the decoupled
  weight decay moves it by lr * 0.1 * |p| >= 2e-5, so each of those faults
  fails the test, while a gradient that differs in its last places moves
  the update by ~1e-8;
* with int8 error feedback, the new residual ``ef`` at atol 1e-6 (it
  carries the gradients' own last-place differences, at |g| up to ~1), and
  1 in 10,000 elements may lie outside those tolerances (an element whose
  quantized value sits at a half rounds apart);
* from a fresh state (step 0, zero moments) the first update is lr times
  the sign of each gradient, and a gradient smaller than the frameworks'
  rounding can take either sign: there every element is held within 2 lr
  and, after four steps, all but one in 1,000 at 1e-6;
* ``apply_updates``, ``lr_schedule`` and ``compress_grads`` on identical
  inputs at rtol 1e-6 (a unit in the last place of float32; ``cos`` and
  ``pow`` come from other libraries).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro.data.tokens import TokenPipeline as RPipeline
from repro.models import transformer as rtrans
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.convert import (opt_state_from_reference,
                                 opt_state_to_reference,
                                 params_from_reference, params_to_reference)
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import transformer
from repro_torch.optim import adamw, compress
from repro_torch.pytree import tree_leaves
from repro_torch.train import step as tstep

ARCHS = rconfigs.list_archs()
# an (arch, config changes) of each family for the cheaper per-family cases
FAMILIES = ["tinyllama-1.1b", "olmoe-1b-7b", "qwen2-moe-a2.7b", "mamba2-1.3b",
            "zamba2-1.2b", "qwen2-vl-7b", "musicgen-medium"]
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)
B, S = 4, 32


def perturb(tree, seed=7):
    """Redraw the leaves ``init_params`` leaves constant (norm weights and
    ``D`` all ones, QKV and conv biases and ``dt_bias`` all zeros)."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("ln1", "ln2", "ln_f", "norm_w", "'D'")):
            new = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif any(f"'{k}'" in name for k in ("bq", "bk", "bv", "conv_b",
                                            "dt_bias")):
            new = 0.05 * rng.standard_normal(leaf.shape)
        else:
            return leaf
        return jnp.asarray(new, leaf.dtype)

    return jax.tree_util.tree_map_with_path(redraw, tree)


def pair(arch, **changes):
    """(reference cfg, reference tree, port cfg, port Transformer on the
    CPU holding the same weights), float32 smoke configs."""
    cfg_r = replace(rconfigs.get_config(arch).smoke(), dtype="float32",
                    **changes)
    cfg = replace(configs.get_config(arch).smoke(), dtype="float32",
                  **changes)
    tree = perturb(rtrans.init_params(jax.random.PRNGKey(0), cfg_r))
    model = transformer.Transformer(cfg, device="meta")
    model.load_state_dict(params_from_reference(tree, cfg, "cpu"),
                          assign=True)
    return cfg_r, tree, cfg, model


def random_state(tree, seed, step=3, ef=False):
    """A numpy optimizer state in the reference's layout: random moments
    (``v`` positive) at ``step``, and with ``ef`` a random residual."""
    r = np.random.default_rng(seed)

    def draw(fn):
        return jax.tree.map(lambda p: fn(p.shape).astype(np.float32), tree)

    state = {"m": draw(lambda sh: 1e-3 * r.standard_normal(sh)),
             "v": draw(lambda sh: 1e-2 * (0.5 + r.random(sh))),
             "step": np.int32(step)}
    if ef:
        state["ef"] = draw(lambda sh: 1e-3 * r.standard_normal(sh))
    return state


def batch(cfg, seed, b=B, s=S):
    """Token ids and labels, and the frontend inputs of
    ``tests/test_arch_smoke.py::make_batch`` (vlm M-RoPE components that
    differ): the reference's batch and the port's."""
    r = np.random.default_rng(seed)
    arrays = {"inputs": r.integers(0, cfg.vocab_size, (b, s)),
              "labels": r.integers(0, cfg.vocab_size, (b, s))}
    arrays = {k: v.astype(np.int32) for k, v in arrays.items()}
    if cfg.frontend != "none":
        arrays["patches"] = r.standard_normal((b, 8, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        arrays["mrope_positions"] = np.stack([pos, pos // 2, pos % 5])
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def assert_tree_close(got, want, what, rtol=0.0, atol=0.0, outliers=0.0):
    """Every leaf of the port's reference-shaped tree ``got`` against the
    reference's ``want``, leaf for leaf in flatten order; with
    ``outliers``, that fraction of the tree's elements may lie outside the
    tolerance."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(leaves) == len(paths), what
    total = off = 0
    for (path, w), g in zip(paths, leaves):
        name = f"{what}{jax.tree_util.keystr(path)}"
        assert tuple(g.shape) == tuple(w.shape), name
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if not outliers:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=name)
        total += g.size
        off += int((~np.isclose(g, w, rtol=rtol, atol=atol)).sum())
    assert off <= outliers * total, (what, off, total)


def assert_step_matches(cfg_r, tree, cfg, model, state, *, microbatches=1,
                        accum="scan", seed=11):
    """One ``train_step`` in both packages from ``state`` (numpy, the
    reference's layout) at the module docstring's tolerances.  With an
    "ef" residual the int8 quantizer rounds (g + ef) / scale, and where
    that lies within the frameworks' rounding of a half, the two round
    apart by one quantization step: 1 in 10,000 elements may then lie
    outside the tolerances."""
    outliers = 1e-4 if "ef" in state else 0.0
    rb, tb = batch(cfg, seed)
    oc = radamw.OptConfig(**OPT)
    rp, ro, rm = jax.jit(lambda p, o, b: rstep.train_step(
        p, o, b, cfg=cfg_r, opt_cfg=oc, microbatches=microbatches,
        accum=accum))(tree, jax.tree.map(jnp.asarray, state), rb)
    opt = opt_state_from_reference(state, model, "cpu")
    params, new_opt, m = tstep.train_step(
        model, opt, tb, cfg=cfg, opt_cfg=adamw.OptConfig(**OPT),
        microbatches=microbatches, accum=accum)
    assert params is model
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
    assert_tree_close(params_to_reference(model), rp, "params", atol=1e-6,
                      outliers=outliers)
    got = opt_state_to_reference(new_opt, model)
    assert int(got["step"]) == int(ro["step"]) == int(state["step"]) + 1
    assert_tree_close(got["m"], ro["m"], "m", atol=1e-7, outliers=outliers)
    assert_tree_close(got["v"], ro["v"], "v", rtol=1e-5, outliers=outliers)
    if "ef" in state:
        assert_tree_close(got["ef"], ro["ef"], "ef", atol=1e-6,
                          outliers=outliers)
    return m


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,host,shape", [(0, 0, (8, 128)), (3, 1, (4, 33)),
                                             (7, 2, (2, 16))])
def test_token_pipeline_is_byte_identical(seed, host, shape):
    """Batches and metadata byte for byte, step after step, and again
    after a snapshot and restore."""
    vocab = 32000 if host == 0 else 256
    want = RPipeline(vocab, *shape, seed=seed, host_id=host, n_hosts=3)
    got = TokenPipeline(vocab, *shape, seed=seed, host_id=host, n_hosts=3)
    for step in range(4):
        if step == 2:
            snap = got.snapshot()
            assert snap == want.snapshot()
            got = TokenPipeline(vocab, *shape, seed=seed)
            got.restore(snap)
        (wb, wm), (gb, gm) = want.next_batch(), got.next_batch()
        for d_want, d_got in ((wb, gb), (wm, gm)):
            assert d_want.keys() == d_got.keys()
            for k in d_want:
                assert d_got[k].dtype == d_want[k].dtype, k
                assert d_got[k].tobytes() == d_want[k].tobytes(), (step, k)


# ---------------------------------------------------------------------------
# loss, schedule, optimizer, compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    r = np.random.default_rng(0)
    logits = (3 * r.standard_normal((3, 7, 19))).astype(np.float32)
    labels = r.integers(0, 19, (3, 7)).astype(np.int32)
    mask = (r.random((3, 7)) < 0.6).astype(np.int32) if masked else None
    want = rstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    got = tstep.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_of_an_empty_mask_is_zero():
    logits = torch.zeros((1, 4, 7))
    labels = torch.zeros((1, 4), dtype=torch.int32)
    mask = torch.zeros((1, 4), dtype=torch.int32)
    assert float(tstep.cross_entropy(logits, labels, mask)) == 0.0
    mask[0, :2] = 1
    np.testing.assert_allclose(float(tstep.cross_entropy(logits, labels,
                                                         mask)),
                               np.log(7), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    oc = dict(lr=0.7, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = radamw.lr_schedule(radamw.OptConfig(**oc), jnp.int32(step))
    got = adamw.lr_schedule(adamw.OptConfig(**oc),
                            torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.lr_schedule(adamw.OptConfig(**oc),
                                                       step)),
                               float(want), rtol=1e-6)


def leaves_np(seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((16, 8)).astype(dtype),
            "b": r.standard_normal((10,)).astype(dtype),
            "c": {"d": r.standard_normal((3, 5, 7)).astype(dtype)}}


@pytest.mark.parametrize("zero_pad", [1, 4])
@pytest.mark.parametrize("fresh", [True, False])
def test_apply_updates_matches_reference(zero_pad, fresh):
    """One AdamW step from one state on the same parameters and gradients:
    param-shaped and ZeRO-1 flat moments (padded to 4, the pad lanes
    staying zero), a fresh state and one at step 5."""
    oc = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=0.5)
    p_np, g_np = leaves_np(0), leaves_np(1)
    names = {"a": ("a",), "b": ("b",), "c.d": ("c", "d")}

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    r = np.random.default_rng(2)
    step = 0 if fresh else 5
    moments = {}
    for which, scale in (("m", 1e-2), ("v", 1e-2)):
        leaves = {}
        for n, path in names.items():
            x = at(p_np, path)
            x = (np.zeros_like(x) if fresh else scale * (
                r.random(x.shape) if which == "v"
                else r.standard_normal(x.shape))).astype(np.float32)
            if zero_pad > 1:  # flat, the pad lanes zeros
                x = np.pad(x.reshape(-1), (0, -x.size % zero_pad))
            leaves[n] = x
        moments[which] = leaves
    ref_state = {k: {"a": jnp.asarray(v["a"]), "b": jnp.asarray(v["b"]),
                     "c": {"d": jnp.asarray(v["c.d"])}}
                 for k, v in moments.items()}
    ref_state["step"] = jnp.int32(step)
    state = {k: {n: torch.from_numpy(x.copy()) for n, x in v.items()}
             for k, v in moments.items()}
    state["step"] = torch.tensor(step, dtype=torch.int32)
    fresh_state = adamw.init_opt_state(
        {n: torch.from_numpy(at(p_np, path)) for n, path in names.items()},
        zero_pad=zero_pad)
    for k in ("m", "v"):
        assert {n: x.shape for n, x in fresh_state[k].items()} == {
            n: x.shape for n, x in state[k].items()}
    if zero_pad > 1:
        assert state["m"]["b"].shape == (12,)
    rp, ro, rm = radamw.apply_updates(
        radamw.OptConfig(**oc), jax.tree.map(jnp.asarray, p_np),
        jax.tree.map(jnp.asarray, g_np), ref_state)
    params = {n: torch.from_numpy(at(p_np, path).copy())
              for n, path in names.items()}
    out, new, m = adamw.apply_updates(
        adamw.OptConfig(**oc), params,
        {n: torch.from_numpy(at(g_np, path)) for n, path in names.items()},
        state)
    assert out is params
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
    assert int(new["step"]) == int(ro["step"]) == step + 1
    for k, path in names.items():
        np.testing.assert_allclose(params[k].numpy(), at(rp, path),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(new["m"][k].numpy(), at(ro["m"], path),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(new["v"][k].numpy(), at(ro["v"], path),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    if zero_pad > 1:
        assert not new["m"]["b"][10:].any() and not new["v"]["b"][10:].any()
        assert not new["m"]["c.d"][105:].any()


def test_apply_updates_passes_extra_keys_and_keeps_types():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init_opt_state(p, error_feedback=True)
    marker = state["ef"]
    _, new, _ = adamw.apply_updates(adamw.OptConfig(), p,
                                    {"w": torch.ones(4, dtype=torch.bfloat16)},
                                    state)
    assert new["ef"] is marker
    assert p["w"].dtype == torch.bfloat16 and new["m"]["w"].dtype == \
        torch.float32
    assert new["step"].dtype == torch.int32 and int(new["step"]) == 1


def test_global_norm_matches_reference():
    tree = leaves_np(3)
    want = radamw.global_norm(jax.tree.map(jnp.asarray, tree))
    got = adamw.global_norm({"a": torch.from_numpy(tree["a"]),
                             "c": {"d": torch.from_numpy(tree["c"]["d"])},
                             "b": torch.from_numpy(tree["b"])})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_compress_grads_matches_reference():
    """Quantize-dequantize and the new residual, bit for bit, with values
    at exact halves of a step (round half to even) and an all-zero
    tensor (the 1e-30 scale floor)."""
    r = np.random.default_rng(4)
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5, -127.0],
                      np.float32)
    grads = {"w": r.standard_normal((32, 16)).astype(np.float32),
             "z": np.zeros((5,), np.float32),
             "h": {"x": halves}}
    ef = {"w": (0.01 * r.standard_normal((32, 16))).astype(np.float32),
          "z": np.zeros((5,), np.float32),
          "h": {"x": np.zeros(8, np.float32)}}
    wq, wef = rcompress.compress_grads(jax.tree.map(jnp.asarray, grads),
                                       jax.tree.map(jnp.asarray, ef))
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)
    gq, gef = compress.compress_grads(to_t(grads), to_t(ef))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(wq)[0],
                            tree_leaves(gq)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))
    for w, g in zip(jax.tree.leaves(wef), tree_leaves(gef)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(gq["h"]["x"].numpy(),
                                  [127, 0, 2, 2, 0, -4, 126, -127])


def test_error_feedback_corrects_bias():
    """tests/test_compress.py's bound on the port: the sum of compressed
    grads tracks the sum of true grads to within the residual."""
    r = np.random.default_rng(1)
    true_sum = np.zeros(32)
    comp_sum = np.zeros(32)
    ef = compress.init_error_feedback({"w": torch.zeros(32)})
    for _ in range(200):
        g = {"w": torch.from_numpy((r.standard_normal(32) * 0.01).astype(
            np.float32))}
        gq, ef = compress.compress_grads(g, ef)
        true_sum += g["w"].numpy()
        comp_sum += gq["w"].numpy()
    resid = np.abs(true_sum - comp_sum).max()
    assert resid <= float(ef["w"].abs().max()) + 1e-5
    assert resid < 0.01


def test_wire_bytes_matches_reference():
    shapes = {"a": (1024, 1024), "b": (512,), "c": {"d": (3, 7)}}
    ref = jax.tree.map(jnp.zeros, shapes,
                       is_leaf=lambda x: isinstance(x, tuple))
    port = {"a": torch.zeros(1024, 1024), "b": torch.zeros(512),
            "c": {"d": torch.zeros(3, 7)}}
    for comp in (False, True):
        assert compress.wire_bytes(port, comp) == rcompress.wire_bytes(ref,
                                                                       comp)
    assert compress.wire_bytes(port, False) / compress.wire_bytes(port,
                                                                  True) > 3.9


def test_init_error_feedback_of_a_model():
    model = transformer.init_params(
        configs.get_config("tinyllama-1.1b").smoke(), device="cpu")
    ef = compress.init_error_feedback(model)
    assert set(ef) == set(model.state_dict())
    assert all(t.dtype == torch.float32 and not t.any() for t in ef.values())


# ---------------------------------------------------------------------------
# train_step / eval_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    cfg_r, tree, cfg, model = pair(arch)
    m = assert_step_matches(cfg_r, tree, cfg, model, random_state(tree, 1))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("accum", ["scan", "unroll"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "qwen2-vl-7b"])
def test_train_step_microbatches_match_reference(arch, accum):
    """Four microbatches (vlm: mrope_positions (3, B, S) cut along
    dimension 1)."""
    cfg_r, tree, cfg, model = pair(arch)
    assert_step_matches(cfg_r, tree, cfg, model, random_state(tree, 2),
                        microbatches=4, accum=accum)


def test_microbatch_accumulation_types():
    """bfloat16 grads: "unroll" adds them in bfloat16, "scan" in float32
    (the reference's numerics); both divide after the sum."""
    cfg = replace(configs.get_config("tinyllama-1.1b").smoke(),
                  dtype="bfloat16")
    model = transformer.init_params(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(1))
    _, tb = batch(cfg, 5)
    seen = {}
    real = tstep.apply_updates

    def spy(opt_cfg, params, grads, state):
        seen["grads"] = grads
        return real(opt_cfg, params, grads, state)

    tstep.apply_updates = spy
    try:
        for accum in ("unroll", "scan"):
            tstep.train_step(model, adamw.init_opt_state(model), tb, cfg=cfg,
                             opt_cfg=adamw.OptConfig(lr=0.0),
                             microbatches=4, accum=accum)
            dtypes = {g.dtype for g in seen["grads"].values()}
            assert dtypes == ({torch.bfloat16} if accum == "unroll"
                              else {torch.float32}), accum
    finally:
        tstep.apply_updates = real


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_train_step_with_error_feedback_matches_reference(arch):
    cfg_r, tree, cfg, model = pair(arch)
    assert_step_matches(cfg_r, tree, cfg, model,
                        random_state(tree, 3, ef=True))


def test_train_step_rejects_grad_shardings():
    _, _, cfg, model = pair("tinyllama-1.1b")
    _, tb = batch(cfg, 1)
    with pytest.raises(ValueError, match="one card"):
        tstep.train_step(model, adamw.init_opt_state(model), tb, cfg=cfg,
                         opt_cfg=adamw.OptConfig(), grad_shardings={})


@pytest.mark.parametrize("arch", FAMILIES)
def test_eval_step_matches_reference(arch):
    cfg_r, tree, cfg, model = pair(arch)
    rb, tb = batch(cfg, 6)
    rb["mask"] = jnp.asarray(np.arange(S)[None, :] % 3 != 0).repeat(B, 0)
    tb["mask"] = torch.from_numpy(np.array(rb["mask"]))
    want = rstep.eval_step(tree, rb, cfg=cfg_r)
    got = tstep.eval_step(model, tb, cfg=cfg)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert not got["loss"].requires_grad


def test_unused_parameters_get_zero_grads():
    """An embedding-input frontend (vlm, audio fed (b, s, d) embeddings)
    leaves ``embed`` unread: ``jax.grad`` gives it zeros, and so does the
    port, so the update still decays it."""
    cfg_r, tree, cfg, model = pair("musicgen-medium")
    r = np.random.default_rng(8)
    emb = r.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    labels = r.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    state = random_state(tree, 4)
    rp, _, _ = jax.jit(lambda p, o, b: rstep.train_step(
        p, o, b, cfg=cfg_r, opt_cfg=radamw.OptConfig(**OPT)))(
        tree, jax.tree.map(jnp.asarray, state),
        {"inputs": jnp.asarray(emb), "labels": jnp.asarray(labels)})
    tstep.train_step(model, opt_state_from_reference(state, model, "cpu"),
                     {"inputs": torch.from_numpy(emb),
                      "labels": torch.from_numpy(labels)},
                     cfg=cfg, opt_cfg=adamw.OptConfig(**OPT))
    np.testing.assert_allclose(model.embed.detach().numpy(),
                               np.asarray(rp["embed"]), atol=1e-6)
    assert not np.array_equal(np.asarray(rp["embed"]),
                              np.asarray(tree["embed"]))


def test_four_step_loop_matches_reference():
    """TokenPipeline -> train_step for four steps in both packages from
    fresh states, as the launchers run them (remat on, lr 3e-3 after a
    two-step warm-up): losses at rtol 1e-5; parameters within 2 lr, all
    but 1 in 1,000 at 1e-6 (the module docstring's fresh-state rule; the
    first step's sign flips feed the next three steps' forward)."""
    cfg_r, tree, cfg, model = pair("tinyllama-1.1b")
    oc = dict(lr=3e-3, total_steps=10, warmup_steps=2)
    ref_step = jax.jit(lambda p, o, b: rstep.train_step(
        p, o, b, cfg=cfg_r, opt_cfg=radamw.OptConfig(**oc)))
    ref_opt = radamw.init_opt_state(tree)
    opt = adamw.init_opt_state(model)
    want_pipe = RPipeline(cfg.vocab_size, 4, 32, seed=3)
    pipe = TokenPipeline(cfg.vocab_size, 4, 32, seed=3)
    for step in range(4):
        (wb, _), (gb, _) = want_pipe.next_batch(), pipe.next_batch()
        tree, ref_opt, rm = ref_step(
            tree, ref_opt, {k: jnp.asarray(v) for k, v in wb.items()})
        model, opt, m = tstep.train_step(
            model, opt, {k: torch.from_numpy(v) for k, v in gb.items()},
            cfg=cfg, opt_cfg=adamw.OptConfig(**oc))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step}")
    assert float(m["loss"]) < 0.95 * 6.1  # it learns
    total = off = 0
    for w, g in zip(jax.tree.leaves(tree),
                    tree_leaves(params_to_reference(model))):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert diff.max() <= 2 * oc["lr"]
        total += diff.size
        off += int((diff > 1e-6).sum())
    assert off <= total // 1_000, (off, total)


# ---------------------------------------------------------------------------
# remat and backward through every family
# ---------------------------------------------------------------------------


def grads_of(model, cfg, tb):
    model.zero_grad(set_to_none=True)
    total, _ = tstep.loss_fn(model, cfg, tb)
    total.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


class CountProducts(TorchDispatchMode):
    """Counts the 2-D matrix products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def backward_products(model, cfg, tb):
    """How many matrix products the backward pass runs (the gradients'
    own, plus any a remat recomputes)."""
    total, _ = tstep.loss_fn(model, cfg, tb)
    with CountProducts() as count:
        total.backward()
    model.zero_grad(set_to_none=True)
    return count.n


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_grads(arch):
    """Remat off, "full" and "dots" give identical grads; "full" reruns the
    blocks' matrix products in the backward pass, "dots" keeps their
    outputs and reruns none of them."""
    _, _, cfg, model = pair(arch, remat=False)
    _, tb = batch(cfg, 9)
    want = grads_of(model, cfg, tb)
    products = {"off": backward_products(model, cfg, tb)}
    for policy in ("full", "dots"):
        on = replace(cfg, remat=True, remat_policy=policy)
        got = grads_of(model, on, tb)
        assert got.keys() == want.keys()
        for n in want:
            assert torch.equal(got[n], want[n]), (policy, n)
        products[policy] = backward_products(model, on, tb)
    assert products["dots"] == products["off"] < products["full"], products


def test_remat_only_with_autograd():
    """Under ``torch.no_grad()`` (serving) the blocks run plainly."""
    _, _, cfg, model = pair("tinyllama-1.1b")
    assert cfg.remat
    _, tb = batch(cfg, 9)
    with torch.no_grad():
        want, _ = transformer.forward(model, replace(cfg, remat=False),
                                      tb["inputs"])
        with CountProducts() as count:
            got, _ = transformer.forward(model, cfg, tb["inputs"])
    assert torch.equal(got, want)
    assert count.n == 2 * 7 + 1  # per layer q, k, v, o and three FFN; head


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_parameter_gets_a_gradient(arch):
    """Backward through the MoE router's top-k and scatter, the Mamba2
    chunk padding (a 20-token sequence, chunk 16) and the hybrid's shared
    block, whose gradient sums over its slots."""
    _, _, cfg, model = pair(arch, remat=False)
    _, tb = batch(cfg, 10, s=20 if cfg.family in ("ssm", "hybrid") else S)
    grads = grads_of(model, cfg, tb)
    for n, p in model.named_parameters():
        if n == "embed" and cfg.frontend != "none":
            continue  # the patch rows replace some token rows only
        assert n in grads and torch.isfinite(grads[n]).all(), n
        if cfg.family != "moe" or "router" not in n:
            assert grads[n].abs().sum() > 0, n


def test_shared_block_gradient_sums_over_its_slots():
    """zamba2 smoke at 4 layers applies the shared block twice; its
    gradient is the sum of what each application contributes, which the
    reference's jax.grad gives too."""
    cfg_r, tree, cfg, model = pair("zamba2-1.2b", n_layers=4)
    assert transformer.n_shared_slots(cfg) == 2
    rb, tb = batch(cfg, 12, s=16)
    want = jax.jit(jax.grad(lambda p: rstep.loss_fn(p, cfg_r, rb)[0]))(tree)
    got = grads_of(model, cfg, tb)
    for name in ("attn.wq", "ffn.w_down", "ln1"):
        keys = name.split(".")
        w = want["shared_attn"]
        for k in keys:
            w = w[k]
        np.testing.assert_allclose(got[f"shared_attn.{name}"].numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_ssd_gradient_is_finite_where_the_decay_overflows():
    """A long chunk whose i < j decays overflow in float32: the masked
    entries' exp would be inf, and 0 * inf a NaN gradient; the port masks
    before the exp."""
    from repro_torch.models import ssm

    r = np.random.default_rng(13)
    b, s, h, p, g, N = 1, 64, 2, 4, 1, 8
    x = torch.from_numpy(r.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.full((b, s, h), 3.0, requires_grad=True)
    A = torch.tensor([-1.0, -2.0])
    Bm = torch.from_numpy(r.standard_normal((b, s, g, N)).astype(np.float32))
    C = torch.from_numpy(r.standard_normal((b, s, g, N)).astype(np.float32))
    y, _ = ssm.ssd_chunked(x, dt, A, Bm, C, torch.ones(h), chunk=64)
    y.sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(dt.grad).all()
