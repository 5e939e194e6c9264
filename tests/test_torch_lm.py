"""The port's LM stack against the reference's on the CPU, every family.

``repro_torch.configs``, ``models.{common,attention,moe,ssm,transformer}``,
``serve.prefill`` and ``train.step`` run beside ``repro.configs``,
``repro.models``, ``repro.serve.prefill`` and ``repro.train.step`` on the
same inputs (made with numpy from fixed seeds) and the same weights: the
reference's ``init_params`` tree, with the leaves it leaves constant (norm
weights, QKV biases, the Mamba2 mixer's ``conv_b``, ``D``, ``dt_bias``
and ``norm_w``) redrawn from a seed, carried across by
``convert.params_from_reference``.  Each model test runs the ``.smoke()``
config of every family: dense (tinyllama-1.1b, and qwen2-7b with
``qkv_bias``), moe (olmoe-1b-7b; qwen2-moe-a2.7b with shared experts),
ssm (mamba2-1.3b), hybrid (zamba2-1.2b: one shared-block slot), vlm
(qwen2-vl-7b: patches and M-RoPE positions) and audio (musicgen-medium:
patches and sinusoidal positions), in float32 at ``rtol = atol = 2e-3``
(``test_prefill.py``'s tolerance) and in bfloat16 at 0.15 (the
reference's own bf16 tests'): bfloat16 rounds at other places in the two
frameworks, about one unit in the last place (0.03 at the logits'
magnitude of 4).  In bfloat16 such a unit ahead of an MoE router can flip
a near tie of the top k, and the flipped token's logits then move by more
than 0.15 (olmoe's bf16 forward has one such token of 24): bf16 MoE
logits are held row by row, at most one row in eight off (none of fewer
than eight rows), and the aux loss at 1e-2.  In float32 the greedy
tokens are identical and every row and the aux agree.  ssm and hybrid
prompts are 16 tokens (the reference's ``ssd_chunked`` takes multiples of
the smoke chunk, 16); the port's padding of other lengths is held against
the decode loop.  Full configs are counted on the ``meta`` device, so a
14B config allocates nothing.
"""

from dataclasses import asdict, replace
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro.models import transformer as rtrans
from repro.serve.prefill import prefill_with_cache as rprefill
from repro.train.step import prefill_step as rprefill_step
from repro.train.step import serve_step as rserve_step
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import attention, common, transformer
from repro_torch.serve.prefill import prefill_with_cache
from repro_torch.train.step import prefill_step, serve_step

ARCHS = ["tinyllama-1.1b", "qwen2-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b",
         "mamba2-1.3b", "zamba2-1.2b", "qwen2-vl-7b", "musicgen-medium"]
# dtype -> (jnp type, torch type, rtol = atol)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.15)}
CASES = [(a, d) for a in ARCHS for d in DTYPES]
# the families whose layers hold an attention mixer
ATTN_CASES = [(a, d) for a, d in CASES
              if configs.get_config(a).family not in ("ssm", "hybrid")]


def jx(a, dtype):
    return jnp.asarray(a, DTYPES[dtype][0])


def tx(a, dtype):
    return torch.from_numpy(np.array(a)).to(DTYPES[dtype][1])


def close(got, want, dtype, what="", cfg=None):
    tol = DTYPES[dtype][2]
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if cfg is not None and cfg.family == "moe" and dtype == "bfloat16":
        # a flipped route moves its token's row alone (module docstring)
        rows_off = ~np.isclose(got, want, rtol=tol, atol=tol).reshape(
            -1, got.shape[-1]).all(-1)
        assert rows_off.sum() <= len(rows_off) // 8, (
            f"{what}: {rows_off.sum()} of {len(rows_off)} rows differ")
        return
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def perturb(tree, seed=7):
    """Redraw the leaves ``init_params`` leaves constant (norm weights and
    ``D`` all ones, QKV and conv biases and ``dt_bias`` all zeros), so
    that they are exercised."""
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


@lru_cache(maxsize=None)
def models(arch, dtype):
    """(reference cfg, reference tree, port cfg, port Transformer on the
    CPU holding the same weights)."""
    cfg_r = replace(rconfigs.get_config(arch).smoke(), dtype=dtype)
    cfg = replace(configs.get_config(arch).smoke(), dtype=dtype)
    tree = perturb(rtrans.init_params(jax.random.PRNGKey(0), cfg_r))
    model = transformer.Transformer(cfg, device="meta")
    model.load_state_dict(params_from_reference(tree, cfg, "cpu"),
                          assign=True)
    return cfg_r, tree, cfg, model


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def prompt_len(cfg):
    """12 tokens, or the smoke chunk (16) for the ssm families, whose
    reference ``ssd_chunked`` takes whole chunks."""
    return 16 if cfg.family in ("ssm", "hybrid") else 12


def frontends(cfg, b, s, seed):
    """``tests/test_arch_smoke.py::make_batch``'s frontend inputs, drawn
    with numpy: 8 patch / frame embeddings for vlm and audio, and for vlm
    M-RoPE positions whose three components differ.  Returns the
    reference's keyword arguments and the port's."""
    r = np.random.default_rng(seed)
    kw = {}
    if cfg.frontend != "none":
        kw["patches"] = r.standard_normal((b, 8, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        kw["mrope_positions"] = np.stack([pos, pos // 2, pos % 5])
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in kw.items()})




# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_list_archs_matches_reference():
    assert configs.list_archs() == rconfigs.list_archs()


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_config_and_smoke_match_reference(arch):
    assert asdict(configs.get_config(arch)) == asdict(
        rconfigs.get_config(arch))
    assert asdict(configs.get_config(arch).smoke()) == asdict(
        rconfigs.get_config(arch).smoke())
    assert (configs.get_config(arch).padded_vocab
            == rconfigs.get_config(arch).padded_vocab)


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_full_config_n_params_matches_reference(arch):
    ref_tree = jax.eval_shape(lambda: rtrans.init_params(
        jax.random.PRNGKey(0), rconfigs.get_config(arch)))
    model = transformer.Transformer(configs.get_config(arch), device="meta")
    assert transformer.n_params(model) == rtrans.n_params(ref_tree)
    if arch == "tinyllama-1.1b":
        assert transformer.n_params(model) == 1_100_048_384
    # every leaf of the tree has its counterpart, shape for shape
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        keys = [k.key for k in path]
        dt = str(leaf.dtype)
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                want[".".join(["layers", str(i), *keys[1:]])] = (
                    leaf.shape[1:], dt)
        else:
            want[".".join(keys)] = (leaf.shape, dt)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in model.state_dict().items()} == want


def test_default_device_is_the_card():
    """No fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = configs.get_config("tinyllama-1.1b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_decode_cache(cfg, 1, 8)


NAMES = {
    "qwen2-7b": {"embed", "ln_f", "lm_head", "layers.1.mixer.bq",
                 "layers.0.ffn.w_down", "layers.1.ln2"},
    "qwen2-moe-a2.7b": {"layers.1.ffn.router", "layers.0.ffn.w_gate",
                        "layers.1.ffn.shared.w_down"},
    "mamba2-1.3b": {"layers.0.mixer.A_log", "layers.1.mixer.conv_w",
                    "layers.1.mixer.dt_bias", "embed", "ln_f"},
    "zamba2-1.2b": {"shared_attn.attn.wq", "shared_attn.ffn.w_up",
                    "shared_attn.ln2", "layers.1.mixer.w_in", "lm_head"},
}


@pytest.mark.parametrize("arch", NAMES)
def test_state_dict_names_mirror_the_reference_tree(arch):
    cfg_r, tree, cfg, model = models(arch, "bfloat16")
    names = set(model.state_dict())
    assert names == set(params_from_reference(tree, cfg, "cpu"))
    assert NAMES[arch] <= names
    if cfg.n_heads:  # (in, out) layout
        mixer = (model.shared_attn.attn if cfg.family == "hybrid"
                 else model.layers[0].mixer)
        assert tuple(mixer.wq.shape) == (cfg.d_model, cfg.n_heads * 32)
    # a cast keeps the router and the mixer's A_log, D, dt_bias float32
    for name, t in params_from_reference(tree, cfg, "cpu",
                                         torch.bfloat16).items():
        keep = name.rsplit(".", 1)[-1] in ("router", "A_log", "D",
                                           "dt_bias")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), name


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    r = np.random.default_rng(1)
    x = 3.0 * r.standard_normal((2, 5, 128))
    w = 1.0 + 0.1 * r.standard_normal(128)
    close(common.rms_norm(tx(x, dtype), tx(w, dtype)),
          rcommon.rms_norm(jx(x, dtype), jx(w, dtype)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(dtype, theta):
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 37, 4, 32))
    pos = r.integers(0, 4000, (2, 37)).astype(np.int32)
    close(common.apply_rope(tx(x, dtype), torch.from_numpy(pos), theta),
          rcommon.apply_rope(jx(x, dtype), jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 7, 128))
    ws = [r.standard_normal(s) / np.sqrt(s[0])
          for s in ((128, 256), (128, 256), (256, 128))]
    close(common.swiglu(tx(x, dtype), *(tx(w, dtype) for w in ws)),
          rcommon.swiglu(jx(x, dtype), *(jx(w, dtype) for w in ws)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((4, 6, 6), 32)])
def test_apply_mrope(dtype, sections, hd):
    r = np.random.default_rng(13)
    x = r.standard_normal((2, 19, 3, hd))
    pos = r.integers(0, 4000, (3, 2, 19)).astype(np.int32)
    close(common.apply_mrope(tx(x, dtype), torch.from_numpy(pos), sections,
                             1e6),
          rcommon.apply_mrope(jx(x, dtype), jnp.asarray(pos), sections, 1e6),
          dtype)
    # equal components rotate as RoPE does
    same = np.broadcast_to(pos[0], pos.shape).copy()
    close(common.apply_mrope(tx(x, dtype), torch.from_numpy(same), sections),
          rcommon.apply_rope(jx(x, dtype), jnp.asarray(pos[0])), dtype)


@pytest.mark.parametrize("d", [128, 1536])
def test_sinusoid(d):
    pos = np.random.default_rng(14).integers(0, 2048, (2, 33)).astype(
        np.int32)
    np.testing.assert_allclose(
        transformer._sinusoid(torch.from_numpy(pos), d).numpy(),
        np.asarray(rtrans._sinusoid(jnp.asarray(pos), d)),
        rtol=2e-3, atol=2e-3)


def test_causal_mask():
    for args in [(5, 5, 0, None), (3, 9, 6, None), (6, 6, 0, 2)]:
        np.testing.assert_array_equal(
            common.causal_mask(*args).numpy(),
            np.asarray(rcommon.causal_mask(*args)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def layer0(arch, dtype, **cfg_changes):
    cfg_r, tree, cfg, model = models(arch, dtype)
    p_r = jax.tree.map(lambda a: a[0], tree["layers"]["mixer"])
    return (replace(cfg_r, **cfg_changes), p_r, replace(cfg, **cfg_changes),
            model.layers[0].mixer)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("arch,dtype", ATTN_CASES)
def test_attention_dense(arch, dtype, window):
    cfg_r, p_r, cfg, p = layer0(arch, dtype, sliding_window=window)
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 16, cfg.d_model))
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    kw_r, kw = frontends(cfg, 2, 16, 17)
    want, wk, wv = rattn.attention(p_r, cfg_r, jx(x, dtype), jnp.asarray(pos),
                                   kw_r.get("mrope_positions"),
                                   return_kv=True)
    with torch.no_grad():
        got, k, v = attention.attention(p, cfg, tx(x, dtype),
                                        torch.from_numpy(pos.copy()),
                                        kw.get("mrope_positions"),
                                        return_kv=True)
    close(got, want, dtype, "out")
    close(k, wk, dtype, "k")
    close(v, wv, dtype, "v")


@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_blockwise(dtype, window):
    """s = 2048 takes the blockwise path (s > 1024): 4 query blocks of
    512 against 2 key blocks of 1024, with the causal skip."""
    cfg_r, p_r, cfg, p = layer0("tinyllama-1.1b", dtype,
                                sliding_window=window)
    r = np.random.default_rng(5)
    x = r.standard_normal((1, 2048, cfg.d_model))
    pos = np.arange(2048, dtype=np.int32)[None]
    want = rattn.attention(p_r, cfg_r, jx(x, dtype), jnp.asarray(pos))
    with torch.no_grad():
        got = attention.attention(p, cfg, tx(x, dtype),
                                  torch.from_numpy(pos.copy()))
    close(got, want, dtype)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("arch,dtype", ATTN_CASES)
def test_decode_attention(arch, dtype, window):
    cfg_r, p_r, cfg, p = layer0(arch, dtype, sliding_window=window)
    r = np.random.default_rng(6)
    S, cache_len = 24, 13
    x = r.standard_normal((2, 1, cfg.d_model))
    ck = r.standard_normal((2, S, cfg.n_kv_heads, cfg.head_dim))
    cv = r.standard_normal((2, S, cfg.n_kv_heads, cfg.head_dim))
    # vlm: M-RoPE positions, which decode replaces by cache_len
    kw_r, kw = frontends(cfg, 2, 1, 18)
    want, wck, wcv = rattn.decode_attention(
        p_r, cfg_r, jx(x, dtype), jx(ck, dtype), jx(cv, dtype),
        jnp.int32(cache_len), kw_r.get("mrope_positions"))
    gck, gcv = tx(ck, dtype), tx(cv, dtype)
    with torch.no_grad():
        got, gck2, gcv2 = attention.decode_attention(
            p, cfg, tx(x, dtype), gck, gcv, cache_len,
            kw.get("mrope_positions"))
    assert gck2 is gck and gcv2 is gcv  # written in place
    close(got, want, dtype, "out")
    close(gck, wck, dtype, "cache k")
    close(gcv, wcv, dtype, "cache v")


def test_decode_attention_rejects_a_full_cache():
    _, _, cfg, p = layer0("tinyllama-1.1b", "float32")
    ck = torch.zeros(1, 4, cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="cache_len 4"):
        attention.decode_attention(p, cfg, torch.zeros(1, 1, cfg.d_model),
                                   ck, ck.clone(), 4)


# ---------------------------------------------------------------------------
# transformer, prefill, serve_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward(arch, dtype):
    cfg_r, tree, cfg, model = models(arch, dtype)
    s = prompt_len(cfg)
    toks = tokens(cfg, (2, s), 8)
    kw_r, kw = frontends(cfg, 2, s, 15)
    want, want_aux = rtrans.forward(tree, cfg_r, jnp.asarray(toks), **kw_r)
    with torch.no_grad():
        got, aux = transformer.forward(model, cfg, torch.from_numpy(toks),
                                       **kw)
        got_m, _ = model(torch.from_numpy(toks), **kw)
    assert got.shape == (2, s, cfg.padded_vocab) and got.dtype == DTYPES[
        dtype][1]
    if cfg.family == "moe":
        assert float(aux) > 0.0
        np.testing.assert_allclose(
            float(aux), float(want_aux),
            rtol=DTYPES[dtype][2] if dtype == "float32" else 1e-2)
    else:
        assert float(aux) == 0.0
    close(got, want, dtype, "logits", cfg)
    assert torch.equal(got, got_m)
    close(prefill_step(model, {"inputs": torch.from_numpy(toks), **kw},
                       cfg=cfg),
          rprefill_step(tree, {"inputs": jnp.asarray(toks), **kw_r},
                        cfg=cfg_r),
          dtype, "prefill_step", cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_cache(arch):
    cfg = configs.get_config(arch).smoke()
    got = transformer.init_decode_cache(cfg, 3, 40, device="cpu")
    want = rtrans.init_decode_cache(rconfigs.get_config(arch).smoke(), 3, 40)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
        assert not got[k].any()
    assert transformer.n_shared_slots(cfg) == rtrans.n_shared_slots(
        rconfigs.get_config(arch).smoke())


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_segments_match_reference(arch):
    for cfg, cfg_r in ((configs.get_config(arch), rconfigs.get_config(arch)),
                       (configs.get_config(arch).smoke(),
                        rconfigs.get_config(arch).smoke())):
        assert transformer._segments(cfg) == rtrans._segments(cfg_r)
    if arch == "zamba2-1.2b":  # six shared slots over 38 layers
        assert transformer.n_shared_slots(configs.get_config(arch)) == 6


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_with_cache_and_decode_step(arch, dtype):
    cfg_r, tree, cfg, model = models(arch, dtype)
    s = prompt_len(cfg)
    toks = tokens(cfg, (2, s), 9)
    kw_r, kw = frontends(cfg, 2, s, 16)
    max_len = 24
    want, wcache = rprefill(tree, cfg_r, jnp.asarray(toks), max_len, **kw_r)
    got, cache = prefill_with_cache(model, cfg, torch.from_numpy(toks),
                                    max_len, **kw)
    close(got, want, dtype, "prefill logits", cfg)
    assert set(cache) == set(wcache)
    for k in wcache:
        assert cache[k].shape == wcache[k].shape
        close(cache[k], wcache[k], dtype, f"prefill cache {k}", cfg)
        if k in ("k", "v"):
            assert not cache[k][:, :, s:].any()
    # one decode step from the reference's own next token
    nxt = np.array(jnp.argmax(want, -1)[:, None].astype(jnp.int32))
    want_d, wcache = rtrans.decode_step(tree, cfg_r, jnp.asarray(nxt),
                                        wcache, jnp.int32(s))
    got_d, cache = transformer.decode_step(model, cfg, torch.from_numpy(nxt),
                                           cache, s)
    close(got_d, want_d, dtype, "decode logits", cfg)
    for k in wcache:
        close(cache[k], wcache[k], dtype, f"decode cache {k}", cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_greedy_tokens_identical_in_float32(arch):
    cfg_r, tree, cfg, model = models(arch, "float32")
    s = 16 if cfg.family in ("ssm", "hybrid") else 10
    toks = tokens(cfg, (3, s), 10)
    logits_r, cache_r = rprefill(tree, cfg_r, jnp.asarray(toks), 24)
    logits, cache = prefill_with_cache(model, cfg, torch.from_numpy(toks), 24)
    tok_r = jnp.argmax(logits_r, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    want, got = [np.asarray(tok_r)], [tok.numpy()]
    for t in range(s, s + 6):
        tok_r, cache_r = rserve_step(tree, tok_r, cache_r, jnp.int32(t),
                                     cfg=cfg_r)
        tok, cache = serve_step(model, tok, cache, t, cfg=cfg)
        assert tok.dtype == torch.int32 and tok.shape == (3, 1)
        want.append(np.asarray(tok_r))
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_serve_step_samples_from_its_generator():
    _, _, cfg, model = models("tinyllama-1.1b", "float32")
    toks = torch.from_numpy(tokens(cfg, (4, 6), 11))
    draws = []
    for _ in range(2):
        _, cache = prefill_with_cache(model, cfg, toks, 12)
        gen = torch.Generator().manual_seed(3)
        tok, _ = serve_step(model, toks[:, -1:], cache, 6, cfg=cfg,
                            temperature=0.8, generator=gen)
        assert tok.shape == (4, 1) and tok.dtype == torch.int32
        assert ((0 <= tok) & (tok < cfg.padded_vocab)).all()
        draws.append(tok)
    assert torch.equal(*draws)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode_loop(arch):
    """test_prefill.py's check on the port: the fused prefill equals a
    token-by-token decode of the same prompt (with capacity factor 8, so
    that no MoE token drops, as there).  12 tokens: the ssm families'
    prefill pads them to the chunk of 16.  The audio family's
    ``decode_step``, like the reference's, adds no sinusoidal position:
    its loop is fed the embeddings with the positions added, and on token
    ids it parts from the prefill as the reference's does."""
    cfg_r, tree, cfg, model = models(arch, "float32")
    cfg = replace(cfg, moe_capacity_factor=8.0)
    toks = torch.from_numpy(tokens(cfg, (2, 12), 12))
    logits_p, cache_p = prefill_with_cache(model, cfg, toks, 24)

    def decode_loop(inputs):
        cache = transformer.init_decode_cache(cfg, 2, 24, dtype=torch.float32,
                                              device="cpu")
        for t in range(12):
            logits, cache = transformer.decode_step(
                model, cfg, inputs[:, t:t + 1], cache, t)
        return logits, cache

    if cfg.family == "audio":
        ids_logits, _ = decode_loop(toks)
        assert not torch.allclose(logits_p, ids_logits, rtol=2e-3, atol=2e-3)
        cache_r = rtrans.init_decode_cache(replace(cfg_r, dtype="float32"),
                                           2, 24)
        for t in range(12):
            want, cache_r = rtrans.decode_step(
                tree, cfg_r, jnp.asarray(toks[:, t:t + 1].numpy()), cache_r,
                jnp.int32(t))
        close(ids_logits, want, "float32", "decode on ids, no positions")
        pos = torch.arange(12, dtype=torch.int32).expand(2, 12)
        logits_d, cache = decode_loop(
            model.embed[toks.long()] + transformer._sinusoid(pos, cfg.d_model))
    else:
        logits_d, cache = decode_loop(toks)
    torch.testing.assert_close(logits_p, logits_d, rtol=2e-3, atol=2e-3)
    for k in cache:
        torch.testing.assert_close(cache_p[k], cache[k], rtol=2e-3,
                                   atol=2e-3, msg=k)
