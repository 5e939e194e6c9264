"""The port's pytree checkpoints, tree converters and training launcher on
the CPU, against the reference.

* ``repro_torch.dist.checkpoint`` runs the reference's own checkpoint cases
  (``tests/test_checkpoint.py``) on trees of tensors;
* a step written by either package restores in the other with identical
  leaves, bfloat16 included, for the full ``{"params", "opt"}`` state of a
  smoke model, and the two packages write the same bytes;
* ``convert.params_to_reference`` and ``opt_state_to_reference`` invert
  ``params_from_reference`` and ``opt_state_from_reference`` (every
  config's parameters; the moments of each family), and refuse ZeRO-1
  flat moments;
* ``repro_torch.launch.train`` at smoke size with ``--device cpu``:
  checkpoints, a resume that continues the run bit for bit, a restart of a
  finished run, a corrupted newest step, a simulated crash (exit code 42),
  and the closing curation query against the reference's
  ``MetadataIndex`` fed the same metadata.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data.metadata_index import MetadataIndex as RMetadataIndex
from repro.data.tokens import TokenPipeline as RPipeline
from repro.dist import checkpoint as rckpt
from repro.models import transformer as rtrans
from repro.optim import init_opt_state as rinit_opt_state
from repro_torch import configs
from repro_torch.convert import (opt_state_from_reference,
                                 opt_state_to_reference,
                                 params_from_reference, params_to_reference)
from repro_torch.core.query import get_backend
from repro_torch.data.metadata_index import MetadataIndex
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.optim import init_opt_state
from repro_torch.pytree import tree_leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(16, 8, generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32),
                   "c": torch.randn(4, generator=g).to(torch.bfloat16)},
    }


def trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def restore(path, like):
    return ckpt.restore(str(path), like, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's cases on the port
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    tree = make_tree()
    assert ckpt.save(str(tmp_path), 5, tree, extra={"note": "hi"}) == \
        16 * 8 * 4 + 10 * 4 + 4 * 2
    restored, step, extra = restore(tmp_path, tree)
    assert step == 5 and extra["note"] == "hi"
    trees_equal(tree, restored)


def test_bfloat16_leaf_roundtrip(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 1, tree)
    restored, _, _ = restore(tmp_path, tree)
    assert restored["nested"]["c"].dtype == torch.bfloat16
    meta = json.loads((tmp_path / "step_00000001" / "metadata.json")
                      .read_text())
    # leaves in sorted-key order: a, nested.b, nested.c
    assert [r["dtype"] for r in meta["leaves"]] == ["float32", "int32",
                                                    "bfloat16"]
    stored = np.load(tmp_path / "step_00000001" / "leaf_00002.npy")
    assert stored.dtype == np.uint16


def test_retention(tmp_path):
    tree = make_tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, tree, keep=3)
    assert ckpt.available_steps(str(tmp_path)) == [3, 4, 5]


def test_corruption_falls_back(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 1, tree, keep=5)
    ckpt.save(str(tmp_path), 2, tree, keep=5)
    victim = tmp_path / "step_00000002" / "leaf_00000.npy"
    np.save(victim, np.zeros_like(np.load(victim).view(np.uint8)))
    restored, step, _ = restore(tmp_path, tree)
    assert step == 1  # fell back to the older intact checkpoint
    trees_equal(tree, restored)


def test_async_save(tmp_path):
    tree = make_tree()
    t = ckpt.save_async(str(tmp_path), 7, tree)
    t.join(timeout=60)
    assert not t.is_alive()
    restored, step, _ = restore(tmp_path, tree)
    assert step == 7
    trees_equal(tree, restored)


def test_async_save_snapshots_before_an_in_place_update(tmp_path):
    """On the CPU a tensor's ``.numpy()`` shares its memory: the snapshot
    must copy, or the next in-place step lands in the checkpoint."""
    tree = make_tree()
    want = tree_map(torch.clone, tree)
    ckpt.save_async(str(tmp_path), 3, tree)
    with torch.no_grad():
        for x in tree_leaves(tree):
            x.add_(1)
    ckpt.wait_pending()
    restored, _, _ = restore(tmp_path, tree)
    trees_equal(want, restored)


def test_restore_rejects_layout_mismatch(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 3, tree)
    new_layout = dict(tree, a=torch.zeros(130))  # 16*8 -> flat+pad
    with pytest.raises(ValueError, match="layout"):
        restore(tmp_path, new_layout)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / "nope", make_tree())


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    ckpt.save(str(tmp_path), 1, make_tree())
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(str(tmp_path), make_tree())


def test_atomicity_no_partial_dirs(tmp_path):
    tree = make_tree()
    for s in range(3):
        ckpt.save(str(tmp_path), s, tree)
    assert [d for d in os.listdir(tmp_path) if d.startswith("tmp.")] == []


def test_retention_survives_crash_before_pointer_flip(tmp_path, monkeypatch):
    """A crash between the data write and the pointer flip leaves every
    committed step on disk and the pointer on the old step."""
    tree = make_tree()
    for s in range(3):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [1, 2]
    assert ckpt.latest_step(str(tmp_path)) == 2

    with monkeypatch.context() as m:
        def boom(directory, step):
            raise RuntimeError("injected crash before LATEST flip")

        m.setattr(ckpt, "flip_latest", boom)
        with pytest.raises(RuntimeError, match="injected crash"):
            ckpt.save(str(tmp_path), 3, tree, keep=2)

    assert ckpt.available_steps(str(tmp_path)) == [1, 2, 3]
    assert ckpt.latest_step(str(tmp_path)) == 2
    restored, _, _ = restore(tmp_path, tree)
    trees_equal(tree, restored)

    ckpt.save(str(tmp_path), 4, tree, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.available_steps(str(tmp_path)) == [3, 4]


def test_latest_pointer_never_moves_backwards(tmp_path):
    ckpt.save(str(tmp_path), 9, make_tree())
    ckpt.flip_latest(str(tmp_path), 3)  # stale flip (e.g. replayed host)
    assert ckpt.latest_step(str(tmp_path)) == 9


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def smoke_state(arch="tinyllama-1.1b", seed=0):
    """A smoke model (bfloat16) on the CPU with random optimizer moments
    at step 3: (cfg, model, opt_state)."""
    cfg = configs.get_config(arch).smoke()
    model = transformer.init_params(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = init_opt_state(model, error_feedback=True)
    g = torch.Generator().manual_seed(seed + 1)
    for key in ("m", "v", "ef"):
        for t in opt[key].values():
            t.copy_(torch.rand(t.shape, generator=g))
    opt["step"].fill_(3)
    return cfg, model, opt


def reference_like(arch):
    cfg = rconfigs.get_config(arch).smoke()
    params = jax.eval_shape(lambda: rtrans.init_params(
        jax.random.PRNGKey(0), cfg))
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), params)
    return {"params": params,
            "opt": rinit_opt_state(params, error_feedback=True)}


def assert_same_leaves(ref_tree, port_tree):
    """The reference's restored arrays against the port's tensors, leaf
    for leaf and bit for bit (bfloat16 through its raw 16 bits)."""
    paths = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    leaves = tree_leaves(port_tree)
    assert len(paths) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        name = jax.tree_util.keystr(path)
        w = np.asarray(w)
        assert str(w.dtype) == str(g.dtype).removeprefix("torch."), name
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16).numpy(), w.view(np.int16)
        np.testing.assert_array_equal(g.numpy() if isinstance(
            g, torch.Tensor) else g, w, err_msg=name)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
def test_port_writes_reference_restores(tmp_path, arch):
    cfg, model, opt = smoke_state(arch)
    state = {"params": params_to_reference(model),
             "opt": opt_state_to_reference(opt, model)}
    ckpt.save(str(tmp_path), 3, state, extra={"pipeline": {"step": 3}})
    got, step, extra = rckpt.restore(str(tmp_path), reference_like(arch))
    assert step == 3 and extra == {"pipeline": {"step": 3}}
    assert got["params"]["embed"].dtype == jnp.bfloat16
    assert_same_leaves(got, state)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
def test_reference_writes_port_restores(tmp_path, arch):
    ref_cfg = rconfigs.get_config(arch).smoke()
    params = rtrans.init_params(jax.random.PRNGKey(2), ref_cfg)
    r = np.random.default_rng(3)
    opt = rinit_opt_state(params, error_feedback=True)
    opt = {k: (jax.tree.map(lambda x: jnp.asarray(r.random(x.shape),
                                                  jnp.float32), v)
               if k != "step" else jnp.int32(4)) for k, v in opt.items()}
    tree = {"params": params, "opt": opt}
    rckpt.save(str(tmp_path), 4, tree, extra={"note": "ref"})
    cfg = configs.get_config(arch).smoke()
    meta = transformer.Transformer(cfg, device="meta")
    like = {"params": params_to_reference(meta),
            "opt": opt_state_to_reference(init_opt_state(
                meta, error_feedback=True), meta)}
    got, step, extra = restore(tmp_path, like)
    assert step == 4 and extra == {"note": "ref"}
    assert_same_leaves(tree, got)
    # and into a model and optimizer state the port trains with
    model = transformer.Transformer(cfg, device="meta")
    model.load_state_dict(params_from_reference(got["params"], cfg, "cpu"),
                          assign=True)
    port_opt = opt_state_from_reference(got["opt"], model, "cpu")
    assert_same_leaves(tree, {"params": params_to_reference(model),
                              "opt": opt_state_to_reference(port_opt,
                                                            model)})


def test_both_packages_write_the_same_bytes(tmp_path):
    """One state saved by each package: the same metadata (dtype, shape,
    CRC of every leaf) and the same leaf files."""
    cfg, model, opt = smoke_state()
    state = {"params": params_to_reference(model),
             "opt": opt_state_to_reference(opt, model)}

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    ckpt.save(str(tmp_path / "port"), 1, state, extra={"x": 1})
    rckpt.save(str(tmp_path / "ref"), 1, tree_map(to_jax, state),
               extra={"x": 1})
    a, b = tmp_path / "port" / "step_00000001", tmp_path / "ref" / \
        "step_00000001"
    assert json.loads((a / "metadata.json").read_text()) == json.loads(
        (b / "metadata.json").read_text())
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 20
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_params_to_reference_inverts_params_from_reference(arch):
    cfg_r = rconfigs.get_config(arch).smoke()
    tree = rtrans.init_params(jax.random.PRNGKey(1), cfg_r)
    cfg = configs.get_config(arch).smoke()
    model = transformer.Transformer(cfg, device="meta")
    model.load_state_dict(params_from_reference(tree, cfg, "cpu"),
                          assign=True)
    back = params_to_reference(model)
    assert_same_leaves(tree, back)
    shapes = params_to_reference(model, device="meta")
    assert all(t.is_meta for t in tree_leaves(shapes))
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == [
        tuple(t.shape) for t in tree_leaves(back)]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "mamba2-1.3b", "zamba2-1.2b"])
def test_opt_state_round_trip(arch):
    """A port state -> the reference's layout (its ``init_opt_state``
    shapes) -> back, identical."""
    cfg = configs.get_config(arch).smoke()
    model = transformer.init_params(cfg, device="cpu")
    opt = init_opt_state(model, error_feedback=True)
    g = torch.Generator().manual_seed(4)
    for key in ("m", "v", "ef"):
        for t in opt[key].values():
            t.copy_(torch.rand(t.shape, generator=g))
    ref = opt_state_to_reference(opt, model)
    want = rinit_opt_state(rtrans.init_params(
        jax.random.PRNGKey(0), rconfigs.get_config(arch).smoke()),
        error_feedback=True)
    assert [tuple(t.shape) for t in tree_leaves(ref)] == [
        tuple(x.shape) for x in jax.tree.leaves(want)]
    back = opt_state_from_reference(ref, model, "cpu")
    assert back.keys() == opt.keys()
    for key in ("m", "v", "ef"):
        assert back[key].keys() == opt[key].keys()
        for name in opt[key]:
            assert torch.equal(back[key][name], opt[key][name]), (key, name)
    assert int(back["step"]) == 0 and back["step"].dtype == torch.int32


def test_flat_moments_are_not_converted():
    """ZeRO-1 flat moments (``zero_pad > 1``) on plain tensors carry no
    record of their multiple: the converter refuses them without
    ``zero_pad`` rather than guess a wrong layout."""
    model = transformer.init_params(
        configs.get_config("tinyllama-1.1b").smoke(), device="cpu")
    with pytest.raises(ValueError, match="ZeRO-1"):
        opt_state_to_reference(init_opt_state(model, zero_pad=4), model)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def run_main(argv):
    """``train.main(argv)`` on the host; (metrics, printed lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = train.main(["--device", "cpu", "--seq", "32", *argv])
    return metrics, out.getvalue().splitlines()


def test_launcher_resumes_bit_for_bit(tmp_path):
    """Four steps with checkpoints at 2 and 4, then a resume to 6 that
    prints ``resumed from step 4`` and gives the losses of an
    uninterrupted six-step run exactly; then a restart of the finished run
    returns []."""
    d = str(tmp_path / "ck")
    first, lines = run_main(["--steps", "4", "--ckpt-dir", d,
                             "--ckpt-every", "2", "--log-every", "1"])
    assert [m["step"] for m in first] == [0, 1, 2, 3]
    assert ckpt.available_steps(d) == [2, 4] and ckpt.latest_step(d) == 4
    assert sum(line.startswith("step ") for line in lines) == 4
    assert any(line.startswith("[train] saved step 4: ") for line in lines)
    assert all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in first)
    resumed, lines = run_main(["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "[train] resumed from step 4" in lines
    assert [m["step"] for m in resumed] == [4, 5]
    whole, _ = run_main(["--steps", "6", "--ckpt-dir",
                         str(tmp_path / "whole"), "--ckpt-every", "100"])
    assert [m["loss"] for m in whole] == [m["loss"] for m in first + resumed]
    assert [m["grad_norm"] for m in whole[4:]] == [
        m["grad_norm"] for m in resumed]
    again, lines = run_main(["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert again == []
    assert lines[-1] == "[train] already at step 6 >= --steps 6; nothing to do"


def test_launcher_falls_back_past_a_corrupted_newest_step(tmp_path):
    d = str(tmp_path / "ck")
    run_main(["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    victim = Path(d) / "step_00000004" / "leaf_00000.npy"
    np.save(victim, np.zeros_like(np.load(victim)))
    metrics, lines = run_main(["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "[train] resumed from step 2" in lines
    assert [m["step"] for m in metrics] == [2, 3, 4, 5]


def test_launcher_simulated_failure_exits_42(tmp_path):
    """A crash at step 4 exits the process with code 42; the restart
    resumes from a committed step and finishes.  The step-4 save is
    started just before the crash and may be torn by it (the async writer
    races the exit, as in the reference), so the restart resumes from step
    4 or, past a torn one, from step 2."""
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--seq", "32", "--steps", "6", "--ckpt-dir", d,
           "--ckpt-every", "2"]
    out = subprocess.run([*cmd, "--simulate-failure-at", "4"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 42, out.stderr
    assert "[train] simulating failure at step 4" in out.stdout
    assert ckpt.available_steps(d)[0] == 2
    out = subprocess.run([*cmd, "--resume"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("[train] resumed from step 2" in out.stdout
            or "[train] resumed from step 4" in out.stdout), out.stdout
    assert ckpt.latest_step(d) == 6


@pytest.mark.parametrize("query_backend", ["torch", "numpy"])
def test_curation_query_matches_reference(query_backend):
    """The launcher's closing query over five batches' metadata: its rows,
    compressed words scanned and index size are the reference
    ``MetadataIndex``'s over the same ``TokenPipeline`` metadata, and the
    port's index returns the reference's row ids.  The torch backend's
    result cache starts cold (other tests query the same segments, and a
    cached segment is not scanned again)."""
    get_backend("torch", device="cpu").result_cache.clear()
    _, lines = run_main(["--steps", "5", "--query-backend", query_backend])
    done = next(line for line in lines if line.startswith("[train] done"))
    ref, port = RMetadataIndex(), MetadataIndex()
    pipe = RPipeline(configs.get_config("tinyllama-1.1b").vocab_size, 8, 32)
    for _ in range(5):
        meta = pipe.next_batch()[1]
        ref.add_batch(meta)
        port.add_batch(meta)
    rows, scanned = ref.query(where={"domain": 3})
    assert (f"metadata index {ref.size_words()} words; domain=3 -> "
            f"{len(rows)} rows ({scanned} compressed words scanned)") in done
    get_backend("torch", device="cpu").result_cache.clear()
    got, got_scanned = port.query(where={"domain": 3}, device="cpu")
    np.testing.assert_array_equal(np.sort(got), np.sort(rows))
    assert got_scanned == scanned
    assert len(rows) > 0
