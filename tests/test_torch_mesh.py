"""The port's mesh layer against the reference's, on the CPU.

* Placement specs: for all 10 configs' smoke versions, on an abstract
  (4, 2) ("data", "model") mesh and a (2, 16, 16) ("pod", "data",
  "model") one, ``repro_torch.dist.sharding``'s ``param_shardings``,
  ``opt_shardings``, ``grad_shardings_zero``, ``batch_shardings`` (train,
  prefill, decode) and ``cache_shardings`` give every dimension of every
  leaf the mesh axis the reference's ``PartitionSpec`` gives it.  The
  reference's specs come from a subprocess with 512 host devices, as
  ``tests/test_distributed.py`` makes its mesh; its layer leaves are
  stacked, so a port leaf ``layers.{i}.x`` takes the reference's
  ``layers.x`` spec without its leading layer entry.
* One spawned 4-rank gloo group (``tests/torch_mesh_ranks.py``) on a
  (2, 2) mesh and then a (4, 1) one: tinyllama-1.1b's smoke config in
  float32, one ``train_step`` at microbatches 2 with
  ``grad_shardings=opt_shardings(...)["m"]``, from perturbed reference
  weights (``convert.params_from_reference``) and a random flat ZeRO-1
  state at step 3, against the port's one-card ``train_step`` and the
  reference's single-device ``repro.train.train_step`` from the same
  weights and flat state.  Tolerances, float32: losses at rtol 1e-5 (the
  mesh adds partial sums in another order: a few units in the last place
  of a value near 6), parameters at atol 1e-5, moments ``m`` at atol 1e-7
  and ``v`` at rtol 1e-5 (the last places of the gradients, as in
  ``tests/test_torch_train.py``); the flat moments round-trip through
  ``convert`` to the reference's flat tree; a save under (2, 2) restores
  on (4, 1) and on one rank, and a flat moment saved under another
  ``zero_pad`` is refused; every family's forward logits on the (2, 2)
  mesh equal one rank's within 1e-5, and the dense and SSM families'
  greedy decode gives identical tokens and caches within 1e-5; both
  launchers run ``--mesh 2,2`` (and a resume on ``--mesh 4,1``) against
  their one-card runs: the bfloat16 smoke losses at rtol 1e-3 (the
  card's ``[lm_mesh]`` gate) and the served greedy tokens identical.
* ``launch.shapes``: every (arch, shape) cell's inputs as ``meta``
  tensors against the reference's ``ShapeDtypeStruct`` stand-ins.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.convert import (opt_state_from_reference,
                                 opt_state_to_reference, params_from_reference,
                                 params_to_reference)
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve, train
from repro_torch.models.common import AbstractMesh, ShardingCtx, lshard
from repro_torch.optim import adamw, init_opt_state
from repro_torch.pytree import tree_leaves
from repro_torch.train import step as tstep
from test_torch_train import OPT, assert_tree_close, batch, pair, random_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = configs.list_archs()
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

SPEC_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from repro.configs import get_config, list_archs
from repro.dist.sharding import (batch_shardings, cache_shardings,
                                 grad_shardings_zero, opt_shardings,
                                 param_shardings)

MESHES = json.loads(os.environ["MESHES"])


def spec(s):
    return [None if a is None else list(a) if isinstance(a, tuple) else a
            for a in s.spec]


def flat(tree):
    return {".".join(str(k.key) for k in path): spec(s)
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


out = {}
for arch in list_archs():
    cfg = get_config(arch).smoke()
    for name, (shape, axes) in MESHES.items():
        n = 1
        for d in shape:
            n *= d
        mesh = jax.make_mesh(tuple(shape), tuple(axes),
                             devices=jax.devices()[:n])
        opt = opt_shardings(mesh, cfg)
        out[f"{arch}|{name}"] = {
            "params": flat(param_shardings(mesh, cfg)),
            "m": flat(opt["m"]), "v": flat(opt["v"]),
            "step": spec(opt["step"]),
            "grad": flat(grad_shardings_zero(mesh, cfg)),
            **{f"batch_{k}": flat(batch_shardings(mesh, cfg, k))
               for k in ("train", "prefill", "decode")},
            "cache": flat(cache_shardings(mesh, cfg)),
        }
print("SPECS:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", MESHES=json.dumps(MESHES))
    out = subprocess.run([sys.executable, "-c", SPEC_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("SPECS:"))
    return json.loads(line[len("SPECS:"):])


def norm(spec):
    """A spec as a tuple of None / axis / tuple of axes, 1-tuples as their
    axis and trailing Nones dropped."""
    out = []
    for a in spec:
        if isinstance(a, (list, tuple)):
            a = tuple(a)
            a = a[0] if len(a) == 1 else a
        out.append(a)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def assert_same_specs(port: dict, ref: dict, n_layers, what, stacked=True):
    """Every port leaf's spec against the reference leaf it comes from."""
    want = {}
    for name, spec in ref.items():
        if stacked and name.startswith("layers."):
            assert norm(spec[:1]) == (), (what, name, spec)
            for i in range(n_layers):
                want[f"layers.{i}.{name[len('layers.'):]}"] = norm(spec[1:])
        elif name.startswith("layers."):
            for i in range(n_layers):
                want[f"layers.{i}.{name[len('layers.'):]}"] = norm(spec)
        else:
            want[name] = norm(spec)
    got = {k: norm(v.spec) for k, v in port.items()}
    assert got == want, what


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_specs_match_reference(ref_specs, arch, mesh_name):
    ref = ref_specs[f"{arch}|{mesh_name}"]
    cfg = configs.get_config(arch).smoke()
    shape, axes = MESHES[mesh_name]
    mesh = AbstractMesh(shape, axes)
    L = cfg.n_layers
    assert_same_specs(sharding.param_shardings(mesh, cfg), ref["params"], L,
                      "params")
    opt = sharding.opt_shardings(mesh, cfg)
    zp = sharding.zero_pad_for(mesh)
    assert zp == dict(zip(axes, shape))["data"]
    # ZeRO-1 moments are flat: one spec for the stacked leaf and each layer
    for key in ("m", "v"):
        assert_same_specs(opt[key], ref[key], L, key, stacked=False)
    assert norm(opt["step"].spec) == norm(ref["step"]) == ()
    assert_same_specs(sharding.grad_shardings_zero(mesh, cfg), ref["grad"],
                      L, "grad")
    for kind in ("train", "prefill", "decode"):
        got = sharding.batch_shardings(mesh, cfg, kind)
        assert {k: norm(v.spec) for k, v in got.items()} == {
            k: norm(v) for k, v in ref[f"batch_{kind}"].items()}, kind
    cache = sharding.cache_shardings(mesh, cfg)
    assert {k: norm(v.spec) for k, v in cache.items()} == {
        k: norm(v) for k, v in ref["cache"].items()}


def test_placements_of_specs():
    """A spec becomes one DTensor placement a mesh axis: ``Shard(d)`` on
    each axis tensor dimension d names (a tuple of axes shards one
    dimension on several), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert sharding.NamedSharding(mesh, (("pod", "data"), None, "model")
                                  ).placements == [Shard(0), Shard(0),
                                                   Shard(2)]
    assert sharding.replicated(mesh).placements == [Replicate()] * 3
    with ShardingCtx(mesh, {"batch": None}):
        assert sharding.batch_shardings(mesh, configs.get_config(
            "tinyllama-1.1b"), "decode", {"batch": None})["tokens"].spec == \
            (None, None)
    x = torch.ones(2, 3)
    with ShardingCtx(mesh):
        assert lshard(x, "batch", "embed") is x  # a plain tensor passes


def test_cli_mesh_checks_its_spec():
    """A spec that is not "data,model" exits with the reference's message;
    one whose product is not the world size raises before any process
    group starts; ``make_production_mesh`` needs 256 or 512 ranks."""
    import torch.distributed as dist

    with pytest.raises(SystemExit, match="--mesh expects 'data,model'"):
        mesh_mod.make_cli_mesh("4x2", "cpu")
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        mesh_mod.make_cli_mesh("2,2", "cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh_mod.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()


def test_one_card_path_starts_no_process_group():
    import torch.distributed as dist

    assert mesh_mod.setup(None, torch.device("cpu")) == (
        None, torch.device("cpu"), 0)
    assert not dist.is_initialized()


def test_grad_shardings_need_a_mesh():
    _, _, cfg, model = pair("tinyllama-1.1b")
    _, tb = batch(cfg, 1)
    with pytest.raises(ValueError, match="not on a mesh"):
        tstep.train_step(model, adamw.init_opt_state(model), tb, cfg=cfg,
                         opt_cfg=adamw.OptConfig(),
                         grad_shardings=sharding.opt_shardings(
                             AbstractMesh((1, 1), ("data", "model")),
                             cfg)["m"])


# ---------------------------------------------------------------------------
# the 4-rank gloo group
# ---------------------------------------------------------------------------


def flat_state(tree, zp, seed=5):
    """``random_state`` in the reference's flat ZeRO-1 layout: each leaf
    flattened and zero-padded to a multiple of ``zp``."""
    state = random_state(tree, seed)
    for key in ("m", "v"):
        state[key] = jax.tree.map(
            lambda a: np.pad(a.reshape(-1), (0, -a.size % zp)), state[key])
    return state


def as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Inputs written, ranks spawned, and the one-card and reference
    steps computed from the same inputs."""
    work = tmp_path_factory.mktemp("mesh")
    cfg_r, tree, cfg, model = pair("tinyllama-1.1b")
    rb, tb = batch(cfg, 11, b=8)
    states = {zp: flat_state(tree, zp) for zp in (2, 4)}
    torch.save({"state_dict": params_from_reference(tree, cfg, "cpu"),
                "opt_ref": {zp: as_torch(s) for zp, s in states.items()},
                "batch": tb, "opt_cfg": OPT}, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    # the ranks run while this process computes the one-card and the
    # reference steps
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_mesh_ranks.py"),
         str(work)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        oc = radamw.OptConfig(**OPT)
        reference, one_card = {}, {}
        for zp, state in states.items():
            rp, ro, rm = jax.jit(lambda p, o, b: rstep.train_step(
                p, o, b, cfg=cfg_r, opt_cfg=oc, microbatches=2))(
                    tree, jax.tree.map(jnp.asarray, state), rb)
            reference[zp] = (rp, ro, rm)
            one = pair("tinyllama-1.1b")[3]
            opt = opt_state_from_reference(state, one, "cpu", zero_pad=zp)
            _, new_opt, m = tstep.train_step(
                one, opt, tb, cfg=cfg, opt_cfg=adamw.OptConfig(**OPT),
                microbatches=2)
            one_card[zp] = (params_to_reference(one), new_opt, m, one)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    res = torch.load(work / "results.pt", weights_only=False)
    res["printed_elsewhere"] = [
        line for r in (1, 2, 3)
        for line in torch.load(work / f"printed_{r}.pt")]
    res["reference"], res["one_card"] = reference, one_card
    res["work"] = work
    return res


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_mesh_places_like_the_reference(mesh_run, shape):
    """The reference's checks (``tests/test_distributed.py``): the FFN on
    the model axis, every moment 1-D, padded to the data size and
    ``Shard(0)`` on "data", a finite loss."""
    r = mesh_run[shape]
    assert "model" in r["ffn_spec"]
    assert r["zero_pad"] == shape[0]
    assert all(len(s) == 1 and s[0] % shape[0] == 0
               for s, _ in r["moments"])
    assert all(p == ["S(0)", "R"]
               for _, p in r["moments"])
    assert np.isfinite(r["metrics"]["loss"])


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_sharded_step_matches_one_card_and_reference(mesh_run, shape):
    r = mesh_run[shape]
    zp = shape[0]
    rp, ro, rm = mesh_run["reference"][zp]
    p1, o1, m1, one = mesh_run["one_card"][zp]
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(r["metrics"][key], float(m1[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
        np.testing.assert_allclose(r["metrics"][key], float(rm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert_tree_close(r["params"], rp, "params", atol=1e-5)
    for a, b in zip(tree_leaves(r["params"]), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # the flat moments against the reference's flat tree
    assert_tree_close(r["opt"]["m"], ro["m"], "m", atol=1e-7)
    assert_tree_close(r["opt"]["v"], ro["v"], "v", rtol=1e-5)
    assert int(r["opt"]["step"]) == int(ro["step"]) == 4
    got1 = opt_state_to_reference(o1, one, zero_pad=zp)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(r["opt"][key]), tree_leaves(got1[key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("zp", [2, 4])
def test_flat_moments_round_trip_convert(mesh_run, zp):
    """The reference's flat tree back into per-layer flat moments (each
    layer's piece padded on its own, the padding lanes zero) and out
    again, unchanged."""
    p1, o1, m1, one = mesh_run["one_card"][zp]
    ref_tree = opt_state_to_reference(o1, one, zero_pad=zp)
    back = opt_state_from_reference(ref_tree, one, "cpu", zero_pad=zp)
    for key in ("m", "v"):
        for name, t in back[key].items():
            assert torch.equal(t, o1[key][name]), (key, name)
            n = dict(one.named_parameters())[name].numel()
            assert t.numel() % zp == 0 and not t[n:].any()
    with pytest.raises(ValueError, match="zero_pad"):
        opt_state_from_reference(ref_tree, one, "cpu")


def test_save_under_2x2_restores_on_4x1_and_one_rank(mesh_run):
    saved = {"params": mesh_run[(2, 2)]["params"],
             "opt": mesh_run[(2, 2)]["opt"]}
    r = mesh_run[(4, 1)]
    assert r["restored_step"] == 1 and r["restored_dtensor"]
    for a, b in zip(tree_leaves(r["restored"]), tree_leaves(saved)):
        assert torch.equal(a, b)
    one = mesh_run["one_card"][2][3]
    ck = mesh_run["work"] / "ckpt"

    def like(zp):
        return {"params": params_to_reference(one, "meta"),
                "opt": opt_state_to_reference(
                    init_opt_state(one, zero_pad=zp), one, "meta",
                    zero_pad=zp)}

    restored, step, _ = ckpt.restore(ck, like(2), device="cpu")
    for a, b in zip(tree_leaves(restored), tree_leaves(saved)):
        assert torch.equal(a, b)
    # moments flattened to another multiple, or param-shaped, are refused
    for zp in (3, 1):
        with pytest.raises(ValueError, match="has shape"):
            ckpt.restore(ck, like(zp), device="cpu")


def test_every_family_forward_on_the_mesh(mesh_run):
    fams = mesh_run["families"]
    assert len(fams) == 7
    for arch, rec in fams.items():
        assert rec["logits_err"] <= 1e-5, (arch, rec)


def test_decode_on_the_mesh_gives_the_same_tokens(mesh_run):
    for arch in ("tinyllama-1.1b", "mamba2-1.3b"):
        rec = mesh_run["families"][arch]
        assert rec["tokens_equal"], arch
        assert rec["cache_err"] <= 1e-5, (arch, rec)


def one_card_main(fn, argv):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


def test_launchers_on_the_mesh_match_one_card(mesh_run, tmp_path):
    got = mesh_run["launchers"]
    argv = ["--device", "cpu", "--seq", "32", "--log-every", "1"]
    want = one_card_main(train.main, [*argv, "--steps", "3"])
    np.testing.assert_allclose([m["loss"] for m in got["train"]],
                               [m["loss"] for m in want[:2]], rtol=1e-3)
    assert "[train] mesh (data=2, model=2) on cpu, backend gloo, 4 ranks" \
        in got["train_lines"]
    assert "[train] resumed from step 2" in got["resumed_lines"]
    assert [m["step"] for m in got["resumed"]] == [2]
    np.testing.assert_allclose([m["loss"] for m in got["resumed"]],
                               [m["loss"] for m in want[2:]], rtol=1e-3)
    served = one_card_main(serve.main, [
        "--device", "cpu", "--requests", "4", "--batch", "4",
        "--gen-tokens", "3"])
    assert len(served["outputs"]) == len(got["serve_outputs"]) == 1
    for a, b in zip(got["serve_outputs"], served["outputs"]):
        np.testing.assert_array_equal(a, b)
    assert any(x.startswith("[serve] mesh (data=2, model=2)")
               for x in got["serve_lines"])
    # rank 0 alone prints
    assert mesh_run["printed_elsewhere"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_input_shapes_match_reference(arch):
    """``launch.shapes``: every cell's runnability, config adaptation and
    input shapes and types (``meta`` tensors) against the reference's
    ``ShapeDtypeStruct`` stand-ins, decode caches included."""
    from repro.configs import get_config as rget_config
    from repro.launch import shapes as rshapes
    from repro_torch.launch import shapes

    assert shapes.SHAPES.keys() == rshapes.SHAPES.keys()
    for name, spec in shapes.SHAPES.items():
        rspec = rshapes.SHAPES[name]
        assert (spec.kind, spec.seq_len, spec.global_batch) == (
            rspec.kind, rspec.seq_len, rspec.global_batch)
        assert shapes.runnable(configs.get_config(arch), spec) == \
            rshapes.runnable(rget_config(arch), rspec)
        cfg, kind, got = shapes.input_specs(arch, name)
        rcfg, rkind, want = rshapes.input_specs(arch, name)
        assert kind == rkind and cfg.sliding_window == rcfg.sliding_window
        flat_got = dict(jax.tree_util.tree_flatten_with_path(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0])
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert flat_got.keys() == flat_want.keys()
        for path, t in flat_got.items():
            w = flat_want[path]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(w.shape), (name, path)
            assert str(t.dtype).removeprefix("torch.") == str(w.dtype), \
                (name, path)
