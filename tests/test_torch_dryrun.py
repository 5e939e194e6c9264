"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's, on the CPU.

* The budget helpers (``budget_key``, ``check_budget``,
  ``update_budget``) give the reference's results on the same records.
* Every skipped cell's record (long_500k for the eight full-attention
  archs, on both meshes: 16 records) equals the reference's ``run_cell``
  record, which returns before it lowers anything (the reference's
  compiled cells fail on jax 0.9.0, so its skipped records and helpers are
  the oracle).  The reference's records come from a subprocess with 512
  host devices, as ``tests/test_torch_mesh.py`` makes its meshes.
* Fake and real worlds count the same: tinyllama-1.1b's smoke train,
  prefill and decode steps on a fake (2, 2) world (``meta`` tensors) and
  on 4 real gloo ranks (CPU tensors; ``tests/torch_dryrun_ranks.py``,
  each world in a subprocess so that no default group leaks into this
  process) give identical collective counts, bytes and mesh dimensions,
  per-rank FLOPs and per-rank argument and output bytes.
* FLOPs per rank: on a fake world of one rank each step's ``cost.flops``
  equals ``FlopCounterMode``'s count of the same step without a mesh; on
  (2, 2), 4 x the per-rank count exceeds that by exactly the work the
  placement repeats on every model rank, counted from the config
  (tolerance 0: the counts are integers): the kv projections (GQA kv
  heads are replicated over the model axis, as in the reference: forward,
  and in training the input and weight gradients) and, in training, the
  head's two backward products, which the loss's replicated vocab
  (``train.step.cross_entropy``) runs over the whole vocabulary on each
  rank's rows.
* The CLI on a skipped cell writes the reference's record and a summary,
  and exits 0.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import SHAPES, runnable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_dryrun_ranks.py")
SKIPPED = [(arch, mp) for mp in (False, True) for arch in list_archs()
           if not runnable(get_config(arch), SHAPES["long_500k"])[0]]

REF_SCRIPT = r"""
import json, sys
from repro.launch.dryrun import run_cell
cells = json.loads(sys.argv[1])
print("RECORDS:" + json.dumps([run_cell(a, "long_500k", mp)
                               for a, mp in cells]))
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module; importing it sets ``XLA_FLAGS`` to
    512 host devices, which is restored for the rest of this process."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref


def records():
    return [
        {"mesh": "16x16", "arch": "tinyllama-1.1b", "shape": "train_4k",
         "status": "ok", "collectives": {"total_bytes": 1000}},
        {"mesh": "2x16x16", "arch": "olmoe-1b-7b", "shape": "decode_32k",
         "status": "ok", "collectives": {"total_bytes": 5000}},
        {"mesh": "16x16", "arch": "qwen2-7b", "shape": "prefill_32k",
         "status": "ok", "collectives": {"total_bytes": 7}},
        {"mesh": "16x16", "arch": "qwen2-7b", "shape": "long_500k",
         "status": "skipped"},
    ]


BUDGET = {"16x16__tinyllama-1.1b__train_4k": {"total_bytes": 1200},
          "2x16x16__olmoe-1b-7b__decode_32k": {"total_bytes": 4000}}


def test_budget_key_and_check_budget_match_reference(ref_dryrun):
    for mine, theirs in zip(records(), records()):
        assert dryrun.budget_key(mine) == ref_dryrun.budget_key(theirs)
        if mine["status"] != "ok":
            continue
        assert (dryrun.check_budget(mine, BUDGET)
                == ref_dryrun.check_budget(theirs, BUDGET))
        assert mine == theirs  # the same "budget" entry added, or none


@pytest.mark.parametrize("existing", [False, True])
def test_update_budget_matches_reference(ref_dryrun, tmp_path, existing):
    paths = [tmp_path / "port.json", tmp_path / "ref.json"]
    printed = []
    for path, update in zip(paths, (dryrun.update_budget,
                                    ref_dryrun.update_budget)):
        if existing:
            path.write_text(json.dumps(
                {"16x16__old__train_4k": {"total_bytes": 3,
                                          "counts": {}}}))
        recs = records()
        for r in recs[:3]:
            r["collectives"]["counts"] = {"all-reduce": 2}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            update(str(path), recs, 1.25)
        printed.append(buf.getvalue().replace(str(path), "PATH"))
    assert paths[0].read_text() == paths[1].read_text()
    assert printed[0] == printed[1]


@pytest.fixture(scope="module")
def ref_skipped():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          json.dumps(SKIPPED)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RECORDS:")]
    return dict(zip(map(tuple, SKIPPED), json.loads(line[-1][8:])))


def test_sixteen_skipped_cells():
    assert len(SKIPPED) == 16
    assert not {a for a, _ in SKIPPED} & {"zamba2-1.2b", "mamba2-1.3b"}


@pytest.mark.parametrize("arch,multi_pod", SKIPPED)
def test_skipped_record_matches_reference(ref_skipped, arch, multi_pod):
    rec = dryrun.run_cell(arch, "long_500k", multi_pod)
    assert rec["status"] == "skipped"
    assert rec == ref_skipped[(arch, multi_pod)]


def test_cli_skipped_cell_writes_reference_record(ref_skipped, tmp_path,
                                                  capsys):
    assert dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k",
                        "--both-meshes", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("[skip]") == 2 and "done: 2 cells, 0 errors" in out
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary == [ref_skipped[("qwen2-7b", False)],
                       ref_skipped[("qwen2-7b", True)]]
    assert json.loads((tmp_path / "2_16_16__qwen2-7b__long_500k.json")
                      .read_text()) == summary[1]


def _world(mode, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, RANKS, str(tmp_path), mode],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads((tmp_path / f"{mode}.json").read_text())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {mode: _world(mode, tmp_path_factory.mktemp(mode))
            for mode in ("fake", "gloo")}


KINDS = ("train", "prefill", "decode")


@pytest.mark.parametrize("kind", KINDS)
def test_fake_and_gloo_worlds_count_the_same(worlds, kind):
    fake, real = worlds["fake"]["2x2"][kind], worlds["gloo"]["2x2"][kind]
    assert fake["collectives"] == real["collectives"]
    assert fake["dims"] == real["dims"]
    assert fake["cost"] == real["cost"]
    assert fake["memory"] == real["memory"]
    assert fake["collectives"]["total_bytes"] > 0
    assert fake["memory"]["temp_bytes"] is None


@pytest.mark.parametrize("kind", KINDS)
def test_one_rank_counts_what_flop_counter_counts(worlds, kind):
    one = worlds["fake"]["1x1"][kind]
    assert one["cost"]["flops"] == worlds["fake"]["unmeshed_flops"][kind]
    assert one["cost"]["flops"] > 0
    assert one["collectives"]["total_bytes"] == 0


def _replicated_work(kind):
    """FLOPs the (2, 2) placement runs on both model ranks of a data
    shard, over the whole batch (see the module docstring)."""
    from torch_dryrun_ranks import ARCH, CELLS

    cfg = get_config(ARCH).smoke()
    _, seq, batch = next(c for c in CELLS if c[0] == kind)
    tokens = batch * (1 if kind == "decode" else seq)
    kv = 2 * 2 * tokens * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
    kv *= cfg.n_layers
    if kind != "train":
        return kv, 0
    head = 2 * 2 * tokens * cfg.d_model * cfg.vocab_size
    return 3 * kv, head


@pytest.mark.parametrize("kind", KINDS)
def test_per_rank_flops_on_a_2x2_world(worlds, kind):
    data, model = 2, 2
    per_rank = worlds["fake"]["2x2"][kind]["cost"]["flops"]
    whole = worlds["fake"]["unmeshed_flops"][kind]
    kv, head = _replicated_work(kind)
    assert per_rank * data * model >= whole
    # the kv work splits over the data axis only, the head's backward
    # over nothing
    assert per_rank * data * model - whole == (model - 1) * kv + (
        data * model - 1) * head


@pytest.mark.parametrize("name,kind", [
    ("_c10d_functional::all_reduce", "all-reduce"),
    ("c10d::allreduce_", "all-reduce"),
    ("_c10d_functional::all_gather_into_tensor", "all-gather"),
    ("_c10d_functional::reduce_scatter_tensor", "reduce-scatter"),
    ("_dtensor::shard_dim_alltoall", "all-to-all"),
    ("c10d_functional.all_to_all_single", "all-to-all"),
    ("c10d::send", "collective-permute"),
    ("_c10d_functional::wait_tensor", None),
    ("aten::mm", None),
])
def test_collective_kind(name, kind):
    assert dryrun.collective_kind(name) == kind


def test_an_unknown_collective_raises():
    with pytest.raises(RuntimeError, match="uncounted collective"):
        dryrun.collective_kind("_c10d_functional::broadcast")
