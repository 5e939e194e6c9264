"""The port's model-serving launcher against the reference's on the CPU.

``repro_torch.launch.serve`` runs beside ``repro.launch.serve``:

* ``make_requests`` draws the reference's lengths from the same seed;
* ``pack_batches`` on ``backend="torch", device="cpu"`` (the kernels'
  plain versions) gives the reference's batches on its numpy backend, and
  ``padding_waste`` the same numbers, in every admission topology:
  rebuild, ``query_fanout=2``, segmented, segmented with the background
  compactor, and segmented behind a two-worker ``ServePlane``;
* ``SegmentedAdmission``'s admit / pack / retire / close sequence gives
  the reference's packs and retire counts;
* the port's ``main`` prints the reference's padding-waste figures and
  request and token counts, for every model family's smoke config
  (``--arch``); ``--no-smoke`` serves every config's published widths
  (traced on the ``meta`` device, so nothing is allocated), ``--mesh`` is
  not an option, and without a card the default device raises.

Lengths are made with numpy from fixed seeds; every comparison is exact.
The compactor and plane cases run under a join timeout, and every plane
has a connect and a reply timeout, so a hung worker or compactor fails
its test.
"""

import contextlib
import io
import re
import threading

import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro_torch.launch import serve

TIMEOUTS = {"connect_timeout": 60.0, "reply_timeout": 180.0}
MODES = {
    "rebuild": {},
    "fanout2": {"query_fanout": 2},
    "segmented": {"admission": "segmented"},
    "compactor": {"admission": "segmented", "compactor": True},
    "hosts2": {"admission": "segmented", "hosts": 2},
}
# (requests, seed, batch): a launch-sized queue, the server's default,
# and one that seals five admission segments (seal_rows 256)
QUEUES = [(24, 0, 8), (64, 0, 8), (1500, 5, 16)]
# every config the reference defines, one a family first
ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-1.2b",
         "qwen2-vl-7b", "musicgen-medium", "qwen2-moe-a2.7b", "qwen2-7b",
         "qwen2.5-14b", "phi3-medium-14b"]


def bounded(fn, timeout=240.0):
    """``fn()`` in a thread joined with a timeout."""
    out = {}
    t = threading.Thread(target=lambda: out.update(v=fn()), daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"did not return within {timeout} s"
    assert "v" in out, "raised (see the thread's traceback above)"
    return out["v"]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,seed", [(24, 0), (64, 0), (1000, 3)])
def test_make_requests_matches_reference(n, seed):
    got = serve.make_requests(n, np.random.default_rng(seed))
    want = rserve.make_requests(n, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    assert serve.BIN_WIDTH == rserve.BIN_WIDTH


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,seed,batch", QUEUES)
def test_pack_batches_match_reference(mode, n, seed, batch):
    lengths = serve.make_requests(n, np.random.default_rng(seed))
    kw = MODES[mode]
    port_kw = dict(kw, plane_opts=TIMEOUTS) if "hosts" in kw else kw
    want = bounded(lambda: rserve.pack_batches(lengths, batch,
                                               backend="numpy", **kw))
    got = bounded(lambda: serve.pack_batches(lengths, batch, backend="torch",
                                             device="cpu", **port_kw))
    assert_batches_equal(got, want)
    assert (serve.padding_waste(lengths, got)
            == rserve.padding_waste(lengths, want))
    # the port's own numpy backend agrees too (the card's check in
    # chip_smoke.py compares against it)
    if mode == "rebuild":
        assert_batches_equal(
            serve.pack_batches(lengths, batch, backend="numpy"), want)


def test_pack_batches_arrival_order_and_errors():
    lengths = serve.make_requests(101, np.random.default_rng(1))
    got = serve.pack_batches(lengths, 8, histogram_aware=False)
    want = rserve.pack_batches(lengths, 8, histogram_aware=False)
    assert_batches_equal(got, want)
    packed = serve.pack_batches(lengths, 8, device="cpu")
    assert sorted(np.concatenate(packed).tolist()) == list(range(101))
    assert (serve.padding_waste(lengths, packed)
            <= serve.padding_waste(lengths, got))
    with pytest.raises(ValueError, match="admission"):
        serve.pack_batches(lengths, 8, admission="bogus", device="cpu")
    with pytest.raises(ValueError, match="pick one"):
        serve.pack_batches(lengths, 8, admission="segmented",
                           query_fanout=2, device="cpu")
    with pytest.raises(ValueError, match="compactor"):
        serve.pack_batches(lengths, 8, compactor=True, device="cpu")
    with pytest.raises(ValueError, match="hosts"):
        serve.pack_batches(lengths, 8, hosts=2, device="cpu")


def admission_sequence(q, lengths):
    """admit in three waves, pack, retire the first three batches, pack."""
    out = {}
    try:
        for chunk in np.array_split(lengths[:200], 3):
            q.admit(chunk)
        first = q.pack(16)
        served = np.concatenate(first[:3])
        out["retired"] = q.retire(served)
        out["again"] = q.retire(served[:5])
        q.admit(lengths[200:])
        out["packs"] = (first, q.pack(16))
        out["lengths"] = q.lengths
        out["segments"] = q.n_segments
    finally:
        q.close()
    return out


@pytest.mark.parametrize("compactor", [False, True])
def test_segmented_admission_matches_reference(compactor):
    lengths = np.random.default_rng(3).integers(8, 96, size=300)
    want = bounded(lambda: admission_sequence(
        rserve.SegmentedAdmission(seal_rows=64, compactor=compactor),
        lengths))
    got = bounded(lambda: admission_sequence(
        serve.SegmentedAdmission(seal_rows=64, compactor=compactor,
                                 device="cpu"), lengths))
    for g, w in zip(got["packs"], want["packs"]):
        assert_batches_equal(g, w)
    assert got["retired"] == want["retired"] == 48
    assert got["again"] == want["again"] == 0
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    served = np.concatenate(got["packs"][0][:3])
    assert not np.intersect1d(np.concatenate(got["packs"][1]), served).size
    if not compactor:
        assert got["segments"] == want["segments"] == 4


def test_segmented_admission_empty_and_closed_twice():
    q = serve.SegmentedAdmission(device="cpu")
    assert q.pack(8) == [] and len(q.lengths) == 0
    q.close()
    q.close()


def run_main(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def figures(text):
    """The padding-waste figures and the served counts a main printed."""
    waste = re.findall(r"histogram_aware=(\w+) .*padding waste ([\d.]+)%",
                       text)
    served = re.findall(r"served (\d+) requests, (\d+) tokens", text)
    return waste, served


def reference_main_figures(argv, n, batch, gen_tokens):
    """What the reference's ``main`` prints.  On jax 0.9.0 its prefill
    raises a ``ShardingTypeError`` (the embedding gather inside its mesh
    context) after the padding-waste lines: those are read from its
    output, and the served counts are computed from its ``make_requests``
    and ``pack_batches`` in its ``main``'s order."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rserve.main(argv)
        except Exception as exc:  # the reference fault named above
            assert "Sharding" in type(exc).__name__, exc
    waste, served = figures(buf.getvalue())
    if not served:
        lengths = rserve.make_requests(n, np.random.default_rng(0))
        batches = rserve.pack_batches(lengths, batch)
        tokens = sum(len(b) for b in batches) * gen_tokens
        served = [(str(n), str(tokens))]
    return waste, served


def test_main_prints_the_reference_figures():
    argv = ["--requests", "24", "--batch", "8", "--gen-tokens", "4"]
    want = reference_main_figures(argv, 24, 8, 4)
    got_text, got = run_main(serve.main, ["--device", "cpu", *argv])
    waste, served = figures(got_text)
    assert (waste, served) == want
    assert len(waste) == 2 and served == [("24", "96")]
    assert "(query backend torch," in got_text
    assert got["requests"] == 24 and got["tokens"] == 96
    assert set(got["phases"]) == {"pack", "prefill", "decode"}
    assert float(waste[1][1]) < float(waste[0][1])


def test_main_profile_writes_a_trace(tmp_path):
    out, got = run_main(serve.main, [
        "--device", "cpu", "--requests", "8", "--batch", "4",
        "--gen-tokens", "2", "--admission", "segmented", "--profile",
        str(tmp_path), "--workload-stats", str(tmp_path / "workload.json")])
    assert (tmp_path / "serve_trace.json").stat().st_size > 0
    assert "# top serving phases (wall-clock)" in out
    assert (tmp_path / "workload.json").exists()
    assert got["tokens"] == 16


def test_main_no_smoke_serves_the_published_widths():
    """``--no-smoke`` leaves the smoke config (the reference's flag is
    ``store_true`` with default True, so its server never can); traced on
    the ``meta`` device, tinyllama-1.1b at full width allocates nothing."""
    out, got = run_main(serve.main, [
        "--no-smoke", "--device", "meta", "--query-backend", "numpy",
        "--requests", "16", "--batch", "8", "--gen-tokens", "3"])
    assert got["requests"] == 16 and got["tokens"] == 48
    assert "served 16 requests, 48 tokens" in out


@pytest.mark.parametrize("arch", ARCHS[1:7])
def test_main_serves_every_family(arch):
    """The smoke config of each family other than dense, through ``main``
    on the CPU: the reference's padding figures and counts."""
    argv = ["--arch", arch, "--requests", "8", "--batch", "4",
            "--gen-tokens", "2"]
    want = reference_main_figures(argv, 8, 4, 2)
    text, got = run_main(serve.main, ["--device", "cpu", *argv])
    assert figures(text) == want
    assert got["requests"] == 8 and got["tokens"] == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_main_no_smoke_traces_every_config(arch):
    """Every config at its published widths on the ``meta`` device: the
    shapes of prefill and decode, allocating nothing."""
    out, got = run_main(serve.main, [
        "--no-smoke", "--arch", arch, "--device", "meta", "--query-backend",
        "numpy", "--requests", "8", "--batch", "8", "--gen-tokens", "2"])
    assert got["requests"] == 8 and got["tokens"] == 16
    assert "served 8 requests, 16 tokens" in out


def test_main_has_no_mesh_option():
    """``--mesh`` takes "data,model" only, and a mesh the process group
    cannot fill raises: a spec of another form exits with the reference's
    message, and "2,1" in a world of one rank raises before any group
    starts (tests/test_torch_mesh.py serves on real meshes)."""
    with pytest.raises(SystemExit, match="--mesh expects 'data,model'"):
        serve.main(["--device", "cpu", "--mesh", "2x1"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        serve.main(["--device", "cpu", "--mesh", "2,1"])


def test_main_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.pack_batches(np.arange(8, 40), 8)
