"""The port's container kernels and container fold against the reference.

* ``repro_torch.kernels.ops.container_pairs`` (and, or, and-not) and
  ``container_gallop`` on the CPU, where they take their plain versions,
  against the reference wrappers ``repro.kernels.ops.container_pairs`` /
  ``container_gallop`` with the Pallas kernels in interpret mode and
  their jnp paths, on the inputs of tests/test_containers.py, padding
  lanes included;
* ``TorchBackend(device="cpu")._container_fold`` against
  ``get_backend("jax", interpret=True)._container_fold`` and the numpy
  streaming fold ``containers.fold`` on the four seeded trials of
  tests/test_containers.py, plus "and" folds that take the
  array-with-bitmap path;
* an unknown merge op raises in both packages.

Inputs are made with numpy from fixed seeds; every comparison is
bit-identical (tolerance 0).  test_torch_cuda.py runs the kernels on the
card.
"""

import numpy as np
import pytest
import torch

from repro.core import containers as RC
from repro.core import ewah
from repro.core.query import get_backend
from repro.kernels import ops as rops
from repro_torch.core import containers as C
from repro_torch.core.query import TorchBackend
from repro_torch.kernels import ops

OPS = ["and", "or", "andnot"]


def random_positions(n_rows, density, seed):
    r = np.random.default_rng(seed)
    return np.flatnonzero(r.random(n_rows) < density).astype(np.int64)


def t32(a):
    """uint32 / int32 numpy -> int32 bit-view CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def chunk_word_stacks(seed):
    """Two (3, CHUNK_WORDS) stacks of expanded chunks at the densities of
    test_kernel_gallop_matches_dense_membership (0.1, 0.5, 0.0), so the
    stacks hold dense, sparse and empty rows."""
    r = np.random.default_rng(seed)
    stacks = []
    for _ in range(2):
        rows = [C.chunk_words(*C.make_chunk(
            np.flatnonzero(r.random(C.CHUNK_ROWS) < d)))
            if d else np.zeros(C.CHUNK_WORDS, dtype=np.uint32)
            for d in (0.1, 0.5, 0.0)]
        stacks.append(np.stack(rows).astype(np.uint32))
    return stacks


@pytest.mark.parametrize("op", OPS)
def test_container_pairs_matches_reference(op):
    a, b = chunk_word_stacks(13)
    got = u32(ops.container_pairs(t32(a), t32(b), op))
    for use_kernel in (True, False):
        want = np.asarray(rops.container_pairs(a, b, op, use_kernel=use_kernel,
                                               interpret=True))
        np.testing.assert_array_equal(got, want)
    assert got.shape == a.shape


@pytest.mark.parametrize("op", OPS)
def test_container_pairs_odd_shape_matches_reference(op):
    """A row count and width off every tile: the reference pads to
    (8, 128) tiles, the port takes any shape."""
    r = np.random.default_rng(5)
    a = r.integers(0, 2**32, size=(3, 200), dtype=np.uint32)
    b = r.integers(0, 2**32, size=(3, 200), dtype=np.uint32)
    want = np.asarray(rops.container_pairs(a, b, op, interpret=True))
    np.testing.assert_array_equal(
        u32(ops.container_pairs(t32(a), t32(b), op)), want)


def gallop_inputs():
    """The inputs of test_kernel_gallop_matches_dense_membership."""
    r = np.random.default_rng(13)
    dense = [np.flatnonzero(r.random(C.CHUNK_ROWS) < d)
             for d in (0.1, 0.5, 0.0)]
    words = np.stack([ewah.positions_to_words(d, C.CHUNK_ROWS)
                      for d in dense])
    pos = np.full((3, 64), -1, dtype=np.int32)
    queries = []
    for i in range(3):
        q = np.unique(r.integers(0, C.CHUNK_ROWS, size=40))
        pos[i, : len(q)] = q
        queries.append(q)
    return dense, words, pos, queries


def test_container_gallop_matches_reference_and_dense():
    dense, words, pos, queries = gallop_inputs()
    got = ops.container_gallop(t32(pos), t32(words)).numpy()
    assert got.dtype == np.int32 and got.shape == pos.shape
    for use_kernel in (True, False):
        want = np.asarray(rops.container_gallop(pos, words,
                                                use_kernel=use_kernel,
                                                interpret=True))
        np.testing.assert_array_equal(got.view(np.uint32), want)
    for i, q in enumerate(queries):
        np.testing.assert_array_equal(q[got[i, : len(q)].astype(bool)],
                                      np.intersect1d(q, dense[i]))
    assert not got[pos < 0].any()     # padding lanes never report hits


def test_container_gallop_edge_positions():
    """Bit 0 and bit 31 of the first and last words, on all-ones and
    all-zero rows; a position past the row reports no hit."""
    words = np.zeros((2, C.CHUNK_WORDS), dtype=np.uint32)
    words[0] = 0xFFFFFFFF
    edge = [0, 31, 32, C.CHUNK_ROWS - 32, C.CHUNK_ROWS - 1]
    pos = np.array([edge + [-1], edge + [-1]], dtype=np.int32)
    want = np.asarray(rops.container_gallop(pos, words, interpret=True))
    got = ops.container_gallop(t32(pos), t32(words)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    np.testing.assert_array_equal(got[0], [1, 1, 1, 1, 1, 0])
    assert not got[1].any()
    past = np.array([[C.CHUNK_ROWS, C.CHUNK_ROWS + 40]], dtype=np.int32)
    assert not ops.container_gallop(t32(past), t32(words[:1])).any()


def fold_trials():
    """The four seeded trials of
    test_containers.py::test_jax_container_fold_bit_identical_to_numpy."""
    n = 2 * C.CHUNK_ROWS + 901
    r = np.random.default_rng(11)
    out = []
    for _ in range(4):
        k = int(r.integers(2, 5))
        pos = [random_positions(n, float(r.uniform(0.001, 0.6)),
                                int(r.integers(0, 2**31))) for _ in range(k)]
        fops = tuple(str(o) for o in r.choice(OPS, size=k - 1))
        out.append((n, pos, fops))
    return out


@pytest.mark.parametrize("trial", range(4))
def test_container_fold_matches_jax_and_numpy(trial):
    n, pos, fops = fold_trials()[trial]
    t_sets = [C.from_positions(p, n) for p in pos]
    r_sets = [RC.from_positions(p, n) for p in pos]
    got = TorchBackend(device="cpu")._container_fold(t_sets, fops, n)
    want_jax = get_backend("jax", interpret=True)._container_fold(
        r_sets, fops, n)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, RC.fold(r_sets, fops, n))
    np.testing.assert_array_equal(got, C.fold(t_sets, fops, n))


@pytest.mark.parametrize("dens", [(0.002, 0.3), (0.3, 0.002),
                                  (0.002, 0.3, 0.2)])
def test_and_fold_takes_gallop_path(dens, monkeypatch):
    """Array containers (density 0.002, about 131 rows a chunk) ANDed with
    bitmap containers (0.2, 0.3: over 4096 rows a chunk): every round's
    array-with-bitmap pairs go through container_gallop, and the result
    still matches the reference fold."""
    n = 16 * C.CHUNK_ROWS
    pos = [random_positions(n, d, 100 + i) for i, d in enumerate(dens)]
    t_sets = [C.from_positions(p, n) for p in pos]
    r_sets = [RC.from_positions(p, n) for p in pos]
    fops = ("and",) * (len(dens) - 1)
    calls = []
    real = ops.container_gallop
    monkeypatch.setattr(ops, "container_gallop",
                        lambda p, w: calls.append(p.shape) or real(p, w))
    got = TorchBackend(device="cpu")._container_fold(t_sets, fops, n)
    assert len(calls) == len(dens) - 1 and all(s[0] == 16 for s in calls)
    np.testing.assert_array_equal(got, RC.fold(r_sets, fops, n))
    np.testing.assert_array_equal(
        got, get_backend("jax", interpret=True)._container_fold(
            r_sets, fops, n))


def test_container_sets_match_reference():
    n = 3 * C.CHUNK_ROWS + 17
    for seed, d in enumerate((0.001, 0.05, 0.4, 0.999)):
        p = random_positions(n, d, seed)
        t, r = C.from_positions(p, n), RC.from_positions(p, n)
        np.testing.assert_array_equal(t.keys, r.keys)
        np.testing.assert_array_equal(t.classes, r.classes)
        for a, b in zip(t.payloads, r.payloads):
            np.testing.assert_array_equal(a, b)


def test_unknown_op_raises_in_both():
    n = C.CHUNK_ROWS
    p = [np.arange(10, dtype=np.int64) * i for i in (1, 2)]
    t_sets = [C.from_positions(x, n) for x in p]
    r_sets = [RC.from_positions(x, n) for x in p]
    with pytest.raises(ValueError, match="unknown container merge op"):
        TorchBackend(device="cpu")._container_fold(t_sets, ("xor",), n)
    with pytest.raises(ValueError, match="unknown container merge op"):
        get_backend("jax", interpret=True)._container_fold(r_sets, ("xor",), n)
    a = torch.zeros(2, C.CHUNK_WORDS, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown container merge op"):
        ops.container_pairs(a, a, "xor")
    with pytest.raises(ValueError, match="unknown container merge op"):
        rops.container_pairs(np.zeros((2, 8), np.uint32),
                             np.zeros((2, 8), np.uint32), "xor")


def test_wrappers_reject_mismatched_shapes():
    a = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        ops.container_pairs(a, a[:1])
    with pytest.raises(ValueError, match="do not pair up"):
        ops.container_gallop(a, a[:1])


def test_cpu_wrappers_count_no_launches():
    ops.reset_launches()
    dense, words, pos, _ = gallop_inputs()
    ops.container_gallop(t32(pos), t32(words))
    ops.container_pairs(t32(words), t32(words), "or")
    assert ops.LAUNCHES["member"] == 0 and ops.LAUNCHES["containerops"] == 0
