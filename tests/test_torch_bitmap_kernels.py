"""The port's build-primitive wrappers (``bitpack``, ``gray``, ``histogram``,
``moe_route_bitmap`` in ``repro_torch.kernels.ops``) against the
reference's wrappers (``repro.kernels.ops``), which run their Pallas
kernels in interpret mode on the CPU, as the reference's own tests do.
Here the port's wrappers take their plain PyTorch versions (CPU tensors);
test_torch_cuda.py holds each CUDA kernel against its plain version on the
card.  Inputs are those of tests/test_kernels.py plus the edge cases the
kernels must keep (values out of range, -1 and out-of-range expert ids,
duplicate ids, words >= 2**31), made with numpy from fixed seeds.  Every
comparison is bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.core import ewah
from repro_torch.kernels import ops


def u32(x):
    return x.numpy().view(np.uint32)


def same_bitpack(bits):
    want = np.asarray(rops.bitpack(jnp.asarray(bits)))
    got = ops.bitpack(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)
    return got


# the shapes of test_bitpack_aligned, test_bitpack_unaligned and a seeded
# draw standing in for test_bitpack_property's (R in 1..300, C in 1..200)
_PROPERTY = [tuple(int(v) for v in s) for s in zip(
    np.random.default_rng(11).integers(1, 301, 6),
    np.random.default_rng(12).integers(1, 201, 6))]


@pytest.mark.parametrize("R,C,seed", [
    *[(R, C, s) for R, C in [(256, 128), (512, 256), (256, 384), (768, 128)]
      for s in (0, 1)],
    *[(R, C, 2) for R, C in [(100, 50), (33, 129), (1, 1), (300, 200)]],
    *[(R, C, 100 + i) for i, (R, C) in enumerate(_PROPERTY)],
])
def test_bitpack_matches_reference(R, C, seed):
    r = np.random.default_rng(seed)
    p = 0.3 if seed < 2 else 0.5
    bits = r.random((R, C)) < p
    got = same_bitpack(bits)
    assert got.shape == (-(-R // 32), C)
    np.testing.assert_array_equal(ewah.unpack_bits(u32(got)[:, 0], R),
                                  bits[:, 0])


def test_bitpack_matches_cpu_codec():
    """Bit layout == the host codec's pack_bits, column by column."""
    r = np.random.default_rng(3)
    bits = r.random((96, 4)) < 0.4
    out = u32(ops.bitpack(torch.from_numpy(bits)))
    for c in range(4):
        np.testing.assert_array_equal(out[:, c], ewah.pack_bits(bits[:, c]))


def test_bitpack_all_ones_sets_the_sign_bit():
    bits = np.ones((70, 3), dtype=bool)
    got = u32(same_bitpack(bits))
    np.testing.assert_array_equal(got[:2], 0xFFFFFFFF)
    np.testing.assert_array_equal(got[2], 0x3F)   # rows 64..69; the rest 0


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_gray_matches_reference(inverse, n):
    r = np.random.default_rng(5)
    x = r.integers(0, 2**32, size=n, dtype=np.uint32)
    x[:6] = (0, 1, 0x7FFFFFFF, 0x80000000, 0xC0000001, 0xFFFFFFFF)
    assert (x >= 2**31).sum() > n // 4
    want = np.asarray(rops.gray(jnp.asarray(x), inverse))
    got = ops.gray(torch.from_numpy(x.view(np.int32)), inverse)
    np.testing.assert_array_equal(u32(got), want)


def test_gray_roundtrip_and_host_transform():
    from repro_torch.core.encoding import from_gray, to_gray

    r = np.random.default_rng(6)
    x = np.concatenate([np.arange(2048, dtype=np.uint32),
                        r.integers(0, 2**32, size=2048, dtype=np.uint32)])
    t = torch.from_numpy(x.view(np.int32))
    g = ops.gray(t)
    np.testing.assert_array_equal(u32(g), to_gray(x).astype(np.uint32))
    back = ops.gray(g, inverse=True)
    np.testing.assert_array_equal(u32(back), x)
    np.testing.assert_array_equal(u32(back), from_gray(u32(g)))


@pytest.mark.parametrize("T,V", [(512, 128), (2048, 256), (1000, 100),
                                 (512, 91)])
def test_histogram_matches_reference(T, V):
    r = np.random.default_rng(6)
    vals = r.integers(0, V, size=T, dtype=np.int32)
    want = np.asarray(rops.histogram(jnp.asarray(vals), V))
    got = ops.histogram(torch.from_numpy(vals), V)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.bincount(vals, minlength=V))


@pytest.mark.parametrize("vals,V,expect", [
    ([-1, 0, 5, 7, 130], 7, [1, 0, 0, 0, 0, 1, 0]),
    ([-2**31, 2**31 - 1, 3, 3], 4, [0, 0, 0, 2]),
])
def test_histogram_drops_values_out_of_range(vals, V, expect):
    vals = np.asarray(vals, dtype=np.int32)
    want = np.asarray(rops.histogram(jnp.asarray(vals), V))
    np.testing.assert_array_equal(want, expect)
    got = ops.histogram(torch.from_numpy(vals), V)
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_random_out_of_range_matches_reference():
    r = np.random.default_rng(8)
    vals = r.integers(-50, 300, size=3000, dtype=np.int32)
    want = np.asarray(rops.histogram(jnp.asarray(vals), 200))
    got = ops.histogram(torch.from_numpy(vals), 200)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == ((vals >= 0) & (vals < 200)).sum()


def same_moe_route(eids, E):
    want = np.asarray(rops.moe_route_bitmap(jnp.asarray(eids), E))
    got = ops.moe_route_bitmap(torch.from_numpy(eids), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)
    return u32(got)


@pytest.mark.parametrize("T,E,k", [(256, 128, 4), (512, 60, 4), (300, 64, 8),
                                   (256, 60, 1)])
def test_moe_route_matches_reference(T, E, k):
    r = np.random.default_rng(7)
    eids = r.integers(0, E, size=(T, k), dtype=np.int32)
    words = same_moe_route(eids, E)
    assert words.shape == (-(-T // 32), E)
    assert words[0, eids[0, 0]] & 1


def test_moe_route_ignores_padding_and_out_of_range_ids():
    r = np.random.default_rng(9)
    T, E, k = 300, 64, 8
    eids = r.integers(0, E, size=(T, k), dtype=np.int32)
    eids[::3, 0] = -1            # padding slots
    eids[1::5, 1] = 64           # ids >= E set nothing
    eids[2::7, 2] = 70
    eids[4::9, 3] = eids[4::9, 4]  # duplicates set one bit
    eids[5] = -1                 # a token routed nowhere
    words = same_moe_route(eids, E)
    bits = np.stack([ewah.unpack_bits(words[:, e], T) for e in range(E)], 1)
    for t in range(T):
        ids = {int(i) for i in eids[t] if 0 <= i < E}
        assert set(np.flatnonzero(bits[t])) == ids


def test_moe_route_matches_plain_bitpack_of_one_hot():
    r = np.random.default_rng(10)
    eids = r.integers(-1, 40, size=(77, 3), dtype=np.int32)
    hot = np.zeros((77, 33), dtype=bool)
    for t in range(77):
        for i in eids[t]:
            if 0 <= i < 33:
                hot[t, i] = True
    np.testing.assert_array_equal(
        same_moe_route(eids, 33), u32(ops.bitpack(torch.from_numpy(hot))))


@pytest.mark.parametrize("call,exc,match", [
    (lambda: ops.bitpack(torch.ones(64, 2, dtype=torch.uint8)), TypeError,
     "torch.bool"),
    (lambda: ops.bitpack(torch.ones(64, 2, dtype=torch.int32)), TypeError,
     "torch.bool"),
    (lambda: ops.bitpack(torch.ones(64, dtype=torch.bool)), ValueError,
     r"\(R, C\)"),
    (lambda: ops.gray(torch.ones(8, dtype=torch.int64)), TypeError, "int32"),
    (lambda: ops.histogram(torch.ones(8, dtype=torch.int64), 4), TypeError,
     "int32"),
    (lambda: ops.histogram(torch.ones(2, 4, dtype=torch.int32), 4),
     ValueError, r"\(T,\)"),
    (lambda: ops.histogram(torch.ones(8, dtype=torch.int32), 0), ValueError,
     "n_values"),
    (lambda: ops.moe_route_bitmap(torch.ones(8, 2, dtype=torch.int64), 4),
     TypeError, "int32"),
    (lambda: ops.moe_route_bitmap(torch.ones(8, dtype=torch.int32), 4),
     ValueError, r"\(T, k\)"),
    (lambda: ops.moe_route_bitmap(torch.ones(8, 2, dtype=torch.int32), 0),
     ValueError, "n_experts"),
    # neither the CPU nor a CUDA device: the wrappers refuse, never fall back
    (lambda: ops.bitpack(torch.ones(64, 2, dtype=torch.bool, device="meta")),
     ValueError, "CPU or all"),
    (lambda: ops.gray(torch.ones(8, dtype=torch.int32, device="meta")),
     ValueError, "CPU or all"),
    (lambda: ops.histogram(torch.ones(8, dtype=torch.int32, device="meta"), 4),
     ValueError, "CPU or all"),
    (lambda: ops.moe_route_bitmap(
        torch.ones(8, 2, dtype=torch.int32, device="meta"), 4),
     ValueError, "CPU or all"),
])
def test_wrapper_checks(call, exc, match):
    with pytest.raises(exc, match=match):
        call()


def test_cpu_calls_launch_no_kernel():
    """On CPU tensors the four wrappers take their plain versions: no
    counter moves."""
    ops.reset_launches()
    x = torch.arange(-50, 50, dtype=torch.int32)
    ops.bitpack(x[:, None] > 0)
    ops.gray(x)
    ops.gray(x, inverse=True)
    ops.histogram(x, 30)
    ops.moe_route_bitmap(x.reshape(25, 4), 16)
    assert set(ops.LAUNCHES) >= {"bitpack", "gray", "histogram", "moe_route"}
    assert all(v == 0 for v in ops.LAUNCHES.values())



# --- histmm.plan: where the counts live, chosen on the host ----------------

from repro_torch.kernels import histmm  # noqa: E402

H100 = dict(sms=132, smem_optin=232_448)
BLOCK_BINS = (232_448 - histmm.STATIC_SMEM) // 16 * 4  # whole 16-byte groups


@pytest.mark.parametrize("n,V,regime,blocks", [
    (1_000_000, 7, "shared", 123),           # dbgen-like col 0
    (1_000_000, 11, "shared", 123),          # dbgen-like col 1
    (1_000_000, 2526, "shared", 123),        # dbgen-like col 2
    (1_000_000, 28_571, "shared", 70),       # dbgen-like col 3
    (199_523, 99_761, "global", 65),         # census-like's widest
])
def test_histogram_plan_of_the_timed_columns(n, V, regime, blocks):
    how = histmm.plan(n, V, **H100)
    assert (how.regime, how.blocks) == (regime, blocks)
    assert not how.exact                      # float adds, below 2**24 values
    assert how.threads == 1024


@pytest.mark.parametrize("n,V,regime", [
    (1000, 1, "shared"),
    (1000, 32, "shared"),
    (1000, 33, "shared"),
    (10**6, BLOCK_BINS, "shared"),            # at the opt-in limit
    (10**6, BLOCK_BINS + 1, "global"),        # past one block's bins
    (10**6, 16 * BLOCK_BINS + 1, "global"),   # past any 16 blocks' bins
    (4097, 1_000_000, "global"),
])
def test_histogram_plan_edges(n, V, regime):
    how = histmm.plan(n, V, **H100)
    assert how.regime == regime
    if regime == "shared":
        assert how.smem == 16 * -(-V // 4)


@pytest.mark.parametrize("V", [1, 7, 64, 2526, 99_761])
def test_histogram_plan_of_no_values(V):
    how = histmm.plan(0, V, **H100)
    assert not how.exact
    # one block, or (global) enough to zero the next call's output
    assert how.blocks == (1 if how.regime != "global" else
                          -(-V // histmm.GLOBAL_ZEROED_PER_BLOCK))


@pytest.mark.parametrize("n", [2**24 - 1, 2**24, 10**8])
def test_histogram_plan_exact_from_2_to_the_24(n):
    """From 2**24 values a count may pass float32's exact integers: the
    counts then meet as uint32 (the exact path)."""
    for V in (7, 2526, 99_761):
        assert histmm.plan(n, V, **H100).exact == (n >= 2**24)


_PLAN_GRID = [(n, V) for n in (0, 1, 4097, 65_536, 10**6, 10**8)
              for V in (1, 7, 11, 31, 33, 2526, 28_571, BLOCK_BINS, 99_761,
                        10**6)]


@pytest.mark.parametrize("n,V", _PLAN_GRID)
def test_histogram_plan_limits(n, V):
    how = histmm.plan(n, V, **H100)
    assert how.smem + histmm.STATIC_SMEM <= 232_448       # 227 KB a block
    assert 1 <= how.blocks <= 132      # the exact path's grid is resident
    assert how.threads == 1024
    if how.regime == "shared" and how.blocks > 1:
        # partial copies are flushed bin by bin: no more than the values fill
        assert how.blocks * V <= n / histmm.FLUSH_FACTOR


def test_histogram_plan_follows_the_card():
    small = histmm.plan(10**6, 28_571, sms=16, smem_optin=100_000)
    assert small.regime == "global" and small.blocks == 16
    assert histmm.plan(10**6, 2526, sms=16, smem_optin=100_000).blocks == 16
    with pytest.raises(ValueError):
        histmm.plan(-1, 7)
    with pytest.raises(ValueError):
        histmm.plan(10, 0)
