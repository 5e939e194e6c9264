"""The port's MoE dispatch-bitmap path (``repro_torch.models.moe`` and
``repro_torch.models.moe_dispatch``) against the reference's
(``repro.models.moe`` and ``benchmarks/bench_moe_dispatch.py``, whose
packing runs the Pallas kernel in interpret mode on the CPU), on the same
routed assignments at T = 4096 tokens for both MoE architectures.  The
port runs on the CPU (``device="cpu"``: the kernels' plain versions).
Words, the Gray-Frequency permutation and the compressed sizes must all
be identical.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from benchmarks import bench_moe_dispatch as rbench  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro_torch.models import moe, moe_dispatch  # noqa: E402

T = 4096
ARCHS = [(name, E, k) for name, E, k in moe_dispatch.ARCHS]


@pytest.fixture(scope="module", params=ARCHS, ids=[a[0] for a in ARCHS])
def routed(request):
    name, E, k = request.param
    eids = moe_dispatch.routed_assignments(T, E, k)
    return name, E, k, eids


def test_architectures_and_assignments_match_the_benchmark(routed):
    name, E, k, eids = routed
    assert (name, E, k) in (("qwen2-moe-a2.7b", 60, 4), ("olmoe-1b-7b", 64, 8))
    np.testing.assert_array_equal(eids, rbench.routed_assignments(T, E, k))


def test_routing_bitmap_words_match_reference(routed):
    _, E, _, eids = routed
    want = np.asarray(rmoe.routing_bitmap_words(jnp.asarray(eids), E))
    got = moe.routing_bitmap_words(torch.from_numpy(eids), E)
    assert got.dtype == torch.int32 and got.shape == (E, T // 32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the kernel wrapper's (W, E) words are the same index transposed
    np.testing.assert_array_equal(
        moe_dispatch.dispatch_words(eids, E, device="cpu"), want.T)


def test_grayfreq_permutation_matches_reference(routed):
    _, E, _, eids = routed
    want = np.asarray(rmoe.grayfreq_token_order(jnp.asarray(eids), E))
    got = moe.grayfreq_token_order(torch.from_numpy(eids), E).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(T))


def test_compressed_dispatch_sizes_match_reference(routed):
    _, E, _, eids = routed
    orders = moe_dispatch.token_orders(eids, E, device="cpu")
    assert set(orders) == {"unsorted", "expert_sorted", "grayfreq"}
    sizes = {}
    for oname, order in orders.items():
        want = rbench.compressed_dispatch_size(eids, E, order)
        got = moe_dispatch.compressed_dispatch_size(eids, E, order,
                                                    device="cpu")
        assert got == want, oname
        sizes[oname] = got
    assert sizes["grayfreq"] < sizes["unsorted"]
    assert sizes["grayfreq"] <= sizes["expert_sorted"]


def test_grayfreq_handles_ties_and_duplicates():
    """Equal-frequency classes and repeated ids: the same permutation."""
    r = np.random.default_rng(5)
    eids = r.integers(0, 6, size=(500, 3), dtype=np.int32)
    eids[::4] = eids[1::4]                      # many tied classes
    eids[::7, 1] = eids[::7, 0]                 # duplicate ids in a row
    want = np.asarray(rmoe.grayfreq_token_order(jnp.asarray(eids), 6))
    got = moe.grayfreq_token_order(torch.from_numpy(eids), 6).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        moe.routing_bitmap_words(torch.from_numpy(eids), 6).numpy()
        .view(np.uint32),
        np.asarray(rmoe.routing_bitmap_words(jnp.asarray(eids), 6)))


def test_run_rows_and_validate():
    rows = moe_dispatch.run(T=2048, device="cpu")
    assert [r["arch"] for r in rows] == [a[0] for a in ARCHS]
    for r in rows:
        assert r["uncompressed_words"] == (2048 // 32) * r["E"]
        assert 0 < r["words_grayfreq"] <= r["uncompressed_words"] + r["E"] * 2
    checks = moe_dispatch.validate(rows)
    assert len(checks) == 4 and all(c.endswith("PASS") for c in checks)
    # the same strings as the benchmark's validate
    assert checks == rbench.validate(rows)
