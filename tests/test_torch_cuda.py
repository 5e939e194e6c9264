"""The port's CUDA kernels and ``TorchBackend`` on the card.

Every test here is marked ``cuda`` and skips (with its reason) where there
is no NVIDIA GPU or no nvcc; on a machine with one, run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports only torch, numpy and the port, so it runs where JAX is
not installed.  Each kernel is held against its plain PyTorch version on
the same device tensors, and the backend against the port's host
``NumpyBackend``.  Inputs are made with numpy from fixed seeds.  Every
comparison is bit-identical.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import ewah
from repro_torch.core.query import NumpyBackend, TorchBackend, compile_plan
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

TAPE = ((0, 0), (0, 1), (2, 1), (0, 2), (1, 0), (2, 0), (0, 3), (2, 2))


@pytest.fixture
def dev():
    """The card; every test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from repro_torch.kernels import build

    try:
        build.nvcc()
    except RuntimeError as exc:
        pytest.skip(f"needs nvcc to build the kernels: {exc}")
    return torch.device("cuda")


def mixed_words(shape, seed):
    """Random words with runs of 0 and 0xFFFFFFFF, as int32 bit-views."""
    r = np.random.default_rng(seed)
    words = r.integers(0, 2**32, size=shape, dtype=np.uint32)
    kind = r.random(shape)
    words[kind < 0.3] = 0
    words[(kind >= 0.3) & (kind < 0.6)] = 0xFFFFFFFF
    flat = words.reshape(-1)
    flat[: flat.size // 5] = 0
    flat[flat.size // 3: flat.size // 2] = 0xFFFFFFFF
    return torch.from_numpy(words.view(np.int32))


def encode_batch(words):
    """(B, m, n) uint32 words -> padded EWAH batch and lengths."""
    B, m, n = words.shape
    streams = np.zeros((B, m, n + 1), dtype=np.uint32)
    lengths = np.zeros((B, m), dtype=np.int32)
    for b in range(B):
        for j in range(m):
            s = ewah.compress(words[b, j])
            streams[b, j, : len(s)] = s
            lengths[b, j] = len(s)
    return (torch.from_numpy(streams.view(np.int32)),
            torch.from_numpy(lengths))


@pytest.mark.parametrize("n", [4096, 4097])  # 16-byte and 4-byte paths
def test_elementwise_kernels_match_plain_versions(dev, n):
    x = mixed_words((5, n), seed=n).to(dev)
    ops.reset_launches()
    cases = [
        (lambda: ops.plan_fuse(x, TAPE), lambda: ref.plan_fuse(x, TAPE)),
        (lambda: ops.wordops(x[0], x[1], "xor"),
         lambda: ref.wordops(x[0], x[1], "xor")),
        (lambda: (ops.slice_fold(x, ("and", "or", "xor", "and")),),
         lambda: (ref.slice_fold(x, ("and", "or", "xor", "and")),)),
        (lambda: ops.recompress_flags(x[0], x[1]),
         lambda: ref.recompress(x[0], x[1])),
    ]
    for kernel, plain in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ops.LAUNCHES["planfuse"] == ops.LAUNCHES["wordops"] == 1
    assert ops.LAUNCHES["slicefold"] == ops.LAUNCHES["recompress"] == 1


@pytest.mark.parametrize("p_clean", [0.0, 0.6, 0.97])
def test_decode_kernel_matches_plain_version(dev, p_clean):
    r = np.random.default_rng(int(p_clean * 100))
    B, m, n = 3, 5, 9000
    words = r.integers(1, 2**32 - 1, size=(B, m, n), dtype=np.uint32)
    kind = r.random((B, m, n))
    words[kind < p_clean / 2] = 0
    words[(kind >= p_clean / 2) & (kind < p_clean)] = 0xFFFFFFFF
    words = np.repeat(words, 3, axis=2)[:, :, :n].copy()  # runs, not singles
    batch, lengths = encode_batch(words)
    lengths[0, 1] //= 2          # a length that cuts the stream short
    batch, lengths = batch.to(dev), lengths.to(dev)
    for n_words in (n, n - 37, n + 50):
        got = ops.ewah_decode(batch, lengths, n_words)
        want = ref.ewah_decode(batch, lengths, n_words)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    full = ops.ewah_decode(batch, lengths, n).cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(full[:, 1:], words.transpose(1, 0, 2)[:, 1:])


def test_wrappers_reject_mixed_devices_and_types(dev):
    a = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CPU or all"):
        ops.wordops(a, a.cpu(), "and")
    with pytest.raises(TypeError, match="int32"):
        ops.wordops(a.long(), a.long(), "and")


@pytest.mark.parametrize("fuse", [True, False])
def test_backend_on_card_matches_numpy(dev, fuse):
    r = np.random.default_rng(3)
    cols = [r.integers(0, c, size=20011) for c in (7, 12, 300)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="lex",
                                                encoding="auto"))
    preds = [T.Eq(0, 3), T.Not(T.Eq(1, 2)), T.Range(2, 40, 210),
             T.And(T.In(0, [0, 1, 2]), T.Range(1, 0, 6), T.Not(T.Eq(2, 5))),
             T.Or(T.And(T.Eq(0, 1), T.Eq(1, 1)), T.Not(T.In(2, [0, 1, 2])))]
    plans = [compile_plan(idx, p) for p in preds]
    want = NumpyBackend().execute_compressed_many(plans)
    ops.reset_launches()
    be = TorchBackend(fuse=fuse)
    for s, w in zip(be.execute_compressed_many(plans), want):
        np.testing.assert_array_equal(s.data, w.data)
    for (rows, _), p in zip(be.execute_many(plans), preds):
        np.testing.assert_array_equal(np.sort(idx.row_perm[rows]),
                                      np.flatnonzero(T.evaluate_mask(p, cols)))
    used = ["planfuse"] if fuse else ["wordops", "slicefold", "recompress"]
    assert ops.LAUNCHES["ewah_decode"] > 0
    assert all(ops.LAUNCHES[k] > 0 for k in used), ops.LAUNCHES
