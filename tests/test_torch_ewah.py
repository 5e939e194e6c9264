"""The port's batched EWAH codec (``repro_torch.core.ewah_torch``) against
the reference's in-graph codec (``repro.core.ewah_jax``) and the numpy
oracle (``repro.core.ewah``), on the density/length sweep of
test_ewah_oracle.py plus the degenerate inputs the scatter port has to get
right.  Inputs are made with numpy from fixed seeds.  Every comparison is
bit-identical: streams are compared trimmed to their lengths, words whole.

The decode runs the ``ewah_decode`` kernel's plain version here (CPU
tensors); test_torch_cuda.py holds the kernel itself against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ewah, ewah_jax
from repro_torch.core import ewah_torch
from repro_torch.kernels import ops, ref
from torch_encode_cases import CASES, batch, overflows

DENSITIES = [0.001, 0.01, 0.05, 0.2, 0.5, 0.8, 0.95, 0.99, 0.999]
LENGTHS = [1, 2, 31, 32, 33, 100, 1000, 4095]
SEEDS = [0, 1, 2]


def density_rows(n_words):
    """One row per (density, seed): packed Bernoulli(density) bits."""
    rows = []
    for density in DENSITIES:
        for seed in SEEDS:
            rng = np.random.default_rng(seed * 7919 + n_words)
            bits = rng.random(n_words * ewah.WORD_BITS) < density
            rows.append(ewah.pack_bits(bits))
    return np.stack(rows)


def degenerate_rows(n):
    zeros = np.zeros(n, dtype=np.uint32)
    ones = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    alternating = np.where(np.arange(n) % 2 == 0, np.uint32(0xAAAAAAAA),
                           np.uint32(0)).astype(np.uint32)
    clean_flip = np.where(np.arange(n) % 2 == 0, np.uint32(0),
                          np.uint32(0xFFFFFFFF)).astype(np.uint32)
    dirty = np.full(n, 0x12345678, dtype=np.uint32)
    return np.stack([zeros, ones, alternating, clean_flip, dirty])


def as_torch(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def as_u32(t):
    return t.numpy().view(np.uint32)


def check_codec(words):
    """Port vs ewah_jax (vmapped) vs the oracle, for a (B, n) batch."""
    B, n = words.shape
    cap = n + 2
    j_streams, j_lens = jax.vmap(lambda w: ewah_jax.compress(w, cap))(
        jnp.asarray(words))
    j_streams, j_lens = np.asarray(j_streams), np.asarray(j_lens)
    t_streams, t_lens = ewah_torch.compress(as_torch(words), cap)
    t_streams, t_lens = as_u32(t_streams), t_lens.numpy()
    np.testing.assert_array_equal(t_lens, j_lens)
    for b in range(B):
        expect = ewah.compress(words[b])
        assert t_lens[b] == len(expect)
        np.testing.assert_array_equal(t_streams[b, : t_lens[b]], expect)
        np.testing.assert_array_equal(t_streams[b, : t_lens[b]],
                                      j_streams[b, : j_lens[b]])
    j_size = np.asarray(jax.vmap(ewah_jax.compressed_size)(jnp.asarray(words)))
    np.testing.assert_array_equal(
        ewah_torch.compressed_size(as_torch(words)).numpy(), j_size)
    # decode: port vs the reference's scan decoder vs the original words
    j_dec = np.asarray(jax.vmap(
        lambda s, l: ewah_jax.decompress(s, l, n))(
            jnp.asarray(j_streams), jnp.asarray(j_lens)))
    t_dec = as_u32(ewah_torch.decompress(
        as_torch(t_streams), torch.from_numpy(t_lens.astype(np.int32)), n))
    np.testing.assert_array_equal(t_dec, words)
    np.testing.assert_array_equal(t_dec, j_dec)


@pytest.mark.parametrize("n", LENGTHS)
def test_codec_matches_ewah_jax_density_sweep(n):
    check_codec(density_rows(n))


@pytest.mark.parametrize("n", [1, 2, 33, 1000])
def test_codec_matches_ewah_jax_degenerate(n):
    check_codec(degenerate_rows(n))


def test_codec_at_max_dirty():
    """The vectorized path's ceiling: exactly MAX_DIRTY words a row (the
    all-dirty row is one marker with a full dirty count)."""
    n = ewah.MAX_DIRTY
    rng = np.random.default_rng(11)
    half = ewah.pack_bits(rng.random(n * ewah.WORD_BITS) < 0.5)
    check_codec(np.stack([half, degenerate_rows(n)[4]]))


def test_compress_rejects_rows_past_max_dirty():
    """Rows past ``MAX_DIRTY`` words, which the reference's single-marker
    compressor rejects, encode as ``ewah.compress`` encodes them: the
    all-zero row as one marker, and rows whose dirty and clean runs split
    at the marker limits."""
    n = ewah.MAX_DIRTY + 1
    zeros = np.zeros(n, dtype=np.uint32)
    rng = np.random.default_rng(12)
    split = rng.integers(1, 0xFFFFFFFF, size=n, dtype=np.uint32)
    ones = np.full(2 * n + 5, 0xFFFFFFFF, dtype=np.uint32)
    for words in (np.stack([zeros, split]), ones[None]):
        cap = ewah_torch.stream_capacity(words.shape[1])
        streams, lens = ewah_torch.compress(as_torch(words), cap)
        for b, row in enumerate(words):
            expect = ewah.compress(row)
            assert int(lens[b]) == len(expect)
            np.testing.assert_array_equal(
                as_u32(streams)[b, : len(expect)], expect)


def test_marker_assembly_wraps_to_int32():
    """A clean-1 marker has bit 31 set: it must come out as the negative
    int32 bit-view of the uint32 marker, not overflow."""
    words = np.full((1, 40), 0xFFFFFFFF, dtype=np.uint32)
    streams, lens = ewah_torch.compress(as_torch(words), 4)
    assert int(lens[0]) == 1
    assert int(as_u32(streams)[0, 0]) == ewah.make_marker(1, 40, 0)
    assert int(streams[0, 0]) < 0


def test_capacity_smaller_than_stream_drops_tail_like_reference():
    """A capacity below the stream length keeps the first words, as the
    reference's drop-mode scatter does."""
    words = degenerate_rows(50)[2:3]
    j_stream, j_len = ewah_jax.compress(jnp.asarray(words[0]), 10)
    t_streams, t_lens = ewah_torch.compress(as_torch(words), 10)
    assert int(t_lens[0]) == int(j_len)
    np.testing.assert_array_equal(as_u32(t_streams)[0], np.asarray(j_stream))


def _decode_cases():
    """Hand-built streams that probe the decoder's edges: a stream covering
    fewer words than n_words, one covering more, a length that cuts a dirty
    run, a length past the buffer, and an empty stream."""
    m = ewah.make_marker
    n_words = 12
    C = 10
    rows = [
        ([m(1, 3, 2), 7, 9], 3),                   # covers 5 of 12 words
        ([m(0, 2, 1), 5, m(1, 20, 0)], 3),         # clean run past n_words
        ([m(1, 1, 4), 1, 2, 3, 4], 3),             # length cuts the dirty run
        ([m(0, 1, 2), 8, 9, m(1, 2, 1), 6], 99),   # length past the buffer
        ([m(1, 4, 0)], 0),                         # empty stream
        ([m(0, 0, 3), 1, 2, 3, m(1, 0, 0), m(0, 0, 1), 4], 7),  # empty runs
    ]
    streams = np.zeros((len(rows), C), dtype=np.uint32)
    lengths = np.zeros(len(rows), dtype=np.int32)
    for i, (words, length) in enumerate(rows):
        streams[i, : len(words)] = words
        lengths[i] = length
    return streams, lengths, n_words


def test_decode_edges_match_reference_scan():
    streams, lengths, n_words = _decode_cases()
    want = np.stack([np.asarray(ewah_jax.decompress(
        jnp.asarray(s), int(l), n_words)) for s, l in zip(streams, lengths)])
    got = ewah_torch.decompress(as_torch(streams), torch.from_numpy(lengths),
                                n_words)
    np.testing.assert_array_equal(as_u32(got), want)


def test_decode_batch_layout_is_plane_major():
    """ops.ewah_decode maps a (B, m, C) batch to (m, B, n_words) planes:
    stream (b, j) lands at [j, b]."""
    rng = np.random.default_rng(4)
    B, m, n = 3, 4, 70
    words = np.where(rng.random((B, m, n)) < 0.5, 0,
                     rng.integers(0, 2**32, size=(B, m, n), dtype=np.uint32)
                     ).astype(np.uint32)
    cap = n + 1
    streams = np.zeros((B, m, cap), dtype=np.uint32)
    lengths = np.zeros((B, m), dtype=np.int32)
    for b in range(B):
        for j in range(m):
            s = ewah.compress(words[b, j])
            streams[b, j, : len(s)] = s
            lengths[b, j] = len(s)
    planes = ops.ewah_decode(as_torch(streams), torch.from_numpy(lengths), n)
    assert tuple(planes.shape) == (m, B, n)
    np.testing.assert_array_equal(as_u32(planes), words.transpose(1, 0, 2))


@pytest.mark.parametrize("name", sorted(CASES))
def test_encoder_matches_oracle_at_every_length(name):
    """The encoder's plain version (``ops.ewah_encode`` on CPU tensors)
    against ``ewah.compress``, row by row, on runs at and past each marker
    limit: bit-identical streams within ``stream_capacity(n)``, and the
    overflow flag where a run splits."""
    words = batch(name)
    B, n = words.shape
    cap = ewah_torch.stream_capacity(n)
    streams, lens, over = ops.ewah_encode(
        as_torch(words), ewah_torch.classify(as_torch(words)), cap)
    assert streams.shape == (B, cap) and lens.shape == over.shape == (B,)
    for b in range(B):
        expect = ewah.compress(words[b])
        assert int(lens[b]) == len(expect) <= cap
        np.testing.assert_array_equal(as_u32(streams)[b, : len(expect)],
                                      expect)
        assert int(over[b]) == overflows(words[b])
    if name.startswith("all_dirty"):   # the worst case fills the capacity
        assert cap - int(lens[0]) == (0 if name.endswith("full") else 1)
    flat = ops.encoded_flat(streams)
    for got, part in zip(ops.split_encoded(flat, B, cap),
                         (streams, lens, over)):
        assert torch.equal(got, part)
