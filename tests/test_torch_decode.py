"""The two phases of the port's ``ewah_decode`` kernel, run through their
plain PyTorch versions (``kernels/ref.py`` ``ewah_markers`` and
``ewah_expand``), against the reference's scan decoder
(``repro.core.ewah_jax.decompress``) and the numpy oracle
(``repro.core.ewah.decompress``).

``ewah_markers`` resolves each stream's marker chain by the kernel's
algorithm (pointer jumping to window exits, then walks of at most 32 steps
down the levels of windows), so these cases give that algorithm CPU
coverage: its marker table is held against a serial walk of the chain,
and its expansion against both decoders and the whole function's plain
version (``ref.ewah_decode``).  Inputs are made with numpy from fixed
seeds; every comparison is bit-identical.  test_torch_cuda.py holds the
kernels against these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ewah, ewah_jax
from repro_torch.kernels import ewah_decode as launcher
from repro_torch.kernels import ops, ref

TILE = launcher.TILE


def short_runs(n, seed, dirty=(1, 3), clean=(1, 2)):
    """n words of alternating clean and dirty runs, each 1-3 words long:
    the shape of a bit slice of a bitsliced column in lex order."""
    r = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.uint32)
    i = 0
    while i < n:
        k = int(r.integers(*clean, endpoint=True))
        out[i:i + k] = 0xFFFFFFFF if r.random() < 0.5 else 0
        i += k
        k = int(r.integers(*dirty, endpoint=True))
        out[i:i + k] = r.integers(1, 2**32 - 1, size=min(k, max(n - i, 0)),
                                  dtype=np.uint32)
        i += k
    return out


def batch_of(streams, C, lengths=None):
    """A (B, m, C) batch from a nested list of streams (uint32 arrays)."""
    B, m = len(streams), len(streams[0])
    batch = np.zeros((B, m, C), dtype=np.uint32)
    lens = np.zeros((B, m), dtype=np.int32)
    for b in range(B):
        for j in range(m):
            s = streams[b][j]
            batch[b, j, :len(s)] = s[:C]
            lens[b, j] = len(s)
    if lengths is not None:
        lens = np.asarray(lengths, dtype=np.int32).reshape(B, m)
    return batch, lens


def walk(stream, length, n_words):
    """The marker table by a serial walk: (position, offset) of every
    marker whose offset is below n_words."""
    length = max(0, min(int(length), len(stream)))
    p = op = 0
    rows = []
    while p < length and op < n_words:
        w = int(stream[p])
        nc, nd = (w >> 15) & 0xFFFF, w & 0x7FFF
        rows.append((p, op))
        op += nc + min(nd, length - p - 1)
        p += 1 + nd
    return rows


def oracle(stream, length, n_words):
    """ewah.decompress of the first ``length`` words, cut or padded with
    zeros to n_words."""
    length = max(0, min(int(length), len(stream)))
    full = ewah.decompress(stream[:length])
    out = np.zeros(n_words, dtype=np.uint32)
    k = min(n_words, len(full))
    out[:k] = full[:k]
    return out


def check(batch, lengths, n_words):
    """Both phases' plain versions against the serial walk, the reference
    scan, the numpy oracle and ref.ewah_decode."""
    B, m, C = batch.shape
    bt = torch.from_numpy(batch.view(np.int32))
    lt = torch.from_numpy(lengths)
    tab, tab_n, tile_first = ref.ewah_markers(bt, lt, n_words, TILE)
    assert tab.shape == (B * m, C, 2)
    assert tile_first.shape == (B * m, -(-n_words // TILE))
    tab, tab_n, tile_first = tab.numpy(), tab_n.numpy(), tile_first.numpy()
    for r in range(B * m):
        rows = walk(batch.reshape(B * m, C)[r], lengths.reshape(-1)[r],
                    n_words)
        assert tab_n[r] == len(rows)
        np.testing.assert_array_equal(tab[r, :len(rows)],
                                      np.asarray(rows, np.int32).reshape(-1, 2))
        offs = np.asarray([o for _, o in rows])
        starts = np.arange(0, n_words, TILE)
        np.testing.assert_array_equal(
            tile_first[r], np.searchsorted(offs, starts, side="right") - 1)
    got = ops.ewah_expand(bt, lt, n_words, torch.from_numpy(tab),
                          torch.from_numpy(tab_n),
                          torch.from_numpy(tile_first))
    got = got.numpy().view(np.uint32)
    assert got.shape == (m, B, n_words)
    want = np.asarray(jax.vmap(lambda s, n: ewah_jax.decompress(
        s, n, n_words))(jnp.asarray(batch.reshape(B * m, C)),
                        jnp.asarray(lengths.reshape(-1))))
    want = want.reshape(B, m, n_words).transpose(1, 0, 2)
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        for j in range(m):
            np.testing.assert_array_equal(
                got[j, b], oracle(batch[b, j], lengths[b, j], n_words))
    whole = ops.ewah_decode(bt, lt, n_words).numpy().view(np.uint32)
    np.testing.assert_array_equal(whole, got)
    return tab_n


@pytest.mark.parametrize("C", [31_251, 32_768, 40_000])
def test_many_markers_of_short_runs(C):
    """About 12K markers of 1-3-word runs over 31,250 words, in a buffer of
    C words (two levels of window exits, or three past 32,768): the stream
    that set the decode time before the redesign."""
    n = 31_250
    words = short_runs(n, seed=1, dirty=(1, 2), clean=(1, 1))
    s = ewah.compress(words)
    batch, lengths = batch_of([[s]], C)
    tab_n = check(batch, lengths, n)
    assert tab_n[0] > 11_000
    assert len(s) > 30_000


def test_dirty_runs_of_max_dirty():
    """Markers with nd = MAX_DIRTY: each jump crosses many tiles."""
    r = np.random.default_rng(2)
    n = 3 * ewah.MAX_DIRTY + 40
    words = r.integers(1, 2**32 - 1, size=n, dtype=np.uint32)
    words[ewah.MAX_DIRTY + 7: ewah.MAX_DIRTY + 20] = 0
    s = ewah.compress(words)
    assert any((int(w) & 0x7FFF) == ewah.MAX_DIRTY for w in s)
    batch, lengths = batch_of([[s]], len(s) + 3)
    check(batch, lengths, n)


@pytest.mark.parametrize("cut", [1, 2, 5])
def test_dirty_count_past_length(cut):
    """A marker whose nd points past `length`: the dirty run stops at the
    length, and the next marker is never read."""
    m = ewah.make_marker
    s = np.array([m(1, 3, 2), 7, 9, m(0, 2, 6), 1, 2, 3, 4, 5, 6, m(1, 4, 0)],
                 dtype=np.uint32)
    length = len(s) - 1 - cut
    batch, lengths = batch_of([[s]], len(s), lengths=[length])
    check(batch, lengths, 40)


@pytest.mark.parametrize("length", [0, -3, 11, 10_000])
def test_length_zero_negative_and_past_buffer(length):
    """length 0 and below give zeros; a length past the buffer is clamped
    to C; 11 cuts the last dirty run of the 12-word stream."""
    m = ewah.make_marker
    s = np.array([m(0, 1, 2), 8, 9, m(1, 2, 1), 6, m(0, 0, 6), 1, 2, 3, 4, 5,
                  6], dtype=np.uint32)
    batch, lengths = batch_of([[s]], len(s), lengths=[length])
    check(batch, lengths, 30)


@pytest.mark.parametrize("n_words", [1, 7, 2047, 2048, 2049, 5000, 9000])
def test_n_words_below_and_above_coverage(n_words):
    """The stream covers 4,500 words: n_words cuts it (inside a clean run,
    inside a dirty run, on tile edges) or pads it with zeros."""
    r = np.random.default_rng(3)
    words = short_runs(4500, seed=4, dirty=(1, 40), clean=(1, 300))
    words[100:130] = r.integers(1, 2**32 - 1, size=30, dtype=np.uint32)
    s = ewah.compress(words)
    batch, lengths = batch_of([[s]], len(s) + 1)
    check(batch, lengths, n_words)


def test_empty_markers_and_zero_runs():
    """Markers with no clean and no dirty words (they produce nothing and
    share an offset with their successor) and a clean run of 0."""
    m = ewah.make_marker
    s = np.array([m(1, 0, 0), m(0, 0, 0), m(1, 3, 1), 5, m(0, 0, 0),
                  m(1, 0, 0), m(0, 2, 0), m(1, 0, 0)], dtype=np.uint32)
    batch, lengths = batch_of([[s]], len(s))
    for n_words in (1, 4, 6, 12):
        check(batch, lengths, n_words)


def test_one_query_batch_of_55_streams():
    """A B=1, m=55 batch with a mix of marker counts (1 to about 10K) in
    one 32,768-word capacity, as the dbgen mix's median batch holds."""
    n = 31_250
    r = np.random.default_rng(5)
    streams = []
    for j in range(55):
        kind = j % 5
        if kind == 0:
            words = np.full(n, 0xFFFFFFFF if j % 2 else 0, dtype=np.uint32)
        elif kind == 1:
            words = short_runs(n, seed=j, dirty=(1, 3), clean=(1, 3))
        elif kind == 2:
            words = r.integers(1, 2**32 - 1, size=n, dtype=np.uint32)
        elif kind == 3:
            words = short_runs(n, seed=j, dirty=(1, 2000),
                               clean=(1, 4000 + 100 * j))
        else:
            words = np.zeros(n, dtype=np.uint32)
            hot = r.choice(n, size=50 * j, replace=False)
            words[hot] = r.integers(1, 2**32 - 1, size=hot.size,
                                    dtype=np.uint32)
        streams.append(ewah.compress(words))
    batch, lengths = batch_of([streams], 32_768)
    tab_n = check(batch, lengths, n)
    assert tab_n.min() == 1 and tab_n.max() > 5_000
    assert len(set(tab_n.tolist())) > 10


def test_batch_layout_matches_plain_decode():
    """A (B, m) batch with several queries: row r = b * m + j of the table,
    plane [j, b] of the output."""
    streams = [[ewah.compress(short_runs(3000, seed=10 * b + j,
                                         dirty=(1, 9), clean=(1, 50)))
                for j in range(4)] for b in range(3)]
    batch, lengths = batch_of(streams, 3100)
    lengths[1, 2] //= 2
    check(batch, lengths, 3000)
