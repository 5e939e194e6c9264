"""The port's CUDA kernels, ``TorchBackend``, the serving launcher,
the training path and a one-rank NCCL mesh on the card.

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
from repro_torch.core import ewah, ewah_torch
from repro_torch.core.query import NumpyBackend, TorchBackend, compile_plan
from repro_torch.kernels import ops, ref
from repro_torch.workload import WorkloadStats
from torch_encode_cases import CASES as ENCODE_CASES
from torch_encode_cases import batch as encode_case

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


def short_run_words(n, seed, dirty=(1, 2), clean=(1, 1)):
    """n words of alternating clean and dirty runs of a few words each: a
    stream of many markers (about 12K at n = 31,250 with the defaults)."""
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


def decode_against_plain(dev, words, C, lengths=None, n_words=None):
    """Encode (B, m, n) words into a (B, m, C) batch, decode on the card,
    and hold the result against ref.ewah_decode (and the words, where the
    whole stream is decoded)."""
    B, m, n = words.shape
    batch = np.zeros((B, m, C), dtype=np.uint32)
    lens = np.zeros((B, m), dtype=np.int32)
    for b in range(B):
        for j in range(m):
            s = ewah.compress(words[b, j])
            batch[b, j, : len(s)] = s
            lens[b, j] = len(s)
    if lengths is not None:
        lens = np.asarray(lengths, dtype=np.int32).reshape(B, m)
    batch = torch.from_numpy(batch.view(np.int32)).to(dev)
    lt = torch.from_numpy(lens).to(dev)
    for nw in ([n] if n_words is None else n_words):
        ops.reset_launches()
        got = ops.ewah_decode(batch, lt, nw)
        want = ref.ewah_decode(batch, lt, nw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert ops.LAUNCHES["ewah_decode"] == 1
        if lengths is None and nw == n:
            np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                          words.transpose(1, 0, 2))
    return batch, lt


@pytest.mark.parametrize("C", [31_251, 32_768, 70_000])  # 70,000: scratch
def test_decode_kernel_many_markers(dev, C):
    """One stream of about 12K markers of 1-3-word runs over 31,250 words:
    pointer jumping in shared memory, or in the wrapper's scratch where C
    is past what shared memory holds."""
    n = 31_250
    words = short_run_words(n, seed=C)[None, None]
    decode_against_plain(dev, words, C, n_words=[n, n - 999, n + 3000])


def test_decode_kernel_one_query_batch_of_55(dev):
    """B = 1, m = 55 with marker counts from 1 to about 12K, as the dbgen
    mix's median batch holds: walked and pointer-jumped streams in one
    launch."""
    n = 31_250
    r = np.random.default_rng(55)
    rows = []
    for j in range(55):
        kind = j % 5
        if kind == 0:
            w = np.full(n, 0xFFFFFFFF if j % 2 else 0, dtype=np.uint32)
        elif kind == 1:
            w = short_run_words(n, seed=j, dirty=(1, 3), clean=(1, 3))
        elif kind == 2:
            w = r.integers(1, 2**32 - 1, size=n, dtype=np.uint32)
        elif kind == 3:
            w = short_run_words(n, seed=j, dirty=(1, 2000), clean=(1, 4000))
        else:
            w = np.zeros(n, dtype=np.uint32)
            hot = r.choice(n, size=60 * j, replace=False)
            w[hot] = r.integers(1, 2**32 - 1, size=hot.size, dtype=np.uint32)
        rows.append(w)
    words = np.stack(rows)[None]
    batch, lengths = decode_against_plain(dev, words, 32_768)
    lengths = lengths.clone()
    lengths[0, 1::3] //= 3      # lengths that cut dirty runs
    got = ops.ewah_decode(batch, lengths, n)
    assert torch.equal(got, ref.ewah_decode(batch, lengths, n))


@pytest.mark.parametrize("n_words", [2047, 2048, 4097, 3 * 32767 + 50])
def test_decode_dirty_runs_cross_tiles(dev, n_words):
    """Dirty runs of up to MAX_DIRTY words crossing the expansion's
    2,048-word tiles, and tiles that start inside clean runs, in a batch
    of several queries."""
    r = np.random.default_rng(n_words)
    B, m, n = 3, 4, 3 * 32767 + 40
    words = r.integers(1, 2**32 - 1, size=(B, m, n), dtype=np.uint32)
    for b in range(B):
        for j in range(m):
            for _ in range(int(r.integers(0, 6))):
                a = int(r.integers(0, n - 5000))
                words[b, j, a: a + int(r.integers(1, 5000))] = (
                    0xFFFFFFFF if r.random() < 0.5 else 0)
    decode_against_plain(dev, words, n + 8, n_words=[n_words, n])


@pytest.mark.parametrize("C", [32_768, 70_000])
def test_decode_phases_match_plain_versions(dev, C):
    """The markers kernel against ref.ewah_markers (the table up to each
    row's count, the counts and the tile starts) and the expansion kernel,
    fed the plain table, against ref.ewah_expand."""
    n = 31_250
    rows = [short_run_words(n, seed=s, dirty=(1, 1 + 40 * s),
                            clean=(1, 1 + 90 * s)) for s in range(6)]
    rows.append(np.zeros(n, dtype=np.uint32))
    words = np.stack(rows).reshape(1, 7, n)
    batch, lengths = decode_against_plain(dev, words, C)
    lengths = lengths.clone()
    lengths[0, 6] = 0            # an empty stream
    for nw in (n, 5000):
        from repro_torch.kernels import ewah_decode as launcher

        tab, tab_n, tile_first = ops.ewah_markers(batch, lengths, nw)
        p_tab, p_n, p_first = ref.ewah_markers(batch, lengths, nw,
                                               launcher.TILE)
        torch.cuda.synchronize()
        assert torch.equal(tab_n, p_n)
        assert torch.equal(tile_first, p_first)
        for r_, k in enumerate(p_n.tolist()):
            assert torch.equal(tab[r_, :k], p_tab[r_, :k])
        got = ops.ewah_expand(batch, lengths, nw, p_tab, p_n, p_first)
        want = ref.ewah_expand(batch, lengths, nw, p_tab, p_n, p_first)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, ref.ewah_decode(batch, lengths, nw))


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
    assert all(ops.LAUNCHES[k] > 0 for k in used + ["ewah_encode"]), \
        ops.LAUNCHES


@pytest.mark.parametrize("fuse", [True, False])
def test_q17_in_list_on_card_matches_numpy(dev, fuse):
    """TPC-H Q17's part selection at a reduced row count: about 400
    scattered keys of the 19-slice ``l_partkey`` (DBGEN 4-d's columns), so
    some 7,600 leaves read 19 planes, each decoded once; the tape is past
    planfuse's gate, so the plan runs per stage on either setting, and
    every per-stage library is built at its first use."""
    r = np.random.default_rng(17)
    n = 200_003
    cols = [r.integers(0, c, size=n) for c in (7, 11, 2526, 400_000)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="lex",
                                                encoding="auto"))
    preds = [T.In(3, [int(k) for k in np.sort(
        r.choice(400_000 // 3, size=k, replace=False)) * 3])
        for k in (400, 470)]
    plans = [compile_plan(idx, p) for p in preds]
    assert all(len({id(s) for s in p.streams}) == 19 and
               len(p.streams) >= 19 * 400 for p in plans)
    want = NumpyBackend().execute_compressed_many(plans)
    ops.reset_launches()
    be = TorchBackend(fuse=fuse, cache_size=0)
    for s, w in zip(be.execute_compressed_many(plans), want):
        np.testing.assert_array_equal(s.data, w.data)
    for (rows, _), p in zip(be.execute_many(plans), preds):
        np.testing.assert_array_equal(np.sort(idx.row_perm[rows]),
                                      np.flatnonzero(T.evaluate_mask(p, cols)))
    assert ops.LAUNCHES["planfuse"] == 0, ops.LAUNCHES
    assert all(ops.LAUNCHES[k] > 0 for k in ("ewah_decode", "wordops",
                                             "recompress", "ewah_encode")), \
        ops.LAUNCHES
    # no key range here, yet slicefold is built: no plan waits on nvcc later
    from repro_torch.kernels import build
    assert all(build.library_path(k).exists() for k in ops.PER_STAGE)


@pytest.mark.parametrize("name", sorted(ENCODE_CASES))
def test_encode_kernel_matches_plain_version(dev, name):
    """The ewah_encode kernel against its plain version, bit for bit, on
    runs at and past each marker limit (tests/torch_encode_cases.py):
    streams within each length, lengths and overflow flags, one count a
    call."""
    words = encode_case(name)
    x = torch.from_numpy(words.view(np.int32))
    cap = ewah_torch.stream_capacity(x.shape[1])
    want = ops.ewah_encode(x, ewah_torch.classify(x), cap)
    xd = x.to(dev)
    ops.reset_launches()
    got = ops.ewah_encode(xd, ewah_torch.classify(xd), cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ewah_encode"] == 1
    g_s, g_l, g_o = (t.cpu() for t in got)
    w_s, w_l, w_o = want
    assert torch.equal(g_l, w_l) and torch.equal(g_o, w_o)
    for b in range(x.shape[0]):
        assert torch.equal(g_s[b, : w_l[b]], w_s[b, : w_l[b]])
    host = ops.encoded_flat(got[0]).cpu()
    for part, whole in zip(ops.split_encoded(host, *got[0].shape),
                           (g_s, g_l, g_o)):
        assert torch.equal(part, whole)


@pytest.mark.parametrize("cap", [1, 700, 40_000])
def test_encode_kernel_drops_words_past_capacity(dev, cap):
    """A capacity below the stream keeps its first words and the whole
    stream's length, as the plain version does."""
    words = encode_case("rows_apart")
    x = torch.from_numpy(words.view(np.int32))
    want_s, want_l, want_o = ops.ewah_encode(x, ewah_torch.classify(x), cap)
    xd = x.to(dev)
    got_s, got_l, got_o = ops.ewah_encode(xd, ewah_torch.classify(xd), cap)
    assert torch.equal(got_l.cpu(), want_l) and torch.equal(got_o.cpu(),
                                                            want_o)
    keep = torch.clamp(want_l, max=cap)
    for b in range(x.shape[0]):
        assert torch.equal(got_s[b, : keep[b]].cpu(), want_s[b, : keep[b]])


@pytest.mark.parametrize("fuse", [True, False])
def test_backend_past_max_dirty_on_card_matches_numpy(dev, fuse):
    """Past MAX_DIRTY words a row every compressed answer encodes on the
    card (one ewah_encode launch a group), identical to the numpy
    backend."""
    r = np.random.default_rng(28)
    n = 40 * (ewah.MAX_DIRTY + 1)
    cols = [np.sort(r.integers(0, 3, size=n)), r.integers(0, 5, size=n)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="unsorted",
                                                column_order="given"))
    preds = [T.Eq(0, 1), T.Or(T.Eq(0, 2), T.Not(T.Eq(1, 0))),
             T.And(T.Eq(1, 3), T.Not(T.Eq(0, 0)))]
    plans = [compile_plan(idx, p) for p in preds]
    want = NumpyBackend().execute_compressed_many(plans)
    ops.reset_launches()
    got = TorchBackend(fuse=fuse, cache_size=0).execute_compressed_many(plans)
    for s, w in zip(got, want):
        np.testing.assert_array_equal(s.data, w.data)
        s.validate()
    assert ops.LAUNCHES["ewah_encode"] == len(plans), ops.LAUNCHES


@pytest.mark.parametrize("n_rows", [1, 31, 32, 33, 1_025, 40_003,
                                    13_977_980])
def test_rowids_kernels_match_plain_version(dev, n_rows):
    """The two rowids kernels against their plain version on three answers
    (empty, all ones with the padding bits set, random): tile offsets,
    totals and ids identical, two launches a call."""
    from repro_torch.kernels import rowids as kr

    W = -(-n_rows // 32)
    r = np.random.default_rng(n_rows)
    words = r.integers(0, 2**32, size=(3, W), dtype=np.uint32)
    words[0] = 0
    words[1] = 0xFFFFFFFF
    x = torch.from_numpy(words.view(np.int32))
    want_off, want_tot = ops.rowid_counts(x, n_rows)
    want_ids = ops.rowid_write(x, n_rows, want_off, int(want_tot.sum()))
    xd = x.to(dev)
    ops.reset_launches()
    off, tot = ops.rowid_counts(xd, n_rows)
    ids = ops.rowid_write(xd, n_rows, off, int(tot.sum()))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rowids"] == 2
    assert tuple(off.shape) == (3, kr.n_tiles(W))
    assert torch.equal(off.cpu(), want_off) and torch.equal(tot.cpu(),
                                                            want_tot)
    assert torch.equal(ids.cpu(), want_ids)
    assert int(want_tot[1]) == n_rows
    got, totals = ops.rowids(xd, n_rows)
    assert torch.equal(got.cpu(), want_ids) and torch.equal(totals, want_tot)


@pytest.mark.parametrize("fuse", [True, False])
def test_backend_rows_entry_on_card_matches_numpy(dev, fuse):
    """The row-id entry on the card: every answer identical to the numpy
    backend's, two rowids launches a group, ids in one copy a group."""
    r = np.random.default_rng(30)
    n = 200_003
    cols = [r.integers(0, 4, size=n), r.integers(0, 5, size=n)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(row_order="lex"))
    preds = [T.Eq(0, 1), T.Not(T.Eq(1, 2)), T.And(T.Eq(0, 0), T.Eq(0, 1)),
             T.Or(*(T.Eq(1, v) for v in range(5))),
             T.And(T.Not(T.Eq(0, 3)), T.Or(T.Eq(1, 0), T.Eq(1, 4)))]
    plans = [compile_plan(idx, p) for p in preds]
    be = TorchBackend(fuse=fuse, cache_size=0)
    groups = list(be._group(plans).values())
    ops.reset_launches()
    got = be.execute_many(plans)
    for (rows, _), p in zip(got, plans):
        want = NumpyBackend().execute(p)[0]
        assert rows.dtype == np.int64
        np.testing.assert_array_equal(rows, want)
    # a group with no id at all needs no write launch
    empty = sum(all(len(got[i][0]) == 0 for i in g) for g in groups)
    assert ops.LAUNCHES["rowids"] == 2 * len(groups) - empty, ops.LAUNCHES


@pytest.mark.parametrize("P", [3, 16])  # 16-byte path on any P x 2048 words
def test_container_kernels_match_plain_versions(dev, P):
    from repro_torch.core import containers as C

    r = np.random.default_rng(P)
    a = mixed_words((P, C.CHUNK_WORDS), seed=P).to(dev)
    b = mixed_words((P, C.CHUNK_WORDS), seed=P + 1).to(dev)
    ops.reset_launches()
    for op in ("and", "or", "andnot"):
        got = ops.container_pairs(a, b, op)
        want = ref.container_pairs(a, b, op)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    odd = ops.container_pairs(a[:, :37].contiguous(), b[:, :37].contiguous(),
                              "andnot")                  # 4-byte path
    assert torch.equal(odd, ref.container_pairs(a[:, :37], b[:, :37],
                                                "andnot"))
    pos = np.full((P, 300), -1, dtype=np.int32)
    for i in range(P):
        size = int(r.integers(1, 300))
        q = np.unique(r.integers(0, C.CHUNK_ROWS, size=size))
        pos[i, : len(q)] = q
    pos[0, :3] = (0, 31, C.CHUNK_ROWS - 1)
    pos_t = torch.from_numpy(pos).to(dev)
    got = ops.container_gallop(pos_t, a)
    want = ref.container_gallop(pos_t, a)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[pos_t < 0].any()
    assert ops.LAUNCHES["containerops"] == 4 and ops.LAUNCHES["member"] == 1


@pytest.mark.parametrize("P,L,W,shift", [
    (1, 145, 2048, 0),      # 4-byte path (L % 4 != 0), one partial tile
    (5, 4096, 2048, 0),     # 16-byte path, four whole tiles a row
    (3, 1500, 2048, 0),     # 16-byte path, a partial last tile a row
    (4, 1500, 2048, 1),     # positions 4 bytes off alignment: 4-byte path
    (300, 3, 37, 0),        # short rows, positions past the row's words
])
def test_member_kernel_paths_match_plain_version(dev, P, L, W, shift):
    """member's 16-byte and 4-byte paths, tile edges, padding and
    positions past the row, against its plain version."""
    r = np.random.default_rng(P * 7 + L)
    words = torch.from_numpy(r.integers(0, 2**32, size=(P, W),
                                        dtype=np.uint32).view(np.int32))
    pos = r.integers(-1, 2**16, size=(P, L)).astype(np.int32)
    pos[:, -1] = -1
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(shift, np.int32), pos.reshape(-1)])).to(dev)
    pos_t = flat[shift:].view(P, L)
    ops.reset_launches()
    got = ops.container_gallop(pos_t, words.to(dev))
    want = ref.container_gallop(pos_t, words.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and ops.LAUNCHES["member"] == 1
    assert not got[pos_t < 0].any() and not got[pos_t >= 32 * W].any()


def test_container_fold_on_card_matches_numpy(dev):
    from repro_torch.core import containers as C

    n = 16 * C.CHUNK_ROWS
    r = np.random.default_rng(21)
    sets = [C.from_positions(np.flatnonzero(r.random(n) < d), n)
            for d in (0.002, 0.3, 0.05, 0.3)]
    be = TorchBackend()
    for fops in (("and", "or", "andnot"), ("and", "and", "and"),
                 ("or", "andnot", "and")):
        ops.reset_launches()
        np.testing.assert_array_equal(be._container_fold(sets, fops, n),
                                      C.fold(sets, fops, n))
        # "and" intersects inside the one fold launch: member never runs
        assert ops.LAUNCHES["member"] == 0
        assert ops.LAUNCHES["containerops"] == 1


@pytest.mark.parametrize("fuse", [True, False])
def test_lifecycle_on_card_matches_numpy(dev, fuse):
    r = np.random.default_rng(4)
    cols = [r.integers(0, c, size=3000) for c in (7, 11, 300)]
    stats = WorkloadStats()
    for i in range(64):
        stats.record(0, "eq", 1, "equality", 1, 40.0 + i % 3)
        stats.record(1, "eq", 1, "equality", 1, 40.0 + i % 3)
    w = T.IndexWriter(T.IndexSpec(row_order="lex", encoding="auto"),
                      workload_stats=stats)
    for lo in range(0, 3000, 1000):
        w.append([c[lo : lo + 1000] for c in cols])
        w.seal()
    dead = w.delete(T.Range(2, 10, 20))                  # on the card
    seg = w.compact(span=(0, 2))
    assert seg.index.encodings()[:2] == ("roaring", "roaring")
    alive = ~T.evaluate_mask(T.Range(2, 10, 20), cols)
    assert dead == int((~alive).sum())
    preds = [T.Eq(0, 3), T.In(1, [1, 5]), T.And(T.Eq(0, 2), T.Range(2, 5, 90)),
             T.Or(T.Eq(1, 4), T.Not(T.Eq(0, 1)))]
    ops.reset_launches()
    got = w.index.query_many(preds, fuse=fuse)
    want = w.index.execute_compressed_many(preds, backend="numpy")
    comp = w.index.execute_compressed_many(preds, fuse=fuse)
    for p, (rows, _), (_, ws), (_, cs) in zip(preds, got, want, comp):
        np.testing.assert_array_equal(
            rows, np.flatnonzero(T.evaluate_mask(p, cols) & alive))
        np.testing.assert_array_equal(cs.data, ws.data)
    assert ops.LAUNCHES["containerops"] > 0


@pytest.mark.parametrize("R,C", [(1000, 512), (333, 36), (70, 7)])
def test_bitpack_kernel_matches_plain_version(dev, R, C):
    """16-column and 1-column groups, a ragged last word."""
    r = np.random.default_rng(R)
    bits = torch.from_numpy(r.random((R, C)) < 0.4).to(dev)
    ops.reset_launches()
    got = ops.bitpack(bits)
    want = ref.bitpack(bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ones = ops.bitpack(torch.ones(R, C, dtype=torch.bool, device=dev))
    assert torch.equal(ones, ref.bitpack(torch.ones_like(bits)))
    assert ops.LAUNCHES["bitpack"] == 2


@pytest.mark.parametrize("n", [4096, 4097])  # 16-byte and 4-byte paths
def test_gray_kernel_matches_plain_version(dev, n):
    r = np.random.default_rng(n)
    x = r.integers(0, 2**32, size=n, dtype=np.uint32)
    x[:4] = (0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 1)
    x = torch.from_numpy(x.view(np.int32)).to(dev)
    ops.reset_launches()
    for inverse in (False, True):
        got = ops.gray(x, inverse)
        want = ref.gray(x, inverse)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(ops.gray(ops.gray(x), inverse=True), x)
    assert ops.LAUNCHES["gray"] == 4


@pytest.mark.parametrize("T,V", [(4096, 7), (4097, 2526), (20000, 28571),
                                 (20001, 99761)])  # the last past smem
def test_histogram_kernel_matches_plain_version(dev, T, V):
    r = np.random.default_rng(V)
    vals = r.integers(-3, V + 3, size=T, dtype=np.int32)  # some dropped
    vals = torch.from_numpy(vals).to(dev)
    ops.reset_launches()
    got = ops.histogram(vals, V)
    want = ref.histogram(vals, V)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert int(got.sum()) == int(((vals >= 0) & (vals < V)).sum())
    assert ops.LAUNCHES["histogram"] == 1


@pytest.mark.parametrize("T,E,k", [(256, 128, 4), (512, 60, 4), (300, 64, 8),
                                   (257, 60, 1), (1000, 33, 3)])
def test_moe_route_kernel_matches_plain_version(dev, T, E, k):
    r = np.random.default_rng(T + E)
    eids = r.integers(0, E, size=(T, k), dtype=np.int32)
    eids[::3, 0] = -1
    eids[1::5, -1] = E + 6
    if k > 1:
        eids[2::7, 1] = eids[2::7, 0]
    eids = torch.from_numpy(eids).to(dev)
    ops.reset_launches()
    got = ops.moe_route_bitmap(eids, E)
    want = ref.moe_route(eids, E)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    from repro_torch.models.moe import routing_bitmap_words

    assert torch.equal(got, routing_bitmap_words(eids, E).T)
    assert ops.LAUNCHES["moe_route"] == 1


def hist_values(T, V, seed):
    """T values in [-3, V + 3): a few dropped on each side."""
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(-3, V + 3, size=T, dtype=np.int32))


# every regime of histmm.plan: a private histogram a block, and counts in
# device memory; one block and a cooperative grid
@pytest.mark.parametrize("T", [0, 1, 4097, 1_000_000])
@pytest.mark.parametrize("V", [1, 7, 11, 64, 2526, 28_571, 99_761,
                               1_000_000])
def test_histogram_regimes_match_plain_version(dev, T, V):
    vals = hist_values(T, V, seed=T + V).to(dev)
    got = ops.histogram(vals, V)
    want = ref.histogram(vals, V)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("V", [7, 2526, 99_761])
def test_histogram_of_a_view_off_16_byte_alignment(dev, V):
    buf = hist_values(200_001, V, seed=V).to(dev)
    vals = buf[1:]
    assert vals.data_ptr() % 16 == 4
    assert torch.equal(ops.histogram(vals, V), ref.histogram(vals, V))


def test_histogram_of_equal_values(dev):
    vals = torch.full((1_000_000,), 3, dtype=torch.int32, device=dev)
    got = ops.histogram(vals, 7)
    assert got.tolist() == [0, 0, 0, 1_000_000, 0, 0, 0]


def test_histogram_buffers_stay_zero_across_calls_and_streams(dev):
    """Back to back and interleaved on two streams: below 2**24 values each
    call takes an output the previous call on its stream zeroed; from 2**24
    on the counts meet in a scratch each launch leaves zero.  Every result
    matches, and every pooled output and scratch is zero afterwards."""
    from repro_torch.kernels import histmm

    cases = [(hist_values(1_000_000, V, seed=V).to(dev), V)
             for V in (7, 2526, 28_571, 99_761)]
    big = hist_values(2**24 + 5, 2526, seed=3).to(dev)
    big[: 2**23] = 1                        # one count past 2**23
    cases.append((big, 2526))
    wants = [ref.histogram(x, V) for x, V in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for _ in range(2):                      # back to back on one stream
        for (x, V), want in zip(cases, wants):
            assert torch.equal(ops.histogram(x, V), want)
    got = []
    for _ in range(3):                      # interleaved on two streams
        for s in streams:
            with torch.cuda.stream(s):
                got.append([ops.histogram(x, V) for x, V in cases])
    torch.cuda.synchronize()
    for outs in got:
        for out, want in zip(outs, wants):
            assert torch.equal(out, want)
    handles = {s.cuda_stream for s in streams}
    pooled = [k for k in histmm._ZEROED if k[1] in handles]
    assert len(pooled) == 2 * 4             # (stream, V) of the 1M cases
    for k in histmm._ZEROED:
        assert int(histmm._ZEROED[k].abs().sum()) == 0
    scratches = [k for k in histmm._SCRATCH if k[1] in handles]
    assert len(scratches) == 2
    for k in histmm._SCRATCH:
        assert int(histmm._SCRATCH[k].abs().sum()) == 0


@pytest.mark.parametrize("V", [7, 2526, 99_761])
def test_histogram_counts_past_2_to_the_24_round_once(dev, V):
    """The exact path: one count of 2**24 + 3 values rounds as the plain
    version rounds its integer count."""
    vals = torch.full((2**24 + 3,), V - 1, dtype=torch.int32, device=dev)
    vals[:2] = 0
    got = ops.histogram(vals, V)
    assert torch.equal(got, ref.histogram(vals, V))
    assert float(got[V - 1]) == float(np.float32(2**24 + 1))


@pytest.mark.parametrize("V", [7, 11, 2526, 28_571, 99_761])
def test_histogram_is_one_device_kernel_a_call(dev, V):
    """Counted by torch.profiler: one kernel launch a call on the host, no
    memset or copy, and one histogram kernel a call on the device.  The
    profiler may hand over none of a short window's device records, so a
    window with fewer is profiled again, up to five in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vals = hist_values(1_000_000, V, seed=1).to(dev)
    ops.histogram(vals, V)                  # the pooled output allocated here
    torch.cuda.synchronize()
    calls = 4
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ops.histogram(vals, V)
            torch.cuda.synchronize()
        host = [e.name for e in prof.events()
                if e.device_type == DeviceType.CPU
                and e.name.startswith("cuda")
                and any(w in e.name for w in ("Launch", "Memset", "Memcpy"))]
        device = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name != "Activity Buffer Request"]
        assert len(host) == calls and all("Launch" in n for n in host), host
        assert len(device) <= calls and all("hist_" in n for n in device), \
            device
        if len(device) == calls:
            break
    assert len(device) == calls, device


@pytest.mark.parametrize("T", [1, 31, 257, 1 << 20])
@pytest.mark.parametrize("E", [1, 33, 60, 64, 128, 160])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 16])
def test_moe_route_shapes_match_plain_version(dev, T, E, k):
    r = np.random.default_rng(T * 7 + E * 3 + k)
    eids = r.integers(-1, E + 2, size=(T, k), dtype=np.int32)
    if k > 1:
        eids[::5, 1] = eids[::5, 0]          # duplicates set one bit
    eids = torch.from_numpy(eids).to(dev)
    ops.reset_launches()
    got = ops.moe_route_bitmap(eids, E)
    want = ref.moe_route(eids, E)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.LAUNCHES["moe_route"] == 1


@pytest.mark.parametrize("k", [4, 8])
def test_moe_route_of_an_unaligned_view(dev, k):
    r = np.random.default_rng(k)
    flat = torch.from_numpy(r.integers(-1, 66, size=5000 * k + 1,
                                       dtype=np.int32)).to(dev)
    eids = flat[1:].view(5000, k)
    assert eids.is_contiguous() and eids.data_ptr() % 16 == 4
    assert torch.equal(ops.moe_route_bitmap(eids, 64),
                       ref.moe_route(eids, 64))


# past the 908 ids a token that two stages of a 32-token row hold in the
# H100's 227 KB of shared memory: read from device memory, same kernel
@pytest.mark.parametrize("k,offset", [(1000, 0), (1000, 1), (1001, 0)])
def test_moe_route_of_more_ids_than_it_stages(dev, k, offset):
    r = np.random.default_rng(k + offset)
    T, E = 100, 1100
    flat = torch.from_numpy(r.integers(-1, E + 2, size=T * k + offset,
                                       dtype=np.int32)).to(dev)
    eids = flat[offset:].view(T, k)
    eids[::3, 1] = eids[::3, 0]              # duplicates set one bit
    ops.reset_launches()
    got = ops.moe_route_bitmap(eids, E)
    assert torch.equal(got, ref.moe_route(eids, E))
    assert ops.LAUNCHES["moe_route"] == 1


def test_moe_route_of_ids_all_minus_one(dev):
    eids = torch.full((1000, 8), -1, dtype=torch.int32, device=dev)
    got = ops.moe_route_bitmap(eids, 60)
    assert got.shape == (32, 60) and int(got.abs().sum()) == 0


def test_build_primitive_wrappers_reject_wrong_types_and_layouts(dev):
    with pytest.raises(TypeError, match="torch.bool"):
        ops.bitpack(torch.ones(64, 2, dtype=torch.uint8, device=dev))
    with pytest.raises(TypeError, match="int32"):
        ops.moe_route_bitmap(torch.ones(64, 2, dtype=torch.int64,
                                        device=dev), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gray(torch.ones(64, 2, dtype=torch.int32, device=dev).T)


def random_tape(depth, m, seed):
    """A tape whose operand stack peaks at ``depth``, pushing random planes
    of m: a right-nested chain of and / or / xor with NOTs, then a left
    fold of a few more planes onto it."""
    r = np.random.default_rng(seed)
    tape = []
    for _ in range(depth):
        tape.append((0, int(r.integers(0, m))))
        if r.random() < 0.3:
            tape.append((1, 0))
    for _ in range(depth - 1):
        tape.append((2, int(r.integers(0, 3))))
    for _ in range(3):
        tape.append((0, int(r.integers(0, m))))
        tape.append((2, int(r.integers(0, 3))))
    return tuple(tape)


# n: a tile of 256 x V words never divides it; 37 and 31,250 take V = 1,
# 200,003 V = 2 and 300,001 V = 4 on 132 SMs
@pytest.mark.parametrize("m", [1, 29, 64])
@pytest.mark.parametrize("n", [37, 31_250, 200_003, 300_001])
def test_planfuse_kernel_every_depth_class(dev, m, n):
    from repro_torch.kernels import planfuse

    base = mixed_words((m * n + 1,), seed=m + n).to(dev)
    planes = {"aligned": base[: m * n].view(m, n),
              "offset": base[1:].view(m, n)}   # 4 bytes off 16-byte ends
    ops.reset_launches()
    calls = 0
    for depth in range(1, 17):
        tape = random_tape(depth, m, seed=depth * 100 + m)
        prog = planfuse.split(tape)
        assert prog.tape_depth == max(depth, 2)   # the tail pushes one more
        for x in planes.values():
            got = ops.plan_fuse(x, prog)
            want = ref.plan_fuse(x, prog)
            torch.cuda.synchronize()
            calls += 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (depth, tape)
    assert ops.LAUNCHES["planfuse"] == calls


def styled_set(n_rows, styles, seed):
    """A container set chunk by chunk in the given styles (array, bitmap,
    run, empty, full); the last chunk may be partial."""
    from repro_torch.core import containers as C

    r = np.random.default_rng(seed)
    out = []
    for key, style in enumerate(styles):
        lo = key * C.CHUNK_ROWS
        width = min(C.CHUNK_ROWS, n_rows - lo)
        if width <= 0 or style == "empty":
            continue
        if style == "array":
            local = np.unique(r.integers(0, width, size=300))
        elif style == "bitmap":
            local = np.flatnonzero(r.random(width) < 0.3)
        elif style == "run":
            cuts = np.sort(r.choice(width, size=8, replace=False))
            local = np.concatenate([np.arange(a, b + 1)
                                    for a, b in cuts.reshape(4, 2)])
        else:
            local = np.arange(width)
        out.append(local + lo)
    pos = np.concatenate(out) if out else np.empty(0, np.int64)
    return C.from_positions(pos, n_rows)


@pytest.mark.parametrize("k", [1, 2, 5, 12])
def test_fold_kernel_matches_plain_version(dev, k):
    from repro_torch.core import containers as C
    from repro_torch.kernels import containers as KC

    r = np.random.default_rng(k)
    styles = ("array", "bitmap", "run", "empty", "full")
    folds = []
    for n in (5 * C.CHUNK_ROWS + 777, 2 * C.CHUNK_ROWS):
        sets = [styled_set(n, r.choice(styles, size=-(-n // C.CHUNK_ROWS)),
                           int(r.integers(0, 2**31))) for _ in range(k)]
        for fops in (("or",) * (k - 1), ("andnot",) * (k - 1),
                     tuple(str(o) for o in r.choice(["or", "andnot", "and"],
                                                    size=k - 1))):
            folds.append((sets, fops, n))
    packed = KC.pack_folds(folds)
    buf = torch.from_numpy(packed.buf).to(dev)
    ops.reset_launches()
    got = ops.container_fold(buf, packed)
    want = ref.container_fold(buf, packed)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.LAUNCHES["containerops"] == 1
    host = got.cpu().numpy().view(np.uint32)
    for (sets, fops, n), (off, W) in zip(folds, packed.planes):
        acc = sets[0]
        for op, nxt in zip(fops, sets[1:]):
            acc = C.merge(acc, nxt, op)
        np.testing.assert_array_equal(host[off: off + W], C.to_words(acc))
    streams = TorchBackend()._container_fold_many(folds)
    for (sets, fops, n), s in zip(folds, streams):
        np.testing.assert_array_equal(s, C.fold(sets, fops, n))


@pytest.mark.parametrize("P", [1, 16, 300])
def test_pairwise_fold_kernel_matches_plain_version(dev, P):
    from repro_torch.core import containers as C

    a = mixed_words((P, C.CHUNK_WORDS), seed=P + 7).to(dev)
    b = mixed_words((P, C.CHUNK_WORDS), seed=P + 8).to(dev)
    ops.reset_launches()
    for op in ("and", "or", "andnot"):
        got = ops.container_pairs(a, b, op)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.container_pairs(a, b, op))
    off = ops.container_pairs(a[:, 1:].contiguous(), b[:, 1:].contiguous(),
                              "or")                       # 2047 words
    assert torch.equal(off, ref.container_pairs(a[:, 1:], b[:, 1:], "or"))
    assert ops.LAUNCHES["containerops"] == 4


def test_one_containerops_launch_per_batched_lowering(dev):
    from repro_torch.core.query import lower_containers_many

    r = np.random.default_rng(8)
    n = 3 * 65_536 + 4099
    cols = [r.integers(0, 7, size=n), r.integers(0, 11, size=n)]
    idx = T.BitmapIndex.build(cols, T.IndexSpec(k=1, row_order="lex",
                                                encoding="roaring"))
    preds = [T.In(0, [1, 3, 5]), T.Range(1, 2, 8), T.In(0, [1, 3, 5]),
             T.Or(T.Eq(0, 6), T.In(1, [9, 10])),
             T.And(T.In(0, [0, 2]), T.Not(T.Range(1, 0, 4)))]
    plans = [compile_plan(idx, p) for p in preds]
    assert all(p.containers for p in plans)
    want = NumpyBackend().execute_compressed_many(
        [compile_plan(idx, p) for p in preds])
    be = TorchBackend()
    ops.reset_launches()
    lower_containers_many(plans, be._container_fold_many)
    assert ops.LAUNCHES["containerops"] == 1 and ops.LAUNCHES["member"] == 0
    for s, w in zip(be.execute_compressed_many(plans), want):
        np.testing.assert_array_equal(s.data, w.data)


def and_popcount_pairs():
    """Stream pairs for the AND-popcount walk: random word mixes at three
    sizes, a sparse pair over 100,000 words, all ones, a marker with no
    words, a length below the array size and dirty counts that run past
    the arrays (the step cap)."""
    r = np.random.default_rng(12)
    pairs = []
    for n in (10, 300, 5000):
        for _ in range(4):
            a, b = (mixed_words((n,), int(r.integers(1 << 30))).numpy()
                    .view(np.uint32) for _ in range(2))
            pairs.append((ewah.compress(a), ewah.compress(b)))
    a = np.zeros(100_000, dtype=np.uint32)
    b = np.zeros(100_000, dtype=np.uint32)
    a[5000:5010] = 0xDEADBEEF
    b[5005:5020] = 0xFFFFFFFF
    pairs.append((ewah.compress(a), ewah.compress(b)))
    ones = ewah.compress(np.full(320, 0xFFFFFFFF, dtype=np.uint32))
    pairs.append((ones, ones))
    s = pairs[5][0]
    pairs.append((np.concatenate([s[:2], np.zeros(1, np.uint32), s[2:]]),
                  pairs[5][1]))
    over = np.asarray([ewah.make_marker(0, 0, 0x7FFF)] + [0xF0F0F0F0] * 5,
                      dtype=np.uint32)
    pairs.append((over, over))
    out = [(sa, len(sa), sb, len(sb)) for sa, sb in pairs]
    out.append((s, len(s) // 2, pairs[5][1], len(pairs[5][1])))
    return out


def test_and_popcount_kernel_matches_plain_version(dev):
    from repro_torch.core.ewah_stream import and_popcount_many

    pairs = and_popcount_pairs()
    ops.reset_launches()
    counts, iters = and_popcount_many(pairs)               # on the card
    # rows of 5,000 words: the wide route, two launches
    assert ops.LAUNCHES["ewah_and_popcount"] == 2
    want_c, want_i = and_popcount_many(pairs, device="cpu")
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(iters, want_i)
    for (sa, la, sb, lb), c in zip(pairs[:14], counts):
        a, b = ewah.decompress(sa), ewah.decompress(sb)
        assert c == int(sum(bin(int(x)).count("1") for x in a & b))


def test_and_popcount_kernel_on_padded_rows(dev):
    """The wrapper on device rows wider than the streams, with array
    sizes past the width (cut to it): the kernel and its plain version
    on the same device tensors."""
    pairs = and_popcount_pairs()[:6]
    C = max(max(len(p[0]), len(p[2])) for p in pairs) + 33
    sa = np.zeros((len(pairs), C), dtype=np.uint32)
    sb = np.zeros((len(pairs), C), dtype=np.uint32)
    for i, (a, _, b, _) in enumerate(pairs):
        sa[i, : len(a)] = a
        sb[i, : len(b)] = b
    t = lambda x: torch.from_numpy(x.view(np.int32)).to(dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    sizes = [C + 5 if i % 2 else len(p[0]) for i, p in enumerate(pairs)]
    args = (t(sa), i32([p[1] for p in pairs]), i32(sizes), t(sb),
            i32([p[3] for p in pairs]), i32([len(p[2]) for p in pairs]))
    got = ops.ewah_and_popcount(*args)
    want = ref.ewah_and_popcount(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_and_popcount_wide_route_phase_by_phase(dev):
    """Long pairs (tests/torch_pair_cases.py) and pairs that are not well
    formed, one batch on the wide route: the chain kernel's tables
    against ref.ewah_pair_chain (up to each row's count), the tile kernel
    on the plain tables against ref.ewah_pair_tiles, and the two launches
    of ops.ewah_and_popcount against the composed plain versions and the
    step walk."""
    from repro_torch.core.ewah_stream import pack_pairs
    from repro_torch.kernels import ewah_and_popcount as launcher
    from torch_pair_cases import edge_pairs, long_pairs

    pairs = long_pairs() + edge_pairs() + and_popcount_pairs()
    args = pack_pairs(pairs, dev)
    sa, la, na, sb, lb, nb = args
    N, T = launcher.N_WORDS, launcher.TILE
    plain = (ref.ewah_pair_chain(sa, la, N, T),
             ref.ewah_pair_chain(sb, lb, N, T))
    for got, want in zip(ops.ewah_pair_chain(sa, la, sb, lb), plain):
        tab, wtab, meta, ptile = got
        assert torch.equal(meta, want[2]) and torch.equal(ptile, want[3])
        for r, k in enumerate(want[2][:, 0].tolist()):
            assert torch.equal(tab[r, :k], want[0][r, :k])
            assert torch.equal(wtab[r, :k], want[1][r, :k])
    got = ops.ewah_pair_tiles(*args, *plain)
    want = ref.ewah_pair_tiles(*args, *plain, N)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ops.reset_launches()
    got = ops.ewah_and_popcount(*args)
    assert ops.LAUNCHES["ewah_and_popcount"] == 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    short = [k for k, p in enumerate(pairs) if max(len(p[0]), len(p[2]))
             <= 2000]
    walk = ref.ewah_and_popcount(*(t[short] for t in args))
    assert torch.equal(got[0][short], walk[0])
    assert torch.equal(got[1][short], walk[1])


@pytest.mark.parametrize("extra", [0, 1])
def test_and_popcount_routes_at_the_short_width(dev, extra):
    """Rows of SHORT_WIDTH words: one launch; one word more: two; both
    bit-identical to the step walk on the same device tensors."""
    from repro_torch.core.ewah_stream import pack_pairs
    from repro_torch.kernels import ewah_and_popcount as launcher

    sa, la, na, sb, lb, nb = pack_pairs(and_popcount_pairs()[:8], dev)
    width = launcher.SHORT_WIDTH + extra
    pad = lambda s: torch.nn.functional.pad(s, (0, width - s.shape[1]))
    args = (pad(sa), la, na, pad(sb), lb, nb)
    ops.reset_launches()
    got = ops.ewah_and_popcount(*args)
    assert ops.LAUNCHES["ewah_and_popcount"] == 1 + extra
    want = ref.ewah_and_popcount(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_serve_plane_on_card_matches_numpy(dev):
    """Two workers, each with its own CUDA context on the one card,
    answer like the in-process index on the card and like NumpyBackend,
    before and after a broadcast delete; their replies report the
    kernels they launched."""
    from repro_torch.dist.serve_plane import ServePlane

    r = np.random.default_rng(6)
    cols = [r.integers(0, c, size=4000) for c in (7, 11, 300)]
    w = T.IndexWriter(T.IndexSpec(row_order="lex", encoding="auto"))
    for lo in range(0, 3200, 800):
        w.append([c[lo : lo + 800] for c in cols])
        w.seal()
    w.append([c[3200:] for c in cols])
    preds = [T.Eq(0, 3), T.In(1, [1, 5]), T.And(T.Eq(0, 2), T.Range(2, 5, 90)),
             T.Or(T.Eq(1, 4), T.Not(T.Eq(0, 1)))]
    with ServePlane(w, n_hosts=2, connect_timeout=120.0,
                    reply_timeout=600.0) as plane:
        for _ in range(2):
            want = w.index.execute_compressed_many(preds, backend="numpy")
            mine = w.index.execute_compressed_many(preds)
            got = plane.execute_compressed_many(preds)
            for (_, ws), (_, ms), (_, gs) in zip(want, mine, got):
                np.testing.assert_array_equal(gs.data, ws.data)
                np.testing.assert_array_equal(ms.data, ws.data)
            plane.delete(T.Range(2, 100, 140))
        launches = plane.stats()["worker_launches"]
        assert launches.get("ewah_decode", 0) > 0
        assert launches.get("planfuse", 0) > 0


# the dense family in float32 and bfloat16; one config of each other
# family in float32 (in bfloat16 a rounding unit can flip an MoE route)
LM_CASES = [(a, d, t) for a in ("tinyllama-1.1b", "qwen2-7b")
            for d, t in (("float32", 2e-3), ("bfloat16", 0.15))] + [
    (a, "float32", 2e-3) for a in ("olmoe-1b-7b", "qwen2-moe-a2.7b",
                                   "mamba2-1.3b", "zamba2-1.2b",
                                   "qwen2-vl-7b", "musicgen-medium")]


def lm_pair(arch, dtype, dev):
    """A smoke model on the CPU and the same weights on the card."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = replace(get_config(arch).smoke(), dtype=dtype)
    cpu = transformer.init_params(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    card = transformer.Transformer(cfg, device="meta")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                         assign=True)
    return cfg, cpu, card


def frontend_inputs(cfg, b, s):
    """vlm / audio frontend embeddings over 8 positions, and vlm M-RoPE
    positions whose components differ (numpy, seeded)."""
    r = np.random.default_rng(4)
    kw = {}
    if cfg.frontend != "none":
        kw["patches"] = torch.from_numpy(r.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        pos = torch.arange(s, dtype=torch.int32).expand(b, s)
        kw["mrope_positions"] = torch.stack([pos, pos // 2, pos % 5])
    return kw


@pytest.mark.parametrize("arch,dtype,tol", LM_CASES)
def test_lm_smoke_on_card_matches_cpu(dev, arch, dtype, tol):
    """forward (with the vlm / audio frontend inputs), the fused prefill
    and greedy decode on the card against the same port on the CPU; TF32
    off, so float32 products are full float32 and differ from the host's
    only in summation order (the tolerance is tests/test_prefill.py's;
    bfloat16 takes the reference's bf16 tests' 0.15).  Greedy tokens are
    identical in float32."""
    from repro_torch.models import transformer
    from repro_torch.serve.prefill import prefill_with_cache
    from repro_torch.train import serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, card = lm_pair(arch, dtype, dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 20)).astype(np.int32))
    kw = frontend_inputs(cfg, 3, 20)
    with torch.no_grad():
        want, want_aux = transformer.forward(cpu, cfg, toks, **kw)
        got, aux = transformer.forward(card, cfg, toks.to(dev),
                                       **{k: v.to(dev) for k, v in kw.items()})
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=tol, atol=tol)
    out = {}
    for name, m, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        logits, cache = prefill_with_cache(m, cfg, toks.to(d), 32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        steps = [logits.float().cpu()]
        toks_out = [tok.cpu()]
        for t in range(20, 26):
            logits, cache = transformer.decode_step(m, cfg, tok, cache, t)
            steps.append(logits.float().cpu())
            tok, _ = serve_step(m, tok, cache, t + 1, cfg=cfg)
            toks_out.append(tok.cpu())
        out[name] = (steps, torch.cat(toks_out, 1),
                     {k: v.float().cpu() for k, v in cache.items()})
    for g, w in zip(out["card"][0], out["cpu"][0]):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    for k, w in out["cpu"][2].items():
        torch.testing.assert_close(out["card"][2][k], w, rtol=tol, atol=tol,
                                   msg=k)
    if dtype == "float32":
        assert torch.equal(out["card"][1], out["cpu"][1])


@pytest.mark.parametrize("dispatch", ["gather", "scatter"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_combine_is_deterministic_on_card(dev, arch, dispatch):
    """The bf16 MoE FFN gives the same bits twice on the card: the
    combine gathers each token's slots and adds them in expert order (no
    atomics), and agrees with the CPU at the bf16 tolerance."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = replace(get_config(arch).smoke(), dtype="bfloat16")
    cpu = moe.MoE(cfg, torch.bfloat16, "cpu",
                  torch.Generator().manual_seed(6))
    card = moe.MoE(cfg, torch.bfloat16, "meta")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                         assign=True)
    x = torch.from_numpy(0.3 * np.random.default_rng(7).standard_normal(
        (8, 64, cfg.d_model))).to(torch.bfloat16)
    with torch.no_grad():
        runs = [moe.moe_ffn(card, cfg, x.to(dev), dispatch=dispatch)
                for _ in range(2)]
        want, want_aux = moe.moe_ffn(cpu, cfg, x, dispatch=dispatch)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    torch.testing.assert_close(runs[0][0].float().cpu(), want.float(),
                               rtol=0.15, atol=0.15)


@pytest.mark.parametrize("mode", [
    {}, {"query_fanout": 2}, {"admission": "segmented"},
    {"admission": "segmented", "compactor": True},
    {"admission": "segmented", "hosts": 2,
     "plane_opts": {"connect_timeout": 120.0, "reply_timeout": 600.0}}])
def test_pack_batches_on_card_match_numpy(dev, mode):
    """Admission packing on the card (the Eq(bin) plans through
    ewah_decode and planfuse) gives numpy's batches in every topology."""
    from repro_torch.launch import serve

    from repro_torch.core.query import get_backend

    lengths = serve.make_requests(600, np.random.default_rng(2))
    # a cold result cache: the topologies share segments' contents
    get_backend("torch", device=dev).result_cache.clear()
    ops.reset_launches()
    got = serve.pack_batches(lengths, 8, backend="torch", device=dev, **mode)
    if "hosts" not in mode:
        assert ops.LAUNCHES["ewah_decode"] > 0
        assert ops.LAUNCHES["planfuse"] > 0
    want = serve.pack_batches(lengths, 8, backend="numpy", **mode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def card_state(cfg, cpu, dev, seed):
    """Random float32 moments at step 3, on the CPU and the same on the
    card (keyed by parameter name)."""
    from repro_torch.optim import init_opt_state

    opt = init_opt_state(cpu)
    g = torch.Generator().manual_seed(seed)
    for key, scale in (("m", 1e-3), ("v", 1e-2)):
        for t in opt[key].values():
            t.copy_(scale * (0.5 + torch.rand(t.shape, generator=g)))
    opt["step"].fill_(3)
    on_card = {k: ({n: t.to(dev) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(dev))
               for k, v in opt.items()}
    return opt, on_card


@pytest.mark.parametrize("accum,mb", [("scan", 1), ("unroll", 2),
                                      ("scan", 2)])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "mamba2-1.3b", "zamba2-1.2b",
                                  "qwen2-vl-7b"])
def test_train_step_on_card_matches_cpu(dev, arch, accum, mb):
    """One float32 ``train_step`` (remat on) on the card against the same
    step on the CPU from the same weights, moments and batch; TF32 off, so
    the two differ only in summation order: loss and grad norm at rtol
    1e-5, parameters and moments at atol 1e-5 (tests/test_torch_train.py
    holds the CPU to the reference ten times tighter; lr 1e-2 moves an
    element by ~1e-4 with any of a wrong sign, bias correction or weight
    decay)."""
    from repro_torch.optim import OptConfig
    from repro_torch.train import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, card = lm_pair(arch, "float32", dev)
    r = np.random.default_rng(5)
    toks = r.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labels = r.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    kw = frontend_inputs(cfg, 4, 32)
    host = {"inputs": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels), **kw}
    opt_cpu, opt_card = card_state(cfg, cpu, dev, 6)
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    _, new_cpu, m_cpu = train_step(cpu, opt_cpu, host, cfg=cfg, opt_cfg=oc,
                                   microbatches=mb, accum=accum)
    _, new_card, m_card = train_step(
        card, opt_card, {k: v.to(dev) for k, v in host.items()}, cfg=cfg,
        opt_cfg=oc, microbatches=mb, accum=accum)
    for key in ("loss", "grad_norm", "aux_loss"):
        torch.testing.assert_close(torch.as_tensor(m_card[key]).cpu(),
                                   torch.as_tensor(m_cpu[key]), rtol=1e-5,
                                   atol=1e-6, msg=key)
    for name, p in cpu.state_dict().items():
        torch.testing.assert_close(card.state_dict()[name].cpu(), p,
                                   rtol=0, atol=1e-5, msg=name)
        torch.testing.assert_close(new_card["m"][name].cpu(),
                                   new_cpu["m"][name], rtol=0, atol=1e-6,
                                   msg=name)
    assert int(new_card["step"]) == 4


def test_checkpoint_round_trip_of_card_tensors(dev, tmp_path):
    """Card tensors (float32, bfloat16, int32) save and restore onto the
    card bit for bit; an async save snapshots before the next in-place
    update on the card."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.pytree import tree_leaves

    g = torch.Generator(dev).manual_seed(3)
    tree = {"w": torch.randn(300, 70, generator=g, device=dev),
            "h": {"b": torch.randn(513, generator=g, device=dev).to(
                torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32, device=dev)}}
    want = [x.clone() for x in tree_leaves(tree)]
    ckpt.save_async(str(tmp_path), 1, tree)
    with torch.no_grad():
        for x in tree_leaves(tree):
            x.add_(1)
    ckpt.wait_pending()
    got, step, _ = ckpt.restore(str(tmp_path), tree, device=dev)
    assert step == 1
    for x, w in zip(tree_leaves(got), want):
        assert x.device.type == "cuda" and x.dtype == w.dtype
        assert torch.equal(x, w)


def test_train_launcher_on_card(dev, tmp_path):
    """``launch.train.main`` on the card at smoke size: finite losses that
    fall, checkpoints and a resume, and a closing curation query over a
    sealed segment that launches ``ewah_decode`` and ``planfuse``."""
    from repro_torch.core.query import get_backend
    from repro_torch.launch import train

    get_backend("torch", device=dev).result_cache.clear()
    d = str(tmp_path / "ck")
    ops.reset_launches()
    metrics = train.main(["--steps", "6", "--ckpt-dir", d, "--ckpt-every",
                          "3"])
    assert ops.LAUNCHES["ewah_decode"] > 0 and ops.LAUNCHES["planfuse"] > 0
    losses = [m["loss"] for m in metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    more = train.main(["--steps", "8", "--ckpt-dir", d, "--resume"])
    assert [m["step"] for m in more] == [6, 7]


@pytest.fixture(scope="module")
def mesh11():
    """A 1x1 ("data", "model") mesh on one NCCL rank, its group destroyed
    after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from repro_torch.launch import mesh as mesh_mod

    mesh = mesh_mod.make_debug_mesh(1, 1, device_type="cuda")
    yield mesh
    mesh_mod.shutdown()


def test_mesh_train_step_on_card_matches_unsharded(dev, mesh11):
    """float32 ``train_step`` at microbatches 2 with the ZeRO moment
    shardings as gradient shardings, on the 1x1 NCCL mesh (DTensor
    parameters, moments and batch), against the unsharded call on the
    card from the same weights, moments and batch: one rank runs the same
    kernels, so losses, parameters and moments agree to 1e-6."""
    import copy

    import torch.distributed as dist

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.train import place_state
    from repro_torch.models.common import ShardingCtx
    from repro_torch.optim import OptConfig
    from repro_torch.train import train_step

    assert dist.get_backend() == "nccl"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cpu, card = lm_pair("tinyllama-1.1b", "float32", dev)
    placed = copy.deepcopy(card)
    r = np.random.default_rng(7)
    host = {k: torch.from_numpy(r.integers(0, cfg.vocab_size, (4, 32))
                                .astype(np.int32)).to(dev)
            for k in ("inputs", "labels")}
    _, opt = card_state(cfg, cpu, dev, 6)
    opt_m = copy.deepcopy(opt)
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    _, new, m = train_step(card, opt, host, cfg=cfg, opt_cfg=oc,
                           microbatches=2)
    with ShardingCtx(mesh11):
        opt_m = place_state(placed, opt_m, mesh11, cfg)
        batch = sh.distribute(host, sh.batch_shardings(mesh11, cfg, "train"))
        _, new_m, mm = train_step(
            placed, opt_m, batch, cfg=cfg, opt_cfg=oc, microbatches=2,
            grad_shardings=sh.opt_shardings(mesh11, cfg)["m"])
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(torch.as_tensor(mm[key]).cpu(),
                                   torch.as_tensor(m[key]).cpu(), rtol=1e-6,
                                   atol=1e-6, msg=key)
    for name, p in card.named_parameters():
        torch.testing.assert_close(
            dict(placed.named_parameters())[name].full_tensor(), p,
            rtol=0, atol=1e-6, msg=name)
        torch.testing.assert_close(new_m["m"][name].full_tensor(),
                                   new["m"][name], rtol=0, atol=1e-6,
                                   msg=name)
    assert int(new_m["step"].full_tensor()) == 4


def test_mesh_serve_step_on_card_matches_unsharded(dev, mesh11):
    """The fused prefill and six greedy ``serve_step`` calls on the 1x1
    NCCL mesh (DTensor parameters, tokens and cache) against the
    unsharded calls on the card: identical tokens, logits and caches at
    1e-6 (float32, one rank)."""
    import copy

    from repro_torch.dist import sharding as sh
    from repro_torch.models.common import ShardingCtx
    from repro_torch.serve.prefill import prefill_with_cache
    from repro_torch.train import serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in ("tinyllama-1.1b", "mamba2-1.3b"):
        cfg, _, card = lm_pair(arch, "float32", dev)
        placed = copy.deepcopy(card)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (4, 20)).astype(np.int32)).to(dev)
        with ShardingCtx(mesh11):
            sh.shard_params(placed, sh.param_shardings(mesh11, cfg))
            dtoks = sh.distribute({"inputs": toks}, sh.batch_shardings(
                mesh11, cfg, "prefill"))["inputs"]
        for name, model, t in (("one", card, toks), ("mesh", placed, dtoks)):
            with ShardingCtx(mesh11):
                logits, cache = prefill_with_cache(model, cfg, t, 32)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                got = [tok]
                for i in range(20, 26):
                    tok, cache = serve_step(model, tok, cache, i, cfg=cfg)
                    got.append(tok)
            out[name] = (sh.gather(logits),
                         torch.cat([sh.gather(x) for x in got], 1),
                         {k: sh.gather(v) for k, v in cache.items()})
        torch.testing.assert_close(out["mesh"][0], out["one"][0], rtol=0,
                                   atol=1e-6)
        assert torch.equal(out["mesh"][1], out["one"][1]), arch
        for k, v in out["one"][2].items():
            torch.testing.assert_close(out["mesh"][2][k], v, rtol=0,
                                       atol=1e-6, msg=k)


DRYRUN_SCRIPT = r"""
import json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec, specs_for

dryrun.fake_world(4)
mesh = make_mesh((2, 2), ("data", "model"), "cuda")
cfg = get_config("tinyllama-1.1b").smoke()
smoke = dryrun.measure_step(cfg, "train", specs_for(
    cfg, ShapeSpec("smoke", "train", 32, 8)), mesh)
smoke.pop("ops")
cell = dryrun.run_cell("zamba2-1.2b", "long_500k", False)
print("DRYRUN:" + json.dumps({"smoke": smoke, "cell": cell}))
"""


def test_dryrun_cells_on_a_cuda_fake_mesh(dev):
    """The dry run on a ``"cuda"`` fake mesh, in a subprocess (a process
    holds one default group): tinyllama-1.1b's smoke train step of 8 x 32
    tokens on a fake (2, 2) world counts collectives and per-rank FLOPs,
    and the full-width zamba2-1.2b long_500k cell (B = 1) on a fake 16x16
    world records ``ok`` on a cuda mesh."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("DRYRUN:")]
    res = json.loads(line[-1][len("DRYRUN:"):])
    assert res["smoke"]["collectives"]["total_bytes"] > 0
    assert res["smoke"]["cost"]["flops"] > 0
    cell = res["cell"]
    assert cell["status"] == "ok", cell.get("error")
    assert cell["mesh_device"] == "cuda" and cell["n_devices"] == 256
