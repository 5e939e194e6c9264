"""The port's distributed serving layer against the reference's.

``repro_torch.dist`` (checkpoint, query fan-out, serve plane) and
``repro_torch.data.metadata_index`` run beside ``repro.dist`` and
``repro.data.metadata_index`` on the same inputs:

* the checkpoint helpers leave the same step directories and pointer, and
  a sharded step written by either package is byte for byte the other's
  and restores in it;
* ``assign_segments`` / ``shard_ranges`` give the reference's placements;
* ``ShardedIndex`` (torch backend, ``device="cpu"``) answers like the
  reference's on numpy and like the port's single index;
* the wire frames are the reference's bytes, and a bad CRC, magic or
  version is refused;
* ``segment_state`` -> ``seal_from_state`` rebuilds a bit-identical
  segment, also from the reference's state;
* a 2-worker port plane on ``backend="torch", device="cpu"`` answers like
  the port's ``SegmentedIndex`` and the reference's ``SegmentedIndex`` on
  numpy over writers built identically in each package (the
  ``build_writer`` recipe of ``tests/test_serve_plane.py``), through a
  broadcast delete, TTL expiry and a save at 2 workers / restore at 3;
* ``backend="torch"`` on a machine without a card raises the worker's
  traceback in the coordinator;
* ``MetadataIndex`` answers like the reference's in all three topologies.

Inputs are made with numpy from fixed seeds.  Every comparison is exact
(row ids, stream words, counts, file bytes).  Every plane has a connect
and a reply timeout, so a hung worker fails its test.
"""

import os
import pickle
import socket
import zlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.segment import Segment as RSegment
from repro.data.metadata_index import MetadataIndex as RMeta
from repro.dist import checkpoint as rckpt
from repro.dist import query_fanout as rfan
from repro.dist import serve_plane as rsp
from repro_torch.core.segment import Segment as TSegment
from repro_torch.data.metadata_index import MetadataIndex as TMeta
from repro_torch.dist import checkpoint as tckpt
from repro_torch.dist import query_fanout as tfan
from repro_torch.dist import serve_plane as tsp
from test_torch_query import assert_columns_equal

T0 = 1000.0
KINDS = ["equality", "bitsliced", "bitsliced-gray", "binned", "roaring"]
CPU = {"device": "cpu"}
TIMEOUTS = {"connect_timeout": 60.0, "reply_timeout": 180.0}
SEGMENT = {"ref": RSegment, "port": TSegment}
CORE = {"ref": R, "port": T}


def preds(P):
    """The PREDS of tests/test_serve_plane.py, from package ``P``."""
    return [
        P.Eq(0, 5),
        P.Eq(1, 117),
        P.Range(1, 40, 160),
        P.In(2, [1, 7, 23]),
        P.And(P.Eq(0, 3), P.Not(P.Eq(2, 2))),
        P.Or(P.Range(1, 0, 30), P.Eq(2, 31)),
        P.Not(P.Eq(0, 0)),
    ]


def build_writer(pkg, clock, n_per=224):
    """tests/test_serve_plane.py's ``build_writer`` in package ``pkg``:
    one segment per encoding kind (the chooser pinned), three
    histogram-auto segments, staggered TTLs and a non-aligned open tail."""
    P, Seg = CORE[pkg], SEGMENT[pkg]
    spec = P.IndexSpec(encoding="auto")
    rng = np.random.default_rng(42)
    segs, pos = [], 0
    for i, kind in enumerate(KINDS + [None, None, None]):
        cols = [rng.integers(0, 12, n_per), rng.integers(0, 200, n_per),
                rng.integers(0, 40, n_per)]
        expiry = np.full(n_per, np.inf)
        expiry[::9] = T0 + 5.0 * (i + 1)
        chooser = None if kind is None else (lambda c, h, k, _k=kind: _k)
        segs.append(Seg.seal(cols, spec, row_start=pos, expiry=expiry,
                             encoding_chooser=chooser))
        pos += n_per
    w = P.IndexWriter.from_parts(spec, segments=tuple(segs), clock=clock)
    tail = [rng.integers(0, 12, 40), rng.integers(0, 200, 40),
            rng.integers(0, 40, 40)]
    w.append(tail, ttl=200.0)
    return w


def reference_answers(ref_writer, now):
    """(merged streams, row ids) of the reference's SegmentedIndex on
    numpy."""
    Q = preds(R)
    merged = [m.data for _, m in ref_writer.index.execute_compressed_many(
        Q, backend="numpy", now=now)]
    rows = [r for r, _ in ref_writer.index.query_many(Q, backend="numpy",
                                                      now=now)]
    return merged, rows


def assert_answers(surface, want, now, **opts):
    """Every query surface of ``surface`` (a SegmentedIndex or a
    ServePlane) gives the reference's streams, row ids and counts;
    ``words_scanned`` is not compared (it depends on result-cache hits)."""
    P = preds(T)
    merged, rows = want
    got = surface.execute_compressed_many(P, now=now, **opts)
    for p, w, (_, g) in zip(P, merged, got):
        np.testing.assert_array_equal(g.data, w, err_msg=f"stream of {p}")
    for p, w, (g, _) in zip(P, rows, surface.query_many(P, now=now,
                                                         **opts)):
        np.testing.assert_array_equal(g, w, err_msg=f"rows of {p}")
    counts = [len(r) for r in rows]
    if isinstance(surface, tsp.ServePlane):
        assert surface.count_many(P, now=now, **opts) == counts
    else:
        assert [surface.count(p, now=now, **opts) for p in P] == counts


# ---------------------------------------------------------------------------
# checkpoint helpers and the segment half
# ---------------------------------------------------------------------------


def pointer_history(ck, directory):
    """One sequence of step writes, flips (one stale) and prunes; returns
    what is on disk after each action."""
    seen = []
    os.makedirs(directory)
    os.makedirs(os.path.join(directory, "step_junk"))
    open(os.path.join(directory, "step_00000009"), "w").close()  # a file
    for step, keep in ((1, None), (2, None), (4, 2), (3, 2), (5, 1)):
        os.makedirs(ck._step_dir(directory, step))
        ck.flip_latest(directory, step)
        if keep is not None:
            ck._prune(directory, keep)
        seen.append((ck.available_steps(directory),
                     ck.latest_step(directory)))
    return seen


def test_pointer_scheme_matches_reference(tmp_path):
    ref = pointer_history(rckpt, str(tmp_path / "ref"))
    port = pointer_history(tckpt, str(tmp_path / "port"))
    assert port == ref
    assert port[-1] == ([5], 5)
    assert port[3][1] == 4           # a stale flip never moves it back
    assert tckpt.available_steps(str(tmp_path / "none")) == []
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def write_step(ck, sp, writer, directory, step, n_hosts=2):
    """A sharded step as the plane writes it, through package modules
    ``ck`` (checkpoint) and ``sp`` (serve_plane), without processes."""
    segs, buf = writer.snapshot()
    path = ck._step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    owners = sp.assign_segments(segs, n_hosts)
    acks = [ck.write_segment_dir(path, i, sp.segment_state(s))
            for i, s in enumerate(segs)]
    coord = ck.write_coordinator_state(path, {
        "spec": writer.spec.to_dict(), "names": None,
        "closed": writer.closed, "seal_rows": writer.seal_rows,
        "buffer": buf, "workload": None})
    ck.commit_sharded_step(directory, step, owners, acks, coord)


def tree_bytes(directory):
    out = {}
    for root, _, files in os.walk(directory):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, directory)] = fh.read()
    return out


def test_sharded_step_is_the_references_bytes(tmp_path):
    clock = lambda: T0
    rw, tw = build_writer("ref", clock), build_writer("port", clock)
    ids = np.arange(0, 500, 11)
    rw.delete(row_ids=ids)
    tw.delete(row_ids=ids)
    write_step(rckpt, rsp, rw, str(tmp_path / "ref"), 3)
    write_step(tckpt, tsp, tw, str(tmp_path / "port"), 3)
    ref, port = tree_bytes(tmp_path / "ref"), tree_bytes(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    assert len([k for k in port if k.endswith("state.npz")]) == 8
    for name in ref:
        assert port[name] == ref[name], name


def reseal_writer(pkg, directory, clock):
    """A writer from the newest sharded step, as ``ServePlane.restore``
    builds one, in package ``pkg`` (no processes)."""
    ck, sp = {"ref": (rckpt, rsp), "port": (tckpt, tsp)}[pkg]
    P = CORE[pkg]
    coord, states, step, _ = ck.load_sharded_step(directory)
    spec = P.IndexSpec.from_dict(coord["spec"])
    segs = [sp.seal_from_state(st, spec) for st in states]
    return P.IndexWriter.from_parts(spec, names=coord["names"],
                                    segments=segs, buffer=coord["buffer"],
                                    closed=coord["closed"], clock=clock), step


def test_port_step_restores_in_reference(tmp_path):
    clock = lambda: T0
    tw = build_writer("port", clock)
    tw.delete(row_ids=np.arange(100, 1900, 13))
    write_step(tckpt, tsp, tw, str(tmp_path), 7)
    rw, step = reseal_writer("ref", str(tmp_path), clock)
    assert step == 7
    assert_answers(tw.index, reference_answers(rw, T0), T0, **CPU)


def test_reference_step_restores_in_port_plane(tmp_path):
    clock = lambda: T0
    rw = build_writer("ref", clock)
    rw.delete(row_ids=np.arange(3, 1800, 17))
    write_step(rckpt, rsp, rw, str(tmp_path), 2)
    tw, _ = reseal_writer("port", str(tmp_path), clock)
    want = reference_answers(rw, T0)
    assert_answers(tw.index, want, T0, **CPU)
    with tsp.ServePlane.restore(str(tmp_path), n_hosts=2, clock=clock,
                                **TIMEOUTS) as plane:
        assert plane.restored_step == 2 and plane.world_size == 2
        assert_answers(plane, want, T0, **CPU)


def test_corrupt_segment_falls_back_a_step(tmp_path):
    clock = lambda: T0
    tw = build_writer("port", clock)
    write_step(tckpt, tsp, tw, str(tmp_path), 1)
    tw.delete(row_ids=np.arange(0, 300, 3))
    write_step(tckpt, tsp, tw, str(tmp_path), 2)
    victim = os.path.join(tckpt._step_dir(str(tmp_path), 2),
                          "segment_00003", "state.npz")
    with open(victim, "r+b") as f:
        f.seek(30)
        byte = f.read(1)
        f.seek(30)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(tckpt.CorruptCheckpoint, match="CRC"):
        tckpt.read_segment_dir(tckpt._step_dir(str(tmp_path), 2), 3)
    for pkg in ("ref", "port"):
        _, step = reseal_writer(pkg, str(tmp_path), clock)
        assert step == 1


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class _FakeSeg:
    def __init__(self, words):
        self._words = words

    def size_words(self):
        return self._words


@pytest.mark.parametrize("n_rows", [0, 1, 31, 32, 33, 1000, 65_537])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, 64])
def test_shard_ranges_match_reference(n_rows, n_shards):
    assert tfan.shard_ranges(n_rows, n_shards) == \
        rfan.shard_ranges(n_rows, n_shards)


@pytest.mark.parametrize("sizes", [[100] * 8, [50] * 16, [10_000] + [10] * 6,
                                   [0, 0], [5], [], [3, 900, 1, 1, 70, 2]])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 8])
def test_assign_segments_matches_reference(sizes, n_hosts):
    segs = [_FakeSeg(s) for s in sizes]
    assert tfan.assign_segments(segs, n_hosts) == \
        rfan.assign_segments(segs, n_hosts)


def test_placement_rejects_empty_worlds():
    with pytest.raises(ValueError):
        tfan.assign_segments([_FakeSeg(1)], 0)
    with pytest.raises(ValueError):
        tfan.shard_ranges(10, 0)


# ---------------------------------------------------------------------------
# in-process fan-out
# ---------------------------------------------------------------------------


def test_sharded_index_matches_reference_and_single_index():
    rng = np.random.default_rng(5)
    cols = [rng.integers(0, 12, 1000), rng.integers(0, 200, 1000),
            rng.integers(0, 40, 1000)]
    rs = rfan.ShardedIndex.build(cols, R.IndexSpec(encoding="auto"),
                                 n_shards=4)
    ts = tfan.ShardedIndex.build(cols, T.IndexSpec(encoding="auto"),
                                 n_shards=4)
    single = T.IndexWriter(T.IndexSpec(encoding="auto"))
    single.append(cols)
    single.close()
    assert ts.n_shards == rs.n_shards == 4 and ts.n_rows == 1000
    assert ts.size_words() == rs.size_words()
    for tsh, rsh in zip(ts.shards, rs.shards):
        assert (tsh.row_start, tsh.row_stop) == (rsh.row_start, rsh.row_stop)
        for tc, rc in zip(tsh.index.columns, rsh.index.columns):
            assert_columns_equal(tc, rc)

    def agree():
        for p, q in zip(preds(T), preds(R)):
            want, _ = rs.query(q, backend="numpy")
            got, _ = ts.query(p, **CPU)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                single.index.query(p, **CPU)[0], want)
            _, tm = ts.execute_compressed(p, **CPU)
            _, rm = rs.execute_compressed(q, backend="numpy")
            np.testing.assert_array_equal(tm.data, rm.data)
        for (g, _), (w, _) in zip(ts.query_many(preds(T), **CPU),
                                  rs.query_many(preds(R), backend="numpy")):
            np.testing.assert_array_equal(g, w)

    agree()
    ids = np.arange(7, 1000, 9)
    assert ts.delete(row_ids=ids) == rs.delete(row_ids=ids)
    single.delete(row_ids=ids, backend="numpy")
    agree()
    assert ts.delete(T.Eq(0, 4), backend="numpy") == \
        rs.delete(R.Eq(0, 4), backend="numpy")
    single.delete(T.Eq(0, 4), backend="numpy")
    agree()


# ---------------------------------------------------------------------------
# wire framing and segment state
# ---------------------------------------------------------------------------


def frame_bytes(mod, op, payload):
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    try:
        n = mod.send_msg(a, op, payload)
        got = b""
        while len(got) < n:
            got += b.recv(n - len(got))
        return got
    finally:
        a.close()
        b.close()


PAYLOADS = [
    {},
    {"rank": 3, "pid": 12345},
    {"xs": np.arange(5), "s": "héllo", "n": 7},
    {"ids": np.arange(0, 500, 11, dtype=np.int64)},
    {"preds": [("eq", 0, 5)], "now": 1000.5, "backend": "torch",
     "opts": {"device": "cpu"}, "gens": [1, 2, 3]},
]


@pytest.mark.parametrize("case", range(len(PAYLOADS)))
def test_wire_frames_are_the_references_bytes(case):
    payload = PAYLOADS[case]
    port = frame_bytes(tsp, "ship", payload)
    assert port == frame_bytes(rsp, "ship", payload)
    a, b = socket.socketpair()
    b.settimeout(10)
    try:
        a.sendall(port)
        op, got, n = tsp.recv_msg(b)
    finally:
        a.close()
        b.close()
    assert op == "ship" and n == len(port)
    assert pickle.dumps(got) == pickle.dumps(payload)


def test_result_blobs_are_the_references_bytes():
    words = np.random.default_rng(1).integers(0, 2**32, 40, dtype=np.uint32)
    words[5:25] = 0
    t = T.ewah_stream.EwahStream(T.ewah.compress(words), 1280, 9)
    r = R.ewah_stream.EwahStream(R.ewah.compress(words), 1280, 9)
    assert t.to_bytes() == r.to_bytes()
    back = T.ewah_stream.EwahStream.from_bytes(r.to_bytes())
    np.testing.assert_array_equal(back.data, r.data)


@pytest.mark.parametrize("bad", ["crc", "magic", "version"])
def test_wire_refuses_bad_frames(bad):
    body = pickle.dumps(("ship", {"n": 7}))
    crc, magic, version = zlib.crc32(body), tsp._FRAME_MAGIC, 1
    if bad == "crc":
        body = body[:3] + bytes([body[3] ^ 0xFF]) + body[4:]
    elif bad == "magic":
        magic = b"NOPE"
    else:
        version = 2
    frame = tsp._FRAME.pack(magic, version, 0, 0, len(body), crc)
    a, b = socket.socketpair()
    b.settimeout(10)
    try:
        a.sendall(frame + body)
        with pytest.raises(tsp.WireError, match=bad.upper() if bad == "crc"
                           else bad):
            tsp.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_frame_layout_is_the_references():
    assert tsp._FRAME.format == rsp._FRAME.format == "<4sBBHQI"
    assert tsp._FRAME_MAGIC == rsp._FRAME_MAGIC == b"SPLN"
    assert tsp._FRAME_VERSION == rsp._FRAME_VERSION == 1


def tombstoned_segment(pkg):
    rng = np.random.default_rng(3)
    n = 160
    keep = np.sort(rng.choice(200, size=n, replace=False)).astype(np.int64)
    expiry = np.full(n, np.inf)
    expiry[::5] = T0 + 3
    seg = SEGMENT[pkg].seal(
        [rng.integers(0, 9, n), rng.integers(0, 300, n)],
        CORE[pkg].IndexSpec(encoding="auto"), row_start=int(keep[0]),
        span_stop=205, row_ids=keep, expiry=expiry,
        encoding_chooser=lambda c, h, k: "roaring" if c == 0 else None)
    seg.delete_ids(keep[::7])
    return seg


def assert_segments_equal(got, want):
    np.testing.assert_array_equal(got.index.row_perm, want.index.row_perm)
    assert list(got.index.encodings()) == list(want.index.encodings())
    assert got.index.size_words() == want.index.size_words()
    for gc, wc in zip(got.index.columns, want.index.columns):
        assert_columns_equal(gc, wc)
    assert (got.row_start, got.row_stop) == (want.row_start, want.row_stop)
    np.testing.assert_array_equal(got.ingest_ids(), want.ingest_ids())
    np.testing.assert_array_equal(got.dead_ids(T0 + 10),
                                  want.dead_ids(T0 + 10))


@pytest.mark.parametrize("source", ["port", "ref"])
def test_segment_state_reseals_bit_identically(source):
    """The port's seal_from_state over the port's or the reference's
    segment_state rebuilds the segment bit for bit; both packages' state
    dicts hold the same arrays."""
    seg = tombstoned_segment(source)
    state = (tsp if source == "port" else rsp).segment_state(seg)
    rebuilt = tsp.seal_from_state(state, T.IndexSpec(encoding="auto"))
    assert_segments_equal(rebuilt, tombstoned_segment("port"))
    other = rsp.segment_state(tombstoned_segment("ref")) \
        if source == "port" else tsp.segment_state(tombstoned_segment("port"))
    for key in ("row_start", "span_stop", "n_rows", "encodings"):
        assert state[key] == other[key]
    for key in ("row_ids", "expiry", "dead"):
        np.testing.assert_array_equal(state[key], other[key])
    for a, b in zip(state["columns"], other["columns"]):
        np.testing.assert_array_equal(a, b)


def test_segment_state_edges():
    seg = TSegment.seal([np.arange(64) % 5], None, keep_columns=False)
    with pytest.raises(ValueError, match="keep_columns"):
        tsp.segment_state(seg)
    rebuilt = tsp.seal_from_state(tsp.segment_state(TSegment.empty(96, 160)),
                                  None)
    assert rebuilt.n_rows == 0
    assert (rebuilt.row_start, rebuilt.row_stop) == (96, 160)


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


def test_two_host_plane_matches_segmented_and_reference(tmp_path):
    clock = [T0]
    now = lambda: clock[0]
    ref = build_writer("ref", now)
    mine = build_writer("port", now)
    with tsp.ServePlane(build_writer("port", now), n_hosts=2,
                        **TIMEOUTS) as plane:
        assert plane.world_size == 2
        for surface in (plane, mine.index):
            assert_answers(surface, reference_answers(ref, T0), T0, **CPU)
        assert len(set(plane._owner_of.values())) == 2

        # a delete by id broadcasts to the owners and the open buffer
        ids = np.concatenate([np.arange(50, 400, 7), np.arange(1800, 1835)])
        assert ref.delete(row_ids=ids) == mine.delete(row_ids=ids) == \
            plane.delete(row_ids=ids)
        # a predicate delete resolves to one row set everywhere
        assert ref.delete(R.Eq(2, 9), now=T0) == \
            mine.delete(T.Eq(2, 9), backend="numpy", now=T0) == \
            plane.delete(T.Eq(2, 9), backend="numpy", now=T0)
        # TTLs: past three segments' deadlines
        clock[0] = T0 + 16.0
        want = reference_answers(ref, clock[0])
        for surface in (plane, mine.index):
            assert_answers(surface, want, clock[0], **CPU)
        stats = plane.stats()
        assert stats["ship_bytes"] > 0
        assert 0 < stats["result_bytes_compressed"]
        assert stats["result_bytes_dense"] > 0
        assert stats["worker_launches"] == {}   # plain versions: no kernel
        plane.save_checkpoint(str(tmp_path), 1)

    with tsp.ServePlane.restore(str(tmp_path), n_hosts=3, clock=now,
                                **TIMEOUTS) as restored:
        assert restored.restored_step == 1 and restored.world_size == 3
        assert_answers(restored, want, clock[0], **CPU)
        assert len(set(restored._owner_of.values())) == 3
    # the plane's own step loads in the reference too
    rw, step = reseal_writer("ref", str(tmp_path), now)
    assert step == 1
    merged, rows = reference_answers(rw, clock[0])
    for a, b in zip(rows, want[1]):
        np.testing.assert_array_equal(a, b)


def test_torch_plane_needs_a_card():
    """No fallback: the torch backend in a worker on a machine without a
    card raises, and the coordinator re-raises that worker's traceback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the torch backend runs on it")
    with tsp.ServePlane(build_writer("port", lambda: T0, n_per=96),
                        n_hosts=2, **TIMEOUTS) as plane:
        with pytest.raises(RuntimeError) as err:
            plane.query(T.Eq(0, 5), now=T0)
        msg = str(err.value)
        assert "worker" in msg and "Traceback" in msg
        assert "CUDA device and none is available" in msg
        # the plane still answers on the host afterwards
        rows, _ = plane.query(T.Eq(0, 5), backend="numpy", now=T0)
        assert len(rows) > 0


# ---------------------------------------------------------------------------
# MetadataIndex
# ---------------------------------------------------------------------------

TOPOLOGIES = {"segmented": {"hosts": 0}, "fanout": {"query_fanout": 4},
              "plane": {"hosts": 2}}


def metadata_batches(n_batches=3, n=2048, seed=0):
    """TokenPipeline's cardinalities (8 sources, 32 domains, 10 quality
    bins, 8 length bins), drawn uniformly."""
    r = np.random.default_rng(seed)
    return [{"source": r.integers(0, 8, n), "domain": r.integers(0, 32, n),
             "quality_bin": r.integers(0, 10, n),
             "length_bin": r.integers(0, 8, n)} for _ in range(n_batches)]


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_metadata_index_matches_reference(topology):
    kw = TOPOLOGIES[topology]
    ref = RMeta(**kw)
    mine = TMeta(**kw, plane_opts=TIMEOUTS)
    try:
        batches = metadata_batches()
        for b in batches:
            ref.add_batch(b)
            mine.add_batch(b)
        cols = {c: np.concatenate([b[c] for b in batches])
                for c in TMeta.COLS}
        alive = np.ones(len(cols["source"]), dtype=bool)

        def agree():
            rows, _ = mine.query(where={"domain": 3, "quality_bin": 8},
                                 **CPU)
            want, _ = ref.query(where={"domain": 3, "quality_bin": 8},
                                backend="numpy")
            np.testing.assert_array_equal(rows, want)
            np.testing.assert_array_equal(rows, np.flatnonzero(
                (cols["domain"] == 3) & (cols["quality_bin"] == 8) & alive))
            for p, q, mask in (
                    (T.In("domain", [1, 3]), R.In("domain", [1, 3]),
                     np.isin(cols["domain"], [1, 3])),
                    (T.And(T.Eq("source", 2), T.Range("quality_bin", 8, 9)),
                     R.And(R.Eq("source", 2), R.Range("quality_bin", 8, 9)),
                     (cols["source"] == 2) & (cols["quality_bin"] >= 8))):
                rows, _ = mine.query_pred(p, **CPU)
                np.testing.assert_array_equal(
                    rows, ref.query_pred(q, backend="numpy")[0])
                np.testing.assert_array_equal(rows,
                                              np.flatnonzero(mask & alive))
            rows, _ = mine.query(where={"domain": 3}, backend="numpy")
            np.testing.assert_array_equal(
                rows, np.flatnonzero((cols["domain"] == 3) & alive))

        agree()
        gone = (cols["length_bin"] == 5) & (cols["source"] == 1)
        assert mine.delete(where={"length_bin": 5, "source": 1},
                           backend="numpy") == \
            ref.delete(where={"length_bin": 5, "source": 1}) == gone.sum()
        alive &= ~gone
        agree()
        assert mine.size_words() == ref.size_words()
        with pytest.raises(ValueError, match="unknown columns"):
            mine.query(where={"bogus": 1})
        assert len(mine.query()[0]) == 0
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("opts", [{"backend": "numpy"},
                                  {"backend": "torch", "device": "cpu"}],
                         ids=["numpy", "torch-cpu"])
def test_metadata_index_query_legacy_shims_removed(opts):
    """The reference's ``test_metadata_index_query_legacy_shims_removed``
    on the port: a condition as a bare keyword and the backend as
    ``_backend=`` raise TypeError, with or without ``where`` (and without
    a card: the torch backend's constructor is read, not called)."""
    import warnings

    mi = TMeta()
    mi.add_batch(metadata_batches(1, 96, seed=3)[0])
    for bad in ({"domain": 2}, {"_backend": "numpy"}):
        with pytest.raises(TypeError, match=next(iter(bad))):
            mi.query(**opts, **bad)
        with pytest.raises(TypeError, match=next(iter(bad))):
            mi.query(where={"domain": 2}, **opts, **bad)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the supported spelling is silent
        rows, _ = mi.query(where={"domain": 2}, **opts)
    assert len(rows) > 0
    want = RMeta()
    want.add_batch(metadata_batches(1, 96, seed=3)[0])
    np.testing.assert_array_equal(
        rows, want.query(where={"domain": 2}, backend="numpy")[0])
    assert len(mi.query(**opts)[0]) == 0


def test_metadata_index_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    mi = TMeta()
    mi.add_batch(metadata_batches(1, 256)[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        mi.query(where={"domain": 3})
    with pytest.raises(ValueError, match="pick one"):
        TMeta(hosts=2, query_fanout=4)
