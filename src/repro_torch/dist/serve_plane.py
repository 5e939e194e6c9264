"""Multi-host segment-parallel serving: the cross-process serve plane.

:class:`ServePlane` turns the single-process segmented engine into a
coordinator + N worker processes, one segment-subset per worker.  A copy
of the reference's ``repro.dist.serve_plane`` whose workers run this
package (``python -m repro_torch.dist.serve_plane``) and execute on the
card:

* **Placement.**  The coordinator owns the authoritative
  :class:`~repro_torch.core.lifecycle.IndexWriter` (appends, deletes,
  seals, compactions all land there first).  Every query first *syncs*:
  it snapshots the writer's segment list, computes the ownership map with
  :func:`~repro_torch.dist.query_fanout.assign_segments` (word-aligned
  carving of the cumulative compressed word space — the same splitter the
  in-process fan-out uses), and ships any new or reassigned segment to
  its owner.  Compaction changes the generation list, so ownership
  rebalances automatically at the next sync.

* **Shipping.**  A segment crosses the wire as its *reconstruction
  state* (:func:`segment_state`): ingest-order raw columns, id-span
  bounds, ``row_ids``/``expiry``, the ingest-local tombstoned positions,
  and the per-original-column encoding kinds the seal chose.  The worker
  re-runs the deterministic seal pipeline (:func:`seal_from_state`) with
  those kinds pinned, producing a bit-identical local index — per-plane
  bitmaps never cross the wire in either direction.

* **Execution.**  The coordinator fans a query batch out to every owner
  (all sends first, then all receives — workers compute in parallel).
  Each worker executes its segments' plans through the backend the query
  names, the torch backend on the card by default (every worker opens its
  own CUDA context; several share one card), keeps one backend instance
  per ``(name, options)`` across requests (tape memo and result cache),
  and replies with **compressed**
  :meth:`~repro_torch.core.ewah_stream.EwahStream.to_bytes` result streams
  — results are never densified for transport — plus the kernel launches
  the request made in that process (``launches``, a field the reference's
  reply lacks).  The coordinator evaluates the open buffer densely (it
  owns those rows), stitches per-segment streams with
  :func:`~repro_torch.core.ewah_stream.concat_streams`, and returns
  original-ingest-order row ids — bit-identical to
  :class:`~repro_torch.core.segment.SegmentedIndex` over the same writer.

* **Checkpointing.**  :meth:`ServePlane.save_checkpoint` runs the
  two-phase commit barrier from :mod:`repro_torch.dist.checkpoint`: phase
  1, every worker writes the segment directories it owns (the coordinator
  writes zero-row segments and the writer-level buffer state) and acks
  per-file CRCs; phase 2, the coordinator verifies every ack, fsyncs the
  manifest, atomically flips ``LATEST``, and only then prunes old steps.
  :meth:`ServePlane.restore` reassembles a writer from the manifest and
  re-shards ownership over the *current* world size.  The format is the
  reference's, so either package restores the other's steps.

Transport is length-prefixed CRC-framed pickle over a loopback TCP
socket pair per worker, byte for byte the reference's framing (workers
are subprocesses this coordinator spawned — a trusted, same-user
transport; the framing is for integrity and the EWAH payloads
additionally carry their own versioned header + CRC via
``EwahStream.to_bytes``).

Query and delete entry points default to ``backend="torch"``: the
reference defaults to ``"numpy"``, the port answers on the card.  A
worker asked for the torch backend on a machine without a card raises,
and the coordinator re-raises the worker's traceback; on the host pass
``device="cpu"`` (it travels to the workers with the backend options) or
``backend="numpy"``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import struct
import subprocess
import sys
import time
import zlib
from time import perf_counter

import numpy as np

from ..analysis.runtime import make_lock, maybe_validate
from ..core import ewah
from ..core.bitmap_index import _observe_workload
from ..core.ewah_stream import EwahStream, concat_streams
from ..core.lifecycle import IndexWriter
from ..core.query import compile_plan, evaluate_mask, get_backend, \
    with_live_mask
from ..core.segment import Segment
from ..core.strategies import IndexSpec
from . import checkpoint as ckpt
from .query_fanout import assign_segments

__all__ = ["ServePlane", "WireError", "WorkerError", "seal_from_state",
           "segment_state", "worker_main"]


# ---------------------------------------------------------------------------
# Wire framing: <magic 4s> <version u8> <kind u8> <flags u16> <len u64>
# <crc u32>, then `len` payload bytes (pickle of an (op, payload) pair).
# ---------------------------------------------------------------------------

_FRAME = struct.Struct("<4sBBHQI")
_FRAME_MAGIC = b"SPLN"
_FRAME_VERSION = 1


class WireError(RuntimeError):
    """A frame failed validation (bad magic/version/CRC) or the peer hung
    up mid-message."""


class WorkerError(RuntimeError):
    """A worker raised while it handled a request; the message carries its
    traceback."""


def send_msg(sock, op: str, payload) -> int:
    """Frame and send one message; returns the bytes put on the wire."""
    body = pickle.dumps((op, payload), protocol=pickle.HIGHEST_PROTOCOL)
    frame = _FRAME.pack(_FRAME_MAGIC, _FRAME_VERSION, 0, 0, len(body),
                        zlib.crc32(body))
    sock.sendall(frame + body)
    return len(frame) + len(body)


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n:
        got = sock.recv(min(n, 1 << 20))
        if not got:
            raise WireError("peer closed the connection mid-message")
        chunks.append(got)
        n -= len(got)
    return b"".join(chunks)


def recv_msg(sock):
    """Receive one framed message; returns ``(op, payload, wire_bytes)``."""
    header = _recv_exact(sock, _FRAME.size)
    magic, version, _kind, _flags, length, crc = _FRAME.unpack(header)
    if magic != _FRAME_MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    if version != _FRAME_VERSION:
        raise WireError(f"unsupported frame version {version}")
    body = _recv_exact(sock, length)
    if zlib.crc32(body) != crc:
        raise WireError("frame payload CRC mismatch")
    op, payload = pickle.loads(body)
    return op, payload, _FRAME.size + length


# ---------------------------------------------------------------------------
# Segment <-> state dict: what crosses the wire and what checkpoints hold.
# ---------------------------------------------------------------------------


def segment_state(seg: Segment) -> dict:
    """A segment's reconstruction state: everything a peer needs to
    re-seal a bit-identical copy (and everything a checkpoint persists).

    ``dead`` captures the tombstone set at snapshot time as ingest-local
    positions (TTL deadlines travel separately in ``expiry`` and re-fold
    against the query-time clock on the receiving side — folding is
    idempotent, so a fold that already happened here never double-counts
    there).  ``encodings`` pins the per-original-column kinds this seal
    chose, so the receiver reproduces them even when they came from a
    workload-driven compaction chooser rather than the spec."""
    if seg.columns is None:
        raise ValueError(
            f"segment gen {seg.generation} was sealed with "
            "keep_columns=False; its row store is gone and it cannot be "
            "shipped or checkpointed")
    idx = seg.index
    return {
        "gen": int(seg.generation),
        "row_start": int(seg.row_start),
        "span_stop": None if seg.span_stop is None else int(seg.span_stop),
        "n_rows": int(seg.n_rows),
        "columns": [np.asarray(c) for c in seg.columns],
        "row_ids": seg.row_ids,
        "expiry": seg.expiry,
        "dead": np.flatnonzero(seg.dead_ingest_mask(None)),
        "encodings": {int(idx.col_perm[i]): idx.columns[i].encoding.kind
                      for i in range(len(idx.columns))},
    }


def seal_from_state(state: dict, spec: IndexSpec | None, *,
                    materialize: bool = True,
                    keep_columns: bool = True) -> Segment:
    """Re-run the deterministic seal pipeline on a :func:`segment_state`
    dict.  The recorded encoding kinds are pinned through the chooser
    hook, so the rebuilt index is bit-identical to the original
    regardless of what chooser produced those kinds."""
    row_start = int(state["row_start"])
    span_stop = state.get("span_stop")
    if not int(state["n_rows"]):
        return Segment.empty(row_start,
                             row_start if span_stop is None
                             else int(span_stop))
    kinds = {int(k): v for k, v in (state.get("encodings") or {}).items()}
    dead = state.get("dead")
    return Segment.seal(
        state["columns"], spec, row_start=row_start,
        span_stop=None if span_stop is None else int(span_stop),
        row_ids=state.get("row_ids"), expiry=state.get("expiry"),
        tombstone_rows=None if dead is None else np.asarray(dead,
                                                            dtype=np.int64),
        materialize=materialize, keep_columns=keep_columns,
        encoding_chooser=lambda col, hist, k: kinds.get(int(col)))


def _empty_stream() -> EwahStream:
    return EwahStream(ewah.compress(np.zeros(0, dtype=np.uint32)), 0, 0)


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


class ServePlane:
    """Coordinator for a fleet of segment-owning worker processes.

    Wraps (or creates) an :class:`~repro_torch.core.lifecycle.IndexWriter`;
    ingest mutations go straight to the writer and propagate to workers
    lazily at the next sync.  Query surfaces (`query`, `query_many`,
    `count`, `count_many`) match ``SegmentedIndex`` bit-for-bit.

    Lock order: ``_lock`` (reentrant) before the writer's ``_lock``,
    never the reverse — the plane never runs inside writer callbacks.
    Counters: ``result_bytes_compressed`` / ``result_bytes_dense`` track
    what result shipping cost versus what dense (1 bit/row) shipping
    would have cost; ``ship_bytes`` counts segment-state shipping;
    ``worker_launches`` sums the kernel launches the workers' query
    replies report, by kernel.

    ``connect_timeout`` bounds the workers' start (seconds until every
    worker has dialled back); ``reply_timeout`` bounds each wait for a
    worker's reply (None waits forever), so a hung worker raises instead
    of hanging the coordinator.
    """

    def __init__(self, writer: IndexWriter | None = None, *,
                 n_hosts: int = 2, spec: IndexSpec | None = None,
                 names=None, seal_rows: int | None = None,
                 clock=time.time, workload_stats=None,
                 connect_timeout: float = 60.0,
                 reply_timeout: float | None = None):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.writer = writer if writer is not None else IndexWriter(
            spec, names=names, seal_rows=seal_rows, clock=clock,
            workload_stats=workload_stats)
        self.n_hosts = int(n_hosts)
        self._lock = make_lock("serve_plane._lock")
        self._procs: list = []        # guarded-by: _lock
        self._socks: list = []        # guarded-by: _lock
        self._owner_of: dict = {}     # guarded-by: _lock  gen -> rank
        self._closed = False          # guarded-by: _lock
        self.ship_bytes = 0                 # guarded-by: _lock
        self.result_bytes_compressed = 0    # guarded-by: _lock
        self.result_bytes_dense = 0         # guarded-by: _lock
        self.worker_launches: dict = {}     # guarded-by: _lock
        self.reply_timeout = reply_timeout
        self.restored_step: int | None = None
        with self._lock:
            self._spawn(connect_timeout)

    # -- process management ------------------------------------------------

    def _spawn(self, connect_timeout: float) -> None:  # holds-lock: _lock
        import repro_torch

        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.bind(("127.0.0.1", 0))
        listener.listen(self.n_hosts)
        listener.settimeout(connect_timeout)
        host, port = listener.getsockname()
        # the directory that holds the repro_torch package must be
        # importable in the workers
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        try:
            for rank in range(self.n_hosts):
                self._procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.dist.serve_plane",
                     "--worker", "--connect", f"{host}:{port}",
                     "--rank", str(rank),
                     "--connect-timeout", str(connect_timeout)],
                    env=env))
            by_rank: dict = {}
            while len(by_rank) < self.n_hosts:
                conn, _ = listener.accept()
                conn.settimeout(self.reply_timeout)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                op, payload, _ = recv_msg(conn)
                if op != "hello":
                    raise WireError(f"expected hello, got {op!r}")
                by_rank[int(payload["rank"])] = conn
            self._socks = [by_rank[r] for r in range(self.n_hosts)]
            cfg = {"spec": self.writer.spec.to_dict(),
                   "names": (None if self.writer.names is None
                             else list(self.writer.names))}
            for sock in self._socks:
                send_msg(sock, "config", cfg)
            for rank in range(self.n_hosts):
                self._reply(rank)
        except BaseException:
            self._kill_workers()
            raise
        finally:
            listener.close()

    def _reply(self, rank: int):  # holds-lock: _lock
        op, payload, n = recv_msg(self._socks[rank])
        if op == "error":
            raise WorkerError(
                f"worker {rank} failed:\n{payload['traceback']}")
        if op != "ok":
            raise WireError(f"worker {rank}: unexpected reply {op!r}")
        return payload, n

    def _replies(self, ranks) -> dict:  # holds-lock: _lock
        """Every rank's reply payload, all read before a worker's error
        is raised, so that no reply is left unread on another worker's
        socket to answer the next request."""
        out, errors = {}, []
        for rank in ranks:
            try:
                out[rank], _ = self._reply(rank)
            except WorkerError as exc:
                errors.append(exc)
        if errors:
            raise errors[0]
        return out

    def _kill_workers(self) -> None:  # holds-lock: _lock
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self._procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self._socks, self._procs = [], []

    @property
    def world_size(self) -> int:
        return len(self._socks)  # analysis-ok: lock/unguarded-read atomic list-reference snapshot

    def __enter__(self) -> "ServePlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Shut the worker fleet down (the writer stays usable)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for rank, sock in enumerate(self._socks):
                try:
                    send_msg(sock, "shutdown", {})
                    self._reply(rank)
                except (OSError, WireError, RuntimeError):
                    pass
            self._kill_workers()

    # -- ingest passthrough ------------------------------------------------

    def append(self, rows, *, ttl=None) -> None:
        self.writer.append(rows, ttl=ttl)

    def seal(self):
        return self.writer.seal()

    def writer_close(self):
        """Seal the final segment and close the writer for appends (the
        plane keeps serving; :meth:`close` shuts the fleet down)."""
        return self.writer.close()

    def compact(self, span=None, **kw):
        return self.writer.compact(span, **kw)

    def delete(self, pred=None, *, row_ids=None, backend: str = "torch",
               now=None) -> int:
        """Tombstone rows everywhere: the authoritative writer first, then
        a broadcast to every worker (each ignores ids outside its owned
        spans).  Predicate deletes resolve to ids through a plane query at
        a single ``now`` so both sides tombstone the identical row set."""
        if (pred is None) == (row_ids is None):
            raise ValueError("delete needs exactly one of pred= or row_ids=")
        with self._lock:
            now = self.writer.clock() if now is None else float(now)
            if row_ids is None:
                ids, _ = self.query(pred, backend=backend, now=now)
            else:
                ids = np.unique(np.asarray(row_ids, dtype=np.int64))
            deleted = self.writer.delete(row_ids=ids, now=now)
            for sock in self._socks:
                send_msg(sock, "delete_ids", {"ids": ids})
            self._replies(range(len(self._socks)))
        return deleted

    # -- sync: ship the ownership map's deltas -----------------------------

    def _sync_locked(self):  # holds-lock: _lock
        """Snapshot the writer and bring every worker's owned set up to
        date; returns ``(segments, buffer, owner_of)`` for that snapshot.
        Ownership is recomputed from scratch each time — compaction or
        growth changes the generation list and segments re-home to keep
        the compressed-word load balanced."""
        segs, buf = self.writer.snapshot()
        owners = assign_segments(segs, len(self._socks))
        new_owner = {}
        ship: list = [[] for _ in self._socks]
        for seg, owner in zip(segs, owners):
            if not seg.n_rows:
                continue  # zero-row spans never ship; stitched locally
            new_owner[seg.generation] = owner
            if self._owner_of.get(seg.generation) != owner:
                ship[owner].append(seg)
        drop: list = [[] for _ in self._socks]
        for gen, owner in self._owner_of.items():
            if new_owner.get(gen) != owner:
                drop[owner].append(gen)
        pending = []
        for rank, sock in enumerate(self._socks):
            if ship[rank] or drop[rank]:
                states = [segment_state(s) for s in ship[rank]]
                self.ship_bytes += send_msg(
                    sock, "ship", {"segments": states, "drop": drop[rank]})
                pending.append(rank)
        self._replies(pending)
        self._owner_of = new_owner
        return segs, buf, new_owner

    def sync(self) -> int:
        """Ship the ownership map's deltas to the workers now (every query
        does this first); returns the bytes this sync put on the wire."""
        with self._lock:
            if self._closed:
                raise ValueError("serve plane is closed")
            before = self.ship_bytes
            self._sync_locked()
            return self.ship_bytes - before

    # -- execution ---------------------------------------------------------

    def _now(self, now):
        return self.writer.clock() if now is None else float(now)

    def _execute_many(self, preds, backend, now, backend_opts):
        """Mirror of ``SegmentedIndex._execute_many`` with the per-segment
        execution fanned out across worker processes; returns
        ``(segments, buffer, triples)`` against one synced snapshot."""
        preds = list(preds)
        with self._lock:
            if self._closed:
                raise ValueError("serve plane is closed")
            now = self._now(now)
            segs, buf, owner_of = self._sync_locked()
            names = self.writer.names
            # owned[rank] = ordered indices into segs (the reply's stream
            # order is this order, per predicate)
            owned: list = [[] for _ in self._socks]
            for i, seg in enumerate(segs):
                if seg.n_rows:
                    owned[owner_of[seg.generation]].append(i)
            active = [r for r in range(len(self._socks)) if owned[r]]
            for r in active:  # all sends first: workers compute in parallel
                send_msg(self._socks[r], "query", {
                    "preds": preds, "now": now, "backend": backend,
                    "opts": backend_opts,
                    "gens": [segs[i].generation for i in owned[r]]})
            replies = self._replies(active)
            from ..workload import merge_snapshots

            for payload in replies.values():
                merge_snapshots([payload.get("workload")],
                                stats=self.writer.workload_stats)
                for kernel, n in payload["launches"].items():
                    self.worker_launches[kernel] = (
                        self.worker_launches.get(kernel, 0) + n)
            # where does segment i's stream sit in its owner's reply?
            slot = {}
            for r in active:
                for j, i in enumerate(owned[r]):
                    slot[i] = j
            total_rows = (sum(s.n_rows for s in segs)
                          + (len(buf[1]) if buf is not None else 0))
            out = []
            for p_i, pred in enumerate(preds):
                per_seg, scanned = [], 0
                for i, seg in enumerate(segs):
                    if not seg.n_rows:
                        per_seg.append(_empty_stream())
                        continue
                    r = owner_of[seg.generation]
                    blob = replies[r]["streams"][p_i][slot[i]]
                    got = EwahStream.from_bytes(blob)
                    words_scanned = replies[r]["scanned"][p_i][slot[i]]
                    per_seg.append(EwahStream(got.data, got.n_rows,
                                              words_scanned))
                    # what shipping this result cost vs a dense 1-bit/row
                    # bitmap of the same segment
                    self.result_bytes_compressed += len(blob)
                    self.result_bytes_dense += 4 * (
                        (seg.n_rows + ewah.WORD_BITS - 1) // ewah.WORD_BITS)
                parts = [s.data for s in per_seg]
                scanned = sum(s.words_scanned for s in per_seg)
                buf_rows = None
                if buf is not None:
                    cols, bdel, bexp = buf
                    mask = evaluate_mask(pred, cols, names=names)
                    mask &= ~bdel & (bexp > now)
                    buf_rows = np.flatnonzero(mask)
                    words = ewah.positions_to_words(buf_rows, len(mask))
                    parts.append(ewah.compress(words))
                    scanned += len(words)
                merged = (EwahStream(concat_streams(parts), total_rows,
                                     scanned)
                          if parts else _empty_stream())
                maybe_validate(merged, origin="ServePlane._execute_many")
                out.append((per_seg, buf_rows, merged))
        return segs, buf, out

    def execute_compressed_many(self, preds, backend: str = "torch",
                                now=None, **backend_opts):
        _, _, triples = self._execute_many(preds, backend, now,
                                           backend_opts)
        return [(per_seg, merged) for per_seg, _, merged in triples]

    def query_many(self, preds, backend: str = "torch", now=None,
                   **backend_opts):
        """Batched queries; one ``(row_ids, words_scanned)`` per
        predicate, row ids in original ingest order, sorted ascending —
        the ``SegmentedIndex.query_many`` contract."""
        segs, _, triples = self._execute_many(preds, backend, now,
                                              backend_opts)
        buf_start = segs[-1].row_stop if segs else 0
        out = []
        for per_seg, buf_rows, merged in triples:
            ids = [seg.original_rows(r.to_rows())
                   for seg, r in zip(segs, per_seg) if seg.n_rows]
            if buf_rows is not None:
                ids.append(buf_start + buf_rows)
            rows = (np.sort(np.concatenate(ids)) if ids
                    else np.asarray([], dtype=np.int64))
            out.append((rows, merged.words_scanned))
        return out

    def query(self, pred, backend: str = "torch", now=None,
              **backend_opts):
        return self.query_many([pred], backend=backend, now=now,
                               **backend_opts)[0]

    def count_many(self, preds, backend: str = "torch", now=None,
                   **backend_opts):
        """Matching live-row counts, popcounted in the compressed domain
        — nothing densifies anywhere on this path."""
        _, _, triples = self._execute_many(preds, backend, now,
                                           backend_opts)
        return [merged.count() for _, _, merged in triples]

    def count(self, pred, backend: str = "torch", now=None,
              **backend_opts) -> int:
        return self.count_many([pred], backend=backend, now=now,
                               **backend_opts)[0]

    def stats(self) -> dict:
        with self._lock:
            return {"world_size": len(self._socks),
                    "ship_bytes": self.ship_bytes,
                    "result_bytes_compressed": self.result_bytes_compressed,
                    "result_bytes_dense": self.result_bytes_dense,
                    "worker_launches": dict(self.worker_launches)}

    # -- sharded two-phase checkpoint --------------------------------------

    def save_checkpoint(self, directory: str, step: int, *,
                        keep: int | None = None) -> None:
        """Two-phase sharded commit (the reference's docs/dist.md): every
        worker writes
        only the segment directories it owns and acks CRCs; the
        coordinator writes zero-row segments and the writer-level state,
        then — only once every ack is in — fsyncs the manifest, flips the
        ``LATEST`` pointer, and prunes old steps."""
        with self._lock:
            segs, buf, owner_of = self._sync_locked()
            step_path = ckpt._step_dir(directory, step)
            os.makedirs(step_path, exist_ok=True)
            seg_acks: list = [None] * len(segs)
            owners: list = []
            per_rank: list = [{} for _ in self._socks]
            for i, seg in enumerate(segs):
                if seg.n_rows:
                    rank = owner_of[seg.generation]
                    per_rank[rank][seg.generation] = i
                    owners.append(rank)
                else:
                    # zero-row spans live nowhere; the coordinator persists
                    # them so the id span stays covered on restore
                    seg_acks[i] = ckpt.write_segment_dir(
                        step_path, i, segment_state(seg))
                    owners.append(-1)
            active = [r for r in range(len(self._socks)) if per_rank[r]]
            for r in active:  # phase 1: fan the writes out
                send_msg(self._socks[r], "ckpt",
                         {"step_path": step_path, "ordinals": per_rank[r]})
            wl = self.writer.workload_stats
            coord_ack = ckpt.write_coordinator_state(step_path, {
                "spec": self.writer.spec.to_dict(),
                "names": (None if self.writer.names is None
                          else list(self.writer.names)),
                "closed": self.writer.closed,
                "seal_rows": self.writer.seal_rows,
                "buffer": buf,
                "workload": wl.snapshot() if wl is not None else None})
            for payload in self._replies(active).values():
                for ordinal, ack in payload["acks"].items():
                    seg_acks[int(ordinal)] = ack
            missing = [i for i, a in enumerate(seg_acks) if a is None]
            if missing:
                raise RuntimeError(
                    f"checkpoint step {step}: segments {missing} never "
                    "acked; refusing to commit a torn step")
            # phase 2: manifest fsync -> LATEST flip -> prune
            ckpt.commit_sharded_step(directory, step, owners, seg_acks,
                                     coord_ack, keep=keep)

    @classmethod
    def restore(cls, directory: str, *, n_hosts: int = 2,
                seal_rows: int | None = None, clock=time.time,
                workload_stats=None, materialize: bool = True,
                connect_timeout: float = 60.0,
                reply_timeout: float | None = None) -> "ServePlane":
        """Reassemble a plane from the newest committed sharded step.

        Segments re-seal from their checkpointed raw columns with their
        recorded encodings (bit-identical indexes), the writer rebuilds
        via :meth:`IndexWriter.from_parts`, and ownership re-shards over
        the *current* ``n_hosts`` at the first sync — a host that died
        since the save simply isn't part of the new map."""
        coord, seg_states, step, _manifest = ckpt.load_sharded_step(
            directory)
        spec = IndexSpec.from_dict(coord["spec"])
        segments = [seal_from_state(st, spec, materialize=materialize)
                    for st in seg_states]
        if workload_stats is not None and coord.get("workload"):
            workload_stats.merge_snapshot(coord["workload"])
        writer = IndexWriter.from_parts(
            spec, names=coord.get("names"), segments=segments,
            buffer=coord.get("buffer"), closed=coord.get("closed", False),
            seal_rows=(seal_rows if seal_rows is not None
                       else coord.get("seal_rows")),
            clock=clock, workload_stats=workload_stats)
        plane = cls(writer, n_hosts=n_hosts,
                    connect_timeout=connect_timeout,
                    reply_timeout=reply_timeout)
        plane.restored_step = step
        return plane


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def _handle(op: str, payload, state: dict):
    """One worker request -> reply payload.  ``state`` holds the worker's
    config plus its owned segments (gen -> Segment)."""
    if op == "config":
        state["spec"] = IndexSpec.from_dict(payload["spec"])
        state["names"] = payload["names"]
        return {"rank": state["rank"]}
    if op == "ship":
        for st in payload["segments"]:
            # keep_columns=True: checkpoint writes need the row store
            state["segments"][int(st["gen"])] = seal_from_state(
                st, state["spec"])
        for gen in payload["drop"]:
            state["segments"].pop(int(gen), None)
        return {"owned": sorted(state["segments"])}
    if op == "query":
        from ..kernels import ops

        before = dict(ops.LAUNCHES)
        segs = [state["segments"][int(g)] for g in payload["gens"]]
        now = payload["now"]
        be = get_backend(payload["backend"], **payload.get("opts", {}))
        live = [s.live_stream(now) for s in segs]
        plans = []
        for pred in payload["preds"]:
            for seg, lv in zip(segs, live):
                plan = compile_plan(seg.index, pred, names=state["names"])
                plans.append(with_live_mask(plan, lv))
        t0 = perf_counter()
        if hasattr(be, "execute_compressed_many"):
            results = be.execute_compressed_many(plans)
        else:
            results = [be.execute_compressed(p) for p in plans]
        _observe_workload(plans, perf_counter() - t0)
        from ..workload import WORKLOAD_STATS

        k = len(segs)
        return {
            "streams": [[results[i * k + j].to_bytes() for j in range(k)]
                        for i in range(len(payload["preds"]))],
            "scanned": [[int(results[i * k + j].words_scanned)
                         for j in range(k)]
                        for i in range(len(payload["preds"]))],
            "workload": WORKLOAD_STATS.drain(),
            "launches": {k: ops.LAUNCHES[k] - before[k] for k in before
                         if ops.LAUNCHES[k] != before[k]},
        }
    if op == "delete_ids":
        ids = np.asarray(payload["ids"], dtype=np.int64)
        deleted = sum(seg.delete_ids(ids)
                      for seg in state["segments"].values())
        return {"deleted": int(deleted)}
    if op == "ckpt":
        acks = {}
        for gen, ordinal in payload["ordinals"].items():
            seg = state["segments"][int(gen)]
            acks[int(ordinal)] = ckpt.write_segment_dir(
                payload["step_path"], int(ordinal), segment_state(seg))
        return {"acks": acks}
    raise ValueError(f"unknown op {op!r}")


def worker_main(connect: str, rank: int,
                connect_timeout: float = 60.0) -> None:
    """Worker process entry: connect back to the coordinator and serve
    requests until ``shutdown``.  Single-threaded by design — requests on
    one segment subset are serialized; parallelism comes from the fleet.
    A worker waits for requests without a time limit, and exits when the
    coordinator hangs up.
    """
    host, _, port = connect.rpartition(":")
    sock = socket.create_connection((host, int(port)),
                                    timeout=connect_timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    state = {"rank": int(rank), "spec": None, "names": None,
             "segments": {}}
    send_msg(sock, "hello", {"rank": int(rank), "pid": os.getpid()})
    try:
        while True:
            op, payload, _ = recv_msg(sock)
            if op == "shutdown":
                send_msg(sock, "ok", {})
                return
            try:
                reply = _handle(op, payload, state)
            except Exception:
                import traceback

                send_msg(sock, "error",
                         {"traceback": traceback.format_exc()})
                continue
            send_msg(sock, "ok", reply)
    finally:
        sock.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.dist.serve_plane",
        description="serve-plane worker process (spawned by ServePlane)")
    parser.add_argument("--worker", action="store_true", required=True)
    parser.add_argument("--connect", required=True,
                        help="coordinator host:port to dial back")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--connect-timeout", type=float, default=60.0)
    args = parser.parse_args(argv)
    worker_main(args.connect, args.rank, args.connect_timeout)


if __name__ == "__main__":
    main()
