"""Sharded serve-plane checkpoints: the step/pointer scheme and the
per-segment two-phase commit.

A copy of the segment half of the reference's ``repro.dist.checkpoint``,
on the same on-disk format, so that a step written by either package
restores in the other:

    <dir>/step_00000042/
        segment_00000/meta.json    id span, row count, encodings, CRC
        segment_00000/state.npz    ingest-order columns, row ids, TTLs,
        ...                        tombstoned positions
        writer.json, buffer.npz    the coordinator's writer-level state
        manifest.json              ownership map + every CRC
    <dir>/LATEST                   committed-step pointer, flipped atomically

Each host writes only the ``segment_<ordinal>/`` directories it owns, the
coordinator writes the writer-level state, and commit is a two-phase
barrier: all hosts write and ack with CRCs, then the coordinator fsyncs
``manifest.json`` and atomically flips ``LATEST``.  Restore trusts only
steps whose manifest validates, so a torn multi-host write costs one
checkpoint.  Arrays load with ``allow_pickle=False``.

**Retention is pointer-gated** (crash-safe under concurrent writers): old
step directories are retired only *after* the new step's ``LATEST`` pointer
flip is fsynced, and never at or above the pointer's target.

The pytree half of the reference module (``save``, ``save_async``,
``wait_pending``, ``restore`` of parameter trees, with bfloat16 leaves
viewed through jax) comes with the port's LM stack; it is not part of
this copy.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib

import numpy as np

_STEP_PREFIX = "step_"
_LATEST = "LATEST"
_MANIFEST = "manifest.json"


class CorruptCheckpoint(RuntimeError):
    """A step directory failed validation (missing, truncated or bad
    files)."""


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_STEP_PREFIX}{step:08d}")


def available_steps(directory: str) -> list[int]:
    """Sorted step numbers present under ``directory`` ([] if none)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(_STEP_PREFIX):
            continue
        try:
            step = int(name[len(_STEP_PREFIX):])
        except ValueError:
            continue
        if os.path.isdir(os.path.join(directory, name)):
            steps.append(step)
    return sorted(steps)


def _fsync_dir(path: str) -> None:
    """Flush a directory entry to disk (best-effort: some filesystems
    refuse to open directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def latest_step(directory: str) -> int | None:
    """The committed step the ``LATEST`` pointer names, or None when no
    pointer exists (pre-pointer checkpoints, or nothing committed yet)."""
    try:
        with open(os.path.join(directory, _LATEST)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def flip_latest(directory: str, step: int) -> None:
    """Atomically commit ``step`` as the newest checkpoint: write the
    pointer to a temp file, fsync it, ``os.replace`` over ``LATEST``, fsync
    the directory entry.  A stale concurrent writer (an async save of an
    older step finishing late) never moves the pointer backwards."""
    cur = latest_step(directory)
    if cur is not None and cur > step:
        return
    fd, tmp = tempfile.mkstemp(prefix="tmp.latest.", dir=directory)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(f"{int(step)}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, _LATEST))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(directory)


def _prune(directory: str, keep: int) -> None:
    """Retire old step directories.  Runs only after a pointer flip is
    fsynced, and never removes the pointer's target or anything newer —
    so a crash anywhere in a save never costs a committed checkpoint."""
    committed = latest_step(directory)
    steps = available_steps(directory)
    if committed is not None:
        steps = [s for s in steps if s < committed]
        keep = keep - 1  # the committed step occupies one retention slot
    for s in steps[: max(0, len(steps) - max(keep, 0))]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


# ---------------------------------------------------------------------------
# Sharded serve-plane checkpoints: per-segment directories, two-phase commit.
#
# Numpy only: worker processes call write_segment_dir/read_segment_dir
# without importing torch's device runtime.  The coordinator drives the
# barrier:
#
#   phase 1   every host writes the segment dirs it owns (plus the
#             coordinator's writer-level state) under <dir>/step_N/ and
#             acks with per-file CRCs;
#   phase 2   the coordinator verifies all acks, fsyncs manifest.json
#             (ownership map + CRCs), atomically flips LATEST, and only
#             then prunes old steps.
#
# A crash before the flip leaves the previous LATEST target untouched (the
# half-written step is unreferenced); load_sharded_step trusts only steps
# whose manifest validates.
# ---------------------------------------------------------------------------


def _npz_payload(arrays: dict) -> tuple[bytes, int]:
    """Serialize named arrays to npz bytes + CRC32 (one file per segment —
    a single CRC covers every column)."""
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    return payload, zlib.crc32(payload)


def write_segment_dir(step_path: str, ordinal: int, state: dict) -> dict:
    """Write one segment's reconstruction state under
    ``<step_path>/segment_<ordinal>/``; returns its CRC manifest entry.

    ``state`` is the serve plane's wire/state dict: ``columns`` (ingest
    order), ``row_start``/``span_stop``, optional ``row_ids``/``expiry``,
    ``dead`` (ingest-local tombstoned positions), and ``encodings`` (the
    per-original-column kinds the seal chose, so a restore re-seals to the
    bit-identical index even when the kinds came from a workload-driven
    compaction chooser).
    """
    d = os.path.join(step_path, f"segment_{ordinal:05d}")
    os.makedirs(d, exist_ok=True)
    arrays = {f"col_{c:05d}": np.asarray(col)
              for c, col in enumerate(state.get("columns") or [])}
    for key in ("row_ids", "expiry", "dead"):
        if state.get(key) is not None:
            arrays[key] = np.asarray(state[key])
    payload, crc = _npz_payload(arrays)
    with open(os.path.join(d, "state.npz"), "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    meta = {"row_start": int(state["row_start"]),
            "span_stop": (None if state.get("span_stop") is None
                          else int(state["span_stop"])),
            "n_rows": int(state["n_rows"]),
            "n_cols": len(state.get("columns") or []),
            "encodings": {str(k): v
                          for k, v in (state.get("encodings") or {}).items()},
            "crc": crc}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    return {"crc": crc}


def read_segment_dir(step_path: str, ordinal: int) -> dict:
    """Load one segment's state dict back; validates the CRC.  The inverse
    of :func:`write_segment_dir`."""
    d = os.path.join(step_path, f"segment_{ordinal:05d}")
    try:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpoint(f"{d}: unreadable meta.json ({e})")
    try:
        with open(os.path.join(d, "state.npz"), "rb") as f:
            payload = f.read()
    except OSError as e:
        raise CorruptCheckpoint(f"{d}: unreadable state.npz ({e})")
    if zlib.crc32(payload) != meta.get("crc"):
        raise CorruptCheckpoint(f"{d}: state.npz CRC mismatch")
    import io

    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    n_cols = int(meta.get("n_cols", 0))
    return {
        "row_start": int(meta["row_start"]),
        "span_stop": meta.get("span_stop"),
        "n_rows": int(meta["n_rows"]),
        "columns": [arrays[f"col_{c:05d}"] for c in range(n_cols)],
        "row_ids": arrays.get("row_ids"),
        "expiry": arrays.get("expiry"),
        "dead": arrays.get("dead"),
        "encodings": {int(k): v
                      for k, v in meta.get("encodings", {}).items()},
    }


def write_coordinator_state(step_path: str, state: dict) -> dict:
    """Write the writer-level (non-segment) state the coordinator owns:
    spec/names/closed plus the open buffer's rows.  Returns the CRC
    manifest entry."""
    os.makedirs(step_path, exist_ok=True)
    arrays = {}
    buf = state.get("buffer")
    if buf is not None:
        cols, deleted, expiry = buf
        arrays = {f"buf_col_{c:05d}": np.asarray(col)
                  for c, col in enumerate(cols)}
        arrays["buf_deleted"] = np.asarray(deleted)
        arrays["buf_expiry"] = np.asarray(expiry)
    payload, crc = _npz_payload(arrays)
    with open(os.path.join(step_path, "buffer.npz"), "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    meta = {"spec": state["spec"], "names": state.get("names"),
            "closed": bool(state.get("closed", False)),
            "seal_rows": state.get("seal_rows"),
            "n_buf_cols": len(buf[0]) if buf is not None else 0,
            "has_buffer": buf is not None,
            "workload": state.get("workload"),
            "crc": crc}
    with open(os.path.join(step_path, "writer.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    return {"crc": crc}


def read_coordinator_state(step_path: str) -> dict:
    """Inverse of :func:`write_coordinator_state` (CRC-validated)."""
    try:
        with open(os.path.join(step_path, "writer.json")) as f:
            meta = json.load(f)
        with open(os.path.join(step_path, "buffer.npz"), "rb") as f:
            payload = f.read()
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpoint(f"{step_path}: unreadable writer state ({e})")
    if zlib.crc32(payload) != meta.get("crc"):
        raise CorruptCheckpoint(f"{step_path}: buffer.npz CRC mismatch")
    buf = None
    if meta.get("has_buffer"):
        import io

        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            cols = [z[f"buf_col_{c:05d}"]
                    for c in range(int(meta.get("n_buf_cols", 0)))]
            buf = (cols, z["buf_deleted"], z["buf_expiry"])
    return {"spec": meta["spec"], "names": meta.get("names"),
            "closed": bool(meta.get("closed", False)),
            "seal_rows": meta.get("seal_rows"),
            "workload": meta.get("workload"),
            "buffer": buf}


def commit_sharded_step(directory: str, step: int, owners: list,
                        seg_acks: list, coord_ack: dict,
                        keep: int | None = None) -> None:
    """Phase 2 of the serve-plane commit barrier: all hosts have written
    and acked — persist the manifest (ownership map + CRCs), fsync it,
    atomically flip ``LATEST``, then (and only then) prune old steps."""
    step_path = _step_dir(directory, step)
    manifest = {"step": int(step),
                "n_segments": len(seg_acks),
                "owners": [int(h) for h in owners],
                "segments": seg_acks,
                "coordinator": coord_ack}
    with open(os.path.join(step_path, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(step_path)
    flip_latest(directory, step)
    if keep is not None:
        _prune(directory, keep)


def load_sharded_step(directory: str):
    """Load the newest committed sharded checkpoint.

    Tries the ``LATEST`` pointer's target first, then every other step
    newest-first; a step counts only if its manifest exists and every
    segment + the coordinator state validate their CRCs.  Returns
    ``(writer_state, [segment_state, ...], step, manifest)``; the caller
    (``ServePlane.restore``) re-shards ownership across the *current*
    world size, so a host missing since the save is tolerated by design.
    """
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    order = list(reversed(steps))
    pointed = latest_step(directory)
    if pointed in order:
        order.remove(pointed)
        order.insert(0, pointed)
    failures = []
    for step in order:
        step_path = _step_dir(directory, step)
        try:
            with open(os.path.join(step_path, _MANIFEST)) as f:
                manifest = json.load(f)
            coord = read_coordinator_state(step_path)
            seg_states = []
            for i in range(int(manifest["n_segments"])):
                state = read_segment_dir(step_path, i)
                want = manifest["segments"][i]["crc"]
                got = zlib.crc32(
                    open(os.path.join(step_path, f"segment_{i:05d}",
                                      "state.npz"), "rb").read())
                if got != want:
                    raise CorruptCheckpoint(
                        f"segment {i}: manifest CRC {want}, on disk {got}")
                seg_states.append(state)
            return coord, seg_states, step, manifest
        except (OSError, json.JSONDecodeError, KeyError, IndexError,
                CorruptCheckpoint) as e:
            failures.append(f"step {step}: {e}")
    raise FileNotFoundError(
        f"no committed sharded checkpoint under {directory!r}: "
        + "; ".join(failures))
