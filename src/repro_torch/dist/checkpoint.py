"""Atomic, fault-tolerant checkpointing: pytrees and sharded segments.

A copy of the reference's ``repro.dist.checkpoint`` on the same on-disk
format, so that a step written by either package restores in the other.

Pytree layout: one directory per step, made visible atomically:

    <dir>/step_00000042/
        metadata.json        {"step", "extra", "leaves": [{dtype, shape, crc}]}
        leaf_00000.npy       the tree's leaves in jax.tree.flatten order:
        leaf_00001.npy       dict keys sorted (repro_torch.pytree)
        ...
    <dir>/LATEST             committed-step pointer, flipped atomically

The trees are nested dicts of tensors (or arrays).  The training launcher
saves the reference's tree (``convert.params_to_reference``,
``convert.opt_state_to_reference``: each layer leaf stacked on a leading
axis), so the files are the reference's.  bfloat16, which numpy cannot
hold, is stored as a uint16 raw view (``tensor.view(torch.int16)``) with
``"bfloat16"`` recorded, and the CRC32 covers the stored bytes.  A save
copies every leaf to host memory before it returns (the training step
updates the parameters in place next), and writes into a ``tmp.*``
sibling directory that ``os.replace`` moves into place, so readers never
observe a partial step.  ``restore`` walks steps newest-first and falls
back to the next older step when validation fails, so a write torn by a
crash (or bit rot on one leaf) costs one checkpoint, not the run.

The sharded serve-plane checkpoints reuse the same step/pointer scheme
but write *per segment*:

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
flip is fsynced, and never at or above the pointer's target.  torch
imports lazily: the segment half of this module is numpy-only.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zlib

import numpy as np

from ..pytree import tree_leaves, tree_map, tree_unflatten

_STEP_PREFIX = "step_"
_META = "metadata.json"
_LATEST = "LATEST"
_MANIFEST = "manifest.json"

# dtypes numpy can't hold: name -> storage dtype (the restore view resolves
# through torch lazily so worker processes stay torch-free)
_RAW = {"bfloat16": np.uint16}


def _raw_view(name: str):
    import torch

    return {"bfloat16": torch.bfloat16}[name]


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


def _crc(stored: np.ndarray) -> int:
    """CRC32 of an array's bytes in C order (``stored.tobytes()``)."""
    return zlib.crc32(np.ascontiguousarray(stored).reshape(-1).view(np.uint8))


def _rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _barrier() -> None:
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        dist.barrier()


def _host(x) -> tuple[str, np.ndarray]:
    """(dtype name, stored array) of one leaf, copied to host memory: a
    bfloat16 leaf as its uint16 raw view; a DTensor gathered first."""
    import torch

    if isinstance(x, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            x = x.full_tensor()
        t = x.detach().to("cpu", memory_format=torch.contiguous_format,
                          copy=True)
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    else:
        a = np.array(x, copy=True)
    name = a.dtype.name
    return name, a.view(_RAW[name]) if name in _RAW else a


def _snapshot(tree) -> list[tuple[str, np.ndarray]]:
    """Copy leaves to host memory NOW: the caller may update the tree's
    tensors in place right after (the train step does).  On the CPU a
    tensor's ``.numpy()`` shares its memory, so every leaf is copied."""
    return [_host(x) for x in tree_leaves(tree)]


def _write(directory: str, step: int, leaves, extra, keep) -> int:
    """Write one step; returns the stored leaves' bytes."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = tempfile.mkdtemp(prefix="tmp.", dir=directory)
    nbytes = 0
    try:
        meta = {"step": int(step), "extra": extra if extra is not None else {},
                "leaves": []}
        for i, (name, stored) in enumerate(leaves):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), stored,
                    allow_pickle=False)
            meta["leaves"].append({
                "dtype": name,
                "shape": list(stored.shape),
                "crc": _crc(stored),
            })
            nbytes += stored.nbytes
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # commit order is load-bearing: the step becomes the pointer's target
    # (fsynced) BEFORE any retention runs, so a crash in between leaves
    # every committed step on disk
    flip_latest(directory, step)
    if keep is not None:
        _prune(directory, keep)
    return nbytes


def save(directory: str, step: int, tree, extra=None,
         keep: int | None = None) -> int:
    """Synchronous atomic save of a tree of tensors or arrays; ``extra`` is
    a small JSON-able dict (data pipeline position, RNG state, ...);
    ``keep`` retains only the N newest steps after a successful write.
    Returns the bytes of the leaves written.  In a process group every
    rank calls it (DTensor leaves are gathered), rank 0 alone writes, and
    every rank returns once the step is committed."""
    leaves = _snapshot(tree)
    nbytes = (_write(directory, step, leaves, extra, keep) if _rank() == 0
              else sum(stored.nbytes for _, stored in leaves))
    _barrier()
    return nbytes


_pending: list[threading.Thread] = []  # guarded-by: _pending_lock
_pending_lock = threading.Lock()


def save_async(directory: str, step: int, tree, extra=None,
               keep: int | None = None) -> threading.Thread:
    """Snapshot to host synchronously, write in a background thread.

    The device-to-host copy happens before this returns, so the caller may
    update the tree's tensors in place at once.  Returns the writer thread
    (already started); ``wait_pending()`` joins all outstanding ones.  In
    a process group every rank calls it and rank 0's thread writes (the
    others' threads do nothing).
    """
    leaves = _snapshot(tree)
    target = _write if _rank() == 0 else (lambda *a: 0)
    t = threading.Thread(target=target, args=(directory, step, leaves, extra,
                                              keep),
                         name=f"ckpt-save-{step}", daemon=True)
    with _pending_lock:
        _pending.append(t)
    t.start()
    return t


def wait_pending() -> None:
    """Block until every save_async writer has finished (in a process
    group, every rank's, so all ranks see the committed steps)."""
    with _pending_lock:
        threads, _pending[:] = list(_pending), []
    for t in threads:
        t.join()
    _barrier()


def _load_step(path: str, n_leaves: int):
    """(leaves as (dtype name, stored array), step, extra) of one step
    directory, validated; raises CorruptCheckpoint."""
    meta_path = os.path.join(path, _META)
    if not os.path.exists(meta_path):
        raise CorruptCheckpoint(f"{path}: missing {_META}")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpoint(f"{path}: unreadable metadata ({e})")
    if len(meta.get("leaves", [])) != n_leaves:
        raise CorruptCheckpoint(
            f"{path}: {len(meta.get('leaves', []))} leaves on disk, "
            f"restore target has {n_leaves}")
    leaves = []
    try:  # valid JSON with missing/mangled keys is corruption too
        for i, rec in enumerate(meta["leaves"]):
            fp = os.path.join(path, f"leaf_{i:05d}.npy")
            try:
                stored = np.load(fp, allow_pickle=False)
            except Exception as e:  # noqa: BLE001 — any unreadable leaf is corruption
                raise CorruptCheckpoint(f"{fp}: {e}")
            name = rec["dtype"]
            want = np.dtype(_RAW[name] if name in _RAW else name)
            if stored.dtype != want or list(stored.shape) != list(rec["shape"]):
                raise CorruptCheckpoint(
                    f"{fp}: got {stored.dtype}{stored.shape}, "
                    f"recorded {name}{tuple(rec['shape'])}")
            if _crc(stored) != rec["crc"]:
                raise CorruptCheckpoint(f"{fp}: CRC mismatch")
            leaves.append((name, stored))
        return leaves, int(meta["step"]), meta.get("extra", {})
    except (KeyError, TypeError, ValueError) as e:
        raise CorruptCheckpoint(f"{path}: malformed metadata ({e!r})")


def _tensor(name: str, stored: np.ndarray):
    import torch

    if name in _RAW:  # the 16-bit raw view, through int16 for torch
        return torch.from_numpy(stored.view(np.int16)).view(_raw_view(name))
    return torch.from_numpy(stored)


def restore(directory: str, tree_like, device=None, shardings=None):
    """Load the newest valid checkpoint.

    ``tree_like`` supplies the tree structure and the expected leaf
    *shapes* (leaf values are ignored, so ``meta`` tensors do; a saved leaf
    whose shape disagrees with its ``tree_like`` counterpart is rejected
    with a clear error, e.g. a checkpoint written before a state-layout
    change such as param-shaped against flat ZeRO-1 moments).  The leaves
    come back as tensors on ``device`` (None: the CUDA device, which
    raises where there is none).  Returns ``(tree, step, extra)``; raises
    FileNotFoundError when no step exists or none validates.
    """
    from ..models.common import resolve_device

    device = resolve_device(device)
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    leaves_like = tree_leaves(tree_like)
    failures = []
    for step in reversed(steps):
        try:
            raw, saved_step, extra = _load_step(
                _step_dir(directory, step), len(leaves_like))
        except CorruptCheckpoint as e:
            failures.append(str(e))
            continue
        for i, ((_, x), like) in enumerate(zip(raw, leaves_like)):
            want = tuple(like.shape if hasattr(like, "shape")
                         else np.shape(like))
            if tuple(x.shape) != want:
                raise ValueError(
                    f"checkpoint step {saved_step} leaf {i} has shape "
                    f"{tuple(x.shape)} but the current state expects {want} "
                    "— the saved state layout predates the running code "
                    "(e.g. param-shaped optimizer moments from before "
                    "flat ZeRO-1); restart fresh or migrate the "
                    "checkpoint")
        leaves = [_tensor(name, x).to(device) for name, x in raw]
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            placed = tree_leaves(tree_map(
                lambda _, sh: False if sh is None else sh, tree_like,
                shardings))
            leaves = [t if sh is False else
                      distribute_tensor(t, sh.mesh, sh.placements)
                      for t, sh in zip(leaves, placed)]
        return tree_unflatten(tree_like, leaves), saved_step, extra
    raise FileNotFoundError(
        f"all checkpoints under {directory!r} failed validation: "
        + "; ".join(failures))


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
