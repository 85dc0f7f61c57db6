"""Distributed checkpoint: save / load with reshard-on-load and an atomic
commit protocol (port of ``paddle_tpu/distributed/checkpoint/``).

The file format is the reference's, so that a checkpoint written by one
package loads in the other: one ``<rank>_0.distcp`` file a writing rank
(an ``np.savez`` zip of ``.npy`` members named ``<key>@<i>``), the JSON
metadata ``0.metadata`` ``{"tensors": {key: {"kind", "global_shape",
"dtype", "shards": [{"window", "file", "key"}]}}, "format":
"paddle_tpu_dckpt_v2"}`` (a non-tensor value is ``{"kind": "object",
"value"}``), a ``checkpoint.manifest`` with each file's size and CRC32,
and the ``COMMIT`` marker. A bfloat16 leaf is stored as numpy stores an
``ml_dtypes`` bfloat16 array: descr ``'<V2'`` over the raw 16-bit words,
``"dtype": "bfloat16"`` in the metadata. The port reads and writes those
words as they are (no ``ml_dtypes``), so bfloat16 crosses bit for bit.

Shards: a DTensor leaf is written as the windows of its local shards,
offsets from its placements; of the ranks that hold the same window (a
replicated mesh dim) only the one at coordinate 0 writes it. A plain
tensor is written whole by the coordinator. Load assembles the windows
each target needs and copies them into the template's tensors in place,
on the template's device and in its placements, which need not be the
ones that saved (reshard-on-load). A template slot that holds no tensor
gets a new tensor on ``device`` (default: the card); a Python ``int``
slot takes a 0-d entry as an ``int`` (the reference's Adam ``step`` is a
0-d ``int32`` array, the port's a host ``int``).

Crash consistency (the reference's staged commit): every save stages
into ``<path>.tmp.<uid>``: shard files, then the metadata, then the
manifest; only after every rank has written does the coordinator rename
the staging dir to ``<path>`` and drop ``COMMIT``. An overwrite of a
non-empty ``path`` moves the old checkpoint aside to ``<path>.old.<uid>``
first (a raised failure moves it back; ``CheckpointManager`` recovers
one a kill left). :func:`load_state_dict` refuses anything uncommitted
or checksum-corrupt with :class:`CheckpointError` naming the file. The
fault points ``checkpoint.write`` / ``checkpoint.metadata`` /
``checkpoint.rename`` / ``checkpoint.commit`` (``testing/faults.py``)
let tests kill the process at each stage.

Several ranks (``torch.distributed`` initialised, ``process_group`` of
more than one rank) exchange the staging uid, the metadata and the
commit status with ``all_gather_object`` where the reference rides its
tagged key-value gathers. Those gathers run on a gloo group of their own
(made once, from the main thread, on the first save), so that an async
save's writer thread never interleaves with the training step's
collectives on the default group. A collective leaves no keys behind, so
the reference's key reclamation has no counterpart.

Async save (:func:`async_save_state_dict`): the snapshot is a clone on
the tensors' own device, taken before the call returns (the port's train
step updates parameters and moments in place); the device-to-host copies,
the file writes and the commit run on a background thread, the copies
on a CUDA stream of their own so they overlap the next steps.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ... import monitor as _monitor
from ...core import resolve_device
from ...testing import faults as _faults

__all__ = ["save_state_dict", "load_state_dict", "CheckpointError",
           "is_committed", "verify_checkpoint", "async_save_state_dict",
           "AsyncSaveHandle", "CheckpointManager"]

_META_NAME = "0.metadata"
_MANIFEST_NAME = "checkpoint.manifest"
_COMMIT_NAME = "COMMIT"
_FORMAT = "paddle_tpu_dckpt_v2"
# numpy's header descr of an ml_dtypes bfloat16 array
_BF16_DESCR = "<V2"

# process-local staging-uid sequence (the pid makes it unique across
# processes)
_UID_SEQ = [0]
_GROUP_MU = threading.Lock()
_GROUPS: dict = {}


class CheckpointError(RuntimeError):
    """A checkpoint directory is unusable: uncommitted (interrupted
    save) or corrupt (manifest checksum/size mismatch). The message
    names the directory and the offending file."""


def _flat_items(state_dict, prefix=""):
    for k, v in state_dict.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat_items(v, prefix=f"{key}.")
        else:
            yield key, v


def _local_uid() -> str:
    _UID_SEQ[0] += 1
    return f"{os.getpid()}.{_UID_SEQ[0]}"


# the unit of shard-file writes, reads and CRC32 tasks
_CHUNK = 1 << 26
# CRC32 tasks run on this many threads (zlib releases the GIL over large
# buffers, so they overlap each other and the file I/O)
_CRC_THREADS = 4


def _gf2_times(mat, vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat):
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def _pow2_zero_ops():
    """``ops[k]``: the CRC32 state operator of appending ``2**k`` zero
    bytes (zlib's ``crc32_combine`` matrices), k < 48."""
    op = [0xEDB88320] + [1 << n for n in range(31)]     # one zero bit
    for _ in range(3):
        op = _gf2_square(op)                            # one zero byte
    ops = []
    for _ in range(48):
        ops.append(op)
        op = _gf2_square(op)
    return ops


_ZERO_OPS: list = []


def _crc_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of ``A + B`` from ``crc1`` of A and ``crc2`` of B, ``len2``
    bytes long (zlib's ``crc32_combine``, which Python's zlib does not
    expose)."""
    if not _ZERO_OPS:
        _ZERO_OPS.extend(_pow2_zero_ops())
    k = 0
    while len2:
        if len2 & 1:
            crc1 = _gf2_times(_ZERO_OPS[k], crc1)
        len2 >>= 1
        k += 1
    return crc1 ^ crc2


def _crc_chain(pieces) -> int:
    """CRC32 of consecutive pieces ``[(crc or future, length), ...]``."""
    crc = 0
    for c, n in pieces:
        crc = _crc_combine(crc, c if isinstance(c, int) else c.result(), n)
    return crc


def _pread_into(fd: int, buf: memoryview, offset: int):
    """Fill ``buf`` from ``fd`` at ``offset`` (short reads retried)."""
    while len(buf):
        n = os.preadv(fd, [buf], offset)
        if n == 0:
            raise EOFError(f"{len(buf)} bytes short at offset {offset}")
        buf, offset = buf[n:], offset + n


def _crc_range(fd: int, offset: int, n: int) -> int:
    buf = np.empty(n, np.uint8)           # no zero fill
    _pread_into(fd, memoryview(buf), offset)
    return zlib.crc32(buf)


def _crc32_of(path: str) -> int:
    """CRC32 of a file: ``_CHUNK`` ranges read and checksummed on
    ``_CRC_THREADS`` threads at once, then combined."""
    size = os.path.getsize(path)
    fd = os.open(path, os.O_RDONLY)
    try:
        with ThreadPoolExecutor(_CRC_THREADS) as pool:
            return _crc_chain([
                (pool.submit(_crc_range, fd, off, min(_CHUNK, size - off)),
                 min(_CHUNK, size - off)) for off in range(0, size, _CHUNK)])
    finally:
        os.close(fd)


def _atomic_write_json(payload: dict, dest: str):
    tmp = f"{dest}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dest)


# -- ranks -------------------------------------------------------------------

def _world(process_group=None):
    """``(multi, rank)``: whether ``process_group`` (default: the default
    group) spans more than one rank, and this rank in it."""
    if not (dist.is_available() and dist.is_initialized()):
        return False, 0
    return (dist.get_world_size(process_group) > 1,
            dist.get_rank(process_group))


def _ckpt_group(process_group=None):
    """The group the checkpoint's gathers run on: for the default group,
    a gloo group over the same ranks made once (every rank saves at the
    same point of its program, so every rank makes it together); a
    caller's group as it is."""
    if process_group is not None:
        return process_group
    with _GROUP_MU:
        g = _GROUPS.get("world")
        if g is None:
            g = _GROUPS["world"] = dist.new_group(backend="gloo")
        return g


def _gather(obj, group) -> list:
    from ...monitor import comms as _comms
    return _comms.gather_object([None] * dist.get_world_size(group), obj,
                                group=group)


# -- leaves ------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype, as the reference's metadata
    writes ``str(arr.dtype)``."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(name))).dtype


def _windows(v: torch.Tensor):
    """``(window, writes)`` of this rank's part of leaf ``v``: the global
    index window it holds, and whether this rank writes it (the holder
    at coordinate 0 of every replicated mesh dim). A plain tensor is
    the whole window, written by every caller that asks."""
    if not isinstance(v, DTensor):
        return [(0, d) for d in v.shape], True
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = v.device_mesh
    for p in v.placements:
        if not (p.is_shard() or p.is_replicate()):
            raise CheckpointError(
                f"checkpoint: a DTensor placed {v.placements} holds "
                "partial sums; reduce it before saving")
    shape, offset = compute_local_shape_and_global_offset(
        v.shape, mesh, v.placements)
    writes = all(mesh.get_local_rank(i) == 0
                 for i, p in enumerate(v.placements)
                 if not isinstance(p, Shard))
    return [(o, o + s) for o, s in zip(offset, shape)], writes


def _leaf_bytes(t: torch.Tensor):
    """``(descr, shape, bytes)`` of a leaf: its ``.npy`` descr (bfloat16
    as numpy stores an ``ml_dtypes`` array, ``'<V2'`` over the raw 16-bit
    words), shape, and its contents as a flat ``uint8`` tensor on its own
    device (a DTensor's local shard)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.to_local()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        descr, t = _BF16_DESCR, t.view(torch.int16)
    else:
        descr = np.lib.format.dtype_to_descr(
            torch.empty((), dtype=t.dtype).numpy().dtype)
    flat = t.reshape(-1)
    return descr, tuple(t.shape), flat.view(torch.uint8) if flat.numel() \
        else torch.empty(0, dtype=torch.uint8)


_ZIP64 = 45                       # the zip version that reads ZIP64
_LOCAL = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_STAGING = 3                      # pinned chunk buffers of a device copy


class _ShardWriter:
    """One shard file as ``np.savez`` writes it, an uncompressed ZIP64
    archive of ``.npy`` members (``np.load`` and the reference read it),
    written in one pass, ``_CHUNK`` by ``_CHUNK``: each chunk's CRC32 is
    computed on the pool while the chunk is written, and the members'
    and the whole file's CRC32s are combined from the chunks'
    (``_crc_combine``), so nothing is read back. A device leaf goes to
    the file through ``_STAGING`` pinned buffers: the copy of the next
    chunk (on ``stream``) runs while the current one is written.
    ``close()`` returns ``(size, crc32)`` of the file."""

    def __init__(self, path: str, pool: ThreadPoolExecutor, stream=None):
        self._f = open(path, "wb")
        self._pool = pool
        self._stream = stream
        self._staging = None
        self._pieces = []       # (crc, length) of the file, in order
        self._members = []      # (name, header offset, size, crc)
        t = time.localtime()
        self._dos = ((max(t.tm_year, 1980) - 1980) << 9 | t.tm_mon << 5
                     | t.tm_mday, t.tm_hour << 11 | t.tm_min << 5
                     | t.tm_sec // 2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()         # idempotent; closes a failed write
        return False

    def _local(self, name: bytes, crc: int, size: int) -> bytes:
        date, tm = self._dos
        return _LOCAL.pack(b"PK\x03\x04", _ZIP64, 0, 0, 0, tm, date, crc,
                           0xFFFFFFFF, 0xFFFFFFFF, len(name), 20) + name \
            + struct.pack("<HHQQ", 1, 16, size, size)

    def _host_chunks(self, data: torch.Tensor):
        view = memoryview(data.numpy()) if data.numel() else b""
        for i in range(0, len(view), _CHUNK):
            part = view[i:i + _CHUNK]
            yield part, self._pool.submit(zlib.crc32, part)

    def _device_chunks(self, data: torch.Tensor):
        if self._staging is None:
            self._staging = [(torch.empty(_CHUNK, dtype=torch.uint8,
                                          pin_memory=True),
                              torch.cuda.Event()) for _ in range(_STAGING)]
        busy = [None] * _STAGING        # the CRC32 task reading a buffer
        starts = range(0, data.numel(), _CHUNK)

        def fetch(k):
            buf, done = self._staging[k % _STAGING]
            if busy[k % _STAGING] is not None:
                busy[k % _STAGING].result()
            n = min(_CHUNK, data.numel() - starts[k])
            with torch.cuda.stream(self._stream):
                buf[:n].copy_(data[starts[k]:starts[k] + n],
                              non_blocking=True)
                done.record()

        if starts:
            fetch(0)
        for k in range(len(starts)):
            if k + 1 < len(starts):
                fetch(k + 1)
            buf, done = self._staging[k % _STAGING]
            done.synchronize()
            part = memoryview(buf.numpy())[:min(_CHUNK,
                                                data.numel() - starts[k])]
            busy[k % _STAGING] = self._pool.submit(zlib.crc32, part)
            yield part, busy[k % _STAGING]

    def add(self, key: str, t: torch.Tensor):
        """Member ``<key>.npy``: the ``.npy`` header of the leaf's descr
        and shape, then its bytes (C order)."""
        descr, shape, data = _leaf_bytes(t)
        name = f"{key}.npy".encode()
        header = io.BytesIO()
        np.lib.format.write_array_header_1_0(header, {
            "descr": descr, "fortran_order": False, "shape": shape})
        header = header.getvalue()
        size = len(header) + data.numel()
        offset = self._f.tell()
        self._f.write(self._local(name, 0, size))     # CRC patched below
        chunks = [(zlib.crc32(header), len(header))]
        self._f.write(header)
        source = self._device_chunks(data) if data.is_cuda \
            else self._host_chunks(data)
        for part, crc in source:
            self._f.write(part)
            chunks.append((crc, len(part)))
        crc = _crc_chain(chunks)
        local = self._local(name, crc, size)
        end = self._f.tell()
        self._f.seek(offset)
        self._f.write(local)
        self._f.seek(end)
        self._pieces += [(zlib.crc32(local), len(local)), (crc, size)]
        self._members.append((name, offset, size, crc))

    def close(self):
        date, tm = self._dos
        start = self._f.tell()
        central = b"".join(
            _CENTRAL.pack(b"PK\x01\x02", _ZIP64, 3, _ZIP64, 0, 0, 0, tm,
                          date, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name), 28,
                          0, 0, 0, 0o600 << 16, 0xFFFFFFFF) + name
            + struct.pack("<HHQQQ", 1, 24, size, size, offset)
            for name, offset, size, crc in self._members)
        n = len(self._members)
        tail = (struct.pack("<4sQ2H2L4Q", b"PK\x06\x06", 44, _ZIP64,
                            _ZIP64, 0, 0, n, n, len(central), start)
                + struct.pack("<4sLQL", b"PK\x06\x07", 0,
                              start + len(central), 1)
                + struct.pack("<4s4H2LH", b"PK\x05\x06", 0, 0,
                              min(n, 0xFFFF), min(n, 0xFFFF),
                              min(len(central), 0xFFFFFFFF),
                              min(start, 0xFFFFFFFF), 0))
        self._f.write(central + tail)
        self._f.close()
        self._pieces.append((zlib.crc32(central + tail),
                             len(central) + len(tail)))
        return start + len(central) + len(tail), _crc_chain(self._pieces)


# -- save --------------------------------------------------------------------

def save_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0,
                    unique_id: Optional[int] = None):
    """Each rank writes its shards; the coordinator writes the metadata
    and manifest, renames the staging dir into place and drops the
    COMMIT marker (see the module docstring). Returns only after the
    commit is visible on every rank."""
    t0 = time.perf_counter()
    try:
        _save_committed(state_dict, path, process_group,
                        coordinator_rank, unique_id)
    except BaseException:
        _monitor.inc("ckpt.commit.failures",
                     doc="checkpoint saves that failed before COMMIT")
        raise
    _monitor.inc("ckpt.saves", doc="committed checkpoint saves")
    _monitor.observe("ckpt.save.duration_ms",
                     (time.perf_counter() - t0) * 1e3,
                     doc="wall time of one committed save (ms)")


def _save_committed(state_dict, path, process_group, coordinator_rank,
                    unique_id):
    path = os.path.normpath(path)
    multi, rank = _world(process_group)
    group = _ckpt_group(process_group) if multi else None
    uid = str(unique_id) if unique_id is not None else _local_uid()
    if multi:
        # every rank must stage into the SAME directory: adopt the
        # coordinator's uid proposal
        uid = _gather(uid, group)[coordinator_rank]
    staging = f"{path}.tmp.{uid}"
    os.makedirs(staging, exist_ok=True)

    # -- phase 1: every rank writes its own shards into the staging dir.
    # A local failure must still reach the metadata gather below (or
    # the peers would block in it), so it travels as a status payload.
    local_err: Optional[BaseException] = None
    meta: dict = {}
    files: dict = {}
    try:
        meta, files = _write_local_shards(state_dict, staging, rank,
                                          rank == coordinator_rank)
    except BaseException as e:
        if not multi:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        local_err = e
    if multi:
        # the gather doubles as the write barrier: once it returns,
        # every rank's shard file is on disk
        all_metas = _gather({
            "meta": meta, "files": files,
            "error": repr(local_err) if local_err is not None else None},
            group)
        peer_errs = [p["error"] for p in all_metas if p["error"]]
        if local_err is not None or peer_errs:
            if rank == coordinator_rank:
                shutil.rmtree(staging, ignore_errors=True)
            if local_err is not None:
                raise local_err
            raise CheckpointError(
                f"checkpoint save to {path!r} aborted: a peer rank "
                f"failed writing its shards ({peer_errs[0]})")
        if rank == coordinator_rank:
            merged = {"tensors": {}, "format": _FORMAT}
            for payload in all_metas:
                files.update(payload["files"])
                for key, entry in payload["meta"]["tensors"].items():
                    if entry.get("kind") == "object":
                        merged["tensors"].setdefault(key, entry)
                        continue
                    tgt = merged["tensors"].setdefault(
                        key, {**entry, "shards": []})
                    windows = {tuple(map(tuple, s["window"]))
                               for s in tgt["shards"]}
                    for s in entry["shards"]:
                        if tuple(map(tuple, s["window"])) not in windows:
                            tgt["shards"].append(s)
            meta = merged

    # -- phase 2: the coordinator writes metadata + manifest, renames
    # the staging dir into place and drops the COMMIT marker; its
    # outcome is exchanged in phase 3.
    commit_err: Optional[BaseException] = None
    if rank == coordinator_rank:
        graveyard = None
        try:
            _faults.hit("checkpoint.metadata")
            meta_path = os.path.join(staging, _META_NAME)
            _atomic_write_json(meta, meta_path)
            files[_META_NAME] = {"size": os.path.getsize(meta_path),
                                 "crc32": _crc32_of(meta_path)}
            _atomic_write_json(
                {"format": _FORMAT, "uid": uid, "files": files},
                os.path.join(staging, _MANIFEST_NAME))
            _faults.hit("checkpoint.rename")
            if os.path.exists(path):
                if os.listdir(path):
                    # overwrite of a live directory: move it aside first
                    # (rename(2) cannot replace a non-empty dir)
                    graveyard = f"{path}.old.{uid}"
                    os.rename(path, graveyard)
                else:
                    os.rmdir(path)
            os.rename(staging, path)
            _faults.hit("checkpoint.commit")
            _atomic_write_json({"uid": uid, "ts": time.time()},
                               os.path.join(path, _COMMIT_NAME))
            if graveyard is not None:
                shutil.rmtree(graveyard, ignore_errors=True)
        except BaseException as e:
            commit_err = e
            _restore_graveyard(path, graveyard)
            shutil.rmtree(staging, ignore_errors=True)
    if multi:
        # phase 3: the commit status, which doubles as the return
        # barrier (no rank returns before the commit landed)
        statuses = _gather(
            repr(commit_err) if commit_err is not None else None, group)
        if commit_err is not None:
            raise commit_err
        bad = [s for s in statuses if s]
        if bad:
            raise CheckpointError(
                f"checkpoint save to {path!r} aborted: the coordinator "
                f"failed to commit ({bad[0]})")
    elif commit_err is not None:
        raise commit_err


def _write_local_shards(state_dict, staging: str, rank: int,
                        coordinator: bool):
    """Phase 1 of the commit protocol: write this rank's shard file into
    the staging dir, one leaf at a time (a device leaf is copied to the
    host as it is written); returns (local metadata, {fname: {size,
    crc32}})."""
    meta = {"tensors": {}, "format": _FORMAT}
    fname = f"{rank}_0.distcp"
    shard_file = os.path.join(staging, fname)
    blobs = []
    for key, v in _flat_items(state_dict):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if not torch.is_tensor(v):
            meta["tensors"][key] = {"kind": "object", "value": v}
            continue
        window, writes = _windows(v)
        entry = {"kind": "tensor", "global_shape": list(v.shape),
                 "dtype": _dtype_name(v.dtype), "shards": []}
        if writes and (coordinator or isinstance(v, DTensor)):
            blob_key = f"{key}@0"
            blobs.append((blob_key, v))
            entry["shards"].append({"window": [list(w) for w in window],
                                    "file": fname, "key": blob_key})
        meta["tensors"][key] = entry
    _faults.hit("checkpoint.write")
    stream = torch.cuda.current_stream() if any(
        v.is_cuda for _, v in blobs) else None
    with ThreadPoolExecutor(_CRC_THREADS) as pool, \
            _ShardWriter(shard_file, pool, stream) as writer:
        for blob_key, v in blobs:
            writer.add(blob_key, v)
        size, crc = writer.close()
    files = {fname: {"size": size, "crc32": crc}}
    _monitor.inc("ckpt.save.bytes", files[fname]["size"],
                 doc="shard bytes written by committed+failed saves")
    return meta, files


def _restore_graveyard(path: str, graveyard: Optional[str]):
    """Undo a move-aside after a raised commit failure: put the
    previously-committed checkpoint back at ``path`` (dropping an
    uncommitted half-renamed staging dir if one landed there)."""
    if graveyard is None or not os.path.exists(graveyard):
        return
    try:
        if os.path.exists(path):
            if os.path.isfile(os.path.join(path, _COMMIT_NAME)):
                return          # a committed checkpoint won; keep it
            shutil.rmtree(path, ignore_errors=True)
        os.rename(graveyard, path)
    except OSError:
        pass


# -- verify ------------------------------------------------------------------

def is_committed(path: str) -> bool:
    """True when ``path`` holds a fully-committed checkpoint (COMMIT
    marker + manifest + metadata present)."""
    return (os.path.isfile(os.path.join(path, _COMMIT_NAME))
            and os.path.isfile(os.path.join(path, _MANIFEST_NAME))
            and os.path.isfile(os.path.join(path, _META_NAME)))


def verify_checkpoint(path: str):
    """Raise :class:`CheckpointError` unless ``path`` is committed and
    every manifest file matches its recorded size and CRC32."""
    if not os.path.isdir(path):
        raise CheckpointError(f"checkpoint dir {path!r} does not exist")
    if not os.path.isfile(os.path.join(path, _COMMIT_NAME)):
        raise CheckpointError(
            f"checkpoint {path!r} has no COMMIT marker — the save was "
            "interrupted before commit; refusing to load a partial "
            "checkpoint (restore from the previous committed one)")
    manifest_path = os.path.join(path, _MANIFEST_NAME)
    if not os.path.isfile(manifest_path):
        raise CheckpointError(
            f"checkpoint {path!r} is committed but has no manifest — "
            "cannot verify integrity")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(
            f"checkpoint {path!r}: unreadable manifest: {e}") from e
    for fname, rec in manifest.get("files", {}).items():
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            raise CheckpointError(
                f"checkpoint {path!r}: file {fname!r} listed in the "
                "manifest is missing")
        size = os.path.getsize(fpath)
        if size != rec["size"]:
            raise CheckpointError(
                f"checkpoint {path!r}: file {fname!r} is {size} bytes, "
                f"manifest says {rec['size']} — truncated or overwritten")
        crc = _crc32_of(fpath)
        if crc != rec["crc32"]:
            raise CheckpointError(
                f"checkpoint {path!r}: file {fname!r} fails its CRC32 "
                f"check ({crc:#010x} != manifest {rec['crc32']:#010x}) "
                "— corrupt")


# -- load --------------------------------------------------------------------

class _Reader:
    """The shard files of one checkpoint dir. A member (uncompressed, C
    order, as ``np.savez`` stores it) is read straight into a tensor,
    ``_CHUNK`` ranges on ``pool``'s threads at once; the checkpoint's
    CRC32s are ``verify_checkpoint``'s to check."""

    def __init__(self, path: str, pool: ThreadPoolExecutor):
        self.path = path
        self._pool = pool
        self._files: dict = {}

    def _open(self, fname):
        got = self._files.get(fname)
        if got is None:
            fd = os.open(os.path.join(self.path, fname), os.O_RDONLY)
            with zipfile.ZipFile(os.path.join(self.path, fname)) as z:
                infos = {i.filename: i for i in z.infolist()}
            got = self._files[fname] = (fd, infos)
        return got

    def member(self, fname: str, key: str, dtype: str) -> torch.Tensor:
        fd, infos = self._open(fname)
        info = infos[f"{key}.npy"]
        local = _LOCAL.unpack(os.pread(fd, _LOCAL.size, info.header_offset))
        start = info.header_offset + _LOCAL.size + local[-2] + local[-1]
        with os.fdopen(os.dup(fd), "rb") as f:
            f.seek(start)
            read = np.lib.format.read_array_header_1_0 \
                if np.lib.format.read_magic(f) == (1, 0) \
                else np.lib.format.read_array_header_2_0
            shape, fortran, stored = read(f)
            start = f.tell()
        want = np.dtype(np.int16) if dtype == "bfloat16" else np.dtype(dtype)
        if stored.itemsize != want.itemsize or (
                dtype != "bfloat16" and stored != want):
            raise CheckpointError(
                f"checkpoint {self.path!r}: member {key!r} of {fname!r} "
                f"holds {stored}, the metadata says {dtype}")
        if info.compress_type != zipfile.ZIP_STORED or fortran:
            raise CheckpointError(
                f"checkpoint {self.path!r}: member {key!r} of {fname!r} is "
                "compressed or in Fortran order; the format stores "
                "uncompressed C-order members")
        out = torch.empty(shape, dtype=_torch_dtype(
            "int16" if dtype == "bfloat16" else dtype))
        buf = memoryview(out.numpy().reshape(-1)).cast("B") \
            if out.numel() else memoryview(b"")
        try:
            for f in [self._pool.submit(_pread_into, fd, buf[i:i + _CHUNK],
                                        start + i)
                      for i in range(0, len(buf), _CHUNK)]:
                f.result()
        except EOFError as e:
            raise CheckpointError(
                f"checkpoint {self.path!r}: member {key!r} of {fname!r} "
                f"is truncated ({e})") from e
        return out.view(torch.bfloat16) if dtype == "bfloat16" else out

    def assemble(self, entry, window=None) -> torch.Tensor:
        """The index ``window`` (default: all) of one tensor entry, on the
        host, from the saved windows that overlap it; a part that no
        saved window covers stays zero, as the reference's does."""
        shape = entry["global_shape"]
        window = [(0, d) for d in shape] if window is None else window
        shards = entry["shards"]
        if len(shards) == 1 and [tuple(w) for w in shards[0]["window"]] \
                == [tuple(w) for w in window]:
            sh = shards[0]
            return self.member(sh["file"], sh["key"], entry["dtype"])
        out = torch.zeros([b - a for a, b in window],
                          dtype=_torch_dtype(entry["dtype"]))
        for sh in shards:
            inter = [(max(a, sa), min(b, sb)) for (a, b), (sa, sb)
                     in zip(window, sh["window"])]
            if any(lo >= hi for lo, hi in inter):
                continue
            src = self.member(sh["file"], sh["key"], entry["dtype"])
            src_idx = tuple(slice(lo - sa, hi - sa) for (lo, hi), (sa, _)
                            in zip(inter, sh["window"]))
            dst_idx = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                            in zip(inter, window))
            out[dst_idx] = src[src_idx]
        return out

    def close(self):
        for fd, _ in self._files.values():
            os.close(fd)
        self._files.clear()


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id: Optional[int] = None,
                    offload: bool = False, verify: bool = True,
                    device="cuda"):
    """Fill ``state_dict`` in place from the checkpoint at ``path``: a
    tensor slot (plain or DTensor) gets its saved value copied in, on its
    own device and in its own placements (reshard-on-load); a Python
    ``int`` slot takes a 0-d entry as an ``int``; any other slot is
    replaced by the saved value, a tensor on ``device`` for a tensor
    entry. Keys the checkpoint lacks stay as they are.

    ``verify=True`` (default) enforces the commit protocol: an
    uncommitted or checksum-failing directory raises
    :class:`CheckpointError` instead of half-loading (one extra read of
    the checkpoint). ``verify=False`` skips it (and reads pre-protocol
    dirs). ``process_group``, ``coordinator_rank``, ``unique_id`` and
    ``offload`` keep the reference's (Paddle's) signature and are
    unused, as there: a load needs no exchange between ranks."""
    del process_group, coordinator_rank, unique_id, offload
    if verify:
        verify_checkpoint(path)
    meta_path = os.path.join(path, _META_NAME)
    if not os.path.isfile(meta_path):
        raise CheckpointError(
            f"checkpoint {path!r} has no {_META_NAME} — not a "
            "checkpoint directory")
    with open(meta_path) as f:
        meta = json.load(f)
    pool = ThreadPoolExecutor(_CRC_THREADS)
    reader = _Reader(path, pool)

    def shape_check(key, entry, v):
        if list(v.shape) != entry["global_shape"]:
            raise CheckpointError(
                f"checkpoint {path!r}: {key!r} is saved with shape "
                f"{entry['global_shape']}, the target has "
                f"{list(v.shape)}")

    def fill(d, prefix=""):
        for k, v in d.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                fill(v, prefix=f"{key}.")
                continue
            entry = meta["tensors"].get(key)
            if entry is None:
                continue
            if entry.get("kind") == "object":
                d[k] = entry["value"]
            elif isinstance(v, DTensor):
                shape_check(key, entry, v)
                window, _ = _windows(v)
                with torch.no_grad():
                    v.to_local().copy_(reader.assemble(entry, window))
            elif torch.is_tensor(v):
                shape_check(key, entry, v)
                with torch.no_grad():
                    v.copy_(reader.assemble(entry))
            elif (isinstance(v, int) and not isinstance(v, bool)
                  and entry["global_shape"] == []):
                d[k] = int(reader.assemble(entry).item())
            else:
                dev = resolve_device(
                    None if str(device) == "cuda" else device)
                d[k] = reader.assemble(entry).to(dev)

    try:
        fill(state_dict)
    finally:
        reader.close()
        pool.shutdown()


# -- async save --------------------------------------------------------------

class AsyncSaveHandle:
    """Handle for an in-flight async checkpoint. ``result()`` joins and
    re-raises any writer error."""

    def __init__(self, thread, errbox):
        self._thread = thread
        self._err = errbox

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self, timeout=None):
        self._thread.join(timeout)

    def result(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"async checkpoint still writing after {timeout}s")
        if self._err:
            raise self._err[0]


def _snapshot(v):
    """A copy of one leaf that later in-place updates cannot reach: a
    tensor cloned on its own device (a DTensor's local shard, placements
    kept); an array copied; other values as they are."""
    if isinstance(v, DTensor):
        return DTensor.from_local(v.to_local().detach().clone(),
                                  v.device_mesh, v.placements,
                                  shape=v.shape, stride=v.stride(),
                                  run_check=False)
    if torch.is_tensor(v):
        return v.detach().clone()
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def async_save_state_dict(state_dict: Dict, path: str, process_group=None,
                          coordinator_rank: int = 0,
                          unique_id: Optional[int] = None
                          ) -> AsyncSaveHandle:
    """Checkpoint without blocking training: the snapshot is taken now
    (device clones, so the caller may update its tensors in place right
    after return); the device-to-host copies, the file writes, the
    metadata merge and the commit run on a background thread, the copies
    on a CUDA stream of their own that starts after the clones."""
    snapshot = {key: _snapshot(v) for key, v in _flat_items(state_dict)}
    multi, _ = _world(process_group)
    if multi:
        _ckpt_group(process_group)      # made here, on the main thread
    cuda = [v for v in snapshot.values()
            if torch.is_tensor(v) and v.device.type == "cuda"]
    stream = None
    if cuda:
        stream = torch.cuda.Stream(device=cuda[0].device)
        stream.wait_stream(torch.cuda.current_stream(cuda[0].device))
    errbox: list = []

    def writer():
        try:
            if stream is None:
                save_state_dict(snapshot, path, process_group,
                                coordinator_rank, unique_id)
                return
            with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                save_state_dict(snapshot, path, process_group,
                                coordinator_rank, unique_id)
        except BaseException as e:   # surfaced via result()
            errbox.append(e)

    th = threading.Thread(target=writer, daemon=True,
                          name="dckpt-async-save")
    th.start()
    return AsyncSaveHandle(th, errbox)


from .manager import CheckpointManager  # noqa: E402
