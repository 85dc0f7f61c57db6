"""The native (C++) data feed for memory-resident datasets (port of
``paddle_tpu/io/native_feed.py``).

For array-backed datasets the per-batch host work is a row gather and a
shuffle; ``paddle_tpu_torch/csrc/datafeed.cc`` runs both on a C++ worker
pool over a ring of reusable buffers, and Python makes one ctypes call a
batch. The library is built from the repo's source by the host C++
compiler at first use (``kernels/_build.py`` ``load_host``); when that
fails, the feed raises. Its C ABI and its shuffle are the reference's,
so both packages' feeds give the same batches for the same seed.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
from ..core import enforce as E

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels import _build
        lib = _build.load_host("datafeed")
        lib.df_pipeline_create.restype = ctypes.c_void_p
        lib.df_pipeline_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.df_pipeline_next.restype = ctypes.c_uint64
        lib.df_pipeline_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.df_pipeline_destroy.argtypes = [ctypes.c_void_p]
        lib.df_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.c_void_p]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """True when the feed's library builds (or is built) here."""
    try:
        _lib()
        return True
    except E.UnavailableError:
        return False


class NativeArrayFeeder:
    """Iterate shuffled batches of row-aligned numpy arrays, assembled
    by the C++ pipeline. ``epochs`` bounds iteration (1 = one pass)."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_threads: int = 2,
                 prefetch_depth: int = 4, epochs: int = 1):
        arrays = [np.ascontiguousarray(a) for a in arrays]
        n = {a.shape[0] for a in arrays}
        if len(n) != 1:
            raise E.InvalidArgumentError("all arrays must share dim 0")
        (self._n,) = n
        if self._n == 0 or batch_size < 1:
            raise E.InvalidArgumentError("need rows and a positive batch size")
        self._arrays = arrays          # keep alive: C++ reads in place
        self._batch = int(batch_size)
        self._drop_last = drop_last
        if int(epochs) < 1:
            # epochs=0 means "endless" to the C++ pipeline but __len__/
            # __iter__ are finite — workers would keep prefetching into
            # the ring after iteration stopped
            raise E.InvalidArgumentError(
                f"NativeArrayFeeder: epochs must be >= 1, got {epochs}")
        self._epochs = int(epochs)
        lib = _lib()
        srcs = (ctypes.c_void_p * len(arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
        row_bytes = (ctypes.c_uint64 * len(arrays))(
            *[a.nbytes // self._n for a in arrays])
        self._row_bytes = list(row_bytes)
        self._handle = lib.df_pipeline_create(
            srcs, row_bytes, len(arrays), self._n, self._batch,
            int(drop_last), int(shuffle), seed, self._epochs,
            num_threads, prefetch_depth)
        if not self._handle:
            raise E.PreconditionNotMetError("native datafeed pipeline create failed")
        self._lib = lib

    def __len__(self):
        per = self._n // self._batch if self._drop_last else \
            -(-self._n // self._batch)
        return per * self._epochs

    def __iter__(self):
        if getattr(self, "_consumed", False):
            raise E.PreconditionNotMetError(
                "NativeArrayFeeder is one-shot (the C++ pipeline "
                "prefetches through its epochs once); construct a new "
                "feeder per pass — DataLoader(worker_mode='native') "
                "does this for you on every __iter__")
        self._consumed = True
        lib = self._lib
        bufs = [np.empty((self._batch,) + a.shape[1:], a.dtype)
                for a in self._arrays]
        dsts = (ctypes.c_void_p * len(bufs))(
            *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
        epoch = ctypes.c_uint64()
        index = ctypes.c_uint64()
        remaining = len(self)
        while remaining > 0:
            rows = lib.df_pipeline_next(self._handle, dsts,
                                        ctypes.byref(epoch),
                                        ctypes.byref(index))
            if rows == 0:
                return
            remaining -= 1
            yield tuple(b[:rows].copy() for b in bufs)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.df_pipeline_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_gather(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """One multi-row gather through the C++ core (the collate
    primitive; also the benchmark hook)."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, np.uint64)
    if idx.size and int(idx.max()) >= src.shape[0]:
        # the C++ gather trusts its indices (raw memcpy) — bound them here
        raise IndexError(
            f"native_gather: index {int(idx.max())} out of range for "
            f"{src.shape[0]} rows")
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    _lib().df_gather(
        src.ctypes.data_as(ctypes.c_void_p),
        src.nbytes // max(src.shape[0], 1),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(idx), out.ctypes.data_as(ctypes.c_void_p))
    return out
