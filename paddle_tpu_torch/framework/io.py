"""``paddle.save`` / ``paddle.load`` and the asynchronous save (port of
``paddle_tpu/framework/io.py``).

The file format is the reference's: a pickle in which every tensor is
``{"__pt_tensor__": True, "data": ndarray, "stop_gradient", "name"}``
and nested dicts, lists and tuples keep their types. ``stop_gradient``
is ``not requires_grad``; ``name`` is a parameter's ``param_name`` (None
where it has none). Either package loads what the other wrote.

bfloat16: numpy has no bfloat16 of its own, and JAX pickles a bf16 leaf
as an ``ml_dtypes.bfloat16`` array. The port writes its bf16 tensors in
exactly that form (the same pickle opcodes, the 16-bit words as the
array's bytes) without importing ``ml_dtypes``, and reads such arrays
back through a restricted unpickler that takes ``ml_dtypes.bfloat16`` as
16-bit words, so neither side needs ``ml_dtypes`` to load the port's
files losslessly and the port needs none to load the reference's.

Writes are atomic: staged beside the destination, then ``os.replace``d,
so a crash mid-save never truncates an existing file. A file that does
not unpickle raises ``RuntimeError``. ``async_save`` snapshots every
tensor to host numpy at once (one device-to-host copy each) and writes
on a background thread; ``clear_async_save_task_queue`` waits for every
queued write.
"""
from __future__ import annotations

import os
import pickle
import threading
from pathlib import Path

import numpy as np
import torch

from ..device import to_torch_device

__all__ = ["save", "load", "async_save", "clear_async_save_task_queue"]


class _Bf16Type:
    """Stands for ``ml_dtypes.bfloat16`` in a pickle: written as that
    global, and read back from it."""


class _Bf16Dtype:
    """Stands for ``numpy.dtype(ml_dtypes.bfloat16)`` while unpickling."""

    def __setstate__(self, state):
        pass


# numpy's own ndarray rebuilder (``numpy.core`` or ``numpy._core``, as the
# installed numpy pickles it)
_NP_RECONSTRUCT = np.empty(0).__reduce__()[0]

# numpy's state of the bfloat16 dtype, as ``np.dtype.__reduce__`` gives it
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Bf16Bits:
    """A bfloat16 array held as its 16-bit words (``uint16``)."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits, np.uint16)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing a ``_Bf16Bits`` as the
    ``ml_dtypes.bfloat16`` ndarray JAX would pickle."""

    def reducer_override(self, obj):
        if isinstance(obj, _Bf16Bits):
            return (_NP_RECONSTRUCT,
                    (np.ndarray, (0,), b"b"),
                    (1, obj.bits.shape, _Bf16Dtype(), False,
                     obj.bits.tobytes()))
        if isinstance(obj, _Bf16Dtype):
            return (np.dtype, (_Bf16Type, False, True), _BF16_DTYPE_STATE)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _Bf16Type:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + b"ml_dtypes\nbfloat16\n")
        self.memoize(obj)


class _ArrayState:
    """An ndarray being unpickled; ``value`` once its state is set: an
    ndarray, or ``_Bf16Bits`` for a bfloat16 array."""

    __slots__ = ("value",)

    def __setstate__(self, state):
        _, shape, dtype, _, raw = state
        if isinstance(dtype, _Bf16Dtype):
            self.value = _Bf16Bits(
                np.frombuffer(raw, np.uint16).reshape(shape))
            return
        a = np.ndarray.__new__(np.ndarray, (0,), "b")
        a.__setstate__(state)
        self.value = a


def _reconstruct(cls, shape, dtype):
    return _ArrayState()


def _dtype(obj, *args):
    if obj is _Bf16Type:
        return _Bf16Dtype()
    return np.dtype(obj, *args)


class _Unpickler(pickle.Unpickler):
    """Reads bfloat16 arrays (``ml_dtypes.bfloat16``) as 16-bit words
    without ``ml_dtypes``; every other class as ``pickle`` would."""

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bf16Type
        if module == "numpy" and name == "dtype":
            return _dtype
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return _reconstruct
        return super().find_class(module, name)


def _host(t: torch.Tensor):
    """A host copy of ``t`` (one device-to-host copy on the card; a copy
    on the CPU too, so later in-place updates never reach it): an
    ndarray, or ``_Bf16Bits``."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).to("cpu", copy=True).numpy()
        return _Bf16Bits(bits.view(np.uint16))
    return t.to("cpu", copy=True).numpy()


def _to_storable(obj):
    if torch.is_tensor(obj):
        return {"__pt_tensor__": True, "data": _host(obj),
                "stop_gradient": not obj.requires_grad,
                "name": getattr(obj, "param_name", None)}
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_storable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _numpy(data):
    """A loaded leaf as numpy: a bfloat16 array as float32 (exact)."""
    if isinstance(data, _ArrayState):
        data = data.value
    if isinstance(data, _Bf16Bits):
        return (data.bits.astype(np.uint32) << 16).view(np.float32)
    return data


def _tensor(data, device):
    if isinstance(data, _ArrayState):
        data = data.value
    if isinstance(data, _Bf16Bits):
        t = torch.from_numpy(data.bits.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(data))
    return t.to(device)


def _from_storable(obj, return_numpy, device):
    if isinstance(obj, dict):
        if obj.get("__pt_tensor__"):
            if return_numpy:
                return _numpy(obj["data"])
            t = _tensor(obj["data"], device)
            if not obj["stop_gradient"] and t.is_floating_point():
                t.requires_grad_()
            if obj.get("name") is not None:
                t.param_name = obj["name"]
            return t
        return {k: _from_storable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_storable(v, return_numpy, device) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    if isinstance(obj, (_ArrayState, _Bf16Bits)):
        return _numpy(obj)
    return obj


def _write(storable, path, protocol):
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    # pid + thread id: a concurrent save of the same path from another
    # process or thread must not share the staging file
    tmp = p.parent / f"{p.name}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            _Pickler(f, protocol=protocol).dump(storable)
        os.replace(tmp, p)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def save(obj, path, protocol=4):
    """``paddle.save``: pickles ``obj`` into a staging file beside
    ``path`` and ``os.replace``s it over ``path``, so a crash (or a
    raising ``__reduce__``) mid-write never truncates an existing
    file."""
    _write(_to_storable(obj), path, protocol)


def load(path, return_numpy=False):
    """``paddle.load``: tensors come back on the current device (the card
    unless ``set_device("cpu")`` asked for the CPU); with
    ``return_numpy`` as numpy arrays (bfloat16 as float32). A file that
    does not unpickle raises ``RuntimeError``."""
    device = None if return_numpy else to_torch_device()
    try:
        with open(path, "rb") as f:
            obj = _Unpickler(f).load()
    except FileNotFoundError:
        raise
    except (pickle.UnpicklingError, EOFError, AttributeError,
            ImportError, IndexError, UnicodeDecodeError, ValueError,
            TypeError) as e:
        raise RuntimeError(
            f"paddle.load: failed to unpickle checkpoint at {str(path)!r} "
            f"({type(e).__name__}: {e}) — the file is truncated, corrupt, "
            "or not a paddle checkpoint") from e
    return _from_storable(obj, return_numpy, device)


# -- asynchronous save: the object is snapshotted to host numpy at once
# (training may go on mutating the parameters), the pickle and the write
# run on a daemon thread. ---------------------------------------------------
_ASYNC_TASKS: list = []
_ASYNC_MU = threading.Lock()        # guards the task list
_ASYNC_WRITE_MU = threading.Lock()  # serializes the writes


def async_save(obj, path, protocol=4, sync_other_task=False):
    """``save`` that returns at once with the writer thread: every
    tensor is copied to the host before it returns, the write happens in
    the background."""
    if sync_other_task:
        clear_async_save_task_queue()
    snap = _to_storable(obj)

    def run():
        # one write at a time: concurrent saves (same or different
        # paths) serialize instead of interleaving on a shared file
        with _ASYNC_WRITE_MU:
            _write(snap, path, protocol)

    th = threading.Thread(target=run, daemon=True)
    with _ASYNC_MU:
        # prune finished writers here as well as in the drain call, so a
        # trainer that never drains holds no dead threads; start under
        # the lock (an unstarted thread reads as not alive)
        _ASYNC_TASKS[:] = [t for t in _ASYNC_TASKS if t.is_alive()]
        th.start()
        _ASYNC_TASKS.append(th)
    return th


def clear_async_save_task_queue():
    """Block until every queued ``async_save`` has finished writing."""
    while True:
        with _ASYNC_MU:
            if not _ASYNC_TASKS:
                return
            th = _ASYNC_TASKS.pop()
        if th.is_alive():
            th.join()
