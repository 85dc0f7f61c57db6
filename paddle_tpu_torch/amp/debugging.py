"""AMP debugging (port of ``paddle_tpu/amp/debugging.py``): operator
stats and tensor checks.

Operator stats count every registered op by name through the dispatch
seam's profile hook (``ops._op.set_profile_hook``); a profiler window's
hook is saved when collection starts and put back when it ends. The
tensor checker is ``FLAGS_check_nan_inf``. ``check_numerics`` reads one
count of NaN and one of inf to the host.
"""
from __future__ import annotations

import contextlib
import enum
import functools
from collections import Counter

import torch

from ..core import enforce as E
from ..ops import _op as _op_mod

__all__ = ["DebugMode", "TensorCheckerConfig", "check_numerics",
           "check_layer_numerics", "collect_operator_stats",
           "compare_accuracy", "disable_operator_stats_collection",
           "disable_tensor_checker", "enable_operator_stats_collection",
           "enable_tensor_checker"]


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3
    CHECK_ALL_ABORT = 4
    CHECK_ALL_ABORT_AND_DUMP = 5
    DUMP_ALL = 6


_op_counts: Counter = Counter()
_collecting = False
_saved_hook = None


def _count_begin(name):
    _op_counts[name] += 1


def _count_end():
    pass


def enable_operator_stats_collection():
    """Count every registered op by name until disabled."""
    global _collecting, _saved_hook
    if _collecting:
        return
    _saved_hook = _op_mod._PROFILE_HOOK
    _op_mod.set_profile_hook(_count_begin, _count_end)
    _collecting = True


def disable_operator_stats_collection():
    """Stop counting, put back the hook that was there, and print the
    table of calls by op."""
    global _collecting, _saved_hook
    if not _collecting:
        return
    if _saved_hook is not None:
        _op_mod.set_profile_hook(_saved_hook[0], _saved_hook[1])
    else:
        _op_mod.set_profile_hook(None, None)
    _collecting = False
    if _op_counts:
        width = max(len(k) for k in _op_counts)
        print("<------------------------------ op list "
              "------------------------------->")
        for name, cnt in _op_counts.most_common():
            print(f"  {name:<{width}}  calls: {cnt}")
        print("<----------------------------------- end "
              "----------------------------->")
    _op_counts.clear()


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


class TensorCheckerConfig:
    def __init__(self, enable=True, debug_mode=DebugMode.CHECK_NAN_INF,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    from ..core.flags import set_flags
    if checker_config.enable:
        set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    from ..core.flags import set_flags
    set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Raise ``PreconditionNotMetError`` naming the counts when a float
    ``tensor`` holds NaN or inf; return it otherwise."""
    if tensor.is_floating_point():
        n_nan = int(torch.isnan(tensor).sum())
        n_inf = int(torch.isinf(tensor).sum())
        if n_nan or n_inf:
            raise E.PreconditionNotMetError(
                f"check_numerics: {op_type or 'tensor'} {var_name} has "
                f"{n_nan} nan / {n_inf} inf values")
    return tensor


def check_layer_numerics(func):
    """Decorate a Layer's ``forward``: its tensor inputs and outputs are
    checked with ``check_numerics``."""
    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        for a in args:
            if isinstance(a, torch.Tensor):
                check_numerics(a, type(self).__name__, "input")
        out = func(self, *args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for o in outs:
            if isinstance(o, torch.Tensor):
                check_numerics(o, type(self).__name__, "output")
        return out

    return wrapper


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "compare_accuracy consumes the reference's nan-inf dump files, a "
        "GPU-kernel-level artifact this runtime does not produce; compare "
        "checkpoints/outputs directly instead")
