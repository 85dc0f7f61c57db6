"""The ``paddle.signal`` namespace (port of ``paddle_tpu/signal.py``):
``stft`` / ``istft`` and the framing pair ``frame`` / ``overlap_add``.
The framing ops are registered as ``signal_frame`` and
``signal_overlap_add`` when this module is imported (the reference
registers them at their first call)."""
import torch

from .core import enforce as E
from .ops._op import op_fn
from .ops.fft_ops import istft, stft  # noqa: F401

__all__ = ['stft', 'istft', 'frame', 'overlap_add']


def _positions(num, frame_length, hop_length, device):
    return (torch.arange(num, device=device)[:, None] * hop_length
            + torch.arange(frame_length, device=device)[None, :])


@op_fn(name="signal_frame")
def _frame(x, *, frame_length, hop_length, axis):
    n = x.shape[axis]
    num = 1 + (n - frame_length) // hop_length
    idx = _positions(num, frame_length, hop_length, x.device).reshape(-1)
    taken = torch.index_select(x, axis % x.ndim, idx)
    if axis in (-1, x.ndim - 1):
        out = taken.reshape(x.shape[:-1] + (num, frame_length))
        return out.transpose(-1, -2)                  # [..., flen, num]
    return taken.reshape((num, frame_length) + x.shape[1:])


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """``x`` cut into overlapping frames along ``axis``: ``axis=-1`` gives
    ``[..., frame_length, num_frames]``, ``axis=0`` ``[num_frames,
    frame_length, ...]``."""
    if frame_length > x.shape[axis]:
        raise E.InvalidArgumentError(
            f"frame_length ({frame_length}) > axis size ({x.shape[axis]})")
    if axis not in (0, -1, x.ndim - 1):
        raise E.InvalidArgumentError("frame: axis must be 0 or -1")
    return _frame(x, frame_length=frame_length, hop_length=hop_length,
                  axis=axis if axis == 0 else -1)


@op_fn(name="signal_overlap_add")
def _ola(x, *, hop_length, axis):
    if axis in (-1, x.ndim - 1):
        xm = x.transpose(-1, -2)                       # [..., num, flen]
        lead = xm.shape[:-2]
        num, flen = xm.shape[-2], xm.shape[-1]
        n = (num - 1) * hop_length + flen
        pos = _positions(num, flen, hop_length, x.device).reshape(-1)
        out = torch.zeros(lead + (n,), dtype=x.dtype, device=x.device)
        return out.index_add(-1, pos, xm.reshape(lead + (num * flen,)))
    num, flen = x.shape[0], x.shape[1]
    n = (num - 1) * hop_length + flen
    pos = _positions(num, flen, hop_length, x.device).reshape(-1)
    out = torch.zeros((n,) + x.shape[2:], dtype=x.dtype, device=x.device)
    return out.index_add(0, pos, x.reshape((num * flen,) + x.shape[2:]))


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of ``frame``: frames added back into a signal
    (``axis=-1``: ``[..., frame_length, num_frames]`` in; ``axis=0``:
    ``[num_frames, frame_length, ...]``)."""
    return _ola(x, hop_length=hop_length, axis=axis)
