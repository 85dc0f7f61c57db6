"""The FFT ops (port of ``paddle_tpu/ops/fft_ops.py``): ``torch.fft`` at
the reference's normalisations (``"backward"``, ``"ortho"``,
``"forward"``). ``hfftn`` / ``ihfftn`` and their 2-D forms are the
reference's conjugate compositions over ``irfftn`` / ``rfftn``.
``stft`` / ``istft`` frame, window and transform as the reference
composes them (an overlap-add with the squared window's envelope for the
inverse)."""
from __future__ import annotations

import torch

from ._op import op_fn, wrap
from .math import _float
from ..core import enforce as E

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftshift", "ifftshift", "fftfreq", "rfftfreq", "stft", "istft",
]


def _norm(normalization):
    if normalization not in ("backward", "ortho", "forward"):
        raise E.InvalidArgumentError(
            f"Unexpected norm: {normalization!r} (use backward/ortho/forward)")
    return normalization


def _resolved(out):
    """``out`` with a lazy conjugate (torch's ``ihfft``) made physical."""
    return out.resolve_conj() if out.is_complex() else out


def _mk1(tfn, opname):
    @op_fn(name=opname)
    def op(x, *, n=None, axis=-1, norm="backward"):
        return _resolved(tfn(_float(x), n=n, dim=axis,
                             norm=_norm(norm)))

    def api(x, n=None, axis=-1, norm="backward", name=None):
        return op(x, n=n, axis=axis, norm=norm)
    api.__name__ = api.__qualname__ = opname
    return api


def _mkn(tfn, opname):
    @op_fn(name=opname)
    def op(x, *, s=None, axes=None, norm="backward"):
        return _resolved(tfn(_float(x), s=s, dim=axes,
                             norm=_norm(norm)))

    def api(x, s=None, axes=None, norm="backward", name=None):
        if isinstance(axes, list):
            axes = tuple(axes)
        if isinstance(s, list):
            s = tuple(s)
        return op(x, s=s, axes=axes, norm=norm)
    api.__name__ = api.__qualname__ = opname
    return api


def _mk2(tfn, opname):
    nd = _mkn(tfn, opname)

    def api(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return nd(x, s=s, axes=axes, norm=norm)
    api.__name__ = api.__qualname__ = opname
    return api


fft = _mk1(torch.fft.fft, "fft")
ifft = _mk1(torch.fft.ifft, "ifft")
rfft = _mk1(torch.fft.rfft, "rfft")
irfft = _mk1(torch.fft.irfft, "irfft")
hfft = _mk1(torch.fft.hfft, "hfft")
ihfft = _mk1(torch.fft.ihfft, "ihfft")

fftn = _mkn(torch.fft.fftn, "fftn")
ifftn = _mkn(torch.fft.ifftn, "ifftn")
rfftn = _mkn(torch.fft.rfftn, "rfftn")
irfftn = _mkn(torch.fft.irfftn, "irfftn")

fft2 = _mk2(torch.fft.fftn, "fft2")
ifft2 = _mk2(torch.fft.ifftn, "ifft2")
rfft2 = _mk2(torch.fft.rfftn, "rfft2")
irfft2 = _mk2(torch.fft.irfftn, "irfft2")

# hermitian-input nd transforms: the conjugate over the real transforms,
# with the normalisation mirrored
_MIRROR = {"backward": "forward", "forward": "backward", "ortho": "ortho"}


def _hfftn(x, s=None, dim=None, norm="backward"):
    return torch.fft.irfftn(torch.conj(x), s=s, dim=dim, norm=_MIRROR[norm])


def _ihfftn(x, s=None, dim=None, norm="backward"):
    return torch.conj_physical(torch.fft.rfftn(x, s=s, dim=dim,
                                               norm=_MIRROR[norm]))


hfftn = _mkn(_hfftn, "hfftn")
ihfftn = _mkn(_ihfftn, "ihfftn")
hfft2 = _mk2(_hfftn, "hfft2")
ihfft2 = _mk2(_ihfftn, "ihfft2")


@op_fn(name="fftshift")
def _fftshift(x, *, axes=None):
    return torch.fft.fftshift(x, dim=axes)


def fftshift(x, axes=None, name=None):
    if isinstance(axes, list):
        axes = tuple(axes)
    return _fftshift(x, axes=axes)


@op_fn(name="ifftshift")
def _ifftshift(x, *, axes=None):
    return torch.fft.ifftshift(x, dim=axes)


def ifftshift(x, axes=None, name=None):
    if isinstance(axes, list):
        axes = tuple(axes)
    return _ifftshift(x, axes=axes)


def _freq(fn, n, d, dtype):
    from ..core.dtype import convert_dtype
    from ..device import to_torch_device
    out = fn(int(n), d=float(d), device=to_torch_device(None))
    return wrap(out.to(convert_dtype(dtype)) if dtype is not None else out)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def _pad_last(x, pad, mode):
    """``x`` padded by ``pad`` on both ends of its last dim, as
    ``jnp.pad`` pads in ``mode`` (``reflect``: mirrored about the end
    values, which are not repeated; ``edge``; ``constant``: zeros)."""
    n = x.shape[-1]
    if mode == "constant":
        return torch.nn.functional.pad(x, (pad, pad))
    if mode == "reflect":
        idx = torch.cat([torch.arange(pad, 0, -1), torch.arange(n),
                         torch.arange(n - 2, n - 2 - pad, -1)])
    elif mode in ("edge", "replicate"):
        idx = torch.arange(-pad, n + pad).clamp(0, n - 1)
    else:
        raise E.InvalidArgumentError(f"stft: pad_mode {mode!r} is not "
                                     "reflect, edge or constant")
    return x[..., idx.to(x.device)]


def _frame_index(n_frames, n_fft, hop_length, device):
    return (torch.arange(n_frames, device=device)[:, None] * hop_length
            + torch.arange(n_fft, device=device)[None, :])


@op_fn(name="stft_op")
def _stft(x, window, *, n_fft, hop_length, center, pad_mode, normalized,
          onesided):
    if center:
        x = _pad_last(x, n_fft // 2, pad_mode)
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    frames = x[..., _frame_index(n_frames, n_fft, hop_length,
                                 x.device)] * window    # [..., frames, n_fft]
    spec = (torch.fft.rfft(frames, dim=-1) if onesided
            else torch.fft.fft(frames, dim=-1))
    if normalized:
        spec = spec / torch.sqrt(torch.tensor(float(n_fft),
                                              dtype=spec.real.dtype))
    return spec.transpose(-1, -2)                        # [..., freq, frames]


def _window(window, win_length, n_fft, like):
    win = (torch.ones(win_length, dtype=torch.float32, device=like.device)
           if window is None else window)
    if win_length < n_fft:                               # center-pad
        lp = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (lp, n_fft - win_length - lp))
    return win


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """The short-time Fourier transform ``[..., freq, frames]``."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    return _stft(x, _window(window, win_length, n_fft, x), n_fft=n_fft,
                 hop_length=hop_length, center=center, pad_mode=pad_mode,
                 normalized=normalized, onesided=onesided)


@op_fn(name="istft_op")
def _istft(spec, window, *, n_fft, hop_length, center, normalized,
           onesided, length, return_complex):
    spec = spec.transpose(-1, -2)                        # [..., frames, freq]
    if normalized:
        spec = spec * torch.sqrt(torch.tensor(float(n_fft),
                                              dtype=spec.real.dtype))
    frames = (torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided
              else torch.fft.ifft(spec, dim=-1))
    if not return_complex and frames.is_complex():
        frames = frames.real
    frames = frames * window
    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    idx = _frame_index(n_frames, n_fft, hop_length, spec.device).reshape(-1)
    batch = frames.shape[:-2]
    flat = frames.reshape(batch + (-1,))
    out = torch.zeros(batch + (out_len,), dtype=flat.dtype,
                      device=flat.device).index_add(-1, idx, flat)
    wsq = torch.zeros(out_len, dtype=window.dtype,
                      device=window.device).index_add(
        0, idx, (window * window).expand(n_frames, n_fft).reshape(-1))
    out = out / torch.where(wsq > 1e-11, wsq, torch.ones_like(wsq))
    if center:
        pad = n_fft // 2
        out = out[..., pad:out_len - pad]
    if length is not None:
        out = out[..., :length]
    return out


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse of ``stft`` by overlap-add."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    return _istft(x, _window(window, win_length, n_fft, x), n_fft=n_fft,
                  hop_length=hop_length, center=center,
                  normalized=normalized, onesided=onesided, length=length,
                  return_complex=return_complex)
