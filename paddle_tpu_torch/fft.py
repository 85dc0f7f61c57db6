"""The ``paddle.fft`` namespace (port of ``paddle_tpu/fft.py``)."""
from .ops.fft_ops import (fft, fft2, fftfreq, fftn, fftshift, hfft,  # noqa
                          hfft2, hfftn, ifft, ifft2, ifftn, ifftshift,
                          ihfft, ihfft2, ihfftn, irfft, irfft2, irfftn,
                          rfft, rfft2, rfftfreq, rfftn)

__all__ = [
    'fft', 'fft2', 'fftn', 'ifft', 'ifft2', 'ifftn', 'rfft', 'rfft2',
    'rfftn', 'irfft', 'irfft2', 'irfftn', 'hfft', 'hfft2', 'hfftn',
    'ihfft', 'ihfft2', 'ihfftn', 'fftfreq', 'rfftfreq', 'fftshift',
    'ifftshift',
]
