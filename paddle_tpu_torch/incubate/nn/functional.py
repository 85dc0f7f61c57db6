"""``paddle.incubate.nn.functional`` (port of ``fused_rms_norm`` and
``fused_rotary_position_embedding`` of
``paddle_tpu/incubate/nn/functional.py``; ``fused_layer_norm``,
``swiglu`` and ``fused_bias_act`` are ROADMAP.md queue A10).

``fused_rms_norm`` is the second user of the RMSNorm kernels: it goes
through ``F.rms_norm``, which launches ``rms_norm_fwd`` (and, under
autograd, ``rms_norm_bwd``) for CUDA tensors.
"""
from __future__ import annotations

from ...nn import functional as F
from ...nn.functional.attention import fused_rotary_position_embedding  # noqa: F401,E501

__all__ = ["fused_rms_norm", "fused_rotary_position_embedding"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """RMSNorm over the trailing axes from ``begin_norm_axis`` on (taken
    as one axis: ``x`` and the weight are flattened there, normalised and
    given their shape back), plus ``norm_bias``. Returns ``(out, None)``,
    as the reference."""
    ndim = x.ndim
    axis = begin_norm_axis % ndim
    if axis == ndim - 1:
        out = F.rms_norm(x, norm_weight, epsilon=epsilon)
    else:
        shape = list(x.shape)
        flat = x.reshape(shape[:axis] + [-1])
        wflat = None if norm_weight is None else norm_weight.reshape(-1)
        out = F.rms_norm(flat, wflat, epsilon=epsilon).reshape(shape)
    if norm_bias is not None:
        out = out + norm_bias
    return out, None
