import contextlib as _ctx

from .activation import silu  # noqa: F401
from .attention import (apply_rotary_emb, flash_attention,  # noqa: F401
                        flash_attention_with_sparse_mask,
                        flash_attn_qkvpacked, flash_attn_unpadded,
                        flash_attn_varlen_qkvpacked,
                        fused_rotary_position_embedding, gather_rope_rows,
                        rope_raw, rope_tables, scaled_dot_product_attention,
                        sdpa_raw, sdpa_reference, segment_attention_raw,
                        segment_ids_from_cu_seqlens)
from .common import embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401


@_ctx.contextmanager
def sdp_kernel(enable_math=True, enable_flash=True,
               enable_mem_efficient=True):
    """Scoped attention-backend choice (port of the reference's
    ``sdp_kernel``): with ``enable_flash=False`` the dense and segment
    attention take their plain math (``sdpa_reference``,
    ``segment_attention_ref``) instead of the flash kernels within the
    scope, on every device; the setting on entry comes back on exit."""
    from . import attention as _att
    prev = _att._FLASH_ENABLED
    try:
        if not enable_flash:
            _att._FLASH_ENABLED = False
        yield
    finally:
        _att._FLASH_ENABLED = prev
