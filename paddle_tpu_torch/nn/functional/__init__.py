import contextlib as _ctx

from .activation import *  # noqa: F401,F403
from .attention import (apply_rotary_emb, flash_attention,  # noqa: F401
                        flash_attention_with_sparse_mask,
                        flash_attn_qkvpacked, flash_attn_unpadded,
                        flash_attn_varlen_qkvpacked,
                        fused_rotary_position_embedding, gather_rope_rows,
                        rope_raw, rope_tables, scaled_dot_product_attention,
                        sdpa_raw, sdpa_reference, segment_attention_raw,
                        segment_ids_from_cu_seqlens)
from .common import *  # noqa: F401,F403
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, dice_loss, gaussian_nll_loss,
                   hinge_embedding_loss, kl_div, l1_loss, log_loss,
                   margin_ranking_loss, mse_loss,
                   multi_label_soft_margin_loss, nll_loss, npair_loss,
                   poisson_nll_loss, sigmoid_focal_loss, smooth_l1_loss,
                   soft_margin_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .norm import *  # noqa: F401,F403


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
