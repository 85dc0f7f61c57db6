from .activation import silu  # noqa: F401
from .attention import (apply_rotary_emb, flash_attn_unpadded,  # noqa: F401
                        flash_attn_varlen_qkvpacked, gather_rope_rows,
                        rope_raw, rope_tables, scaled_dot_product_attention,
                        sdpa_raw, sdpa_reference, segment_attention_raw,
                        segment_ids_from_cu_seqlens)
from .common import embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
