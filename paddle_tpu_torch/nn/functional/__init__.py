from .attention import (flash_attn_unpadded,  # noqa: F401
                        flash_attn_varlen_qkvpacked, gather_rope_rows,
                        rope_raw, rope_tables, sdpa_raw, sdpa_reference,
                        segment_attention_raw, segment_ids_from_cu_seqlens)
