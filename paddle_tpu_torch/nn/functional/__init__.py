from .attention import (rope_raw, rope_tables, sdpa_raw,  # noqa: F401
                        sdpa_reference)
