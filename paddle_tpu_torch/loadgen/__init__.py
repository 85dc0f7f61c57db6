"""Deterministic load generation for the serving engine (port of
``paddle_tpu/loadgen/``: the trace half, ``traces.py``, which also holds
a copy of the replay's prompt builder, ``traces._trace_prompt``). The
replay loop and the scorecard need the monitor planes and wait for them
(ROADMAP A10).
"""
from .traces import (ArrivalTrace, TenantSpec, TraceRequest,  # noqa: F401
                     generate_trace, heavy_tailed_lengths,
                     mixed_length_trace, prompt_tokens, tenant_prefix_tokens)

__all__ = ["ArrivalTrace", "TenantSpec", "TraceRequest", "generate_trace",
           "heavy_tailed_lengths", "mixed_length_trace", "prompt_tokens",
           "tenant_prefix_tokens"]
