"""Deterministic load generation for the serving engine (port of
``paddle_tpu/loadgen/``): the seeded arrival traces (``traces.py``, which
also holds the replay's prompt builder, ``traces._trace_prompt``), the
open-loop single-engine replay (``replay.py`` :func:`replay_trace`, on a
virtual clock with burst and drain episodes) and the SLO scorecard
(``scorecard.py`` :func:`build_scorecard`, deterministic and timing
halves and a verdict), and the fleet replay (``replay.py``
:func:`replay_fleet`: replicas under the elastic serving controller,
publishing federated frames, with kill episodes and exactly-once
failover re-dispatch).
"""
from .replay import (BURST_RID_BASE, Episode, ReplayResult,  # noqa: F401
                     replay_fleet, replay_trace)
from .scorecard import (build_scorecard, last_scorecard,  # noqa: F401
                        set_last_scorecard)
from .traces import (ArrivalTrace, TenantSpec, TraceRequest,  # noqa: F401
                     generate_trace, heavy_tailed_lengths,
                     mixed_length_trace, prompt_tokens, tenant_prefix_tokens)

__all__ = ["ArrivalTrace", "BURST_RID_BASE", "Episode", "ReplayResult",
           "TenantSpec", "TraceRequest", "build_scorecard",
           "generate_trace", "heavy_tailed_lengths", "last_scorecard",
           "mixed_length_trace", "prompt_tokens", "replay_fleet", "replay_trace",
           "set_last_scorecard", "tenant_prefix_tokens"]
