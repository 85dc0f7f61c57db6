"""Exposition formats for the stat registry (a copy of
``paddle_tpu/monitor/exposition.py``).

Two consumers, two formats (reference split: monitor.h stats surface
through Paddle's pybind as dicts for python-side dumping; production
fleets scrape text):

- ``expose_text(registry)``: Prometheus text exposition format 0.0.4 —
  ``# HELP`` / ``# TYPE`` per family, histogram ``_bucket{le=...}`` /
  ``_sum`` / ``_count`` series. Metric names sanitize to the
  ``[a-zA-Z_:][a-zA-Z0-9_:]*`` charset (dots become underscores).
- ``dump_json(registry, run_id)``: the bench-embedding shape — a
  ``{"run_id": ..., "unix_time": ..., "metrics": snapshot()}`` payload
  BENCH_*.json can carry verbatim, with an optional atomic file write.
"""
from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Optional

from .registry import StatRegistry

__all__ = ["expose_text", "dump_json", "sanitize_name", "escape_help",
           "escape_label_value", "render_sample"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_FIRST_RE = re.compile(r"^[^a-zA-Z_:]")


def sanitize_name(name: str) -> str:
    """Prometheus-legal metric name (dots/slashes -> underscores)."""
    out = _NAME_RE.sub("_", name)
    if _FIRST_RE.match(out):
        out = "_" + out
    return out


def escape_help(text: str) -> str:
    """HELP-line escaping per the text format 0.0.4: backslash and
    newline (a doc string with a literal newline would otherwise split
    into a second, unparseable line)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value: str) -> str:
    """Label-value escaping: backslash, double-quote, newline — in that
    order (escaping the escapes first keeps the round-trip exact)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def render_sample(name: str, labels, value) -> str:
    """One exposition sample line, labels escaped:
    ``name{k="v",...} value``. ``labels`` may be None/{}."""
    n = sanitize_name(name)
    if labels:
        body = ",".join(
            f'{sanitize_name(str(k))}="{escape_label_value(v)}"'
            for k, v in labels.items())
        return f"{n}{{{body}}} {_fmt(value)}"
    return f"{n} {_fmt(value)}"


def _fmt(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and v == int(v) and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def expose_text(registry: StatRegistry) -> str:
    """Render every registered metric in the Prometheus text format."""
    lines = []
    for m in registry.metrics():
        name = sanitize_name(m.name)
        if m.doc:
            lines.append(f"# HELP {name} {escape_help(m.doc)}")
        lines.append(f"# TYPE {name} {m.kind}")
        if m.kind in ("counter", "gauge"):
            lines.append(f"{name} {_fmt(m.value)}")
        else:   # histogram
            for bound, cum in m.cumulative_buckets():
                le = "+Inf" if math.isinf(bound) else _fmt(bound)
                lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{name}_sum {_fmt(m.sum)}")
            lines.append(f"{name}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def dump_json(registry: StatRegistry, run_id: Optional[str] = None,
              path: Optional[str] = None) -> dict:
    """Snapshot keyed by a run id; optionally persisted (atomic
    tmp+rename, the autotune-cache write discipline)."""
    payload = {
        "run_id": run_id or f"{os.getpid()}-{int(time.time())}",
        "unix_time": round(time.time(), 3),
        "metrics": registry.snapshot(),
    }
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return payload
