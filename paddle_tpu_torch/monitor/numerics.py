"""Numerics plane: where precision lives, per layer, over time (port of
``paddle_tpu/monitor/numerics.py``).

The host half of the value instrumentation; the device half lives in
``training/guards.py`` (``grad_numerics``: per-layer reductions inside
the guarded train step, ``FLAGS_enable_numerics``-gated). Three
consumers feed it:

- **Per-step grad statistics** (:func:`record_step_stats`): the
  guarded step's ``health["numerics"]`` block (per-layer absmax, rms,
  mean, zero fraction, overflow and underflow fraction against the
  dtype's range, squared norm) lands in a bounded per-layer ring, an
  absmax EMA per tensor, a top-k movers report and the
  ``worst_layer`` attribution the sentinel surfaces (non-finite layers
  rank above any finite norm). Each leaf's statistics come to the host
  as one stacked tensor: one copy a leaf, where the reference converts
  each statistic.
- **Quantization audit** (:func:`audit_quantized_tree`): per-weight
  SQNR (dB) and max abs error of a weight-only tree
  (``models.llama.quantize_weights``, int8 ``{"q", "s"}`` or packed
  int4 ``{"q4", "s"}``) against its full-precision source, through the
  serving seams' dequant math (float32 multiply, then one cast to the
  serving dtype, a torch dtype here).
- **KV-page absmax** (:func:`record_kv_absmax`): sampled 1-in-N decode
  chunks (``PADDLE_TPU_KV_SAMPLE``, default 16; 0 disables) at the
  engine's per-chunk download seam: plain PyTorch reductions over the
  pool run after the chunk's tokens reached the host, so the card has
  finished the chunk and the sample adds no synchronization of work in
  flight. For int8 pools, :func:`record_kv_quant` adds the referenced
  pages' scales and the fraction of codes at the +-127 rail.

Served at ``/numerics`` (``monitor/server.py``) and embedded in the
flight record. Gating: every record path is one cached
``FLAGS_enable_monitor`` branch when the monitor is off.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import flags as _flags
from ..training.guards import NUMERIC_STATS


def _host(x, dtype=None) -> np.ndarray:
    """A tensor (any device; bfloat16 through float32, which is exact) or
    array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x, dtype)

__all__ = [
    "record_step_stats", "worst_layer", "top_movers", "latest",
    "sqnr_db", "dequant_ref", "audit_quantized_tree", "last_audit",
    "kv_sample_rate", "set_kv_sample_rate", "record_kv_absmax",
    "record_kv_quant", "kv_quant_snapshot",
    "kv_snapshot", "numerics_snapshot", "reset", "NUMERIC_STATS",
]

_FLAG = _flags.flag_info("enable_monitor")

_DEFAULT_CAPACITY = 128
_EMA_BETA = 0.9
_TOPK = 5

_MU = threading.Lock()
_RING: deque = deque(maxlen=_DEFAULT_CAPACITY)
_TOTAL = [0]                     # lifetime rows (bounding evidence)
_LAST_STEP = [0]
# per-tensor state: key -> latest stat dict / absmax EMA. Keys are
# "layers.<name>[<l>]" for scan-stacked weights, the plain tree name
# otherwise — the layer map a debug session walks.
_LATEST: Dict[str, dict] = {}
_EMA: Dict[str, float] = {}
_WORST: List[Optional[dict]] = [None]
_AUDIT: List[Optional[dict]] = [None]

# KV-page absmax distribution (engine-fed, 1-in-N chunks)
_KV_RATE: list = [None]          # None = re-read env on next use
_KV_MU = threading.Lock()
_KV = {"samples": 0, "pages": 0, "min": None, "max": None,
       "sum": 0.0, "recent": deque(maxlen=64)}
# KV-quant write-time health (engine-fed when FLAGS_serving_kv_quant):
# latest sampled scale-plane p99 + saturated-code fraction
_KVQ = {"samples": 0, "scale_p99": None, "clip_fraction": None}


def _capacity_from_env() -> int:
    try:
        n = int(os.environ.get("PADDLE_TPU_NUMERICS_STEPS",
                               str(_DEFAULT_CAPACITY)))
        return max(n, 8)
    except ValueError:
        return _DEFAULT_CAPACITY


_RING = deque(maxlen=_capacity_from_env())


# -- per-step grad statistics ------------------------------------------------

def _flatten_stats(stats) -> Dict[str, dict]:
    """Host-coerce one step's device stats tree into
    {entry_key: {stat: float}} rows, expanding the per-layer [L] rows
    of scan-stacked weights into one entry per layer index and adding
    the derived ``gnorm`` (sqrt of the breakdown's squared norm)."""
    out: Dict[str, dict] = {}

    def put(key, host_vals, idx=None):
        row = {}
        for stat in NUMERIC_STATS:
            v = host_vals[stat]
            row[stat] = float(v if idx is None else v[idx])
        g = row["gnorm_sq"]
        row["gnorm"] = math.sqrt(g) if g >= 0 and math.isfinite(g) \
            else float("nan")
        out[key] = row

    def to_host(vals):
        # one stacked copy a leaf: this runs on the per-step train-loop
        # path, and each copy of a device tensor waits for the card
        stacked = _host(torch.stack([torch.as_tensor(vals[stat]).float()
                                     for stat in NUMERIC_STATS]))
        return dict(zip(NUMERIC_STATS, stacked))

    for name, vals in stats.get("layers", {}).items():
        host = to_host(vals)
        for l in range(int(host["gnorm_sq"].shape[0])):
            put(f"layers.{name}[{l}]", host, l)
    for name, vals in stats.get("tensors", {}).items():
        put(name, to_host(vals))
    return out


def record_step_stats(stats, step: Optional[int] = None):
    """Digest one guarded step's ``health["numerics"]`` block
    (monitor-gated; one cached-flag branch when off). Updates the
    per-tensor latest view, the absmax EMAs, the worst-layer
    attribution, the bounded timeseries ring, and the ``numerics.*``
    gauges. Returns the worst-layer dict (None when the monitor is
    off or the stats are empty)."""
    if not _FLAG.value:
        return None
    from . import inc as _inc
    from . import set_gauge as _set_gauge

    rows = _flatten_stats(stats)
    if not rows:
        return None
    worst = None
    max_absmax = 0.0
    max_over = 0.0
    max_under = 0.0
    with _MU:
        for key, row in rows.items():
            prev = _EMA.get(key)
            if math.isfinite(row["absmax"]):
                _EMA[key] = row["absmax"] if prev is None else \
                    _EMA_BETA * prev + (1 - _EMA_BETA) * row["absmax"]
            _LATEST[key] = row
            g = row["gnorm"]
            # non-finite layers rank above ANY finite norm (a NaN layer
            # IS the worst layer); ties keep the first in tree order
            rank = float("inf") if not math.isfinite(g) else g
            if worst is None or rank > worst["_rank"]:
                worst = {"name": key, "grad_norm": g,
                         "finite": math.isfinite(g), "_rank": rank}
            if math.isfinite(row["absmax"]):
                max_absmax = max(max_absmax, row["absmax"])
            max_over = max(max_over, row["overflow_frac"])
            max_under = max(max_under, row["underflow_frac"])
        step = int(step) if step is not None else _LAST_STEP[0] + 1
        _LAST_STEP[0] = step
        _RING.append({
            "step": step,
            "unix_time": round(time.time(), 3),
            "worst_layer": worst["name"],
            "worst_gnorm": worst["grad_norm"],
            "gnorm": {k: r["gnorm"] for k, r in rows.items()},
            "absmax": {k: r["absmax"] for k, r in rows.items()},
        })
        _TOTAL[0] += 1
        worst = dict(worst)
        worst.pop("_rank")
        _WORST[0] = worst
    _inc("numerics.steps",
         doc="guarded train steps whose in-graph numerics block was "
             "recorded by the numerics plane")
    _set_gauge("numerics.tensors.tracked", len(_LATEST),
               doc="per-layer tensor entries with recorded statistics")
    _set_gauge("numerics.worst.gnorm",
               worst["grad_norm"] if worst["finite"] else -1.0,
               doc="largest per-layer grad norm of the latest recorded "
                   "step (-1 = the worst layer is non-finite)")
    _set_gauge("numerics.absmax.max", max_absmax,
               doc="largest finite per-layer grad absmax of the latest "
                   "recorded step")
    _set_gauge("numerics.overflow.max_frac", max_over,
               doc="largest per-layer fraction of grad values within 2x "
                   "of the tensor dtype's finite max")
    _set_gauge("numerics.underflow.max_frac", max_under,
               doc="largest per-layer fraction of nonzero grad values "
                   "below the tensor dtype's smallest normal")
    return worst


def worst_layer() -> Optional[dict]:
    """The latest step's worst layer: {"name", "grad_norm", "finite"}
    (non-finite layers rank above any finite norm), or None before any
    step was recorded."""
    return _WORST[0]


def top_movers(k: int = _TOPK) -> List[dict]:
    """The tensors whose latest absmax moved most against their EMA —
    ranked by max(ratio, 1/ratio), so a collapse hides as little as a
    blow-up. Entries without an EMA history or with a non-finite
    absmax are skipped."""
    out = []
    with _MU:
        for key, row in _LATEST.items():
            ema = _EMA.get(key)
            a = row["absmax"]
            if ema is None or ema <= 0 or not math.isfinite(a) or a <= 0:
                continue
            ratio = a / ema
            out.append({"name": key, "absmax": a,
                        "absmax_ema": round(ema, 9),
                        "ratio": round(ratio, 6),
                        "_rank": max(ratio, 1.0 / ratio)})
    out.sort(key=lambda e: e["_rank"], reverse=True)
    for e in out:
        e.pop("_rank")
    return out[:k]


def latest() -> Dict[str, dict]:
    """The latest per-tensor stat rows (copy), keyed by entry name."""
    with _MU:
        return {k: dict(v) for k, v in _LATEST.items()}


# -- quantization audit ------------------------------------------------------

def sqnr_db(ref, deq) -> float:
    """Signal-to-quantization-noise ratio in dB of ``deq`` against the
    full-precision ``ref``: 10*log10(sum(ref^2) / sum((ref-deq)^2)).
    +inf for an exact reconstruction, -inf for a zero-signal tensor
    with nonzero error, nan when both are zero."""
    ref = _host(ref, np.float64)
    deq = _host(deq, np.float64)
    sig = float(np.sum(ref * ref))
    err = float(np.sum((ref - deq) ** 2))
    if err == 0.0:
        return float("inf") if sig > 0 else float("nan")
    if sig == 0.0:
        return float("-inf")
    return 10.0 * math.log10(sig / err)


def _scale_axes(qa: np.ndarray, sa: np.ndarray) -> List[int]:
    """Every axis of ``qa`` whose removal yields ``sa``'s shape."""
    if sa.ndim != qa.ndim - 1:
        raise ValueError(
            f"scale rank {sa.ndim} does not drop exactly one axis of "
            f"the quantized weight rank {qa.ndim}")
    return [i for i in range(qa.ndim)
            if qa.shape[:i] + qa.shape[i + 1:] == sa.shape]


def _scheme_in_axis(qa: np.ndarray) -> int:
    """The contraction (reduced) axis of the one scheme definition
    (``models.llama.quant_int8`` call sites): stacked ``[..., in, out]``
    weights quantize over ``in`` (second-to-last axis); the 2-D heads
    are ``[out, in]`` (``[V, D]`` against ``einsum('...d,vd->...v')``)
    and quantize over the LAST axis. Needed because shape inference
    alone is ambiguous on square tensors — a 64x64 head matches both
    axes, and picking the wrong one silently reads ~15 dB SQNR off a
    perfectly good quantization."""
    return qa.ndim - 1 if qa.ndim == 2 else qa.ndim - 2


def _unpack_int4_np(qa: np.ndarray, axis: int) -> np.ndarray:
    """Host-side inverse of ``models.llama.quant_packed``'s int4 nibble
    pack:
    sign-extend both nibbles of each byte and re-interleave along
    ``axis`` (even code -> low nibble, odd -> high), doubling it."""
    lo = (qa & 0x0F).astype(np.int16)
    lo = np.where(lo >= 8, lo - 16, lo)
    hi = ((qa.astype(np.int16) >> 4) & 0x0F)
    hi = np.where(hi >= 8, hi - 16, hi)
    shape = list(qa.shape)
    shape[axis] *= 2
    return np.stack([lo, hi], axis=axis + 1).reshape(shape) \
        .astype(np.int8)


def dequant_ref(q, s, in_axis: Optional[int] = None, *,
                int4_packed: bool = False) -> np.ndarray:
    """f32 reconstruction of a weight-only {"q": int8, "s": f32} leaf
    under the one scheme definition (``models.llama.quant_int8``) — or,
    with ``int4_packed``, of a {"q4": packed int4, "s"} leaf
    (``quant_packed``): the packed axis unpacks to int8 codes first.
    The scale's reduced axis is re-inserted and the multiply runs in
    f32 — the reference the serving-dtype seams are audited against.

    ``in_axis`` pins the reduced axis; by default it is inferred from
    the shapes, falling back to the scheme convention
    (:func:`_scheme_in_axis`) when a square tensor makes the shapes
    ambiguous. The scale drops the reduced axis entirely, so the
    inference works identically on a packed (halved) axis."""
    qa = _host(q)
    sa = _host(s, np.float32)
    axes = _scale_axes(qa, sa)
    if not axes:
        raise ValueError(
            f"scale shape {sa.shape} matches no reduced axis of "
            f"quantized shape {qa.shape}")
    if in_axis is not None:
        if in_axis not in axes:
            raise ValueError(
                f"in_axis {in_axis} is not a matching reduced axis "
                f"{axes} for scale {sa.shape} vs quantized {qa.shape}")
        axis = in_axis
    elif len(axes) == 1:
        axis = axes[0]
    else:
        scheme = _scheme_in_axis(qa)
        axis = scheme if scheme in axes else axes[0]
    if int4_packed:
        qa = _unpack_int4_np(qa, axis)
    return qa.astype(np.float32) * np.expand_dims(sa, axis)


def _walk_pair(ref, q, prefix=""):
    """Yield (path, ref_leaf, quant_dict) for every weight-only leaf —
    int8 ({"q", "s"}) and packed-int4 ({"q4", "s"}) forms both."""
    if isinstance(q, dict) and (set(q) == {"q", "s"}
                                or set(q) == {"q4", "s"}):
        yield prefix, ref, q
        return
    if isinstance(q, dict):
        for k in q:
            if k in ref:
                yield from _walk_pair(ref[k], q[k],
                                      f"{prefix}.{k}" if prefix else k)


def audit_quantized_tree(ref_params, q_params, serving_dtype=None
                         ) -> dict:
    """Per-weight-tensor quantization-error report of a weight-only
    int8 tree against its full-precision source: for every {"q", "s"}
    leaf, the SQNR (dB) and max abs error of the f32 reconstruction —
    and, when ``serving_dtype`` is given (a torch dtype, e.g.
    ``torch.bfloat16``), of the
    reconstruction as the serving matmuls actually see it (f32
    multiply, ONE cast to the serving dtype — the fixed seam
    ordering). The report is stored for ``/numerics`` and condensed
    onto the ``numerics.quant.*`` gauges; returns it."""
    tensors = {}
    min_sqnr = None
    int4_min_sqnr = None
    for path, ref_leaf, q_leaf in _walk_pair(ref_params, q_params):
        ref = _host(ref_leaf, np.float32)
        int4 = "q4" in q_leaf
        deq = dequant_ref(q_leaf["q4"] if int4 else q_leaf["q"],
                          q_leaf["s"], int4_packed=int4)
        entry = {
            "sqnr_db": round(sqnr_db(ref, deq), 3),
            "max_abs_err": round(float(np.max(np.abs(ref - deq))), 9),
            "absmax": round(float(np.max(np.abs(ref))), 9),
            "bits": 4 if int4 else 8,
        }
        if serving_dtype is not None:
            served = torch.from_numpy(deq).to(serving_dtype).float() \
                .numpy()
            entry["sqnr_served_db"] = round(sqnr_db(ref, served), 3)
        tensors[path] = entry
        s = entry.get("sqnr_served_db", entry["sqnr_db"])
        if math.isfinite(s) and (min_sqnr is None or s < min_sqnr):
            min_sqnr = s
        if int4 and math.isfinite(s) and (int4_min_sqnr is None
                                          or s < int4_min_sqnr):
            int4_min_sqnr = s
    report = {
        "unix_time": round(time.time(), 3),
        "tensors": tensors,
        "min_sqnr_db": min_sqnr,
        "int4_min_sqnr_db": int4_min_sqnr,
        "serving_dtype": str(serving_dtype).replace("torch.", "")
        if serving_dtype is not None else None,
    }
    if _FLAG.value:
        # the report always RETURNS (explicit offline analysis), but
        # the module's stores honor the monitor gate: off-flag,
        # nothing persists for /numerics or the flight record
        _AUDIT[0] = report
    if _FLAG.value and tensors:
        from . import set_gauge as _set_gauge
        _set_gauge("numerics.quant.tensors", len(tensors),
                   doc="weight tensors in the latest quantization "
                       "audit")
        if min_sqnr is not None:
            _set_gauge("numerics.quant.min_sqnr_db",
                       round(min_sqnr, 3),
                       doc="worst per-tensor SQNR (dB) of the latest "
                           "weight-only quantization audit")
        if int4_min_sqnr is not None:
            _set_gauge("numerics.quant.int4_min_sqnr_db",
                       round(int4_min_sqnr, 3),
                       doc="worst per-tensor SQNR (dB) among the "
                           "packed-int4 leaves of the latest "
                           "weight-only quantization audit")
    return report


def last_audit() -> Optional[dict]:
    return _AUDIT[0]


# -- KV-page absmax (engine-fed) ---------------------------------------------

def kv_sample_rate() -> int:
    """1-in-N decode-chunk sampling rate for KV-page absmax
    (``PADDLE_TPU_KV_SAMPLE``, default 16; 0 disables)."""
    r = _KV_RATE[0]
    if r is None:
        try:
            r = int(os.environ.get("PADDLE_TPU_KV_SAMPLE", "16"))
        except ValueError:
            r = 16
        r = max(r, 0)
        _KV_RATE[0] = r
    return r


def set_kv_sample_rate(n: Optional[int]):
    """Override the KV sampling rate in process (0 disables); ``None``
    re-reads the env var on next use."""
    _KV_RATE[0] = max(int(n), 0) if n is not None else None


def record_kv_absmax(absmax_k, absmax_v=None):
    """Digest one sampled chunk's per-layer per-page KV absmax arrays
    (any shape; the engine passes [L, P]). Maintains a running
    min/mean/max over every observed page value plus a bounded ring of
    per-sample quantile summaries — the distribution per-page KV-quant
    scale selection reads. Monitor-gated."""
    if not _FLAG.value:
        return
    from . import inc as _inc
    from . import set_gauge as _set_gauge

    parts = [np.asarray(absmax_k, np.float32).ravel()]
    if absmax_v is not None:
        parts.append(np.asarray(absmax_v, np.float32).ravel())
    vals = np.concatenate(parts)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return
    with _KV_MU:
        _KV["samples"] += 1
        _KV["pages"] += int(vals.size)
        _KV["sum"] += float(vals.sum())
        vmin, vmax = float(vals.min()), float(vals.max())
        _KV["min"] = vmin if _KV["min"] is None else min(_KV["min"], vmin)
        _KV["max"] = vmax if _KV["max"] is None else max(_KV["max"], vmax)
        _KV["recent"].append({
            "unix_time": round(time.time(), 3),
            "pages": int(vals.size),
            "min": round(vmin, 9),
            "p50": round(float(np.percentile(vals, 50)), 9),
            "p95": round(float(np.percentile(vals, 95)), 9),
            "max": round(vmax, 9),
            "mean": round(float(vals.mean()), 9),
        })
        gmax = _KV["max"]
    _inc("numerics.kv.samples",
         doc="decode chunks whose KV-page absmax was sampled (1-in-N "
             "at the per-chunk download seam)")
    _inc("numerics.kv.pages", int(vals.size),
         doc="per-layer page absmax values observed by KV sampling")
    _set_gauge("numerics.kv.absmax.max", round(gmax, 9),
               doc="largest KV-page absmax observed — the per-page "
                   "KV-quantization scale ceiling")


def record_kv_quant(scales, clip_fraction: float):
    """Digest one sampled chunk's KV-quant write-time health
    (FLAGS_serving_kv_quant engines, same 1-in-N seam as
    :func:`record_kv_absmax`): the referenced pages' scale-plane
    values and the fraction of int8 codes sitting at the +-127 clamp
    — saturation means a page's write-time scale went stale against
    later appends. Monitor-gated."""
    if not _FLAG.value:
        return
    from . import set_gauge as _set_gauge

    vals = np.asarray(scales, np.float32).ravel()
    vals = vals[np.isfinite(vals) & (vals > 0)]
    clip = float(clip_fraction)
    with _KV_MU:
        _KVQ["samples"] += 1
        if vals.size:
            _KVQ["scale_p99"] = round(
                float(np.percentile(vals, 99)), 9)
        _KVQ["clip_fraction"] = round(clip, 9)
        p99 = _KVQ["scale_p99"]
    if p99 is not None:
        _set_gauge("numerics.kv_quant.scale_p99", p99,
                   doc="p99 of the referenced KV pages' write-time "
                       "quantization scales (per-page per-kv-head "
                       "absmax/127) at the latest sample")
    _set_gauge("numerics.kv_quant.clip_fraction", round(clip, 9),
               doc="fraction of referenced int8 KV codes at the "
                   "+-127 clamp at the latest sample — saturation "
                   "from scales gone stale against later appends")


def kv_quant_snapshot() -> dict:
    with _KV_MU:
        return dict(_KVQ)


def kv_snapshot() -> dict:
    with _KV_MU:
        return {
            "sample_rate": kv_sample_rate(),
            "samples": _KV["samples"],
            "pages": _KV["pages"],
            "min": _KV["min"],
            "max": _KV["max"],
            "mean": (_KV["sum"] / _KV["pages"]) if _KV["pages"] else None,
            "recent": list(_KV["recent"]),
        }


# -- reporting ---------------------------------------------------------------

def _j(v):
    """JSON-safe float: non-finite -> None (a strict parser must never
    choke on a NaN token; the 'finite' flags carry the distinction)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _j(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_j(x) for x in v]
    return v


def numerics_snapshot(n: Optional[int] = None) -> dict:
    """The ``/numerics`` payload (and the flight record's ``numerics``
    block): latest per-tensor stats + EMAs, worst-layer attribution,
    top movers, the bounded step ring, the latest quantization audit,
    and the KV-page absmax distribution. Non-finite floats serialize
    as null (their ``finite`` flags keep the information)."""
    with _MU:
        rows = list(_RING)
        tensors = {k: dict(v, absmax_ema=_EMA.get(k))
                   for k, v in _LATEST.items()}
    if n is not None:
        # n=0 means NO rows (the bench condensation), not all of them
        rows = rows[-n:] if n > 0 else []
    return _j({
        "capacity": _RING.maxlen,
        "total_steps": _TOTAL[0],
        "worst_layer": _WORST[0],
        "top_movers": top_movers(),
        "tensors": tensors,
        "rows": rows,
        "quant": _AUDIT[0],
        "kv": kv_snapshot(),
        "kv_quant": kv_quant_snapshot(),
    })


def reset():
    with _MU:
        _RING.clear()
        _TOTAL[0] = 0
        _LAST_STEP[0] = 0
        _LATEST.clear()
        _EMA.clear()
        _WORST[0] = None
        _AUDIT[0] = None
    with _KV_MU:
        _KV.update(samples=0, pages=0, sum=0.0, min=None, max=None)
        _KV["recent"].clear()
        _KVQ.update(samples=0, scale_p99=None, clip_fraction=None)
