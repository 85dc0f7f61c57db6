"""Roofline classification: is each program compute-, HBM- or
comm-bound? (port of ``paddle_tpu/monitor/roofline.py``).

Every program in the registry (``monitor/programs.py``) carries its
FLOPs and bytes accessed, which the serving engine counts from the
program's shapes (``serving_program_flops`` / ``serving_program_bytes``),
and the collectives counted at the port's seams (``monitor/comms.py``).
Dividing those by the card's peak FLOP/s, HBM bandwidth and
interconnect bandwidth gives three modeled times; the largest names the
bottleneck, and arithmetic intensity against the ridge point
(peak FLOP/s over HBM bytes/s) is the classic verdict for the
compute-vs-HBM pair.

Peaks resolve as ``monitor/mfu.py``'s do: the env override
(``PADDLE_TPU_PEAK_HBM_GBS`` / ``PADDLE_TPU_PEAK_ICI_GBS``) -> the
card's table row (H100 SXM: HBM3 3350 GB/s; NVLink 4, 450 GB/s each
way, a modeling figure for the comm denominator) -> a nominal host
figure. A program whose FLOPs or bytes are unknown classifies as
``None``, never as a made-up bound.

**Calibration**: a program carrying sampled execution times
(``monitor/exectime.py``) composes its measured mean wall time with its
modeled time into ``model_error_ratio`` (measured / modeled, ``None``
when unsampled); beyond ``PADDLE_TPU_ROOFLINE_ERROR_MAX`` (default 4,
either way) it is flagged ``model_divergent``, and the worst ratio
exports as ``roofline.model.max_error_ratio``.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["PEAK_HBM_GBS_TABLE", "PEAK_ICI_GBS_TABLE",
           "peak_hbm_bytes_per_sec", "peak_ici_bytes_per_sec",
           "ridge_point", "classify", "resolve_peaks",
           "model_error_threshold", "roofline_snapshot"]

# HBM bandwidth by card (GB/s; datasheet figures, SXM parts).
PEAK_HBM_GBS_TABLE = {
    "h100": 3350.0,
}

# Interconnect bandwidth by card (GB/s, NVLink one way) — a modeling
# figure for the comm-time denominator (see module docstring).
PEAK_ICI_GBS_TABLE = {
    "h100": 450.0,
}

# Nominal host figures when nothing overrides: keeps CPU-smoke verdicts
# finite without claiming to measure the machine.
_CPU_NOMINAL_HBM = 5e10      # ~50 GB/s DDR
_CPU_NOMINAL_ICI = 1e10      # ~10 GB/s loopback stand-in


def _resolve_bw(env_name: str, table: dict, nominal: float,
                device=None) -> dict:
    """Bandwidth adapter over the ONE shared resolver
    (``monitor/mfu.py::resolve_peak``): env (GB/s) -> the card's table
    row (GB/s) -> nominal (bytes/s). Returns ``{"bytes_per_sec",
    "source", "generation"}``."""
    from . import mfu as _mfu

    r = _mfu.resolve_peak(env_name, table, nominal, device, scale=1e9)
    return {"bytes_per_sec": r["value"], "source": r["source"],
            "generation": r["generation"]}


def peak_hbm_bytes_per_sec(device=None) -> float:
    """Peak HBM bytes/s of ``device`` (default: the current card);
    ``PADDLE_TPU_PEAK_HBM_GBS`` overrides."""
    return _resolve_bw("PADDLE_TPU_PEAK_HBM_GBS", PEAK_HBM_GBS_TABLE,
                       _CPU_NOMINAL_HBM, device)["bytes_per_sec"]


def peak_ici_bytes_per_sec(device=None) -> float:
    """Modeled peak interconnect bytes/s for ``device``;
    ``PADDLE_TPU_PEAK_ICI_GBS`` overrides."""
    return _resolve_bw("PADDLE_TPU_PEAK_ICI_GBS", PEAK_ICI_GBS_TABLE,
                       _CPU_NOMINAL_ICI, device)["bytes_per_sec"]


def resolve_peaks(device=None) -> dict:
    """The full denominator set + provenance for one device: peak
    FLOP/s (``monitor/mfu.py`` table), HBM and interconnect bandwidth
    (tables above), and the ridge point. ``hbm_source`` / ``ici_source``
    say whether a table row, an env override, or a nominal figure
    answered."""
    from . import mfu as _mfu

    kind, platform = _mfu._device_kind(device)
    hbm = _resolve_bw("PADDLE_TPU_PEAK_HBM_GBS", PEAK_HBM_GBS_TABLE,
                      _CPU_NOMINAL_HBM, device)
    ici = _resolve_bw("PADDLE_TPU_PEAK_ICI_GBS", PEAK_ICI_GBS_TABLE,
                      _CPU_NOMINAL_ICI, device)
    fl = _mfu.resolve_peak("PADDLE_TPU_PEAK_FLOPS",
                           _mfu.PEAK_FLOPS_TABLE, _mfu._CPU_NOMINAL,
                           device)
    return {
        "device_kind": kind,
        "platform": platform,
        "peak_flops_per_sec": fl["value"],
        "flops_source": fl["source"],
        "flops_generation": fl["generation"],
        "peak_hbm_bytes_per_sec": hbm["bytes_per_sec"],
        "hbm_source": hbm["source"],
        "hbm_generation": hbm["generation"],
        "peak_ici_bytes_per_sec": ici["bytes_per_sec"],
        "ici_source": ici["source"],
        "ici_generation": ici["generation"],
        "ridge_point_flops_per_byte": ridge_point(
            fl["value"], hbm["bytes_per_sec"]),
    }


def ridge_point(peak_flops: float, peak_hbm_bps: float
                ) -> Optional[float]:
    """The roofline knee: arithmetic intensity (flops/byte) below
    which a kernel cannot reach peak FLOP/s."""
    if peak_flops <= 0 or peak_hbm_bps <= 0:
        return None
    return peak_flops / peak_hbm_bps


def classify(flops: Optional[float], bytes_accessed: Optional[float],
             comm_bytes: float, peaks: dict) -> dict:
    """One program's roofline verdict from its measured inputs.

    Returns modeled times (seconds per invocation), arithmetic
    intensity, and ``verdict`` in {"compute-bound", "hbm-bound",
    "comm-bound", None}. None when flops or bytes-accessed are
    unavailable (None) — a missing measurement must not classify; an
    ANSWERED zero-FLOP program with real byte traffic classifies
    normally (trivially hbm/comm-bound). The modeled per-invocation
    time is ``max`` of the three legs (the roofline overlap
    assumption: whichever resource saturates is the wall)."""
    out = {"flops": flops, "bytes_accessed": bytes_accessed,
           "comm_bytes": comm_bytes, "arithmetic_intensity": None,
           "t_compute_s": None, "t_hbm_s": None, "t_comm_s": None,
           "t_modeled_s": None, "verdict": None}
    pf = peaks.get("peak_flops_per_sec") or 0
    ph = peaks.get("peak_hbm_bytes_per_sec") or 0
    pi = peaks.get("peak_ici_bytes_per_sec") or 0
    if flops is None or bytes_accessed is None or bytes_accessed <= 0 \
            or pf <= 0 or ph <= 0:
        return out
    out["arithmetic_intensity"] = flops / bytes_accessed
    t_compute = flops / pf
    t_hbm = bytes_accessed / ph
    t_comm = (comm_bytes / pi) if (comm_bytes and pi > 0) else 0.0
    out["t_compute_s"] = t_compute
    out["t_hbm_s"] = t_hbm
    out["t_comm_s"] = t_comm
    out["t_modeled_s"] = max(t_compute, t_hbm, t_comm)
    if t_comm > t_compute and t_comm > t_hbm:
        out["verdict"] = "comm-bound"
    elif t_compute >= t_hbm:
        out["verdict"] = "compute-bound"
    else:
        out["verdict"] = "hbm-bound"
    return out


def model_error_threshold() -> float:
    """Divergence flag threshold for ``model_error_ratio``
    (``PADDLE_TPU_ROOFLINE_ERROR_MAX``, default 4): a program whose
    measured/modeled ratio exceeds it — or undercuts its reciprocal —
    is flagged ``model_divergent``."""
    try:
        v = float(os.environ.get("PADDLE_TPU_ROOFLINE_ERROR_MAX", "4"))
        return v if v > 1.0 else 4.0
    except ValueError:
        return 4.0


def roofline_snapshot(analyze: bool = True, max_analyze: int = 8,
                      device=None) -> dict:
    """The ``/roofline`` payload: per-program verdicts over the program
    registry and a step-level attribution report. ``analyze`` and
    ``max_analyze`` keep the reference's signature; the port has no
    lazy program analysis to run.

    Attribution weights each program's modeled per-invocation time by
    its invocation count (1 compile + recorded cache hits): ``share``
    is its fraction of total modeled time, ``comm_fraction`` the
    fraction of total modeled time spent in collectives. Refreshes the
    ``roofline.programs.classified`` / ``roofline.comm.modeled_fraction``
    gauges (monitor-gated)."""
    from . import comms as _comms
    from . import programs as _programs
    from . import set_gauge as _set_gauge

    del analyze, max_analyze
    peaks = resolve_peaks(device)
    err_thr = model_error_threshold()
    progs = []
    total_t = total_comm_t = 0.0
    classified = measured = 0
    # worst ratio in EITHER direction: a 0.05x ratio (model 20x over-
    # estimates) is a bigger model error than a 1.1x — rank by
    # max(ratio, 1/ratio), report the actual ratio
    max_error = None
    max_error_dev = 0.0
    divergent = []
    for rec in _programs.programs_snapshot():
        comm_ops, comm_bytes = _comms.total_counts(rec.get("collectives"))
        cls = classify(rec.get("flops"), rec.get("bytes_accessed"),
                       comm_bytes, peaks)
        invocations = rec.get("hits", 0) + 1
        entry = {
            "name": rec["name"],
            "source": rec["source"],
            "signature": rec["signature"],
            "invocations": invocations,
            "collective_ops": comm_ops,
            "collectives": rec.get("collectives"),
            "comms_analyzed": rec.get("collectives") is not None,
            **cls,
        }
        # calibration: measured (sampled) mean wall time vs the model.
        # Both legs must exist — an unsampled or unclassified program
        # keeps model_error_ratio None, never a fabricated number.
        exec_mean_ms = rec.get("exec_mean_ms")
        entry["exec_samples"] = rec.get("exec_samples", 0)
        entry["exec_mean_ms"] = exec_mean_ms
        entry["exec_max_ms"] = rec.get("exec_max_ms")
        ratio = None
        if exec_mean_ms is not None and cls["t_modeled_s"]:
            ratio = (exec_mean_ms / 1e3) / cls["t_modeled_s"]
            measured += 1
            dev = max(ratio, 1.0 / ratio) if ratio > 0 else float("inf")
            if max_error is None or dev > max_error_dev:
                max_error, max_error_dev = ratio, dev
        entry["model_error_ratio"] = round(ratio, 4) \
            if ratio is not None else None
        entry["model_divergent"] = bool(
            ratio is not None
            and (ratio > err_thr or ratio < 1.0 / err_thr))
        if entry["model_divergent"]:
            divergent.append({"name": entry["name"],
                              "model_error_ratio":
                                  entry["model_error_ratio"],
                              "verdict": cls["verdict"]})
        if cls["t_modeled_s"] is not None:
            classified += 1
            entry["t_modeled_total_s"] = cls["t_modeled_s"] * invocations
            total_t += entry["t_modeled_total_s"]
            total_comm_t += (cls["t_comm_s"] or 0.0) * invocations
        progs.append(entry)
    # dominant-first: the program an operator should look at is line 1
    progs.sort(key=lambda p: -(p.get("t_modeled_total_s") or 0.0))
    for p in progs:
        t = p.get("t_modeled_total_s")
        p["share"] = round(t / total_t, 4) if t and total_t > 0 else None
    comm_fraction = (total_comm_t / total_t) if total_t > 0 else None
    _set_gauge("roofline.programs.classified", classified,
               doc="registry programs with a compute/HBM/comm-bound "
                   "verdict (flops + bytes-accessed both measured)")
    if comm_fraction is not None:
        _set_gauge("roofline.comm.modeled_fraction",
                   round(comm_fraction, 6),
                   doc="fraction of total modeled program time spent "
                       "in collectives (invocation-weighted)")
    if max_error is not None:
        _set_gauge("roofline.model.max_error_ratio",
                   round(max_error, 4),
                   doc="worst measured/modeled execution-time ratio "
                       "across sampled registry programs (worst in "
                       "EITHER direction, ranked by max(r, 1/r)) — "
                       "the roofline model-error signal")
    verdicts = {}
    for p in progs:
        v = p["verdict"] or "unclassified"
        verdicts[v] = verdicts.get(v, 0) + 1
    return {
        "peaks": peaks,
        "programs": progs,
        "comm": _comms.comm_summary(),
        "calibration": {
            "measured_programs": measured,
            "max_error_ratio": round(max_error, 4)
            if max_error is not None else None,
            "error_threshold": err_thr,
            "divergent": divergent,
        },
        "attribution": {
            "total_modeled_s": total_t,
            "comm_fraction": round(comm_fraction, 6)
            if comm_fraction is not None else None,
            "verdict_counts": verdicts,
            "dominant": [{"name": p["name"], "share": p["share"],
                          "verdict": p["verdict"]}
                         for p in progs[:5] if p["share"]],
        },
    }
