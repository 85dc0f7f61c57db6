"""Train-loop anomaly sentinel: NaN / spike guards, skip-or-rollback
auto-recovery, and a hang watchdog (port of
``paddle_tpu/training/sentinel.py``).

A week-long run dies three ways that have nothing to do with the model:
a non-finite loss poisons the parameters, a gradient spike silently
degrades them, or a wedged step burns the card doing nothing. Three
cooperating pieces:

1. **The guard** (``models/llama.py`` / ``models/moe.py``
   ``make_train_step(guard=True)``, ``training/guards.py``): the step
   computes loss finiteness, the global gradient norm and the id range,
   and applies the update whole or not at all (parameters, moments and
   ``step`` byte-identical on an anomalous step).
2. **Host policy** (:class:`AnomalySentinel`): an EMA / sigma grad-norm
   spike detector feeds the guard's ``gnorm_cap``; anomalies climb an
   escalation ladder: skip the batch (quarantining its content hash and
   stamping a trace event), and after ``max_consecutive`` anomalies roll
   back through ``CheckpointManager.restore_latest`` and fast-forward a
   fresh deterministic data stream past the poisoned window
   (quarantined batches are skipped by hash on replay). On several
   ranks, any-rank-anomalous means all-ranks-skip through an
   ``all_gather_object`` agreement, so ranks never diverge on whether
   an update applied.
3. **Hang watchdog** (:class:`HangWatchdog`): a daemon thread fed by
   StepTimer heartbeats (``monitor.steptimer.add_step_listener``) and by
   :class:`SentinelLoop`. A stall past the deadline dumps the flight
   record plus all-thread stacks to disk and, configurably, exits
   non-zero so supervision restarts the worker.

Where the port differs from the reference: :class:`SentinelLoop` reads
the step's health (``finite``, ``grad_norm``, ``loss``) to the host in
one copy, after the guard's own read of its gate, where the reference
converts each scalar (on the card each conversion waits for the work
queued before it). :func:`batch_hash` walks dicts in sorted key order,
as ``jax.tree.leaves`` does, and hashes each leaf's numpy dtype name,
shape and bytes, so a batch hashes as JAX's does where the dtypes agree
(the port holds ids as ``int64`` where JAX on the CPU holds ``int32``).

Gating: ``FLAGS_enable_sentinel`` selects the guarded step in
``make_train_step`` (its ``guard=None`` default) and arms
:func:`guard_eager_update`; off (the default) every seam is one
cached-flag branch. Explicitly-constructed sentinel objects always work.
Metrics (``FLAGS_enable_monitor``-gated as usual) land under
``train.anomaly.*`` / ``train.watchdog.*``.

Proven by fault injection: ``testing/faults.py``'s ``corrupt`` action
plants NaN / Inf (or an out-of-range token id) into a batch at the
``train.batch`` value point, driving the skip / rollback / watchdog
tests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import monitor as _monitor
from ..core import flags as _flags
from ..monitor import profile_capture as _pcap
from ..monitor import timeseries as _timeseries
from ..monitor import trace as _trace
from ..testing import faults as _faults

__all__ = [
    "OK", "SKIP", "ROLLBACK",
    "SentinelConfig", "AnomalySentinel", "SentinelLoop", "HangWatchdog",
    "batch_hash", "fast_forward", "enabled", "guard_eager_update",
]

_FLAG = _flags.flag_info("enable_sentinel")

# Verdicts of AnomalySentinel.observe — what the loop should do with
# the step it just ran.
OK = "ok"              # update applied; keep going
SKIP = "skip"          # update did not apply; drop the batch, continue
ROLLBACK = "rollback"  # escalation: restore the last committed checkpoint


def enabled() -> bool:
    """True when FLAGS_enable_sentinel is set (env or set_flags)."""
    return _FLAG.value


@dataclasses.dataclass
class SentinelConfig:
    """Policy knobs (see docs/fault_tolerance.md for tuning guidance).

    The spike threshold is ``ema + spike_sigma * std`` over the grad
    norms of HEALTHY steps (EMA with ``ema_beta``; std floored at
    ``spike_floor_frac * ema`` so a converged run's near-zero variance
    cannot turn normal jitter into anomalies). Before ``warmup_steps``
    healthy observations the cap is +inf — early-training norms are
    legitimately wild."""
    ema_beta: float = 0.98
    spike_sigma: float = 6.0
    spike_floor_frac: float = 0.05
    warmup_steps: int = 20
    # escalation: this many CONSECUTIVE anomalies triggers a rollback
    # (when a CheckpointManager is attached; otherwise keep skipping)
    max_consecutive: int = 3
    # hard stop: a run that rolled back this many times is not going to
    # converge by rolling back harder
    max_rollbacks: int = 8
    # multi-host any-anomalous -> all-skip agreement gather. In clean
    # SPMD the health scalars are replicated and the gather is
    # redundant; it exists so a host-side divergence (corrupt local
    # data, a flaky host) can never split the fleet into updated and
    # non-updated halves. One small KV round-trip per step.
    agree: bool = True
    # host-identical tag namespace for the agreement gathers
    name: str = "train"


class _SpikeStats:
    """Bias-corrected EMA mean/std of the healthy-step grad norm."""

    __slots__ = ("beta", "n", "_m", "_v")

    def __init__(self, beta: float):
        self.beta = beta
        self.n = 0
        self._m = 0.0
        self._v = 0.0

    def update(self, g: float):
        if not math.isfinite(g):
            return
        self.n += 1
        self._m = self.beta * self._m + (1 - self.beta) * g
        self._v = self.beta * self._v + (1 - self.beta) * g * g

    @property
    def mean(self) -> float:
        if self.n == 0:
            return 0.0
        return self._m / (1 - self.beta ** self.n)

    @property
    def std(self) -> float:
        if self.n == 0:
            return 0.0
        var = self._v / (1 - self.beta ** self.n) - self.mean ** 2
        return math.sqrt(max(var, 0.0))


def _leaves(tree):
    """The leaves of a batch in ``jax.tree.leaves`` order: dict values by
    sorted key, list and tuple items in order, ``None`` no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [] if tree is None else [tree]


def _host_leaf(leaf) -> np.ndarray:
    """A leaf as a numpy array; a bfloat16 tensor as its raw 16-bit
    words (the bytes a JAX bfloat16 array holds)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def batch_hash(batch) -> str:
    """Content hash of a batch pytree (dtype+shape+bytes per leaf) —
    the quarantine key. Hashed on the host copy; the loop only hashes
    when a sentinel is active."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in _leaves(batch):
        arr = _host_leaf(leaf)
        dtype = "bfloat16" if torch.is_tensor(leaf) and \
            leaf.dtype == torch.bfloat16 else str(arr.dtype)
        h.update(dtype.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def fast_forward(stream, n: int):
    """Consume ``n`` items from a (deterministic) batch iterator — the
    post-rollback replay positioning: a checkpoint at step N means N
    batches were consumed, so a fresh stream fast-forwarded by N yields
    exactly the batches the restored run has not seen."""
    for _ in range(n):
        next(stream)
    _trace.instant("anomaly.fast_forward", n=n)
    return stream


class AnomalySentinel:
    """Consumes one guarded step's health per :meth:`observe` call and
    answers with a verdict (OK / SKIP / ROLLBACK); owns the spike
    detector, the escalation ladder, the quarantine set, and the
    multi-host agreement. Attach a
    ``distributed.checkpoint.CheckpointManager`` to enable the
    ROLLBACK verdict and :meth:`rollback`."""

    def __init__(self, config: Optional[SentinelConfig] = None, *,
                 manager=None):
        self.config = config or SentinelConfig()
        self.manager = manager
        self.stats = _SpikeStats(self.config.ema_beta)
        self.consecutive = 0
        self.anomalies = 0
        self.rollbacks = 0
        self.quarantine: set = set()
        # step-time drift (monitor/timeseries.py), OBSERVE-ONLY: the
        # ladder sees the signal (health provider, flight record) but
        # a slow step never changes a verdict — slowness is a paging
        # problem, not a data-corruption one.
        self.step_time_drift: Optional[float] = None
        # worst-layer attribution (monitor/numerics.py), OBSERVE-ONLY:
        # {"name", "grad_norm", "finite"} of the latest numerics-
        # enabled guarded step, set by the loop BEFORE observe() so a
        # SKIP/ROLLBACK names a layer instead of a scalar — the
        # verdict ladder itself never reads it. ``worst_layer_at_
        # anomaly`` freezes the attribution of the most recent
        # anomalous step: healthy steps after a skip keep refreshing
        # ``worst_layer``, but the operator reading the health report
        # still sees which layer blew up.
        self.worst_layer: Optional[dict] = None
        self.worst_layer_at_anomaly: Optional[dict] = None

    # -- device-gate feed ---------------------------------------------------

    def gnorm_cap(self) -> float:
        """The spike threshold the NEXT guarded step gates on (+inf
        during warmup): EMA mean + sigma * floored std of healthy grad
        norms seen so far."""
        c = self.config
        if self.stats.n < c.warmup_steps:
            return float("inf")
        mu = self.stats.mean
        std = max(self.stats.std, c.spike_floor_frac * mu + 1e-12)
        return mu + c.spike_sigma * std

    # -- verdicts -----------------------------------------------------------

    def observe(self, *, finite, grad_norm=None, loss=None,
                batch=None) -> str:
        """Digest one step's health: ``finite`` is the guarded step's
        applied flag (host bool or device scalar), ``grad_norm`` its
        aux norm, ``loss`` optional (classification only), ``batch``
        optional (quarantined on anomaly). Returns OK/SKIP/ROLLBACK;
        multi-host, the verdict is agreement-gathered so every rank
        returns the same one."""
        c = self.config
        fin = bool(finite)
        g = float(grad_norm) if grad_norm is not None else float("nan")
        anom = not fin
        if c.agree and dist.is_initialized() and dist.get_world_size() > 1:
            anom, g = self._agree(anom, g)
        if not anom:
            self.consecutive = 0
            self.stats.update(g)
            _monitor.set_gauge("train.anomaly.consecutive", 0)
            if math.isfinite(g):
                _monitor.set_gauge("train.anomaly.grad_norm_ema",
                                   round(self.stats.mean, 6))
                cap = self.gnorm_cap()
                if math.isfinite(cap):
                    _monitor.set_gauge("train.anomaly.grad_norm_cap",
                                       round(cap, 6))
            return OK
        self.anomalies += 1
        self.consecutive += 1
        nonfinite = (not math.isfinite(g)) or (
            loss is not None and not math.isfinite(float(loss)))
        _monitor.inc("train.anomaly.steps",
                     doc="anomalous train steps (update did not apply)")
        if nonfinite:
            _monitor.inc("train.anomaly.nonfinite",
                         doc="anomalous steps with a non-finite loss or "
                             "grad norm")
        else:
            _monitor.inc("train.anomaly.spikes",
                         doc="anomalous steps gated while finite (grad "
                             "spike over the cap, or invalid token ids)")
        _monitor.set_gauge("train.anomaly.consecutive", self.consecutive)
        if batch is not None:
            self.quarantine.add(batch_hash(batch))
            _monitor.set_gauge("train.anomaly.quarantined",
                               len(self.quarantine),
                               doc="batch hashes in the quarantine set")
        wl = self.worst_layer
        if wl is not None:
            self.worst_layer_at_anomaly = wl
        _trace.instant("anomaly.skip", consecutive=self.consecutive,
                       nonfinite=nonfinite,
                       grad_norm=g if math.isfinite(g) else None,
                       worst_layer=wl["name"] if wl else None,
                       worst_layer_grad_norm=(
                           wl["grad_norm"] if wl and wl["finite"]
                           else None))
        if self.manager is not None \
                and self.consecutive >= c.max_consecutive:
            return ROLLBACK
        return SKIP

    def is_quarantined(self, batch) -> bool:
        """True when this batch's content hash was quarantined by an
        earlier anomaly — the post-rollback replay must not feed a
        known-poisoned batch back into the model. O(1) after the hash;
        hashing is skipped entirely while the set is empty."""
        return bool(self.quarantine) and batch_hash(batch) in \
            self.quarantine

    # -- escalation ---------------------------------------------------------

    def rollback(self, state_dict) -> Optional[int]:
        """Restore the newest committed checkpoint into ``state_dict``
        in place (multi-host agreement inside ``restore_latest``).
        Returns the restored step, or None when no usable checkpoint
        exists (state untouched — the caller keeps skipping). The
        consecutive counter resets either way; spike statistics are
        kept (they describe healthy steps, which the restored params
        produced)."""
        if self.rollbacks >= self.config.max_rollbacks:
            raise RuntimeError(
                f"anomaly sentinel: {self.rollbacks} rollbacks without "
                "recovery — refusing to thrash (max_rollbacks="
                f"{self.config.max_rollbacks})")
        self.consecutive = 0
        step = self.manager.restore_latest(state_dict) \
            if self.manager is not None else None
        if step is None:
            return None
        self.rollbacks += 1
        _monitor.inc("train.anomaly.rollbacks",
                     doc="checkpoint restores triggered by consecutive "
                         "anomalies")
        wl = self.worst_layer
        _trace.instant("anomaly.rollback", step=step,
                       rollbacks=self.rollbacks,
                       worst_layer=wl["name"] if wl else None)
        return step

    # -- multi-host agreement -----------------------------------------------

    def _agree(self, local_anom: bool, g: float):
        """Agreement gather over the default group (the reference's
        tagged key-value gather): every rank contributes (anomalous?,
        grad_norm); any rank anomalous makes EVERY rank anomalous, and
        the max norm keeps the EMA state rank-identical, so the caps
        fed to the next step never diverge across ranks. It runs on the
        loop's thread, in step order on every rank."""
        from ..monitor import comms as _comms
        out = _comms.gather_object([None] * dist.get_world_size(),
                                   (bool(local_anom), float(g)))
        anom = any(a for a, _ in out)
        norms = [x for _, x in out if math.isfinite(x)]
        return anom, (max(norms) if norms else float("nan"))


def _sentinel_health_provider(ref):
    """``/healthz`` contributor over a weakly-held SentinelLoop: the
    escalation-ladder state an operator reads before deciding whether a
    fleet of skips is data rot or model divergence. A loop that burned
    its rollback budget reports ``ok: false`` — it is alive but cannot
    recover itself, exactly what a supervisor should replace."""
    def provide():
        loop = ref()
        if loop is None:
            return None
        sent = loop.sentinel
        return {
            "ok": sent.rollbacks < sent.config.max_rollbacks,
            "step": loop.step,
            "applied": loop.applied,
            "skipped": loop.skipped,
            "consecutive_anomalies": sent.consecutive,
            "anomalies": sent.anomalies,
            "rollbacks": sent.rollbacks,
            "max_rollbacks": sent.config.max_rollbacks,
            "quarantined": len(sent.quarantine),
            # observe-only drift visibility: the ladder never acts on
            # it, but the operator reading /healthz sees slowness next
            # to the anomaly state
            "step_time_drift": sent.step_time_drift,
            # observe-only numerics attribution: which layer's grad
            # norm dominated the latest numerics-enabled step (a
            # fleet of skips names a layer, not a scalar)
            "worst_layer": (sent.worst_layer or {}).get("name"),
            # None when non-finite: NaN would make the JSON probe
            # response unparseable for strict readers; "finite" below
            # carries the distinction
            "worst_layer_grad_norm":
                (sent.worst_layer or {}).get("grad_norm")
                if (sent.worst_layer or {}).get("finite") else None,
            "worst_layer_finite":
                (sent.worst_layer or {}).get("finite"),
            # frozen at the most recent ANOMALY: the layer that blew
            # up stays visible after healthy steps refresh the latest
            # view above
            "worst_layer_last_anomaly":
                (sent.worst_layer_at_anomaly or {}).get("name"),
        }
    return provide


class SentinelLoop:
    """Drive a GUARDED train step under an :class:`AnomalySentinel` —
    the functional-path loop the smoke/chaos harnesses and tests run.

    ``step_fn`` is a guarded step from ``make_train_step(guard=True)``
    (4-in/4-out; the port's updates ``params`` and ``opt_state`` in
    place, so a rollback's in-place load leaves the step's own tensors
    holding the checkpoint); ``make_stream`` is a ZERO-ARG factory
    returning a
    fresh deterministic batch iterator — determinism is what makes the
    post-rollback fast-forward land on exactly the unseen batches.
    Every batch passes the ``train.batch`` corrupt value point
    (``testing/faults.py``), so chaos runs can poison the stream
    without touching the loop. With a ``manager``, applied steps are
    offered to ``manager.save`` (its interval policy decides), and the
    ROLLBACK verdict restores + fast-forwards in place.

    ``dataloader=`` (any object with ``state_dict`` /
    ``set_state_dict``, an ``io.DataLoader`` in the reference) upgrades
    data positioning to EXACTLY-ONCE: the loader's own {epoch, cursor,
    RNG-seed, collator-carry} state rides every checkpoint in
    ``_state()['data']``, rollback/restore re-seats
    the loader at the exact batch boundary of the restored step (the
    loader fast-forwards indices without touching samples), and
    :meth:`restore_latest` gives a restarted worker a one-call
    resume. When set, the loop streams from ``iter(dataloader)`` and
    never applies the external step-count fast-forward (the loader owns
    its position)."""

    def __init__(self, step_fn, params, opt_state, make_stream=None, *,
                 sentinel: Optional[AnomalySentinel] = None,
                 manager=None, watchdog: Optional["HangWatchdog"] = None,
                 dataloader=None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.dataloader = dataloader
        if make_stream is None:
            if dataloader is None:
                raise ValueError(
                    "SentinelLoop needs make_stream or dataloader")
            make_stream = lambda: iter(dataloader)  # noqa: E731
        self.make_stream = make_stream
        self.manager = manager
        self.sentinel = sentinel or AnomalySentinel(manager=manager)
        if manager is not None and self.sentinel.manager is None:
            self.sentinel.manager = manager
        self.watchdog = watchdog
        self.step = 0              # batches consumed (applied or skipped)
        self.applied = 0
        self.skipped = 0
        self.last_loss: Optional[float] = None
        # Operator plane: this is a long-running-loop entrypoint, so it
        # starts the telemetry server when FLAGS_enable_monitor_server
        # is set (one cached branch otherwise) and contributes the
        # sentinel's ladder state to /healthz through a weakref (a
        # finished loop prunes itself). Unique per-loop key — two
        # loops must not evict each other's view — registered only
        # while some plane could read it (a fully-off process must not
        # grow the provider map).
        from ..monitor import server as _mserver
        _mserver.maybe_start()
        if _monitor.enabled() or _mserver.plane_active():
            # process-unique uid (GIL-atomic, monitor/programs.py):
            # two loops must not evict each other's /healthz view
            _mserver.register_health_provider(
                f"sentinel:{_monitor.programs.next_uid()}",
                _sentinel_health_provider(weakref.ref(self)))

    def _state(self) -> Dict[str, Any]:
        state = {"params": self.params, "opt": self.opt_state,
                 "step": self.step}
        if self.dataloader is not None and \
                hasattr(self.dataloader, "state_dict"):
            state["data"] = dict(self.dataloader.state_dict())
        return state

    def _state_provider(self):
        """Offer-time save provider: params/opt stay LAZY (an
        interval-skipped save must not pay a traversal) but step and
        the dataloader cursor are snapshotted NOW — the SIGTERM
        emergency save materializes the provider mid-NEXT-batch, when
        the live cursor has already advanced one past the offered
        step; a deferred read would make the resumed loader skip that
        batch (silent sample loss on exactly the preemption path).

        The provider reaches the loop through a weakref: the manager
        keeps the newest offer for that emergency save, and a strong
        reference would tie loop and manager into a cycle that holds the
        whole state until a garbage collection. A dropped loop offers
        nothing (the provider returns None)."""
        ref = weakref.ref(self)
        step = self.step
        data_fn = None
        if self.dataloader is not None:
            if hasattr(self.dataloader, "state_provider"):
                data_fn = self.dataloader.state_provider()   # O(1) pin
            elif hasattr(self.dataloader, "state_dict"):
                snap = dict(self.dataloader.state_dict())
                data_fn = lambda: snap                       # noqa: E731

        def provide():
            loop = ref()
            if loop is None:
                return None
            state = {"params": loop.params, "opt": loop.opt_state,
                     "step": step}
            if data_fn is not None:
                state["data"] = dict(data_fn())
            return state
        return provide

    def _new_stream(self):
        """A stream positioned at ``self.step``: the dataloader owns its
        own cursor (exactly-once, index-level skip); factory streams
        fast-forward by step count (the deterministic-replay
        contract)."""
        if self.dataloader is not None:
            return iter(self.dataloader)
        return fast_forward(self.make_stream(), self.step) \
            if self.step else self.make_stream()

    def _apply_restored(self, state) -> None:
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = int(state["step"])
        if self.dataloader is not None and "data" in state \
                and hasattr(self.dataloader, "set_state_dict"):
            self.dataloader.set_state_dict(state["data"])

    def restore_latest(self) -> Optional[int]:
        """One-call elastic resume for a freshly-constructed loop:
        restore the newest committed checkpoint into params/opt/step AND
        the dataloader's batch boundary. Returns the restored step (None
        = fresh start)."""
        if self.manager is None:
            return None
        state = self._state()
        step = self.manager.restore_latest(state)
        if step is not None:
            self._apply_restored(state)
        return step

    def run(self, n_steps: int) -> Dict[str, Any]:
        stream = self._new_stream()
        while self.step < n_steps:
            try:
                batch = next(stream)
            except StopIteration:
                break
            batch = _faults.corrupt("train.batch", batch)
            if self.sentinel.is_quarantined(batch):
                # consumed (stream position == step count) but never
                # shown to the model again
                self.step += 1
                self.skipped += 1
                _monitor.inc("train.anomaly.quarantine.skips",
                             doc="replayed batches skipped because "
                                 "their hash is quarantined")
                _trace.instant("anomaly.quarantine_skip", step=self.step)
                continue
            cap = self.sentinel.gnorm_cap()
            t_step = time.perf_counter()
            # StepTraceAnnotation only while an on-demand profiler
            # capture window is open (null context otherwise), so
            # device trace steps correlate with the host spans
            with _pcap.annotate_step("train.step", self.step):
                params, opt, loss, health = self.step_fn(
                    self.params, self.opt_state, batch, cap)
                if "numerics" in health and _monitor.enabled():
                    # numerics-enabled guarded step: feed the plane and
                    # refresh the sentinel's worst-layer attribution
                    # BEFORE observe(), so a SKIP/ROLLBACK instant
                    # names THIS step's layer (one host copy a leaf).
                    from ..monitor import numerics as _numerics
                    wl = _numerics.record_step_stats(
                        health["numerics"], step=self.step + 1)
                    if wl is not None:
                        self.sentinel.worst_layer = wl
                # the step's health on the host in one copy (the guard
                # already read its gate, so this waits only for the
                # update queued after it)
                finite, gnorm, loss = torch.stack([
                    torch.as_tensor(x).float().reshape(()) for x in
                    (health["finite"], health["grad_norm"], loss)]
                ).tolist()
                verdict = self.sentinel.observe(
                    finite=finite, grad_norm=gnorm, loss=loss,
                    batch=batch)
            # the health read synchronized the step: t_step -> now is a
            # device-complete wall time — the timeseries row the drift
            # detector consumes
            step_ms = (time.perf_counter() - t_step) * 1e3
            self.params, self.opt_state = params, opt
            self.step += 1
            if self.watchdog is not None:
                self.watchdog.heartbeat()
            if _monitor.enabled():
                from ..monitor import exectime as _exectime
                _timeseries.record_step(
                    step=self.step, total_ms=step_ms,
                    loss=loss if verdict == OK else None,
                    grad_norm_ema=self.sentinel.stats.mean
                    if self.sentinel.stats.n else None,
                    exec_ms=_exectime.take_last_sample_ms())
                self.sentinel.step_time_drift = \
                    _timeseries.drift_status().get("ratio")
            if verdict == OK:
                self.applied += 1
                self.last_loss = loss
                if self.manager is not None:
                    self.manager.save(self.step, self._state_provider())
            else:
                self.skipped += 1
                if verdict == ROLLBACK:
                    state = self._state()
                    restored = self.sentinel.rollback(state)
                    if restored is not None:
                        self._apply_restored(state)
                        stream = self._new_stream()
        if self.manager is not None:
            self.manager.wait()
        return {"steps": self.step, "applied": self.applied,
                "skipped": self.skipped,
                "rollbacks": self.sentinel.rollbacks,
                "quarantined": len(self.sentinel.quarantine),
                "last_loss": self.last_loss}


class HangWatchdog:
    """Detect a wedged train step and leave a usable corpse.

    A daemon thread checks the age of the last heartbeat every
    ``poll_s``; past ``deadline_s`` it (once per stall episode) dumps
    the flight record (``monitor.trace``; armed path or
    ``stall_path + '.flight.json'``), writes an all-thread stack dump
    as parseable JSON to ``stall_path``, mirrors the stacks to stderr
    via ``faulthandler``, and — with ``exit_on_stall`` — ``os._exit``s
    with ``exit_code`` so elastic/heartbeat supervision (which watches
    the PROCESS, not the python loop) restarts the worker instead of
    burning a pod on a program that will never finish its step.

    Heartbeats arrive two ways: every ``StepTimer.end_step`` anywhere
    in the process (the daemon registers a step listener), and explicit
    :meth:`heartbeat` calls from bespoke loops (``SentinelLoop`` does).
    Use as a context manager or call ``start()``/``stop()``."""

    def __init__(self, deadline_s: float, *, poll_s: Optional[float] = None,
                 stall_path: Optional[str] = None,
                 exit_on_stall: bool = False, exit_code: int = 42,
                 name: str = "train"):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(min(self.deadline_s / 4.0, 1.0), 0.02)
        self.stall_path = stall_path
        self.exit_on_stall = exit_on_stall
        self.exit_code = exit_code
        self.name = name
        self.stalls = 0
        self._last = time.monotonic()
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._provider_key: Optional[str] = None

    def start(self) -> "HangWatchdog":
        from ..monitor import server as _mserver
        from ..monitor import steptimer as _steptimer
        self._last = time.monotonic()
        _steptimer.add_step_listener(self.heartbeat)
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name=f"sentinel-watchdog-{self.name}")
        self._thread.start()
        # /healthz liveness: a blown heartbeat deadline flips the
        # operator-plane endpoint to 503 (recomputed per probe, so a
        # recovered loop reads healthy again without re-arming). The
        # key carries a process-unique id (GIL-atomic counter): two
        # watchdogs sharing a name (old loop draining while its
        # replacement starts) must not have stop() unregister the
        # SURVIVOR's provider. Bounded by live watchdogs — stop()
        # removes exactly this instance's key.
        self._provider_key = (f"watchdog:{self.name}:"
                              f"{_monitor.programs.next_uid()}")
        _mserver.register_health_provider(self._provider_key,
                                          self._health)
        return self

    def _health(self) -> dict:
        age = time.monotonic() - self._last
        return {
            "ok": age <= self.deadline_s,
            "last_heartbeat_age_s": round(age, 3),
            "deadline_s": self.deadline_s,
            "stalls": self.stalls,
        }

    def heartbeat(self):
        """The step completed; push the deadline out. Re-arms after a
        dump-only stall so a recovered loop is watched again."""
        self._last = time.monotonic()
        self._fired = False
        _monitor.inc("train.watchdog.heartbeats",
                     doc="step heartbeats fed to the hang watchdog")

    def stop(self):
        from ..monitor import server as _mserver
        from ..monitor import steptimer as _steptimer
        self._stop.set()
        _steptimer.remove_step_listener(self.heartbeat)
        if getattr(self, "_provider_key", None) is not None:
            _mserver.unregister_health_provider(self._provider_key)
            self._provider_key = None
        if self._thread is not None:
            self._thread.join(timeout=max(self.poll_s * 4, 1.0))
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- the watch thread ---------------------------------------------------

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            age = time.monotonic() - self._last
            if age > self.deadline_s and not self._fired:
                self._fired = True
                self._on_stall(age)

    def _thread_stacks(self) -> Dict[str, list]:
        names = {t.ident: t.name for t in threading.enumerate()}
        return {
            f"{names.get(tid, 'unknown')}-{tid}":
                traceback.format_stack(frame)
            for tid, frame in sys._current_frames().items()
        }

    def _on_stall(self, age: float):
        self.stalls += 1
        _monitor.inc("train.watchdog.stalls",
                     doc="heartbeat deadlines missed (wedged steps)")
        _monitor.set_gauge("train.watchdog.last_stall_age_s",
                           round(age, 3),
                           doc="heartbeat age when the last stall fired")
        _trace.instant("watchdog.stall", age_s=round(age, 3),
                       deadline_s=self.deadline_s)
        # flight record to the armed destination (or next to the stall
        # file when none is armed) — what the program was DOING before
        # it wedged
        fr_path = _trace.flight_record_path() or (
            self.stall_path + ".flight.json" if self.stall_path else None)
        try:
            _trace.dump_flight_record(fr_path, reason="watchdog.stall")
        except Exception:
            pass
        if self.stall_path:
            payload = {
                "kind": "paddle_tpu.watchdog_stall",
                "name": self.name,
                "pid": os.getpid(),
                "unix_time": round(time.time(), 3),
                "heartbeat_age_s": round(age, 3),
                "deadline_s": self.deadline_s,
                "threads": self._thread_stacks(),
            }
            try:
                d = os.path.dirname(os.path.abspath(self.stall_path))
                os.makedirs(d, exist_ok=True)
                # direct write + fsync, no tmp/rename: this is a crash
                # path — a torn file beats no file (same discipline as
                # dump_flight_record)
                with open(self.stall_path, "w") as f:
                    json.dump(payload, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass
        try:
            import faulthandler
            print(f"[sentinel] watchdog stall: no heartbeat for "
                  f"{age:.1f}s (deadline {self.deadline_s}s); thread "
                  "stacks follow", file=sys.stderr)
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            pass
        if self.exit_on_stall:
            os._exit(self.exit_code)


# -- eager-path seam ---------------------------------------------------------

def guard_eager_update(owner, loss_values, *, update: bool = True) -> bool:
    """The eager loop's guard (the reference's hapi fit loop calls it;
    an eager ``LlamaForCausalLM`` loop of the port calls it the same
    way): with ``FLAGS_enable_sentinel`` set, a
    non-finite loss SKIPS the optimizer step (gradients cleared,
    parameters untouched — the eager equivalent of the in-graph gate)
    and feeds the anomaly metrics through a per-model sentinel created
    on first use.

    Call on EVERY micro-batch, with ``update=False`` on
    gradient-accumulation micro-batches: a non-finite loss anywhere in
    the accumulation window poisons the WHOLE window (its NaN is
    already summed into the accumulated grads), so the window's update
    step is skipped even when the final micro-batch's own loss is
    finite. One anomaly verdict per window (at the update call), not
    per micro-batch. The poisoned flag deliberately survives an
    ABANDONED window (epoch end or ``num_iters`` break before the
    update call): gradients are only cleared at an update call, so the
    abandoned window's NaN stays summed in the tape — the next update,
    whenever it comes, must still skip and clear. Grad-norm spike
    detection is the functional step's (the eager tape would pay a full
    extra traversal); the eager guard is loss-finiteness only. Returns
    True when the optimizer update must be skipped; one cached-flag
    branch when the flag is off."""
    if not _FLAG.value:
        return False
    sent = getattr(owner, "_anomaly_sentinel", None)
    if sent is None:
        sent = AnomalySentinel(SentinelConfig(agree=False, name="hapi"))
        owner._anomaly_sentinel = sent
    fin = all(math.isfinite(float(v)) for v in loss_values)
    bad = None if fin else next(float(v) for v in loss_values
                                if not math.isfinite(float(v)))
    if not update:
        if not fin:
            owner._anomaly_window_poisoned = True
            _trace.instant("anomaly.window_poisoned", loss=repr(bad))
        return True
    poisoned = getattr(owner, "_anomaly_window_poisoned", False)
    owner._anomaly_window_poisoned = False
    verdict = sent.observe(finite=fin and not poisoned, grad_norm=None,
                           loss=bad)
    return verdict != OK
