"""Elastic training and serving (port of
``paddle_tpu/distributed/fleet/elastic.py``): the restart loops around
the launcher, the controller that drives a fleet of serving replicas,
and the checkpoint resume point of a training worker.

:meth:`AdaptiveElasticManager.run_serving` manages a fleet of
independent engine REPLICAS against the autoscale demand signals the
SLO plane computes (``monitor/slo.demand_model``, the payload of
``ServingEngine.autoscale_payload``). It is transport-agnostic: the
caller provides spawn / stop / signals callables (in-process engines,
subprocesses, a deployment), and the controller owns the POLICY: scale
toward the demand hint within ``[min_replicas, max_replicas]``, drain
before stopping, replace replicas whose heartbeat went stale, scale on
federated burn (``monitor/federation.py``) behind
``FLAGS_serving_fleet_burn_scaling``, and own the exactly-once
failover coordinator (``inference/failover.py``) behind
``FLAGS_serving_failover``.

A scale-in drains a replica after checkpointing its ``state_fn()``
under ``ckpt_dir`` (or ``PADDLE_ELASTIC_CKPT_DIR``) through the
checkpoint manager (``distributed/checkpoint``). The worker side
(``elastic_run_index``, ``save_state``, ``finish_saves``,
``load_state``, with the pre-commit ``latest`` + ``step<N>`` layout as
a fallback) keeps a worker's resume point under
``PADDLE_ELASTIC_CKPT_DIR``.

The training restart loops re-form a launched world
(``distributed/launch``): :meth:`ElasticManager.run` (and
``run_elastic``) relaunches a failed job up to a restart budget, at the
same size, or one worker smaller toward ``min_nproc`` once half the
budget is spent (never off ``PEER_FAILURE_RC``, an innocent rank's
exit), each relaunch exporting the next ``PADDLE_ELASTIC_RUN``;
:meth:`AdaptiveElasticManager.run_adaptive` also grows the world back
when a worker is re-admitted (a ``worker*.up`` file in
``membership_dir``, or ``readmit_after`` seconds), stopping the running
world with ``RESCALE_RC``. Workers resume from their last committed
checkpoint (``load_state``), which reshards to the new world.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from ..launch.main import PEER_FAILURE_RC, RESCALE_RC  # the protocol rcs

__all__ = ["ElasticManager", "ElasticStatus", "AdaptiveElasticManager",
           "run_elastic", "save_state", "finish_saves", "load_state",
           "elastic_run_index", "RESCALE_RC", "PEER_FAILURE_RC"]


class ElasticStatus:
    """reference: elastic/manager.py ElasticStatus enum."""
    COMPLETED = "completed"
    RESTART = "restart"
    ERROR = "error"
    EXIT = "exit"


class ElasticManager:
    """Restart policy around the launch controller: the event log
    (``events``, each ``(timestamp, status, detail)``), the restart
    budget and :meth:`run`."""

    def __init__(self, max_restarts: int = 3, min_nproc: Optional[int] = None,
                 restart_delay: float = 1.0,
                 launcher: Optional[Callable] = None):
        self.max_restarts = int(max_restarts)
        self.min_nproc = min_nproc
        self.restart_delay = restart_delay
        if launcher is None:
            from ..launch.main import launch as launcher
        self._launch = launcher
        self.restarts = 0
        self.events = []   # (timestamp, status, detail)

    def _record(self, status, detail):
        self.events.append((time.time(), status, detail))

    def run(self, script: str, script_args: Sequence[str] = (),
            nproc_per_node: int = 1, **launch_kwargs) -> int:
        """Run the job; on worker failure relaunch (same size, then
        scale-in toward min_nproc when repeated failures suggest a sick
        worker). Returns the final exit code (0 = completed). The restart
        budget is per-job: each run() starts fresh."""
        self.restarts = 0
        self.events = []
        nproc = nproc_per_node
        base_env = dict(launch_kwargs.pop("extra_env", None) or {})
        run_idx = 0
        while True:
            # export the world incarnation (like run_adaptive): the
            # death/abort markers are generation-keyed, so each
            # relaunch must advance the generation or a marker from the
            # previous incarnation (same shared heartbeat dir) would
            # instantly kill the new world
            env = dict(base_env, PADDLE_ELASTIC_RUN=str(run_idx))
            run_idx += 1
            rc = self._launch(script, script_args,
                              nproc_per_node=nproc, extra_env=env,
                              **launch_kwargs)
            if rc == 0:
                self._record(ElasticStatus.COMPLETED, {"nproc": nproc})
                return 0
            if self.restarts >= self.max_restarts:
                self._record(ElasticStatus.ERROR,
                             {"nproc": nproc, "rc": rc,
                              "reason": "restart budget exhausted"})
                return rc
            self.restarts += 1
            # PEER_FAILURE_RC means an INNOCENT rank exited because a
            # PEER died — restart the world, but never feed the
            # scale-in heuristic off the innocent rank's rc (the
            # exiting worker is not the sick one).
            peer_failure = rc == PEER_FAILURE_RC
            # scale-in after half the budget is burned (a peer that
            # stays unhealthy)
            if (not peer_failure and self.min_nproc is not None
                    and nproc > self.min_nproc
                    and self.restarts > self.max_restarts // 2):
                nproc = max(self.min_nproc, nproc - 1)
            self._record(ElasticStatus.RESTART,
                         {"nproc": nproc, "rc": rc,
                          "attempt": self.restarts,
                          "reason": "peer-failure" if peer_failure
                          else "worker-failure"})
            time.sleep(self.restart_delay)


def run_elastic(script: str, script_args: Sequence[str] = (),
                nproc_per_node: int = 1, max_restarts: int = 3,
                min_nproc: Optional[int] = None, **launch_kwargs) -> int:
    """Functional form of :meth:`ElasticManager.run`."""
    return ElasticManager(max_restarts=max_restarts,
                          min_nproc=min_nproc).run(
        script, script_args, nproc_per_node=nproc_per_node,
        **launch_kwargs)


class _BoundedSignals:
    """Control-loop isolation for ``run_serving``'s legacy ``signals``
    callable: each call runs on a daemon worker thread joined for at
    most ``timeout`` seconds. A call that blows the bound returns None
    (no payload — never fabricated) and marks the replica WEDGED:
    while its call is still outstanding, later ticks skip it instantly
    instead of stacking threads, so one frozen replica delays the
    whole fleet's tick by at most one bound, once. A late result from
    a recovered callable is kept and served on the next ask.
    ``timeout`` None/<=0 = pass-through (the pre-federation blocking
    semantics). Exceptions surface to the caller's existing
    try/except as None results."""

    def __init__(self, fn, timeout: Optional[float]):
        self._fn = fn
        self._timeout = timeout
        self._pending: dict = {}     # name -> (result box, done event)
        self._workers: dict = {}     # name -> (thread, request queue)

    def __call__(self, name, handle):
        if not self._timeout or self._timeout <= 0:
            return self._fn(name, handle)
        import queue as _queue
        import threading

        pend = self._pending.get(name)
        if pend is not None:
            box, done = pend
            if not done.is_set():
                return None          # still wedged: skip instantly
            self._pending.pop(name, None)
            return box.get("value")  # late result from a recovery
        w = self._workers.get(name)
        if w is None or not w[0].is_alive():
            # ONE persistent worker per name, created lazily and fed
            # through a queue — not a thread per call: the healthy
            # common case (every replica, every 50ms tick) must not
            # pay thread create/join churn to buy wedge protection
            # for the rare frozen callable
            req: _queue.Queue = _queue.Queue()

            def loop():
                while True:
                    item = req.get()
                    if item is None:
                        return       # retired
                    h, box_, done_ = item
                    try:
                        box_["value"] = self._fn(name, h)
                    except Exception:
                        box_["value"] = None
                    done_.set()

            th = threading.Thread(target=loop, daemon=True,
                                  name=f"signals:{name}")
            th.start()
            w = (th, req)
            self._workers[name] = w
        box: dict = {}
        done = threading.Event()
        w[1].put((handle, box, done))
        if done.wait(self._timeout):
            return box.get("value")
        self._pending[name] = (box, done)
        return None

    def discard_pending(self, name):
        """Drop an outstanding call's future result (the drain
        barrier: a payload captured before ``begin_drain`` must not
        be served inside the drain wait). The worker keeps running —
        a wedged call finishes into a box nobody reads."""
        self._pending.pop(name, None)

    def retire(self, name):
        """The name will never be asked again (its replica stopped or
        was replaced; numbering is monotonic): drop the pending box
        (it would pin the stopped replica's handle) and shut the
        worker down — the sentinel lets a wedged call finish into a
        box nobody reads, then the thread exits instead of idling for
        the rest of the run."""
        self._pending.pop(name, None)
        w = self._workers.pop(name, None)
        if w is not None:
            w[1].put(None)


class AdaptiveElasticManager(ElasticManager):
    """Elastic training with scale-IN on failure and scale-OUT on worker
    re-admission, resuming each world from the latest checkpoint, and
    the elastic serving controller (:meth:`run_serving`).

    A DOWN worker is whatever the launch
    watcher reported (crash rc or heartbeat rc=124), and re-admission is
    an announcement file in ``membership_dir`` (``worker*.up``, touched
    by the recovered host's agent) or an automatic ``readmit_after``
    backoff expiry. A membership GROWTH during a running world triggers a
    controlled stop (launch control_dir rescale flag, rc=125) and a
    relaunch at the larger size; workers resume from the latest
    checkpoint (distributed.checkpoint reshards on load, so 3→2→3-style
    world changes re-partition state automatically)."""

    def __init__(self, max_restarts: int = 10,
                 min_nproc: Optional[int] = None,
                 restart_delay: float = 0.2,
                 readmit_after: Optional[float] = None,
                 launcher: Optional[Callable] = None):
        super().__init__(max_restarts=max_restarts, min_nproc=min_nproc,
                         restart_delay=restart_delay, launcher=launcher)
        self.readmit_after = readmit_after
        self._down_times: list = []      # one entry per currently-down slot
        self._up_consumed: set = set()   # consumed worker*.up file paths

    # membership -------------------------------------------------------------
    def _capacity(self, nproc_target: int, membership_dir) -> int:
        """Current admissible world size: target minus still-down slots.
        A down slot is re-admitted by an unconsumed ``worker*.up``
        announcement or by ``readmit_after`` expiry."""
        import glob
        import os

        if membership_dir:
            # consumed announcements tracked by FILENAME, not count: a
            # consumed up-file being deleted later must not swallow a
            # different worker's future announcement
            ups = sorted(glob.glob(os.path.join(membership_dir,
                                                "worker*.up")))
            for u in ups:
                if u in self._up_consumed or not self._down_times:
                    continue
                self._down_times.pop(0)
                self._up_consumed.add(u)
        if self.readmit_after is not None:
            now = time.time()
            self._down_times = [t for t in self._down_times
                                if now - t < self.readmit_after]
        return max(1, nproc_target - len(self._down_times))

    def run_adaptive(self, script: str, script_args: Sequence[str] = (),
                     nproc_per_node: int = 1,
                     membership_dir: Optional[str] = None,
                     ckpt_dir: Optional[str] = None,
                     poll_interval: float = 0.5,
                     **launch_kwargs) -> int:
        """Run the job with world-size adaptation. Returns 0 when a world
        completes, else the last failure rc once the restart budget is
        exhausted. ``ckpt_dir`` is exported as PADDLE_ELASTIC_CKPT_DIR
        for the load_state/save_state worker helpers."""
        import os
        import tempfile
        import threading

        self.restarts = 0
        self.events = []
        self._down_times = []
        # baseline pre-existing announcements: an up-file left over from
        # a previous job must not instantly re-admit this job's first
        # crash
        self._up_consumed = set()
        if membership_dir:
            import glob
            self._up_consumed = set(glob.glob(
                os.path.join(membership_dir, "worker*.up")))
        ctl = tempfile.mkdtemp(prefix="paddle_elastic_ctl_")
        extra_env = dict(launch_kwargs.pop("extra_env", None) or {})
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            extra_env["PADDLE_ELASTIC_CKPT_DIR"] = ckpt_dir
        import shutil
        try:
            run_idx = 0
            rc = 0
            while True:
                np_now = self._capacity(nproc_per_node, membership_dir)
                if self.min_nproc is not None and np_now < self.min_nproc:
                    self._record(ElasticStatus.ERROR,
                                 {"reason": "below min_nproc",
                                  "capacity": np_now})
                    return rc or 1
                flag = os.path.join(ctl, "rescale")
                if os.path.exists(flag):
                    os.remove(flag)
                stop_watch = threading.Event()

                def watch_membership(np_running=np_now):
                    while not stop_watch.is_set():
                        if self._capacity(nproc_per_node,
                                          membership_dir) > np_running:
                            try:
                                with open(flag, "w"):
                                    pass
                                return
                            except OSError as e:
                                # the re-admission was already consumed by
                                # _capacity — keep retrying the flag write,
                                # or the scale-out is silently lost
                                import sys
                                print(f"[elastic] rescale flag write failed "
                                      f"({e}); retrying", file=sys.stderr)
                        stop_watch.wait(poll_interval)

                watcher = None
                if np_now < nproc_per_node and (membership_dir
                                                or self.readmit_after):
                    watcher = threading.Thread(target=watch_membership,
                                               daemon=True)
                    watcher.start()
                env = dict(extra_env, PADDLE_ELASTIC_RUN=str(run_idx))
                kw = dict(launch_kwargs)
                if kw.get("log_dir"):
                    # one dir per world incarnation — a relaunch must not
                    # overwrite the previous world's workerlogs
                    kw["log_dir"] = os.path.join(kw["log_dir"],
                                                 f"run{run_idx}")
                try:
                    rc = self._launch(script, script_args,
                                      nproc_per_node=np_now,
                                      extra_env=env, control_dir=ctl,
                                      **kw)
                finally:
                    stop_watch.set()
                    if watcher:
                        watcher.join(timeout=5)
                run_idx += 1
                if rc == 0:
                    self._record(ElasticStatus.COMPLETED, {"nproc": np_now})
                    return 0
                if rc == RESCALE_RC and os.path.exists(flag):
                    # controlled stop for scale-out (confirmed by OUR flag —
                    # a worker exiting 125 on its own is a failure, not a
                    # rescale): no budget burn
                    self._record(ElasticStatus.RESTART,
                                 {"nproc": np_now, "reason": "scale-out"})
                    continue
                if self.restarts >= self.max_restarts:
                    self._record(ElasticStatus.ERROR,
                                 {"nproc": np_now, "rc": rc,
                                  "reason": "restart budget exhausted"})
                    return rc
                self.restarts += 1
                if rc != PEER_FAILURE_RC:
                    self._down_times.append(time.time())
                # else an INNOCENT rank exited first: marking a slot down
                # off its rc would permanently shrink the next world (no
                # up-file will ever re-admit a worker that was never
                # sick); restart full-size
                self._record(ElasticStatus.RESTART,
                             {"nproc": np_now, "rc": rc,
                              "attempt": self.restarts,
                              "reason": "peer-failure"
                              if rc == PEER_FAILURE_RC
                              else "worker-failure"})
                time.sleep(self.restart_delay)
        finally:
            # the control tempdir (rescale flag) must not leak
            # across run_adaptive calls
            shutil.rmtree(ctl, ignore_errors=True)

    # -- serving-replica elasticity ------------------------------------------
    #
    # Training elasticity re-forms a WORLD between launches; serving
    # elasticity manages a fleet of independent engine REPLICAS against the
    # autoscale demand signals the SLO plane computes
    # (monitor/slo.demand_model — the same payload /slo serves as
    # serving.autoscale.*). Transport-agnostic: the caller provides
    # spawn/stop/signals callables (a deployment, subprocesses, or
    # in-process engines in tests); the controller owns the POLICY — scale
    # toward the demand hint within [min, max], drain before stopping, and
    # replace heartbeat-stale replicas.

    def _drain_and_stop(self, name, handle, *, signals, drain, stop,
                        drain_timeout: float, poll_interval: float,
                        state_fn=None, ckpt_dir=None,
                        checkpoint: bool = True,
                        discard_stale_signals: bool = True,
                        stop_event=None, view=None) -> bool:
        """The scale-in path, in the order that keeps it crash-safe:
        (1) checkpoint the replica's ``state_fn()`` under ``ckpt_dir``
        (or ``PADDLE_ELASTIC_CKPT_DIR``) through the checkpoint manager
        (atomic commit: a kill anywhere after this leaves only committed
        state; ``checkpoint=False`` on a RETRY of the same victim, so a
        repeatedly-timing-out drain does not re-save identical state
        every tick), (2) tell the replica to stop admitting
        (``drain``, default ``handle.begin_drain()``, idempotent: new
        submissions shed with retry hints), (3) WAIT until its signals
        report ``drain_safe`` (no queued, no resident requests — live
        work finishes, never dropped), (4) stop it. Returns False on
        drain timeout — or when ``stop_event`` fires, so a controller
        shutdown never hangs behind a long decode — WITHOUT stopping:
        a replica is stopped only when ``drain_safe``; the caller
        retries on a later tick."""
        import os

        from ...testing import faults as _faults

        root = ckpt_dir or os.environ.get("PADDLE_ELASTIC_CKPT_DIR")
        if checkpoint and state_fn is not None and root:
            _faults.hit("drain.checkpoint")
            mgr = _manager_for(root)
            step = (mgr.latest_step() or 0) + 1
            mgr.save(step, dict(state_fn()), blocking=True)
        drain(name, handle)
        if discard_stale_signals and hasattr(signals,
                                             "discard_pending"):
            # a signals() call that wedged BEFORE the drain could
            # complete late with a pre-drain "idle" payload — its
            # drain_safe must never authorize this stop. ONCE, when
            # the drain first commits (the checkpoint=False retry
            # discipline): re-discarding on every retry tick would
            # re-spawn a bounded worker per tick for a wedged
            # callable and re-block the loop by the full bound each
            # time — the exact stall _BoundedSignals exists to
            # prevent.
            signals.discard_pending(name)
        deadline = time.monotonic() + drain_timeout
        while True:
            sig = None
            if view is not None:
                # federation first: a fresh frame's autoscale payload
                # answers drain_safe without touching the (possibly
                # wedged, possibly remote) signals callable. Only a
                # frame that already REFLECTS the drain counts — a
                # pre-drain frame still inside the staleness window
                # reports the idle state from before admission and
                # must not authorize the stop (begin_drain
                # force-publishes, so the draining frame arrives as
                # fast as the transport can carry it).
                view.poll([name])
                frame = view.fresh_frames([name]).get(name)
                if frame is not None and frame.get("draining"):
                    sig = frame.get("autoscale")
                    if not isinstance(sig, dict):
                        sig = None   # remote input: fall through
            if sig is None:
                try:
                    sig = signals(name, handle)
                except Exception:
                    sig = None
            if sig and sig.get("drain_safe"):
                break
            if time.monotonic() >= deadline:
                return False
            if stop_event is not None and stop_event.is_set():
                return False
            time.sleep(poll_interval)
        _faults.hit("drain.stop")
        stop(name, handle)
        return True

    def run_serving(self, spawn, stop, *, signals=None, drain=None,
                    min_replicas: int = 1, max_replicas: int = 4,
                    poll_interval: float = 0.05,
                    drain_timeout: float = 60.0,
                    heartbeat_dir: Optional[str] = None,
                    heartbeat_timeout: float = 0.0,
                    state_fn=None, ckpt_dir: Optional[str] = None,
                    max_ticks: Optional[int] = None,
                    stop_event=None, federation=None,
                    fleet_burn_scaling: Optional[bool] = None,
                    failover: Optional[bool] = None,
                    signal_timeout: Optional[float] = 5.0,
                    on_tick=None) -> dict:
        """Drive a serving-replica fleet against the autoscale signals.

        ``spawn(name) -> handle`` creates a replica; ``stop(name,
        handle)`` terminates one; ``signals(name, handle) -> dict``
        returns its demand payload (default:
        ``handle.autoscale_payload()`` — the engine's own
        ``monitor/slo.demand_model`` view); ``drain(name, handle)``
        begins its drain (default ``handle.begin_drain()``).

        Each tick: (1) heartbeat-stale replicas (``heartbeat_dir`` +
        ``heartbeat_timeout``, via ``heartbeat.stale_names``) are
        force-stopped and replaced — a wedged replica cannot execute a
        drain protocol, so it burns a unit of the restart budget
        instead; (2) fleet demand = sum of per-replica
        ``demand_estimate``, and the fleet scales toward
        ``ceil(demand)`` clamped to [min_replicas, max_replicas] —
        scale-out spawns immediately, scale-in retires the NEWEST
        replica (oldest keep their warm compile caches) through
        :meth:`_drain_and_stop`, at most one per tick, and ONLY once
        its ``drain_safe`` signal holds. A drain is COMMITTED: once
        ``begin_drain`` ran, the replica sheds all new work (the
        engine has no un-drain), so it stops counting toward
        effective capacity — a demand rise mid-drain spawns a
        replacement instead of stranding a shedding replica in the
        fleet — and the controller keeps retrying its drain (without
        re-checkpointing) until it completes. Returns a summary once
        ``max_ticks`` elapse or ``stop_event`` is set; the event log
        rides ``self.events`` like the training paths.

        Fleet SLO federation (``monitor/federation.py``):
        ``federation`` is a ``FleetSLOView`` over the replicas'
        published telemetry frames — with one, each tick reads frames
        NON-BLOCKING and the ``signals`` callable is only a fallback
        for replicas with no fresh frame. ``fleet_burn_scaling``
        (default ``FLAGS_serving_fleet_burn_scaling``, OFF — flags-off
        decisions byte-identical) arms burn-aware actuation: a
        federated latency-objective fast-burn adds one replica of
        scale-out pressure even at flat demand, and scale-in is
        REFUSED while the fleet burn alerts (latency objectives only —
        the shed-on-burn ``load_only`` lesson: availability-fed
        triggers self-lock; already-committed drains keep retrying).
        With the flag on and no view passed, one is built over
        ``heartbeat_dir``. ``signal_timeout`` bounds every USER-PASSED
        ``signals`` call on a worker thread (None/<=0 = unbounded):
        one frozen replica's callable delays a tick by at most the
        bound ONCE — while its call is still outstanding the replica
        is skipped (payload None), so heartbeat checks and scale-out
        for the rest of the fleet keep running. The built-in default
        (a direct in-process ``handle.autoscale_payload()`` read)
        stays inline — it cannot wedge on a transport, and bounding
        it would cost a thread per replica per tick. Beat hygiene:
        stopping or replacing a replica sweeps its name-keyed beat
        file and frame (``heartbeat.remove_named``), and spawning one
        sweeps any leftover from a PRIOR controller incarnation (a
        higher-seq dead frame would otherwise outrank the fresh
        replica's), so a long-lived controller dir does not
        accumulate dead replicas' files.

        Exactly-once failover (``inference/failover.py``): with
        ``failover`` on (default ``FLAGS_serving_failover``, OFF —
        flags-off decisions byte-identical), the controller owns a
        :class:`~paddle_tpu_torch.inference.failover.FailoverCoordinator`
        (exposed as ``self.failover_coordinator`` and registered for
        the ``/fleet/serving`` failover block). When a stale replica
        is force-replaced, the coordinator consumes its admission
        journal — completion markers dedup work that finished just
        before the crash — and queues the stranded remainder for
        re-dispatch; the caller's pump (``on_tick``) drains
        ``coordinator.due()`` through normal admission on survivors.
        Spawning and retiring a replica sweeps its journal alongside
        its beat/frame (same hygiene contract).

        ``on_tick(ticks, replicas)`` is an optional in-process hook
        called at the top of every tick on the controller thread —
        the loadgen trace-replay pump rides it to submit work and
        step in-process engines in lockstep with the controller's
        spawn/stop decisions. Exceptions are recorded as events,
        never fatal."""
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]")
        from .. import heartbeat as _heartbeat

        default_signals = signals is None
        if signals is None:
            def signals(name, h):
                return h.autoscale_payload() \
                    if hasattr(h, "autoscale_payload") else None
        if drain is None:
            def drain(name, h):
                if hasattr(h, "begin_drain"):
                    h.begin_drain()
        # the built-in default is a direct in-process attribute read —
        # it cannot wedge on a remote transport, and bounding it would
        # spawn a worker thread per replica per tick on the 50ms
        # control loop for nothing; pass-through keeps the pre-bound
        # inline semantics (discard_pending stays a no-op)
        signals = _BoundedSignals(
            signals, None if default_signals else signal_timeout)
        from ...core import flags as _cflags
        burn_scaling = bool(
            _cflags.flag_value("serving_fleet_burn_scaling")
            if fleet_burn_scaling is None else fleet_burn_scaling)
        failover_on = bool(
            _cflags.flag_value("serving_failover")
            if failover is None else failover)
        coord = None
        _fo = None
        if failover_on:
            from ...inference import failover as _fo
            coord = _fo.FailoverCoordinator(heartbeat_dir=heartbeat_dir)
            self.failover_coordinator = coord
            _fo.set_active_coordinator(coord)
        view = federation
        if view is None and burn_scaling and heartbeat_dir:
            from ...monitor import federation as _fed
            view = _fed.FleetSLOView(heartbeat_dir)
        if view is not None:
            from ...monitor import federation as _fed
            _fed.set_active_view(view)
        # burn-actuation edge trackers (events record transitions, not
        # every tick)
        self._burn_pressure_on = False
        self._burn_refused_on = False
        self.restarts = 0
        self.events = []
        if burn_scaling and view is None:
            # the flag promises burn-aware actuation, but with no
            # federation view and no heartbeat_dir to build one over
            # there is no telemetry to act on — burn_alert stays False
            # forever and decisions degrade to demand-only scaling.
            # Record the misconfiguration ONCE instead of silently
            # behaving as if the flag were off.
            self._record(ElasticStatus.RESTART,
                         {"reason": "burn-scaling-no-telemetry",
                          "detail": "FLAGS_serving_fleet_burn_scaling "
                                    "is on but no federation view was "
                                    "passed and no heartbeat_dir is "
                                    "set — burn-aware scale-out/"
                                    "scale-in refusal cannot engage"})
        replicas: dict = {}
        spawn_times: dict = {}
        next_idx = [0]

        def _spawn(reason):
            name = f"replica{next_idx[0]}"
            next_idx[0] += 1
            _sweep_name(name)
            replicas[name] = spawn(name)
            spawn_times[name] = time.time()
            self._record(ElasticStatus.RESTART,
                         {"reason": reason, "replica": name,
                          "replicas": len(replicas)})
            return name

        def _sweep_name(name):
            # transport-only name sweep: the global beat file + KV
            # frame, and the view's OWN transport (a custom client /
            # KV-only fleet the global-client remove_named cannot
            # reach). At spawn time (numbering restarts at replica0
            # every run) this clears a prior incarnation's leftover
            # payload — its HIGHER seq would keep winning read_named's
            # tiebreak, stamped fresh for one staleness window, then
            # masking the live replica's frames until its seq caught
            # up. In-memory view tracking is deliberately untouched
            # here (in-process frame seeding for a name about to
            # spawn is a supported pattern).
            if heartbeat_dir:
                _heartbeat.remove_named(heartbeat_dir, name)
            if coord is not None:
                # same leftover-payload hazard for the admission
                # journal: a prior incarnation's higher-seq journal
                # would win read_named's tiebreak and re-dispatch a
                # dead fleet's requests into this one
                _fo.sweep_journal(name, dir_path=heartbeat_dir)
            if view is not None:
                view.sweep(name)

        def _gc_replica(name):
            # beat-file + frame GC for a name that will NEVER be
            # asked again (stopped or replaced; numbering is
            # monotonic). One edit-wide contract for both retirement
            # paths: the global transport, the view's OWN transport
            # (custom client / KV-only fleets the global-client
            # remove_named cannot reach) + its tracking, and the
            # bounded-signals worker (a wedged call's pending box
            # would pin the stopped replica's handle; its worker
            # thread would idle for the rest of the run)
            _sweep_name(name)
            if view is not None:
                view.forget(name)
            signals.retire(name)

        for _ in range(min_replicas):
            _spawn("spawn")
        ticks = 0
        draining: set = set()    # committed drains: shedding, excluded
        #                          from effective capacity, retried
        ckpted: set = set()      # victims whose pre-drain checkpoint
        #                          already committed (never re-saved)
        drain_deadline: dict = {}   # name -> [cross-tick deadline,
        #                             timeout-event-recorded flag]
        while True:
            if stop_event is not None and stop_event.is_set():
                self._record(ElasticStatus.EXIT, {"reason": "stopped"})
                break
            if max_ticks is not None and ticks >= max_ticks:
                self._record(ElasticStatus.EXIT,
                             {"reason": "max_ticks", "ticks": ticks})
                break
            ticks += 1
            if on_tick is not None:
                # in-process pump hook (the loadgen replay driver):
                # runs ON the controller thread, ordered with this
                # tick's stale handling and scaling decisions — the
                # caller submits work / steps in-process engines here
                # without feeder-thread races. A raising hook is a
                # caller bug: recorded, never fatal to the fleet.
                try:
                    on_tick(ticks, dict(replicas))
                except Exception as e:
                    self._record(ElasticStatus.ERROR,
                                 {"reason": "on-tick-error",
                                  "detail": repr(e)[:300]})
            if heartbeat_dir and heartbeat_timeout > 0:
                stale = _heartbeat.stale_names(
                    heartbeat_dir, list(replicas), heartbeat_timeout,
                    started_at=spawn_times)
                for name, why in stale.items():
                    # a wedged replica cannot drain — force-stop and
                    # replace, burning a unit of the restart budget
                    handle = replicas.pop(name)
                    spawn_times.pop(name, None)
                    draining.discard(name)
                    ckpted.discard(name)
                    drain_deadline.pop(name, None)
                    self._record(ElasticStatus.RESTART,
                                 {"reason": "stale-replace",
                                  "replica": name, "detail": why})
                    try:
                        stop(name, handle)
                    except Exception as e:
                        self._record(ElasticStatus.ERROR,
                                     {"reason": "stale-stop-failed",
                                      "replica": name,
                                      "detail": repr(e)})
                    if coord is not None:
                        # consume the dead replica's admission journal
                        # BEFORE the GC sweeps it: completion markers
                        # dedup, poison requests quarantine, the rest
                        # queue for re-dispatch on survivors
                        stranded = coord.note_replaced(name)
                        if stranded:
                            self._record(
                                ElasticStatus.RESTART,
                                {"reason": "failover-strand",
                                 "replica": name,
                                 "stranded": stranded})
                    # GC AFTER the stop: a stale-but-recovering
                    # replica could otherwise republish between
                    # sweep and stop, resurrecting an orphan file
                    # for a name no longer tracked
                    _gc_replica(name)
                    self.restarts += 1
                    # >= : same budget semantics as the training paths
                    # (max_restarts replacements total, not N+1)
                    if self.restarts >= self.max_restarts:
                        self._record(
                            ElasticStatus.ERROR,
                            {"reason": "restart budget exhausted"})
                        return {"replicas": list(replicas),
                                "ticks": ticks, "events": self.events}
            fed_fresh = {}
            burn_alert = False
            if view is not None:
                # NON-BLOCKING telemetry: published frames answer for
                # every replica with a fresh one; the signals callable
                # is only the fallback below
                try:
                    view.poll(list(replicas))
                    fed_fresh = view.fresh_frames(list(replicas))
                    if burn_scaling:
                        rep = view.fleet_report(list(replicas),
                                                poll=False)
                        burn_alert = bool(rep["alerting_load"])
                except Exception:
                    fed_fresh = {}
            payloads = {}
            for name, h in list(replicas.items()):
                frame = fed_fresh.get(name)
                if frame is not None:
                    # frame sub-blocks are remote input: a truthy
                    # non-dict autoscale must contribute nothing, not
                    # crash the tick
                    p = frame.get("autoscale")
                    if not isinstance(p, dict):
                        p = None
                else:
                    try:
                        p = signals(name, h)
                    except Exception:
                        p = None
                if p:
                    payloads[name] = p
            if payloads:
                import math as _math
                # frame payloads are remote input: a malformed
                # demand_estimate (a string, NaN) from one replica
                # contributes nothing — it must not crash the fold or
                # poison the fleet sum
                demand = 0.0
                for p in payloads.values():
                    try:
                        d = float(p.get("demand_estimate", 0.0))
                    except (TypeError, ValueError):
                        continue
                    if _math.isfinite(d):
                        demand += d
                desired = max(int(_math.ceil(demand - 1e-9)), 0)
            else:
                # no signals: hold effective capacity steady
                desired = len(replicas) - len(draining)
            desired = min(max(desired, min_replicas), max_replicas)
            if burn_scaling and burn_alert:
                # fleet latency fast-burn = the current capacity is
                # not meeting the SLO even when demand looks flat: one
                # replica of scale-out pressure over the demand-based
                # target (stable while the burn persists — pressure is
                # +1 over demand, not +1 over capacity per tick, so it
                # cannot escalate to max_replicas on its own)
                desired = min(desired + 1, max_replicas)
                if not self._burn_pressure_on:
                    self._burn_pressure_on = True
                    self._record(ElasticStatus.RESTART,
                                 {"reason": "burn-pressure",
                                  "desired": desired})
            else:
                # burn cleared (or scaling off): re-arm the
                # once-per-episode transition events
                self._burn_pressure_on = False
                self._burn_refused_on = False
            # effective capacity excludes committed drains: a replica
            # that began draining sheds every submission, so demand
            # growth mid-drain spawns a replacement instead of
            # counting a shedding replica as capacity. The TOTAL fleet
            # (draining included) still honors max_replicas — on infra
            # provisioned for exactly that many, the replacement waits
            # for the drain to land rather than oversubscribing.
            while (len(replicas) - len(draining) < desired
                   and len(replicas) < max_replicas):
                _spawn("scale-out")
            target = None
            if draining:
                # resume a committed drain first (no re-checkpoint)
                target = next(n for n in replicas if n in draining)
            elif len(replicas) - len(draining) > desired:
                if burn_scaling and burn_alert:
                    # scale-in REFUSED while the fleet burn alerts:
                    # shrinking a fleet that is failing its latency
                    # SLO digs the hole deeper. Latency objectives
                    # only (load_only above) — the refusal itself can
                    # never feed the trigger that caused it.
                    if not self._burn_refused_on:
                        self._burn_refused_on = True
                        self._record(ElasticStatus.RESTART,
                                     {"reason": "burn-scale-in-refused",
                                      "desired": desired})
                else:
                    # (the burn-cleared else above already re-armed
                    # the refused-episode tracker this tick)
                    target = next(n for n in reversed(list(replicas))
                                  if n not in draining)  # newest first
            if target is not None:
                if target not in draining:
                    draining.add(target)
                    drain_deadline[target] = [
                        time.monotonic() + drain_timeout, False]
                # the in-tick wait is BOUNDED (~one poll interval):
                # the drain itself persists across ticks via the sets
                # above, so a slow drain never suspends heartbeat
                # checks, demand gathering, or scale-out for the rest
                # of the fleet; drain_timeout is accounted against the
                # cross-tick deadline instead
                ok = self._drain_and_stop(
                    target, replicas[target], signals=signals,
                    drain=drain, stop=stop,
                    drain_timeout=poll_interval,
                    poll_interval=poll_interval, state_fn=state_fn,
                    ckpt_dir=ckpt_dir,
                    checkpoint=target not in ckpted,
                    discard_stale_signals=target not in ckpted,
                    stop_event=stop_event, view=view)
                ckpted.add(target)
                if ok:
                    replicas.pop(target)
                    spawn_times.pop(target, None)
                    draining.discard(target)
                    ckpted.discard(target)
                    drain_deadline.pop(target, None)
                    _gc_replica(target)
                    self._record(ElasticStatus.RESTART,
                                 {"reason": "scale-in",
                                  "replica": target,
                                  "replicas": len(replicas)})
                else:
                    dl = drain_deadline.get(target)
                    if dl and not dl[1] and time.monotonic() >= dl[0]:
                        # cross-tick drain_timeout spent: record the
                        # transition ONCE (informational — the drain
                        # stays committed and keeps retrying)
                        dl[1] = True
                        self._record(ElasticStatus.RESTART,
                                     {"reason": "drain-timeout",
                                      "replica": target})
            if stop_event is not None:
                stop_event.wait(poll_interval)
            else:
                time.sleep(poll_interval)
        out = {"replicas": list(replicas), "ticks": ticks,
               "events": self.events}
        if coord is not None:
            out["failover"] = coord.snapshot()
        return out


# -- worker-side elastic state (resume across world re-forms) ----------------

def elastic_run_index() -> int:
    """Which world incarnation this process belongs to (0 = first)."""
    import os
    return int(os.environ.get("PADDLE_ELASTIC_RUN", "0"))


# One CheckpointManager per checkpoint root (workers call save_state /
# load_state with only the env var set; the manager carries the commit
# protocol, retention, discovery, and the SIGTERM finalize hook).
_MANAGERS: dict = {}


def _manager_for(root: str):
    import os

    mgr = _MANAGERS.get(root)
    if mgr is None:
        from ..checkpoint import CheckpointManager

        mgr = CheckpointManager(
            root,
            keep_last_n=int(os.environ.get("PADDLE_ELASTIC_KEEP_CKPTS",
                                           "2")),
            async_save=True)
        # preemption (a supervisor's SIGTERM): finalize the
        # in-flight save — or take an emergency sync save — before
        # dying, so the restarted world resumes from the step the
        # worker was actually on
        mgr.install_preemption_hook()
        _MANAGERS[root] = mgr
    return mgr


def save_state(step: int, state_dict, blocking: bool = False,
               prev_handle=None):
    """Checkpoint one training step for elastic resume via the
    CheckpointManager: atomic commit (a kill mid-write can never be
    resumed from), async by default (snapshot now, write in background,
    shard-aware, reshards on load at a different world size), keep-last-N
    retention. The manager itself finalizes the previous save before
    staging the next (a 1-deep pipeline: step N's save overlaps step
    N+1's compute), so ``prev_handle`` is accepted only for backward
    compatibility and ignored.

    Returns the per-root manager (or None when blocking or no
    PADDLE_ELASTIC_CKPT_DIR is set); pass whatever was returned to
    ``finish_saves`` once after the loop to join the final save."""
    import os

    root = os.environ.get("PADDLE_ELASTIC_CKPT_DIR")
    if not root:
        return None
    mgr = _manager_for(root)
    mgr.save(step, dict(state_dict), blocking=blocking)
    return None if blocking else mgr


def finish_saves(pending) -> bool:
    """Finalize an in-flight elastic save (join + retention GC)."""
    if pending is None:
        return False
    pending.wait()
    return True


def load_state(template_state_dict):
    """Resume point for an elastic worker: (start_step, state). Loads the
    newest COMMITTED checkpoint into ``template_state_dict`` (sharded
    values reshard to the CURRENT world's placements), skipping
    incomplete or corrupt directories, or returns (0, template) on a
    fresh start. Falls back to a pre-commit-protocol layout (``latest``
    pointer + ``step<N>`` dirs) so jobs upgraded mid-flight keep their
    resume point."""
    import os

    root = os.environ.get("PADDLE_ELASTIC_CKPT_DIR")
    if not root or not os.path.isdir(root):
        return 0, template_state_dict
    mgr = _manager_for(root)
    full = dict(template_state_dict)
    step = mgr.restore_latest(full)
    if step is None:
        legacy = _load_legacy_state(root, template_state_dict)
        if legacy is not None:
            return legacy
        return 0, template_state_dict
    return step, full


def _load_legacy_state(root, template_state_dict):
    """Resume from a checkpoint dir written before the commit protocol:
    the old rank-0 ``latest`` pointer named the ``step<N>`` dir (no
    underscore, no COMMIT/manifest). Best-effort — any failure means a
    fresh start, as before."""
    import os

    latest = os.path.join(root, "latest")
    if not os.path.isfile(latest):
        return None
    from .. import checkpoint as dckpt

    try:
        step = int(open(latest).read().strip())
        full = dict(template_state_dict)
        dckpt.load_state_dict(full, os.path.join(root, f"step{step}"),
                              verify=False)
        return step, full
    except Exception as e:
        import sys
        print(f"[elastic] legacy checkpoint at {root!r} unusable "
              f"({type(e).__name__}: {e}); starting fresh", file=sys.stderr)
        return None
