"""CheckpointManager: retention, discovery, auto-resume, preemption (port
of ``paddle_tpu/distributed/checkpoint/manager.py``).

Reference capability: the fleet elastic stack's checkpoint lifecycle
(python/paddle/distributed/fleet/elastic — restarts are normal
operation, so the checkpoint subsystem must make them cheap) realized
with the discipline of Orbax's CheckpointManager: every save commits
atomically (see this package's commit protocol), retention never
deletes the newest committed step, and discovery trusts only COMMIT
markers — a crashed save's staging dir is garbage to be collected, not
a resume candidate.

Layout: one directory per step under ``root``::

    root/
      step_40/   (committed: COMMIT + checkpoint.manifest + shards)
      step_50/
      step_60.tmp.12345.3/   (in-flight or crashed save — ignored)

``save(step, state)`` applies the save-interval policy, runs sync or
async (via :func:`async_save_state_dict`), and garbage-collects old
steps after each commit. ``restore_latest(state)`` walks committed
steps newest-first, verifies the manifest, and falls back to the
previous committed step when verification fails (counting
``ckpt.restore.fallbacks``). ``install_preemption_hook`` finalizes an
in-flight async save — or takes an emergency sync save of the newest
state it has seen — before the process dies to SIGTERM, which is what
lets a preempted worker resume from the step it was on rather than the
last scheduled save.

Where the port differs: :meth:`restore_latest` first finalizes an async
save in flight, so a restore (a sentinel rollback among them) lands on
the newest step handed to :meth:`save`, where the reference takes
whatever had committed at that instant. Several ranks agree on the step
to restore through ``all_gather_object`` on the checkpoint's own gloo
group (``checkpoint._ckpt_group``), where the reference rides tagged
key-value gathers.
"""
from __future__ import annotations

import os
import re
import shutil
import signal
import threading
import time
from typing import Dict, List, Optional

from ... import monitor as _monitor
from . import _ckpt_group, _gather, _world

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")
# step_40.tmp.123.4 / step_40.old.123.4 — commit-protocol debris
_DEBRIS_RE = re.compile(r"^step_\d+\.(tmp|old)\.")
_OLD_RE = re.compile(r"^(step_\d+)\.old\.")


def _newest_mtime(d: str) -> float:
    t = os.path.getmtime(d)
    try:
        names = os.listdir(d)
    except OSError:
        return t
    for n in names:
        try:
            t = max(t, os.path.getmtime(os.path.join(d, n)))
        except OSError:
            pass
    return t


class CheckpointManager:
    """Fault-tolerant checkpoint lifecycle over one root directory.

    Parameters
    ----------
    root: directory holding one ``step_<N>`` subdir per checkpoint.
    keep_last_n: committed checkpoints retained; older ones are deleted
        after each successful save (the newest committed step is never
        deleted, whatever the setting).
    save_interval_steps: ``save(step)`` is a no-op unless
        ``step % save_interval_steps == 0`` (or ``force=True``).
    async_save: stage device->host now, write+commit on a background
        thread; the next ``save()``/``wait()`` finalizes the previous
        one first, so at most one save is in flight.
    coordinator_rank: the process that renames/commits/GCs.
    """

    def __init__(self, root: str, keep_last_n: int = 3,
                 save_interval_steps: int = 1, async_save: bool = False,
                 coordinator_rank: int = 0):
        if keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1, got "
                             f"{save_interval_steps}")
        self.root = os.path.normpath(root)
        self.keep_last_n = keep_last_n
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self.coordinator_rank = coordinator_rank
        os.makedirs(self.root, exist_ok=True)
        self._mu = threading.RLock()
        self._gc_mu = threading.Lock()   # serializes gc() runs
        self._pending = None          # (step, AsyncSaveHandle)
        # newest state handed to save(), committed or not: the
        # preemption hook's emergency-save source
        self._last_seen: Optional[tuple] = None   # (step, state_dict)
        self._prev_handlers: dict = {}
        if _world()[1] == self.coordinator_rank:
            self._recover_graveyards()

    # -- discovery ----------------------------------------------------------

    def _step_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def all_steps(self) -> List[int]:
        """Committed steps, ascending. Uncommitted/staging dirs are
        skipped — a crashed save is invisible here."""
        from . import is_committed
        steps = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        for name in names:
            m = _STEP_RE.match(name)
            if m and is_committed(os.path.join(self.root, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """Newest committed step, or None on a fresh start."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0

    def save(self, step: int, state_dict, force: bool = False,
             blocking: Optional[bool] = None) -> bool:
        """Checkpoint ``state_dict`` as ``step``. Returns False when the
        save-interval policy skips the step (the state — or provider —
        is still remembered for an emergency preemption save).
        ``state_dict`` may be a zero-arg callable returning the state:
        it is only materialized when a save actually happens, so
        callers on the per-batch hot path don't pay a full
        state-dict/optimizer traversal for interval-skipped steps.
        ``blocking`` overrides the manager's async default for this
        call."""
        with self._mu:
            self._last_seen = (step, state_dict)
            if not force and not self.should_save(step):
                return False
            if callable(state_dict):
                state_dict = state_dict()
            # one save in flight: finalize the previous before staging
            # the next. The training thread's time in here — staging,
            # sync writes, finalizing the previous async save — bills
            # to the active StepTimer's checkpoint phase (and the
            # train.step.checkpoint_ms histogram) so step-timeline
            # accounting sees checkpoint stalls without the loop
            # threading its timer into this manager.
            with _monitor.ambient_phase("checkpoint"):
                self._finalize_pending_locked()
                sync = not self.async_save if blocking is None \
                    else blocking
                if sync:
                    from . import save_state_dict
                    save_state_dict(state_dict, self._step_path(step),
                                    coordinator_rank=self.coordinator_rank)
                    self._after_commit_locked(step)
                else:
                    from . import async_save_state_dict
                    handle = async_save_state_dict(
                        state_dict, self._step_path(step),
                        coordinator_rank=self.coordinator_rank)
                    self._pending = (step, handle)
            return True

    def wait(self):
        """Finalize any in-flight async save (join + retention GC).
        Re-raises a writer error. Returns only after retention is
        settled (the async path runs GC on a background thread; this
        runs one synchronously behind it)."""
        with self._mu:
            self._finalize_pending_locked()
        self.gc()

    def _finalize_pending_locked(self):
        if self._pending is None:
            return
        step, handle = self._pending
        self._pending = None
        handle.result()            # joins; re-raises writer errors
        self._after_commit_locked(step)

    def _after_commit_locked(self, step: int):
        if self._last_seen is not None and self._last_seen[0] <= step:
            # this state is now durable — drop the emergency-save ref
            # (keeping it would pin one full model copy per manager)
            self._last_seen = (step, None)
        if self.async_save:
            # rmtree of a multi-GB evicted checkpoint can take seconds
            # on a network filesystem — an async-save manager must not
            # bill that to the training thread (which is where this
            # runs, via the next save()'s finalize)
            threading.Thread(target=self._gc_quiet, daemon=True,
                             name="ckpt-gc").start()
        else:
            self.gc()

    def _gc_quiet(self):
        try:
            self.gc()
        except Exception as e:
            import sys
            print(f"[checkpoint] retention GC failed: {e}", file=sys.stderr)

    # -- recovery -----------------------------------------------------------

    def _recover_graveyards(self):
        """A kill inside the commit protocol's overwrite window (save
        onto an existing committed step) strands the only good copy at
        ``step_<N>.old.<uid>``: rename it back instead of letting the
        debris sweep collect it. An uncommitted half-renamed dir at the
        step path loses to a committed graveyard."""
        from . import is_committed
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return
        for name in names:
            m = _OLD_RE.match(name)
            if m is None:
                continue
            full = os.path.join(self.root, name)
            dest = os.path.join(self.root, m.group(1))
            if not is_committed(full) or is_committed(dest):
                continue        # nothing to save / a committed dir won
            try:
                if os.path.exists(dest):
                    shutil.rmtree(dest, ignore_errors=True)
                os.rename(full, dest)
            except OSError:
                continue
            import sys
            print(f"[checkpoint] recovered {m.group(1)} from interrupted "
                  "overwrite", file=sys.stderr)

    # -- retention ----------------------------------------------------------

    def gc(self):
        """Delete committed steps beyond ``keep_last_n`` (never the
        newest), plus crash debris: stale staging/graveyard dirs and
        cold uncommitted ``step_<N>`` dirs (a kill between the rename
        and the COMMIT write leaves one at the final path). Only the
        coordinator deletes — on a shared filesystem every other host
        would race it."""
        from . import is_committed
        if _world()[1] != self.coordinator_rank:
            return
        with self._gc_mu:
            self._gc_locked(is_committed)

    def _gc_locked(self, is_committed):
        # stranded committed graveyards must be rescued BEFORE the
        # debris sweep below can consider them collectible
        self._recover_graveyards()
        steps = self.all_steps()
        doomed = steps[:-self.keep_last_n] if len(steps) > self.keep_last_n \
            else []
        for step in doomed:
            shutil.rmtree(self._step_path(step), ignore_errors=True)
            _monitor.inc("ckpt.gc.deleted",
                         doc="checkpoints removed by retention GC")
        pending_step = self._pending[0] if self._pending is not None else None
        in_flight = f"step_{pending_step}." if pending_step is not None \
            else None
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return
        for name in names:
            full = os.path.join(self.root, name)
            m = _STEP_RE.match(name)
            if _DEBRIS_RE.match(name):
                if in_flight and name.startswith(in_flight):
                    continue
            elif m and not is_committed(full):
                if pending_step is not None and int(m.group(1)) == \
                        pending_step:
                    continue
            else:
                continue
            # only collect cold debris: a live save from another manager
            # keeps its shard FILE's mtime fresh while streaming (the
            # dir mtime freezes after file creation), so take the newest
            # mtime across the dir and its entries
            try:
                if time.time() - _newest_mtime(full) < 60.0:
                    continue
            except OSError:
                continue
            shutil.rmtree(full, ignore_errors=True)
            _monitor.inc("ckpt.gc.debris",
                         doc="crash debris dirs removed by GC (staging, "
                             "graveyards, uncommitted step dirs)")

    # -- restore ------------------------------------------------------------

    def restore(self, step: int, state_dict: Dict, verify: bool = True):
        """Load committed ``step`` into ``state_dict`` in place
        (manifest-verified unless the caller already verified; reshards
        onto current placements)."""
        from . import load_state_dict
        load_state_dict(state_dict, self._step_path(step), verify=verify)

    def restore_latest(self, state_dict: Dict) -> Optional[int]:
        """Load the newest committed checkpoint that passes manifest
        verification into ``state_dict``; fall back to the previous
        committed one on corruption. Returns the restored step, or None
        when no usable checkpoint exists (state_dict untouched). An async
        save in flight is finalized first (its step becomes a candidate).

        Multi-host: hosts AGREE on the step before loading (candidate
        sets are intersected and each candidate's local verification is
        all-gathered), so a checkpoint that is torn or not yet visible
        on one host can never make workers resume from different
        steps."""
        from . import CheckpointError, verify_checkpoint
        multi = _world()[0]
        with self._mu:
            self._finalize_pending_locked()
        candidates = list(reversed(self.all_steps()))
        group = _ckpt_group() if multi else None
        if multi:
            sets = _gather(candidates, group)
            common = set(sets[0])
            for s in sets[1:]:
                common &= set(s)
            candidates = sorted(common, reverse=True)
        for i, step in enumerate(candidates):
            if multi:
                try:
                    verify_checkpoint(self._step_path(step))
                    ok = True
                except CheckpointError:
                    ok = False
                if not all(_gather(ok, group)):
                    _monitor.inc(
                        "ckpt.restore.fallbacks",
                        doc="restores that skipped corrupt checkpoints")
                    continue
            try:
                # multi-host: the agreement round just CRC-verified this
                # dir — don't pay the full read again inside the load
                self.restore(step, state_dict, verify=not multi)
                if i and not multi:
                    _monitor.inc(
                        "ckpt.restore.fallbacks", i,
                        doc="restores that skipped corrupt checkpoints")
                return step
            except (CheckpointError, OSError, ValueError, KeyError) as e:
                import sys
                print(f"[checkpoint] step_{step} unusable "
                      f"({type(e).__name__}: {e}); falling back",
                      file=sys.stderr)
                if multi:
                    # verification passed everywhere but the LOAD failed
                    # locally: divergence is now unavoidable without
                    # another agreement round — fail hard rather than
                    # silently resume from a different step than peers
                    raise
        return None

    # -- preemption ---------------------------------------------------------

    def finalize_on_preemption(self, timeout: float = 8.0):
        """Make the newest known state durable before the process dies:
        join an in-flight async save (bounded — the launcher escalates
        SIGTERM to SIGKILL after a grace window, and a peer-less
        multi-host writer can block on the dead coordinator), then — if
        the newest state handed to ``save()`` was interval-skipped and
        is newer than anything committed — take an emergency sync save
        of it."""
        import sys

        # Preemption black box FIRST: the flight record must capture
        # what the process was doing when SIGTERM landed, before the
        # finalize/emergency-save below rewrites the metrics story (and
        # before anything here can block into the kill escalation).
        # The dump runs on a helper thread with a bounded join: this
        # handler executes ON the interrupted thread, which may hold
        # the trace-ring or registry locks — dumping inline would
        # deadlock the whole grace window. Off-thread, a held lock
        # merely delays the dump until the handler returns and the
        # interrupted frame releases it.
        try:
            from ...monitor import trace as _trace
            t = threading.Thread(
                target=_trace.record_fault,
                args=("preemption.sigterm", "preempt"), daemon=True)
            t.start()
            t.join(timeout=2.0)
        except Exception:
            pass
        with self._mu:
            if self._pending is not None:
                step, handle = self._pending
                try:
                    handle.result(timeout=timeout)
                    self._pending = None
                    self._after_commit_locked(step)
                except TimeoutError:
                    print(f"[checkpoint] in-flight save of step {step} "
                          f"still writing after {timeout}s; dying "
                          "without it", file=sys.stderr)
                    return
                except BaseException as e:
                    self._pending = None
                    print(f"[checkpoint] in-flight save failed during "
                          f"preemption: {e}", file=sys.stderr)
            if self._last_seen is not None:
                step, state = self._last_seen
                if callable(state):
                    # a provider whose loop is gone offers None
                    state = state()
                latest = self.latest_step()
                if state is not None and (latest is None or step > latest):
                    if _world()[0]:
                        # a committed save is a collective; hosts reach
                        # their SIGTERM hooks independently, so starting
                        # one here can only block on peers that already
                        # died — burn no grace time on it
                        print("[checkpoint] multi-host preemption: "
                              f"step {step} was never saved and cannot "
                              "be emergency-saved without peers",
                              file=sys.stderr)
                    else:
                        _monitor.inc("ckpt.preempt.emergency_saves",
                                     doc="sync saves taken in SIGTERM hooks")
                        self.save(step, state, force=True, blocking=True)

    def install_preemption_hook(self, signals=(signal.SIGTERM,),
                                resend: bool = True):
        """On each signal: finalize (see ``finalize_on_preemption``),
        then chain to the previously-installed handler — or, with
        ``resend=True`` and a default handler, re-deliver the signal so
        the process still dies with the right status. No-op off the
        main thread (signal.signal would raise)."""
        def _handler(signum, frame):
            self.finalize_on_preemption()
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif resend:
                signal.signal(signum, prev if prev is not None
                              else signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        for sig in signals:
            try:
                self._prev_handlers[sig] = signal.signal(sig, _handler)
            except ValueError:      # not the main thread
                return False
        return True

    def remove_preemption_hook(self):
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except ValueError:
                pass
        self._prev_handlers.clear()

    def close(self):
        """Finalize the in-flight save and detach signal handlers; the
        emergency-save reference is dropped so a closed manager can
        never commit a stale state under a stale step number."""
        self.wait()
        self.remove_preemption_hook()
        with self._mu:
            self._last_seen = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
