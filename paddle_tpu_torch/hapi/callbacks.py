"""Training callbacks of ``Model.fit`` (port of
``paddle_tpu/hapi/callbacks.py``): ``Callback`` and ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``FaultTolerantCheckpoint`` over
the port's ``CheckpointManager`` with exactly-once data resume,
``EarlyStopping``, ``LRScheduler`` and ``config_callbacks``.

``LRScheduler`` steps the optimizer's scheduler, the ``LRScheduler``
object given as its ``learning_rate``. The reference's callback reads an
``_lr_scheduler`` attribute that its optimizer never sets, so there it
steps nothing (ROADMAP C, "Reference behaviour").
"""
from __future__ import annotations

import numbers
import os
import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "FaultTolerantCheckpoint", "EarlyStopping", "LRScheduler",
           "config_callbacks"]


class Callback:
    """Base class: every hook does nothing."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    # eval
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    # predict
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    """Calls each hook on every callback in order."""

    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args, **kwargs):
        for c in self.callbacks:
            getattr(c, name)(*args, **kwargs)

    def on_begin(self, mode, logs=None):
        self._call(f"on_{mode}_begin", logs)

    def on_end(self, mode, logs=None):
        self._call(f"on_{mode}_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_begin", step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_end", step, logs)


class ProgBarLogger(Callback):
    """Step and epoch console logging."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self._t0 = None

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def _fmt(self, logs):
        items = []
        for k, v in (logs or {}).items():
            if isinstance(v, (numbers.Number, np.floating)):
                items.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, np.ndarray)) and len(v):
                items.append(f"{k}: {float(np.asarray(v).flat[0]):.4f}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            print(f"step {step}: {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - (self._t0 or time.time())
            print(f"epoch {epoch + 1} done in {dt:.1f}s - "
                  f"{self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """``model.save`` every ``save_freq`` epochs and at the end."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class FaultTolerantCheckpoint(Callback):
    """Step-granular crash-consistent checkpointing with auto-resume.

    Where :class:`ModelCheckpoint` writes ``model.save`` files per epoch,
    this callback drives a ``distributed.checkpoint.CheckpointManager``:
    every save commits atomically (kill-anywhere safe), retention keeps
    the last N, ``on_train_begin`` restores the newest committed
    checkpoint into the live parameters (skipping corrupt ones), and a
    SIGTERM hook finalizes the in-flight save before preemption kills
    the process — the hapi face of the ``run_elastic`` auto-resume path.

    Resume restores parameters in place and, when the checkpoint carried
    an ``opt`` section, re-applies optimizer state (accumulators,
    ``global_step``, LR-scheduler state) via ``set_state_dict`` — the
    optimizer's accumulators are pre-created so a freshly-built
    optimizer can receive them. The epoch/step loop itself restarts at
    0; ``restored_step`` records what was loaded.

    Exactly-once data resume: ``Model.fit`` registers its train
    DataLoader here (``register_dataloader``); its
    {seed, epoch, batch-cursor, collator-carry} state then rides every
    checkpoint under ``data`` and is restored on resume, so the
    restarted fit's first epoch continues the interrupted epoch from
    the exact batch boundary — no sample replayed, none skipped
    (``include_dataloader=False`` opts out).
    """

    def __init__(self, save_dir: str, keep_last_n: int = 3,
                 save_interval_steps: int = 100, async_save: bool = True,
                 resume: bool = True, preemption_hook: bool = True,
                 include_optimizer: bool = True,
                 include_dataloader: bool = True):
        super().__init__()
        self.save_dir = save_dir
        self.keep_last_n = keep_last_n
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self.resume = resume
        self.preemption_hook = preemption_hook
        self.include_optimizer = include_optimizer
        self.include_dataloader = include_dataloader
        self.manager = None
        self.restored_step = None
        self._gstep = 0
        self._last_saved = 0
        self._loader = None

    def register_dataloader(self, loader):
        """Called by ``Model.fit`` with the train loader; accepted only
        when it carries the resume-state protocol."""
        if self.include_dataloader and hasattr(loader, "state_dict") \
                and hasattr(loader, "set_state_dict"):
            self._loader = loader

    def _state(self):
        state = {"model": dict(self.model.network.state_dict())}
        if self.include_optimizer:
            opt = getattr(self.model, "_optimizer", None)
            opt_sd = getattr(opt, "state_dict", lambda: {})() if opt else {}
            if opt_sd:
                state["opt"] = dict(opt_sd)
        if self._loader is not None:
            state["data"] = dict(self._loader.state_dict())
        return state

    def _state_provider(self):
        """Offer-time provider for the per-batch save: model/optimizer
        stay LAZY (interval-skipped batches pay nothing) but the
        loader cursor is snapshotted NOW — a SIGTERM emergency save
        materializes the provider mid-NEXT-batch, when the live cursor
        is one ahead of this batch's step; a deferred read would make
        the resumed loader silently skip that batch."""
        data_fn = None
        if self._loader is not None:
            if hasattr(self._loader, "state_provider"):
                data_fn = self._loader.state_provider()      # O(1) pin
            else:
                snap = dict(self._loader.state_dict())
                data_fn = lambda: snap                       # noqa: E731

        def provide():
            state = {"model": dict(self.model.network.state_dict())}
            if self.include_optimizer:
                opt = getattr(self.model, "_optimizer", None)
                opt_sd = getattr(opt, "state_dict", lambda: {})() \
                    if opt else {}
                if opt_sd:
                    state["opt"] = dict(opt_sd)
            if data_fn is not None:
                state["data"] = dict(data_fn())
            return state
        return provide

    def on_train_begin(self, logs=None):
        from ..distributed.checkpoint import CheckpointManager

        if self.manager is not None:
            # fit() does not reach on_train_end when training raises: a
            # retried fit must not leave the previous manager's SIGTERM
            # hook chained (it would emergency-commit stale state under
            # a stale step number)
            try:
                self.manager.close()
            except BaseException as e:
                import sys
                print("[checkpoint] previous run's final save failed "
                      f"({type(e).__name__}: {e}); its last checkpoint "
                      "may be older than expected", file=sys.stderr)
                self.manager.remove_preemption_hook()
        self.manager = CheckpointManager(
            self.save_dir, keep_last_n=self.keep_last_n,
            save_interval_steps=self.save_interval_steps,
            async_save=self.async_save)
        self._gstep = 0
        self._last_saved = 0
        if self.resume:
            # load_state_dict copies into the live parameters, so the
            # network sees the restored values directly. Optimizer
            # accumulators are NOT live handles (Optimizer.state_dict
            # returns copies), so pre-create them for the template and
            # re-apply via set_state_dict after the load.
            opt = getattr(self.model, "_optimizer", None)
            if (self.include_optimizer and opt is not None
                    and hasattr(opt, "_ensure_state")):
                for p in (getattr(opt, "_parameter_list", None) or []):
                    opt._ensure_state(p)
            state = self._state()
            self.restored_step = self.manager.restore_latest(state)
            if self.restored_step is not None:
                self._gstep = self.restored_step
                self._last_saved = self.restored_step
                if "opt" in state and opt is not None \
                        and hasattr(opt, "set_state_dict"):
                    opt.set_state_dict(state["opt"])
                if "data" in state and self._loader is not None:
                    # re-seat the train loader at the restored step's
                    # batch boundary (exactly-once across the restart)
                    self._loader.set_state_dict(state["data"])
        if self.preemption_hook:
            self.manager.install_preemption_hook()

    def on_train_batch_end(self, step, logs=None):
        self._gstep += 1
        if self.manager is not None:
            # pass a provider, not the state: the manager materializes
            # it only when the interval policy actually saves (or in a
            # SIGTERM emergency save), so interval-skipped batches don't
            # pay a full state-dict + optimizer traversal — but the
            # loader cursor inside it is pinned to THIS batch
            if self.manager.save(self._gstep, self._state_provider()):
                self._last_saved = self._gstep

    def on_train_end(self, logs=None):
        if self.manager is None:
            return
        self.manager.wait()
        # decide the final force-save from program state (_last_saved),
        # not a filesystem read: saves are collective, and a local
        # latest_step() probe can disagree across hosts (NFS attribute
        # caches, host-local roots) — the step counters cannot
        if self._gstep and self._last_saved != self._gstep:
            self.manager.save(self._gstep, self._state(), force=True,
                              blocking=True)
            self._last_saved = self._gstep
        self.manager.close()
        self.manager = None


class EarlyStopping(Callback):
    """Stop when a monitored metric stalls."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.wait = 0
        self._epoch = 0
        # baseline seeds `best` (reference semantics: runs that never beat
        # the baseline stop after `patience` evals)
        self.best = baseline

    def _better(self, cur, best):
        if best is None:
            return True
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).flat[0])
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            save_dir = (self.params or {}).get("save_dir")
            if self.save_best_model and save_dir:
                self.model.save(os.path.join(save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self._epoch
                self.model.stop_training = True


class LRScheduler(Callback):
    """Step the optimizer's learning-rate scheduler after every batch
    (``by_step``) and / or every epoch (``by_epoch``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as _Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if isinstance(lr, _Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, log_freq=2, verbose=2,
                     save_freq=1, save_dir=None, metrics=None, mode="train"):
    """The fit loop's ``CallbackList``: ``ProgBarLogger`` first when
    ``verbose``, ``LRScheduler`` and ``ModelCheckpoint`` (with a
    ``save_dir``) appended unless given."""
    cbks = callbacks or []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
        "save_dir": save_dir,
    })
    return lst
