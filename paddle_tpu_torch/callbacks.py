"""``paddle.callbacks`` (port of ``paddle_tpu/callbacks.py``): the hapi
callbacks, ``ReduceLROnPlateau``, and the ``VisualDL`` / ``WandbCallback``
trackers, which import their client packages at first use and raise
``PreconditionNotMetError`` when those are not installed."""
from __future__ import annotations

from .core import enforce as E
from .hapi.callbacks import (Callback, EarlyStopping,  # noqa
                             FaultTolerantCheckpoint, LRScheduler,
                             ModelCheckpoint, ProgBarLogger)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint",
           "FaultTolerantCheckpoint", "LRScheduler", "EarlyStopping",
           "ReduceLROnPlateau", "VisualDL", "WandbCallback"]


class ReduceLROnPlateau(Callback):
    """Shrink the lr by ``factor`` when the monitored metric has not
    improved for ``patience`` evaluations."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "max" or (mode == "auto" and ("acc" in monitor)):
            self._better = lambda a, b: a > b + self.min_delta
            self._best = float("-inf")
        else:
            self._better = lambda a, b: a < b - self.min_delta
            self._best = float("inf")
        self._wait = 0
        self._cooldown_counter = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cooldown_counter > 0:
            # in cooldown: track the best but don't accumulate patience
            self._cooldown_counter -= 1
            self._wait = 0
            if self._better(cur, self._best):
                self._best = cur
            return
        if self._better(cur, self._best):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is None:
                return
            lr = opt.get_lr()
            new_lr = max(lr * self.factor, self.min_lr)
            if new_lr < lr:
                opt.set_lr(new_lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {lr:.3g} -> {new_lr:.3g}")
            self._cooldown_counter = self.cooldown
            self._wait = 0


class VisualDL(Callback):
    """VisualDL scalar logging; needs the visualdl package."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None

    def _ensure(self):
        if self._writer is None:
            try:
                from visualdl import LogWriter

                self._writer = LogWriter(self.log_dir)
            except ImportError as e:
                raise E.PreconditionNotMetError(
                    "VisualDL callback needs the visualdl package, which "
                    "is not installed in this environment") from e

    def on_train_batch_end(self, step, logs=None):
        self._ensure()
        for k, v in (logs or {}).items():
            try:
                self._writer.add_scalar(f"train/{k}", float(
                    v[0] if isinstance(v, (list, tuple)) else v), step)
            except (TypeError, ValueError):
                pass


class WandbCallback(Callback):
    """Weights & Biases logging; needs the wandb package."""

    def __init__(self, project=None, **kwargs):
        super().__init__()
        self.project = project
        self.kwargs = kwargs
        self._run = None

    def _ensure(self):
        if self._run is None:
            try:
                import wandb

                self._run = wandb.init(project=self.project, **self.kwargs)
            except ImportError as e:
                raise E.PreconditionNotMetError(
                    "WandbCallback needs the wandb package, which is not "
                    "installed in this environment") from e

    def on_train_batch_end(self, step, logs=None):
        self._ensure()
        self._run.log({k: float(v[0] if isinstance(v, (list, tuple))
                                else v)
                       for k, v in (logs or {}).items()
                       if isinstance(v, (int, float, list, tuple))},
                      step=step)
