"""``paddle.Model``, the high-level train / eval / predict API (port of
``paddle_tpu/hapi/model.py``).

One adapter, the eager one: ``network`` is a port ``nn.Layer`` whose
forward runs the port's kernels on the card. ``fit`` keeps the
reference's seams: ``StepTimer("hapi.fit")`` (data wait, compute,
checkpoint), ``monitor.server.maybe_start()``, the ``train.batch``
fault point, ``guard_eager_update`` (``FLAGS_enable_sentinel``),
gradient accumulation, and the train loader handed to every callback
that has ``register_dataloader`` (``FaultTolerantCheckpoint``'s
exactly-once resume). ``save`` / ``load`` write and read ``.pdparams``
and ``.pdopt`` through ``paddle_tpu_torch.save`` / ``load``, the
reference's file format. Inputs that are not tensors become tensors on
the current device.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Union

import numpy as np

import torch

from ..core.tensor import to_tensor
from ..framework.io import load as _load, save as _save
from ..io import DataLoader
from ..metric import Metric
from ..metric import _np as _host
from ..nn.layer.base import Layer
from .callbacks import config_callbacks

__all__ = ["Model", "summary"]


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _to_tensor(x):
    if torch.is_tensor(x):
        return x
    return to_tensor(np.asarray(x))


class Model:
    """``paddle.Model`` over a port ``nn.Layer``."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._metrics: List[Metric] = []
        self._optimizer = None
        self.stop_training = False

    # -- setup ------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        ms = _to_list(metrics)
        for m in ms:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m} is not a paddle.metric.Metric")
        self._metrics = ms

    # -- single-batch ops ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True,
                    loss_scale=1.0):
        """One training step. ``update=False`` accumulates gradients
        without stepping (reference accumulate path); outputs are stashed
        on ``self._last_outs`` for metric updates."""
        self.network.train()
        outs, losses = self._run_batch(inputs, labels, compute_loss=True)
        self._last_outs = outs
        if losses:
            total = losses[0] if len(losses) == 1 \
                else sum(losses[1:], losses[0])
            if loss_scale != 1.0:
                total = total * loss_scale
            total.backward()
        # Anomaly guard (training/sentinel.py), fed EVERY micro-batch:
        # with FLAGS_enable_sentinel set, a non-finite loss anywhere in
        # the accumulation window SKIPS the window's optimizer step
        # (its NaN is already summed into the accumulated grads) —
        # gradients cleared, parameters untouched, train.anomaly.*
        # metrics fed. One cached-flag branch off.
        from ..training.sentinel import guard_eager_update
        skip = guard_eager_update(self, losses, update=update)
        if update and self._optimizer is not None:
            if not skip:
                self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(l.detach()) for l in losses]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        outs, losses = self._run_batch(inputs, labels, compute_loss=True)
        metric_res = self._update_metrics(outs, labels)
        return [float(l.detach()) for l in losses], metric_res

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        outs, _ = self._run_batch(inputs, None, compute_loss=False)
        return [_host(o) for o in outs]

    def _run_batch(self, inputs, labels, compute_loss):
        ins = [_to_tensor(x) for x in _to_list(inputs)]
        outs = self.network(*ins)
        outs_l = _to_list(outs)
        losses = []
        if compute_loss and self._loss is not None and labels is not None:
            lbls = [_to_tensor(x) for x in _to_list(labels)]
            loss = self._loss(*(outs_l + lbls))
            losses = _to_list(loss)
        return outs_l, losses

    @torch.no_grad()
    def _update_metrics(self, outs, labels):
        res = {}
        lbls = [_to_tensor(x) for x in _to_list(labels)]
        for m in self._metrics:
            stats = m.compute(*(outs + lbls))
            m.update(*_to_list(stats))
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            acc = m.accumulate()
            accs = acc if isinstance(acc, list) else [acc]
            for n, a in zip(names, accs):
                res[n] = a
        return res

    # -- loops: fit / evaluate / predict -------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1,
            epochs=1, eval_freq=1, log_freq=10, save_dir=None,
            save_freq=1, verbose=2, drop_last=False, shuffle=True,
            num_workers=0, callbacks=None, accumulate_grad_batches=1,
            num_iters=None):
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   drop_last, num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        False, num_workers) \
            if eval_data is not None else None
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                save_freq=save_freq, save_dir=save_dir,
                                verbose=verbose, metrics=self._metric_names())
        self.stop_training = False
        # hand the train loader to resume-aware callbacks BEFORE
        # on_begin: FaultTolerantCheckpoint checkpoints its
        # {epoch, cursor, collator} state and re-seats it on restore,
        # making fit resume exactly-once at the batch level
        for cb in cbks:
            if hasattr(cb, "register_dataloader"):
                cb.register_dataloader(loader)
        cbks.on_begin("train")
        it = 0
        # Step-timeline accounting (monitor/steptimer.py): data-wait vs
        # compute vs checkpoint split + goodput. Off-flag, every seam is
        # one cached-flag branch and registers nothing. The `with stim:`
        # scope keeps this timer the thread's ambient target for the
        # whole loop — so checkpoint time spent inside callbacks
        # (FaultTolerantCheckpoint -> CheckpointManager.save), which run
        # BETWEEN the timed phases, bills itself here through the
        # ambient-phase seam — and releases it when fit returns.
        from .. import monitor as _monitor
        from ..monitor import server as _mserver
        from ..testing import faults as _faults
        # Operator plane: a fit loop is a long-running entrypoint, so
        # it starts the telemetry server when FLAGS_enable_monitor_
        # server is set (one cached branch otherwise)
        _mserver.maybe_start()
        stim = _monitor.StepTimer("hapi.fit")
        with stim:
            for epoch in range(epochs):
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                for step, batch in enumerate(stim.iter_data(loader)):
                    # chaos value point: FLAGS_fault_injection can
                    # poison a batch here (testing/faults.py `corrupt`)
                    # to drive the sentinel's skip path end to end
                    batch = _faults.corrupt("train.batch", batch)
                    inputs, labels = self._split_batch(batch)
                    cbks.on_batch_begin("train", step, logs)
                    k = max(int(accumulate_grad_batches), 1)
                    with stim.compute():
                        losses = self.train_batch(
                            inputs, labels, update=(step + 1) % k == 0,
                            loss_scale=1.0 / k)
                    metric_res = self._update_metrics(
                        self._last_outs, labels) if self._metrics else {}
                    logs = {"loss": losses, **metric_res}
                    cbks.on_batch_end("train", step, logs)
                    stim.end_step()
                    it += 1
                    if num_iters is not None and it >= num_iters:
                        self.stop_training = True
                        break
                cbks.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    self._run_eval(eval_loader, cbks)
                if self.stop_training:
                    break
        cbks.on_end("train", logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._make_loader(eval_data, batch_size, False, False,
                                   num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                metrics=self._metric_names())
        return self._run_eval(loader, cbks, num_iters=num_iters)

    def _run_eval(self, loader, cbks, num_iters=None):
        for m in self._metrics:
            m.reset()
        cbks.on_begin("eval")
        logs = {}
        loss_sum, n = 0.0, 0
        for step, batch in enumerate(loader):
            inputs, labels = self._split_batch(batch)
            cbks.on_batch_begin("eval", step, logs)
            losses, metric_res = self.eval_batch(inputs, labels)
            if losses:
                loss_sum += losses[0]
                n += 1
            logs = {"loss": losses, **metric_res}
            cbks.on_batch_end("eval", step, logs)
            if num_iters is not None and step + 1 >= num_iters:
                break
        if n:
            logs["loss"] = [loss_sum / n]
        cbks.on_end("eval", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, False,
                                   num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose)
        cbks.on_begin("predict")
        outputs = []
        for step, batch in enumerate(loader):
            inputs, _ = self._split_batch(batch, labeled=False)
            cbks.on_batch_begin("predict", step, None)
            outs = self.predict_batch(inputs)
            outputs.append(outs)
            cbks.on_batch_end("predict", step, None)
        cbks.on_end("predict", None)
        # transpose to per-output lists (reference semantics)
        res = [[o[i] for o in outputs] for i in range(len(outputs[0]))]
        if stack_outputs:
            res = [np.concatenate(r, axis=0) for r in res]
        return res

    # -- persistence: the reference's .pdparams / .pdopt files ---------------
    def save(self, path, training=True):
        dirn = os.path.dirname(path)
        if dirn:
            os.makedirs(dirn, exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            state = getattr(self._optimizer, "state_dict", lambda: {})()
            _save(state, path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        params = _load(path + ".pdparams")
        self.network.set_state_dict(params)
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            state = _load(opt_path)
            if hasattr(self._optimizer, "set_state_dict"):
                self._optimizer.set_state_dict(state)

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtypes=dtype)

    # -- helpers ----------------------------------------------------------
    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _make_loader(self, data, batch_size, shuffle, drop_last,
                     num_workers):
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _split_batch(self, batch, labeled=True):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if not labeled or len(batch) == 1:
            return batch, None
        # convention: last element(s) are labels (reference uses
        # inputs/labels specs; without specs, 1 label)
        return batch[:-1], batch[-1:]


def summary(net: Layer, input_size=None, dtypes=None, input=None):
    """``paddle.summary``: prints a table of the sublayers that hold
    parameters and returns the total and trainable parameter counts."""
    rows = []
    total = 0
    trainable = 0
    for name, sub in net.named_sublayers(include_self=False):
        # recurse=False: a plain torch module inside the network too
        n_params = sum(p.numel() for p in sub.parameters(recurse=False))
        if n_params == 0 and len(list(sub.children())):
            continue
        total_sub = int(n_params)
        rows.append((name, type(sub).__name__, total_sub))
    for p in net.parameters():
        total += int(p.numel())
        if p.requires_grad:
            trainable += int(p.numel())
    width = max([len(r[0]) for r in rows] + [len("Layer")], default=10) + 2
    lines = [f"{'Layer':<{width}}{'Type':<20}{'Params':>12}"]
    lines += [f"{n:<{width}}{t:<20}{c:>12,}" for n, t, c in rows]
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
