"""Port parity: ``paddle.Model`` and its callbacks
(``paddle_tpu_torch/hapi/``, ``paddle_tpu_torch/callbacks.py``) against
``paddle_tpu``'s.

- ``llama_tiny`` (2 layers, float32) with the JAX model's weights carried
  across (``state_dict`` -> numpy -> ``set_state_dict``, the RMSNorm
  weights drawn around 1): ``fit`` (3 AdamW steps; per-step losses rtol
  1e-5, the eager parity tests' bound), then ``evaluate`` (loss rtol
  1e-5, accuracy equal) and ``predict`` (logits within 1e-4 of the
  largest) against the reference's ``Model`` on the JAX
  ``LlamaForCausalLM``; ``summary``'s counts equal.
- On a ``Linear`` regression with carried weights and Adam (losses rtol
  1e-5): a recording callback sees the reference's events in the
  reference's order; ``EarlyStopping`` stops at the reference's epoch;
  ``LRScheduler`` steps the optimizer's scheduler (the reference's
  callback steps nothing, pinned, so its side steps by hand);
  ``ReduceLROnPlateau`` gives the reference's lr trajectory;
  ``ModelCheckpoint`` writes the reference's files, whose
  ``.pdparams`` the reference loads, and ``Model.load`` restores
  ``.pdopt``.
- ``FaultTolerantCheckpoint``: a fit in a process of its own
  (``tests/_torch_hapi_worker.py``) killed by
  ``FLAGS_fault_injection=train.batch:kill:3`` resumes here from step 2
  with the loader re-seated: no batch replayed or skipped, the losses
  those of an uninterrupted fit bit for bit (after
  ``tests/test_checkpoint_ft.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.models import llama as JL
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import device as TD
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import llama as TL

from _torch_hapi_worker import fit_linear

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def cpu_device():
    prev = TD._current_device
    tpaddle.set_device("cpu")
    yield
    TD._current_device = prev


class Recorder:
    """Records every hook call as ``(hook, step or epoch)``."""

    HOOKS = ("train_begin", "train_end", "epoch_begin", "epoch_end",
             "train_batch_begin", "train_batch_end", "eval_begin",
             "eval_end", "eval_batch_begin", "eval_batch_end",
             "predict_begin", "predict_end", "predict_batch_begin",
             "predict_batch_end")

    @classmethod
    def make(cls, base):
        def hook(name):
            def f(self, *a, **kw):
                arg = a[0] if a and isinstance(a[0], int) else None
                self.events.append((name, arg))
                if name == "train_batch_end":
                    self.losses.append(float(kw.get(
                        "logs", a[1] if len(a) > 1 else {})["loss"][0]))
            return f
        body = {f"on_{h}": hook(h) for h in cls.HOOKS}
        body["__init__"] = lambda self: (base.__init__(self), setattr(
            self, "events", []), setattr(self, "losses", []))[0]
        return type("Rec", (base,), body)()


# -- llama_tiny through fit / evaluate / predict --------------------------

@pytest.fixture(scope="module")
def llama_runs():
    prev = TD._current_device
    tpaddle.set_device("cpu")
    try:
        jpaddle.seed(0)
        jm = JL.LlamaForCausalLM(JL.llama_tiny(num_hidden_layers=2))
        tm = TL.LlamaForCausalLM(TL.llama_tiny(num_hidden_layers=2))
        rng = np.random.default_rng(100)
        sd = {k: v.numpy() for k, v in jm.state_dict().items()}
        for k, v in sd.items():
            if "norm" in k:
                sd[k] = (1 + 0.3 * rng.normal(size=v.shape)).astype(
                    np.float32)
        jm.set_state_dict(sd)
        tm.set_state_dict(sd)
        ids = np.random.default_rng(1).integers(0, 256, (12, 17))
        inp, tgt = ids[:, :-1], ids[:, 1:]
        out = {}
        for side, m, nn, opt, io, metric in (
                ("torch", tm, tnn, topt, tio, tmetric),
                ("jax", jm, jnn, jopt, jio, jmetric)):
            model = (tpaddle if side == "torch" else jpaddle).Model(m)
            model.prepare(opt.AdamW(learning_rate=1e-3,
                                    parameters=m.parameters()),
                          nn.CrossEntropyLoss(), metrics=metric.Accuracy())
            rec = Recorder.make(tcb.Callback if side == "torch"
                                else jcb.Callback)
            model.fit(io.TensorDataset([inp, tgt]), batch_size=4, epochs=1,
                      shuffle=False, verbose=0, callbacks=[rec])
            ev = model.evaluate(io.TensorDataset([inp, tgt]), batch_size=4,
                                verbose=0)
            pred = model.predict(io.TensorDataset([inp]), batch_size=6,
                                 stack_outputs=True, verbose=0)
            out[side] = {"losses": rec.losses, "eval": ev, "pred": pred,
                         "events": rec.events, "model": model}
        return out
    finally:
        TD._current_device = prev


def test_fit_losses_match_the_reference(llama_runs):
    t, j = llama_runs["torch"], llama_runs["jax"]
    assert len(t["losses"]) == len(j["losses"]) == 3
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    assert t["events"] == j["events"]


def test_evaluate_and_predict_match_the_reference(llama_runs):
    t, j = llama_runs["torch"], llama_runs["jax"]
    assert set(t["eval"]) == set(j["eval"]) == {"loss", "acc"}
    np.testing.assert_allclose(t["eval"]["loss"], j["eval"]["loss"],
                               rtol=1e-5)
    assert t["eval"]["acc"] == j["eval"]["acc"]
    (tp,), (jp,) = t["pred"], j["pred"]
    assert tp.shape == jp.shape == (12, 16, 256)
    assert np.abs(tp - jp).max() <= 1e-4 * np.abs(jp).max()


def test_summary_counts_match_the_reference(llama_runs, capsys):
    t = llama_runs["torch"]["model"].summary()
    j = llama_runs["jax"]["model"].summary()
    assert t == j and t["total_params"] == TL.count_params(
        TL.llama_tiny(num_hidden_layers=2))
    printed = capsys.readouterr().out
    assert "layers.1.down_proj" in printed


# -- callbacks on a Linear regression ------------------------------------

def _linear_data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x @ rng.normal(size=(4, 1)) + 0.1).astype(np.float32)
    w = rng.normal(size=(4, 1)).astype(np.float32) * 0.1
    return x, y, w


def _linear_models(lr=0.05, seed=0, t_lr=None, j_lr=None):
    x, y, w = _linear_data(seed)
    out = {}
    for side, P, nn, opt in (("torch", tpaddle, tnn, topt),
                             ("jax", jpaddle, jnn, jopt)):
        net = nn.Linear(4, 1)
        net.set_state_dict({"weight": w, "bias": np.zeros(1, np.float32)})
        model = P.Model(net)
        rate = (t_lr if side == "torch" else j_lr) or lr
        model.prepare(opt.Adam(learning_rate=rate,
                               parameters=net.parameters()), nn.MSELoss())
        out[side] = model
    return out, x, y


def _ds(side, x, y):
    return (tio if side == "torch" else jio).TensorDataset([x, y])


def test_event_order_matches_the_reference():
    models, x, y = _linear_models()
    events = {}
    for side, model in models.items():
        rec = Recorder.make(tcb.Callback if side == "torch"
                            else jcb.Callback)
        model.fit(_ds(side, x, y), eval_data=_ds(side, x[:8], y[:8]),
                  batch_size=4, epochs=2, shuffle=False, verbose=0,
                  callbacks=[rec], accumulate_grad_batches=2)
        model.evaluate(_ds(side, x, y), batch_size=8, verbose=0,
                       callbacks=[rec])
        model.predict((tio if side == "torch" else jio).TensorDataset(
            [x]), batch_size=8, verbose=0, callbacks=[rec])
        events[side] = (rec.events, rec.losses)
    assert events["torch"][0] == events["jax"][0]
    assert ("train_batch_end", 3) in events["torch"][0]
    np.testing.assert_allclose(events["torch"][1], events["jax"][1],
                               rtol=1e-5)


def test_early_stopping_stops_at_the_reference_epoch(tmp_path):
    models, x, y = _linear_models()
    seen = {}
    for side, model in models.items():
        cb = (tcb if side == "torch" else jcb).EarlyStopping(
            monitor="loss", patience=2, baseline=-1.0,
            save_best_model=False)
        rec = Recorder.make(tcb.Callback if side == "torch"
                            else jcb.Callback)
        model.fit(_ds(side, x, y), eval_data=_ds(side, x, y), batch_size=8,
                  epochs=10, verbose=0, shuffle=False, callbacks=[cb, rec])
        seen[side] = (cb.stopped_epoch, cb.wait,
                      [e for e in rec.events if e[0] == "epoch_end"],
                      rec.losses)
    assert seen["torch"][:3] == seen["jax"][:3]
    assert seen["torch"][0] == 1 and len(seen["torch"][2]) == 2
    np.testing.assert_allclose(seen["torch"][3], seen["jax"][3], rtol=1e-5)


def test_lr_scheduler_steps_the_optimizers_scheduler():
    """The port's callback steps the scheduler a batch; the reference's
    reads ``_lr_scheduler``, which its optimizer never sets, so it steps
    nothing (pinned), and its side steps by hand."""
    t_sched = topt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    j_sched = jopt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    models, x, y = _linear_models(t_lr=t_sched, j_lr=j_sched)
    jm = models["jax"]
    jcb.LRScheduler().set_model(jm)
    pinned = jcb.LRScheduler()
    pinned.set_model(jm)
    assert pinned._sched() is None

    class ByHand(jcb.Callback):
        def on_train_batch_end(self, step, logs=None):
            j_sched.step()

    lrs = {"torch": [], "jax": []}
    for side, model in models.items():
        class Lr((tcb if side == "torch" else jcb).Callback):
            def on_train_batch_begin(self, step, logs=None, _s=side):
                lrs[_s].append(self.model._optimizer.get_lr())
        extra = [ByHand()] if side == "jax" else []
        model.fit(_ds(side, x, y), batch_size=4, epochs=1, verbose=0,
                  shuffle=False, callbacks=[Lr(), *extra])
    assert lrs["torch"] == lrs["jax"] == [0.1, 0.1, 0.05, 0.05]
    assert t_sched.last_epoch == j_sched.last_epoch == 4


def test_reduce_lr_on_plateau_matches_the_reference():
    models, x, y = _linear_models()
    lrs = {}
    for side, model in models.items():
        mod = tpaddle.callbacks if side == "torch" else jpaddle.callbacks
        cb = mod.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                                   min_delta=1e9, verbose=0)
        seen = []

        class Lr(mod.Callback):
            def on_epoch_end(self, epoch, logs=None, _seen=seen):
                _seen.append(self.model._optimizer.get_lr())
        model.fit(_ds(side, x, y), eval_data=_ds(side, x, y), batch_size=8,
                  epochs=4, verbose=0, shuffle=False, callbacks=[Lr(), cb])
        lrs[side] = seen + [model._optimizer.get_lr()]
    assert lrs["torch"] == lrs["jax"]
    assert lrs["torch"][-1] == pytest.approx(0.05 * 0.5 ** 3)


def test_model_checkpoint_files_cross_and_restore(tmp_path):
    models, x, y = _linear_models()
    for side, model in models.items():
        model.fit(_ds(side, x, y), batch_size=4, epochs=2, verbose=0,
                  shuffle=False, save_dir=str(tmp_path / side))
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    tm = models["torch"]
    want = {k: v.detach().numpy().copy()
            for k, v in tm.network.state_dict().items()}
    jref, _, _ = _linear_models()
    jref["jax"].load(str(tmp_path / "torch" / "final"),
                     reset_optimizer=True)
    for k, v in jref["jax"].network.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v.numpy()), want[k])
    fresh, _, _ = _linear_models()
    fresh["torch"].load(str(tmp_path / "torch" / "final"))
    for k, v in fresh["torch"].network.state_dict().items():
        assert torch.equal(v.detach(), torch.from_numpy(want[k]))
    a, b = tm._optimizer.state_dict(), fresh["torch"]._optimizer.state_dict()
    assert a.keys() == b.keys() and a["global_step"] == b["global_step"] == 8
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k


def _prepare_in(tmp, seed=3):
    x, y, w = _linear_data(seed, n=20)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "in.npz"), x=x, y=y, w=w,
             b=np.zeros(1, np.float32))


def test_fault_tolerant_checkpoint_resumes_a_killed_fit_exactly_once(
        tmp_path):
    whole = str(tmp_path / "whole")
    _prepare_in(whole)
    want = []
    fit_linear(whole, want.append)
    assert len(want) == 5

    run = str(tmp_path / "run")
    _prepare_in(run)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               FLAGS_fault_injection="train.batch:kill:3")
    r = subprocess.run([sys.executable,
                        os.path.join(HERE, "_torch_hapi_worker.py"), run],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 137, r.stderr[-2000:]
    with open(os.path.join(run, "losses.txt")) as f:
        killed = [float(v) for v in f.read().split()]
    assert killed == want[:2]

    got = []
    model, ck = fit_linear(run, got.append)
    assert ck.restored_step == 2
    assert killed + got == want
