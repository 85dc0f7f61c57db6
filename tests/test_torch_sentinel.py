"""Port parity: the training sentinel (``paddle_tpu_torch/training/
sentinel.py`` against ``paddle_tpu/training/sentinel.py``) and the
numerics plane's step half (``monitor/numerics.py``).

- ``AnomalySentinel``: one ``observe`` sequence (healthy norms through
  warmup, a spike over the cap, non-finite steps, consecutive anomalies
  to ROLLBACK, ``rollback``) into both: equal verdicts, caps, EMA mean
  and std, counters, quarantine and ``train.anomaly.*`` metrics.
- ``batch_hash`` equals the reference's where the dtypes agree (numpy
  and torch ``int32`` leaves, tuples and dicts in ``jax.tree.leaves``
  order); the port's ``int64`` ids hash differently from JAX's ``int32``
  ones, which quarantine (one process) does not mind.
- ``SentinelLoop`` on ``llama_tiny`` float32 with the same weights, the
  same stream (``faults`` corrupting ``train.batch`` once, two batches
  poisoned in the data) and a synchronous ``CheckpointManager`` on both:
  equal verdict sequences and counts; losses within 1e-5 relative, final
  parameters within 1e-5 relative L2 a leaf.
- ``dataloader=`` (a duck-typed loader): its state rides the
  checkpoints and the rollback, and ``restore_latest`` resumes it, as
  the reference's.
- ``HangWatchdog``: the stall dump and flight record, re-arming on a
  heartbeat, the StepTimer listener feed, ``/healthz``, ``exit_on_stall``
  (exit 42 in a subprocess).
- ``guard_eager_update``: the reference's decisions on one loss sequence
  (accumulation windows included), and on the port's eager
  ``LlamaForCausalLM`` a NaN step skipped with the parameters unchanged.
- Skip agreement over 2 gloo ranks (``tests/_torch_mesh_worker.py``
  ``case_sentinel_agree``): any rank anomalous, both skip; the max norm
  keeps the statistics equal, as the reference's sentinel fed the
  gathered values.
- ``record_step_stats`` / ``worst_layer`` / ``top_movers`` / ``latest`` /
  ``numerics_snapshot`` and ``audit_quantized_tree`` on the same inputs
  as the reference's.
"""
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_common import launched, load_json
from _torch_monitor_common import FakeClock, JM, TM, reset_both, set_monitor
from paddle_tpu.core import flags as JF
from paddle_tpu.distributed.checkpoint import CheckpointManager as JCM
from paddle_tpu.models import llama as JL
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.training import sentinel as JS
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager as TCM
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.training import sentinel as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, V = 2, 16, 64


@pytest.fixture(autouse=True)
def _clean():
    yield
    for f in (jfaults, tfaults):
        f.clear()
    for F in (JF, TF):
        F.set_flags({"enable_sentinel": False, "enable_monitor": False})
    reset_both()


def _batch(i, poison=()):
    r = np.random.RandomState(1000 + i)
    ids = r.randint(0, V, size=(B, T + 1)).astype(np.int32)
    if i in poison:
        ids[0, 0] = np.iinfo(np.int32).min
    return ids[:, :-1], ids[:, 1:]


def _stream(poison=(), n=1000):
    return lambda: (_batch(i, poison) for i in range(n))


class _Manager:
    """A stand-in manager: enables ROLLBACK, restores nothing."""

    def restore_latest(self, state):
        return None


# -- AnomalySentinel ----------------------------------------------------------

OBSERVED = ([(True, 1.0 + 0.1 * i, 2.0) for i in range(6)]
            + [(False, 40.0, 2.0),              # a spike the gate held
               (True, 1.2, 1.9),
               (False, float("nan"), float("nan")),
               (False, float("inf"), 3.0),
               (True, 1.1, 1.8)])


def test_observe_sequence_matches_the_reference():
    set_monitor(True)
    out = {}
    for side, S in (("jax", JS), ("torch", TS)):
        reset_both()
        set_monitor(True)
        sent = S.AnomalySentinel(S.SentinelConfig(
            warmup_steps=3, max_consecutive=2, agree=False),
            manager=_Manager())
        rows = []
        for i, (fin, g, loss) in enumerate(OBSERVED):
            v = sent.observe(finite=fin, grad_norm=g, loss=loss,
                             batch=_batch(i))
            rows.append((v, sent.gnorm_cap(), sent.stats.n,
                         sent.stats.mean, sent.stats.std, sent.consecutive,
                         sent.anomalies))
        rolled = sent.rollback({})
        M = JM if side == "jax" else TM
        snap = M.snapshot()
        metrics = {k: {n: v for n, v in snap[k].items()
                       if n.startswith("train.anomaly")}
                   for k in ("counters", "gauges")}
        out[side] = (rows, rolled, sent.consecutive, sent.rollbacks,
                     sorted(sent.quarantine), metrics,
                     [e["name"] for e in M.trace.events()])
    assert out["torch"] == out["jax"]
    rows = out["torch"][0]
    assert [r[0] for r in rows] == ["ok"] * 6 + ["skip", "ok", "skip",
                                                  "rollback", "ok"]
    assert math.isinf(rows[1][1]) and math.isfinite(rows[6][1])


def test_max_rollbacks_and_quarantine_match_the_reference():
    for S in (JS, TS):
        sent = S.AnomalySentinel(S.SentinelConfig(max_rollbacks=1),
                                 manager=None)
        assert sent.observe(finite=False, grad_norm=1.0) == S.SKIP
        assert sent.rollback({}) is None           # no manager
        sent.rollbacks = 1
        with pytest.raises(RuntimeError, match="max_rollbacks"):
            sent.rollback({})
        b = _batch(3)
        assert not sent.is_quarantined(b)
        sent.observe(finite=False, grad_norm=1.0, batch=b)
        assert sent.is_quarantined(b) and not sent.is_quarantined(_batch(4))


def test_batch_hash_matches_the_reference_where_dtypes_agree():
    inp, lab = _batch(0)
    cases = [
        ((inp, lab), (torch.from_numpy(inp), torch.from_numpy(lab))),
        ({"labels": lab, "inp": inp}, {"inp": torch.from_numpy(inp),
                                        "labels": torch.from_numpy(lab)}),
        ((jnp.asarray(inp), None), (torch.from_numpy(inp), None)),
    ]
    for j, t in cases:
        assert TS.batch_hash(t) == JS.batch_hash(j)
    bf = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    assert TS.batch_hash(torch.from_numpy(bf).to(torch.bfloat16)) == \
        JS.batch_hash(jnp.asarray(bf, jnp.bfloat16))
    # the port's int64 ids are another dtype: another hash
    assert TS.batch_hash(torch.from_numpy(inp.astype(np.int64))) != \
        JS.batch_hash(jnp.asarray(inp))
    s = TS.fast_forward(_stream()(), 3)
    np.testing.assert_array_equal(next(s)[0], _batch(3)[0])


# -- SentinelLoop -------------------------------------------------------------

def _loop(S, step, params, opt, faults, root, poison):
    mgr = (JCM if S is JS else TCM)(root, save_interval_steps=2,
                                    async_save=False)
    sent = S.AnomalySentinel(S.SentinelConfig(
        agree=False, max_consecutive=2, warmup_steps=100), manager=mgr)
    seen = []
    observe = sent.observe

    def recorded(**kw):
        v = observe(**kw)
        seen.append((v, float(kw["loss"])))
        return v

    sent.observe = recorded
    faults.inject("train.batch", "corrupt", nth=3)
    loop = S.SentinelLoop(step, params, opt, _stream(poison), sentinel=sent,
                          manager=mgr)
    return loop, seen


def _rel(a, b):
    """Relative L2 distance: Adam divides each gradient by its own size
    plus 1e-8, so an entry whose gradient is near eps moves by a few
    percent of ``lr`` on summation-order noise; the norm holds the leaf
    (as ``tests/test_torch_eager_llama.py`` holds its parameters)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_sentinel_loop_matches_the_reference(tmp_path):
    """Faults corrupt the third batch (SKIP); batches 5 and 6 are
    poisoned in the data (ROLLBACK to step 4, then their replays are
    skipped by hash)."""
    cfg = JL.llama_tiny(vocab_size=V)
    jp = JL.init_params(cfg, jax.random.PRNGKey(0))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    poison = {5, 6}
    jl, jseen = _loop(JS, JL.make_train_step(cfg, guard=True, donate=False),
                      jp, JL.adamw_init(jp), jfaults, str(tmp_path / "j"),
                      poison)
    tl, tseen = _loop(TS, TL.make_train_step(TL.llama_tiny(vocab_size=V),
                                             guard=True),
                      tp, TL.adamw_init(tp), tfaults, str(tmp_path / "t"),
                      poison)
    jout, tout = jl.run(10), tl.run(10)
    assert [v for v, _ in tseen] == [v for v, _ in jseen]
    assert [v for v, _ in tseen] == ["ok", "ok", "skip", "ok", "ok", "skip",
                                     "rollback", "ok", "ok", "ok", "ok"]
    assert {k: tout[k] for k in tout if k != "last_loss"} == \
        {k: jout[k] for k in jout if k != "last_loss"} == {
            "steps": 10, "applied": 8, "skipped": 5, "rollbacks": 1,
            "quarantined": 3}
    for (tv, tloss), (_, jloss) in zip(tseen, jseen):
        if tv == "ok":
            assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert abs(tout["last_loss"] - jout["last_loss"]) <= \
        1e-5 * abs(jout["last_loss"])
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jl.params))[0]
    for path, w in want:
        got = tl.params
        for k in path:
            got = got[k.key]
        assert _rel(got.detach().numpy(), w) <= 1e-5, path
    # the restored step 4 had applied 3 updates (step 3 was skipped)
    assert tl.opt_state["step"] == int(jl.opt_state["step"]) == 7


class _Loader:
    """A duck-typed loader: iterates the canonical stream from its cursor,
    which ``state_dict`` / ``set_state_dict`` carry."""

    def __init__(self, poison=()):
        self.cursor = 0
        self.poison = poison

    def __iter__(self):
        while True:
            i = self.cursor
            self.cursor += 1
            yield _batch(i, self.poison)

    def state_dict(self):
        return {"cursor": self.cursor}

    def set_state_dict(self, state):
        self.cursor = int(state["cursor"])


def test_dataloader_state_rides_the_checkpoint(tmp_path):
    """With ``dataloader=``, the loader's state rides every checkpoint,
    a rollback re-seats it at the restored step's batch, and a fresh
    loop's ``restore_latest`` resumes it, as the reference's."""
    cfg = JL.llama_tiny(vocab_size=V)
    jp = JL.init_params(cfg, jax.random.PRNGKey(1))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    out = {}
    for side, S, Mgr, step, params, opt in (
            ("jax", JS, JCM, JL.make_train_step(cfg, guard=True,
                                                donate=False),
             jp, JL.adamw_init(jp)),
            ("torch", TS, TCM, TL.make_train_step(
                TL.llama_tiny(vocab_size=V), guard=True),
             tp, TL.adamw_init(tp))):
        root = str(tmp_path / side)
        loader = _Loader(poison={3, 4})
        mgr = Mgr(root, save_interval_steps=2, async_save=False)
        sent = S.AnomalySentinel(S.SentinelConfig(
            agree=False, max_consecutive=2, warmup_steps=100))
        loop = S.SentinelLoop(step, params, opt, sentinel=sent, manager=mgr,
                              dataloader=loader)
        res = loop.run(6)
        res.pop("last_loss")
        fresh = _Loader()
        resumed = S.SentinelLoop(step, params, opt, manager=Mgr(root),
                                 dataloader=fresh).restore_latest()
        out[side] = (res, loader.cursor, resumed, fresh.cursor)
    assert out["torch"] == out["jax"]
    # the rollback re-seated the loader at step 2's batch; step 6 saved
    # cursor 6, which the fresh loop's loader resumes from
    assert out["torch"][0]["rollbacks"] == 1
    assert out["torch"][1:] == (6, 6, 6)


def _offering_loop(root):
    """A port loop whose manager saves every 4 steps, run 5: its newest
    offer (step 5) is past the last save."""
    cfg = TL.llama_tiny(vocab_size=V)
    params = TL.init_params(cfg, seed=0, device="cpu")
    mgr = TCM(root, save_interval_steps=4, async_save=False)
    loop = TS.SentinelLoop(
        TL.make_train_step(cfg, guard=True), params, TL.adamw_init(params),
        _stream(), sentinel=TS.AnomalySentinel(TS.SentinelConfig(
            agree=False)), manager=mgr)
    loop.run(5)
    assert mgr.latest_step() == 4 and mgr._last_seen[0] == 5
    return loop, mgr


def test_dropped_loop_frees_its_state_without_close(tmp_path):
    """The manager keeps the newest offer for an emergency save. The
    offer reaches the loop through a weakref, so a dropped loop frees its
    parameters and moments at once (no garbage collection, no
    ``close()``), and a later preemption has nothing to save; a live
    loop's offer is still saved."""
    loop, mgr = _offering_loop(str(tmp_path / "dropped"))
    probes = [weakref.ref(t) for t in (
        loop.params["embed"], loop.opt_state["m"]["embed"])]
    gc.disable()
    try:
        del loop
        assert [p() for p in probes] == [None, None]
    finally:
        gc.enable()
    mgr.finalize_on_preemption()
    assert mgr.latest_step() == 4
    live, mgr = _offering_loop(str(tmp_path / "live"))
    mgr.finalize_on_preemption()
    assert mgr.latest_step() == 5
    state = live._state()
    assert mgr.restore_latest(state) == 5 and state["step"] == 5


# -- HangWatchdog -------------------------------------------------------------

def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)


def test_watchdog_stall_dump_rearm_and_health(tmp_path):
    sp = str(tmp_path / "stall.json")
    wd = TS.HangWatchdog(0.2, poll_s=0.02, stall_path=sp)
    with wd:
        key = wd._provider_key
        ok, payload = TM.server.health()
        assert payload["providers"][key]["ok"]
        _wait(lambda: wd.stalls == 1)
        assert wd.stalls == 1
        ok, payload = TM.server.health()
        assert not ok and not payload["providers"][key]["ok"]
        wd.heartbeat()                       # the loop recovered
        _wait(lambda: wd.stalls == 2)
    assert wd.stalls == 2 and key not in TM.server.health()[1]["providers"]
    payload = json.load(open(sp))
    assert payload["kind"] == "paddle_tpu.watchdog_stall"
    assert payload["heartbeat_age_s"] > 0.2
    assert any("MainThread" in k for k in payload["threads"])
    assert all(isinstance(v, list) and v for v in payload["threads"].values())
    fr = json.load(open(sp + ".flight.json"))
    assert fr["kind"] == "paddle_tpu.flight_record"
    assert fr["reason"] == "watchdog.stall"
    with pytest.raises(ValueError):
        TS.HangWatchdog(0.0)


def test_steptimer_end_step_feeds_the_watchdog():
    wd = TS.HangWatchdog(60.0, poll_s=0.05)
    with wd:
        before = wd._last
        time.sleep(0.01)
        TM.StepTimer("wd").end_step()            # monitor off
        assert wd._last > before
    from paddle_tpu_torch.monitor import steptimer
    assert wd.heartbeat not in steptimer._STEP_LISTENERS


def test_exit_on_stall_leaves_forensics(tmp_path):
    sp = str(tmp_path / "stall.json")
    code = (
        "import time\n"
        "from paddle_tpu_torch.core import flags\n"
        "from paddle_tpu_torch.monitor import trace\n"
        "from paddle_tpu_torch.training.sentinel import HangWatchdog\n"
        "flags.set_flags({'FLAGS_enable_monitor': True})\n"
        "trace.instant('about.to.wedge', step=7)\n"
        f"HangWatchdog(0.3, poll_s=0.05, stall_path={sp!r},\n"
        "             exit_on_stall=True, exit_code=42).start()\n"
        "time.sleep(120)\n"
        "raise SystemExit('the watchdog did not fire')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO,
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 42, (r.returncode, r.stderr[-2000:])
    assert "watchdog stall" in r.stderr
    assert json.load(open(sp))["threads"]
    fr = json.load(open(sp + ".flight.json"))
    assert any(e["name"] == "about.to.wedge" for e in fr["events"])


# -- the eager guard ----------------------------------------------------------

# (losses of the micro-batch, update?) of an eager loop with
# accumulation windows of 2; NaN in a window poisons its update
EAGER = [([2.0], True), ([float("nan")], True), ([1.9], False),
         ([float("nan")], False), ([1.8], True), ([1.7], True),
         ([float("inf"), 1.0], True), ([1.6], True)]


class _Owner:
    pass


def test_guard_eager_update_matches_the_reference():
    out = {}
    for side, S, F in (("jax", JS, JF), ("torch", TS, TF)):
        reset_both()
        F.set_flags({"enable_sentinel": True, "enable_monitor": True})
        owner = _Owner()
        decisions = [S.guard_eager_update(owner, losses, update=up)
                     for losses, up in EAGER]
        M = JM if side == "jax" else TM
        out[side] = (decisions, owner._anomaly_sentinel.anomalies,
                     M.snapshot()["counters"])
        F.set_flags({"enable_sentinel": False})
        assert not S.guard_eager_update(_Owner(), [float("nan")])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [False, True, True, True, True, False, True,
                               False]


def test_eager_llama_skips_a_nan_step(tmp_path):
    """The port's eager ``LlamaForCausalLM`` loop under the guard: a
    step whose loss is NaN leaves every parameter as it was."""
    import paddle_tpu_torch as tpaddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import device as TD
    from paddle_tpu_torch import optimizer as topt
    prev = TD._current_device
    tpaddle.set_device("cpu")
    TF.set_flags({"enable_sentinel": True})
    try:
        model = TL.LlamaForCausalLM(TL.llama_tiny(num_hidden_layers=1))
        opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())
        applied = []
        for i, scale in enumerate((1.0, float("nan"), 1.0)):
            inp, lab = _batch(i)
            before = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
            loss = F.cross_entropy(
                model(tpaddle.to_tensor(inp)).reshape([-1, 256]),
                tpaddle.to_tensor(lab.astype(np.int64)).reshape([-1])) \
                * scale
            loss.backward()
            if TS.guard_eager_update(model, [loss.detach()]):
                opt.clear_grad()
                same = all(torch.equal(before[k], v)
                           for k, v in model.state_dict().items())
                applied.append(("skip", same))
            else:
                opt.step()
                opt.clear_grad()
                applied.append(("step", None))
    finally:
        TF.set_flags({"enable_sentinel": False})
        TD._current_device = prev
    assert applied == [("step", None), ("skip", True), ("step", None)]
    assert model._anomaly_sentinel.anomalies == 1


# -- skip agreement over 2 gloo ranks -----------------------------------------

@pytest.fixture(scope="module")
def agreed(tmp_path_factory):
    return launched(tmp_path_factory, "sentinel", 2, ["sentinel_agree"],
                    lambda tmp: None)


def test_skip_agreement_over_two_ranks(agreed):
    got = [load_json(agreed / f"out_sentinel_agree_r{r}.json")
           for r in range(2)]
    assert got[0] == got[1]
    assert got[0]["verdicts"] == ["skip", "ok", "ok"]
    # the reference's sentinel fed what the gather agrees on: rank 0's
    # anomaly, then the max norm
    sent = JS.AnomalySentinel(JS.SentinelConfig(warmup_steps=1,
                                                agree=False))
    for fin, g in ((False, float("nan")), (True, 2.0), (True, 2.0)):
        sent.observe(finite=fin, grad_norm=g)
    assert (got[0]["n"], got[0]["mean"], got[0]["cap"],
            got[0]["consecutive"]) == (sent.stats.n, sent.stats.mean,
                                       sent.gnorm_cap(), sent.consecutive)


# -- the numerics plane's step half -------------------------------------------

def _stats_block(seed, spike=None):
    """A ``health["numerics"]`` block of llama_tiny's shapes from a seed:
    ``{"layers": {name: {stat: [L]}}, "tensors": {name: {stat: ()}}}``."""
    from paddle_tpu_torch.training.guards import NUMERIC_STATS
    rng = np.random.default_rng(seed)

    def stats(shape):
        out = {s: rng.uniform(0.01, 1.0, shape).astype(np.float32)
               for s in NUMERIC_STATS}
        return out
    block = {"layers": {n: stats((2,)) for n in ("wq", "wo", "down")},
             "tensors": {n: stats(()) for n in ("embed", "ln_f")}}
    if spike:
        block["layers"]["wo"]["gnorm_sq"][1] = spike
        block["layers"]["wo"]["absmax"][1] = 50.0
    return block


def test_record_step_stats_matches_the_reference(monkeypatch):
    clock = FakeClock()
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(
            f"{pkg}.monitor.numerics"), "time", clock)
    out = {}
    for side, M in (("jax", JM), ("torch", TM)):
        reset_both()
        set_monitor(True)
        clock.now = 1000.0
        worst = []
        for step, spike in ((1, None), (2, None), (3, 400.0),
                            (4, float("nan"))):
            block = _stats_block(step, spike)
            if side == "jax":
                block = jax.tree.map(jnp.asarray, block)
            else:
                block = jax.tree.map(torch.from_numpy, block)
            worst.append(M.numerics.record_step_stats(block, step=step))
            clock.advance(1.0)
        out[side] = (worst, M.numerics.worst_layer(),
                     M.numerics.top_movers(3), M.numerics.latest(),
                     M.numerics.numerics_snapshot(2),
                     {k: v for k, v in M.snapshot()["gauges"].items()
                      if k.startswith("numerics.")})
    assert json.dumps(out["torch"], sort_keys=True, default=str) == \
        json.dumps(out["jax"], sort_keys=True, default=str)
    worst = out["torch"][0]
    assert worst[2]["name"] == "layers.wo[1]" and worst[2]["finite"]
    assert worst[3]["name"] == "layers.wo[1]" and not worst[3]["finite"]


def test_quantization_audit_matches_the_reference():
    jcfg = JL.llama_tiny(num_hidden_layers=1)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(2))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    set_monitor(True)
    reports = {}
    for side, M, L, p, dt in (("jax", JM, JL, jp, jnp.bfloat16),
                              ("torch", TM, TL, tp, torch.bfloat16)):
        for wdt in ("int8", "int4"):
            rep = M.numerics.audit_quantized_tree(
                p, L.quantize_weights(p, weight_dtype=wdt),
                serving_dtype=dt)
            rep.pop("unix_time")
            assert M.numerics.last_audit()["tensors"] == rep["tensors"]
            reports[side, wdt] = rep
    for wdt in ("int8", "int4"):
        assert reports["torch", wdt] == reports["jax", wdt]
    assert reports["torch", "int4"]["int4_min_sqnr_db"] is not None
    assert reports["torch", "int8"]["serving_dtype"] == "bfloat16"
    q = np.arange(-6, 6, dtype=np.int8).reshape(3, 4)
    s = np.array([0.5, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(
        TM.numerics.dequant_ref(torch.from_numpy(q), torch.from_numpy(s)),
        JM.numerics.dequant_ref(q, s))
    assert TM.numerics.sqnr_db(torch.ones(3), torch.ones(3)) == math.inf
