"""Port parity: the flags registry (``paddle_tpu_torch/core/flags.py``, a
copy of ``paddle_tpu/core/flags.py``) and the options that read it.

- Registry semantics: ``get_flags`` / ``set_flags`` with or without the
  ``FLAGS_`` prefix, strings parsed by the flag's type, unknown names
  refused; ``FLAGS_<name>`` in the environment overrides a default when
  the flag is defined.
- Every flag the port defines has the JAX registry's name, default and
  doc (``PORT_DOCS``: a doc of its own, naming the port's knobs), and the
  port defines exactly the ones it reads.
- ``set_flags`` reaches ``make_train_step``'s guard and numerics
  defaults and ``ServingEngine``'s ``kv_quant``, ``prefix_cache``,
  ``spec_decode``, ``priority_admission``, ``tenant_inflight_cap``,
  ``slo_preemption``, ``max_queue``, ``shed_on_burn`` and ``failover``;
  ``FLAGS_enable_monitor_server`` makes engine construction start the
  operator HTTP server on ``FLAGS_monitor_server_port``, and
  ``FLAGS_serving_fleet_burn_scaling`` is the elastic serving
  controller's burn actuation.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu.core import flags as JF
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import moe as TM

PORTED = ("enable_sentinel", "enable_numerics", "fault_injection",
          "enable_monitor", "enable_monitor_server", "monitor_server_port",
          "serving_fleet_burn_scaling", "use_autotune", "check_nan_inf")
# flags whose doc names the port's own knobs: use_autotune tunes the KV
# page size and the cross-entropy chunk here, Pallas block sizes there
PORT_DOCS = ("use_autotune",)
# the operator and fleet planes' flags, read outside the engine's options
PLANE_FLAGS = ("serving_fleet_burn_scaling", "enable_monitor_server")
# each ported serving option's flag and how the engine shows it is on
ENGINE_OPTIONS = {
    "serving_prefix_cache": lambda e: e._prefix is not None,
    "serving_spec_decode": lambda e: e._spec_decode,
    "serving_priority_admission": lambda e: e._priority_admission,
    "serving_tenant_inflight_cap": lambda e: e._tenant_cap == 4,
    "serving_slo_preemption": lambda e: e._slo_preemption,
    "serving_max_queue": lambda e: e._max_queue == 4,
    "serving_shed_on_burn": lambda e: e._shed_on_burn,
    "serving_failover": lambda e: e._failover,
}


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {k: v.value for k, v in TF._REGISTRY.items()}
    yield
    for k, v in saved.items():
        TF._REGISTRY[k].value = v


def test_registry_get_set_semantics():
    assert paddle_tpu_torch.get_flags is TF.get_flags
    assert paddle_tpu_torch.set_flags is TF.set_flags
    assert TF.get_flags("FLAGS_enable_sentinel") == {
        "FLAGS_enable_sentinel": False}
    assert TF.get_flags(["enable_numerics", "FLAGS_serving_max_queue"]) == {
        "enable_numerics": False, "FLAGS_serving_max_queue": 0}
    TF.set_flags({"enable_sentinel": True, "FLAGS_serving_max_queue": "7"})
    assert TF.flag_value("enable_sentinel") is True
    assert TF.flag_value("serving_max_queue") == 7            # parsed
    TF.set_flags({"FLAGS_enable_sentinel": "off"})
    assert TF.flag_value("enable_sentinel") is False
    info = TF.flag_info("enable_numerics")
    TF.set_flags({"FLAGS_enable_numerics": True})
    assert info.value is True                # the live record, in place
    with pytest.raises(TE.InvalidArgumentError):
        TF.get_flags("FLAGS_use_pallas_kernels")
    with pytest.raises(TE.InvalidArgumentError):
        TF.set_flags({"FLAGS_no_such_flag": 1})


def test_environment_overrides_at_definition(monkeypatch):
    monkeypatch.setenv("FLAGS_port_test_flag", "12")
    try:
        TF.define_flag("port_test_flag", 3, "a test flag")
        assert TF.flag_value("port_test_flag") == 12
        assert TF.flag_info("port_test_flag").default == 3
    finally:
        del TF._REGISTRY["port_test_flag"]
    code = ("import paddle_tpu_torch as p; "
            "print(p.get_flags(['FLAGS_enable_sentinel', "
            "'FLAGS_serving_kv_quant']))")
    env = dict(os.environ, FLAGS_enable_sentinel="1",
               FLAGS_serving_kv_quant="yes")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert "'FLAGS_enable_sentinel': True" in out.stdout
    assert "'FLAGS_serving_kv_quant': True" in out.stdout


def test_each_flag_matches_the_jax_registry():
    want = set(PORTED) | {k for k in JF._REGISTRY if k.startswith("serving_")}
    assert set(TF._REGISTRY) == want
    for name, info in TF._REGISTRY.items():
        ref = JF._REGISTRY[name]
        assert info.default == ref.default, name
        assert (info.doc == ref.doc) != (name in PORT_DOCS), name
        assert type(info.default) is type(ref.default), name


def _batch(cfg, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 9)))


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_set_flags_reaches_the_train_step(family):
    mod = {"llama": TL, "moe": TM}[family]
    cfg = TL.llama_tiny() if family == "llama" else TM.moe_tiny()
    params = mod.init_params(cfg, device="cpu")
    state = mod.adamw_init(params)
    out = mod.make_train_step(cfg)(params, state, _batch(cfg))
    assert len(out) == 3                        # flags off: unguarded
    paddle_tpu_torch.set_flags({"FLAGS_enable_sentinel": True})
    step = mod.make_train_step(cfg)
    out = step(params, state, _batch(cfg), float("inf"))
    assert len(out) == 4 and set(out[3]) == {"finite", "grad_norm"}
    paddle_tpu_torch.set_flags({"FLAGS_enable_numerics": True})
    out = mod.make_train_step(cfg)(params, state, _batch(cfg), float("inf"))
    assert set(out[3]) == {"finite", "grad_norm", "numerics"}
    # an explicit argument wins over the flag
    assert len(mod.make_train_step(cfg, guard=False)(
        params, state, _batch(cfg))) == 3
    out = mod.make_train_step(cfg, numerics=False)(
        params, state, _batch(cfg), float("inf"))
    assert "numerics" not in out[3]


def test_set_flags_reaches_the_engine_kv_quant():
    cfg = TL.llama_tiny()
    params = TL.init_params(cfg, device="cpu")
    assert not ServingEngine(TL, params, cfg, device="cpu").kv_quant
    paddle_tpu_torch.set_flags({"FLAGS_serving_kv_quant": True})
    eng = ServingEngine(TL, params, cfg, device="cpu")
    assert eng.kv_quant and isinstance(eng.cache.pool["k"], dict)
    assert not ServingEngine(TL, params, cfg, device="cpu",
                             kv_quant=False).kv_quant


@pytest.mark.parametrize("flag", sorted(ENGINE_OPTIONS))
def test_set_flags_reaches_the_engine_options(flag):
    """Each ported option's flag is its constructor default, as
    ``kv_quant``'s; an explicit argument wins over it."""
    cfg = TL.llama_tiny()
    params = TL.init_params(cfg, device="cpu")
    is_on = ENGINE_OPTIONS[flag]
    assert not is_on(ServingEngine(TL, params, cfg, device="cpu"))
    on = True if isinstance(TF._REGISTRY[flag].default, bool) else 4
    paddle_tpu_torch.set_flags({f"FLAGS_{flag}": on})
    assert is_on(ServingEngine(TL, params, cfg, device="cpu"))
    off = {flag.removeprefix("serving_"): 0 if on == 4 else False}
    assert not is_on(ServingEngine(TL, params, cfg, device="cpu", **off))


def _burning_controller(d, burn_scaling=None):
    """``run_serving`` over one fake replica whose published frame burns
    its latency budget at flat demand: with burn scaling on, one replica
    of scale-out pressure."""
    from paddle_tpu_torch.distributed import heartbeat as HB
    from paddle_tpu_torch.distributed.fleet import elastic as EL

    class Replica:
        def autoscale_payload(self):
            return {"demand_estimate": 0.0, "drain_safe": True}

    def publish(t, live):
        HB.publish_named("replica0", {
            "kind": "paddle_tpu.slo_frame", "version": 1,
            "name": "replica0", "seq": t,
            "autoscale": {"demand_estimate": 0.2, "drain_safe": True},
            "slo": {"objectives": {"ttft_p99_ms": {
                "compliance": 0.5, "burn_fast": 30.0, "burn_slow": 30.0,
                "samples_slow": 64, "samples_fast": 64}}}}, dir_path=d)

    mgr = EL.AdaptiveElasticManager()
    out = mgr.run_serving(lambda n: Replica(), lambda n, h: None,
                          min_replicas=1, max_replicas=3, heartbeat_dir=d,
                          poll_interval=0.0001, max_ticks=5,
                          on_tick=publish,
                          fleet_burn_scaling=burn_scaling)
    return [e[2].get("reason") for e in mgr.events], out["replicas"]


@pytest.mark.parametrize("flag", PLANE_FLAGS)
def test_operator_and_fleet_flags_reach_their_planes(flag, tmp_path):
    """``FLAGS_enable_monitor_server`` makes ``ServingEngine`` start the
    operator HTTP server on ``FLAGS_monitor_server_port`` (port 0:
    ephemeral), and with the flag off none starts;
    ``FLAGS_serving_fleet_burn_scaling`` is the default of the elastic
    controller's burn actuation (an explicit argument wins)."""
    from paddle_tpu_torch.monitor import federation as FED
    from paddle_tpu_torch.monitor import server as S
    S.stop_server()
    try:
        if flag == "enable_monitor_server":
            cfg = TL.llama_tiny()
            params = TL.init_params(cfg, device="cpu")
            ServingEngine(TL, params, cfg, device="cpu")
            assert S.get_server() is None
            paddle_tpu_torch.set_flags({"FLAGS_enable_monitor_server": True,
                                        "FLAGS_monitor_server_port": 0})
            eng = ServingEngine(TL, params, cfg, device="cpu")
            srv = S.get_server()
            assert srv is not None and srv.port > 0
            assert S.bound_port() == srv.port
            import json
            import urllib.request
            with urllib.request.urlopen(srv.url + "/healthz",
                                        timeout=30) as r:
                providers = json.loads(r.read())["providers"]
            assert f"serving:{eng._engine_uid}" in providers
        else:
            d = str(tmp_path)
            reasons, replicas = _burning_controller(d)
            assert "burn-pressure" not in reasons and replicas == [
                "replica0"]
            paddle_tpu_torch.set_flags({f"FLAGS_{flag}": True})
            reasons, replicas = _burning_controller(d)
            assert "burn-pressure" in reasons
            assert replicas == ["replica0", "replica1"]
            reasons, _ = _burning_controller(d, burn_scaling=False)
            assert "burn-pressure" not in reasons
            # the engine builds with the flag on: it is the controller's
            cfg = TL.llama_tiny()
            ServingEngine(TL, TL.init_params(cfg, device="cpu"), cfg,
                          device="cpu")
    finally:
        S.stop_server()
        FED.reset()
