"""Port parity: the MoE family (``paddle_tpu_torch/models/moe.py``)
against ``paddle_tpu/models/moe.py`` on ``moe_tiny`` (4 experts, top 2,
a shared expert) with the JAX weights carried over, on the CPU.

Tolerances, float32: logits, aux and losses within ``1e-5`` (``rtol``;
summation order only), every gradient within ``rtol=1e-5, atol=1e-6``
(the llama family's); 3 train steps as ``tests/test_torch_train.py``
holds them. Greedy and beam tokens, and the serving engine's tokens, are
equal exactly. Routing is discrete, so these parities hold only while
no router probability of the two sides falls on the other side of a tie;
the inputs are random and float32 makes that a non-event.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import moe as JM
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import moe as TM


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def _jnamed(tree):
    return {jtu.keystr(p): np.asarray(v)
            for p, v in jtu.tree_flatten_with_path(tree)[0]}


def _setup(seed=1, **kw):
    jcfg = JM.moe_tiny(**kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TM.moe_tiny(**kw), tp


def _ids(shape, seed=2):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@pytest.fixture
def routed(monkeypatch):
    """Records ``(T, topi)`` of every routing call of the port."""
    calls = []
    route = TM._route

    def recording(x, lp, config):
        out = route(x, lp, config)
        calls.append((x.shape[0], out[1]))
        return out

    monkeypatch.setattr(TM, "_route", recording)
    return calls


def _drops(cfg, calls, n_tokens=None):
    """Slots that capacity dispatch dropped over the recorded calls (those
    of ``n_tokens`` tokens only, if given)."""
    total = 0
    for T, topi in calls:
        if n_tokens is None or T == n_tokens:
            counts = torch.bincount(topi.reshape(-1),
                                    minlength=cfg.num_experts)
            total += int((counts - TM.moe_capacity(cfg, T)).clamp(
                min=0).sum())
    return total


@pytest.mark.parametrize("mode,factor", [("dense", 1.25),
                                         ("capacity", 1.25),
                                         ("capacity", 0.3)])
def test_forward_logits_and_aux_match_jax(mode, factor, routed):
    """``capacity_factor`` 0.3 gives 8 slots an expert for 32 tokens x 2
    choices: slots drop, and the dropped tokens keep only their shared
    expert, as in the reference."""
    jcfg, jp, cfg, tp = _setup(dispatch_mode=mode, capacity_factor=factor)
    ids = _ids((2, 16))
    wl, wa = JM.forward(jp, jnp.asarray(ids), jcfg)
    gl, ga = TM.forward(tp, torch.as_tensor(ids), cfg)
    assert gl.dtype == torch.float32 and tuple(gl.shape) == (2, 16, 256)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-5)
    if factor < 1:
        assert TM.moe_capacity(cfg, 32) == 8
        assert _drops(cfg, routed) > 0


def test_capacity_dispatch_ties_and_slot_order_match_jax():
    """Equal router logits (a zero router): every token picks experts 0
    and 1 (``lax.top_k``'s index order), so expert 0's buffer fills in
    token order and every later slot drops."""
    jcfg, jp, cfg, tp = _setup(dispatch_mode="capacity", capacity_factor=0.5)
    jp["layers"]["router"] = jnp.zeros_like(jp["layers"]["router"])
    tp["layers"]["router"].zero_()
    ids = _ids((1, 24), seed=3)
    x = tp["embed"][torch.as_tensor(ids)][0]
    topv, topi, _ = TM._route(x, TL.layer(tp, 0), cfg)
    assert (topi == torch.tensor([0, 1])).all()
    torch.testing.assert_close(topv, torch.full_like(topv, 0.5))
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    wr, wa = JM._moe_mlp_capacity(jnp.asarray(x.numpy()), jlp, jcfg, 24)
    gr, ga = TM._moe_mlp_capacity(x, TL.layer(tp, 0), cfg)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-6)
    C = TM.moe_capacity(cfg, 24)
    assert C == 8                                  # 16 of 24 tokens drop
    assert (gr[C:] == 0).all() and (gr[:C] != 0).any()


@pytest.mark.parametrize("mode", ["dense", "capacity"])
@pytest.mark.parametrize("fused_ce", [True, False])
def test_loss_and_every_grad_match_jax(mode, fused_ce):
    jcfg, jp, cfg, tp = _setup(dispatch_mode=mode, fused_ce=fused_ce)
    ids = _ids((2, 13))
    want_loss, want_g = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jnp.asarray(ids), jcfg))(jp)
    TK.reset_dispatch_stats()
    loss, grads = TM.loss_and_grads(tp, ids, cfg)
    stats = TK.dispatch_stats()
    assert stats["fused_ce"] == int(fused_ce)
    assert stats["flash_bwd_ref"] == cfg.num_hidden_layers
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_g, grads = _jnamed(want_g), _named(grads)
    assert grads.keys() == want_g.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_remat_policies_give_the_same_grads():
    """Remat ``"full"`` and ``"dots"`` against no remat, capacity
    dispatch. ``"dots"`` keeps the outputs of ``aten.mm`` / ``addmm``
    only: the expert products are ``bmm``, which it recomputes, as the
    reference's ``dots_with_no_batch_dims_saveable`` does."""
    policy = TL.remat_policy("dots")
    assert torch.ops.aten.bmm.default not in policy.args[0]
    assert torch.ops.aten.mm.default in policy.args[0]
    ids = _ids((2, 11), seed=4)
    results = {}
    for remat, name in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = TM.moe_tiny(dispatch_mode="capacity", remat=remat,
                          remat_policy=name)
        tp = TM.init_params(cfg, seed=3, device="cpu")
        TK.reset_dispatch_stats()
        loss, grads = TM.loss_and_grads(tp, ids, cfg)
        assert TK.dispatch_stats()["flash_ref"] == \
            (2 if remat else 1) * cfg.num_hidden_layers
        results[(remat, name)] = (float(loss), _named(grads))
    base_loss, base_g = results[(False, "full")]
    for loss, grads in results.values():
        assert loss == pytest.approx(base_loss, rel=1e-6)
        for name, g in grads.items():
            torch.testing.assert_close(g, base_g[name], rtol=1e-5, atol=1e-7)


def test_packed_batch_loss_and_grads_match_jax():
    """Two documents a row (segment ids, segment-local positions,
    ``-100`` at each document's last label): the segment attention path
    and per-document rope, as in the llama family."""
    jcfg, jp, cfg, tp = _setup(dispatch_mode="capacity")
    ids = _ids((2, 17), seed=5)
    inp, labels = ids[:, :-1], ids[:, 1:].copy()
    seg = np.repeat(np.array([[0] * 7 + [1] * 9]), 2, 0).astype(np.int32)
    pos = np.concatenate([np.arange(7), np.arange(9)])[None].repeat(2, 0)
    pos = pos.astype(np.int32)
    labels[:, 6] = -100
    batch = (inp, labels, seg, pos)
    want_loss, want_g = jax.value_and_grad(lambda p: JM.loss_fn(
        p, tuple(jnp.asarray(a) for a in batch), jcfg))(jp)
    TK.reset_dispatch_stats()
    loss, grads = TM.loss_and_grads(tp, batch, cfg)
    assert TK.dispatch_stats()["varlen_ref"] == cfg.num_hidden_layers
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_g = _jnamed(want_g)
    for name, g in _named(grads).items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_three_train_steps_match_reference():
    jcfg, jp, cfg, tp = _setup(seed=5, dispatch_mode="capacity")
    batch = _ids((2, 13), seed=6)
    jstep = JM.make_train_step(jcfg, donate=False)
    jstate = JM.adamw_init(jp)
    tstate = TM.adamw_init(tp)
    assert all(m.dtype == torch.float32 for m in TL._leaves(tstate["m"]))
    tstep = TM.make_train_step(cfg)
    _, g1 = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jnp.asarray(batch), jcfg))(jp)
    g1 = _jnamed(g1)
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(batch))
        tp2, tstate, tloss = tstep(tp, tstate, batch)
        assert tp2 is tp
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert tstate["step"] == 3
    want, noisy, total = _jnamed(jp), 0, 0
    lr = 1e-4                                # the MoE step's default
    for name, t in _named(tp).items():
        g = np.abs(g1[name])
        quiet = g < 1e-6 * g.max()
        err = np.abs(t.numpy() - want[name])
        assert np.all(err[~quiet] <= 1e-5), name
        assert np.all(err[quiet] <= 2 * 3 * lr + 1e-5), name
        noisy += int((err[quiet] > 1e-5).sum())
        total += err.size
    assert noisy <= 1e-3 * total


def test_not_ported_paths_raise():
    cfg = TM.moe_tiny()
    tp = TM.init_params(cfg, device="cpu")
    # the guarded step is ported (tests/test_torch_guards.py)
    _, _, _, health = TM.make_train_step(cfg, guard=True)(
        tp, TM.adamw_init(tp), torch.as_tensor(_ids((2, 9))), float("inf"))
    assert bool(health["finite"])
    with pytest.raises(NotImplementedError, match="A9"):
        TM.make_train_step(cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="A9"):
        TM.forward(tp, torch.as_tensor(_ids((1, 4))), cfg, mesh=object())
    with pytest.raises(ValueError, match="dispatch_mode"):
        TM.forward(tp, torch.as_tensor(_ids((1, 4))),
                   TM.moe_tiny(dispatch_mode="ragged"))


@pytest.mark.parametrize("width", ["int8", "int4"])
def test_quantized_forward_and_tree_match_jax(width):
    """Expert grids quantize over axis 2 (their contraction axis); the
    router, the norms and the embedding stay as they are."""
    jcfg, jp, cfg, tp = _setup(dispatch_mode="capacity")
    jq = JM.quantize_weights(jp, width)
    tq = TM.quantize_weights(tp, width)
    code = "q" if width == "int8" else "q4"
    want = _jnamed(jq)
    for name, t in _named(tq).items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
    assert tq["layers"]["router"] is tp["layers"]["router"]
    assert tuple(tq["layers"]["e_gate"]["s"].shape) == (2, 4, 32)
    assert tq["layers"]["e_down"][code].shape[3] == 64
    ids = _ids((2, 9), seed=7)
    wl, wa = JM.forward(jq, jnp.asarray(ids), jcfg)
    carried = TM.params_from_numpy(jax.tree.map(np.asarray, jq),
                                   device="cpu")
    gl, ga = TM.forward(carried, torch.as_tensor(ids), cfg)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "capacity"])
def test_generate_and_beam_search_match_jax(mode):
    jcfg, jp, cfg, tp = _setup(seed=2, dispatch_mode=mode)
    ids = _ids((3, 6), seed=8)
    want = np.asarray(JM.generate(jp, jnp.asarray(ids), jcfg,
                                  max_new_tokens=5))
    got = TM.generate(tp, ids, cfg, max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), want)
    wt, ws = JM.beam_search(jp, jnp.asarray(ids), jcfg, max_new_tokens=4,
                            num_beams=3, eos_token_id=int(want[0, 1]))
    gt, gs = TM.beam_search(tp, ids, cfg, max_new_tokens=4, num_beams=3,
                            eos_token_id=int(want[0, 1]))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)


def test_capacity_decode_drops_at_batch_as_the_reference(routed):
    """Decode routes the ``B`` decoded tokens, so capacity dispatch at
    ``C = moe_capacity(B)`` < ``B`` drops a slot whenever more than ``C``
    of them pick one expert (the reference's known non-dropless decode):
    the port drops the same slots and gives the same tokens."""
    jcfg, jp, cfg, tp = _setup(seed=4, dispatch_mode="capacity",
                               capacity_factor=0.5)
    ids = _ids((16, 3), seed=9)
    assert TM.moe_capacity(cfg, 16) == 8
    want = np.asarray(JM.generate(jp, jnp.asarray(ids), jcfg,
                                  max_new_tokens=4))
    got = TM.generate(tp, ids, cfg, max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _drops(cfg, routed, n_tokens=16) > 0      # in the decode steps


_ENGINE = dict(num_slots=2, max_len=16, page_size=4, num_pages=5,
               decode_chunk=2)
# capacity dispatch at factor 0.3: 12 slots make a decode step route 12
# tokens (idle slots included) at C = 8, so decode drops as prefill does
_CAPACITY_ENGINE = dict(num_slots=12, max_len=16, page_size=4,
                        num_pages=20, decode_chunk=2)


@pytest.mark.parametrize("mode,kv_quant,weights", [
    pytest.param("dense", False, None, id="False-None"),
    pytest.param("dense", True, None, id="True-None"),
    pytest.param("dense", False, "int8", id="False-int8"),
    pytest.param("capacity", False, None, id="capacity-False-None"),
    pytest.param("capacity", True, None, id="capacity-True-None"),
    pytest.param("capacity", False, "int8", id="capacity-False-int8")])
def test_engine_tokens_match_jax_engine(mode, kv_quant, weights, routed):
    """``ServingEngine`` over the MoE family: queueing, a forced
    preemption, full-precision pages (float32, the tiny config's type) or
    int8 pages, and an int8 weight-only tree. Dense dispatch is the tiny
    config's; capacity dispatch, the full-width serving path's, runs at a
    factor that drops slots both in the prefill groups (padded prompt
    positions and group-padding rows take capacity) and in the decode
    steps (idle slots take capacity), as the reference drops them."""
    kw = {} if mode == "dense" else dict(dispatch_mode="capacity",
                                         capacity_factor=0.3)
    engine = _ENGINE if mode == "dense" else _CAPACITY_ENGINE
    jcfg, jp, cfg, tp = _setup(seed=3, **kw)
    if weights:
        jp = JM.quantize_weights(jp, weights)
        tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.default_rng(5)
    if mode == "dense":
        trace = [(rng.integers(0, 256, (n,)).astype(np.int32), m)
                 for n, m in zip((4, 7, 3, 5), (8, 5, 9, 6))]
    else:
        trace = [(rng.integers(0, 256, (int(a),)).astype(np.int32), int(m))
                 for a, m in zip(rng.integers(3, 9, 14),
                                 rng.integers(4, 9, 14))]
    jout = JEngine(JM, jp, jcfg, kv_quant=kv_quant, **engine).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(trace)])
    TK.reset_dispatch_stats()
    eng = ServingEngine(TM, tp, cfg, device="cpu", kv_quant=kv_quant,
                        **engine)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in enumerate(trace)])
    stats = TK.dispatch_stats()
    assert eng.stats.preempted >= 1
    assert stats["paged_quant_ref" if kv_quant else "paged_ref"] > 0
    for i, (_, m) in enumerate(trace):
        assert len(out[i].tokens) == m
        np.testing.assert_array_equal(out[i].tokens, jout[i].tokens)
    eng.cache.alloc.check_invariants()
    if mode == "capacity":
        slots = engine["num_slots"]
        assert _drops(cfg, routed, n_tokens=slots) > 0       # decode
        assert _drops(cfg, [(T, i) for T, i in routed if T != slots]) > 0


def test_count_params_and_router_stays_float32():
    for make in ("moe_tiny", "deepseek_moe_16b", "qwen2_moe_a14b",
                 "ernie_4_5_a3b"):
        assert TM.count_params(getattr(TM, make)()) == \
            JM.count_params(getattr(JM, make)()), make
    assert TM.count_params(TM.deepseek_moe_16b()) == 16879568896
    cfg = TM.moe_tiny(dtype=torch.bfloat16)
    tp = TM.init_params(cfg, device="cpu")
    assert TM.count_params(cfg) == sum(p.numel() for p in TL._leaves(tp))
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["e_gate"].dtype == torch.bfloat16
    jcfg = JM.moe_tiny(dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    for dtype in (None, torch.bfloat16):
        carried = TM.params_from_numpy(jp, device="cpu", dtype=dtype)
        assert carried["layers"]["router"].dtype == torch.float32
        assert carried["layers"]["wq"].dtype == torch.bfloat16


def test_config_defaults_match_reference():
    for make in ("moe_tiny", "deepseek_moe_16b", "qwen2_moe_a14b",
                 "ernie_4_5_a3b"):
        want, got = getattr(JM, make)(), getattr(TM, make)()
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "shared_intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "num_key_value_heads",
                  "num_experts", "num_experts_per_tok",
                  "max_position_embeddings", "rms_norm_eps", "rope_theta",
                  "router_aux_loss_coef", "remat", "remat_policy",
                  "dispatch_mode", "capacity_factor", "fused_ce",
                  "head_dim"):
            assert getattr(got, f) == getattr(want, f), (make, f)
    for n in (1, 8, 12, 100, 1000, 8192):
        assert TM.moe_capacity(TM.deepseek_moe_16b(), n) == \
            JM.moe_capacity(JM.deepseek_moe_16b(), n)
