"""Port parity: the anomaly guards (``paddle_tpu_torch/training/guards.py``)
and the guarded train step of both families (``make_train_step(guard=
True)``).

- Every function of ``guards.py`` against the JAX package's on the same
  numpy inputs, float32 and bfloat16 leaves, overflow and underflow
  fractions at the dtype boundaries included (statistics within ``1e-6``
  relative; counts and fractions exactly; subnormal counts where XLA's
  CPU code flushes them to zero are held to their definition).
- The guarded step, llama and MoE: on a clean batch it gives the
  unguarded step's loss, parameters, moments and ``step`` bit for bit;
  an id equal to ``vocab_size``, an id of ``iinfo(int32).min``, a cap of
  ``1e-9`` and a poisoned packed batch each give ``finite`` false and
  leave parameters, moments and ``step`` equal to a clone taken before.
  Clean, bad, clean steps against the JAX guarded step: losses and grad
  norms ``rtol=1e-5``, ``finite`` equal, parameters as
  ``tests/test_torch_train.py`` holds them (``atol=1e-5`` but entries
  whose first gradient is at noise level). The loss of a poisoned batch
  is compared on neither side (the JAX gather fills NaN on the CPU; the
  port clamps the ids it feeds the loss).
- Numerics on and off give the same update bit for bit, and the
  squared norms of ``health["numerics"]`` tile ``grad_norm``.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu.io import packing as JPK
from paddle_tpu.models import llama as JL
from paddle_tpu.models import moe as JM
from paddle_tpu.training import guards as JG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import moe as TM
from paddle_tpu_torch.training import guards as TG

B, T, V = 2, 16, 64
INF = float("inf")


def _tree_np(tree):
    """{path: numpy} of a port tree in JAX's key-path spelling."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}['{k}']")
        else:
            out[prefix] = (node.float().numpy() if torch.is_tensor(node)
                           else np.asarray(node))
    walk(tree, "")
    return out


def _jtree_np(tree):
    return {jtu.keystr(p): np.asarray(v, np.float32)
            for p, v in jtu.tree_flatten_with_path(tree)[0]}


# -- the functions of guards.py -------------------------------------------------

def _grad_tree(rng, dtype):
    """A gradient-shaped tree: stacked ``layers`` leaves and plain ones."""
    def leaf(*shape):
        return (rng.normal(size=shape) * 1e-2).astype(np.float32)
    tree = {"embed": leaf(8, 4), "ln_f": leaf(4),
            "layers": {"wq": leaf(3, 4, 6), "ln1": leaf(3, 4)}}
    return (jax.tree.map(lambda a: jnp.asarray(a, dtype), tree),
            jax.tree.map(lambda a: torch.as_tensor(np.array(
                jnp.asarray(a, dtype), np.float32)).to(
                {jnp.float32: torch.float32,
                 jnp.bfloat16: torch.bfloat16}[dtype]), tree))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_grad_global_norm_and_numerics_match_jax(dtype):
    jt, tt = _grad_tree(np.random.default_rng(0), dtype)
    np.testing.assert_allclose(float(TG.grad_global_norm(tt)),
                               float(JG.grad_global_norm(jt)), rtol=1e-6)
    want = JG.grad_numerics(jt)
    got = TG.grad_numerics(tt)
    assert got.keys() == want.keys()
    for group in ("layers", "tensors"):
        assert got[group].keys() == want[group].keys()
        for name in got[group]:
            assert tuple(got[group][name]) == TG.NUMERIC_STATS
            for stat in TG.NUMERIC_STATS:
                g = got[group][name][stat]
                assert g.dtype == torch.float32
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(want[group][name][stat]),
                    rtol=1e-6, atol=1e-12, err_msg=f"{name}.{stat}")
    # per-layer rows keep axis 0 and the squared norms tile the norm
    assert got["layers"]["wq"]["absmax"].shape == (3,)
    total = sum(float(s["gnorm_sq"].sum()) for grp in got.values()
                for s in grp.values())
    np.testing.assert_allclose(np.sqrt(total),
                               float(TG.grad_global_norm(tt)), rtol=1e-6)


@pytest.mark.parametrize("name", ["float16", "float32", "bfloat16"])
def test_tensor_stats_at_the_dtype_boundaries(name):
    """Values past half of ``finfo.max`` count as overflow and a nonzero
    value under ``finfo.tiny`` (a subnormal of the dtype) as underflow;
    values exactly at either threshold count as neither, exact zeros as
    zeros: 3, 1 and 2 of 12. The port gives these counts in every dtype.
    JAX gives them in float16, whose subnormals are normal float32
    values; XLA on the CPU flushes float32 subnormals to zero, so its
    float32 and bfloat16 counts see that value as a zero (the reference's
    own boundary test runs float16 for this reason). The overflow band
    and absmax match JAX in every dtype."""
    jdt = getattr(jnp, name)
    tdt = getattr(torch, name)
    fi = jnp.finfo(jdt)
    over, tiny = float(fi.max) / 2.0, float(fi.tiny)
    vals = np.array([float(fi.max) * 0.9, over * 1.25, -over * 1.5, over,
                     1.0, -0.5, tiny, 0.0, 0.0, tiny * 0.25, 3.0, 5.0],
                    np.float32).reshape(2, 6)
    jx = jnp.asarray(vals, jdt)
    tx = torch.as_tensor(np.array(jx, np.float32)).to(tdt)
    got = TG.tensor_stats(tx)
    assert float(got["overflow_frac"]) == pytest.approx(3 / 12)
    assert float(got["underflow_frac"]) == pytest.approx(1 / 12)
    assert float(got["zero_frac"]) == pytest.approx(2 / 12)
    exact = ("absmax", "overflow_frac") + (
        ("zero_frac", "underflow_frac") if name == "float16" else ())
    for axes in (None, (1,)):
        want = JG.tensor_stats(jx, reduce_axes=axes)
        got = TG.tensor_stats(tx, reduce_axes=axes)
        for stat in exact:
            np.testing.assert_array_equal(got[stat].numpy(),
                                          np.asarray(want[stat]), stat)
    ints = TG.tensor_stats(torch.tensor([0, 5, -7], dtype=torch.int32))
    assert float(ints["overflow_frac"]) == float(ints["underflow_frac"]) == 0
    assert float(ints["zero_frac"]) == pytest.approx(1 / 3)
    assert TG._dtype_range(torch.int32) == JG._dtype_range(jnp.int32)
    assert TG._dtype_range(tdt) == JG._dtype_range(jdt)


def test_step_health_matches_jax():
    jt, tt = _grad_tree(np.random.default_rng(1), jnp.float32)
    ids = np.array([[0, 5, V - 1]], np.int32)
    gnorm = float(JG.grad_global_norm(jt))
    cases = [(1.5, ids, INF), (np.nan, ids, INF), (1.5, ids, gnorm / 2),
             (np.inf, ids, INF), (1.5, ids + 1, INF), (1.5, ids - 1, INF)]
    for loss, inp, cap in cases:
        jok, jh = JG.step_health(jnp.float32(loss), jt, jnp.asarray(inp), V,
                                 jnp.float32(cap))
        tok, th = TG.step_health(torch.tensor(loss, dtype=torch.float32), tt,
                                 torch.as_tensor(inp), V, cap)
        assert bool(tok) == bool(jok) and th["finite"] is tok
        np.testing.assert_allclose(float(th["grad_norm"]),
                                   float(jh["grad_norm"]), rtol=1e-6)
    assert [bool(TG.step_health(torch.tensor(1.0), tt,
                                torch.as_tensor(ids), V, cap)[0])
            for cap in (torch.tensor(INF), np.float32(1e-9))] == [True, False]


def test_resolve_follows_the_flags():
    try:
        assert TG.resolve_guard(None) is False
        assert TG.resolve_guard(True) is True
        paddle_tpu_torch.set_flags({"FLAGS_enable_sentinel": True,
                                    "FLAGS_enable_numerics": True})
        assert TG.resolve_guard(None) is True
        assert TG.resolve_numerics(None) is True
        assert TG.resolve_numerics(False) is False
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_enable_sentinel": False,
                                    "FLAGS_enable_numerics": False})


def test_gated_update_is_all_or_nothing():
    calls = []

    def update(p, o, g):
        calls.append(1)
        return "p'", "o'"
    assert TG.gated_update(torch.tensor(True), update, "p", "o", "g") == \
        ("p'", "o'")
    assert TG.gated_update(torch.tensor(False), update, "p", "o", "g") == \
        ("p", "o")
    assert calls == [1]


# -- the guarded train steps ----------------------------------------------------

_FAMILIES = {
    "llama": (JL, TL, lambda m: m.llama_tiny(vocab_size=V)),
    "moe": (JM, TM, lambda m: m.moe_tiny(vocab_size=V)),
}


def _setup(family):
    jm, tm, make = _FAMILIES[family]
    jcfg, cfg = make(jm), make(tm)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, tm, jcfg, jp, cfg, tp


def _batch(i):
    r = np.random.RandomState(1000 + i)
    ids = r.randint(0, V, size=(B, T + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def _identical(a, b):
    """Byte equality of two trees (NaN payloads and signed zeros
    included)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_identical(a[k], b[k])
                                            for k in a)
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return a == b


def _poisoned():
    inp, lab = _batch(1)
    vocab = inp.copy()
    vocab[0, 3] = V                              # one past the edge
    low = inp.copy()
    low[0, 0] = np.iinfo(np.int32).min
    return {"vocab_size": (vocab, lab), "int32_min": (low, lab)}


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_clean_guarded_step_is_the_unguarded_step_bit_for_bit(family):
    _, tm, _, _, cfg, tp = _setup(family)
    pu, ou = _clone(tp), tm.adamw_init(tp)
    pg, og = _clone(tp), tm.adamw_init(tp)
    unguarded = tm.make_train_step(cfg, guard=False)
    guarded = tm.make_train_step(cfg, guard=True)
    for i in range(2):
        _, _, lu = unguarded(pu, ou, _batch(i))
        _, _, lg, h = guarded(pg, og, _batch(i), INF)
        assert bool(h["finite"]) and torch.equal(lu, lg)
        assert _identical(pu, pg) and _identical(ou, og)


@pytest.mark.parametrize("family", ["llama", "moe"])
@pytest.mark.parametrize("case", ["vocab_size", "int32_min", "spike_cap"])
def test_anomalous_step_leaves_a_clone_equal_state(family, case):
    _, tm, _, _, cfg, tp = _setup(family)
    state = tm.adamw_init(tp)
    step = tm.make_train_step(cfg, guard=True)
    step(tp, state, _batch(0), INF)              # moments not all zero
    p0, o0 = _clone(tp), _clone(state)
    if case == "spike_cap":
        _, _, loss, h = step(tp, state, _batch(1), 1e-9)
        assert np.isfinite(float(loss)) and np.isfinite(float(h["grad_norm"]))
    else:
        _, _, _, h = step(tp, state, _poisoned()[case], INF)
    assert not bool(h["finite"])
    assert _identical(tp, p0) and _identical(state, o0)
    assert state["step"] == o0["step"] == 1
    # the next clean step applies
    _, _, _, h = step(tp, state, _batch(2), INF)
    assert bool(h["finite"]) and state["step"] == 2
    assert not _identical(tp, p0)


def test_poisoned_packed_batch_is_gated():
    """A packed batch (``io/packing.py``) with ``iinfo(int32).min`` in its
    first row: the segment attention path gates as the dense one."""
    _, tm, _, _, cfg, tp = _setup("llama")
    state = tm.adamw_init(tp)
    step = tm.make_train_step(cfg, guard=True)
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, V, (n,)).astype(np.int32) for n in (40, 24)]
    pb = JPK.packed_train_batch(JPK.pack_documents(docs, 64))
    bad = (np.where(np.arange(64)[None] == 0, np.iinfo(np.int32).min,
                    pb[0]).astype(np.int32),) + tuple(pb[1:])
    p0, o0 = _clone(tp), _clone(state)
    _, _, _, h = step(tp, state, tuple(np.array(a) for a in bad), INF)
    assert not bool(h["finite"])
    assert _identical(tp, p0) and _identical(state, o0)
    _, _, _, h = step(tp, state, tuple(np.array(a) for a in pb), INF)
    assert bool(h["finite"]) and state["step"] == 1


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_clean_bad_clean_matches_the_jax_guarded_step(family):
    jm, tm, jcfg, jp, cfg, tp = _setup(family)
    lr = 3e-4 if family == "llama" else 1e-4
    jstep = jm.make_train_step(jcfg, guard=True, donate=False)
    jstate = jm.adamw_init(jp)
    tstep = tm.make_train_step(cfg, guard=True)
    tstate = tm.adamw_init(tp)
    _, g1 = jax.value_and_grad(
        lambda p: jm.loss_fn(p, tuple(map(jnp.asarray, _batch(0))),
                             jcfg))(jp)
    g1 = _jtree_np(g1)
    batches = [_batch(0), _poisoned()["vocab_size"], _batch(2)]
    for i, batch in enumerate(batches):
        jp, jstate, jloss, jh = jstep(jp, jstate, tuple(map(jnp.asarray,
                                                            batch)),
                                      jnp.float32(INF))
        _, _, tloss, th = tstep(tp, tstate, batch, INF)
        assert bool(th["finite"]) == bool(jh["finite"]) == (i != 1)
        if i != 1:
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(th["grad_norm"]),
                                       float(jh["grad_norm"]), rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == 2
    want, noisy, total = _jtree_np(jp), 0, 0
    for name, t in _tree_np(tp).items():
        g = np.abs(g1[name])
        quiet = g < 1e-6 * g.max()
        err = np.abs(t - want[name])
        assert np.all(err[~quiet] <= 1e-5), name
        assert np.all(err[quiet] <= 2 * 2 * lr + 1e-5), name
        noisy += int((err[quiet] > 1e-5).sum())
        total += err.size
    assert noisy <= 1e-3 * total


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_numerics_on_and_off_give_the_same_update(family):
    """The numerics block is observation only: in eager PyTorch the two
    steps run the same update code on the same gradients, so parameters,
    moments and loss are equal bit for bit (the reference compares two
    compiled programs there). Its stats match the JAX numerics step's."""
    jm, tm, jcfg, jp, cfg, tp = _setup(family)
    pa, oa = _clone(tp), tm.adamw_init(tp)
    pb, ob = _clone(tp), tm.adamw_init(tp)
    _, _, la, ha = tm.make_train_step(cfg, guard=True)(pa, oa, _batch(0), INF)
    _, _, lb, hb = tm.make_train_step(cfg, guard=True, numerics=True)(
        pb, ob, _batch(0), INF)
    assert "numerics" not in ha
    assert torch.equal(la, lb) and _identical(pa, pb) and _identical(oa, ob)
    nm = hb["numerics"]
    total = sum(float(s["gnorm_sq"].sum()) for grp in nm.values()
                for s in grp.values())
    np.testing.assert_allclose(np.sqrt(total), float(hb["grad_norm"]),
                               rtol=1e-5)
    jstep = jm.make_train_step(jcfg, guard=True, numerics=True,
                               donate=False)
    _, _, _, jh = jstep(jp, jm.adamw_init(jp),
                        tuple(map(jnp.asarray, _batch(0))), jnp.float32(INF))
    for group in ("layers", "tensors"):
        assert nm[group].keys() == jh["numerics"][group].keys()
        for name, stats in nm[group].items():
            want = jh["numerics"][group][name]
            scale = float(np.max(np.asarray(want["absmax"])))
            for stat in ("absmax", "rms", "gnorm_sq"):
                np.testing.assert_allclose(stats[stat].numpy(),
                                           np.asarray(want[stat]),
                                           rtol=1e-4, atol=1e-12,
                                           err_msg=f"{name}.{stat}")
            np.testing.assert_allclose(stats["mean"].numpy(),
                                       np.asarray(want["mean"]), rtol=0,
                                       atol=1e-5 * scale + 1e-12)
            for stat in ("overflow_frac", "underflow_frac"):
                np.testing.assert_array_equal(stats[stat].numpy(),
                                              np.asarray(want[stat]))
