"""Port parity: the training slice of the Llama core (``loss_fn``, remat,
``adamw_init`` / ``_adamw_update``, ``make_train_step``).

Weights are the JAX tree carried over with ``params_from_numpy``; token
ids come from numpy. Loss and every parameter gradient are held to
``jax.value_and_grad(loss_fn)`` in float32 (``rtol=1e-5, atol=1e-6``:
summation order only). Three train steps are held to the JAX
``make_train_step``: losses to ``rtol=1e-5``, parameters to ``atol=1e-5``
except entries whose step-1 gradient is at noise level (below 1e-6 of
the tensor's max): Adam's first step moves every entry by about
``lr * sign(g)``, so a sign that summation order flips moves such an
entry up to ``2 * lr`` the other way; they must be under 0.1% of the
entries.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.models import llama as TL


def _named(tree, prefix=""):
    """{path: leaf} of the port's dict tree, in the JAX key-path spelling."""
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
    jcfg = JL.llama_tiny(**kw)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(**kw), tp


def _ids(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _torch_loss_and_grads(tp, batch, cfg):
    loss, grads = TL.loss_and_grads(tp, batch, cfg)
    return float(loss), _named(grads)


@pytest.mark.parametrize("fused_ce", [True, False])
@pytest.mark.parametrize("form", ["ids", "pair"])
def test_loss_and_every_grad_match_jax(fused_ce, form):
    jcfg, jp, cfg, tp = _setup(fused_ce=fused_ce, fused_ce_chunk=64)
    ids = _ids(jcfg, (2, 17))
    if form == "ids":
        jb, tb = jnp.asarray(ids), torch.as_tensor(ids)
    else:
        jb = (jnp.asarray(ids[:, :-1]), jnp.asarray(ids[:, 1:]))
        tb = (torch.as_tensor(ids[:, :-1]), torch.as_tensor(ids[:, 1:]))
    want_loss, want_g = jax.value_and_grad(
        lambda p: JL.loss_fn(p, jb, jcfg))(jp)
    TK.reset_dispatch_stats()
    loss, grads = _torch_loss_and_grads(tp, tb, cfg)
    stats = TK.dispatch_stats()
    assert stats["fused_ce"] == (1 if fused_ce else 0)
    assert stats["flash_bwd_ref"] == cfg.num_hidden_layers
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want_g = _jnamed(want_g)
    assert grads.keys() == want_g.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_remat_policies_give_the_same_loss_and_grads():
    """Remat off, ``"full"`` and ``"dots"`` differ only in what the
    backward recomputes: with remat the flash forward runs twice a
    layer, the backward once."""
    results = {}
    for remat, policy in ((False, "dots"), (True, "full"), (True, "dots")):
        cfg = TL.llama_tiny(remat=remat, remat_policy=policy)
        tp = TL.init_params(cfg, seed=3, device="cpu")
        TK.reset_dispatch_stats()
        results[(remat, policy)] = _torch_loss_and_grads(
            tp, torch.as_tensor(_ids(cfg, (2, 13))), cfg)
        stats = TK.dispatch_stats()
        layers = cfg.num_hidden_layers
        assert stats["flash_ref"] == (2 if remat else 1) * layers
        assert stats["flash_bwd_ref"] == layers
    base_loss, base_g = results[(False, "dots")]
    for loss, grads in results.values():
        assert loss == pytest.approx(base_loss, rel=1e-6)
        for name, g in grads.items():
            torch.testing.assert_close(g, base_g[name], rtol=1e-5,
                                       atol=1e-7)


def test_remat_policy_names():
    from torch.utils.checkpoint import noop_context_fn
    assert TL.remat_policy("full") is noop_context_fn
    assert callable(TL.remat_policy("dots"))
    assert callable(TL.remat_policy("attn"))   # tests/test_torch_remat_attn.py
    with pytest.raises(ValueError):
        TL.remat_policy("everything")


def test_config_defaults_match_reference():
    for name in ("remat", "remat_policy", "fused_ce", "fused_ce_chunk"):
        assert getattr(TL.llama_3_8b(), name) == \
            getattr(JL.llama_3_8b(), name), name
        assert getattr(TL.llama_tiny(), name) == \
            getattr(JL.llama_tiny(), name), name


def test_count_params_matches_reference_and_tree():
    for make in ("llama_tiny", "llama_3_8b"):
        assert TL.count_params(getattr(TL, make)()) == \
            JL.count_params(getattr(JL, make)()), make
    cfg = TL.llama_tiny()
    tp = TL.init_params(cfg, device="cpu")
    assert TL.count_params(cfg) == sum(p.numel() for p in TL._leaves(tp))
    assert TL.count_params(TL.llama_3_8b(num_hidden_layers=4)) == 1923125248


def test_unpack_batch_forms_match_reference():
    ids = _ids(TL.llama_tiny(), (2, 9))
    seg = np.zeros((2, 8), np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    forms = [ids, (ids[:, :-1], ids[:, 1:]),
             (ids[:, :-1], ids[:, 1:], seg, pos),
             {"ids": ids[:, :-1], "labels": ids[:, 1:],
              "segment_ids": seg, "positions": pos},
             {"ids": ids[:, :-1], "labels": ids[:, 1:]}]
    for form in forms:
        want = JL.unpack_batch(form)
        tform = jax.tree.map(torch.as_tensor, form)
        got = TL.unpack_batch(tform)
        assert len(got) == 4
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 2, 3)}}

    def tree(scale):
        return jax.tree.map(lambda s: (rng.normal(size=s) * scale)
                            .astype(np.float32), shapes,
                            is_leaf=lambda s: isinstance(s, tuple))

    params, m, v = tree(1.0), tree(0.1), tree(0.1)
    v = jax.tree.map(np.abs, v)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[moments]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
    for step in (0, 6):
        grads = tree(1.0)
        jstate = {"step": jnp.asarray(step, jnp.int32),
                  "m": jax.tree.map(lambda a: jnp.asarray(a, jdt), m),
                  "v": jax.tree.map(lambda a: jnp.asarray(a, jdt), v)}
        wp, ws = JL._adamw_update(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, grads), jstate,
                                  3e-4)
        tparams = jax.tree.map(torch.tensor, params)
        tstate = {"step": step,
                  "m": jax.tree.map(lambda a: torch.tensor(a).to(tdt), m),
                  "v": jax.tree.map(lambda a: torch.tensor(a).to(tdt), v)}
        gp, gs = TL._adamw_update(tparams, jax.tree.map(torch.as_tensor,
                                                        grads), tstate, 3e-4)
        assert gp is tparams and gs["step"] == int(ws["step"]) == step + 1
        for got, want in ((gp, wp), (gs["m"], ws["m"]), (gs["v"], ws["v"])):
            want = _jnamed(want)
            for name, t in _named(got).items():
                np.testing.assert_allclose(
                    t.float().numpy(), np.asarray(want[name], np.float32),
                    rtol=1e-6, atol=1e-7, err_msg=name)
        assert all(t.dtype == tdt for t in TL._leaves(gs["m"]))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_coupled_decay_matches_reference(moments):
    """The functional step computes the reference's ``p - lr * (u + wd *
    p)``, not the eager order ``(p - lr * u) - lr * wd * p``. At the
    scale of real weights (p ~ N(0, 0.02)) the two orders differ in the
    last float32 bit of about a third of the entries; the coupled form
    differs from JAX's in a few hundredths of a percent (XLA may fuse
    what PyTorch rounds op by op). One step of one 65536-entry leaf: at
    most 0.5% of the entries may differ, each by at most 4e-9."""
    rng = np.random.default_rng(11)
    n = 65536
    p = (rng.normal(size=n) * 0.02).astype(np.float32)
    g = (rng.normal(size=n) * 0.5).astype(np.float32)
    zeros = np.zeros(n, np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[moments]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
    jstate = {"step": jnp.asarray(0, jnp.int32),
              "m": {"w": jnp.asarray(zeros, jdt)},
              "v": {"w": jnp.asarray(zeros, jdt)}}
    wp, _ = JL._adamw_update({"w": jnp.asarray(p)}, {"w": jnp.asarray(g)},
                             jstate, 3e-4, wd=0.1)
    tstate = {"step": 0, "m": {"w": torch.zeros(n, dtype=tdt)},
              "v": {"w": torch.zeros(n, dtype=tdt)}}
    gp, _ = TL._adamw_update({"w": torch.tensor(p)},
                             {"w": torch.tensor(g)}, tstate, 3e-4, wd=0.1)
    got, want = gp["w"].numpy(), np.asarray(wp["w"])
    diff = np.abs(got - want)
    assert np.count_nonzero(diff) <= 0.005 * n, np.count_nonzero(diff)
    assert diff.max() <= 4e-9, diff.max()


def test_adamw_init_layout():
    cfg = TL.llama_tiny()
    tp = TL.init_params(cfg, device="cpu")
    for dt in (torch.float32, torch.bfloat16):
        st = TL.adamw_init(tp, moment_dtype=dt)
        assert st["step"] == 0
        for key in ("m", "v"):
            assert _named(st[key]).keys() == _named(tp).keys()
            assert all(t.dtype == dt and not t.any()
                       for t in TL._leaves(st[key]))


def test_three_train_steps_match_reference():
    jcfg, jp, cfg, tp = _setup(seed=5)
    batch = _ids(jcfg, (2, 17), seed=6)
    jstep = JL.make_train_step(jcfg, donate=False)
    jstate = JL.adamw_init(jp)
    tstate = TL.adamw_init(tp)
    tstep = TL.make_train_step(cfg)
    _, g1 = jax.value_and_grad(
        lambda p: JL.loss_fn(p, jnp.asarray(batch), jcfg))(jp)
    g1 = _jnamed(g1)
    ids_before = {k: id(v) for k, v in _named(tp).items()}
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(batch))
        tp2, tstate, tloss = tstep(tp, tstate, batch)
        assert tp2 is tp
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert tstate["step"] == 3
    assert {k: id(v) for k, v in _named(tp).items()} == ids_before
    want, noisy, total = _jnamed(jp), 0, 0
    for name, t in _named(tp).items():
        assert t.device.type == "cpu" and not t.requires_grad
        g = np.abs(g1[name])
        quiet = g < 1e-6 * g.max()
        err = np.abs(t.numpy() - want[name])
        assert np.all(err[~quiet] <= 1e-5), name
        assert np.all(err[quiet] <= 2 * 3 * 3e-4 + 1e-5), name
        noisy += int((err[quiet] > 1e-5).sum())
        total += err.size
    assert noisy <= 1e-3 * total


def test_train_step_loss_decreases_with_bf16_moments():
    cfg = TL.llama_tiny()
    tp = TL.init_params(cfg, seed=7, device="cpu")
    state = TL.adamw_init(tp, moment_dtype=torch.bfloat16)
    step = TL.make_train_step(cfg, lr=1e-2)
    batch = torch.as_tensor(_ids(cfg, (2, 9), seed=8))
    losses = [float(step(tp, state, batch)[2]) for _ in range(4)]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_loss_and_grads_leaves_params_alone():
    """The gradient is taken through detached aliases: the parameters
    keep ``requires_grad=False``, get no ``.grad``, and are not moved; a
    numpy batch is brought to their device."""
    cfg = TL.llama_tiny()
    tp = TL.init_params(cfg, device="cpu")
    loss, grads = TL.loss_and_grads(tp, _ids(cfg, (2, 9)), cfg)
    assert loss.grad_fn is None and loss.ndim == 0
    assert _named(grads).keys() == _named(tp).keys()
    for name, p in _named(tp).items():
        assert not p.requires_grad and p.grad is None
        assert _named(grads)[name].shape == p.shape


def test_not_yet_ported_paths_raise():
    """Sequence-packed batches are ported (``tests/test_torch_packing.py``),
    and so are attention masks in ``sdpa_raw`` (they take the plain math
    path, ``sdpa_reference``; ``tests/test_torch_masked_attention.py``)
    and the guarded step (``tests/test_torch_guards.py``); the mesh path
    still raises."""
    from paddle_tpu_torch.nn.functional import attention as TATT
    cfg = TL.llama_tiny()
    tp = TL.init_params(cfg, device="cpu")
    ids = torch.as_tensor(_ids(cfg, (2, 9)))
    seg = torch.zeros(2, 8, dtype=torch.int32)
    pos = torch.arange(8).repeat(2, 1)
    packed = TL.loss_fn(tp, (ids[:, :-1], ids[:, 1:], seg, pos), cfg)
    np.testing.assert_allclose(float(packed), float(TL.loss_fn(tp, ids, cfg)),
                               rtol=1e-6)
    q = torch.zeros(1, 8, 4, 16)
    mask = torch.ones(8, 8, dtype=torch.bool)
    torch.testing.assert_close(TATT.sdpa_raw(q, q, q, mask),
                               TATT.sdpa_reference(q, q, q, mask))
    step = TL.make_train_step(cfg, guard=True)
    _, _, _, health = step(tp, TL.adamw_init(tp), ids, float("inf"))
    assert bool(health["finite"])
    with pytest.raises(NotImplementedError, match="mesh"):
        TL.make_train_step(cfg, mesh=object())


def test_guard_default_follows_sentinel_flag():
    """``guard=None`` resolves from ``FLAGS_enable_sentinel`` as in the
    reference (the registry, ``paddle_tpu_torch.set_flags``; the
    environment is read when the flag is defined): on, the guarded 4-in /
    4-out step is built; off, the plain step."""
    import paddle_tpu_torch
    cfg = TL.llama_tiny()
    tp = TL.init_params(cfg, device="cpu")
    ids = torch.as_tensor(_ids(cfg, (2, 9)))
    try:
        paddle_tpu_torch.set_flags({"FLAGS_enable_sentinel": True})
        out = TL.make_train_step(cfg)(tp, TL.adamw_init(tp), ids,
                                      float("inf"))
        assert len(out) == 4 and bool(out[3]["finite"])
        assert len(TL.make_train_step(cfg, guard=False)(
            tp, TL.adamw_init(tp), ids)) == 3
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_enable_sentinel": False})
    assert len(TL.make_train_step(cfg)(tp, TL.adamw_init(tp), ids)) == 3
