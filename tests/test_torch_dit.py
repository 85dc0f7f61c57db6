"""Port parity: the DiT family (``paddle_tpu_torch/models/dit.py``)
against ``paddle_tpu/models/dit.py``.

Weights are one JAX tree carried over with ``params_from_numpy``. The
reference's init leaves the adaLN modulations and the final layer at
zero, which makes every block the identity and hides attention, so the
parity tests run on that tree with its zero leaves refilled with seeded
normals (``_refill``); one test keeps the true init for the identity
property. JAX's attention seam points at the Pallas flash kernel in
interpret mode (``kernels.register(flash=True, rms=False,
tpu_only=False)``, restored afterwards), so the reference runs the
kernel the port's flash wrappers replace; on CPU tensors the port takes
their plain versions.

Tolerances: float32 forward and loss ``1e-5`` of the largest value
(summation order, the exponential); gradients ``1e-5`` of each tensor's
max; bfloat16 forward ``3e-2`` of the largest value (the two frameworks
round the bf16 products, softmax and GELU at other places; one bf16 ulp
is 7.8e-3 of a value); DDIM samples ``1e-4`` of the largest value (five
float32 steps that divide by ``sqrt(alpha_bar)`` near 0.006, over alpha
tables whose cumulative products differ by up to 5e-7).
"""
import contextlib

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as JK
from paddle_tpu.models import dit as JD
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.models import dit as TD
from paddle_tpu_torch.models import llama as TL

HEAD_DIMS = {72: dict(hidden_size=144, num_attention_heads=2),
             24: dict(hidden_size=96, num_attention_heads=4)}


@contextlib.contextmanager
def _pallas_flash():
    """JAX's attention seam on the Pallas flash kernel (interpret mode
    off the TPU), then the default dispatchers back."""
    JK.register(flash=True, rms=False, tpu_only=False)
    try:
        yield
    finally:
        JK.unregister()
        JK.auto_register()


def _refill(tree, seed=1, std=0.02):
    """The tree with every all-zero leaf (biases, ``mod_*``, ``final_*``)
    drawn from a seeded normal, so that gates and biases are not zero."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.any():
            return a
        return (rng.standard_normal(a.shape) * std).astype(a.dtype)
    return jax.tree.map(leaf, tree)


def _setup(d=72, seed=0, refill=True, dtype="float32", **kw):
    kw = {**HEAD_DIMS[d], **kw}
    jcfg = JD.dit_tiny(dtype=getattr(jnp, dtype), **kw)
    cfg = TD.dit_tiny(dtype=getattr(torch, dtype), **kw)
    tree = jax.tree.map(np.asarray, JD.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    if refill:
        tree = _refill(tree, seed + 1)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, jp, cfg, TD.params_from_numpy(tree, device="cpu")


def _inputs(cfg, b=3, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.in_channels, cfg.image_size,
                             cfg.image_size)).astype(np.float32)
    t = rng.integers(0, 1000, b).astype(np.int32)
    y = rng.integers(0, cfg.num_classes + 1, b).astype(np.int32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    return x, t, y, noise


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


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


def test_patchify_and_unpatchify_are_the_reference_reshapes():
    cfg, jcfg = TD.dit_tiny(), JD.dit_tiny()
    x = np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(
        np.float32)
    p = TD.patchify(torch.as_tensor(x), cfg)
    assert p.shape == (2, cfg.num_patches, 16)
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(JD.patchify(x, jcfg)))
    back = TD.unpatchify(p, cfg)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JD.unpatchify(jnp.asarray(p.numpy()),
                                               jcfg)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_timestep_embedding_matches_reference():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    got = TD.timestep_embedding(torch.as_tensor(t)).numpy()
    want = np.asarray(JD.timestep_embedding(jnp.asarray(t)))
    assert got.shape == (5, 256) and got.dtype == np.float32
    # float32 cosines and sines of arguments up to 999, whose ulp is
    # 6.1e-5: a frequency one ulp apart moves a value by up to that
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", sorted(HEAD_DIMS))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_forward_matches_reference(d, dtype, tol):
    jcfg, jp, cfg, tp = _setup(d, dtype=dtype)
    assert cfg.head_dim == d
    # params_from_numpy carries the tree in its own type (bf16 through
    # float32, exactly)
    assert tp["blocks"]["qkv_w"].dtype == cfg.dtype
    np.testing.assert_array_equal(
        tp["blocks"]["qkv_w"].float().numpy(),
        np.asarray(jp["blocks"]["qkv_w"], np.float32))
    x, t, y, _ = _inputs(cfg)
    with _pallas_flash():
        JK.reset_dispatch_stats()
        want = JD.forward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                          jcfg)
        assert JK.dispatch_stats()["flash"] >= 1
    TK.reset_dispatch_stats()
    got = TD.forward(tp, x, t, y, cfg)
    assert TK.dispatch_stats()["flash_ref"] == cfg.num_hidden_layers
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got.numpy(), want) <= tol


def test_zero_init_blocks_are_the_identity():
    """With the reference's init the gates and the final layer are zero:
    every block returns its input bit for bit and the prediction is 0,
    in both packages."""
    jcfg, jp, cfg, tp = _setup(72, refill=False)
    x, t, y, _ = _inputs(cfg)
    got = TD.forward(tp, x, t, y, cfg)
    want = np.asarray(JD.forward(jp, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(y), jcfg))
    assert not got.any() and not want.any()
    h = torch.randn(3, cfg.num_patches, cfg.hidden_size)
    cond = torch.randn(3, cfg.hidden_size)
    bp = {k: w[0] for k, w in tp["blocks"].items()}
    assert torch.equal(TD._block(h, cond, bp, cfg), h)


def test_init_params_layout_and_draws():
    cfg = TD.dit_tiny(**HEAD_DIMS[72])
    tp = TD.init_params(cfg, seed=3, device="cpu")
    jtree = JD.init_params(JD.dit_tiny(**HEAD_DIMS[72]),
                           jax.random.PRNGKey(0))
    got, want = _named(tp), _jnamed(jtree)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == torch.float32, name
        # the reference's zeros stay zeros; its normals are normals
        assert bool(got[name].any()) == bool(w.any()), name
    qkv = got["['blocks']['qkv_w']"]
    assert 0.018 < float(qkv.std()) < 0.022
    assert torch.equal(TD.init_params(cfg, seed=3, device="cpu")["pos"],
                       tp["pos"])
    assert TD.count_params(cfg) == sum(v.numel() for v in got.values())


def test_count_params_matches_reference():
    for make in ("dit_tiny", "dit_xl_2"):
        assert TD.count_params(getattr(TD, make)()) == \
            JD.count_params(getattr(JD, make)()), make
    assert TD.count_params(TD.dit_xl_2()) == 675111184


def test_config_defaults_match_reference():
    for make in ("dit_tiny", "dit_xl_2"):
        t, j = getattr(TD, make)(), getattr(JD, make)()
        for f in ("image_size", "patch_size", "in_channels", "hidden_size",
                  "num_hidden_layers", "num_attention_heads", "mlp_ratio",
                  "num_classes", "remat", "num_patches", "head_dim"):
            assert getattr(t, f) == getattr(j, f), (make, f)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
    assert TD.dit_xl_2().head_dim == 72


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_grad_match_reference(remat):
    jcfg, jp, cfg, tp = _setup(72, remat=remat)
    batch = _inputs(cfg, seed=4)
    with _pallas_flash():
        want_loss, want_g = jax.value_and_grad(
            lambda p: JD.loss_fn(p, tuple(map(jnp.asarray, batch)),
                                 jcfg))(jp)
    TK.reset_dispatch_stats()
    loss, grads = TL.loss_and_grads(tp, batch, cfg, loss=TD.loss_fn)
    stats = TK.dispatch_stats()
    layers = cfg.num_hidden_layers
    assert stats["flash_ref"] == (2 if remat else 1) * layers
    assert stats["flash_bwd_ref"] == layers
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got, want = _named(grads), _jnamed(want_g)
    assert got.keys() == want.keys()
    for name, g in got.items():
        err = np.abs(g.numpy() - want[name]).max()
        assert err <= 1e-5 * np.abs(want[name]).max(), name


def test_three_train_steps_match_reference():
    """Losses ``rtol=1e-5``; parameters after 3 AdamW steps (lr 1e-4)
    within 1e-6, except entries whose step-1 gradient is at noise level
    (below 1e-6 of the tensor's max), where Adam's first step moves by
    about ``lr * sign(g)`` and a sign flipped by summation order moves
    the entry the other way: under 0.1% of the entries."""
    jcfg, jp, cfg, tp = _setup(72, seed=5)
    batches = [_inputs(cfg, b=2, seed=10 + i) for i in range(3)]
    jstep = JD.make_train_step(jcfg)
    jstate = JD.adamw_init(jp)
    tstep = TD.make_train_step(cfg)
    tstate = TD.adamw_init(tp)
    with _pallas_flash():
        _, g1 = jax.value_and_grad(lambda p: JD.loss_fn(
            p, tuple(map(jnp.asarray, batches[0])), jcfg))(jp)
        for batch in batches:
            jp, jstate, jloss = jstep(jp, jstate,
                                      tuple(map(jnp.asarray, batch)))
            tp2, tstate, tloss = tstep(tp, tstate, batch)
            assert tp2 is tp
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=1e-5)
    assert tstate["step"] == 3
    g1, want = _jnamed(g1), _jnamed(jp)
    noisy = total = 0
    for name, t in _named(tp).items():
        assert not t.requires_grad
        g = np.abs(g1[name])
        quiet = g < 1e-6 * g.max()
        err = np.abs(t.numpy() - want[name])
        assert np.all(err[~quiet] <= 1e-6), name
        assert np.all(err[quiet] <= 2 * 3 * 1e-4 + 1e-6), name
        noisy += int((err[quiet] > 1e-6).sum())
        total += err.size
    assert noisy <= 1e-3 * total


# step counts held to JAX's ladder: every count to 40, then counts across
# the range where the two agree (each JAX count is one compile, ~0.1 s)
LADDER_STEPS = {1000: [*range(1, 41), 49, 50, 64, 99, 100, 127, 128, 199,
                       200, 250, 256, 299, 300, 333, 353, 354],
                100: [*range(1, 101, 3), 100]}


def test_ddim_ladder_is_the_reference_ladder():
    """The integer timestep ladder equals JAX's (``jnp.linspace(tmax -
    1, 0, steps).astype(int32)``): the port's formula agrees at every step
    count up to 354 of tmax 1000 and at every count of tmax 100 (held here
    at ``LADDER_STEPS``); ``torch.linspace`` misses it already at 4
    steps."""
    for tmax, counts in LADDER_STEPS.items():
        for steps in counts:
            want = np.asarray(jnp.linspace(tmax - 1, 0, steps).astype(
                jnp.int32)).tolist()
            assert TD.ddim_timesteps(steps, tmax) == want, (tmax, steps)
    assert TD.ddim_timesteps(4) == [999, 665, 332, 0]
    assert torch.linspace(999, 0, 4).to(torch.int32).tolist() != \
        TD.ddim_timesteps(4)


def test_alpha_bar_table_matches_reference():
    got = TD._alpha_bar_table().numpy()
    want = np.asarray(JD._alpha_bar_table())
    assert got.shape == (1000,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def _jax_draws(cfg, b, steps, seed):
    """The latents and per-step normals JAX's ``ddim_sample`` draws from
    ``PRNGKey(seed)``, in its order."""
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    shape = (b, cfg.in_channels, cfg.image_size, cfg.image_size)
    x = jax.random.normal(k0, shape, jnp.float32)
    noise = jnp.stack([jax.random.normal(k, shape, jnp.float32)
                       for k in jax.random.split(key, steps)])
    return np.array(x), np.array(noise)


@pytest.mark.parametrize("eta,guidance", [(0.0, 1.0), (0.0, 4.0),
                                          (1.0, 1.0), (1.0, 4.0)])
def test_ddim_sample_matches_reference_on_its_draws(eta, guidance):
    jcfg, jp, cfg, tp = _setup(72, seed=6)
    y = np.array([1, 7], np.int32)
    steps = 5
    with _pallas_flash():
        want = np.asarray(JD.ddim_sample(
            jp, jnp.asarray(y), jcfg, steps=steps, eta=eta,
            guidance_scale=guidance, key=jax.random.PRNGKey(9)))
    x, noise = _jax_draws(jcfg, 2, steps, 9)
    TK.reset_dispatch_stats()
    got = TD._ddim_over(tp, y, cfg, x, noise if eta else None, steps=steps,
                        eta=eta, guidance_scale=guidance)
    assert TK.dispatch_stats()["flash_ref"] == \
        steps * cfg.num_hidden_layers
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4


def test_ddim_sample_draws_from_its_generator():
    _, _, cfg, tp = _setup(72, seed=7)
    a = TD.ddim_sample(tp, [2, 3], cfg, steps=3, eta=1.0,
                       guidance_scale=4.0, generator=11)
    b = TD.ddim_sample(tp, [2, 3], cfg, steps=3, eta=1.0,
                       guidance_scale=4.0, generator=11)
    c = TD.ddim_sample(tp, [2, 3], cfg, steps=3, eta=1.0,
                       guidance_scale=4.0, generator=12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 4, 8, 8) and bool(torch.isfinite(a).all())
    # eta 0 from the same seed is the ODE on the same x_T
    g = torch.Generator().manual_seed(11)
    x = torch.randn((2, 4, 8, 8), generator=g)
    ode = TD.ddim_sample(tp, [2, 3], cfg, steps=3, generator=11)
    assert torch.equal(ode, TD._ddim_over(tp, [2, 3], cfg, x, None,
                                          steps=3))


def test_mesh_raises_and_names_a9():
    """The mesh path (ROADMAP A9) is ported: on a one-rank dp / fsdp / tp
    gloo mesh the forward, the loss and a train step are the
    single-device ones (multi-rank parity: ``tests/test_torch_mesh.py``)."""
    from _torch_mesh_common import one_rank_mesh
    _, _, cfg, tp = _setup(24)
    x, t, y, noise = _inputs(cfg)
    want = TD.forward(tp, x, t, y, cfg)
    want_loss = TD.loss_fn(tp, (x, t, y, noise), cfg)
    with one_rank_mesh(("dp", "fsdp", "tp")) as mesh:
        mp = TD.shard_params(tp, cfg, mesh)
        with torch.no_grad():
            got = TD.forward(mp, x, t, y, cfg, mesh=mesh)
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5,
                                   atol=1e-6)
        _, _, loss = TD.make_train_step(cfg, mesh)(
            mp, TD.adamw_init(mp), (x, t, y, noise))
        np.testing.assert_allclose(float(loss.full_tensor()),
                                   float(want_loss), rtol=1e-6)
