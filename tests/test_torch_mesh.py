"""The port's mesh path (ROADMAP A9) against the JAX reference's.

The JAX side runs here on its 8 fake CPU devices; the port's runs as 8
gloo processes (``tests/_torch_mesh_worker.py``), launched once for the
module. Weights come from the JAX ``init_params`` and cross through
numpy (``params_from_numpy`` -> ``shard_params``). Tolerances are the
JAX mesh tests' (``tests/test_models.py``, ``tests/test_models_extended.py``):
loss rtol 1e-5 and updated weights rtol 2e-4 / atol 2e-5 for the train
step, loss rtol 2e-4 for the MoE and DiT meshes; greedy tokens exact in
float32. Where a weight's first gradient is quiet (below 1e-6 of its
leaf's largest, or within 100 Adam eps of zero, 1e-6), Adam's update
``m / (sqrt(v) + eps)`` turns summation-order noise into a step of up
to ``lr`` either way, so there the bound is ``2 * lr`` (the rule of
``test_torch_train.py::test_three_train_steps_match_reference``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from paddle_tpu.models import dit as JD
from paddle_tpu.models import llama as JL
from paddle_tpu.models import moe as JM

from _torch_mesh_common import launched, load_json, load_tree, save_tree

CASES = ["llama_step", "llama_packed", "forward_gqa", "moe", "dit"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _refill(tree, seed=1, std=0.02):
    """Every all-zero leaf (DiT's gates and biases) drawn from a seeded
    normal, so that attention and the gates reach the loss."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a if np.asarray(a).any() else (
        rng.standard_normal(a.shape) * std).astype(a.dtype), _np(tree))


def _cfg():
    return dataclasses.replace(JL.llama_tiny(), fused_ce=False)


def _packed_batch(vocab):
    rng = np.random.default_rng(3)
    seg = np.array([[0] * 5 + [1] * 7 + [2] * 4, [0] * 16,
                    [0] * 3 + [1] * 13, [0] * 10 + [-1] * 6], np.int32)
    pos = np.zeros_like(seg)
    for r in range(4):
        for s in set(seg[r].tolist()) - {-1}:
            idx = np.nonzero(seg[r] == s)[0]
            pos[r, idx] = np.arange(len(idx))
    inp = rng.integers(0, vocab, seg.shape).astype(np.int32)
    labels = rng.integers(0, vocab, seg.shape).astype(np.int32)
    labels[seg < 0] = -100
    return {"inp": inp, "labels": labels, "seg": seg, "pos": pos}


def _dit_batch(cfg):
    rng = np.random.default_rng(2)
    shape = (4, cfg.in_channels, cfg.image_size, cfg.image_size)
    return {"x0": rng.normal(size=shape).astype(np.float32),
            "t": rng.integers(0, 1000, (4,)).astype(np.int32),
            "y": rng.integers(0, cfg.num_classes, (4,)).astype(np.int32),
            "noise": rng.normal(size=shape).astype(np.float32)}


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), names)


def _prepare(tmp):
    cfg = _cfg()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (4, 17)).astype(np.int32)
    save_tree(tmp / "in_llama_step.npz",
              {"params": _np(JL.init_params(cfg, jax.random.PRNGKey(0))),
               "ids": ids})
    save_tree(tmp / "in_llama_packed.npz",
              {"params": _np(JL.init_params(cfg, jax.random.PRNGKey(1))),
               **_packed_batch(cfg.vocab_size)})
    gen_ids = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)
    save_tree(tmp / "in_forward_gqa.npz",
              {"params": _np(JL.init_params(JL.llama_tiny(),
                                            jax.random.PRNGKey(5))),
               "ids": gen_ids})
    mcfg = JM.moe_tiny()
    save_tree(tmp / "in_moe.npz",
              {"params": _np(JM.init_params(mcfg, jax.random.key(3))),
               "ids": np.random.default_rng(1).integers(
                   0, mcfg.vocab_size, (4, 17)).astype(np.int32)})
    dcfg = JD.dit_tiny()
    save_tree(tmp / "in_dit.npz",
              {"params": _refill(JD.init_params(dcfg, jax.random.key(3))),
               **_dit_batch(dcfg)})


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    return launched(tmp_path_factory, "mesh", 8, CASES, _prepare)


def _out(ran, case):
    return load_tree(ran / f"out_{case}.npz")


LR = 1e-2
ADAM_EPS = 1e-8


def _close_trees(got, want, grads, rtol=2e-4, atol=2e-5):
    """Updated weights against the reference's; ``grads`` (the reference's
    first gradients) mark the quiet entries, held to ``2 * LR``."""
    flat_g = dict(jax.tree_util.tree_flatten_with_path(_np(grads))[0])
    for path, w in jax.tree_util.tree_flatten_with_path(_np(want))[0]:
        g = got
        for k in path:
            g = g[k.key]
        name = jax.tree_util.keystr(path)
        gr = np.abs(flat_g[path])
        quiet = gr < max(1e-6 * gr.max(), 100 * ADAM_EPS)
        np.testing.assert_allclose(g[~quiet], w[~quiet], rtol=rtol,
                                   atol=atol, err_msg=name)
        assert np.all(np.abs(g - w)[quiet] <= 2 * LR), name


def _grads(cfg, params, batch):
    return jax.grad(lambda p: JL.loss_fn(p, batch, cfg))(params)


def _jax_step(cfg, params, batch, mesh=None, **kw):
    step = JL.make_train_step(cfg, mesh, lr=LR, donate=False, **kw)
    if mesh is not None:
        params = JL.shard_params(params, cfg, mesh)
        batch = jax.device_put(batch, NamedSharding(mesh, JP(("dp", "fsdp"),
                                                            None)))
    args = (params, JL.adamw_init(params), batch)
    if kw.get("guard"):
        args += (jnp.float32(np.inf),)
    return step(*args)


def test_llama_sp_step_matches_the_jax_mesh_and_single_device(ran):
    cfg = _cfg()
    d = load_tree(ran / "in_llama_step.npz")
    params = jax.tree.map(jnp.asarray, d["params"])
    got = _out(ran, "llama_step")
    ref_p, _, ref_loss = _jax_step(cfg, params, jnp.asarray(d["ids"]))
    mesh_p, _, mesh_loss = _jax_step(cfg, params, jnp.asarray(d["ids"]),
                                     _mesh((2, 2, 2), ("dp", "fsdp", "tp")),
                                     sp=True)
    grads = _grads(cfg, params, jnp.asarray(d["ids"]))
    for loss, p in ((ref_loss, ref_p), (mesh_loss, mesh_p)):
        np.testing.assert_allclose(float(got["loss"]), float(loss),
                                   rtol=1e-5)
        _close_trees(got["params"], p, grads)


def test_llama_guarded_sp_step_matches_the_reference(ran):
    cfg = _cfg()
    d = load_tree(ran / "in_llama_step.npz")
    params = jax.tree.map(jnp.asarray, d["params"])
    got = _out(ran, "llama_step")
    grads = _grads(cfg, params, jnp.asarray(d["ids"]))
    for mesh in (None, _mesh((2, 2, 2), ("dp", "fsdp", "tp"))):
        kw = {} if mesh is None else {"sp": True}
        p, _, loss, health = _jax_step(cfg, params, jnp.asarray(d["ids"]),
                                       mesh, guard=True, numerics=True,
                                       **kw)
        np.testing.assert_allclose(float(got["gloss"]), float(loss),
                                   rtol=1e-5)
        assert bool(got["finite"]) and bool(health["finite"])
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(health["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(
            got["wq_absmax"], np.asarray(health["numerics"]["layers"]["wq"][
                "absmax"]), rtol=1e-4)
        _close_trees(got["gparams"], p, grads)
    # the guard's flag and norm are the same on every rank
    first, last = (load_json(ran / f"out_specs_r{r}.json") for r in (0, 7))
    assert first["grad_norm"] == last["grad_norm"]
    assert first["finite"] and last["finite"]


def test_param_placements_are_the_reference_specs(ran):
    """``tests/test_models.py::TestShardedLlama::test_param_placement``."""
    specs = JL.param_specs(_cfg())
    got = load_json(ran / "out_specs_r0.json")
    assert got["wq"] == str(specs["layers"]["wq"]) == \
        str(JP(None, "fsdp", "tp"))
    assert got["embed"] == str(specs["embed"]) == str(JP("tp", "fsdp"))
    assert got["batch"] == str(JP(("dp", "fsdp"), None))


def test_packed_mesh_step_matches_the_single_device_reference(ran):
    cfg = _cfg()
    d = load_tree(ran / "in_llama_packed.npz")
    params = jax.tree.map(jnp.asarray, d["params"])
    batch = tuple(jnp.asarray(d[k]) for k in ("inp", "labels", "seg",
                                               "pos"))
    p, _, loss = _jax_step(cfg, params, batch)
    got = _out(ran, "llama_packed")
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    _close_trees(got["params"], p, _grads(cfg, params, batch))


def test_make_forward_with_repeated_kv_heads_matches_the_reference(ran):
    """2 kv heads over tp 4: the seam repeats each kv head twice before
    the split. Logits against JAX ``forward``; greedy tokens against the
    JAX greedy ``generate`` (``test_tp_sharded_generate_...``)."""
    cfg = JL.llama_tiny()
    d = load_tree(ran / "in_forward_gqa.npz")
    params = jax.tree.map(jnp.asarray, d["params"])
    ids = jnp.asarray(d["ids"])
    got = _out(ran, "forward_gqa")
    np.testing.assert_allclose(got["logits"],
                               np.asarray(JL.forward(params, ids, cfg)),
                               rtol=1e-4, atol=1e-5)
    want = np.asarray(JL.generate(params, ids, cfg, max_new_tokens=4))
    np.testing.assert_array_equal(got["tokens"], want)
    assert load_json(ran / "out_forward_gqa_r0.json")["spec"] == str(
        JP(("dp", "fsdp"), None, "tp"))


def test_moe_ep_mesh_loss_matches_the_reference(ran):
    """``tests/test_models_extended.py::test_ep_sharded_matches_local``:
    the (2, 2, 2, 1) mesh with dense dispatch."""
    cfg = JM.moe_tiny()
    d = load_tree(ran / "in_moe.npz")
    local = JM.loss_fn(jax.tree.map(jnp.asarray, d["params"]),
                       jnp.asarray(d["ids"]), cfg)
    np.testing.assert_allclose(float(_out(ran, "moe")["loss"]),
                               float(local), rtol=2e-4)


def test_dit_mesh_loss_matches_the_reference(ran):
    """``tests/test_models_extended.py::test_sharded_matches_local`` on a
    tree whose zero gates are refilled."""
    cfg = JD.dit_tiny()
    d = load_tree(ran / "in_dit.npz")
    batch = tuple(jnp.asarray(d[k]) for k in ("x0", "t", "y", "noise"))
    local = JD.loss_fn(jax.tree.map(jnp.asarray, d["params"]), batch, cfg)
    np.testing.assert_allclose(float(_out(ran, "dit")["loss"]),
                               float(local), rtol=2e-4)


# -- in this process: specs, and the mesh of one ------------------------------

@pytest.mark.parametrize("spec", [(), (None,), ("tp", "fsdp"),
                                  (None, "fsdp", "tp"),
                                  (("dp", "fsdp"), None, "tp")])
def test_partition_spec_text_is_the_references(spec):
    from paddle_tpu_torch.distributed.spmd import P
    assert str(P(*spec)) == str(JP(*spec)) == repr(P(*spec))
    assert P(*spec) == tuple(spec)


def test_placements_of_a_spec():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from paddle_tpu_torch.core import enforce as TE
    from paddle_tpu_torch.distributed import spmd
    from _torch_mesh_common import one_rank_mesh
    with one_rank_mesh(("dp", "fsdp", "tp")) as mesh:
        assert spmd.placements(spmd.P(("dp", "fsdp"), None, "tp"), mesh) \
            == (Shard(0), Shard(0), Shard(2))
        assert spmd.placements(spmd.P(None, "fsdp"), mesh) == (
            Replicate(), Shard(1), Replicate())
        with pytest.raises(TE.InvalidArgumentError):
            spmd.placements(spmd.P(("fsdp", "dp")), mesh)
        with pytest.raises(TE.InvalidArgumentError):
            spmd.placements(spmd.P("tp", "tp"), mesh)
        assert dist.get_world_size() == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("policy,fwd", [("attn", 1), ("full", 2)])
def test_one_rank_mesh_step_launches_as_the_single_device_step(policy, fwd):
    """Remat ``"attn"`` keeps its saved flash outputs through the DTensor
    seam: L flash forwards a step against ``"full"``'s 2L, as the
    single-device step (CPU tensors count the plain versions)."""
    import torch

    from paddle_tpu_torch import kernels as TK
    from paddle_tpu_torch.models import llama as TL
    from _torch_mesh_common import one_rank_mesh
    cfg = TL.llama_tiny(remat=True, remat_policy=policy, fused_ce=False)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)))
    counts = {}
    with one_rank_mesh(("dp", "fsdp", "tp")) as mesh:
        for arm in ("mesh", "single"):
            p = TL.init_params(cfg, device="cpu")
            m = mesh if arm == "mesh" else None
            if m is not None:
                p = TL.shard_params(p, cfg, m)
            step = TL.make_train_step(cfg, m)
            TK.reset_dispatch_stats()
            step(p, TL.adamw_init(p), ids)
            counts[arm] = TK.dispatch_stats()
    L = cfg.num_hidden_layers
    assert counts["mesh"] == counts["single"]
    assert counts["mesh"]["flash_ref"] == fwd * L
    assert counts["mesh"]["flash_bwd_ref"] == L


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, imported by path."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mesh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["none", "ulp", "quiet_flip", "zero",
                                   "flip", "grad"])
def test_mesh_leaf_check_fails_a_skipped_or_reversed_step(fault):
    """The card's meshed-against-unmeshed step check
    (``chip_smoke.mesh_leaf_compare`` and ``_mesh_asserts``) on one AdamW
    first step of lr 1e-4 over bf16 matrices of std 0.02, a bf16 norm
    scale and a float32 matrix, with gradients of std 1e-3 and one entry
    in 100 quiet (1e-9): equal steps pass, one ulp in 1 entry of 2000
    passes, a quiet entry's reversed step passes; a skipped update, a
    reversed update and a reversed gradient fail. Where any entry is
    loud, the planted readings are over one half."""
    import torch
    C = _chip_smoke()
    lr = 1e-4
    g = torch.Generator().manual_seed(0)
    old = [(torch.randn(256, 64, generator=g) * 0.02).bfloat16(),
           torch.ones(64, dtype=torch.bfloat16),
           torch.randn(64, 8, generator=g) * 0.02]
    grads = [torch.randn(o.shape, generator=g) * 1e-3 for o in old]
    for gr in grads:
        gr.view(-1)[::100] = 1e-9

    def step(o, gr):
        u = gr / (gr.abs() + 1e-8)
        return (o.float() - lr * u).to(o.dtype)

    single = [step(o, gr) for o, gr in zip(old, grads)]
    m_single = [0.1 * gr for gr in grads]
    meshed, m_mesh = [s.clone() for s in single], list(m_single)
    if fault == "ulp":
        meshed[0].view(torch.int16).view(-1)[::2000] += 1
    elif fault == "quiet_flip":
        gr = grads[0].clone()
        gr.view(-1)[::100] = -1e-9
        meshed[0], m_mesh[0] = step(old[0], gr), 0.1 * gr
    elif fault == "zero":
        meshed = [o.clone() for o in old]
    elif fault == "flip":
        meshed = [(2 * o.float() - s.float()).to(o.dtype)
                  for o, s in zip(old, single)]
    elif fault == "grad":
        m_mesh = [-m for m in m_single]
        meshed = [step(o, -gr) for o, gr in zip(old, grads)]
    cmp = C.mesh_leaf_compare(torch, old, single, meshed, m_single, m_mesh,
                              lr)
    if fault == "grad":     # no entry is loud: the gradient check fails
        assert cmp["grad_rel"] > C.MESH_GRAD_RTOL and cmp["quiet"] == 1, cmp
    else:
        assert min(cmp["planted_zero"], cmp["planted_flip"]) > 0.5, cmp
    launches = {"loss": 1.0, "launches": dict.fromkeys(C.MESH_LAUNCH_KEYS,
                                                       0)}
    sides = {"single": launches, "mesh": launches}
    if fault in ("zero", "flip", "grad"):
        with pytest.raises(AssertionError):
            C._mesh_asserts(torch, fault, sides, cmp, lr, C.MESH_LAUNCH_KEYS)
        return
    C._mesh_asserts(torch, fault, sides, cmp, lr, C.MESH_LAUNCH_KEYS)
    assert (cmp["differ"] > 0) == (fault != "none"), cmp
