"""Port parity: capacity dispatch on a mesh (ROADMAP A9b).

The reference runs ``dispatch_mode="capacity"`` under a mesh by letting
GSPMD shard ``_moe_mlp_capacity`` over the global token matrix: the
capacity ``C`` takes the global token count and drops fall in global
token-major order. The port's ranks run as gloo processes
(``tests/_torch_mesh_worker.py``, ``case_moe_cap_*``) on a ``dp=2`` mesh
and a ``dp=2, ep=2`` mesh; the JAX side runs here on its fake CPU devices
on the same meshes, and on one device. ``moe_tiny`` at capacity factor
0.5 on a ``[4, 17]`` batch, whose dispatch drops slots (asserted).
Tolerances, float32: logits and aux ``rtol=1e-5, atol=1e-6``, the loss
``rtol=1e-5``, every gradient leaf ``rtol=1e-4, atol=1e-6`` (summation
order over ranks), one train step's loss ``rtol=1e-5``.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
from jax.sharding import Mesh

from paddle_tpu.models import moe as JM

from _torch_mesh_common import launched, load_tree, save_tree

CAPACITY_FACTOR = 0.5
MESHES = {"moe_cap_dp2": (2, 1, 1, 1), "moe_cap_dp2_ep2": (2, 1, 2, 1)}


def _cfg():
    return JM.moe_tiny(dispatch_mode="capacity",
                       capacity_factor=CAPACITY_FACTOR)


def _inputs():
    params = jax.tree.map(np.asarray,
                          JM.init_params(_cfg(), jax.random.key(3)))
    ids = np.random.default_rng(1).integers(0, 256, (4, 17)).astype(
        np.int32)
    return params, ids


def _prepare(tmp):
    params, ids = _inputs()
    save_tree(tmp / "in_moe_cap.npz",
              {"params": params, "ids": ids,
               "capacity_factor": np.float32(CAPACITY_FACTOR)})


@pytest.fixture(scope="module", params=sorted(MESHES))
def ran(request, tmp_path_factory):
    name = request.param
    world = int(np.prod(MESHES[name]))
    return name, launched(tmp_path_factory, name, world, [name], _prepare)


def _jax_side(shape):
    """Forward, loss and gradients of the reference on ``shape``'s mesh
    of fake devices (``None``: one device)."""
    cfg = _cfg()
    params, ids = _inputs()
    params = jax.tree.map(jnp.asarray, params)
    ids = jnp.asarray(ids)
    mesh = None
    if shape is not None:
        mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))])
                    .reshape(shape), ("dp", "fsdp", "ep", "tp"))

    def run():
        fwd = jax.jit(lambda p, b: JM.forward(p, b, cfg, mesh=mesh))
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(p, b, cfg, mesh=mesh)))
        return fwd(params, ids), vg(params, ids)

    if mesh is None:
        return run()
    with mesh:
        return run()


def test_the_batch_drops_slots(monkeypatch):
    """At capacity factor 0.5 the global batch's dispatch drops slots in
    every layer (``C`` = 17 slots an expert for 68 tokens x 2 choices
    over 4 experts), counted on the port's one-device forward, whose
    routing equals the reference's (``tests/test_torch_moe.py``)."""
    import torch
    from paddle_tpu_torch.models import moe as TM
    cfg = TM.moe_tiny(dispatch_mode="capacity",
                      capacity_factor=CAPACITY_FACTOR)
    params, ids = _inputs()
    assert TM.moe_capacity(cfg, ids.size) == 17
    seen = []
    route = TM._route

    def recording(x, lp, config):
        out = route(x, lp, config)
        seen.append(out[1])
        return out

    monkeypatch.setattr(TM, "_route", recording)
    with torch.no_grad():
        TM.forward(TM.params_from_numpy(params, device="cpu"),
                   torch.as_tensor(ids), cfg)
    assert len(seen) == cfg.num_hidden_layers
    for topi in seen:
        counts = torch.bincount(topi.reshape(-1),
                                minlength=cfg.num_experts)
        assert int((counts - 17).clamp(min=0).sum()) > 0


def test_capacity_mesh_matches_the_reference(ran):
    name, tmp = ran
    got = load_tree(tmp / f"out_{name}.npz")
    (logits, aux), (loss, grads) = _jax_side(MESHES[name])
    (l1, a1), (loss1, _) = _jax_side(None)
    np.testing.assert_allclose(got["logits"], np.asarray(logits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["aux"], np.asarray(aux), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    # GSPMD computes the one-device function
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(float(got["step_loss"]), float(loss),
                               rtol=1e-5)
    flat = {jtu.keystr(p): np.asarray(v)
            for p, v in jtu.tree_flatten_with_path(grads)[0]}
    gg = got["grads"]
    for key, want in flat.items():
        node = gg
        for part in key.strip("[]'").split("']['"):
            node = node[part]
        np.testing.assert_allclose(node, want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name} {key}")
    assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                            for v in gg.values())
