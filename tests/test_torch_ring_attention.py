"""The port's ring attention (``paddle_tpu_torch/kernels/ring_attention.py``)
on 4 "sp" gloo ranks against the JAX reference's, at the reference's
three cases (``tests/test_parallel.py::TestRingAttention``: values rtol /
atol 1e-5, gradients rtol 1e-4 / atol 5e-4). The ranks run once for the
module (``tests/_torch_mesh_worker.py`` case ``ring``); the JAX ring
runs here on 4 of its fake CPU devices."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from paddle_tpu.nn.functional.attention import sdpa_reference

from _torch_mesh_common import launched, load_tree, save_tree

JRA = importlib.import_module("paddle_tpu.kernels.ring_attention")
SHAPES = [(2, 64, 4, 4, 32, True), (1, 128, 4, 2, 32, True),
          (2, 64, 2, 2, 16, False)]


def _qkv(rng, b, s, h, kv, d):
    return {"q": rng.normal(size=(b, s, h, d)).astype(np.float32),
            "k": rng.normal(size=(b, s, kv, d)).astype(np.float32),
            "v": rng.normal(size=(b, s, kv, d)).astype(np.float32)}


def _inputs():
    rng = np.random.default_rng(0)
    tree = {f"c{i}": {**_qkv(rng, *shape[:5]), "causal": np.array(shape[5])}
            for i, shape in enumerate(SHAPES)}
    tree["grad"] = {"q": rng.normal(size=(1, 64, 2, 16)).astype(np.float32)}
    tree["gqa"] = _qkv(rng, 1, 64, 4, 2, 16)
    return tree


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    tree = _inputs()
    tmp = launched(tmp_path_factory, "ring", 4, ["ring"],
                   lambda d: save_tree(d / "in_ring.npz", tree))
    return tree, load_tree(tmp / "out_ring.npz")


def _mesh():
    return Mesh(np.array(jax.devices()[:4]), ("sp",))


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_ring_attention_matches_the_reference(ran, case):
    tree, got = ran
    c = tree[f"c{case}"]
    q, k, v = (jnp.asarray(c[n]) for n in "qkv")
    causal = bool(c["causal"])
    want = JRA.ring_attention(q, k, v, _mesh(), causal=causal)
    np.testing.assert_allclose(got[f"out{case}"], np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got[f"out{case}"], np.asarray(sdpa_reference(q, k, v,
                                                     causal=causal)),
        rtol=1e-5, atol=1e-5)


def test_ring_attention_gradients_match_the_reference(ran):
    tree, got = ran
    # the reference's gradient test holds its ring to sdpa_reference's
    # gradient; the port's ring is held to the same
    q = jnp.asarray(tree["grad"]["q"])
    want = jax.grad(lambda q: (sdpa_reference(
        q, q, q, causal=True) ** 2).sum())(q)
    np.testing.assert_allclose(got["dq"], np.asarray(want), rtol=1e-4,
                               atol=5e-4)
    g = tree["gqa"]
    args = tuple(jnp.asarray(g[n]) for n in "qkv")
    want = jax.grad(lambda q, k, v: (sdpa_reference(
        q, k, v, causal=True) ** 2).sum(), argnums=(0, 1, 2))(*args)
    for n, w in zip("qkv", want):
        np.testing.assert_allclose(got[f"gqa_d{n}"], np.asarray(w),
                                   rtol=1e-4, atol=5e-4)
