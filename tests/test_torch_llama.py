"""Port parity: the Llama functional core
(``paddle_tpu_torch/models/llama.py``).

Weights are the JAX tree carried over with ``params_from_numpy``; the
forward logits are held to JAX ``forward`` on the same token ids in
float32 (``rtol=1e-5``, ``atol=1e-6``: summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import llama as TL


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_params_from_numpy_round_trips(jdt, tdt):
    """Every leaf keeps its path, shape, dtype and exact values; a bf16
    leaf (an ml_dtypes array that torch.from_numpy refuses) goes through
    float32 losslessly."""
    jp = JL.init_params(JL.llama_tiny(dtype=jdt), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = TL.params_from_numpy(tree, device="cpu")
    jf, tf = _flat(tree), _flat(tp)
    assert jf.keys() == tf.keys()
    for name, a in jf.items():
        t = tf[name]
        assert t.dtype == tdt and tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32), err_msg=name)
    # an explicit dtype casts every floating leaf
    up = TL.params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in _flat(up).values())


def test_init_params_matches_reference_layout():
    """Same leaves, shapes and dtypes as the JAX tree; deterministic per
    seed; normal(0, 0.02) projections and unit norms."""
    jp = jax.tree.map(np.asarray, JL.init_params(JL.llama_tiny(),
                                                 jax.random.PRNGKey(0)))
    cfg = TL.llama_tiny()
    a = TL.init_params(cfg, seed=1, device="cpu")
    b = TL.init_params(cfg, seed=1, device="cpu")
    c = TL.init_params(cfg, seed=2, device="cpu")
    for name, w in _flat(a).items():
        assert tuple(w.shape) == _flat(jp)[name].shape, name
        assert w.dtype == torch.float32
        assert torch.equal(w, _flat(b)[name])
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.all(a["layers"]["ln1"] == 1)
    assert abs(float(a["layers"]["gate"].std()) - 0.02) < 2e-3


def test_forward_logits_match_jax_f32():
    jcfg = JL.llama_tiny()
    jp = JL.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                            (2, 12)).astype(np.int32)
    want = np.asarray(JL.forward(jp, jnp.asarray(ids), jcfg))
    got = TL.forward(tp, torch.as_tensor(ids).long(), TL.llama_tiny())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_llama_3_8b_widths():
    c = TL.llama_3_8b()
    assert (c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
            c.head_dim, c.intermediate_size, c.vocab_size) == (
        4096, 32, 8, 128, 14336, 128256)
    assert c.dtype == torch.bfloat16
