"""Port parity: the lm-head logits (``models/llama.py`` ``_head_logits``)
and the materialising cross entropy of ``dispatched_fused_ce``.

The reference computes the head product with
``preferred_element_type=float32``: bfloat16 operands, float32 sums and
a float32 result that is never rounded to bfloat16. The port must do the
same. Inputs are bfloat16 values from a numpy seed, given to both
packages; the tolerance is ``1e-5 * max |logit|`` (summation order
only; a bfloat16 rounding of the product would be ~4e-3 of it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as JK
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.models import llama as TL

_REL = 1e-5


def _bf16_case(n=4, d=256, v=1000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    head = (0.1 * rng.normal(size=(v, d))).astype(np.float32)
    tx = torch.as_tensor(x).bfloat16()
    th = torch.as_tensor(head).bfloat16()
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(head, jnp.bfloat16),
            tx, th)


@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_bf16_head_logits_match_jax(lead):
    """2D rows (serving) and a [B, S, D] batch (``forward``)."""
    n = int(np.prod(lead))
    jx, jh, tx, th = _bf16_case(n=n)
    jx, tx = jx.reshape(*lead, -1), tx.reshape(*lead, -1)
    want = np.asarray(JL._head_logits(jx, jh))
    got = TL._head_logits(tx, th)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= _REL * float(np.abs(want).max()), err


def test_bf16_head_logits_gradients_flow_to_bf16_leaves():
    """The float32 product keeps a gradient to bfloat16 operands, as the
    reference's einsum does (each cotangent in its operand's dtype)."""
    _, _, tx, th = _bf16_case(n=3, d=32, v=50)
    tx.requires_grad_()
    th.requires_grad_()
    TL._head_logits(tx, th).square().sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    assert th.grad.dtype == torch.bfloat16
    xf, hf = tx.detach().float(), th.detach().float()
    gx = 2 * (xf @ hf.t()) @ hf
    assert float((tx.grad.float() - gx).abs().max()) <= \
        8e-3 * float(gx.abs().max())


@pytest.mark.parametrize("label", [17, 250])
def test_fused_ce_fallback_takes_float32_logits(label):
    """One token's hidden state ``[D]`` is a shape the blockwise loss
    does not take (it needs ``x.ndim >= 2``), in both packages, so the
    loss comes from the materialising fallback over bfloat16
    operands."""
    jx, jh, tx, th = _bf16_case(n=1, d=128, v=300, seed=1)
    TK.reset_dispatch_stats()
    got = TK.dispatched_fused_ce(tx[0], th, torch.tensor(label),
                                 reduction="none")
    assert TK.dispatch_stats()["fused_ce_fallback"] == 1
    want = float(JK.dispatched_fused_ce(jx[0], jh, jnp.asarray(label),
                                        reduction="none"))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= _REL * abs(want), (float(got), want)
