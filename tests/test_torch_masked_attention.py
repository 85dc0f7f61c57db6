"""Port parity: the masked attention path and the rest of the attention
surface (``nn/functional/attention.py``), and ``incubate``'s
``fused_rms_norm``, against the JAX package on the same numpy inputs.

- ``sdpa_raw`` with a boolean or additive mask (alone, with causal, with
  GQA) against JAX ``sdpa_reference``, forward and the input gradients
  against ``jax.vjp``; the mask path counts no flash launch.
- ``flash_attention_with_sparse_mask``, ``flash_attention``,
  ``flash_attn_qkvpacked``, ``fused_rotary_position_embedding`` (both
  rope styles, three table forms, ``position_ids``) and
  ``fused_rms_norm`` (the last axis, and trailing axes flattened, with a
  bias) against the JAX package's eager functions.
- Dropout by its statistics (its draws come from the port's generator):
  through identity values the output is the probabilities, each either
  zero or scaled by ``1 / (1 - p)``, kept at a rate within six binomial
  standard deviations of ``1 - p``; no dropout outside training.

Tolerances: float32 ``1e-5`` of the largest reference value (summation
order only); bfloat16 ``2e-2`` (the two frameworks round the bf16
probabilities at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional import attention as JATT
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.incubate.nn.functional as TIF
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import device as TD
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.nn.functional import attention as TATT

_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cpu_device():
    prev = TD._current_device
    tpaddle.set_device("cpu")
    yield
    TD._current_device = prev


def _qkv(seed, B=2, sq=16, sk=16, H=4, KVH=2, D=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, sq, H, D)).astype(np.float32),
            rng.normal(size=(B, sk, KVH, D)).astype(np.float32),
            rng.normal(size=(B, sk, KVH, D)).astype(np.float32))


def _masks(seed, B, H, sq, sk):
    """Masks of each broadcast form: ``[Sq, Sk]`` and ``[B, 1, Sq, Sk]``
    boolean (every row keeps its diagonal key, so no row is all masked),
    and a ``[B, H, Sq, Sk]`` additive one."""
    rng = np.random.default_rng(seed)
    eye = np.eye(sq, sk, k=sk - sq, dtype=bool)
    return {"bool_2d": (rng.random((sq, sk)) < 0.6) | eye,
            "bool_4d": (rng.random((B, 1, sq, sk)) < 0.5) | eye,
            "additive": rng.normal(size=(B, H, sq, sk)).astype(np.float32)}


def _close(got, want, dt):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= _TOL[dt] * np.abs(want).max()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bool_2d", "bool_4d", "additive"])
@pytest.mark.parametrize("causal,kvh", [(False, 4), (True, 2)])
def test_masked_sdpa_matches_jax_sdpa_reference(dt, kind, causal, kvh):
    q, k, v = _qkv(1, KVH=kvh)
    mask = _masks(2, 2, 4, 16, 16)[kind]
    want = JATT.sdpa_reference(
        *(jnp.asarray(a, _JDT[dt]) for a in (q, k, v)), jnp.asarray(mask),
        causal=causal)
    TK.reset_dispatch_stats()
    got = TATT.sdpa_raw(*(torch.as_tensor(a).to(_TDT[dt])
                          for a in (q, k, v)), torch.as_tensor(mask),
                        is_causal=causal)
    assert got.dtype == _TDT[dt] and TK.dispatch_stats()["flash_ref"] == 0
    _close(got, np.asarray(want, np.float32), dt)


def test_masked_sdpa_gradients_match_jax_vjp():
    q, k, v = _qkv(3, sq=8, sk=12)
    mask = _masks(4, 2, 4, 8, 12)["bool_4d"]
    dout = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: JATT.sdpa_reference(
        *a, jnp.asarray(mask), causal=True), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    t = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    TATT.sdpa_raw(*t, torch.as_tensor(mask), is_causal=True).backward(
        torch.as_tensor(dout))
    for a, b in zip(t, want):
        _close(a.grad, b, "float32")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_with_sparse_mask_matches_jax(cpu_device, causal):
    q, k, v = _qkv(6, H=2, KVH=2)
    starts = np.random.default_rng(7).integers(1, 17, (2, 2, 16))
    starts[..., 0] = 16          # row r always sees key 0: no empty row
    want = JF.flash_attention_with_sparse_mask(
        *(jpaddle.to_tensor(a) for a in (q, k, v)),
        jpaddle.to_tensor(starts), is_causal=causal)[0].numpy()
    got, none = TF.flash_attention_with_sparse_mask(
        *(torch.as_tensor(a) for a in (q, k, v)), torch.as_tensor(starts),
        is_causal=causal)
    assert none is None
    _close(got, want, "float32")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_and_qkvpacked_match_jax(cpu_device, causal):
    q, k, v = _qkv(8, H=2, KVH=2)
    want = JF.flash_attention(*(jpaddle.to_tensor(a) for a in (q, k, v)),
                              causal=causal)[0].numpy()
    TK.reset_dispatch_stats()
    got = TF.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                             causal=causal)[0]
    assert TK.dispatch_stats()["flash_ref"] == 1    # the flash wrapper
    _close(got, want, "float32")
    qkv = np.stack([q, k, v], axis=2)               # [B, S, 3, H, D]
    want = JF.flash_attn_qkvpacked(jpaddle.to_tensor(qkv),
                                   causal=causal)[0].numpy()
    got = TF.flash_attn_qkvpacked(torch.as_tensor(qkv), causal=causal)[0]
    _close(got, want, "float32")


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("tables", ["none", "half", "full_4d"])
@pytest.mark.parametrize("with_pos", [False, True])
def test_fused_rotary_position_embedding_matches_jax(cpu_device, neox,
                                                     tables, with_pos):
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if tables != "none":
        cos, sin = (a.numpy() for a in TATT.rope_tables(8, 16))
        if tables == "full_4d":    # [1, S, 1, D]: the halves repeated
            cos, sin = (np.concatenate([a, a], -1)[None, :, None]
                        for a in (cos, sin))
        kw_j = {"cos": jpaddle.to_tensor(cos), "sin": jpaddle.to_tensor(sin)}
        kw_t = {"cos": torch.as_tensor(cos), "sin": torch.as_tensor(sin)}
    if with_pos:
        pos = rng.integers(0, 8, (2, 8))
        kw_j["position_ids"] = jpaddle.to_tensor(pos)
        kw_t["position_ids"] = torch.as_tensor(pos)
    jq, jk, jv = JIF.fused_rotary_position_embedding(
        *(jpaddle.to_tensor(a) for a in (q, k, v)),
        use_neox_rotary_style=neox, **kw_j)
    tq, tk, tv = TIF.fused_rotary_position_embedding(
        *(torch.as_tensor(a) for a in (q, k, v)),
        use_neox_rotary_style=neox, **kw_t)
    _close(tq, jq.numpy(), "float32")
    _close(tk, jk.numpy(), "float32")
    np.testing.assert_array_equal(tv.numpy(), v)


@pytest.mark.parametrize("axis,bias", [(-1, False), (1, True)])
def test_fused_rms_norm_matches_jax(cpu_device, axis, bias):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 4, 8)).astype(np.float32)
    w = (1 + 0.3 * rng.normal(size=x.shape[axis:])).astype(np.float32)
    b = rng.normal(size=x.shape[axis:]).astype(np.float32) if bias else None
    jb = jpaddle.to_tensor(b) if bias else None
    want = JIF.fused_rms_norm(jpaddle.to_tensor(x), jpaddle.to_tensor(w),
                              jb, 1e-5, axis)[0].numpy()
    TK.reset_dispatch_stats()
    got, none = TIF.fused_rms_norm(
        torch.as_tensor(x), torch.as_tensor(w),
        torch.as_tensor(b) if bias else None, 1e-5, axis)
    assert none is None and TK.dispatch_stats()["rms_ref"] == 1
    _close(got, want, "float32")


def test_dropout_keeps_at_its_rate_and_scales_kept_probabilities(
        cpu_device):
    """Values are one-hot per key, so the output row is the row of
    (dropped) probabilities."""
    p, B, S, H = 0.25, 2, 32, 2
    q, k, _ = _qkv(11, B=B, sq=S, sk=S, H=H, KVH=H, D=S)
    v = np.broadcast_to(np.eye(S, dtype=np.float32)[None, :, None, :],
                        (B, S, H, S)).copy()
    t = [torch.as_tensor(a) for a in (q, k, v)]
    plain = TF.scaled_dot_product_attention(*t, is_causal=True)
    tpaddle.seed(3)
    out = TF.scaled_dot_product_attention(*t, dropout_p=p, is_causal=True)
    seen = plain > 0
    kept = out[seen] != 0
    np.testing.assert_allclose(out[seen][kept].numpy(),
                               (plain[seen][kept] / (1 - p)).numpy(),
                               rtol=1e-6)
    assert torch.all(out[~seen] == 0)
    n = int(seen.sum())
    bound = 6 * (n * p * (1 - p)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - p)) <= bound
    tpaddle.seed(3)
    again = TF.scaled_dot_product_attention(*t, dropout_p=p, is_causal=True)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    evald = TF.scaled_dot_product_attention(*t, dropout_p=p, is_causal=True,
                                            training=False)
    torch.testing.assert_close(evald, plain, rtol=0, atol=0)


def test_sdp_kernel_without_flash_takes_the_math_path(cpu_device):
    t = [torch.as_tensor(a) for a in _qkv(12)]
    TK.reset_dispatch_stats()
    with TF.sdp_kernel(enable_flash=False):
        got = TF.scaled_dot_product_attention(*t, is_causal=True)
    assert TK.dispatch_stats()["flash_ref"] == 0
    want = TF.scaled_dot_product_attention(*t, is_causal=True)
    assert TK.dispatch_stats()["flash_ref"] == 1
    _close(got, want.numpy(), "float32")
