"""The flash pair at every head dim the Pallas kernels take that the
port's kernels take too: ``D % 8 == 0`` from 8 to 256.

The plain versions the port's wrappers run for CPU tensors (dense
``flash_attention_ref`` / ``flash_attention_bwd_ref``, segment
``segment_attention_ref`` / ``segment_attention_bwd_ref``) are held to
``jax.vjp`` of the JAX package's Pallas kernels in interpret mode at D
24, 40, 72, 136, 192 and 256, with GQA (4 query, 2 kv heads), causal and
not: outputs ``atol=1e-5``, gradients ``rtol=1e-4, atol=5e-4`` (float32;
summation order only). ``supported`` and the C entries' ``bad_shape``
take exactly that domain; the CUDA kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as TFA

JFA = importlib.import_module("paddle_tpu.kernels.flash_attention")
CSRC = Path(TFA.__file__).resolve().parent.parent / "csrc"

HEAD_DIMS = [24, 40, 72, 136, 192, 256]


def _qkv(seed, d, sq=32, sk=32, H=4, KVH=2, B=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, s, n, d)).astype(np.float32)
                 for s, n in ((sq, H), (sk, KVH), (sk, KVH), (sq, H)))


def _jax_vjp(f, q, k, v, dout):
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _check(out, grads, want_out, want_grads):
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    for g, w in zip(grads, want_grads):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_dense_plain_versions_match_pallas(d, causal):
    q, k, v, dout = _qkv(d, d)
    want_out, want_grads = _jax_vjp(
        lambda q, k, v: JFA.flash_attention(q, k, v, causal=causal,
                                            interpret=True, block_q=16,
                                            block_k=16), q, k, v, dout)
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, dout))
    out, lse = TFA.flash_attention_ref(tq, tk, tv, causal=causal)
    grads = TFA.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg,
                                        causal=causal)
    _check(out, grads, want_out, want_grads)


def _packed(b, s):
    """Two rows of documents (10, 14, 5 and 20, 9) with padding tails:
    segment ids (-1 padding) and segment-local positions, int32."""
    seg = np.full((b, s), -1, np.int32)
    pos = np.zeros((b, s), np.int32)
    for r, lens in enumerate(([10, 14, 5], [20, 9])[:b]):
        o = 0
        for i, n in enumerate(lens):
            seg[r, o:o + n], pos[r, o:o + n] = i, np.arange(n)
            o += n
    return seg, pos


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_segment_plain_versions_match_pallas(d, causal):
    q, k, v, dout = _qkv(100 + d, d)
    seg, pos = _packed(2, 32)
    segs = (seg, seg, pos, pos)
    want_out, want_grads = _jax_vjp(
        lambda q, k, v: JFA.flash_attention_segments(
            q, k, v, *segs, causal=causal, interpret=True, block_q=16,
            block_k=16), q, k, v, dout)
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, dout))
    ts = [torch.as_tensor(a) for a in segs]
    out, lse = TFA.segment_attention_ref(tq, tk, tv, *ts, causal=causal)
    grads = TFA.segment_attention_bwd_ref(tq, tk, tv, out, lse, tg, *ts,
                                          causal=causal)
    _check(out, grads, want_out, want_grads)
    pad = torch.as_tensor(seg < 0)
    assert torch.all(out[pad] == 0) and torch.all(grads[0][pad] == 0)
    assert torch.all(grads[1][pad] == 0) and torch.all(grads[2][pad] == 0)


def _zeros(d, dtype, h=4, kvh=2, s=8):
    return (torch.zeros(1, s, h, d, dtype=dtype),
            torch.zeros(1, s, kvh, d, dtype=dtype),
            torch.zeros(1, s, kvh, d, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_supported_takes_every_multiple_of_8_to_256(dtype):
    seg = torch.zeros(1, 8, dtype=torch.int32)
    for d in range(8, 257, 8):
        q, k, v = _zeros(d, dtype)
        assert TFA.supported(q, k, v) and TFA.supported_bwd(q, k, v), d
        assert TFA.segments_supported(q, k, v, seg, seg, seg, seg), d
        assert TFA.tensor_core_route(q) is (dtype == torch.bfloat16
                                            and d in (64, 72, 128)), d
    for d in (1, 4, 12, 20, 36, 100, 252, 260, 264, 512):
        q, k, v = _zeros(d, dtype)
        assert not TFA.supported(q, k, v), d
        assert not TFA.segments_supported(q, k, v, seg, seg, seg, seg), d
    assert (TFA.MIN_D, TFA.MAX_D) == (8, 256)
    # the Pallas kernel takes every D <= 256: the port's domain is inside
    for d in (24, 72, 256):
        jq = jnp.zeros((1, 16, 4, d))
        jk = jnp.zeros((1, 16, 2, d))
        assert JFA.supported(jq, jk, jk), d


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd.cu"])
def test_c_entries_refuse_what_supported_refuses(source):
    """Each source's ``bad_shape`` refuses ``D % 8 != 0``, ``D < 8`` and
    ``D > MAX_D`` with ``MAX_D`` 256, the wrapper's ``supported``."""
    text = (CSRC / source).read_text()
    assert re.search(r"constexpr int MAX_D = (\d+);", text).group(1) == \
        str(TFA.MAX_D)
    body = re.search(r"bool bad_shape\([^)]*\) \{([^}]*)\}", text).group(1)
    assert "D % 8 != 0 || D < 8 || D > MAX_D" in " ".join(body.split())
