"""Port parity: weight-only quantization (``models/llama.py``
``quant_int8``, ``quant_packed``, ``unpack_int4``, ``quantize_weights``
and the dict branches of ``_mm`` / ``_head_logits``), and serving with
the quantized trees.

The same numpy weights go through both packages. Codes, nibble bytes and
scales must be equal byte for byte (the same float32 division and round
half to even). The dequantized products: float32 ``1e-6`` of the
largest magnitude (summation order only); bfloat16 one rounding of the
product (``8e-3``; both dequantize with an f32 multiply and ONE cast to
bfloat16, so the weights are identical and only the product's rounding
differs), and the head's float32 logits ``1e-5`` of the largest. Greedy
tokens of the engine exactly equal in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import llama as TL


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def tiny_tree():
    """One float32 ``llama_tiny`` JAX tree, drawn once for the file."""
    return JL.init_params(JL.llama_tiny(), jax.random.PRNGKey(1))


def _weights(shape=(3, 10, 6), seed=0):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    w[0, :, 1] = 0.0                     # an all-zero channel: scale 0
    w[1, 2, 3] = 0.5 * np.abs(w[1]).max()
    return w


@pytest.mark.parametrize("width", ["int8", "int4"])
@pytest.mark.parametrize("in_axis", [1, -1])
def test_quant_packed_matches_jax_byte_for_byte(width, in_axis):
    w = _weights()
    got = TL.quant_packed(torch.as_tensor(w), in_axis, width)
    want = jax.tree.map(np.asarray,
                        JL.quant_packed(jnp.asarray(w), in_axis, width))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == {"q": torch.int8, "q4": torch.int8,
                                "s": torch.float32}[k]
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if width == "int4":
        codes = TL.unpack_int4(got["q4"], in_axis)
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(JL.unpack_int4(jnp.asarray(
                want["q4"]), in_axis)))
        assert int(codes.min()) >= -8 and int(codes.max()) <= 7
    else:
        np.testing.assert_array_equal(
            TL.quant_int8(torch.as_tensor(w), in_axis)["q"].numpy(),
            want["q"])


def test_int4_nibble_layout():
    """Even index in the low nibble, odd in the high, sign-extended on
    the way back."""
    q4 = TL.quant_packed(torch.tensor([[7.0, -8.0 * 7 / 8, -7.0, 1.0]]),
                         1, "int4")["q4"]
    assert q4.tolist() == [[(-7 << 4) | 7, (1 << 4) | (-7 & 0x0F)]]
    assert TL.unpack_int4(q4, 1).tolist() == [[7, -7, -7, 1]]


def test_quant_packed_refuses_what_the_reference_refuses():
    with pytest.raises(TE.UnimplementedError):
        TL.quant_packed(torch.zeros(2, 4), 1, "int2")
    with pytest.raises(TE.PreconditionNotMetError):
        TL.quant_packed(torch.zeros(2, 5), 1, "int4")


@pytest.mark.parametrize("width", ["int8", "int4"])
@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_quantize_weights_and_params_from_numpy_match_jax(tiny_tree, width,
                                                         jdt, tdt):
    """The port's tree of the same weights equals the JAX tree, and the
    JAX tree carried over by ``params_from_numpy`` equals it too (int8
    codes stay int8, scales float32, the rest keeps its type)."""
    jp = jax.tree.map(lambda a: a.astype(jdt), tiny_tree)
    jq = jax.tree.map(np.asarray, JL.quantize_weights(jp, width))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    got = _flat(TL.quantize_weights(tp, width))
    carried = _flat(TL.params_from_numpy(jq, device="cpu", dtype=tdt))
    want = _flat(jq)
    assert got.keys() == want.keys() == carried.keys()
    for name, a in want.items():
        for t in (got[name], carried[name]):
            assert str(t.dtype).split(".")[-1] == a.dtype.name, name
            np.testing.assert_array_equal(t.float().numpy(),
                                          a.astype(np.float32),
                                          err_msg=name)
    assert got["layers/wq/" + ("q" if width == "int8" else "q4")].dtype \
        == torch.int8
    assert got["lm_head/s"].dtype == torch.float32
    assert got["embed"].dtype == tdt


@pytest.mark.parametrize("width", ["int8", "int4"])
@pytest.mark.parametrize("jdt,tdt,tol", [
    (jnp.float32, torch.float32, 1e-6),
    (jnp.bfloat16, torch.bfloat16, 8e-3)])
def test_dequant_products_match_jax(width, jdt, tdt, tol):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    head = rng.normal(size=(40, 32)).astype(np.float32)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    jw = JL.quant_packed(jnp.asarray(w), 0, width)
    jh = JL.quant_packed(jnp.asarray(head), 1, width)
    tw = TL.quant_packed(torch.as_tensor(w), 0, width)
    th = TL.quant_packed(torch.as_tensor(head), 1, width)
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    want = np.asarray(JL._mm(jx, jw).astype(jnp.float32))
    got = TL._mm(tx, tw)
    assert got.dtype == tdt
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err
    want = np.asarray(JL._head_logits(jx, jh))
    got = TL._head_logits(tx, th)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_forward_takes_a_quantized_tree():
    """``forward`` over a quantized tree equals ``forward`` over the
    dense tree of its dequantized weights (the same products)."""
    cfg = TL.llama_tiny()
    p = TL.init_params(cfg, seed=3, device="cpu")
    qp = TL.quantize_weights(p, "int4")
    dense = {"embed": qp["embed"], "ln_f": qp["ln_f"],
             "lm_head": TL._dequant(qp["lm_head"], -1, torch.float32),
             "layers": {k: v if torch.is_tensor(v)
                        else TL._dequant(v, -2, torch.float32)
                        for k, v in qp["layers"].items()}}
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 9)))
    torch.testing.assert_close(TL.forward(qp, ids, cfg),
                               TL.forward(dense, ids, cfg), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("width,kv_quant", [("int8", False), ("int4", True)])
def test_engine_with_quantized_weights_matches_jax(tiny_tree, width,
                                                  kv_quant):
    jcfg = JL.llama_tiny()
    jq = JL.quantize_weights(tiny_tree, width)
    tq = TL.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    rng = np.random.default_rng(8)
    trace = [(rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32), m)
             for n, m in zip((5, 8, 3), (7, 5, 6))]
    kw = dict(num_slots=2, max_len=16, page_size=4, num_pages=5,
              decode_chunk=2, kv_quant=kv_quant)
    jout = JEngine(JL, jq, jcfg, **kw).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(trace)])
    eng = ServingEngine(TL, tq, TL.llama_tiny(), device="cpu", **kw)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in enumerate(trace)])
    assert eng.stats.preempted >= 1
    for i, (_, m) in enumerate(trace):
        np.testing.assert_array_equal(out[i].tokens, jout[i].tokens)
        assert len(out[i].tokens) == m
