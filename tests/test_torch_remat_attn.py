"""Port parity: remat ``"attn"`` (``models/llama.py`` ``remat_policy``),
which keeps each layer's flash-attention output and recomputes the rest.

The flash forwards are registered ops (``torch.ops.paddle_tpu_torch.
flash_fwd`` / ``flash_fwd_seg``); inside ``through_ops()`` the autograd
Functions call them, and the selective-checkpoint policy saves their
``(out, lse)``. So under ``"attn"`` a step runs the forward kernel (on
CPU tensors, its plain version) once a layer, where ``"full"`` runs it
twice, and gets the same loss and gradients bit for bit: the same code
on the same inputs, the saved output standing for the recomputed one.
Both are held to JAX's ``"attn"`` step (``jax.checkpoint`` with
``save_only_these_names("attn_out")``): loss ``rtol=1e-5``, gradients
``rtol=1e-5, atol=1e-6`` (float32, summation order), the parameters
after one ``make_train_step`` as ``tests/test_torch_train.py`` holds
them. The MoE block tags
no attention output, so there ``"attn"`` acts as ``"full"``.
"""
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu.io import packing as JPK
from paddle_tpu.models import llama as JL
from paddle_tpu.models import moe as JM
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.kernels import flash_attention as TFA
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import moe as TM


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def _ids(vocab, shape, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _packed_batch(vocab):
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in (20, 9, 30)]
    return tuple(np.array(a) for a in JPK.packed_train_batch(
        JPK.pack_documents(docs, 32)))


def _run(tm, cfg, params, batch):
    TK.reset_dispatch_stats()
    loss, grads = tm.loss_and_grads(params, batch, cfg) if tm is TM else \
        TL.loss_and_grads(params, batch, cfg)
    return loss, _named(grads), TK.dispatch_stats()


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_attn_equals_full_bit_for_bit_with_half_the_forwards(packed):
    cfg = {p: TL.llama_tiny(remat=True, remat_policy=p)
           for p in ("full", "attn")}
    params = TL.init_params(cfg["full"], seed=3, device="cpu")
    batch = _packed_batch(256) if packed else _ids(256, (2, 17))
    fwd, bwd = ("varlen_ref", "varlen_bwd_ref") if packed else \
        ("flash_ref", "flash_bwd_ref")
    out = {p: _run(TL, c, params, batch) for p, c in cfg.items()}
    L = cfg["full"].num_hidden_layers
    assert out["full"][2][fwd] == 2 * L and out["attn"][2][fwd] == L
    assert out["full"][2][bwd] == out["attn"][2][bwd] == L
    assert torch.equal(out["full"][0], out["attn"][0])
    for name, g in out["full"][1].items():
        assert torch.equal(g, out["attn"][1][name]), name


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_attn_matches_the_jax_attn_step(packed):
    jcfg = JL.llama_tiny(remat=True, remat_policy="attn")
    cfg = TL.llama_tiny(remat=True, remat_policy="attn")
    jp = JL.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = _packed_batch(256) if packed else _ids(256, (2, 17))
    jbatch = tuple(map(jnp.asarray, batch)) if packed else jnp.asarray(batch)
    want_loss, want_g = jax.value_and_grad(
        lambda p: JL.loss_fn(p, jbatch, jcfg))(jp)
    loss, grads, _ = _run(TL, cfg, tp, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_g = {jtu.keystr(p): np.asarray(v)
              for p, v in jtu.tree_flatten_with_path(want_g)[0]}
    assert grads.keys() == want_g.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # one step of make_train_step on both sides
    jp2, _, jl = JL.make_train_step(jcfg, donate=False)(
        jp, JL.adamw_init(jp), jbatch)
    _, _, tl = TL.make_train_step(cfg)(tp, TL.adamw_init(tp), batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # parameters as tests/test_torch_train.py holds them: 1e-5, but
    # entries whose gradient is at noise level, where a sign flip moves
    # Adam's first step by up to 2 lr (under 0.1% of the entries)
    want_p = {jtu.keystr(p): np.asarray(v)
              for p, v in jtu.tree_flatten_with_path(jp2)[0]}
    noisy = total = 0
    for name, t in _named(tp).items():
        g = np.abs(want_g[name])
        quiet = g < 1e-6 * g.max()
        err = np.abs(t.numpy() - want_p[name])
        assert np.all(err[~quiet] <= 1e-5), name
        assert np.all(err[quiet] <= 2 * 3e-4 + 1e-5), name
        noisy += int((err[quiet] > 1e-5).sum())
        total += err.size
    assert noisy <= 1e-3 * total


def test_moe_attn_acts_as_full():
    cfg = {p: TM.moe_tiny(remat=True, remat_policy=p)
           for p in ("full", "attn")}
    params = TM.init_params(cfg["full"], seed=4, device="cpu")
    batch = _ids(cfg["full"].vocab_size, (2, 13))
    out = {p: _run(TM, c, params, batch) for p, c in cfg.items()}
    L = cfg["full"].num_hidden_layers
    assert out["attn"][2]["flash_ref"] == out["full"][2]["flash_ref"] == 2 * L
    assert torch.equal(out["full"][0], out["attn"][0])
    for name, g in out["full"][1].items():
        assert torch.equal(g, out["attn"][1][name]), name
    jcfg = JM.moe_tiny(remat=True, remat_policy="attn")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want = JM.loss_fn(jp, jnp.asarray(batch), jcfg)
    got, _, _ = _run(TM, cfg["attn"], tp, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


class _Ops(TorchDispatchMode):
    """Records every op that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


def test_forwards_take_the_registered_ops_only_inside_through_ops():
    """Outside ``through_ops()`` the Functions call the wrapper directly
    (no op dispatch on the common paths); inside, the registered op,
    whose fake implementation gives the output shapes."""
    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, requires_grad=True)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)[None]
    for ctx, want in ((torch.enable_grad(), 0), (TFA.through_ops(), 1)):
        with ctx, _Ops() as rec:
            dense = TFA.flash_attention(q, k, k, causal=True)
            packed = TFA.flash_attention_segments(q, k, k, seg, seg, pos,
                                                  pos, causal=True)
        assert rec.seen.count(TFA.FLASH_FWD_OPS[0]) == want
        assert rec.seen.count(TFA.FLASH_FWD_OPS[1]) == want
        assert dense.shape == packed.shape == q.shape
    from torch._subclasses.fake_tensor import FakeTensorMode
    qd, kd = q.detach(), k.detach()
    with FakeTensorMode() as mode:
        fq, fk = mode.from_tensor(qd), mode.from_tensor(kd)
        out, lse = torch.ops.paddle_tpu_torch.flash_fwd(fq, fk, fk, True,
                                                        0.25)
        assert out.shape == (1, 8, 4, 16) and lse.shape == (1, 4, 8)
        assert lse.dtype == torch.float32
