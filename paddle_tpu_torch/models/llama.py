"""Llama model family, functional core (port of
``paddle_tpu/models/llama.py``).

Parameters are a plain dict of tensors in the reference's pytree layout:
per-layer weights stacked on a leading ``[L, ...]`` axis and matmul
weights stored ``[in, out]`` (``x @ w``), so a JAX parameter tree crosses
over through numpy without transposes (``params_from_numpy``). The layer
loop is a Python loop over the stacked axis, each layer under
``torch.utils.checkpoint`` when the config asks for remat.

Serving also takes the weight-only-quantized tree of ``quantize_weights``
(int8 or packed int4 codes with float32 per-output-channel scales):
``_mm`` and ``_head_logits`` dequantize each such weight in plain
PyTorch before its product, as the reference leaves both to XLA.

Generation over a static ring cache ``[L, B, max_len, kv, hd]``, as the
reference: ``init_cache``, ``prefill`` (attention through the flash
kernel), ``decode_step`` (one position written in place, float32
attention over the whole cache in plain PyTorch, the reference's
einsum), ``generate`` (greedy, or temperature then top-k / top-p
sampling from a ``torch.Generator``; EOS and pad masking) and
``beam_search``. The loops are family-generic (``_generate_over`` /
``_beam_search_over``); the MoE family runs them over its own MLP.

Training: ``loss_fn`` (blockwise cross entropy), ``adamw_init`` /
``_adamw_update`` (the reference's AdamW math) and ``make_train_step``,
which updates the parameters in place (the counterpart of donation),
optionally guarded (``training.guards``: the update applies only to a
healthy step).

The eager Paddle-surface model, ``LlamaForCausalLM`` over
``LlamaDecoderLayer``, is built from ``nn.Layer``s (``Embedding``,
``Linear`` with ``[in, out]`` weights, ``RMSNorm`` through the fused
RMSNorm kernels) and trained as PaddleNLP users train it: ``model(ids)``,
``F.cross_entropy``, ``loss.backward()``, ``optimizer.AdamW``.
``functional_params()`` exports its weights as the functional tree
above, and its ``generate`` runs the ring-cache generation on them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .. import nn
from ..core import enforce as E
from ..core import resolve_device
from ..core.tensor import from_numpy
from ..distributed import spmd
from ..distributed.spmd import P
from ..kernels.flash_attention import FLASH_FWD_OPS, through_ops
from ..kernels.fused_ce import _mm_f32, vocab_parallel_xent
from ..nn import functional as PF
from ..nn.functional.attention import gather_rope_rows, rope_raw
from ..nn.functional.attention import rope_tables as _rope_tables
from ..nn.functional.attention import sdpa_raw
from ..optimizer.optimizer import adam_update_
from ..training.guards import (gated_update, grad_numerics, resolve_guard,
                               resolve_numerics, step_health)

__all__ = ["LlamaConfig", "llama_tiny", "llama_3_8b", "init_params",
           "params_from_numpy", "quant_int8", "quant_packed",
           "unpack_int4", "quantize_weights", "forward_hidden", "forward",
           "decode_mlp", "init_cache", "prefill", "decode_step",
           "sampling_filter", "make_sampler", "generate", "beam_search",
           "remat_policy", "unpack_batch", "loss_fn", "count_params",
           "loss_and_grads", "adamw_init", "make_train_step",
           "param_specs", "shard_params", "shard_batch", "make_forward",
           "LlamaDecoderLayer", "LlamaForCausalLM"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True              # per-layer rematerialisation
    # "full" recomputes the whole layer; "dots" keeps the products of
    # the weight matmuls and recomputes the rest; "attn" keeps only the
    # flash forward's output and lse
    remat_policy: str = "dots"
    fused_ce: bool = True           # blockwise lm-head cross entropy
    # vocab chunk of the blockwise cross entropy; None: CE_DEFAULT_CHUNK
    fused_ce_chunk: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_tiny(**kw) -> LlamaConfig:
    """Small config for tests."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, dtype=torch.float32, remat=False)
    base.update(kw)
    return LlamaConfig(**base)


def llama_3_8b(**kw) -> LlamaConfig:
    """Llama-3-8B shapes."""
    base = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                num_hidden_layers=32, num_attention_heads=32,
                num_key_value_heads=8, max_position_embeddings=8192,
                rope_theta=500000.0)
    base.update(kw)
    return LlamaConfig(**base)


def init_params(config: LlamaConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Parameter dict drawn from a ``torch.Generator`` seeded with
    ``seed``: normal(0, 0.02) for projections and embeddings, ones for
    norms (the reference's recipe; the numbers differ from JAX's draw).
    Stacked weights are drawn one layer at a time in float32, so the
    float32 copy never exceeds one layer."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    hd, nh, nkv = c.head_dim, c.num_attention_heads, c.num_key_value_heads
    L, D, Ff, V = (c.num_hidden_layers, c.hidden_size, c.intermediate_size,
                   c.vocab_size)

    def nrm(shape):
        out = torch.empty(shape, dtype=c.dtype, device=dev)
        for part in (out if len(shape) == 3 else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * 0.02)
        return out

    params = {
        "embed": nrm((V, D)),
        "layers": {
            "ln1": torch.ones((L, D), dtype=c.dtype, device=dev),
            "wq": nrm((L, D, nh * hd)),
            "wk": nrm((L, D, nkv * hd)),
            "wv": nrm((L, D, nkv * hd)),
            "wo": nrm((L, nh * hd, D)),
            "ln2": torch.ones((L, D), dtype=c.dtype, device=dev),
            "gate": nrm((L, D, Ff)),
            "up": nrm((L, D, Ff)),
            "down": nrm((L, Ff, D)),
        },
        "ln_f": torch.ones((D,), dtype=c.dtype, device=dev),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = nrm((V, D))
    return params


def params_from_numpy(tree, device=None, dtype=None):
    """The port's parameter dict from a JAX parameter tree converted to
    numpy (``jax.tree.map(np.asarray, params)``). A bfloat16 leaf arrives
    as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
    refuses; ``core.tensor.from_numpy`` takes it through float32
    (lossless) and back to bfloat16.
    ``dtype`` casts every floating leaf but a MoE tree's ``router``,
    which stays float32 in every tree, as the reference draws it;
    ``None`` keeps the source type. A weight-only-quantized tree
    (``quantize_weights``) keeps its int8 codes and its float32 scales
    as they are."""
    dev = resolve_device(device)

    def leaf(a, cast=True):
        t = from_numpy(a)
        if cast and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            quant = "s" in node and ("q" in node or "q4" in node)
            return {k: leaf(v, cast=False) if quant or k == "router"
                    else walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def _rms(x, w, eps):
    if spmd.is_dtensor(x):
        return spmd.rowwise(functools.partial(_rms, eps=eps), x, w)
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _dequant(w, in_axis: int, dtype):
    """A weight-only-quantized leaf (``{"q": int8, "s"}`` or ``{"q4":
    int8 nibble pairs, "s"}``) as a dense weight in ``dtype``: the
    reference's ordering, an f32 multiply ``q * s`` and ONE cast. The
    scale is per output channel; ``in_axis`` is the contraction axis of
    the codes.

    One elementwise pass: ``mul`` takes the product in the inputs'
    common type (float32) and rounds it once to ``dtype`` on store, the
    numbers of ``(q.float() * s).to(dtype)`` without its two float32
    temporaries (a third of the device-memory traffic)."""
    q = unpack_int4(w["q4"], in_axis) if "q4" in w else w["q"]
    s = w["s"].unsqueeze(in_axis % q.ndim)
    return torch.mul(q, s, out=torch.empty(q.shape, dtype=dtype,
                                           device=q.device))


def _mm(x, w):
    """Matmul against a plain ``[in, out]`` weight or its weight-only
    form ``{"q"|"q4", "s": f32 [out]}`` (dequantized in plain PyTorch,
    then the product, as the reference leaves both to XLA). DTensors (a
    mesh) multiply on their local shards (``spmd.matmul``)."""
    if spmd.is_dtensor(x):
        return spmd.matmul(x, w)
    if isinstance(w, dict):
        return x @ _dequant(w, -2, x.dtype)
    return x @ w


def _head_logits(x2d, head):
    """lm-head logits ``[.., V]`` from hidden ``[.., D]``; head is ``[V,
    D]`` or its weight-only form ``{"q"|"q4", "s": f32 [V]}``. The
    product is summed and returned in float32, never rounded to
    bfloat16 (the reference's ``preferred_element_type=float32``)."""
    if isinstance(head, dict):
        head = _dequant(head, -1, x2d.dtype)
    return _mm_f32(x2d, head.t())


# -- weight-only quantization -------------------------------------------------

def quant_int8(w, in_axis: int):
    """Per-out-channel absmax int8 quantization of a (stacked) weight:
    ``|w|`` reduced over ``in_axis`` (the contraction axis), scale
    ``absmax / 127``, codes ``clamp(round(w / max(s, 1e-10)), ±127)``.
    Returns ``{"q": int8, "s": f32}`` with the reduced axis dropped."""
    return quant_packed(w, in_axis, "int8")


def quant_packed(w, in_axis: int, weight_dtype: str = "int8"):
    """``quant_int8`` over a code width: ``"int8"`` gives ``{"q", "s"}``;
    ``"int4"`` takes scale ``absmax / 7`` and codes in ``[-8, 7]``, then
    packs two codes along ``in_axis`` into one byte (even index in the
    low nibble, odd in the high): ``{"q4": int8 with in_axis halved,
    "s"}``. ``torch.round`` rounds half to even, as ``jnp.round``."""
    E.enforce(weight_dtype in ("int8", "int4"),
              f"weight-only serving supports int8 and packed int4, got "
              f"{weight_dtype!r}", error=E.UnimplementedError)
    in_axis = in_axis % w.ndim
    qmax, qmin = (127.0, -127.0) if weight_dtype == "int8" else (7.0, -8.0)
    wf = w.float()
    s = wf.abs().amax(dim=in_axis, keepdim=True) / qmax
    q = torch.clamp(torch.round(wf / torch.clamp(s, min=1e-10)),
                    qmin, qmax).to(torch.int8)
    s = s.squeeze(in_axis)
    if weight_dtype == "int8":
        return {"q": q, "s": s}
    E.enforce(w.shape[in_axis] % 2 == 0,
              f"int4 packing needs an even contraction dim, got "
              f"{w.shape[in_axis]} on axis {in_axis} of "
              f"{tuple(w.shape)}")
    lead = (slice(None),) * in_axis
    lo, hi = q[lead + (slice(0, None, 2),)], q[lead + (slice(1, None, 2),)]
    return {"q4": (lo & 0x0F) | (hi << 4), "s": s}


def unpack_int4(q4, in_axis: int):
    """Inverse of ``quant_packed``'s nibble pack: both nibbles of each
    byte sign-extended (arithmetic shifts) and re-interleaved along
    ``in_axis``, which doubles; int8 codes in ``[-8, 7]``."""
    in_axis = in_axis % q4.ndim
    lo = (q4 << 4) >> 4
    hi = q4 >> 4
    shape = list(q4.shape)
    shape[in_axis] *= 2
    return torch.stack([lo, hi], dim=in_axis + 1).reshape(shape)


def quantize_weights(params, weight_dtype: str = "int8"):
    """Weight-only quantization of a parameter dict for serving: every
    matmul weight (the per-layer attention and MLP matrices and the lm
    head) becomes ``quant_packed`` of it over its contraction axis; the
    norms and the embedding stay full precision (the embedding is
    gathered, not multiplied; with tied embeddings it also serves the
    head in full precision)."""
    out = {"embed": params["embed"], "layers": {}, "ln_f": params["ln_f"]}
    for name, w in params["layers"].items():
        out["layers"][name] = w if name.startswith("ln") else \
            quant_packed(w, 1, weight_dtype)
    if "lm_head" in params:
        out["lm_head"] = quant_packed(params["lm_head"], 1, weight_dtype)
    return out


# the batch axes of every activation on a mesh (the reference's
# ``("dp", "fsdp")`` entry)
BATCH = ("dp", "fsdp")


def _act_spec(sp: bool):
    """The residual stream ``[B, S, D]`` on a mesh: batch over dp and
    fsdp, the sequence over tp when sequence-parallel (Megatron-SP: the
    norms and elementwise work run on sequence shards, gathered before
    the column-parallel products and reduce-scattered after the
    row-parallel ones)."""
    return P(BATCH, "tp" if sp else None, None)


def _heads_spec(mesh, n_heads: int):
    """Placement of a ``[B, S, heads, hd]`` grid: heads over tp, unless
    the heads do not split evenly over tp (kv heads fewer than tp), when
    they stay whole and the attention seam repeats them
    (``nn.functional.attention._sdpa_sharded``)."""
    tp = spmd.axis_size(mesh, "tp")
    return P(BATCH, None, "tp" if n_heads % tp == 0 else None, None)


def _qkv_proj(h, lp, config: LlamaConfig, mesh=None):
    """Attention input projections ``[B, S, D]`` -> q/k/v head grids (no
    rope). On a mesh the heads shard over tp (the reference's constraint
    sites)."""
    c = config
    B, S, _ = h.shape
    nh, nkv, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim

    def heads(w, n):
        spec = _heads_spec(mesh, n)
        y = _mm(h, w)
        if spec[2] is None:     # whole heads: gather the tp columns first
            y = spmd.constrain(y, mesh, P(BATCH, None, None))
        return spmd.constrain(y.reshape(B, S, n, hd), mesh, spec)

    return heads(lp["wq"], nh), heads(lp["wk"], nkv), heads(lp["wv"], nkv)


def _ffn(x, lp, config: LlamaConfig, mesh=None, sp: bool = False):
    """Post-attention half of a decoder layer (ln2 + SwiGLU + residual);
    on a mesh column-parallel gate / up and a row-parallel down."""
    h = spmd.constrain(_rms(x, lp["ln2"], config.rms_norm_eps), mesh,
                       _act_spec(False))
    g = spmd.constrain(_mm(h, lp["gate"]), mesh, P(BATCH, None, "tp"))
    u = spmd.constrain(_mm(h, lp["up"]), mesh, P(BATCH, None, "tp"))
    a = spmd.elementwise(lambda gl, ul: F.silu(gl) * ul, g, u)
    return spmd.elementwise(torch.add, x, spmd.constrain(
        _mm(a, lp["down"]), mesh, _act_spec(sp)))


def decode_mlp(x, lp, config: LlamaConfig):
    """Post-attention half of a decode-path layer: the family seam the
    paged serving path (``inference/paged.py``) composes with."""
    return _ffn(x, lp, config)


def _slice(w, i):
    """Layer ``i`` of a stacked leaf: a tensor or a weight-only dict."""
    if isinstance(w, dict):
        return {k: v[i] for k, v in w.items()}
    return w[i]


def layer(params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked weights (views, no copies;
    weight-only ``{"q"|"q4", "s"}`` leaves slice both parts)."""
    return {k: _slice(w, i) for k, w in params["layers"].items()}


def _block(x, lp, cos, sin, config: LlamaConfig, segment_ids=None,
           positions=None, mesh=None, sp: bool = False):
    """One decoder layer. ``segment_ids`` / ``positions`` select the
    sequence-packed attention (``sdpa_raw``). On a mesh the layer's
    weights are first gathered over fsdp (``_zero3_gather``)."""
    lp = _zero3_gather(lp, mesh)
    x, _, _ = _attn_half(x, lp, cos, sin, config, segment_ids, positions,
                         mesh, sp)
    return _ffn(x, lp, config, mesh, sp)


def _zero3_gather(lp, mesh):
    """ZeRO-3: one layer's weights gathered over the fsdp axis, each
    keeping its other shards (tp, ep). Inside the block, so remat
    gathers again in the backward, and autograd reduce-scatters the
    gradients back to the fsdp shards. Without a mesh, ``lp``."""
    if mesh is None:
        return lp
    return {k: spmd.gather_axis(w, "fsdp") for k, w in lp.items()}


def _attn_half(x, lp, cos, sin, config, segment_ids=None, positions=None,
               mesh=None, sp: bool = False):
    """Attention half of a decoder layer (ln1, q/k/v, rope, causal
    ``sdpa_raw``, output projection, residual), shared with the MoE
    family and the prefill: ``(x, k after rope, v)``. On a mesh the
    sequence is gathered before the projections (sequence-parallel) and
    the output projection's partial sums reduce to ``_act_spec(sp)``."""
    c = config
    B, S, _ = x.shape
    h = spmd.constrain(_rms(x, lp["ln1"], c.rms_norm_eps), mesh,
                       _act_spec(False))
    q, k, v = _qkv_proj(h, lp, c, mesh)
    q = spmd.local(rope_raw, mesh, None, q, cos, sin)
    k = spmd.local(rope_raw, mesh, None, k, cos, sin)
    a = sdpa_raw(q, k, v, is_causal=True, segment_ids=segment_ids,
                 positions=positions).reshape(B, S, -1)
    return spmd.elementwise(torch.add, x, spmd.constrain(
        _mm(a, lp["wo"]), mesh, _act_spec(sp))), k, v


def _save_flash_outputs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat ``"attn"``: keep the outputs of
    the flash forward ops, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in FLASH_FWD_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _through_ops(ctx):
    """``ctx`` (a selective-checkpoint context) with the flash forwards
    called through their ops, which the context can see."""
    with through_ops(), ctx:
        yield


def _attn_contexts():
    fwd, recompute = create_selective_checkpoint_contexts(_save_flash_outputs)
    return _through_ops(fwd), _through_ops(recompute)


def remat_policy(name: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a config's
    remat policy name: none for ``"full"`` (recompute everything),
    selective checkpointing that keeps the outputs of ``aten.mm`` /
    ``aten.addmm`` (the weight matmuls; attention's products run inside
    its kernel) for ``"dots"``, and for ``"attn"`` selective
    checkpointing that keeps only the flash forward's ``(out, lse)``
    (the reference's ``checkpoint_name(a, "attn_out")``), so the
    backward's recompute launches no flash forward. The flash forwards
    run through their registered ops (``kernels.flash_attention.
    through_ops``) under that policy only."""
    if name == "full":
        return noop_context_fn
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 [torch.ops.aten.mm.default,
                                  torch.ops.aten.addmm.default])
    if name == "attn":
        return _attn_contexts
    raise E.InvalidArgumentError(
        f"remat_policy must be one of ['attn', 'dots', 'full'], got "
        f"{name!r}")


def forward_hidden(params, ids, config: LlamaConfig, *, sp: bool = False,
                   mesh=None, segment_ids=None, positions=None):
    """Final hidden states ``[B, S, D]`` (post ln_f) from token ids.

    ``segment_ids`` / ``positions`` ``[B, S]`` select sequence-packed
    semantics: rope positions restart per document and attention is
    segment-masked (``sdpa_raw``). With a ``mesh`` the parameters are
    DTensors placed by ``param_specs`` and the ids a DTensor (or a tensor
    that is the same on every rank); ``sp`` shards the residual stream's
    sequence over tp."""
    return _layers_over(_block, params, ids, config, segment_ids,
                        positions, mesh=mesh, sp=sp)[0]


def _embed_on_mesh(params, ids, mesh, sp, segment_ids, positions):
    """The mesh form of the embedding: the vocab-parallel gather of the
    table's tp shards (each rank looks up the ids in its rows, the
    partial rows reduce), the batch DTensors placed, the rope tables
    replicated."""
    ids = shard_batch(ids, mesh)
    table = spmd.constrain(params["embed"], mesh, P("tp", None))
    v = table.shape[0]
    tp = spmd.axis_size(mesh, "tp")
    offset = spmd.axis_rank(mesh, "tp") * (-(-v // tp))

    def lookup(i, t):
        # the rows of this rank's vocab shard; other ids give zeros
        mine = (i >= offset) & (i < offset + t.shape[0])
        rows = F.embedding((i - offset).clamp(0, t.shape[0] - 1), t)
        return rows * mine[..., None].to(rows.dtype)

    x = spmd.local(lookup, mesh, spmd.partial_on(
        spmd.placements(P(BATCH), mesh), mesh, ("tp",)), ids, table,
        grads=[None, spmd.partial_on(table, mesh, BATCH)])
    x = spmd.constrain(x, mesh, _act_spec(sp))
    seg = pos = None
    if segment_ids is not None:
        seg = shard_batch(segment_ids, mesh)
    if positions is not None:
        pos = shard_batch(positions, mesh)
    return ids, x, seg, pos


def _layers_over(block, params, ids, config, segment_ids=None,
                 positions=None, *, tags_attn: bool = True, mesh=None,
                 sp: bool = False):
    """The layer loop of any family: embed ``ids``, run ``block(x, lp,
    cos, sin, config, segment_ids, positions, mesh, sp)`` over the
    stacked layers,
    apply ln_f. ``block`` returns ``x``, or ``(x, aux)``; returns
    ``(hidden [B, S, D], [each layer's aux])``. The stacked weights are
    split into per-layer views once (``unbind``), so their gradient is
    stacked once. With ``config.remat`` and grad enabled, each layer runs
    under ``torch.utils.checkpoint`` with ``config.remat_policy``. A
    family whose block tags no attention output (``tags_attn=False``, the
    MoE block, as in the reference) runs ``"attn"`` as ``"full"``. With a
    ``mesh`` the parameters are DTensors."""
    c = config
    if mesh is None:
        x = params["embed"][ids]
    else:
        ids, x, segment_ids, positions = _embed_on_mesh(
            params, ids, mesh, sp, segment_ids, positions)
    cos, sin = _rope_tables(ids.shape[1], c.head_dim, theta=c.rope_theta,
                            device=x.device)
    if mesh is not None:
        cos, sin = spmd.replicate(cos, mesh), spmd.replicate(sin, mesh)
    if positions is not None:
        # segment-local rope rows (sequence packing), each rank's own
        cos, sin = spmd.local(gather_rope_rows, mesh,
                              [P(BATCH, None, None)] * 2, cos, sin,
                              positions)
    per_layer = {k: w.unbind(0) if torch.is_tensor(w)
                 else [_slice(w, i) for i in range(c.num_hidden_layers)]
                 for k, w in params["layers"].items()}
    remat = c.remat and torch.is_grad_enabled()
    policy = c.remat_policy
    if policy == "attn" and not tags_attn:
        policy = "full"
    context_fn = remat_policy(policy) if remat else None
    auxes = []
    for i in range(c.num_hidden_layers):
        lp = {k: w[i] for k, w in per_layer.items()}
        if remat:
            x = checkpoint(block, x, lp, cos, sin, c, segment_ids,
                           positions, mesh, sp, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = block(x, lp, cos, sin, c, segment_ids, positions, mesh, sp)
        if isinstance(x, tuple):
            x, aux = x
            auxes.append(aux)
    return _rms(x, params["ln_f"], c.rms_norm_eps), auxes


def _head(params, config: LlamaConfig):
    return params["embed"] if config.tie_word_embeddings \
        else params["lm_head"]


def _sharded_logits(x, head, mesh):
    """The mesh form of ``_head_logits``: each rank multiplies its batch
    rows by its tp rows of the head (gathered over fsdp), so the float32
    logits come out vocab-parallel, ``P(BATCH, None, "tp")``."""
    x = spmd.constrain(x, mesh, _act_spec(False))
    head = spmd.gather_axis(head, "fsdp")
    return spmd.local(lambda a, w: _mm_f32(a, w.t()), mesh,
                      P(BATCH, None, "tp"), x, head,
                      grads=[spmd.partial_on(x, mesh, ("tp",)),
                             spmd.partial_on(head, mesh, BATCH)])


def forward(params, ids, config: LlamaConfig, *, sp: bool = False,
            mesh=None, segment_ids=None, positions=None):
    """Logits ``[B, S, V]`` (float32) from token ids ``[B, S]``
    (sequence-packed with ``segment_ids`` / ``positions``); on a mesh a
    DTensor placed ``P(BATCH, None, "tp")``."""
    x = forward_hidden(params, ids, config, sp=sp, mesh=mesh,
                       segment_ids=segment_ids, positions=positions)
    if mesh is not None:
        return _sharded_logits(x, _head(params, config), mesh)
    return _head_logits(x, _head(params, config))


# -- ring-cache decoding ------------------------------------------------------
#
# A static [L, B, max_len, kv, hd] cache per sequence batch: prefill fills
# positions [0, S), each decode step writes one position in place and
# attends over the whole buffer with the positions past it masked (the
# reference's shapes; it writes with dynamic_update_slice). ``pos`` is a
# Python int, so no step reads the device to learn where to write.

def init_cache(config, batch: int, max_len: int, dtype=None, *,
               device=None):
    """Zeroed decode cache ``{"k", "v": [L, batch, max_len, kv, hd],
    "pos": 0}`` in ``dtype`` (default ``config.dtype``)."""
    c = config
    dev = resolve_device(device)
    dt = dtype if dtype is not None else c.dtype
    shape = (c.num_hidden_layers, batch, max_len, c.num_key_value_heads,
             c.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


def _attn_over_cache(q, kc, vc, pos: int):
    """One query row ``q`` ``[B, 1, nh, hd]`` against a layer's cache
    ``kc`` / ``vc`` ``[B, M, nkv, hd]`` in float32, positions after
    ``pos`` masked out; ``[B, 1, nh * hd]`` float32. The whole buffer is
    read every step, as in the reference."""
    B, M, nkv, hd = kc.shape
    nh = q.shape[2]
    qf = q.float().reshape(B, nkv, nh // nkv, hd)
    scores = torch.einsum("bkgd,bmkd->bkgm", qf, kc.float()) / math.sqrt(hd)
    mask = torch.arange(M, device=q.device) <= pos
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgm,bmkd->bkgd", p, vc.float())
    return out.reshape(B, 1, nh * hd)


def _prefill_over(mlp, head, params, ids, config, cache):
    """``prefill`` of a family whose decoder layer is ``_attn_half`` then
    ``mlp(x, lp, config)`` and whose head is ``head(params, config)``."""
    c = config
    S = ids.shape[1]
    E.enforce(S <= cache["k"].shape[2],
              f"prompt length {S} exceeds cache max_len "
              f"{cache['k'].shape[2]}")
    x = params["embed"][ids]
    cos, sin = _rope_tables(S, c.head_dim, theta=c.rope_theta,
                            device=x.device)
    for i in range(c.num_hidden_layers):
        lp = layer(params, i)
        x, k, v = _attn_half(x, lp, cos, sin, c)
        x = mlp(x, lp, c)
        cache["k"][i, :, :S] = k      # post-rope k, raw v
        cache["v"][i, :, :S] = v
    x = _rms(x, params["ln_f"], c.rms_norm_eps)
    logits = _head_logits(x[:, -1, :], head(params, c))
    return {"k": cache["k"], "v": cache["v"], "pos": S}, logits


def _decode_step_over(mlp, head, params, cache, token, config):
    """``decode_step`` of a family, as ``_prefill_over``."""
    c = config
    pos = int(cache["pos"])
    M = cache["k"].shape[2]
    E.enforce(pos < M, f"decode position {pos} is past the cache's "
              f"max_len {M}")
    x = params["embed"][token][:, None, :]                 # [B, 1, D]
    cos_t, sin_t = _rope_tables(M, c.head_dim, theta=c.rope_theta,
                                device=x.device)
    cos, sin = cos_t[pos:pos + 1], sin_t[pos:pos + 1]      # prefill's rows
    for i in range(c.num_hidden_layers):
        lp = layer(params, i)
        h = _rms(x, lp["ln1"], c.rms_norm_eps)
        q, k, v = _qkv_proj(h, lp, c)
        q = rope_raw(q, cos, sin)
        k = rope_raw(k, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        a = _attn_over_cache(q, kc, vc, pos)
        x = mlp(x + _mm(a.to(x.dtype), lp["wo"]), lp, c)
    x = _rms(x, params["ln_f"], c.rms_norm_eps)
    logits = _head_logits(x[:, 0, :], head(params, c))
    return {"k": cache["k"], "v": cache["v"], "pos": pos + 1}, logits


@torch.no_grad()
def prefill(params, ids, config: LlamaConfig, cache):
    """Consume the prompt ``ids`` ``[B, S]``: writes ``cache[:, :, :S]``
    in place and returns ``(cache, last-position logits [B, V])`` with
    ``pos`` ``S``. Attention goes through ``sdpa_raw`` (the flash
    kernel on the card)."""
    return _prefill_over(decode_mlp, _head, params, ids, config, cache)


@torch.no_grad()
def decode_step(params, cache, token, config: LlamaConfig):
    """One incremental step: ``token`` ``[B]`` sits at ``cache["pos"]``;
    its k / v are written there in place. Returns ``(cache, logits [B,
    V])`` for the next position, ``pos`` advanced by one."""
    return _decode_step_over(decode_mlp, _head, params, cache, token, config)


def _top_k_stable(x, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, equal values in index order (the order of ``lax.top_k``, which
    ``torch.topk`` does not promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sampling_filter(logits, top_k: Optional[int] = None,
                    top_p: Optional[float] = None):
    """The logits ``make_sampler`` draws from: entries below the
    ``top_k``-th largest, then those outside the nucleus, set to -inf.
    The nucleus keeps, over the descending order, every token whose
    preceding cumulative probability is still below ``top_p`` (the
    first always survives)."""
    if top_k is not None:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]),
                         dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        cut = torch.where(cum < top_p, srt, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cut, float("-inf"))
    return logits


def make_sampler(temperature: float = 0.0, *, top_k: Optional[int] = None,
                 top_p: Optional[float] = None):
    """``sample(logits [B, V], generator) -> [B]`` int32: the argmax at
    temperature 0; otherwise the logits over ``temperature`` (first, so
    the nucleus is taken on the tempered distribution), then
    ``sampling_filter``, then one categorical draw a row from
    ``generator`` (a ``torch.Generator`` on the logits' device). The
    draws are not those of the reference, whose keys are JAX's."""
    if top_p is not None:
        E.enforce(0.0 < top_p <= 1.0, f"top_p must be in (0, 1], got "
                  f"{top_p}", error=E.InvalidArgumentError)

    def sample(logits, generator=None):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(
            sampling_filter(logits.float() / temperature, top_k, top_p),
            dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    return sample


def _generator(generator, device):
    """A ``torch.Generator`` on ``device``: the one given, or one seeded
    with the given int (default 0, the reference's ``PRNGKey(0)``)."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(
        0 if generator is None else int(generator))


def generate(params, ids, config: LlamaConfig, *, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             generator=None):
    """Autoregressive generation over the ring cache: greedy at
    temperature 0, else temperature sampling with optional top-k /
    nucleus filtering, and EOS stopping. ``ids`` ``[B, S]`` (a tensor or
    an array, brought to the parameters' device); returns int32 ``[B,
    max_new_tokens]``. With ``eos_token_id``, positions after a row's EOS
    hold ``pad_token_id`` (finished rows keep decoding; their outputs are
    masked). ``generator`` (a ``torch.Generator`` or an int seed) stands
    where the reference takes a JAX key; its draws differ."""
    return _generate_over(
        prefill, decode_step, params, ids, config,
        max_new_tokens=max_new_tokens, max_len=max_len,
        temperature=temperature, top_k=top_k, top_p=top_p,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id,
        generator=generator)


@torch.no_grad()
def _generate_over(prefill_fn, decode_fn, params, ids, config, *,
                   max_new_tokens: int, max_len: Optional[int] = None,
                   temperature: float = 0.0,
                   top_k: Optional[int] = None, top_p: Optional[float] = None,
                   eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                   generator=None):
    """The sampling loop of any family whose ``(prefill, decode_step)``
    run over ``init_cache``'s ring cache: ``max_new_tokens - 1`` decode
    steps; the last token is sampled from the carried logits."""
    c = config
    dev = params["embed"].device
    ids = torch.as_tensor(ids, device=dev)
    B, S = ids.shape
    M = max_len if max_len is not None else S + max_new_tokens
    E.enforce(M >= S + max_new_tokens,
              f"max_len {M} < prompt {S} + max_new_tokens "
              f"{max_new_tokens}")
    if max_new_tokens == 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    sample = make_sampler(temperature, top_k=top_k, top_p=top_p)
    gen = None if temperature == 0.0 else _generator(generator, dev)
    cache = init_cache(c, B, M, device=dev)
    cache, logits = prefill_fn(params, ids, c, cache)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    pad = torch.tensor(pad_token_id, dtype=torch.int32, device=dev)
    out = []
    for t in range(max_new_tokens):
        tok = sample(logits, gen)
        if eos_token_id is not None:
            out.append(torch.where(done, pad, tok))
            done = done | (tok == eos_token_id)
        else:
            out.append(tok)
        if t + 1 < max_new_tokens:
            cache, logits = decode_fn(params, cache, tok, c)
    return torch.stack(out, dim=1)


def beam_search(params, ids, config: LlamaConfig, *, max_new_tokens: int,
                num_beams: int, max_len: Optional[int] = None,
                length_penalty: float = 0.0,
                eos_token_id: Optional[int] = None, pad_token_id: int = 0):
    """Beam search over the ring cache: one prefill, then each step one
    decode over the ``B * K`` beam rows, the global top ``K`` of
    ``running score + log-softmax`` over ``[K, V]`` (equal totals in
    index order, as the reference's ``lax.top_k``), and the cache
    reordered along the beam axis with a gather. A beam that emitted EOS
    is frozen: its only continuation is ``pad_token_id`` at zero score.
    The final ranking divides scores by ``generated_length **
    length_penalty``. Returns ``(tokens [B, max_new_tokens] int32 of the
    best beam, its scores [B] float32)``."""
    return _beam_search_over(
        prefill, decode_step, params, ids, config,
        max_new_tokens=max_new_tokens, num_beams=num_beams,
        max_len=max_len, length_penalty=length_penalty,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id)


@torch.no_grad()
def _beam_search_over(prefill_fn, decode_fn, params, ids, config, *,
                      max_new_tokens: int, num_beams: int,
                      max_len: Optional[int] = None,
                      length_penalty: float = 0.0,
                      eos_token_id: Optional[int] = None,
                      pad_token_id: int = 0):
    """The beam loop of any family with the cache contract (see
    ``_generate_over``)."""
    c = config
    dev = params["embed"].device
    ids = torch.as_tensor(ids, device=dev)
    B, S = ids.shape
    K = num_beams
    E.enforce(K >= 1, f"num_beams must be >= 1, got {K}")
    M = max_len if max_len is not None else S + max_new_tokens
    E.enforce(M >= S + max_new_tokens,
              f"max_len {M} < prompt {S} + max_new_tokens "
              f"{max_new_tokens}")
    # beam 0 starts live, the rest at -inf, so step 1 picks K distinct
    # tokens of the prompt's distribution
    scores = torch.full((B, K), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    if max_new_tokens == 0:
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                scores[:, 0].clone())
    cache = init_cache(c, B, M, device=dev)
    cache, logits = prefill_fn(params, ids, c, cache)   # logits [B, V]
    cache = {"k": cache["k"].repeat_interleave(K, dim=1),
             "v": cache["v"].repeat_interleave(K, dim=1),
             "pos": cache["pos"]}
    V = logits.shape[-1]
    logits = logits.repeat_interleave(K, dim=0)          # [B * K, V]
    pad_only = torch.full((V,), float("-inf"), device=dev)
    pad_only[pad_token_id] = 0.0          # a negative id wraps, as in JAX
    pad = torch.tensor(pad_token_id, dtype=torch.int32, device=dev)
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)
    row0 = torch.arange(B, device=dev)[:, None] * K
    toks, bidx = [], []
    for t in range(max_new_tokens):
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        # frozen beams: only pad continues, at zero additional score
        logp = torch.where(done[:, :, None], pad_only, logp)
        total = scores[:, :, None] + logp                # [B, K, V]
        scores, flat = _top_k_stable(total.reshape(B, K * V), K)
        beam_idx = flat // V
        tok = (flat % V).to(torch.int32)
        done = done.gather(1, beam_idx)
        lengths = lengths.gather(1, beam_idx) + (~done).to(torch.int32)
        # a frozen beam records the literal pad id (which may be
        # negative), not its wrapped score slot
        tok = torch.where(done, pad, tok)
        if eos_token_id is not None:
            done = done | ((tok == eos_token_id) & ~done)
        toks.append(tok)
        bidx.append(beam_idx)
        if t + 1 < max_new_tokens:
            rows = (row0 + beam_idx).reshape(-1)
            cache = {"k": cache["k"].index_select(1, rows),
                     "v": cache["v"].index_select(1, rows),
                     "pos": cache["pos"]}
            cache, logits = decode_fn(params, cache, tok.reshape(-1), c)
    # each final beam's path, walked back through its parents
    beam = torch.arange(K, device=dev).repeat(B, 1)
    path = []
    for tok, bi in zip(reversed(toks), reversed(bidx)):
        path.append(tok.gather(1, beam))
        beam = bi.gather(1, beam)
    path = torch.stack(path[::-1], dim=-1)              # [B, K, T]
    norm = lengths.clamp(min=1).float() ** length_penalty
    ranked = scores / norm
    best = torch.argmax(ranked, dim=1)
    best_toks = path[torch.arange(B, device=dev), best]
    return best_toks, ranked.gather(1, best[:, None])[:, 0]


# -- training -----------------------------------------------------------------

def unpack_batch(batch):
    """A train-step batch as ``(inp, labels, segment_ids, positions)``:

    - ids ``[B, S+1]`` (labels are the shifted ids),
    - ``(inp, labels)``,
    - ``(inp, labels, segment_ids, positions)``: sequence-packed rows,
    - ``{"ids", "labels", "segment_ids", "positions"}``: the packing
      collator's output.
    """
    if isinstance(batch, dict):
        return (batch["ids"], batch["labels"],
                batch.get("segment_ids"), batch.get("positions"))
    if isinstance(batch, (tuple, list)):
        if len(batch) == 4:
            return batch[0], batch[1], batch[2], batch[3]
        inp, labels = batch
        return inp, labels, None, None
    return batch[:, :-1], batch[:, 1:], None, None


def loss_fn(params, batch, config: LlamaConfig, *, sp: bool = False,
            mesh=None):
    """Causal-LM cross entropy of a batch in any ``unpack_batch`` form:
    the blockwise cross entropy over the final hidden states with
    ``config.fused_ce`` (the ``[B, S, V]`` logits never exist whole), else
    the materialising one over ``forward``'s logits; both leave out
    ``ignore_index`` labels and take the mean over the valid tokens.

    Sequence-packed batches carry per-token segment ids and segment-local
    positions (``io/packing.py``), and their labels hold ``ignore_index``
    at every document's last token, so no document predicts the next
    one's first token.

    With a ``mesh`` the logits always materialise, vocab-parallel, and the
    cross entropy reduces across the tp shards
    (``kernels.fused_ce.vocab_parallel_xent``), as the reference's mesh
    path never fuses."""
    from ..kernels import dispatched_fused_ce
    from ..kernels.fused_ce import masked_xent_from_logits
    inp, labels, seg, pos = unpack_batch(batch)
    c = config
    if mesh is not None:
        logits = forward(params, inp, c, sp=sp, mesh=mesh, segment_ids=seg,
                         positions=pos)
        return vocab_parallel_xent(logits, shard_batch(labels, mesh), mesh)
    if c.fused_ce:
        x = forward_hidden(params, inp, c, segment_ids=seg, positions=pos)
        return dispatched_fused_ce(x, _head(params, c), labels,
                                   vocab_chunk=c.fused_ce_chunk)
    return masked_xent_from_logits(
        forward(params, inp, c, segment_ids=seg, positions=pos), labels)


def param_specs(config: LlamaConfig) -> Dict[str, Any]:
    """Placement of every weight over a ``("dp", "fsdp", "tp")`` mesh:
    Megatron column-parallel (wq / wk / wv / gate / up: output dim on
    tp), row-parallel (wo / down: input dim on tp), vocab-parallel
    embedding and head; fsdp (ZeRO-3) shards the other matmul dim."""
    specs = {
        "embed": P("tp", "fsdp"),
        "layers": {
            "ln1": P(None, None),
            "wq": P(None, "fsdp", "tp"),
            "wk": P(None, "fsdp", "tp"),
            "wv": P(None, "fsdp", "tp"),
            "wo": P(None, "tp", "fsdp"),
            "ln2": P(None, None),
            "gate": P(None, "fsdp", "tp"),
            "up": P(None, "fsdp", "tp"),
            "down": P(None, "tp", "fsdp"),
        },
        "ln_f": P(None),
    }
    if not config.tie_word_embeddings:
        specs["lm_head"] = P("tp", "fsdp")
    return specs


def shard_params(params, config, mesh, specs=None):
    """A parameter tree (the same on every rank, e.g. ``init_params`` or
    ``params_from_numpy`` of a JAX tree) as DTensors placed by
    ``param_specs`` (or ``specs``) on ``mesh``. Each rank keeps its own
    shard of its own copy: nothing is sent, and where a shard is the
    whole tensor (a mesh of one) it is the tree's tensor itself, which a
    train step then updates in place."""
    specs = param_specs(config) if specs is None else specs

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return spmd.shard(p, mesh, s)

    return walk(params, specs)


def shard_batch(x, mesh):
    """A batch array ``[B, ...]`` (the same on every rank) or DTensor
    placed over the batch axes, ``P(BATCH)``."""
    if x is None:
        return None
    if not spmd.is_dtensor(x):
        x = torch.as_tensor(x, device=mesh.device_type)
    return spmd.shard(x, mesh, P(BATCH))


def count_params(config: LlamaConfig) -> int:
    c = config
    hd = c.head_dim
    per_layer = (c.hidden_size * hd * (c.num_attention_heads +
                                       2 * c.num_key_value_heads)
                 + c.num_attention_heads * hd * c.hidden_size
                 + 3 * c.hidden_size * c.intermediate_size
                 + 2 * c.hidden_size)
    n = c.vocab_size * c.hidden_size + c.num_hidden_layers * per_layer \
        + c.hidden_size
    if not c.tie_word_embeddings:
        n += c.vocab_size * c.hidden_size
    return n


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in _leaves(tree[key])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def adamw_init(params, moment_dtype=torch.float32):
    """Adam state: the step count and zero moments like every parameter,
    stored in ``moment_dtype`` (float32, or bfloat16 to halve their
    memory; the update math runs in float32 either way)."""
    return {"step": 0,
            "m": _map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                      params),
            "v": _map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                      params)}


@torch.no_grad()
def _adamw_update(params, grads, opt_state, lr, *, b1=0.9, b2=0.95,
                  eps=1e-8, wd=0.1):
    """One AdamW step, ``optimizer.adam_update_`` of every leaf in the
    reference's coupled order ``p - lr * (u + wd * p)`` (decay from the
    float32 weight before the step), with the bias corrections rounded in
    float32 as the reference's are. Updates ``params`` and the moments in
    place (one leaf at a time, so the float32 temporaries never exceed
    one leaf) and returns ``(params, opt_state)``. The update is
    elementwise, so DTensor leaves (a mesh; the gradients in their
    parameters' placements) are updated on their local shards."""
    step = opt_state["step"] + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(opt_state["m"]), _leaves(opt_state["v"])):
        if spmd.is_dtensor(p):
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        p.copy_(adam_update_(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                             bc1=bc1, bc2=bc2, wd=wd, coupled=True))
    opt_state["step"] = step
    return params, opt_state


def _batch_to(batch, device):
    """A batch in any ``unpack_batch`` form with every array on
    ``device`` (DTensors stay where their mesh holds them)."""
    def to(v):
        return v if spmd.is_dtensor(v) else torch.as_tensor(v, device=device)
    if isinstance(batch, dict):
        return {k: to(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return tuple(to(v) for v in batch)
    return to(batch)


def loss_and_grads(params, batch, config: LlamaConfig, *, loss=None):
    """``(loss, grads)``: ``loss_fn`` (or the family's ``loss``) and the
    gradient of every parameter, as a tree like ``params``. The
    parameters need not require grad (the gradient is taken through
    detached aliases of them); the batch (tensors or numpy arrays) is
    brought to their device. A DTensor parameter's gradient comes back in
    the parameter's placements (partial sums reduced)."""
    loss = loss_fn if loss is None else loss
    flat = _leaves(params)
    work = [p.detach().requires_grad_() for p in flat]
    it = iter(work)
    with torch.enable_grad():
        value = loss(_map(lambda _: next(it), params),
                     _batch_to(batch, flat[0].device), config)
        grads = torch.autograd.grad(value, work)
    grads = iter([g.redistribute(p.device_mesh, p.placements)
                  if spmd.is_dtensor(p) else g for p, g in zip(flat, grads)])
    return value.detach(), _map(lambda _: next(grads), params)


def _clamped_ids(batch, vocab_size: int):
    """A batch in the ``(inp, labels[, segment_ids, positions])`` form with
    the input ids clamped into ``[0, vocab_size)``: what the guarded step
    feeds its loss, so that an out-of-range id (which ``step_health``
    flags) gathers a row instead of raising (CPU) or tripping a
    device-side assert that poisons the CUDA context (card). Labels are
    left as they are: the cross entropy gives labels outside ``[0, V)``
    zero loss, as the reference's."""
    inp, labels, seg, pos = unpack_batch(batch)
    inp = inp.clamp(0, vocab_size - 1)
    return (inp, labels) if seg is None else (inp, labels, seg, pos)


def make_forward(config: LlamaConfig, mesh=None):
    """``fwd(params, ids) -> logits``: ``forward`` of ``config``; with a
    ``mesh``, on parameters placed by ``shard_params`` and ids placed over
    the batch axes (``shard_batch``), the logits a DTensor placed
    ``P(BATCH, None, "tp")``."""
    if mesh is None:
        return functools.partial(forward, config=config)

    def fwd(params, ids):
        return forward(params, shard_batch(ids, mesh), config, mesh=mesh)

    return fwd


def make_train_step(config: LlamaConfig, mesh=None, *, lr: float = 3e-4,
                    weight_decay: float = 0.1, sp: bool = False,
                    guard: Optional[bool] = None,
                    numerics: Optional[bool] = None, loss=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    ``loss_and_grads`` (of ``loss_fn``, or of the family's ``loss``),
    then AdamW. The parameters and the moments are updated in place
    under ``no_grad`` (the counterpart of the reference's buffer
    donation) and the same dicts are returned. The step runs where the
    parameters lie and never moves them.

    ``guard`` (default: ``FLAGS_enable_sentinel``, read when the step is
    built) selects the guarded step ``(params, opt_state, batch,
    gnorm_cap) -> (params, opt_state, loss, health)``: ``health`` is
    ``training.guards.step_health``'s ``{"finite", "grad_norm"}``
    (tensors on the parameters' device), and the update applies only
    when the loss and the global gradient norm are finite, every input
    id lies in ``[0, vocab_size)`` and the norm is at most ``gnorm_cap``.
    The gate (``gated_update``) reads that flag on the host once, after
    the gradients: on an anomalous step nothing is written, so
    parameters, moments and ``step`` stay byte-identical; on a clean
    step the update is the unguarded step's. The loss is taken on the
    input ids clamped into the vocabulary (``_clamped_ids``), so a
    poisoned batch cannot index out of range.

    ``numerics`` (default: ``FLAGS_enable_numerics``; guarded step only)
    adds ``health["numerics"]``, ``training.guards.grad_numerics`` of the
    gradients.

    With a ``mesh`` (axes dp / fsdp / tp): the parameters are DTensors
    placed by ``param_specs`` (``shard_params``), so the moments are too;
    the batch is placed over the batch axes, the layers gather their
    weights over fsdp (ZeRO-3), the products are Megatron tensor-parallel
    on tp and ``sp`` shards the residual stream's sequence over tp. The
    health scalars are reduced over the mesh, the same on every rank."""
    guard = resolve_guard(guard)
    numerics = guard and resolve_numerics(numerics)
    if mesh is not None:
        family = loss_fn if loss is None else loss
        on_mesh = dict(mesh=mesh, **({"sp": True} if sp else {}))

        def loss(p, b, c):
            return family(p, b, c, **on_mesh)

    def place(batch):
        if mesh is None:
            return batch
        if isinstance(batch, dict):
            return {k: shard_batch(v, mesh) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return tuple(shard_batch(v, mesh) for v in batch)
        return shard_batch(batch, mesh)

    def update(params, opt_state, grads):
        return _adamw_update(params, grads, opt_state, lr, wd=weight_decay)

    def step(params, opt_state, batch):
        value, grads = loss_and_grads(params, place(batch), config,
                                      loss=loss)
        update(params, opt_state, grads)
        return params, opt_state, value

    def guarded_step(params, opt_state, batch, gnorm_cap):
        batch = place(_batch_to(batch, _leaves(params)[0].device))
        value, grads = loss_and_grads(
            params, _clamped_ids(batch, config.vocab_size), config,
            loss=loss)
        ok, health = step_health(value, grads, unpack_batch(batch)[0],
                                 config.vocab_size, gnorm_cap)
        if numerics:
            health["numerics"] = grad_numerics(grads)
        gated_update(ok, update, params, opt_state, grads)
        return params, opt_state, value, health

    return guarded_step if guard else step


# -- eager Layer model (imperative parity path) -------------------------------

class LlamaDecoderLayer(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.config = c
        self.input_layernorm = nn.RMSNorm(c.hidden_size,
                                          epsilon=c.rms_norm_eps)
        self.q_proj = nn.Linear(c.hidden_size,
                                c.num_attention_heads * c.head_dim,
                                bias_attr=False)
        self.k_proj = nn.Linear(c.hidden_size,
                                c.num_key_value_heads * c.head_dim,
                                bias_attr=False)
        self.v_proj = nn.Linear(c.hidden_size,
                                c.num_key_value_heads * c.head_dim,
                                bias_attr=False)
        self.o_proj = nn.Linear(c.num_attention_heads * c.head_dim,
                                c.hidden_size, bias_attr=False)
        self.post_attention_layernorm = nn.RMSNorm(c.hidden_size,
                                                   epsilon=c.rms_norm_eps)
        self.gate_proj = nn.Linear(c.hidden_size, c.intermediate_size,
                                   bias_attr=False)
        self.up_proj = nn.Linear(c.hidden_size, c.intermediate_size,
                                 bias_attr=False)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size,
                                   bias_attr=False)

    def forward(self, x, cos, sin):
        c = self.config
        b, s = x.shape[0], x.shape[1]
        h = self.input_layernorm(x)
        q = self.q_proj(h).reshape(b, s, c.num_attention_heads, c.head_dim)
        k = self.k_proj(h).reshape(b, s, c.num_key_value_heads, c.head_dim)
        v = self.v_proj(h).reshape(b, s, c.num_key_value_heads, c.head_dim)
        q = PF.apply_rotary_emb(q, cos, sin)
        k = PF.apply_rotary_emb(k, cos, sin)
        a = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + self.o_proj(a.reshape(b, s, c.num_attention_heads
                                      * c.head_dim))
        h = self.post_attention_layernorm(x)
        return x + self.down_proj(PF.silu(self.gate_proj(h))
                                  * self.up_proj(h))


class LlamaForCausalLM(nn.Layer):
    """Imperative Llama (reference surface: PaddleNLP
    ``LlamaForCausalLM``): logits ``[B, S, V]`` in the parameters' type
    from ids ``[B, S]``. Parameters are made on the current device in
    float32 with Paddle's default initializers; ``.to(dtype=...)`` casts
    them. ``generate`` runs the ring-cache decode on the exported
    weights."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.config = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.LayerList(
            [LlamaDecoderLayer(c) for _ in range(c.num_hidden_layers)])
        self.norm = nn.RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps)
        if not c.tie_word_embeddings:
            self.lm_head = nn.Linear(c.hidden_size, c.vocab_size,
                                     bias_attr=False)

    def forward(self, ids):
        c = self.config
        x = self.embed_tokens(ids)
        cos, sin = _rope_tables(ids.shape[1], c.head_dim,
                                theta=c.rope_theta, device=x.device)
        for layer in self.layers:
            x = layer(x, cos, sin)
        x = self.norm(x)
        if c.tie_word_embeddings:
            return torch.matmul(x, self.embed_tokens.weight.t())
        return self.lm_head(x)

    _LAYER_MAP = (("ln1", "input_layernorm"), ("wq", "q_proj"),
                  ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj"),
                  ("ln2", "post_attention_layernorm"),
                  ("gate", "gate_proj"), ("up", "up_proj"),
                  ("down", "down_proj"))

    def functional_params(self):
        """This Layer's weights as the functional tree (``init_params``'
        layout: per-layer weights stacked ``[L, ...]``, the head ``[V,
        D]``), the bridge onto ``forward``, ``make_train_step`` and
        ``ServingEngine``. Copies: mutate the Layer, export again."""
        with torch.no_grad():
            params = {
                "embed": self.embed_tokens.weight.detach().clone(),
                "layers": {fk: torch.stack([getattr(layer, attr).weight
                                            for layer in self.layers])
                           for fk, attr in self._LAYER_MAP},
                "ln_f": self.norm.weight.detach().clone()}
            if not self.config.tie_word_embeddings:
                # the functional head is [V, D]; nn.Linear stores [D, V]
                params["lm_head"] = self.lm_head.weight.t().contiguous()
        return params

    def generate(self, ids, max_new_tokens: int, num_beams: int = 1, **kw):
        """Generation through the ring-cache functional path on this
        Layer's weights (``functional_params()``): ``beam_search`` when
        ``num_beams > 1``, else ``generate``, the reference's one-API
        shape. The other mode's knobs are dropped as the reference drops
        them (beam search is deterministic; ``length_penalty`` is
        beam-only). ``ids`` is a tensor or an array; returns the tokens
        ``[B, max_new_tokens]`` as a tensor on the weights' device."""
        params = self.functional_params()
        if num_beams > 1:
            for k in ("temperature", "top_k", "top_p", "key", "generator"):
                kw.pop(k, None)
            toks, _ = beam_search(params, ids, self.config,
                                  max_new_tokens=max_new_tokens,
                                  num_beams=num_beams, **kw)
            return toks
        kw.pop("length_penalty", None)
        return generate(params, ids, self.config,
                        max_new_tokens=max_new_tokens, **kw)
