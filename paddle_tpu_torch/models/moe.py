"""Mixture-of-Experts decoder LM family, functional core (port of
``paddle_tpu/models/moe.py``: DeepSeekMoE / Qwen2-MoE / ERNIE-4.5-style
fine-grained routed experts plus an always-on shared expert).

The parameter tree is the reference's: the llama layout (``embed``,
stacked ``layers``, ``ln_f``, ``lm_head``) with, per layer, a float32
``router`` ``[D, E]``, routed expert grids ``e_gate`` / ``e_up``
``[E, D, Fe]`` and ``e_down`` ``[E, Fe, D]``, and the shared expert's
``s_gate`` / ``s_up`` / ``s_down``. A JAX tree crosses over with
``params_from_numpy`` (the llama walker, which keeps ``router`` float32).

Two dispatch modes, as in the reference:

- ``"capacity"`` (the default without a mesh): each (token, choice) slot
  takes a place in its expert's buffer of ``C = moe_capacity(T)`` rows
  in token-major order; over-capacity slots drop (the token keeps its
  shared expert). The experts run as batched ``[E, C, D]`` products.
- ``"dense"``: every expert sees every routed token through a 0/1
  dispatch mask and the outputs combine with the router weights. Only
  the single-device form is ported; a ``mesh`` raises (ROADMAP A9).

Attention, the ring-cache decode (``prefill`` / ``decode_step`` /
``generate`` / ``beam_search``) and the train step are the llama
family's, over this family's MLP (``decode_mlp``) and head; the paged
serving plane takes this module as its ``family``. Routing, dispatch and
the expert products are plain PyTorch (cuBLAS), as the reference leaves
them to XLA; attention goes through the flash kernels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import llama as _L
from ..core import enforce as E
from ..core import resolve_device
from .llama import (_attn_half, _dequant, _head_logits, _mm, _rms,
                    params_from_numpy, quant_packed)

__all__ = ["MoEConfig", "moe_tiny", "deepseek_moe_16b", "qwen2_moe_a14b",
           "ernie_4_5_a3b", "init_params", "params_from_numpy",
           "count_params", "quantize_weights", "moe_capacity",
           "decode_mlp", "forward_hidden", "forward", "loss_fn",
           "loss_and_grads", "adamw_init", "make_train_step", "init_cache",
           "prefill", "decode_step", "generate", "beam_search"]


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 1408        # per routed expert
    shared_intermediate_size: int = 2816  # shared-expert MLP width
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 64
    num_experts_per_tok: int = 6
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    router_aux_loss_coef: float = 0.001
    dtype: Any = torch.bfloat16
    remat: bool = True
    # "full" recomputes the whole layer; "dots" keeps the products of the
    # weight matmuls (aten.mm / addmm), not the batched expert products;
    # "attn" acts as "full" (the MoE block tags nothing)
    remat_policy: str = "full"
    # None: "capacity" (the single-device choice of the reference)
    dispatch_mode: Optional[str] = None
    capacity_factor: float = 1.25
    fused_ce: bool = True                # blockwise lm-head cross entropy

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def moe_tiny(**kw) -> MoEConfig:
    """Small config for tests."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=32,
                shared_intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4,
                num_experts=4, num_experts_per_tok=2,
                max_position_embeddings=128, dtype=torch.float32,
                remat=False, dispatch_mode="dense")
    base.update(kw)
    return MoEConfig(**base)


def deepseek_moe_16b(**kw) -> MoEConfig:
    """DeepSeekMoE-16B shapes."""
    base = dict(vocab_size=102400, hidden_size=2048,
                intermediate_size=1408, shared_intermediate_size=2816,
                num_hidden_layers=28, num_attention_heads=16,
                num_key_value_heads=16, num_experts=64,
                num_experts_per_tok=6, max_position_embeddings=4096)
    base.update(kw)
    return MoEConfig(**base)


def qwen2_moe_a14b(**kw) -> MoEConfig:
    """Qwen2-MoE-A14B shapes."""
    base = dict(vocab_size=151936, hidden_size=3584,
                intermediate_size=2560, shared_intermediate_size=20480,
                num_hidden_layers=28, num_attention_heads=28,
                num_key_value_heads=4, num_experts=64,
                num_experts_per_tok=8, max_position_embeddings=32768,
                rope_theta=1000000.0)
    base.update(kw)
    return MoEConfig(**base)


def ernie_4_5_a3b(**kw) -> MoEConfig:
    """ERNIE-4.5-style fine-grained MoE shapes: many small routed experts,
    a shared expert, GQA attention."""
    base = dict(vocab_size=103424, hidden_size=2560,
                intermediate_size=1536, shared_intermediate_size=3072,
                num_hidden_layers=28, num_attention_heads=20,
                num_key_value_heads=4, num_experts=64,
                num_experts_per_tok=6, max_position_embeddings=131072,
                rope_theta=500000.0)
    base.update(kw)
    return MoEConfig(**base)


# -- parameters ---------------------------------------------------------------

def _shapes(config: MoEConfig) -> Dict[str, Any]:
    """The parameter tree's leaf shapes."""
    c = config
    hd, nh, nkv = c.head_dim, c.num_attention_heads, c.num_key_value_heads
    L, D, Fe, Fs = (c.num_hidden_layers, c.hidden_size,
                    c.intermediate_size, c.shared_intermediate_size)
    Ex, V = c.num_experts, c.vocab_size
    return {
        "embed": (V, D),
        "layers": {
            "ln1": (L, D), "wq": (L, D, nh * hd), "wk": (L, D, nkv * hd),
            "wv": (L, D, nkv * hd), "wo": (L, nh * hd, D), "ln2": (L, D),
            "router": (L, D, Ex),
            "e_gate": (L, Ex, D, Fe), "e_up": (L, Ex, D, Fe),
            "e_down": (L, Ex, Fe, D),
            "s_gate": (L, D, Fs), "s_up": (L, D, Fs), "s_down": (L, Fs, D),
        },
        "ln_f": (D,),
        "lm_head": (V, D),
    }


def init_params(config: MoEConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Parameter dict drawn from a ``torch.Generator`` seeded with
    ``seed``: normal(0, 0.02) for every weight, ones for the norms (the
    reference's recipe; the numbers differ from JAX's draw). Stacked
    weights are drawn one layer at a time in float32 (an expert weight
    one layer's ``[E, in, out]`` grid at a time) and cast to
    ``config.dtype``; the router stays float32 in every tree."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def nrm(shape, dtype=c.dtype):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in (out if len(shape) >= 3 else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * 0.02)
        return out

    shapes = _shapes(c)
    layers = {}
    for name, shape in shapes["layers"].items():
        if name.startswith("ln"):
            layers[name] = torch.ones(shape, dtype=c.dtype, device=dev)
        else:
            layers[name] = nrm(shape, torch.float32 if name == "router"
                               else c.dtype)
    return {"embed": nrm(shapes["embed"]), "layers": layers,
            "ln_f": torch.ones(shapes["ln_f"], dtype=c.dtype, device=dev),
            "lm_head": nrm(shapes["lm_head"])}


def count_params(config: MoEConfig) -> int:
    """Parameters of the tree ``init_params`` draws."""
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return math.prod(node)
    return count(_shapes(config))


def quantize_weights(params, weight_dtype: str = "int8"):
    """Weight-only quantization (int8, or packed int4) of a MoE tree for
    serving: the attention, shared-expert and expert weights and the lm
    head become ``quant_packed`` of themselves over their contraction
    axis (axis 2 of an ``[L, E, in, out]`` expert grid); the router stays
    float32, and the norms and the embedding stay as they are."""
    out = {"embed": params["embed"], "ln_f": params["ln_f"], "layers": {}}
    for name, w in params["layers"].items():
        if name.startswith("ln") or name == "router":
            out["layers"][name] = w
        else:
            out["layers"][name] = quant_packed(
                w, 2 if name.startswith("e_") else 1, weight_dtype)
    out["lm_head"] = quant_packed(params["lm_head"], 1, weight_dtype)
    return out


def _edeq(w, dtype):
    """An expert grid ``[E, in, out]`` for the batched products: a plain
    tensor, or its weight-only form dequantized as llama's ``_dequant``
    does (a float32 multiply, one cast)."""
    return _dequant(w, -2, dtype) if isinstance(w, dict) else w


# -- the MoE block ------------------------------------------------------------

def moe_capacity(config: MoEConfig, n_tokens: int) -> int:
    """Slots an expert: ``ceil(T * k / E * capacity_factor)``, rounded up
    to a multiple of 128 from 128 on, at least 8 and at most ``T``."""
    c = config
    even = n_tokens * c.num_experts_per_tok / c.num_experts
    cap = int(even * c.capacity_factor + 0.9999)
    return max(8, min(n_tokens, (cap + 127) // 128 * 128 if cap >= 128
                      else cap))


def _route(x, lp, config: MoEConfig):
    """``(topv [T, k] renormalised float32, topi [T, k], aux)``: float32
    router logits, softmax, the top ``k`` (equal probabilities in expert
    order, as ``lax.top_k``), and the switch-style load-balancing loss
    ``E * sum(mean prob * routed share)``."""
    c = config
    probs = torch.softmax(x.float() @ lp["router"], dim=-1)     # [T, E]
    topv, topi = _L._top_k_stable(probs, c.num_experts_per_tok)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    sel = F.one_hot(topi, c.num_experts).float().sum(dim=1)    # [T, E]
    aux = c.num_experts * (probs.mean(dim=0) * sel.mean(dim=0)).sum()
    return topv, topi, aux


def _expert_ffn(xe, lp):
    """Batched SwiGLU of every expert on its ``[E, C|T, D]`` rows
    (``bmm``)."""
    g = torch.bmm(xe, _edeq(lp["e_gate"], xe.dtype))
    u = torch.bmm(xe, _edeq(lp["e_up"], xe.dtype))
    return torch.bmm(F.silu(g) * u, _edeq(lp["e_down"], xe.dtype))


def _moe_mlp_capacity(x, lp, config: MoEConfig):
    """Capacity dispatch of ``x`` ``[T, D]``: ``(routed [T, D], aux)``.
    A slot's place in its expert's buffer is the count of earlier slots
    (token-major) that chose the same expert; places ``>= C`` drop. The
    grid of token indices has a sink row at ``E * C`` that takes the
    dropped slots' writes (the reference scatters them out of range with
    ``mode="drop"``) and is sliced away."""
    c = config
    T = x.shape[0]
    Ex, k = c.num_experts, c.num_experts_per_tok
    C = moe_capacity(c, T)
    topv, topi, aux = _route(x, lp, c)
    expert = topi.reshape(-1)                                   # [T * k]
    # the inclusive count of each expert's slots, scanned along the
    # contiguous axis in int32; a slot's place is its own expert's count
    # less one (the reference's cumsum(oh) - oh at the chosen expert)
    oh = (expert[None] == torch.arange(Ex, device=x.device)[:, None]) \
        .to(torch.int32)                                        # [E, T * k]
    pos = oh.cumsum(dim=1, dtype=torch.int32).gather(
        0, expert[None])[0] - 1                                 # [T * k]
    keep = pos < C
    dest = expert * C + pos
    idx = torch.full((Ex * C + 1,), T, dtype=torch.long, device=x.device)
    idx[torch.where(keep, dest, Ex * C)] = torch.arange(
        T, device=x.device).repeat_interleave(k)
    xp = torch.cat([x, x.new_zeros(1, x.shape[1])])             # row T: 0
    xe = xp[idx[:Ex * C]].reshape(Ex, C, -1)                    # [E, C, D]
    y = _expert_ffn(xe, lp)
    # each slot gathers its expert's output row, weighted by its router
    # weight; a dropped slot weighs 0
    yk = y.reshape(Ex * C, -1)[torch.where(keep, dest, 0)]
    w = (topv.reshape(-1) * keep).float()[:, None]
    routed = (yk.float() * w).reshape(T, k, -1).sum(dim=1)
    return routed.to(x.dtype), aux


def _moe_mlp_dense(x, lp, config: MoEConfig):
    """Dense dispatch of ``x`` ``[T, D]`` (single device): every expert
    takes every token, masked to 0 where not routed; outputs combine
    with the router weights. ``(routed [T, D], aux)``."""
    c = config
    T = x.shape[0]
    topv, topi, aux = _route(x, lp, c)
    combine = torch.zeros((T, c.num_experts), dtype=torch.float32,
                          device=x.device)
    combine[torch.arange(T, device=x.device)[:, None], topi] = topv
    # a selected expert sees the unscaled token; the router weight
    # scales its output
    dispatch = (combine > 0).to(c.dtype)                        # [T, E]
    xe = dispatch.t()[:, :, None] * x.to(c.dtype)[None]         # [E, T, D]
    y = _expert_ffn(xe, lp)
    routed = torch.einsum("etd,te->td", y.float(), combine)
    return routed.to(x.dtype), aux


def _moe_mlp(h, lp, config: MoEConfig):
    """Routed experts plus the shared expert of ``h`` ``[B, S, D]``:
    ``(out [B, S, D], aux)``. The routed sum is float32 cast to
    ``h.dtype``; the shared expert runs in ``h.dtype``."""
    c = config
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    mode = c.dispatch_mode or "capacity"
    if mode == "capacity":
        routed, aux = _moe_mlp_capacity(x, lp, c)
    elif mode == "dense":
        routed, aux = _moe_mlp_dense(x, lp, c)
    else:
        raise E.InvalidArgumentError(
            f"dispatch_mode must be 'dense' or 'capacity', got {mode!r}")
    shared = _mm(F.silu(_mm(x, lp["s_gate"])) * _mm(x, lp["s_up"]),
                 lp["s_down"])
    return (routed + shared).reshape(B, S, D).to(h.dtype), aux


def decode_mlp(x, lp, config: MoEConfig):
    """Post-attention half of a decoder layer (ln2, routed and shared
    experts, residual) without the aux loss: the family seam of the
    ring-cache decode and the paged serving plane."""
    out, _ = _moe_mlp(_rms(x, lp["ln2"], config.rms_norm_eps), lp, config)
    return x + out


def _head(params, config: MoEConfig):
    """The lm head (the MoE families never tie embeddings)."""
    return params["lm_head"]


def _block(x, lp, cos, sin, config: MoEConfig, segment_ids=None,
           positions=None):
    """One decoder layer: ``(x, aux)``."""
    x, _, _ = _attn_half(x, lp, cos, sin, config, segment_ids, positions)
    out, aux = _moe_mlp(_rms(x, lp["ln2"], config.rms_norm_eps), lp,
                        config)
    return x + out, aux


def _no_mesh(mesh, what):
    if mesh is not None:
        raise NotImplementedError(
            f"moe.{what}: the mesh (multi-GPU, expert-parallel) path is "
            f"not ported yet (ROADMAP.md queue A item A9)")


def forward_hidden(params, ids, config: MoEConfig, *, mesh=None,
                   segment_ids=None, positions=None):
    """``(final hidden [B, S, D] after ln_f, aux summed over layers)``:
    llama's layer loop over this family's ``_block`` (packed batches and
    remat as there; the block tags no attention output, so remat
    ``"attn"`` recomputes the whole layer, as ``"full"``, as in the
    reference)."""
    _no_mesh(mesh, "forward_hidden")
    x, auxes = _L._layers_over(_block, params, ids, config, segment_ids,
                               positions, tags_attn=False)
    return x, torch.stack(auxes).sum()


def forward(params, ids, config: MoEConfig, *, mesh=None, segment_ids=None,
            positions=None):
    """``(logits [B, S, V] float32, aux)``."""
    x, aux = forward_hidden(params, ids, config, mesh=mesh,
                            segment_ids=segment_ids, positions=positions)
    return _head_logits(x, params["lm_head"]), aux


def loss_fn(params, batch, config: MoEConfig, *, mesh=None):
    """Causal-LM cross entropy of a batch in any llama ``unpack_batch``
    form (sequence-packed included) plus ``router_aux_loss_coef * aux``:
    the blockwise cross entropy with ``config.fused_ce``, else the
    materialising one over ``forward``'s logits."""
    from ..kernels import dispatched_fused_ce
    from ..kernels.fused_ce import masked_xent_from_logits
    inp, labels, seg, pos = _L.unpack_batch(batch)
    c = config
    if c.fused_ce:
        x, aux = forward_hidden(params, inp, c, mesh=mesh, segment_ids=seg,
                                positions=pos)
        ce = dispatched_fused_ce(x, params["lm_head"], labels)
    else:
        logits, aux = forward(params, inp, c, mesh=mesh, segment_ids=seg,
                              positions=pos)
        ce = masked_xent_from_logits(logits, labels)
    return ce + c.router_aux_loss_coef * aux


def loss_and_grads(params, batch, config: MoEConfig):
    """``(loss, grads)`` of ``loss_fn`` (llama's ``loss_and_grads``)."""
    return _L.loss_and_grads(params, batch, config, loss=loss_fn)


def adamw_init(params):
    """AdamW state with float32 moments (llama's ``adamw_init``, which
    also takes ``moment_dtype``)."""
    return _L.adamw_init(params)


def make_train_step(config: MoEConfig, mesh=None, *, lr: float = 1e-4,
                    guard: Optional[bool] = None,
                    numerics: Optional[bool] = None):
    """llama's ``make_train_step`` over this family's ``loss_fn`` (the
    reference's shared AdamW, coupled decay 0.1), at ``lr`` 1e-4:
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``, or
    with ``guard`` (default: ``FLAGS_enable_sentinel``) the guarded
    ``(params, opt_state, batch, gnorm_cap) -> (params, opt_state, loss,
    health)``, the llama family's contract, with ``numerics`` (default:
    ``FLAGS_enable_numerics``) as there. The mesh path raises (A9)."""
    _no_mesh(mesh, "make_train_step")
    return _L.make_train_step(config, lr=lr, guard=guard,
                              numerics=numerics, loss=loss_fn)


# -- ring-cache decoding (the llama family's, over this MLP) ------------------

def init_cache(config: MoEConfig, batch: int, max_len: int, dtype=None, *,
               device=None):
    """Fresh decode cache, the llama family's layout."""
    return _L.init_cache(config, batch, max_len, dtype, device=device)


@torch.no_grad()
def prefill(params, ids, config: MoEConfig, cache):
    """Consume the prompt ``[B, S]`` into the cache (llama's
    ``prefill`` over this family's MLP): ``(cache, logits [B, V])``."""
    return _L._prefill_over(decode_mlp, _head, params, ids, config, cache)


@torch.no_grad()
def decode_step(params, cache, token, config: MoEConfig):
    """One incremental step (llama's ``decode_step`` over this family's
    MLP). Routing runs over the ``B`` decoded tokens, so under capacity
    dispatch ``C = moe_capacity(config, B)``: a step drops a slot
    whenever more than ``C`` of the ``B`` tokens pick one expert, which
    a routing hot spot at large ``B`` can cause (the reference's
    behaviour; ``"dense"`` never drops)."""
    return _L._decode_step_over(decode_mlp, _head, params, cache, token,
                                config)


def generate(params, ids, config: MoEConfig, *, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             generator=None):
    """Autoregressive generation (llama's ``generate`` loop)."""
    return _L._generate_over(
        prefill, decode_step, params, ids, config,
        max_new_tokens=max_new_tokens, max_len=max_len,
        temperature=temperature, top_k=top_k, top_p=top_p,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id,
        generator=generator)


def beam_search(params, ids, config: MoEConfig, *, max_new_tokens: int,
                num_beams: int, max_len: Optional[int] = None,
                length_penalty: float = 0.0,
                eos_token_id: Optional[int] = None, pad_token_id: int = 0):
    """Beam search (llama's ``beam_search`` loop)."""
    return _L._beam_search_over(
        prefill, decode_step, params, ids, config,
        max_new_tokens=max_new_tokens, num_beams=num_beams,
        max_len=max_len, length_penalty=length_penalty,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id)
