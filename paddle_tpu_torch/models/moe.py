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
  shared expert). The experts run as batched ``[E, C, D]`` products. On
  a mesh ``T`` is the global batch's and the places count in global
  token-major order, as the reference's GSPMD run of the same code.
- ``"dense"`` (the default on a mesh): every expert sees every routed
  token through a 0/1 dispatch mask and the outputs combine with the
  router weights. On a ``("dp", "fsdp", "ep", "tp")`` mesh the expert
  axis shards over ep: the dispatched ``[E, T, D]`` rows and the expert
  outputs are placed ``P("ep", None, None)`` (the reference's two
  constraints, its ep exchange), the expert products are tensor-parallel
  on tp, and the parameters are placed by ``param_specs``.

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
from ..distributed import spmd
from ..distributed.spmd import P
from .llama import (_attn_half, _dequant, _head_logits, _mm, _rms,
                    params_from_numpy, quant_packed)

__all__ = ["MoEConfig", "moe_tiny", "deepseek_moe_16b", "qwen2_moe_a14b",
           "ernie_4_5_a3b", "init_params", "params_from_numpy",
           "count_params", "quantize_weights", "moe_capacity",
           "decode_mlp", "forward_hidden", "forward", "loss_fn",
           "loss_and_grads", "adamw_init", "make_train_step", "init_cache",
           "param_specs", "shard_params",
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


def _slot_dest(expert, n_experts: int, cap: int, before=None):
    """Each slot's row in the ``[E * C]`` grid, ``expert * C + place``,
    or -1 where it drops, for the slots' experts ``expert`` ``[T * k]``
    (token-major). A slot's place is the count of earlier slots that
    chose the same expert, after ``before[e]`` slots of expert ``e`` that
    come ahead of these (earlier batch shards on a mesh); places ``>= C``
    drop."""
    # the inclusive count of each expert's slots, scanned along the
    # contiguous axis in int32; a slot's place is its own expert's count
    # less one (the reference's cumsum(oh) - oh at the chosen expert)
    oh = (expert[None] == torch.arange(n_experts, device=expert.device)
          [:, None]).to(torch.int32)                            # [E, T * k]
    pos = oh.cumsum(dim=1, dtype=torch.int32).gather(
        0, expert[None])[0] - 1                                 # [T * k]
    if before is not None:
        pos = pos + before[expert]
    return torch.where(pos < cap, expert * cap + pos, -1)


def _dispatch_grid(x, dest, n_experts: int, cap: int, k: int):
    """The ``[E, C, D]`` rows of ``x`` ``[T, D]`` at the kept slots'
    ``dest``; a row no slot takes is 0. The grid of token indices has a
    sink row at ``E * C`` that takes the dropped slots' writes (the
    reference scatters them out of range with ``mode="drop"``) and is
    sliced away."""
    T = x.shape[0]
    idx = torch.full((n_experts * cap + 1,), T, dtype=torch.long,
                     device=x.device)
    idx[torch.where(dest >= 0, dest, n_experts * cap)] = torch.arange(
        T, device=x.device).repeat_interleave(k)
    xp = torch.cat([x, x.new_zeros(1, x.shape[1])])             # row T: 0
    return xp[idx[:n_experts * cap]].reshape(n_experts, cap, -1)


def _combine_slots(y, topv, dest, cap: int, k: int, e0: int, n_local: int):
    """Float32 ``[T, D]``: each slot gathers its expert's output row of
    ``y`` ``[El, C, D]`` (experts ``[e0, e0 + El)``), weighted by its
    router weight; a dropped slot, or one whose expert lies outside the
    window, weighs 0."""
    mine = (dest >= e0 * cap) & (dest < (e0 + n_local) * cap)
    yk = y.reshape(n_local * cap, -1)[torch.where(mine, dest - e0 * cap, 0)]
    w = (topv.reshape(-1) * mine).float()[:, None]
    return (yk.float() * w).reshape(topv.shape[0], k, -1).sum(dim=1)


def _moe_mlp_capacity(x, lp, config: MoEConfig):
    """Capacity dispatch of ``x`` ``[T, D]``: ``(routed [T, D], aux)``.
    Slots take places in their experts' buffers token-major
    (``_slot_dest``); places ``>= C`` drop."""
    c = config
    Ex, k = c.num_experts, c.num_experts_per_tok
    C = moe_capacity(c, x.shape[0])
    topv, topi, aux = _route(x, lp, c)
    dest = _slot_dest(topi.reshape(-1), Ex, C)                  # [T * k]
    y = _expert_ffn(_dispatch_grid(x, dest, Ex, C, k), lp)
    return _combine_slots(y, topv, dest, C, k, 0, Ex).to(x.dtype), aux


def _moe_mlp_dense(x, lp, config: MoEConfig, mesh=None):
    """Dense dispatch of ``x`` ``[T, D]``: every expert takes every token,
    masked to 0 where not routed; outputs combine with the router
    weights. ``(routed [T, D], aux)``. On a mesh the routing runs on each
    rank's tokens and the dispatched rows and expert outputs are placed
    over ep."""
    c = config
    if mesh is not None:
        return _moe_mlp_dense_mesh(x, lp, c, mesh)
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


def _moe_mlp_dense_mesh(x, lp, config: MoEConfig, mesh):
    """``_moe_mlp_dense`` of batch-sharded tokens on a mesh. Each step
    runs on local shards (``spmd.local``), with the placements between
    them explicit: the dispatched rows ``[E, T, D]`` and the expert
    outputs are placed ``P("ep", None, None)`` (the reference's two
    constraints: every ep rank takes all tokens for its experts), the
    expert products split their hidden dim over tp (partial sums reduced
    on tp), and each ep rank combines its experts' outputs into partial
    token rows that reduce over ep back to the batch shards."""
    c = config
    topv, topi, aux = _route_on_mesh(x, lp, c, mesh)
    tokens = P(_L.BATCH, None)
    combine = spmd.local(                                      # [T, E]
        lambda tv, ti: tv.new_zeros(tv.shape[0], c.num_experts).scatter(
            -1, ti, tv), mesh, tokens, topv, topi)

    def dispatch_rows(comb, xl):
        # a selected expert sees the unscaled token
        return (comb > 0).to(c.dtype).t()[:, :, None] * xl.to(c.dtype)[None]

    xe = spmd.constrain(spmd.local(dispatch_rows, mesh, P(None, _L.BATCH),
                                   combine, x), mesh, P("ep", None, None))
    experts = {k: spmd.gather_axis(lp[k], "fsdp")
               for k in ("e_gate", "e_up", "e_down")}
    ep_rows = spmd.placements(P("ep", None, None), mesh)
    y = spmd.local(
        lambda a, g, u, d: _expert_ffn(a, {"e_gate": g, "e_up": u,
                                          "e_down": d}),
        mesh, spmd.partial_on(ep_rows, mesh, ("tp",)), xe,
        experts["e_gate"], experts["e_up"], experts["e_down"],
        grads=[spmd.partial_on(xe, mesh, ("tp",)), None, None, None])
    y = spmd.constrain(y, mesh, P("ep", None, None))
    comb = spmd.constrain(combine, mesh, P(None, "ep"))
    routed = spmd.local(
        lambda yl, cl: torch.einsum("etd,te->td", yl.float(), cl), mesh,
        spmd.partial_on(spmd.placements(P(None, None), mesh), mesh,
                        ("ep",)), y, comb,
        grads=[None, None])
    return spmd.constrain(routed, mesh, tokens).to(x.dtype), aux


def _moe_mlp_capacity_mesh(x, lp, config: MoEConfig, mesh):
    """``_moe_mlp_capacity`` of batch-sharded tokens on a mesh, computing
    the reference's function: under GSPMD it runs on the global token
    matrix, so ``C = moe_capacity(T)`` takes the global ``T`` and a
    slot's place counts the earlier slots of every earlier batch shard
    (an exclusive prefix over the shards of their per-expert counts,
    gathered once) before its own shard's: drops fall in global
    token-major order. Each shard scatters its kept slots into its part
    of the ``[E, C, D]`` grid, which sums over the batch axes and is
    placed ``P("ep", None, None)`` (the dense path's placement); each ep
    rank runs its experts, and each token row gathers the outputs of the
    slots its rank's experts hold, a partial sum over ep."""
    c = config
    Ex, k = c.num_experts, c.num_experts_per_tok
    C = moe_capacity(c, x.shape[0])            # the global token count
    fsdp = spmd.axis_size(mesh, "fsdp")
    me = spmd.axis_rank(mesh, "dp") * fsdp + spmd.axis_rank(mesh, "fsdp")
    El = Ex // spmd.axis_size(mesh, "ep")
    e0 = spmd.axis_rank(mesh, "ep") * El
    rows = P(_L.BATCH, None)
    topv, topi, aux = _route_on_mesh(x, lp, c, mesh)
    # every batch shard's slots an expert, [shards, E] on every rank
    counts = spmd.full(spmd.local(
        lambda ti: F.one_hot(ti.reshape(-1), Ex).sum(0, keepdim=True),
        mesh, rows, topi))
    before = counts[:me].sum(0)                # earlier shards' slots
    dest = spmd.local(
        lambda ti: _slot_dest(ti.reshape(-1), Ex, C, before.to(ti.device))
        .reshape(ti.shape), mesh, rows, topi)

    def dispatch(xl, dl):
        # this shard's kept slots in the grid; the rest read a zero row
        return _dispatch_grid(xl, dl.reshape(-1), Ex, C, k)

    grid = spmd.partial_on(spmd.placements(P(None, None, None), mesh), mesh,
                           _L.BATCH)
    xe = spmd.constrain(spmd.local(dispatch, mesh, grid, x, dest), mesh,
                        P("ep", None, None))
    experts = {n: spmd.gather_axis(lp[n], "fsdp")
               for n in ("e_gate", "e_up", "e_down")}
    ep_rows = spmd.placements(P("ep", None, None), mesh)
    y = spmd.local(
        lambda a, g, u, d: _expert_ffn(a, {"e_gate": g, "e_up": u,
                                          "e_down": d}),
        mesh, spmd.partial_on(ep_rows, mesh, ("tp",)), xe,
        experts["e_gate"], experts["e_up"], experts["e_down"],
        grads=[spmd.partial_on(xe, mesh, ("tp",)), None, None, None])
    y = spmd.constrain(y, mesh, P("ep", None, None))

    def combine(yl, tv, dl):
        # the slots whose expert this ep rank holds
        return _combine_slots(yl, tv, dl.reshape(-1), C, k, e0, El)

    routed = spmd.local(
        combine, mesh, spmd.partial_on(spmd.placements(rows, mesh), mesh,
                                       ("ep",)), y, topv, dest,
        grads=[spmd.partial_on(y, mesh, _L.BATCH),
               spmd.partial_on(topv, mesh, ("ep",)), None])
    return spmd.constrain(routed, mesh, rows).to(x.dtype), aux


def _route_on_mesh(x, lp, config: MoEConfig, mesh):
    """``(topv [T, k], topi [T, k], aux)`` of batch-sharded tokens ``x``:
    ``_route`` on each rank's tokens (the router gathered over fsdp),
    the load-balancing loss from the mesh-wide means."""
    c = config
    router = spmd.gather_axis(lp["router"], "fsdp")

    def route(xl, r):
        probs = torch.softmax(xl.float() @ r, dim=-1)
        topv, topi = _L._top_k_stable(probs, c.num_experts_per_tok)
        topv = topv / topv.sum(dim=-1, keepdim=True)
        sel = F.one_hot(topi, c.num_experts).float().sum(dim=1)
        return topv, topi, probs, sel

    rows = P(_L.BATCH, None)
    topv, topi, probs, sel = spmd.local(
        route, mesh, [rows, rows, rows, rows], x, router,
        grads=[None, spmd.partial_on(router, mesh, _L.BATCH)])
    aux = c.num_experts * (probs.mean(dim=0) * sel.mean(dim=0)).sum()
    return topv, topi, aux


def _moe_mlp(h, lp, config: MoEConfig, mesh=None):
    """Routed experts plus the shared expert of ``h`` ``[B, S, D]``:
    ``(out [B, S, D], aux)``. The routed sum is float32 cast to
    ``h.dtype``; the shared expert runs in ``h.dtype``. The dispatch mode
    defaults to ``"capacity"`` on one device and ``"dense"`` on a mesh,
    as the reference's; either runs on both."""
    c = config
    B, S, D = h.shape
    # each rank's rows, token-major
    x = spmd.local(lambda a: a.reshape(-1, D), mesh, P(_L.BATCH, None),
                   spmd.constrain(h, mesh, P(_L.BATCH, None, None)))
    mode = c.dispatch_mode or ("dense" if mesh is not None else "capacity")
    if mode == "capacity":
        routed, aux = (_moe_mlp_capacity(x, lp, c) if mesh is None else
                       _moe_mlp_capacity_mesh(x, lp, c, mesh))
    elif mode == "dense":
        routed, aux = _moe_mlp_dense(x, lp, c, mesh)
    else:
        raise E.InvalidArgumentError(
            f"dispatch_mode must be 'dense' or 'capacity', got {mode!r}")
    a = spmd.elementwise(lambda g, u: F.silu(g) * u, _mm(x, lp["s_gate"]),
                         _mm(x, lp["s_up"]))
    shared = spmd.constrain(_mm(a, lp["s_down"]), mesh, P(_L.BATCH, None))
    out = spmd.local(lambda r, sh: (r + sh).reshape(-1, S, D).to(h.dtype),
                     mesh, P(_L.BATCH, None, None), routed, shared)
    return out, aux


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
           positions=None, mesh=None, sp: bool = False):
    """One decoder layer: ``(x, aux)``. On a mesh the layer's weights are
    first gathered over fsdp, as llama's."""
    lp = _L._zero3_gather(lp, mesh)
    x, _, _ = _attn_half(x, lp, cos, sin, config, segment_ids, positions,
                         mesh, sp)
    out, aux = _moe_mlp(_rms(x, lp["ln2"], config.rms_norm_eps), lp,
                        config, mesh)
    return spmd.elementwise(torch.add, x, spmd.constrain(
        out, mesh, _L._act_spec(sp))), aux


def forward_hidden(params, ids, config: MoEConfig, *, mesh=None,
                   segment_ids=None, positions=None):
    """``(final hidden [B, S, D] after ln_f, aux summed over layers)``:
    llama's layer loop over this family's ``_block`` (packed batches and
    remat as there; the block tags no attention output, so remat
    ``"attn"`` recomputes the whole layer, as ``"full"``, as in the
    reference). With a ``mesh`` the parameters are DTensors placed by
    ``param_specs``."""
    x, auxes = _L._layers_over(_block, params, ids, config, segment_ids,
                               positions, tags_attn=False, mesh=mesh)
    return x, torch.stack(auxes).sum()


def forward(params, ids, config: MoEConfig, *, mesh=None, segment_ids=None,
            positions=None):
    """``(logits [B, S, V] float32, aux)``; on a mesh the logits are
    placed vocab-parallel, as llama's."""
    x, aux = forward_hidden(params, ids, config, mesh=mesh,
                            segment_ids=segment_ids, positions=positions)
    if mesh is not None:
        return _L._sharded_logits(x, params["lm_head"], mesh), aux
    return _head_logits(x, params["lm_head"]), aux


def loss_fn(params, batch, config: MoEConfig, *, mesh=None):
    """Causal-LM cross entropy of a batch in any llama ``unpack_batch``
    form (sequence-packed included) plus ``router_aux_loss_coef * aux``:
    the blockwise cross entropy with ``config.fused_ce``, else the
    materialising one over ``forward``'s logits. On a mesh the logits
    always materialise and the cross entropy is vocab-parallel
    (``kernels.fused_ce.vocab_parallel_xent``), as the reference's mesh
    path never fuses."""
    from ..kernels import dispatched_fused_ce
    from ..kernels.fused_ce import masked_xent_from_logits, \
        vocab_parallel_xent
    inp, labels, seg, pos = _L.unpack_batch(batch)
    c = config
    if mesh is not None:
        logits, aux = forward(params, inp, c, mesh=mesh, segment_ids=seg,
                              positions=pos)
        ce = vocab_parallel_xent(logits, _L.shard_batch(labels, mesh), mesh)
    elif c.fused_ce:
        x, aux = forward_hidden(params, inp, c, segment_ids=seg,
                                positions=pos)
        ce = dispatched_fused_ce(x, params["lm_head"], labels)
    else:
        logits, aux = forward(params, inp, c, segment_ids=seg,
                              positions=pos)
        ce = masked_xent_from_logits(logits, labels)
    return ce + c.router_aux_loss_coef * aux


def param_specs(config: MoEConfig) -> Dict[str, Any]:
    """Placements over a ``("dp", "fsdp", "ep", "tp")`` mesh: the expert
    grids put E on ep (expert parallelism) and their FFN dims on tp /
    fsdp; the dense weights follow the llama family's layout."""
    del config
    return {
        "embed": P("tp", "fsdp"),
        "layers": {
            "ln1": P(None, None),
            "wq": P(None, "fsdp", "tp"),
            "wk": P(None, "fsdp", "tp"),
            "wv": P(None, "fsdp", "tp"),
            "wo": P(None, "tp", "fsdp"),
            "ln2": P(None, None),
            "router": P(None, "fsdp", None),
            "e_gate": P(None, "ep", "fsdp", "tp"),
            "e_up": P(None, "ep", "fsdp", "tp"),
            "e_down": P(None, "ep", "tp", "fsdp"),
            "s_gate": P(None, "fsdp", "tp"),
            "s_up": P(None, "fsdp", "tp"),
            "s_down": P(None, "tp", "fsdp"),
        },
        "ln_f": P(None),
        "lm_head": P("tp", "fsdp"),
    }


def shard_params(params, config: MoEConfig, mesh):
    """A parameter tree (the same on every rank) as DTensors placed by
    ``param_specs`` on ``mesh`` (``llama.shard_params``)."""
    return _L.shard_params(params, config, mesh, param_specs(config))


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
    ``FLAGS_enable_numerics``) as there. With a ``mesh`` the parameters
    are placed by ``param_specs`` and the batch over dp and fsdp."""
    return _L.make_train_step(config, mesh, lr=lr, guard=guard,
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
