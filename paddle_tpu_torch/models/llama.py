"""Llama model family, functional core (port of
``paddle_tpu/models/llama.py``).

Parameters are a plain dict of tensors in the reference's pytree layout:
per-layer weights stacked on a leading ``[L, ...]`` axis and matmul
weights stored ``[in, out]`` (``x @ w``), so a JAX parameter tree crosses
over through numpy without transposes (``params_from_numpy``). The layer
loop is a Python loop over the stacked axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core import resolve_device
from ..nn.functional.attention import rope_raw, rope_tables as _rope_tables
from ..nn.functional.attention import sdpa_raw

__all__ = ["LlamaConfig", "llama_tiny", "llama_3_8b", "init_params",
           "params_from_numpy", "forward_hidden", "forward", "decode_mlp"]


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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_tiny(**kw) -> LlamaConfig:
    """Small config for tests."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, dtype=torch.float32)
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
    refuses; it goes through float32 (lossless) and back to bfloat16.
    ``dtype`` casts every floating leaf; ``None`` keeps the source type."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        want = dtype
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
            want = want or torch.bfloat16
        t = torch.from_numpy(np.array(a))
        if want is not None and t.is_floating_point():
            t = t.to(want)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def _rms(x, w, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _mm(x, w):
    """Matmul against a plain ``[in, out]`` weight."""
    return x @ w


def _head_logits(x2d, head):
    """lm-head logits ``[.., V]`` in float32 from hidden ``[.., D]``; head
    is ``[V, D]``."""
    return (x2d @ head.t()).float()


def _qkv_proj(h, lp, config: LlamaConfig):
    """Attention input projections ``[B, S, D]`` -> q/k/v head grids (no
    rope)."""
    c = config
    B, S, _ = h.shape
    nh, nkv, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    q = _mm(h, lp["wq"]).reshape(B, S, nh, hd)
    k = _mm(h, lp["wk"]).reshape(B, S, nkv, hd)
    v = _mm(h, lp["wv"]).reshape(B, S, nkv, hd)
    return q, k, v


def _ffn(x, lp, config: LlamaConfig):
    """Post-attention half of a decoder layer (ln2 + SwiGLU + residual)."""
    h = _rms(x, lp["ln2"], config.rms_norm_eps)
    g = _mm(h, lp["gate"])
    u = _mm(h, lp["up"])
    return x + _mm(F.silu(g) * u, lp["down"])


def decode_mlp(x, lp, config: LlamaConfig):
    """Post-attention half of a decode-path layer: the family seam the
    paged serving path (``inference/paged.py``) composes with."""
    return _ffn(x, lp, config)


def layer(params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked weights (views, no copies)."""
    return {k: w[i] for k, w in params["layers"].items()}


def _block(x, lp, cos, sin, config: LlamaConfig):
    c = config
    B, S, _ = x.shape
    h = _rms(x, lp["ln1"], c.rms_norm_eps)
    q, k, v = _qkv_proj(h, lp, c)
    q = rope_raw(q, cos, sin)
    k = rope_raw(k, cos, sin)
    a = sdpa_raw(q, k, v, is_causal=True).reshape(B, S, -1)
    x = x + _mm(a, lp["wo"])
    return _ffn(x, lp, c)


def forward_hidden(params, ids, config: LlamaConfig):
    """Final hidden states ``[B, S, D]`` (post ln_f) from token ids."""
    c = config
    x = params["embed"][ids]
    cos, sin = _rope_tables(ids.shape[1], c.head_dim, theta=c.rope_theta,
                            device=x.device)
    for i in range(c.num_hidden_layers):
        x = _block(x, layer(params, i), cos, sin, c)
    return _rms(x, params["ln_f"], c.rms_norm_eps)


def _head(params, config: LlamaConfig):
    return params["embed"] if config.tie_word_embeddings \
        else params["lm_head"]


def forward(params, ids, config: LlamaConfig):
    """Logits ``[B, S, V]`` (float32) from token ids ``[B, S]``."""
    x = forward_hidden(params, ids, config)
    return _head_logits(x, _head(params, config))
