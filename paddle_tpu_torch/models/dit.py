"""DiT, the Diffusion Transformer family, functional core (port of
``paddle_tpu/models/dit.py``).

Parameters are a plain dict of tensors in the reference's pytree layout:
per-block weights stacked on a leading ``[L, ...]`` axis and matmul
weights stored ``[in, out]`` (``x @ w``), so a JAX parameter tree crosses
over through numpy without transposes (``params_from_numpy``). Patchify
is a reshape (no convolution); each block is adaLN-Zero: six modulation
vectors from the conditioning (timestep MLP plus label embedding), a
non-causal self-attention through ``sdpa_raw`` (the flash kernels on the
card: DiT-XL/2's head dim 72 runs their tensor cores in bf16) and a tanh-GELU
MLP, each gated into the residual. The block loop is a Python loop over
the stacked axis, each block under ``torch.utils.checkpoint`` when the
config asks for remat and autograd needs it.

Sampling: ``ddim_sample`` (DDIM over the reference's integer timestep
ladder, ``eta`` 0 deterministic to 1 ancestral, classifier-free guidance
as one forward over the conditional and null-label halves), drawing its
latents and noise from a ``torch.Generator`` on the parameters' device;
``_ddim_over`` is its loop on given draws. Training: ``loss_fn`` (the
DDPM epsilon-prediction MSE), ``adamw_init`` and ``make_train_step``
(the Llama family's AdamW step, parameters updated in place). The mesh
path (``param_specs``, ``mesh=``) is ROADMAP.md queue A item A9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import enforce as E
from ..core import resolve_device
from ..nn.functional.attention import sdpa_raw
from . import llama
from .llama import adamw_init, params_from_numpy

__all__ = ["DiTConfig", "dit_tiny", "dit_xl_2", "init_params",
           "params_from_numpy", "timestep_embedding", "patchify",
           "unpatchify", "forward", "loss_fn", "ddim_timesteps",
           "ddim_sample", "count_params", "adamw_init", "make_train_step"]


@dataclasses.dataclass
class DiTConfig:
    image_size: int = 32          # latent spatial size (32 = 256px VAE/8)
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def dit_tiny(**kw) -> DiTConfig:
    """Small config for tests."""
    base = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=64,
                num_hidden_layers=2, num_attention_heads=4, num_classes=10,
                dtype=torch.float32, remat=False)
    base.update(kw)
    return DiTConfig(**base)


def dit_xl_2(**kw) -> DiTConfig:
    """DiT-XL/2 shapes (hidden 1152, 28 blocks, 16 heads of 72)."""
    base = dict(image_size=32, patch_size=2, hidden_size=1152,
                num_hidden_layers=28, num_attention_heads=16)
    base.update(kw)
    return DiTConfig(**base)


def _no_mesh(what: str, mesh):
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: the mesh (multi-GPU) path is not ported yet "
            "(ROADMAP.md queue A item A9)")


# -- parameters ---------------------------------------------------------------

def init_params(config: DiTConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Parameter dict drawn from a ``torch.Generator`` seeded with
    ``seed``: normal(0, 0.02) where the reference draws, and its zeros
    for every bias, the adaLN modulations (``mod_*``) and the final layer
    (``final_*``), so that every block starts as the identity (the
    numbers differ from JAX's draw). Stacked weights are drawn one block
    at a time in float32."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    D, L = c.hidden_size, c.num_hidden_layers
    pdim = c.patch_size * c.patch_size * c.in_channels
    Ff = int(D * c.mlp_ratio)

    def nrm(shape):
        out = torch.empty(shape, dtype=c.dtype, device=dev)
        for part in (out if len(shape) == 3 else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * 0.02)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=c.dtype, device=dev)

    return {
        "patch_w": nrm((pdim, D)),
        "patch_b": zeros(D),
        "pos": nrm((c.num_patches, D)),
        # timestep MLP (sinusoidal features -> 2-layer MLP)
        "t_w1": nrm((256, D)),
        "t_b1": zeros(D),
        "t_w2": nrm((D, D)),
        "t_b2": zeros(D),
        # label embedding, one row more: the guidance's null class
        "y_embed": nrm((c.num_classes + 1, D)),
        "blocks": {
            "mod_w": zeros(L, D, 6 * D),
            "mod_b": zeros(L, 6 * D),
            "qkv_w": nrm((L, D, 3 * D)),
            "qkv_b": zeros(L, 3 * D),
            "proj_w": nrm((L, D, D)),
            "proj_b": zeros(L, D),
            "mlp_w1": nrm((L, D, Ff)),
            "mlp_b1": zeros(L, Ff),
            "mlp_w2": nrm((L, Ff, D)),
            "mlp_b2": zeros(L, D),
        },
        "final_mod_w": zeros(D, 2 * D),
        "final_mod_b": zeros(2 * D),
        "final_w": zeros(D, pdim),
        "final_b": zeros(pdim),
    }


def count_params(config: DiTConfig) -> int:
    c = config
    D, L = c.hidden_size, c.num_hidden_layers
    pdim = c.patch_size * c.patch_size * c.in_channels
    Ff = int(D * c.mlp_ratio)
    per_block = (D * 6 * D + 6 * D + D * 3 * D + 3 * D + D * D + D
                 + D * Ff + Ff + Ff * D + D)
    return (pdim * D + D + c.num_patches * D + 256 * D + D + D * D + D
            + (c.num_classes + 1) * D + L * per_block
            + D * 2 * D + 2 * D + D * pdim + pdim)


# -- pieces -------------------------------------------------------------------

def timestep_embedding(t, dim: int = 256, max_period: float = 10000.0):
    """Sinusoidal timestep features ``[B, dim]`` float32 (DiT
    convention: cosines, then sines)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(x, config: DiTConfig):
    """``[B, C, H, W]`` -> ``[B, N, p*p*C]``."""
    B, C, H, W = x.shape
    p = config.patch_size
    x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(x, config: DiTConfig):
    """``[B, N, p*p*C]`` -> ``[B, C, H, W]``."""
    c = config
    B = x.shape[0]
    p = c.patch_size
    hw = c.image_size // p
    x = x.reshape(B, hw, hw, p, p, c.in_channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(B, c.in_channels, hw * p, hw * p)


def _ln(x):
    """LayerNorm without affine: population variance in float32, eps
    1e-6, back to ``x``'s type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    return (d * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _block(x, cond, bp, config: DiTConfig):
    c = config
    B, N, D = x.shape
    nh, hd = c.num_attention_heads, c.head_dim
    mod = F.silu(cond) @ bp["mod_w"] + bp["mod_b"]            # [B, 6D]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)

    h = _modulate(_ln(x), sh1, sc1)
    qkv = h @ bp["qkv_w"] + bp["qkv_b"]
    q, k, v = (t.contiguous() for t in qkv.reshape(B, N, 3, nh, hd)
               .unbind(2))                                     # [B, N, nh, hd]
    a = sdpa_raw(q, k, v, is_causal=False).reshape(B, N, D)
    x = x + g1[:, None, :] * (a @ bp["proj_w"] + bp["proj_b"])

    h = _modulate(_ln(x), sh2, sc2)
    h = F.gelu(h @ bp["mlp_w1"] + bp["mlp_b1"], approximate="tanh")
    return x + g2[:, None, :] * (h @ bp["mlp_w2"] + bp["mlp_b2"])


def forward(params, x, t, y, config: DiTConfig, *, mesh=None):
    """Noise prediction ``[B, C, H, W]`` float32 from latents ``x [B, C,
    H, W]``, integer timesteps ``t [B]`` and labels ``y [B]`` (tensors or
    arrays, brought to the parameters' device)."""
    _no_mesh("dit.forward", mesh)
    c = config
    p = params
    dev = p["pos"].device
    x, t, y = (torch.as_tensor(a, device=dev) for a in (x, t, y))
    h = patchify(x.to(c.dtype), c) @ p["patch_w"] + p["patch_b"]
    h = h + p["pos"][None]

    temb = timestep_embedding(t).to(c.dtype)
    cond = F.silu(temb @ p["t_w1"] + p["t_b1"]) @ p["t_w2"] + p["t_b2"]
    cond = cond + p["y_embed"][y.long()]

    per_block = {k: w.unbind(0) for k, w in p["blocks"].items()}
    remat = c.remat and torch.is_grad_enabled()
    for i in range(c.num_hidden_layers):
        bp = {k: w[i] for k, w in per_block.items()}
        if remat:
            h = checkpoint(_block, h, cond, bp, c, use_reentrant=False)
        else:
            h = _block(h, cond, bp, c)

    fmod = F.silu(cond) @ p["final_mod_w"] + p["final_mod_b"]
    fsh, fsc = fmod.chunk(2, dim=-1)
    h = _modulate(_ln(h), fsh, fsc)
    out = h @ p["final_w"] + p["final_b"]
    return unpatchify(out.float(), c)


# -- diffusion ----------------------------------------------------------------

def _linspace(start: float, stop: float, num: int, device=None):
    """``num`` float32 points from ``start`` to ``stop``, by the
    reference's formula: ``start * (1 - s) + stop * s`` with ``s = i *
    (1 / (num - 1))`` (the division by a constant is a reciprocal
    multiply, as XLA computes it), the last point ``stop``. The points
    differ from ``torch.linspace``'s in the last bit, which moves some
    integer timesteps by one."""
    f32 = dict(dtype=torch.float32, device=device)
    a, b = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    if num == 1:
        return a[None]
    s = torch.arange(num - 1, **f32) * (1.0 / torch.tensor(num - 1.0, **f32))
    return torch.cat([a * (1 - s) + b * s, b[None]])


def _alpha_bar_table(tmax: int = 1000, device=None):
    """``cumprod(1 - beta_t)`` of the linear DDPM schedule (``beta`` from
    1e-4 to 0.02), float32 ``[tmax]``."""
    return torch.cumprod(1.0 - _linspace(1e-4, 0.02, tmax, device), dim=0)


def ddim_timesteps(steps: int, tmax: int = 1000):
    """The descending integer ladder, a list of ints: the float32 points
    of ``_linspace(tmax - 1, 0, steps)`` truncated toward zero, as the
    reference's ``jnp.linspace(...).astype(int32)``. It equals JAX's on
    the CPU at every step count up to 354 of ``tmax`` 1000 (past that,
    XLA's vectorised loop rounds some points once, as a fused
    multiply-add, and a rung may move by one)."""
    return _linspace(float(tmax - 1), 0.0, steps).to(torch.int32).tolist()


def loss_fn(params, batch, config: DiTConfig, *, mesh=None):
    """DDPM epsilon-prediction MSE: ``batch = (x0, t, y, noise)``, ``t``
    integer timesteps in ``[0, 1000)`` (the DiT training objective)."""
    _no_mesh("dit.loss_fn", mesh)
    dev = params["pos"].device
    x0, t, y, noise = (torch.as_tensor(a, device=dev) for a in batch)
    abar = _alpha_bar_table(device=dev)[t.long()][:, None, None, None]
    xt = torch.sqrt(abar) * x0 + torch.sqrt(1 - abar) * noise
    pred = forward(params, xt, t, y, config)
    return torch.mean((pred - noise) ** 2)


@torch.no_grad()
def ddim_sample(params, y, config: DiTConfig, *, steps: int = 50,
                eta: float = 0.0, guidance_scale: float = 1.0,
                generator=None, tmax: int = 1000):
    """DDIM samples ``x0 [B, C, H, W]`` float32 for labels ``y [B]``:
    ``eta`` 0 is the deterministic DDIM ODE, 1 ancestral DDPM noise;
    ``guidance_scale`` other than 1 runs classifier-free guidance, one
    forward a step over the conditional and the null-label halves (label
    ``config.num_classes``). The initial latents and each step's noise
    are drawn from ``generator`` (a ``torch.Generator`` or an int seed,
    default 0) on the parameters' device; the draws differ from JAX's.
    No noise is drawn at ``eta`` 0, where it is multiplied by zero."""
    c = config
    dev = params["pos"].device
    y = torch.as_tensor(y, device=dev)
    gen = llama._generator(generator, dev)
    shape = (y.shape[0], c.in_channels, c.image_size, c.image_size)
    x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    noise = None
    if eta != 0.0:
        noise = torch.randn((steps, *shape), generator=gen, device=dev,
                            dtype=torch.float32)
    return _ddim_over(params, y, config, x, noise, steps=steps, eta=eta,
                      guidance_scale=guidance_scale, tmax=tmax)


@torch.no_grad()
def _ddim_over(params, y, config: DiTConfig, x, noise, *, steps: int,
               eta: float = 0.0, guidance_scale: float = 1.0,
               tmax: int = 1000):
    """The DDIM loop of ``ddim_sample`` on given draws: the initial
    latents ``x [B, C, H, W]`` and each step's standard normal noise
    ``[steps, B, C, H, W]`` (scaled by the step's sigma; ``None`` stands
    for zeros, exact at ``eta`` 0). Arrays are brought to the
    parameters' device."""
    c = config
    dev = params["pos"].device
    y = torch.as_tensor(y, device=dev)
    x = torch.as_tensor(x, device=dev, dtype=torch.float32)
    if noise is not None:
        noise = torch.as_tensor(noise, device=dev, dtype=torch.float32)
        E.enforce(noise.shape == (steps, *x.shape),
                  f"ddim: noise {tuple(noise.shape)} must be [steps "
                  f"{steps}, *x {tuple(x.shape)}]",
                  error=E.InvalidArgumentError)
    B = y.shape[0]
    abar = _alpha_bar_table(tmax, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    ts = ddim_timesteps(steps, tmax)
    null = torch.full((B,), c.num_classes, dtype=y.dtype, device=dev)

    def eps_fn(x, t):
        tb = torch.full((B,), t, dtype=torch.int32, device=dev)
        if guidance_scale == 1.0:
            return forward(params, x, tb, y, c)
        both = forward(params, torch.cat([x, x]), torch.cat([tb, tb]),
                       torch.cat([y, null]), c)
        e_cond, e_null = both.chunk(2)
        return e_null + guidance_scale * (e_cond - e_null)

    for s, (t, t_prev) in enumerate(zip(ts, ts[1:] + [-1])):
        a_t = abar[t]
        a_prev = abar[t_prev] if t_prev >= 0 else one
        eps = eps_fn(x, t)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        sigma = eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t)
                                 * (1.0 - a_t / a_prev))
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2,
                                        min=0.0)) * eps
        x = torch.sqrt(a_prev) * x0 + dir_xt
        if noise is not None:
            x = x + sigma * noise[s]
    return x


def make_train_step(config: DiTConfig, mesh=None, *, lr: float = 1e-4):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    ``loss_fn`` and its gradients, then the Llama family's AdamW
    (``llama._adamw_update`` at its defaults, as the reference's step).
    Parameters and moments are updated in place and the same dicts are
    returned; the step runs where the parameters lie."""
    _no_mesh("dit.make_train_step", mesh)

    def step(params, opt_state, batch):
        value, grads = llama.loss_and_grads(params, batch, config,
                                            loss=loss_fn)
        llama._adamw_update(params, grads, opt_state, lr)
        return params, opt_state, value

    return step
