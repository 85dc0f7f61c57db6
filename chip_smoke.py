#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. build: compile every CUDA kernel of the serving and training paths
   from ``paddle_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a``, one
   compile per source, all at once;
2. kernels: call each kernel's wrapper on card tensors at the shapes the
   main paths give it, hold the result to its plain PyTorch version on
   the same inputs (tolerances stated below), and time kernel, plain
   version and the one PyTorch call that computes the same function
   (``scaled_dot_product_attention``, forward or backward);
3. parity: a ``llama_tiny`` float32 model with one set of weights is
   served on the card (kernels) and on the CPU (plain versions); the
   greedy tokens must be equal, through queueing and preemption;
4. train_parity: the same kind of model takes 3 ``make_train_step``
   steps on the card and on the CPU; losses and step-1 gradients must
   agree, and the card's steps must go through the kernels;
5. main: a ``ServingEngine`` at Llama-3-8B widths (random bf16 weights
   from a seed) serves 16 requests; both kernels' launch counts over
   this run must be above zero and every token in range;
6. train: ``make_train_step`` at Llama-3-8B widths, 4 layers (the JAX
   package's headline training rung), random bf16 weights from seed 0,
   float32 AdamW moments, batch 4 x 2048: 2 untimed and 5 timed steps on
   one batch; the loss must be finite and fall, and every step must run
   the backward kernel once a layer and no plain version.

Then it prints the kernel records as one JSON line, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repo beside it, it exits non-zero
before printing any result.

``--layers N`` cuts the main path's depth (default: all 32 layers).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3

FLASH_TOL = 2e-2    # bf16 output: one bf16 rounding of values of size ~1
FLASH_F32_TOL = 1e-4    # float32: summation order and __expf only
LSE_TOL = 1e-3
PAGED_TOL = 2e-2
# backward: max abs error of dq / dk / dv over each reference's max |.|
BWD_TOL = 2e-2      # bf16 outputs and inputs
BWD_F32_TOL = 1e-4  # float32: summation order and __expf only
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-5   # step-1 grads, relative to each tensor's max |g|
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048


def _say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _time_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _main_requests(vocab, seed=0):
    """16 requests: 8 prompts of 257..512 tokens (one prefill group at a
    512-token bucket), then 8 of 513..1024; 32..64 new tokens each."""
    import numpy as np
    from paddle_tpu_torch.inference import Request
    rng = np.random.default_rng(seed)
    lens = np.concatenate([rng.integers(257, 513, 8),
                           rng.integers(513, 1025, 8)])
    news = rng.integers(32, 65, 16)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)),
                    max_new_tokens=int(m))
            for i, (n, m) in enumerate(zip(lens, news))]


def phase_flash(torch, dev, main_g, main_s):
    from paddle_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(1)
    H, KVH, D = 32, 8, 128

    def qkv(b, s, dtype):
        return tuple(torch.randn(b, s, h, D, generator=gen, device=dev)
                     .to(dtype) for h in (H, KVH, KVH))

    worst = 0.0
    for s, causal, dtype, tol in ((16, True, torch.bfloat16, FLASH_TOL),
                                  (48, True, torch.bfloat16, FLASH_TOL),
                                  (512, True, torch.bfloat16, FLASH_TOL),
                                  (48, False, torch.bfloat16, FLASH_TOL),
                                  (48, True, torch.float32, FLASH_F32_TOL)):
        q, k, v = qkv(2, s, dtype)
        out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
        err, lerr = _err(out, ref), _err(lse, ref_lse)
        _say("kernels", kernel="flash_fwd", S=s, causal=causal,
             dtype=str(dtype).split(".")[-1], max_abs_err=err,
             lse_err=lerr, tol=tol)
        assert err <= tol and lerr <= LSE_TOL, "flash_fwd disagrees"
        if dtype == torch.bfloat16:
            worst = max(worst, err)

    # the main path's first prefill group: G requests at one bucket
    q, k, v = qkv(main_g, main_s, torch.bfloat16)
    out = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = FA.flash_attention_ref(q, k, v, causal=True)[0]
    err = _err(out, ref)
    assert err <= FLASH_TOL, "flash_fwd disagrees at the main-path shape"
    worst = max(worst, err)
    del ref
    ms = _time_ms(lambda: FA.flash_attention(q, k, v, causal=True), 20)
    plain_ms = _time_ms(
        lambda: FA.flash_attention_ref(q, k, v, causal=True), 5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    flops = 2.0 * main_g * H * main_s * main_s * D        # causal
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
              + 2 * q.numel() + 4 * main_g * H * main_s)
    bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    _say("kernels", kernel="flash_fwd", shape=f"G{main_g}xS{main_s}",
         ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
         tflops=flops / ms / 1e9)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention.py:40",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if flops / H100_BF16_FLOPS
            >= nbytes / H100_BYTES_PER_S else "bytes",
            "library_ms": library_ms}


def phase_paged(torch, dev, main_lengths, num_pages, maxp):
    from paddle_tpu_torch.kernels import paged_attention as PA
    gen = torch.Generator(device=dev).manual_seed(2)
    B, NH, KVH, D, PS = len(main_lengths), 32, 8, 128, 16
    kp = torch.randn(num_pages, KVH, PS, D, generator=gen,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn(num_pages, KVH, PS, D, generator=gen,
                     device=dev).to(torch.bfloat16)

    def tables(lengths):
        """Each sequence's own pages, then sentinel (num_pages) entries
        and garbage past them."""
        bt = torch.full((B, maxp), num_pages, dtype=torch.int32)
        perm = torch.randperm(num_pages, generator=torch.Generator()
                              .manual_seed(3))
        nxt = 0
        for b, n in enumerate(lengths):
            used = -(-n // PS)
            bt[b, :used] = perm[nxt:nxt + used]
            nxt += used
            if used < maxp - 1:
                bt[b, -1] = -7 if b % 2 else 10 * num_pages
        return bt.to(dev)

    worst = 0.0
    cases = (("edge", [0, 1, 15, 16, 17, 300, 777, maxp * PS]),
             ("main", list(main_lengths)))
    for name, lengths in cases:
        q = torch.randn(B, NH, D, generator=gen,
                        device=dev).to(torch.bfloat16)
        bt = tables(lengths)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = PA.ragged_paged_attention(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        ref = PA.paged_attention_ref(q, kp, vp, bt, ln)
        err = _err(out, ref)
        zero_rows = [b for b, n in enumerate(lengths) if n == 0]
        _say("kernels", kernel="paged_decode", case=name,
             lengths=",".join(map(str, lengths)), max_abs_err=err,
             tol=PAGED_TOL)
        assert err <= PAGED_TOL, "paged_decode disagrees"
        assert all(bool((out[b] == 0).all()) for b in zero_rows), \
            "paged_decode: a length-0 row is not zero"
        assert bool(torch.isfinite(out.float()).all())
        worst = max(worst, err)
    ms = _time_ms(lambda: PA.ragged_paged_attention(q, kp, vp, bt, ln), 50)
    plain_ms = _time_ms(lambda: PA.paged_attention_ref(q, kp, vp, bt, ln),
                        10)
    ctx = sum(main_lengths)
    nbytes = (2 * KVH * ctx * D * 2 + 2 * 2 * q.numel()
              + 4 * (bt.numel() + B))
    flops = 4.0 * NH * ctx * D
    bound = max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
    _say("kernels", kernel="paged_decode", shape=f"B{B}xctx{ctx}",
         ms=ms, plain_ms=plain_ms, bound_ms=bound,
         gbps=nbytes / ms / 1e6)
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:60",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def phase_parity(torch, dev):
    """Greedy tokens of one float32 llama_tiny model, served on the card
    and on the CPU, must be equal."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_tiny()
    cpu_params = L.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True),
                        cpu_params)
    rng = np.random.default_rng(5)
    trace = [(rng.integers(0, cfg.vocab_size, n), m)
             for n, m in zip((4, 7, 3, 5, 6, 9), (8, 5, 9, 6, 4, 7))]
    outs = {}
    for name, params, device in (("card", card_params, dev),
                                 ("cpu", cpu_params, "cpu")):
        K.reset_dispatch_stats()
        eng = ServingEngine(L, params, cfg, num_slots=2, max_len=16,
                            page_size=4, num_pages=5, decode_chunk=2,
                            device=device)
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(trace)])
        torch.cuda.synchronize()
        stats = K.dispatch_stats()
        outs[name] = [out[i].tokens.tolist() for i in range(len(trace))]
        _say("parity", engine=name, preempted=eng.stats.preempted,
             **stats)
        if name == "card":
            assert stats["flash"] > 0 and stats["paged"] > 0
            assert stats["flash_ref"] == 0 and stats["paged_ref"] == 0
        assert eng.stats.preempted >= 1
    same = outs["card"] == outs["cpu"]
    _say("parity", tokens_equal=same,
         tokens=sum(len(t) for t in outs["card"]))
    assert same, f"card {outs['card']} != cpu {outs['cpu']}"


def phase_main(torch, dev, layers, requests, card):
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_3_8b(num_hidden_layers=layers)
    t0 = time.perf_counter()
    params = L.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    nparams = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "ln_f", "lm_head"))
    _say("main", layers=layers, params_b=round(nparams / 1e9, 3),
         weights_gb=round(2 * nparams / 1e9, 2),
         init_s=round(time.perf_counter() - t0, 2))
    eng = ServingEngine(L, params, cfg, num_slots=8, max_len=2048)
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    t0 = time.perf_counter()
    out = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.dispatch_stats()
    st = eng.stats
    ttft = sorted(o.ttft_s for o in out.values())
    _say("main", card=repr(card), requests=len(out),
         wall_s=round(wall, 3),
         prefill_tokens=st.tokens_prefilled, prefill_s=st.prefill_s,
         prefill_tok_per_s=st.tokens_prefilled / st.prefill_s,
         decode_tokens=st.tokens_decoded, decode_steps=st.decode_steps,
         decode_s=st.decode_s,
         decode_tok_per_s=st.tokens_decoded / st.decode_s,
         ttft_median_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
         preempted=st.preempted,
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2))
    _say("main", flash_launches=launches["flash"],
         paged_launches=launches["paged"],
         paged_per_decode_step=launches["paged"] / st.decode_steps,
         flash_ref=launches["flash_ref"], paged_ref=launches["paged_ref"])
    assert launches["flash"] > 0 and launches["paged"] > 0, launches
    assert launches["flash_ref"] == 0 and launches["paged_ref"] == 0
    for r in requests:
        toks = out[r.rid].tokens
        assert len(toks) == r.max_new_tokens, (r.rid, len(toks))
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), r.rid
    return launches


def phase_flash_bwd(torch, dev, batch, seq):
    """The backward kernels against their plain version on the same card
    tensors (out and lse from the forward kernel), then timed at the
    training path's shape."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(4)
    H, KVH, D = 32, 8, 128

    def inputs(b, sq, sk, dtype, causal):
        q, k, v, dout = (torch.randn(b, s, h, D, generator=gen, device=dev)
                         .to(dtype) for s, h in ((sq, H), (sk, KVH),
                                                 (sk, KVH), (sq, H)))
        out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        return q, k, v, out, lse, dout

    def check(args, is_causal, tol, **what):
        got = FA.flash_attention_bwd(*args, causal=is_causal)
        torch.cuda.synchronize()
        want = FA.flash_attention_bwd_ref(*args, causal=is_causal)
        errs = [_err(g, w) for g, w in zip(got, want)]
        rel = max(e / float(w.float().abs().max())
                  for e, w in zip(errs, want))
        _say("kernels", kernel="flash_bwd", **what, max_abs_err=max(errs),
             rel_err=rel, tol=tol)
        assert rel <= tol, "flash_bwd disagrees"
        assert all(bool(torch.isfinite(g.float()).all()) for g in got)
        return got, max(errs)

    worst = 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    for sq, sk, causal, dtype, tol in ((16, 16, True, bf16, BWD_TOL),
                                       (48, 48, True, bf16, BWD_TOL),
                                       (512, 512, True, bf16, BWD_TOL),
                                       (48, 48, False, bf16, BWD_TOL),
                                       (48, 48, True, f32, BWD_F32_TOL),
                                       (32, 80, True, bf16, BWD_TOL),
                                       (80, 48, True, bf16, BWD_TOL)):
        got, err = check(inputs(2, sq, sk, dtype, causal), causal, tol,
                         Sq=sq, Sk=sk, causal=causal,
                         dtype=str(dtype).split(".")[-1])
        if sq > sk:     # rows that see no key: exact zeros
            assert bool((got[0][:, :sq - sk] == 0).all()), \
                "flash_bwd: a row that sees no key has a nonzero dq"
            _say("kernels", kernel="flash_bwd", zero_rows=sq - sk,
                 dq_zero=True)
        if dtype == bf16:
            worst = max(worst, err)

    # the training path's shape: one layer's attention of the train phase;
    # its out / lse from the forward kernel are held to the plain forward
    args = inputs(batch, seq, seq, bf16, True)
    ref, ref_lse = FA.flash_attention_ref(*args[:3], causal=True)
    err, lerr = _err(args[3], ref), _err(args[4], ref_lse)
    _say("kernels", kernel="flash_fwd", shape=f"B{batch}xS{seq}",
         max_abs_err=err, lse_err=lerr, tol=FLASH_TOL)
    assert err <= FLASH_TOL and lerr <= LSE_TOL, \
        "flash_fwd disagrees at the training path's shape"
    del ref, ref_lse
    _, err = check(args, True, BWD_TOL, shape=f"B{batch}xS{seq}")
    worst = max(worst, err)
    ms = _time_ms(lambda: FA.flash_attention_bwd(*args, causal=True), 5)
    plain_ms = _time_ms(
        lambda: FA.flash_attention_bwd_ref(*args, causal=True), 3)
    q, k, v, _, _, dout = args
    leaves = [x.transpose(1, 2).contiguous().requires_grad_()
              for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    lib_dout = dout.transpose(1, 2).contiguous()
    library_ms = _time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, lib_dout, retain_graph=True), 5)
    del lib_out, leaves, args
    # least work: 5 causal products (q k^T, dout v^T, dv, dq, dk) of
    # B*H*S^2*D operations each; bytes: q, o, dout, k, v, lse read once,
    # dq, dk, dv written once
    flops = 5.0 * batch * H * seq * seq * D
    nbytes = (2 * batch * seq * D * (4 * H + 4 * KVH)
              + 4 * batch * H * seq)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    _say("kernels", kernel="flash_bwd", shape=f"B{batch}xS{seq}", ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
         tflops=flops / ms / 1e9)
    return {"name": "flash_bwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention.py:146",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def phase_train_parity(torch, dev):
    """Three train steps of one float32 llama_tiny model on the card
    (kernels) and on the CPU (plain versions)."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_tiny()
    cpu_params = L.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True),
                        cpu_params)
    batch = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 33)))
    losses, grads = {}, {}
    for name, params in (("card", card_params), ("cpu", cpu_params)):
        K.reset_dispatch_stats()
        grads[name] = L._leaves(L.loss_and_grads(params, batch, cfg)[1])
        state = L.adamw_init(params)
        step = L.make_train_step(cfg)
        losses[name] = [float(step(params, state, batch)[2])
                        for _ in range(3)]
        torch.cuda.synchronize()
        stats = K.dispatch_stats()
        _say("train_parity", device=name, losses=losses[name], **stats)
        if name == "card":
            assert stats["flash_bwd"] > 0 and stats["flash_bwd_ref"] == 0
            assert stats["flash"] > 0 and stats["flash_ref"] == 0
            assert stats["fused_ce"] > 0
    grad_err = max(_err(a.cpu(), b) / float(b.abs().max())
                   for a, b in zip(grads["card"], grads["cpu"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    _say("train_parity", loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
         grad_rel_err=grad_err, grad_tol=TRAIN_GRAD_TOL)
    assert loss_err <= TRAIN_LOSS_RTOL, losses
    assert grad_err <= TRAIN_GRAD_TOL, grad_err


def train_setup(torch, dev):
    """The training main path's ``(cfg, params, opt_state, step, batch)``:
    Llama-3-8B widths at ``TRAIN_LAYERS`` layers, random bf16 weights from
    seed 0, float32 AdamW moments, ids ``[TRAIN_BATCH, TRAIN_SEQ + 1]``
    from ``numpy.random.default_rng(0)``, all on ``dev``."""
    import numpy as np
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_3_8b(num_hidden_layers=TRAIN_LAYERS)
    params = L.init_params(cfg, seed=0, device=dev)
    state = L.adamw_init(params, moment_dtype=torch.float32)
    step = L.make_train_step(cfg)
    batch = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1)), device=dev)
    return cfg, params, state, step, batch


def phase_train(torch, dev, card):
    """The training main path: Llama-3-8B widths, 4 layers, AdamW."""
    import math

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    t0 = time.perf_counter()
    cfg, params, state, step, batch = train_setup(torch, dev)
    torch.cuda.synchronize()
    nparams = L.count_params(cfg)
    _say("train", layers=TRAIN_LAYERS, params_b=round(nparams / 1e9, 3),
         remat=cfg.remat_policy, fused_ce=cfg.fused_ce,
         batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}",
         init_s=round(time.perf_counter() - t0, 2))
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    losses, times = [], []
    for i in range(7):
        t0 = time.perf_counter()
        _, _, loss = step(params, state, batch)
        losses.append(float(loss))        # waits for the step's end
        times.append(time.perf_counter() - t0)
    launches = K.dispatch_stats()
    timed = sorted(times[2:])
    step_s = timed[len(timed) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    _say("train", card=repr(card), losses=losses,
         step_ms=[t * 1e3 for t in times[2:]], median_step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s,
         mfu_6nd=6.0 * nparams * tokens / step_s / H100_BF16_FLOPS,
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2))
    _say("train", steps=len(times), flash_launches=launches["flash"],
         flash_bwd_launches=launches["flash_bwd"],
         fused_ce=launches["fused_ce"], flash_ref=launches["flash_ref"],
         flash_bwd_ref=launches["flash_bwd_ref"],
         fused_ce_fallback=launches["fused_ce_fallback"],
         paged_ref=launches["paged_ref"])
    ln_v = math.log(cfg.vocab_size)
    assert all(math.isfinite(x) for x in losses), losses
    assert ln_v - 1 <= losses[0] <= ln_v + 2, (losses[0], ln_v)
    assert losses[-1] < losses[0], losses
    assert launches["flash_bwd"] == TRAIN_LAYERS * len(times), launches
    assert launches["fused_ce"] == len(times), launches
    assert all(launches[k] == 0 for k in ("flash_ref", "flash_bwd_ref",
                                          "paged_ref", "fused_ce_fallback"))
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="main-path depth (default: all 32 layers)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import llama as L

    dev = torch.device("cuda", 0)
    # float32 parity needs full float32 products on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _say("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0).replace(" ", "_"))

    t0 = time.perf_counter()
    compiled = _build.build_all()
    _say("build", seconds=round(time.perf_counter() - t0, 2),
         compiled=",".join(f"{k}:{v:.1f}s" for k, v in compiled.items())
         or "cached")
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _say("build", lib=name, ptxas=line.strip().replace(" ", "_"))

    cfg = L.llama_3_8b(num_hidden_layers=args.layers)
    requests = _main_requests(cfg.vocab_size)
    maxp = 2048 // 16
    # decode lengths of the first wave, half-way through its generation
    main_lengths = [int(r.prompt.shape[0]) + r.max_new_tokens // 2
                    for r in requests[:8]]
    flash = phase_flash(torch, dev, 8, 512)
    paged = phase_paged(torch, dev, main_lengths, 8 * maxp, maxp)
    flash_bwd = phase_flash_bwd(torch, dev, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.empty_cache()
    phase_parity(torch, dev)
    phase_train_parity(torch, dev)
    launches = phase_main(torch, dev, args.layers, requests, smi)
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, dev, smi)
    # launches on each kernel's main path: serving for the forward and
    # the decode kernel, training for the backward
    flash["launches"] = launches["flash"]
    paged["launches"] = launches["paged"]
    flash_bwd["launches"] = train_launches["flash_bwd"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in (flash, paged, flash_bwd)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
