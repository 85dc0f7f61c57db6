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
   (``scaled_dot_product_attention``, forward or backward). The dense
   flash pair is checked on both routes: bf16 at head dim 128 and 64
   (up to S 1000, Sq != Sk, rows that see no key exactly zero) on the
   tensor cores, float32 on the CUDA cores, each launch counted on the
   route it must take; the forward is timed at the serving and the
   training shapes, the backward at the training shape; the decode
   kernel (``kernel=paged_decode``, bf16 pages of 16) at edge lengths,
   the first and second waves' lengths, lengths at the split plan's
   chunk edges up to the full 2048-position table, one sequence over the
   full table, 32 sequences (twice, bit for bit) and NaN in every slot
   past a sequence's length; its int8 arm (``kernel=paged_decode_int8``)
   at page sizes 16, 32 and 64 with float32 and bfloat16 queries,
   against the full-precision kernel on the densely dequantized pages,
   and at int8 pages of 32 on the same cases (NaN scales where the
   table's sentinel entries point); both arms timed at the first wave,
   the second wave and 32 sequences over the full table by the
   profiler's device time of the split and combine kernels over a
   rotation of pools larger than the L2 (``decode_timing``), beside the
   old back-to-back wrapper time (``wrapper_ms``); the dense flash pair
   and the bf16 decode kernel are checked again at DeepSeekMoE-16B's 16
   query and 16 kv heads (no GQA) at the MoE main paths' shapes:
   ``moe_main``'s prefill groups and decode lengths (its split plan),
   ``moe_train``'s 8 x 1024;
   layer_grads: one bf16 layer at Llama-3-8B widths, forward and
   backward, with attention through the kernels and through the plain
   version: the q, k, v gradients must agree within ``BWD_TOL``; then
   the same with the packed trace's first two rows of segment ids and
   positions, through the segment kernels;
3. parity: a ``llama_tiny`` float32 model with one set of weights is
   served on the card (kernels) and on the CPU (plain versions); the
   greedy tokens must be equal, through queueing and preemption;
4. quant_parity: the same with int8 KV pages, alone and with int8 and
   int4 weight-only trees; the card must decode through the int8 arm;
5. train_parity: the same kind of model takes 3 ``make_train_step``
   steps on the card and on the CPU; losses and step-1 gradients must
   agree, and the card's steps must go through the kernels;
6. main: a ``ServingEngine`` at Llama-3-8B widths (random bf16 weights
   from a seed) serves 16 requests; both kernels' launch counts over
   this run must be above zero and every token in range; then the JAX
   serving rung's uniform-batch baseline: the same requests in waves of
   8 through ring-cache ``generate``, each wave padded to the largest
   prompt and generation (``uniform_batch_tokens_per_sec``,
   ``speedup_vs_uniform``);
7. main_kvq: the same requests with ``kv_quant=True`` (int8 KV pages of
   32 tokens, the JAX package's ``kv_quant`` arm of its serving rung):
   every decode launch must take the int8 arm; pool bytes per KV token
   against bf16 pages; how many requests give ``main``'s greedy tokens
   (a reading: int8 KV is lossy);
8. main_wq: the same with int8 weight-only weights
   (``quantize_weights``) and int8 KV pages, the quantized memory plane;
9. train: ``make_train_step`` at Llama-3-8B widths, 4 layers (vocab
   128256, blockwise cross entropy, the ``make_train_step`` defaults; not
   the JAX package's headline rung, which has vocab 32000, materialising
   cross entropy and bf16 moments), random bf16 weights from seed 0,
   float32 AdamW moments, batch 4 x 2048: 2 untimed and 5 timed steps on
   one batch; the loss must be finite and fall, and every step must run
   the backward kernel once a layer and no plain version;
10. train_packed_parity: 3 sequence-packed ``llama_tiny`` float32 steps
    on the card and on the CPU (losses, step-1 gradients), and the packed
    loss against the same documents one per row on the card;
11. train_packed: the JAX package's packed training rung (``bench.py``
    ``_training_packed_rung``): Llama-3-8B widths, 4 layers, vocab 32000,
    materialising cross entropy, bf16 AdamW moments, lr 1e-4; 24
    heavy-tailed documents (seed 7) packed into one ``[7, 2048]`` batch,
    2 untimed and 5 timed steps, every step through the segment kernels
    (2 forward launches and 1 backward a layer) and no plain version;
    then the same documents one per row in 4 waves of ``[7, 2048]``
    through the dense kernels (1 untimed and 2 timed passes), for useful
    tokens/s both ways;
12. eager_parity: one float32 ``llama_tiny`` eager ``LlamaForCausalLM``
    (the Paddle surface: ``model(ids)``, ``F.cross_entropy``,
    ``loss.backward()``, ``optimizer.AdamW``) with one set of weights
    takes 3 steps on the card and on the CPU; losses and step-1
    gradients must agree, and the card must go through the RMSNorm and
    flash kernels and no plain version;
13. eager_train: the same eager model at Llama-3-8B widths, 4 layers
    (``seed(0)``, Paddle's default initializers, ``.to(dtype=
    "bfloat16")``, ``AdamW(learning_rate=3e-4)``), ids ``[4, 2049]`` from
    a numpy seed: 2 untimed and 5 timed steps on one batch; the loss must
    be finite and fall, and every step must launch the RMSNorm forward
    and backward kernels ``2L + 1`` times each, the flash forward and
    backward once a layer, and no plain version;
14. generate_parity: one float32 ``llama_tiny`` model with one set of
    weights runs ring-cache ``generate`` (greedy, and with EOS and a
    negative pad) and ``beam_search`` (3 beams, EOS) on the card and on
    the CPU: tokens equal, beam scores within ``BEAM_SCORE_TOL``; the
    card's prefills launch the flash kernel, no plain version;
15. moe_parity: one float32 ``moe_tiny`` model (capacity dispatch) on
    the card and on the CPU: ``ServingEngine`` through queueing and a
    preemption with full-precision and with int8 pages, ``generate``, 3
    ``make_train_step`` steps; tokens equal, losses and step-1 gradients
    within the train tolerances, and the card through ``flash``,
    ``flash_bwd``, ``paged`` and ``paged_quant``, no plain version;
16. generate: the JAX package's decode rung (``bench.py``
    ``_decode_rung``) on the ring cache: Llama-3-8B widths, 4 layers,
    vocab 32000, random bf16 weights from seed 0, prompt 128, 64 greedy
    tokens at batch 8, 16 and 32 (decode tokens/s, ms a token, prefill
    ms and tokens/s, and ``generate`` end to end), then int8 and int4
    weight-only trees at batch 8, then ``beam_search`` with 4 beams at
    batch 8; every prefill on the flash kernel's tensor-core route;
17. moe_main: the serving main path over DeepSeekMoE-16B (28 layers,
    16.88 B parameters, random bf16 weights from seed 0 with a float32
    router) and the same engine and request shapes over its vocab,
    after the Llama weights are freed; both serving kernels must launch;
18. moe_train: the JAX package's MoE rung (``bench.py`` ``_moe_rung``):
    DeepSeekMoE-16B widths at 2 layers, capacity dispatch, materialising
    cross entropy, remat ``"dots"``, bf16 AdamW moments, lr 1e-4, ids
    ``[8, 1025]``: 2 untimed and 5 timed steps (step ms, tokens/s, MFU on
    the active parameters, peak memory); the loss must be finite and
    fall, and every step must launch the flash forward twice a layer
    (remat) and the backward once, on their tensor-core routes, and no
    plain version;
19. no_sync (before ``main``, on its weights): the ``ServingEngine``
    serves 3 prompts of one bucket (512) in 4 slots: one prefill group
    (a dummy row of sentinel pages) and one 8-step decode chunk (a dead
    slot) at Llama-3-8B widths, with bf16 pages, int8 pages, and one
    request sampled (bf16 pages), with its data plane (``_prefill_plane``,
    ``_decode_plane``) under ``torch.cuda.set_sync_debug_mode("error")``:
    no host sync may happen there, and the tokens must equal the same
    serve's outside that mode;
20. surface (card against CPU on the same seeded inputs): masked
    ``F.scaled_dot_product_attention`` (boolean and additive masks, with
    causal, 32 / 8 heads, float32 and bf16: plain math, no flash launch),
    ``flash_attention_with_sparse_mask``, dropout by its statistics (keep
    rate within six binomial deviations, kept values scaled by
    ``1 / (1 - p)``), ``F.flash_attention`` and ``flash_attn_qkvpacked``
    in bf16 at D 128 (one tensor-core flash launch each, equal to
    ``sdpa_raw``) and ``fused_rms_norm`` (one ``rms`` launch, equal to
    ``F.rms_norm``);
21. eager_recipe_parity: the training recipe (``AdamW`` with beta2 0.95
    and weight decay 0.1, ``LinearWarmup`` over ``CosineAnnealingDecay``,
    ``ClipGradByGlobalNorm`` at 0.05, which binds from step 1 on
    llama_tiny) on a float32 llama_tiny ``LlamaForCausalLM``, 3 steps on
    the card and on the CPU from one set of weights (losses and step-1
    gradients at the train tolerances), and on each device a
    ``state_dict`` after step 2 into a fresh optimizer and scheduler whose
    step 3 equals the uninterrupted run's bit for bit;
22. eager_recipe: ``eager_train`` with the recipe (clip norm 1.0): the
    median step beside ``eager_train``'s of the same run, the learning
    rate and the clip's scale at each step (read after the timed
    window), the clip alone and the scheduler's step alone timed, and
    ``eager_train``'s launch counts, every one on a kernel.
23. flash_d (in the kernels phase): the flash pair at head dims 8, 24,
    40, 72, 80, 136, 192 and 256 (``FLASH_DIMS``: under 16, not a
    multiple of 16, above 128), float32 and bf16, GQA 8 / 2:
    the dense forward and backward causal at Sq 70 != Sk 100 and not
    causal at a ragged S 100, the segment pair on a packed layout with a
    padding tail and on Sq 70 != Sk 90, each against its plain version at
    the forward and backward tolerances below, bf16 at 72 on the tensor
    cores and every other launch off them; then the two DiT-XL/2 records
    (``phase_dit_kernels``): the forward at the sampling shape ``[16,
    256, 16, 72]`` and the backward at the training shape ``[32, 256,
    16, 72]``, bf16, not causal, on the tensor cores, their device times
    taken in turns with SDPA's (median of ``DIT_TIMING_REPS``), beside
    their plain versions and the float32 CUDA-core route, then against
    the waves of blocks they launch;
24. dit_parity: one DiT at head dim 72 (hidden 144, 2 heads, 2 blocks;
    zero leaves refilled so the gates are not zero) on the card and on
    the CPU, float32 (the CUDA cores) and bf16 (the tensor cores):
    forward and ``loss_fn`` within ``DIT_PARITY_TOL`` / ``DIT_BF16_TOL``,
    step-1 gradients, 3 ``make_train_step`` losses and a 5-step DDIM loop
    (eta 1, guidance 4.0) from the same draws; the card through
    ``flash`` and ``flash_bwd``, no plain version;
25. dit_sample: DiT-XL/2 (675 M parameters, 28 blocks, bf16, random
    weights from seed 0 with refilled gates) samples 8 labels under
    classifier-free guidance 4.0 (16 rows a forward) in 50 DDIM steps at
    eta 0: ms a step, images/s, peak memory; 1400 flash launches a call
    (28 a step), all on the tensor cores (head dim 72), finite samples;
26. dit_train: the same model, remat on, float32 AdamW moments, lr
    1e-4, 32 latents of 4 x 32 x 32 (the DiT paper's 256 over 8 GPUs):
    2 untimed and 5 timed steps, median step ms, images/s, MFU by 6 N
    tokens (attention's operations not credited), peak memory; the flash
    forward twice a block (remat) and the backward once, both on the
    tensor cores; the loss finite and falling;
27. prefix_plane (after ``no_sync``, on ``main``'s weights before they
    are quantized; bf16 pages of 16, int8 pages of 16, then the same
    model cast to float32 on float32 pages): 4 prompts of 1024 tokens
    sharing their first 768, through one ``paged_prefill`` and through a
    prefill of the prefix plus ``paged_prefill_shared`` of the 256-token
    tails over its pages; a ``paged_verify_window`` of 4 drafted tokens
    at 8 sequences of 257-1024 tokens against 4 greedy
    ``paged_decode_step``s; both functions under
    ``set_sync_debug_mode("error")``. float32: logits and tail pages
    within ``PREFIX_F32_TOL`` of the largest value, every argmax equal.
    bf16 and int8: each function bit for bit against the same math
    (``prefix_plane_checks``), its difference from the kernel paths a
    reading under ``PREFIX_DRIFT_GUARD``; wall ms of each beside what it
    replaces;
28. guard: the guarded train step (``make_train_step(guard=True)``) at
    ``train``'s configuration and at ``moe_train``'s: a clean step gives
    the unguarded step's loss, parameters and moments bit for bit and
    makes one host sync more than it (counted under
    ``set_sync_debug_mode("warn")``); ``iinfo(int32).min`` at ``[0, 0]``,
    ``vocab_size`` at ``[0, 3]`` and a cap of 1e-9 give ``finite`` false
    and write nothing; the next clean step, with numerics, applies bit
    for bit and its squared norms tile ``grad_norm`` within
    ``GUARD_NORM_RTOL``; unguarded, guarded and numerics step ms;
29. remat_attn: ``train``'s loss and every gradient under remat
    ``"attn"`` and ``"full"`` equal bit for bit, with 4 and 8 flash
    forward launches and 4 backward launches; the packed rung's batch
    the same through the segment kernels; step ms and peak memory of
    each policy on ``train``'s path.

The kernels phase also holds the RMSNorm forward and backward kernels to
their plain versions (``kernel=rms_norm_fwd|rms_norm_bwd``: d 64, 4096
and 5120 with n 1, 22 and 8193, each float32 / bfloat16 pair of x and w,
then the eager path's ``[8192, 4096]`` bfloat16, where ``dw`` must be
the same bit for bit in two launches) and times kernel, plain version
and ``torch.nn.functional.rms_norm`` (forward, and its autograd
backward), and it holds the segment (packed) kernels to their plain
versions at 11 shapes (bf16 at head dim 64 and 128 on the tensor cores,
up to a ragged S 1000 with a padding tail; float32 on the CUDA cores),
to the dense kernels on a one-document row, and at the packed trace's
shape checks that the forward kernel computes exactly the tiles
``count_skipped_blocks`` leaves at the route's tiles (``seg_tiles``),
then times both beside ``scaled_dot_product_attention`` with a
block-diagonal causal mask.

Every bf16 main path (``main`` and its uniform baseline, ``main_kvq``,
``main_wq``, ``generate``, ``moe_main``, ``train``, the padded pass of
``train_packed``, ``eager_train``, ``moe_train``, ``dit_sample``,
``dit_train``) must launch the
dense flash kernels only on their tensor-core route (``flash_tc ==
flash``, ``flash_bwd_tc == flash_bwd``), and the packed pass of
``train_packed`` the segment kernels only on theirs (``varlen_tc ==
varlen``, ``varlen_bwd_tc == varlen_bwd``). The build phase prints the
registers and spills of every flash kernel (the tensor-core ones at
each head dim they take, ``flash_fwd_tc_kernel<72,DenseTC>``, the
CUDA-core ones at each padded head dim,
``flash_fwd_kernel<bf16,Dp80,DenseMask>``), each
decode kernel (``paged_decode_kernel<q, page, heads>``,
``paged_decode_combine_kernel``) and the RMSNorm backward from
``ptxas``.

Then it prints the kernel records as one JSON line, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repo beside it, it exits non-zero
before printing any result.

``--layers N`` cuts the depth of the serving main paths: the three Llama
ones (default: all 32 layers) and ``moe_main`` (at most its 28).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
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
# RMSNorm: float32 outputs differ by summation order; one bf16 ulp is
# 3.9e-3 of a value, and a value may round the other way
RMS_F32_TOL = 1e-5
RMS_BF16_TOL = 8e-3     # both relative to max |ref|
RMS_EPS = 1e-5          # llama_3_8b's rms_norm_eps
BEAM_SCORE_TOL = 1e-5   # float32 beam scores, card against CPU
# the JAX package's decode rung: batches, prompt and new tokens
DECODE_BATCHES = (8, 16, 32)
DECODE_PROMPT, DECODE_NEW = 128, 64
# the JAX package's MoE rung: DeepSeekMoE-16B widths at 2 layers
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 8, 1024
MOE_HEADS = (16, 16)    # DeepSeekMoE-16B: 16 query and 16 kv heads of 128
# the packed rung's trace: heavy-tailed document lengths and token ids
# from one seed, packed into rows of PACKED_SEQ
PACKED_DOCS, PACKED_SEQ, PACKED_SEED, PACKED_VOCAB = 24, 2048, 7, 32000
# head dims of the flash pair held to the plain versions beyond the
# tensor cores' 64 / 128: the CUDA-core route in float32 at each, and in
# bf16 at each but 72, which takes the tensor cores (up to 128: 4 threads
# a row; above: 8)
FLASH_DIMS = (8, 24, 40, 72, 80, 136, 192, 256)
# DiT: parity within 1e-4 of the largest value (of each gradient's max),
# card against CPU, float32 at head dim 72: the flash pair's own float32
# tolerance (summation order and __expf), which every gradient passes
# through, and cuBLAS sums over the batch's tokens in another order than
# the CPU's; sampling 8 labels under guidance 4.0, 50 DDIM steps;
# training at the DiT paper's 256 over 8 GPUs, 32 images a card
DIT_PARITY_TOL = 1e-4
# bf16 at head dim 72 (the tensor cores), card against CPU, each relative
# to the largest value: the flash pair's bf16 tolerance (FLASH_TOL,
# BWD_TOL: one bf16 rounding of P and of dS, which the kernels make and
# the plain backward does not). The whole bf16-vs-float32 drift of this
# model on the CPU is at most 8.4e-3 (gradients) and 4.9e-3 (forward).
DIT_BF16_TOL = 2e-2
DIT_LABELS, DIT_STEPS, DIT_GUIDANCE = 8, 50, 4.0
# interleaved repetitions of each timing in phase_dit_kernels (median),
# and the batches of its waves reading at DiT's [b, 256, 16, 72]
DIT_TIMING_REPS = 5
DIT_WAVE_BATCHES = (4, 8, 16, 32)
DIT_TRAIN_BATCH = 32


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


def _ptxas_entries(log):
    """``(kernel, registers, spill store bytes, spill load bytes)`` of
    each entry function in a ``ptxas -v`` log; a template kernel is
    named ``name<D>`` or ``name<D,Policy>`` from its mangled name."""
    import re
    out, kernel, spills = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"\d((?:flash|paged|rms)\w*?_kernel)"
                          r"(?:ILi(\d+)E(?:NS_(\d+)(\w+))?)?", mangled)
            args = []
            if m and m.group(2):
                args.append(m.group(2))
            if m and m.group(3):          # a policy: its name's length
                args.append(m.group(4)[:int(m.group(3))])
            if m and m.group(1).startswith(("paged_decode", "rms")):
                args = _decode_args(mangled[m.end(1):])
            cc = m and re.match(r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ENS_"
                                r"(\d+)(\w+)", mangled[m.end(1):])
            if cc:                        # <T, G, NC, Mask>: Dp = 4 G NC
                args = [{"f": "float"}.get(cc.group(1), "bf16"),
                        f"Dp{4 * int(cc.group(2)) * int(cc.group(3))}",
                        cc.group(5)[:int(cc.group(4))]]
            kernel = (f"{m.group(1)}<{','.join(args)}>" if args
                      else m.group(1) if m else mangled)
        elif kernel and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            spills = tuple(int(n) for n in nums[:2])
        elif kernel and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((kernel, regs, *spills))
            kernel, spills = None, (0, 0)
    return out


def _decode_args(rest):
    """The template arguments of a mangled decode kernel name after its
    name (``I13__nv_bfloat16aLi4ELb1EEE...``): types, numbers and bools
    (1 / 0); a substitution (``S1_``) repeats the type before it."""
    import re
    m = re.match(r"I((?:f|a|13__nv_bfloat16|S\d*_|L[ib]\d+E)+)E", rest)
    args = []
    for tok in re.finditer(r"f|a|13__nv_bfloat16|S\d*_|L[ib](\d+)E",
                           m.group(1) if m else ""):
        t = tok.group(0)
        args.append(tok.group(1) if tok.group(1) else
                    {"f": "float", "a": "int8",
                     "13__nv_bfloat16": "bf16"}.get(t, args[-1] if args
                                                    else t))
    return args


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


def _tc_launches(K, kind, want):
    """Assert that one launch of a dense flash kernel (``kind``:
    ``flash`` or ``flash_bwd``) was made since the counters were reset,
    on the tensor-core route exactly when ``want`` (bf16 at D 64 / 72 /
    128)."""
    st = K.dispatch_stats()
    assert st[kind] == 1 and st[f"{kind}_tc"] == int(want), st


def moe_flash_cases(main_g, main_s):
    """``(B, Sq, Sk, causal)`` of the dense flash kernels at
    DeepSeekMoE-16B's heads: edge shapes, then the MoE main paths' own:
    ``moe_main``'s prefill groups at its two buckets (the same requests
    as ``main``) and ``moe_train``'s batch."""
    return tuple(dict.fromkeys((
        (2, 48, 48, True), (2, 48, 48, False), (2, 80, 48, True),
        (2, 1000, 1000, True), (main_g, main_s, main_s, True),
        (main_g, 2 * main_s, 2 * main_s, True),
        (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_SEQ, True))))


def phase_flash(torch, dev, main_g, main_s):
    """The forward kernel against its plain version: Llama-3-8B's heads
    (32 / 8) at edge shapes on both routes, then DeepSeekMoE-16B's (16 /
    16, no GQA) at ``moe_flash_cases``; then timed at the serving main
    path's first prefill group."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(1)
    H, KVH, D = 32, 8, 128

    def qkv(b, sq, sk, dtype, d=D, heads=(H, KVH)):
        h, kvh = heads
        return tuple(torch.randn(b, s, n, d, generator=gen, device=dev)
                     .to(dtype) for s, n in ((sq, h), (sk, kvh), (sk, kvh)))

    worst = 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    for sq, sk, d, causal, dtype, tol in (
            (16, 16, D, True, bf16, FLASH_TOL),
            (48, 48, D, True, bf16, FLASH_TOL),
            (512, 512, D, True, bf16, FLASH_TOL),
            (48, 48, D, False, bf16, FLASH_TOL),
            (1000, 1000, D, True, bf16, FLASH_TOL),
            (80, 48, D, True, bf16, FLASH_TOL),
            (48, 48, 64, True, bf16, FLASH_TOL),
            (1000, 1000, 64, True, bf16, FLASH_TOL),
            (200, 200, 64, False, bf16, FLASH_TOL),
            (48, 48, D, True, f32, FLASH_F32_TOL)):
        q, k, v = qkv(2, sq, sk, dtype, d)
        K.reset_dispatch_stats()
        out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _tc_launches(K, "flash", FA.tensor_core_route(q))
        ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
        seen = torch.isfinite(ref_lse)
        err = _err(out, ref)
        lerr = _err(torch.where(seen, lse, 0.0), torch.where(seen, ref_lse,
                                                               0.0))
        _say("kernels", kernel="flash_fwd", Sq=sq, Sk=sk, D=d, causal=causal,
             dtype=str(dtype).split(".")[-1],
             route="tc" if FA.tensor_core_route(q) else "cuda_cores",
             max_abs_err=err, lse_err=lerr, tol=tol)
        assert err <= tol and lerr <= LSE_TOL, "flash_fwd disagrees"
        if causal and sq > sk:      # rows that see no key: exact zeros
            assert bool((out[:, :sq - sk] == 0).all()), \
                "flash_fwd: a row that sees no key has a nonzero output"
            assert bool((lse[..., :sq - sk] == float("-inf")).all()), \
                "flash_fwd: a row that sees no key has a finite lse"
            _say("kernels", kernel="flash_fwd", zero_rows=sq - sk,
                 out_zero=True, lse_neg_inf=True)
        if dtype == bf16:
            worst = max(worst, err)

    for b, sq, sk, causal in moe_flash_cases(main_g, main_s):
        q, k, v = qkv(b, sq, sk, bf16, heads=MOE_HEADS)
        K.reset_dispatch_stats()
        out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _tc_launches(K, "flash", True)
        ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
        seen = torch.isfinite(ref_lse)
        err = _err(out, ref)
        lerr = _err(torch.where(seen, lse, 0.0), torch.where(seen, ref_lse,
                                                               0.0))
        _say("kernels", kernel="flash_fwd", heads="16/16", B=b, Sq=sq,
             Sk=sk, D=D, causal=causal, dtype="bfloat16", route="tc",
             max_abs_err=err, lse_err=lerr, tol=FLASH_TOL)
        assert err <= FLASH_TOL and lerr <= LSE_TOL, \
            "flash_fwd disagrees at DeepSeekMoE-16B's heads"
        if causal and sq > sk:
            assert bool((out[:, :sq - sk] == 0).all())
        worst = max(worst, err)
        del out, lse, ref, ref_lse
    torch.cuda.empty_cache()

    # the main path's first prefill group: G requests at one bucket
    q, k, v = qkv(main_g, main_s, main_s, bf16)
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
         share_of_bound=bound / ms, tflops=flops / ms / 1e9)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention.py:40",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if flops / H100_BF16_FLOPS
            >= nbytes / H100_BYTES_PER_S else "bytes",
            "library_ms": library_ms}


def rms_bwd_timing(torch, dev, RN, n, d, xdt, wdt, seed=0):
    """The RMSNorm backward of ``RN`` (a ``kernels.rms_norm`` module) at
    ``[n, d]``: ``torch.profiler``'s device time of its row pass and of
    its ``dw`` pass (kernels named ``rms_bwd*`` and ``rms_dw*``) over 30
    calls on one set of inputs (x and dy together exceed the L2 at the
    timed shapes, so each call finds them cold), beside the back-to-back
    wrapper time, ``F.rms_norm``'s autograd backward and ``torch.add``
    over the same three streams (read x and dy, write dx: the rate the
    card reaches on this traffic). Checks dx and dw against the plain
    version first. Bound: bytes (every input read once, every output
    written once)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=dev).to(xdt)
    w = (1 + 0.3 * torch.randn(d, generator=gen, device=dev)).to(wdt)
    dy = torch.randn(n, d, generator=gen, device=dev).to(xdt)
    _, rstd = RN.rms_norm_ref(x, w, RMS_EPS)
    dx, dw = RN.rms_norm_bwd(x, w, rstd, dy)
    dx_ref, dw_ref = RN.rms_norm_bwd_ref(x, w, rstd, dy)
    err = {}
    for name, got, want in (("dx", dx, dx_ref), ("dw", dw, dw_ref)):
        tol = RMS_F32_TOL if got.dtype == torch.float32 else RMS_BF16_TOL
        err[name] = _err(got, want) / float(want.float().abs().max())
        assert err[name] <= tol, (name, n, d, xdt, wdt, err[name])
    del dx_ref, dw_ref
    for _ in range(5):
        RN.rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    calls = 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            RN.rms_norm_bwd(x, w, rstd, dy)
        torch.cuda.synchronize()
    row_us = dw_us = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if "rms_dw" in evt.key:
            dw_us += us
        elif "rms_bwd" in evt.key:
            row_us += us
    assert row_us > 0 and dw_us > 0, "the profiler saw no backward kernel"
    ms = (row_us + dw_us) / calls / 1e3
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    yl = torch.nn.functional.rms_norm(xl, (d,), wl, RMS_EPS)
    out = torch.empty_like(x)
    nbytes = (3 * n * d * x.element_size() + 2 * d * w.element_size()
              + 4 * n)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    plan = (RN.bwd_plan(n, d, xdt, wdt)._asdict()
            if hasattr(RN, "bwd_plan") else
            {"route": "blocks", "grid": -(-n // RN.bwd_rows(n)),
             "rows": RN.bwd_rows(n)})
    return {"shape": f"{n}x{d}", "ms": ms, "row_ms": row_us / calls / 1e3,
            "dw_ms": dw_us / calls / 1e3,
            "wrapper_ms": _time_ms(lambda: RN.rms_norm_bwd(x, w, rstd, dy),
                                   50),
            "library_ms": _time_ms(lambda: torch.autograd.grad(
                yl, (xl, wl), dy, retain_graph=True), 50),
            "add_ms": _time_ms(lambda: torch.add(x, dy, out=out), 50),
            "bound_ms": bound, "bound_share": bound / ms,
            "gbps": nbytes / ms / 1e6, "max_rel_err": err,
            "plan": json.dumps(plan).replace(" ", "")}


def phase_rms(torch, dev):
    """The RMSNorm kernels against their plain versions on the same card
    tensors (every float32 / bfloat16 pair of x and w, d 64 / 4096 /
    5120, n 1 / 22 / 8193, each with the backward's plan), then at the
    eager path's ``[8192, 4096]`` bfloat16: ``dw`` bit for bit across
    two launches, times of kernel (the backward: device time of its row
    and ``dw`` passes, ``rms_bwd_timing``), plain version and
    ``torch.nn.functional.rms_norm``."""
    from paddle_tpu_torch.kernels import rms_norm as RN
    gen = torch.Generator(device=dev).manual_seed(13)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def inputs(n, d, xdt, wdt):
        x = torch.randn(n, d, generator=gen, device=dev).to(xdt)
        w = (1 + 0.3 * torch.randn(d, generator=gen, device=dev)).to(wdt)
        dy = torch.randn(n, d, generator=gen, device=dev).to(xdt)
        return x, w, dy

    def check(x, w, dy):
        """Worst error over y / dx / dw as a share of max |ref|, against
        each output's tolerance; returns the worst bf16 and f32 abs
        errors of the forward."""
        y, rstd = RN.rms_norm_fwd(x, w, RMS_EPS)
        dx, dw = RN.rms_norm_bwd(x, w, rstd, dy)
        torch.cuda.synchronize()
        y_ref, rstd_ref = RN.rms_norm_ref(x, w, RMS_EPS)
        dx_ref, dw_ref = RN.rms_norm_bwd_ref(x, w, rstd_ref, dy)
        errs = {}
        for name, got, want in (("y", y, y_ref), ("dx", dx, dx_ref),
                                ("dw", dw, dw_ref), ("rstd", rstd, rstd_ref)):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            tol = RMS_F32_TOL if got.dtype == torch.float32 else RMS_BF16_TOL
            rel = _err(got, want) / float(want.float().abs().max())
            assert rel <= tol, (name, tuple(x.shape), x.dtype, w.dtype, rel)
            errs[name] = rel
        return errs, _err(y, y_ref), _err(dx, dx_ref)

    def plan(n, d, xdt, wdt):
        p = RN.bwd_plan(n, d, xdt, wdt)
        return f"{p.route}:{p.grid}x{p.groups}x{p.threads}:s{p.stages}"

    worst_fwd = worst_bwd = 0.0
    for d in (64, 4096, 5120):
        for n in (1, 22, 8193):
            rel, plans = {}, {}
            for xn, wn in (("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"),
                           ("f32", "bf16")):
                errs, ef, eb = check(*inputs(n, d, dts[xn], dts[wn]))
                rel[f"{xn}x{wn}"] = max(errs.values())
                plans[f"{xn}x{wn}"] = plan(n, d, dts[xn], dts[wn])
                worst_fwd, worst_bwd = max(worst_fwd, ef), max(worst_bwd, eb)
            _say("kernels", kernel="rms_norm_fwd|rms_norm_bwd", n=n, d=d,
                 max_rel_err_by_x_w_dtype=json.dumps(rel).replace(" ", ""),
                 bwd_plan_grid_groups_threads_stages=json.dumps(
                     plans).replace(" ", ""),
                 f32_tol=RMS_F32_TOL, bf16_tol=RMS_BF16_TOL)

    # the eager path's shape: x [B * S, D] bf16, w [D] bf16
    n, d = TRAIN_BATCH * TRAIN_SEQ, 4096
    x, w, dy = inputs(n, d, torch.bfloat16, torch.bfloat16)
    errs, ef, eb = check(x, w, dy)
    worst_fwd, worst_bwd = max(worst_fwd, ef), max(worst_bwd, eb)
    _, rstd = RN.rms_norm_fwd(x, w, RMS_EPS)
    dws = [RN.rms_norm_bwd(x, w, rstd, dy)[1] for _ in range(2)]
    deterministic = bool(torch.equal(dws[0], dws[1]))
    _say("kernels", kernel="rms_norm_fwd|rms_norm_bwd", shape=f"{n}x{d}",
         dtype="bf16", max_rel_err=json.dumps(errs).replace(" ", ""),
         dw_bitwise_equal_across_launches=deterministic,
         bwd_plan=json.dumps(RN.bwd_plan(n, d, x.dtype, w.dtype)._asdict())
         .replace(" ", ""))
    assert deterministic, "rms_norm dw differs between two launches"

    ms_f = _time_ms(lambda: RN.rms_norm_fwd(x, w, RMS_EPS), 50)
    plain_f = _time_ms(lambda: RN.rms_norm_ref(x, w, RMS_EPS), 20)
    lib = torch.nn.functional.rms_norm
    lib_f = _time_ms(lambda: lib(x, (d,), w, RMS_EPS), 50)
    plain_b = _time_ms(lambda: RN.rms_norm_bwd_ref(x, w, rstd, dy), 20)
    e = x.element_size()
    del x, w, dy, rstd, dws
    tb = rms_bwd_timing(torch, dev, RN, n, d, torch.bfloat16, torch.bfloat16)
    _say("kernels", kernel="rms_norm_bwd", timing="device", **tb)
    # bytes each moves at least: every input read once, every output
    # written once; a few float32 operations an element besides
    fwd_bytes = 2 * n * d * e + d * e + 4 * n
    bwd_bytes = 3 * n * d * e + 2 * d * e + 4 * n
    fwd_ops, bwd_ops = 4.0 * n * d, 10.0 * n * d
    recs = []
    for name, line, ms, plain, libms, nbytes, ops, err in (
            ("rms_norm_fwd", 48, ms_f, plain_f, lib_f, fwd_bytes, fwd_ops,
             worst_fwd),
            ("rms_norm_bwd", 55, tb["ms"], plain_b, tb["library_ms"],
             bwd_bytes, bwd_ops, worst_bwd)):
        t_bytes = nbytes / H100_BYTES_PER_S
        t_ops = ops / H100_F32_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        _say("kernels", kernel=name, shape=f"{n}x{d}", dtype="bf16", ms=ms,
             plain_ms=plain, library_ms=libms, bound_ms=bound,
             bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
        recs.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/rms_norm.cu",
                     "replaces": f"paddle_tpu/kernels/rms_norm.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": libms})
    return recs


def _page_tables(torch, dev, lengths, ps, width, num_pages, seed):
    """int32 ``[len(lengths), width]`` block tables on the card: each
    sequence's own pages (a seeded permutation), then sentinel
    (``num_pages``) entries and garbage past them."""
    bt = torch.full((len(lengths), width), num_pages, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=torch.Generator()
                          .manual_seed(seed))
    nxt = 0
    for b, n in enumerate(lengths):
        used = -(-n // ps)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
        if used < width - 1:
            bt[b, -1] = -7 if b % 2 else 10 * num_pages
    return bt.to(dev)


def decode_wave_lengths(requests):
    """Decode lengths of the main path's two waves of 8 requests (prompts
    257..512, then 513..1024), each half-way through its generation."""
    lens = [int(r.prompt.shape[0]) + r.max_new_tokens // 2 for r in requests]
    return lens[:8], lens[8:16]


def _split_cases(torch, PA, B, KVH, ps, width, main_lengths, wave2):
    """The decode kernel's cases beyond its edge lengths, each ``(name,
    lengths)``: the first wave; lengths at the edges of the split plan's
    chunk (``decode_split_plan``) up to the full table; one sequence over
    the full table (where the split matters most); 32 sequences; the
    second wave."""
    full = width * ps

    def chunk(b):
        return PA.decode_split_plan(b, KVH, ps, width)[0] * ps

    c8, c32 = chunk(B), chunk(32)
    rng = torch.Generator().manual_seed(17)
    b32 = [0, 1, full, c32 - 1, c32, c32 + 1] + torch.randint(
        1, full + 1, (26,), generator=rng).tolist()
    return (("main", list(main_lengths)),
            ("split_edges", [c8 - 1, c8, c8 + 1, 2 * c8 - 1, 2 * c8 + 1, 0,
                             full - 1, full]),
            ("b1_full", [full]),
            ("b32", b32),
            ("second_wave", list(wave2)))


def _nan_past_lengths(torch, pages, bt, lengths, ps, value):
    """A copy of ``pages`` whose slots past each sequence's length in its
    last page hold ``value``."""
    out = pages.clone()
    for b, n in enumerate(lengths):
        if n % ps:
            out[int(bt[b, n // ps]), :, n % ps:] = value
    return out


L2_BYTES = 50e6      # the H100's L2 cache


def decode_timing(torch, dev, PA, lengths, ps, width, quant, seed,
                  check=True):
    """One decode call's device time at ``lengths`` (bf16 q, Llama-3-8B
    heads; bf16 pages of ``ps``, or int8 with scales): ``torch.profiler``'s
    device time of every ``paged_decode*`` kernel (split and combine) over
    a rotation of pools of the same shape whose live bytes are at least
    twice the L2, so each call finds its pages cold, as the main path's 32
    layer pools do. Beside it ``wrapper_ms`` (back-to-back wrapper calls
    on one pool, the timing of earlier rows: hot L2, and paced by the
    host once the kernel is short) and the plain version's time. Checks
    the kernel against the plain version on one pool (``check=False``
    reports the error without the check, for variants that drop part of
    the work)."""
    import math
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, NH, KVH, D = len(lengths), 32, 8, 128
    P = sum(-(-n // ps) for n in lengths) + 1
    elem = 1 if quant else 2
    live = 2 * KVH * sum(lengths) * D * elem
    npool = max(8, math.ceil(2 * L2_BYTES / live))
    pools = []
    for _ in range(npool):
        if quant:
            pools.append(tuple(
                torch.randint(-127, 128, (P, KVH, ps, D), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2)) + tuple(
                0.02 * torch.rand(P, KVH, generator=gen, device=dev)
                for _ in range(2)))
        else:
            pools.append(tuple(
                torch.randn(P, KVH, ps, D, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2)))
    bt = _page_tables(torch, dev, lengths, ps, width, P - 1, seed)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(B, NH, D, generator=gen, device=dev).to(torch.bfloat16)

    def call(i, fn=PA.ragged_paged_attention):
        kp, vp, *sc = pools[i]
        return fn(q, kp, vp, bt, ln, **(
            {"k_scales": sc[0], "v_scales": sc[1]} if quant else {}))

    err = _err(call(0), call(0, PA.paged_attention_ref))
    assert err <= PAGED_TOL or not check, \
        f"decode kernel disagrees at B{B}: {err}"
    for i in range(npool):
        call(i)
    torch.cuda.synchronize()
    reps = math.ceil(240 / npool)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for i in range(npool):
                call(i)
        torch.cuda.synchronize()
    split_us = combine_us = 0.0
    for evt in prof.key_averages():
        if "paged_decode" not in evt.key:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if "combine" in evt.key:
            combine_us += us
        else:
            split_us += us
    calls = reps * npool
    assert split_us > 0, "the profiler saw no decode kernel"
    ms = (split_us + combine_us) / calls / 1e3
    ctx = sum(lengths)
    pages = sum(-(-n // ps) for n in lengths)
    # bytes: the live context's keys and values (int8: codes, and the
    # scales of their pages), q and out in bf16, block tables and lengths
    nbytes = (2 * KVH * ctx * D * elem + (2 * 4 * KVH * pages if quant
                                         else 0)
              + 2 * 2 * q.numel() + 4 * (bt.numel() + B))
    flops = 4.0 * NH * ctx * D
    bound = max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
    return {"shape": f"B{B}xctx{ctx}xps{ps}", "ms": ms,
            "split_ms": split_us / calls / 1e3,
            "combine_ms": combine_us / calls / 1e3,
            "wrapper_ms": _time_ms(lambda: call(0), 50),
            "plain_ms": _time_ms(lambda: call(0, PA.paged_attention_ref),
                                 10),
            "bound_ms": bound, "bound_share": bound / ms,
            "gbps": nbytes / ms / 1e6, "pools": npool,
            "pool_mb": live / 1e6, "max_abs_err": err,
            "splits": PA.decode_split_plan(B, KVH, ps, width)[1]
            if hasattr(PA, "decode_split_plan") else 1}


def decode_timing_shapes(main_lengths, wave2, full):
    """The three timed shapes: the first wave, the second wave, and 32
    sequences over the full table of ``full`` positions (the bandwidth
    shape)."""
    return (("first_wave", list(main_lengths)),
            ("second_wave", list(wave2)),
            ("bandwidth", [full] * 32))


def paged_checks(torch, dev, PA, heads, main_lengths, wave2, maxp):
    """The decode kernel (bf16 pages of 16, ``heads`` = (query, kv) of
    128) against its plain version: edge lengths, the first wave, the
    split plan's chunk edges, B 1 over the full table, B 32, the second
    wave, NaN in every slot past a sequence's length and in the page its
    sentinel entries name (against the plain version on zeros there),
    two launches bit for bit. Returns the largest error."""
    gen = torch.Generator(device=dev).manual_seed(2)
    (NH, KVH), B, D, PS = heads, len(main_lengths), 128, 16
    num_pages = 32 * maxp + 8
    kp = torch.randn(num_pages, KVH, PS, D, generator=gen,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn(num_pages, KVH, PS, D, generator=gen,
                     device=dev).to(torch.bfloat16)

    worst = 0.0
    cases = (("edge", [0, 1, 15, 16, 17, 300, 777, maxp * PS]),) + \
        _split_cases(torch, PA, B, KVH, PS, maxp, main_lengths, wave2) + \
        (("nan_past_length", [1, 15, 17, 255, 257, 700, 1025,
                              maxp * PS - 1]),)
    for name, lengths in cases:
        q = torch.randn(len(lengths), NH, D, generator=gen,
                        device=dev).to(torch.bfloat16)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if name == "nan_past_length":
            # sentinel entries (num_pages - 1 after the clamp) name the
            # last page, which no sequence owns
            bt = _page_tables(torch, dev, lengths, PS, maxp, num_pages - 1,
                              3)
            kn = _nan_past_lengths(torch, kp, bt, lengths, PS, float("nan"))
            vn = _nan_past_lengths(torch, vp, bt, lengths, PS, float("nan"))
            kn[-1] = float("nan")
            vn[-1] = float("nan")
            out = PA.ragged_paged_attention(q, kn, vn, bt, ln)
            kz = _nan_past_lengths(torch, kp, bt, lengths, PS, 0.0)
            vz = _nan_past_lengths(torch, vp, bt, lengths, PS, 0.0)
            kz[-1] = 0.0
            vz[-1] = 0.0
            torch.cuda.synchronize()
            ref = PA.paged_attention_ref(q, kz, vz, bt, ln)
            del kn, vn, kz, vz
        else:
            bt = _page_tables(torch, dev, lengths, PS, maxp, num_pages, 3)
            out = PA.ragged_paged_attention(q, kp, vp, bt, ln)
            torch.cuda.synchronize()
            ref = PA.paged_attention_ref(q, kp, vp, bt, ln)
        err = _err(out, ref)
        zero_rows = [b for b, n in enumerate(lengths) if n == 0]
        same = True
        if name == "b32":
            again = PA.ragged_paged_attention(q, kp, vp, bt, ln)
            same = bool(torch.equal(out, again))
        _say("kernels", kernel="paged_decode", heads=f"{NH}/{KVH}",
             case=name, B=len(lengths),
             splits=PA.decode_split_plan(len(lengths), KVH, PS, maxp)[1],
             lengths=",".join(map(str, lengths)) if len(lengths) <= 8
             else f"{len(lengths)}_seqs", max_abs_err=err, tol=PAGED_TOL,
             bitwise_repeat=same)
        assert err <= PAGED_TOL, f"paged_decode disagrees ({name})"
        assert all(bool((out[b] == 0).all()) for b in zero_rows), \
            "paged_decode: a length-0 row is not zero"
        assert bool(torch.isfinite(out.float()).all())
        assert same, "paged_decode: two launches differ"
        worst = max(worst, err)
    del kp, vp
    return worst


def phase_paged(torch, dev, main_lengths, wave2, maxp):
    """The decode kernel (bf16 pages of 16) against its plain version
    (``paged_checks``) at Llama-3-8B's heads (32 / 8), then at
    DeepSeekMoE-16B's (16 / 16, no GQA: the kernel's one-head-a-group
    instance, and its own split plan), both at the main paths' decode
    lengths (``moe_main`` serves the same requests); then timed at
    three shapes (``decode_timing``)."""
    from paddle_tpu_torch.kernels import paged_attention as PA
    PS = 16
    worst = max(paged_checks(torch, dev, PA, heads, main_lengths, wave2,
                             maxp)
                for heads in ((32, 8), MOE_HEADS))
    torch.cuda.empty_cache()
    timed = {}
    for shape, lengths in decode_timing_shapes(main_lengths, wave2,
                                               maxp * PS):
        timed[shape] = t = decode_timing(torch, dev, PA, lengths, PS, maxp,
                                         False, 4)
        _say("kernels", kernel="paged_decode", timing=shape, **t)
        torch.cuda.empty_cache()
    first = timed["first_wave"]
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:60",
            "max_abs_err": worst, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def phase_paged_int8(torch, dev, main_lengths, wave2, maxp, ps):
    """The int8 arm of the decode kernel against its plain version at page
    sizes 16, 32 and 64 with q in float32 and bfloat16 (edge lengths,
    sentinel and garbage table entries, never-written pages of scale 0),
    against the full-precision kernel on the densely dequantized pages;
    then at the main int8 pages (``ps``, bf16 q) the cases of
    ``phase_paged`` (the NaN case: NaN scales on the page the sentinel
    entries name, -128 codes past each length); then timed at three
    shapes."""
    from paddle_tpu_torch.kernels import paged_attention as PA
    gen = torch.Generator(device=dev).manual_seed(11)
    B, NH, KVH, D = len(main_lengths), 32, 8, 128

    def pool(n_pages, page):
        codes = [torch.randint(-127, 128, (n_pages, KVH, page, D),
                               generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [0.02 * torch.rand(n_pages, KVH, generator=gen, device=dev)
                  for _ in range(2)]
        for t in scales:
            t[:2] = 0.0                  # never written: dequantize to 0
        return codes, scales

    worst = 0.0
    for page in (16, 32, 64):
        width = 8
        (kc, vc), (ks, vs) = pool(64, page)
        lengths = [0, 1, page - 1, page, page + 1, width * page]
        bt = _page_tables(torch, dev, lengths, page, width, 64, 12)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for dtype, tol in ((torch.float32, FLASH_F32_TOL),
                           (torch.bfloat16, PAGED_TOL)):
            q = torch.randn(len(lengths), NH, D, generator=gen,
                            device=dev).to(dtype)
            out = PA.ragged_paged_attention(q, kc, vc, bt, ln, k_scales=ks,
                                            v_scales=vs)
            torch.cuda.synchronize()
            ref = PA.paged_attention_ref(q, kc, vc, bt, ln, k_scales=ks,
                                         v_scales=vs)
            err = _err(out, ref)
            zero = bool((out[0] == 0).all())
            _say("kernels", kernel="paged_decode_int8", ps=page,
                 q=str(dtype).split(".")[-1],
                 lengths=",".join(map(str, lengths)), max_abs_err=err,
                 tol=tol, zero_row_exact=zero)
            assert err <= tol, "paged_decode_int8 disagrees"
            assert zero, "paged_decode_int8: a length-0 row is not zero"
            assert bool(torch.isfinite(out.float()).all())
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            else:
                # scale handling is exact: the full-precision kernel on
                # the densely dequantized float32 pages
                dense = PA.ragged_paged_attention(
                    q, (kc.float() * ks[:, :, None, None]).contiguous(),
                    (vc.float() * vs[:, :, None, None]).contiguous(), bt, ln)
                torch.cuda.synchronize()
                derr = _err(out, dense)
                _say("kernels", kernel="paged_decode_int8", ps=page,
                     vs_full_precision_kernel=derr, tol=FLASH_F32_TOL)
                assert derr <= FLASH_F32_TOL, \
                    "paged_decode_int8 differs from the dense kernel"

    # the main int8 pages: bf16 q, pages of ps, the phase_paged cases
    num_pages = 32 * maxp + 8
    (kc, vc), (ks, vs) = pool(num_pages, ps)
    cases = _split_cases(torch, PA, B, KVH, ps, maxp, main_lengths,
                         wave2) + (("nan_past_length",
                                    [1, 31, 33, 255, 257, 700, 1025,
                                     maxp * ps - 1]),)
    for name, lengths in cases:
        q = torch.randn(len(lengths), NH, D, generator=gen,
                        device=dev).to(torch.bfloat16)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if name == "nan_past_length":
            bt = _page_tables(torch, dev, lengths, ps, maxp, num_pages - 1,
                              12)
            kn = _nan_past_lengths(torch, kc, bt, lengths, ps, -128)
            vn = _nan_past_lengths(torch, vc, bt, lengths, ps, -128)
            ksn, vsn = ks.clone(), vs.clone()
            ksn[-1] = float("nan")
            vsn[-1] = float("nan")
            out = PA.ragged_paged_attention(q, kn, vn, bt, ln, k_scales=ksn,
                                            v_scales=vsn)
            kz = _nan_past_lengths(torch, kc, bt, lengths, ps, 0)
            vz = _nan_past_lengths(torch, vc, bt, lengths, ps, 0)
            ksz, vsz = ks.clone(), vs.clone()
            ksz[-1] = 0.0
            vsz[-1] = 0.0
            torch.cuda.synchronize()
            ref = PA.paged_attention_ref(q, kz, vz, bt, ln, k_scales=ksz,
                                         v_scales=vsz)
            del kn, vn, kz, vz
        else:
            bt = _page_tables(torch, dev, lengths, ps, maxp, num_pages, 12)
            out = PA.ragged_paged_attention(q, kc, vc, bt, ln, k_scales=ks,
                                            v_scales=vs)
            torch.cuda.synchronize()
            ref = PA.paged_attention_ref(q, kc, vc, bt, ln, k_scales=ks,
                                         v_scales=vs)
        err = _err(out, ref)
        same = True
        if name == "b32":
            again = PA.ragged_paged_attention(q, kc, vc, bt, ln,
                                              k_scales=ks, v_scales=vs)
            same = bool(torch.equal(out, again))
        _say("kernels", kernel="paged_decode_int8", case=name, ps=ps,
             B=len(lengths),
             splits=PA.decode_split_plan(len(lengths), KVH, ps, maxp)[1],
             lengths=",".join(map(str, lengths)) if len(lengths) <= 8
             else f"{len(lengths)}_seqs", max_abs_err=err, tol=PAGED_TOL,
             bitwise_repeat=same)
        assert err <= PAGED_TOL, f"paged_decode_int8 disagrees ({name})"
        assert all(bool((out[b] == 0).all())
                   for b, n in enumerate(lengths) if n == 0)
        assert bool(torch.isfinite(out.float()).all())
        assert same, "paged_decode_int8: two launches differ"
        worst = max(worst, err)
    del kc, vc
    torch.cuda.empty_cache()
    timed = {}
    for shape, lengths in decode_timing_shapes(main_lengths, wave2,
                                               maxp * ps):
        timed[shape] = t = decode_timing(torch, dev, PA, lengths, ps, maxp,
                                         True, 13)
        _say("kernels", kernel="paged_decode_int8", timing=shape, **t)
        torch.cuda.empty_cache()
    first = timed["first_wave"]
    return {"name": "paged_decode_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:60",
            "max_abs_err": worst, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


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


def phase_quant_parity(torch, dev):
    """``phase_parity`` with int8 KV pages, alone and with int8 and int4
    weight-only trees (quantized once, on the CPU): the greedy tokens of
    the card and the CPU must be equal, and the card must decode through
    the int8 arm of the kernel with no plain version."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_tiny()
    base = L.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    trace = [(rng.integers(0, cfg.vocab_size, n), m)
             for n, m in zip((4, 7, 3, 5, 6, 9), (8, 5, 9, 6, 4, 7))]
    for weights in (None, "int8", "int4"):
        cpu_params = base if weights is None else L.quantize_weights(
            base, weights)
        card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
        outs = {}
        for name, params, device in (("card", card_params, dev),
                                     ("cpu", cpu_params, "cpu")):
            K.reset_dispatch_stats()
            eng = ServingEngine(L, params, cfg, num_slots=2, max_len=16,
                                page_size=4, num_pages=5, decode_chunk=2,
                                kv_quant=True, device=device)
            out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                           for i, (p, m) in enumerate(trace)])
            torch.cuda.synchronize()
            stats = K.dispatch_stats()
            outs[name] = [out[i].tokens.tolist() for i in range(len(trace))]
            _say("quant_parity", weights=weights or "bf16_tree",
                 engine=name, preempted=eng.stats.preempted, **stats)
            if name == "card":
                assert stats["paged_quant"] > 0 and stats["flash"] > 0
                assert stats["paged"] == 0
                assert all(v == 0 for k, v in stats.items()
                           if k.endswith("_ref")), stats
            assert eng.stats.preempted >= 1
        same = outs["card"] == outs["cpu"]
        _say("quant_parity", weights=weights or "bf16_tree",
             tokens_equal=same, tokens=sum(len(t) for t in outs["card"]))
        assert same, f"card {outs['card']} != cpu {outs['cpu']}"


def phase_main(torch, dev, cfg, params, requests, card, phase="main",
               kv_quant=False, reference=None, family=None, uniform=False):
    """Serve ``requests`` through ``ServingEngine`` at the config's widths
    (``kv_quant``: int8 KV pages) with the model ``family`` (default
    llama). Returns ``(launches, tokens)``. With ``reference`` (the tokens
    of the bf16 run) it also reports, as a reading only, how many
    requests give the same greedy tokens and where each first differs.
    With ``uniform`` it also serves the same requests as the JAX serving
    rung's uniform-batch baseline (``uniform_batch_baseline``) and reports
    both rates over the requested tokens and ``speedup_vs_uniform``."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import llama as L
    family = L if family is None else family
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in L._leaves(params))
    eng = ServingEngine(family, params, cfg, num_slots=8, max_len=2048,
                        kv_quant=kv_quant)
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    t0 = time.perf_counter()
    out = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.dispatch_stats()
    st = eng.stats
    ttft = sorted(o.ttft_s for o in out.values())
    _say(phase, card=repr(card), requests=len(out),
         wall_s=round(wall, 3),
         prefill_tokens=st.tokens_prefilled, prefill_s=st.prefill_s,
         prefill_tok_per_s=st.tokens_prefilled / st.prefill_s,
         decode_tokens=st.tokens_decoded, decode_steps=st.decode_steps,
         decode_s=st.decode_s,
         decode_tok_per_s=st.tokens_decoded / st.decode_s,
         ttft_median_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
         preempted=st.preempted,
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2))
    # pool bytes per KV token over all layers, against bf16 pages of the
    # same geometry (k and v: 2 bytes a value)
    pool_bytes = eng.cache.pool_bytes()
    per_token = pool_bytes / (eng.cache.num_pages * eng.page_size)
    bf16_per_token = (2 * cfg.num_hidden_layers * cfg.num_key_value_heads
                      * cfg.head_dim * 2)
    _say(phase, kv_quant=kv_quant, page_size=eng.page_size,
         pool_gb=pool_bytes / 1e9, pool_bytes_per_kv_token=per_token,
         bf16_pool_bytes_per_kv_token=bf16_per_token,
         servable_concurrency_at_fixed_pool_bytes=bf16_per_token / per_token,
         weights_gb=weight_bytes / 1e9)
    arm = "paged_quant" if kv_quant else "paged"
    _say(phase, flash_launches=launches["flash"],
         flash_tc_launches=launches["flash_tc"],
         **{f"{arm}_launches": launches[arm],
            f"{arm}_per_decode_step": launches[arm] / st.decode_steps},
         other_arm=launches["paged" if kv_quant else "paged_quant"],
         **{k: v for k, v in launches.items() if k.endswith("_ref")})
    assert launches["flash"] > 0 and launches[arm] > 0, launches
    assert launches["paged" if kv_quant else "paged_quant"] == 0, launches
    _tc_route_only(launches)
    assert all(v == 0 for k, v in launches.items() if k.endswith("_ref")), \
        launches
    tokens = {}
    for r in requests:
        toks = out[r.rid].tokens
        assert len(toks) == r.max_new_tokens, (r.rid, len(toks))
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all(), r.rid
        tokens[r.rid] = toks.tolist()
    if uniform:
        useful = sum(r.max_new_tokens for r in requests)
        uniform_s, uniform_launches = uniform_batch_baseline(
            torch, family, cfg, params, requests, eng.num_slots, dev)
        _say(phase, requested_tokens=useful,
             serving_tokens_per_sec=useful / wall,
             uniform_batch_s=uniform_s,
             uniform_batch_tokens_per_sec=useful / uniform_s,
             speedup_vs_uniform=uniform_s / wall,
             uniform_flash=uniform_launches["flash"],
             uniform_flash_tc=uniform_launches["flash_tc"])
        _tc_route_only(uniform_launches)
        assert uniform_launches["flash"] > 0, uniform_launches
    if reference is not None:
        first = [next((i for i, (a, b) in enumerate(zip(tokens[r], ref))
                       if a != b), None) for r, ref in reference.items()]
        _say(phase, tokens_equal_to_main=sum(f is None for f in first),
             of=len(first), first_divergence=",".join(
                 "-" if f is None else str(f) for f in first))
    return launches, tokens


def phase_generate_parity(torch, dev):
    """Ring-cache generation of one float32 llama_tiny model on the card
    (flash kernel in the prefill) and on the CPU: greedy tokens (with and
    without EOS) and beam tokens must be equal, beam scores within
    ``BEAM_SCORE_TOL``."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_tiny()
    cpu_params = L.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 7))
    eos = int(L.generate(cpu_params, ids, cfg, max_new_tokens=8)[0, 2])
    outs = {}
    for name, params in (("cpu", cpu_params), ("card", card_params)):
        K.reset_dispatch_stats()
        greedy = L.generate(params, ids, cfg, max_new_tokens=8)
        stopped = L.generate(params, ids, cfg, max_new_tokens=8,
                             eos_token_id=eos, pad_token_id=-1)
        beams, scores = L.beam_search(params, ids, cfg, max_new_tokens=6,
                                      num_beams=3, eos_token_id=eos)
        if name == "card":
            torch.cuda.synchronize()
        stats = K.dispatch_stats()
        outs[name] = [t.cpu() for t in (greedy, stopped, beams, scores)]
        _say("generate_parity", device=name, **stats)
        if name == "card":
            # 3 prefills of 2 layers; decode attends over the ring cache
            # in plain PyTorch, as the reference's einsum
            assert stats["flash"] == 3 * cfg.num_hidden_layers, stats
            assert all(v == 0 for k, v in stats.items()
                       if k.endswith("_ref")), stats
    card, cpu = outs["card"], outs["cpu"]
    same = all(torch.equal(a, b) for a, b in zip(card[:3], cpu[:3]))
    score_err = _err(card[3], cpu[3])
    _say("generate_parity", tokens_equal=same, eos=eos,
         stopped_pads=int((cpu[1] == -1).sum()), beam_score_err=score_err,
         beam_score_tol=BEAM_SCORE_TOL)
    assert same, (card, cpu)
    assert (cpu[1] == -1).any(), cpu[1]
    assert score_err <= BEAM_SCORE_TOL, score_err


def _decode_one_batch(torch, L, cfg, params, batch, dev, phase, card):
    """The JAX package's ``_decode_one_batch`` on the port: ``batch``
    prompts of ``DECODE_PROMPT`` tokens prefilled into a fresh ring cache
    (timed), then ``DECODE_NEW`` greedy decode steps (timed), after one
    untimed pass of both; then ``generate`` end to end. Every prefill
    must take the flash kernel on its tensor-core route."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, DECODE_PROMPT)), device=dev)

    def prefill():
        cache = L.init_cache(cfg, batch, DECODE_PROMPT + DECODE_NEW,
                             device=dev)
        return L.prefill(params, ids, cfg, cache)

    def decode(cache, logits):
        toks = []
        for _ in range(DECODE_NEW):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            cache, logits = L.decode_step(params, cache, tok, cfg)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    decode(*prefill())
    torch.cuda.synchronize()
    K.reset_dispatch_stats()
    t0 = time.perf_counter()
    cache, logits = prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = decode(cache, logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = L.generate(params, ids, cfg, max_new_tokens=DECODE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = K.dispatch_stats()
    _say(phase, card=repr(card), batch=batch, prompt=DECODE_PROMPT,
         new_tokens=DECODE_NEW,
         decode_tokens_per_sec=batch * DECODE_NEW / decode_s,
         ms_per_token=decode_s / DECODE_NEW * 1e3,
         prefill_ms=prefill_s * 1e3,
         prefill_tokens_per_sec=batch * DECODE_PROMPT / prefill_s,
         generate_s=gen_s, generate_tokens_per_sec=batch * DECODE_NEW / gen_s,
         generate_equals_loop=bool(torch.equal(gen, toks)),
         flash=launches["flash"], flash_tc=launches["flash_tc"])
    for t in (toks, gen):
        assert ((t >= 0) & (t < cfg.vocab_size)).all()
    assert launches["flash"] == 2 * cfg.num_hidden_layers, launches
    _tc_route_only(launches)
    assert all(v == 0 for k, v in launches.items() if k.endswith("_ref"))
    return ids


def phase_generate(torch, dev, card):
    """The JAX package's decode rung (``bench.py`` ``_decode_rung``) on the
    ring cache: Llama-3-8B widths, 4 layers, vocab 32000, random bf16
    weights from seed 0, prompt 128 and 64 new greedy tokens at batch 8,
    16 and 32; then int8 and int4 weight-only trees at batch 8, and
    ``beam_search`` with 4 beams at batch 8."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_3_8b(num_hidden_layers=4, vocab_size=32000, remat=False)
    params = L.init_params(cfg, seed=0, device=dev)
    for batch in DECODE_BATCHES:
        ids = _decode_one_batch(torch, L, cfg, params, batch, dev,
                                "generate", card)
    ids = ids[:DECODE_BATCHES[0]]
    for width in ("int8", "int4"):
        qparams = L.quantize_weights(params, width)
        _say("generate", weights=width)
        _decode_one_batch(torch, L, cfg, qparams, DECODE_BATCHES[0], dev,
                          "generate", card)
        del qparams
    L.beam_search(params, ids, cfg, max_new_tokens=2, num_beams=4)
    torch.cuda.synchronize()
    K.reset_dispatch_stats()
    t0 = time.perf_counter()
    toks, scores = L.beam_search(params, ids, cfg,
                                 max_new_tokens=DECODE_NEW, num_beams=4)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    launches = K.dispatch_stats()
    _say("generate", card=repr(card), beams=4, batch=ids.shape[0],
         new_tokens=DECODE_NEW, beam_s=beam_s,
         ms_per_token=beam_s / DECODE_NEW * 1e3,
         scores_finite=bool(torch.isfinite(scores).all()),
         flash=launches["flash"], flash_tc=launches["flash_tc"])
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert torch.isfinite(scores).all()
    assert launches["flash"] == cfg.num_hidden_layers, launches
    _tc_route_only(launches)


def uniform_batch_baseline(torch, family, cfg, params, requests, num_slots,
                           dev):
    """The JAX serving rung's uniform-batch baseline (``bench.py``
    ``_serving_paged_rung``): the same requests in waves of
    ``num_slots``, each wave padded to the largest prompt and generation,
    through ``generate`` on the ring cache, after one untimed wave.
    Returns ``(seconds, launches)`` of the timed waves."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    max_p = max(len(r.prompt) for r in requests)
    max_g = max(r.max_new_tokens for r in requests)
    ids = torch.as_tensor(np.random.default_rng(42).integers(
        0, cfg.vocab_size, (num_slots, max_p)), device=dev)
    waves = -(-len(requests) // num_slots)
    family.generate(params, ids, cfg, max_new_tokens=max_g)
    torch.cuda.synchronize()
    K.reset_dispatch_stats()
    t0 = time.perf_counter()
    for _ in range(waves):
        toks = family.generate(params, ids, cfg, max_new_tokens=max_g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    return seconds, K.dispatch_stats()


def phase_moe_parity(torch, dev):
    """One float32 moe_tiny model (capacity dispatch, the full-width
    paths' choice) with one set of weights on the card and on the CPU:
    ``ServingEngine`` through queueing and a forced preemption with
    full-precision pages, then with int8 pages; ``generate``; 3
    ``make_train_step`` steps. Tokens must be equal, losses and step-1
    gradients within ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_TOL``, and the card
    must take the flash pair and both decode arms, no plain version."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.models import moe as M
    cfg = M.moe_tiny(dispatch_mode="capacity")
    cpu_params = M.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
    rng = np.random.default_rng(5)
    trace = [(rng.integers(0, cfg.vocab_size, n), m)
             for n, m in zip((4, 7, 3, 5, 6, 9), (8, 5, 9, 6, 4, 7))]
    ids = rng.integers(0, cfg.vocab_size, (3, 6))
    batch = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    tokens, losses, grads = {}, {}, {}
    for name, params, device in (("card", card_params, dev),
                                 ("cpu", cpu_params, "cpu")):
        out = []
        for kv_quant in (False, True):
            K.reset_dispatch_stats()
            eng = ServingEngine(M, params, cfg, num_slots=2, max_len=16,
                                page_size=4, num_pages=5, decode_chunk=2,
                                kv_quant=kv_quant, device=device)
            served = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                              for i, (p, m) in enumerate(trace)])
            stats = K.dispatch_stats()
            _say("moe_parity", device=name, path="serve", kv_quant=kv_quant,
                 preempted=eng.stats.preempted, **stats)
            assert eng.stats.preempted >= 1
            if name == "card":
                arm = "paged_quant" if kv_quant else "paged"
                assert stats["flash"] > 0 and stats[arm] > 0, stats
            out += [served[i].tokens.tolist() for i in range(len(trace))]
        K.reset_dispatch_stats()
        out.append(M.generate(params, ids, cfg, max_new_tokens=6).tolist())
        grads[name] = L._leaves(M.loss_and_grads(params, batch, cfg)[1])
        state = M.adamw_init(params)
        step = M.make_train_step(cfg)
        losses[name] = [float(step(params, state, batch)[2])
                        for _ in range(3)]
        stats = K.dispatch_stats()
        _say("moe_parity", device=name, path="generate_train",
             losses=losses[name], **stats)
        if name == "card":
            assert stats["flash"] > 0 and stats["flash_bwd"] > 0, stats
            assert all(v == 0 for k, v in stats.items()
                       if k.endswith("_ref")), stats
        tokens[name] = out
    grad_err = max(_err(a.cpu(), b) / float(b.abs().max())
                   for a, b in zip(grads["card"], grads["cpu"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    same = tokens["card"] == tokens["cpu"]
    _say("moe_parity", tokens_equal=same, loss_rel_err=loss_err,
         loss_rtol=TRAIN_LOSS_RTOL, grad_rel_err=grad_err,
         grad_tol=TRAIN_GRAD_TOL)
    assert same, (tokens["card"], tokens["cpu"])
    assert loss_err <= TRAIN_LOSS_RTOL, losses
    assert grad_err <= TRAIN_GRAD_TOL, grad_err


def phase_moe_main(torch, dev, layers, card):
    """The MoE serving main path: DeepSeekMoE-16B widths at
    ``min(layers, 28)`` layers (all 28 by default), random bf16 weights
    from seed 0 (router float32), the llama main path's engine and
    request shapes over its vocab; both serving kernels must launch."""
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.models import moe as M
    cfg = M.deepseek_moe_16b()
    cfg.num_hidden_layers = min(layers, cfg.num_hidden_layers)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    _say("moe_main", layers=cfg.num_hidden_layers,
         params_b=round(M.count_params(cfg) / 1e9, 3),
         router_dtype=str(params["layers"]["router"].dtype),
         weight_dtype=str(params["layers"]["e_gate"].dtype),
         dispatch=cfg.dispatch_mode or "capacity",
         init_s=round(time.perf_counter() - t0, 2))
    assert params["layers"]["router"].dtype == torch.float32
    assert sum(t.numel() for t in L._leaves(params)) == M.count_params(cfg)
    launches, _ = phase_main(torch, dev, cfg, params,
                             _main_requests(cfg.vocab_size), card,
                             phase="moe_main", family=M)
    return launches


def moe_train_setup(torch, dev):
    """The MoE training main path's ``(cfg, params, opt_state, step,
    batch)``: the JAX package's MoE rung (``bench.py`` ``_moe_rung``),
    DeepSeekMoE-16B widths at ``MOE_TRAIN_LAYERS`` layers, capacity
    dispatch, materialising cross entropy, remat ``"dots"``, random bf16
    weights from seed 0 (router float32), bf16 AdamW moments, lr 1e-4,
    ids ``[MOE_TRAIN_BATCH, MOE_TRAIN_SEQ + 1]`` from
    ``numpy.random.default_rng(1)``, all on ``dev``."""
    import numpy as np
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.models import moe as M
    cfg = M.deepseek_moe_16b(num_hidden_layers=MOE_TRAIN_LAYERS,
                             dispatch_mode="capacity", fused_ce=False,
                             remat_policy="dots")
    params = M.init_params(cfg, seed=0, device=dev)
    state = L.adamw_init(params, moment_dtype=torch.bfloat16)
    step = M.make_train_step(cfg, lr=1e-4)
    batch = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ + 1)), device=dev)
    return cfg, params, state, step, batch


def phase_moe_train(torch, dev, card):
    """The MoE training main path (``moe_train_setup``): 2 untimed and 5
    timed steps on one batch; MFU against the active parameters (shared,
    top-k routed, dense), as the JAX package's MoE rung defines it."""
    import math

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import moe as M
    t0 = time.perf_counter()
    cfg, params, state, step, batch = moe_train_setup(torch, dev)
    torch.cuda.synchronize()
    total = M.count_params(cfg)
    routed = (cfg.num_hidden_layers * cfg.num_experts * 3
              * cfg.hidden_size * cfg.intermediate_size)
    active = total - routed + routed * cfg.num_experts_per_tok \
        // cfg.num_experts
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    _say("moe_train", layers=MOE_TRAIN_LAYERS, params_total=total,
         params_active=active, dispatch=cfg.dispatch_mode,
         capacity=M.moe_capacity(cfg, tokens), remat=cfg.remat_policy,
         fused_ce=cfg.fused_ce, batch=f"{MOE_TRAIN_BATCH}x{MOE_TRAIN_SEQ}",
         init_s=round(time.perf_counter() - t0, 2))
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    losses, times = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        _, _, loss = step(params, state, batch)
        losses.append(float(loss))        # waits for the step's end
        times.append(time.perf_counter() - t0)
    launches = K.dispatch_stats()
    timed = sorted(times[2:])
    step_s = timed[len(timed) // 2]
    _say("moe_train", card=repr(card), losses=losses,
         step_ms=[t * 1e3 for t in times[2:]], median_step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s,
         mfu_active=6.0 * active * tokens / step_s / H100_BF16_FLOPS,
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2))
    _say("moe_train", steps=len(times), **launches)
    ln_v = math.log(cfg.vocab_size)
    assert all(math.isfinite(x) for x in losses), losses
    assert ln_v - 1 <= losses[0] <= ln_v + 2, (losses[0], ln_v)
    assert losses[-1] < losses[0], losses
    assert launches["flash_bwd"] == MOE_TRAIN_LAYERS * len(times), launches
    # remat recomputes each layer's forward: two forward launches a layer
    assert launches["flash"] == 2 * MOE_TRAIN_LAYERS * len(times), launches
    _tc_route_only(launches)
    assert all(v == 0 for k, v in launches.items() if k.endswith("_ref"))
    return launches


# guarded train step (A2): a cap every finite step exceeds, and the
# tolerance of sqrt(sum of the numerics block's gnorm_sq) against
# grad_norm (float32 sums in another order)
GUARD_CAP = 1e-9
GUARD_NORM_RTOL = 1e-5
GUARD_TIMED = 3         # timed steps of each kind, in turns
# the paged data plane's prefix pieces (A6) at the serving model: prompts
# of PREFIX_LEN sharing their first PREFIX_SHARED tokens, and a verify
# window of VERIFY_C drafted tokens at VERIFY_B sequences. In float32 at
# full depth both are held to what they replace within PREFIX_F32_TOL of
# the largest logit (summation order). In bf16 two rounding orders drift
# apart with depth through the residual stream: between the flash and the
# plain full prefill 1.1% / 2.7% / 5.5% of the largest logit at 2 / 8 /
# 32 layers, int8 pages 9.6-11% (H100, this phase at each depth); so in
# bf16 each function is held bit for bit to the same math (the shared
# prefill to the full prefill on plain attention; on int8 pages, to the
# shared prefill over the dequantized prefix), and its difference from
# the kernel path is a reading under PREFIX_DRIFT_GUARD, a guard against
# gross faults only
PREFIX_ROWS, PREFIX_LEN, PREFIX_SHARED = 4, 1024, 768
VERIFY_B, VERIFY_C = 8, 4
PREFIX_F32_TOL = 1e-4
PREFIX_DRIFT_GUARD = 0.15


def _tree_copy(tree):
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    return tree.clone() if hasattr(tree, "clone") else tree


def _tree_same(torch, a, b):
    """Byte equality of two trees of tensors (and host scalars)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_same(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return a == b


def count_syncs(torch, fn):
    """``(fn(), sites)``: ``fn`` runs under ``set_sync_debug_mode("warn")``;
    ``sites`` lists ``file:line`` of each synchronizing CUDA call it made
    (one warning each)."""
    import os
    import warnings
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                 if str(w.message).startswith(
                     "called a synchronizing CUDA operation")]


def guard_checks(torch, family, cfg, params, state, batch, timed=0, **kw):
    """The guarded step's contract on one model (``params`` / ``state``
    are stepped in place; a copy takes the guarded steps):

    - a clean batch: the guarded step gives the unguarded step's loss,
      parameters, moments and ``step`` bit for bit;
    - ``iinfo(int32).min`` at ``[0, 0]``, ``vocab_size`` at ``[0, 3]``
      and a cap of ``GUARD_CAP``: ``finite`` false, nothing written (the
      copy stays byte-equal to the unguarded side);
    - a second clean pair, each step's host syncs counted (the first
      pair has settled the caching allocator, whose own frees would
      count), again bit for bit;
    - then a clean guarded step with numerics applies, bit for bit with
      the unguarded step, and the squared norms of its numerics block
      tile ``grad_norm``;
    - with ``timed``, that many unguarded, guarded and numerics steps in
      turns: their median ms."""
    import math

    import numpy as np
    from paddle_tpu_torch.training.guards import NUMERIC_STATS
    unguarded = family.make_train_step(cfg, guard=False, **kw)
    guarded = family.make_train_step(cfg, guard=True, numerics=False, **kw)
    numerics = family.make_train_step(cfg, guard=True, numerics=True, **kw)
    gp, gs = _tree_copy(params), _tree_copy(state)

    def same():
        return _tree_same(torch, params, gp) and _tree_same(torch, state, gs)

    _, _, lu = unguarded(params, state, batch)
    _, _, lg, h = guarded(gp, gs, batch, math.inf)
    r = {"clean_finite": bool(h["finite"]),
         "clean_bitwise": torch.equal(lu, lg) and same(),
         "loss": float(lu), "grad_norm": float(h["grad_norm"])}
    for name, (row, col, val) in (("int32_min", (0, 0, np.iinfo(np.int32)
                                                 .min)),
                                  ("vocab_size", (0, 3, cfg.vocab_size))):
        bad = batch.clone()
        bad[row, col] = val
        _, _, _, hb = guarded(gp, gs, bad, math.inf)
        r[f"{name}_finite"] = bool(hb["finite"])
        r[f"{name}_unchanged"] = same()
    _, _, lc, hc = guarded(gp, gs, batch, GUARD_CAP)
    r["cap_finite"] = bool(hc["finite"])
    r["cap_loss_finite"] = math.isfinite(float(lc))
    r["cap_unchanged"] = same()
    (_, _, lu), sites_u = count_syncs(
        torch, lambda: unguarded(params, state, batch))
    (_, _, lg, h), sites_g = count_syncs(
        torch, lambda: guarded(gp, gs, batch, math.inf))
    r["syncs_unguarded"], r["syncs_guarded"] = len(sites_u), len(sites_g)
    r["sync_sites_unguarded"] = ",".join(sites_u) or "none"
    r["sync_sites_guarded"] = ",".join(sites_g) or "none"
    r["second_clean_bitwise"] = (bool(h["finite"]) and torch.equal(lu, lg)
                                 and same())
    _, _, lu = unguarded(params, state, batch)
    _, _, ln, hn = numerics(gp, gs, batch, math.inf)
    r["next_clean_finite"] = bool(hn["finite"])
    r["next_clean_bitwise"] = torch.equal(lu, ln) and same()
    nm = hn["numerics"]
    r["numerics_keys"] = all(tuple(s) == NUMERIC_STATS
                             for grp in nm.values() for s in grp.values())
    tiled = math.sqrt(sum(float(s["gnorm_sq"].double().sum())
                          for grp in nm.values() for s in grp.values()))
    r["norm_tiling_rel_err"] = abs(tiled - float(hn["grad_norm"])) / float(
        hn["grad_norm"])
    if timed:
        times = {"unguarded": [], "guarded": [], "numerics": []}
        for _ in range(timed):
            for kind, run in (
                    ("unguarded", lambda: unguarded(params, state, batch)),
                    ("guarded", lambda: guarded(gp, gs, batch, math.inf)),
                    ("numerics", lambda: numerics(gp, gs, batch,
                                                  math.inf))):
                t0 = time.perf_counter()
                float(run()[2])               # waits for the step's end
                times[kind].append((time.perf_counter() - t0) * 1e3)
        for kind, ts in times.items():
            r[f"{kind}_ms"] = sorted(ts)[len(ts) // 2]
        r["guarded_over_unguarded"] = r["guarded_ms"] / r["unguarded_ms"]
    return r


def _guard_asserts(r):
    assert r["clean_finite"] and r["clean_bitwise"], r
    assert r["second_clean_bitwise"], r
    assert r["syncs_guarded"] == r["syncs_unguarded"] + 1, r
    for name in ("int32_min", "vocab_size", "cap"):
        assert not r[f"{name}_finite"] and r[f"{name}_unchanged"], (name, r)
    assert r["cap_loss_finite"], r
    assert r["next_clean_finite"] and r["next_clean_bitwise"], r
    assert r["numerics_keys"], r
    assert r["norm_tiling_rel_err"] <= GUARD_NORM_RTOL, r


def phase_guard(torch, dev, card):
    """The guarded train step (``guard_checks``) at the dense training
    main path's configuration and at the MoE rung's."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.models import moe as M
    for name, setup, family, kw in (("dense", train_setup, L, {}),
                                    ("moe", moe_train_setup, M,
                                     {"lr": 1e-4})):
        cfg, params, state, _, batch = setup(torch, dev)
        K.reset_dispatch_stats()
        r = guard_checks(torch, family, cfg, params, state, batch,
                         timed=GUARD_TIMED, **kw)
        st = K.dispatch_stats()
        _say("guard", model=name, card=repr(card), **r, flash=st["flash"],
             flash_bwd=st["flash_bwd"])
        _guard_asserts(r)
        _tc_route_only(st)
        assert all(v == 0 for k, v in st.items() if k.endswith("_ref")), st
        del params, state
        torch.cuda.empty_cache()


def remat_attn_checks(torch, cfg, params, batch):
    """``loss_and_grads`` under remat ``"full"`` and ``"attn"`` on the same
    weights and batch: ``(bit-identical, {policy: launches and
    grads_peak_gb})``, the launches of one call each and the peak memory
    it adds above what was allocated before it (the saved activations,
    the gradients and the temporaries of the backward)."""
    import dataclasses

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    out = {}
    for policy in ("full", "attn"):
        c = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        K.reset_dispatch_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, grads = L.loss_and_grads(params, batch, c)
        torch.cuda.synchronize()
        st = K.dispatch_stats()
        st["grads_peak_gb"] = round(
            (torch.cuda.max_memory_allocated() - base) / 1e9, 4)
        out[policy] = (loss, grads, st)
    same = torch.equal(out["full"][0], out["attn"][0]) and _tree_same(
        torch, out["full"][1], out["attn"][1])
    return same, {p: o[2] for p, o in out.items()}


def phase_remat_attn(torch, dev, card):
    """Remat ``"attn"`` against ``"full"``: the dense training main path's
    loss and gradients bit for bit, 4 flash forward launches against 8
    and 4 backward launches in both; the packed rung's batch the same
    through the segment kernels; then each policy's step ms and peak
    memory on the dense path."""
    import dataclasses

    from paddle_tpu_torch.models import llama as L
    layers = TRAIN_LAYERS
    for name, setup, fwd, bwd in (
            ("dense", train_setup, "flash", "flash_bwd"),
            ("packed", packed_train_setup, "varlen", "varlen_bwd")):
        cfg, params, state, _, batch, *_ = setup(torch, dev)
        same, launches = remat_attn_checks(torch, cfg, params, batch)
        _say("remat_attn", batch=name, bitwise=same,
             **{f"{p}_{k}": v[k] for p, v in launches.items()
                for k in (fwd, bwd, f"{fwd}_tc", f"{bwd}_tc",
                          "grads_peak_gb")})
        assert same
        for p, want in (("full", 2 * layers), ("attn", layers)):
            st = launches[p]
            assert st[fwd] == st[f"{fwd}_tc"] == want, (p, st)
            assert st[bwd] == st[f"{bwd}_tc"] == layers, (p, st)
            assert all(v == 0 for k, v in st.items() if k.endswith("_ref"))
        if name == "dense":
            for policy in ("full", "attn"):
                c = dataclasses.replace(cfg, remat=True, remat_policy=policy)
                step = L.make_train_step(c)
                torch.cuda.reset_peak_memory_stats(dev)
                times = []
                for _ in range(4):
                    t0 = time.perf_counter()
                    float(step(params, state, batch)[2])
                    times.append((time.perf_counter() - t0) * 1e3)
                timed = sorted(times[1:])
                _say("remat_attn", batch=name, policy=policy,
                     card=repr(card), step_ms=times[1:],
                     median_step_ms=timed[len(timed) // 2],
                     peak_mem_gb=round(
                         torch.cuda.max_memory_allocated(dev) / 1e9, 3))
        del params, state
        torch.cuda.empty_cache()


def _strict(torch, fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: a host read of the
    device raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _wall_ms(torch, fn):
    """``(fn(), wall ms)`` from a drained card to the end of ``fn``'s
    work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rel(a, b):
    """Max abs difference over the reference's max abs value."""
    return _err(a, b) / max(float(b.float().abs().max()), 1e-30)


def _layer_pages(torch, PG, leaf, rows, dtype):
    """Every layer's pages ``rows`` of a pool leaf in ``dtype`` (an int8
    leaf dequantized as the data plane does)."""
    L = (leaf["q"] if isinstance(leaf, dict) else leaf).shape[0]
    return torch.stack([PG._kv_pool_gather(PG._layer_leaf(leaf, i), rows,
                                           dtype) for i in range(L)])


def prefix_plane_checks(torch, family, cfg, params, dev, kv_quant, *,
                        rows=PREFIX_ROWS, plen=PREFIX_LEN,
                        shared=PREFIX_SHARED, verify_lens=None,
                        window=VERIFY_C, ps=16):
    """``paged_prefill_shared`` and ``paged_verify_window`` on the card,
    each run under ``set_sync_debug_mode("error")`` (a host sync raises):

    - ``rows`` prompts of ``plen`` tokens sharing their first ``shared``:
      a prefill of the prefix on plain attention (``sdp_kernel(
      enable_flash=False)``), then a shared prefill of the tails over its
      pages, against one ``paged_prefill`` of the whole prompts (the flash
      kernel): ``shared_vs_full`` (logits), ``shared_pages_vs_full``
      (tail pages). Same math: on full-precision pages the shared prefill
      must equal the full prefill on plain attention bit for bit, logits
      and tail pages; on int8
      pages, the shared prefill over a full-precision pool that holds the
      int8 prefix dequantized, bit for bit (logits), and its tail pages
      must lie within half a code step of that pool's;
    - sequences of ``verify_lens`` tokens (one prefill group): a window of
      ``window`` tokens against that many greedy ``paged_decode_step``s on
      a copy of the pool: ``verify_vs_decode`` (logits) and the argmax
      agreement.

    Returns the readings, the same-math verdicts and wall ms (the second
    of two runs of each)."""
    import numpy as np
    from paddle_tpu_torch.inference import paged as PG
    from paddle_tpu_torch.nn import functional as PF
    V = cfg.vocab_size
    rng = np.random.default_rng(11)
    npages, ncp = plen // ps, shared // ps
    prefix = rng.integers(0, V, shared)
    ids = torch.as_tensor(np.concatenate(
        [np.tile(prefix, (rows, 1)), rng.integers(0, V, (rows, plen - shared))],
        axis=1), device=dev)
    full_rows = torch.arange(rows * npages, device=dev).reshape(rows, npages)
    tail_rows = full_rows[:, ncp:]
    ctx_rows = torch.arange(ncp, device=dev).expand(rows, ncp).contiguous()
    slen = torch.full((rows,), plen, device=dev)
    tail_slen = slen - shared
    head_slen = torch.full((1,), shared, device=dev)

    def pools(quant):
        return PG.init_pool(cfg, rows * npages, ps, device=dev,
                            kv_quant=quant)

    def shared_prefill(pool):
        return PG.paged_prefill_shared(
            family, params, ids[:, shared:], cfg, pool["k"], pool["v"],
            tail_rows, tail_slen, ctx_rows)

    pool, pool_sh = pools(kv_quant), pools(kv_quant)
    with PF.sdp_kernel(enable_flash=False):
        PG.paged_prefill(family, params, ids[:1, :shared], cfg,
                         pool_sh["k"], pool_sh["v"], ctx_rows[:1], head_slen)
    r = {}
    for _ in range(2):
        want, r["full_prefill_ms"] = _wall_ms(torch, lambda: PG.paged_prefill(
            family, params, ids, cfg, pool["k"], pool["v"], full_rows, slen))
        got, r["shared_prefill_ms"] = _wall_ms(
            torch, lambda: _strict(torch, lambda: shared_prefill(pool_sh)))
    r["shared_over_full"] = r["shared_prefill_ms"] / r["full_prefill_ms"]
    flat = tail_rows.reshape(-1)
    tails = {n: _layer_pages(torch, PG, pool_sh[n], flat, torch.float32)
             for n in ("k", "v")}
    r["shared_vs_full"] = _rel(got, want)
    r["shared_pages_vs_full"] = max(
        _rel(tails[n], _layer_pages(torch, PG, pool[n], flat,
                                    torch.float32)) for n in ("k", "v"))
    if not kv_quant:
        with PF.sdp_kernel(enable_flash=False):
            plain = PG.paged_prefill(family, params, ids, cfg, pool["k"],
                                     pool["v"], full_rows, slen)
        r["same_math"] = bool(torch.equal(got, plain)) and all(
            torch.equal(pool_sh[n][:, flat], pool[n][:, flat])
            for n in ("k", "v"))
    else:
        deq = pools(False)
        for n in ("k", "v"):
            deq[n][:, :ncp] = _layer_pages(torch, PG, pool_sh[n],
                                           ctx_rows[0], cfg.dtype)
        ref = shared_prefill(deq)
        code_step = {n: pool_sh[n]["s"][:, flat][..., None, None]
                     for n in ("k", "v")}
        r["same_math"] = bool(torch.equal(got, ref)) and all(
            bool(((tails[n] - deq[n][:, flat].float()).abs()
                  <= 0.501 * code_step[n]).all()) for n in ("k", "v"))
        del deq
    del pool, pool_sh
    lens = (np.linspace(257, plen, VERIFY_B).astype(np.int64)
            if verify_lens is None else np.asarray(verify_lens))
    B, S = len(lens), -(-int(lens.max()) // ps) * ps
    maxp = -(-(int(lens.max()) + window) // ps)
    bt = torch.arange(B * maxp, device=dev, dtype=torch.int32).reshape(
        B, maxp)
    kv_len = torch.as_tensor(lens, device=dev, dtype=torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    steps = [kv_len + i + 1 for i in range(window)]
    pool = PG.init_pool(cfg, B * maxp, ps, device=dev, kv_quant=kv_quant)
    logits = PG.paged_prefill(
        family, params, torch.as_tensor(rng.integers(0, V, (B, S)),
                                        device=dev), cfg, pool["k"],
        pool["v"], bt[:, :S // ps].long(), kv_len)
    first = logits.argmax(-1)
    base = _tree_copy(pool)
    del pool
    for _ in range(2):
        seq_pool, win_pool = _tree_copy(base), _tree_copy(base)

        def sequential():
            toks, outs = [first], []
            for n in steps:
                outs.append(PG.paged_decode_step(
                    family, params, seq_pool["k"], seq_pool["v"], bt, n,
                    toks[-1], cfg))
                toks.append(outs[-1].argmax(-1))
            return torch.stack(toks[:window], 1), torch.stack(outs, 1)

        (drafted, seq), r["decode_steps_ms"] = _wall_ms(torch, sequential)
        got, r["verify_window_ms"] = _wall_ms(torch, lambda: _strict(
            torch, lambda: PG.paged_verify_window(
                family, params, drafted, cfg, win_pool["k"], win_pool["v"],
                bt, kv_len, live)))
        del seq_pool, win_pool
    r["window_over_decode_step"] = r["verify_window_ms"] / (
        r["decode_steps_ms"] / window)
    r["verify_vs_decode"] = _rel(got, seq)
    agree = got.argmax(-1) == seq.argmax(-1)
    r["verify_argmax_agree"] = f"{int(agree.sum())}/{agree.numel()}"
    r["verify_argmax_all"] = bool(agree.all())
    r["sync_debug_mode"] = "error"
    return r


def _prefix_asserts(r, exact):
    """``exact``: float32, within ``PREFIX_F32_TOL`` and every argmax
    equal (the same-math pair is a reading there: cuBLAS may sum the
    prefix prefill's rows and the full prefill's, a different count, in
    other orders, and float32 keeps the last bits that bf16 rounds away);
    else bf16 weights: the same-math verdict, and the drift from the
    kernel paths under ``PREFIX_DRIFT_GUARD``."""
    if exact:
        assert r["shared_vs_full"] <= PREFIX_F32_TOL, r
        assert r["shared_pages_vs_full"] <= PREFIX_F32_TOL, r
        assert r["verify_vs_decode"] <= PREFIX_F32_TOL, r
        assert r["verify_argmax_all"], r
        return
    for key in ("shared_vs_full", "shared_pages_vs_full",
                "verify_vs_decode"):
        assert r[key] <= PREFIX_DRIFT_GUARD, (key, r)
    assert r["same_math"], r


def phase_prefix_plane(torch, dev, cfg, params, card):
    """The rest of the paged data plane (``prefix_plane_checks``) at the
    serving main path's model and weights: bf16 pages of 16, int8 pages
    of 16, then the same model in float32 on float32 pages."""
    import dataclasses

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    for dtype, kv_quant in ((cfg.dtype, False), (cfg.dtype, True),
                            (torch.float32, False)):
        c, p = cfg, params
        if dtype != cfg.dtype:
            c = dataclasses.replace(cfg, dtype=dtype)
            p = L._map(lambda t: t.to(dtype), params)
        K.reset_dispatch_stats()
        r = prefix_plane_checks(torch, L, c, p, dev, kv_quant)
        st = K.dispatch_stats()
        arm = "paged_quant" if kv_quant else "paged"
        _say("prefix_plane", dtype=str(dtype).removeprefix("torch."),
             kv_quant=kv_quant, layers=c.num_hidden_layers,
             card=repr(card), flash=st["flash"], **{arm: st[arm]}, **r)
        _prefix_asserts(r, exact=dtype == torch.float32)
        assert st[arm] > 0 and st["flash"] > 0, st
        assert all(v == 0 for k, v in st.items() if k.endswith("_ref")), st
        del p
        torch.cuda.empty_cache()


def phase_flash_bwd(torch, dev, batch, seq):
    """The backward kernels against their plain version on the same card
    tensors (out and lse from the forward kernel): Llama-3-8B's heads at
    edge shapes on both routes, then DeepSeekMoE-16B's (16 / 16) at edge
    shapes and ``moe_train``'s batch; then timed at the training path's
    shape."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(4)
    H, KVH, D = 32, 8, 128

    def inputs(b, sq, sk, dtype, causal, d=D, heads=(H, KVH)):
        h, kvh = heads
        q, k, v, dout = (torch.randn(b, s, n, d, generator=gen, device=dev)
                         .to(dtype) for s, n in ((sq, h), (sk, kvh),
                                                 (sk, kvh), (sq, h)))
        out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        return q, k, v, out, lse, dout

    def check(args, is_causal, tol, **what):
        K.reset_dispatch_stats()
        got = FA.flash_attention_bwd(*args, causal=is_causal)
        torch.cuda.synchronize()
        _tc_launches(K, "flash_bwd", FA.tensor_core_route(args[0]))
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
    for sq, sk, d, causal, dtype, tol in (
            (16, 16, D, True, bf16, BWD_TOL),
            (48, 48, D, True, bf16, BWD_TOL),
            (512, 512, D, True, bf16, BWD_TOL),
            (48, 48, D, False, bf16, BWD_TOL),
            (48, 48, D, True, f32, BWD_F32_TOL),
            (32, 80, D, True, bf16, BWD_TOL),
            (80, 48, D, True, bf16, BWD_TOL),
            (1000, 1000, D, True, bf16, BWD_TOL),
            (48, 48, 64, True, bf16, BWD_TOL),
            (80, 48, 64, True, bf16, BWD_TOL),
            (1000, 1000, 64, True, bf16, BWD_TOL),
            (200, 200, 64, False, bf16, BWD_TOL)):
        got, err = check(inputs(2, sq, sk, dtype, causal, d), causal, tol,
                         Sq=sq, Sk=sk, D=d, causal=causal,
                         dtype=str(dtype).split(".")[-1])
        if sq > sk:     # rows that see no key: exact zeros
            assert bool((got[0][:, :sq - sk] == 0).all()), \
                "flash_bwd: a row that sees no key has a nonzero dq"
            _say("kernels", kernel="flash_bwd", zero_rows=sq - sk,
                 dq_zero=True)
        if dtype == bf16:
            worst = max(worst, err)

    for b, sq, sk, causal in ((2, 48, 48, True), (2, 48, 48, False),
                              (2, 32, 80, True), (2, 80, 48, True),
                              (2, 1000, 1000, True),
                              (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                               MOE_TRAIN_SEQ, True)):
        got, err = check(inputs(b, sq, sk, bf16, causal, heads=MOE_HEADS),
                         causal, BWD_TOL, heads="16/16", B=b, Sq=sq, Sk=sk,
                         D=D, causal=causal, dtype="bfloat16")
        if sq > sk:
            assert bool((got[0][:, :sq - sk] == 0).all()), \
                "flash_bwd: a row that sees no key has a nonzero dq"
        worst = max(worst, err)
        del got
    torch.cuda.empty_cache()

    # the training path's shape: one layer's attention of the train phase;
    # its out / lse from the forward kernel are held to the plain forward,
    # and the forward is timed there too, beside SDPA
    args = inputs(batch, seq, seq, bf16, True)
    ref, ref_lse = FA.flash_attention_ref(*args[:3], causal=True)
    err, lerr = _err(args[3], ref), _err(args[4], ref_lse)
    assert err <= FLASH_TOL and lerr <= LSE_TOL, \
        "flash_fwd disagrees at the training path's shape"
    del ref, ref_lse
    q, k, v = args[:3]
    fwd_ms = _time_ms(lambda: FA.flash_attention_fwd(q, k, v, causal=True),
                      20)
    fwd_plain_ms = _time_ms(
        lambda: FA.flash_attention_ref(q, k, v, causal=True), 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_lib_ms = _time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    fwd_flops = 2.0 * batch * H * seq * seq * D        # causal
    fwd_bytes = 4 * q.numel() + 4 * k.numel() + 4 * batch * H * seq
    fwd_bound = max(fwd_flops / H100_BF16_FLOPS,
                    fwd_bytes / H100_BYTES_PER_S) * 1e3
    _say("kernels", kernel="flash_fwd", shape=f"B{batch}xS{seq}",
         max_abs_err=err, lse_err=lerr, tol=FLASH_TOL, ms=fwd_ms,
         plain_ms=fwd_plain_ms, library_ms=fwd_lib_ms, bound_ms=fwd_bound,
         bound_by="operations" if fwd_flops / H100_BF16_FLOPS
         >= fwd_bytes / H100_BYTES_PER_S else "bytes",
         share_of_bound=fwd_bound / fwd_ms, tflops=fwd_flops / fwd_ms / 1e9)
    del qt, kt, vt
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
         share_of_bound=bound / ms, tflops=flops / ms / 1e9)
    return {"name": "flash_bwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "paddle_tpu/kernels/flash_attention.py:146",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def phase_layer_grads(torch, dev, packed=False):
    """One bf16 layer at Llama-3-8B widths, one forward and backward on
    ``[2, TRAIN_SEQ]``, with its attention through the kernels and then
    through the plain version (autograd through ``flash_attention_ref``,
    or, ``packed``, through ``segment_attention_ref`` with the packed
    trace's first two rows of segment ids and positions): the gradients
    of the layer's q, k and v (after rope, as attention sees them) must
    agree within ``BWD_TOL`` of each one's max |.|, and the kernels must
    take the tensor-core route. This catches layout and stride faults
    that the kernel-level checks, on tensors made for them, cannot."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_3_8b(num_hidden_layers=1)
    params = L.init_params(cfg, seed=0, device=dev)
    lp = L.layer(params, 0)
    b, s = 2, TRAIN_SEQ
    segs = ()
    if packed:
        trace = packed_trace()[1]
        segs = tuple(torch.as_tensor(trace[key][:b], device=dev)
                     for key in ("segment_ids", "positions"))
    ids = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, s)), device=dev)
    x = params["embed"][ids].detach().requires_grad_()
    cos, sin = L._rope_tables(s, cfg.head_dim, theta=cfg.rope_theta,
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    cot = torch.randn(b, s, cfg.hidden_size, generator=gen,
                      device=dev).to(x.dtype)
    kernel_attn = L.sdpa_raw
    grads, launches = {}, {}
    for name in ("kernel", "plain"):
        seen = []

        def attn(q, k, v, **kw):
            for t in (q, k, v):
                t.retain_grad()
            seen.extend((q, k, v))
            if name == "kernel":
                return kernel_attn(q, k, v, **kw)
            if packed:
                seg, pos = kw["segment_ids"], kw["positions"]
                return FA.segment_attention_ref(q, k, v, seg, seg, pos, pos,
                                                causal=kw["is_causal"])[0]
            return FA.flash_attention_ref(q, k, v,
                                          causal=kw["is_causal"])[0]

        L.sdpa_raw = attn
        try:
            K.reset_dispatch_stats()
            L._block(x, lp, cos, sin, cfg, *segs).backward(cot)
            torch.cuda.synchronize()
        finally:
            L.sdpa_raw = kernel_attn
        launches[name] = K.dispatch_stats()
        grads[name] = [t.grad for t in seen]
    rel = [_err(g, w) / float(w.float().abs().max())
           for g, w in zip(grads["kernel"], grads["plain"])]
    st = launches["kernel"]
    fwd, bwd = ("varlen", "varlen_bwd") if packed else ("flash", "flash_bwd")
    _say("layer_grads", widths="llama_3_8b", batch=f"{b}x{s}",
         layout="packed_trace_rows_0_1" if packed else "dense",
         dq_rel_err=rel[0], dk_rel_err=rel[1], dv_rel_err=rel[2],
         tol=BWD_TOL, **{key: st[key] for key in (fwd, f"{fwd}_tc", bwd,
                                                  f"{bwd}_tc")})
    assert max(rel) <= BWD_TOL, rel
    assert st[fwd] == st[f"{fwd}_tc"] == 1, st
    assert st[bwd] == st[f"{bwd}_tc"] == 1, st
    assert launches["plain"][fwd] == 0, launches["plain"]


def _tc_route_only(launches):
    """A bf16 main path launches the dense flash kernels only on their
    tensor-core route."""
    assert launches["flash_tc"] == launches["flash"], launches
    assert launches["flash_bwd_tc"] == launches["flash_bwd"], launches


def _seg_tc_route_only(launches):
    """A bf16 packed main path launches the segment kernels only on their
    tensor-core route."""
    assert launches["varlen_tc"] == launches["varlen"], launches
    assert launches["varlen_bwd_tc"] == launches["varlen_bwd"], launches


def packed_trace():
    """The packed rung's documents: ``(docs, packed)``, 24 heavy-tailed
    lengths up to 2048 (seed 7), ids from ``default_rng(7)``, packed
    first-fit into ``[7, 2048]`` rows."""
    import numpy as np
    from paddle_tpu_torch.io import packing as PK
    lens = PK.heavy_tailed_lengths(PACKED_SEQ, PACKED_DOCS, seed=PACKED_SEED)
    rng = np.random.default_rng(PACKED_SEED)
    docs = [rng.integers(0, PACKED_VOCAB, (n,)).astype(np.int32)
            for n in lens]
    return docs, PK.pack_documents(docs, PACKED_SEQ)


def one_doc_per_row(docs, rows, seq):
    """The padded form of ``docs``: ``(ids, labels)`` int32 ``[rows,
    seq]``, one document a row from the top, next-token labels inside
    each document and ``IGNORE_INDEX`` elsewhere."""
    import numpy as np
    from paddle_tpu_torch.io.packing import IGNORE_INDEX
    ids = np.zeros((rows, seq), np.int32)
    labels = np.full((rows, seq), IGNORE_INDEX, np.int32)
    for i, d in enumerate(docs):
        ids[i, :len(d)] = d
        labels[i, :len(d) - 1] = d[1:]
    return ids, labels


def _seg_layout(torch, dev, b, sq, sk, kind):
    """(seg_q, seg_k, pos_q, pos_k) int32 on the card: documents of
    assorted lengths that cross tile edges, with a padding tail
    ("packed"); random ids (padding included) and positions per token
    ("random", where the tile predicate is only conservative); q and k
    sides of different documents ("cu", Sq != Sk)."""
    g = torch.Generator().manual_seed(8)
    if kind == "random":
        seg_q, seg_k = (torch.randint(-1, 3, (b, s), generator=g)
                        for s in (sq, sk))
        pos_q, pos_k = (torch.randint(0, s, (b, s), generator=g)
                        for s in (sq, sk))
    else:
        def side(s, lens):
            seg = torch.full((b, s), -1)
            pos = torch.zeros(b, s, dtype=torch.long)
            o = 0
            for i, n in enumerate(lens):
                seg[:, o:o + n], pos[:, o:o + n] = i, torch.arange(n)
                o += n
            return seg, pos
        seg_q, pos_q = side(sq, [sq // 3, sq // 2 - 5, sq // 8])
        seg_k, pos_k = (side(sk, [sk // 4, sk // 2, sk // 5])
                        if kind == "cu" else (seg_q, pos_q))
    return tuple(t.to(torch.int32).to(dev)
                 for t in (seg_q, seg_k, pos_q, pos_k))


def phase_flash_seg(torch, dev):
    """The segment (sequence-packed) kernels against their plain versions
    on the same card tensors, each launch on the route it must take
    (bf16 at D 64 / 128 on the tensor cores, float32 on the CUDA cores;
    bf16 at D 72 in ``phase_flash_d``),
    then at the packed trace's shape: the skip count at the route's
    tiles, out / lse and grads held to the plain versions, and times of
    kernel, plain version and SDPA with a block-diagonal causal mask."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(9)
    H, KVH, D = 32, 8, 128
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(b, sq, sk, dtype, d=D):
        return tuple(torch.randn(b, s, h, d, generator=gen, device=dev)
                     .to(dtype) for s, h in ((sq, H), (sk, KVH), (sk, KVH),
                                             (sq, H)))

    def check(q, k, v, dout, segs, is_causal, tol, **what):
        """Both kernels against the plain versions, each launched once on
        its route; exact zeros on padding rows (out, dq) and padding keys
        (dk, dv)."""
        K.reset_dispatch_stats()
        out, lse = FA.flash_attention_segments_fwd(q, k, v, *segs,
                                                   causal=is_causal)
        grads = FA.flash_attention_segments_bwd(q, k, v, out, lse, dout,
                                                *segs, causal=is_causal)
        torch.cuda.synchronize()
        st = K.dispatch_stats()
        tc = int(FA.tensor_core_route(q))
        assert st["varlen"] == st["varlen_bwd"] == 1, st
        assert st["varlen_tc"] == st["varlen_bwd_tc"] == tc, st
        ref, ref_lse = FA.segment_attention_ref(q, k, v, *segs,
                                                causal=is_causal)
        err = _err(out, ref)
        seen = torch.isfinite(ref_lse)
        assert torch.equal(seen, torch.isfinite(lse)), \
            "flash_seg_fwd: rows that see no key differ"
        lerr = _err(lse[seen], ref_lse[seen]) if bool(seen.any()) else 0.0
        del ref, ref_lse
        want = FA.segment_attention_bwd_ref(q, k, v, out, lse, dout, *segs,
                                            causal=is_causal)
        berrs = [_err(g, w) for g, w in zip(grads, want)]
        rel = max(e / float(w.float().abs().max())
                  for e, w in zip(berrs, want))
        del want
        pad_q, pad_k = segs[0] < 0, segs[1] < 0
        zeros = (bool((out[pad_q] == 0).all())
                 and bool((grads[0][pad_q] == 0).all())
                 and bool((grads[1][pad_k] == 0).all())
                 and bool((grads[2][pad_k] == 0).all()))
        _say("kernels", kernel="flash_seg", **what,
             route="tc" if tc else "cuda_cores", max_abs_err=err,
             lse_err=lerr, bwd_max_abs_err=max(berrs), bwd_rel_err=rel,
             tol=tol, padding_rows=int(pad_q.sum()),
             padding_keys=int(pad_k.sum()), padding_exact_zeros=zeros)
        assert err <= tol and lerr <= LSE_TOL, "flash_seg_fwd disagrees"
        assert rel <= tol, "flash_seg_bwd disagrees"
        assert zeros, "flash_seg: padding rows / keys are not exact zeros"
        assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
        return out, lse, grads, err, max(berrs)

    worst_f = worst_b = 0.0
    for sq, sk, d, causal, dtype, tol, kind in (
            (96, 96, D, True, bf16, FLASH_TOL, "packed"),
            (160, 160, D, False, bf16, FLASH_TOL, "packed"),
            (512, 512, D, True, bf16, FLASH_TOL, "packed"),
            (96, 96, D, True, f32, FLASH_F32_TOL, "packed"),
            (64, 64, D, True, bf16, FLASH_TOL, "random"),
            (70, 90, D, True, bf16, FLASH_TOL, "cu"),
            (70, 90, D, False, f32, FLASH_F32_TOL, "cu"),
            # ragged S with a padding tail, at both tensor-core head dims
            (1000, 1000, D, True, bf16, FLASH_TOL, "packed"),
            (1000, 1000, 64, True, bf16, FLASH_TOL, "packed"),
            (1000, 1000, 64, False, bf16, FLASH_TOL, "packed"),
            (300, 260, 64, True, bf16, FLASH_TOL, "cu")):
        q, k, v, dout = inputs(2, sq, sk, dtype, d)
        segs = _seg_layout(torch, dev, 2, sq, sk, kind)
        *_, ef, eb = check(q, k, v, dout, segs, causal, tol, Sq=sq, Sk=sk,
                           D=d, causal=causal,
                           dtype=str(dtype).split(".")[-1], layout=kind)
        if dtype == bf16:
            worst_f, worst_b = max(worst_f, ef), max(worst_b, eb)

    # one document over the whole row is dense causal attention: the
    # segment kernels against the dense ones
    q, k, v, dout = inputs(2, 200, 200, bf16)
    seg = torch.zeros(2, 200, dtype=torch.int32, device=dev)
    pos = torch.arange(200, dtype=torch.int32, device=dev).expand(2, 200)
    segs = (seg, seg, pos.contiguous(), pos.contiguous())
    K.reset_dispatch_stats()
    out, lse = FA.flash_attention_segments_fwd(q, k, v, *segs, causal=True)
    dense, dense_lse = FA.flash_attention_fwd(q, k, v, causal=True)
    grads = FA.flash_attention_segments_bwd(q, k, v, out, lse, dout, *segs,
                                            causal=True)
    dense_g = FA.flash_attention_bwd(q, k, v, dense, dense_lse, dout,
                                     causal=True)
    torch.cuda.synchronize()
    st = K.dispatch_stats()
    err, lerr = _err(out, dense), _err(lse, dense_lse)
    rel = max(_err(a, b) / float(b.float().abs().max())
              for a, b in zip(grads, dense_g))
    _say("kernels", kernel="flash_seg", case="one_document_vs_dense",
         route="tc", max_abs_err=err, lse_err=lerr, bwd_rel_err=rel,
         tol=FLASH_TOL)
    assert err <= FLASH_TOL and lerr <= LSE_TOL and rel <= BWD_TOL, \
        "flash_seg: a one-document row differs from the dense kernels"
    assert all(st[key] == 1 for key in ("varlen_tc", "varlen_bwd_tc",
                                        "flash_tc", "flash_bwd_tc")), st

    # the packed trace: [7, 2048] at Llama-3-8B's attention widths
    _, packed = packed_trace()
    seg = torch.as_tensor(packed["segment_ids"], device=dev)
    pos = torch.as_tensor(packed["positions"], device=dev)
    segs = (seg, seg, pos, pos)
    b, s = seg.shape
    q, k, v, dout = inputs(b, s, s, bf16)
    ran = torch.zeros(1, dtype=torch.int32, device=dev)
    FA.flash_attention_segments_fwd(q, k, v, *segs, causal=True,
                                    tiles_ran=ran)
    tiles = FA.seg_tiles(q)
    skipped, total = FA.count_skipped_blocks(*segs, *tiles, True)
    ran_per_head = int(ran) / H
    _say("kernels", kernel="flash_seg_fwd", shape=f"B{b}xS{s}",
         tiles=f"{tiles[0]}x{tiles[1]}", tiles_total=total,
         tiles_skipped_count=skipped, tiles_run_kernel_per_head=ran_per_head)
    # what coarser tiles cost on this trace: tiles run of the total, and
    # pairs computed over visible pairs (a count, on the CPU)
    cpu_segs = [x.cpu() for x in segs]
    visible = int(FA._seg_mask(*cpu_segs, True).sum())
    for tq, tk in ((32, 32), (64, 64), (128, 128), (128, 64), (64, 128)):
        sk_, tot_ = FA.count_skipped_blocks(*cpu_segs, tq, tk, True)
        _say("kernels", kernel="flash_seg", trace_tiles=f"{tq}x{tk}",
             tiles_run=tot_ - sk_, tiles_total=tot_,
             pairs_computed_over_visible=(tot_ - sk_) * tq * tk / visible)
    assert ran_per_head == total - skipped, \
        "flash_seg_fwd: the tiles run differ from count_skipped_blocks"
    out, lse, grads, ef, eb = check(q, k, v, dout, segs, True, FLASH_TOL,
                                    shape=f"B{b}xS{s}", layout="trace")
    worst_f, worst_b = max(worst_f, ef), max(worst_b, eb)
    del grads
    torch.cuda.empty_cache()
    # the kernels on stats computed once, as the main path's backward
    # reuses its forward's; the stats' own time beside them
    stats = [FA._tile_stats(segs, FA.seg_tiles(q, backward=bwd))
             for bwd in (False, True)]
    stats_ms = _time_ms(lambda: [FA._tile_stats(segs, FA.seg_tiles(
        q, backward=bwd)) for bwd in (False, True)], 10)
    fwd_ms = _time_ms(lambda: FA.flash_attention_segments_fwd(
        q, k, v, *segs, causal=True, stats=stats[0]), 10)
    fwd_plain_ms = _time_ms(lambda: FA.segment_attention_ref(
        q, k, v, *segs, causal=True), 3)
    bwd_ms = _time_ms(lambda: FA.flash_attention_segments_bwd(
        q, k, v, out, lse, dout, *segs, causal=True, stats=stats[1]), 5)
    bwd_plain_ms = _time_ms(lambda: FA.segment_attention_bwd_ref(
        q, k, v, out, lse, dout, *segs, causal=True), 3)
    torch.cuda.empty_cache()
    # the library yardstick: SDPA with the same function as a boolean
    # [B, 1, S, S] mask (k / v heads repeated outside the timed call);
    # its padding rows may be NaN, so no value is compared
    mask = FA._seg_mask(*segs, True)
    visible = int(mask.sum())           # per head: sum of n(n + 1) / 2
    leaves = [x.transpose(1, 2).repeat_interleave(H // x.shape[2], dim=1)
              .contiguous().requires_grad_() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        lib_fwd_ms = _time_ms(
            lambda: sdpa(*leaves, attn_mask=mask[:, None]), 10)
    lib_out = sdpa(*leaves, attn_mask=mask[:, None])
    lib_dout = dout.transpose(1, 2).contiguous()
    lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, lib_dout, retain_graph=True), 5)
    del lib_out, leaves, mask
    torch.cuda.empty_cache()
    # least work over the visible pairs only: 2 products (q k^T, p v)
    # forward, 5 backward, of 2 * D operations a pair and head; bytes:
    # each input read once, each output written once
    pair_ops = 2.0 * D * H * visible
    seg_bytes = 4 * 4 * b * s
    fwd_ops, bwd_ops = 2 * pair_ops, 5 * pair_ops
    qb, kb = 2 * b * s * H * D, 2 * b * s * KVH * D
    fwd_bytes = 2 * qb + 2 * kb + 4 * b * H * s + seg_bytes
    bwd_bytes = 4 * qb + 4 * kb + 4 * b * H * s + seg_bytes
    recs = []
    for name, src_line, ms, plain, lib, ops, nbytes, worst in (
            ("flash_seg_fwd", 496, fwd_ms, fwd_plain_ms, lib_fwd_ms,
             fwd_ops, fwd_bytes, worst_f),
            ("flash_seg_bwd", 546, bwd_ms, bwd_plain_ms, lib_bwd_ms,
             bwd_ops, bwd_bytes, worst_b)):
        t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        _say("kernels", kernel=name, shape=f"B{b}xS{s}", route="tc",
             ms=ms, stats_ms=stats_ms, plain_ms=plain, library_ms=lib,
             bound_ms=bound,
             share_of_bound=bound / ms, visible_pairs_per_head=visible,
             gflop=ops / 1e9, mbytes=nbytes / 1e6, tflops=ops / ms / 1e9)
        recs.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/" + (
                         "flash_fwd.cu" if name.endswith("fwd")
                         else "flash_bwd.cu"),
                     "replaces": f"paddle_tpu/kernels/flash_attention.py:"
                                 f"{src_line}",
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "library_ms": lib})
    return recs


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
         flash_tc=launches["flash_tc"], flash_bwd_tc=launches["flash_bwd_tc"],
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
    _tc_route_only(launches)
    assert all(launches[k] == 0 for k in ("flash_ref", "flash_bwd_ref",
                                          "paged_ref", "fused_ce_fallback"))
    return launches


def phase_train_packed_parity(torch, dev):
    """Three sequence-packed train steps of one float32 llama_tiny model
    on the card (segment kernels) and on the CPU (plain versions), and
    the packed loss against the same documents one per row on the
    card."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import packing as PK
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_tiny()
    cpu_params = L.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
    rng = np.random.default_rng(10)
    lens = [40, 24, 30, 17, 9, 33, 64, 5]
    docs = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    packed = PK.pack_documents(docs, 64)
    losses, grads = {}, {}
    for name, params, where in (("card", card_params, dev),
                                ("cpu", cpu_params, "cpu")):
        batch = PK.packed_train_batch(packed, device=where)
        K.reset_dispatch_stats()
        grads[name] = L._leaves(L.loss_and_grads(params, batch, cfg)[1])
        state = L.adamw_init(params)
        step = L.make_train_step(cfg)
        losses[name] = [float(step(params, state, batch)[2])
                        for _ in range(3)]
        torch.cuda.synchronize()
        stats = K.dispatch_stats()
        _say("train_packed_parity", device=name, rows=packed["ids"].shape[0],
             losses=losses[name], **stats)
        if name == "card":
            assert stats["varlen"] > 0 and stats["varlen_bwd"] > 0
            assert stats["varlen_ref"] == 0 and stats["varlen_bwd_ref"] == 0
            assert stats["flash"] == 0 and stats["flash_ref"] == 0
    grad_err = max(_err(a.cpu(), b) / float(b.abs().max())
                   for a, b in zip(grads["card"], grads["cpu"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    # the same documents one per row (padded with ignored labels), through
    # the dense kernels, on the card
    params = L.init_params(cfg, seed=0, device=dev)
    ids, lab = one_doc_per_row(docs, len(docs), max(lens))
    with torch.no_grad():
        lp = float(L.loss_fn(params, PK.packed_train_batch(packed, dev),
                             cfg))
        lu = float(L.loss_fn(params, (torch.as_tensor(ids, device=dev),
                                      torch.as_tensor(lab, device=dev)),
                             cfg))
    unpacked_err = abs(lp - lu) / abs(lu)
    _say("train_packed_parity", loss_rel_err=loss_err,
         loss_rtol=TRAIN_LOSS_RTOL, grad_rel_err=grad_err,
         grad_tol=TRAIN_GRAD_TOL, packed_loss=lp, unpacked_loss=lu,
         packed_vs_unpacked_rel_err=unpacked_err)
    assert loss_err <= TRAIN_LOSS_RTOL, losses
    assert grad_err <= TRAIN_GRAD_TOL, grad_err
    assert unpacked_err <= TRAIN_LOSS_RTOL, (lp, lu)


def packed_train_setup(torch, dev):
    """The packed training main path's ``(cfg, params, opt_state, step,
    batch, docs, packed)``: the JAX package's packed rung at Llama-3-8B
    widths (4 layers, vocab 32000, remat "dots", materialising cross
    entropy), random bf16 weights from seed 0, bf16 AdamW moments, lr
    1e-4, the packed trace as one ``[7, 2048]`` batch on ``dev``."""
    from paddle_tpu_torch.io import packing as PK
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_3_8b(num_hidden_layers=TRAIN_LAYERS,
                       vocab_size=PACKED_VOCAB, remat_policy="dots",
                       fused_ce=False)
    params = L.init_params(cfg, seed=0, device=dev)
    state = L.adamw_init(params, moment_dtype=torch.bfloat16)
    step = L.make_train_step(cfg, lr=1e-4)
    docs, packed = packed_trace()
    return (cfg, params, state, step, PK.packed_train_batch(packed, dev),
            docs, packed)


def phase_train_packed(torch, dev, card):
    """The packed training main path, then its padded baseline."""
    import math

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import packing as PK
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.models import llama as L
    t0 = time.perf_counter()
    cfg, params, state, step, batch, docs, packed = packed_train_setup(
        torch, dev)
    torch.cuda.synchronize()
    nparams = L.count_params(cfg)
    rows, seq = packed["ids"].shape
    useful = int((packed["labels"] >= 0).sum())
    seg, pos = packed["segment_ids"], packed["positions"]
    # at the tiles the forward kernel runs on the path's bf16 q
    q_like = torch.empty(1, 1, cfg.num_attention_heads, cfg.head_dim,
                         dtype=torch.bfloat16, device="meta")
    skipped, total = FA.count_skipped_blocks(seg, seg, pos, pos,
                                             *FA.seg_tiles(q_like), True)
    _say("train_packed", layers=TRAIN_LAYERS,
         params_b=round(nparams / 1e9, 3), vocab=cfg.vocab_size,
         remat=cfg.remat_policy, fused_ce=cfg.fused_ce,
         batch=f"{rows}x{seq}", documents=len(docs), useful_tokens=useful,
         packing_efficiency=PK.packing_efficiency(packed),
         tiles_skipped=skipped, tiles_total=total,
         tiles_skipped_share=skipped / total,
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
    peak = torch.cuda.max_memory_allocated(dev)
    timed = sorted(times[2:])
    step_s = timed[len(timed) // 2]
    packed_tps = useful / step_s

    # the padded baseline: the same documents one per row, in waves of
    # `rows` rows, through the same step (the dense kernels)
    waves = -(-len(docs) // rows)
    ids, lab = one_doc_per_row(docs, waves * rows, seq)
    pad_batches = [(torch.as_tensor(ids[w * rows:(w + 1) * rows], device=dev),
                    torch.as_tensor(lab[w * rows:(w + 1) * rows], device=dev))
                   for w in range(waves)]
    K.reset_dispatch_stats()
    pass_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        for pb in pad_batches:
            float(step(params, state, pb)[2])
        pass_s.append(time.perf_counter() - t0)
    pad_launches = K.dispatch_stats()
    padded_tps = useful / (sum(pass_s[1:]) / 2)
    steps = len(times)
    _say("train_packed", card=repr(card), losses=losses,
         step_ms=[t * 1e3 for t in times[2:]], median_step_ms=step_s * 1e3,
         useful_tokens_per_s=packed_tps,
         mfu_6nd_useful=6.0 * nparams * packed_tps / H100_BF16_FLOPS,
         peak_mem_gb=round(peak / 1e9, 2))
    _say("train_packed", padded_waves=waves, padded_pass_ms=[
        t * 1e3 for t in pass_s[1:]], padded_useful_tokens_per_s=padded_tps,
         speedup_vs_padded=packed_tps / padded_tps,
         padded_flash=pad_launches["flash"],
         padded_flash_bwd=pad_launches["flash_bwd"],
         padded_flash_tc=pad_launches["flash_tc"],
         padded_flash_bwd_tc=pad_launches["flash_bwd_tc"])
    _say("train_packed", steps=steps,
         varlen_per_step=launches["varlen"] / steps,
         varlen_bwd_per_step=launches["varlen_bwd"] / steps,
         **{k: v for k, v in launches.items() if k != "paged"})
    ln_v = math.log(cfg.vocab_size)
    assert all(math.isfinite(x) for x in losses), losses
    assert ln_v - 1 <= losses[0] <= ln_v + 2, (losses[0], ln_v)
    assert losses[-1] < losses[0], losses
    assert launches["varlen"] == 2 * TRAIN_LAYERS * steps, launches
    assert launches["varlen_bwd"] == TRAIN_LAYERS * steps, launches
    _seg_tc_route_only(launches)
    assert launches["flash"] == 0 and launches["flash_bwd"] == 0, launches
    assert all(v == 0 for k, v in launches.items() if k.endswith("_ref")), \
        launches
    assert pad_launches["flash_bwd"] == TRAIN_LAYERS * waves * 3
    _tc_route_only(pad_launches)
    assert all(v == 0 for k, v in pad_launches.items()
               if k.endswith("_ref") or k.startswith("varlen"))
    return launches


def eager_train_setup(torch, cfg, seed=0, data_seed=0, batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, dtype="bfloat16", lr=3e-4):
    """The eager main path's ``(model, optimizer, inp, tgt)`` on the
    current device: ``seed(seed)``, ``LlamaForCausalLM(cfg)`` with
    Paddle's default initializers, cast to ``dtype``, ``AdamW``, ids
    ``[batch, seq + 1]`` from ``numpy.random.default_rng(data_seed)``
    split into inputs and shifted targets."""
    import numpy as np
    import paddle_tpu_torch as P
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import llama as L
    P.seed(seed)
    model = L.LlamaForCausalLM(cfg)
    if dtype is not None:
        model.to(dtype=dtype)
    opt = O.AdamW(learning_rate=lr, parameters=model.parameters())
    ids = np.random.default_rng(data_seed).integers(
        0, cfg.vocab_size, (batch, seq + 1))
    return model, opt, P.to_tensor(ids[:, :-1]), P.to_tensor(ids[:, 1:])


def eager_step(model, opt, inp, tgt):
    """One eager training step as PaddleNLP users write it; returns the
    loss (a tensor on the card)."""
    import paddle_tpu_torch.nn.functional as F
    vocab = model.config.vocab_size
    loss = F.cross_entropy(model(inp).reshape([-1, vocab]),
                           tgt.reshape([-1]))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def phase_eager_parity(torch, dev):
    """Three eager steps of one float32 llama_tiny ``LlamaForCausalLM``
    on the card (kernels) and on the CPU (plain versions), from one set
    of weights."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_tiny()
    losses, grads, weights = {}, {}, None
    try:
        for name, where in (("cpu", "cpu"), ("card", f"gpu:{dev.index}")):
            P.set_device(where)
            model, opt, inp, tgt = eager_train_setup(
                torch, cfg, seed=0, data_seed=6, batch=2, seq=32,
                dtype=None, lr=3e-3)
            if weights is None:
                weights = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
            else:
                model.set_state_dict(weights)
            K.reset_dispatch_stats()
            loss = F.cross_entropy(
                model(inp).reshape([-1, cfg.vocab_size]), tgt.reshape([-1]))
            loss.backward()
            grads[name] = [p.grad.detach().cpu() for p in model.parameters()]
            opt.clear_grad()
            losses[name] = [float(eager_step(model, opt, inp, tgt))
                            for _ in range(3)]
            torch.cuda.synchronize()
            stats = K.dispatch_stats()
            _say("eager_parity", device=name, losses=losses[name],
                 **{k: v for k, v in stats.items() if v})
        # 2L + 1 RMSNorms a forward: 4 forwards (one for the gradients)
        n_rms = 4 * (2 * cfg.num_hidden_layers + 1)
        assert stats["rms"] == n_rms and stats["rms_bwd"] == n_rms, stats
        assert stats["flash"] > 0 and stats["flash_bwd"] > 0, stats
        assert all(v == 0 for k, v in stats.items()
                   if k.endswith("_ref") or k == "rms_fallback"), stats
    finally:
        P.set_device(f"gpu:{dev.index}")
    grad_err = max(_err(a, b) / float(b.abs().max())
                   for a, b in zip(grads["card"], grads["cpu"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    _say("eager_parity", loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
         grad_rel_err=grad_err, grad_tol=TRAIN_GRAD_TOL)
    assert loss_err <= TRAIN_LOSS_RTOL, losses
    assert grad_err <= TRAIN_GRAD_TOL, grad_err


def phase_eager_train(torch, dev, card):
    """The eager main path: ``LlamaForCausalLM`` at Llama-3-8B widths, 4
    layers, bf16, AdamW, batch 4 x 2048. Returns ``(launches, median step
    ms)``."""
    import math

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    t0 = time.perf_counter()
    cfg = L.llama_3_8b(num_hidden_layers=TRAIN_LAYERS)
    model, opt, inp, tgt = eager_train_setup(torch, cfg)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    assert nparams == L.count_params(cfg), (nparams, L.count_params(cfg))
    _say("eager_train", layers=TRAIN_LAYERS, params_b=round(nparams / 1e9, 3),
         dtype="bf16", batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}",
         init_s=round(time.perf_counter() - t0, 2))
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    losses, times = [], []
    for i in range(7):
        t0 = time.perf_counter()
        losses.append(float(eager_step(model, opt, inp, tgt)))   # waits
        times.append(time.perf_counter() - t0)
    launches = K.dispatch_stats()
    timed = sorted(times[2:])
    step_s = timed[len(timed) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = len(times)
    _say("eager_train", card=repr(card), losses=losses,
         step_ms=[t * 1e3 for t in times[2:]], median_step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s,
         mfu_6nd=6.0 * nparams * tokens / step_s / H100_BF16_FLOPS,
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2))
    _say("eager_train", steps=steps, rms_per_step=launches["rms"] / steps,
         rms_bwd_per_step=launches["rms_bwd"] / steps,
         **{k: v for k, v in launches.items() if v})
    n_rms = 2 * TRAIN_LAYERS + 1
    ln_v = math.log(cfg.vocab_size)
    assert all(math.isfinite(x) for x in losses), losses
    assert ln_v - 1 <= losses[0] <= ln_v + 2, (losses[0], ln_v)
    assert losses[-1] < losses[0], losses
    assert launches["rms"] == n_rms * steps, launches
    assert launches["rms_bwd"] == n_rms * steps, launches
    assert launches["flash"] == TRAIN_LAYERS * steps, launches
    assert launches["flash_bwd"] == TRAIN_LAYERS * steps, launches
    _tc_route_only(launches)
    assert all(v == 0 for k, v in launches.items()
               if k.endswith("_ref") or k == "rms_fallback"), launches
    return launches, step_s * 1e3


# the no_sync phase: three prompts of one bucket (512 positions) in an
# engine of 4 slots make one prefill group padded to 4 (a dummy row of
# sentinel pages) and then one decode chunk with a dead slot; the last
# request is sampled in the sampled case
NO_SYNC_PROMPTS, NO_SYNC_CHUNK = (400, 300, 257), 8


def serve_strict(torch, family, cfg, params, dev, kv_quant, prompts,
                 chunk, forbid_sync, temperature=0.0):
    """Serve ``prompts`` (random ids from seed 0, ``chunk + 1`` new tokens
    each) with a ``ServingEngine`` of 4 slots and decode chunk ``chunk``
    on bf16 pages, or int8 pages with ``kv_quant``; the last request
    samples at ``temperature`` when it is above 0. With ``forbid_sync``
    every call of the engine's data plane (``_prefill_plane``,
    ``_decode_plane``) runs under ``torch.cuda.set_sync_debug_mode
    ("error")``, so any read of the device by the host inside a prefill
    group or a decode chunk raises; the engine's own uploads and reads
    between them are allowed. Returns the tokens of each request and the
    number of group and chunk calls."""
    import numpy as np
    from paddle_tpu_torch.inference import Request, ServingEngine
    eng = ServingEngine(family, params, cfg, num_slots=4, max_len=1024,
                        decode_chunk=chunk, kv_quant=kv_quant, device=dev)
    calls = {"prefill": 0, "decode": 0}

    def watched(name, plane):
        def run(*args):
            calls[name] += 1
            if not forbid_sync:
                return plane(*args)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return plane(*args)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return run

    eng._prefill_plane = watched("prefill", eng._prefill_plane)
    eng._decode_plane = watched("decode", eng._decode_plane)
    rng = np.random.default_rng(0)
    last = len(prompts) - 1
    out = eng.run([Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                      plen),
                           max_new_tokens=chunk + 1,
                           temperature=temperature if i == last else 0.0,
                           seed=100 + i)
                   for i, plen in enumerate(prompts)])
    return [out[i].tokens for i in range(len(prompts))], calls


def phase_no_sync(torch, dev, cfg, params):
    """The serving data plane reads nothing back inside a prefill group or
    a decode chunk: at ``main``'s Llama-3-8B widths, with bf16 and then
    int8 pages, the engine serves one group and one greedy chunk with its
    data plane under ``set_sync_debug_mode("error")`` and gives the
    tokens of the same serve outside it; a sampled request (bf16 pages)
    likewise, drawing the same tokens twice from the same seed."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    layers = cfg.num_hidden_layers
    for kv_quant, temperature in ((False, 0.0), (True, 0.0), (False, 0.8)):
        free, _ = serve_strict(torch, L, cfg, params, dev, kv_quant,
                               NO_SYNC_PROMPTS, NO_SYNC_CHUNK, False,
                               temperature)
        K.reset_dispatch_stats()
        t0 = time.perf_counter()
        strict, calls = serve_strict(torch, L, cfg, params, dev, kv_quant,
                                     NO_SYNC_PROMPTS, NO_SYNC_CHUNK, True,
                                     temperature)
        wall = time.perf_counter() - t0
        st = K.dispatch_stats()
        arm = "paged_quant" if kv_quant else "paged"
        same = all(np.array_equal(a, b) for a, b in zip(free, strict))
        _say("no_sync", kv_quant=kv_quant, temperature=temperature,
             prompts=",".join(map(str, NO_SYNC_PROMPTS)),
             chunk=NO_SYNC_CHUNK, sync_debug_mode="error", raised=False,
             groups=calls["prefill"], chunks=calls["decode"],
             tokens_equal=same, first=[int(t[0]) for t in strict],
             wall_s=round(wall, 3), flash=st["flash"],
             flash_tc=st["flash_tc"], **{arm: st[arm]})
        assert same, (free, strict)
        assert calls == {"prefill": 1, "decode": 1}, calls
        assert all(len(t) == NO_SYNC_CHUNK + 1 for t in strict), strict
        assert all(0 <= int(v) < cfg.vocab_size for t in strict for v in t)
        assert st["flash"] == st["flash_tc"] == layers, st
        assert st[arm] == NO_SYNC_CHUNK * layers, st
        assert all(v == 0 for k, v in st.items() if k.endswith("_ref")), st


SURFACE_TOL = {"float32": 1e-5, "bfloat16": FLASH_TOL}


def phase_surface(torch, dev):
    """The masked attention path and the eager surface's leftovers, card
    against CPU on the same seeded inputs: masked
    ``F.scaled_dot_product_attention`` (boolean and additive masks, with
    causal, GQA, float32 and bf16; plain math on every device, no flash
    launch), ``flash_attention_with_sparse_mask``, dropout by its
    statistics, ``F.flash_attention`` and ``flash_attn_qkvpacked`` (one
    tensor-core flash launch each, equal to ``sdpa_raw``) and
    ``fused_rms_norm`` (one ``rms`` launch, equal to ``F.rms_norm``)."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.incubate.nn.functional as IF
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import kernels as K
    gen = torch.Generator(device="cpu").manual_seed(11)
    B, S, H, KVH, D = 2, 256, 32, 8, 128

    def both(x):
        return x, x.to(dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    q, k, v = randn(B, S, H, D), randn(B, S, KVH, D), randn(B, S, KVH, D)
    masks = {"bool": (torch.rand(B, 1, S, S, generator=gen) < 0.5)
             | torch.eye(S, dtype=torch.bool),
             "additive": randn(B, H, S, S)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for kind, causal in (("bool", False), ("bool", True),
                             ("additive", True)):
            outs = {}
            K.reset_dispatch_stats()
            for where, idx in (("cpu", 0), ("card", 1)):
                t = [both(x.to(dtype))[idx] for x in (q, k, v)]
                m = both(masks[kind])[idx]
                outs[where] = F.scaled_dot_product_attention(
                    *t, m, is_causal=causal)
            torch.cuda.synchronize()
            err = _err(outs["card"].cpu(), outs["cpu"]) / float(
                outs["cpu"].float().abs().max())
            flash = K.dispatch_stats()["flash"]
            _say("surface", fn="scaled_dot_product_attention", mask=kind,
                 causal=causal, gqa=f"{H}/{KVH}", dtype=name, rel_err=err,
                 tol=SURFACE_TOL[name], flash_launches=flash)
            assert err <= SURFACE_TOL[name] and flash == 0

    starts = torch.randint(1, S + 1, (B, 8, S), generator=gen)
    starts[..., 0] = S
    q8, k8, v8 = (randn(B, S, 8, D) for _ in range(3))
    outs = [F.flash_attention_with_sparse_mask(
        *(both(x)[i] for x in (q8, k8, v8)), both(starts)[i],
        is_causal=True)[0] for i in (0, 1)]
    err = _err(outs[1].cpu(), outs[0]) / float(outs[0].abs().max())
    _say("surface", fn="flash_attention_with_sparse_mask", causal=True,
         rel_err=err, tol=SURFACE_TOL["float32"])
    assert err <= SURFACE_TOL["float32"]

    # dropout: one-hot values turn the output rows into the probabilities
    p = 0.2
    qd, kd = (x.to(dev) for x in (q8, k8))
    vd = torch.eye(S, device=dev)[None, :, None, :].expand(
        B, S, 8, S).contiguous()
    plain = F.sdpa_reference(qd, kd, vd, causal=True)     # D 256: no flash
    P.seed(5)
    drop = F.scaled_dot_product_attention(qd, kd, vd, dropout_p=p,
                                          is_causal=True)
    seen = plain > 0
    kept = drop[seen] != 0
    n, n_kept = int(seen.sum()), int(kept.sum())
    scale_err = float(((drop[seen][kept] - plain[seen][kept] / (1 - p))
                       .abs() / plain[seen][kept]).max())
    bound = 6 * (n * p * (1 - p)) ** 0.5
    _say("surface", fn="dropout", p=p, probabilities=n,
         keep_rate=n_kept / n, keep_bound=f"{1 - p}+-{bound / n:.5f}",
         kept_scale_rel_err=scale_err,
         dropped_past_causal=int((drop[~seen] != 0).sum()))
    assert abs(n_kept - n * (1 - p)) <= bound and scale_err <= 1e-6
    assert not bool((drop[~seen] != 0).any())

    # the flash entries at D 128 in bf16: one launch each, tensor cores
    qb, kb, vb = (x.to(dev, torch.bfloat16) for x in (q, k, v))
    want = F.sdpa_raw(qb, kb, vb, is_causal=True)
    qkv = torch.stack([qb, kb.repeat_interleave(H // KVH, 2),
                       vb.repeat_interleave(H // KVH, 2)], dim=2)
    want_packed = F.sdpa_raw(*(qkv[:, :, i].contiguous() for i in range(3)),
                             is_causal=True)
    for fn, call, ref in (
            ("flash_attention",
             lambda: F.flash_attention(qb, kb, vb, causal=True)[0], want),
            ("flash_attn_qkvpacked",
             lambda: F.flash_attn_qkvpacked(qkv, causal=True)[0],
             want_packed)):
        K.reset_dispatch_stats()
        got = call()
        torch.cuda.synchronize()
        st = K.dispatch_stats()
        _say("surface", fn=fn, D=D, dtype="bfloat16", flash=st["flash"],
             flash_tc=st["flash_tc"], equal_to_sdpa_raw=torch.equal(got,
                                                                    ref))
        assert st["flash"] == 1 and st["flash_tc"] == 1, st
        assert torch.equal(got, ref)

    # over the last axis (d 512), and over the last two flattened (4096)
    x = randn(16, 8, 512).to(dev, torch.bfloat16)
    for axis in (-1, 1):
        wi = (1 + 0.3 * randn(*x.shape[axis:])).to(dev, torch.bfloat16)
        K.reset_dispatch_stats()
        got = IF.fused_rms_norm(x, wi, None, RMS_EPS, axis)[0]
        torch.cuda.synchronize()
        st = K.dispatch_stats()
        want = F.rms_norm(x.reshape(16, -1) if axis == 1 else x,
                          wi.reshape(-1), epsilon=RMS_EPS).reshape(x.shape)
        _say("surface", fn="fused_rms_norm", begin_norm_axis=axis,
             rms=st["rms"], rms_ref=st["rms_ref"],
             equal_to_f_rms_norm=torch.equal(got, want))
        assert st["rms"] == 1 and st["rms_ref"] == 0 and torch.equal(got,
                                                                     want)


# the training recipe of a Llama user: AdamW (beta2 0.95, weight decay
# 0.1) under LinearWarmup over CosineAnnealingDecay, global-norm clip
RECIPE_LR, RECIPE_WARMUP, RECIPE_T_MAX = 3e-4, 2, 100
# llama_tiny's step-1 gradient norm is about 1.5: 0.05 makes the clip bind
RECIPE_PARITY_CLIP = 0.05


def eager_recipe_setup(torch, cfg, clip_norm, seed=0, data_seed=0,
                       batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype="bfloat16",
                       lr=RECIPE_LR):
    """``eager_train_setup`` with the recipe: ``(model, optimizer,
    scheduler, clip, inp, tgt)``; ``clip`` records each step's scale (a
    device tensor) in ``clip.scales``."""
    from paddle_tpu_torch import optimizer as O

    class RecordingClip(O.ClipGradByGlobalNorm):
        def __init__(self, clip_norm):
            super().__init__(clip_norm)
            self.scales = []

        def _scale(self, grads):
            s = super()._scale(grads)
            self.scales.append(s)
            return s

    model, _, inp, tgt = eager_train_setup(torch, cfg, seed, data_seed,
                                           batch, seq, dtype, lr)
    clip = RecordingClip(clip_norm)
    opt, sched = recipe_optimizer(model.parameters(), clip, lr)
    return model, opt, sched, clip, inp, tgt


def recipe_optimizer(params, clip, lr):
    """The recipe's ``(AdamW, scheduler)`` over ``params``: warmup from
    ``lr / 10`` over ``RECIPE_WARMUP`` steps, then cosine."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.optimizer import lr as LR
    sched = LR.LinearWarmup(LR.CosineAnnealingDecay(lr, T_max=RECIPE_T_MAX),
                            RECIPE_WARMUP, lr / 10, lr)
    return O.AdamW(learning_rate=sched, beta2=0.95, weight_decay=0.1,
                   grad_clip=clip, parameters=params), sched


def recipe_step(model, opt, sched, inp, tgt):
    """``eager_step`` and then the scheduler's step."""
    loss = eager_step(model, opt, inp, tgt)
    sched.step()
    return loss


def phase_eager_recipe_parity(torch, dev):
    """The recipe on one float32 llama_tiny ``LlamaForCausalLM``, 3 steps
    on the card and on the CPU from one set of weights (losses and step-1
    gradients agree, the clip binds at step 1); then on each device a
    ``state_dict`` after step 2 into a fresh optimizer and scheduler, whose
    step 3 must equal the uninterrupted run's bit for bit."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_tiny()
    losses, grads, weights = {}, {}, None
    kw = dict(seed=0, data_seed=7, batch=2, seq=32, dtype=None, lr=3e-3)
    try:
        for name, where in (("cpu", "cpu"), ("card", f"gpu:{dev.index}")):
            P.set_device(where)
            model, opt, sched, clip, inp, tgt = eager_recipe_setup(
                torch, cfg, RECIPE_PARITY_CLIP, **kw)
            if weights is None:
                weights = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
            else:
                model.set_state_dict(weights)
            K.reset_dispatch_stats()
            loss = F.cross_entropy(
                model(inp).reshape([-1, cfg.vocab_size]), tgt.reshape([-1]))
            loss.backward()
            grads[name] = [p.grad.detach().cpu() for p in model.parameters()]
            opt.clear_grad()
            losses[name] = [float(recipe_step(model, opt, sched, inp, tgt))
                            for _ in range(3)]
            stats = K.dispatch_stats()
            scales = [float(s) for s in clip.scales]
            # the same 2 steps, a state dict into a fresh optimizer, step 3
            again, opt2, sched2, _, _, _ = eager_recipe_setup(
                torch, cfg, RECIPE_PARITY_CLIP, **kw)
            again.set_state_dict(weights)
            for _ in range(2):
                recipe_step(again, opt2, sched2, inp, tgt)
            saved = opt2.state_dict()
            opt3, sched3 = recipe_optimizer(
                again.parameters(), O.ClipGradByGlobalNorm(
                    RECIPE_PARITY_CLIP), kw["lr"])
            opt3.set_state_dict(saved)
            recipe_step(again, opt3, sched3, inp, tgt)
            bitwise = all(torch.equal(a, b) for a, b in zip(
                model.parameters(), again.parameters()))
            _say("eager_recipe_parity", device=name, losses=losses[name],
                 clip_norm=RECIPE_PARITY_CLIP, clip_scales=scales,
                 resumed_step3_bit_for_bit=bitwise,
                 **{k: v for k, v in stats.items() if v})
            assert bitwise, name
            assert scales[0] < 1.0, scales            # the clip binds
        n_rms = 4 * (2 * cfg.num_hidden_layers + 1)
        assert stats["rms"] == n_rms and stats["rms_bwd"] == n_rms, stats
        assert stats["flash"] > 0 and stats["flash_bwd"] > 0, stats
        assert all(v == 0 for k, v in stats.items()
                   if k.endswith("_ref") or k == "rms_fallback"), stats
    finally:
        P.set_device(f"gpu:{dev.index}")
    grad_err = max(_err(a, b) / float(b.abs().max())
                   for a, b in zip(grads["card"], grads["cpu"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    _say("eager_recipe_parity", loss_rel_err=loss_err,
         loss_rtol=TRAIN_LOSS_RTOL, grad_rel_err=grad_err,
         grad_tol=TRAIN_GRAD_TOL)
    assert loss_err <= TRAIN_LOSS_RTOL, losses
    assert grad_err <= TRAIN_GRAD_TOL, grad_err


def phase_eager_recipe(torch, dev, card, eager_step_ms):
    """The eager main path with the recipe (clip norm 1.0) at Llama-3-8B
    widths, 4 layers, bf16, batch 4 x 2048: 2 untimed and 5 timed steps,
    beside ``eager_train``'s median step of the same run; then the clip
    alone and the scheduler's step alone, timed on the last gradients."""
    import math
    import statistics

    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_3_8b(num_hidden_layers=TRAIN_LAYERS)
    model, opt, sched, clip, inp, tgt = eager_recipe_setup(torch, cfg, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    losses, times, lrs = [], [], []
    for _ in range(7):
        lrs.append(opt.get_lr())
        t0 = time.perf_counter()
        losses.append(float(recipe_step(model, opt, sched, inp, tgt)))
        times.append(time.perf_counter() - t0)
    launches = K.dispatch_stats()
    scales = [float(s) for s in clip.scales]      # after the timed window
    step_ms = statistics.median(times[2:]) * 1e3
    # the clip alone on one step's gradients, and the scheduler alone
    F.cross_entropy(model(inp).reshape([-1, cfg.vocab_size]),
                    tgt.reshape([-1])).backward()
    grads = [p.grad for p in model.parameters()]
    clip_ms = _time_ms(lambda: clip._clip(grads), 5)
    opt.clear_grad()
    t0 = time.perf_counter()
    for _ in range(1000):
        sched.step()
        opt.get_lr()
    sched_us = (time.perf_counter() - t0) * 1e3
    steps = len(times)
    _say("eager_recipe", card=repr(card), layers=TRAIN_LAYERS, dtype="bf16",
         batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}", clip_norm=1.0,
         losses=losses, lr=lrs, clip_scale=scales,
         step_ms=[t * 1e3 for t in times[2:]], median_step_ms=step_ms,
         eager_train_median_step_ms=eager_step_ms,
         recipe_over_eager_train=step_ms / eager_step_ms,
         clip_ms=clip_ms, clip_share=clip_ms / step_ms,
         scheduler_step_us=sched_us, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
         / step_ms * 1e3,
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2))
    _say("eager_recipe", steps=steps,
         **{k: v for k, v in launches.items() if v})
    n_rms = 2 * TRAIN_LAYERS + 1
    ln_v = math.log(cfg.vocab_size)
    assert all(math.isfinite(x) for x in losses), losses
    assert ln_v - 1 <= losses[0] <= ln_v + 2, (losses[0], ln_v)
    assert losses[-1] < losses[0], losses
    assert len(scales) == steps and all(0 < s <= 1 for s in scales), scales
    assert lrs[0] < lrs[RECIPE_WARMUP] and lrs[-1] < lrs[RECIPE_WARMUP], lrs
    assert launches["rms"] == n_rms * steps, launches
    assert launches["rms_bwd"] == n_rms * steps, launches
    assert launches["flash"] == TRAIN_LAYERS * steps, launches
    assert launches["flash_bwd"] == TRAIN_LAYERS * steps, launches
    _tc_route_only(launches)
    assert all(v == 0 for k, v in launches.items()
               if k.endswith("_ref") or k == "rms_fallback"), launches


def phase_flash_d(torch, dev):
    """The flash pair at ``FLASH_DIMS`` against the plain versions,
    float32 and bf16, with GQA (8 / 2): the dense forward and backward
    causal at Sq 70 != Sk 100 and not causal at a ragged S 100, then the
    segment forward and backward on a packed layout with a padding tail
    (causal) and on documents that differ on the two sides (Sq 70 != Sk
    90, not causal). bf16 at D 72 is counted on the tensor cores
    (``flash_tc`` / ``varlen_tc`` and the backward's), every other launch
    off them."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(12)

    def rel(got, want):
        return max(_err(g, w) / float(w.float().abs().max())
                   for g, w in zip(got, want))

    for d in FLASH_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            ftol = FLASH_F32_TOL if f32 else FLASH_TOL
            btol = BWD_F32_TOL if f32 else BWD_TOL
            tc_route = dtype == torch.bfloat16 and d == 72
            errs = {}
            for kind, sq, sk, causal in (("dense", 70, 100, True),
                                         ("dense", 100, 100, False),
                                         ("segment", 100, 100, True),
                                         ("segment", 70, 90, False)):
                q, k, v, dout = (
                    torch.randn(2, s, h, d, generator=gen, device=dev)
                    .to(dtype) for s, h in ((sq, 8), (sk, 2), (sk, 2),
                                            (sq, 8)))
                K.reset_dispatch_stats()
                if kind == "dense":
                    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
                    got = FA.flash_attention_bwd(q, k, v, out, lse, dout,
                                                 causal=causal)
                    torch.cuda.synchronize()
                    ref, ref_lse = FA.flash_attention_ref(q, k, v,
                                                          causal=causal)
                    want = FA.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                      causal=causal)
                    count, tc = ("flash", "flash_bwd"), ("flash_tc",
                                                         "flash_bwd_tc")
                else:
                    segs = _seg_layout(torch, dev, 2, sq, sk,
                                       "packed" if sq == sk else "cu")
                    out, lse = FA.flash_attention_segments_fwd(
                        q, k, v, *segs, causal=causal)
                    got = FA.flash_attention_segments_bwd(
                        q, k, v, out, lse, dout, *segs, causal=causal)
                    torch.cuda.synchronize()
                    ref, ref_lse = FA.segment_attention_ref(
                        q, k, v, *segs, causal=causal)
                    want = FA.segment_attention_bwd_ref(
                        q, k, v, out, lse, dout, *segs, causal=causal)
                    count, tc = ("varlen", "varlen_bwd"), ("varlen_tc",
                                                           "varlen_bwd_tc")
                st = K.dispatch_stats()
                assert FA.tensor_core_route(q) is tc_route
                assert all(st[c] == 1 for c in count), st
                assert all(st[c] == int(tc_route) for c in tc), st
                seen = torch.isfinite(ref_lse)
                assert torch.equal(seen, torch.isfinite(lse)), \
                    "flash: rows that see a key differ"
                fe, le = _err(out, ref), _err(lse[seen], ref_lse[seen])
                be = rel(got, want)
                assert fe <= ftol and le <= LSE_TOL, (d, dtype, kind, fe, le)
                assert be <= btol, (d, dtype, kind, be)
                assert all(bool(torch.isfinite(g.float()).all())
                           for g in got)
                tag = f"{kind}_{'causal' if causal else 'full'}"
                errs[f"{tag}_fwd"], errs[f"{tag}_bwd"] = fe, be
            _say("flash_d", D=d, dtype=str(dtype).split(".")[-1],
                 route="tc" if tc_route else "cuda_cores", fwd_tol=ftol,
                 bwd_tol=btol,
                 **{k: f"{v:.3g}" for k, v in errs.items()})


def _dit_named(tree, prefix=""):
    """``(path, leaf)`` pairs of a DiT parameter tree, ``blocks.qkv_w``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _dit_named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _dit_refill(torch, params, gen):
    """Refill the zero leaves of a DiT tree (biases, ``mod_*``,
    ``final_*``) in place with normals of std 0.02 from ``gen``, a block
    at a time: with the reference's init the gates are zero and no
    output depends on attention."""
    from paddle_tpu_torch.models import llama as L
    for leaf in L._leaves(params):
        if bool(leaf.any()):
            continue
        for part in (leaf if leaf.ndim == 3 else (leaf,)):
            part.copy_(torch.randn(part.shape, generator=gen,
                                   device=leaf.device) * 0.02)


def phase_dit_parity(torch, dev):
    """One DiT at head dim 72 (hidden 144, 2 heads, 2 blocks) with
    refilled gates, one tree on the card and on the CPU, in float32 (the
    flash pair's CUDA-core route) and in bf16 (its tensor cores): the
    forward and ``loss_fn`` within the dtype's tolerance of the largest
    value, the step-1 gradients of each tensor's max, 3
    ``make_train_step`` losses, and a 5-step ``ddim_sample`` loop
    (``_ddim_over``, eta 1, guidance 4.0) from the same draws. float32
    holds ``DIT_PARITY_TOL`` (step losses ``TRAIN_LOSS_RTOL``), bf16
    ``DIT_BF16_TOL`` throughout; the card goes through ``flash`` and
    ``flash_bwd`` on the route of its dtype, never a plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        _dit_parity(torch, dev, dtype)


def _dit_parity(torch, dev, dtype):
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import dit as DIT
    from paddle_tpu_torch.models import llama as L
    f32 = dtype == torch.float32
    tol = DIT_PARITY_TOL if f32 else DIT_BF16_TOL
    step_tol = TRAIN_LOSS_RTOL if f32 else DIT_BF16_TOL
    cfg = DIT.dit_tiny(hidden_size=144, num_attention_heads=2, dtype=dtype)
    assert cfg.head_dim == 72
    cpu_params = DIT.init_params(cfg, seed=0, device="cpu")
    _dit_refill(torch, cpu_params, torch.Generator().manual_seed(1))
    card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
    rng = np.random.default_rng(2)
    shape = (4, cfg.in_channels, cfg.image_size, cfg.image_size)
    batch = (rng.standard_normal(shape).astype(np.float32),
             rng.integers(0, 1000, 4).astype(np.int32),
             rng.integers(0, cfg.num_classes + 1, 4).astype(np.int32),
             rng.standard_normal(shape).astype(np.float32))
    labels = np.array([1, 7], np.int32)
    x_t = rng.standard_normal((2, *shape[1:])).astype(np.float32)
    noise = rng.standard_normal((5, 2, *shape[1:])).astype(np.float32)
    res = {}
    for name, params in (("card", card_params), ("cpu", cpu_params)):
        K.reset_dispatch_stats()
        out = DIT.forward(params, *batch[:3], cfg).float().cpu()
        loss, grads = L.loss_and_grads(params, batch, cfg,
                                       loss=DIT.loss_fn)
        grads = {k: g.float().cpu() for k, g in _dit_named(grads)}
        state = DIT.adamw_init(params)
        step = DIT.make_train_step(cfg)
        losses = [float(step(params, state, batch)[2]) for _ in range(3)]
        sample = DIT._ddim_over(params, labels, cfg, x_t, noise, steps=5,
                                eta=1.0, guidance_scale=4.0).float().cpu()
        torch.cuda.synchronize()
        stats = K.dispatch_stats()
        _say("dit_parity", device=name, dtype=str(dtype).split(".")[-1],
             loss=float(loss), losses=losses,
             **{k: v for k, v in stats.items() if k.startswith("flash")})
        if name == "card":
            assert stats["flash"] > 0 and stats["flash_bwd"] > 0, stats
            if f32:
                assert stats["flash_tc"] == stats["flash_bwd_tc"] == 0, stats
            else:
                _tc_route_only(stats)
            assert all(v == 0 for k, v in stats.items()
                       if k.endswith("_ref")), stats
        res[name] = (out, float(loss), grads, losses, sample)
    (out, loss, grads, losses, sample), (w_out, w_loss, w_grads, w_losses,
                                         w_sample) = res["card"], res["cpu"]
    fwd_err = _err(out, w_out) / float(w_out.abs().max())
    loss_err = abs(loss - w_loss) / abs(w_loss)
    grad_errs = {k: _err(g, w_grads[k]) / float(w_grads[k].abs().max())
                 for k, g in grads.items()}
    worst = max(grad_errs, key=grad_errs.get)
    grad_err = grad_errs[worst]
    step_err = max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses))
    sample_err = _err(sample, w_sample) / float(w_sample.abs().max())
    _say("dit_parity", dtype=str(dtype).split(".")[-1],
         route="cuda_cores" if f32 else "tc", head_dim=cfg.head_dim,
         fwd_rel_err=fwd_err, loss_rel_err=loss_err, grad_rel_err=grad_err,
         grad_worst=worst, step_loss_rel_err=step_err,
         ddim_rel_err=sample_err, tol=tol, loss_rtol=step_tol)
    assert fwd_err <= tol and loss_err <= tol, (fwd_err, loss_err)
    assert grad_err <= tol, (worst, grad_err)
    assert step_err <= step_tol, (losses, w_losses)
    assert sample_err <= tol, sample_err
    assert bool(torch.isfinite(sample).all())


def dit_xl_setup(torch, dev):
    """DiT-XL/2 in bf16 with random weights from seed 0, zero leaves
    refilled (seed 1) so that the gates are not zero."""
    from paddle_tpu_torch.models import dit as DIT
    cfg = DIT.dit_xl_2()
    params = DIT.init_params(cfg, seed=0, device=dev)
    _dit_refill(torch, params, torch.Generator(device=dev).manual_seed(1))
    return cfg, params


def dit_train_setup(torch, dev):
    """The DiT training main path's ``(cfg, params, opt_state, step,
    batch)``: ``dit_xl_setup``'s model (remat on), float32 AdamW moments,
    lr 1e-4, and one batch of ``DIT_TRAIN_BATCH`` latents, timesteps,
    labels and noise from a generator on ``dev`` seeded with 3."""
    from paddle_tpu_torch.models import dit as DIT
    cfg, params = dit_xl_setup(torch, dev)
    assert cfg.remat
    state = DIT.adamw_init(params)
    step = DIT.make_train_step(cfg, lr=1e-4)
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (DIT_TRAIN_BATCH, cfg.in_channels, cfg.image_size,
             cfg.image_size)
    batch = (torch.randn(shape, generator=g, device=dev),
             torch.randint(0, 1000, (DIT_TRAIN_BATCH,), generator=g,
                           device=dev),
             torch.randint(0, cfg.num_classes, (DIT_TRAIN_BATCH,),
                           generator=g, device=dev),
             torch.randn(shape, generator=g, device=dev))
    return cfg, params, state, step, batch


def dit_labels(torch, dev, cfg):
    """The sampling main path's ``DIT_LABELS`` class labels."""
    return torch.arange(DIT_LABELS, device=dev) * 97 % cfg.num_classes


def phase_dit_sample(torch, dev, card):
    """DiT sampling at full width: DiT-XL/2, 28 blocks, bf16,
    ``DIT_LABELS`` labels under classifier-free guidance ``DIT_GUIDANCE``
    (twice as many rows a forward), ``DIT_STEPS`` DDIM steps at eta 0:
    one untimed call, then one timed; every attention through the flash
    kernel's tensor-core route (bf16 at head dim 72), no plain version."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import dit as DIT
    t0 = time.perf_counter()
    cfg, params = dit_xl_setup(torch, dev)
    torch.cuda.synchronize()
    _say("dit_sample", layers=cfg.num_hidden_layers,
         params=DIT.count_params(cfg), head_dim=cfg.head_dim,
         tokens=cfg.num_patches, init_s=round(time.perf_counter() - t0, 2))
    labels = dit_labels(torch, dev, cfg)

    def sample():
        return DIT.ddim_sample(params, labels, cfg, steps=DIT_STEPS,
                               guidance_scale=DIT_GUIDANCE, generator=0)

    sample()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    t0 = time.perf_counter()
    x = sample()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.dispatch_stats()
    _say("dit_sample", card=repr(card), labels=DIT_LABELS,
         rows_a_forward=2 * DIT_LABELS, steps=DIT_STEPS, eta=0.0,
         guidance=DIT_GUIDANCE, ms_a_step=wall * 1e3 / DIT_STEPS,
         images_per_s=DIT_LABELS / wall, sample_s=wall,
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2),
         x_std=float(x.std()),
         **{k: v for k, v in launches.items() if v})
    assert x.shape == (DIT_LABELS, cfg.in_channels, cfg.image_size,
                       cfg.image_size)
    assert bool(torch.isfinite(x).all()), "dit_sample: non-finite samples"
    assert launches["flash"] == cfg.num_hidden_layers * DIT_STEPS, launches
    assert launches["flash_tc"] == launches["flash"], launches
    assert all(v == 0 for k, v in launches.items() if k.endswith("_ref"))
    del params
    return launches


def phase_dit_train(torch, dev, card):
    """DiT training at full width: DiT-XL/2, 28 blocks, bf16, remat,
    float32 AdamW moments, lr 1e-4, ``DIT_TRAIN_BATCH`` latents of 4 x 32
    x 32 (256 tokens each) with timesteps, labels and noise from a seeded
    generator, one batch: 2 untimed and 5 timed steps. MFU is 6 N tokens
    a step over 989 TFLOP/s (N = ``count_params``); attention's own
    operations are not credited. The flash forward launches twice a block
    (remat), the backward once, both on the tensor-core route."""
    import math

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import dit as DIT
    t0 = time.perf_counter()
    cfg, params, state, step, batch = dit_train_setup(torch, dev)
    torch.cuda.synchronize()
    n = DIT.count_params(cfg)
    tokens = DIT_TRAIN_BATCH * cfg.num_patches
    _say("dit_train", layers=cfg.num_hidden_layers, params=n,
         batch=f"{DIT_TRAIN_BATCH}x{cfg.num_patches}", remat=cfg.remat,
         init_s=round(time.perf_counter() - t0, 2))
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_dispatch_stats()
    losses, times = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        _, _, loss = step(params, state, batch)
        losses.append(float(loss))        # waits for the step's end
        times.append(time.perf_counter() - t0)
    launches = K.dispatch_stats()
    timed = sorted(times[2:])
    step_s = timed[len(timed) // 2]
    _say("dit_train", card=repr(card), losses=losses,
         step_ms=[t * 1e3 for t in times[2:]], median_step_ms=step_s * 1e3,
         images_per_s=DIT_TRAIN_BATCH / step_s, tokens_per_s=tokens / step_s,
         mfu=6.0 * n * tokens / step_s / H100_BF16_FLOPS,
         mfu_note="6N_tokens_attention_not_credited",
         peak_mem_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 2),
         flash_a_step=launches["flash"] / len(times),
         flash_bwd_a_step=launches["flash_bwd"] / len(times))
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    L_ = cfg.num_hidden_layers
    assert launches["flash"] == 2 * L_ * len(times), launches
    assert launches["flash_bwd"] == L_ * len(times), launches
    _tc_route_only(launches)
    assert all(v == 0 for k, v in launches.items() if k.endswith("_ref"))
    del params, state
    return launches


def _device_ms(fn, calls):
    """Device ms a call of ``fn``: ``torch.profiler``'s device time of
    every kernel that ``calls`` back-to-back calls launch, over
    ``calls``. Unlike ``_time_ms`` it does not count the card's waits for
    the host between short launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    assert us > 0, "the profiler saw no kernel"
    return us / calls / 1e3


def _interleaved_ms(fns, reps=DIT_TIMING_REPS):
    """``{name: (median, min, max)}`` ms a call of each ``(timer, fn,
    iters)`` in ``fns`` (``timer`` is ``_device_ms`` or ``_time_ms``),
    timed in turns ``reps`` times, so that a drift of the card or its
    host falls on every entry alike."""
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, (timer, fn, iters) in fns.items():
            times[name].append(timer(fn, iters))
    return {name: (sorted(v)[len(v) // 2], min(v), max(v))
            for name, v in times.items()}


def phase_dit_kernels(torch, dev):
    """The two kernel records at DiT-XL/2's shapes, bf16, not causal, on
    the tensor-core route: the forward at the sampling shape ``[16, 256,
    16, 72]`` and the backward at the training shape ``[32, 256, 16,
    72]``, each held to its plain version, then timed in turns
    (``_interleaved_ms``, the median of ``DIT_TIMING_REPS``) beside
    ``scaled_dot_product_attention`` (its backward by autograd), the plain
    version and, at the same shape in float32, the CUDA-core route (held
    to its plain version too; a reading, not a record). The records' ``ms``
    and ``library_ms`` are device times (``_device_ms``); the lines give
    beside them each one's back-to-back wrapper time (``_time_ms``),
    which the host's enqueue paces at these shapes. Bounds: the
    forward's 4 B H S^2 D operations, the backward's five products (q k^T,
    dout v^T, dv, dq, dk) of 2 B H S^2 D each, at the bf16 peak, against
    each input read once and each output written once. Then each kernel
    at batches of ``DIT_WAVE_BATCHES``, a reading of its time against the
    waves of blocks it launches (``_dit_waves``)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(13)
    H, S, D = 16, 256, 72
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs = []
    for kind, b in (("fwd", 2 * DIT_LABELS), ("bwd", DIT_TRAIN_BATCH)):
        q, k, v, dout = (torch.randn(b, S, H, D, generator=gen, device=dev)
                         .bfloat16() for _ in range(4))
        K.reset_dispatch_stats()
        out, lse = FA.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        _tc_launches(K, "flash", True)
        ref, ref_lse = FA.flash_attention_ref(q, k, v)
        err = _err(out, ref)
        lse_err = _err(lse, ref_lse)
        assert err <= FLASH_TOL and lse_err <= LSE_TOL, (err, lse_err)
        leaves = [x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v)]
        # the CUDA-core route at the same shape: float32 inputs
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
        elem = 2 * b * S * H * D          # bytes of one bf16 [b, S, H, D]
        if kind == "fwd":
            K.reset_dispatch_stats()
            o32, l32 = FA.flash_attention_fwd(q32, k32, v32)
            torch.cuda.synchronize()
            _tc_launches(K, "flash", False)
            cc_err = _err(o32, FA.flash_attention_ref(q32, k32, v32)[0])
            assert cc_err <= FLASH_F32_TOL, cc_err

            def kernel():
                return FA.flash_attention_fwd(q, k, v)

            def library():
                return sdpa(*leaves)

            with torch.no_grad():
                times = _interleaved_ms({
                    "kernel": (_device_ms, kernel, 20),
                    "library": (_device_ms, library, 20),
                    "kernel_wrapper": (_time_ms, kernel, 20),
                    "library_wrapper": (_time_ms, library, 20),
                    "cuda_cores": (_time_ms, lambda: FA.flash_attention_fwd(
                        q32, k32, v32), 10),
                    "plain": (_time_ms, lambda: FA.flash_attention_ref(
                        q, k, v), 5)})
            flops = 4.0 * b * H * S * S * D
            nbytes = 4 * elem + 4 * b * H * S         # q k v out, lse
        else:
            K.reset_dispatch_stats()
            got = FA.flash_attention_bwd(q, k, v, out, lse, dout)
            torch.cuda.synchronize()
            _tc_launches(K, "flash_bwd", True)
            want = FA.flash_attention_bwd_ref(q, k, v, out, lse, dout)
            err = max(_err(a, w) for a, w in zip(got, want))
            rel = max(_err(a, w) / float(w.float().abs().max())
                      for a, w in zip(got, want))
            assert rel <= BWD_TOL, rel
            o32, l32 = FA.flash_attention_fwd(q32, k32, v32)
            K.reset_dispatch_stats()
            got32 = FA.flash_attention_bwd(q32, k32, v32, o32, l32, do32)
            torch.cuda.synchronize()
            _tc_launches(K, "flash_bwd", False)
            want32 = FA.flash_attention_bwd_ref(q32, k32, v32, o32, l32, do32)
            cc_err = max(_err(a, w) / float(w.abs().max())
                         for a, w in zip(got32, want32))
            assert cc_err <= BWD_F32_TOL, cc_err
            del got32, want32
            lib_out = sdpa(*leaves)
            lib_dout = dout.transpose(1, 2).contiguous()

            def kernel():
                return FA.flash_attention_bwd(q, k, v, out, lse, dout)

            def library():
                return torch.autograd.grad(lib_out, leaves, lib_dout,
                                           retain_graph=True)

            times = _interleaved_ms({
                "kernel": (_device_ms, kernel, 10),
                "library": (_device_ms, library, 10),
                "kernel_wrapper": (_time_ms, kernel, 10),
                "library_wrapper": (_time_ms, library, 10),
                "cuda_cores": (_time_ms, lambda: FA.flash_attention_bwd(
                    q32, k32, v32, o32, l32, do32), 5),
                "plain": (_time_ms, lambda: FA.flash_attention_bwd_ref(
                    q, k, v, out, lse, dout), 3)})
            flops = 5 * 2.0 * b * H * S * S * D
            # q, k, v, out, dout, lse read; dq, dk, dv written
            nbytes = 8 * elem + 4 * b * H * S
        ms, library_ms, plain_ms = (times[n][0] for n in
                                    ("kernel", "library", "plain"))
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        _say("kernels", kernel=f"flash_{kind}", shape=f"B{b}xS{S}xH{H}xD{D}",
             dtype="bfloat16", causal=False, route="tc",
             max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound, share_of_bound=bound / ms,
             tflops=flops / ms / 1e9, vs_library=ms / library_ms,
             timing="device", wrapper_ms=times["kernel_wrapper"][0],
             library_wrapper_ms=times["library_wrapper"][0],
             reps=DIT_TIMING_REPS,
             **{f"{n}_min_max": f"{lo:.4f}/{hi:.4f}"
                for n, (_, lo, hi) in times.items()})
        _say("kernels", kernel=f"flash_{kind}", shape=f"B{b}xS{S}xH{H}xD{D}",
             dtype="float32", causal=False, route="cuda_cores",
             err_vs_plain=cc_err, ms=times["cuda_cores"][0],
             tc_speedup=times["cuda_cores"][0] / ms)
        recs.append({"name": f"flash_{kind}_d72", "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/flash_{kind}.cu",
                     "replaces": "paddle_tpu/kernels/flash_attention.py:"
                     + ("40" if kind == "fwd" else "146"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "library_ms": library_ms})
        del q, k, v, dout, out, lse, ref, leaves, q32, k32, v32, do32, o32
        torch.cuda.empty_cache()
        _dit_waves(torch, dev, FA, kind, H, S, D)
    return recs


def _dit_waves(torch, dev, FA, kind, H, S, D):
    """The bf16 kernel ``kind`` at ``[b, S, H, D]`` for each b of
    ``DIT_WAVE_BATCHES``, beside the waves of blocks it launches: B H
    ceil(S / 128) blocks in each kernel, one resident on each of the
    card's SMs at a time (registers and shared memory). Device ms
    (``_device_ms``) that grow by more than the bytes a wave moves are a
    latency each block pays; back-to-back wrapper ms (``_time_ms``) that
    do not grow with the waves are the host's enqueue."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms, wrapper = {}, {}
    for b in DIT_WAVE_BATCHES:
        q, k, v, dout = (torch.randn(b, S, H, D, device=dev).bfloat16()
                         for _ in range(4))
        out, lse = FA.flash_attention_fwd(q, k, v)

        def call():
            if kind == "fwd":
                return FA.flash_attention_fwd(q, k, v)
            return FA.flash_attention_bwd(q, k, v, out, lse, dout)

        ms[b], wrapper[b] = _device_ms(call, 20), _time_ms(call, 20)
    waves = {b: b * H * -(-S // 128) / sms for b in ms}
    lo, hi = min(ms), max(ms)
    _say("kernels", kernel=f"flash_{kind}", reading="waves", sms=sms,
         **{f"B{b}": f"{ms[b]:.4f}ms/{wrapper[b]:.4f}wrapper_ms/"
            f"{waves[b]:.2f}waves" for b in ms},
         ms_a_wave=(ms[hi] - ms[lo]) / (waves[hi] - waves[lo]),
         # a block's share of the bytes: 4 (forward) or 8 (backward)
         # [128, D] bf16 tiles
         bytes_ms_a_wave=(4 if kind == "fwd" else 8) * 2 * 128 * D * sms
         / H100_BYTES_PER_S * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="serving main-path depth (default: all 32 "
                    "layers; moe_main takes at most its 28)")
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
        for kernel, regs, stores, loads in _ptxas_entries(log):
            if kernel.startswith(("flash", "paged", "rms_bwd")):
                _say("build", lib=name, kernel=kernel, registers=regs,
                     spill_store_bytes=stores, spill_load_bytes=loads)

    cfg = L.llama_3_8b(num_hidden_layers=args.layers)
    requests = _main_requests(cfg.vocab_size)
    maxp = 2048 // 16
    # decode lengths of the first wave, half-way through its generation
    main_lengths, wave2 = decode_wave_lengths(requests)
    flash = phase_flash(torch, dev, 8, 512)
    paged = phase_paged(torch, dev, main_lengths, wave2, maxp)
    paged_int8 = phase_paged_int8(torch, dev, main_lengths, wave2,
                                  2048 // 32, 32)
    flash_bwd = phase_flash_bwd(torch, dev, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.empty_cache()
    phase_layer_grads(torch, dev)
    torch.cuda.empty_cache()
    phase_layer_grads(torch, dev, packed=True)
    torch.cuda.empty_cache()
    seg_fwd, seg_bwd = phase_flash_seg(torch, dev)
    torch.cuda.empty_cache()
    phase_flash_d(torch, dev)
    dit_fwd, dit_bwd = phase_dit_kernels(torch, dev)
    torch.cuda.empty_cache()
    rms_fwd, rms_bwd = phase_rms(torch, dev)
    torch.cuda.empty_cache()
    phase_parity(torch, dev)
    phase_quant_parity(torch, dev)
    phase_train_parity(torch, dev)
    phase_train_packed_parity(torch, dev)
    phase_eager_parity(torch, dev)
    phase_surface(torch, dev)
    phase_eager_recipe_parity(torch, dev)
    phase_generate_parity(torch, dev)
    phase_moe_parity(torch, dev)
    phase_dit_parity(torch, dev)
    t0 = time.perf_counter()
    params = L.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in L._leaves(params))
    _say("main", layers=args.layers, params_b=round(nparams / 1e9, 3),
         init_s=round(time.perf_counter() - t0, 2))
    phase_no_sync(torch, dev, cfg, params)
    torch.cuda.empty_cache()
    phase_prefix_plane(torch, dev, cfg, params, smi)
    torch.cuda.empty_cache()
    launches, main_tokens = phase_main(torch, dev, cfg, params, requests, smi,
                                       uniform=True)
    torch.cuda.empty_cache()
    kvq_launches, _ = phase_main(torch, dev, cfg, params, requests, smi,
                                 phase="main_kvq", kv_quant=True,
                                 reference=main_tokens)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qparams = L.quantize_weights(params)        # int8 weight-only
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _say("main_wq", weights="int8", quantize_s=round(
        time.perf_counter() - t0, 2))
    phase_main(torch, dev, cfg, qparams, requests, smi, phase="main_wq",
               kv_quant=True, reference=main_tokens)
    del qparams
    torch.cuda.empty_cache()
    phase_generate(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_moe_main(torch, dev, args.layers, smi)
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, dev, smi)
    torch.cuda.empty_cache()
    packed_launches = phase_train_packed(torch, dev, smi)
    torch.cuda.empty_cache()
    eager_launches, eager_ms = phase_eager_train(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_eager_recipe(torch, dev, smi, eager_ms)
    torch.cuda.empty_cache()
    phase_moe_train(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_guard(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_remat_attn(torch, dev, smi)
    torch.cuda.empty_cache()
    dit_sample_launches = phase_dit_sample(torch, dev, smi)
    torch.cuda.empty_cache()
    dit_train_launches = phase_dit_train(torch, dev, smi)
    # launches on each kernel's main path: serving for the forward and
    # the decode kernel, int8-KV serving for its int8 arm, dense training
    # for the backward, packed training for the segment kernels, eager
    # training for the RMSNorm kernels, DiT sampling and training for the
    # flash pair's tensor-core route at head dim 72
    flash["launches"] = launches["flash"]
    paged["launches"] = launches["paged"]
    paged_int8["launches"] = kvq_launches["paged_quant"]
    flash_bwd["launches"] = train_launches["flash_bwd"]
    seg_fwd["launches"] = packed_launches["varlen"]
    seg_bwd["launches"] = packed_launches["varlen_bwd"]
    rms_fwd["launches"] = eager_launches["rms"]
    rms_bwd["launches"] = eager_launches["rms_bwd"]
    dit_fwd["launches"] = dit_sample_launches["flash"]
    dit_bwd["launches"] = dit_train_launches["flash_bwd"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {k: rec[k] for k in keys}
        for rec in (flash, paged, paged_int8, flash_bwd, seg_fwd,
                    seg_bwd, rms_fwd, rms_bwd, dit_fwd, dit_bwd)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
