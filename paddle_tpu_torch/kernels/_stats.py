"""Launch counters of the port's kernels (mirror of the reference's
``_DISPATCH_STATS``, ``paddle_tpu/kernels/__init__.py:50``).

``flash`` / ``flash_bwd`` / ``varlen`` / ``varlen_bwd`` / ``paged`` /
``paged_quant`` / ``rms`` / ``rms_bwd`` count CUDA kernel launches, one
per wrapper call that launches, added by the wrapper right where it
launches (a backward's dq / dkv pair, and the RMSNorm backward's row and
column passes, count as one; ``flash_tc`` / ``flash_bwd_tc`` count the
dense launches among ``flash`` / ``flash_bwd`` that took the tensor-core
route, ``flash_attention.tensor_core_route``, and ``flash_d72`` /
``flash_bwd_d72`` those of them at head dim 72, DiT's heads;
``varlen*`` are the
segment-masked, sequence-packed kernels, the reference's names, and
``varlen_tc`` / ``varlen_bwd_tc`` count those of their launches that took
the same tensor-core route; ``paged_quant`` is the
decode kernel's int8 arm, ``paged_mixed`` counts the launches among
``paged`` whose pages are of another type than q, and ``paged_d256`` /
``paged_g32`` (``paged_quant_d256`` / ``paged_quant_g32``) those among
``paged`` (``paged_quant``) at head dim 256 and at a query-head group of
32); ``flash_ref`` / ``flash_bwd_ref`` /
``varlen_ref`` / ``varlen_bwd_ref`` / ``paged_ref`` / ``paged_quant_ref``
/ ``rms_ref`` / ``rms_bwd_ref`` count calls that took the plain PyTorch
version because the tensors lay on the CPU. ``fused_ce`` /
``fused_ce_fallback`` count losses that took the blockwise cross entropy
or, for a shape it does not take, the materialising one (plain PyTorch
on every device, as in the reference). ``rms_fallback`` counts RMSNorm
calls on CPU tensors whose weight is not ``[x.shape[-1]]``: the
dispatcher gives them the plain math, the reference's one shape rule (a
CUDA tensor launches or raises there). Plain integers, so
a run can show which path it took."""

DISPATCH_STATS = {"flash": 0, "flash_tc": 0, "flash_d72": 0, "flash_ref": 0,
                  "flash_bwd": 0, "flash_bwd_tc": 0, "flash_bwd_d72": 0,
                  "flash_bwd_ref": 0,
                  "varlen": 0, "varlen_tc": 0, "varlen_ref": 0,
                  "varlen_bwd": 0, "varlen_bwd_tc": 0, "varlen_bwd_ref": 0,
                  "paged": 0, "paged_mixed": 0, "paged_d256": 0,
                  "paged_g32": 0, "paged_ref": 0,
                  "paged_quant": 0, "paged_quant_d256": 0,
                  "paged_quant_g32": 0, "paged_quant_ref": 0,
                  "rms": 0, "rms_ref": 0, "rms_bwd": 0, "rms_bwd_ref": 0,
                  "rms_fallback": 0,
                  "fused_ce": 0, "fused_ce_fallback": 0}
