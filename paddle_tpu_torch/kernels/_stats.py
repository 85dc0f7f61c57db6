"""Launch counters of the port's kernels (mirror of the reference's
``_DISPATCH_STATS``, ``paddle_tpu/kernels/__init__.py:50``).

``flash`` / ``paged`` count CUDA kernel launches, one per launch, added
by the wrapper right where it launches; ``flash_ref`` / ``paged_ref``
count calls that took the plain PyTorch version because the tensors lay
on the CPU. Plain integers, so a run can show which path it took."""

DISPATCH_STATS = {"flash": 0, "flash_ref": 0, "paged": 0, "paged_ref": 0}
