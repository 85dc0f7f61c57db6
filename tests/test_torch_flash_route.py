"""The dense flash kernels' two routes, on the CPU.

``flash_attention.tensor_core_route`` says which kernels a CUDA launch
runs: bfloat16 at head dim 64 or 128 takes the tensor-core kernels
(``wgmma``), float32 and every other head dim that ``supported`` takes
the float32 CUDA-core kernels. The C entries make the same choice
(``tc_route`` in ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``); the
counters ``flash_tc`` / ``flash_bwd_tc`` count the launches that took
it. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import flash_attention as FA

CSRC = Path(FA.__file__).resolve().parent.parent / "csrc"


def _q(dtype, d, h=4, kvh=2, s=8):
    return (torch.zeros(1, s, h, d, dtype=dtype),
            torch.zeros(1, s, kvh, d, dtype=dtype),
            torch.zeros(1, s, kvh, d, dtype=dtype))


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.bfloat16, 16, False), (torch.bfloat16, 48, False),
    (torch.bfloat16, 112, False)])
def test_route_takes_tensor_cores_for_bf16_at_64_and_128(dtype, d, want):
    q, k, v = _q(dtype, d)
    assert FA.supported(q, k, v) and FA.supported_bwd(q, k, v)
    assert FA.tensor_core_route(q) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_supported_keeps_every_head_dim(dtype):
    """The tensor-core route narrows nothing: every multiple of 16 up to
    128 is still taken, in float32 and bfloat16 alike."""
    for d in range(16, 129, 16):
        assert FA.supported(*_q(dtype, d)), d
    for d in (8, 24, 144):
        assert not FA.supported(*_q(dtype, d)), d


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd.cu"])
def test_c_entries_choose_the_same_route(source):
    """Each C entry's ``tc_route`` is the Python predicate: dtype code 1
    (``_DTYPES[torch.bfloat16]``) at D 64 or 128."""
    text = (CSRC / source).read_text()
    body = re.search(r"bool tc_route\(int dtype, int D\) \{([^}]*)\}", text)
    assert body is not None
    assert body.group(1).split() == \
        "return dtype == 1 && (D == 64 || D == 128);".split()
    assert FA._DTYPES[torch.bfloat16] == 1
    assert "if (tc_route(dtype, D))" in text


def test_route_counters_start_at_zero_and_reset():
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["flash_tc"] == 0 and st["flash_bwd_tc"] == 0
    K._DISPATCH_STATS["flash_tc"] = 3
    K._DISPATCH_STATS["flash_bwd_tc"] = 2
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["flash_tc"] == 0 and st["flash_bwd_tc"] == 0


def test_cpu_tensors_count_the_plain_version_not_a_route():
    """A CPU tensor takes the plain version (``flash_ref`` /
    ``flash_bwd_ref``) on either route's dtype and launches nothing."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, h, 64, generator=g).bfloat16()
               for h in (4, 2, 2))
    K.reset_dispatch_stats()
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    FA.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q),
                           causal=True)
    st = K.dispatch_stats()
    assert st["flash_ref"] == 1 and st["flash_bwd_ref"] == 1
    assert st["flash"] == st["flash_tc"] == 0
    assert st["flash_bwd"] == st["flash_bwd_tc"] == 0
