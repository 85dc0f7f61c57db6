"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a CUDA device every test here skips (decided in
a fixture, never at import). On a machine with an H100, from the repo
root:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: bfloat16 outputs ``2e-2`` (one bf16 rounding of values of
size ~1), float32 ``1e-4`` (summation order and the fast exponential).
"""
import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import paged_attention as PA

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("sq,sk,causal", [(48, 48, True), (33, 70, True),
                                          (70, 33, True), (40, 40, False)])
def test_flash_kernel_matches_plain(dev, dtype, tol, sq, sk, causal):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, sq, 8, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, sk, 2, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, sk, 2, 64, generator=g, device=dev).to(dtype)
    K.reset_dispatch_stats()
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.dispatch_stats()["flash"] == 1
    ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_paged_kernel_matches_plain(dev, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(1)
    B, NH, KVH, D, PS, P, MAXP = 5, 8, 2, 64, 16, 40, 6
    q = torch.randn(B, NH, D, generator=g, device=dev).to(dtype)
    kp = torch.randn(P, KVH, PS, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(P, KVH, PS, D, generator=g, device=dev).to(dtype)
    lengths = [0, 1, 17, 64, MAXP * PS]
    bt = torch.full((B, MAXP), P, dtype=torch.int32)
    bt[:, -1] = -3                                 # garbage past the pages
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(2))
    nxt = 0
    for b, n in enumerate(lengths):
        used = -(-n // PS)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
    bt = bt.to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = PA.ragged_paged_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    ref = PA.paged_attention_ref(q, kp, vp, bt, ln)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert torch.all(out[0] == 0)


def test_kernels_raise_instead_of_falling_back(dev):
    q = torch.zeros(1, 8, 2, 24, device=dev)       # head_dim 24: no kernel
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        PA.ragged_paged_attention(
            torch.zeros(1, 2, 64, device=dev),
            torch.zeros(4, 2, 16, 64, device=dev),
            torch.zeros(4, 2, 16, 64, device=dev),
            torch.zeros(1, 2, dtype=torch.int64, device=dev),   # not int32
            torch.ones(1, dtype=torch.int32, device=dev))
