"""The flash kernels' two routes, dense and segment-masked, on the CPU.

``flash_attention.tensor_core_route`` says which kernels a CUDA launch
runs: bfloat16 or float16 at head dim 64, 72 or 128 takes the
tensor-core kernels (``wgmma`` at the input type), float32 and every
other head dim that ``supported`` takes (``D % 8 == 0``, 8 to 256) the
float32 CUDA-core kernels. The C entries
make the same choice (``tc_route`` in ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, in the dense and the segment entries), and each
source's ``dispatch_tc`` has one kernel instance for every head dim its
``tc_route`` takes; the counters ``flash_tc`` /
``flash_bwd_tc`` and ``varlen_tc`` / ``varlen_bwd_tc`` count the
launches that took it. ``seg_tiles`` names each route's segment tiles,
which the C entries check. The kernels themselves run only on the card
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
    (torch.bfloat16, 112, False), (torch.bfloat16, 72, True),
    (torch.bfloat16, 256, False), (torch.float32, 72, False),
    (torch.bfloat16, 80, False), (torch.float16, 64, True),
    (torch.float16, 72, True), (torch.float16, 128, True),
    (torch.float16, 40, False), (torch.float16, 256, False)])
def test_route_takes_tensor_cores_for_bf16_at_64_and_128(dtype, d, want):
    """bf16 and float16 at 64 and 128, and at DiT-XL/2's 72, take the
    tensor cores; float32 at any D, and a 2-byte type at any other D, do
    not."""
    q, k, v = _q(dtype, d)
    assert FA.supported(q, k, v) and FA.supported_bwd(q, k, v)
    assert FA.tensor_core_route(q) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_supported_keeps_every_head_dim(dtype):
    """The tensor-core route narrows nothing: every multiple of 8 from 8
    to 256 is taken, in float32, bfloat16 and float16 alike; 4, 12 and
    264 are not."""
    for d in range(8, 257, 8):
        assert FA.supported(*_q(dtype, d)), d
    for d in (24, 72, 256):
        assert FA.supported(*_q(dtype, d)), d
    for d in (4, 12, 264):
        assert not FA.supported(*_q(dtype, d)), d


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd.cu"])
def test_c_entries_choose_the_same_route(source):
    """Each C entry's ``tc_route`` is the Python predicate: dtype codes 1
    and 2 (``_DTYPES[torch.bfloat16]``, ``_DTYPES[torch.float16]``) at D
    64, 72 or 128."""
    text = (CSRC / source).read_text()
    body = re.search(r"bool tc_route\(int dtype, int D\) \{([^}]*)\}", text)
    assert body is not None
    assert body.group(1).split() == (
        "return (dtype == 1 || dtype == 2) && (D == 64 || D == 72 || D == "
        "128);").split()
    assert FA._DTYPES[torch.bfloat16] == 1
    assert FA._DTYPES[torch.float16] == 2
    assert set(FA.TC_DTYPES) == {torch.bfloat16, torch.float16}
    assert "if (tc_route(dtype, D))" in text


def _tc_route_dims(source):
    """The head dims ``tc_route`` in ``source`` takes."""
    text = (CSRC / source).read_text()
    body = re.search(r"bool tc_route\(int dtype, int D\) \{([^}]*)\}", text)
    return {int(d) for d in re.findall(r"D == (\d+)", body.group(1))}


def _dispatch_tc_instances(source):
    """``{D: instance}`` of ``dispatch_tc`` in ``source``: each ``case D:``
    and the ``launch_tc<D, T>`` it returns (one instance a type ``T``)."""
    text = (CSRC / source).read_text()
    start = text.index("cudaError_t dispatch_tc(")
    body = text[start:text.index("\n}\n", start)]
    return {int(d): int(inst) for d, inst in re.findall(
        r"case (\d+):\s*return launch_tc<(\d+), T>", body)}


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd.cu"])
def test_dispatch_tc_has_an_instance_for_every_route_dim(source):
    """Every head dim that a source's ``tc_route`` sends to the tensor
    cores has its own ``dispatch_tc`` case, launching the instance of
    that D (``launch_tc<D>``), and no other D has one: a D the route takes
    without an instance would reach no kernel, and an instance the route
    never takes is dead code. The set is ``TC_DIMS``, the Python
    mirror's."""
    dims = _tc_route_dims(source)
    assert dims == set(FA.TC_DIMS) == {64, 72, 128}
    instances = _dispatch_tc_instances(source)
    assert set(instances) == dims
    assert all(d == inst for d, inst in instances.items())
    for d in dims:
        for dtype in FA.TC_DTYPES:
            assert FA.tensor_core_route(_q(dtype, d)[0])
    # the type-dispatching entry: dtype 2 to the __half instances, else
    # the bfloat16 ones
    text = (CSRC / source).read_text()
    start = text.index("cudaError_t dispatch_tc_type(")
    body = text[start:text.index("\n}\n", start)]
    assert "if (dtype == 2)" in body and "dispatch_tc<__half>" in body
    assert "dispatch_tc<__nv_bfloat16>" in body


def _entry_body(source, name):
    """The text of C entry ``name`` in ``source``, up to the next
    top-level closing brace."""
    text = (CSRC / source).read_text()
    start = text.index(f'extern "C" int {name}(')
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("source,entry", [
    ("flash_fwd.cu", "flash_fwd"), ("flash_fwd.cu", "flash_fwd_seg"),
    ("flash_bwd.cu", "flash_bwd"), ("flash_bwd.cu", "flash_bwd_seg")])
def test_every_entry_takes_the_route(source, entry):
    """Each C entry, dense and segment-masked, chooses its route by
    ``tc_route`` before the CUDA-core dispatch."""
    body = _entry_body(source, entry)
    assert "if (tc_route(dtype, D))" in body
    assert body.index("if (tc_route(dtype, D))") < body.index(
        "return dispatch(")


def _constant(source, name):
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64),
    (torch.float32, 128), (torch.bfloat16, 32), (torch.bfloat16, 96),
    (torch.bfloat16, 72), (torch.float32, 72)])
def test_seg_tiles_name_the_kernels_tiles(dtype, d):
    """``seg_tiles`` gives the tiles the segment kernels of the route run:
    the tensor-core forward's TC_BM x TC_BN and the backward's TC_TILE x
    TC_TILE, or the CUDA-core BM x BN."""
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    fwd, bwd = FA.seg_tiles(q), FA.seg_tiles(q, backward=True)
    if FA.tensor_core_route(q):
        assert fwd == (_constant("flash_fwd.cu", "TC_BM"),
                       _constant("flash_fwd.cu", "TC_BN")) == (128, 128)
        tile = _constant("flash_bwd.cu", "TC_TILE")
        assert bwd == (tile, tile) == (64, 64)
    else:
        for source, tiles in (("flash_fwd.cu", fwd), ("flash_bwd.cu", bwd)):
            assert tiles == (_constant(source, "BM"), _constant(source, "BN"))
            assert tiles == (FA.SEG_BLOCK, FA.SEG_BLOCK)


def _packed_layout(s, lens):
    """int32 ``(seg, pos)`` ``[len(lens), s]``: each row packed full with
    documents of the lengths in ``lens[row]``, in order."""
    seg = torch.zeros((len(lens), s), dtype=torch.int32)
    pos = torch.zeros((len(lens), s), dtype=torch.int32)
    for r, row in enumerate(lens):
        assert sum(row) == s
        at = 0
        for i, n in enumerate(row):
            seg[r, at:at + n] = i
            pos[r, at:at + n] = torch.arange(n, dtype=torch.int32)
            at += n
    return seg, pos


def _empty_tile_pairs(seg, pos, tq, tk, causal):
    """Tile pairs at ``tq x tk`` that hold no visible (row, key) pair,
    counted element by element from the mask."""
    mask = FA._seg_mask(seg, seg, pos, pos, causal)
    b, s = seg.shape
    nq, nk = -(-s // tq), -(-s // tk)
    pad = torch.zeros(b, nq * tq, nk * tk, dtype=torch.bool)
    pad[:, :s, :s] = mask
    seen = pad.reshape(b, nq, tq, nk, tk).any(dim=4).any(dim=2)
    return int((~seen).sum()), b * nq * nk


@pytest.mark.parametrize("causal", [False, True])
def test_d72_segment_tiles_are_the_tensor_cores(causal):
    """bf16 at D 72 takes the tensor-core route in the segment entries
    too: ``seg_tiles`` gives that route's tiles (128 x 128 forward, 64 x
    64 backward), the stats the wrapper builds carry them, and at those
    tiles ``count_skipped_blocks`` skips no tile pair that holds a
    visible pair and, on rows packed full with no causal mask (where the
    predicate is exact), every pair that holds none: the tiles the
    kernels run."""
    q = torch.zeros(2, 300, 4, 72, dtype=torch.bfloat16)
    assert FA.tensor_core_route(q)
    fwd, bwd = FA.seg_tiles(q), FA.seg_tiles(q, backward=True)
    assert fwd == (_constant("flash_fwd.cu", "TC_BM"),
                   _constant("flash_fwd.cu", "TC_BN")) == (128, 128)
    tile = _constant("flash_bwd.cu", "TC_TILE")
    assert bwd == (tile, tile) == (64, 64)
    seg, pos = _packed_layout(300, [[40, 150, 110], [100, 130, 70]])
    for tiles in (fwd, bwd):
        _, _, got = FA._tile_stats((seg, seg, pos, pos), tiles)
        assert got == tiles
        skipped, total = FA.count_skipped_blocks(seg, seg, pos, pos, *tiles,
                                                 causal)
        empty, n = _empty_tile_pairs(seg, pos, *tiles, causal)
        assert total == n and skipped <= empty
        if not causal:
            assert skipped == empty
        assert skipped > 0


def test_tile_stats_carry_their_tiles():
    """The wrappers pass the stats' tiles to the C entries, which refuse
    stats at other tiles than the route's."""
    seg = torch.zeros(2, 300, dtype=torch.int32)
    pos = torch.arange(300, dtype=torch.int32).expand(2, 300)
    for tiles in ((128, 128), (64, 64), (32, 32)):
        stats, stride, got = FA._tile_stats((seg, seg, pos, pos), tiles)
        assert got == tiles and stride == -(-300 // tiles[0])
        assert stats.shape == (8, 2 * stride) and stats.dtype == torch.int32
    for source, entry in (("flash_fwd.cu", "flash_fwd_seg"),
                          ("flash_bwd.cu", "flash_bwd_seg")):
        body = _entry_body(source, entry)
        assert body.count("bad_tiles(Sq, Sk, stride, tile_q, tile_k,") == 2


def test_route_counters_start_at_zero_and_reset():
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["flash_tc"] == 0 and st["flash_bwd_tc"] == 0
    K._DISPATCH_STATS["flash_tc"] = 3
    K._DISPATCH_STATS["flash_bwd_tc"] = 2
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["flash_tc"] == 0 and st["flash_bwd_tc"] == 0


def test_head_dim_72_counters_start_at_zero_and_reset():
    """``flash_d72`` / ``flash_bwd_d72`` count the tensor-core launches at
    DiT's head dim among ``flash`` / ``flash_bwd``."""
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["flash_d72"] == 0 and st["flash_bwd_d72"] == 0
    K._DISPATCH_STATS["flash_d72"] = 3
    K._DISPATCH_STATS["flash_bwd_d72"] = 2
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["flash_d72"] == 0 and st["flash_bwd_d72"] == 0


def test_segment_route_counters_start_at_zero_and_reset():
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["varlen_tc"] == 0 and st["varlen_bwd_tc"] == 0
    K._DISPATCH_STATS["varlen_tc"] = 3
    K._DISPATCH_STATS["varlen_bwd_tc"] = 2
    K.reset_dispatch_stats()
    st = K.dispatch_stats()
    assert st["varlen_tc"] == 0 and st["varlen_bwd_tc"] == 0


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64)])
def test_cpu_segment_calls_count_the_plain_version_not_a_route(dtype, d):
    """A CPU tensor takes the segment plain versions (``varlen_ref`` /
    ``varlen_bwd_ref``) on either route's dtype, through the wrappers and
    through the autograd Function, and launches nothing."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, h, d, generator=g).to(dtype)
               for h in (4, 2, 2))
    seg = torch.tensor([[0, 0, 0, 1, 1, 1, -1, -1]], dtype=torch.int32)
    pos = torch.tensor([[0, 1, 2, 0, 1, 2, 0, 0]], dtype=torch.int32)
    segs = (seg, seg, pos, pos)
    K.reset_dispatch_stats()
    out, lse = FA.flash_attention_segments_fwd(q, k, v, *segs, causal=True)
    FA.flash_attention_segments_bwd(q, k, v, out, lse, torch.ones_like(q),
                                    *segs, causal=True)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_segments(*leaves, *segs, causal=True).sum().backward()
    st = K.dispatch_stats()
    assert st["varlen_ref"] == 2 and st["varlen_bwd_ref"] == 2, st
    assert st["varlen"] == st["varlen_tc"] == 0
    assert st["varlen_bwd"] == st["varlen_bwd_tc"] == 0


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
