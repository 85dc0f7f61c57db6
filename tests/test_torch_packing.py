"""Port parity: sequence packing (``io/packing.py``) and packed training
of the Llama core.

The packer must give the JAX package's arrays byte for byte. On
``llama_tiny`` in float32 with the JAX weights carried over, the packed
loss and every parameter gradient are held to
``jax.value_and_grad(loss_fn)`` at ``tests/test_torch_train.py``'s
tolerances (``rtol=1e-5, atol=1e-6``: summation order only), the packed
loss to the unpacked one-document-per-row loss (``rtol=1e-5``, the
reference's packed-vs-unpacked contract), and three packed train steps
to the JAX ``make_train_step`` (losses ``rtol=1e-5``, parameters as in
``test_three_train_steps_match_reference``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.io import packing as JPK
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.io import packing as TPK
from paddle_tpu_torch.kernels import flash_attention as TFA
from paddle_tpu_torch.models import llama as TL

from test_torch_train import _jnamed, _named, _setup

JFA = importlib.import_module("paddle_tpu.kernels.flash_attention")


def _docs(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.int32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("lens,seq_len", [
    ([40, 24], 64),                       # the reference's parity trace
    ([5, 17, 3, 30, 12, 9, 1, 20], 32),   # first-fit into earlier rows
    ([70, 10, 33], 32),                   # long documents split in chunks
    ([], 16), ([0, 4], 8),                # nothing / an empty document
])
def test_pack_documents_matches_jax_byte_for_byte(lens, seq_len):
    docs = _docs(100, lens)
    for kw in ({}, {"pad_id": 7, "ignore_index": -1}):
        _same(TPK.pack_documents(docs, seq_len, **kw),
              JPK.pack_documents(docs, seq_len, **kw))
    # tensors and lists are documents too
    _same(TPK.pack_documents([torch.as_tensor(d) for d in docs], seq_len),
          JPK.pack_documents([d.tolist() for d in docs], seq_len))


def test_labels_stop_at_document_boundaries():
    docs = _docs(50, [5, 3])
    p = TPK.pack_documents(docs, 10)
    np.testing.assert_array_equal(p["labels"][0, :4], docs[0][1:])
    assert p["labels"][0, 4] == TPK.IGNORE_INDEX          # last of doc 0
    np.testing.assert_array_equal(p["labels"][0, 5:7], docs[1][1:])
    assert (p["labels"][0, 7:] == TPK.IGNORE_INDEX).all()
    np.testing.assert_array_equal(p["positions"][0, :8],
                                  [0, 1, 2, 3, 4, 0, 1, 2])
    assert TPK.packing_efficiency(p) == JPK.packing_efficiency(p) == 0.8


def test_max_rows_overflow_raises_or_collects_as_jax():
    docs = _docs(100, [20, 20, 20, 5, 20])
    with pytest.raises(TE.ResourceExhaustedError):
        TPK.pack_documents(docs, 32, max_rows=2)
    with pytest.raises(MemoryError):
        JPK.pack_documents(docs, 32, max_rows=2)
    got, g_over = TPK.pack_documents(docs, 32, max_rows=2,
                                     collect_overflow=True)
    want, w_over = JPK.pack_documents(docs, 32, max_rows=2,
                                      collect_overflow=True)
    _same(got, want)
    assert len(g_over) == len(w_over) == 3      # order kept: 20, 5, 20
    for a, b in zip(g_over, w_over):
        np.testing.assert_array_equal(a, b)


def test_collator_carry_over_and_state_dict_match_jax():
    batches = [_docs(100, lens, seed=i) for i, lens in
               enumerate(([20, 20, 20, 5], [9, 30], [31, 2, 2]))]
    got_c = TPK.PackingCollator(32, max_rows=2, carry_over=True)
    want_c = JPK.PackingCollator(32, max_rows=2, carry_over=True)
    for i, batch in enumerate(batches):
        _same(got_c(batch), want_c(batch))
        assert got_c.state_dict() == want_c.state_dict()
        if i == 1:      # a resumed collator carries on bit-exactly
            state = got_c.state_dict()
            got_c = TPK.PackingCollator(32, max_rows=2, carry_over=True)
            got_c.set_state_dict(state)
    while (tail := want_c.flush()) is not None:
        _same(got_c.flush(), tail)
    assert got_c.flush() is None
    with pytest.raises(ValueError):
        TPK.PackingCollator(32, carry_over=True)
    plain = TPK.PackingCollator(32)
    _same(plain(batches[1]), JPK.pack_documents(batches[1], 32))


def test_packed_trace_of_the_training_rung():
    """The packed rung's trace: 24 heavy-tailed documents (seed 7) of up
    to 2048 tokens pack into ``[7, 2048]``; tiles skipped equal JAX's."""
    lens = TPK.heavy_tailed_lengths(2048, 24, seed=7)
    assert lens == JPK.heavy_tailed_lengths(2048, 24, seed=7)
    assert TPK.heavy_tailed_lengths(128, 50, 3) == \
        JPK.heavy_tailed_lengths(128, 50, 3)
    docs = _docs(32000, lens, seed=7)
    packed = TPK.pack_documents(docs, 2048)
    _same(packed, JPK.pack_documents(docs, 2048))
    assert packed["ids"].shape == (7, 2048)
    assert int((packed["labels"] >= 0).sum()) == 12392
    assert round(TPK.packing_efficiency(packed), 4) == 0.8661
    seg, pos = packed["segment_ids"], packed["positions"]
    for block in (16, 32, 64):
        assert TFA.count_skipped_blocks(
            *(torch.as_tensor(a) for a in (seg, seg, pos, pos)), block,
            block, True) == JFA.count_skipped_blocks(seg, seg, pos, pos,
                                                     block, block, True)
    assert TFA.count_skipped_blocks(
        *(torch.as_tensor(a) for a in (seg, seg, pos, pos)), 32, 32,
        True) == (21878, 28672)


def test_packed_train_batch_tensors():
    packed = TPK.pack_documents(_docs(100, [5, 3]), 10)
    batch = TPK.packed_train_batch(packed, device="cpu")
    assert len(batch) == 4
    for t, key in zip(batch, ("ids", "labels", "segment_ids", "positions")):
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), packed[key])
    if not torch.cuda.is_available():
        with pytest.raises(TE.UnavailableError):
            TPK.packed_train_batch(packed)


def _packed_and_unpacked(vocab, lens, seq_len, seed=0):
    """The reference's parity pair: packed rows and the same documents
    one per row, padded with ``ignore_index`` labels."""
    docs = _docs(vocab, lens, seed)
    packed = TPK.pack_documents(docs, seq_len)
    maxl = max(lens)
    ids = np.zeros((len(docs), maxl), np.int32)
    lab = np.full((len(docs), maxl), -100, np.int32)
    for i, d in enumerate(docs):
        ids[i, :len(d)] = d
        lab[i, :len(d) - 1] = d[1:]
    return packed, (ids, lab)


def _jbatch(packed):
    return tuple(jnp.asarray(packed[k]) for k in
                 ("ids", "labels", "segment_ids", "positions"))


@pytest.mark.parametrize("fused_ce", [True, False])
def test_packed_loss_and_every_grad_match_jax(fused_ce):
    jcfg, jp, cfg, tp = _setup(fused_ce=fused_ce, fused_ce_chunk=64)
    packed, _ = _packed_and_unpacked(jcfg.vocab_size, [20, 9, 14, 6, 11],
                                     24)
    want_loss, want_g = jax.value_and_grad(
        lambda p: JL.loss_fn(p, _jbatch(packed), jcfg))(jp)
    TK.reset_dispatch_stats()
    loss, grads = TL.loss_and_grads(tp, TPK.packed_train_batch(
        packed, device="cpu"), cfg)
    stats = TK.dispatch_stats()
    layers = cfg.num_hidden_layers
    assert stats["varlen_ref"] == layers == stats["varlen_bwd_ref"]
    assert stats["flash_ref"] == 0 and stats["flash_bwd_ref"] == 0
    assert stats["fused_ce"] == (1 if fused_ce else 0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads, want_g = _named(grads), _jnamed(want_g)
    assert grads.keys() == want_g.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_packed_loss_and_grads_equal_unpacked():
    """Packed rows give the loss of the same documents one per row (same
    contexts, same valid-token mean) and its gradients."""
    cfg = TL.llama_tiny(vocab_size=64)
    tp = TL.init_params(cfg, seed=0, device="cpu")
    packed, unpacked = _packed_and_unpacked(64, [40, 24], 64)
    lp, gp = TL.loss_and_grads(tp, TPK.packed_train_batch(packed, "cpu"),
                               cfg)
    lu, gu = TL.loss_and_grads(tp, unpacked, cfg)
    np.testing.assert_allclose(float(lp), float(lu), rtol=1e-5)
    for name, g in _named(gp).items():
        torch.testing.assert_close(g, _named(gu)[name], rtol=1e-4, atol=1e-5)


def test_packed_remat_recomputes_the_segment_forward():
    """Under remat the segment forward runs twice a layer, the backward
    once, and the loss and gradients are those without remat."""
    results = {}
    for remat in (False, True):
        cfg = TL.llama_tiny(remat=remat, remat_policy="dots")
        tp = TL.init_params(cfg, seed=3, device="cpu")
        packed, _ = _packed_and_unpacked(cfg.vocab_size, [13, 7, 9], 16)
        TK.reset_dispatch_stats()
        results[remat] = TL.loss_and_grads(
            tp, TPK.packed_train_batch(packed, "cpu"), cfg)
        stats = TK.dispatch_stats()
        assert stats["varlen_ref"] == (2 if remat else 1) * \
            cfg.num_hidden_layers
        assert stats["varlen_bwd_ref"] == cfg.num_hidden_layers
    assert float(results[True][0]) == pytest.approx(float(results[False][0]),
                                                    rel=1e-6)
    for a, b in zip(TL._leaves(results[True][1]),
                    TL._leaves(results[False][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_three_packed_train_steps_match_reference():
    jcfg, jp, cfg, tp = _setup(seed=5)
    packed, _ = _packed_and_unpacked(jcfg.vocab_size, [20, 9, 14, 6, 11],
                                     24, seed=6)
    jstep = JL.make_train_step(jcfg, donate=False)
    jstate, tstate = JL.adamw_init(jp), TL.adamw_init(tp)
    tstep = TL.make_train_step(cfg)
    _, g1 = jax.value_and_grad(
        lambda p: JL.loss_fn(p, _jbatch(packed), jcfg))(jp)
    g1 = _jnamed(g1)
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, _jbatch(packed))
        _, tstate, tloss = tstep(tp, tstate, packed)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want, noisy, total = _jnamed(jp), 0, 0
    for name, t in _named(tp).items():
        g = np.abs(g1[name])
        quiet = g < 1e-6 * g.max()
        err = np.abs(t.numpy() - want[name])
        assert np.all(err[~quiet] <= 1e-5), name
        assert np.all(err[quiet] <= 2 * 3 * 3e-4 + 1e-5), name
        noisy += int((err[quiet] > 1e-5).sum())
        total += err.size
    assert noisy <= 1e-3 * total


@pytest.mark.parametrize("lens,seq_len,max_rows", [
    ([40, 24], 64, None),
    ([5, 17, 3, 30, 12, 9, 1, 20], 32, None),
    ([70, 10, 33], 32, None),
    ([0, 4, 0], 8, None),
    ([20, 20, 20, 5], 24, 2),             # the overflow's chunks uncounted
])
def test_packing_metrics_match_the_reference(lens, seq_len, max_rows):
    """ROADMAP C6: with the monitor on, packing the same documents twice
    through each package leaves the same ``packing.*`` gauge and
    counters in both snapshots (efficiency of the last pack; documents,
    rows, real and padding tokens summed over both)."""
    from _torch_monitor_common import JM, TM, reset_both, set_monitor
    docs = _docs(100, lens)
    kw = ({} if max_rows is None
          else {"max_rows": max_rows, "collect_overflow": True})
    reset_both()
    set_monitor(True)
    try:
        for _ in range(2):
            TPK.pack_documents(docs, seq_len, **kw)
            JPK.pack_documents(docs, seq_len, **kw)
        snaps = [{kind: {k: v for k, v in vals.items()
                         if k.startswith("packing.")}
                  for kind, vals in M.snapshot().items()}
                 for M in (TM, JM)]
        assert snaps[0] == snaps[1]
        assert snaps[0]["counters"]["packing.documents"] == 2 * sum(
            n > 0 for n in lens)
        assert "packing.efficiency" in snaps[0]["gauges"]
    finally:
        set_monitor(False)
        reset_both()
    # monitor off: nothing is registered
    TPK.pack_documents(docs, seq_len, **kw)
    assert not any(k.startswith("packing.") for vals in
                   TM.snapshot().values() for k in vals)
