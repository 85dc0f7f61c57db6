"""Sequence packing for training (port of ``paddle_tpu/io/packing.py``):
variable-length documents -> dense ``[B, S]`` rows.

Greedy first-fit over arrival order: deterministic (the same documents
give a bit-identical batch), no sorting (arrival order kept within a
row), rows closed only by capacity. A document longer than ``seq_len``
splits into consecutive chunks, each its own segment (positions
restart). The segment-masked flash kernels (``kernels/flash_attention.py``)
keep documents apart inside a row and skip the tiles between them.

Output contract (the dict form ``models.llama.unpack_batch`` takes):
- ``ids``          [B, S] int32: packed token ids, ``pad_id`` padding;
- ``segment_ids``  [B, S] int32: per-row document index, -1 = padding;
- ``positions``    [B, S] int32: segment-local offsets (rope positions);
- ``labels``       [B, S] int32: next-token targets; the last token of
  every document and all padding hold ``ignore_index``, so no token
  predicts across a document boundary.

The arrays are numpy; ``packed_train_batch`` turns them into the torch
tuple a train step takes. The reference's monitor gauges and counters
(``packing.efficiency`` and friends) are not ported: the port has no
monitor plane yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import enforce as E
from ..core import resolve_device

__all__ = ["pack_documents", "PackingCollator", "packed_train_batch",
           "packing_efficiency", "heavy_tailed_lengths", "IGNORE_INDEX"]

IGNORE_INDEX = -100


def _as_1d_ids(doc) -> np.ndarray:
    if isinstance(doc, torch.Tensor):
        doc = doc.detach().cpu().numpy()
    return np.asarray(doc).reshape(-1).astype(np.int32)


def pack_documents(docs: Sequence, seq_len: int, *, pad_id: int = 0,
                   ignore_index: int = IGNORE_INDEX,
                   max_rows: Optional[int] = None,
                   collect_overflow: bool = False):
    """First-fit ``docs`` (1-D token-id arrays, lists or tensors) into
    packed ``[B, S]`` rows, in arrival order. ``max_rows`` caps the
    batch: a chunk that fits no open row once the cap is reached raises,
    unless ``collect_overflow``, in which case that chunk and every later
    one go to an overflow list (arrival order kept: a later small chunk
    must not jump the queue) and ``(packed, overflow)`` is returned."""
    E.enforce(seq_len >= 2, f"seq_len must be >= 2, got {seq_len}",
              E.InvalidArgumentError)
    chunks = []
    for doc in docs:
        a = _as_1d_ids(doc)
        for off in range(0, len(a), seq_len):
            chunks.append(a[off:off + seq_len])

    rows: list = []          # list of list-of-chunks
    space: list = []         # remaining capacity per row
    overflow: list = []
    for ci, ch in enumerate(chunks):
        for r, free in enumerate(space):
            if free >= len(ch):
                rows[r].append(ch)
                space[r] -= len(ch)
                break
        else:
            if max_rows is not None and len(rows) >= max_rows:
                if collect_overflow:
                    overflow = chunks[ci:]
                    break
                raise E.ResourceExhaustedError(
                    f"pack_documents: a {len(ch)}-token chunk fits none "
                    f"of the {len(rows)} open rows and max_rows="
                    f"{max_rows} is reached; raise max_rows or feed "
                    "fewer documents per pack")
            rows.append([ch])
            space.append(seq_len - len(ch))

    b = max(len(rows), 1)
    ids = np.full((b, seq_len), pad_id, np.int32)
    seg = np.full((b, seq_len), -1, np.int32)
    pos = np.zeros((b, seq_len), np.int32)
    labels = np.full((b, seq_len), ignore_index, np.int32)
    for r, row in enumerate(rows):
        o = 0
        for si, ch in enumerate(row):
            n = len(ch)
            ids[r, o:o + n] = ch
            seg[r, o:o + n] = si
            pos[r, o:o + n] = np.arange(n, dtype=np.int32)
            # next-token targets stay inside the document
            labels[r, o:o + n - 1] = ch[1:]
            o += n
    packed = {"ids": ids, "segment_ids": seg, "positions": pos,
              "labels": labels}
    if collect_overflow:
        return packed, overflow
    return packed


def packing_efficiency(packed: dict) -> float:
    """Real tokens over row slots of a packed batch (from segment_ids)."""
    seg = np.asarray(packed["segment_ids"])
    return float((seg >= 0).sum() / seg.size)


def packed_train_batch(packed: dict, device=None):
    """Packed dict -> the ``(inp, labels, segment_ids, positions)`` tuple
    of int32 tensors that ``loss_fn`` / ``make_train_step`` take, on the
    card unless ``device`` says otherwise (``core.resolve_device``)."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.asarray(packed[k]), device=dev)
                 for k in ("ids", "labels", "segment_ids", "positions"))


class PackingCollator:
    """DataLoader ``collate_fn``: a list of variable-length token-id
    samples packs into one dense ``[B, S]`` batch per the module contract
    (numpy arrays; ``packed_train_batch`` turns them into tensors).

    ``carry_over=True`` (needs ``max_rows``) makes the collator stateful:
    chunks that do not fit the row budget wait in a carry-over that leads
    the next call's pack, so no token is dropped and batches keep a fixed
    row ceiling. The carry rides ``state_dict()`` / ``set_state_dict()``
    (JSON-safe lists), so a resumed loader restores it bit-exactly."""

    def __init__(self, seq_len: int, *, pad_id: int = 0,
                 ignore_index: int = IGNORE_INDEX,
                 max_rows: Optional[int] = None,
                 carry_over: bool = False):
        E.enforce(not carry_over or max_rows,
                  "PackingCollator carry_over requires max_rows (an "
                  "unbounded pack never overflows)",
                  E.InvalidArgumentError)
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.ignore_index = ignore_index
        self.max_rows = max_rows
        self.carry_over = bool(carry_over)
        self._carry: list = []

    def __call__(self, batch) -> dict:
        if not self.carry_over:
            return pack_documents(batch, self.seq_len, pad_id=self.pad_id,
                                  ignore_index=self.ignore_index,
                                  max_rows=self.max_rows)
        docs = list(self._carry) + list(batch)
        packed, leftover = pack_documents(
            docs, self.seq_len, pad_id=self.pad_id,
            ignore_index=self.ignore_index, max_rows=self.max_rows,
            collect_overflow=True)
        self._carry = [np.asarray(ch, np.int32) for ch in leftover]
        return packed

    def flush(self) -> Optional[dict]:
        """Pack one more batch from the carry-over (end of stream); None
        once it is empty. A flush can overflow ``max_rows`` and refill the
        carry, so call it until it returns None."""
        if not self._carry:
            return None
        docs, self._carry = self._carry, []
        return self(docs)

    def state_dict(self) -> dict:
        return {"carry": [np.asarray(c).ravel().astype(int).tolist()
                          for c in self._carry]}

    def set_state_dict(self, state: dict):
        self._carry = [np.asarray(c, np.int32).reshape(-1)
                       for c in state.get("carry", [])]


def heavy_tailed_lengths(seq_len: int, n_docs: int, seed: int = 7):
    """Deterministic heavy-tailed document-length trace (most documents
    short, a few near ``seq_len``): the reference's
    ``loadgen/traces.py`` draw, copied with its pinned sequence (the
    packed training rung's trace)."""
    rng = np.random.default_rng(seed)
    buckets = np.array([seq_len // 16, seq_len // 8, seq_len // 4,
                        seq_len // 2, seq_len])
    probs = np.array([0.35, 0.25, 0.2, 0.15, 0.05])
    return [int(x) for x in rng.choice(buckets, size=n_docs, p=probs)]
