"""``DataLoader`` (port of ``paddle_tpu/io/dataloader.py``).

The loader assembles host (numpy) batches and makes them tensors at
yield time, on its ``places`` or, when that is not set, the current
device (the card unless the caller asked for the CPU). Four ways to
assemble:

- ``num_workers=0``: synchronous;
- ``worker_mode="thread"``: prefetch threads;
- ``worker_mode="process"``: subprocess workers with an ordered
  reassembly buffer, for Python-heavy per-sample transforms; children
  exchange numpy only and never touch CUDA (fork keeps datasets
  zero-copy on Linux);
- ``worker_mode="native"``: C++ batch assembly for array-backed datasets
  (``io/native_feed.py``); when its library cannot be built it raises,
  never falling back to another mode.

Determinism and exactly-once resume: the loader owns a seed root
(``seed=``, or drawn ONCE from the port's CPU generator, so
``paddle_tpu_torch.seed`` keeps controlling shuffle order), and every
per-epoch stream (shuffle permutation, worker seeds, the native feeder)
derives from ``(seed, epoch)`` through numpy, as in the reference, so
one seed gives the same batches in both packages.
``state_dict()`` / ``set_state_dict()`` capture and restore {seed,
epoch, intra-epoch batch cursor, stateful-collator state}; a restored
loader fast-forwards to the exact batch boundary WITHOUT touching the
dataset (sampler indices are consumed, samples are not). Each yielded
batch passes the ``dataloader.batch`` fault value point
(``testing/faults.py``).
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

import torch

from .. import monitor as _monitor
from ..core import enforce as E
from ..core.tensor import to_tensor
from ..device import to_torch_device
from ..testing import faults as _faults
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def _collate(batch, leaf_stack, recurse):
    """Shared recursive collate skeleton; ``leaf_stack`` owns the array
    leaves (tensors or numpy in the parent, numpy only in subprocess
    workers)."""
    sample = batch[0]
    if isinstance(sample, (torch.Tensor, np.ndarray)):
        return leaf_stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return leaf_stack([np.asarray(b) for b in batch])
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: recurse([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [recurse(list(items)) for items in zip(*batch)]
    return batch


def _host_collate(batch):
    """The loader's default collate: numpy samples stacked with numpy,
    tensor samples with ``torch.stack`` where they lie; the batch moves
    to the loader's device at yield time."""
    def leaf(items):
        if torch.is_tensor(items[0]):
            return torch.stack(items)
        return np.stack(items)
    return _collate(batch, leaf, _host_collate)


def default_collate_fn(batch):
    """Stack samples into batch tensors on the current device."""
    return _to_tensor_tree(_host_collate(batch), to_torch_device())


class _ThreadedPrefetcher:
    def __init__(self, make_iter: Callable, num_workers: int,
                 prefetch_factor: int):
        self._make_iter = make_iter
        self._depth = max(2, num_workers * prefetch_factor)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        sentinel = object()
        stop = threading.Event()
        err = []

        def worker():
            try:
                for item in self._make_iter():
                    # bounded put that aborts when the consumer went away,
                    # so an early `break` in the train loop can't leave the
                    # thread blocked forever holding batches in memory
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            stop.set()
            while not q.empty():  # unblock a final put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def _np_collate(batch):
    """Worker-side collate: numpy only. Tensor samples are REJECTED — a
    forked child must not touch the parent's CUDA context;
    process-mode datasets return numpy / python samples."""
    def leaf(items):
        if torch.is_tensor(items[0]):
            raise TypeError(
                "worker_mode='process' datasets must return numpy arrays "
                "or python scalars, not tensors (a forked DataLoader "
                "worker must not touch the parent's CUDA context); return "
                "np.ndarray from __getitem__ or use worker_mode='thread'")
        return np.stack(items)
    return _collate(batch, leaf, _np_collate)


def _to_tensor_tree(x, device):
    """Every numpy array and tensor of a batch as a tensor on
    ``device`` (numpy float64 becomes float32, as ``to_tensor`` does)."""
    if isinstance(x, np.ndarray):
        return to_tensor(x, place=device)
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to_tensor_tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        out = [_to_tensor_tree(v, device) for v in x]
        return out if isinstance(x, list) else tuple(out)
    return x


class _WorkerError:
    def __init__(self, exc):
        import traceback
        self.msg = f"{type(exc).__name__}: {exc}\n" + traceback.format_exc()


class WorkerInfo:
    """Worker-side metadata (reference: io/dataloader/worker.py
    WorkerInfo): id, num_workers, seed, dataset."""

    def __init__(self, id, num_workers, seed, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """Inside a DataLoader worker, returns that worker's WorkerInfo;
    None in the main process (reference: io/dataloader/worker.py
    get_worker_info)."""
    return _worker_info


def _process_worker_loop(dataset, index_q, result_q, worker_init_fn, wid,
                         ship_raw, num_workers=0, seed=0):
    """One subprocess worker (reference: io/dataloader/worker.py
    _worker_loop): pull (seq, indices), push (seq, numpy batch). With
    ``ship_raw`` (user collate_fn), the raw sample list is shipped and
    the parent applies the user's collate. ``seed`` is the loader's
    per-epoch base seed; WorkerInfo.seed = base + wid (so it differs
    across workers AND across epochs/runs, like the reference's
    base_seed + worker_id), and the worker's stdlib/numpy RNGs are
    seeded from it before worker_init_fn runs."""
    global _worker_info
    wseed = (seed + wid) & 0xFFFFFFFF
    _worker_info = WorkerInfo(wid, num_workers, wseed, dataset)
    import random as _random
    _random.seed(wseed)
    np.random.seed(wseed)
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        task = index_q.get()
        if task is None:
            return
        seq, idxs = task
        try:
            samples = [dataset[i] for i in idxs]
            batch = samples if ship_raw else _np_collate(samples)
        except BaseException as e:   # surface in the parent
            result_q.put((seq, _WorkerError(e)))
            continue
        result_q.put((seq, batch))


class _ProcessPrefetcher:
    """Ordered multi-process batch pipeline: an index queue feeds workers,
    results reassemble in submission order (the reference's out-of-order
    queue + reorder logic in dataloader_iter.py)."""

    def __init__(self, dataset, batches, num_workers, prefetch_factor,
                 worker_init_fn, collate_fn=None, timeout=0,
                 base_seed=0):
        self._dataset = dataset
        self._batches = batches
        self._n = num_workers
        self._depth = max(2, prefetch_factor) * num_workers
        self._init_fn = worker_init_fn
        # non-default collate runs in the PARENT over raw shipped samples
        # (a user fn may build tensors — CUDA stays out of the workers)
        self._collate = collate_fn
        self._timeout = timeout or None
        # per-epoch worker base seed, derived by the DataLoader from its
        # owned (seed, epoch) root — never from ambient np.random, so
        # two identically-seeded loaders give identical worker seeds
        # regardless of interleaved global-RNG use
        self._base_seed = int(base_seed)

    def __iter__(self):
        ctx = mp.get_context(
            "fork" if "fork" in mp.get_all_start_methods() else "spawn")
        index_q = ctx.Queue()
        result_q = ctx.Queue()
        ship_raw = self._collate is not None
        base_seed = self._base_seed
        workers = [ctx.Process(
            target=_process_worker_loop,
            args=(self._dataset, index_q, result_q, self._init_fn, w,
                  ship_raw, self._n, base_seed),
            daemon=True) for w in range(self._n)]
        for w in workers:
            w.start()
        try:
            submitted = 0
            received = 0
            buf = {}
            total = len(self._batches)
            # prime the pipeline
            while submitted < min(self._depth, total):
                index_q.put((submitted, self._batches[submitted]))
                submitted += 1
            import time as _time
            next_seq = 0
            while next_seq < total:
                # per-BATCH timeout (paddle semantics): the clock restarts
                # once each awaited batch arrives
                deadline = (None if self._timeout is None
                            else _time.time() + self._timeout)
                while next_seq not in buf and received < total:
                    # bounded waits so a dead worker (OOM-kill, segfault)
                    # raises instead of deadlocking the train loop
                    # (reference: dataloader_iter.py worker health polls)
                    try:
                        seq, data = result_q.get(timeout=1.0)
                    except queue.Empty:
                        dead = [w for w in workers if not w.is_alive()]
                        if dead:
                            raise E.PreconditionNotMetError(
                                f"DataLoader worker(s) died unexpectedly "
                                f"(exitcodes "
                                f"{[w.exitcode for w in dead]}) — likely "
                                "killed (OOM?) or crashed in native code")
                        if deadline is not None and \
                                _time.time() > deadline:
                            raise E.PreconditionNotMetError(
                                f"DataLoader timed out after "
                                f"{self._timeout}s waiting for a batch")
                        continue
                    buf[seq] = data
                    received += 1
                    if submitted < total:
                        index_q.put((submitted, self._batches[submitted]))
                        submitted += 1
                data = buf.pop(next_seq)
                next_seq += 1
                if isinstance(data, _WorkerError):
                    raise E.PreconditionNotMetError(
                        f"DataLoader worker failed:\n{data.msg}")
                yield self._collate(data) if ship_raw else data
        finally:
            for _ in workers:
                index_q.put(None)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()


class DataLoader:
    """``paddle.io.DataLoader``. Batches are tensors on ``places`` (a
    Paddle device string, ``torch.device`` or a list of them, of which
    the first is taken), else on the current device."""

    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True, batch_sampler=None,
                 batch_size: Optional[int] = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn=None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 prefetch_factor: int = 2, use_shared_memory: bool = True,
                 timeout: int = 0, worker_init_fn=None,
                 persistent_workers=False, worker_mode: str = "thread",
                 seed: Optional[int] = None):
        E.enforce(worker_mode in ("thread", "process", "native"),
                  "worker_mode must be 'thread', 'process', or 'native'",
                  E.InvalidArgumentError)
        self.dataset = dataset
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.worker_mode = worker_mode
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self._shuffle = bool(shuffle)
        self._drop_last = bool(drop_last)
        self._user_batch_sampler = batch_sampler is not None
        # loader-owned seed root: every per-epoch stream (shuffle,
        # worker seeds, native feeder) derives from (seed, epoch).
        # None = drawn lazily ONCE from the port's CPU generator (so
        # paddle_tpu_torch.seed before first use keeps whole runs
        # reproducible) — never re-drawn inside __iter__.
        self._seed = None if seed is None else int(seed) & 0xFFFFFFFF
        self._epoch = -1          # epoch currently/last iterated
        self._cursor = 0          # batches yielded this epoch
        self._resume_epoch = None  # set_state_dict target epoch
        self._resume_skip = 0      # batches to fast-forward past
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)
                self.batch_size = batch_size

    def _collate_batch(self, samples):
        if self.collate_fn is default_collate_fn:
            return _host_collate(samples)
        return self.collate_fn(samples)

    def _raw_iter(self, skip: int = 0):
        """The synchronous batch source. ``skip`` fast-forwards past the
        first N batches WITHOUT building them: map-style skips consume
        sampler indices only (no dataset access, no collate); iterable
        datasets must draw the samples (the iterator owns the position)
        but still skip the collate."""
        if self._iterable_mode:
            it = iter(self.dataset)
            if self.batch_size is None:
                for sample in itertools.islice(it, skip, None):
                    yield sample
                return
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                if skip > 0:
                    skip -= 1
                    continue
                yield self._collate_batch(batch)
        elif self.batch_sampler is None:
            for i in range(skip, len(self.dataset)):
                yield self.dataset[i]
        else:
            for batch_idx in self.batch_sampler:
                if skip > 0:
                    skip -= 1
                    continue
                yield self._collate_batch([self.dataset[i]
                                           for i in batch_idx])

    # -- loader-owned determinism + resume state ----------------------------

    def _root_seed(self) -> int:
        if self._seed is None:
            # seedless loaders draw their root ONCE from the port's CPU
            # generator (the one the samplers use), so
            # paddle_tpu_torch.seed keeps controlling shuffle order
            from ..framework import random as frandom
            self._seed = int(torch.randint(
                0, 2**32, (1,), generator=frandom.default_generator("cpu"),
                dtype=torch.int64))
        return self._seed

    def _epoch_rng(self) -> np.random.Generator:
        """Fresh Generator for THIS epoch, derived from (seed, epoch) —
        replayable, so a restored loader reproduces the epoch's shuffle
        and worker seeds bit-exactly."""
        return np.random.default_rng(
            np.random.SeedSequence([self._root_seed(),
                                    max(self._epoch, 0)]))

    def _epoch_base_seed(self) -> int:
        return int(self._epoch_rng().integers(0, 2**31 - 1))

    def state_dict(self) -> dict:
        """Resume state: seed root, epoch index, intra-epoch batch
        cursor, and a stateful collator's state (PackingCollator's
        carry-over buffer). JSON-safe — registers directly into
        CheckpointManager state. With prefetching workers
        (num_workers>0) a stateful COLLATOR may have run ahead of the
        consumed cursor; checkpoint stateful-collator loaders with
        num_workers=0 for exact carry accounting."""
        if self._resume_epoch is not None:
            # a restore is pending but __iter__ hasn't run yet (e.g. a
            # preemption save between resume and the first batch): the
            # truthful position is the pending target, not the stale
            # pre-restore counters
            epoch, cursor = self._resume_epoch, self._resume_skip
        else:
            epoch, cursor = self._epoch, self._cursor
        sd = {"seed": self._root_seed(), "epoch": int(epoch),
              "cursor": int(cursor)}
        if hasattr(self.collate_fn, "state_dict"):
            sd["collate"] = self.collate_fn.state_dict()
        return sd

    def state_provider(self):
        """Offer-time pin of the resume state at O(1) cost, for
        per-batch save providers (SentinelLoop, FaultTolerantCheckpoint):
        the scalar cursor state is captured NOW; a stateful collator
        exposing ``state_snapshot``/``render_state`` (PackingCollator)
        has its carry pinned by REFERENCE and rendered JSON-safe only
        when the returned callable runs — an interval-skipped save pays
        nothing. Collators with only ``state_dict`` are captured
        eagerly (correct, possibly costlier)."""
        if self._resume_epoch is not None:
            epoch, cursor = self._resume_epoch, self._resume_skip
        else:
            epoch, cursor = self._epoch, self._cursor
        seed = self._root_seed()
        collate = self.collate_fn
        pinned = rendered = None
        if hasattr(collate, "state_snapshot") and \
                hasattr(collate, "render_state"):
            pinned = collate.state_snapshot()
        elif hasattr(collate, "state_dict"):
            rendered = collate.state_dict()

        def provide() -> dict:
            sd = {"seed": int(seed), "epoch": int(epoch),
                  "cursor": int(cursor)}
            if pinned is not None:
                sd["collate"] = collate.render_state(pinned)
            elif rendered is not None:
                sd["collate"] = rendered
            return sd
        return provide

    def set_state_dict(self, state: dict):
        """Restore :meth:`state_dict`: the NEXT ``__iter__`` re-enters
        the captured epoch and fast-forwards to its batch cursor, so
        every sample index is consumed exactly once across the
        kill/resume boundary (no replay, no skip)."""
        self._seed = int(state["seed"]) & 0xFFFFFFFF
        epoch = int(state.get("epoch", -1))
        cursor = int(state.get("cursor", 0))
        if epoch < 0:
            self._resume_epoch = None
            self._resume_skip = 0
            self._epoch = -1
            self._cursor = 0
        else:
            self._resume_epoch = epoch
            self._resume_skip = cursor
        if "collate" in state and hasattr(self.collate_fn,
                                          "set_state_dict"):
            self.collate_fn.set_state_dict(state["collate"])

    def __iter__(self):
        if self._resume_epoch is not None:
            self._epoch = self._resume_epoch
            self._resume_epoch = None
        else:
            self._epoch += 1
            self._resume_skip = 0
        skip = self._resume_skip
        self._resume_skip = 0
        self._cursor = skip
        if skip and _monitor.enabled():
            _monitor.inc("data.resume.fast_forward_batches", skip,
                         doc="batches fast-forwarded (indices consumed, "
                             "samples untouched) by state_dict resume")
        # re-derive the owned shuffle stream for this epoch (only when
        # the loader built its own sampler — a user batch_sampler owns
        # its order)
        if (self.batch_sampler is not None and not self._user_batch_sampler
                and self._shuffle
                and hasattr(self.batch_sampler, "sampler")):
            self.batch_sampler.sampler.generator = self._epoch_rng()
        device = to_torch_device(self.places)
        it = self._counted(self._make_iter(skip), device)
        if _monitor.enabled():
            return self._monitored(it)
        return it

    def _counted(self, it, device):
        """Innermost consumer-side wrapper: makes each batch tensors on
        ``device``, advances the intra-epoch cursor per YIELDED batch
        (prefetchers may run ahead; the cursor tracks what the training
        loop actually consumed) and exposes the ``dataloader.batch``
        fault value point."""
        for batch in it:
            batch = _to_tensor_tree(batch, device)
            batch = _faults.corrupt("dataloader.batch", batch)
            self._cursor += 1
            yield batch

    def _monitored(self, it):
        """Per-batch throughput instrumentation (entered only when the
        monitor is enabled): batch counter + inter-batch interval
        histogram while iterating, and an epoch-level batches/sec gauge
        when the epoch ends. Metric handles hoist out of the loop (the
        record_op pattern) so the per-batch cost is two lock-free-ish
        updates, not registry lookups; an epoch started under the flag
        keeps recording to its handles until it ends. batches/sec over
        the whole run = dataloader.batches /
        (dataloader.batch_interval_ms.sum / 1000)."""
        batches = _monitor.counter(
            "dataloader.batches", "batches yielded across all loaders")
        intervals = _monitor.histogram(
            "dataloader.batch_interval_ms",
            "gap between consecutive batches (includes consumer step "
            "time)")
        t_start = time.perf_counter()
        last = t_start
        n = 0
        try:
            for batch in it:
                now = time.perf_counter()
                batches.incr()
                intervals.observe((now - last) * 1e3)
                last = now
                n += 1
                yield batch
        finally:
            elapsed = time.perf_counter() - t_start
            if n and elapsed > 0:
                _monitor.set_gauge(
                    "dataloader.last_epoch_batches_per_sec",
                    round(n / elapsed, 3),
                    doc="throughput of the most recently finished epoch")

    def _make_iter(self, skip: int = 0):
        if self.worker_mode == "native":
            if self._user_batch_sampler:
                raise E.InvalidArgumentError(
                    "worker_mode='native' drives its own batching/"
                    "shuffle and cannot honor a custom batch_sampler",
                    hint="drop batch_sampler (use shuffle=/drop_last=) "
                         "or use worker_mode='thread'/'process'")
            return self._native_iter(skip)
        if self.num_workers > 0 and self.worker_mode == "process":
            if self._iterable_mode or self.batch_sampler is None:
                raise E.InvalidArgumentError(
                    "worker_mode='process' requires a map-style dataset "
                    "with batching (IterableDataset / batch_size=None "
                    "cannot be index-partitioned across workers); use "
                    "worker_mode='thread'")
            batches = [list(b) for b in self.batch_sampler][skip:]
            user_collate = (self.collate_fn
                            if self.collate_fn is not default_collate_fn
                            else None)
            return iter(_ProcessPrefetcher(
                self.dataset, batches, self.num_workers,
                self.prefetch_factor, self.worker_init_fn,
                collate_fn=user_collate, timeout=self.timeout,
                base_seed=self._epoch_base_seed()))
        if self.num_workers > 0:
            return iter(_ThreadedPrefetcher(
                lambda: self._raw_iter(skip), self.num_workers,
                self.prefetch_factor))
        return self._raw_iter(skip)

    def _native_iter(self, skip: int = 0):
        """worker_mode='native': C++ batch assembly (csrc/datafeed.cc)
        for row-aligned array datasets — TensorDataset, or any dataset
        exposing ``numpy_arrays()`` -> tuple of [N, ...] numpy arrays.
        Shuffle/drop_last honored natively; yields Tensor tuples like
        the default collate (made tensors at yield time, on the loader's
        device). Resume fast-forward drains ``skip``
        assembled batches (the feeder owns its position — the C++ path
        cannot skip index-only)."""
        import numpy as np

        from .dataset import TensorDataset
        from .native_feed import NativeArrayFeeder

        if hasattr(self.dataset, "numpy_arrays"):
            arrays = [np.asarray(a) for a in self.dataset.numpy_arrays()]
        elif isinstance(self.dataset, TensorDataset):
            arrays = [t.detach().cpu().numpy() if torch.is_tensor(t)
                      else np.asarray(t) for t in self.dataset.tensors]
        else:
            raise TypeError(
                "worker_mode='native' needs an array-backed dataset "
                "(TensorDataset or one exposing numpy_arrays()); use "
                "worker_mode='thread'/'process' for arbitrary map-style "
                "datasets")
        if self.batch_size is None:
            raise E.InvalidArgumentError("worker_mode='native' requires batch_size")
        if self.collate_fn is not default_collate_fn:
            raise E.InvalidArgumentError(
                "worker_mode='native' assembles batches in C++ and "
                "cannot run a custom collate_fn",
                hint="drop collate_fn or use worker_mode="
                     "'thread'/'process'")
        # per-epoch seed derived from the loader-owned (seed, epoch)
        # root — every __iter__ reshuffles like the thread/process
        # paths, and a restored loader replays the same order
        feeder = NativeArrayFeeder(
            arrays, self.batch_size, shuffle=self._shuffle,
            drop_last=self._drop_last, seed=self._epoch_base_seed(),
            num_threads=max(self.num_workers, 1), epochs=1)
        try:
            for batch in feeder:
                if skip > 0:
                    skip -= 1
                    continue
                yield batch
        finally:
            feeder.close()

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)
