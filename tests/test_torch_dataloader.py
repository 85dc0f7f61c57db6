"""Port parity: datasets, samplers and the ``DataLoader``
(``paddle_tpu_torch/io/`` against ``paddle_tpu/io/``).

Every draw of both packages comes from ``numpy.random.default_rng``, so
one seed gives the same indices and the same batches, compared exactly:
the samplers with an explicit ``generator`` seed; the loader with its
``seed=`` root in every worker mode (synchronous, ``"thread"``,
``"process"``, ``"native"``), shuffled and not, ``drop_last`` on and
off, over two epochs. The port's batches are tensors on the loader's
device (the CPU here, asked for with ``places="cpu"``). Resume: a
loader stopped after ``k`` batches hands ``state_dict()`` to a fresh
one (the reference's state into the port's too, JSON-safe), which
yields exactly the batches the uninterrupted loader would have (after
``tests/test_data_resume.py``), without touching the dataset for the
skipped ones, and a ``PackingCollator``'s carry rides along. The
``dataloader.batch`` fault point and the monitor's loader counters are
the reference's.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import io as jio
from paddle_tpu import monitor as JM
from paddle_tpu.core import flags as JF
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import monitor as TM
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.testing import faults as tfaults

MODES = [("sync", 0), ("thread", 2), ("process", 2), ("native", 2)]


@pytest.fixture
def cpu_device():
    prev = tpaddle.device._current_device
    tpaddle.set_device("cpu")
    yield
    tpaddle.device._current_device = prev


def _np(x):
    if torch.is_tensor(x):
        assert x.device.type == "cpu"
        return x.numpy()
    return np.asarray(x.numpy())


def _flat(batches):
    """Batches as lists of numpy arrays (a batch is a tuple / list)."""
    return [[_np(t) for t in b] for b in batches]


def _assert_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


class ArrayDS:
    """A map-style dataset of numpy rows (the process mode's kind)."""

    def __init__(self, n=22):
        rng = np.random.default_rng(0)
        self.x = rng.normal(size=(n, 3)).astype(np.float32)
        self.y = np.arange(n, dtype=np.int32)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _dataset(pkg, mode):
    base = ArrayDS()
    if mode == "native":
        mod = tio if pkg == "torch" else jio
        return mod.TensorDataset([base.x, base.y])
    if pkg == "torch":
        return type("TDS", (ArrayDS, tio.Dataset), {})()
    return type("JDS", (ArrayDS, jio.Dataset), {})()


def _loader(pkg, mode, nw, **kw):
    mod = tio if pkg == "torch" else jio
    extra = {"places": "cpu"} if pkg == "torch" else {}
    return mod.DataLoader(_dataset(pkg, mode), batch_size=4, num_workers=nw,
                          worker_mode="thread" if mode == "sync" else mode,
                          seed=123, **extra, **kw)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
@pytest.mark.parametrize("mode,nw", MODES)
def test_loader_batches_match_the_reference(mode, nw, shuffle, drop_last):
    t = _loader("torch", mode, nw, shuffle=shuffle, drop_last=drop_last)
    j = _loader("jax", mode, nw, shuffle=shuffle, drop_last=drop_last)
    for _ in range(2):        # two epochs: each reshuffles the same way
        got, want = _flat(t), _flat(j)
        _assert_batches(got, want)
    n = sum(len(b[1]) for b in got)
    assert n == (20 if drop_last else 22)


@pytest.mark.parametrize("mode,nw", MODES)
def test_mid_epoch_resume_is_exactly_once(mode, nw):
    full = _flat(_loader("torch", mode, nw, shuffle=True))
    for src in ("torch", "jax"):
        first = _loader(src, mode, nw, shuffle=True)
        it = iter(first)
        head = [next(it) for _ in range(2)]
        state = json.loads(json.dumps(first.state_dict()))
        assert state["cursor"] == 2 and state["epoch"] == 0
        resumed = _loader("torch", mode, nw, shuffle=True)
        resumed.set_state_dict(state)
        tail = _flat(resumed)
        _assert_batches(_flat(head) + tail, full)


def test_fast_forward_never_touches_the_skipped_samples():
    seen = []

    class Spy(tio.Dataset):
        def __len__(self):
            return 12

        def __getitem__(self, i):
            seen.append(i)
            return np.asarray([i], np.int64)

    a = tio.DataLoader(Spy(), batch_size=3, shuffle=True, seed=5,
                       places="cpu")
    order = [int(v) for b in a for v in b.numpy().ravel()]
    b = tio.DataLoader(Spy(), batch_size=3, shuffle=True, seed=5,
                       places="cpu")
    b.set_state_dict({"seed": 5, "epoch": 0, "cursor": 2})
    seen.clear()
    rest = [int(v) for bt in b for v in bt.numpy().ravel()]
    assert rest == order[6:] and sorted(seen) == sorted(order[6:])


def test_packing_collator_carry_rides_the_state():
    docs = [np.arange(n, dtype=np.int32) + 10 * i
            for i, n in enumerate([5, 4, 4, 3, 6, 2, 7, 5])]

    class Docs(tio.Dataset):
        def __len__(self):
            return len(docs)

        def __getitem__(self, i):
            return docs[i]

    def make():
        return tio.DataLoader(Docs(), batch_size=2, seed=3, places="cpu",
                              collate_fn=tio.PackingCollator(
                                  8, max_rows=1, carry_over=True))
    full = [b["ids"].numpy() for b in make()]
    a = make()
    it = iter(a)
    head = [next(it)["ids"].numpy() for _ in range(2)]
    state = json.loads(json.dumps(a.state_provider()()))
    assert state["collate"]["carry"]
    b = make()
    b.set_state_dict(state)
    tail = [x["ids"].numpy() for x in b]
    for g, w in zip(head + tail, full):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("replacement,num", [(False, None), (True, 30),
                                             (False, 7)])
def test_random_samplers_match_the_reference(replacement, num):
    data = list(range(20))
    t = tio.RandomSampler(data, replacement=replacement, num_samples=num,
                          generator=9)
    j = jio.RandomSampler(data, replacement=replacement, num_samples=num,
                          generator=9)
    assert list(t) == list(j) and len(t) == len(j)
    assert list(tio.SubsetRandomSampler([3, 5, 8, 13], generator=4)) == \
        list(jio.SubsetRandomSampler([3, 5, 8, 13], generator=4))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_samplers_match_the_reference(shuffle, drop_last):
    data = list(range(23))
    assert list(tio.BatchSampler(data, batch_size=5, drop_last=drop_last)) \
        == list(jio.BatchSampler(data, batch_size=5, drop_last=drop_last))
    for rank in range(3):
        t = tio.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        j = jio.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)


def test_seedless_draws_follow_paddle_seed(cpu_device):
    data = list(range(16))
    for make in (lambda: list(tio.RandomSampler(data)),
                 lambda: list(tio.WeightedRandomSampler(
                     np.arange(1, 17), 10)),
                 lambda: [v for b in tio.DataLoader(
                     tio.TensorDataset([np.arange(16)]), batch_size=4,
                     shuffle=True, places="cpu") for v in b[0].tolist()]):
        tpaddle.seed(77)
        a = make()
        tpaddle.seed(77)
        assert make() == a
    tpaddle.seed(1)
    parts = tio.random_split(tio.TensorDataset([np.arange(10)]), [0.7, 0.3])
    assert sorted(parts[0].indices + parts[1].indices) == list(range(10))
    assert [len(p) for p in parts] == [7, 3]


def test_datasets_match_the_reference():
    x = np.arange(12).reshape(6, 2)
    for mod in (tio, jio):
        ds = mod.ConcatDataset([mod.TensorDataset([x]),
                                mod.Subset(mod.TensorDataset([x]), [4, 1])])
        assert len(ds) == 8
        np.testing.assert_array_equal(np.asarray(ds[7][0]), x[1])
        comp = mod.ComposeDataset([mod.TensorDataset([x]),
                                   mod.TensorDataset([x * 2])])
        np.testing.assert_array_equal(np.asarray(comp[2][1]), x[2] * 2)


def test_batches_land_on_the_loaders_device():
    """``places`` first; else the current device, which is the card and
    raises without one unless the CPU was asked for."""
    ds = tio.TensorDataset([np.arange(8, dtype=np.float64).reshape(4, 2)])
    (b,) = next(iter(tio.DataLoader(ds, batch_size=4, places=["cpu"])))
    assert b.device.type == "cpu" and b.dtype == torch.float32
    prev = tpaddle.device._current_device
    try:
        tpaddle.device._current_device = None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                next(iter(tio.DataLoader(ds, batch_size=2)))
        tpaddle.set_device("cpu")
        (b,) = next(iter(tio.DataLoader(ds, batch_size=2)))
        assert b.device.type == "cpu"
    finally:
        tpaddle.device._current_device = prev


def test_process_workers_refuse_tensor_samples():
    class TensorRows(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return torch.ones(2)

    dl = tio.DataLoader(TensorRows(), batch_size=2, num_workers=1,
                        worker_mode="process", places="cpu")
    with pytest.raises(Exception, match="not tensors"):
        list(dl)


def test_fault_point_and_monitor_counters():
    ds = tio.TensorDataset([np.arange(8)])
    with tfaults.injected("dataloader.batch", action="raise", nth=2):
        it = iter(tio.DataLoader(ds, batch_size=2, places="cpu"))
        next(it)
        with pytest.raises(tfaults.FaultInjected):
            next(it)
    snaps = {}
    for pkg, M, F, mod, extra in (
            ("torch", TM, TF, tio, {"places": "cpu"}),
            ("jax", JM, JF, jio, {})):
        prev = F.flag_value("enable_monitor")
        M.reset()
        F.set_flags({"FLAGS_enable_monitor": True})
        try:
            dl = mod.DataLoader(mod.TensorDataset([np.arange(8)]),
                                batch_size=2, seed=1, **extra)
            list(dl)
            dl.set_state_dict({"seed": 1, "epoch": 1, "cursor": 3})
            list(dl)
            snaps[pkg] = M.snapshot()
        finally:
            F.set_flags({"FLAGS_enable_monitor": prev})
            M.reset()
    for pkg in snaps:
        assert snaps[pkg]["counters"]["dataloader.batches"] == 5
        assert snaps[pkg]["counters"][
            "data.resume.fast_forward_batches"] == 3
        assert "dataloader.last_epoch_batches_per_sec" in \
            snaps[pkg]["gauges"]
