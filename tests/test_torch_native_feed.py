"""Port parity: the native (C++) data feed (``paddle_tpu_torch/io/
native_feed.py`` over ``paddle_tpu_torch/csrc/datafeed.cc``, built by the
host C++ compiler) against the reference's (``paddle_tpu/io/
native_feed.py`` over ``csrc/datafeed.cc``).

The two sources share their C ABI and their shuffle, so the feeders give
the same batches, compared exactly, for the same seed: in order and
shuffled, with and without ``drop_last``, over two epochs, on one and on
three C++ threads; ``native_gather`` equals numpy's fancy indexing and
the reference's (after ``tests/test_io.py:301-375``) and refuses an
index past the rows. Without a compiler, or when the compile fails,
``worker_mode="native"`` raises and never falls back to another mode.
"""
import numpy as np
import pytest

from paddle_tpu.io import native_feed as jnf
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.io import native_feed as tnf
from paddle_tpu_torch.kernels import _build


def _arrays(n=23):
    rng = np.random.default_rng(0)
    return [rng.normal(size=(n, 5)).astype(np.float32),
            np.arange(n, dtype=np.int64),
            rng.integers(0, 255, (n, 2, 3)).astype(np.uint8)]


def _run(mod, **kw):
    feeder = mod.NativeArrayFeeder(_arrays(), **kw)
    try:
        return list(feeder), len(feeder)
    finally:
        feeder.close()


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_feeder_batches_match_the_reference(shuffle, drop_last, threads):
    kw = dict(batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=1234,
              num_threads=threads, epochs=2)
    got, n_got = _run(tnf, **kw)
    want, n_want = _run(jnf, **kw)
    assert n_got == n_want == len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    ids = np.concatenate([b[1] for b in got[:len(got) // 2]])
    assert len(ids) == (20 if drop_last else 23)
    assert len(set(ids.tolist())) == len(ids)      # one epoch, no repeat


def test_native_gather_matches_numpy_and_the_reference():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(3000, 64)).astype(np.float32)
    idx = rng.integers(0, 3000, 777).astype(np.uint64)
    got = tnf.native_gather(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, jnf.native_gather(src, idx))
    with pytest.raises(IndexError, match="out of range"):
        tnf.native_gather(src, np.array([3000], np.uint64))


def test_feeder_rejects_bad_arguments():
    a = np.zeros((6, 2), np.float32)
    with pytest.raises(ValueError, match="epochs"):
        tnf.NativeArrayFeeder([a], batch_size=2, epochs=0)
    with pytest.raises(ValueError, match="dim 0"):
        tnf.NativeArrayFeeder([a, np.zeros(5)], batch_size=2)
    f = tnf.NativeArrayFeeder([a], batch_size=4)
    list(f)
    with pytest.raises(RuntimeError, match="one-shot"):
        list(f)
    f.close()


def test_loader_native_mode_refuses_what_it_cannot_honour():
    ds = tio.TensorDataset([np.arange(8)])
    with pytest.raises(ValueError, match="batch_sampler"):
        list(tio.DataLoader(ds, batch_sampler=tio.BatchSampler(
            ds, batch_size=2), worker_mode="native", places="cpu"))
    with pytest.raises(ValueError, match="collate_fn"):
        list(tio.DataLoader(ds, batch_size=2, collate_fn=lambda b: b,
                            worker_mode="native", places="cpu"))

    class NotArrays(tio.Dataset):
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return np.zeros(1)
    with pytest.raises(TypeError, match="array-backed"):
        list(tio.DataLoader(NotArrays(), batch_size=2,
                            worker_mode="native", places="cpu"))


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_native_mode_raises_when_the_feed_cannot_build(tmp_path,
                                                       monkeypatch,
                                                       compiler):
    """A fresh build directory and no usable compiler: the loader raises
    ``UnavailableError`` at its first batch, never yielding a batch from
    another mode."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(tnf, "_LIB", None)
    monkeypatch.delitem(_build._LIBS, "host:datafeed", raising=False)
    if compiler == "missing":
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        match = "no host C\\+\\+ compiler"
    else:
        monkeypatch.setenv("CXX", "false")
        match = "host build of datafeed failed"
    assert not tnf.native_available()
    dl = tio.DataLoader(tio.TensorDataset([np.arange(8)]), batch_size=2,
                        worker_mode="native", places="cpu")
    with pytest.raises(TE.UnavailableError, match=match):
        next(iter(dl))
