"""The data iterators of mxnet_tpu_torch (``io``) against mxnet_tpu's, on
the same inputs: every NDArrayIter case of tests/python/unittest/test_io.py
(pad, discard, roll_over, the shuffle under one ``np.random`` seed, dict
inputs), CSVIter, ResizeIter, PrefetchingIter, MNISTIter on synthetic idx
files, the ``MXNET_DEVICE_PREFETCH`` depth knob and the four
DevicePrefetchIter cases.  Every batch is compared whole: data, label and
pad, and the port's arrays must lie on the host."""
import gzip
import struct
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _epoch(it):
    """[(data arrays, label arrays, pad)] of one pass; the port's on the
    host."""
    out = []
    for b in it:
        for a in list(b.data) + list(b.label or []):
            if isinstance(a, mt.nd.NDArray):
                assert a.context == mt.cpu(), a.context
        out.append(([a.asnumpy().copy() for a in b.data],
                    [a.asnumpy().copy() for a in b.label or []], b.pad))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _pad_data():
    datas = np.ones([1000, 2, 2])
    labels = np.ones([1000, 1])
    for i in range(1000):
        datas[i] = i / 100
        labels[i] = i / 100
    return datas, labels


@pytest.mark.parametrize("shuffle", [True, False])
def test_ndarray_iter_pad(mx, shuffle):
    """(twin: test_ndarray_iter_pad) 8 batches of 128 from 1000 rows, the
    last one padded from the epoch's start; with the shuffle both packages
    draw the same order from np.random."""
    datas, labels = _pad_data()
    got, want = [], []
    for pkg, out in ((mt, got), (mx, want)):
        np.random.seed(11)
        out += _epoch(pkg.io.NDArrayIter(datas, labels, 128, shuffle,
                                         last_batch_handle="pad"))
    _same(got, want)
    assert len(got) == 8 and got[-1][2] == 24
    if not shuffle:
        labelcount = np.bincount(np.concatenate(
            [lab[0].ravel() for _, lab, _ in got]).astype(int))
        assert labelcount[0] == 124 and (labelcount[1:] == 100).all()


@pytest.mark.parametrize("handle,n", [("discard", 4), ("roll_over", None)])
def test_ndarray_iter_last_batch(mx, handle, n):
    """(twins: test_ndarray_iter_discard, test_ndarray_iter_roll_over) two
    epochs; roll_over carries the tail into the next epoch."""
    x = np.arange(23).reshape(23, 1).astype(np.float32)
    got, want = [], []
    for pkg, out in ((mt, got), (mx, want)):
        it = pkg.io.NDArrayIter(x, None, batch_size=5,
                                last_batch_handle=handle)
        out += _epoch(it)
        it.reset()
        out += _epoch(it)
    _same(got, want)
    if n is not None:
        assert len(got) == 2 * n


def test_ndarray_iter_shuffle_deterministic(mx):
    """(twin) one np.random seed, one order, every row once."""
    x = np.arange(40).reshape(40, 1).astype(np.float32)
    got, want = [], []
    for pkg, out in ((mt, got), (mx, want)):
        np.random.seed(7)
        it = pkg.io.NDArrayIter(x, None, batch_size=10, shuffle=True)
        out += _epoch(it)
        it.reset()
        out += _epoch(it)
    _same(got, want)
    order = np.concatenate([d[0].ravel() for d, _, _ in got[:4]])
    assert sorted(order.tolist()) == list(range(40))
    assert not np.array_equal(order, np.arange(40))


def test_ndarray_iter_dict_data(mx):
    """(twin) dict inputs keep their names, in both packages' order."""
    data = {"a": np.zeros((12, 2), np.float32),
            "b": np.ones((12, 3), np.float32)}
    label = {"softmax_label": np.arange(12, dtype=np.float32)}
    its = [pkg.io.NDArrayIter(data, label, batch_size=4) for pkg in (mt, mx)]
    assert [(d.name, tuple(d.shape)) for d in its[0].provide_data] == \
        [(d.name, tuple(d.shape)) for d in its[1].provide_data]
    assert [(d.name, tuple(d.shape)) for d in its[0].provide_label] == \
        [(d.name, tuple(d.shape)) for d in its[1].provide_label]
    _same(_epoch(its[0]), _epoch(its[1]))


def test_csv_iter(mx, tmp_path):
    """(twin) 20 rows of 6 columns and a label file, batches of 5, and an
    18-row file whose last batch is padded."""
    path = str(tmp_path / "data.csv")
    lpath = str(tmp_path / "label.csv")
    data = RS(0).rand(20, 6).astype(np.float32)
    label = RS(1).randint(0, 3, (20, 1)).astype(np.float32)
    np.savetxt(path, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    got, want = [], []
    for pkg, out in ((mt, got), (mx, want)):
        out += _epoch(pkg.io.CSVIter(data_csv=path, data_shape=(6,),
                                     label_csv=lpath, batch_size=5))
    _same(got, want)
    np.testing.assert_allclose(np.concatenate([d[0] for d, _, _ in got]),
                               data, rtol=1e-5)
    short = str(tmp_path / "short.csv")
    np.savetxt(short, data[:18], delimiter=",")
    _same(_epoch(mt.io.CSVIter(data_csv=short, data_shape=(2, 3),
                               batch_size=5)),
          _epoch(mx.io.CSVIter(data_csv=short, data_shape=(2, 3),
                               batch_size=5)))


def test_resize_iter(mx):
    """(twin) 2 batches an epoch of a 6-batch iterator, then 8 over 6."""
    x = np.arange(30).reshape(30, 1).astype(np.float32)
    for size in (2, 8):
        got, want = [], []
        for pkg, out in ((mt, got), (mx, want)):
            it = pkg.io.ResizeIter(
                pkg.io.NDArrayIter(x, None, batch_size=5), size=size)
            out += _epoch(it)
            it.reset()
            out += _epoch(it)
        _same(got, want)
        assert len(got) == 2 * size


def test_prefetching_iter(mx):
    """(twin) the same batches as the base iterator, over two epochs, and
    two children renamed into one batch."""
    x = RS(0).rand(40, 3).astype(np.float32)
    y = RS(1).randint(0, 2, 40).astype(np.float32)
    got, want = [], []
    for pkg, out in ((mt, got), (mx, want)):
        pre = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, y, batch_size=8))
        out += _epoch(pre)
        pre.reset()
        out += _epoch(pre)
    _same(got, want)
    _same(got[:5], _epoch(mt.io.NDArrayIter(x, y, batch_size=8)))
    two = mt.io.PrefetchingIter(
        [mt.io.NDArrayIter(x, y, batch_size=8),
         mt.io.NDArrayIter(2 * x, y, batch_size=8)],
        rename_data=[{"data": "a"}, {"data": "b"}])
    assert [d.name for d in two.provide_data] == ["a", "b"]
    batches = _epoch(two)
    assert len(batches) == 5
    np.testing.assert_array_equal(batches[0][0][1], 2 * batches[0][0][0])


def test_mnist_iter_synthetic(mx, tmp_path):
    """(twin) idx-format files, unshuffled and shuffled by seed, flat."""
    img_path = str(tmp_path / "img.gz")
    lbl_path = str(tmp_path / "lbl.gz")
    n = 30
    imgs = RS(0).randint(0, 255, (n, 28, 28)).astype(np.uint8)
    lbls = RS(1).randint(0, 10, n).astype(np.uint8)
    with gzip.open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(imgs.tobytes())
    with gzip.open(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(lbls.tobytes())
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=3),
               dict(shuffle=False, flat=True)):
        got, want = [
            _epoch(pkg.io.MNISTIter(image=img_path, label=lbl_path,
                                    batch_size=10, **kw)) for pkg in (mt, mx)]
        _same(got, want)
        assert len(got) == 3
    np.testing.assert_array_equal(got[0][1][0].astype(int), lbls[:10])


def test_device_prefetch_depth_env(mx, monkeypatch):
    """(twin) MXNET_DEVICE_PREFETCH: unset/1 -> 2, 0 -> off, N -> N, junk
    -> MXNetError; both packages agree."""
    for raw, want in ((None, 2), ("1", 2), ("0", 0), ("5", 5)):
        if raw is None:
            monkeypatch.delenv("MXNET_DEVICE_PREFETCH", raising=False)
        else:
            monkeypatch.setenv("MXNET_DEVICE_PREFETCH", raw)
        assert mt.io.device_prefetch_depth() == \
            mx.io.device_prefetch_depth() == want
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "two")
    with pytest.raises(mt.MXNetError):
        mt.io.device_prefetch_depth()


def test_device_prefetch_iter_orders_and_stages():
    """(twin) order kept, staging on the producer thread, exhausted stays
    exhausted."""
    staged_on = []

    def stage(x):
        staged_on.append(threading.current_thread().name)
        return x * 10

    it = mt.io.DevicePrefetchIter(iter(range(6)), stage=stage)
    assert list(it) == [0, 10, 20, 30, 40, 50]
    assert staged_on and all(n != threading.main_thread().name
                             for n in staged_on)
    with pytest.raises(StopIteration):
        next(it)


def test_device_prefetch_iter_forwards_exceptions():
    def gen():
        yield 1
        raise ValueError("loader died")

    it = mt.io.DevicePrefetchIter(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="loader died"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_device_prefetch_iter_stage_error_forwarded():
    def bad_stage(x):
        raise RuntimeError("copy failed")

    it = mt.io.DevicePrefetchIter(iter([1, 2]), stage=bad_stage)
    with pytest.raises(RuntimeError, match="copy failed"):
        next(it)


def test_device_prefetch_iter_drain_unblocks_producer():
    """(twin) drain() ends a producer blocked on a full queue."""
    it = mt.io.DevicePrefetchIter(iter(range(100)), depth=2)
    assert next(it) == 0
    it.drain()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_staged_inputs_on_the_host():
    """StagedInputs on the CPU hands the host tensors on as they are (no
    stream, no event); the card's copy path is the cuda test's."""
    import torch
    host = {"data": torch.arange(6.0).reshape(2, 3),
            "softmax_label": torch.ones(2)}
    staged = mt.io.StagedInputs(host, torch.device("cpu"))
    got = staged.take()
    assert set(got) == set(host)
    for k in host:
        assert got[k] is host[k]


def test_image_iterators_name_their_slice():
    """The image iterators, which io once refused naming the image slice,
    resolve to that slice's module; other names still raise."""
    for name in ("ImageRecordIter", "ImageIter"):
        assert getattr(mt.io, name) is getattr(mt.image, name)
    with pytest.raises(AttributeError):
        mt.io.NoSuchIter
