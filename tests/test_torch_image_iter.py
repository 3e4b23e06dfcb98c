"""ImageIter and ImageRecordIter of mxnet_tpu_torch against mxnet_tpu's on
the same records and seeds, at one decode thread: every batch bitwise
equal (data, label, pad, dtype) over two epochs, float32 and uint8,
``round_batch``, the ``.idx`` shuffle, ``part_index``, resizes, vector
labels; a ``reset()`` in mid-epoch; ``io``'s lazy names and the
``io_batches`` counter; the LeNet fit from records of the JAX package's
test_image.py held to its fit by the float32 floor rule; the uint8 feed
through the fused fit; ``bench/im2rec.py`` against tools/im2rec.py and
``bench/train_imagenet.py --data-train`` at toy size.  The card cases
(cuda) skip here.

The iterators are driven with ``next()`` from their construction: the
constructor starts the first epoch's producer, and ``iter()`` would start
a second one whose crops draw from the same generator while the first is
still drawing."""
import os
import random
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import recordio as mt_rio
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOOR_X = 4.0
FLOOR_MIN = 1e-6
NUDGE = 2.0 ** -20


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    mx = pytest.importorskip("mxnet_tpu")
    import mxnet_tpu.image  # noqa: F401
    import mxnet_tpu.models  # noqa: F401
    return mx


def _pack(prefix, n=13, size=(22, 27), kind="raw", label_width=1, seed=0):
    """``n`` random images packed by the port; returns the images."""
    from PIL import Image
    import io
    imgs = RS(seed).randint(0, 256, (n,) + size + (3,)).astype(np.uint8)
    w = mt_rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, img in enumerate(imgs):
        label = float(i % 4) if label_width == 1 else \
            [float(i), float(i % 2), 3.0][:label_width]
        header = mt_rio.IRHeader(0, label, i, 0)
        if kind == "raw":
            w.write_idx(i, mt_rio.pack_raw_img(header, img))
        else:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=90)
            w.write_idx(i, mt_rio.pack(header, buf.getvalue()))
    w.close()
    return imgs


def _drain(it):
    """[(data, label, pad, dtype)] of one epoch through next()."""
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        if isinstance(b.data[0], mt.nd.NDArray):
            assert b.data[0].context == mt.cpu()
            assert b.label[0].context == mt.cpu()
        out.append((b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                    b.pad, b.data[0].dtype))


def _two_epochs(it):
    first = _drain(it)
    it.reset()
    return first + _drain(it)


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp, gt), (wd, wl, wp, wt) in zip(got, want):
        assert gp == wp and np.dtype(gt) == np.dtype(wt)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


RECORD_CASES = {
    "float32_shuffle": dict(shuffle=True, rand_crop=True, rand_mirror=True,
                            mean_r=10.0, mean_g=20.0, mean_b=30.0,
                            std_r=2.0, std_g=3.0, std_b=4.0, scale=0.5),
    "uint8": dict(shuffle=True, rand_crop=True, rand_mirror=True,
                  dtype="uint8"),
    "no_round_batch": dict(round_batch=False, rand_crop=True),
    "part_index": dict(num_parts=2, part_index=1, shuffle=True,
                       rand_mirror=True),
    "no_idx": dict(path_imgidx=None, rand_crop=True, rand_mirror=True),
    "jpeg_resize": dict(kind="jpeg", resize=18, rand_crop=True,
                        shuffle=True),
    "upscale": dict(size=(12, 14), rand_crop=True),
    "label_width": dict(label_width=2, shuffle=True, rand_crop=True),
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_image_record_iter_matches(mx, tmp_path, case):
    kw = dict(RECORD_CASES[case])
    prefix = str(tmp_path / "r")
    _pack(prefix, kind=kw.pop("kind", "raw"), size=kw.pop("size", (22, 27)),
          label_width=kw.get("label_width", 1))
    kw.setdefault("path_imgidx", prefix + ".idx")
    kw.update(path_imgrec=prefix + ".rec", data_shape=(3, 16, 16),
              batch_size=5, preprocess_threads=1, seed=3)
    got = _two_epochs(mt.io.ImageRecordIter(**kw))
    want = _two_epochs(mx.io.ImageRecordIter(**kw))
    _same(got, want)
    n = 13 if kw.get("num_parts", 1) == 1 else 6
    assert sum(5 - p for _, _, p, _ in got) == 2 * n


IMAGE_ITER_CASES = ["rec_idx_shuffle", "rec_sequential", "imglist",
                    "path_imglist_parts"]


@pytest.mark.parametrize("case", IMAGE_ITER_CASES)
def test_image_iter_matches(mx, tmp_path, case):
    from PIL import Image
    prefix = str(tmp_path / "r")
    imgs = _pack(prefix)
    kw = dict(batch_size=4, data_shape=(3, 16, 16), rand_crop=True,
              rand_mirror=True)
    if case == "rec_idx_shuffle":
        kw.update(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
                  shuffle=True, mean=True, std=True)
    elif case == "rec_sequential":
        kw.update(path_imgrec=prefix + ".rec", resize=20)
    else:
        root = tmp_path / "imgs"
        root.mkdir()
        lines, imglist = [], []
        for i, img in enumerate(imgs[:9]):
            Image.fromarray(img).save(str(root / ("%d.png" % i)))
            lines.append("%d\t%f\t%d.png\n" % (i, i % 3, i))
            imglist.append((float(i % 3), "%d.png" % i))
        if case == "imglist":
            kw.update(imglist=imglist, path_root=str(root), shuffle=True)
        else:
            (tmp_path / "l.lst").write_text("".join(lines))
            kw.update(path_imglist=str(tmp_path / "l.lst"),
                      path_root=str(root), num_parts=2, part_index=0)

    def run(pkg):
        random.seed(5)
        it = pkg.image.ImageIter(**kw)
        return _two_epochs(it)
    got, want = run(mt), run(mx)
    _same(got, want)
    assert got and all(d.shape == (4, 3, 16, 16) for d, _, _, _ in got)


def test_reset_in_mid_epoch(mx, tmp_path):
    """A reset() after one batch: the next epoch is whole and in order (the
    old producer's batches are dropped by their token), as in the JAX
    package, and the old producer stops."""
    prefix = str(tmp_path / "r")
    _pack(prefix, n=20)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 16, 16), batch_size=4, preprocess_threads=1,
              prefetch_buffer=1)
    full = _drain(mt.io.ImageRecordIter(**kw))
    runs = []
    for pkg in (mt, mx):
        it = pkg.io.ImageRecordIter(**kw)
        first = it.next()
        old = it._producer
        it.reset()
        runs.append([first.data[0].asnumpy()] + [d for d, _, _, _
                                                 in _drain(it)])
        if pkg is mt:
            old.join(timeout=30)
            assert not old.is_alive()
    for run in runs:
        assert len(run) == 1 + len(full) == 6
        for d, (w, _, _, _) in zip(run[1:], full):
            np.testing.assert_array_equal(d, w)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_io_names_and_batch_counter(tmp_path):
    prefix = str(tmp_path / "r")
    _pack(prefix, n=8)
    assert mt.io.ImageRecordIter is mt.image.ImageRecordIter
    assert mt.io.ImageIter is mt.image.ImageIter
    with pytest.raises(AttributeError):
        mt.io.NoSuchIter
    tel = mt.telemetry
    tel.start()
    try:
        _drain(mt.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                     data_shape=(3, 16, 16), batch_size=4))
        _drain(mt.image.ImageIter(4, (3, 16, 16),
                                  path_imgrec=prefix + ".rec"))
        counts = [e["tags"]["iter"] for e in tel.events()
                  if e.get("name") == "io_batches"]
    finally:
        tel.stop()
    assert counts == ["ImageRecordIter"] * 2 + ["ImageIter"] * 2


def test_uint8_refuses_host_normalisation(tmp_path):
    prefix = str(tmp_path / "r")
    _pack(prefix, n=4)
    with pytest.raises(ValueError, match="uint8"):
        mt.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                              data_shape=(3, 16, 16), batch_size=4,
                              dtype="uint8", mean_r=1.0)


def _lenet_params(pkg, seed=1, nudge=0.0, nudge_seed=None):
    net = pkg.models.lenet.get_symbol(num_classes=3)
    shapes = {"data": (8, 3, 24, 24), "softmax_label": (8,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = RS(seed)
    nrs = rs if nudge_seed is None else RS(nudge_seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        v = rs.uniform(-1, 1, s) * np.sqrt(3.0 / max(1, np.prod(s[1:])))
        args[n] = (v * (1 + nudge * nrs.uniform(-1, 1, s))).astype(
            np.float32)
    return args


def _lenet_fit(pkg, prefix, args):
    """test_image.py::test_train_lenet_from_recordio's fit (one decode
    thread, one warm epoch through next() first).  The JAX package's fit
    runs without its device prefetch: that one calls iter() on the
    epoch's iterator again, and ImageRecordIter.__iter__ resets, so a
    second producer would race the first for the crop generator."""
    it = pkg.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                path_imgidx=prefix + ".idx",
                                data_shape=(3, 24, 24), batch_size=8,
                                rand_crop=True, scale=1.0 / 255,
                                preprocess_threads=1)
    _drain(it)
    mod = pkg.Module(pkg.models.lenet.get_symbol(num_classes=3),
                     context=pkg.cpu())
    old = os.environ.get("MXNET_DEVICE_PREFETCH")
    if pkg is not mt:
        os.environ["MXNET_DEVICE_PREFETCH"] = "0"
    try:
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.05},
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in args.items()}, aux_params={})
    finally:
        if old is None:
            os.environ.pop("MXNET_DEVICE_PREFETCH", None)
        else:
            os.environ["MXNET_DEVICE_PREFETCH"] = old
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_lenet_fit_from_records_matches_mxnet_tpu(mx, tmp_path):
    """16 JPEG images of 28x28 in 3 classes packed by the port's im2rec
    twin, LeNet for one epoch: each parameter within FLOOR_X times the JAX
    fit's float32 floor, the largest distance of four JAX fits from
    parameters nudged by NUDGE (four, as the float32 floor rule samples:
    in two steps a nudge moves little, and what it does move is a max
    pool's near-tie, whose winner float32 rounding can flip)."""
    from PIL import Image
    from mxnet_tpu_torch.bench import im2rec
    root = tmp_path / "imgs"
    rs = RS(0)
    for i in range(16):
        d = root / ("class%d" % (i % 3))
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 255, (28, 28, 3)).astype(np.uint8)) \
            .save(str(d / ("img%d.jpg" % i)), "JPEG")
    prefix = str(tmp_path / "mnist_like")
    random.seed(0)
    assert im2rec.make_list(prefix, str(root)) == 16
    assert im2rec.pack(prefix, str(root)) == 16
    args = _lenet_params(mt)
    got = _lenet_fit(mt, prefix, args)
    want = _lenet_fit(mx, prefix, args)
    nudged = [_lenet_fit(mx, prefix, _lenet_params(mt, nudge=NUDGE,
                                                   nudge_seed=10 + i))
              for i in range(4)]
    moved = max(float(np.abs(got[k] - args[k]).max()) for k in args)
    assert moved > 1e-4

    def rel(a, k):
        return float(np.abs(a[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30))
    for k in want:
        floor = max(max(rel(n, k) for n in nudged), FLOOR_MIN)
        assert rel(got, k) <= FLOOR_X * floor, (k, rel(got, k), floor)


def test_fit_resets_the_iterator_once_an_epoch(tmp_path, monkeypatch):
    """A fused fit with the device prefetch on restarts an
    ImageRecordIter once at each epoch's start (and once at its end), so
    one producer draws the epoch's crops."""
    prefix = str(tmp_path / "r")
    _pack(prefix, n=8, size=(30, 30))
    calls = []
    real = mt.image.ImageRecordIter.reset

    def reset(self):
        calls.append(self._epoch_token)
        real(self)
    monkeypatch.setattr(mt.image.ImageRecordIter, "reset", reset)
    it = mt.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               data_shape=(3, 28, 28), batch_size=4,
                               rand_crop=True)
    mod = mt.Module(mt.models.lenet.get_symbol(num_classes=4),
                    context=mt.cpu())
    mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.01})
    assert mod._fused_ts_cache is not None
    assert calls == [0, 1, 2, 3, 4]


def _u8_net(S, image=28):
    prep = (S.Cast(S.Variable("data"), dtype="float32") - 127.5) * \
        (1.0 / 127.5)
    return mt.models.resnet.get_symbol(num_classes=4, num_layers=8,
                                       image_shape="3,%d,%d" % (image, image),
                                       data=prep)


def test_uint8_feed_through_the_fused_fit(tmp_path, monkeypatch):
    """dtype="uint8" batches reach the fused step as uint8 (nothing casts
    on the host) and train the Cast-prologue ResNet exactly as float32
    batches of the same pixels do."""
    prefix = str(tmp_path / "r")
    _pack(prefix, n=12, size=(36, 40))
    seen = []
    real = mt.module.module._FusedFit._host_batch

    def host_batch(self, batch):
        out = real(self, batch)
        seen.append(out["data"].dtype)
        return out
    monkeypatch.setattr(mt.module.module._FusedFit, "_host_batch",
                        host_batch)
    net = _u8_net(mt.sym)
    ts = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
    p, _, a = ts.init({"data": (4, 3, 28, 28)}, {"softmax_label": (4,)})
    runs = {}
    for dtype in ("uint8", "float32"):
        it = mt.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                   path_imgidx=prefix + ".idx",
                                   data_shape=(3, 28, 28), batch_size=4,
                                   rand_crop=True, rand_mirror=True,
                                   preprocess_threads=1, dtype=dtype)
        _drain(it)
        mod = mt.Module(net, context=mt.cpu())
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1,
                                                   "momentum": 0.9},
                arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in p.items()},
                aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in a.items()})
        assert mod._fused_ts_cache is not None
        runs[dtype] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert seen == [torch.uint8] * 3 + [torch.float32] * 3
    for k in runs["uint8"]:
        np.testing.assert_array_equal(runs["uint8"][k], runs["float32"][k])


@pytest.mark.parametrize("mode", ["plain", "resize", "pass_through"])
def test_im2rec_twin_matches_the_tool(mx, tmp_path, mode):
    """The port's im2rec twin writes the same .lst, .rec and .idx bytes as
    tools/im2rec.py (the same seed of ``random`` for the list's shuffle)."""
    from PIL import Image
    from mxnet_tpu_torch.bench import im2rec
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import im2rec as tool
    finally:
        sys.path.pop(0)
    root = tmp_path / "imgs"
    rs = RS(2)
    for i in range(7):
        d = root / ("c%d" % (i % 2))
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 255, (30, 24, 3)).astype(np.uint8)) \
            .save(str(d / ("%d.jpg" % i)), "JPEG")
    opts = {"plain": {}, "resize": {"resize": 16},
            "pass_through": {"pass_through": True, "resize": 20}}[mode]
    for name, m in (("mt", im2rec), ("mx", tool)):
        random.seed(4)
        assert m.make_list(str(tmp_path / name), str(root),
                           train_ratio=0.8) == 7
        assert m.pack(str(tmp_path / name), str(root), **opts) == 5
    for ext in (".lst", "_val.lst", ".rec", ".idx"):
        assert (tmp_path / ("mt" + ext)).read_bytes() == \
            (tmp_path / ("mx" + ext)).read_bytes(), ext
    # the command line
    assert im2rec.main([str(tmp_path / "cli"), str(root), "--list",
                        "--no-shuffle"]) == 0
    assert im2rec.main([str(tmp_path / "cli"), str(root),
                        "--pass-through"]) == 0
    r = mt_rio.MXRecordIO(str(tmp_path / "cli.rec"), "r")
    assert mt_rio.is_raw_img(mt_rio.unpack(r.read())[1])
    r.close()


def test_train_imagenet_from_records_on_the_host(tmp_path, capsys):
    """bench/train_imagenet.py --cpu --data-train at toy size: one JSON
    line with a finite loss a batch, data_wait and the batch count."""
    import json
    from mxnet_tpu_torch.bench import train_imagenet as ti
    prefix = str(tmp_path / "r")
    _pack(prefix, n=12, size=(40, 48))
    argv = ["--cpu", "--network", "resnet8", "--num-classes", "4",
            "--image-shape", "3,28,28", "--batch-size", "4",
            "--data-train", prefix + ".rec", "--data-train-idx",
            prefix + ".idx"]
    assert ti.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["batches"] == 3 and len(rec["batch_loss"]) == 3
    assert np.isfinite(rec["batch_loss"]).all()
    assert rec["data_wait_ms"] >= 0.0
    assert os.environ.get("MXNET_TELEMETRY_FUSED") is None
    assert not mt.telemetry.enabled()


# ----------------------------------------------------------- on the card
@pytest.mark.cuda
def test_fit_from_records_on_the_card(tmp_path):
    """LeNet from records on gpu(0) (centre crops: every epoch yields the
    same batches) equals the fit over an NDArrayIter of those batches, bit
    for bit (cuDNN deterministic); uint8 batches are staged on the card as
    uint8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    prefix = str(tmp_path / "r")
    _pack(prefix, n=16, size=(28, 30))
    args = _lenet_params(mt)
    it = mt.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               path_imgidx=prefix + ".idx",
                               data_shape=(3, 24, 24), batch_size=8,
                               scale=1.0 / 255)
    batches = _drain(it)
    runs = []
    for src in (it, mt.io.NDArrayIter(
            np.concatenate([b[0] for b in batches]),
            np.concatenate([b[1] for b in batches]), batch_size=8)):
        mod = mt.Module(mt.models.lenet.get_symbol(num_classes=3))
        mod.fit(src, num_epoch=1, optimizer_params={"learning_rate": 0.05},
                arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in args.items()}, aux_params={})
        runs.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    assert len(batches) == 2
    for k in runs[0]:
        assert np.isfinite(runs[0][k]).all()
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
    staged = []
    real = mt.module.module._FusedFit._stage

    def stage(self, batch):
        out = real(self, batch)
        staged.append(out._staged.tensors["data"].dtype)
        return out
    mt.module.module._FusedFit._stage = stage
    try:
        u8 = mt.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                   data_shape=(3, 28, 28), batch_size=4,
                                   dtype="uint8")
        mod = mt.Module(_u8_net(mt.sym))
        mod.fit(u8, num_epoch=1, optimizer_params={"learning_rate": 0.1})
    finally:
        mt.module.module._FusedFit._stage = real
    assert staged and set(staged) == {torch.uint8}
