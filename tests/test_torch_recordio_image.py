"""recordio and image of mxnet_tpu_torch against mxnet_tpu's, on the same
inputs: a ``.rec``/``.idx`` pack written by either package equals the
other's byte for byte and reads back in the other, in both record kinds
(encoded and pass-through) and with scalar and vector labels; the
decoders, the resize and crop helpers, every augmenter and
``CreateAugmenter``'s chains give the same arrays, the random ones after
the same seeds of ``random`` and ``np.random`` on each side (the free
functions draw from those modules, which both packages share)."""
import io
import random

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import image as mt_image
from mxnet_tpu_torch import recordio as mt_rio
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _images(n, h=20, w=26, seed=0):
    return RS(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)


def _jpeg(img, fmt="JPEG"):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, quality=90)
    return buf.getvalue()


def _label(i, kind):
    return float(i % 3) if kind == "scalar" else [float(i), 0.5 * i, 2.0]


def _write(rio, prefix, record, label, imgs, encoded):
    w = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, img in enumerate(imgs):
        header = rio.IRHeader(0, _label(i, label), i, 7)
        w.write_idx(i, rio.pack(header, encoded[i]) if record == "encoded"
                    else rio.pack_raw_img(header, img))
    w.close()


@pytest.mark.parametrize("label", ["scalar", "vector"])
@pytest.mark.parametrize("record", ["encoded", "raw"])
def test_packs_are_byte_equal_and_cross_read(mx, tmp_path, record, label):
    imgs = _images(5)
    encoded = [_jpeg(im) for im in imgs]
    for pkg, rio in (("mt", mt_rio), ("mx", mx.recordio)):
        _write(rio, str(tmp_path / pkg), record, label, imgs, encoded)
    for ext in (".rec", ".idx"):
        assert (tmp_path / ("mt" + ext)).read_bytes() == \
            (tmp_path / ("mx" + ext)).read_bytes()
    # each package reads the other's pack, by key and in sequence
    for writer, rio in (("mx", mt_rio), ("mt", mx.recordio)):
        p = str(tmp_path / writer)
        r = rio.MXIndexedRecordIO(p + ".idx", p + ".rec", "r")
        assert r.keys == list(range(5))
        seq = rio.MXRecordIO(p + ".rec", "r")
        for i in (3, 0, 4, 1, 2):
            header, payload = rio.unpack(r.read_idx(i))
            assert header.id == i and header.id2 == 7
            np.testing.assert_array_equal(
                np.asarray(header.label, np.float32).reshape(-1),
                np.asarray(_label(i, label), np.float32).reshape(-1))
            if record == "raw":
                assert rio.is_raw_img(payload)
                np.testing.assert_array_equal(rio.unpack_raw_img(payload),
                                              imgs[i])
            else:
                assert payload == encoded[i]
        for i in range(5):
            assert rio.unpack(seq.read())[0].id == i
        assert seq.read() is None
        r.close()
        seq.close()


def test_frame_layout_and_errors(tmp_path):
    """A record is the magic, its length and the payload padded to 4
    bytes; a bad magic raises, as do a bad flag and oversized raw dims."""
    p = str(tmp_path / "f.rec")
    w = mt_rio.MXRecordIO(p, "w")
    w.write(b"abcde")
    w.close()
    raw = open(p, "rb").read()
    assert raw == (b"\x0a\x23\xd7\xce" + (5).to_bytes(4, "little")
                   + b"abcde\x00\x00\x00")
    with open(p, "wb") as f:
        f.write(b"\x00" * 12)
    with pytest.raises(mt.MXNetError, match="magic"):
        mt_rio.MXRecordIO(p, "r").read()
    with pytest.raises(ValueError):
        mt_rio.MXRecordIO(p, "x")
    with pytest.raises(ValueError, match="65535"):
        mt_rio.pack_raw_img(mt_rio.IRHeader(0, 0.0, 0, 0),
                            np.zeros((70000, 1), np.uint8))
    gray = mt_rio.pack_raw_img(mt_rio.IRHeader(0, 1.0, 0, 0),
                               np.ones((4, 5), np.uint8))
    assert mt_rio.unpack_raw_img(mt_rio.unpack(gray)[1]).shape == (4, 5, 1)


def test_pack_img_with_opencv_matches(mx):
    cv2 = pytest.importorskip("cv2")
    img = _images(1)[0]
    header = mt_rio.IRHeader(0, 2.0, 4, 0)
    for fmt in (".jpg", ".png"):
        got = mt_rio.pack_img(header, img, quality=3 if fmt == ".png"
                              else 90, img_fmt=fmt)
        want = mx.recordio.pack_img(header, img, quality=3 if fmt == ".png"
                                    else 90, img_fmt=fmt)
        assert got == want
        h, dec = mt_rio.unpack_img(got)
        h2, dec2 = mx.recordio.unpack_img(want)
        assert h == h2
        np.testing.assert_array_equal(dec, dec2)
    assert cv2 is not None


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_and_imencode_match(mx, flag, to_rgb):
    img = _images(1)[0]
    for fmt in (".jpg", ".png"):
        got = mt_image.imencode(img, fmt, quality=85)
        assert got == mx.image.imencode(img, fmt, quality=85)
        dec = mt_image.imdecode(got, flag=flag, to_rgb=to_rgb)
        assert dec.context == mt.cpu() and dec.dtype == np.uint8
        np.testing.assert_array_equal(
            dec.asnumpy(),
            mx.image.imdecode(got, flag=flag, to_rgb=to_rgb).asnumpy())


def test_nd_imdecode_matches(mx):
    pytest.importorskip("cv2")
    buf = _jpeg(_images(1)[0], "PNG")
    mean = RS(1).uniform(0, 50, (1, 3, 20, 26)).astype(np.float32)
    got = mt.nd.imdecode(buf, clip_rect=(2, 3, 20, 15),
                         mean=mt.nd.array(mean[:, :, 3:15, 2:20],
                                          ctx=mt.cpu()), ctx=mt.cpu())
    want = mx.nd.imdecode(buf, clip_rect=(2, 3, 20, 15),
                          mean=mx.nd.array(mean[:, :, 3:15, 2:20]))
    assert got.context == mt.cpu() and got.shape == (1, 3, 12, 18)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def _same_draws(fn_mt, fn_mx, seed):
    """fn_mt() and fn_mx() after the same seeds of random and np.random."""
    random.seed(seed)
    np.random.seed(seed)
    a = fn_mt()
    random.seed(seed)
    np.random.seed(seed)
    b = fn_mx()
    return a, b


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_resize_and_crop_helpers_match(mx):
    img = _images(1, 30, 44)[0]
    src = mt.nd.array(img, ctx=mt.cpu(), dtype=np.uint8)
    msrc = mx.nd.array(img, dtype=np.uint8)
    for size in ((10, 10), (50, 20), (44, 44), (5, 60)):
        assert mt_image.scale_down((44, 30), size) == \
            mx.image.scale_down((44, 30), size)
    for interp in range(4):
        np.testing.assert_array_equal(
            mt_image.imresize(src, 17, 23, interp).asnumpy(),
            mx.image.imresize(msrc, 17, 23, interp).asnumpy())
    np.testing.assert_array_equal(mt_image.resize_short(src, 16).asnumpy(),
                                  mx.image.resize_short(msrc, 16).asnumpy())
    np.testing.assert_array_equal(
        mt_image.fixed_crop(src, 3, 4, 10, 12, size=(8, 8)).asnumpy(),
        mx.image.fixed_crop(msrc, 3, 4, 10, 12, size=(8, 8)).asnumpy())
    got, want = mt_image.center_crop(src, (20, 18)), \
        mx.image.center_crop(msrc, (20, 18))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0].asnumpy(), want[0].asnumpy())
    for seed in range(3):
        a, b = _same_draws(lambda: mt_image.random_crop(src, (16, 12)),
                           lambda: mx.image.random_crop(msrc, (16, 12)),
                           seed)
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0].asnumpy(), b[0].asnumpy())
        a, b = _same_draws(
            lambda: mt_image.random_size_crop(src, (12, 12), 0.3,
                                              (0.75, 1.333)),
            lambda: mx.image.random_size_crop(msrc, (12, 12), 0.3,
                                              (0.75, 1.333)), seed)
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0].asnumpy(), b[0].asnumpy())
    mean, std = [120.0, 110.0, 100.0], [50.0, 60.0, 70.0]
    got = mt_image.color_normalize(src, mean, std)
    assert got.context == mt.cpu()
    np.testing.assert_array_equal(
        got.asnumpy(), mx.image.color_normalize(msrc, mean, std).asnumpy())


EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]
AUGMENTERS = {
    "ResizeAug": lambda m: m.ResizeAug(16),
    "ForceResizeAug": lambda m: m.ForceResizeAug((12, 10)),
    "RandomCropAug": lambda m: m.RandomCropAug((12, 10)),
    "CenterCropAug": lambda m: m.CenterCropAug((12, 10)),
    "RandomSizedCropAug": lambda m: m.RandomSizedCropAug(
        (12, 10), 0.3, (0.75, 1.333)),
    "HorizontalFlipAug": lambda m: m.HorizontalFlipAug(0.5),
    "CastAug": lambda m: m.CastAug(),
    "BrightnessJitterAug": lambda m: m.BrightnessJitterAug(0.3),
    "ContrastJitterAug": lambda m: m.ContrastJitterAug(0.3),
    "SaturationJitterAug": lambda m: m.SaturationJitterAug(0.3),
    "ColorJitterAug": lambda m: m.ColorJitterAug(0.3, 0.3, 0.3),
    "LightingAug": lambda m: m.LightingAug(0.1, EIGVAL, EIGVEC),
    "RandomOrderAug": lambda m: m.RandomOrderAug(
        [m.BrightnessJitterAug(0.2), m.HorizontalFlipAug(0.5),
         m.ContrastJitterAug(0.2)]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_augmenter_matches(mx, name):
    """Five draws of each augmenter on one image, seeded alike."""
    img = _images(1, 24, 30)[0]
    aug_mt, aug_mx = AUGMENTERS[name](mt_image), AUGMENTERS[name](mx.image)

    def run(pkg, aug):
        src = pkg.nd.array(img, dtype=np.uint8,
                           **({"ctx": pkg.cpu()} if pkg is mt else {}))
        return [_np(aug(src)) for _ in range(5)]
    got, want = _same_draws(lambda: run(mt, aug_mt),
                            lambda: run(mx, aug_mx), 11)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


CHAINS = [dict(resize=20, rand_crop=True, rand_mirror=True, mean=True,
               std=True),
          dict(rand_crop=True, rand_resize=True, brightness=0.2,
               contrast=0.2, saturation=0.2, pca_noise=0.1),
          dict(mean=np.array([100.0, 90.0, 80.0])),
          dict(resize=18, inter_method=1)]


@pytest.mark.parametrize("kw", CHAINS, ids=["standard", "jitter", "mean",
                                             "bilinear"])
def test_create_augmenter_chains_match(mx, kw):
    img = _images(1, 28, 34)[0]
    augs_mt = mt_image.CreateAugmenter((3, 16, 16), **kw)
    augs_mx = mx.image.CreateAugmenter((3, 16, 16), **kw)
    assert len(augs_mt) == len(augs_mx)

    def run(pkg, augs):
        out = []
        for _ in range(3):
            x = pkg.nd.array(img, dtype=np.uint8,
                             **({"ctx": pkg.cpu()} if pkg is mt else {}))
            for a in augs:
                x = a(x)
            out.append(_np(x))
        return out
    got, want = _same_draws(lambda: run(mt, augs_mt),
                            lambda: run(mx, augs_mx), 5)
    for g, w in zip(got, want):
        assert g.shape == (16, 16, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
