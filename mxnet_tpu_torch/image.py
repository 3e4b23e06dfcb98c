"""Image decode, augmentation and the image iterators (counterpart:
mxnet_tpu/image.py).

Decode and augmentation run on the host, on numpy arrays and CPU
NDArrays (every NDArray this module makes lives on ``cpu()``; the port's
default context is the card).  PIL decodes and resizes; it is imported at
the first call that needs it, so ``import mxnet_tpu_torch`` works without
it.  The iterators yield host batches, NCHW float32 (or uint8), as every
iterator of the port does: ``Module.fit``'s device prefetch
(``io.DevicePrefetchIter`` + ``io.StagedInputs``) moves them to the card.

``ImageRecordIter``'s pipeline: a producer thread walks the RecordIO
stream (the ``.idx`` keys shuffled each epoch), a pool of
``preprocess_threads`` threads decodes and augments the samples, and
whole batches go through a bounded queue of ``prefetch_buffer``.  Crops
and mirrors draw from one ``random.Random(seed)`` that the pool's
threads share, so with more than one thread which image gets which crop
depends on scheduling; at one thread the batches are the JAX package's
bit for bit.  ``dtype="uint8"`` keeps the pixels uint8 (a quarter of the
bytes to the card), and the model normalises on the card.
"""
from __future__ import annotations

import io as _io
import os
import queue
import random as _pyrandom
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from . import io as mx_io
from . import ndarray as nd
from . import recordio

__all__ = ["imdecode", "imencode", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "random_size_crop",
           "color_normalize", "HorizontalFlipAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "RandomSizedCropAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "ColorJitterAug", "LightingAug", "CastAug",
           "RandomOrderAug", "CreateAugmenter", "ImageIter",
           "ImageRecordIter"]


def _pil():
    from PIL import Image
    return Image


def _host(arr, dtype=None):
    """A CPU NDArray of ``arr``."""
    return nd.array(arr, ctx=cpu(), dtype=dtype)


def _numpy(src):
    return src.asnumpy() if isinstance(src, nd.NDArray) else np.asarray(src)


# ------------------------------------------------------------------ decoding
def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded image to a CPU NDArray (H, W, C) uint8 (parity:
    mx.image.imdecode)."""
    Image = _pil()
    img = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        arr = np.asarray(img.convert("L"), np.uint8)[:, :, None]
    else:
        arr = np.asarray(img.convert("RGB"), np.uint8)
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return _host(arr.copy(), np.uint8)


def imencode(img, img_fmt=".jpg", quality=95):
    """Encode an (H, W, C) uint8 array or NDArray to bytes."""
    Image = _pil()
    arr = _numpy(img)
    pil = Image.fromarray(arr.astype(np.uint8).squeeze()
                          if arr.shape[-1] == 1 else arr.astype(np.uint8))
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    pil.save(buf, fmt, quality=quality)
    return buf.getvalue()


def imresize(src, w, h, interp=2):
    """Resize to exactly (w, h) (parity: mx.image.imresize)."""
    Image = _pil()
    arr = _numpy(src)
    squeeze = arr.shape[-1] == 1
    pil = Image.fromarray(arr.astype(np.uint8).squeeze() if squeeze
                          else arr.astype(np.uint8))
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.LANCZOS}.get(interp, Image.BICUBIC)
    out = np.asarray(pil.resize((w, h), resample))
    if squeeze:
        out = out[:, :, None]
    return _host(out.copy(), np.uint8)


def scale_down(src_size, size):
    """(w, h) scaled down to fit in ``src_size``, keeping the aspect
    (parity: mx.image.scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so that the shorter side is ``size`` (parity:
    mx.image.resize_short)."""
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a region, resized to ``size`` (w, h) when given."""
    out = _host(_numpy(src)[y0:y0 + h, x0:x0 + w].copy(), np.uint8)
    if size is not None and (w, h) != tuple(size):
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    """A random crop of ``size`` (w, h), scaled down to fit: (img, (x0,
    y0, w, h)) (parity: mx.image.random_crop; draws from ``random``)."""
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = scale_down((w, h), size)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """The centre crop of ``size`` (parity: mx.image.center_crop)."""
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """A crop of random area and aspect, resized to ``size`` (parity:
    mx.image.random_size_crop); the centre crop after 10 misses."""
    h, w = src.shape[0], src.shape[1]
    area = w * h
    for _ in range(10):
        new_area = _pyrandom.uniform(min_area, 1.0) * area
        new_ratio = _pyrandom.uniform(*ratio)
        new_w = int(round(np.sqrt(new_area * new_ratio)))
        new_h = int(round(np.sqrt(new_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std in float32 (parity: mx.image.color_normalize)."""
    arr = _numpy(src).astype(np.float32)
    arr = arr - np.asarray(mean, np.float32)
    if std is not None:
        arr = arr / np.asarray(std, np.float32)
    return _host(arr)


# ---------------------------------------------------------------- augmenters
class Augmenter(object):
    """An image -> image transform (parity: mx.image.Augmenter)."""

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    """Resize the shorter side to ``size``."""

    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Resize to (w, h), ignoring the aspect."""

    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2):
        self.size, self.min_area, self.ratio, self.interp = \
            size, min_area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    """Mirror left-right with probability ``p``."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _host(src.asnumpy()[:, ::-1].copy(), src.dtype)
        return src


class CastAug(Augmenter):
    def __call__(self, src):
        return _host(src.asnumpy().astype(np.float32))


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return _host(src.asnumpy().astype(np.float32) * alpha)


_GRAY = np.array([[[0.299, 0.587, 0.114]]], np.float32)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = src.asnumpy().astype(np.float32)
        gray = (arr * _GRAY).sum() * (3.0 / arr.size)
        return _host(arr * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = src.asnumpy().astype(np.float32)
        gray = (arr * _GRAY).sum(axis=2, keepdims=True)
        return _host(arr * alpha + gray * (1.0 - alpha))


class ColorJitterAug(Augmenter):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness, contrast, saturation):
        augs = []
        if brightness > 0:
            augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            augs.append(SaturationJitterAug(saturation))
        self.inner = RandomOrderAug(augs)

    def __call__(self, src):
        return self.inner(src)


class LightingAug(Augmenter):
    """PCA colour noise, AlexNet's (draws from ``np.random``)."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,)) \
            .astype(np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _host(src.asnumpy().astype(np.float32) + rgb)


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        self.ts = list(ts)

    def __call__(self, src):
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """The standard augmenter list (parity: mx.image.CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.3,
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and mean is not False:
        auglist.append(lambda src: color_normalize(src, mean, std))
    return auglist


def _label_desc(name, batch_size, label_width):
    shape = (batch_size,) if label_width == 1 else (batch_size, label_width)
    return [mx_io.DataDesc(name, shape)]


# ------------------------------------------------------------------ ImageIter
class ImageIter(mx_io.DataIter):
    """An image iterator over a RecordIO file (with or without its
    ``.idx``) or an image list, with an augmenter list (parity:
    mx.image.ImageIter).  One batch at a time on the calling thread; NCHW
    float32 host batches."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self.imgrec = None
        self.imgidx = None
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        self.imglist = None
        if path_imglist:
            self.imglist = {}
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
        elif imglist is not None:
            self.imglist = {}
            for i, (label, fname) in enumerate(imglist):
                self.imglist[i] = (np.array(label, np.float32).reshape(-1),
                                   fname)
        self.path_root = path_root
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.seq = list(self.imglist.keys()) if self.imglist is not None \
            else (list(self.imgidx) if self.imgidx is not None else None)
        if self.seq is not None and num_parts > 1:
            self.seq = self.seq[part_index::num_parts]
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **kwargs)
        self.auglist = aug_list
        self.data_name = data_name
        self.label_name = label_name
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [mx_io.DataDesc(self.data_name,
                               (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return _label_desc(self.label_name, self.batch_size,
                           self.label_width)

    def reset(self):
        if self.shuffle and self.seq is not None:
            _pyrandom.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def _unpack(self, s):
        header, img = recordio.unpack(s)
        if recordio.is_raw_img(img):
            img = recordio.unpack_raw_img(img)
        return header.label, img

    def next_sample(self):
        """(label, encoded bytes or a pass-through record's pixels)."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                return self._unpack(self.imgrec.read_idx(idx))
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root or "", fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        return self._unpack(s)

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                if isinstance(s, (bytes, bytearray)):
                    img = imdecode(s)
                elif isinstance(s, np.ndarray):
                    img = _host(s, np.uint8)
                else:
                    img = s
                for aug in self.auglist:
                    img = aug(img)
                arr = _numpy(img)
                if arr.shape[:2] != (h, w):
                    raise MXNetError(
                        "augmented image %s does not match data_shape %s"
                        % (arr.shape, self.data_shape))
                batch_data[i] = arr.astype(np.float32).transpose(2, 0, 1)
                batch_label[i] = np.asarray(label, np.float32).reshape(-1)[
                    :self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        label_out = batch_label[:, 0] if self.label_width == 1 \
            else batch_label
        mx_io._count_batch(self)
        return mx_io.DataBatch([nd.NDArray(torch.from_numpy(batch_data),
                                           ctx=cpu())],
                               [_host(label_out)], pad=self.batch_size - i,
                               provide_data=self.provide_data,
                               provide_label=self.provide_label)

    def __next__(self):
        return self.next()

    def __iter__(self):
        self.reset()
        return self


# ------------------------------------------------------------ ImageRecordIter
class ImageRecordIter(mx_io.DataIter):
    """The threaded RecordIO image iterator (parity:
    mx.image.ImageRecordIter, the reference's ImageRecordIter with its
    prefetcher).

    A producer thread reads the records (the ``.idx`` keys, this part's
    share of them, shuffled each epoch), a pool of ``preprocess_threads``
    decodes and augments them, and whole batches, contiguous NCHW, go
    through a queue of ``prefetch_buffer``.  ``reset()`` starts a new
    producer with a new epoch token: ``next()`` drops the batches an older
    producer still queues, and that producer stops at its next batch
    without an end marker.
    ``round_batch`` fills the last batch from the epoch's first (its
    ``pad`` says how many).  Augmentation: ``resize`` (the shorter side),
    ``rand_crop`` (else the centre), ``rand_mirror``, ``mean_r/g/b``,
    ``std_r/g/b`` and ``scale``; ``dtype="uint8"`` skips the three last,
    which then belong on the card."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 path_imgidx=None, shuffle=False, rand_crop=False,
                 rand_mirror=False, mean_img=None, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 resize=-1, preprocess_threads=4, prefetch_buffer=4,
                 round_batch=True, part_index=0, num_parts=1, seed=0,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", **kwargs):
        super().__init__(batch_size)
        self.dtype = np.dtype(dtype)
        if self.dtype == np.uint8 and (mean_r or mean_g or mean_b
                                       or std_r != 1.0 or std_g != 1.0
                                       or std_b != 1.0 or scale != 1.0):
            raise ValueError("dtype='uint8' emits raw pixels; apply "
                             "mean/std/scale on the device instead")
        self.path_imgrec = path_imgrec
        self.path_imgidx = path_imgidx
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.round_batch = round_batch
        self.part_index, self.num_parts = part_index, num_parts
        self.preprocess_threads = max(1, int(preprocess_threads))
        self.prefetch_buffer = max(1, int(prefetch_buffer))
        self.data_name, self.label_name = data_name, label_name
        self._rng = _pyrandom.Random(seed)
        self.resize = resize
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
        std = np.array([std_r, std_g, std_b], np.float32)
        self._mean = mean if mean.any() else None
        self._std = std if (std != 1.0).any() else None
        self._scale = scale
        self._queue = None
        self._producer = None
        self._epoch_token = 0
        self.reset()

    @property
    def provide_data(self):
        return [mx_io.DataDesc(self.data_name,
                               (self.batch_size,) + self.data_shape,
                               dtype=self.dtype)]

    @property
    def provide_label(self):
        return _label_desc(self.label_name, self.batch_size,
                           self.label_width)

    # ----------------------------------------------------------- decode path
    def _augment_one(self, raw):
        """A record's bytes -> ((C, H, W) pixels, label vector)."""
        header, img = recordio.unpack(raw)
        if recordio.is_raw_img(img):
            arr = recordio.unpack_raw_img(img)   # pass-through: no decode
        else:
            arr = imdecode(img).asnumpy()
        c, h, w = self.data_shape
        if self.resize > 0:
            arr = resize_short(arr, self.resize).asnumpy()
        ih, iw = arr.shape[:2]
        if self.rand_crop and (ih > h or iw > w):
            y0 = self._rng.randint(0, ih - h)
            x0 = self._rng.randint(0, iw - w)
        else:
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        if ih < h or iw < w:
            arr = imresize(arr, w, h).asnumpy()
            y0 = x0 = 0
        arr = arr[y0:y0 + h, x0:x0 + w]
        if self.rand_mirror and self._rng.random() < 0.5:
            arr = arr[:, ::-1]
        if self.dtype == np.uint8:
            out = np.ascontiguousarray(arr, np.uint8)
        else:
            out = arr.astype(np.float32)
            if self._mean is not None:
                out = out - self._mean
            if self._std is not None:
                out = out / self._std
            if self._scale != 1.0:
                out = out * self._scale
        label = np.asarray(header.label, np.float32).reshape(-1)
        return out.transpose(2, 0, 1), label[:self.label_width]

    def _records(self):
        """(the open reader, an iterator over this epoch's records)."""
        if self.path_imgidx:
            rec = recordio.MXIndexedRecordIO(self.path_imgidx,
                                             self.path_imgrec, "r")
            keys = list(rec.keys)[self.part_index::self.num_parts]
            if self.shuffle:
                self._rng.shuffle(keys)
            return rec, (rec.read_idx(k) for k in keys)
        rec = recordio.MXRecordIO(self.path_imgrec, "r")
        return rec, iter(rec.read, None)

    def _produce(self, token):
        """The producer thread of epoch ``token``: read, decode in the
        pool, queue whole batches, then the end marker (or the error)."""
        from concurrent.futures import ThreadPoolExecutor
        c, h, w = self.data_shape
        try:
            rec, raw_iter = self._records()
            first = None
            with ThreadPoolExecutor(self.preprocess_threads) as pool:
                done = False
                while not done and token == self._epoch_token:
                    raws = []
                    while len(raws) < self.batch_size:
                        try:
                            raws.append(next(raw_iter))
                        except StopIteration:
                            done = True
                            break
                    samples = list(pool.map(self._augment_one, raws))
                    if not samples:
                        break
                    pad = self.batch_size - len(samples)
                    if pad and self.round_batch and first is not None:
                        # wrap around to the epoch's first batch
                        data = np.concatenate(
                            [np.stack([s[0] for s in samples]),
                             first[0][:pad]])
                        label = np.concatenate(
                            [np.stack([s[1] for s in samples]),
                             first[1][:pad]])
                    else:
                        data = np.zeros((self.batch_size, c, h, w),
                                        self.dtype)
                        label = np.zeros((self.batch_size,
                                          self.label_width), np.float32)
                        for i, (d, l) in enumerate(samples):
                            data[i] = d
                            label[i] = l
                    if first is None:
                        first = (data.copy(), label.copy())
                    self._queue.put((token, data, label, pad))
            rec.close()
            if token == self._epoch_token:
                self._queue.put((token, None, None, None))   # end of epoch
        except Exception as e:   # forwarded to the consumer
            self._queue.put((token, e, None, None))

    # ------------------------------------------------------------- iteration
    def reset(self):
        self._epoch_token += 1
        self._queue = queue.Queue(maxsize=self.prefetch_buffer)
        self._producer = threading.Thread(
            target=self._produce, args=(self._epoch_token,), daemon=True)
        self._producer.start()

    def next(self):
        while True:
            token, data, label, pad = self._queue.get()
            if token == self._epoch_token:
                break   # else a batch of an older epoch's producer
        if isinstance(data, Exception):
            raise data
        if data is None:
            raise StopIteration
        label_out = label[:, 0] if self.label_width == 1 else label
        mx_io._count_batch(self)
        # the producer made ``data`` for this batch alone: no copy
        return mx_io.DataBatch([nd.NDArray(torch.from_numpy(data),
                                           ctx=cpu())],
                               [_host(label_out)], pad=pad,
                               provide_data=self.provide_data,
                               provide_label=self.provide_label)

    def __next__(self):
        return self.next()

    def __iter__(self):
        self.reset()
        return self
