"""RecordIO, the magic-framed binary record format of MXNet's image packs
(counterpart: mxnet_tpu/recordio.py).

The port's own copy of the wire format: each record is the magic
0xCED7230A, a little-endian word with the length in its lower 29 bits,
the payload and zero padding to 4 bytes; the ``.idx`` sidecar holds one
``key<TAB>offset`` line a record.  A pack written by either package reads
back byte for byte in the other.  Pure Python and numpy: nothing here
touches torch or the card.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError, smart_open

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img",
           "pack_raw_img", "is_raw_img", "unpack_raw_img"]

_KMAGIC = 0xCED7230A
_LFLAG_BITS = 29


def _pack_frame(data):
    """One record: magic, (cflag<<29|len), payload, pad to 4 bytes."""
    out = [struct.pack("<II", _KMAGIC, len(data)), data]
    pad = (4 - (len(data) % 4)) % 4
    if pad:
        out.append(b"\x00" * pad)
    return b"".join(out)


class MXRecordIO(object):
    """Sequential record reader or writer (parity: recordio.MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = smart_open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = smart_open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def __del__(self):
        self.close()

    def close(self):
        if getattr(self, "handle", None) is not None and self.is_open:
            self.handle.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self.handle.write(_pack_frame(buf))

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        self.handle.seek(pos)

    def read(self):
        """The next record's payload, or None at the end."""
        assert not self.writable
        header = self.handle.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _KMAGIC:
            raise MXNetError("invalid record magic")
        length = lrec & ((1 << _LFLAG_BITS) - 1)
        data = self.handle.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.handle.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random access through a ``.idx`` sidecar (parity:
    recordio.MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        else:
            self.fidx = None
            if os.path.exists(self.idx_path):
                with open(self.idx_path) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) < 2:
                            continue
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if getattr(self, "fidx", None) is not None and \
                not self.fidx.closed:
            self.fidx.close()
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        assert self.writable
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """An IRHeader and a payload as one record's bytes; a vector label
    goes in front of the payload, its length in ``flag`` (parity:
    recordio.pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                       header.id2) + s


def unpack(s):
    """A record's bytes as (IRHeader, payload) (parity: recordio.unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array, JPEG- or PNG-encoded by OpenCV (parity:
    recordio.pack_img)."""
    import cv2
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """(IRHeader, image array) of a record; a pass-through record needs no
    decoder (parity: recordio.unpack_img)."""
    header, s = unpack(s)
    if is_raw_img(s):
        return header, unpack_raw_img(s)
    import cv2
    img = cv2.imdecode(np.frombuffer(s, dtype=np.uint8), iscolor)
    return header, img


# A pass-through payload: RAW_IMG_MAGIC, three little-endian uint16 dims
# (H, W, C) and the raw uint8 HWC pixels (im2rec --pass-through).  The
# marker lives in the payload, not in header.flag, which counts a vector
# label's entries.  No encoded image format starts with these bytes.
RAW_IMG_MAGIC = b"MXRW"


def pack_raw_img(header, img):
    """Pack an (H, W, C) uint8 array without encoding (parity:
    recordio.pack_raw_img): readers skip the decode."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if h > 0xFFFF or w > 0xFFFF or c > 0xFFFF:
        raise ValueError("pass-through records store uint16 dims; image "
                         "%dx%dx%d exceeds 65535 (resize before packing)"
                         % (h, w, c))
    payload = RAW_IMG_MAGIC + struct.pack("<HHH", h, w, c) + img.tobytes()
    return pack(header, payload)


def is_raw_img(payload):
    """True when a record payload is a pass-through raw image."""
    return isinstance(payload, (bytes, bytearray)) and \
        payload[:4] == RAW_IMG_MAGIC


def unpack_raw_img(payload):
    """A pass-through payload as a writable (H, W, C) uint8 array."""
    h, w, c = struct.unpack("<HHH", payload[4:10])
    arr = np.frombuffer(payload, dtype=np.uint8, offset=10)
    return arr.reshape(h, w, c).copy()
