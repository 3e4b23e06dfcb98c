"""Pack an image list into a RecordIO file with the port (the twin of
``tools/im2rec.py``: the same flags, list format and records).

    python -m mxnet_tpu_torch.bench.im2rec <prefix> <root> --list
    python -m mxnet_tpu_torch.bench.im2rec <prefix> <root>
    python -m mxnet_tpu_torch.bench.im2rec <prefix> <root> --resize 256
    python -m mxnet_tpu_torch.bench.im2rec <prefix> <root> --pass-through

The list (``<prefix>.lst``) is tab-separated: index, label(s), the path
under ``<root>``; with ``--list`` the class directories under ``<root>``
give the labels (0, 1, ... in sorted order).  Packing writes
``<prefix>.rec`` and ``<prefix>.idx``: each image's bytes as they are,
re-encoded after ``--resize`` (the shorter side), or with
``--pass-through`` decoded once into raw uint8 pixels that the readers
take without a decode.  Runs on the host (PIL).
"""
import argparse
import os
import random
import sys

import numpy as np

from mxnet_tpu_torch import image as mt_image
from mxnet_tpu_torch import recordio


def make_list(prefix, root, recursive=True, train_ratio=1.0, shuffle=True,
              exts=(".jpg", ".jpeg", ".png")):
    """Write ``<prefix>.lst`` (and ``<prefix>_val.lst`` below a train
    ratio of 1) from the images under ``root``; returns their count."""
    paths = []
    if recursive:
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        label_of = {c: i for i, c in enumerate(classes)}
        for c in classes:
            for dirpath, _, files in os.walk(os.path.join(root, c)):
                for f in sorted(files):
                    if os.path.splitext(f)[1].lower() in exts:
                        rel = os.path.relpath(os.path.join(dirpath, f), root)
                        paths.append((label_of[c], rel))
    else:
        for f in sorted(os.listdir(root)):
            if os.path.splitext(f)[1].lower() in exts:
                paths.append((0, f))
    if shuffle:
        random.shuffle(paths)
    n_train = int(len(paths) * train_ratio)
    with open(prefix + ".lst", "w") as out:
        for i, (label, rel) in enumerate(paths[:n_train]):
            out.write("%d\t%f\t%s\n" % (i, label, rel))
    if train_ratio < 1.0:
        with open(prefix + "_val.lst", "w") as out:
            for i, (label, rel) in enumerate(paths[n_train:]):
                out.write("%d\t%f\t%s\n" % (i, label, rel))
    return len(paths)


def pack(prefix, root, resize=0, quality=95, num_thread=1,
         pass_through=False):
    """Pack the images of ``<prefix>.lst`` into ``<prefix>.rec`` and
    ``<prefix>.idx``; returns the record count."""
    record = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    count = 0
    with open(prefix + ".lst") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            with open(os.path.join(root, parts[-1]), "rb") as imgf:
                buf = imgf.read()
            label = labels[0] if len(labels) == 1 else labels
            header = recordio.IRHeader(0, label, idx, 0)
            if pass_through:
                img = mt_image.imdecode(buf)
                if resize > 0:
                    img = mt_image.resize_short(img, resize)
                payload = recordio.pack_raw_img(
                    header, np.asarray(img.asnumpy(), dtype=np.uint8))
            else:
                if resize > 0:
                    img = mt_image.resize_short(mt_image.imdecode(buf),
                                                resize)
                    buf = mt_image.imencode(img, quality=quality)
                payload = recordio.pack(header, buf)
            record.write_idx(idx, payload)
            count += 1
    record.close()
    return count


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("prefix")
    ap.add_argument("root")
    ap.add_argument("--list", action="store_true",
                    help="make the .lst file instead of packing")
    ap.add_argument("--recursive", action="store_true", default=True)
    ap.add_argument("--train-ratio", type=float, default=1.0)
    ap.add_argument("--no-shuffle", action="store_true")
    ap.add_argument("--resize", type=int, default=0)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--pass-through", action="store_true",
                    help="store raw uint8 pixels (decoded once here; the "
                         "readers skip the decode)")
    args = ap.parse_args(argv)
    if args.list:
        n = make_list(args.prefix, args.root, args.recursive,
                      args.train_ratio, not args.no_shuffle)
        print("wrote %d entries to %s.lst" % (n, args.prefix))
    else:
        n = pack(args.prefix, args.root, args.resize, args.quality,
                 pass_through=args.pass_through)
        print("packed %d records into %s.rec" % (n, args.prefix))
    return 0


if __name__ == "__main__":
    sys.exit(main())
