"""Repairs of chip_smoke.py's own faults that a CPU run can show.

- The image phase's checked fits draw their batches through
  ``image_checked_iter``: one decode thread, the constructor's epoch
  drained and one producer an epoch, so that two fits over the same
  records see the same batches, bit for bit.  Driven here as
  ``Module.fit`` drives an iterator (``iter()`` at an epoch's start,
  ``reset()`` at its end) at a toy size with the phase's settings.
- The CPU references are built once, by name
  (``reference``): from a job's file when the reference process runs it,
  otherwise in this process, and a job's floors as a table give the same
  check rows as the floor steps.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


@pytest.fixture
def toy_image(monkeypatch, tmp_path):
    """The image phase's records and train_imagenet arguments at a toy
    size: 24 records of 40x52, batches of 8 at 32x32."""
    from mxnet_tpu_torch.bench import train_imagenet as ti
    monkeypatch.setattr(cs, "IMAGE_RECORDS", 24)
    monkeypatch.setattr(cs, "IMAGE_RAW", (40, 52))
    monkeypatch.setattr(cs, "IMAGE", 32)
    monkeypatch.setattr(cs, "IMAGE_BATCH", 8)
    rec = str(tmp_path / "raw")
    cs.image_pack(mt, rec, jpeg=False)
    args = cs.imagenet_args(ti, "resnet50", cs.IMAGE_BATCH, cs.IMAGE_LR)
    args.data_train, args.data_train_idx = rec + ".rec", rec + ".idx"
    return ti, args


def _two_epochs(feed):
    """The batches of two epochs, drawn as Module.fit draws them."""
    out = []
    for _ in range(2):
        it = iter(feed)
        while True:
            try:
                b = next(it)
            except StopIteration:
                break
            out.append((b.data[0].asnumpy().copy(),
                        b.label[0].asnumpy().copy()))
        feed.reset()
    return out


def test_checked_image_feed_repeats_bitwise(toy_image):
    ti, args = toy_image
    runs = [_two_epochs(cs.image_checked_iter(ti, args, resize=-1))
            for _ in range(2)]
    nb = cs.IMAGE_RECORDS // cs.IMAGE_BATCH
    assert len(runs[0]) == len(runs[1]) == 2 * nb
    for (x1, y1), (x2, y2) in zip(*runs):
        assert x1.shape == (cs.IMAGE_BATCH, 3, cs.IMAGE, cs.IMAGE)
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
    # the epochs draw new crops (and the shuffle a new order)
    assert not np.array_equal(runs[0][0][0], runs[0][nb][0])


def test_one_producer_an_epoch(toy_image):
    """Through ``_OneProducer`` the fit's reset at an epoch's end starts no
    producer: the iterator's epoch token moves once an epoch."""
    ti, args = toy_image
    feed = cs.image_checked_iter(ti, args, resize=-1)
    start = feed.it._epoch_token
    _two_epochs(feed)
    assert feed.it._epoch_token == start + 2
    assert feed.batch_size == cs.IMAGE_BATCH
    assert feed.provide_data == feed.it.provide_data


def _rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[6:] == y[6:]
        np.testing.assert_allclose(x[:6], y[:6], rtol=0, atol=0)


def test_floor_table_gives_the_same_rows():
    rs = np.random.RandomState(0)

    def leaves(scale):
        return ({"w": torch.from_numpy(rs.randn(3, 4) * scale + 1.0),
                 "b": torch.from_numpy(rs.randn(4) * scale + 1.0)},
                {"m": torch.from_numpy(rs.randn(4) * scale + 2.0)})
    want = leaves(0.0)
    floors = [leaves(1e-7) for _ in range(3)]
    got = leaves(1e-6)
    kinds = ("grad", "aux")
    table = cs.floor_table(want, floors, kinds)
    assert set(table) == {(0, "w"), (0, "b"), (1, "m")}
    _rows_equal(cs.resnet50_leaf_rows(torch, got, want, table, kinds),
                cs.resnet50_leaf_rows(torch, got, want, floors, kinds))


def test_references_are_built_once_and_read_from_the_worker(monkeypatch,
                                                            tmp_path):
    """A job runs once in this process when no reference process runs it;
    a job the reference process built is read from its file (the worker
    writes each job whole, then renames it)."""
    calls = []

    def job(mt_):
        calls.append(1)
        return {"want": torch.arange(3.0)}
    monkeypatch.setattr(cs, "REF_JOBS", [("toy", job), ("toy2", job)])
    monkeypatch.setattr(cs, "_REF", {"dir": None, "proc": None,
                                     "names": (), "memo": {}})
    a = cs.reference(mt, "toy")
    b = cs.reference(mt, "toy")
    assert a is b and len(calls) == 1
    assert cs.reference(mt, "toy", keep=False) is a
    assert "toy" not in cs._REF["memo"]
    # the worker's side, run here: its file, then read by name
    cs._REF["memo"].clear()
    cs.reference_worker(str(tmp_path), ["toy2"], 1)
    assert os.listdir(str(tmp_path)) == ["toy2.pt"]

    class Alive(object):
        exitcode = None

        def is_alive(self):
            return True
    cs._REF.update(dir=str(tmp_path), proc=Alive(), names=["toy2"],
                   memo={})
    calls.clear()
    got = cs.reference(mt, "toy2")
    assert calls == [] and torch.equal(got["want"], torch.arange(3.0))
    assert os.listdir(str(tmp_path)) == []
