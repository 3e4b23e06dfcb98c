"""The port's ``kvstore`` (``local`` and ``device``) against mxnet_tpu's, on
the CPU: twins of the nine tests of tests/python/unittest/test_kvstore.py.

Each twin runs the same pushes and pulls through both packages, checks the
reference's exact values in each (the arithmetic is exact: sums of small
integers in float32) and the two packages' pulled arrays against each
other, bit for bit.  Devices are ``cpu(0..3)``: in the port they are one
torch device, in the JAX package the virtual CPU devices of
tests/conftest.py.  One difference is by design: the JAX package accepts
the ``dist*`` types (one process: rank 0 of 1), the port refuses them,
naming the distributed slice.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

SHAPE = (4, 4)
KEYS = [5, 7, 11]
DIST = ("dist_sync", "dist_async", "dist_sync_device", "dist_async_device",
        "dist", "dist_tpu")


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _init_kv(pkg, kv_type="local"):
    kv = pkg.kv.create(kv_type)
    kv.init(3, pkg.nd.zeros(SHAPE, pkg.cpu()))
    kv.init(KEYS, [pkg.nd.zeros(SHAPE, pkg.cpu())] * len(KEYS))
    return kv


def _flat(arrs):
    out = []
    for a in arrs:
        out.extend(_flat(a) if isinstance(a, list) else [a.asnumpy()])
    return out


def _twin(mx, body, want):
    """``body(pkg)`` -> arrays, in both packages: each equal to the scalar
    ``want`` (or its list) everywhere, and the two packages equal."""
    got = {}
    for name, pkg in (("port", mt), ("jax", mx)):
        arrs = _flat(body(pkg))
        wants = want if isinstance(want, list) else [want] * len(arrs)
        assert len(arrs) == len(wants), name
        for a, w in zip(arrs, wants):
            assert np.sum(np.abs(a - w)) == 0, (name, a, w)
        got[name] = arrs
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_init_pull(mx, kv_type):
    def body(pkg):
        kv = pkg.kv.create(kv_type)
        kv.init(3, pkg.nd.ones(SHAPE, pkg.cpu()) * 4)
        a = pkg.nd.zeros(SHAPE, pkg.cpu())
        kv.pull(3, out=a)
        return [a]
    _twin(mx, body, 4)


def test_single_kv_pair(mx):
    def body(pkg):
        kv = _init_kv(pkg)
        kv.push(3, pkg.nd.ones(SHAPE, pkg.cpu()))
        val = pkg.nd.empty(SHAPE, pkg.cpu())
        kv.pull(3, out=val)
        return [val]
    _twin(mx, body, 1)


def test_list_kv_pair(mx):
    def body(pkg):
        kv = _init_kv(pkg)
        kv.push(KEYS, [pkg.nd.ones(SHAPE, pkg.cpu()) * 4] * len(KEYS))
        val = [pkg.nd.empty(SHAPE, pkg.cpu()) for _ in KEYS]
        kv.pull(KEYS, out=val)
        return val
    _twin(mx, body, 4)


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_aggregator(mx, kv_type):
    """Values of one key on four devices sum; pulled into each device."""
    num_devs = 4

    def body(pkg):
        kv = _init_kv(pkg, kv_type)
        devs = [pkg.Context("cpu", i) for i in range(num_devs)]
        vals = [pkg.nd.ones(SHAPE, d) for d in devs]
        kv.push(3, vals)
        kv.pull(3, out=vals)
        lists = [[pkg.nd.ones(SHAPE, d) * 2.0 for d in devs] for _ in KEYS]
        kv.push(KEYS, lists)
        kv.pull(KEYS, out=lists)
        assert [v.context for v in vals] == devs
        return vals + lists
    _twin(mx, body, [num_devs] * 4 + [num_devs * 2.0] * 12)


def test_updater(mx):
    num_devs = 4
    num_push = 4

    def body(pkg):
        kv = _init_kv(pkg)
        kv.set_updater(lambda key, recv, local: local.__iadd__(recv))
        devs = [pkg.Context("cpu", i) for i in range(num_devs)]
        vals = [pkg.nd.ones(SHAPE, d) for d in devs]
        kv.push(3, vals)
        kv.pull(3, out=vals)
        lists = [[pkg.nd.ones(SHAPE, d) for d in devs] for _ in KEYS]
        for _ in range(num_push):
            kv.push(KEYS, lists)
        out = [pkg.nd.empty(SHAPE, pkg.cpu()) for _ in KEYS]
        kv.pull(KEYS, out=out)
        return vals + out
    _twin(mx, body, [num_devs] * 4 + [num_devs * num_push] * 3)


def test_no_updater_replaces(mx):
    """Without an updater a push replaces the stored value by the merged
    one: init ones, push 4 -> 4; push 2 -> 2, never accumulated; a
    duplicate key within one push sums."""
    def body(pkg):
        kv = pkg.kv.create()
        kv.init(3, pkg.nd.ones(SHAPE, pkg.cpu()))
        kv.push(3, pkg.nd.ones(SHAPE, pkg.cpu()) * 4)
        a = pkg.nd.empty(SHAPE, pkg.cpu())
        kv.pull(3, out=a)
        kv.push(3, pkg.nd.ones(SHAPE, pkg.cpu()) * 2)
        b = pkg.nd.empty(SHAPE, pkg.cpu())
        kv.pull(3, out=b)
        kv.push([3, 3], [pkg.nd.ones(SHAPE, pkg.cpu()),
                         pkg.nd.ones(SHAPE, pkg.cpu()) * 5])
        c = pkg.nd.empty(SHAPE, pkg.cpu())
        kv.pull(3, out=c)
        return [a, b, c]
    _twin(mx, body, [4, 2, 6])


def test_get_type_rank(mx):
    for pkg in (mt, mx):
        for kv_type in ("local", "device"):
            kv = pkg.kv.create(kv_type)
            assert (kv.type, kv.rank, kv.num_workers) == (kv_type, 0, 1)
        kv.barrier()


def test_test_optimizer_store_side(mx):
    """The optimizer on the store: w += rescale * merged (the Test rule)."""
    def body(pkg):
        kv = _init_kv(pkg)
        kv.set_optimizer(pkg.optimizer.create("test", 2.0))
        kv.push(3, [pkg.nd.ones(SHAPE, pkg.cpu(0)),
                    pkg.nd.ones(SHAPE, pkg.cpu(1))])
        val = pkg.nd.empty(SHAPE, pkg.cpu())
        kv.pull(3, out=val)
        return [val]
    _twin(mx, body, 4)


def test_unknown_type_raises(mx):
    """Unknown types raise in both packages; the ``dist*`` types are
    accepted by both, by ``create`` and by ``KVStore``: rank 0 of 1 in a
    process without the MXTPU_* contract."""
    for pkg in (mt, mx):
        with pytest.raises(Exception):
            pkg.kv.create("nope")
        with pytest.raises(TypeError):
            pkg.kv.create(3)
    for kv_type in DIST:
        for pkg in (mt, mx):
            for kv in (pkg.kv.create(kv_type), pkg.kvstore.KVStore(kv_type)):
                assert (kv.type, kv.rank, kv.num_workers) == (kv_type, 0, 1)
