"""``Module`` over several contexts in mxnet_tpu_torch against mxnet_tpu's,
on the CPU: the data-parallel executor group, the kvstore decisions and
the update helpers of ``model``.

- The two-context ``test_save_load`` of tests/python/unittest/
  test_module.py:42, with the optimizer states saved through the store.
- ``Module.fit`` of two batches over [cpu(0), cpu(1)] with kvstore None,
  "local", "device" and a ``KVStore`` object: every parameter, moving
  statistic and optimizer state against the JAX package's two-context
  Module, within 1e-5 of its largest entry or of 1e-4 (two SGD-momentum
  steps of a small net in float32; both sum the devices' gradients in one
  order).
- ``update_on_kvstore`` off with a store, which ``Module`` takes only above
  16M elements a parameter: ``model._update_params(..., kvstore=...)`` on
  small arrays against the JAX package's, parameters, gradients and the
  ``Updater``'s states by index ``index * num_device + k``.
- ``model._create_kvstore``'s decisions, the 16M rule read from shapes.
- ``get_outputs`` merged and unmerged, input gradients, ``work_load_list``
  and ``_split_input_slice`` with uneven workloads; the fused fit's
  fallback logged for several contexts; the same context twice; one
  context with a ``KVStore`` object, the fused fit on the store's
  updater.
"""
import logging
from types import SimpleNamespace

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from test_torch_threads import torch_threads_per_worker  # noqa: F401

RS = np.random.RandomState
TOL = 1e-5
SCALE_MIN = 1e-4
CTX2 = ("cpu", 0), ("cpu", 1)


@pytest.fixture
def mx():
    pytest.importorskip("jax")
    return pytest.importorskip("mxnet_tpu")


def _ctxs(pkg, spec=CTX2):
    return [pkg.Context(t, i) for t, i in spec]


def _net(pkg):
    S = pkg.sym
    fc = S.FullyConnected(S.Variable("data"), num_hidden=16, name="fc1")
    bn = S.BatchNorm(fc, fix_gamma=False, name="bn1")
    act = S.Activation(bn, act_type="relu")
    out = S.FullyConnected(act, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(out, name="softmax")


def _data(n=60, seed=0):
    rs = RS(seed)
    return (rs.randn(n, 10).astype(np.float32),
            rs.randint(0, 4, n).astype(np.float32))


def _params(seed=1):
    shapes = dict(zip(_net(mt).list_arguments(), _net(mt).infer_shape(
        data=(30, 10), softmax_label=(30,))[0]))
    rs = RS(seed)
    return {n: rs.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in shapes.items() if n not in ("data",
                                                    "softmax_label")}


def _close(got, want, what):
    """Within TOL of the largest entry, or of SCALE_MIN where all are
    smaller (fc1's bias feeds a BatchNorm: its gradient and momentum are 0
    up to rounding, ~1e-10)."""
    scale = max(float(np.abs(want).max()), SCALE_MIN)
    assert np.abs(got - want).max() <= TOL * scale, \
        (what, float(np.abs(got - want).max()), scale)


def _states(mod):
    """{index: tuple of numpy arrays} of the module's optimizer states,
    the store's when the update runs there."""
    upd = mod._kvstore._updater if mod._update_on_kvstore else mod._updater
    out = {}
    for k, st in upd.states.items():
        st = st if isinstance(st, tuple) else (st,)
        out[k] = tuple(s.asnumpy() for s in st if s is not None)
    return out


def _kvstore(pkg, kind):
    return pkg.kv.create("local") if kind == "object" else kind


def _fit(pkg, kind, params):
    x, y = _data()
    it = pkg.io.NDArrayIter(x, y, batch_size=30, shuffle=False)
    mod = pkg.Module(_net(pkg), context=_ctxs(pkg))
    mod.fit(it, num_epoch=1, kvstore=_kvstore(pkg, kind),
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in params.items()},
            aux_params={"bn1_moving_mean": pkg.nd.zeros((16,), pkg.cpu()),
                        "bn1_moving_var": pkg.nd.ones((16,), pkg.cpu())})
    arg, aux = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in list(arg.items())
                 + list(aux.items())}


@pytest.mark.parametrize("kind", [None, "local", "device", "object"])
def test_fit_two_contexts_matches_mxnet_tpu(mx, kind, caplog):
    params = _params()
    with caplog.at_level(logging.INFO):
        mod, got = _fit(mt, kind, params)
    assert "multi-context binding" in caplog.text
    jmod, want = _fit(mx, kind, params)
    assert mod._update_on_kvstore == jmod._update_on_kvstore == \
        (kind is not None)
    assert (mod._kvstore is None) == (kind is None)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)
    gs, ws = _states(mod), _states(jmod)
    assert sorted(gs) == sorted(ws)
    for k in ws:
        for a, b in zip(gs[k], ws[k]):
            _close(a, b, "state %s" % k)
    # both devices hold the same parameters after the update
    for name, (a, b) in zip(mod._exec_group.param_names,
                            mod._exec_group.param_arrays):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy(), name)
        assert (a.context, b.context) == tuple(_ctxs(mt))


def test_save_load_two_contexts(mx, tmp_path):
    """(twin: test_module.py test_save_load, multi device) one update,
    save with the optimizer states (through the store: two contexts and
    "local" update on it), load into a module over the same contexts: the
    parameters and the store's states equal; the JAX package loads the
    port's checkpoint."""
    prefix = str(tmp_path / "test")
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=16)
    mod = mt.Module(net, ("data",), None, context=_ctxs(mt))
    mod.bind(data_shapes=[("data", (10, 10))])
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    assert mod._update_on_kvstore and mod._updater is None
    batch = mt.io.DataBatch(data=[mt.nd.array(RS(1).randn(10, 10),
                                              ctx=mt.cpu())])
    mod.forward(batch, is_train=True)
    mod.backward([mt.nd.ones((10, 16), ctx=mt.cpu())])
    mod.update()
    mod.save_checkpoint(prefix, 0, save_optimizer_states=True)
    mod2 = mt.Module.load(prefix, 0, load_optimizer_states=True,
                          data_names=("data",), label_names=None,
                          context=_ctxs(mt))
    mod2.bind(data_shapes=[("data", (10, 10))])
    mod2.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    assert mod._symbol.tojson() == mod2._symbol.tojson()
    a1, a2 = mod.get_params()[0], mod2.get_params()[0]
    assert set(a1) == set(a2)
    for k in a1:
        np.testing.assert_array_equal(a1[k].asnumpy(), a2[k].asnumpy())
    s1, s2 = _states(mod), _states(mod2)
    assert sorted(s1) == sorted(s2) == [0, 1]
    for k in s1:
        for a, b in zip(s1[k], s2[k]):
            np.testing.assert_array_equal(a, b)
    jmod = mx.Module.load(prefix, 0, data_names=("data",), label_names=None)
    for k, v in jmod._arg_params.items():
        np.testing.assert_array_equal(v.asnumpy(), a1[k].asnumpy())


def _update_arrays(pkg, n_dev=2, seed=3):
    """Two parameters on ``n_dev`` cpu devices: (param lists, grad lists),
    the gradients different on each device."""
    rs = RS(seed)
    ctxs = [pkg.Context("cpu", k) for k in range(n_dev)]
    params, grads = [], []
    for shape in ((3, 4), (5,)):
        w = rs.randn(*shape).astype(np.float32)
        params.append([pkg.nd.array(w, ctx=c) for c in ctxs])
        grads.append([pkg.nd.array(rs.randn(*shape).astype(np.float32),
                                   ctx=c) for c in ctxs])
    return params, grads


def test_update_params_with_store_not_on_it(mx):
    """``update_on_kvstore`` off with a store: the gradients pushed and the
    sum pulled back into each device's gradient, then each device's copy
    updated by the Updater under ``index * num_device + k``; twice."""
    got = {}
    for name, pkg in (("port", mt), ("jax", mx)):
        params, grads = _update_arrays(pkg)
        kv = pkg.kv.create("local")
        for idx, plist in enumerate(params):
            kv.init(idx, plist[0])
        opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                rescale_grad=0.5)
        upd = pkg.optimizer.get_updater(opt)
        for _ in range(2):
            pkg.model._update_params(params, grads, upd, num_device=2,
                                     kvstore=kv)
        got[name] = ([[w.asnumpy() for w in pl] for pl in params],
                     [[g.asnumpy() for g in gl] for gl in grads],
                     {k: v.asnumpy() for k, v in upd.states.items()})
    (pw, pg, ps), (jw, jg, js) = got["port"], got["jax"]
    assert sorted(ps) == sorted(js) == [0, 1, 2, 3]
    for a, b in zip(sum(pw, []) + sum(pg, []), sum(jw, []) + sum(jg, [])):
        _close(a, b, "array")
    for k in js:
        _close(ps[k], js[k], "state %d" % k)
    for pl, gl in zip(pw, pg):
        np.testing.assert_array_equal(pl[0], pl[1])
        np.testing.assert_array_equal(gl[0], gl[1])


@pytest.mark.parametrize("n_dev", [1, 2])
def test_update_params_in_process(mx, n_dev):
    """No store: the gradients summed in process over the devices (none to
    sum with one), each device's copy updated with its own state."""
    got = {}
    for name, pkg in (("port", mt), ("jax", mx)):
        params, grads = _update_arrays(pkg, n_dev)
        upd = pkg.optimizer.get_updater(pkg.optimizer.SGD(
            learning_rate=0.1, momentum=0.9))
        for _ in range(2):
            pkg.model._update_params(params, grads, upd, num_device=n_dev)
        got[name] = [w.asnumpy() for pl in params for w in pl] + \
            [upd.states[k].asnumpy() for k in sorted(upd.states)]
    assert len(got["port"]) == len(got["jax"])
    for a, b in zip(got["port"], got["jax"]):
        _close(a, b, "array")


def test_create_kvstore_decisions(mx):
    """The store and ``update_on_kvstore`` for each kvstore argument and
    device count, as the JAX package decides; the 16M rule from shapes
    (no such array is allocated); ``dist*`` refused by the port naming
    the distributed slice (the JAX package makes one)."""
    small = {"w": SimpleNamespace(shape=(3, 4))}
    big = {"w": SimpleNamespace(shape=(4097, 4096)),
           "b": SimpleNamespace(shape=(7,))}
    edge = {"w": SimpleNamespace(shape=(4096, 4096))}
    cases = [(None, 1, small), (None, 2, small), ("local", 1, small),
             ("device", 1, big), ("local", 2, small), ("device", 2, small),
             ("local", 2, big), ("local", 2, edge), ("device", 2, big),
             ("object", 1, small), ("object", 2, big)]
    for kind, n, params in cases:
        rows = []
        for pkg in (mt, mx):
            kv, on = pkg.model._create_kvstore(_kvstore(pkg, kind), n,
                                               params)
            rows.append((None if kv is None else kv.type, on))
        assert rows[0] == rows[1], (kind, n, rows)
    assert mt.model._create_kvstore("local", 2, big)[1] is False
    assert mt.model._create_kvstore("local", 2, edge)[1] is True
    for pkg, err in ((mt, TypeError), (mx, TypeError)):
        with pytest.raises(err):
            pkg.model._create_kvstore(object(), 2, small)
    # a dist store is made for any device count, with the update on it
    for n in (1, 2):
        rows = [(kv.type, on) for kv, on in (
            pkg.model._create_kvstore("dist_sync", n, small)
            for pkg in (mt, mx))]
        assert rows == [("dist_sync", True)] * 2


def _bound(pkg, workload=None):
    mod = pkg.Module(_net(pkg), context=_ctxs(pkg),
                     work_load_list=workload)
    mod.bind(data_shapes=[("data", (10, 10))],
             label_shapes=[("softmax_label", (10,))],
             inputs_need_grad=True)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in _params(5).items()},
                    aux_params={"bn1_moving_mean":
                                pkg.nd.zeros((16,), pkg.cpu()),
                                "bn1_moving_var":
                                pkg.nd.ones((16,), pkg.cpu())})
    x, y = _data(10, seed=6)
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                             label=[pkg.nd.array(y, ctx=pkg.cpu())])
    mod.forward(batch, is_train=True)
    mod.backward()
    return mod


@pytest.mark.parametrize("workload", [None, [1, 3]])
def test_outputs_and_input_grads_merged(mx, workload):
    """A forward and backward over [cpu(0), cpu(1)]: each executor binds
    its slice of the batch (by the workload), outputs and input gradients
    merge on the first context (their concatenation), unmerged they come
    a list a device; all equal the JAX package's."""
    mod, jmod = _bound(mt, workload), _bound(mx, workload)
    rows = [5, 5] if workload is None else [2, 8]
    assert [ex.arg_dict["data"].shape[0] for ex in mod._exec_group.execs] \
        == rows
    for got, want in ((mod.get_outputs(), jmod.get_outputs()),
                      (mod.get_input_grads(), jmod.get_input_grads())):
        assert len(got) == len(want) == 1
        assert got[0].shape == (10,) + want[0].shape[1:]
        assert got[0].context == mt.cpu(0)
        _close(got[0].asnumpy(), want[0].asnumpy(), "merged")
    un = mod.get_outputs(merge_multi_context=False)
    assert len(un) == 1 and [o.shape[0] for o in un[0]] == rows
    np.testing.assert_array_equal(
        np.concatenate([o.asnumpy() for o in un[0]]),
        mod.get_outputs()[0].asnumpy())
    assert len(mod.get_input_grads(merge_multi_context=False)[0]) == 2


def test_split_input_slice_uneven(mx):
    """The rows of each device by workload, as the JAX package splits."""
    from mxnet_tpu.module.executor_group import _split_input_slice as jsplit
    from mxnet_tpu_torch.module.executor_group import _split_input_slice
    for batch, work in ((10, [1, 1]), (10, [1, 2]), (7, [1, 1, 1]),
                        (32, [3, 1]), (5, [0.5, 0.25, 0.25]),
                        (9, [1, 1, 1, 1])):
        got = _split_input_slice(batch, work)
        assert got == jsplit(batch, work), (batch, work)
        assert got[0].start == 0 and got[-1].stop == batch
        assert all(a.stop == b.start for a, b in zip(got, got[1:]))
    for split in (_split_input_slice, jsplit):
        with pytest.raises(ValueError):
            split(2, [1, 1, 1])


def test_same_context_twice_and_feedforward():
    """[cpu(0), cpu(0)]: two executors with arrays of their own (no
    aliasing), equal after an update; FeedForward over two contexts trains
    through the same helpers."""
    mod = mt.Module(_net(mt), context=[mt.cpu(0), mt.cpu(0)])
    x, y = _data()
    it = mt.io.NDArrayIter(x, y, batch_size=30)
    mod.fit(it, num_epoch=1, kvstore="device",
            optimizer_params={"learning_rate": 0.05})
    e0, e1 = mod._exec_group.execs
    for n in e0.arg_dict:
        assert e0.arg_dict[n] is not e1.arg_dict[n]
        assert e0.arg_dict[n].value.data_ptr() != \
            e1.arg_dict[n].value.data_ptr()
    for n in mod._exec_group.param_names:
        np.testing.assert_array_equal(e0.arg_dict[n].asnumpy(),
                                      e1.arg_dict[n].asnumpy())
    ff = mt.model.FeedForward(_net(mt), ctx=_ctxs(mt), num_epoch=1,
                              numpy_batch_size=20)
    ff.fit(x, y)
    assert ff._module._kvstore is not None
    assert ff.predict(x).shape == (60, 4)


def test_one_context_fit_with_store_object(mx):
    """One context and a ``KVStore`` object: the update belongs to the
    store, and the fused fit takes its states from the store's updater and
    leaves the trained values in the store and the states in its updater,
    so a later ``update()`` on the general path continues from them; the
    parameters and states against the JAX package's fit."""
    params = _params()
    got = {}
    for name, pkg in (("port", mt), ("jax", mx)):
        x, y = _data()
        it = pkg.io.NDArrayIter(x, y, batch_size=30, shuffle=False)
        mod = pkg.Module(_net(pkg), context=pkg.cpu())
        mod.fit(it, num_epoch=2, kvstore=pkg.kv.create("local"),
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in params.items()},
                aux_params={"bn1_moving_mean":
                            pkg.nd.zeros((16,), pkg.cpu()),
                            "bn1_moving_var": pkg.nd.ones((16,), pkg.cpu())})
        assert mod._update_on_kvstore and mod._updater is None
        if pkg is mt:
            assert mod._fused_ts_cache is not None      # the fused path
        arg, _ = mod.get_params()
        store = mod._kvstore._store
        for i, n in enumerate(mod._exec_group.param_names):
            np.testing.assert_array_equal(store[i].asnumpy(),
                                          arg[n].asnumpy())
        got[name] = ({k: v.asnumpy() for k, v in arg.items()},
                     _states(mod))
    (pa, ps), (ja, js) = got["port"], got["jax"]
    for k in ja:
        _close(pa[k], ja[k], k)
    assert sorted(ps) == sorted(js)
    for k in js:
        for a, b in zip(ps[k], js[k]):
            _close(a, b, "state %s" % k)
