"""The Python side of the native C API (counterpart: mxnet_tpu/capi.py).

``csrc/c_api.cc`` builds into a shared library (``ops/kernel_build.
HostLibrary``) that embeds CPython and calls these flat functions; its
header is ``include/mxnet_tpu/c_api.h`` (with ``c_predict_api.h``), the same
declarations as the JAX package's, so C and C++ programs (the cpp-package)
build against either library unchanged.  Every function takes and returns
simple types (ints, strings, bytes, tuples, lists); a handle on the C side
is a pointer to the Python object returned here.

Raw tensor bytes cross the boundary as little-endian float32 (the C predict
API's contract) unless a call says it is typed.

Device type codes are MXNet's: 1 ``cpu``, 2 ``gpu`` (the card), 3
``cpu_pinned``.  Any other code raises (the JAX package maps unknown codes
to the CPU; the port does not fall back), so the C call returns -1 with the
error in ``MXGetLastError``.  The calls that take no device (``MXNDArrayLoad``,
``MXNDArrayLoadFromRawBytes``, ``MXNDArrayCreateNone``) give host arrays, as
the JAX package's do.
"""
from __future__ import annotations

import weakref

import numpy as _np

from .base import MXNetError
from . import ndarray as nd
from . import random as _random
from . import symbol as sym_mod
from .context import Context, cpu
from .predictor import Predictor

_DEVTYPE = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
_DEVCODE = {v: k for k, v in _DEVTYPE.items()}


def _ctx(dev_type, dev_id):
    code = int(dev_type)
    if code not in _DEVTYPE:
        raise MXNetError("device type code %d is not a context of the port "
                         "(1 cpu, 2 gpu, 3 cpu_pinned)" % code)
    return Context(_DEVTYPE[code], int(dev_id))


# ------------------------------------------------------------------ ndarray
def nd_create(shape, dev_type, dev_id):
    return nd.zeros(tuple(int(x) for x in shape), ctx=_ctx(dev_type, dev_id))


def nd_create_none():
    """An empty handle (MXNDArrayCreateNone): a 0-d host array whose value
    a later producer (a kvstore pull, an op's output, a copy) replaces
    whole; MXNDArrayGetShape reports ndim 0 until then."""
    return nd.zeros((), ctx=cpu())


def nd_sync_copy_from(handle, data):
    arr = _np.frombuffer(data, dtype="<f4").reshape(handle.shape)
    handle[:] = arr


def nd_sync_copy_to(handle):
    return _np.ascontiguousarray(
        handle.asnumpy().astype("<f4", copy=False)).tobytes()


def nd_get_shape(handle):
    return tuple(int(x) for x in handle.shape)


def nd_save(fname, handles, names):
    if names:
        nd.save(fname, dict(zip(names, handles)))
    else:
        nd.save(fname, list(handles))


def nd_load(fname):
    data = nd.load(fname, ctx=cpu())
    if isinstance(data, dict):
        names = list(data)
        return [data[n] for n in names], names
    return list(data), []


def nd_waitall():
    nd.waitall()


def nd_wait_to_read(handle):
    handle.wait_to_read()


def nd_wait_to_write(handle):
    # one wait for the card's pending work covers both directions
    handle.wait_to_read()


def nd_save_raw_bytes(handle):
    return nd.save_raw_bytes(handle)


def nd_load_from_raw_bytes(data):
    return nd.load_from_raw_bytes(bytes(data), ctx=cpu())


# id(handle) -> [(tensor weakref, version, bytes)]: the host copies handed
# out by MXNDArrayGetData, dropped with their handle
_DATA_REFS = {}


def nd_get_data_f32(handle):
    """A host float32 copy whose buffer the C side hands out as
    MXNDArrayGetData; it is kept with the handle, so the pointer stays
    valid for the handle's lifetime (the header's contract).  Polling an
    array that has not changed (same tensor, same torch version counter)
    or whose contents are unchanged gives the same buffer; a changed
    array gets a new copy, and the earlier ones are kept, because a
    caller may hold their pointers.  Read-only: a write through the
    pointer does not reach the array (the cpp-package only reads
    through it)."""
    key = id(handle)
    refs = _DATA_REFS.get(key)
    if refs is None:
        refs = _DATA_REFS[key] = []
        weakref.finalize(handle, _DATA_REFS.pop, key, None)
    cur = handle.value
    last = refs[-1] if refs else None
    if last is not None and last[0]() is cur and last[1] == cur._version:
        return last[2]
    buf = _np.ascontiguousarray(
        handle.asnumpy().astype("<f4", copy=False)).tobytes()
    if last is not None and buf == last[2]:
        return last[2]
    refs.append((weakref.ref(cur), cur._version, buf))
    return buf


# ------------------------------------------------------------------- symbol
def list_all_op_names():
    from .ops import registry
    return sorted(registry.list_ops())


def symbol_create_from_json(json_str):
    return sym_mod.load_json(json_str)


def symbol_save_to_json(handle):
    return _sym(handle).tojson()


def symbol_list_arguments(handle):
    return list(_sym(handle).list_arguments())


def symbol_list_outputs(handle):
    return list(_sym(handle).list_outputs())


def symbol_list_auxiliary_states(handle):
    return list(_sym(handle).list_auxiliary_states())


def symbol_infer_shape(handle, names, shapes):
    kwargs = {n: tuple(s) for n, s in zip(names, shapes)}
    arg_shapes, out_shapes, aux_shapes = _sym(handle).infer_shape(**kwargs)
    if arg_shapes is None:
        return None
    return (tuple(map(tuple, arg_shapes)), tuple(map(tuple, out_shapes)),
            tuple(map(tuple, aux_shapes)))


def symbol_infer_shape_partial(handle, names, shapes):
    """Partial inference: unknown shapes come back as (), and the trailing
    flag says whether everything resolved (MXSymbolInferShapePartial's
    ``complete``)."""
    kwargs = {n: tuple(s) for n, s in zip(names, shapes)}
    arg_shapes, out_shapes, aux_shapes = \
        _sym(handle).infer_shape_partial(**kwargs)

    def norm(shapes_):
        return tuple(() if s is None else tuple(s) for s in (shapes_ or ()))
    groups = (norm(arg_shapes), norm(out_shapes), norm(aux_shapes))
    # judged on the shapes before the () normalisation: a 0-d shape is
    # resolved; None, or a shape holding MXNet's unknown dimension 0, is
    # not
    complete = int(arg_shapes is not None and all(
        s is not None and 0 not in tuple(s)
        for g in (arg_shapes, out_shapes, aux_shapes)
        for s in (g or ())))
    return groups + (complete,)


# ---------------------------------------------------------------- predictor
def pred_create(symbol_json, param_bytes, dev_type, dev_id, input_names,
                input_shapes):
    shapes = {n: tuple(int(x) for x in s)
              for n, s in zip(input_names, input_shapes)}
    ctx = _ctx(dev_type, dev_id)
    return Predictor(symbol_json, bytes(param_bytes), shapes,
                     ctx.device_type, ctx.device_id)


def pred_set_input(pred, name, data):
    shape = None
    for n in pred._input_names:
        if n == name:
            shape = pred._executor.arg_dict[n].shape
    if shape is None:
        raise MXNetError("unknown input %s (have %s)"
                         % (name, pred._input_names))
    arr = _np.frombuffer(data, dtype="<f4")
    pred.set_input(name, arr.reshape(shape))


def pred_create_partial(symbol_json, param_bytes, dev_type, dev_id,
                        input_names, input_shapes, output_names):
    shapes = {n: tuple(int(x) for x in s)
              for n, s in zip(input_names, input_shapes)}
    ctx = _ctx(dev_type, dev_id)
    return Predictor(symbol_json, bytes(param_bytes), shapes,
                     ctx.device_type, ctx.device_id,
                     output_names=list(output_names))


def pred_partial_forward(pred, step):
    return int(pred.partial_forward(int(step)))


def pred_forward(pred):
    pred.forward()


def pred_get_output_shape(pred, index):
    return tuple(int(x) for x in pred.get_output_shape(int(index)))


def pred_get_output(pred, index):
    out = pred.get_output(int(index))
    return _np.ascontiguousarray(out.astype("<f4", copy=False)).tobytes()


class _NDList(object):
    """An in-memory ``.params`` blob as an indexable list (MXNDList*, the
    mean-image loader).  Keys, float32 buffers and shapes are kept, so
    the C pointers stay valid while the handle lives."""

    def __init__(self, blob):
        data = nd.deserialize_arrays(blob)
        self.keys = list(data)
        arrays = [data[k] for k in self.keys]
        self.shapes = [tuple(int(x) for x in a.shape) for a in arrays]
        self.bufs = [_np.ascontiguousarray(
            a.float().numpy().astype("<f4", copy=False)).tobytes()
            for a in arrays]
        # shapes pre-packed as little-endian uint32 so the C side can hand
        # out a pointer that stays valid for the handle's lifetime
        self.shape_bufs = [_np.asarray(s, "<u4").tobytes() or b"\0"
                           for s in self.shapes]

    def __len__(self):
        return len(self.keys)


def ndlist_create(blob):
    lst = _NDList(bytes(blob))
    return lst, len(lst)


def ndlist_get(lst, index):
    """-> (key, data bytes, shape bytes, ndim); the list owns every one,
    so the C pointers into them live as long as the NDListHandle."""
    i = int(index)
    return lst.keys[i], lst.bufs[i], lst.shape_bufs[i], len(lst.shapes[i])


# ------------------------------------------------------------------- random
def random_seed(seed):
    _random.seed(int(seed))


# -------------------------------------------------- NDArray (extended surface)
_DTYPE_CODE = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
               4: "int32", 5: "int8", 6: "int64"}
_DTYPE_RCODE = {v: k for k, v in _DTYPE_CODE.items()}


def _dtype_of(code):
    if int(code) not in _DTYPE_CODE:
        raise MXNetError("unknown dtype code %d" % int(code))
    return _np.dtype(_DTYPE_CODE[int(code)])


def _code_of(dtype):
    name = _np.dtype(dtype).name
    if name not in _DTYPE_RCODE:
        raise MXNetError("dtype %s has no C API code" % name)
    return _DTYPE_RCODE[name]


def nd_create_ex(shape, dev_type, dev_id, dtype_code):
    return nd.zeros(tuple(int(x) for x in shape), ctx=_ctx(dev_type, dev_id),
                    dtype=_dtype_of(dtype_code))


def nd_get_dtype(handle):
    return _code_of(handle.dtype)


def nd_get_context(handle):
    ctx = handle.context
    return _DEVCODE[ctx.device_type], int(ctx.device_id)


def nd_slice(handle, begin, end):
    return handle[int(begin):int(end)]


def nd_at(handle, idx):
    return handle[int(idx)]


def nd_reshape(handle, shape):
    return handle.reshape(tuple(int(x) for x in shape))


def nd_sync_copy_from_typed(handle, data):
    arr = _np.frombuffer(data, dtype=handle.dtype).reshape(handle.shape)
    handle[:] = arr


def nd_sync_copy_to_typed(handle):
    return _np.ascontiguousarray(handle.asnumpy()).tobytes()


# ------------------------------------------------- op reflection + imperative
def _op_registry():
    from .ops import registry
    return registry


def atomic_symbol_info(op_name):
    """(name, doc, arg_names, arg_types, arg_descs, key_var_num_args):
    MXSymbolGetAtomicSymbolInfo, what the cpp-package's op.h generator
    reads."""
    op = _op_registry().get_op(str(op_name))
    params = op.normalize_attrs({})
    try:
        input_names = op.arg_names_for(params)
    except Exception:
        # ops whose inputs depend on mandatory attrs (Custom needs op_type)
        input_names = []
    arg_names = []
    arg_types = []
    arg_descs = []
    for n in input_names:
        arg_names.append(n)
        arg_types.append("NDArray-or-Symbol")
        arg_descs.append("input: %s" % n)
    for k in sorted(op.attr_types):
        arg_names.append(k)
        default = op.defaults.get(k)
        arg_types.append("string, optional, default='%s'" % (default,)
                         if k in op.defaults else "string, required")
        arg_descs.append("attribute %s" % k)
    return (op.name, op.doc or "", arg_names, arg_types, arg_descs,
            op.key_var_num_args or "")


def imperative_invoke(op_name, input_handles, keys, vals, out_handles):
    """Run one op eagerly on NDArray handles (MXImperativeInvoke).
    Returns the output NDArrays: new ones, or ``out_handles`` written in
    place."""
    attrs = dict(zip(keys, vals))
    from .ndarray import _invoke
    from .ops.registry import get_op
    if out_handles:
        op = get_op(str(op_name))
        n_vis = op.num_outputs_for(op.normalize_attrs(attrs))
        if len(out_handles) != n_vis:
            raise ValueError("op %s has %d outputs, got %d out handles"
                             % (op_name, n_vis, len(out_handles)))
    outs = _invoke(str(op_name), list(input_handles), attrs,
                   out=list(out_handles) if out_handles else None)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    return list(outs)


# ------------------------------------------------- Symbol (extended surface)
class _AtomicStub(object):
    """MXSymbolCreateAtomicSymbol's product: an op and its params waiting
    for MXSymbolCompose, which composes in place: the C handle keeps
    pointing at this stub, which then holds the composed graph."""

    def __init__(self, op_name, params):
        self.op_name = op_name
        self.params = params
        self.sym = None


def _sym(handle):
    if isinstance(handle, _AtomicStub):
        if handle.sym is None:
            raise ValueError("symbol %s not composed yet" % handle.op_name)
        return handle.sym
    return handle


def symbol_create_atomic(op_name, keys, vals):
    return _AtomicStub(str(op_name), dict(zip(keys, vals)))


def symbol_create_variable(name):
    return sym_mod.Variable(str(name))


def symbol_create_group(handles):
    return sym_mod.Group([_sym(h) for h in handles])


def symbol_compose(handle, name, keys, arg_handles):
    """MXSymbolCompose, in place on the handle."""
    args = [_sym(h) for h in arg_handles]
    if not isinstance(handle, _AtomicStub):
        raise ValueError("can only compose an atomic symbol")
    kwargs = dict(handle.params)
    if name:
        kwargs["name"] = str(name)
    if keys:
        named = dict(zip(keys, args))
        handle.sym = sym_mod.create(handle.op_name, **named, **kwargs)
    else:
        handle.sym = sym_mod.create(handle.op_name, *args, **kwargs)
    return None


def symbol_copy(handle):
    return sym_mod.load_json(_sym(handle).tojson())


def symbol_print(handle):
    return _sym(handle).debug_str()


def symbol_get_attr(handle, key):
    v = _sym(handle).attr(str(key))
    return v if v is not None else None


def symbol_set_attr(handle, key, value):
    _sym(handle)._set_attr(**{str(key): str(value)})


def symbol_get_internals(handle):
    return _sym(handle).get_internals()


def symbol_get_output(handle, index):
    return _sym(handle)[int(index)]


def symbol_list_attr(handle):
    out = []
    for k, v in sorted(_sym(handle).attr_dict().items()):
        if isinstance(v, dict):
            for kk, vv in sorted(v.items()):
                out.append("%s$%s" % (k, kk))
                out.append(str(vv))
    return out


def symbol_list_attr_shallow(handle):
    """The attributes of the output node(s) only, plain keys
    (MXSymbolListAttrShallow)."""
    from .symbol import _attr_str
    out = []
    seen = set()
    for node, _ in _sym(handle)._outputs:
        if id(node) in seen:
            continue
        seen.add(id(node))
        d = dict(node.attr)
        if not node.is_var:
            d.update({k: _attr_str(v) for k, v in node.params.items()})
        for k in sorted(d):
            out.append(k)
            out.append(str(d[k]))
    return out


def symbol_get_name(handle):
    return _sym(handle).name


def symbol_get_children(handle):
    """The group of the output nodes' direct inputs (MXSymbolGetChildren);
    a leaf symbol gives an empty group."""
    from .symbol import Symbol
    outs = []
    for node, _ in _sym(handle)._outputs:
        outs.extend(getattr(node, "inputs", ()))
    return Symbol(outs)


def symbol_save_to_file(handle, fname):
    with open(fname, "w") as f:
        f.write(_sym(handle).tojson())


def symbol_infer_type(handle, names, dtype_codes):
    kwargs = {n: _dtype_of(c)
              for n, c in zip(names, dtype_codes)}
    arg_t, out_t, aux_t = _sym(handle).infer_type(**kwargs)
    if arg_t is None:
        return None

    def codes(ts):
        return [_code_of(t) for t in ts]
    return codes(arg_t), codes(out_t), codes(aux_t)


# ---------------------------------------------------------------- Executor
_GRAD_REQ = {0: "null", 1: "write", 3: "add"}


def executor_bind(handle, dev_type, dev_id, arg_handles, grad_handles,
                  grad_req_codes, aux_handles):
    """MXExecutorBind (and its X/EX forms)."""
    symbol = _sym(handle)
    ctx = _ctx(dev_type, dev_id)
    args = list(arg_handles)
    grads = list(grad_handles) if grad_handles else None
    bad = [int(c) for c in grad_req_codes if int(c) not in _GRAD_REQ]
    if bad:
        raise MXNetError("unknown grad_req codes %s (0 null, 1 write, 3 add)"
                         % bad)
    reqs = [_GRAD_REQ[int(c)] for c in grad_req_codes]
    aux = list(aux_handles) if aux_handles else None
    return symbol.bind(ctx, args=args, args_grad=grads, grad_req=reqs,
                       aux_states=aux)


def executor_forward(ex, is_train):
    ex.forward(is_train=bool(is_train))


def executor_backward(ex, head_grad_handles):
    if head_grad_handles:
        ex.backward(list(head_grad_handles))
    else:
        ex.backward()


def executor_outputs(ex):
    return list(ex.outputs)


def executor_set_monitor(ex, fn, capsule):
    """``fn`` is the native call_monitor bridge (NativeCallMonitor in
    csrc/c_api.cc); the executor's monitor is callback(name, NDArray)."""
    ex.set_monitor_callback(lambda name, arr: fn(capsule, str(name), arr))


def executor_print(ex):
    return "Executor(symbol=%s)" % (ex._symbol.name or "Grouped")


# ----------------------------------------------------------------- KVStore
def kvstore_create(kv_type):
    """A store of the port (``local``, ``device``, or a ``dist*`` type
    spanning the world of the MXTPU_* contract: rank 0 of 1 without
    it)."""
    from . import kvstore as kv_mod
    return kv_mod.create(str(kv_type))


def kvstore_init(kv, keys, nd_handles):
    kv.init(list(keys), list(nd_handles))


def kvstore_push(kv, keys, nd_handles, priority):
    kv.push(list(keys), list(nd_handles), priority=int(priority))


def kvstore_pull(kv, keys, nd_handles, priority):
    kv.pull(list(keys), out=list(nd_handles), priority=int(priority))


def kvstore_set_updater(kv, fn, capsule):
    """``fn`` is the native call_updater bridge (NativeCallUpdater in
    csrc/c_api.cc) and ``capsule`` wraps the user's C function pointer; the
    store's updater is updater(key, received, stored)."""
    kv.set_updater(lambda key, recv, local: fn(capsule, int(key), recv,
                                               local))


def kvstore_get_type(kv):
    return kv.type


def kvstore_get_rank(kv):
    return int(kv.rank)


def kvstore_get_group_size(kv):
    return int(kv.num_workers)


def kvstore_barrier(kv):
    kv.barrier()


def kvstore_set_barrier_before_exit(kv, flag):
    kv.set_barrier_before_exit(bool(flag))


def kvstore_get_num_dead_node(kv, node_id, timeout):
    return int(kv.num_dead_node(int(node_id), int(timeout)))


def kvstore_send_command_to_servers(kv, head, body):
    kv._send_command_to_servers(int(head), bytes(body))


# ---------------------------------------------------------------- DataIter
_DATA_ITERS = ("MNISTIter", "ImageRecordIter", "CSVIter")


def list_data_iters():
    return list(_DATA_ITERS)


def data_iter_info(name):
    from . import io as io_mod
    from . import image as image_mod
    cls = getattr(image_mod if name == "ImageRecordIter" else io_mod, name)
    return (str(name), cls.__doc__ or "")


def _parse_iter_val(v):
    import ast
    v = str(v)
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if v in ("True", "true"):
            return True
        if v in ("False", "false"):
            return False
        return v


def data_iter_create(name, keys, vals):
    from . import io as io_mod
    from . import image as image_mod
    name = str(name)
    if name not in _DATA_ITERS:
        raise ValueError("unknown data iter %s" % name)
    cls = getattr(image_mod if name == "ImageRecordIter" else io_mod, name)
    kwargs = {k: _parse_iter_val(v) for k, v in zip(keys, vals)}
    return _CApiIter(cls(**kwargs))


class _CApiIter(object):
    """A DataIter for the C boundary: Next keeps the batch, so GetData,
    GetLabel and GetPadNum refer to the batch Next just returned."""

    def __init__(self, it):
        self.it = it
        self.batch = None


def data_iter_next(handle):
    try:
        handle.batch = next(handle.it)
        return 1
    except StopIteration:
        handle.batch = None
        return 0


def data_iter_before_first(handle):
    handle.it.reset()
    handle.batch = None


def data_iter_get_data(handle):
    return handle.batch.data[0]


def data_iter_get_label(handle):
    return handle.batch.label[0]


def data_iter_get_pad_num(handle):
    return int(handle.batch.pad or 0)


def data_iter_get_index(handle):
    idx = getattr(handle.batch, "index", None)
    if idx is None:
        return []
    return [int(i) for i in idx]


# ---------------------------------------------------------------- profiler
def profiler_set_config(mode, filename):
    from . import profiler
    profiler.set_config("all" if int(mode) > 0 else "symbolic",
                        str(filename))


def profiler_set_state(state):
    from . import profiler
    profiler.set_state("run" if int(state) == 1 else "stop")


def profiler_dump():
    from . import profiler
    profiler.dump_profile()


# ------------------------------------------------------------------ recordio
def recordio_writer_create(uri):
    from .recordio import MXRecordIO
    return MXRecordIO(uri, "w")


def recordio_writer_write(handle, data):
    handle.write(bytes(data))


def recordio_tell(handle):
    return int(handle.tell())


def recordio_reader_create(uri):
    from .recordio import MXRecordIO
    return MXRecordIO(uri, "r")


def recordio_reader_read(handle):
    rec = handle.read()
    return b"" if rec is None else rec


def recordio_reader_seek(handle, pos):
    handle.seek(int(pos))


def recordio_close(handle):
    handle.close()


# --------------------------------------------------- native custom operators
_REQ_NAME = {0: "null", 1: "write", 2: "inplace", 3: "add"}
_REQ_CODE = {v: k for k, v in _REQ_NAME.items()}


def custom_op_register_native(op_type, prop_create, prop_call, op_call,
                              creator_capsule):
    """Register an operator written in C (MXCustomOpRegister).
    ``prop_create``, ``prop_call`` and ``op_call`` are the native bridges
    of csrc/c_api.cc that call the user's CustomOpPropInfo and
    CustomOpInfo callback tables; this wraps them in ``operator``'s
    CustomOp and CustomOpProp, so the op runs through ``ops/custom.py``'s
    Function as a Python custom op does."""
    from . import operator as _operator

    class _NativeOp(_operator.CustomOp):
        def __init__(self, opinfo):
            self._opinfo = opinfo

        def forward(self, is_train, req, in_data, out_data, aux):
            tensors = list(in_data) + list(out_data) + list(aux)
            tags = [0] * len(in_data) + [1] * len(out_data) + [4] * len(aux)
            reqs = [_REQ_CODE.get(r, 1) for r in req]
            op_call(self._opinfo, "forward", tensors, tags, reqs,
                    int(bool(is_train)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            # MXNet's tag and order protocol: in_data (0), out_data (1),
            # in_grad (2), aux (4), out_grad (3)
            tensors = (list(in_data) + list(out_data) + list(in_grad)
                       + list(aux) + list(out_grad))
            tags = ([0] * len(in_data) + [1] * len(out_data)
                    + [2] * len(in_grad) + [4] * len(aux)
                    + [3] * len(out_grad))
            reqs = [_REQ_CODE.get(r, 1) for r in req]
            op_call(self._opinfo, "backward", tensors, tags, reqs, 1)

    class _NativeProp(_operator.CustomOpProp):
        def __init__(self, **kwargs):
            super(_NativeProp, self).__init__(need_top_grad=True)
            keys = [str(k) for k in kwargs]
            vals = [str(kwargs[k]) for k in kwargs]
            self._info = prop_create(creator_capsule, str(op_type), keys,
                                     vals)

        def list_arguments(self):
            return prop_call(self._info, "list_arguments", None)

        def list_outputs(self):
            return prop_call(self._info, "list_outputs", None)

        def list_auxiliary_states(self):
            return prop_call(self._info, "list_aux", None)

        def infer_shape(self, in_shape):
            return prop_call(self._info, "infer_shape",
                             ([tuple(int(d) for d in s) for s in in_shape],
                              len(self.list_outputs()),
                              len(self.list_auxiliary_states())))

        def declare_backward_dependency(self, out_grad, in_data, out_data):
            return prop_call(self._info, "backward_deps",
                             (list(out_grad), list(in_data), list(out_data)))

        def create_operator(self, ctx, in_shapes, in_dtypes):
            codes = [_code_of(d) for d in in_dtypes]
            opinfo = prop_call(self._info, "create_operator",
                               (str(ctx),
                                [tuple(int(d) for d in s)
                                 for s in in_shapes], codes))
            return _NativeOp(opinfo)

    _operator.register(str(op_type))(_NativeProp)
