"""Symbol — the symbolic graph (counterpart: mxnet_tpu/symbol.py).

A Symbol is a lightweight Python DAG whose nodes name registered operators.
``bind`` hands the DAG to the executor, which walks it op by op on tensors.
The JSON format (nodes / arg_nodes / heads) is the JAX package's, so a graph
saved by either package loads in the other.
"""
from __future__ import annotations

import json

import numpy as _np

from .attribute import AttrScope
from .base import MXNetError, atomic_write, string_types
from .context import current_context
from . import name as _name_mgr
from .ops import registry as _reg

__all__ = ["Symbol", "Variable", "Group", "load", "load_json", "var"]


class _Node(object):
    """One graph node: a variable (op is None) or an operator application."""

    __slots__ = ("op", "name", "params", "attr", "inputs")

    def __init__(self, op, name, params=None, attr=None, inputs=None):
        self.op = op
        self.name = name
        self.params = dict(params or {})
        self.attr = dict(attr or {})
        self.inputs = list(inputs or [])  # list of (_Node, out_index)

    @property
    def is_var(self):
        return self.op is None

    def num_outputs(self):
        if self.is_var:
            return 1
        return self.op.num_outputs_for(self.params)


def _topo(nodes_out):
    """Post-order DFS over the DAG feeding the given output nodes."""
    seen = set()
    order = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for (child, _) in node.inputs:
            visit(child)
        order.append(node)

    for n in nodes_out:
        visit(n)
    return order


class Symbol(object):
    """An (immutable) reference to one or more outputs of the graph."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (_Node, out_index)

    def __getitem__(self, index):
        if isinstance(index, string_types):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("cannot find output %s" % index)
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self._outputs)))

    # ----------------------------------------------------------- composition
    def __call__(self, *args, **kwargs):
        raise MXNetError("symbol re-composition is not supported; "
                         "build a new symbol instead")

    # ------------------------------------------------------------ arithmetic
    def __add__(self, other):
        return _sym_binary("_plus", "_plus_scalar", self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return _sym_binary("_minus", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _sym_scalar("_rminus_scalar", self, other)

    def __mul__(self, other):
        return _sym_binary("_mul", "_mul_scalar", self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sym_binary("_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _sym_scalar("_rdiv_scalar", self, other)

    def __pow__(self, other):
        return _sym_binary("_power", "_power_scalar", self, other)

    def __neg__(self):
        return create("negative", data=self)

    # -------------------------------------------------------------- listing
    @property
    def name(self):
        if len(self._outputs) > 1:
            return None
        return self._outputs[0][0].name

    def _nodes(self):
        return _topo([n for n, _ in self._outputs])

    def _aux_node_ids(self):
        """ids of variable nodes that feed auxiliary-state input slots."""
        aux = set()
        for node in self._nodes():
            if node.is_var or not node.op.num_aux:
                continue
            names = node.op.arg_names_for(node.params)
            for i, nm in enumerate(names):
                if nm in node.op.aux_names and i < len(node.inputs):
                    child = node.inputs[i][0]
                    if child.is_var:
                        aux.add(id(child))
        return aux

    def list_arguments(self):
        aux = self._aux_node_ids()
        return [n.name for n in self._nodes() if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_node_ids()
        return [n.name for n in self._nodes() if n.is_var and id(n) in aux]

    def list_outputs(self):
        out = []
        for node, idx in self._outputs:
            if node.is_var:
                out.append(node.name)
            elif node.num_outputs() == 1:
                out.append(node.name + "_output")
            else:
                out.append("%s_output%d" % (node.name, idx))
        return out

    def attr_dict(self):
        """{node name: {attribute: string}} over the graph (parity:
        Symbol.attr_dict): variables' attributes (``__init__``,
        ``__lr_mult__``, ...) and operators' parameters."""
        ret = {}
        for node in _topo([n for n, _ in self._outputs]):
            d = dict(node.attr)
            if not node.is_var:
                d.update({k: _attr_str(v) for k, v in node.params.items()})
            if d:
                ret[node.name] = d
        return ret

    def get_internals(self):
        """Every node output as a Group (parity: symbol.get_internals)."""
        return Symbol([(node, i) for node in self._nodes()
                       for i in range(node.num_outputs())])

    # ------------------------------------------------------------- inference
    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes = self._infer_shape_impl(
            *args, **kwargs)
        if arg_shapes is not None and any(
                s is None or 0 in s for s in arg_shapes):
            return None, None, None
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(*args, **kwargs)

    def _infer_shape_impl(self, *args, **kwargs):
        if args and kwargs:
            raise MXNetError("cannot mix positional and keyword shape args")
        arg_names = self.list_arguments()
        known = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        for k, v in kwargs.items():
            known[k] = tuple(v)
        var_shapes, out_shapes = _run_shape_inference(self, known)
        arg_shapes = [var_shapes.get(n) for n in arg_names]
        aux_shapes = [var_shapes.get(n) for n in self.list_auxiliary_states()]
        outs = [out_shapes.get((id(node), idx)) for node, idx in self._outputs]
        return arg_shapes, outs, aux_shapes

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        for n, t in zip(arg_names, args):
            if t is not None:
                known[n] = _np.dtype(t)
        for k, v in kwargs.items():
            known[k] = _np.dtype(v)
        var_types = {}
        out_types = {}
        for node in self._nodes():
            if node.is_var:
                var_types[node.name] = known.get(node.name, _np.float32)
                out_types[(id(node), 0)] = var_types[node.name]
            else:
                in_t = [out_types.get((id(c), i)) for c, i in node.inputs]
                _, outs, _ = node.op.infer_type(node.params, in_t)
                for i, t in enumerate(outs):
                    out_types[(id(node), i)] = t
        return ([var_types.get(n) for n in arg_names],
                [out_types.get((id(n), i)) for n, i in self._outputs],
                [var_types.get(n) for n in self.list_auxiliary_states()])

    # ----------------------------------------------------------------- serde
    def tojson(self):
        nodes = self._nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_var else n.op.name,
                "name": n.name,
                "param": {} if n.is_var else
                         {k: _attr_str(v) for k, v in n.params.items()},
                "attr": dict(n.attr),
                "inputs": [[nid[id(c)], i, 0] for c, i in n.inputs],
            })
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var],
            "heads": [[nid[id(n)], i, 0] for n, i in self._outputs],
            "attrs": {"mxnet_tpu_version": 1},
        }, indent=2)

    def save(self, fname):
        """Write the JSON through ``base.atomic_write`` (a checkpoint's
        symbol file is never seen half written)."""
        with atomic_write(fname, "w") as f:
            f.write(self.tojson())

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    # --------------------------------------------------------------- binding
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Bind with argument, gradient and aux arrays allocated from the
        shapes inferred from ``kwargs`` (parity: Symbol.simple_bind; see
        ``Executor.simple_bind``)."""
        from .executor import Executor
        return Executor.simple_bind(self, ctx or current_context(),
                                    grad_req=grad_req, type_dict=type_dict,
                                    group2ctx=group2ctx,
                                    shared_exec=shared_exec, **kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind arguments, gradient arrays and aux states into an
        :class:`Executor` (parity: Symbol.bind); gradients are computed
        for the arguments with an array in ``args_grad`` and a grad_req
        other than 'null'."""
        from .executor import Executor
        return Executor(self, ctx or current_context(), args, args_grad,
                        grad_req, aux_states)


def _attr_str(v):
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(str(x) for x in v) + ")"
    if v is None:
        return "None"
    if isinstance(v, _np.dtype):
        return v.name
    if isinstance(v, type):
        return getattr(v, "__name__", str(v))
    return str(v)


# -------------------------------------------------------------- construction
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None):
    """Create a variable symbol (parity: mx.sym.Variable): ``init`` (an
    Initializer or its JSON) lands in the ``__init__`` attribute that
    ``Module.init_params`` dispatches on."""
    if not isinstance(name, string_types):
        raise TypeError("Expect a string for variable name")
    attr = dict(AttrScope.current().get(attr) or {})
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attr["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attr["__dtype__"] = str(_np.dtype(dtype))
    if init is not None:
        attr["__init__"] = init if isinstance(init, string_types) else \
            init.dumps()
    return Symbol([(_Node(None, name, attr=attr), 0)])


var = Variable


def Group(symbols):
    """Group symbols into one multi-output symbol (parity: mx.sym.Group)."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


# op-call kwargs lifted into __k__ node attrs and inherited by auto-created
# variable inputs (parity: mxnet_tpu/symbol.py _HIDDEN_KEYS)
_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage")


def create(op_name, *args, **kwargs):
    """Create a node applying ``op_name`` (the generic symbol constructor)."""
    op = _reg.get_op(op_name)
    name = kwargs.pop("name", None)
    attr = dict(AttrScope.current().get(kwargs.pop("attr", None)))
    for k in _HIDDEN_KEYS:
        if k in kwargs:
            attr["__%s__" % k] = str(kwargs.pop(k))
    sym_kwargs = {}
    params = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol) or (isinstance(v, (list, tuple)) and v and
                                     all(isinstance(x, Symbol) for x in v)):
            sym_kwargs[k] = v
        else:
            params[k] = v
    pos_syms = []
    for a in args:
        if isinstance(a, Symbol):
            pos_syms.append(a)
        elif isinstance(a, (list, tuple)) and \
                all(isinstance(x, Symbol) for x in a):
            pos_syms.extend(a)
        else:
            raise MXNetError("positional arguments to %s must be Symbols"
                             % op_name)
    if op.key_var_num_args and op.key_var_num_args not in params:
        # a variadic op counts its inputs (parity: the reference's
        # key_var_num_args fill-in)
        params[op.key_var_num_args] = len(pos_syms) + len(sym_kwargs)
    params = op.normalize_attrs(params)
    name = _name_mgr.current().get(name, op.name.lower().lstrip("_"))
    inputs = []
    pos_iter = iter(pos_syms)
    for an in op.arg_names_for(params):
        s = sym_kwargs.pop(an) if an in sym_kwargs else next(pos_iter, None)
        if s is None:
            # auto-create missing inputs as {name}_{arg} variables
            inherited = {k: v for k, v in attr.items()
                         if k.strip("_") in _HIDDEN_KEYS}
            s = Variable("%s_%s" % (name, an), attr=inherited or None)
        if len(s._outputs) != 1:
            raise MXNetError("cannot feed grouped symbol to input %s" % an)
        inputs.append(s._outputs[0])
    leftover = list(pos_iter)
    if leftover or sym_kwargs:
        raise MXNetError("unexpected inputs to %s: %d positional, kw=%s"
                         % (op_name, len(leftover), list(sym_kwargs)))
    node = _Node(op, name, params=params, attr=attr, inputs=inputs)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _sym_binary(op, scalar_op, lhs, rhs):
    if isinstance(rhs, Symbol):
        return create(op, lhs=lhs, rhs=rhs)
    return _sym_scalar(scalar_op, lhs, rhs)


def _sym_scalar(scalar_op, data, scalar):
    return create(scalar_op, data=data, scalar=float(scalar))


# -------------------------------------------------------------------- loading
def load_json(json_str):
    """Load a symbol from its JSON string (parity: mx.sym.load_json; both
    [node, index] and [node, index, version] input entries)."""
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attr = jn.get("attr", jn.get("attrs", {})) or {}
        if jn["op"] == "null":
            node = _Node(None, jn["name"], attr=attr)
        else:
            op = _reg.get_op(jn["op"])
            raw = jn.get("param", None)
            if raw is None:
                # nnvm-era JSON keeps op params among the attrs
                declared = set(op.attr_types) | set(op.defaults)
                raw = {k: v for k, v in attr.items() if k in declared}
            params = op.normalize_attrs(raw)
            node = _Node(op, jn["name"], params=params, attr=attr)
            node.inputs = [(nodes[e[0]], e[1]) for e in jn["inputs"]]
            # pre-nnvm JSON omits the implicit aux inputs (BN moving stats)
            names = op.arg_names_for(params)
            missing = len(names) - len(node.inputs)
            if missing > 0 and op.num_aux:
                for an in names[-missing:]:
                    node.inputs.append(
                        (_Node(None, "%s_%s" % (jn["name"], an)), 0))
        nodes.append(node)
    return Symbol([(nodes[e[0]], e[1]) for e in data["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ------------------------------------------------------------ shape inference
def _run_shape_inference(symbol, known):
    """Fixpoint bidirectional shape propagation over the DAG (parity:
    mxnet_tpu/symbol.py _run_shape_inference, without the backward rules no
    op of the port has).  Returns (var name -> shape, (node id, index) ->
    shape)."""
    order = symbol._nodes()
    var_shapes = dict(known)
    for n in order:
        if n.is_var and "__shape__" in n.attr and n.name not in var_shapes:
            var_shapes[n.name] = _reg.parse_tuple(n.attr["__shape__"])
    out_shapes = {}

    def merge(cur, new):
        """Unify; returns (merged, improved?)."""
        if new is None:
            return cur, False
        new = tuple(int(x) for x in new)
        try:
            m = _reg.shape_unify(cur, new)
        except ValueError:
            raise MXNetError("shape inference conflict: %r vs %r"
                             % (cur, new))
        return m, m != cur

    for _ in range(10):
        changed = False
        for node in order:
            if node.is_var:
                m, imp = merge(out_shapes.get((id(node), 0)),
                               var_shapes.get(node.name))
                if imp:
                    out_shapes[(id(node), 0)] = m
                    changed = True
                m2, imp2 = merge(var_shapes.get(node.name),
                                 out_shapes.get((id(node), 0)))
                if imp2:
                    var_shapes[node.name] = m2
                    changed = True
                continue
            in_shapes = [out_shapes.get((id(c), i)) for c, i in node.inputs]
            try:
                new_in, new_out, _aux = node.op.infer_shape(node.params,
                                                            in_shapes)
            except MXNetError:
                raise
            except Exception:
                new_in, new_out = None, None
            for (child, ci), s in zip(node.inputs, new_in or ()):
                if s is None:
                    continue
                if child.is_var:
                    m, imp = merge(var_shapes.get(child.name), s)
                    if imp:
                        var_shapes[child.name] = m
                        changed = True
                m, imp = merge(out_shapes.get((id(child), ci)), s)
                if imp:
                    out_shapes[(id(child), ci)] = m
                    changed = True
            for i, s in enumerate(new_out or []):
                m, imp = merge(out_shapes.get((id(node), i)), s)
                if imp:
                    out_shapes[(id(node), i)] = m
                    changed = True
        if not changed:
            break
    return var_shapes, out_shapes


# ------------------------------------------------- autogenerated constructors
def _make_symbol_function(op):
    def fn(*args, **kwargs):
        return create(op.name, *args, **kwargs)

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def _init_symbol_module(target):
    """One constructor per registered op; a name the module defines itself
    (load, Variable, ...) is never shadowed."""
    seen = {}
    for nm in _reg.list_ops():
        if nm in target:
            continue
        op = _reg.get_op(nm)
        fn = seen.get(id(op))
        if fn is None:
            fn = seen[id(op)] = _make_symbol_function(op)
        target[nm] = fn


_init_symbol_module(globals())
