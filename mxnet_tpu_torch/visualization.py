"""Network visualization (counterpart: mxnet_tpu/visualization.py):
``print_summary``'s table, the same text as the JAX package's, and
``plot_network``'s graphviz Digraph (graphviz is imported at the call)."""
from __future__ import annotations

import json

from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64,
                                                                  .74, 1.)):
    """Print a layer summary table: one row per op node with its output
    shape (batch dim dropped), parameter count (the product of each weight
    input's shape) and producing layers.  Returns the total parameter count
    (parity surface: visualization.print_summary)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    shape_of = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_of = dict(zip(internals.list_outputs(), out_shapes))
    graph = json.loads(symbol.tojson())
    nodes = graph["nodes"]
    heads = {h[0] for h in graph["heads"]}
    cols = [int(line_length * p) if p <= 1 else p for p in positions]

    def emit(fields):
        line = ""
        for stop, field in zip(cols, fields):
            line = (line + str(field))[:stop].ljust(stop)
        print(line)

    def describe(i, node):
        """-> (out_shape, param_count, producer names) for one op row."""
        oshape = shape_of.get(node["name"] + "_output", [None])[1:] \
            if (node["op"] != "null" or i in heads) else []
        params, producers = 0, []
        for src, _ in (x[:2] for x in node["inputs"]):
            src_node = nodes[src]
            if src_node["op"] != "null" or src in heads:
                producers.append(src_node["name"])
            else:
                wshape = shape_of.get(src_node["name"])
                if wshape is not None:
                    params += int(_prod(wshape))
        return oshape or [], params, producers

    print("_" * line_length)
    emit(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print("=" * line_length)
    total = 0
    for i, node in enumerate(nodes):
        if node["op"] == "null" and i > 0:
            continue   # weights/aux fold into their consumer's Param #
        oshape, params, producers = describe(i, node) \
            if node["op"] != "null" else (describe(i, node)[0], 0, [])
        total += params
        emit(["%s(%s)" % (node["name"], node["op"]), str(oshape),
              str(params), producers[0] if producers else ""])
        for extra in producers[1:]:
            emit(["", "", "", extra])
        print("_" * line_length)
    print("Total params: %d" % total)
    print("_" * line_length)
    return total


def _prod(t):
    out = 1
    for x in t:
        out *= x
    return out


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Build a graphviz Digraph of the network (parity: plot_network)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library")
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    draw_shape = False
    shape_dict = {}
    if shape is not None:
        draw_shape = True
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs or {})
    dot = Digraph(name=title, format=save_format)
    cm = ("#8dd3c7", "#fb8072", "#ffffb3", "#bebada", "#80b1d3", "#fdb462",
          "#b3de69", "#fccde5")

    def looks_like_weight(name):
        if name.endswith("_weight") or name.endswith("_bias") or \
                name.endswith("_gamma") or name.endswith("_beta") or \
                name.endswith("_moving_var") or name.endswith("_moving_mean"):
            return True
        return False

    hidden_nodes = set()
    for node in nodes:
        op = node["op"]
        name = node["name"]
        attrs = {"shape": "box", "fixedsize": "false"}
        attrs.update(node_attr)
        label = name
        if op == "null":
            if looks_like_weight(name):
                if hide_weights:
                    hidden_nodes.add(name)
                continue
            attrs["shape"] = "oval"
            attrs["fillcolor"] = cm[0]
        elif op in ("Convolution", "Deconvolution"):
            p = node.get("param", {})
            label = "%s\n%s/%s, %s" % (op, p.get("kernel", ""),
                                       p.get("stride", "(1,)"),
                                       p.get("num_filter", ""))
            attrs["fillcolor"] = cm[1]
        elif op == "FullyConnected":
            label = "%s\n%s" % (op, node.get("param", {}).get("num_hidden",
                                                              ""))
            attrs["fillcolor"] = cm[1]
        elif op == "BatchNorm":
            attrs["fillcolor"] = cm[3]
        elif op == "Activation" or op == "LeakyReLU":
            label = "%s\n%s" % (op, node.get("param", {}).get("act_type", ""))
            attrs["fillcolor"] = cm[2]
        elif op == "Pooling":
            p = node.get("param", {})
            label = "Pooling\n%s, %s/%s" % (p.get("pool_type", ""),
                                            p.get("kernel", ""),
                                            p.get("stride", "(1,)"))
            attrs["fillcolor"] = cm[4]
        elif op in ("Concat", "Flatten", "Reshape"):
            attrs["fillcolor"] = cm[5]
        elif op == "Softmax" or op == "SoftmaxOutput":
            attrs["fillcolor"] = cm[6]
        else:
            attrs["fillcolor"] = cm[7]
        dot.node(name=name, label=label, **attrs)
    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        inputs = node["inputs"]
        for item in inputs:
            input_node = nodes[item[0]]
            input_name = input_node["name"]
            if input_name in hidden_nodes:
                continue
            attrs = {"dir": "back", "arrowtail": "open"}
            if draw_shape:
                key = input_name
                if input_node["op"] != "null":
                    key += "_output"
                if key in shape_dict:
                    shape = shape_dict[key][1:]
                    label = "x".join([str(x) for x in shape])
                    attrs["label"] = label
            dot.edge(tail_name=name, head_name=input_name, **attrs)
    return dot
