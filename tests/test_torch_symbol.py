"""mxnet_tpu_torch symbol graph vs mxnet_tpu: the ResNet JSON loads both
ways, the builders emit the same JSON, and shape/type inference agree."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import name as jname
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch import name as pname
from mxnet_tpu_torch.models import resnet as presnet
from test_torch_threads import torch_threads_per_worker  # noqa: F401

CONFIGS = [
    # num_classes, num_layers, image_shape, data shape
    (1000, 50, "3,224,224", (2, 3, 224, 224)),
    (10, 50, "3,32,32", (2, 3, 32, 32)),
    (10, 20, "3,16,16", (2, 3, 16, 16)),
]


def _build(cfg):
    classes, layers, image, _ = cfg
    with jname.NameManager():
        j = jresnet.get_symbol(classes, layers, image)
    with pname.NameManager():
        p = presnet.get_symbol(classes, layers, image)
    return j, p


def _assert_same_graph(j, p, dshape):
    assert p.list_arguments() == j.list_arguments()
    assert p.list_auxiliary_states() == j.list_auxiliary_states()
    assert p.list_outputs() == j.list_outputs()
    assert p.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert p.infer_shape(data=dshape) == j.infer_shape(data=dshape)
    pt = p.infer_type(data=np.float64)
    jt = j.infer_type(data=np.float64)
    assert [np.dtype(t) for t in pt[1]] == [np.dtype(t) for t in jt[1]]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_builders_emit_the_same_json(cfg):
    j, p = _build(cfg)
    assert p.tojson() == j.tojson()


@pytest.mark.parametrize("cfg", CONFIGS)
def test_jax_json_loads_in_port(cfg):
    j, _ = _build(cfg)
    p = mt.sym.load_json(j.tojson())
    _assert_same_graph(j, p, cfg[3])
    assert p.tojson() == j.tojson()


@pytest.mark.parametrize("cfg", CONFIGS)
def test_port_json_loads_in_jax(cfg):
    _, p = _build(cfg)
    j = mx.sym.load_json(p.tojson())
    _assert_same_graph(j, p, cfg[3])


def test_symbol_api(tmp_path):
    data = mt.sym.Variable("data")
    fc = mt.sym.FullyConnected(data=data, num_hidden=4, name="fc")
    act = mt.sym.Activation(data=fc, act_type="relu", name="act")
    net = act + fc
    assert net.list_arguments() == ["data", "fc_weight", "fc_bias"]
    assert net.infer_shape(data=(3, 5))[1] == [(3, 4)]
    assert net.infer_shape_partial()[1] == [None]
    assert net.infer_shape() == (None, None, None)
    grp = mt.sym.Group([act, fc])
    assert grp.list_outputs() == ["act_output", "fc_output"]
    assert grp["fc_output"].name == "fc"
    assert [s.name for s in grp] == ["act", "fc"]
    f = str(tmp_path / "net.json")
    net.save(f)
    assert mt.sym.load(f).tojson() == net.tojson()
    with pytest.raises(mt.MXNetError):
        mt.sym.FullyConnected(data, data, data, data, num_hidden=2)
    with pytest.raises(mt.MXNetError, match="unknown operator"):
        mt.sym.load_json(net.tojson().replace("FullyConnected", "NoSuchOp"))
