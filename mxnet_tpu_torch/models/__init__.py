"""Model symbol builders of the port (counterpart: mxnet_tpu/models)."""
from . import alexnet
from . import lenet
from . import mlp
from . import resnet
from . import ssd
from . import transformer

get_lenet = lenet.get_symbol
get_alexnet = alexnet.get_symbol
get_mlp = mlp.get_symbol
get_resnet = resnet.get_symbol
