"""Model symbol builders of the port (counterpart: mxnet_tpu/models)."""
from . import resnet
from . import transformer

get_resnet = resnet.get_symbol
