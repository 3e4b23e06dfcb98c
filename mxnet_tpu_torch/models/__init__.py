"""Model symbol builders of the port (counterpart: mxnet_tpu/models)."""
from . import resnet

get_resnet = resnet.get_symbol
