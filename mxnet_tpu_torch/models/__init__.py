"""Model symbol builders of the port (counterpart: mxnet_tpu/models)."""
from . import alexnet
from . import inception_v3
from . import lenet
from . import mlp
from . import resnet
from . import ssd
from . import transformer
from . import vgg

get_lenet = lenet.get_symbol
get_alexnet = alexnet.get_symbol
get_mlp = mlp.get_symbol
get_resnet = resnet.get_symbol
get_inception_v3 = inception_v3.get_symbol
get_vgg = vgg.get_symbol
