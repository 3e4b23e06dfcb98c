"""LeNet-5 (counterpart: mxnet_tpu/models/lenet.py, after the
reference's example/image-classification/symbols/lenet.py)."""
from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    # first conv
    conv1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=20,
                            name="conv1")
    tanh1 = sym.Activation(data=conv1, act_type="tanh", name="tanh1")
    pool1 = sym.Pooling(data=tanh1, pool_type="max", kernel=(2, 2),
                        stride=(2, 2), name="pool1")
    # second conv
    conv2 = sym.Convolution(data=pool1, kernel=(5, 5), num_filter=50,
                            name="conv2")
    tanh2 = sym.Activation(data=conv2, act_type="tanh", name="tanh2")
    pool2 = sym.Pooling(data=tanh2, pool_type="max", kernel=(2, 2),
                        stride=(2, 2), name="pool2")
    # first fullc
    flatten = sym.Flatten(data=pool2, name="flatten")
    fc1 = sym.FullyConnected(data=flatten, num_hidden=500, name="fc1")
    tanh3 = sym.Activation(data=fc1, act_type="tanh", name="tanh3")
    # second fullc
    fc2 = sym.FullyConnected(data=tanh3, num_hidden=num_classes, name="fc2")
    # loss
    lenet = sym.SoftmaxOutput(data=fc2, name="softmax")
    return lenet
