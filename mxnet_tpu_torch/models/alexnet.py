"""AlexNet (counterpart: mxnet_tpu/models/alexnet.py, after the reference's
example/image-classification/symbols/alexnet.py)."""
from .. import symbol as sym


def get_symbol(num_classes=1000, **kwargs):
    input_data = sym.Variable(name="data")
    # stage 1
    conv1 = sym.Convolution(name="conv1", data=input_data, kernel=(11, 11),
                            stride=(4, 4), num_filter=96)
    relu1 = sym.Activation(data=conv1, act_type="relu")
    lrn1 = sym.LRN(data=relu1, alpha=0.0001, beta=0.75, knorm=2, nsize=5)
    pool1 = sym.Pooling(data=lrn1, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    # stage 2
    conv2 = sym.Convolution(name="conv2", data=pool1, kernel=(5, 5),
                            pad=(2, 2), num_filter=256)
    relu2 = sym.Activation(data=conv2, act_type="relu")
    lrn2 = sym.LRN(data=relu2, alpha=0.0001, beta=0.75, knorm=2, nsize=5)
    pool2 = sym.Pooling(data=lrn2, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    # stage 3
    conv3 = sym.Convolution(name="conv3", data=pool2, kernel=(3, 3),
                            pad=(1, 1), num_filter=384)
    relu3 = sym.Activation(data=conv3, act_type="relu")
    conv4 = sym.Convolution(name="conv4", data=relu3, kernel=(3, 3),
                            pad=(1, 1), num_filter=384)
    relu4 = sym.Activation(data=conv4, act_type="relu")
    conv5 = sym.Convolution(name="conv5", data=relu4, kernel=(3, 3),
                            pad=(1, 1), num_filter=256)
    relu5 = sym.Activation(data=conv5, act_type="relu")
    pool3 = sym.Pooling(data=relu5, kernel=(3, 3), stride=(2, 2),
                        pool_type="max")
    # stage 4
    flatten = sym.Flatten(data=pool3)
    fc1 = sym.FullyConnected(name="fc1", data=flatten, num_hidden=4096)
    relu6 = sym.Activation(data=fc1, act_type="relu")
    dropout1 = sym.Dropout(data=relu6, p=0.5)
    # stage 5
    fc2 = sym.FullyConnected(name="fc2", data=dropout1, num_hidden=4096)
    relu7 = sym.Activation(data=fc2, act_type="relu")
    dropout2 = sym.Dropout(data=relu7, p=0.5)
    # stage 6
    fc3 = sym.FullyConnected(name="fc3", data=dropout2,
                             num_hidden=num_classes)
    softmax = sym.SoftmaxOutput(data=fc3, name="softmax")
    return softmax
