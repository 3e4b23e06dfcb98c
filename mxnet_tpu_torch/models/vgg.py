"""VGG 11/13/16/19, with or without BatchNorm (counterpart:
mxnet_tpu/models/vgg.py, after the reference's
example/image-classification/symbols/vgg.py)."""
from ..base import MXNetError
from .. import symbol as sym

vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_feature(internel_layer, layers, filters, batch_norm=False):
    for i, num in enumerate(layers):
        for j in range(num):
            internel_layer = sym.Convolution(
                data=internel_layer, kernel=(3, 3), pad=(1, 1),
                num_filter=filters[i], name="conv%s_%s" % (i + 1, j + 1))
            if batch_norm:
                internel_layer = sym.BatchNorm(
                    data=internel_layer, name="bn%s_%s" % (i + 1, j + 1))
            internel_layer = sym.Activation(
                data=internel_layer, act_type="relu",
                name="relu%s_%s" % (i + 1, j + 1))
        internel_layer = sym.Pooling(
            data=internel_layer, pool_type="max", kernel=(2, 2),
            stride=(2, 2), name="pool%s" % (i + 1))
    return internel_layer


def get_classifier(input_data, num_classes):
    flatten = sym.Flatten(data=input_data, name="flatten")
    fc6 = sym.FullyConnected(data=flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(data=fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(data=relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(data=drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(data=fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(data=relu7, p=0.5, name="drop7")
    fc8 = sym.FullyConnected(data=drop7, num_hidden=num_classes, name="fc8")
    return fc8


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in vgg_spec:
        raise MXNetError("no experiments done on vgg num_layers %d"
                         % num_layers)
    layers, filters = vgg_spec[num_layers]
    data = sym.Variable(name="data")
    feature = get_feature(data, layers, filters, batch_norm)
    classifier = get_classifier(feature, num_classes)
    symbol = sym.SoftmaxOutput(data=classifier, name="softmax")
    return symbol
