"""SSD detection network (counterpart: mxnet_tpu/models/ssd.py): a
compact single-shot detector over a small backbone (16/32/64/64 channels at
64x64 input, feature maps at strides 4, 8 and 16, 4 anchors a pixel, 1,344
anchors), wired through the MultiBox ops of ``ops/contrib.py``.

The training symbol has MXNet's example/ssd loss structure: a softmax over
the classes with the ignore label, and a smooth-L1 localisation loss on the
MultiBoxTarget outputs; the eval symbol ends in MultiBoxDetection.  The
layer names are the JAX package's, so ``.params`` files load across the two
packages.
"""
from __future__ import annotations

from .. import symbol as mx_sym


def _conv_block(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
                stride=(1, 1)):
    c = mx_sym.Convolution(data=data, kernel=kernel, pad=pad, stride=stride,
                           num_filter=num_filter, name="%s_conv" % name)
    return mx_sym.Activation(data=c, act_type="relu", name="%s_relu" % name)


def _backbone(data):
    """Small feature pyramid: returns list of feature maps for detection."""
    feats = []
    x = _conv_block(data, "b1a", 16)
    x = _conv_block(x, "b1b", 16)
    x = mx_sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p1")
    x = _conv_block(x, "b2a", 32)
    x = mx_sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p2")
    feats.append(x)                                   # stride 4
    x = _conv_block(x, "b3a", 64)
    x = mx_sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p3")
    feats.append(x)                                   # stride 8
    x = _conv_block(x, "b4a", 64)
    x = mx_sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p4")
    feats.append(x)                                   # stride 16
    return feats


_SIZES = [(0.2, 0.272), (0.37, 0.447), (0.54, 0.619)]
_RATIOS = [(1.0, 2.0, 0.5)] * 3


def multibox_layer(feats, num_classes):
    """Per-feature-map class/box heads + anchors (parity: example/ssd
    symbol/common.py multibox_layer)."""
    cls_preds, loc_preds, anchors = [], [], []
    for i, feat in enumerate(feats):
        sizes, ratios = _SIZES[i], _RATIOS[i]
        n_anchor = len(sizes) + len(ratios) - 1
        loc = mx_sym.Convolution(data=feat, kernel=(3, 3), pad=(1, 1),
                                 num_filter=n_anchor * 4,
                                 name="loc_pred_%d" % i)
        loc = mx_sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(mx_sym.Flatten(loc))
        cls = mx_sym.Convolution(data=feat, kernel=(3, 3), pad=(1, 1),
                                 num_filter=n_anchor * (num_classes + 1),
                                 name="cls_pred_%d" % i)
        cls = mx_sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = mx_sym.Reshape(cls, shape=(0, -1, num_classes + 1))
        cls_preds.append(cls)
        anchors.append(mx_sym.Reshape(
            mx_sym.MultiBoxPrior(feat, sizes=sizes, ratios=ratios),
            shape=(1, -1, 4), name="anchor_%d" % i))
    loc_preds = mx_sym.Concat(*loc_preds, dim=1, name="multibox_loc_pred")
    cls_preds = mx_sym.Concat(*cls_preds, dim=1)
    cls_preds = mx_sym.transpose(cls_preds, axes=(0, 2, 1),
                                 name="multibox_cls_pred")
    anchors = mx_sym.Concat(*anchors, dim=1, name="multibox_anchors")
    return loc_preds, cls_preds, anchors


def get_symbol_train(num_classes=20, **kwargs):
    """Training symbol: [cls_prob, loc_loss, cls_label] (parity:
    example/ssd/symbol/symbol_builder.py get_symbol_train)."""
    data = mx_sym.Variable("data")
    label = mx_sym.Variable("label")
    feats = _backbone(data)
    loc_preds, cls_preds, anchors = multibox_layer(feats, num_classes)
    tmp = mx_sym.MultiBoxTarget(anchors, label, cls_preds,
                                overlap_threshold=0.5,
                                ignore_label=-1.0,
                                negative_mining_ratio=3.0,
                                minimum_negative_samples=0,
                                negative_mining_thresh=0.5,
                                variances=(0.1, 0.1, 0.2, 0.2),
                                name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = mx_sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                    ignore_label=-1.0, use_ignore=True,
                                    multi_output=True,
                                    normalization="valid", name="cls_prob")
    loc_diff = loc_target_mask * (mx_sym.Reshape(loc_preds, shape=(0, -1))
                                  - loc_target)
    loc_loss = mx_sym.MakeLoss(mx_sym.smooth_l1(loc_diff, scalar=1.0),
                               grad_scale=1.0, name="loc_loss")
    cls_label = mx_sym.MakeLoss(data=cls_target, grad_scale=0.0,
                                name="cls_label")
    return mx_sym.Group([cls_prob, loc_loss, cls_label])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               **kwargs):
    """Inference symbol ending in MultiBoxDetection."""
    data = mx_sym.Variable("data")
    feats = _backbone(data)
    loc_preds, cls_preds, anchors = multibox_layer(feats, num_classes)
    cls_prob = mx_sym.SoftmaxActivation(cls_preds, mode="channel",
                                        name="cls_prob")
    return mx_sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                    nms_threshold=nms_thresh,
                                    force_suppress=force_suppress,
                                    variances=(0.1, 0.1, 0.2, 0.2),
                                    name="detection")
