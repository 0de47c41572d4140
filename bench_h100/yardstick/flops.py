"""Analytic FLOPs (2 x multiply-adds) of the convolutions and dense layers
of one image's predict or train step, at the canvas the program computes
on (padding included).

Counted: every conv and dense layer of the backbone, the RPN head, the
RoI head and the detector heads. Not counted: the RoI crop (its bilinear
taps are a bytes-bound gather, held to `bounds.py`), pools, the frozen
BatchNorms' affines, elementwise work, NMS and sampling. A train step is
the forward, each trainable layer's weight gradient (as many FLOPs as its
forward) and the input gradient of every layer whose input needs one (as
many again): none for the frozen prefix (VGG-16's conv1-conv2 blocks,
ResNet's conv1 and layer1), nor for the first layer after it, whose input
is cut from the graph.
"""

from __future__ import annotations

from typing import List, Tuple

VGG_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}

# (forward FLOPs, trainable, input needs a gradient)
Layer = Tuple[float, bool, bool]


def _conv(h: int, w: int, k: int, cin: int, cout: int) -> float:
    """An output map of h x w, a k x k kernel."""
    return 2.0 * h * w * k * k * cin * cout


def _head_layers(fm_h, fm_w, c, anchors, rois, vec, classes) -> List[Layer]:
    out = [(_conv(fm_h, fm_w, 3, c, c), True, True), (_conv(fm_h, fm_w, 1, c, anchors + 4 * anchors), True, True)]
    out.append((2.0 * rois * vec * (classes + 4 * (classes - 1)), True, True))
    return out


def vgg16_layers(h: int, w: int, rois: int, classes: int = 21, anchors: int = 9) -> List[Layer]:
    layers: List[Layer] = []
    cin, rh, rw = 3, h, w
    for b, (n, ch) in enumerate(VGG_BLOCKS):
        for i in range(n):
            trainable = b >= 2
            first_trainable = b == 2 and i == 0
            layers.append((_conv(rh, rw, 3, cin, ch), trainable, trainable and not first_trainable))
            cin = ch
        if b < 4:
            rh, rw = rh // 2, rw // 2
    fm_h, fm_w = h // 16, w // 16
    layers += _head_layers(fm_h, fm_w, 512, anchors, rois, 4096, classes)
    layers.append((2.0 * rois * (7 * 7 * 512 * 4096 + 4096 * 4096), True, True))
    return layers


def _bottleneck(h, w, cin, mid, stride, project, trainable, input_grad) -> List[Layer]:
    """A bottleneck whose input map is h x w (torchvision v1.5: the stride
    on the 3x3 conv)."""
    oh, ow = -(-h // stride), -(-w // stride)
    out = [(_conv(h, w, 1, cin, mid), trainable, input_grad),
           (_conv(oh, ow, 3, mid, mid), trainable, trainable),
           (_conv(oh, ow, 1, mid, 4 * mid), trainable, trainable)]
    if project:
        out.append((_conv(oh, ow, 1, cin, 4 * mid), trainable, input_grad))
    return out


def _stage(h, w, n, cin, mid, stride, trainable, input_grad) -> Tuple[List[Layer], int, int]:
    layers: List[Layer] = []
    for i in range(n):
        layers += _bottleneck(h, w, cin, mid, stride if i == 0 else 1, i == 0, trainable,
                              input_grad if i == 0 else trainable)
        if i == 0:
            h, w = -(-h // stride), -(-w // stride)
        cin = 4 * mid
    return layers, h, w


def resnet_layers(h: int, w: int, rois: int, backbone: str = "resnet101", classes: int = 21,
                  anchors: int = 9) -> List[Layer]:
    blocks = RESNET_BLOCKS[backbone]
    ch, cw = -(-h // 2), -(-w // 2)
    layers: List[Layer] = [(_conv(ch, cw, 7, 3, 64), False, False)]
    ph, pw = -(-ch // 2), -(-cw // 2)
    s1, h1, w1 = _stage(ph, pw, blocks[0], 64, 64, 1, False, False)
    s2, h2, w2 = _stage(h1, w1, blocks[1], 256, 128, 2, True, False)
    s3, h3, w3 = _stage(h2, w2, blocks[2], 512, 256, 2, True, True)
    layers += s1 + s2 + s3
    layers += _head_layers(h3, w3, 1024, anchors, rois, 2048, classes)
    s4, _, _ = _stage(7, 7, blocks[3], 1024, 512, 2, True, True)
    layers += [(f * rois, t, g) for f, t, g in s4]
    return layers


def layers_for(model: dict, h: int, w: int, rois: int) -> List[Layer]:
    k = model["num_classes"]
    if model["backbone"] == "vgg16":
        return vgg16_layers(h, w, rois, k)
    return resnet_layers(h, w, rois, model["backbone"], k)


def flops_per_image(model: dict, canvas, rois: int, train: bool) -> float:
    """Forward FLOPs, plus the backward's where `train`, of one image."""
    layers = layers_for(model, canvas[0], canvas[1], rois)
    total = sum(f for f, _, _ in layers)
    if train:
        total += sum(f for f, t, _ in layers if t) + sum(f for f, _, g in layers if g)
    return total
