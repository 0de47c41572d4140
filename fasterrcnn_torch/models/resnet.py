"""ResNet-50/101/152 backbones with frozen BatchNorm.

The JAX package's `models/resnet.py` in PyTorch. Module names are the JAX
package's parameter names (conv1/bn1/layer1..layer3 in the extractor,
layer4 in the head, `block{i}` in a stage, conv1..3/bn1..3/downsample_conv/
downsample_bn in a bottleneck), so `utils/weights.py` carries one state onto
the other by name.

  * BatchNorm is frozen: `FrozenBatchNorm` is the per-channel affine
    x * scale + bias, its two parameters precomputed at weight import from
    gamma, beta and the running statistics (`utils/checkpoint.py`). It is
    not folded into the conv, so the parameter tree stays the JAX one.
  * Torch paddings (conv1 3, the 3x3 convs 1, the max pool 1), so a
    torchvision ResNet's weights sample the same positions; the map extent
    is ceil(size / 16).
  * The extractor is conv1..layer3 (stride 16, 1024 channels); the RoI head
    is layer4 on the 7x7 pooled RoIs and the spatial mean (2048 values).
  * Training leaves conv1, bn1, layer1 and every BN affine unchanged
    (`frozen_param_patterns`), and the extractor cuts the gradient after
    layer1, unless `ModelConfig.train_all`.

The convs run NCHW in the `channels_last` memory format; the extractor and
the head take NHWC tensors, the layout of the JAX package's functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fasterrcnn_torch.data.image import TORCHVISION_RGB
from fasterrcnn_torch.models.backbone import BackboneSpec, register_backbone
from fasterrcnn_torch.models.layers import Conv2d
from fasterrcnn_torch.parallel import tp

# Bottlenecks per stage (layer1..layer4), torchvision's architectures.
ARCHITECTURES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


class FrozenBatchNorm(nn.Module):
    """Per-channel affine y = x * scale + bias over dim 1 of an NCHW tensor.

    Computed in the input's type, rounding after the product and after the
    sum, as the JAX package's FrozenBatchNorm does in bf16. `init_params`
    sets scale to 1 (0 for each bottleneck's bn3 under train_all) and bias
    to 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1, 1, 1)
        return x * self.scale.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)

    def affine_f32(self, x: torch.Tensor) -> torch.Tensor:
        """The affine in f32 on any input type, unrounded (a bf16 input
        promotes to f32 exactly inside the product)."""
        shape = (-1, 1, 1)
        return x * self.scale.view(shape) + self.bias.view(shape)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1, with a projection shortcut where the
    shape changes.

    The convs compute in the input's type. What follows each conv (its
    frozen BN, the ReLU; after conv3 also the shortcut's BN and the residual
    add) is computed in f32 and rounded to the input's type once, where the
    next conv reads it and at the block's output: the rounding of one XLA
    fusion of those elementwise ops in bf16. In f32 this is the op-by-op
    arithmetic.

    A layer4 block on a tp mesh (`tp_mesh`, set by `parallel/tp.
    shard_model`) holds this rank's output channels of conv1 and bn1 and
    its input channels of conv2: conv1 runs on `copy_to_tp` of the input
    (the shortcut takes the input itself, so the tp all-reduce of the input
    gradient covers conv1's part only), and `reduce_from_tp` sums the
    ranks' partial conv2 outputs in f32 before bn2's f32 chain. In bf16 each
    partial output is rounded to bf16 before that sum, where one device
    rounds the whole conv2 output once: the only arithmetic tp changes,
    besides the order of the sum.
    """

    tp_mesh = None

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        out_channels = channels * 4
        self.conv1 = Conv2d(in_channels, channels, 1, bias=False)
        self.bn1 = FrozenBatchNorm(channels)
        self.conv2 = Conv2d(channels, channels, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(channels)
        self.conv3 = Conv2d(channels, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_channels)
        self.project = in_channels != out_channels or stride != 1
        if self.project:
            self.downsample_conv = Conv2d(in_channels, out_channels, 1, stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        mesh = self.tp_mesh
        y = F.relu(self.bn1.affine_f32(self.conv1(tp.copy_to_tp(x, mesh)))).to(dt)
        y = self.conv2(y)
        if mesh is not None:
            y = tp.reduce_from_tp(y.float(), mesh)
        y = F.relu(self.bn2.affine_f32(y)).to(dt)
        y = self.bn3.affine_f32(self.conv3(y))
        residual = self.downsample_bn.affine_f32(self.downsample_conv(x)) if self.project else x
        return F.relu(y + residual).to(dt)


class ResNetStage(nn.Sequential):
    """`num_blocks` bottlenecks named block0.., the first one strided."""

    def __init__(self, num_blocks: int, in_channels: int, channels: int, stride: int):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"block{i}", Bottleneck(in_channels, channels, stride if i == 0 else 1))
            in_channels = channels * 4


class ResNetFeatureExtractor(nn.Module):
    """conv1 .. layer3: (B, H, W, 3) -> (B, ceil(H/16), ceil(W/16), 1024),
    both NHWC."""

    def __init__(self, blocks, freeze: bool = True):
        super().__init__()
        self.freeze = freeze
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResNetStage(blocks[0], 64, 64, 1)
        self.layer2 = ResNetStage(blocks[1], 256, 128, 2)
        self.layer3 = ResNetStage(blocks[2], 512, 256, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        x = F.relu(self.bn1(self.conv1(x)))
        # max_pool2d pads with -inf, so the padding never wins a window, as
        # the JAX package's explicit -inf pad.
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer1(x)
        if self.freeze:
            x = x.detach()  # conv1, bn1 and layer1 are frozen: no backward through them
        x = self.layer3(self.layer2(x))
        return x.permute(0, 2, 3, 1)


class ResNetHead(nn.Module):
    """Pooled RoIs (P, 7, 7, 1024) -> layer4 -> spatial mean (P, 2048). No
    dropout."""

    def __init__(self, blocks):
        super().__init__()
        self.layer4 = ResNetStage(blocks[3], 1024, 512, 2)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        return self.layer4(rois.permute(0, 3, 1, 2)).mean(dim=(2, 3))


def _make_spec(arch: str) -> BackboneSpec:
    blocks = ARCHITECTURES[arch]
    return BackboneSpec(
        name=arch,
        feature_map_channels=1024,
        feature_pixels=16,
        feature_vector_size=2048,
        preprocessing=TORCHVISION_RGB,
        fm_ceil_mode=True,
        make_feature_extractor=lambda freeze=True: ResNetFeatureExtractor(blocks, freeze),
        make_head=lambda dropout=0.0: ResNetHead(blocks),
        frozen_param_patterns=(
            r".*feature_extractor\.conv1.*",
            r".*feature_extractor\.bn1.*",
            r".*layer1\..*",
            r".*\.bn\d\..*",  # every BN affine, layer4's too
            r".*downsample_bn\..*",
        ),
    )


for _arch in ARCHITECTURES:
    register_backbone(_arch, lambda a=_arch: _make_spec(a))
