"""VGG-16 backbone: 13 3x3 convs with a stride-16 feature map, and the
two-layer 4096-d fully connected RoI head.

Module names (block{i}_conv{j}, fc1/fc2) are the JAX package's parameter
names, so `utils/weights.py` maps one state onto the other by name. The
convs run NCHW in the `channels_last` memory format; the extractor takes and
returns NHWC tensors, the layout of the JAX package's public functions.
Max pools floor (VALID padding), so the map extent is `size // 16`.
Blocks 1-2 are frozen in training unless `ModelConfig.train_all`: their
parameters are listed in `frozen_param_patterns`, and the extractor cuts the
gradient after block 2 so no backward pass runs through them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fasterrcnn_torch.data.image import CAFFE_BGR, TORCHVISION_RGB
from fasterrcnn_torch.models.backbone import BackboneSpec, register_backbone
from fasterrcnn_torch.models.layers import Conv2d, Linear
from fasterrcnn_torch.parallel import tp

_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class VGG16FeatureExtractor(nn.Module):
    """conv1_1..conv5_3; pools after blocks 1-4 only (stride-16 output)."""

    def __init__(self, freeze: bool = True):
        super().__init__()
        self.freeze = freeze
        in_ch = 3
        for block_idx, (num_convs, channels) in enumerate(_BLOCKS):
            for conv_idx in range(num_convs):
                name = f"block{block_idx + 1}_conv{conv_idx + 1}"
                self.add_module(name, Conv2d(in_ch, channels, 3, padding=1))
                in_ch = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/16, W/16, 512), both NHWC."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        for block_idx, (num_convs, _) in enumerate(_BLOCKS):
            for conv_idx in range(num_convs):
                conv = getattr(self, f"block{block_idx + 1}_conv{conv_idx + 1}")
                x = F.relu(conv(x))
            if block_idx < 4:  # no pool after block 5
                x = F.max_pool2d(x, 2, 2)
            if block_idx == 1 and self.freeze:
                x = x.detach()  # blocks 1-2 are frozen: no backward through them
        return x.permute(0, 2, 3, 1)


class VGG16Head(nn.Module):
    """Pooled RoIs (P, 7, 7, 512) -> feature vectors (P, 4096), flattened in
    HWC order as the JAX package flattens them. Dropout after fc1 and fc2
    when `dropout` > 0, active in training mode only.

    On a tp mesh (`tp_mesh`, set by `parallel/tp.shard_model`) fc1 holds
    this rank's rows of the weight (its output columns) and fc2 its columns:
    fc1 runs on `copy_to_tp` of the input, fc2 without its bias, then
    `reduce_from_tp` sums the ranks' partial products in f32 and fc2's bias
    is added once. In bf16 each partial product is rounded to bf16 before
    that sum and the bias is added in f32, rounding once, where one device
    rounds the whole product with its bias: the only arithmetic tp changes,
    besides the order of the sum. Every tp rank of a dp row draws the whole
    (P, 4096) dropout masks, as one device draws them, from the default
    generators its row shares (`engine.rank_seed` of the dp index), and
    fc1's is sliced to this rank's columns: the replicated fc2 output sees
    the same mask on every rank of the row."""

    tp_mesh = None

    def __init__(self, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(7 * 7 * 512, 4096)
        self.fc2 = Linear(4096, 4096)
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else nn.Identity()

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        x = rois.reshape(rois.shape[0], -1)
        mesh = self.tp_mesh
        if mesh is None:
            x = self.dropout(F.relu(self.fc1(x)))
            return self.dropout(F.relu(self.fc2(x)))
        x = self._tp_dropout(F.relu(self.fc1(tp.copy_to_tp(x, mesh))), self.fc1.out_features, mesh)
        partial = F.linear(x, self.fc2.weight.to(x.dtype))
        x = (tp.reduce_from_tp(partial.float(), mesh) + self.fc2.bias).to(x.dtype)
        return self._tp_dropout(F.relu(x), self.fc2.out_features, mesh)

    def _tp_dropout(self, x: torch.Tensor, width: int, mesh) -> torch.Tensor:
        """Dropout of this rank's columns of a (P, width) activation (a
        layer's full width: sharding leaves `out_features` as it was): the
        whole mask drawn (`self.dropout` of ones: F.dropout's draws and
        scale), then sliced."""
        if not (self.training and isinstance(self.dropout, nn.Dropout)):
            return x
        mask = self.dropout(torch.ones(x.shape[0], width, dtype=x.dtype, device=x.device))
        if x.shape[1] != width:
            mask = mask.narrow(1, mesh.tp_index * x.shape[1], x.shape[1])
        return x * mask


def _make_spec() -> BackboneSpec:
    return BackboneSpec(
        name="vgg16",
        feature_map_channels=512,
        feature_pixels=16,
        feature_vector_size=4096,
        preprocessing=CAFFE_BGR,
        fm_ceil_mode=False,
        make_feature_extractor=VGG16FeatureExtractor,
        make_head=VGG16Head,
        frozen_param_patterns=(r".*block1_conv.*", r".*block2_conv.*"),
    )


def _make_torch_spec() -> BackboneSpec:
    """The reference's second VGG-16 flavor: same topology, torchvision
    weight source and RGB/255 preprocessing."""
    return dataclasses.replace(_make_spec(), name="vgg16-torch", preprocessing=TORCHVISION_RGB)


register_backbone("vgg16", _make_spec)
register_backbone("vgg16-torch", _make_torch_spec)
