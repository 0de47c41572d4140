"""Tensor parallelism: the two Megatron operators and the sharding of a model.

JAX's GSPMD places the tp collectives from the parameters' shardings
(`parallel/mesh.py`'s `_PARAM_RULES`): one all-reduce after the row-sharded
product (fc2, or a ResNet layer4 block's conv2) forward, and one on the
input gradient of the column-sharded product (fc1, or conv1) backward. Here
they are two autograd functions over the mesh's tp group:

  * `copy_to_tp`: the identity forward; the backward all-reduces the
    gradient (each rank's column shard gives part of the input gradient);
  * `reduce_from_tp`: the forward all-reduces (each rank's row shard gives
    part of the product); the identity backward.

Both are the identity on a mesh of tp=1, and without a mesh.

`shard_model` keeps this rank's shard of every tp-sharded parameter of a
full model and hands the mesh to the modules that run these operators
(`models/vgg16.VGG16Head`, the layer4 `models/resnet.Bottleneck`s);
`average_replicated` gives every rank one gradient of the replicated
parameters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from fasterrcnn_torch.parallel import mesh as mesh_lib


def _all_reduce(t: torch.Tensor, group) -> None:
    """SUM-all-reduce `t` in place over `group`: every tp collective of the
    model goes through here."""
    dist.all_reduce(t, group=group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad).copy_(grad)
        _all_reduce(out, ctx.group)
        return out, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = torch.empty_like(x).copy_(x)
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x`, whose gradient is summed over the tp group (the input of a
    column-sharded product)."""
    if mesh is None or mesh.tp == 1:
        return x
    return _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` summed over the tp group (the partial output of a row-sharded
    product); its gradient passes unchanged."""
    if mesh is None or mesh.tp == 1:
        return x
    return _ReduceFromTP.apply(x, mesh.tp_group)


@torch.no_grad()
def average_replicated(grads: torch.Tensor, mesh) -> None:
    """Replace `grads`, the replicated parameters' gradients (contiguous),
    by their sum over every rank divided by tp: the dp sum, and the mean of
    the tp ranks' copies, which a card computes alike only up to its
    nondeterministic reductions. Every rank then holds the same bits."""
    _all_reduce(grads, mesh.group)
    grads.div_(mesh.tp)


@torch.no_grad()
def shard_model(model: nn.Module, mesh) -> None:
    """Replace each tp-sharded parameter of the full `model` (`mesh_lib.
    param_spec`) by this rank's shard, a parameter of its own flagged
    `tp_sharded` (the optimizer's clipping and `DataParallelStep` read the
    flag), and set `tp_mesh` on the module that holds the sharded layers
    (the parameter's module's parent: `roi_head`, or a
    `roi_head.layer4.block{i}`). The layers keep their full
    `in_features`/`out_features` (`in_channels`/`out_channels`). Nothing on
    a mesh of tp=1."""
    if mesh is None or mesh.tp == 1:
        return
    mesh_lib.warn_if_tp_unused(mesh, dict(model.named_parameters()))
    for name, p in list(model.named_parameters()):
        dim = mesh_lib.param_spec(name)
        if dim is None:
            continue
        module_name, leaf = name.rsplit(".", 1)
        shard = mesh_lib.shard_tensor(mesh, p.detach(), dim)
        shard = shard.contiguous(memory_format=torch.channels_last) if shard.dim() == 4 else shard.contiguous()
        param = nn.Parameter(shard.clone(), requires_grad=p.requires_grad)
        param.tp_sharded = True
        setattr(model.get_submodule(module_name), leaf, param)
        model.get_submodule(module_name.rsplit(".", 1)[0]).tp_mesh = mesh
