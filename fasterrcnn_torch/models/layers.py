"""Conv and dense layers that keep f32 parameters and compute in the input's
type.

The JAX package's layers take `param_dtype=float32` and a compute `dtype`:
the optimizer updates f32 parameters, and a bf16 model casts them to bf16 at
each use (flax promotes kernel, bias and input to the compute type). These
subclasses do the same: the weight and bias (where there is one: a conv
built with `bias=False` has none) are cast to the input's type in
`forward`, a no-op for f32 inputs. The cast is part of the autograd graph,
so gradients reach the f32 parameters in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
