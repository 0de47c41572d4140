"""3x3 SAME stride-1 convolutions (+ bias, optional fused ReLU), NHWC.

The counterpart of the JAX package's `ops/pallas/conv_pallas.py`: two
hand-written kernels for the same function, kept, as there, for the conv
A/B (`fasterrcnn_torch/scripts/profile_conv.py`) against the library conv;
no model calls them (the backbone's convs are cuDNN's, `models/layers.py`).

  * `conv3x3` launches `ops/kernels/csrc/conv3x3.cu` (K5): a direct conv,
    the taps visited kx outer, ky inner, as the TPU kernel's nine shifted
    matmuls.
  * `conv3x3_im2col` launches `ops/kernels/csrc/conv3x3_im2col.cu` (K6): one
    GEMM of depth 9C over a kx-major patch matrix, the TPU kernel's
    formulation for the C = 64/128 layers.

Activations are (B, H, W, C) and weights (Cout, C, 3, 3), the layout
`nn.Conv2d` holds. Both wrappers run `conv3x3_plain` on a CPU tensor and
their kernel on a CUDA tensor, and are differentiable: the backward is
autograd of `conv3x3_plain`, recomputed from the saved inputs (the ReLU mask
with it), as the JAX custom VJPs differentiate the library conv.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from fasterrcnn_torch.ops.kernels import _build


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The library conv on f32 copies: (B,H,W,C), (Cout,C,3,3), (Cout,) ->
    (B,H,W,Cout) in x's type; + bias in f32, optional ReLU, then the cast
    (the JAX package's `_xla_conv3x3`)."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w.float(), padding=1)
    out = out + b.float()[:, None, None]
    if relu:
        out = torch.relu(out)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check_conv_args(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"x {tuple(x.shape)} (B,H,W,C) / w {tuple(w.shape)} (Cout,C,3,3)")
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"bias {tuple(b.shape)} for {w.shape[0]} output channels")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    dev = x.device
    if dev.type not in ("cpu", "cuda") or w.device != dev or b.device != dev:
        raise ValueError(f"x on {dev}, w on {w.device}, b on {b.device}")


def _launch(name: str, x: torch.Tensor, wt: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch a conv kernel on x (B,H,W,C) with its repacked f32 weights."""
    bsz, h, wd, c = x.shape
    cout = b.shape[0]
    x = x.contiguous()
    bias = b.float().contiguous()
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            name, x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
            bsz, h, wd, c, cout, int(relu), int(x.dtype == torch.bfloat16), stream,
        )
    return out


def _conv3x3_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu)
    # (Cout, C, ky, kx) -> (ky, kx, C, Cout), the TPU kernel's HWIO.
    out = _launch("conv3x3", x, w.float().permute(2, 3, 1, 0).contiguous(), b, relu)
    conv3x3.launches += 1
    return out


def _conv3x3_im2col_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu)
    # (Cout, C, ky, kx) -> (kx, ky, C, Cout) -> (9C, Cout): kx-major, as
    # `_im2col_weights` orders the TPU kernel's patch columns.
    wk = w.float().permute(3, 2, 1, 0).reshape(9 * w.shape[1], w.shape[0]).contiguous()
    out = _launch("conv3x3_im2col", x, wk, b, relu)
    conv3x3_im2col.launches += 1
    return out


class Conv3x3(torch.autograd.Function):
    """A conv kernel's forward; the backward is autograd of `conv3x3_plain`."""

    @staticmethod
    def forward(ctx, x, w, b, relu: bool, forward: Callable):
        ctx.save_for_backward(x, w, b)
        ctx.relu = relu
        return forward(x, w, b, relu)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out = conv3x3_plain(*inputs, ctx.relu)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if need else None for need in needs), None, None)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """3x3 SAME conv + bias (+ ReLU): (B,H,W,C), (Cout,C,3,3), (Cout,) ->
    (B,H,W,Cout) in x's type, through K5 on a CUDA tensor."""
    _check_conv_args(x, w, b)
    return Conv3x3.apply(x, w, b, relu, _conv3x3_forward)


conv3x3.launches = 0


def conv3x3_im2col(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """The same conv as `conv3x3`, through K6 (the im2col GEMM) on a CUDA
    tensor."""
    _check_conv_args(x, w, b)
    return Conv3x3.apply(x, w, b, relu, _conv3x3_im2col_forward)


conv3x3_im2col.launches = 0
