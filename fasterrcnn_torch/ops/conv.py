"""3x3 SAME stride-1 convolutions (+ bias, optional fused ReLU), NHWC.

The counterpart of the JAX package's `ops/pallas/conv_pallas.py`: two
hand-written kernels for the same function, kept, as there, for the conv
A/B (`fasterrcnn_torch/scripts/profile_conv.py`) against the library conv;
no model calls them (the backbone's convs are cuDNN's, `models/layers.py`).

  * `conv3x3` launches `ops/kernels/csrc/conv3x3.cu` (K5): the TPU kernel's
    nine shifted matmuls over one staged, W-padded input window.
  * `conv3x3_im2col` launches `ops/kernels/csrc/conv3x3_im2col.cu` (K6): one
    GEMM of depth 9C over a kx-major patch matrix, the TPU kernel's
    formulation for the C = 64/128 layers.

Each kernel runs on the tensor cores (`wgmma`, `csrc/conv_wgmma.cuh`) in
two paths chosen by x's dtype: bf16 as it is, f32 as 3xTF32 (each f32
operand split into a TF32 high and low part, three TF32 products summed in
f32, which keeps f32 parity). The weights come prepacked in the kernels'
B layout, by `pack_conv3x3_weights` / `pack_conv3x3_im2col_weights` (bf16)
and `pack_conv3x3_weights_f32` / `pack_conv3x3_im2col_weights_f32` (f32,
split into hi and lo by `split_tf32`); input channels are zero-padded to a
multiple of 8 for 16-byte copies. A bf16 x takes bf16 weights and bias: with
f32 weights the JAX package's `jnp.dot(bf16, f32)` would promote to f32, a
different function.

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


# Tiles of the kernels (csrc/conv_wgmma.cuh, conv3x3.cu, conv3x3_im2col.cu).
TILE_N = 128  # output channels a block
K5_CHUNK = 32  # input channels a K5 bf16 stage (one ky, three kx taps)
K6_CHUNK = 64  # input channels a K6 bf16 K-tile (one tap)
K5_CHUNK_F32 = 16  # the same in f32 (half K5's, so that three stages fit)
K6_CHUNK_F32 = 32


def _padded(w: torch.Tensor, chunk: int, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, C, 3, 3) in dtype, zero-padded to a multiple of TILE_N output
    channels and of `chunk` input channels."""
    cout, c = w.shape[:2]
    w = w.to(dtype)
    if c % chunk or cout % TILE_N:  # VGG's widths need no padding: no copy
        w = F.pad(w, (0, 0, 0, 0, 0, -c % chunk, 0, -cout % TILE_N))
    return w


def pack_conv3x3_weights(w: torch.Tensor) -> torch.Tensor:
    """K5's bf16 B operand: (Cout, C, 3, 3) -> (Cout/128 tiles, 3 ky, C/32
    chunks, 3 kx, 4 channel groups, 128 output channels, 8 channels), both
    counts rounded up with zeros. One (tile, ky, chunk) block is a stage's
    weights in the wgmma K-major layout: 8 channels of one output channel a
    16-byte row."""
    wp = _padded(w, K5_CHUNK, torch.bfloat16)
    n, cp = wp.shape[0] // TILE_N, wp.shape[1] // K5_CHUNK
    t = wp.reshape(n, TILE_N, cp, K5_CHUNK // 8, 8, 3, 3)  # tile, co, chunk, group, e, ky, kx
    return t.permute(0, 5, 2, 6, 3, 1, 4).contiguous()


def pack_conv3x3_im2col_weights(w: torch.Tensor) -> torch.Tensor:
    """K6's bf16 B operand: (Cout, C, 3, 3) -> (Cout/128 tiles, 9 taps, C/64
    chunks, 8 channel groups, 128 output channels, 8 channels), tap = kx * 3
    + ky (the patch matrix's kx-major column order), both counts rounded up
    with zeros; one (tile, tap, chunk) block is a K-tile."""
    wp = _padded(w, K6_CHUNK, torch.bfloat16)
    n, cp = wp.shape[0] // TILE_N, wp.shape[1] // K6_CHUNK
    t = wp.reshape(n, TILE_N, cp, K6_CHUNK // 8, 8, 3, 3)  # tile, co, chunk, group, e, ky, kx
    return t.permute(0, 6, 5, 2, 3, 1, 4).reshape(n, 9, cp, K6_CHUNK // 8, TILE_N, 8).contiguous()


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 v rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as `cvt.rna.tf32.f32` rounds: the 13 low bits of the result are 0."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor):
    """(hi, lo): the TF32 high part of f32 v and the TF32 rounding of the
    (exact) remainder, so hi + lo equals v within 2^-22 of |v|."""
    hi = round_tf32(v)
    return hi, round_tf32(v.float() - hi)


def _pack_f32(w: torch.Tensor, chunk: int, order) -> torch.Tensor:
    """(Cout, C, 3, 3) -> both TF32 parts of the f32 kernels' B operand, as
    (part, tile, co, chunk, k8 step, e, h, ky, kx) permuted to `order`:
    within each 8 channels, channel 2 e + h sits at K-group h, element e (k
    order 0, 2, 4, 6 | 1, 3, 5, 7), the order in which each thread of the
    kernel loads two adjacent channels as its A fragment's columns k and
    k + 4."""
    wp = _padded(w, chunk, torch.float32)
    n, cp = wp.shape[0] // TILE_N, wp.shape[1] // chunk
    t = torch.stack(split_tf32(wp)).reshape(2, n, TILE_N, cp, chunk // 8, 4, 2, 3, 3)
    return t.permute(order).contiguous()


def pack_conv3x3_weights_f32(w: torch.Tensor) -> torch.Tensor:
    """K5's f32 B operand: (Cout, C, 3, 3) -> (Cout/128 tiles, 3 ky, C/16
    chunks, 2 parts (TF32 hi, lo), 3 kx, 4 K-groups, 128 output channels, 4
    channels), both counts rounded up with zeros; one (tile, ky, chunk)
    block is a stage's weights (see `_pack_f32` for the channel order)."""
    t = _pack_f32(w, K5_CHUNK_F32, (1, 7, 3, 0, 8, 4, 6, 2, 5))
    return t.reshape(*t.shape[:5], K5_CHUNK_F32 // 4, TILE_N, 4)


def pack_conv3x3_im2col_weights_f32(w: torch.Tensor) -> torch.Tensor:
    """K6's f32 B operand: (Cout, C, 3, 3) -> (Cout/128 tiles, 9 taps, C/32
    chunks, 2 parts (TF32 hi, lo), 8 K-groups, 128 output channels, 4
    channels), tap = kx * 3 + ky, both counts rounded up with zeros; one
    (tile, tap, chunk) block is a K-tile."""
    t = _pack_f32(w, K6_CHUNK_F32, (1, 8, 7, 3, 0, 4, 6, 2, 5))
    return t.reshape(t.shape[0], 9, *t.shape[3:5], K6_CHUNK_F32 // 4, TILE_N, 4)


PACKERS = {
    ("conv3x3", torch.bfloat16): pack_conv3x3_weights,
    ("conv3x3_im2col", torch.bfloat16): pack_conv3x3_im2col_weights,
    ("conv3x3", torch.float32): pack_conv3x3_weights_f32,
    ("conv3x3_im2col", torch.float32): pack_conv3x3_im2col_weights_f32,
}


def pad_channels8(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) with C zero-padded to a multiple of 8 (exact: the
    padded channels meet zero weights)."""
    return F.pad(x, (0, -x.shape[-1] % 8)) if x.shape[-1] % 8 else x


def _check_conv_args(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(f"x {tuple(x.shape)} (B,H,W,C) / w {tuple(w.shape)} (Cout,C,3,3)")
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"bias {tuple(b.shape)} for {w.shape[0]} output channels")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dtype == torch.bfloat16 and (w.dtype, b.dtype) != (torch.bfloat16, torch.bfloat16):
        raise TypeError(f"bf16 x takes bf16 weights and bias, got {w.dtype} and {b.dtype}")
    dev = x.device
    if dev.type not in ("cpu", "cuda") or w.device != dev or b.device != dev:
        raise ValueError(f"x on {dev}, w on {w.device}, b on {b.device}")


def kernel_operands(name: str, x: torch.Tensor, w: torch.Tensor):
    """(x, weights) as kernel `name` ("conv3x3" or "conv3x3_im2col") takes
    them: x with its channels zero-padded to a multiple of 8, and the
    weights packed for x's dtype (`PACKERS`)."""
    return pad_channels8(x), PACKERS[name, x.dtype](w)


def launch_kernel(name: str, x: torch.Tensor, wt: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch conv kernel `name` on CUDA operands from `kernel_operands`;
    counts no launch (the wrappers do). Returns (B,H,W,Cout) in x's type."""
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
    out = launch_kernel("conv3x3", *kernel_operands("conv3x3", x, w), b, relu)
    conv3x3.launches += 1
    return out


def _conv3x3_im2col_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu)
    out = launch_kernel("conv3x3_im2col", *kernel_operands("conv3x3_im2col", x, w), b, relu)
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
