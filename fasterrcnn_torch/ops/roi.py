"""RoI feature extraction: 14x14 bilinear crop + 2x2 max pool -> 7x7.

The tf2 reference tree's RoI layer (crop_and_resize + max pool), as the JAX
package computes it. Every image's feature map spans its padded canvas; RoIs
(pixel corners) are scaled onto the *real* feature grid by
norm = ((fh - 1) / img_h, (fw - 1) / img_w), and a sample that falls outside
the canvas map contributes 0.

`roi_pool_taps` is the differentiable entry point (`RoIPoolTaps`): its
forward launches the hand-written kernel `ops/kernels/csrc/roi_pool_taps.cu`
on a CUDA tensor and runs `roi_pool_features`, the same function in plain
PyTorch, on a CPU tensor; its backward is `roi_pool_taps_bwd`, which launches
`ops/kernels/csrc/roi_pool_taps_bwd.cu` on a CUDA tensor and runs
`roi_pool_taps_bwd_plain` on a CPU tensor. The feature map alone gets a
cotangent: RoIs are constants of the train step. `roi_pool_fused` (forward
only; no model calls it) computes the same crop + pool with the rounding of
the TPU's dense weight-sheet kernel, launching
`ops/kernels/csrc/roi_pool_fused.cu` (the taps kernel's column walk with
that rounding) on a CUDA tensor and running `roi_pool_fused_plain` (the
sheets) on a CPU tensor. In bf16 each rounds where its TPU kernel rounds.
All take a fixed number of padded RoIs; rows of invalid RoIs are garbage
that callers mask out.
"""

from __future__ import annotations

from typing import Optional

import torch

from fasterrcnn_torch.ops.kernels import _build

CROP_SIZE = 14
OUTPUT_SIZE = 7


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 `x` rounded to `dtype` and held in f32; the identity for f32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _interp_weights(
    coords: torch.Tensor, size: int, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear interpolation weight sheets of the low and the high tap.

    Args:
      coords: (..., S) sample positions in source-cell space [0, size-1].
        Positions outside that range get all-zero weights.
      size: number of source cells.
      dtype: the map's type. The weights are rounded to it, as the TPU
        kernels cast their weight sheets to the map's type
        (`roi_pallas.py:106,194,219-220`).

    Returns:
      Two (..., S, size) f32 sheets such that `lo @ src + hi @ src`
      interpolates. Each row of a sheet holds at most one non-zero, so each
      product is one rounded multiply whatever order a matmul sums in (in
      bf16 an exact one), and the two taps are then added once: the
      interpolation rounds as the CUDA kernels' does.
    """
    lo = torch.floor(coords)
    frac = coords - lo
    idx = torch.arange(size, dtype=torch.float32, device=coords.device)
    in_range = ((coords >= 0.0) & (coords <= size - 1.0))[..., None]
    w_lo = torch.where((idx == lo[..., None]) & in_range, 1.0 - frac[..., None], 0.0)
    w_hi = torch.where((idx == lo[..., None] + 1.0) & in_range, frac[..., None], 0.0)
    return _round_to(w_lo, dtype), _round_to(w_hi, dtype)


def _sample_positions(rois: torch.Tensor, norm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, P, S) y and x sample positions on the feature grid."""
    scale = norm.float()[:, (0, 1, 0, 1)]  # (B, 4) -> (sy, sx, sy, sx)
    r = rois.float() * scale[:, None, :]
    # s / (S-1) rounded once to f32, as an f32 division gives it. (PyTorch on
    # CUDA divides a tensor by a scalar as a product with the reciprocal,
    # which is an ulp off for some s and moves the sample positions.)
    steps = torch.tensor(
        [s / (CROP_SIZE - 1) for s in range(CROP_SIZE)], dtype=torch.float32, device=rois.device
    )
    ys = r[..., 0:1] + (r[..., 2:3] - r[..., 0:1]) * steps
    xs = r[..., 1:2] + (r[..., 3:4] - r[..., 1:2]) * steps
    return ys, xs


def _rows_and_x_weights(feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor):
    """The y-stage shared by both crop formulations and the x-tap sheets.

    Returns (rows (B, P, S, W, C), wx_lo, wx_hi (B, P, S, W)), all f32: each
    row is the y-interpolated map, its two taps added once in f32 and the sum
    rounded to the map's type, where both TPU kernels round it
    (`roi_pallas.py:120,202`).
    """
    _, h, w, _ = feature_map.shape
    dt = feature_map.dtype
    ys, xs = _sample_positions(rois, norm)  # (B, P, S) each
    wy_lo, wy_hi = _interp_weights(ys, h, dt)  # (B, P, S, H) each
    wx_lo, wx_hi = _interp_weights(xs, w, dt)  # (B, P, S, W) each
    fm = feature_map.float()
    rows = torch.einsum("bpsh,bhwc->bpswc", wy_lo, fm) + torch.einsum("bpsh,bhwc->bpswc", wy_hi, fm)
    return _round_to(rows, dt), wx_lo, wx_hi


def crop_and_resize(feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Bilinear crop of each RoI to (CROP_SIZE, CROP_SIZE) samples, as the
    taps kernel (K2, `roi_pallas.py:_roi_taps_kernel`) computes it.

    Args:
      feature_map: (B, H, W, C) canvas feature maps, f32 or bf16.
      rois: (B, P, 4) boxes (y1, x1, y2, x2) in image-pixel coordinates.
      norm: (B, 2) pixel -> feature-grid factors ((fh-1)/img_h, (fw-1)/img_w).

    Returns:
      (B, P, CROP_SIZE, CROP_SIZE, C) crops in f32 holding values of the
      map's type. The weights are rounded to the map's type; the rows are
      y-interpolated and rounded (`_rows_and_x_weights`); then each x-tap
      product is rounded to the map's type and so is their sum, as the TPU
      kernel computes its x-taps in the map's type (`roi_pallas.py:218-221`).
      In f32 every rounding is the f32 operation's own.
    """
    dt = feature_map.dtype
    rows, wx_lo, wx_hi = _rows_and_x_weights(feature_map, rois, norm)
    lo = _round_to(torch.einsum("bpqw,bpswc->bpsqc", wx_lo, rows), dt)
    hi = _round_to(torch.einsum("bpqw,bpswc->bpsqc", wx_hi, rows), dt)
    return _round_to(lo + hi, dt)  # (B, P, y, x, C)


def _max_pool(crops: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, P, 14, 14, C) crops -> (B, P, 7, 7, C) 2x2 maxima in `dtype`."""
    b, p, _, _, c = crops.shape
    pooled = crops.reshape(b, p, OUTPUT_SIZE, 2, OUTPUT_SIZE, 2, c).amax(dim=(3, 5))
    return pooled.to(dtype)


def roi_pool_features(
    feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor
) -> torch.Tensor:
    """Plain RoI pooling: 14x14 crop + 2x2 max pool -> (B, P, 7, 7, C), map dtype."""
    return _max_pool(crop_and_resize(feature_map, rois, norm), feature_map.dtype)


def roi_pool_taps_bwd_plain(
    feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Cotangent of `roi_pool_features` with respect to the feature map.

    The TPU backward kernel's semantics, in plain PyTorch: the forward's
    samples are recomputed as `crop_and_resize` computes them; each output's
    cotangent g (B, P, 7, 7, C) is split equally among the samples of its 2x2
    window that equal the window's max (all four counted); the shares go
    through the x-taps and then the y-taps in f32, with the forward's weights
    (rounded to the map's type, `roi_pallas.py:365-366,387,391,399`), and
    the (B, H, W, C) result is cast once to the map's type. (Autograd of the plain forward
    would round the row cotangent to bf16 at the forward's row rounding.)
    """
    b, h, w, c = feature_map.shape
    p = rois.shape[1]
    window = crop_and_resize(feature_map, rois, norm).reshape(b, p, OUTPUT_SIZE, 2, OUTPUT_SIZE, 2, c)
    ties = (window == window.amax(dim=(3, 5), keepdim=True)).float()
    share = g.float().reshape(b, p, OUTPUT_SIZE, 1, OUTPUT_SIZE, 1, c) / ties.sum(dim=(3, 5), keepdim=True)
    gcrops = (ties * share).reshape(b, p, CROP_SIZE, CROP_SIZE, c)
    ys, xs = _sample_positions(rois, norm)
    wy_lo, wy_hi = _interp_weights(ys, h, feature_map.dtype)  # (B, P, S, H) each
    wx_lo, wx_hi = _interp_weights(xs, w, feature_map.dtype)  # (B, P, S, W) each
    grows = torch.einsum("bpqw,bpsqc->bpswc", wx_lo, gcrops) + torch.einsum("bpqw,bpsqc->bpswc", wx_hi, gcrops)
    gfm = torch.einsum("bpsh,bpswc->bhwc", wy_lo, grows) + torch.einsum("bpsh,bpswc->bhwc", wy_hi, grows)
    return gfm.to(feature_map.dtype)


def roi_pool_fused_plain(
    feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor
) -> torch.Tensor:
    """RoI crop + pool as the dense weight-sheet kernel (K4,
    `roi_pallas.py:_roi_kernel`) rounds it -> (B, P, 7, 7, C), map dtype.

    The same function as `roi_pool_features`, with K4's rounding points:
    weight sheets in the map's type; the y-contraction summed in f32 and
    rounded to the map's type (`:114-120`); the x-contraction likewise
    summed in f32 and rounded once (`:127-133`), where the taps kernel
    rounds each x-tap product too; then the 2x2 max. In f32 the two agree
    bit for bit; in bf16 K4's output is a bf16 step off K2's on some values.
    """
    dt = feature_map.dtype
    rows, wx_lo, wx_hi = _rows_and_x_weights(feature_map, rois, norm)
    crops = torch.einsum("bpqw,bpswc->bpsqc", wx_lo, rows) + torch.einsum("bpqw,bpswc->bpsqc", wx_hi, rows)
    return _max_pool(_round_to(crops, dt), dt)


def _check_roi_args(feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor) -> None:
    if feature_map.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"feature_map {tuple(feature_map.shape)} / rois {tuple(rois.shape)}")
    b = feature_map.shape[0]
    if rois.shape[0] != b or tuple(norm.shape) != (b, 2):
        raise ValueError(f"rois {tuple(rois.shape)} / norm {tuple(norm.shape)} for batch {b}")
    if feature_map.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feature_map must be float32 or bfloat16, got {feature_map.dtype}")
    dev = feature_map.device
    if dev.type not in ("cpu", "cuda") or rois.device != dev or norm.device != dev:
        raise ValueError(f"feature_map on {dev}, rois on {rois.device}, norm on {norm.device}")


def lane_width(c: int, *tensors: torch.Tensor, channels: Optional[int] = None) -> int:
    """Channels a thread of K2, K3 or K4 works on: `channels` (default 16 bytes
    of the first tensor's type: 4 f32 or 8 bf16), so that a thread's run of
    them is one vector access, when C is a multiple of it and every tensor's
    data is aligned to such a run of its own type; else 1 (scalar lanes, the
    same kernel and the same values)."""
    vec = channels or 16 // tensors[0].element_size()
    if c % vec == 0 and all(t.data_ptr() % (vec * t.element_size()) == 0 for t in tensors):
        return vec
    return 1


def _launch_forward(name: str, feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Launch a RoI forward kernel (`roi_pool_taps` or `roi_pool_fused`) on
    CUDA tensors: (B,H,W,C), (B,P,4), (B,2) -> (B,P,7,7,C) in the map's type."""
    b, h, w, c = feature_map.shape
    fm = feature_map.contiguous()
    rois = rois.float().contiguous()
    norm = norm.float().contiguous()
    p = rois.shape[1]
    out = torch.empty((b, p, OUTPUT_SIZE, OUTPUT_SIZE, c), dtype=fm.dtype, device=fm.device)
    with torch.cuda.device(fm.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            name,
            fm.data_ptr(), rois.data_ptr(), norm.data_ptr(), out.data_ptr(),
            b, h, w, c, p, int(fm.dtype == torch.bfloat16), lane_width(c, fm, out), stream,
        )
    return out


def _roi_pool_taps_forward(feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """The forward wrapper: kernel on a CUDA tensor, plain version on the CPU."""
    if feature_map.device.type == "cpu":
        return roi_pool_features(feature_map, rois, norm)
    out = _launch_forward("roi_pool_taps", feature_map, rois, norm)
    roi_pool_taps.launches += 1
    return out


def roi_pool_taps_bwd(
    feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Feature-map cotangent of `roi_pool_taps`: (B,H,W,C) in the map's type.

    CPU tensors go to `roi_pool_taps_bwd_plain`; CUDA tensors launch the
    kernel, which accumulates into a zeroed f32 map that is then cast to the
    map's type. g must be a contiguous (B, P, 7, 7, C) tensor of the map's type.
    """
    _check_roi_args(feature_map, rois, norm)
    b, h, w, c = feature_map.shape
    p = rois.shape[1]
    if tuple(g.shape) != (b, p, OUTPUT_SIZE, OUTPUT_SIZE, c) or g.dtype != feature_map.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} for feature_map {tuple(feature_map.shape)} "
                         f"{feature_map.dtype} and {p} RoIs")
    if g.device != feature_map.device:
        raise ValueError(f"feature_map on {feature_map.device}, g on {g.device}")
    if feature_map.device.type == "cpu":
        return roi_pool_taps_bwd_plain(feature_map, rois, norm, g)
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    fm = feature_map.contiguous()
    rois = rois.float().contiguous()
    norm = norm.float().contiguous()
    gfm = torch.zeros((b, h, w, c), dtype=torch.float32, device=fm.device)
    item = fm.element_size() // 2  # 2 for f32, 1 for bf16
    with torch.cuda.device(fm.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "roi_pool_taps_bwd",
            fm.data_ptr(), rois.data_ptr(), norm.data_ptr(), g.data_ptr(), gfm.data_ptr(),
            # 8 bytes of the map a thread (2 f32 or 4 bf16 channels), one
            # vector reduction into gfm: wider lanes cost registers and ran slower.
            b, h, w, c, p, int(fm.dtype == torch.bfloat16), lane_width(c, fm, g, gfm, channels=4 // item), stream,
        )
    roi_pool_taps_bwd.launches += 1
    return gfm.to(fm.dtype)


roi_pool_taps_bwd.launches = 0


class RoIPoolTaps(torch.autograd.Function):
    """RoI crop + pool with the hand-written backward; RoIs and norm get no
    cotangent. Saves its inputs, not its output: the backward recomputes the
    samples."""

    @staticmethod
    def forward(ctx, feature_map, rois, norm):
        ctx.save_for_backward(feature_map, rois, norm)
        return _roi_pool_taps_forward(feature_map, rois, norm)

    @staticmethod
    def backward(ctx, g):
        fm, rois, norm = ctx.saved_tensors
        return roi_pool_taps_bwd(fm, rois, norm, g.contiguous()), None, None


def roi_pool_taps(
    feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor
) -> torch.Tensor:
    """RoI crop + pool: (B,H,W,C) f32/bf16, (B,P,4), (B,2) -> (B,P,7,7,C).

    Differentiable with respect to the feature map (`RoIPoolTaps`). CPU
    tensors take the plain versions; CUDA tensors launch the kernels.
    """
    _check_roi_args(feature_map, rois, norm)
    return RoIPoolTaps.apply(feature_map, rois, norm)


roi_pool_taps.launches = 0


def roi_pool_fused(
    feature_map: torch.Tensor, rois: torch.Tensor, norm: torch.Tensor
) -> torch.Tensor:
    """RoI crop + pool with the dense weight-sheet kernel's rounding (K4):
    (B,H,W,C) f32/bf16, (B,P,4), (B,2) -> (B,P,7,7,C) in the map's type.

    The counterpart of `roi_pool_fused_pallas`, kept, as there, as the
    reference point against the taps kernel; no model calls it. Forward only:
    the JAX op defines no gradient, so a map that requires grad raises. CPU
    tensors take `roi_pool_fused_plain`; CUDA tensors launch
    `ops/kernels/csrc/roi_pool_fused.cu`, which walks each RoI's tap columns
    as the taps kernel does and sums each sample's two x-tap products in f32
    before one rounding, with the lane width of `lane_width`. A sample there
    reads only its taps: a map that holds inf or NaN outside a RoI's taps
    does not spread it into that RoI, as the plain version's sheets do
    through a zero weight (0 * inf is NaN). On finite maps the two are equal
    bit for bit.
    """
    _check_roi_args(feature_map, rois, norm)
    if feature_map.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("roi_pool_fused has no gradient: use roi_pool_taps to train")
    if feature_map.device.type == "cpu":
        return roi_pool_fused_plain(feature_map, rois, norm)
    out = _launch_forward("roi_pool_fused", feature_map, rois, norm)
    roi_pool_fused.launches += 1
    return out


roi_pool_fused.launches = 0
