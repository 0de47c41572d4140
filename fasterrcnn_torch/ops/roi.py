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

`roi_pool_exact` is the other RoI mode (`roi_mode="exact_pool"`): torchvision's
RoIPool quantization on the whole canvas map, in PyTorch ops on the tensor's
device (the JAX op is XLA, no Pallas kernel), with the JAX op's map cotangent
(`RoIPoolExact`).
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


# Elements one RoI chunk's row gather (B, chunk, 7, rows, W, C) may hold, at
# most; `_exact_plan` also keeps it within a quarter of one image's P*H*W*C
# (JAX's masked row stage is 7*P*H*W*C an image). The backward holds about
# four tensors of the gather's size. At ResNet-101's train shape (B=4, 128
# RoIs an image on a 38x50x1024 map, widest bin 7 rows) the quarter binds:
# 6 RoIs a chunk, 60M elements.
EXACT_CHUNK_ELEMENTS = 1 << 28


def exact_bins(rois: torch.Tensor, spatial_scale: float, output_size: int, h: int, w: int):
    """Torchvision RoIPool's bins of (..., P, 4) boxes (y1, x1, y2, x2) on an
    (h, w) map: (row start, row end, column start, column end), each
    (..., P, output_size) int64, ends exclusive.

    Corners are floor(v * spatial_scale + 0.5) in f32 (C++ round: half away
    from zero, so x1 = 8 at 1/16 goes up; torch.round would round half to
    even), then int32. Each side's span is max(hi - lo + 1, 1) cells; bin b
    covers [lo + span*b // out, lo + ceil(span*(b+1) / out)) in integer
    arithmetic, both ends clipped to [0, size] of the whole map.
    """
    corners = torch.floor(rois.float() * spatial_scale + 0.5).to(torch.int32).long()
    b = torch.arange(output_size, device=rois.device)

    def edges(lo, hi, size):
        span = torch.clamp(hi - lo + 1, min=1)[..., None]
        starts = (span * b) // output_size + lo[..., None]
        ends = (span * (b + 1) + output_size - 1) // output_size + lo[..., None]
        return starts.clamp(0, size), ends.clamp(0, size)

    return (*edges(corners[..., 0], corners[..., 2], h), *edges(corners[..., 1], corners[..., 3], w))


def _exact_slots(starts: torch.Tensor, ends: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """(..., out) bin edges -> (..., out, n) cell indices; a slot past its
    bin's end gets `size`, the -inf padding cell."""
    cells = starts[..., None] + torch.arange(n, device=starts.device)
    return torch.where(cells < ends[..., None], cells, size)


def _pad_neg_inf(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x with one -inf slice appended along `dim`."""
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([x, x.new_full(shape, float("-inf"))], dim=dim)


def _exact_chunk(fm_pad: torch.Tensor, bins, rows: int, cols: int):
    """The two max stages of one RoI chunk, rows first as the JAX op
    reduces, on the map with a -inf row appended (B, H+1, W, C): (B, c, out)
    bins -> the row gather (B, c, out, rows, W, C) and its row indices, the
    row maxima (B, c, out, W, C), the column gather of the row maxima
    (B, c, out, out, cols, C) and its column indices, and the bin maxima
    (B, c, out, out, C). Slots past a bin's end read -inf."""
    bsz, h1, w, ch = fm_pad.shape
    ys, ye, xs, xe = bins
    c, out = ys.shape[1], ys.shape[2]
    dev = fm_pad.device
    # Row gather: whole (W, C) rows of the flattened (B * (H+1)) maps.
    r_idx = _exact_slots(ys, ye, rows, h1 - 1)  # (B, c, out, rows)
    base = (torch.arange(bsz, device=dev) * h1)[:, None, None, None]
    xr = fm_pad.reshape(bsz * h1, w, ch).index_select(0, (base + r_idx).reshape(-1)).view(bsz, c, out, rows, w, ch)
    rowmax = xr.amax(dim=3)  # (B, c, out, W, C)
    # Column gather: whole C vectors of the flattened (B * c * out * (W+1))
    # row maxima, for each bin row i and bin column j.
    c_idx = _exact_slots(xs, xe, cols, w)  # (B, c, out, cols)
    line = torch.arange(bsz * c * out, device=dev).view(bsz, c, out, 1, 1) * (w + 1)
    flat = (line + c_idx[:, :, None]).reshape(-1)  # (B, c, out_i, out_j, cols)
    xc = _pad_neg_inf(rowmax, 3).reshape(-1, ch).index_select(0, flat).view(bsz, c, out, out, cols, ch)
    return xr, r_idx, rowmax, xc, c_idx, xc.amax(dim=4)


def _exact_plan(feature_map: torch.Tensor, rois: torch.Tensor, spatial_scale: float, output_size: int):
    """The bins, the widest bin's rows and columns (read to the host once)
    and the RoIs a chunk: as many as keep the row gather within
    EXACT_CHUNK_ELEMENTS and a quarter of P*H*W*C, but at least one."""
    bsz, h, w, c = feature_map.shape
    budget = min(EXACT_CHUNK_ELEMENTS, rois.shape[1] * h * w * c // 4)
    bins = exact_bins(rois, spatial_scale, output_size, h, w)
    ys, ye, xs, xe = bins
    rows, cols = (max(int(v), 1) for v in torch.stack([(ye - ys).max(), (xe - xs).max()]).tolist())
    chunk = max(1, budget // (bsz * output_size * rows * w * c))
    return bins, rows, cols, chunk


class RoIPoolExact(torch.autograd.Function):
    """Exact RoIPool over RoI chunks, with the map cotangent of the JAX op's
    two max stages. Saves the map and the bins, not the gathers: the
    backward recomputes each chunk's."""

    @staticmethod
    def forward(ctx, feature_map, rois, spatial_scale, output_size):
        bins, rows, cols, chunk = _exact_plan(feature_map, rois, spatial_scale, output_size)
        fm_pad = _pad_neg_inf(feature_map, 1)
        outs = []
        for s in range(0, rois.shape[1], chunk):
            pooled = _exact_chunk(fm_pad, tuple(t[:, s : s + chunk] for t in bins), rows, cols)[-1]
            outs.append(torch.where(torch.isfinite(pooled), pooled, 0.0))
        ctx.save_for_backward(feature_map, *bins)
        ctx.plan = (rows, cols, chunk)
        return torch.cat(outs, dim=1)

    @staticmethod
    def backward(ctx, g):
        fm, *bins = ctx.saved_tensors
        rows, cols, chunk = ctx.plan
        return roi_pool_exact_bwd(fm, tuple(bins), g, rows, cols, chunk), None, None, None


def roi_pool_exact_bwd(fm: torch.Tensor, bins, g: torch.Tensor, rows: int, cols: int, chunk: int) -> torch.Tensor:
    """Map cotangent of exact RoIPool: (B, H, W, C) in the map's type.

    The JAX op's VJP of its two masked maxes: a bin's cotangent (0 where the
    pooled value was not finite) is split evenly among the row maxima of its
    columns that equal the bin's max; each row maximum's cotangent, summed
    over the bins that hold its column, is split evenly among the cells of
    its rows that equal it; each cell sums its shares over RoIs and bin
    rows. Each split is rounded to the map's type (a division of cotangents
    of that type); each sum is carried in f32 and rounded once, as K3
    (`roi_pool_taps_bwd`) sums. JAX on the CPU rounds every partial sum of
    a bf16 reduction instead, so in bf16 the two differ where a sum has more
    than two terms. On the CPU the sums run RoI after RoI, so the chunking
    changes no bit; on a CUDA tensor they are atomic adds in no fixed order.
    Shares of the -inf padding slots land in a padding row and column that
    are dropped.
    """
    bsz, h, w, c = fm.shape
    dt = fm.dtype
    fm_pad = _pad_neg_inf(fm, 1)
    gfm = torch.zeros((bsz * (h + 1), w, c), dtype=torch.float32, device=fm.device)
    base = (torch.arange(bsz, device=fm.device) * (h + 1))[:, None, None, None]
    for s in range(0, g.shape[1], chunk):
        xr, r_idx, rowmax, xc, c_idx, pooled = _exact_chunk(fm_pad, tuple(t[:, s : s + chunk] for t in bins), rows, cols)
        gg = torch.where(torch.isfinite(pooled), g[:, s : s + chunk].float(), 0.0)
        # Column stage: each bin's cotangent over its tied row maxima, summed
        # for each row maximum over the bins that hold its column.
        tied = xc == pooled[..., None, :]  # (B, n, out_i, out_j, cols, C)
        share = _round_to(gg / tied.sum(dim=4), dt)
        n, k = c_idx.shape[1], c_idx.shape[2]
        growmax = torch.zeros((bsz, n, k, w + 1, c), dtype=torch.float32, device=fm.device)
        index = c_idx.reshape(bsz, n, 1, k * cols, 1).expand(-1, -1, k, -1, c)
        growmax.scatter_add_(3, index, (tied * share[..., None, :]).reshape(bsz, n, k, k * cols, c))
        growmax = _round_to(growmax[:, :, :, :w], dt)
        # Row stage: each row maximum's cotangent over its tied cells.
        tied = xr == rowmax[:, :, :, None]  # (B, n, out, rows, W, C)
        share = _round_to(growmax / tied.sum(dim=3), dt)
        gfm.index_add_(0, (base + r_idx).reshape(-1), (tied * share[:, :, :, None]).reshape(-1, w, c))
    return gfm.view(bsz, h + 1, w, c)[:, :h].to(dt)


def roi_pool_exact(
    feature_map: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float = 1.0 / 16.0,
    output_size: int = OUTPUT_SIZE,
) -> torch.Tensor:
    """Exact torchvision RoIPool, the JAX package's `ops/roi.roi_pool_exact`:
    (H, W, C) map and (P, 4) boxes -> (P, out, out, C), or batched, (B, H, W,
    C) and (B, P, 4) -> (B, P, out, out, C), in the map's type (a max never
    rounds).

    Each box's bins come from `exact_bins`; each bin takes the max over its
    cells, and an empty bin, or any non-finite result, gives 0. No Pallas
    kernel sits behind it: the same PyTorch ops run on the tensor's device.
    Instead of JAX's (P, out, H, W, C) masked tensor, each chunk of RoIs (as
    many as `_exact_plan` allows) gathers its bins' rows, as many as the widest bin's, the slots past a bin's end
    reading an appended -inf row; then its bins' columns of the row maxima
    the same way. Differentiable with
    respect to the map (`RoIPoolExact`); boxes are constants.
    """
    single = feature_map.dim() == 3
    if single:
        feature_map, rois = feature_map[None], rois[None]
    if feature_map.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4 or rois.shape[0] != feature_map.shape[0]:
        raise ValueError(f"feature_map {tuple(feature_map.shape)} / rois {tuple(rois.shape)}")
    if feature_map.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feature_map must be float32 or bfloat16, got {feature_map.dtype}")
    if rois.device != feature_map.device:
        raise ValueError(f"feature_map on {feature_map.device}, rois on {rois.device}")
    out = RoIPoolExact.apply(feature_map, rois.detach(), float(spatial_scale), int(output_size))
    return out[0] if single else out
