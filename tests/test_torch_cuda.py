"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

The tests marked `cuda` skip where torch.cuda.is_available() is false.
Tolerances: NMS keep-masks are decisions and must be identical, and two
launches must give the same bits. RoI pooling
must be identical too, in f32 and in bf16: kernel and plain version round
each tap product and each two-tap sum once, and in bf16 the weights, the
rows, each x-tap product and the x-sum to bf16 (K2), or the weights, the
rows and the x-sum (K4). The RoI backward makes the same argmax and tie decisions as its
plain version (both recompute the forward's samples bit for bit), but adds
into the map with atomics, in an order that changes from run to run, and
multiplies each share by its x- and y-weight before adding where the plain
version adds the x-taps first: in f32 each value may differ by 1e-5 of the
largest; in bf16, after the one cast at the end, also by one bf16 step
(2^-7 of the value). The conv kernels (K5, K6) are held to
`profile_conv.conv_close`, which `chip_smoke.py` uses too.
"""

import re

import numpy as np
import pytest
import torch

from fasterrcnn_torch.ops import conv as torch_conv
from fasterrcnn_torch.ops import nms as torch_nms
from fasterrcnn_torch.ops import roi as torch_roi
from fasterrcnn_torch.ops.kernels import _build
from fasterrcnn_torch.scripts import profile_conv, profile_nms, reference_train


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def roi_inputs(seed, b, h, w, c, p, img_h, img_w, real_fh, real_fw):
    rng = np.random.default_rng(seed)
    fm = rng.normal(size=(b, h, w, c)).astype(np.float32)
    y1 = rng.uniform(-40, img_h, (b, p))
    x1 = rng.uniform(-40, img_w, (b, p))
    rois = np.stack([y1, x1, y1 + rng.uniform(8, img_h / 2, (b, p)), x1 + rng.uniform(8, img_w / 2, (b, p))], -1)
    norm = np.tile([[(real_fh - 1) / img_h, (real_fw - 1) / img_w]], (b, 1))
    return fm, rois.astype(np.float32), norm.astype(np.float32)


def edge_roi_inputs(seed, b, h, w, c, p):
    """roi_inputs on an (h, w) map whose real grid is the whole map, RoIs of
    16x the map's size, with the first six RoIs of image 0 (p >= 6) made
    inverted, zero-area, fully outside, partly outside, spanning the whole
    grid (samples at pos == size-1) and reaching past its far edge."""
    img_h, img_w = 16.0 * h, 16.0 * w
    fm, rois, norm = roi_inputs(seed, b, h, w, c, p, img_h, img_w, h, w)
    rois[0, :6] = [
        [img_h * 0.3, img_w * 0.6, img_h * 0.1, img_w * 0.2],
        [img_h * 0.4, img_w * 0.4, img_h * 0.4, img_w * 0.4],
        [-500.0, -500.0, -300.0, -300.0],
        [-50.0, -50.0, img_h * 0.5, img_w * 0.5],
        [0.0, 0.0, img_h, img_w],
        [img_h * 0.9, img_w * 0.9, img_h * 2.0, img_w * 2.0],
    ]
    norm[:] = [(h - 1) / img_h if h > 1 else 0.0, (w - 1) / img_w if w > 1 else 0.0]
    return torch.from_numpy(fm), torch.from_numpy(rois), torch.from_numpy(norm)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(0)
    boxes = torch.from_numpy(profile_nms.sorted_boxes(rng, 2, 50))
    valid = torch.ones((2, 50), dtype=torch.bool)
    fm, rois, norm = map(torch.from_numpy, roi_inputs(0, 1, 6, 8, 16, 5, 96.0, 128.0, 6, 8))
    nms_before, roi_before = torch_nms.nms_keep_mask.launches, torch_roi.roi_pool_taps.launches
    assert torch.equal(
        torch_nms.nms_keep_mask(boxes, valid, 0.5, 10), torch_nms.nms_keep_mask_plain(boxes, valid, 0.5, 10)
    )
    assert torch.equal(torch_roi.roi_pool_taps(fm, rois, norm), torch_roi.roi_pool_features(fm, rois, norm))
    assert torch_nms.nms_keep_mask.launches == nms_before
    assert torch_roi.roi_pool_taps.launches == roi_before


def test_cpu_backward_takes_the_plain_version_and_counts_no_launch():
    fm, rois, norm = map(torch.from_numpy, roi_inputs(2, 2, 6, 8, 16, 5, 96.0, 128.0, 6, 8))
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 5, 7, 7, 16)).astype(np.float32))
    before = torch_roi.roi_pool_taps_bwd.launches
    f = fm.clone().requires_grad_()
    out = torch_roi.roi_pool_taps(f, rois, norm)
    assert out.grad_fn is not None
    out.backward(g)
    assert torch.equal(f.grad, torch_roi.roi_pool_taps_bwd_plain(fm, rois, norm, g))
    assert torch_roi.roi_pool_taps_bwd.launches == before


def test_cpu_fused_roi_takes_the_plain_version_and_counts_no_launch():
    fm, rois, norm = map(torch.from_numpy, roi_inputs(7, 2, 6, 8, 40, 5, 96.0, 128.0, 6, 8))
    before = torch_roi.roi_pool_fused.launches
    assert torch.equal(torch_roi.roi_pool_fused(fm, rois, norm), torch_roi.roi_pool_fused_plain(fm, rois, norm))
    assert torch_roi.roi_pool_fused.launches == before


def taps_reference(fm, rois, norm):
    """roi_pool_taps.cu's arithmetic, one sample at a time, with r() rounding
    to the map's type (the identity in f32): tap weights r(1 - frac) and
    r(frac); each row the f32 sum of its two y-taps, rounded with r; each
    sample r(r(w_lo * row_lo) + r(w_hi * row_hi)); a sample outside the map
    0; then the 2x2 max."""
    b, h, w, c = fm.shape
    steps = torch.tensor([s / 13 for s in range(14)], dtype=torch.float32)
    f = fm.float()

    def r(v):
        return v.to(fm.dtype).float()

    out = torch.empty((b, rois.shape[1], 7, 7, c), dtype=fm.dtype)
    for i in range(b):
        for n in range(rois.shape[1]):
            taps = []
            for axis, size in ((0, h), (1, w)):
                lo, hi = rois[i, n, axis] * norm[i, axis], rois[i, n, 2 + axis] * norm[i, axis]
                pos = lo + (hi - lo) * steps
                cell = torch.floor(pos)
                inside = (pos >= 0) & (pos <= size - 1)
                taps.append((torch.where(inside, cell, 0).long(), r(1.0 - (pos - cell)), r(pos - cell), inside))
            (y0, wy0, wy1, in_y), (x0, wx0, wx1, in_x) = taps

            def row(s, x):
                v = wy0[s] * f[i, y0[s], x]
                if y0[s] + 1 < h:
                    v = v + wy1[s] * f[i, y0[s] + 1, x]
                return r(v)

            def sample(s, q):
                if not (in_y[s] and in_x[q]):
                    return torch.zeros(c)
                v = r(wx0[q] * row(s, x0[q]))
                if x0[q] + 1 < w:
                    v = r(v + r(wx1[q] * row(s, x0[q] + 1)))
                return v

            for py in range(7):
                for px in range(7):
                    pooled = torch.stack([sample(2 * py + a, 2 * px + e) for a in (0, 1) for e in (0, 1)]).amax(0)
                    out[i, n, py, px] = pooled.to(fm.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_roi_rounds_as_the_kernel(dtype):
    """The plain version equals the kernel's arithmetic bit for bit, which is
    what lets the card tests below demand identical outputs."""
    fm, rois, norm = map(torch.from_numpy, roi_inputs(3, 2, 9, 12, 24, 6, 128.0, 176.0, 8, 11))
    fm = fm.to(dtype)
    assert torch.equal(torch_roi.roi_pool_features(fm, rois, norm), taps_reference(fm, rois, norm))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,k,thr,max_keep,layout",
    [
        (4, 6000, 0.7, 300, "spread"), (80, 300, 0.3, 300, "spread"), (2, 12000, 0.7, 2000, "spread"),
        (1, 12000, 0.7, 2000, "spread"), (3, 37, 0.5, 40, "spread"), (5, 1000, 0.5, 0, "spread"),
        # Boxes piled onto a few objects: accepts stall below max_keep and
        # the scan walks every word.
        (4, 12000, 0.7, 2000, "clustered"), (4, 6000, 0.7, 300, "clustered"), (3, 1000, 0.5, 1000, "clustered"),
        # Ragged K (one word, one short of a word, one past it), and K past
        # the shared-memory limit of the kernel before the mask pass.
        (3, 1, 0.5, 5, "spread"), (3, 63, 0.5, 63, "clustered"), (3, 65, 0.5, 65, "clustered"),
        (1, 13000, 0.7, 13000, "spread"), (2, 20000, 0.7, 2000, "clustered"),
    ],
)
def test_cuda_nms_kernel_matches_plain(cuda, n, k, thr, max_keep, layout):
    rng = np.random.default_rng(k)
    make = profile_nms.sorted_boxes if layout == "spread" else profile_nms.clustered_boxes
    boxes = torch.from_numpy(make(rng, n, k)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(n, k)) > 0.1).to(cuda)
    before = torch_nms.nms_keep_mask.launches
    got = torch_nms.nms_keep_mask(boxes, valid, thr, max_keep)
    want = torch_nms.nms_keep_mask_plain(boxes, valid, thr, max_keep)
    torch.cuda.synchronize()
    assert torch_nms.nms_keep_mask.launches == before + 1
    assert torch.equal(got, want)
    assert int(got.sum(dim=1).max()) <= max_keep
    # No atomics decide a bit: a second launch must give the same mask.
    assert torch.equal(torch_nms.nms_keep_mask(boxes, valid, thr, max_keep), got)


@pytest.mark.cuda
def test_cuda_nms_reports_a_mask_scratch_that_does_not_fit(cuda):
    """900,000 boxes are inside the scan's shared-memory limit, but their
    suppression mask (101 GB) exceeds the card's memory."""
    k = 900_000
    assert k <= torch_nms.MAX_KERNEL_K
    boxes = torch.zeros((1, k, 4), device=cuda)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="suppression mask"):
        torch_nms.nms_keep_mask(boxes, torch.ones((1, k), dtype=torch.bool, device=cuda), 0.5, 10)


@pytest.mark.cuda
def test_cuda_nms_full_gather_matches_cpu(cuda):
    """`nms` (sort, kernel, gather) on the card equals the CPU's result."""
    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(profile_nms.sorted_boxes(rng, 6, 300, 300.0, 300.0))
    scores = torch.from_numpy(rng.uniform(size=(6, 300)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(6, 300)) > 0.3)
    want = torch_nms.nms(boxes, scores, valid, 0.3, 300)
    got = torch_nms.nms(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.3, 300)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (4, 38, 50, 512, 300, 600.0, 800.0, 37, 50), (2, 12, 16, 200, 7, 160.0, 200.0, 10, 12),
        # ResNet's C=1024, and C that fills no whole 16-byte lane (scalar lanes).
        (4, 38, 50, 1024, 300, 600.0, 800.0, 37, 50), (2, 12, 16, 36, 7, 160.0, 200.0, 10, 12),
        (2, 12, 16, 1030, 7, 160.0, 200.0, 10, 12),
    ],
)
def test_cuda_roi_kernel_matches_plain(cuda, dtype, shape):
    b, h, w, c, p, img_h, img_w, fh, fw = shape
    fm, rois, norm = roi_inputs(1, b, h, w, c, p, img_h, img_w, fh, fw)
    fm = torch.from_numpy(fm).to(cuda, dtype)
    rois, norm = torch.from_numpy(rois).to(cuda), torch.from_numpy(norm).to(cuda)
    got = torch_roi.roi_pool_taps(fm, rois, norm)
    want = torch_roi.roi_pool_features(fm, rois, norm)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, p, 7, 7, c)
    assert torch.equal(got, want)


def assert_backward_close(got, want):
    """The tolerance of the module docstring."""
    assert got.dtype == want.dtype and got.shape == want.shape
    rtol = 2.0**-7 if want.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = 1e-5 * want.abs().max() + rtol * want.abs()
    assert bool((err <= bound).all()), f"max abs err {float(err.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize(
    "shape",
    [
        (4, 38, 50, 512, 128, 600.0, 800.0, 37, 50), (2, 12, 16, 200, 7, 160.0, 200.0, 10, 12),
        (4, 38, 50, 1024, 128, 600.0, 800.0, 37, 50), (2, 12, 16, 36, 7, 160.0, 200.0, 10, 12),
        (2, 12, 16, 1030, 7, 160.0, 200.0, 10, 12),
    ],
)
def test_cuda_roi_backward_kernel_matches_plain(cuda, dtype, relu, shape):
    """On a ReLU'd map zero windows tie four ways and neighbouring samples
    tie exactly; both sides must split the cotangent alike."""
    b, h, w, c, p, img_h, img_w, fh, fw = shape
    fm, rois, norm = roi_inputs(4, b, h, w, c, p, img_h, img_w, fh, fw)
    if relu:
        fm = np.maximum(fm, 0.0)
    g = np.random.default_rng(5).normal(size=(b, p, 7, 7, c)).astype(np.float32)
    fm, g = torch.from_numpy(fm).to(cuda, dtype), torch.from_numpy(g).to(cuda, dtype)
    rois, norm = torch.from_numpy(rois).to(cuda), torch.from_numpy(norm).to(cuda)
    before = torch_roi.roi_pool_taps_bwd.launches
    got = torch_roi.roi_pool_taps_bwd(fm, rois, norm, g)
    want = torch_roi.roi_pool_taps_bwd_plain(fm, rois, norm, g)
    torch.cuda.synchronize()
    assert torch_roi.roi_pool_taps_bwd.launches == before + 1
    assert_backward_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "hwc", [(6, 8, 1), (6, 8, 3), (6, 8, 8), (6, 8, 36), (6, 8, 512), (6, 8, 1030), (1, 1, 16), (1, 5, 16),
            (5, 1, 16), (2, 2, 16), (2, 7, 16)],
)
def test_cuda_roi_kernels_match_plain_on_edge_rois(cuda, dtype, hwc):
    """Inverted, zero-area, fully- and partly-outside RoIs, RoIs at
    pos == size-1 and past the far edge (`edge_roi_inputs`), on maps down to
    one cell: K2 identical, K3 within the tolerance, on a ReLU'd map."""
    h, w, c = hwc
    fm, rois, norm = edge_roi_inputs(c + h, 2, h, w, c, 7)
    fm = torch.relu(fm).to(cuda, dtype)
    rois, norm = rois.to(cuda), norm.to(cuda)
    g = torch.from_numpy(np.random.default_rng(c).normal(size=(2, 7, 7, 7, c)).astype(np.float32)).to(cuda, dtype)
    got = torch_roi.roi_pool_taps(fm, rois, norm)
    back = torch_roi.roi_pool_taps_bwd(fm, rois, norm, g)
    torch.cuda.synchronize()
    assert torch.equal(got, torch_roi.roi_pool_features(fm, rois, norm))
    assert_backward_close(back, torch_roi.roi_pool_taps_bwd_plain(fm, rois, norm, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_roi_kernels_on_a_map_that_is_not_16_byte_aligned(cuda, dtype):
    """A map that starts one element past an aligned address runs the same
    kernels on scalar lanes, with the same values."""
    b, h, w, c, p = 2, 12, 16, 512, 9
    fm, rois, norm = roi_inputs(9, b, h, w, c, p, 160.0, 200.0, 10, 12)
    flat = torch.empty(b * h * w * c + 1, device=cuda, dtype=dtype)
    shifted = flat[1:].view(b, h, w, c)
    shifted.copy_(torch.from_numpy(fm))
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert torch_roi.lane_width(c, shifted) == 1
    rois, norm = torch.from_numpy(rois).to(cuda), torch.from_numpy(norm).to(cuda)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(b, p, 7, 7, c)).astype(np.float32)).to(cuda, dtype)
    got = torch_roi.roi_pool_taps(shifted, rois, norm)
    back = torch_roi.roi_pool_taps_bwd(shifted, rois, norm, g)
    torch.cuda.synchronize()
    assert torch.equal(got, torch_roi.roi_pool_features(shifted, rois, norm))
    assert_backward_close(back, torch_roi.roi_pool_taps_bwd_plain(shifted, rois, norm, g))


@pytest.mark.cuda
def test_cuda_roi_libraries_use_vector_loads_and_reductions(cuda):
    """K2's library holds 128-bit global loads; K3's holds vector f32
    reductions into the map's cotangent."""
    loads = sum(n for op, n in _build.sass_opcodes("roi_pool_taps").items() if op.startswith("LDG") and ".128" in op)
    reds = sum(n for op, n in _build.sass_opcodes("roi_pool_taps_bwd").items() if is_vector_reduction(op))
    assert loads > 0 and reds > 0, (loads, reds)


def is_vector_reduction(opcode: str) -> bool:
    """A SASS global reduction or atomic on two or four f32 (`F32x2`, `F32x4`)."""
    return opcode.startswith(("RED", "ATOM")) and re.search(r"\.F32x[24]\b", opcode) is not None


def test_reference_train_batch_comes_from_its_own_seed():
    """The card-vs-CPU train check draws its batch from a generator of its
    own seed, so what other checks drew before it cannot move it."""
    np.random.default_rng(123).normal(size=1000)  # another phase's draws
    a = reference_train.host_batch(16)
    b = reference_train.host_batch(16)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.images, reference_train.host_batch(17).images)
    assert int(a.images[:, 64:].abs().sum()) == 0 and int(a.images[:, :, 80:].abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_train_gradient_gap_is_born_in_the_backbone(cuda):
    """The card-vs-CPU gradient gap of one train step, on the draw of the 24
    where it is largest (seed 16, 7.8e-3 in block3_conv1.weight on an H100),
    is the backbone's: run backward from the CPU's feature-map cotangent,
    the card's backbone alone gives it, while the RoI stage and the heads
    on the card (K2, K3, the losses) stay within 3e-4 and K3 within 1e-5 of
    the plain backward on the same inputs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    row = reference_train.run_draw(cuda, 16, diagnose=True)
    assert row["loss_rel_max"] < 1e-4
    assert row["k3_vs_plain"] < 1e-5
    assert row["head_side"] < 3e-4 and row["roi_cotangent"] < 1e-3
    assert row["backbone_side"] >= 0.9 * row["worst"]


@pytest.mark.cuda
def test_cuda_roi_pool_taps_carries_a_gradient_through_the_kernels(cuda):
    fm, rois, norm = roi_inputs(6, 2, 12, 16, 256, 9, 160.0, 200.0, 10, 12)
    fm = torch.from_numpy(fm).to(cuda).requires_grad_()
    rois, norm = torch.from_numpy(rois).to(cuda), torch.from_numpy(norm).to(cuda)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 9, 7, 7, 256)).astype(np.float32)).to(cuda)
    fwd, bwd = torch_roi.roi_pool_taps.launches, torch_roi.roi_pool_taps_bwd.launches
    out = torch_roi.roi_pool_taps(fm, rois, norm)
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert torch_roi.roi_pool_taps.launches == fwd + 1
    assert torch_roi.roi_pool_taps_bwd.launches == bwd + 1
    assert_backward_close(fm.grad, torch_roi.roi_pool_taps_bwd_plain(fm.detach(), rois, norm, g))


@pytest.mark.cuda
def test_cuda_wrappers_reject_mixed_devices(cuda):
    boxes = torch.zeros((1, 10, 4), device=cuda)
    with pytest.raises(ValueError):
        torch_nms.nms_keep_mask(boxes, torch.ones((1, 10), dtype=torch.bool), 0.5, 5)
    fm = torch.zeros((1, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        torch_roi.roi_pool_taps(fm, torch.zeros((1, 2, 4)), torch.ones((1, 2), device=cuda))
    rois, norm = torch.zeros((1, 2, 4), device=cuda), torch.ones((1, 2), device=cuda)
    with pytest.raises(ValueError):
        torch_roi.roi_pool_taps_bwd(fm, rois, norm, torch.zeros((1, 2, 7, 7, 8)))
    with pytest.raises(ValueError):
        torch_roi.roi_pool_taps_bwd(fm, rois, norm, torch.zeros((1, 2, 7, 7, 8), device=cuda).bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,misaligned",
    [
        ((4, 38, 50, 512, 300, 600.0, 800.0, 37, 50), False), ((2, 12, 16, 200, 7, 160.0, 200.0, 10, 12), False),
        # Where the lanes change: C=1024 (vector lanes), C=1030 (scalar), a
        # map one element past a 16-byte boundary; and a map 160 cells wide.
        ((4, 38, 50, 1024, 300, 600.0, 800.0, 37, 50), False), ((4, 38, 50, 1030, 300, 600.0, 800.0, 37, 50), False),
        ((4, 38, 50, 512, 300, 600.0, 800.0, 37, 50), True), ((1, 38, 160, 512, 300, 600.0, 2560.0, 37, 160), False),
    ],
)
def test_cuda_fused_roi_kernel_matches_plain(cuda, dtype, shape, misaligned):
    b, h, w, c, p, img_h, img_w, fh, fw = shape
    fm, rois, norm = roi_inputs(8, b, h, w, c, p, img_h, img_w, fh, fw)
    fm = torch.from_numpy(fm).to(cuda, dtype)
    if misaligned:
        fm = torch.empty(fm.numel() + 1, dtype=dtype, device=cuda)[1:].view(fm.shape).copy_(fm)
        assert torch_roi.lane_width(c, fm) == 1
    rois, norm = torch.from_numpy(rois).to(cuda), torch.from_numpy(norm).to(cuda)
    before = torch_roi.roi_pool_fused.launches
    got = torch_roi.roi_pool_fused(fm, rois, norm)
    want = torch_roi.roi_pool_fused_plain(fm, rois, norm)
    torch.cuda.synchronize()
    assert torch_roi.roi_pool_fused.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, p, 7, 7, c)
    assert torch.equal(got, want)
    if dtype == torch.float32:
        assert torch.equal(got, torch_roi.roi_pool_taps(fm, rois, norm))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    "kernel,shape",
    [
        ("conv3x3", (4, 38, 50, 512, 512)), ("conv3x3", (4, 76, 100, 512, 512)),
        ("conv3x3", (4, 152, 200, 256, 256)), ("conv3x3", (2, 9, 20, 24, 70)),
        ("conv3x3_im2col", (2, 76, 100, 128, 128)), ("conv3x3_im2col", (2, 76, 100, 64, 128)),
        ("conv3x3_im2col", (2, 9, 20, 24, 70)),
        # Ragged and edge shapes: C = 3 and 40 (padded to 8-channel groups),
        # Cout = 200 (a part tile), W = 400 (a padded row of 402 positions,
        # wider than a 256-row tile), B = 1.
        ("conv3x3", (1, 7, 11, 3, 64)), ("conv3x3", (1, 5, 400, 40, 200)),
        ("conv3x3_im2col", (1, 7, 11, 3, 64)), ("conv3x3_im2col", (1, 5, 400, 40, 200)),
    ],
)
def test_cuda_conv_kernels_match_plain(cuda, dtype, relu, kernel, shape):
    b, h, w, c, cout = shape
    rng = np.random.default_rng(c + cout)
    x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(cuda, dtype)
    wt = torch.from_numpy((0.05 * rng.normal(size=(cout, c, 3, 3))).astype(np.float32)).to(cuda, dtype)
    bias = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(cuda, dtype)
    fn = getattr(torch_conv, kernel)
    before = fn.launches
    torch.backends.cudnn.allow_tf32 = False
    got = fn(x, wt, bias, relu=relu)
    want = torch_conv.conv3x3_plain(x, wt, bias, relu=relu)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    ok, err, _, _ = profile_conv.conv_close(got, want)
    assert ok, f"max abs err {err}"
    # No atomics: a second launch must give the same bits (a stage of the
    # ring, or an f32 kernel's TF32 A fragment registers, overwritten while
    # a wgmma reads it would not).
    assert torch.equal(fn(x, wt, bias, relu=relu), got)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["BF16", "TF32"])
@pytest.mark.parametrize("kernel", ["conv3x3", "conv3x3_im2col"])
def test_cuda_conv_libraries_run_bf16_on_the_tensor_cores(cuda, kernel, operand):
    """The built library holds warpgroup MMA instructions (HGMMA in SASS) of
    each input type: BF16 for the bf16 path, TF32 for the f32 path's
    3xTF32 products."""
    opcodes = _build.sass_opcodes(kernel)
    assert sum(n for op, n in opcodes.items() if op.startswith("HGMMA.") and operand in op.split(".")) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["conv3x3", "conv3x3_im2col"])
def test_cuda_conv_wrappers_carry_the_plain_gradient(cuda, kernel):
    rng = np.random.default_rng(3)
    x, wt, bias = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
                   for s in ((2, 12, 16, 64), (96, 64, 3, 3), (96,)))
    g = torch.from_numpy(rng.normal(size=(2, 12, 16, 96)).astype(np.float32)).to(cuda)
    torch.backends.cudnn.allow_tf32 = False
    grads = []
    for fn in (getattr(torch_conv, kernel), torch_conv.conv3x3_plain):
        leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
        out = fn(*leaves)
        assert out.grad_fn is not None
        out.backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# How far the card's detections may lie from a CPU engine's on the same
# weights and images, in score and in box corner (pixels). The two agree
# stage by stage to ~1e-4 (chip_smoke.py phase 4). The mAPs must then be
# equal: on the H100 the gap was 0.0 at both thresholds.
DETECTION_ATOL = 1e-4


def paired_gaps(on_card, on_host):
    """Largest score and box gaps between one image's detections of one
    class on the card and on the CPU, each card detection paired with the
    CPU detection nearest in box corners, and the pairing required to be
    one to one. Detections whose scores differ in the last bits may leave
    NMS in either order; within a class NMS leaves no two boxes that near."""
    n = len(on_host)
    dist = np.abs(on_card[:, None, :4] - on_host[None, :, :4]).max(-1)
    nearest = dist.argmin(1)
    assert sorted(nearest.tolist()) == list(range(n)), "the card's detections do not pair one to one"
    return float(np.abs(on_card[:, 4] - on_host[nearest, 4]).max()), float(dist[np.arange(n), nearest].max())


@pytest.mark.cuda
def test_cuda_evaluate_matches_a_cpu_engine(cuda, tmp_path, monkeypatch):
    """Engine.evaluate on the card and on the CPU, tiny config, the same
    weights, over a 12-image VOC split (batch 4, two canvases, residue
    batches): the same images reach the calculator, each with the same
    number of detections of each class, paired one to one with the CPU's
    within DETECTION_ATOL in score and box, and the mAPs are equal. Prints
    the gaps."""
    from fasterrcnn_torch import config, engine as torch_engine
    from fasterrcnn_torch.data import synthetic_voc, voc
    from fasterrcnn_torch.utils import stats

    cfg = config.ModelConfig(
        anchors=config.AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=config.RPNConfig(pre_nms_train=400, post_nms_train=128, pre_nms_infer=200, post_nms_infer=64,
                             minibatch_size=64),
        detector=config.DetectorConfig(proposal_batch_size=32),
        max_gt_boxes=8,
    )
    root = synthetic_voc.generate_voc_dataset(str(tmp_path / "VOC2007"), {"test": 12}, seed=2)
    seen = []

    class Recording(stats.PrecisionRecallCurveCalculator):
        def add_image_results(self, scored, gt_boxes):
            gt = tuple(tuple(float(v) for v in b.corners) for b in gt_boxes)
            seen.append((gt, {c: np.array(rows) for c, rows in scored.items()}))
            super().add_image_results(scored, gt_boxes)

    monkeypatch.setattr(torch_engine, "PrecisionRecallCurveCalculator", Recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    card = torch_engine.Engine(cfg, seed=0, device=cuda)
    host = torch_engine.Engine(cfg, seed=1, device="cpu")
    host.set_params(card.model.state_dict())
    for threshold in (0.0, 0.05):
        maps = []
        for engine in (card, host):
            seen.clear()
            split = voc.Dataset("test", dir=root, augment=False, shuffle=False, cache=False,
                                min_dimension_pixels=120, max_dimension_pixels=160)
            maps.append((engine.evaluate(split, batch_size=4, score_threshold=threshold, progress=False), list(seen)))
        (got, seen_card), (want, seen_host) = maps
        assert len(seen_card) == 12 and [g for g, _ in seen_card] == [g for g, _ in seen_host]
        score_err = box_err = 0.0
        detections = 0
        for (_, on_card), (_, on_host) in zip(seen_card, seen_host):
            assert on_card.keys() == on_host.keys()
            for c in on_host:
                assert on_card[c].shape == on_host[c].shape, f"class {c}: {on_card[c].shape} {on_host[c].shape}"
                if len(on_host[c]):
                    detections += len(on_host[c])
                    score_gap, box_gap = paired_gaps(on_card[c], on_host[c])
                    score_err, box_err = max(score_err, score_gap), max(box_err, box_gap)
        print(f"evaluate at score threshold {threshold}: {detections} detections on each side; max score gap "
              f"{score_err!r}, max box gap {box_err!r} px; mAP card {got!r}, CPU {want!r}, gap {abs(got - want)!r} "
              f"mAP points over {len(seen_host)} images")
        assert detections > 0 and want > 0.0
        assert score_err <= DETECTION_ATOL and box_err <= DETECTION_ATOL
        assert got == want


# ---------------------------------------------------------------------------
# The captured train loop (models/faster_rcnn.CapturedStep, Engine.train_epoch)
# ---------------------------------------------------------------------------


def flat_samples(n, hw=(120, 150)):
    """n samples of one extent whose every pixel is the sample's index."""
    from fasterrcnn_torch.data.voc import Sample

    return [Sample(image_u8=np.full((*hw, 3), i % 256, np.uint8), image_hw=hw, gt_boxes=[], filepath=str(i))
            for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("scan_steps", ["1", "4"])
def test_cuda_uploads_from_the_prefetch_thread_arrive_before_the_step(cuda, monkeypatch, scan_steps):
    """A fast prefetcher and a slow consumer over 64 batches: every step
    reads back its own batch (the image's pixels encode the step index that
    aux carries), so no upload is read before it lands or after its memory
    went to a later upload."""
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models.faster_rcnn import Losses

    monkeypatch.setenv("FRCNN_SCAN_STEPS", scan_steps)
    monkeypatch.setenv("FRCNN_LOSS_FLUSH_STEPS", "8")
    engine = Engine(reference_train.every_box_config(), seed=0)
    bad = torch.zeros((), device=cuda)
    steps = torch.zeros((), device=cuda)

    def read(images, aux):
        torch.cuda._sleep(2_000_000)  # the card is slow to reach the read
        want = aux[..., 0, -1] % 256
        got = images[..., 0, 0, 0, 0].float()
        bad.add_((got != want).sum())
        steps.add_(got.numel())

    def packed(images, aux):
        read(images, aux)
        return Losses(*torch.zeros(4, device=cuda)), torch.zeros(4, device=cuda)

    def scan(images, aux):
        read(images, aux)
        return torch.zeros(images.shape[0], 4, device=cuda)

    monkeypatch.setattr(engine, "packed_step_for", lambda canvas: packed)
    monkeypatch.setattr(engine, "scan_step_for", lambda canvas, k: scan)
    engine.train_epoch(flat_samples(64), batch_size=1)
    torch.cuda.synchronize()
    assert int(steps) == 64 and int(bad) == 0 and engine._global_step == 64


@pytest.mark.cuda
def test_cuda_captured_epoch_matches_eager_steps(cuda):
    """`reference_train.graph_against_eager`, as `chip_smoke.py` phase 6e
    runs it: step 0's losses identical; each teacher-forced program's later
    losses and parameters, in the closest of its replays, within twice the
    largest gap between eager replicas (K3's float reductions and cuDNN's
    backward are not deterministic); the learning rates and the generator's offsets of the
    eager run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = reference_train.graph_against_eager()
    assert out["failures"] == []


@pytest.mark.cuda
def test_cuda_one_capture_per_canvas_and_k(cuda, monkeypatch):
    """Two canvases, K=2, two epochs: one packed and one 2-step graph a
    canvas, captured in the first epoch and only replayed in the second;
    K1-K3 counted at capture and added once per replay."""
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models import faster_rcnn as frcnn

    monkeypatch.setenv("FRCNN_SCAN_STEPS", "2")
    engine = Engine(reference_train.every_box_config(), seed=0)
    samples = flat_samples(6) + flat_samples(6, hw=(150, 120))
    for s in samples:
        s.image_u8 = np.random.default_rng(int(s.filepath)).integers(0, 255, s.image_u8.shape, dtype=np.uint8)
    engine.train_epoch(samples, batch_size=2)
    steps = {**engine._packed_steps, **engine._scan_steps}
    assert sorted(engine._packed_steps) == [(128, 160), (160, 128)]
    assert sorted(engine._scan_steps) == [((128, 160), 2), ((160, 128), 2)]
    graphs = {key: [id(g.graph) for g in s.captured_step.graphs.values()] for key, s in steps.items()}
    assert all(len(g) == 1 for g in graphs.values())
    for fn in frcnn.LAUNCH_COUNTERS:
        fn.launches = 0
    engine.train_epoch(samples, batch_size=2)
    torch.cuda.synchronize()
    assert {key: [id(g.graph) for g in s.captured_step.graphs.values()] for key, s in steps.items()} == graphs
    assert all(s.captured_step.replays == 2 for s in steps.values())
    for fn in frcnn.LAUNCH_COUNTERS:
        want = sum(s.captured_step.launches[fn.__name__] for s in steps.values())
        assert want > 0 and fn.launches == want, fn.__name__
    # Another batch size is another set of shapes: one more graph (each
    # canvas's 6 samples at 3 are one 2-step block, no residue).
    engine.train_epoch(samples, batch_size=3)
    assert all(len(s.captured_step.graphs) == 2 for s in engine._scan_steps.values())
    assert all(len(s.captured_step.graphs) == 1 for s in engine._packed_steps.values())


@pytest.mark.cuda
def test_cuda_a_capture_that_fails_raises(cuda):
    """A body that reads a value on the host cannot be captured: the step
    raises, it does not run eagerly instead."""
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models.faster_rcnn import CapturedStep

    engine = Engine(reference_train.every_box_config(), seed=0)
    step = CapturedStep(lambda x: x * float(x.sum()), engine.model, engine.optimizer)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        step(torch.ones(4, device=cuda))
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=cuda).sum()) == 2.0


@pytest.mark.cuda
def test_cuda_training_after_set_params_captures_anew(cuda, monkeypatch):
    """set_params drops the step programs; the next epoch captures its own
    in a pool of its own (capturing into the pool of graphs that are gone
    trips PyTorch's allocator)."""
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine

    monkeypatch.setenv("FRCNN_SCAN_STEPS", "2")
    engine = Engine(reference_train.every_box_config(), seed=0)
    data = SyntheticDataset(num_samples=6, height=120, width=150, seed=3)
    state = {k: v.clone() for k, v in engine.model.state_dict().items()}
    engine.train_epoch(data, batch_size=2)
    pool = engine._graph_pool
    engine.set_params(state)
    assert engine._graph_pool != pool and not engine._scan_steps
    stats = engine.train_epoch(data, batch_size=2)
    assert stats._count == 3 and np.isfinite(list(stats.means().values())).all()


@pytest.mark.cuda
def test_cuda_the_data_parallel_step_on_one_rank_is_the_packed_step(cuda, monkeypatch):
    """`DataParallelStep`'s gradient and update programs, run without the
    all-reduce on one rank's whole batch, against the packed program from
    the same state, TF32 off: the same forward on the same draws, so the
    losses within 1e-6 relative (each capture picks its cuDNN algorithms
    anew; dp=2 against one rank, teacher-forced, measured 6.4e-8 in
    `chip_smoke.py` phase 6d), and each trained tensor's update within
    1e-4 in relative norm (K3's atomics and cuDNN's backward are not
    deterministic; phase 6d measured 1.3e-5)."""
    from fasterrcnn_torch.data.pipeline import batched
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models.faster_rcnn import DataParallelStep, pack_aux, snapshot_train_state
    from fasterrcnn_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    engine = Engine(reference_train.every_box_config(), seed=0)
    (hb,) = batched(iter(SyntheticDataset(num_samples=2, height=120, width=150, seed=3)), 2, 8)
    images = torch.as_tensor(hb.images, device="cuda")
    aux = torch.as_tensor(pack_aux(hb, 0), device="cuda")
    restore = snapshot_train_state(engine.model, engine.optimizer, (engine.generator,))
    before = [p.detach().clone() for p in engine.model.parameters()]
    outcomes = []
    for split in (False, True):
        restore()
        if split:
            parts = DataParallelStep(engine.model, engine.optimizer, 128, 160, mesh_lib.make_mesh(1, devices=["cuda"]),
                                     generator=engine.generator)
            parts.grad(images, aux, torch.tensor(hb.denominator, device="cuda"))
            losses = parts.update()
        else:
            losses = engine.packed_step_for((128, 160))(images, aux)[1]
        outcomes.append((losses.cpu(), [p.detach() - b for p, b in zip(engine.model.parameters(), before)]))
    (want_losses, want), (got_losses, got) = outcomes
    torch.testing.assert_close(got_losses, want_losses, rtol=1e-6, atol=0)
    for g, w, p in zip(got, want, engine.model.parameters()):
        if p.requires_grad:
            assert float((g - w).norm() / w.norm()) <= 1e-4
