"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

The tests marked `cuda` skip where torch.cuda.is_available() is false.
Tolerances: NMS keep-masks are decisions and must be identical. RoI pooling
must be identical too, in f32 and in bf16: kernel and plain version round
each tap product and each two-tap sum once, and the bf16 rows before the
x-taps. The RoI backward makes the same argmax and tie decisions as its
plain version (both recompute the forward's samples bit for bit), but adds
into the map with atomics, in an order that changes from run to run, and
multiplies each share by its x- and y-weight before adding where the plain
version adds the x-taps first: in f32 each value may differ by 1e-5 of the
largest; in bf16, after the one cast at the end, also by one bf16 step
(2^-7 of the value).
"""

import numpy as np
import pytest
import torch

from fasterrcnn_torch.ops import nms as torch_nms
from fasterrcnn_torch.ops import roi as torch_roi


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def sorted_boxes(rng, n, k, spread=800.0):
    cy = rng.uniform(0, spread, (n, k))
    cx = rng.uniform(0, spread, (n, k))
    h = rng.uniform(16, 300, (n, k))
    w = rng.uniform(16, 300, (n, k))
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1).astype(np.float32)


def roi_inputs(seed, b, h, w, c, p, img_h, img_w, real_fh, real_fw):
    rng = np.random.default_rng(seed)
    fm = rng.normal(size=(b, h, w, c)).astype(np.float32)
    y1 = rng.uniform(-40, img_h, (b, p))
    x1 = rng.uniform(-40, img_w, (b, p))
    rois = np.stack([y1, x1, y1 + rng.uniform(8, img_h / 2, (b, p)), x1 + rng.uniform(8, img_w / 2, (b, p))], -1)
    norm = np.tile([[(real_fh - 1) / img_h, (real_fw - 1) / img_w]], (b, 1))
    return fm, rois.astype(np.float32), norm.astype(np.float32)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(0)
    boxes = torch.from_numpy(sorted_boxes(rng, 2, 50))
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


def taps_reference(fm, rois, norm):
    """roi_pool_taps.cu's arithmetic, one sample at a time: each tap product
    and each two-tap sum rounded once in f32, rows rounded to the map's type
    before the x-taps, a sample outside the map 0, then the 2x2 max."""
    b, h, w, c = fm.shape
    steps = torch.tensor([s / 13 for s in range(14)], dtype=torch.float32)
    f = fm.float()
    out = torch.empty((b, rois.shape[1], 7, 7, c), dtype=fm.dtype)
    for i in range(b):
        for r in range(rois.shape[1]):
            taps = []
            for axis, size in ((0, h), (1, w)):
                lo, hi = rois[i, r, axis] * norm[i, axis], rois[i, r, 2 + axis] * norm[i, axis]
                pos = lo + (hi - lo) * steps
                cell = torch.floor(pos)
                inside = (pos >= 0) & (pos <= size - 1)
                taps.append((torch.where(inside, cell, 0).long(), 1.0 - (pos - cell), pos - cell, inside))
            (y0, wy0, wy1, in_y), (x0, wx0, wx1, in_x) = taps

            def row(s, x):
                v = wy0[s] * f[i, y0[s], x]
                if y0[s] + 1 < h:
                    v = v + wy1[s] * f[i, y0[s] + 1, x]
                return v.to(fm.dtype).float()

            def sample(s, q):
                if not (in_y[s] and in_x[q]):
                    return torch.zeros(c)
                v = wx0[q] * row(s, x0[q])
                if x0[q] + 1 < w:
                    v = v + wx1[q] * row(s, x0[q] + 1)
                return v

            for py in range(7):
                for px in range(7):
                    pooled = torch.stack([sample(2 * py + a, 2 * px + e) for a in (0, 1) for e in (0, 1)]).amax(0)
                    out[i, r, py, px] = pooled.to(fm.dtype)
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
    "n,k,thr,max_keep",
    [
        (4, 6000, 0.7, 300), (80, 300, 0.3, 300), (2, 12000, 0.7, 2000), (1, 12000, 0.7, 2000),
        (3, 37, 0.5, 40), (5, 1000, 0.5, 0),
    ],
)
def test_cuda_nms_kernel_matches_plain(cuda, n, k, thr, max_keep):
    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(sorted_boxes(rng, n, k)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(n, k)) > 0.1).to(cuda)
    before = torch_nms.nms_keep_mask.launches
    got = torch_nms.nms_keep_mask(boxes, valid, thr, max_keep)
    want = torch_nms.nms_keep_mask_plain(boxes, valid, thr, max_keep)
    torch.cuda.synchronize()
    assert torch_nms.nms_keep_mask.launches == before + 1
    assert torch.equal(got, want)
    assert int(got.sum(dim=1).max()) <= max_keep


@pytest.mark.cuda
def test_cuda_nms_full_gather_matches_cpu(cuda):
    """`nms` (sort, kernel, gather) on the card equals the CPU's result."""
    rng = np.random.default_rng(5)
    boxes = torch.from_numpy(sorted_boxes(rng, 6, 300, spread=300.0))
    scores = torch.from_numpy(rng.uniform(size=(6, 300)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(6, 300)) > 0.3)
    want = torch_nms.nms(boxes, scores, valid, 0.3, 300)
    got = torch_nms.nms(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.3, 300)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape", [(4, 38, 50, 512, 300, 600.0, 800.0, 37, 50), (2, 12, 16, 200, 7, 160.0, 200.0, 10, 12)]
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
    "shape", [(4, 38, 50, 512, 128, 600.0, 800.0, 37, 50), (2, 12, 16, 200, 7, 160.0, 200.0, 10, 12)]
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
