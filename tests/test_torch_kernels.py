"""The port's kernel functions against the JAX package's Pallas kernels.

On the CPU the wrappers (`nms_keep_mask`, `roi_pool_taps`, `roi_pool_fused`)
run their plain PyTorch versions; these are held against the Pallas kernels
in interpret mode, as the JAX package's own tests run them, and against the
NumPy NMS oracle. `tests/test_torch_cuda.py` holds each CUDA kernel against
its plain version on the card; `tests/test_torch_conv.py` holds the conv
kernels' wrappers.

Tolerances: NMS keep-masks are decisions and must be identical. RoI pooling
in f32 is a 4-tap bilinear sum, so the two formulations differ only in
summation order (and the JAX CPU matmul's FMA use): atol 1e-5 on
unit-variance maps. In bf16 every product is exact in f32 and each side
rounds at the TPU kernel's points, so the outputs must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterrcnn_tpu.ops import nms as jax_nms
from fasterrcnn_tpu.ops.pallas.nms_pallas import nms_keep_mask_pallas
from fasterrcnn_tpu.ops.pallas.roi_pallas import roi_pool_fused_pallas, roi_pool_taps_pallas
from fasterrcnn_torch.ops import nms as torch_nms
from fasterrcnn_torch.ops import roi as torch_roi
from tests.test_torch_cuda import taps_reference


def sorted_random_boxes(rng, k, spread=300.0):
    cy = rng.uniform(0, spread, k)
    cx = rng.uniform(0, spread, k)
    h = rng.uniform(10, 90, k)
    w = rng.uniform(10, 90, k)
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], 1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1.0, k).astype(np.float32))[::-1].copy()
    return boxes, scores


def random_rois(rng, n, img_h, img_w):
    y1 = rng.uniform(0, img_h * 0.8, n)
    x1 = rng.uniform(0, img_w * 0.8, n)
    y2 = y1 + rng.uniform(16, img_h * 0.4, n)
    x2 = x1 + rng.uniform(16, img_w * 0.4, n)
    return np.stack([y1, x1, np.minimum(y2, img_h), np.minimum(x2, img_w)], 1).astype(np.float32)


# --- NMS ---------------------------------------------------------------------


@pytest.mark.parametrize("k", [128, 384, 1024])
@pytest.mark.parametrize("thr,max_keep", [(0.5, None), (0.7, 40)])
def test_plain_nms_matches_pallas_kernel(k, thr, max_keep):
    rng = np.random.default_rng(k)
    n = 3
    max_keep = k if max_keep is None else max_keep
    boxes = np.stack([sorted_random_boxes(rng, k)[0] for _ in range(n)])
    valid = rng.uniform(size=(n, k)) > 0.1
    got = torch_nms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), thr, max_keep)
    for i in range(n):
        want = nms_keep_mask_pallas(
            jnp.asarray(boxes[i]),
            jnp.asarray(valid[i].astype(np.float32)),
            iou_threshold=thr,
            max_keep=max_keep,
            interpret=True,
        )
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want) > 0)
    assert int(got.sum(dim=1).max()) <= max_keep


@pytest.mark.parametrize("k", [300, 500])
def test_plain_nms_matches_numpy_oracle_with_padding(k):
    """Unsorted scores and padded (invalid) boxes through the full `nms`."""
    rng = np.random.default_rng(k + 1)
    n = 2
    boxes, scores, valid = [], [], []
    for _ in range(n):
        b, s = sorted_random_boxes(rng, k)
        perm = rng.permutation(k)
        v = np.ones(k, bool)
        v[rng.choice(k, k // 5, replace=False)] = False  # padding rows
        boxes.append(b[perm])
        scores.append(s[perm])
        valid.append(v)
    boxes, scores, valid = np.stack(boxes), np.stack(scores), np.stack(valid)
    res = torch_nms.nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.5, max_outputs=k
    )
    for i in range(n):
        idx = np.where(valid[i])[0]
        kept = idx[jax_nms.nms_reference_numpy(boxes[i][idx], scores[i][idx], 0.5)]
        m = len(kept)
        np.testing.assert_array_equal(res.valid[i].numpy(), (np.arange(k) < m).astype(np.float32))
        np.testing.assert_array_equal(res.boxes[i, :m].numpy(), boxes[i][kept])
        np.testing.assert_array_equal(res.scores[i, :m].numpy(), scores[i][kept])
        assert not res.boxes[i, m:].any() and not res.scores[i, m:].any()


@pytest.mark.parametrize("presorted", [False, True])
def test_nms_survivors_match_jax_blocked_nms(presorted):
    """Gathered survivors, with fewer survivors than outputs (padding) and a
    cap below the survivor count, equal the JAX package's `nms`."""
    rng = np.random.default_rng(7)
    k = 300
    boxes, scores = sorted_random_boxes(rng, k, spread=150.0)
    if not presorted:
        perm = rng.permutation(k)
        boxes, scores = boxes[perm], scores[perm]
    valid = rng.uniform(size=k) > 0.2
    for max_outputs in (20, 400):
        want = jax_nms.nms(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.3, max_outputs, presorted=presorted
        )
        got = torch_nms.nms(
            torch.from_numpy(boxes[None]),
            torch.from_numpy(scores[None]),
            torch.from_numpy(valid[None]),
            0.3,
            max_outputs,
            presorted=presorted,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_nms_wrapper_rejects_bad_input():
    boxes = torch.zeros((2, 10, 4))
    with pytest.raises(ValueError):
        torch_nms.nms_keep_mask(boxes, torch.ones((2, 9), dtype=torch.bool), 0.5, 5)
    with pytest.raises(TypeError):
        torch_nms.nms_keep_mask(boxes.double(), torch.ones((2, 10), dtype=torch.bool), 0.5, 5)


# --- RoI crop + pool ---------------------------------------------------------


def roi_case(seed, b=2, h=12, w=16, c=128, p=6):
    """A map on a padded canvas, RoIs inside the real image plus RoIs that
    reach past the real grid, past the canvas, and below zero."""
    rng = np.random.default_rng(seed)
    img_h, img_w = 160.0, 200.0  # real grid 10x12 of the 12x16 canvas map
    real_fh, real_fw = 10, 12
    fm = rng.normal(size=(b, h, w, c)).astype(np.float32)
    rois = np.stack([random_rois(rng, p, img_h, img_w) for _ in range(b)])
    rois[:, 0] = [150.0, 190.0, 260.0, 400.0]  # past the real grid and the canvas
    rois[:, 1] = [-30.0, -20.0, 40.0, 50.0]  # starts above and left of the image
    rois[:, 2] = [0.0, 0.0, img_h, img_w]  # the whole image
    norm = np.tile([[(real_fh - 1) / img_h, (real_fw - 1) / img_w]], (b, 1)).astype(np.float32)
    return fm, rois, norm


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_roi_matches_pallas_taps_kernel(seed):
    fm, rois, norm = roi_case(seed)
    want = np.asarray(
        roi_pool_taps_pallas(jnp.asarray(fm), jnp.asarray(rois), jnp.asarray(norm), interpret=True, chunk=2)
    )
    got = torch_roi.roi_pool_taps(torch.from_numpy(fm), torch.from_numpy(rois), torch.from_numpy(norm))
    assert got.shape == want.shape == (2, 6, 7, 7, 128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_plain_roi_out_of_range_samples_are_zero():
    fm, rois, norm = roi_case(2)
    rois[:, 0] = [300.0, 300.0, 400.0, 400.0]  # entirely past the canvas map
    got = torch_roi.roi_pool_taps(torch.from_numpy(fm), torch.from_numpy(rois), torch.from_numpy(norm))
    assert not got[:, 0].any()
    assert got[:, 2].abs().sum() > 0


def test_plain_roi_bf16_rounds_rows_then_pools():
    """bf16 maps give bf16 output: the tap weights, the y-interpolated rows,
    each x-tap product and the x-sum round to bf16 (the TPU kernel's points,
    spelled out one sample at a time by `taps_reference`), then the pool;
    the output stays within bf16 rounding of the f32 result."""
    fm, rois, norm = roi_case(3)
    f32 = torch_roi.roi_pool_taps(torch.from_numpy(fm), torch.from_numpy(rois), torch.from_numpy(norm))
    fm16 = torch.from_numpy(fm).to(torch.bfloat16)
    b16 = torch_roi.roi_pool_taps(fm16, torch.from_numpy(rois), torch.from_numpy(norm))
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, taps_reference(fm16, torch.from_numpy(rois), torch.from_numpy(norm)))
    np.testing.assert_allclose(b16.float().numpy(), f32.numpy(), rtol=2**-6, atol=2**-6)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plain_roi_bf16_equals_pallas_taps_kernel(seed):
    """bf16 maps: the TPU taps kernel's rounding points, no value differs."""
    fm, rois, norm = roi_case(seed)
    want = roi_pool_taps_pallas(
        jnp.asarray(fm, jnp.bfloat16), jnp.asarray(rois), jnp.asarray(norm), interpret=True, chunk=2
    )
    got = torch_roi.roi_pool_taps(torch.from_numpy(fm).bfloat16(), torch.from_numpy(rois), torch.from_numpy(norm))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("seed,chunk", [(0, 2), (1, 3), (7, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_roi_matches_pallas_fused_kernel(seed, chunk, dtype):
    """K4's rounding: in f32 within summation order (1e-5); in bf16 equal."""
    fm, rois, norm = roi_case(seed, c=24)
    want = roi_pool_fused_pallas(
        jnp.asarray(fm, dtype), jnp.asarray(rois), jnp.asarray(norm), interpret=True, chunk=chunk
    )
    got = torch_roi.roi_pool_fused(torch.from_numpy(fm).to(getattr(torch, dtype)), torch.from_numpy(rois),
                                   torch.from_numpy(norm))
    assert got.shape == (2, 6, 7, 7, 24) and got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_fused_and_taps_roi_differ_only_in_the_bf16_x_rounding():
    """In f32 the two formulations are one function, bit for bit; in bf16
    K4 rounds the x-sum once where K2 rounds each x-tap product too, so
    some values differ: by the two product roundings (2^-9 of a tap each)
    and the sums' own, at most 2^-7 of the map's largest value."""
    fm, rois, norm = map(torch.from_numpy, roi_case(4))
    assert torch.equal(torch_roi.roi_pool_fused(fm, rois, norm), torch_roi.roi_pool_taps(fm, rois, norm))
    fused = torch_roi.roi_pool_fused(fm.bfloat16(), rois, norm).float()
    taps = torch_roi.roi_pool_taps(fm.bfloat16(), rois, norm).float()
    diff = (fused - taps).abs()
    assert 0.05 < (diff > 0).float().mean() < 0.5
    assert float(diff.max()) <= 2.0**-7 * float(fm.abs().max())


def test_plain_fused_roi_out_of_range_rois_are_zero():
    """RoIs past the real grid sample zeros (`tests/test_roi_pallas.py:67-81`)."""
    rng = np.random.default_rng(3)
    fm = torch.from_numpy(rng.normal(size=(1, 16, 16, 8)).astype(np.float32))
    rois = torch.tensor([[[2.0, 400.0, 10.0, 500.0]]])
    norm = torch.tensor([[15.0 / 256.0, 15.0 / 256.0]])
    assert not torch_roi.roi_pool_fused(fm, rois, norm).any()
    want = roi_pool_fused_pallas(jnp.asarray(fm.numpy()), jnp.asarray(rois.numpy()), jnp.asarray(norm.numpy()),
                                 interpret=True, chunk=1)
    np.testing.assert_array_equal(np.asarray(want), 0.0)


def test_fused_roi_has_no_gradient():
    """As the JAX op, which defines no VJP: a map that requires grad raises."""
    fm, rois, norm = map(torch.from_numpy, roi_case(5))
    with pytest.raises(RuntimeError):
        torch_roi.roi_pool_fused(fm.clone().requires_grad_(), rois, norm)
    with torch.no_grad():
        out = torch_roi.roi_pool_fused(fm.clone().requires_grad_(), rois, norm)
    assert out.grad_fn is None
