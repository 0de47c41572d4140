"""The port's train step against the JAX package's, on the same weights.

The model is `tests/test_torch_predict.py`'s tiny config: full-width VGG-16
on the 128x160 canvas, B=2, train caps 400 -> 128, 64 RPN and 32 detector
samples an image. The JAX model and its parameters are built once; the port
loads them through `utils/weights.from_jax_params`. On the CPU the JAX
package takes its XLA paths (blocked NMS, einsum RoI crop), and the port its
plain versions. `jax.random` bits cannot be made in torch, so the port is fed
the uniforms JAX draws from the keys of its `compute_losses`.

Tolerances (f32 on both sides):
  * target assignment, sampling and sampled slots are decisions: equal;
    targets to 1e-6 absolute;
  * loss functions fed the same inputs: 1e-6 relative;
  * the whole loss: 1e-4 relative (the two backbones already differ by up to
    1e-4, `tests/test_torch_predict.py`);
  * gradients, per parameter tensor, in relative norm |g - g_jax| / |g_jax|:
    3e-3. Measured at most 5.9e-4: the backbones' 1e-4 differences, the JAX
    RoI crop's sample positions (rois / img * (fh - 1), the port's
    rois * ((fh - 1) / img), an ulp apart), and on a ReLU'd feature map
    two samples symmetric about a cell with zero neighbours that tie or
    not by the last bit (`test_symmetric_ties_are_where_the_two_backwards_part`),
    so one side may split a cotangent the other gives whole. A norm bounds
    these; an elementwise tolerance would not;
  * three optimizer steps: the update of each tensor (params after - before)
    in relative norm, 2e-3 (measured at most 3.7e-4); frozen tensors exactly
    0. These steps use a config in which every anchor and proposal is
    trained (`every_box_config`), so the trained boxes do not depend on
    near-tied scores.
"""

import dataclasses
import itertools
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu import engine as jax_engine
from fasterrcnn_tpu.models import faster_rcnn as jax_frcnn
from fasterrcnn_tpu.models import losses as jax_losses
from fasterrcnn_tpu.models.rpn import generate_proposals as jax_generate_proposals
from fasterrcnn_tpu.ops import anchors as jax_anchors
from fasterrcnn_tpu.ops import sampling as jax_sampling
from fasterrcnn_tpu.ops.pallas import roi_pallas
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch.data.pipeline import Prefetcher
from fasterrcnn_torch.data.synthetic import SyntheticDataset
from fasterrcnn_torch.engine import Engine, make_optimizer
from fasterrcnn_torch.models import faster_rcnn as torch_frcnn
from fasterrcnn_torch.models import losses as torch_losses
from fasterrcnn_torch.models.rpn import generate_proposals
from fasterrcnn_torch.ops import anchors as torch_anchors
from fasterrcnn_torch.ops import roi as torch_roi
from fasterrcnn_torch.ops import sampling as torch_sampling
from fasterrcnn_torch.utils.weights import _flatten, from_jax_params
from tests.test_torch_predict import CANVAS_H, CANVAS_W, tiny_config

B, G = 2, 8


def numpy_batch(seed, b=B):
    """`tests/test_model.py`'s synthetic_batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, CANVAS_H, CANVAS_W, 3), dtype=np.uint8)
    image_hw = np.tile([[120.0, 150.0]], (b, 1)).astype(np.float32)
    gt_boxes = np.zeros((b, G, 4), np.float32)
    gt_classes = np.zeros((b, G), np.int32)
    gt_mask = np.zeros((b, G), np.float32)
    for i in range(b):
        for j in range(int(rng.integers(1, 4))):
            y1, x1 = rng.uniform(0, 60), rng.uniform(0, 80)
            gt_boxes[i, j] = [y1, x1, y1 + rng.uniform(30, 55), x1 + rng.uniform(30, 60)]
            gt_classes[i, j] = rng.integers(1, 21)
            gt_mask[i, j] = 1.0
    return dict(
        images=images, image_hw=image_hw, gt_boxes=gt_boxes, gt_classes=gt_classes, gt_mask=gt_mask,
        sample_weight=np.ones((b,), np.float32),
    )


def jax_batch(nb):
    return jax_frcnn.Batch(**{k: jnp.asarray(v) for k, v in nb.items()})


def torch_batch(nb):
    return torch_frcnn.Batch(**{k: torch.from_numpy(np.array(v)) for k, v in nb.items()})


def jax_draws(rng, b, n_anchors, n_props):
    """The uniforms JAX's compute_losses draws from `rng`, in its key order:
    split(rng) -> sample key -> split(., b); per image split(key) -> k1, k2;
    split(k1) -> (positive, negative) anchor ranks; split(k2, 3) -> (positive,
    negative, unused) proposal ranks."""
    _, sample_rng = jax.random.split(rng)
    rpn, det = ([], []), ([], [])
    for key in jax.random.split(sample_rng, b):
        k1, k2 = jax.random.split(key)
        for out, keys, n in ((rpn, jax.random.split(k1), n_anchors), (det, jax.random.split(k2, 3), n_props)):
            for side in range(2):
                out[side].append(np.asarray(jax.random.uniform(keys[side], (n,))))
    to_torch = lambda pair: tuple(torch.from_numpy(np.stack(u)) for u in pair)  # noqa: E731
    return torch_frcnn.TrainDraws(rpn=to_torch(rpn), detector=to_torch(det))


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config(jax_config)
    jax_model = jax_frcnn.FasterRCNN(cfg=cfg)
    params = jax_frcnn.init_params(jax_model, CANVAS_H, CANVAS_W, seed=0)
    grid = jax_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    return jax_model, params, grid


def fresh_port(params):
    port = torch_frcnn.FasterRCNN(tiny_config(torch_config))
    port.load_state_dict(from_jax_params(params))
    return port


def test_generate_rpn_targets_match_jax_with_padding_and_forced_ties(models):
    _, _, grid = models
    rng = np.random.default_rng(0)
    image_hw = np.array([[120.0, 150.0], [112.0, 160.0]], np.float32)
    gt = np.zeros((B, G, 4), np.float32)
    mask = np.zeros((B, G), np.float32)
    # The last box lies in the image's corner, where no anchor fully inside
    # the image reaches: every valid anchor ties at IoU 0 with it.
    gt[0, :3] = [[10, 20, 60, 70], [40, 50, 90, 140], [118, 148, 120, 150]]
    gt[1, :2] = [[8, 8, 32, 32], [50, 30, 100, 110]]  # the first is an exact anchor-cell fit
    mask[0, :3] = mask[1, :2] = 1.0
    gt[0, 5] = [30, 30, 80, 80]  # padded rows with real-looking boxes must be ignored
    gt[1, 3] = rng.uniform(0, 100, 4)
    cfg = tiny_config(jax_config)
    valid = np.stack([np.asarray(jax_frcnn.proposal_masks(cfg, grid, jnp.asarray(hw))[1]) > 0 for hw in image_hw])
    want = jax.vmap(
        lambda v, g, m: jax_anchors.generate_rpn_targets(
            jnp.asarray(grid.centers), jnp.asarray(grid.corners), v, g, m
        )
    )(jnp.asarray(valid), jnp.asarray(gt), jnp.asarray(mask))
    got = torch_anchors.generate_rpn_targets(
        torch.from_numpy(grid.centers), torch.from_numpy(grid.corners), torch.from_numpy(valid),
        torch.from_numpy(gt), torch.from_numpy(mask),
    )
    np.testing.assert_array_equal(got.trainable.numpy(), np.asarray(want.trainable))
    np.testing.assert_array_equal(got.objectness.numpy(), np.asarray(want.objectness))
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas), rtol=0, atol=1e-6)
    # The degenerate box forces every valid anchor (all at IoU 0) positive.
    assert got.objectness[0].sum() == got.trainable[0].sum() > 0


def rpn_and_proposals(jax_model, params, grid, nb):
    """JAX's RPN outputs, targets and train-cap proposals of a batch."""
    cfg = jax_model.cfg
    _, logits, deltas = jax_model.apply(
        {"params": params}, jnp.asarray(nb["images"]), method=jax_frcnn.FasterRCNN.features_and_rpn
    )
    centers, corners = jnp.asarray(grid.centers), jnp.asarray(grid.corners)

    def per_image(lg, dl, hw, gt, m):
        prop_mask, train_valid = jax_frcnn.proposal_masks(cfg, grid, hw)
        props = jax_generate_proposals(
            lg, dl, centers, prop_mask, hw[0], hw[1], cfg.rpn.pre_nms_train, cfg.rpn.post_nms_train,
            cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side,
        )
        return props, jax_anchors.generate_rpn_targets(centers, corners, train_valid > 0, gt, m)

    return jax.vmap(per_image)(
        logits, deltas, jnp.asarray(nb["image_hw"]), jnp.asarray(nb["gt_boxes"]), jnp.asarray(nb["gt_mask"])
    )


def test_sampling_matches_jax_on_jax_draws(models):
    jax_model, params, grid = models
    cfg = jax_model.cfg
    nb = numpy_batch(1)
    props, targets = rpn_and_proposals(jax_model, params, grid, nb)
    rng = jax.random.key(3)
    draws = jax_draws(rng, B, grid.total, cfg.rpn.post_nms_train + G)
    keys = jax.random.split(jax.random.split(rng)[1], B)

    def per_image(key, trainable, objectness, boxes, valid, gt, classes, mask):
        k1, k2 = jax.random.split(key)
        mb = jax_sampling.sample_rpn_minibatch(k1, trainable, objectness, cfg.rpn.minibatch_size, 0.5)
        smp = jax_sampling.label_and_sample_proposals(
            k2, boxes, valid, gt, classes, mask, cfg.detector.proposal_batch_size
        )
        return mb, smp

    want_mb, want = jax.vmap(per_image)(
        keys, targets.trainable, targets.objectness, props.boxes, props.valid,
        jnp.asarray(nb["gt_boxes"]), jnp.asarray(nb["gt_classes"]), jnp.asarray(nb["gt_mask"]),
    )
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got_mb = torch_sampling.sample_rpn_minibatch(
        t(targets.trainable), t(targets.objectness), cfg.rpn.minibatch_size, 0.5, draws=draws.rpn
    )
    got = torch_sampling.label_and_sample_proposals(
        t(props.boxes), t(props.valid), t(nb["gt_boxes"]), t(nb["gt_classes"]), t(nb["gt_mask"]),
        cfg.detector.proposal_batch_size, draws=draws.detector,
    )
    np.testing.assert_array_equal(got_mb.numpy(), np.asarray(want_mb))
    assert 0 < got_mb.sum() <= B * cfg.rpn.minibatch_size
    for name in ("boxes", "classes", "weights", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas), rtol=0, atol=1e-6)
    assert (got.classes > 0).sum() > 0 and got.weights.sum() > (got.classes > 0).sum()


def test_masked_rank_and_tie_rules_follow_jax():
    """Stable ranks on tied draws, top_k's index order and round-half-even
    (round(2 * 0.25) = 0 positives of 2 samples)."""
    mask = torch.tensor([[True, False, True, True, True]])
    u = torch.tensor([[0.5, 0.1, 0.5, 0.2, 0.5]])
    want = np.asarray(jnp.argsort(jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(u.numpy()), 2.0)))
    ranks = torch_sampling._masked_rank(u, mask)
    np.testing.assert_array_equal(np.argsort(ranks.numpy()[0]), want[0])
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [50.0, 50.0, 60.0, 60.0]]])
    gt = torch.tensor([[[0.0, 0.0, 10.0, 10.0]]])
    smp = torch_sampling.label_and_sample_proposals(
        boxes, torch.ones(1, 2), gt, torch.tensor([[3]]), torch.ones(1, 1), batch_size=2,
        draws=(torch.full((1, 3), 0.5), torch.full((1, 3), 0.5)),
    )
    assert int(smp.count) == 0 and float(smp.weights.sum()) == 0.0  # no positive slot: empty batch


def test_loss_functions_match_jax():
    rng = np.random.default_rng(4)
    a, s, c = 300, 32, 21
    logits = rng.normal(size=(a,)).astype(np.float32) * 3
    obj = (rng.uniform(size=a) > 0.7).astype(np.float32)
    mb = (rng.uniform(size=a) > 0.5).astype(np.float32)
    deltas, tdeltas = (rng.normal(size=(a, 4)).astype(np.float32) for _ in range(2))
    cls_logits = rng.normal(size=(s, c)).astype(np.float32)
    classes = rng.integers(0, c, s).astype(np.int32)
    weights = (rng.uniform(size=s) > 0.2).astype(np.float32)
    count = np.int32(weights.sum())
    box_deltas = rng.normal(size=(s, 4 * (c - 1))).astype(np.float32)
    sdeltas = rng.normal(size=(s, 4)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (jax_losses.rpn_class_loss(logits, obj, mb), torch_losses.rpn_class_loss(t(logits), t(obj), t(mb))),
        (
            jax_losses.rpn_regression_loss(deltas, tdeltas, obj, mb, 3.0),
            torch_losses.rpn_regression_loss(t(deltas), t(tdeltas), t(obj), t(mb), 3.0),
        ),
        (
            jax_losses.detector_class_loss(cls_logits, classes, weights, count),
            torch_losses.detector_class_loss(t(cls_logits), t(classes), t(weights), torch.tensor(count)),
        ),
        (
            jax_losses.detector_regression_loss(box_deltas, classes, sdeltas, weights, count, 1.0),
            torch_losses.detector_regression_loss(
                t(box_deltas), t(classes), t(sdeltas), t(weights), torch.tensor(count), 1.0
            ),
        ),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def roi_case(seed, relu=False, zero_windows=False):
    rng = np.random.default_rng(seed)
    fm = rng.normal(size=(2, 8, 10, 128)).astype(np.float32)
    if relu:
        fm = np.maximum(fm, 0.0)
    y1, x1 = rng.uniform(-30, 90, (2, 4)), rng.uniform(-30, 120, (2, 4))
    rois = np.stack([y1, x1, y1 + rng.uniform(10, 70, (2, 4)), x1 + rng.uniform(10, 80, (2, 4))], -1)
    if zero_windows:
        fm[:, 2:6, 3:8] = 0.0  # whole 2x2 windows of zero samples: four-way ties
        rois[:, 0] = [20.0, 30.0, 80.0, 100.0]  # inside the zero block
        rois[:, 1] = [-60.0, -50.0, 40.0, 60.0]  # partly outside the map: zero samples tie
    norm = np.tile([[7 / 120, 9 / 150]], (2, 1)).astype(np.float32)
    g = rng.normal(size=(2, 4, 7, 7, 128)).astype(np.float32)
    return fm, rois.astype(np.float32), norm, g


@pytest.mark.parametrize("zero_windows", [False, True])
def test_plain_roi_backward_matches_jax_kernel(zero_windows):
    fm, rois, norm, g = roi_case(5, zero_windows=zero_windows)
    want = np.asarray(roi_pallas.roi_pool_taps_pallas_bwd(fm, rois, norm, g, interpret=True))
    got = torch_roi.roi_pool_taps_bwd_plain(*map(torch.from_numpy, (fm, rois, norm, g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_symmetric_ties_are_where_the_two_backwards_part():
    """A known gap, pinned: on a ReLU'd map, samples 6 and 7 of the RoI
    (y = 1.923 and 2.077, norm_y 0.05) lie symmetrically about row 2; where
    rows 1 and 3 are zero both equal 0.923 * fm[2] up to the last bit, which
    the two implementations compute differently, so one splits the
    cotangent between them and the other does not (here 0.07 against a
    largest gradient of 7.4). Outside the port's tied windows the two agree
    to 1e-5."""
    rng = np.random.default_rng(0)
    fm = np.maximum(rng.normal(size=(1, 8, 10, 128)), 0.0).astype(np.float32)
    rois = np.array([[[20.0, 30.0, 60.0, 70.0]]], np.float32)
    norm = np.array([[0.05, 9 / 150]], np.float32)
    g = rng.normal(size=(1, 1, 7, 7, 128)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    want = np.asarray(roi_pallas.roi_pool_taps_pallas_bwd(fm, rois, norm, g, interpret=True))
    got = torch_roi.roi_pool_taps_bwd_plain(t(fm), t(rois), t(norm), t(g)).numpy()
    assert np.abs(got - want).max() > 5e-3 * np.abs(want).max()
    # The port's windows with a tie between two non-zero samples.
    window = torch_roi.crop_and_resize(t(fm), t(rois), t(norm)).reshape(1, 1, 7, 2, 7, 2, 128)
    peak = window.amax(dim=(3, 5), keepdim=True)
    ties = ((window == peak) & (peak > 0)).sum(dim=(3, 5)) >= 2
    assert ties.any()
    g_clear = np.where(ties.numpy(), 0.0, g).astype(np.float32)
    want = np.asarray(roi_pallas.roi_pool_taps_pallas_bwd(fm, rois, norm, g_clear, interpret=True))
    got = torch_roi.roi_pool_taps_bwd_plain(t(fm), t(rois), t(norm), t(g_clear)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_plain_roi_backward_is_autograd_of_the_plain_forward_in_f32():
    fm, rois, norm, g = map(torch.from_numpy, roi_case(6, relu=True))
    f = fm.clone().requires_grad_()
    torch_roi.roi_pool_features(f, rois, norm).backward(g)
    got = torch_roi.roi_pool_taps_bwd_plain(fm, rois, norm, g)
    torch.testing.assert_close(got, f.grad, rtol=0, atol=1e-6)


def test_compute_losses_and_gradients_match_jax(models):
    jax_model, params, grid = models
    cfg = jax_model.cfg
    nb = numpy_batch(2)
    rng = jax.random.key(5)
    jb = jax_batch(nb)
    (_, want), grads = jax.jit(
        jax.value_and_grad(lambda p: jax_frcnn.compute_losses(jax_model, p, jb, rng, cfg, grid), has_aux=True)
    )(params)
    draws = jax_draws(rng, B, grid.total, cfg.rpn.post_nms_train + G)
    port = fresh_port(params)
    port.train()
    # The decisions first: proposal masks and sampled slots as JAX's.
    props, _ = rpn_and_proposals(jax_model, params, grid, nb)
    with torch.no_grad():
        _, logits, deltas = port.features_and_rpn(torch.from_numpy(nb["images"]))
        hw = torch.from_numpy(nb["image_hw"])
        got_props = generate_proposals(
            logits, deltas, torch.from_numpy(grid.centers), torch_frcnn.proposal_masks(port.cfg, grid, hw)[0],
            hw[:, 0], hw[:, 1], cfg.rpn.pre_nms_train, cfg.rpn.post_nms_train, cfg.rpn.nms_iou_threshold,
            cfg.rpn.min_proposal_side,
        )
    np.testing.assert_array_equal(got_props.valid.numpy(), np.asarray(props.valid))
    smp_args = (torch.from_numpy(nb["gt_boxes"]), torch.from_numpy(nb["gt_classes"]), torch.from_numpy(nb["gt_mask"]))
    got_smp = torch_sampling.label_and_sample_proposals(
        got_props.boxes, got_props.valid, *smp_args, cfg.detector.proposal_batch_size, draws=draws.detector
    )
    want_smp = torch_sampling.label_and_sample_proposals(
        torch.from_numpy(np.array(props.boxes)), torch.from_numpy(np.array(props.valid)), *smp_args,
        cfg.detector.proposal_batch_size, draws=draws.detector,
    )
    np.testing.assert_array_equal(got_smp.weights.numpy(), want_smp.weights.numpy())
    np.testing.assert_array_equal(got_smp.classes.numpy(), want_smp.classes.numpy())

    total, got = torch_frcnn.compute_losses(port, torch_batch(nb), grid, draws=draws)
    for name in torch_frcnn.Losses._fields:
        value = getattr(got, name).item()
        np.testing.assert_allclose(value, float(getattr(want, name)), rtol=1e-4, err_msg=name)
        assert value > 0, name
    total.backward()
    want_grads = from_jax_params(jax.tree.map(np.asarray, grads))
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            np.testing.assert_array_equal(want_grads[name].numpy(), 0.0, err_msg=name)
            continue
        err = rel_norm(p.grad.numpy(), want_grads[name].numpy())
        assert err <= 3e-3, (name, err)


def every_box_config(cfg_module):
    """The tiny config with every anchor a proposal (no NMS suppression, no
    size filter, caps above the 720 anchors) and every anchor and proposal
    sampled. Over several steps the two packages' RPN scores drift apart by
    ~1e-5, which reorders near-tied scores and changes which proposals a
    step trains on (as `tests/test_model.py`'s scan test notes within JAX);
    here the set of trained boxes no longer depends on the scores."""
    base = tiny_config(cfg_module)
    return dataclasses.replace(
        base,
        rpn=dataclasses.replace(
            base.rpn, pre_nms_train=720, post_nms_train=720, nms_iou_threshold=1.0, min_proposal_side=0.0,
            minibatch_size=720, max_positive_fraction=1.0,
        ),
        detector=dataclasses.replace(base.detector, proposal_batch_size=256, positive_fraction=1.0),
    )


def small_image_batch(seed):
    """numpy_batch with 64x80 images in the canvas: 180 proposals each."""
    nb = numpy_batch(seed)
    rng = np.random.default_rng(seed + 1000)
    nb["image_hw"][:] = [64.0, 80.0]
    nb["images"][:, 64:] = nb["images"][:, :, 80:] = 0
    for i in range(B):
        for j in range(int(nb["gt_mask"][i].sum())):
            y1, x1 = rng.uniform(0, 30), rng.uniform(0, 40)
            nb["gt_boxes"][i, j] = [y1, x1, y1 + rng.uniform(20, 34), x1 + rng.uniform(20, 40)]
    return nb


def flat_labels(jax_labels):
    """optax group labels keyed by the port's parameter names."""
    out = {}
    for path, label in _flatten(jax_labels):
        *module, leaf = path
        out[".".join([*module, "weight" if leaf == "kernel" else leaf])] = str(label)
    return out


def jax_reference_steps(jax_model, params, grid, train_cfg, batches, rngs):
    tx, labels = jax_engine.make_optimizer(jax_model.cfg, train_cfg, params)
    step = jax_frcnn.make_train_step(jax_model, tx, CANVAS_H, CANVAS_W)
    p, o = jax.tree.map(jnp.copy, params), tx.init(params)
    losses = []
    for nb, rng in zip(batches, rngs):
        p, o, out = step(p, o, jax_batch(nb), rng)
        losses.append(np.asarray(jnp.stack(list(out))))
    return from_jax_params(jax.tree.map(np.asarray, p)), np.stack(losses), labels


@pytest.mark.parametrize(
    "train_cfg",
    [
        jax_config.TrainConfig(),
        jax_config.TrainConfig(
            optimizer="adam", learning_rate=1e-4, clipnorm=1.0, lr_schedule="cosine", warmup_steps=1, total_steps=4
        ),
    ],
    ids=["sgd", "adam-clip-cosine"],
)
def test_three_train_steps_match_jax(models, train_cfg):
    _, params, grid = models
    cfg = every_box_config(jax_config)
    jax_model = jax_frcnn.FasterRCNN(cfg=cfg)
    batches = [small_image_batch(10 + i) for i in range(3)]
    rngs = [jax.random.key(20 + i) for i in range(3)]
    want, want_losses, jax_labels = jax_reference_steps(jax_model, params, grid, train_cfg, batches, rngs)

    port = torch_frcnn.FasterRCNN(every_box_config(torch_config))
    port.load_state_dict(from_jax_params(params))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    optimizer, labels = make_optimizer(port.cfg, torch_config.TrainConfig(**vars(train_cfg)), port)
    step = torch_frcnn.make_train_step(port, optimizer, CANVAS_H, CANVAS_W)
    losses = [
        torch.stack(list(step(torch_batch(nb), draws=jax_draws(rng, B, grid.total, cfg.rpn.post_nms_train + G)))).numpy()
        for nb, rng in zip(batches, rngs)
    ]
    np.testing.assert_allclose(np.stack(losses), want_losses, rtol=1e-3)

    assert labels == flat_labels(jax_labels)
    assert labels["feature_extractor.block1_conv1.weight"] == "frozen"
    assert labels["feature_extractor.block3_conv1.weight"] == "decayed"
    assert labels["feature_extractor.block3_conv1.bias"] == "plain"
    for name, p in port.named_parameters():
        got_update = (p.detach() - before[name]).numpy()
        want_update = want[name].numpy() - before[name].numpy()
        if labels[name] == "frozen":
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(want_update, 0.0, err_msg=name)
            continue
        err = rel_norm(got_update, want_update)
        assert err <= 2e-3, (name, err)


def test_padding_images_leave_the_loss_unchanged(models):
    _, params, grid = models
    port = fresh_port(params)
    port.train()
    nb = numpy_batch(3)
    padded = {k: np.concatenate([v, np.zeros_like(v)]) for k, v in nb.items()}
    padded["images"][2:] = np.random.default_rng(9).integers(0, 255, padded["images"][2:].shape, dtype=np.uint8)
    padded["image_hw"][2:] = [CANVAS_H, CANVAS_W]
    cfg = port.cfg
    draws = torch_frcnn.draw_train_uniforms(cfg, grid, 4, torch.Generator().manual_seed(0), "cpu")
    real_draws = torch_frcnn.TrainDraws(*(tuple(u[:2] for u in pair) for pair in draws))
    with torch.no_grad():
        total_real, _ = torch_frcnn.compute_losses(port, torch_batch(nb), grid, draws=real_draws)
        total_padded, _ = torch_frcnn.compute_losses(port, torch_batch(padded), grid, draws=draws)
    np.testing.assert_allclose(float(total_padded), float(total_real), rtol=1e-5)


def test_engine_train_epoch_on_cpu():
    engine = Engine(tiny_config(torch_config), seed=0, device="cpu")
    w = engine.model.roi_head.fc2.weight.detach().clone()
    stats = engine.train_epoch(SyntheticDataset(num_samples=4, height=120, width=150, seed=0), batch_size=2)
    means = stats.means()
    assert stats._count == 2 and set(means) == set(stats.LOSS_NAMES)
    assert all(np.isfinite(v) for v in means.values())
    assert not torch.equal(engine.model.roi_head.fc2.weight, w)


@pytest.mark.parametrize("seed", [5, 7])
def test_bf16_roi_forward_equals_the_tpu_kernel(seed):
    """In bf16 the port rounds where the TPU taps kernel rounds: weights of
    both axes, the y-sum, each x-tap product and the x-sum
    (roi_pallas.py:194,202,218-221), so no value may differ."""
    fm, rois, norm, _ = roi_case(seed)
    t = torch.from_numpy
    want = roi_pallas.roi_pool_taps_pallas(jnp.asarray(fm, jnp.bfloat16), rois, norm, interpret=True, chunk=2)
    got = torch_roi.roi_pool_features(t(fm).bfloat16(), t(rois), t(norm))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [5, 7])
def test_bf16_roi_backward_matches_the_tpu_kernel(seed):
    """On a normal map (no exact ties) the bf16 backward makes the TPU
    kernel's argmax decisions and scatters through the same bf16-rounded
    weights (roi_pallas.py:387,391,399). Tolerance: both sum in f32, in
    orders of their own, and cast once to bf16, so a value may differ by
    1e-5 of the largest and by one bf16 step (2^-7 of it); measured 0."""
    fm, rois, norm, g = roi_case(seed)
    fm16 = np.array(jnp.asarray(fm, jnp.bfloat16).astype(jnp.float32))
    g16 = np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    want = roi_pallas.roi_pool_taps_pallas_bwd(
        jnp.asarray(fm16, jnp.bfloat16), rois, norm, jnp.asarray(g16, jnp.bfloat16), interpret=True, chunk=2
    )
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    t = torch.from_numpy
    got = torch_roi.roi_pool_taps_bwd_plain(t(fm16).bfloat16(), t(rois), t(norm), t(g16).bfloat16())
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 1e-5 * np.abs(want).max() + 2.0**-7 * np.abs(want)).all(), err.max()


def test_bf16_model_keeps_f32_parameters_and_computes_in_bf16():
    """A bf16 model computes in bf16 and updates f32 parameters, as the JAX
    package's param_dtype=float32 layers do."""
    engine = Engine(dataclasses.replace(tiny_config(torch_config), compute_dtype="bfloat16"), seed=0, device="cpu")
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())
    nb = numpy_batch(4)
    with torch.no_grad():
        fm, logits, _ = engine.model.features_and_rpn(torch.from_numpy(nb["images"]))
    assert fm.dtype == torch.bfloat16 and logits.dtype == torch.float32
    w = engine.model.roi_head.fc1.weight.detach().clone()
    losses = engine.train_step(torch_batch(nb))
    assert all(np.isfinite(v.item()) for v in losses)
    assert engine.model.roi_head.fc1.weight.dtype == torch.float32
    assert not torch.equal(engine.model.roi_head.fc1.weight, w)


def test_frozen_blocks_and_head_dropout():
    cfg = dataclasses.replace(
        tiny_config(torch_config), detector=dataclasses.replace(tiny_config(torch_config).detector, dropout=0.5)
    )
    model = torch_frcnn.FasterRCNN(cfg)
    frozen = set(torch_frcnn.frozen_parameter_names(model))
    assert frozen == {f"feature_extractor.block{b}_conv{c}.{k}" for b in (1, 2) for c in (1, 2) for k in ("weight", "bias")}
    assert not any(model.get_parameter(n).requires_grad for n in frozen)
    assert not torch_frcnn.frozen_parameter_names(
        torch_frcnn.FasterRCNN(dataclasses.replace(cfg, train_all=True))
    )
    x = torch.ones(3, 7, 7, 512)
    model.train()
    assert not torch.equal(model.roi_head(x), model.roi_head(x))  # dropout after fc1 and fc2
    model.eval()
    assert torch.equal(model.roi_head(x), model.roi_head(x))


def test_prefetcher_delivers_every_item_when_the_consumer_is_slow():
    """The worker finishes while its queue is full: the end marker waits
    behind the queued items instead of replacing one. close() still stops a
    worker blocked on a full queue."""
    prefetcher = Prefetcher(iter([1, 2]), depth=2)
    while prefetcher._queue.qsize() < 2:
        time.sleep(0.01)
    time.sleep(0.2)  # the worker is done with its source and holds the end marker
    assert list(prefetcher) == [1, 2]
    endless = Prefetcher(itertools.count(), depth=2)
    assert next(endless) == 0
    endless.close()
    assert not endless._thread.is_alive()
