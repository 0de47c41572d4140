"""The port's predict path against the JAX package's, on the same weights.

The model is full-width VGG-16 on the 128x160 canvas with the tiny config of
`tests/test_model.py` (infer caps 200 -> 64, B=2): the VGG widths are fixed,
so this is the smallest faithful model. The JAX model and its parameters are
built once; the port loads them through `utils/weights.from_jax_params`. On
the CPU the JAX package takes its XLA paths (blocked NMS, einsum RoI), the
oracles of its Pallas kernels, and the port takes its plain versions.

Tolerances (f32 on both sides): the backbone's 13 convs sum in another order
in XLA than in PyTorch, so features and RPN outputs agree to 1e-4; stages fed
the same inputs agree to 1e-4 (boxes in pixels); detection scores are
softmax outputs, to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu import engine as jax_engine
from fasterrcnn_tpu.data import voc as jax_voc
from fasterrcnn_tpu.models import faster_rcnn as jax_frcnn
from fasterrcnn_tpu.models.rpn import generate_proposals as jax_generate_proposals
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch.data import voc as torch_voc
from fasterrcnn_torch.engine import Engine
from fasterrcnn_torch.models import faster_rcnn as torch_frcnn
from fasterrcnn_torch.models.rpn import generate_proposals
from fasterrcnn_torch.utils.weights import from_jax_params, to_jax_params
from tests.test_predict_golden import reference_predict_numpy

CANVAS_H, CANVAS_W = 128, 160


def tiny_config(cfg_module):
    """`tests/test_model.py`'s tiny_config, for either package's config."""
    return cfg_module.ModelConfig(
        num_classes=21,
        anchors=cfg_module.AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=cfg_module.RPNConfig(
            pre_nms_train=400, post_nms_train=128, pre_nms_infer=200, post_nms_infer=64, minibatch_size=64
        ),
        detector=cfg_module.DetectorConfig(proposal_batch_size=32),
        max_gt_boxes=8,
    )


def synthetic_images(seed, b=2):
    """`tests/test_model.py`'s synthetic_batch images and real extents."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, CANVAS_H, CANVAS_W, 3), dtype=np.uint8)
    image_hw = np.tile([[120.0, 150.0]], (b, 1)).astype(np.float32)
    return images, image_hw


@pytest.fixture(scope="module")
def models():
    jax_model = jax_frcnn.FasterRCNN(cfg=tiny_config(jax_config))
    params = jax_frcnn.init_params(jax_model, CANVAS_H, CANVAS_W, seed=0)
    port = torch_frcnn.FasterRCNN(tiny_config(torch_config))
    port.load_state_dict(from_jax_params(params))
    port.eval()
    return jax_model, params, port


def test_weight_bridge_round_trips_bit_exactly(models):
    _, params, port = models
    state = from_jax_params(params)
    assert set(state) == set(port.state_dict())  # no missing or extra keys
    back = to_jax_params(state)
    flat_in = {"/".join(k): v for k, v in _flatten(params)}
    flat_out = {"/".join(k): v for k, v in _flatten(back)}
    assert flat_in.keys() == flat_out.keys()
    for key, value in flat_in.items():
        np.testing.assert_array_equal(flat_out[key], value, err_msg=key)
    # And torch -> flax -> torch.
    again = from_jax_params(to_jax_params(port.state_dict()))
    for key, value in port.state_dict().items():
        assert torch.equal(again[key], value), key


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_features_and_rpn(jax_model, params, images):
    return jax_model.apply({"params": params}, jnp.asarray(images), method=jax_frcnn.FasterRCNN.features_and_rpn)


def test_features_and_rpn_match_jax(models):
    jax_model, params, port = models
    images, _ = synthetic_images(0)
    fm_j, logits_j, deltas_j = _jax_features_and_rpn(jax_model, params, images)
    with torch.inference_mode():
        fm_t, logits_t, deltas_t = port.features_and_rpn(torch.from_numpy(images))
    assert fm_t.shape == (2, 8, 10, 512)
    assert logits_t.shape == (2, 8 * 10 * 9) and deltas_t.shape == (2, 8 * 10 * 9, 4)
    for got, want in ((fm_t, fm_j), (logits_t, logits_j), (deltas_t, deltas_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_generate_proposals_matches_jax_on_jax_rpn_outputs(models):
    jax_model, params, _ = models
    cfg = tiny_config(jax_config)
    images, image_hw = synthetic_images(1)
    _, logits, deltas = _jax_features_and_rpn(jax_model, params, images)
    grid = jax_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    centers = jnp.asarray(grid.centers)
    for pre, post in ((cfg.rpn.pre_nms_infer, cfg.rpn.post_nms_infer), (cfg.rpn.pre_nms_train, cfg.rpn.post_nms_train)):
        want = jax.vmap(
            lambda lg, dl, hw: jax_generate_proposals(
                lg, dl, centers, jax_frcnn.proposal_masks(cfg, grid, hw)[0], hw[0], hw[1], pre, post,
                cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side,
            )
        )(logits, deltas, jnp.asarray(image_hw))
        hw_t = torch.from_numpy(image_hw)
        mask = torch_frcnn.proposal_masks(tiny_config(torch_config), grid, hw_t)[0]
        got = generate_proposals(
            torch.from_numpy(np.array(logits)), torch.from_numpy(np.array(deltas)),
            torch.from_numpy(grid.centers), mask, hw_t[:, 0], hw_t[:, 1], pre, post,
            cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side,
        )
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
        assert got.valid.sum() > 0


def test_detect_rois_matches_jax_on_jax_proposals(models):
    jax_model, params, port = models
    images, image_hw = synthetic_images(2)
    fm, _, _ = _jax_features_and_rpn(jax_model, params, images)
    rng = np.random.default_rng(2)
    y1 = rng.uniform(-10, 100, (2, 64))
    x1 = rng.uniform(-10, 130, (2, 64))
    boxes = np.stack([y1, x1, y1 + rng.uniform(8, 60, (2, 64)), x1 + rng.uniform(8, 60, (2, 64))], -1)
    boxes = boxes.astype(np.float32)
    want_cls, want_box = jax_model.apply(
        {"params": params}, fm, jnp.asarray(boxes), jnp.asarray(image_hw), method=jax_frcnn.FasterRCNN.detect_rois
    )
    with torch.inference_mode():
        got_cls, got_box = port.detect_rois(
            torch.from_numpy(np.array(fm)), torch.from_numpy(boxes), torch.from_numpy(image_hw)
        )
    assert got_cls.shape == (2, 64, 21) and got_box.shape == (2, 64, 80)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_box.numpy(), np.asarray(want_box), rtol=0, atol=1e-4)


@pytest.mark.parametrize("score_threshold", [0.05, 0.0])
def test_predict_matches_jax(models, score_threshold):
    jax_model, params, port = models
    images, image_hw = synthetic_images(3)
    want = jax_frcnn.make_predict_fn(jax_model, CANVAS_H, CANVAS_W)(
        params, jnp.asarray(images), jnp.asarray(image_hw), score_threshold=score_threshold
    )
    got = torch_frcnn.make_predict_fn(port, CANVAS_H, CANVAS_W)(
        torch.from_numpy(images), torch.from_numpy(image_hw), score_threshold=score_threshold
    )
    assert got.boxes.shape == (2, 20, 64, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


def test_predict_matches_numpy_reference_oracle(models):
    """The port's predict against the NumPy port of the reference's predict
    (`tests/test_predict_golden.py`), fed the port's own proposals and head
    outputs."""
    _, _, port = models
    cfg = port.cfg
    images, image_hw = synthetic_images(5)
    imgs, hw = torch.from_numpy(images), torch.from_numpy(image_hw)
    det = torch_frcnn.make_predict_fn(port, CANVAS_H, CANVAS_W)(imgs, hw, score_threshold=0.05)
    grid = torch_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    with torch.inference_mode():
        fm, logits, deltas = port.features_and_rpn(imgs)
        props = generate_proposals(
            logits, deltas, torch.from_numpy(grid.centers), torch_frcnn.proposal_masks(cfg, grid, hw)[0],
            hw[:, 0], hw[:, 1], cfg.rpn.pre_nms_infer, cfg.rpn.post_nms_infer,
            cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side,
        )
        class_logits, box_deltas = port.detect_rois(fm, props.boxes, hw)
    assert det.valid.sum() > 0
    for i in range(2):
        want = reference_predict_numpy(
            props.boxes[i].numpy(), props.valid[i].numpy(), class_logits[i].numpy(), box_deltas[i].numpy(),
            image_hw[i], score_threshold=0.05, nms_iou=cfg.detector.test_nms_iou_threshold,
            num_classes=cfg.num_classes,
        )
        for cls in range(1, cfg.num_classes):
            v = det.valid[i, cls - 1].numpy() > 0
            want_boxes, want_scores = want[cls]
            assert v.sum() == len(want_scores), f"class {cls}"
            if len(want_scores):
                np.testing.assert_allclose(det.scores[i, cls - 1].numpy()[v], want_scores, rtol=1e-4)
                np.testing.assert_allclose(det.boxes[i, cls - 1].numpy()[v], want_boxes, rtol=1e-3, atol=1e-2)


def test_engine_predict_image_on_cpu(models):
    _, params, port = models
    engine = Engine(tiny_config(torch_config), seed=0, device="cpu")
    engine.set_params(from_jax_params(params))
    images, image_hw = synthetic_images(4, b=1)
    image = images[0, :120, :150].copy()
    images[:, 120:] = 0  # predict_image pads with zeros
    images[:, :, 150:] = 0
    want = engine.predict(images, image_hw, score_threshold=0.0)
    got = engine.predict_image(image_sample(image), score_threshold=0.0)
    assert sorted(got) == list(range(1, 21))
    for c, rows in got.items():
        live = want.valid[0, c - 1] > 0
        assert rows.shape == (int(live.sum()), 5)
        np.testing.assert_allclose(rows[:, 4], want.scores[0, c - 1][live].numpy(), rtol=0, atol=1e-6)


def image_sample(image, package=torch_voc):
    return package.Sample(image_u8=image, image_hw=image.shape[:2], gt_boxes=[], filepath="synthetic")


def test_engine_predict_image_matches_jax(models):
    """Both engines' predict_image on one Sample, with the same weights, give
    the same detections: the tolerances of test_predict_matches_jax."""
    _, params, _ = models
    image = synthetic_images(6, b=1)[0][0, :120, :150].copy()
    jax_eng = jax_engine.Engine(tiny_config(jax_config), seed=0, init_canvas=(CANVAS_H, CANVAS_W))
    jax_eng.set_params(params)
    port_eng = Engine(tiny_config(torch_config), device="cpu")
    port_eng.set_params(from_jax_params(params))
    want = jax_eng.predict_image(image_sample(image, jax_voc), score_threshold=0.0)
    got = port_eng.predict_image(image_sample(image), score_threshold=0.0)
    assert sorted(got) == sorted(want) == list(range(1, 21))
    assert sum(len(r) for r in got.values()) > 0
    for c in want:
        assert got[c].shape == want[c].shape, f"class {c}"
        np.testing.assert_allclose(got[c][:, :4], want[c][:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[c][:, 4], want[c][:, 4], rtol=0, atol=1e-5)


def test_engine_binds_its_arguments_in_the_reference_order():
    """Engine(model_cfg, train_cfg) binds as the JAX package's Engine does."""
    train_cfg = torch_config.TrainConfig(learning_rate=0.25, optimizer="adam")
    engine = Engine(tiny_config(torch_config), train_cfg, 3, "cpu")
    assert engine.train_cfg is train_cfg and engine.device.type == "cpu"
    assert engine.optimizer.lr_table.tolist() == [0.25] and engine.optimizer.kind == "adam"
    twin = Engine(tiny_config(torch_config), seed=3, device="cpu")
    for a, b in zip(engine.model.parameters(), twin.model.parameters()):
        assert torch.equal(a, b)


def test_engine_without_cuda_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tiny_config(torch_config))
