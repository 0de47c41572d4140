"""The port's ResNet backbones (`fasterrcnn_torch/models/resnet.py`) against
the JAX package's, on the same weights.

ResNet-50 runs at `tests/test_torch_predict.py`'s tiny config and 128x160
canvas (B=2; the ResNet widths are fixed, so this is the smallest faithful
model). The JAX model and its parameters are built once; the port loads them
through `utils/weights.from_jax_params`. On the CPU the JAX package takes
its XLA paths (blocked NMS, einsum RoI crop) and the port its plain
versions. ResNet-101 and ResNet-152 are built and checked (names, shapes,
block counts, optimizer labels) but not run.

Tolerances (f32 on both sides):
  * modules fed the same inputs: 1e-4 absolute and relative (the convs sum
    in another order in XLA than in PyTorch; measured ~2e-5 on values up to
    ~11);
  * proposals fed the same RPN outputs: as `tests/test_torch_predict.py`
    (valid masks equal, boxes 1e-4 px, scores 1e-6);
  * the whole predict: valid masks equal, scores 1e-5, boxes 1e-3 px;
  * losses 1e-4 relative; gradients per tensor in relative norm 3e-3, the
    bound of `tests/test_torch_train.py` (measured 2.0e-4);
  * weight import and the bridge copy, transpose and fold in the same numpy
    f32 arithmetic on both sides: bit for bit.

The exact-edge sample (ROADMAP §C, `tests/test_torch_roi.py`): under
ResNet's ceil rule the real feature grid of a 120x150 image on the 128x160
canvas is the whole 8x10 map, so a proposal clipped to the image puts its
last sample row or column exactly on the map's last cell. JAX's einsum crop,
which its CPU predict and train step run, keeps that sample on the map as
the port does; JAX's Pallas taps kernel computes the positions under jit
one ulp past it for some RoIs and drops the sample. Whole-predict and
train-step comparisons here are against the einsum path, and
`test_exact_edge_rois_are_the_only_ones_the_pallas_kernel_parts_from`
replays the Pallas kernel on the predict's own map and proposals.
"""

import dataclasses
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu import engine as jax_engine
from fasterrcnn_tpu.models import faster_rcnn as jax_frcnn
from fasterrcnn_tpu.models import resnet as jax_resnet
from fasterrcnn_tpu.models.rpn import generate_proposals as jax_generate_proposals
from fasterrcnn_tpu.ops.pallas import roi_pallas
from fasterrcnn_tpu.utils import checkpoint as jax_ckpt
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch.engine import make_optimizer
from fasterrcnn_torch.models import faster_rcnn as torch_frcnn
from fasterrcnn_torch.models import resnet as torch_resnet
from fasterrcnn_torch.models.rpn import generate_proposals
from fasterrcnn_torch.ops import roi as torch_roi
from fasterrcnn_torch.utils import checkpoint
from fasterrcnn_torch.utils.weights import _flatten, from_jax_params, to_jax_params
from chip_smoke import torchvision_resnet_state
from tests.test_torch_predict import CANVAS_H, CANVAS_W, synthetic_images, tiny_config
from tests.test_torch_roi import jax_positions
from tests.test_torch_train import (
    B, G, every_box_config, flat_labels, jax_batch, jax_draws, numpy_batch, rel_norm, small_image_batch, torch_batch,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def resnet_config(cfg_module, backbone="resnet50", train_all=False):
    return dataclasses.replace(tiny_config(cfg_module), backbone=backbone, train_all=train_all)


def jax_model_and_params(train_all=False):
    jax_model = jax_frcnn.FasterRCNN(cfg=resnet_config(jax_config, train_all=train_all))
    return jax_model, jax_frcnn.init_params(jax_model, CANVAS_H, CANVAS_W, seed=0)


def port_with(params, train_all=False):
    port = torch_frcnn.FasterRCNN(resnet_config(torch_config, train_all=train_all))
    port.load_state_dict(from_jax_params(params))
    return port.eval()


@pytest.fixture(scope="module")
def models():
    jax_model, params = jax_model_and_params()
    return jax_model, params, port_with(params)


@pytest.fixture(scope="module")
def train_all_params():
    """JAX's from-scratch ResNet-50 model and its initial parameters, made
    once for the tests that take them."""
    return jax_model_and_params(train_all=True)


def flat(tree):
    return {"/".join(path): value for path, value in _flatten(tree)}


def test_weight_bridge_round_trips_a_resnet50_tree_bit_for_bit(models):
    _, params, port = models
    state = from_jax_params(params)
    assert set(state) == set(port.state_dict())
    assert state["feature_extractor.layer1.block0.bn3.scale"].shape == (256,)
    want = flat(params)
    got = flat(to_jax_params(state))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    again = from_jax_params(to_jax_params(port.state_dict()))
    for key, value in port.state_dict().items():
        assert torch.equal(again[key], value), key


def test_feature_extractor_and_head_match_jax(models):
    """Each module alone, on the same f32 inputs: the extractor on a
    normalized 128x160 batch, the head on (P, 7, 7, 1024) pooled RoIs."""
    _, params, port = models
    rng = np.random.default_rng(0)
    blocks = jax_resnet.ARCHITECTURES["resnet50"]
    x = rng.normal(size=(2, CANVAS_H, CANVAS_W, 3)).astype(np.float32)
    want = jax_resnet.ResNetFeatureExtractor(blocks=blocks).apply({"params": params["feature_extractor"]}, x)
    with torch.inference_mode():
        got = port.feature_extractor(torch.from_numpy(x))
    assert got.shape == (2, 8, 10, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    rois = np.maximum(rng.normal(size=(6, 7, 7, 1024)), 0.0).astype(np.float32)
    want = jax_resnet.ResNetHead(blocks=blocks).apply({"params": params["roi_head"]}, rois)
    with torch.inference_mode():
        got = port.roi_head(torch.from_numpy(rois))
    assert got.shape == (6, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_frozen_batchnorm_rounds_as_jax_in_bf16():
    """The stem's frozen BN (the module's own forward): x * scale + bias in
    the input's type, rounded after the product and after the sum, as flax
    computes it op by op: bit for bit. A bottleneck's (`Bottleneck.forward`,
    through `affine_f32`): the chain after a conv (BN and ReLU; after conv3
    the shortcut's BN, the residual add and the ReLU) computed in f32 on the
    bf16 values and rounded to bf16 once, where one XLA fusion rounds: bit
    for bit JAX's FrozenBatchNorm and ReLU in f32 on the same values,
    rounded to bf16 once."""
    rng = np.random.default_rng(1)
    x, r = (rng.normal(size=(2, 4, 5, 64)).astype(np.float32) for _ in range(2))
    (scale, bias), (scale2, bias2) = ((rng.normal(size=64).astype(np.float32) for _ in range(2)) for _ in range(2))
    want = jax_resnet.FrozenBatchNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jnp.bfloat16))
    bn, bn2 = torch_resnet.FrozenBatchNorm(64), torch_resnet.FrozenBatchNorm(64)
    bn.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    bn2.load_state_dict({"scale": torch.from_numpy(scale2), "bias": torch.from_numpy(bias2)})

    def nchw(a):
        return torch.from_numpy(a).bfloat16().permute(0, 3, 1, 2)

    def nhwc(t):
        assert t.dtype == torch.bfloat16
        return t.permute(0, 2, 3, 1).float().numpy()

    with torch.inference_mode():
        got = nhwc(bn(nchw(x)))
        got_chain = nhwc(torch.relu(bn.affine_f32(nchw(x))).bfloat16())
        got_tail = nhwc(torch.relu(bn.affine_f32(nchw(x)) + bn2.affine_f32(nchw(r))).bfloat16())
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))

    def jax_f32(a, sc, bi):
        a16 = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # the bf16 values the port sees
        return jax_resnet.FrozenBatchNorm().apply({"params": {"scale": sc, "bias": bi}}, jnp.asarray(a16))

    want_chain = jnp.maximum(jax_f32(x, scale, bias), 0.0).astype(jnp.bfloat16)
    want_tail = jnp.maximum(jax_f32(x, scale, bias) + jax_f32(r, scale2, bias2), 0.0).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got_chain, np.asarray(want_chain, np.float32))
    np.testing.assert_array_equal(got_tail, np.asarray(want_tail, np.float32))
    # The two rules part: rounding once is not rounding op by op.
    assert not np.array_equal(got_chain, np.maximum(got, 0.0))


def jax_features_and_rpn(jax_model, params, images):
    return jax_model.apply({"params": params}, jnp.asarray(images), method=jax_frcnn.FasterRCNN.features_and_rpn)


def test_features_and_rpn_match_jax(models):
    jax_model, params, port = models
    images, _ = synthetic_images(0)
    want = jax_features_and_rpn(jax_model, params, images)
    with torch.inference_mode():
        got = port.features_and_rpn(torch.from_numpy(images))
    assert got[0].shape == (2, 8, 10, 1024)
    assert got[1].shape == (2, 8 * 10 * 9) and got[2].shape == (2, 8 * 10 * 9, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_proposals_match_jax_on_jax_rpn_outputs(models):
    """Infer and train caps, with ResNet's ceil rule in the proposal masks."""
    jax_model, params, port = models
    cfg = jax_model.cfg
    images, image_hw = synthetic_images(1)
    image_hw[1] = [112.0, 136.0]  # real grid 7x9 of the 8x10 map
    _, logits, deltas = jax_features_and_rpn(jax_model, params, images)
    grid = jax_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    centers = jnp.asarray(grid.centers)
    hw_t = torch.from_numpy(image_hw)
    for pre, post in ((cfg.rpn.pre_nms_infer, cfg.rpn.post_nms_infer), (cfg.rpn.pre_nms_train, cfg.rpn.post_nms_train)):
        want = jax.vmap(
            lambda lg, dl, hw: jax_generate_proposals(
                lg, dl, centers, jax_frcnn.proposal_masks(cfg, grid, hw)[0], hw[0], hw[1], pre, post,
                cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side,
            )
        )(logits, deltas, jnp.asarray(image_hw))
        mask = torch_frcnn.proposal_masks(port.cfg, grid, hw_t)[0]
        got = generate_proposals(
            torch.from_numpy(np.array(logits)), torch.from_numpy(np.array(deltas)), torch.from_numpy(grid.centers),
            mask, hw_t[:, 0], hw_t[:, 1], pre, post, cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side,
        )
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
        assert got.valid.sum() > 0


def test_detect_rois_matches_jax_on_jax_features(models):
    """The RoI crop at C=1024, layer4 and the heads on JAX's feature map,
    with boxes reaching past the images' edges."""
    jax_model, params, port = models
    images, image_hw = synthetic_images(2)
    fm, _, _ = jax_features_and_rpn(jax_model, params, images)
    rng = np.random.default_rng(2)
    y1, x1 = rng.uniform(-10, 100, (2, 64)), rng.uniform(-10, 130, (2, 64))
    boxes = np.stack([y1, x1, y1 + rng.uniform(8, 60, (2, 64)), x1 + rng.uniform(8, 60, (2, 64))], -1)
    boxes = boxes.astype(np.float32)
    want = jax_model.apply(
        {"params": params}, fm, jnp.asarray(boxes), jnp.asarray(image_hw), method=jax_frcnn.FasterRCNN.detect_rois
    )
    with torch.inference_mode():
        got = port.detect_rois(torch.from_numpy(np.array(fm)), torch.from_numpy(boxes), torch.from_numpy(image_hw))
    assert got[0].shape == (2, 64, 21) and got[1].shape == (2, 64, 80)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def exact_edge_rois(port, images, image_hw):
    """The predict path's feature map, proposals and norm, and the valid
    proposals whose last sample row or column lies exactly on the map's last
    cell (where JAX's jitted Pallas positions may fall one ulp past it)."""
    grid = torch_frcnn.anchor_grid_for(port.cfg, CANVAS_H, CANVAS_W)
    hw = torch.from_numpy(image_hw)
    with torch.inference_mode():
        fm, props = torch_frcnn.infer_proposals(port, grid, torch.from_numpy(grid.centers), torch.from_numpy(images), hw)
    norm = port.roi_norm(hw)
    ys, xs = torch_roi._sample_positions(props.boxes, norm)
    h, w = fm.shape[1:3]
    edge = ((ys[..., -1] == h - 1) | (xs[..., -1] == w - 1)) & (props.valid > 0)
    return fm, props, norm, edge


@pytest.mark.parametrize("score_threshold", [0.05, 0.0])
def test_predict_matches_jax(models, score_threshold):
    """The whole predict. Its proposals include exact-edge RoIs, which JAX's
    einsum crop samples on the map as the port does: they are held to the
    same tolerance as every other output."""
    jax_model, params, port = models
    images, image_hw = synthetic_images(3)
    want = jax_frcnn.make_predict_fn(jax_model, CANVAS_H, CANVAS_W)(
        params, jnp.asarray(images), jnp.asarray(image_hw), score_threshold=score_threshold
    )
    got = torch_frcnn.make_predict_fn(port, CANVAS_H, CANVAS_W)(
        torch.from_numpy(images), torch.from_numpy(image_hw), score_threshold=score_threshold
    )
    assert got.boxes.shape == (2, 20, 64, 4)
    assert exact_edge_rois(port, images, image_hw)[3].sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


def test_exact_edge_rois_are_the_only_ones_the_pallas_kernel_parts_from(models, monkeypatch):
    """JAX's Pallas taps kernel (interpret mode, jitted) on the predict's
    own (2, 8, 10, 1024) map (values up to 11.1) and 64 proposals an image:
    it parts from the port's crop only on exact-edge RoIs (2 of the 20 here,
    by 2.05 and 1.45), and on none once the port takes the kernel's jitted
    sample positions (`tests/test_torch_roi.py`'s replay). Tolerance 1e-5:
    elsewhere the two sample positions differ by an ulp at most, and the
    pooled values by at most 3.8e-6 (measured)."""
    _, _, port = models
    images, image_hw = synthetic_images(3)
    fm, props, norm, edge = exact_edge_rois(port, images, image_hw)
    args = (fm.numpy(), props.boxes.numpy(), norm.numpy())
    pallas = np.asarray(jax.jit(lambda *a: roi_pallas.roi_pool_taps_pallas(*a, interpret=True, chunk=1))(*args))
    gap = np.abs(torch_roi.roi_pool_features(fm, props.boxes, norm).numpy() - pallas).max(axis=(2, 3, 4))
    live = props.valid.numpy() > 0
    parted = (gap > 1e-5) & live
    assert parted.any() and not (parted & ~edge.numpy()).any()

    def positions(rois, norm):
        corners = np.asarray(roi_pallas._rois_to_feature_grid(jnp.asarray(rois.numpy()), jnp.asarray(norm.numpy())))
        b, p = corners.shape[:2]
        c = corners.reshape(b * p, 4)
        ys, xs = (np.array(jax_positions(c[:, lo], c[:, hi]).reshape(b, p, 14)) for lo, hi in ((0, 2), (1, 3)))
        return torch.from_numpy(ys), torch.from_numpy(xs)

    monkeypatch.setattr(torch_roi, "_sample_positions", positions)
    replay = torch_roi.roi_pool_features(fm, props.boxes, norm).numpy()
    assert np.abs(replay - pallas).max(axis=(2, 3, 4))[live].max() <= 1e-5


@pytest.mark.parametrize("train_all", [False, True], ids=["frozen", "train_all"])
def test_compute_losses_and_gradients_match_jax(models, train_all_params, train_all):
    """One train step's losses and every gradient, on JAX's draws. Frozen
    parameters get no gradient in the port; in JAX those behind the cut
    after layer1 get zeros, and the other frozen ones (BN affines of layers
    2-4) a gradient the optimizer discards."""
    if train_all:
        jax_model, params = train_all_params
        port = port_with(params, train_all=True)
    else:
        jax_model, params, _ = models
        port = port_with(params)
    cfg = jax_model.cfg
    grid = jax_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    nb = numpy_batch(2)
    rng = jax.random.key(5)
    jb = jax_batch(nb)
    (_, want), grads = jax.jit(
        jax.value_and_grad(lambda p: jax_frcnn.compute_losses(jax_model, p, jb, rng, cfg, grid), has_aux=True)
    )(params)
    draws = jax_draws(rng, B, grid.total, cfg.rpn.post_nms_train + G)
    port.train()
    total, got = torch_frcnn.compute_losses(port, torch_batch(nb), grid, draws=draws)
    for name in torch_frcnn.Losses._fields:
        value = getattr(got, name).item()
        np.testing.assert_allclose(value, float(getattr(want, name)), rtol=1e-4, err_msg=name)
        assert value > 0, name
    total.backward()
    want_grads = from_jax_params(jax.tree.map(np.asarray, grads))
    behind_cut = re.compile(r"feature_extractor\.(conv1|bn1|layer1)\.")
    assert set(want_grads) == set(dict(port.named_parameters()))
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert not train_all and p.grad is None, name
            if behind_cut.match(name):
                np.testing.assert_array_equal(want_grads[name].numpy(), 0.0, err_msg=name)
            continue
        err = rel_norm(p.grad.numpy(), want_grads[name].numpy())
        assert err <= 3e-3, (name, err)


def abstract_params(backbone, train_all=False):
    jax_model = jax_frcnn.FasterRCNN(cfg=resnet_config(jax_config, backbone, train_all))
    return jax.eval_shape(lambda: jax_frcnn.init_params(jax_model, CANVAS_H, CANVAS_W, seed=0))


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101", "resnet152"])
def test_resnets_have_jax_names_shapes_blocks_and_labels(backbone):
    """Built, not run: the port's parameters are JAX's, name for name and
    shape for shape through the bridge; each stage has the architecture's
    bottleneck count; the optimizer's frozen, decayed and plain groups are
    JAX's, with and without train_all."""
    port = torch_frcnn.FasterRCNN(resnet_config(torch_config, backbone))
    leaves = jax.tree_util.tree_flatten_with_path(abstract_params(backbone))[0]
    want = {"/".join(k.key for k in path): leaf.shape for path, leaf in leaves}
    got = {k: v.shape for k, v in flat(to_jax_params(port.state_dict())).items()}
    assert got == want
    blocks = torch_resnet.ARCHITECTURES[backbone]
    stages = (port.feature_extractor.layer1, port.feature_extractor.layer2, port.feature_extractor.layer3,
              port.roi_head.layer4)
    assert tuple(len(s) for s in stages) == blocks
    for train_all in (False, True):
        cfg = resnet_config(torch_config, backbone, train_all)
        model = port if not train_all else torch_frcnn.FasterRCNN(cfg)
        _, labels = make_optimizer(cfg, torch_config.TrainConfig(), model)
        _, jax_labels = jax_engine.make_optimizer(
            resnet_config(jax_config, backbone, train_all), jax_config.TrainConfig(), abstract_params(backbone, train_all)
        )
        assert labels == flat_labels(jax_labels)
        frozen = {n for n, g in labels.items() if g == "frozen"}
        assert frozen == ({n for n, p in model.named_parameters() if not p.requires_grad})
        assert bool(frozen) != train_all
    assert labels["feature_extractor.layer2.block0.bn1.scale"] == "decayed"
    assert labels["feature_extractor.layer2.block0.bn1.bias"] == "plain"


def test_bn3_starts_closed_only_under_train_all():
    """init_params: every frozen BN is the identity, except each
    bottleneck's bn3 under train_all, whose scale is 0 (16 in ResNet-50);
    the shortcut's BN stays open in both modes."""
    for train_all in (False, True):
        model = torch_frcnn.FasterRCNN(resnet_config(torch_config, train_all=train_all))
        torch_frcnn.init_params(model, seed=0)
        bns = {n: m for n, m in model.named_modules() if isinstance(m, torch_resnet.FrozenBatchNorm)}
        assert sum(n.endswith(".bn3") for n in bns) == 16
        for name, bn in bns.items():
            closed = train_all and name.endswith(".bn3")
            assert bool((bn.scale == (0.0 if closed else 1.0)).all()), name
            assert bool((bn.bias == 0.0).all()), name


def test_torchvision_resnet50_loads_as_in_jax(models, tmp_path):
    """Both packages load the file into the same starting weights (the JAX
    model's), leaf for leaf and bit for bit: the folded BNs included. The
    RPN and the detector heads keep their values. A malformed file raises
    the importer's ValueError."""
    _, params, port = models
    state = torchvision_resnet_state(np.random.default_rng(7), "resnet50")
    path = str(tmp_path / "resnet50.pth")
    torch.save(state, path)
    want = flat(jax_ckpt.load(jax.tree.map(np.asarray, params), path))
    loaded = checkpoint.load(port.state_dict(), path)
    assert set(loaded) == set(port.state_dict())
    got = flat(to_jax_params(loaded))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert not np.array_equal(got["feature_extractor/bn1/scale"], np.asarray(params["feature_extractor"]["bn1"]["scale"]))
    np.testing.assert_array_equal(got["rpn_head/conv/kernel"], np.asarray(params["rpn_head"]["conv"]["kernel"]))

    del state["layer3.2.bn2.running_var"]
    torch.save(state, path)
    with pytest.raises(ValueError, match="layer3.2.bn2.*running_var"):
        checkpoint.load(port.state_dict(), path)


def test_jax_msgpack_of_a_resnet_loads_in_the_port(models, tmp_path):
    """The JAX package's own weight file of a ResNet-50 model (its
    `save_weights`, flax msgpack), perturbed so no leaf is the port's
    current value: the port loads every leaf bit for bit; the port's own
    `.pth` of the result round-trips through `load`."""
    _, params, port = models
    rng = np.random.default_rng(4)
    other = jax.tree.map(lambda v: np.asarray(v) + rng.random(np.shape(v), dtype=np.float32), params)
    path = str(tmp_path / "resnet50.msgpack")
    jax_ckpt.save_weights(path, other)
    loaded = checkpoint.load(port.state_dict(), path)
    want = from_jax_params(other)
    assert set(loaded) == set(want)
    for key, value in want.items():
        assert torch.equal(loaded[key], value), key
    own = str(tmp_path / "resnet50.pth")
    checkpoint.save_weights(own, loaded)
    again = checkpoint.load(port.state_dict(), own)
    for key, value in loaded.items():
        assert torch.equal(again[key], value), key
    os.remove(own)


def test_three_train_all_steps_with_the_resnet101_proxy_optimizer_match_jax(train_all_params):
    """Three steps of ResNet-50 in from-scratch mode with the ResNet-101
    proxy's optimizer (`fasterrcnn_torch/scripts/prodshape_proxy.py`'s
    recipe: Adam, learning rate 1e-3, warmup then cosine decay, the CLI's
    weight decay 5e-4, which the "decayed" group applies to the frozen-BN
    scales too), on JAX's draws, with every anchor and proposal trained
    (`every_box_config`).

    The whole steps: the port's losses within 1e-3 relative of JAX's at each
    step. The optimizer: on JAX's own trajectory, fed JAX's gradients, the
    port's new values of each tensor equal optax's up to one f32 step each
    (the rounding of p + update), and the excess over that step is within
    2e-5 of the update in norm: optax evaluates Adam's bias correction
    1 - 0.999^t in f32, torch.optim in double, which scales every update of
    step t = 2 by 1 - 9.98e-6 (measured, every tensor alike).
    (The whole steps' updates are not compared tensor by tensor: a bias
    whose first non-zero gradient comes at step 3, behind a bn3 scale that
    starts at 0, has components near Adam's eps of 1e-8, where the two
    packages' last-bit gradient differences move the update by up to 2.5x;
    a 2e-3 bound holds for every other tensor.)"""
    train_cfg = dict(optimizer="adam", learning_rate=1e-3, weight_decay=5e-4, lr_schedule="cosine",
                     warmup_steps=1, total_steps=4)
    cfg = dataclasses.replace(every_box_config(jax_config), backbone="resnet50", train_all=True)
    jax_model = jax_frcnn.FasterRCNN(cfg=cfg)
    # The tiny config's initial parameters: the caps make no parameter.
    params = train_all_params[1]
    grid = jax_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    batches = [small_image_batch(10 + i) for i in range(3)]
    rngs = [jax.random.key(20 + i) for i in range(3)]
    tx, jax_labels = jax_engine.make_optimizer(cfg, jax_config.TrainConfig(**train_cfg), params)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b, r: jax_frcnn.compute_losses(jax_model, p, b, r, cfg, grid), has_aux=True))
    n_props = cfg.rpn.post_nms_train + G

    def port_and_optimizer():
        port = torch_frcnn.FasterRCNN(dataclasses.replace(every_box_config(torch_config), backbone="resnet50",
                                                          train_all=True))
        port.load_state_dict(from_jax_params(params))
        return port, make_optimizer(port.cfg, torch_config.TrainConfig(**train_cfg), port)

    port, (optimizer, labels) = port_and_optimizer()
    assert labels == flat_labels(jax_labels) and "frozen" not in labels.values()
    assert labels["feature_extractor.layer2.block0.bn3.scale"] == "decayed"
    step = torch_frcnn.make_train_step(port, optimizer, CANVAS_H, CANVAS_W)
    forced, (forced_opt, _) = port_and_optimizer()
    p, state = params, tx.init(params)
    for nb, rng in zip(batches, rngs):
        draws = jax_draws(rng, B, grid.total, n_props)
        # JAX's step, as its train step takes it, and its losses.
        (_, want), grads = value_and_grad(p, jax_batch(nb), rng)
        updates, state = tx.update(grads, state, p)
        p_next = jax.tree.map(lambda a, u: a + u, p, updates)
        # The port's own step from its own weights.
        got = step(torch_batch(nb), draws=draws)
        np.testing.assert_allclose(torch.stack(list(got)).numpy(), np.stack([np.asarray(v) for v in want]), rtol=1e-3)
        # The port's optimizer on JAX's weights and gradients.
        forced.load_state_dict(from_jax_params(jax.tree.map(np.asarray, p)))
        jax_grads = from_jax_params(jax.tree.map(np.asarray, grads))
        before = {n: t.detach().clone() for n, t in forced.named_parameters()}
        for name, t in forced.named_parameters():
            t.grad = jax_grads[name].clone()
        forced_opt.step()
        want_params = from_jax_params(jax.tree.map(np.asarray, p_next))
        for name, t in forced.named_parameters():
            new, want_new = t.detach().numpy(), want_params[name].numpy()
            excess = np.maximum(np.abs(new - want_new) - np.spacing(np.abs(want_new)), 0.0)
            assert np.linalg.norm(excess) <= 2e-5 * np.linalg.norm(want_new - before[name].numpy()), name
        p = p_next


def test_a_shallower_torchvision_resnet_loads_in_part_in_jax_and_raises_in_the_port(tmp_path):
    """A torchvision ResNet-50 file given to a ResNet-101 model: JAX's
    `import_stage` loads layer3's 6 bottlenecks into blocks 0-5, leaves
    blocks 6-22 as they were and prints "Loaded"; the port refuses the file
    (layer3 holds 6 bottlenecks, the model 23). The port keeps its refusal."""
    state = torchvision_resnet_state(np.random.default_rng(13), "resnet50")
    path = str(tmp_path / "resnet50.pth")
    torch.save(state, path)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract_params("resnet101"))
    loaded = jax_ckpt.load(zeros, path)
    layer3 = loaded["feature_extractor"]["layer3"]
    np.testing.assert_array_equal(layer3["block5"]["conv1"]["kernel"],
                                  state["layer3.5.conv1.weight"].numpy().transpose(2, 3, 1, 0))
    assert all(not np.asarray(layer3[f"block{i}"]["conv1"]["kernel"]).any() for i in range(6, 23))
    port = torch_frcnn.FasterRCNN(resnet_config(torch_config, "resnet101"))
    with pytest.raises(ValueError, match="layer3 holds 6 bottlenecks, the model 23"):
        checkpoint.load(port.state_dict(), path)
