"""Exact RoIPool (`roi_mode="exact_pool"`, `--custom-roi-pool`) in the port
against the JAX package's, on the CPU.

`fasterrcnn_torch/ops/roi.roi_pool_exact` is the counterpart of
`fasterrcnn_tpu/ops/roi.roi_pool_exact` (XLA; no Pallas kernel sits behind
it). The model tests use `tests/test_torch_predict.py`'s tiny config
(full-width VGG-16 or ResNet-50 on the 128x160 canvas, B=2), one JAX model
and parameter tree per backbone built once for the module, loaded into the
port through `utils/weights.from_jax_params`.

Tolerances:
  * pooled values, f32 and bf16: identical (gathers and maxes do not round),
    also on maps holding inf and NaN, boxes past the map, half-point
    corners and empty bins;
  * the map cotangent in f32: within 1e-6 of the largest |JAX value|
    (measured: identical);
  * in bf16, where no sum has more than two terms: identical to JAX (the
    tie splits). Where more terms meet, JAX on the CPU rounds each partial
    sum to bf16 and the port sums in f32 and rounds once; for a positive
    cotangent the port then lies within four bf16 roundings (4 * 2^-9,
    relative) of JAX's f32 VJP of the same bf16 values, elementwise;
  * RoI chunking: values and cotangents identical for any chunk;
  * the whole predict: valid masks equal, boxes 1e-3 px, scores 1e-5 (as
    `tests/test_torch_predict.py`);
  * one train step: losses 1e-4 relative, each gradient tensor 3e-3 in
    relative norm (as `tests/test_torch_train.py`; the backbones differ by
    1e-4, which may move a bin's max to another cell).
"""

import dataclasses
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu.models import faster_rcnn as jax_frcnn
from fasterrcnn_tpu.ops import roi as jax_roi
from fasterrcnn_torch import __main__ as cli
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch.models import faster_rcnn as torch_frcnn
from fasterrcnn_torch.ops import roi as torch_roi
from fasterrcnn_torch.utils import checkpoint
from fasterrcnn_torch.utils.weights import from_jax_params
from tests.test_torch_checkpoint import reference_state
from tests.test_torch_predict import CANVAS_H, CANVAS_W, synthetic_images, tiny_config
from tests.test_torch_train import B, G, jax_batch, jax_draws, numpy_batch, rel_norm, torch_batch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def jax_pool(fm, rois, dtype, output_size=7):
    out = jax_roi.roi_pool_exact(jnp.asarray(fm).astype(dtype), jnp.asarray(rois), 1.0 / 16.0, output_size)
    return np.asarray(out.astype(jnp.float32))


def jax_vjp(fm, rois, g, dtype, output_size=7):
    _, vjp = jax.vjp(lambda f: jax_roi.roi_pool_exact(f, jnp.asarray(rois), 1.0 / 16.0, output_size),
                     jnp.asarray(fm).astype(dtype))
    return np.asarray(vjp(jnp.asarray(g).astype(dtype))[0].astype(jnp.float32))


def port_vjp(fm, rois, g, dtype, output_size=7):
    leaf = torch.from_numpy(fm).to(DTYPES[dtype]).requires_grad_()
    out = torch_roi.roi_pool_exact(leaf, torch.from_numpy(rois), 1.0 / 16.0, output_size)
    out.backward(torch.from_numpy(g).to(DTYPES[dtype]))
    return out.detach(), leaf.grad


def feature_map(rng, kind, shape=(24, 32, 8)):
    """Seeded normal values; "ties": small integers, so bins tie often;
    "nonfinite": normal values with inf, -inf and NaN cells."""
    if kind == "ties":
        return rng.integers(0, 3, shape).astype(np.float32)
    fm = rng.normal(size=shape).astype(np.float32)
    if kind == "nonfinite":
        flat = fm.reshape(-1, shape[-1])
        for value, count in ((np.inf, 12), (-np.inf, 12), (np.nan, 12)):
            flat[rng.integers(0, flat.shape[0], count), rng.integers(0, shape[-1], count)] = value
    return fm


def boxes(rng, n, h=24, w=32):
    """Image-space boxes on an (h, w) map at 1/16: drawn ones reaching past
    the map on every side, then fixed ones: half-point corners (8/16 = 0.5
    goes up to 1), inverted and one-cell boxes (span 1: every bin the same
    cell), boxes wholly past the map (every bin empty) and the whole map."""
    y1, x1 = rng.uniform(-40, 16 * h - 40, n), rng.uniform(-40, 16 * w - 40, n)
    drawn = np.stack([y1, x1, y1 + rng.uniform(0, 16 * h, n), x1 + rng.uniform(0, 16 * w, n)], -1)
    fixed = [
        [8.0, 8.0, 150.0, 150.0],
        [24.0, 40.0, 232.0, 8.0 + 16 * 20],
        [100.0, 100.0, 90.0, 95.0],
        [40.0, 40.0, 40.0, 40.0],
        [16.0 * h + 100, 0.0, 16.0 * h + 300, 200.0],
        [-400.0, -400.0, -100.0, -100.0],
        [0.0, 0.0, 16.0 * h - 1, 16.0 * w - 1],
    ]
    return np.concatenate([drawn, np.asarray(fixed)]).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "nonfinite"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_values_match_jax(dtype, kind):
    rng = np.random.default_rng(1)
    fm, rois = feature_map(rng, kind), boxes(rng, 40)
    want = jax_pool(fm, rois, dtype)
    got = torch_roi.roi_pool_exact(torch.from_numpy(fm).to(DTYPES[dtype]), torch.from_numpy(rois))
    assert got.dtype == DTYPES[dtype] and got.shape == (rois.shape[0], 7, 7, 8)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.isfinite(want).all() and (want[-3:-1] == 0).all()  # non-finite and empty bins give 0


def test_half_point_corners_round_up():
    """x1 = 8 at 1/16 is 0.5, which C++ round() (half away from zero) takes
    to 1; torch.round would take it to 0."""
    rois = torch.tensor([[8.0, 24.0, 150.0, 150.0]])
    ys, _, xs, _ = torch_roi.exact_bins(rois, 1.0 / 16.0, 7, 20, 20)
    assert int(ys[0, 0]) == 1 and int(xs[0, 0]) == 2
    assert int(torch.round(torch.tensor(0.5))) == 0


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_f32_vjp_matches_jax(kind):
    rng = np.random.default_rng(2)
    fm, rois = feature_map(rng, kind), boxes(rng, 40)
    g = rng.normal(size=(rois.shape[0], 7, 7, 8)).astype(np.float32)
    want = jax_vjp(fm, rois, g, "float32")
    _, got = port_vjp(fm, rois, g, "float32")
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_bin_splits_rows_first_as_jax(dtype):
    """One 2x2 bin [[1, 1], [1, 0]] and an upstream cotangent of 1: JAX
    splits rows first, then columns: [[0.25, 0.5], [0.25, 0]], where a
    one-stage split would give 1/3 each."""
    fm = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)[:, :, None]
    rois = np.array([[0.0, 0.0, 16.0, 16.0]], np.float32)
    g = np.ones((1, 1, 1, 1), np.float32)
    want = jax_vjp(fm, rois, g, dtype, output_size=1)
    _, got = port_vjp(fm, rois, g, dtype, output_size=1)
    np.testing.assert_array_equal(want[..., 0], [[0.25, 0.5], [0.25, 0.0]])
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_vjp_splits_ties_as_jax():
    """Four RoIs tiling a tie-heavy map, spans of 12 and 16 cells: no cell
    and no row maximum sums more than two shares, so the order of the sums
    does not matter and the bf16 cotangents are JAX's, bit for bit."""
    rng = np.random.default_rng(3)
    fm = feature_map(rng, "ties")
    rois = np.array([[0, 0, 176, 240], [192, 0, 368, 240], [0, 256, 176, 496], [192, 256, 368, 496]], np.float32)
    g = rng.normal(size=(4, 7, 7, 8)).astype(np.float32)
    want = jax_vjp(fm, rois, g, "bfloat16")
    _, got = port_vjp(fm, rois, g, "bfloat16")
    assert got.dtype == torch.bfloat16 and (want != 0).sum() > 100
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_bf16_vjp_within_four_roundings_of_the_f32_vjp(kind):
    """Overlapping RoIs: every split and sum of a positive cotangent, once
    rounded each (two splits, two sums), keeps the port's bf16 cotangent
    within 4 * 2^-9 of JAX's f32 VJP of the same bf16 values, relative to
    each value, and zero exactly where that is zero."""
    rng = np.random.default_rng(4)
    fm = torch.from_numpy(feature_map(rng, kind)).bfloat16().float().numpy()
    rois = boxes(rng, 40)
    g = torch.from_numpy(rng.uniform(0.1, 1.0, (rois.shape[0], 7, 7, 8)).astype(np.float32)).bfloat16().float().numpy()
    want = jax_vjp(fm, rois, g, "float32")
    _, got = port_vjp(fm, rois, g, "bfloat16")
    got = got.float().numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    live = want != 0
    assert np.all(np.abs(got - want)[live] <= 4 * 2.0**-9 * np.abs(want)[live])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunking_is_invisible(dtype, monkeypatch):
    """A batch of two maps: values and cotangents are the same bits for
    chunks of 1 and 3 RoIs and all of them, and the batched op is the
    per-image op."""
    rng = np.random.default_rng(5)
    fm = np.stack([feature_map(rng, "ties"), feature_map(rng, "normal")])
    rois = np.stack([boxes(rng, 20), boxes(rng, 20)])
    g = rng.normal(size=(2, rois.shape[1], 7, 7, 8)).astype(np.float32)
    plan = torch_roi._exact_plan
    runs = []
    for chunk in (1, 3, rois.shape[1]):
        monkeypatch.setattr(torch_roi, "_exact_plan", lambda *a, chunk=chunk: (*plan(*a)[:3], chunk))
        runs.append(port_vjp(fm, rois, g, dtype))
    for out, grad in runs[:2]:
        assert torch.equal(out, runs[2][0]) and torch.equal(grad, runs[2][1])
    for i in range(2):
        single = torch_roi.roi_pool_exact(torch.from_numpy(fm[i]).to(DTYPES[dtype]), torch.from_numpy(rois[i]))
        assert torch.equal(single, runs[2][0][i])


@pytest.mark.parametrize("rois_per_image,channels", [(300, 1024), (128, 1024), (300, 512), (128, 512)])
def test_chunks_gather_the_widest_bin_only(rois_per_image, channels):
    """The row gather spans the widest bin's rows, not the map: on boxes
    inside a (38, 50) map at most ceil(38 / 7) + 1 = 7 rows and 9 columns;
    and a chunk keeps (B, chunk, 7, rows, W, C) within the element budget
    and under a quarter of P*H*W*C, at B=4 and the predict (300) and train
    (128) RoI counts of ResNet (C=1024) and VGG-16 (C=512)."""
    rng = np.random.default_rng(6)
    p = rois_per_image
    fm = torch.zeros((4, 38, 50, channels))
    y1, x1 = rng.uniform(0, 500, (4, p)), rng.uniform(0, 700, (4, p))
    rois = np.stack([y1, x1, np.minimum(y1 + rng.uniform(0, 600, (4, p)), 599),
                     np.minimum(x1 + rng.uniform(0, 800, (4, p)), 799)], -1)
    _, rows, cols, chunk = torch_roi._exact_plan(fm, torch.from_numpy(rois.astype(np.float32)), 1.0 / 16.0, 7)
    assert rows <= 7 and cols <= 9
    gather = 4 * chunk * 7 * rows * 50 * channels
    assert gather <= torch_roi.EXACT_CHUNK_ELEMENTS and 4 * gather <= p * 38 * 50 * channels


def test_other_roi_modes_raise():
    with pytest.raises(ValueError, match="roi_mode"):
        torch_frcnn.FasterRCNN(dataclasses.replace(tiny_config(torch_config), roi_mode="align"))


def exact_config(cfg_module, backbone):
    return dataclasses.replace(tiny_config(cfg_module), backbone=backbone, roi_mode="exact_pool")


@pytest.fixture(scope="module")
def models():
    """Per backbone, built when first asked for: the JAX model and its
    parameters, and the port with the same weights."""
    built = {}

    def get(backbone):
        if backbone not in built:
            jax_model = jax_frcnn.FasterRCNN(cfg=exact_config(jax_config, backbone))
            params = jax_frcnn.init_params(jax_model, CANVAS_H, CANVAS_W, seed=0)
            port = torch_frcnn.FasterRCNN(exact_config(torch_config, backbone))
            port.load_state_dict(from_jax_params(params))
            built[backbone] = (jax_model, params, port.eval())
        return built[backbone]

    return get


@pytest.mark.parametrize("score_threshold", [0.05, 0.0])
@pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
def test_predict_matches_jax(models, backbone, score_threshold):
    """The whole predict, padded proposal rows included: the exact pool of
    such a row is a one-cell bin, not 0."""
    jax_model, params, port = models(backbone)
    images, image_hw = synthetic_images(3)
    want = jax_frcnn.make_predict_fn(jax_model, CANVAS_H, CANVAS_W)(
        params, jnp.asarray(images), jnp.asarray(image_hw), score_threshold=score_threshold
    )
    called = []
    real = torch_roi.roi_pool_exact

    def recording(*args, **kwargs):
        called.append(args[1].shape)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_roi, "roi_pool_exact", recording)
        mp.setattr(torch_roi, "roi_pool_taps", None)  # the crop is not on this path
        got = torch_frcnn.make_predict_fn(port, CANVAS_H, CANVAS_W)(
            torch.from_numpy(images), torch.from_numpy(image_hw), score_threshold=score_threshold
        )
    assert called == [(2, 64, 4)]
    assert got.boxes.shape == (2, 20, 64, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


@pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
def test_compute_losses_and_gradients_match_jax(models, backbone):
    """One train step's losses and every trained gradient on JAX's draws
    (frozen mode: the frozen tensors get no gradient in the port)."""
    jax_model, params, _ = models(backbone)
    cfg = jax_model.cfg
    grid = jax_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    nb = numpy_batch(2)
    rng = jax.random.key(5)
    jb = jax_batch(nb)
    (_, want), grads = jax.jit(
        jax.value_and_grad(lambda p: jax_frcnn.compute_losses(jax_model, p, jb, rng, cfg, grid), has_aux=True)
    )(params)
    port = torch_frcnn.FasterRCNN(exact_config(torch_config, backbone))
    port.load_state_dict(from_jax_params(params))
    port.train()
    draws = jax_draws(rng, B, grid.total, cfg.rpn.post_nms_train + G)
    total, got = torch_frcnn.compute_losses(port, torch_batch(nb), grid, draws=draws)
    for name in torch_frcnn.Losses._fields:
        value = getattr(got, name).item()
        np.testing.assert_allclose(value, float(getattr(want, name)), rtol=1e-4, err_msg=name)
        assert value > 0, name
    total.backward()
    want_grads = from_jax_params(jax.tree.map(np.asarray, grads))
    trained = [(n, p) for n, p in port.named_parameters() if p.requires_grad]
    assert len(trained) > 10
    for name, p in trained:
        err = rel_norm(p.grad.numpy(), want_grads[name].numpy())
        assert err <= 3e-3, (name, err)
    # The RoI stage passes a gradient into the backbone.
    assert float(port.feature_extractor.block5_conv3.weight.grad.abs().sum() if backbone == "vgg16"
                 else port.feature_extractor.layer3.block0.conv1.weight.grad.abs().sum()) > 0


TINY = ["--device", "cpu", "--tiny"]


def test_cli_custom_roi_pool_trains_and_evaluates(tmp_path, monkeypatch, capsys):
    """--custom-roi-pool through `python -m fasterrcnn_torch`: one tiny train
    epoch (finite positive losses) with --save-to, then --eval of the saved
    weights; both run exact RoIPool and never the crop."""
    from fasterrcnn_torch import engine as engine_mod

    monkeypatch.chdir(tmp_path)
    built, pooled = [], []

    class RecordingEngine(engine_mod.Engine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    real = torch_roi.roi_pool_exact
    monkeypatch.setattr(engine_mod, "Engine", RecordingEngine)
    monkeypatch.setattr(torch_roi, "roi_pool_exact", lambda *a, **k: pooled.append(1) or real(*a, **k))
    monkeypatch.setattr(torch_roi, "roi_pool_taps", None)
    cli.main([*TINY, "--train", "--custom-roi-pool", "--synthetic", "4", "--batch-size", "2", "--epochs", "1",
              "--eval-batch-size", "2", "--periodic-eval-samples", "2", "--save-to", "w.pth", "--log-csv", "log.csv"])
    header, row = (tmp_path / "log.csv").read_text().strip().splitlines()
    losses = {k: float(v) for k, v in zip(header.split(","), row.split(",")) if k.endswith("loss")}
    assert len(losses) == 5 and all(np.isfinite(v) and v > 0 for v in losses.values()), losses
    trained = len(pooled)
    assert trained >= 2
    cli.main([*TINY, "--eval", "--custom-roi-pool", "--synthetic", "4", "--eval-batch-size", "2",
              "--load-from", "w.pth"])
    assert len(pooled) > trained
    assert [e.model.cfg.roi_mode for e in built] == ["exact_pool", "exact_pool"]
    assert capsys.readouterr().out.count("Mean Average Precision = ") == 3
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_reference_checkpoint_evaluates_with_custom_roi_pool(tmp_path, monkeypatch, capsys):
    """The port's counterpart of the reference's
    `--eval --load-from checkpoint-epoch-14-mAP-71.0.pth --custom-roi-pool`:
    a full reference checkpoint ({"epoch", "model_state_dict"}) loads into
    an exact-pool model exactly as into a crop model, and evaluates."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "checkpoint-epoch-14-mAP-71.0.pth")
    torch.save({"epoch": 14, "model_state_dict": reference_state(np.random.default_rng(2))}, path)
    crop = checkpoint.load(torch_frcnn.FasterRCNN(tiny_config(torch_config)).state_dict(), path)
    exact = checkpoint.load(torch_frcnn.FasterRCNN(exact_config(torch_config, "vgg16")).state_dict(), path)
    assert crop.keys() == exact.keys() and all(torch.equal(crop[k], exact[k]) for k in crop)
    cli.main([*TINY, "--eval", "--custom-roi-pool", "--synthetic", "4", "--eval-batch-size", "2", "--load-from", path])
    out = capsys.readouterr().out
    assert "Mean Average Precision = " in out
    shutil.rmtree(tmp_path, ignore_errors=True)
