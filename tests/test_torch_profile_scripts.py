"""The port's stage-isolation profiles and RoI gradient check
(`fasterrcnn_torch/scripts/profile_inference.py`, `profile_train.py`,
`gradcheck_roi_vjp.py`) on the CPU, at the CLI's tiny config in f32 (the
full-width VGG-16 on the 128x160 canvas, B=2).

Each prefix the profiles time must return what the whole program computes
at that point: the same tensors, compared with torch.equal (the predict
program's proposals and class logits, recorded inside it; the train step's
loss, with and without autograd). The proposals, at the infer caps
(200 -> 64) and at the train leg's (400 -> 128), are held to the JAX
package's `generate_proposals` on the same RPN outputs: boxes within 1e-5
pixels, the same valid slots. The gradient check's PyTorch mirror is held
to the JAX script's `mirror_one` within 1e-5, and its two gated checks run
on the CPU route (the plain forward and backward) at B=1, P=8, C=32.
"""

import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu.models import faster_rcnn as jax_frcnn
from fasterrcnn_tpu.models.rpn import generate_proposals as jax_generate_proposals
from fasterrcnn_torch.models.faster_rcnn import compute_losses
from fasterrcnn_torch.scripts import gradcheck_roi_vjp, profile_inference, profile_train
from fasterrcnn_torch.utils import profiling
from tests.test_torch_predict import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Slopes over loops of 0 and 1 calls: each stage runs three times (a warm
# call, the slope's settling call, the timed one), the least that reaches
# every line of the scripts; the suite has no time for more.
TINY = ["--device", "cpu", "--tiny", "--batch", "2", "--lo", "0", "--hi", "1"]


def options(**kw):
    return types.SimpleNamespace(**{"device": "cpu", "tiny": True, "batch": 2, "backbone": "vgg16",
                                    "dtype": "float32", **kw})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread while this file runs (restored after): the suite's six
    workers already fill the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engine():
    """The file's one port model: both scripts' setups take it."""
    return profile_inference.make_engine(options())


def setup_on(script, engine):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profile_inference, "make_engine", lambda flags: engine)
        return script.setup(options())


@pytest.fixture(scope="module")
def inference(engine):
    return setup_on(profile_inference, engine)


@pytest.fixture(scope="module")
def train(engine):
    return setup_on(profile_train, engine)


def test_predict_prefixes_return_what_the_predict_program_computes(inference):
    s = inference
    with profile_inference.predict_internals(s.engine.model) as seen:
        det = profile_inference.stage_predict(s)
    assert "detect_rois" not in vars(s.engine.model)  # the recording is undone
    fm, props = profile_inference.stage_proposals(s)
    logits, deltas = profile_inference.stage_detect(s)
    features = profile_inference.stage_features(s)
    assert torch.equal(fm, features[0])
    for got, want in zip(props, seen["proposals"]):
        assert torch.equal(got, want)
    assert torch.equal(logits, seen["logits"])
    assert props.boxes.shape == (2, 64, 4) and props.valid.sum() > 0
    assert logits.shape == (2, 64, 21) and deltas.shape == (2, 64, 80) and det.scores.shape == (2, 20, 64)


def jax_proposals(logits, deltas, image_hw, pre, post):
    cfg = tiny_config(jax_config)
    grid = jax_frcnn.anchor_grid_for(cfg, *profile_inference.TINY_CANVAS)
    centers = jnp.asarray(grid.centers)
    return jax.vmap(
        lambda lg, dl, hw: jax_generate_proposals(
            lg, dl, centers, jax_frcnn.proposal_masks(cfg, grid, hw)[0], hw[0], hw[1], pre, post,
            cfg.rpn.nms_iou_threshold, cfg.rpn.min_proposal_side,
        )
    )(jnp.asarray(logits.numpy()), jnp.asarray(deltas.numpy()), jnp.asarray(image_hw.numpy()))


def test_proposals_and_the_train_leg_match_jax(inference):
    s = inference
    _, logits, deltas = profile_inference.stage_features(s)
    rpn = s.engine.model_cfg.rpn
    for (pre, post), got in (
        ((rpn.pre_nms_infer, rpn.post_nms_infer), profile_inference.stage_proposals(s)[1]),
        ((rpn.pre_nms_train, rpn.post_nms_train), profile_inference.train_proposals(s, logits, deltas)),
    ):
        want = jax_proposals(logits, deltas, s.image_hw, pre, post)
        assert got.boxes.shape == (2, post, 4)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-5)
        assert got.valid.sum() > 0
    # Leg `plain`'s input is what the train leg's NMS takes: its keep mask,
    # gathered, gives the train leg's boxes.
    boxes, _, valid = profile_inference.train_candidates(s, logits, deltas)
    from fasterrcnn_torch.ops import nms as nms_ops

    keep = nms_ops.nms_keep_mask_plain(boxes, valid, rpn.nms_iou_threshold, rpn.post_nms_train)
    props = profile_inference.train_proposals(s, logits, deltas)
    for i in range(2):
        kept = boxes[i][keep[i]]
        assert torch.equal(kept, props.boxes[i, : kept.shape[0]]) and int(props.valid[i].sum()) == kept.shape[0]


def test_train_prefixes_return_the_train_steps_loss(train):
    s = train
    model = s.engine.model
    s.restore()
    model.train()
    with_grad = compute_losses(model, s.batch, s.grid, draws=s.draws)[0]
    assert with_grad.requires_grad
    no_grad = profile_train.stage_losses(s)
    assert not no_grad.requires_grad and torch.equal(no_grad, with_grad.detach())
    assert torch.equal(profile_train.stage_backward(s), no_grad)
    assert all(p.grad is not None for p in model.roi_head.parameters())
    before = model.detector_heads.classifier.weight.detach().clone()
    assert torch.equal(profile_train.stage_step(s).total, no_grad)
    assert not torch.equal(model.detector_heads.classifier.weight, before)  # the step updated
    s.restore()
    assert torch.equal(model.detector_heads.classifier.weight, before)
    assert profile_train.stage_features(s).shape == (2, 8 * 10 * 9)


@pytest.mark.parametrize("script, fixture, labels", [
    (profile_inference, "inference", [
        "backbone+rpn_head", "+ proposal gen (RPN NMS)", "+ roi pool + det head", "full predict",
        "train NMS 400->128 B=2 [kernel]", "train NMS 400->128 B=2 [nms_keep_mask]",
        "train NMS 400->128 B=2 [nms_keep_mask_plain]"]),
    (profile_train, "train", ["fwd backbone+rpn_head", "fwd full losses", "+ backward", "full train step",
                              "captured packed step"]),
])
def test_main_prints_every_stage(script, fixture, labels, request, monkeypatch, capsys):
    """`main` on the flags: its setup is the module's (built from the same
    flags), so that the file builds one engine a script."""
    built = request.getfixturevalue(fixture)
    seen = []

    def setup(options):
        seen.append(options)
        return built

    monkeypatch.setattr(script, "setup", setup)
    rows = script.main([*TINY, "--dtype", "float32"])
    (flags,) = seen
    assert vars(options()) == {k: v for k, v in vars(flags).items() if k in vars(options())}
    out = capsys.readouterr().out
    assert [row["stage"] for row in rows] == labels
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert lines == rows
    for row in rows:
        assert np.isfinite(row["slope_ms"]) and row["card"] == "cpu" and row["batch"] in (2,)
        # A CPU run measures no device time.
        assert row["device_busy_ms"] == row["device_idle_share"] == row["device_ops"] == "not measured"
        assert f"{row['stage']:26s}: " in out
    assert out.count("images/sec") == (1 if script is profile_inference else 2)


def test_device_profile_measures_nothing_without_a_card():
    calls = []
    prof = profiling.device_profile(lambda: calls.append(1), reps=2)
    assert calls == [] and set(prof.values()) == {"not measured"}
    assert {"device_busy_ms_per_call", "device_idle_share", "device_ops_per_call"} <= set(prof)


@pytest.fixture(scope="module")
def jax_gradcheck():
    spec = importlib.util.spec_from_file_location("jax_gradcheck_roi_vjp",
                                                  os.path.join(REPO, "scripts", "gradcheck_roi_vjp.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_gradcheck_mirror_matches_jax_mirror_one(jax_gradcheck):
    rng = np.random.default_rng(3)
    fm = rng.normal(size=(38, 50, 512)).astype(np.float32)
    norm = np.float32([(gradcheck_roi_vjp.REAL_FH - 1) / gradcheck_roi_vjp.IMG_H,
                       (gradcheck_roi_vjp.REAL_FW - 1) / gradcheck_roi_vjp.IMG_W])
    for roi in gradcheck_roi_vjp.random_rois(rng, 3):
        roi_fg = (roi * norm[[0, 1, 0, 1]]).astype(np.float32)
        want = np.asarray(jax_gradcheck.mirror_one(jnp.asarray(fm), jnp.asarray(roi_fg)))
        got = gradcheck_roi_vjp.mirror_one(torch.from_numpy(fm), torch.from_numpy(roi_fg)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gradcheck_gates_hold_on_the_cpu_route():
    out = gradcheck_roi_vjp.gradcheck("cpu", b=1, p=8, c=32)
    assert out["ok"] and out["vs_mirror"] < gradcheck_roi_vjp.MIRROR_GATE and out["vs_plain"] < gradcheck_roi_vjp.PLAIN_GATE
    assert out["forward_kernel"] == out["forward_plain"]  # the CPU route is the plain forward
    assert [row["eps"] for row in out["fd"]] == [1e-3, 3e-4] and all(np.isfinite(row["rel"]) for row in out["fd"])
