"""The port's weight import and checkpoints (`fasterrcnn_torch/utils/
checkpoint.py`) against the JAX package's `utils/checkpoint.py`.

Each weight format is written once from seeded arrays and loaded by both
packages into the same starting weights (the port's seeded model, given to
JAX as `utils/weights.to_jax_params` of it); the port's result, brought back
through `to_jax_params`, must equal JAX's tree leaf for leaf, bit for bit
(tolerance 0: both sides only copy, transpose and reshape f32 arrays).
The model is full-width VGG-16 (its widths are fixed; the tiny config
changes only anchors and caps).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import torchvision_resnet_state
from fasterrcnn_tpu.utils import checkpoint as jax_ckpt
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch.data.pipeline import make_host_batch
from fasterrcnn_torch.data.synthetic import SyntheticDataset
from fasterrcnn_torch.engine import Engine
from fasterrcnn_torch.models import faster_rcnn as torch_frcnn
from fasterrcnn_torch.utils import checkpoint
from fasterrcnn_torch.utils.weights import to_jax_params
from tests.test_keras_import import make_keras_vgg16_h5
from tests.test_torch_predict import tiny_config

VGG_FEATURES = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128), 10: (256, 128), 12: (256, 256),
                14: (256, 256), 17: (512, 256), 19: (512, 512), 21: (512, 512), 24: (512, 512),
                26: (512, 512), 28: (512, 512)}


@pytest.fixture(autouse=True)
def remove_weight_files(tmp_path):
    """A full-width weight file is ~0.5 GB: delete each test's files when it
    ends, not when pytest prunes old temporary directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def normal(rng, *shape, std=0.05):
    """Seeded f32 values of the given spread (uniform: cheaper to draw at
    fc1's 102.8M elements than a normal)."""
    return torch.from_numpy((rng.random(shape, dtype=np.float32) - np.float32(0.5)) * np.float32(std * 3.46))


def vgg16_state(rng, classifier=(0, 3)):
    """A torch VGG-16 state dict (Caffe conversion: classifier 0 and 3;
    torchvision adds the 1000-way classifier.6)."""
    state = {}
    for idx, (co, ci) in VGG_FEATURES.items():
        state[f"features.{idx}.weight"] = normal(rng, co, ci, 3, 3)
        state[f"features.{idx}.bias"] = normal(rng, co)
    shapes = {0: (4096, 25088), 3: (4096, 4096), 6: (1000, 4096)}
    for idx in classifier:
        state[f"classifier.{idx}.weight"] = normal(rng, *shapes[idx], std=0.02)
        state[f"classifier.{idx}.bias"] = normal(rng, shapes[idx][0], std=0.02)
    return state


def reference_state(rng):
    """The reference's full VGG-16 FasterRCNN state dict."""
    state = {}
    fe = "_stage1_feature_extractor._"
    for (co, ci), name in zip(VGG_FEATURES.values(), checkpoint.VGG16_CONV_LAYERS):
        state[fe + name + ".weight"] = normal(rng, co, ci, 3, 3)
        state[fe + name + ".bias"] = normal(rng, co)
    rpn = "_stage2_region_proposal_network._"
    for name, co, k in (("rpn_conv1", 512, 3), ("rpn_class", 9, 1), ("rpn_boxes", 36, 1)):
        state[rpn + name + ".weight"] = normal(rng, co, 512, k, k)
        state[rpn + name + ".bias"] = normal(rng, co)
    det = "_stage3_detector_network._"
    for name, (o, i) in (("pool_to_feature_vector._fc1", (4096, 25088)), ("pool_to_feature_vector._fc2", (4096, 4096)),
                         ("classifier", (21, 4096)), ("regressor", (80, 4096))):
        state[det + name + ".weight"] = normal(rng, o, i)
        state[det + name + ".bias"] = normal(rng, o)
    return state


def flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def models():
    """The port's seeded model and the same weights as a JAX parameter tree
    (the bridge's round trip is exact: tests/test_torch_predict.py)."""
    port = torch_frcnn.FasterRCNN(torch_config.ModelConfig())
    torch_frcnn.init_params(port, seed=0)
    return to_jax_params(port.state_dict()), port


def assert_both_load_the_same(models, path):
    params, port = models
    want = dict(flat(jax_ckpt.load(params, path)))
    state = checkpoint.load(port.state_dict(), path)
    assert set(state) == set(port.state_dict())
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in state.values())
    got = dict(flat(to_jax_params(state)))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    return got


def test_caffe_vgg16_loads_as_in_jax(models, tmp_path):
    path = str(tmp_path / "vgg16_caffe.pth")
    state = vgg16_state(np.random.default_rng(0))
    torch.save(state, path)
    got = assert_both_load_the_same(models, path)
    # The import reached fc1 (rows reordered CHW -> HWC) and left the RPN.
    np.testing.assert_array_equal(got["roi_head/fc1/bias"], state["classifier.0.bias"].numpy())
    np.testing.assert_array_equal(got["rpn_head/conv/bias"], np.asarray(models[0]["rpn_head"]["conv"]["bias"]))


def test_torchvision_vgg16_loads_as_in_jax(models, tmp_path):
    path = str(tmp_path / "vgg16-imagenet.pth")
    torch.save(vgg16_state(np.random.default_rng(1), classifier=(0, 3, 6)), path)
    assert_both_load_the_same(models, path)


def test_reference_checkpoint_loads_as_in_jax(models, tmp_path):
    path = str(tmp_path / "checkpoint-epoch-14-mAP-71.0.pth")
    state = reference_state(np.random.default_rng(2))
    torch.save({"epoch": 14, "model_state_dict": state}, path)
    got = assert_both_load_the_same(models, path)
    np.testing.assert_array_equal(got["detector_heads/regressor/kernel"],
                                  state["_stage3_detector_network._regressor.weight"].numpy().T)


def test_keras_h5_loads_as_in_jax(models, tmp_path):
    path = str(tmp_path / "vgg16.h5")
    stored = make_keras_vgg16_h5(path, np.random.default_rng(3))
    got = assert_both_load_the_same(models, path)
    np.testing.assert_array_equal(got["roi_head/fc1/kernel"], stored["fc1"][0])


def test_jax_msgpack_loads_as_in_jax(models, tmp_path):
    params, port = models
    path = str(tmp_path / "final.msgpack")
    rng = np.random.default_rng(4)
    other = {k: {m: {leaf: (np.asarray(v) + rng.random(np.shape(v), dtype=np.float32))
                     for leaf, v in layer.items()} for m, layer in mod.items()} for k, mod in params.items()}
    jax_ckpt.save_weights(path, other)
    got = assert_both_load_the_same(models, path)
    for key, value in flat(other):
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_own_weights_round_trip_bit_for_bit(models, tmp_path):
    _, port = models
    path = str(tmp_path / "w.pth")
    checkpoint.save_weights(path, port)
    state = checkpoint.load(port.state_dict(), path)
    for key, value in port.state_dict().items():
        assert torch.equal(state[key], value), key


def test_own_weights_are_checked_against_the_model(models, tmp_path):
    _, port = models
    state = {k: v.clone() for k, v in port.state_dict().items()}
    path = str(tmp_path / "w.pth")
    del state["detector_heads.regressor.bias"]
    torch.save(state, path)
    with pytest.raises(ValueError, match="missing keys.*detector_heads.regressor.bias"):
        checkpoint.load(port.state_dict(), path)
    state["detector_heads.regressor.bias"] = torch.zeros(81)
    torch.save(state, path)
    with pytest.raises(ValueError, match="detector_heads.regressor.bias has shape"):
        checkpoint.load(port.state_dict(), path)
    state["detector_heads.regressor.bias"] = torch.zeros(80, dtype=torch.float64)
    torch.save(state, path)
    with pytest.raises(ValueError, match="detector_heads.regressor.bias is torch.float64"):
        checkpoint.load(port.state_dict(), path)
    state["detector_heads.regressor.bias"] = torch.zeros(80)
    state["extra.weight"] = torch.zeros(1)
    torch.save(state, path)
    with pytest.raises(ValueError, match="unexpected keys.*extra.weight"):
        checkpoint.load(port.state_dict(), path)


def test_load_raises_for_resnet_unknown_and_empty_files(models, tmp_path):
    """A torchvision ResNet-50 file loads into a ResNet-50 model
    (`tests/test_torch_resnet.py` holds it to JAX's import); a malformed one,
    and a ResNet file given to the VGG-16 model, raise the importer's
    ValueError. Unknown, empty and unparsable files raise too."""
    _, port = models
    resnet50 = torch_frcnn.FasterRCNN(torch_config.ModelConfig(backbone="resnet50"))
    resnet = str(tmp_path / "resnet50.pth")
    state = torchvision_resnet_state(np.random.default_rng(8), "resnet50")
    torch.save(state, resnet)
    loaded = checkpoint.load(resnet50.state_dict(), resnet)
    assert torch.equal(loaded["feature_extractor.conv1.weight"], state["conv1.weight"])
    assert torch.equal(loaded["roi_head.layer4.block2.conv3.weight"], state["layer4.2.conv3.weight"])
    with pytest.raises(ValueError, match="not a torchvision ResNet of this model"):
        checkpoint.load(port.state_dict(), resnet)
    torch.save({"conv1.weight": torch.zeros(64, 3, 7, 7), "layer1.0.conv1.weight": torch.zeros(64, 64, 1, 1)}, resnet)
    with pytest.raises(ValueError, match="not a torchvision ResNet of this model.*bn1"):
        checkpoint.load(resnet50.state_dict(), resnet)
    other = str(tmp_path / "other.pth")
    torch.save({"something.weight": torch.zeros(3)}, other)
    with pytest.raises(ValueError, match="unknown layout"):
        checkpoint.load(port.state_dict(), other)
    empty = tmp_path / "empty.pth"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        checkpoint.load(port.state_dict(), str(empty))
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(b"\xc1 not msgpack at all")
    with pytest.raises(ValueError, match="matched no known signature"):
        checkpoint.load(port.state_dict(), str(garbage))


def test_train_checkpoint_manager_keeps_three_and_resumes_newest(tmp_path):
    model = torch.nn.Linear(3, 2)
    manager = checkpoint.TrainCheckpointManager(str(tmp_path / "ck"))
    assert manager.restore_latest() is None
    saved = {}
    for epoch in range(1, 6):
        with torch.no_grad():
            model.weight.fill_(epoch)
        manager.save(epoch, model.state_dict(), mAP=10.0 * epoch)
        saved[epoch] = {k: v.clone() for k, v in model.state_dict().items()}
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4", "5"]
    with open(tmp_path / "ck" / "5" / "meta.json") as f:
        assert json.load(f) == {"epoch": 5, "mAP": 50.0}
    state, epoch = checkpoint.TrainCheckpointManager(str(tmp_path / "ck")).restore_latest()
    assert epoch == 5 and manager.latest_epoch() == 5
    for key, value in saved[5].items():
        assert torch.equal(state[key], value), key


def test_best_weights_tracker_saves_the_best_epoch(tmp_path):
    engine = Engine(tiny_config(torch_config), seed=0, device="cpu")
    batch = make_host_batch(list(SyntheticDataset(num_samples=2, height=120, width=150, seed=0)), (128, 160), 8)
    path = str(tmp_path / "best.pth")
    tracker = checkpoint.BestWeightsTracker(path)
    tracker.on_epoch_end(engine.model.state_dict(), 1, 0.0)  # not above the start (0.0)
    engine.train_step(batch)
    tracker.on_epoch_end(engine.model.state_dict(), 2, 50.0)
    best = {k: v.clone() for k, v in engine.model.state_dict().items()}
    engine.train_step(batch)  # updates the live parameters in place
    tracker.on_epoch_end(engine.model.state_dict(), 3, 40.0)
    tracker.save_best_weights()
    saved = torch.load(path, weights_only=True)
    changed = [k for k in best if not torch.equal(best[k], engine.model.state_dict()[k])]
    assert changed  # the third epoch moved the weights
    for key, value in best.items():
        assert torch.equal(saved[key], value), key
