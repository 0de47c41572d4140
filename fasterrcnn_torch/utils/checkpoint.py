"""Checkpoints and pretrained-weight import.

A port of the JAX package's `utils/checkpoint.py` with one loader and one
path. The importers are the JAX package's own, numpy only: each fills a
nested dict of numpy arrays in the JAX parameter tree's layout (HWIO conv
kernels, (in, out) dense kernels, fc1's rows in HWC order), which is what
`utils/weights.to_jax_params(model.state_dict())` gives. The filled tree
then becomes the port's state dict through `utils/weights.from_jax_params`,
the one place that undoes those layouts.

Formats `load` reads, told apart by the file's signature and then by the
state dict's keys:
  * Keras VGG-16 h5 (h5py, imported when needed);
  * Caffe and torchvision VGG-16 `.pth` state dicts (`features.N`,
    `classifier.N`): the backbone and fc1/fc2 only, the rest of the model
    keeps its values;
  * torchvision ResNet-50/101/152 state dicts (`conv1`, `layerN.i.*`):
    conv1..layer4, each BatchNorm folded into the frozen-BN scale and bias
    (eps 1e-5); the RPN and detector heads keep their values;
  * the reference's full checkpoints {"epoch", "model_state_dict"} of
    `_stage1_feature_extractor.` keys;
  * the port's own `.pth`, written by `save_weights`;
  * the JAX package's flax msgpack files, decoded with `msgpack` (imported
    when needed), not flax.
Per-epoch training checkpoints (`TrainCheckpointManager`) store the weights
only: resume restarts the optimizer, so a changed learning rate is honoured.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fasterrcnn_torch.utils.weights import from_jax_params, to_jax_params

VGG16_CONV_LAYERS = tuple(
    f"block{b}_conv{c}"
    for b, n in ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3))
    for c in range(1, n + 1)
)

# Caffe/torchvision VGG-16 "features.N" indices of the 13 convs (the same
# module order in both sources).
_VGG_FEATURES_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# A key the port's own state dicts carry, whatever the backbone.
_OWN_KEY = "detector_heads.classifier.weight"


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _torch_fc1_to_hwc(w: np.ndarray, channels: int = 512, side: int = 7) -> np.ndarray:
    """torch fc1 weight (4096, C*H*W in CHW order) -> (H*W*C, 4096) HWC order."""
    w = w.reshape(4096, channels, side, side)
    w = np.transpose(w, (2, 3, 1, 0))  # (7, 7, 512, 4096)
    return w.reshape(side * side * channels, 4096)


def _to_numpy_state(obj) -> Dict[str, np.ndarray]:
    """torch state dict -> {name: np.ndarray}."""
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in obj.items()}


def _load_torch_file(filepath: str):
    """torch.load with safe unpickling; arbitrary-code pickles are opt-in.

    weights_only=True covers every checkpoint format imported here (plain
    tensor dicts, the reference's {'epoch', 'model_state_dict'} files). A
    file that needs full unpickling runs code from the checkpoint, so that
    path is gated behind FASTERRCNN_UNSAFE_PICKLE=1.
    """
    try:
        return torch.load(filepath, map_location="cpu", weights_only=True)
    except Exception as e:
        if os.environ.get("FASTERRCNN_UNSAFE_PICKLE") == "1":
            return torch.load(filepath, map_location="cpu", weights_only=False)
        raise ValueError(
            f"'{filepath}' could not be loaded with safe unpickling "
            f"(weights_only=True): {e}. If you trust this file, set "
            "FASTERRCNN_UNSAFE_PICKLE=1 to allow full pickle execution."
        ) from e


def _set(params: Dict, path: str, value: np.ndarray) -> None:
    node = params
    *parents, leaf = path.split("/")
    try:
        for p in parents:
            node = node[p]
        expected = node[leaf].shape
    except KeyError:
        raise ValueError(f"{path}: the model has no such parameter") from None
    if tuple(value.shape) != tuple(expected):
        raise ValueError(f"{path}: shape {value.shape} != expected {expected}")
    node[leaf] = value.astype(np.float32)


# ---------------------------------------------------------------------------
# Importers (each takes and returns a mutable nested-dict JAX-layout tree)
# ---------------------------------------------------------------------------


def _import_torch_vgg16_state(state: Dict[str, np.ndarray], params: Dict,
                              source: str) -> Dict:
    """features.N / classifier.N torch VGG-16 state dict -> the tree.

    Covers both pretrained VGG-16 sources, which share the module order: the
    Caffe conversion vgg16_caffe.pth and torchvision.models.vgg16
    IMAGENET1K_V1 (classifier.6, the 1000-way head, is skipped)."""
    loaded = []
    for idx, layer in zip(_VGG_FEATURES_INDEX, VGG16_CONV_LAYERS):
        wk, bk = f"features.{idx}.weight", f"features.{idx}.bias"
        if wk in state and bk in state:
            _set(params, f"feature_extractor/{layer}/kernel", _oihw_to_hwio(state[wk]))
            _set(params, f"feature_extractor/{layer}/bias", state[bk])
            loaded.append(layer)
    if "classifier.0.weight" in state:
        _set(params, "roi_head/fc1/kernel", _torch_fc1_to_hwc(state["classifier.0.weight"]))
        _set(params, "roi_head/fc1/bias", state["classifier.0.bias"])
        loaded.append("fc1")
    if "classifier.3.weight" in state:
        _set(params, "roi_head/fc2/kernel", state["classifier.3.weight"].T)
        _set(params, "roi_head/fc2/bias", state["classifier.3.bias"])
        loaded.append("fc2")
    if not loaded:
        raise ValueError(f"'{source}' is not a torch VGG-16 state dict")
    print(f"Loaded {len(loaded)} VGG-16 layers from torch model '{source}'")
    return params


def import_keras_vgg16(filepath: str, params: Dict) -> Dict:
    """Keras VGG-16 h5. Its kernels are HWIO already and fc1 is already in
    HWC-flatten order."""
    import h5py

    loaded, missing = [], []
    with h5py.File(filepath, "r") as f:

        def find(layer):
            group = f[f"model_weights/{layer}"]
            for sub in group:
                if sub.startswith(("conv", "dense")):
                    return (
                        np.asarray(group[sub]["kernel:0"], np.float32),
                        np.asarray(group[sub]["bias:0"], np.float32),
                    )
            return None, None

        for layer in VGG16_CONV_LAYERS:
            try:
                w, b = find(layer)
            except KeyError:
                w = b = None
            if w is None:
                missing.append(layer)
                continue
            _set(params, f"feature_extractor/{layer}/kernel", w)
            _set(params, f"feature_extractor/{layer}/bias", b)
            loaded.append(layer)
        for fc in ("fc1", "fc2"):
            try:
                w, b = find(fc)
            except KeyError:
                w = b = None
            if w is None:
                missing.append(fc)
                continue
            _set(params, f"roi_head/{fc}/kernel", w)  # (in, out) already
            _set(params, f"roi_head/{fc}/bias", b)
            loaded.append(fc)
    if not loaded:
        raise ValueError(f"'{filepath}' is not a Keras VGG-16 model")
    if missing:
        print(f"Layers missing from '{filepath}': {', '.join(missing)}")
    print(f"Loaded {len(loaded)} VGG-16 layers from Keras model '{filepath}'")
    return params


def _fold_bn(state: Dict[str, np.ndarray], prefix: str, eps: float = 1e-5):
    """A torch BatchNorm's (gamma, beta, running mean, running var) as the
    frozen-BN (scale, bias): gamma / sqrt(var + eps), beta - mean * scale."""
    gamma = state[prefix + ".weight"]
    beta = state[prefix + ".bias"]
    mean = state[prefix + ".running_mean"]
    var = state[prefix + ".running_var"]
    scale = gamma / np.sqrt(var + eps)
    return scale, beta - mean * scale


def _import_torchvision_resnet_state(state: Dict[str, np.ndarray], params: Dict, filepath: str) -> Dict:
    """torchvision resnet{50,101,152} state dict -> the frozen-BN tree. Each
    stage must hold as many bottlenecks as the model's."""
    if "conv1.weight" not in state or "layer1.0.conv1.weight" not in state:
        raise ValueError(f"'{filepath}' is not a torchvision ResNet state dict")
    try:
        _set(params, "feature_extractor/conv1/kernel", _oihw_to_hwio(state["conv1.weight"]))
        s, b = _fold_bn(state, "bn1")
        _set(params, "feature_extractor/bn1/scale", s)
        _set(params, "feature_extractor/bn1/bias", b)
        for top, stage in (
            ("feature_extractor", "layer1"),
            ("feature_extractor", "layer2"),
            ("feature_extractor", "layer3"),
            ("roi_head", "layer4"),
        ):
            n = 0
            while f"{stage}.{n}.conv1.weight" in state:
                n += 1
            want = len(params.get(top, {}).get(stage, {}))
            if n != want:
                raise ValueError(f"{stage} holds {n} bottlenecks, the model {want}")
            for i in range(n):
                src, dst = f"{stage}.{i}", f"{top}/{stage}/block{i}"
                for conv in ("conv1", "conv2", "conv3"):
                    _set(params, f"{dst}/{conv}/kernel", _oihw_to_hwio(state[f"{src}.{conv}.weight"]))
                    sc, bi = _fold_bn(state, f"{src}.bn{conv[-1]}")
                    _set(params, f"{dst}/bn{conv[-1]}/scale", sc)
                    _set(params, f"{dst}/bn{conv[-1]}/bias", bi)
                if f"{src}.downsample.0.weight" in state:
                    _set(params, f"{dst}/downsample_conv/kernel", _oihw_to_hwio(state[f"{src}.downsample.0.weight"]))
                    sc, bi = _fold_bn(state, f"{src}.downsample.1")
                    _set(params, f"{dst}/downsample_bn/scale", sc)
                    _set(params, f"{dst}/downsample_bn/bias", bi)
    except KeyError as e:
        raise ValueError(f"'{filepath}': not a torchvision ResNet of this model: it lacks {e}") from None
    except ValueError as e:
        raise ValueError(f"'{filepath}': not a torchvision ResNet of this model: {e}") from None
    print(f"Loaded torchvision ResNet backbone from '{filepath}'")
    return params


def _import_reference_state(
    state: Dict[str, np.ndarray], params: Dict, filepath: str
) -> Dict:
    """The reference's full VGG-16 checkpoint: backbone, RPN and detector."""
    fe = "_stage1_feature_extractor._"
    if fe + "block1_conv1.weight" not in state:
        raise ValueError(f"'{filepath}' is not a reference FasterRCNN checkpoint")
    for layer in VGG16_CONV_LAYERS:
        _set(params, f"feature_extractor/{layer}/kernel", _oihw_to_hwio(state[fe + layer + ".weight"]))
        _set(params, f"feature_extractor/{layer}/bias", state[fe + layer + ".bias"])

    rpn = "_stage2_region_proposal_network._"
    _set(params, "rpn_head/conv/kernel", _oihw_to_hwio(state[rpn + "rpn_conv1.weight"]))
    _set(params, "rpn_head/conv/bias", state[rpn + "rpn_conv1.bias"])
    _set(params, "rpn_head/objectness/kernel", _oihw_to_hwio(state[rpn + "rpn_class.weight"]))
    _set(params, "rpn_head/objectness/bias", state[rpn + "rpn_class.bias"])
    _set(params, "rpn_head/deltas/kernel", _oihw_to_hwio(state[rpn + "rpn_boxes.weight"]))
    _set(params, "rpn_head/deltas/bias", state[rpn + "rpn_boxes.bias"])

    det = "_stage3_detector_network._"
    _set(params, "roi_head/fc1/kernel",
         _torch_fc1_to_hwc(state[det + "pool_to_feature_vector._fc1.weight"]))
    _set(params, "roi_head/fc1/bias", state[det + "pool_to_feature_vector._fc1.bias"])
    _set(params, "roi_head/fc2/kernel", state[det + "pool_to_feature_vector._fc2.weight"].T)
    _set(params, "roi_head/fc2/bias", state[det + "pool_to_feature_vector._fc2.bias"])
    _set(params, "detector_heads/classifier/kernel", state[det + "classifier.weight"].T)
    _set(params, "detector_heads/classifier/bias", state[det + "classifier.bias"])
    _set(params, "detector_heads/regressor/kernel", state[det + "regressor.weight"].T)
    _set(params, "detector_heads/regressor/bias", state[det + "regressor.bias"])
    print(f"Loaded full reference checkpoint from '{filepath}'")
    return params


def _read_flax_msgpack(filepath: str) -> Dict:
    """The JAX package's msgpack weight file -> nested dict of numpy arrays.

    Flax packs an array as ext type 1 holding msgpack (shape, dtype name,
    C-order bytes) and a numpy scalar as ext type 3 in the same form."""
    import msgpack

    def array(data: bytes) -> np.ndarray:
        shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
        if dtype_name == b"bfloat16":
            raise ValueError(f"'{filepath}': bfloat16 leaves are not supported")
        return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape, order="C")

    def ext_hook(code: int, data: bytes):
        if code == 1:
            return array(data)
        if code == 3:
            return array(data)[()]
        raise ValueError(f"'{filepath}': msgpack ext type {code} is not a flax array")

    with open(filepath, "rb") as f:
        data = f.read()
    try:
        tree = msgpack.unpackb(data, ext_hook=ext_hook, raw=False)
    except Exception as e:
        raise ValueError(
            f"'{filepath}' matched no known signature (HDF5, torch zip, "
            f"pickle) and failed to parse as a flax msgpack weight file: {e}"
        ) from e
    if not isinstance(tree, dict):
        raise ValueError(f"'{filepath}': the msgpack body is not a parameter tree")

    def check(node, path):
        for key, value in node.items():
            if key == "__msgpack_chunked_array__":
                # Flax chunks only leaves over 2^30 bytes; VGG-16's largest
                # (fc1) is 411 MB.
                raise ValueError(f"'{filepath}': {'/'.join(path)} is a chunked array leaf")
            if isinstance(value, dict):
                check(value, path + (key,))

    check(tree, ())
    return tree


def _sniff_format(filepath: str) -> str:
    """File-signature detection: 'h5' | 'torch' | 'msgpack'.

    h5 files start with the HDF5 magic; torch.save writes either a zip
    archive ('PK..') or a bare pickle ('\\x80<proto>'). Everything else is
    taken for a flax msgpack weight file.
    """
    with open(filepath, "rb") as f:
        magic = f.read(8)
    if len(magic) < 2:
        raise ValueError(
            f"'{filepath}' is not a recognized checkpoint: file is empty or "
            f"truncated ({len(magic)} bytes)"
        )
    if magic.startswith(b"\x89HDF"):
        return "h5"
    if magic.startswith(b"PK") or magic[:1] == b"\x80":
        return "torch"
    return "msgpack"


def _checked(state: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
             filepath: str) -> Dict[str, torch.Tensor]:
    """`state` as CPU tensors, after checking its keys, shapes and dtypes
    against `reference` (the model's state dict)."""
    missing = [k for k in reference if k not in state]
    extra = [k for k in state if k not in reference]
    if missing or extra:
        raise ValueError(f"'{filepath}': missing keys {missing}, unexpected keys {extra}")
    out = {}
    for key, want in reference.items():
        got = torch.as_tensor(state[key])
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"'{filepath}': {key} has shape {tuple(got.shape)}, the model {tuple(want.shape)}")
        if got.dtype != want.dtype:
            raise ValueError(f"'{filepath}': {key} is {got.dtype}, the model {want.dtype}")
        out[key] = got.detach().cpu()
    return out


def load(reference: Mapping[str, torch.Tensor], filepath: str) -> Dict[str, torch.Tensor]:
    """The full state dict `reference` (a model's) with the weights of
    `filepath` put in.

    The format is detected from the file's signature, then, for torch files,
    from the state dict's keys, so a recognized but broken file raises its
    own importer's error. Partial imports (VGG-16 and ResNet backbone files)
    replace only what they carry; the rest keeps the model's current values.
    """
    kind = _sniff_format(filepath)
    if kind == "torch":
        raw = _load_torch_file(filepath)
        state = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
        if not isinstance(state, Mapping):
            raise ValueError(f"'{filepath}' holds a {type(state).__name__}, not a state dict")
        if _OWN_KEY in state:
            return _checked(state, reference, filepath)
        tree = to_jax_params(reference)
        if "layer1.0.conv1.weight" in state:
            tree = _import_torchvision_resnet_state(_to_numpy_state(state), tree, filepath)
        elif any(k.startswith("_stage1_feature_extractor.") for k in state):
            tree = _import_reference_state(_to_numpy_state(state), tree, filepath)
        elif "features.0.weight" in state:
            tree = _import_torch_vgg16_state(_to_numpy_state(state), tree, filepath)
        else:
            sample = ", ".join(sorted(state)[:5])
            raise ValueError(
                f"'{filepath}' is a torch state dict of unknown layout "
                f"(first keys: {sample})"
            )
    elif kind == "h5":
        tree = import_keras_vgg16(filepath, to_jax_params(reference))
    else:
        tree = _read_flax_msgpack(filepath)
    return _checked(from_jax_params(tree), reference, filepath)


def save_weights(filepath: str, model) -> None:
    """torch.save of the state dict of `model` (a module or a state dict),
    moved to the CPU."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, filepath)
    print(f"Saved model weights to '{filepath}'")


class TrainCheckpointManager:
    """Per-epoch training checkpoints with resume.

    One directory per epoch, named by the epoch number, holding the weights
    (`params.pth`, torch.save) and {"epoch", "mAP"} (`meta.json`); the newest
    `max_to_keep` are kept. Resume restores the weights only: the optimizer
    restarts, so a changed learning rate is honoured.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _epochs(self):
        return sorted(
            int(name) for name in os.listdir(self._dir)
            if name.isdigit() and os.path.isfile(os.path.join(self._dir, name, "meta.json"))
        )

    def save(self, epoch: int, state: Mapping[str, torch.Tensor], mAP: float) -> None:
        """Write epoch `epoch`'s checkpoint of the state dict `state` and drop
        all but the newest `max_to_keep`."""
        final = os.path.join(self._dir, str(epoch))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({k: v.detach().cpu() for k, v in state.items()}, os.path.join(tmp, "params.pth"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"epoch": epoch, "mAP": float(mAP)}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._epochs()[: -self._max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)))
        print("Saved checkpoint for epoch %d (mAP %.1f%%) to '%s'" % (epoch, mAP, self._dir))

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore_latest(self) -> Optional[Tuple[Dict[str, torch.Tensor], int]]:
        """(state_dict, epoch) from the newest checkpoint, or None."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        path = os.path.join(self._dir, str(epoch))
        state = torch.load(os.path.join(path, "params.pth"), map_location="cpu", weights_only=True)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        print("Resumed from checkpoint epoch %d (mAP %.1f%%) in '%s'" % (epoch, meta.get("mAP", 0.0), self._dir))
        return state, epoch


class BestWeightsTracker:
    """Keep the best-mAP weights in memory; save them at the end."""

    def __init__(self, filepath: str):
        self._filepath = filepath
        self._best_params = None
        self._best_map = 0.0
        self._best_epoch = None

    def on_epoch_end(self, state: Mapping[str, torch.Tensor], epoch: int, mAP: float) -> None:
        """A better epoch's weights, the state dict `state`, are copied to
        the CPU: state_dict() returns views of the live parameters, which the
        optimizer updates in place (and .cpu() of a CPU tensor is no copy)."""
        if mAP > self._best_map:
            self._best_map = mAP
            self._best_epoch = epoch
            self._best_params = {k: v.detach().to("cpu", copy=True) for k, v in state.items()}

    def save_best_weights(self) -> None:
        if self._best_params is not None:
            save_weights(self._filepath, self._best_params)
            print(
                "Saved best model weights (mAP = %1.2f%%, epoch %s) to '%s'"
                % (self._best_map, self._best_epoch, self._filepath)
            )
