"""Carry parameters between the JAX package's flax tree and a torch state_dict.

The port's modules carry the flax parameter paths as their names, so a flax
path ("feature_extractor", "block1_conv1", "kernel") becomes the state_dict
key "feature_extractor.block1_conv1.weight". Layouts:
  * conv kernels: flax HWIO (kh, kw, in, out) <-> torch OIHW (out, in, kh, kw);
  * dense kernels: flax (in, out) <-> torch (out, in);
  * biases and frozen-BN scales (1-D) are the same.
fc1 needs no permutation: both packages flatten pooled RoIs (P, 7, 7, C) in
HWC order.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def from_jax_params(np_tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (nested mapping of arrays) -> torch state_dict."""
    state = {}
    for path, value in _flatten(np_tree):
        *module, leaf = path
        if leaf == "kernel":
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif value.ndim == 2:
                value = value.T  # (in, out) -> (out, in)
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {value.ndim}")
            leaf = "weight"
        elif leaf not in ("bias", "scale"):
            raise ValueError(f"{'/'.join(path)}: unknown parameter {leaf!r}")
        state[".".join([*module, leaf])] = torch.from_numpy(np.array(value, order="C"))
    return state


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """torch state_dict -> flax param tree (nested dicts of numpy arrays)."""
    tree: Dict = {}
    for key, tensor in state_dict.items():
        *module, leaf = key.split(".")
        value = tensor.detach().cpu().numpy()
        if leaf == "weight":
            if value.ndim == 4:
                value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            elif value.ndim == 2:
                value = value.T
            else:
                raise ValueError(f"{key}: weight of rank {value.ndim}")
            leaf = "kernel"
        elif leaf not in ("bias", "scale"):
            raise ValueError(f"{key}: unknown parameter {leaf!r}")
        node = tree
        for part in module:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree
