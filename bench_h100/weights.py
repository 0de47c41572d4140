"""Seeded random weights, made on the device in a few large calls.

Every conv and dense weight is a normal draw with standard deviation
gain / sqrt(fan_in); the gain of a parameter is that of the first rule of
the configuration's "init" object whose regular expression matches its
name (`re.search`), else `default_gain`. Biases are 0; the frozen
BatchNorms' scales are `bn_scale` (their biases 0). All weights come from
one `torch.randn` over their total size, from a generator on the device
seeded with the run's weight seed, in `reference.model.param_shapes`
order, so a seed gives the same weights on every run and to both sides.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch

from bench_h100.reference.model import param_shapes


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for a configuration file's model."""
    init = config["init"]
    rules = [(re.compile(pattern), gain) for pattern, gain in init["rules"]]
    shapes = param_shapes(config["model"])
    matrices = [(n, s) for n, s in shapes if len(s) >= 2]
    total = sum(math.prod(s) for _, s in matrices)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in matrices:
        n = math.prod(shape)
        gain = next((g for rx, g in rules if rx.search(name)), init["default_gain"])
        out[name] = flat[offset:offset + n].view(shape).mul_(gain / math.sqrt(n // shape[0]))
        offset += n
    for name, shape in shapes:
        if name not in out:
            fill = init["bn_scale"] if name.endswith(".scale") else 0.0
            out[name] = torch.full(shape, fill, dtype=torch.float32, device=device)
    return {name: out[name] for name, _ in shapes}
