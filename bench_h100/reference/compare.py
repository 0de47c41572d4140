"""The numbers that decide `correct`, and their limits.

Predict (`detection_gaps`): every valid detection of one side is matched
to the nearest valid detection of the same image and class on the other:
its cost is max(1 - IoU, |score difference| / larger score), or 1 where
the other side has none of that class; a cost is capped at 1. Both sides
are matched both ways, so a detection one side lacks costs 1 wherever it
is. `worst_image_gap` and `worst_image_median` are the largest mean and
median cost of one image's matches, `mean_gap` the mean cost of all
matches (an image without detections on either side costs 0).
`cost_q50` and `cost_q75` are quantiles of every match cost of both
sides, `worst_batch_q50` the largest median of one batch's costs,
`worst_class_q50` the largest median of one class's costs over every
image (of a class with at least `min_share` of all costs),
`unmatched_share` the share of costs of 0.5 or more, `count_gap` the
relative gap between the two sides' numbers of detections and
`worst_batch_count_gap` the largest such gap of one batch.

Train (`train_gaps`, from each side's loss rows of the checked steps and
each leaf's norm of the momentum trace after them and of its change over
them): `loss_gap` (and `rpn_loss_gap`, `det_loss_gap` of the RPN's two
losses and the detector's two) is the largest relative gap of a step's
total, and the `_mean` ones the mean of those gaps over the steps; `trace_gap` and `update_gap` are the largest, over the leaves, gap
between the two sides' norms over the larger of the reference's norm of
that leaf and of the median leaf, and the `_median` ones the median of
those ratios. Leaves whose reference first-gradient norm is under a
thousandth of the median leaf's are left out (rounding alone moves them).

`limits/<workload>.json` names the numbers compared and their limits; a
run is correct when each of them is finite and at most its limit.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, Optional

import torch

from bench_h100.reference.model import iou


def _costs(b1, s1, v1, b2, s2, v2) -> torch.Tensor:
    """(N, D) cost of each entry of side 1 matched to side 2 (N problems
    of D padded detections); 0 where side 1's entry is not valid."""
    m = torch.maximum(1.0 - iou(b1, b2), (s1[:, :, None] - s2[:, None, :]).abs()
                      / torch.maximum(s1[:, :, None], s2[:, None, :]).clamp(min=1e-12))
    m = torch.where(v2[:, None, :], m, 1.0)
    best = m.amin(-1).clamp(max=1.0) if m.shape[-1] else torch.ones_like(s1)
    return torch.where(v1, best, 0.0)


def detection_gaps(prog, ref, group: int = 0, chunk: int = 4, detail: bool = False,
                   min_share: float = 0.001) -> Dict[str, float]:
    """prog, ref: (boxes (B, K-1, D, 4), scores (B, K-1, D), valid (B, K-1,
    D)) of the same images, in batches of `group` images (0: one batch).
    Returns the match-cost and count readings of the module docstring; a
    class with under `min_share` of all costs has no median of its own."""
    b, k = prog[0].shape[:2]
    group = group or b
    costs, by_class = [], [[] for _ in range(k)]
    for i in range(0, b, chunk):
        pb, ps, pv = prog[0][i:i + chunk].float(), prog[1][i:i + chunk].float(), prog[2][i:i + chunk].bool()
        rb, rs, rv = ref[0][i:i + chunk].float(), ref[1][i:i + chunk].float(), ref[2][i:i + chunk].bool()
        n, _, d = ps.shape
        flat = lambda t: t.reshape(n * k, d, *t.shape[3:])
        fwd = _costs(flat(pb), flat(ps), flat(pv), flat(rb), flat(rs), flat(rv)).reshape(n, k, d).double().cpu()
        bwd = _costs(flat(rb), flat(rs), flat(rv), flat(pb), flat(ps), flat(pv)).reshape(n, k, d).double().cpu()
        pv, rv = pv.cpu(), rv.cpu()
        costs += [torch.cat([fwd[j][pv[j]], bwd[j][rv[j]]]) for j in range(n)]
        for c in range(k):
            by_class[c] += [fwd[:, c][pv[:, c]], bwd[:, c][rv[:, c]]]
    per_image = [float(c.mean()) if c.numel() else 0.0 for c in costs]
    medians = [float(c.median()) if c.numel() else 0.0 for c in costs]
    classes = [torch.cat(c) for c in by_class]
    every = torch.cat(costs)
    quantile = lambda c, q: float(torch.quantile(c, q)) if c.numel() else 0.0
    counts = [(prog[2][i:i + group].bool().sum().item(), ref[2][i:i + group].bool().sum().item())
              for i in range(0, b, group)]
    gap = lambda np_, nr: abs(np_ - nr) / max(nr, 1)
    n_prog, n_ref = sum(c[0] for c in counts), sum(c[1] for c in counts)
    return {"worst_image_gap": max(per_image), "mean_gap": float(every.mean()) if every.numel() else 0.0,
            "worst_image_median": max(medians),
            "unmatched_share": float((every >= 0.5).double().mean()) if every.numel() else 0.0,
            "cost_q50": quantile(every, 0.5), "cost_q75": quantile(every, 0.75),
            "worst_batch_q50": max(quantile(torch.cat(costs[i:i + group]), 0.5) for i in range(0, b, group)),
            "worst_class_q50": max([quantile(c, 0.5) for c in classes
                                    if c.numel() and c.numel() >= min_share * every.numel()], default=0.0),
            "count_gap": gap(n_prog, n_ref), "worst_batch_count_gap": max(gap(*c) for c in counts),
            "program_detections": n_prog, "reference_detections": n_ref,
            **({"per_image": {"median": medians, "mean": per_image},
                "per_class": {"median": [quantile(c, 0.5) for c in classes], "count": [c.numel() for c in classes]}}
               if detail else {})}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    med = statistics.median(ref[n] for n in keep)
    ratios = [abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep]
    return {"worst": max(ratios), "median": statistics.median(ratios)}


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"losses": [[4 losses] a step], "trace_norms": {leaf:
    norm}, "update_norms": {leaf: norm}}; ref also "grad_norms", each
    leaf's first gradient norm."""
    out = {}
    for key, cols in (("loss_gap", slice(0, 4)), ("rpn_loss_gap", slice(0, 2)), ("det_loss_gap", slice(2, 4))):
        gaps = [_rel(sum(p[cols]), sum(r[cols])) for p, r in zip(prog["losses"], ref["losses"])]
        out[key], out[f"{key}_mean"] = max(gaps), statistics.mean(gaps)
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    keep = [n for n, v in g.items() if v >= 1e-3 * med]
    for key, name in (("trace", "trace_norms"), ("update", "update_norms")):
        gaps = _leaf_gaps(prog[name], ref[name], keep)
        out[f"{key}_gap"], out[f"{key}_gap_median"] = gaps["worst"], gaps["median"]
    out["leaves_compared"] = len(keep)
    out["leaves_left_out"] = len(g) - len(keep)
    return out


def load_limits(directory: Path, workload: str) -> Optional[dict]:
    path = directory / f"{workload}.json"
    return json.loads(path.read_text()) if path.is_file() else None


def judge(numbers: Dict[str, float], limits: Optional[dict]) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the numbers the limits name.
    Without limits nothing is correct."""
    if not limits:
        return False, {}
    checks = {}
    for name, spec in limits["limits"].items():
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": spec["limit"]}
    ok = all(c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
