"""Gradient check of the RoI crop+pool's backward on the card: the JAX
package's `scripts/gradcheck_roi_vjp.py`.

At production-like shapes (B=4, P=128 RoIs an image, a 38x50xC f32 map with
the 37x50 real grid of a 600x800 image; C = FRCNN_GRADCHECK_C, default 512,
1024 for ResNet's width) the loss sum(roi_pool_taps(fm, rois, norm) * cot)
goes through `RoIPoolTaps`: on the card K2 forward and K3 backward, on the
CPU their plain versions. Its map gradient is checked three ways:

1. Element-wise against autograd of `mirror`, the taps written out in
   PyTorch as JAX's `mirror_one` writes them (same y-weight sheet, same
   clamped two-tap x interpolation, same pooling order). The only
   legitimate disagreements are argmax flips on float near-ties, so the
   fraction of elements off by more than 1e-2 relative must stay below 5e-5.
2. Against autograd of `ops/roi.roi_pool_features`, the plain forward: the
   same function by another float path, where near-tie flips are more
   common; the fraction must stay below 1e-3.
3. Central finite differences along one seeded direction at eps 1e-3 and
   3e-4: printed, not gated. The pooled loss is piecewise linear with a
   dense set of max-pool kinks at these shapes, so a finite difference
   carries a kink-crossing bias of order eps, which the mirror's own
   autograd shows alike.

The draws are the JAX script's, in its order, from numpy's default_rng(0):
the map, each image's RoIs, the cotangent, then the direction.

Exits 1 on a failed gate; prints ROI VJP GRADCHECK OK at the end.

Usage (on the card; no fallback):
    python -m fasterrcnn_torch.scripts.gradcheck_roi_vjp
    FRCNN_GRADCHECK_C=1024 python -m fasterrcnn_torch.scripts.gradcheck_roi_vjp
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

IMG_H, IMG_W = 600.0, 800.0
REAL_FH, REAL_FW = 37, 50
H, W = 38, 50
CROP, OUT = 14, 7
MIRROR_GATE, PLAIN_GATE = 5e-5, 1e-3


def random_rois(rng, n):
    y1 = rng.uniform(0, IMG_H * 0.8, n)
    x1 = rng.uniform(0, IMG_W * 0.8, n)
    y2 = y1 + rng.uniform(16, IMG_H * 0.4, n)
    x2 = x1 + rng.uniform(16, IMG_W * 0.4, n)
    return np.stack([y1, x1, np.minimum(y2, IMG_H), np.minimum(x2, IMG_W)], 1).astype(np.float32)


def mirror(fm: torch.Tensor, rois_fg: torch.Tensor) -> torch.Tensor:
    """JAX's `mirror_one` over every RoI: (B, H, W, C) map, (B, P, 4) RoIs
    in feature-grid coordinates -> (B, P, 7, 7, C)."""
    _, h, w, c = fm.shape
    b, p = rois_fg.shape[:2]
    steps = torch.arange(CROP, dtype=torch.float32, device=fm.device) / (CROP - 1)

    def interp(pos, size):
        lo = torch.floor(pos)
        frac = pos - lo
        idx = torch.arange(size, dtype=torch.float32, device=fm.device)
        sheet = (torch.where(idx == lo[..., None], 1.0 - frac[..., None], 0.0)
                 + torch.where(idx == lo[..., None] + 1.0, frac[..., None], 0.0))
        return sheet * ((pos >= 0.0) & (pos <= size - 1.0))[..., None]

    ys = rois_fg[..., 0:1] + (rois_fg[..., 2:3] - rois_fg[..., 0:1]) * steps  # (B, P, S)
    xs = rois_fg[..., 1:2] + (rois_fg[..., 3:4] - rois_fg[..., 1:2]) * steps
    wy = interp(ys, h).to(fm.dtype)  # (B, P, S, H)
    rows = torch.einsum("bpsh,bhwc->bpswc", wy, fm)
    in_r = ((xs >= 0.0) & (xs <= w - 1.0)).float()
    xlo_f = torch.clamp(torch.floor(xs), 0.0, w - 2.0)
    f = xs - xlo_f
    xlo = xlo_f.long()
    index = xlo[:, :, None, :, None].expand(b, p, CROP, CROP, c)
    seg_lo = torch.gather(rows, 3, index)
    seg_hi = torch.gather(rows, 3, index + 1)
    col = seg_lo * ((1.0 - f) * in_r)[:, :, None, :, None] + seg_hi * (f * in_r)[:, :, None, :, None]
    yp = col.reshape(b, p, OUT, 2, CROP, c).amax(dim=3)
    return yp.reshape(b, p, OUT, OUT, 2, c).amax(dim=4)


def mirror_one(fm_i: torch.Tensor, roi: torch.Tensor) -> torch.Tensor:
    """`mirror` of one (H, W, C) map and one RoI (4,) -> (7, 7, C)."""
    return mirror(fm_i[None], roi[None, None])[0, 0]


def mismatch(got: np.ndarray, want: np.ndarray) -> float:
    """Share of elements more than 1e-2 off, relative to max(|want|, 1e-3)."""
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-3) > 1e-2).mean())


def gradcheck(device="cuda", b: int = 4, p: int = 128, c: Optional[int] = None) -> Dict:
    """The three checks; returns their numbers and `ok` (both gates held)."""
    from fasterrcnn_torch.ops import roi as roi_ops

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() is false")
    c = int(os.environ.get("FRCNN_GRADCHECK_C", "512")) if c is None else c
    rng = np.random.default_rng(0)
    fm = rng.normal(size=(b, H, W, c)).astype(np.float32)
    rois = np.stack([random_rois(rng, p) for _ in range(b)])
    norm = np.tile([[(REAL_FH - 1) / IMG_H, (REAL_FW - 1) / IMG_W]], (b, 1)).astype(np.float32)
    cot = rng.normal(size=(b, p, OUT, OUT, c)).astype(np.float32)
    rois_fg = (rois * norm[:, (0, 1, 0, 1)][:, None, :]).astype(np.float32)
    rois_t, norm_t, rois_fg_t, cot_t = (torch.as_tensor(a, device=dev) for a in (rois, norm, rois_fg, cot))

    def loss_kernel(x):
        return torch.sum(roi_ops.roi_pool_taps(x, rois_t, norm_t) * cot_t)

    def loss_mirror(x):
        return torch.sum(mirror(x, rois_fg_t) * cot_t)

    def loss_plain(x):
        return torch.sum(roi_ops.roi_pool_features(x, rois_t, norm_t) * cot_t)

    def value_and_grad(loss, x):
        x = torch.as_tensor(x, device=dev).requires_grad_(True)
        value = loss(x)
        (grad,) = torch.autograd.grad(value, x)
        return float(value.detach()), grad.cpu().numpy()

    out: Dict = {"device": str(dev), "b": b, "p": p, "c": c}
    # The mirror's and the plain version's products in full f32, as JAX's
    # Precision.HIGHEST.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (out["forward_kernel"], g_k), (out["forward_mirror"], g_m), (out["forward_plain"], g_p) = (
            value_and_grad(loss, fm) for loss in (loss_kernel, loss_mirror, loss_plain))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print("forward: kernel %.6f mirror %.6f plain %.6f"
          % (out["forward_kernel"], out["forward_mirror"], out["forward_plain"]), flush=True)

    out["vs_mirror"] = mismatch(g_k, g_m)
    print("vs mirror:  frac(rel>1e-2) = %.2e (gate %.0e)" % (out["vs_mirror"], MIRROR_GATE), flush=True)
    out["vs_plain"] = mismatch(g_k, g_p)
    print("vs plain:   frac(rel>1e-2) = %.2e (gate %.0e)" % (out["vs_plain"], PLAIN_GATE), flush=True)
    out["ok"] = out["vs_mirror"] < MIRROR_GATE and out["vs_plain"] < PLAIN_GATE

    d = rng.normal(size=fm.shape).astype(np.float32)
    analytic = float(np.sum(g_k * d))
    out["fd"] = []
    with torch.no_grad():
        for eps in (1e-3, 3e-4):
            lp = float(loss_kernel(torch.as_tensor(fm + eps * d, device=dev)))
            lm = float(loss_kernel(torch.as_tensor(fm - eps * d, device=dev)))
            est = (lp - lm) / (2 * eps)
            rel = abs(est - analytic) / abs(est)
            out["fd"].append({"eps": eps, "fd": est, "analytic": analytic, "rel": rel})
            print("fd eps %.0e: fd %.2f analytic %.2f rel %.2e (kink-bias, O(eps))" % (eps, est, analytic, rel),
                  flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    options = ap.parse_args(argv)
    out = gradcheck(options.device)
    if not out["ok"]:
        print("ROI VJP GRADCHECK FAILED", flush=True)
        sys.exit(1)
    print("ROI VJP GRADCHECK OK", flush=True)
    return out


if __name__ == "__main__":
    main()
