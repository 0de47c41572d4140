"""One train step's gradients on the card against the same step on the CPU.

The tiny config with every anchor a proposal and every box sampled
(`every_box_config`: the boxes a step trains on then do not hang on
near-tied scores), full-width VGG-16 (or, through `run_draw`'s arguments,
another backbone, in from-scratch mode) on a 128x160 canvas, B=2: the same
seeded weights (`init_params(seed=1)`), the same sampling uniforms and the
same batch on both sides, the CPU running the plain versions and the card
the kernels, TF32 off. Each draw's batch comes from its own
`np.random.default_rng(seed)`: random pixels in the top-left 64x80 of each
image (zeros elsewhere, as a padded canvas has), two and one boxes.

For each draw the script prints one JSON line: the four losses' largest
relative difference, every gradient's relative norm |g_card - g_cpu| /
|g_cpu| (`worst` and `worst_tensor`), and where the gap is born:

  backbone_side  the worst relative norm of the backbone's gradients when
                 the card's backbone runs its backward from the CPU's
                 feature-map cotangent (the convs' forward and backward on
                 the card, TF32 off)
  head_side      the same with the CPU's backbone run backward from the
                 card's feature-map cotangent (RPN head, losses, RoI stage
                 and detector heads on the card)
  roi_cotangent  the RoI backward's output, card (K3 on the card's inputs)
                 against CPU (the plain version on the CPU's inputs), in
                 relative norm; `k3_vs_plain` the same on the card's own
                 inputs (K3's own error), `roi_by_ties` with the CPU's
                 cotangent on both sides (the tie decisions and shares that
                 the two feature maps' last bits move)
  tie_flips      (window, channel) pairs of the RoI stage whose set of tied
                 maxima differs between the card's and the CPU's map
  pool_flips     per backbone max pool, the windows whose argmax (the input
                 its backward routes the gradient to) differs between the
                 card's forward and the CPU's: `by_values` from the two
                 inputs' last bits (both argmaxes taken on the CPU),
                 `by_tie_rule` from the two devices' max_pool2d on the
                 card's input alone (exact ties broken differently), and
                 `exact_ties` the windows of the CPU's input with a tied max

Then a summary line: the worst over the draws and how many exceed
TOLERANCE (3e-3, the bound `chip_smoke.py` holds one draw to).

The script imports only the port's models and ops, so it can run another
checkout's kernels on the same draws:
`PYTHONPATH=<checkout> python fasterrcnn_torch/scripts/reference_train.py`.

Usage (on the card; no fallback):
    python -m fasterrcnn_torch.scripts.reference_train [--draws 24] [--first-seed 0] [--diagnose]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

TOLERANCE = 3e-3


def every_box_config(backbone: str = "vgg16", train_all: bool = False):
    """The tiny config with every anchor a proposal (no NMS suppression, no
    size filter, caps above the 720 anchors of the 128x160 canvas) and every
    anchor and proposal sampled."""
    from fasterrcnn_torch.config import AnchorConfig, DetectorConfig, ModelConfig, RPNConfig

    return ModelConfig(
        backbone=backbone,
        train_all=train_all,
        anchors=AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=RPNConfig(pre_nms_train=720, post_nms_train=720, nms_iou_threshold=1.0, min_proposal_side=0.0,
                      minibatch_size=720, max_positive_fraction=1.0),
        detector=DetectorConfig(proposal_batch_size=256, positive_fraction=1.0),
        max_gt_boxes=8,
    )


def host_batch(seed: int):
    import torch
    from fasterrcnn_torch.models import faster_rcnn as frcnn

    rng = np.random.default_rng(seed)
    images = np.zeros((2, 128, 160, 3), np.uint8)
    images[:, :64, :80] = rng.integers(0, 255, (2, 64, 80, 3), dtype=np.uint8)
    gt_boxes = np.zeros((2, 8, 4), np.float32)
    gt_boxes[0, :2] = [[5, 8, 40, 50], [20, 30, 60, 78]]
    gt_boxes[1, :1] = [[10, 10, 50, 60]]
    gt_mask = (gt_boxes[..., 2] > 0).astype(np.float32)
    return frcnn.Batch(
        images=torch.from_numpy(images), image_hw=torch.tensor([[64.0, 80.0]] * 2),
        gt_boxes=torch.from_numpy(gt_boxes), gt_classes=torch.from_numpy((gt_mask * 7).astype(np.int32)),
        gt_mask=torch.from_numpy(gt_mask), sample_weight=torch.ones(2),
    )


def rel_norm(a, b) -> float:
    return float((a.cpu().float() - b.cpu().float()).norm() / b.cpu().float().norm().clamp_min(1e-30))


def _step(model, cfg, grid, host, draws, device):
    """One step's losses and gradients on `device`, with the feature map,
    its cotangent and the RoI stage's inputs and cotangent recorded."""
    import torch
    from fasterrcnn_torch.models import faster_rcnn as frcnn

    rec = {}

    def keep_fm(_, __, fm):
        fm.retain_grad()
        rec["fm"] = fm

    def keep_rois(fm, boxes, hw):
        rec["rois"], rec["norm"] = boxes, model.roi_norm(hw)
        return frcnn.FasterRCNN.detect_rois(model, fm, boxes, hw)

    def keep_pooled(_, args):
        args[0].register_hook(lambda g: rec.__setitem__("g", g.reshape(rec["rois"].shape[:2] + g.shape[1:])))

    hooks = [model.feature_extractor.register_forward_hook(keep_fm),
             model.roi_head.register_forward_pre_hook(keep_pooled)]
    model.detect_rois = keep_rois
    try:
        model.train()
        model.zero_grad(set_to_none=True)
        batch = frcnn.Batch(*(t.to(device) for t in host))
        d = frcnn.TrainDraws(*(tuple(u.to(device) for u in pair) for pair in draws))
        total, losses = frcnn.compute_losses(model, batch, grid, draws=d)
        total.backward()
    finally:
        for h in hooks:
            h.remove()
        del model.detect_rois
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    return [v.item() for v in losses], grads, rec


def _backbone_grads(model, images, cot) -> Dict[str, object]:
    """Backbone parameter gradients of the feature map's backward from `cot`."""
    from fasterrcnn_torch.models.backbone import normalize_images

    model.zero_grad(set_to_none=True)
    x = normalize_images(images, model.spec.preprocessing, model.cfg.torch_dtype)
    model.feature_extractor(x).backward(cot)
    return {n: p.grad.detach().cpu() for n, p in model.feature_extractor.named_parameters() if p.grad is not None}


def _pool_inputs(model, images) -> List[object]:
    """The inputs of the backbone's max pools in one forward."""
    import torch
    import torch.nn.functional as F

    seen, pool = [], F.max_pool2d

    def record(x, *args, **kwargs):
        seen.append(x.detach())
        return pool(x, *args, **kwargs)

    F.max_pool2d = record
    try:
        with torch.no_grad():
            model.features_and_rpn(images)
    finally:
        F.max_pool2d = pool
    return seen


def _pool_flips(cpu, card, images, dev) -> List[Dict[str, int]]:
    import torch.nn.functional as F

    flips = []
    for x_cpu, x_card in zip(_pool_inputs(cpu, images), _pool_inputs(card, images.to(dev))):
        x_card_cpu = x_card.cpu().contiguous()
        idx_cpu = F.max_pool2d(x_cpu, 2, 2, return_indices=True)[1]
        idx_card_values = F.max_pool2d(x_card_cpu, 2, 2, return_indices=True)[1]
        idx_card_rule = F.max_pool2d(x_card, 2, 2, return_indices=True)[1].cpu()
        top = F.max_pool2d(x_cpu, 2, 2)
        hits = (F.interpolate(top, scale_factor=2.0, mode="nearest") == x_cpu[..., : 2 * top.shape[-2], : 2 * top.shape[-1]])
        ties = F.avg_pool2d(hits.float(), 2, 2) > 0.25
        flips.append(dict(
            windows=idx_cpu.numel(), by_values=int((idx_card_values != idx_cpu).sum()),
            by_tie_rule=int((idx_card_rule != idx_card_values).sum()), exact_ties=int(ties.sum()),
        ))
    return flips


def run_draw(
    dev, seed: int, diagnose: bool = False, backbone: str = "vgg16", train_all: bool = False
) -> Dict[str, object]:
    """Card against CPU on the batch of one seed; see the module docstring.
    `diagnose` reads VGG-16's 2x2 max pools."""
    import torch
    from fasterrcnn_torch.models import faster_rcnn as frcnn
    from fasterrcnn_torch.ops import roi as roi_ops

    if diagnose and not backbone.startswith("vgg16"):
        raise ValueError(f"--diagnose reads VGG-16's max pools, not {backbone}'s")
    cfg = every_box_config(backbone, train_all)
    cpu = frcnn.FasterRCNN(cfg)
    frcnn.init_params(cpu, seed=1)
    card = frcnn.FasterRCNN(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, memory_format=torch.channels_last)
    grid = frcnn.anchor_grid_for(cfg, 128, 160)
    host = host_batch(seed)
    draws = frcnn.draw_train_uniforms(cfg, grid, 2, torch.Generator().manual_seed(0), "cpu")
    cpu_losses, cpu_grads, cpu_rec = _step(cpu, cfg, grid, host, draws, "cpu")
    card_losses, card_grads, card_rec = _step(card, cfg, grid, host, draws, dev)
    if card_grads.keys() != cpu_grads.keys() or not cpu_grads:
        raise RuntimeError("card and CPU gradient sets differ")
    rel = {n: rel_norm(card_grads[n], g) for n, g in cpu_grads.items()}
    worst = max(rel, key=rel.get)
    row = dict(
        seed=seed, losses_cpu=cpu_losses, losses_card=card_losses,
        loss_rel_max=max(abs(a - c) / abs(c) for a, c in zip(card_losses, cpu_losses)),
        worst=rel[worst], worst_tensor=worst, tensors=len(rel),
    )
    if diagnose:
        prefix = "feature_extractor."
        cpu_cot, card_cot = cpu_rec["fm"].grad.detach(), card_rec["fm"].grad.detach()
        head = _backbone_grads(cpu, host.images, card_cot.cpu().contiguous())
        back = _backbone_grads(card, host.images.to(dev), cpu_cot.to(dev).contiguous(memory_format=torch.channels_last))
        on_cpu = {k: v.detach().cpu() for k, v in card_rec.items()}
        fm_c, fm_g = cpu_rec["fm"].detach(), on_cpu["fm"]
        plain = roi_ops.roi_pool_taps_bwd_plain
        roi_cpu = plain(fm_c, cpu_rec["rois"], cpu_rec["norm"], cpu_rec["g"])
        k3 = roi_ops.roi_pool_taps_bwd(card_rec["fm"].detach().contiguous(), card_rec["rois"], card_rec["norm"],
                                       card_rec["g"].contiguous())
        c = fm_c.shape[-1]
        windows = []
        for fm, rec in ((fm_c, cpu_rec), (fm_g, on_cpu)):
            w = roi_ops.crop_and_resize(fm, rec["rois"].cpu(), rec["norm"].cpu()).reshape(*rec["rois"].shape[:2], 7, 2, 7, 2, c)
            windows.append(w == w.amax(dim=(3, 5), keepdim=True))
        row.update(
            fm_cotangent=rel_norm(card_cot, cpu_cot),
            backbone_side=max(rel_norm(back[n], cpu_grads[prefix + n]) for n in back),
            head_side=max(rel_norm(head[n], cpu_grads[prefix + n]) for n in head),
            roi_cotangent=rel_norm(k3, roi_cpu),
            k3_vs_plain=rel_norm(k3, plain(fm_g, on_cpu["rois"], on_cpu["norm"], on_cpu["g"])),
            roi_by_ties=rel_norm(plain(fm_g, on_cpu["rois"], on_cpu["norm"], cpu_rec["g"]), roi_cpu),
            tie_flips=int((windows[0] != windows[1]).any(dim=(3, 5)).sum().item()),
            pool_flips=_pool_flips(cpu, card, host.images, dev),
        )
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=24)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--diagnose", action="store_true", help="also where each draw's gap is born")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("reference_train: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    for seed in range(args.first_seed, args.first_seed + args.draws):
        rows.append(run_draw(dev, seed, args.diagnose))
        print(json.dumps(rows[-1]), flush=True)
    worst = max(rows, key=lambda r: r["worst"])
    print(json.dumps(dict(
        draws=len(rows), worst=worst["worst"], worst_seed=worst["seed"], worst_tensor=worst["worst_tensor"],
        above_tolerance=sum(r["worst"] > TOLERANCE for r in rows), tolerance=TOLERANCE,
        card=torch.cuda.get_device_name(0),
    )), flush=True)
    return rows


if __name__ == "__main__":
    main()
