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
    python -m fasterrcnn_torch.scripts.reference_train --graph-vs-eager 10
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


class StepRows:
    """A TrainingStatistics stand-in for `Engine.train_epoch` that keeps
    every step's loss row."""

    def __init__(self):
        self.rows = []
        self._count = 0

    def on_training_step_values(self, row):
        self.rows.append(np.asarray(row, np.float64))
        self._count += 1

    def get_progbar_postfix(self):
        return {}


def _train_tensors(engine):
    from fasterrcnn_torch.models.faster_rcnn import train_tensors

    return train_tensors(engine.model, engine.optimizer)


def train_state(engine):
    """Everything an engine's train step reads and writes: parameters,
    buffers, optimizer state, the sampling generator's and the card's
    default generator's states."""
    import torch

    return ([t.detach().clone() for t in _train_tensors(engine)], engine.generator.get_state(),
            torch.cuda.get_rng_state())


def load_train_state(engine, state) -> None:
    import torch

    values, gen, default = state
    with torch.no_grad():
        for t, v in zip(_train_tensors(engine), values):
            t.copy_(v)
    engine.generator.set_state(gen)
    torch.cuda.set_rng_state(default)
    engine._global_step = 0


def graph_against_eager(replicas: int = 6, graph_replays: int = 5) -> Dict:
    """The captured train programs (`Engine.train_epoch`, FRCNN_SCAN_STEPS=2
    and =1) against eager `Engine.train_step` on the card, on the every-box
    config, f32 with TF32 off, SGD under a cosine schedule, 5 batches of 2.

    Eager runs on the card differ from run to run (K3's float reductions and
    cuDNN's backward are not deterministic), and a trajectory amplifies
    that: once a decoded proposal crosses an IoU threshold, a label flips,
    the detector loss moves by ~1e-4 in about a quarter of the runs, and the
    parameters part with it (the largest gap between two eager runs' final
    parameters came out between 3.2e-7 and 8.2e-7 from call to call). Two
    samples of such a spread bound nothing, so the checks are:

      * trajectories: `replicas` eager runs and the two `train_epoch` runs
        from the same first state; step 0's losses identical everywhere (the
        later losses and the final parameters are reported beside the eager
        runs' spread, not checked);
      * teacher-forced programs: before each program (a 2-step block or a
        single step) `replicas - 1` eager replicas, and the graph engine
        before each of its `graph_replays` replays, are put into the eager
        reference's state; the program's first losses must be identical in
        every run and replay, and its later losses and the parameters after
        it within twice the largest gap between two eager replicas over the
        programs of both runs (one backward's nondeterminism, a few ulps,
        measured on every program), in the replay closest to the reference
        (losses and parameters each). A replay is one more draw of that
        nondeterminism, so one replay alone can land outside the bound when
        the eager runs happen to agree (a loss near 3 moves in ulps of
        2.4e-7; `--graph-vs-eager N` counts how often), while a capture
        that differs from the eager program does so in every replay;
      * the packed program, step by step: the learning rate of each step
        and the sampling generator's offset after it equal the eager run's
        (every replay draws afresh).

    Returns the measurements and `failures`, one message per failed check.
    """
    import os

    import torch
    from fasterrcnn_torch.config import TrainConfig
    from fasterrcnn_torch.data.pipeline import batched
    from fasterrcnn_torch.data.synthetic import SyntheticDataset
    from fasterrcnn_torch.engine import Engine, warmup_cosine_factor
    from fasterrcnn_torch.models.faster_rcnn import pack_aux

    cfg = every_box_config()
    train_cfg = TrainConfig(learning_rate=1e-3, lr_schedule="cosine", warmup_steps=2, total_steps=6)

    def data():
        return SyntheticDataset(num_samples=10, height=120, width=150, seed=3)

    host = list(batched(iter(data()), 2, cfg.max_gt_boxes))
    canvas = host[0].canvas_hw
    dev = torch.device("cuda")
    failures = []

    def params(engine):
        return [p.detach().clone() for p in engine.model.parameters()]

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def eager_rows(engine, batches):
        return np.array([[v.item() for v in engine.train_step(hb)] for hb in batches])

    ref, replica = Engine(cfg, train_cfg, seed=0), Engine(cfg, train_cfg, seed=0)
    graphs = {k: Engine(cfg, train_cfg, seed=0) for k in (2, 1)}
    first = train_state(ref)

    # Trajectories from the first state.
    eager = []
    for _ in range(replicas):
        load_train_state(replica, first)
        eager.append((eager_rows(replica, host), params(replica)))
    param_spread = max(gap(a[1], b[1]) for i, a in enumerate(eager) for b in eager[i + 1:])
    loss_spread = max(float(np.abs(a[0] - b[0]).max()) for i, a in enumerate(eager) for b in eager[i + 1:])
    out = {"eager_param_spread": param_spread, "eager_loss_spread": loss_spread}
    for k, engine in graphs.items():
        load_train_state(engine, first)
        log = StepRows()
        os.environ["FRCNN_SCAN_STEPS"] = str(k)
        try:
            engine.train_epoch(data(), batch_size=2, stats=log)
        finally:
            del os.environ["FRCNN_SCAN_STEPS"]
        rows = np.array(log.rows)
        programs = [engine.packed_step_for(canvas), *engine._scan_steps.values()]
        if not all(p.captured_step.graphs for p in programs):
            failures.append(f"FRCNN_SCAN_STEPS={k}: a program ran uncaptured")
        if rows.shape != (5, 4) or not np.array_equal(rows[0], eager[0][0][0]):
            failures.append(f"FRCNN_SCAN_STEPS={k}: step 0 losses {rows[:1]} != eager {eager[0][0][0]}")
            continue
        out[f"trajectory_scan_steps_{k}"] = {
            "loss_gap": float(np.abs(rows[1:] - eager[0][0][1:]).max()), "param_gap": gap(params(engine), eager[0][1]),
            "last_epoch_trace": dict(engine.last_epoch_trace)}

    # Teacher-forced programs.
    graph_gaps = {k: [0.0, 0.0] for k in graphs}  # (later losses, parameters), the closest replay
    first_gaps = {k: [0.0, 0.0] for k in graphs}  # the same, the first replay alone
    spreads = [0.0, 0.0]
    for k, engine in graphs.items():
        load_train_state(ref, first)
        for start in range(0, len(host), k):
            block = host[start:start + k]
            state = train_state(ref)
            runs = [(eager_rows(ref, block), params(ref))]
            after = train_state(ref)
            for _ in range(replicas - 1):
                load_train_state(replica, state)
                runs.append((eager_rows(replica, block), params(replica)))
            images = torch.as_tensor(np.stack([hb.images for hb in block]), device=dev)
            aux = torch.as_tensor(np.stack([pack_aux(hb, start + i) for i, hb in enumerate(block)]), device=dev)
            graph_runs = []
            for _ in range(graph_replays):
                load_train_state(engine, state)
                if len(block) == k and k > 1:
                    rows = engine.scan_step_for(canvas, k)(images, aux).cpu().numpy()
                else:
                    rows = engine.packed_step_for(canvas)(images[0], aux[0])[1][None].cpu().numpy()
                graph_runs.append((rows.astype(np.float64), params(engine)))
            if any(not np.array_equal(r[0][0], runs[0][0][0]) for r in (*runs[1:], *graph_runs)):
                failures.append(f"FRCNN_SCAN_STEPS={k}, program at step {start}: first losses differ")
            gaps = graph_gaps[k]
            gaps[0] = max(gaps[0], min(float(np.abs(g[0][1:] - runs[0][0][1:]).max(initial=0.0)) for g in graph_runs))
            gaps[1] = max(gaps[1], min(gap(g[1], runs[0][1]) for g in graph_runs))
            alone = first_gaps[k]
            alone[0] = max(alone[0], float(np.abs(graph_runs[0][0][1:] - runs[0][0][1:]).max(initial=0.0)))
            alone[1] = max(alone[1], gap(graph_runs[0][1], runs[0][1]))
            for i, a in enumerate(runs):
                for b in runs[i + 1:]:
                    spreads[0] = max(spreads[0], float(np.abs(a[0][1:] - b[0][1:]).max(initial=0.0)))
                    spreads[1] = max(spreads[1], gap(a[1], b[1]))
            load_train_state(ref, after)
    out["teacher_forced_eager_spread"] = {"loss": spreads[0], "param": spreads[1]}
    for k, (loss_gap, param_gap) in graph_gaps.items():
        alone = first_gaps[k]
        out[f"teacher_forced_scan_steps_{k}"] = {
            "loss_gap": loss_gap, "param_gap": param_gap, "first_replay_loss_gap": alone[0],
            "first_replay_param_gap": alone[1],
            "first_replay_over": alone[0] > 2 * spreads[0] or alone[1] > 2 * spreads[1]}
        if loss_gap > 2 * spreads[0] or param_gap > 2 * spreads[1]:
            failures.append(f"FRCNN_SCAN_STEPS={k}, teacher-forced: graph gaps {loss_gap}, {param_gap} over twice "
                            f"the eager spreads {spreads}")

    # The packed program step by step: learning rates and generator offsets.
    engine = graphs[1]
    load_train_state(ref, first)
    load_train_state(engine, first)
    lrs, offsets, graph_lrs, graph_offsets = [], [], [], []
    step = engine.packed_step_for(canvas)
    for i, hb in enumerate(host):
        ref.train_step(hb)
        lrs.append(ref.optimizer.lr.item())
        offsets.append(ref.generator.get_offset())
        step(torch.as_tensor(hb.images, device=dev), torch.as_tensor(pack_aux(hb, i), device=dev))
        graph_lrs.append(engine.optimizer.lr.item())
        graph_offsets.append(engine.generator.get_offset())
    want = [float(np.float32(1e-3 * warmup_cosine_factor(i, 2, 6))) for i in range(len(host))]
    if not lrs == graph_lrs == want:
        failures.append(f"learning rates: eager {lrs}, graph {graph_lrs}, schedule {want}")
    if graph_offsets != offsets or not all(b > a for a, b in zip(offsets, offsets[1:])):
        failures.append(f"generator offsets: eager {offsets}, graph {graph_offsets}")
    out.update(learning_rates=graph_lrs, generator_offsets=graph_offsets, failures=failures)
    return out


def graph_against_eager_runs(n: int) -> List[Dict]:
    """`graph_against_eager` `n` times: one JSON line each, then how many
    runs failed a check and how many would have failed the teacher-forced
    check had it read only the first replay of each program."""
    import torch

    rows = []
    for _ in range(n):
        rows.append(graph_against_eager())
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(dict(
        runs=n, failed=sum(bool(r["failures"]) for r in rows),
        first_replay_over=sum(any(v["first_replay_over"] for k, v in r.items() if k.startswith("teacher_forced_scan"))
                              for r in rows),
        card=torch.cuda.get_device_name(0),
    )), flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=24)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--diagnose", action="store_true", help="also where each draw's gap is born")
    ap.add_argument("--graph-vs-eager", type=int, default=0, metavar="N",
                    help="instead: run graph_against_eager N times and count the failed checks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("reference_train: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.graph_vs_eager:
        return graph_against_eager_runs(args.graph_vs_eager)
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
