"""Command-line entry point: python -m fasterrcnn_torch --help

The body of the CLI; `fasterrcnn_torch/__main__.py` runs `main` from here.
It lives in an importable module because --num-devices spawns its ranks
with `parallel/mesh.spawn`, which pickles `run_rank` by its import path: a
spawned child imports `fasterrcnn_torch.cli`, where it could not re-import a
package's `__main__`.

The JAX package's CLI (`fasterrcnn_tpu/__main__.py`) with the same flags and
defaults: the procedures --train / --eval / --predict / --predict-to-file /
--predict-all / --dump-anchors, the hyperparameter and optimizer flags,
--batch-size, --compute-dtype, --synthetic and --tiny. One flag is the
port's own: --device (default cuda; "cpu" asks for the CPU). There is no
fallback: --device cuda without a card raises.

The diagnostics are the JAX CLI's: --memory-stats prints the device
memory and each train step's memory after the first epoch, --debug-nans
raises at the first NaN (autograd anomaly mode; the train loop then runs
uncaptured, and says so), --profile-dir writes a torch.profiler trace of the
first epoch's steps.

--num-devices N above 1 runs N ranks, one process each, on a (dp, tp) mesh
of N / T rows of --tp T ranks (`parallel/mesh.py`, JAX's grid): on the
first N CUDA devices, one a rank, over nccl, or with --device cpu on N CPU
ranks over gloo. --tp T above 1 shards the detector head across each row
(`parallel/tp.py`); without --num-devices it takes every CUDA device, as
the JAX CLI does, or T CPU ranks with --device cpu. Rank 0 alone prints
and writes files (weights, checkpoints, the CSV, traces, predictions);
--predict, --predict-to-file and --predict-all run on rank 0's tp row,
which holds one model between its ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("fasterrcnn_torch")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--train", action="store_true", help="Train model")
    group.add_argument("--eval", action="store_true", help="Evaluate model")
    group.add_argument("--predict", metavar="url", type=str,
                       help="Run inference on image and display detected boxes")
    group.add_argument("--predict-to-file", metavar="url", type=str,
                       help="Run inference and render boxes to 'predictions.png'")
    group.add_argument("--predict-all", metavar="name", type=str,
                       help="Run inference on all images in a split, write to "
                            "'predictions_<split>/'")
    parser.add_argument("--load-from", metavar="file",
                        help="Load initial model weights from file (the port's "
                             ".pth, the JAX package's msgpack, Caffe/torchvision/"
                             "Keras VGG-16, torchvision ResNet, or full "
                             "reference .pth checkpoint)")
    parser.add_argument("--backbone", metavar="model", default="vgg16",
                        choices=["vgg16", "vgg16-torch", "resnet50",
                                 "resnet101", "resnet152"],
                        help="Backbone model for feature extraction")
    parser.add_argument("--save-to", metavar="file",
                        help="Save final trained weights to file")
    parser.add_argument("--save-best-to", metavar="file",
                        help="Save best weights (highest mAP) to file")
    parser.add_argument("--dataset-dir", metavar="dir", default="VOCdevkit/VOC2007",
                        help="VOC dataset directory")
    parser.add_argument("--train-split", metavar="name", default="trainval")
    parser.add_argument("--eval-split", metavar="name", default="test")
    parser.add_argument("--cache-images", action="store_true",
                        help="Cache resized images in memory across epochs")
    parser.add_argument("--periodic-eval-samples", metavar="count", type=int,
                        default=1000, help="Eval sample count after each epoch")
    parser.add_argument("--checkpoint-dir", metavar="dir",
                        help="Save per-epoch checkpoints into this directory "
                             "(enables --resume)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume weights from the newest checkpoint in "
                             "--checkpoint-dir (optimizer restarts fresh, "
                             "honoring the current --learning-rate)")
    parser.add_argument("--plot", action="store_true",
                        help="Plot per-class average precision after eval")
    parser.add_argument("--log-csv", metavar="file",
                        help="Log training metrics to CSV file")
    parser.add_argument("--epochs", metavar="count", type=int, default=1)
    parser.add_argument("--learning-rate", metavar="value", type=float, default=1e-3)
    parser.add_argument("--momentum", metavar="value", type=float, default=0.9)
    parser.add_argument("--weight-decay", metavar="value", type=float, default=5e-4)
    parser.add_argument("--dropout", metavar="probability", type=float, default=0.0,
                        help="Dropout after the two detector FC layers (VGG-16)")
    parser.add_argument("--optimizer", metavar="name", default="sgd",
                        choices=["sgd", "adam"], help="Optimizer")
    parser.add_argument("--clipnorm", metavar="value", type=float, default=0.0,
                        help="Gradient norm clipping")
    parser.add_argument("--beta1", metavar="value", type=float, default=0.9)
    parser.add_argument("--beta2", metavar="value", type=float, default=0.999)
    parser.add_argument("--lr-schedule", metavar="name", default="constant",
                        choices=["constant", "cosine"],
                        help="Learning-rate schedule: constant (reference "
                             "behavior) or cosine (linear warmup over "
                             "--warmup-steps, cosine decay to 0 over the "
                             "whole run; the from-scratch recipe)")
    parser.add_argument("--warmup-steps", metavar="n", type=int, default=0,
                        help="Linear LR warmup steps (cosine schedule only)")
    parser.add_argument("--train-all", action="store_true",
                        help="Train every parameter (from-scratch mode): "
                             "disable the backbone freeze patterns, which "
                             "exist to protect pretrained weights")
    parser.add_argument("--no-augment", action="store_true",
                        help="Disable random horizontal flips during training")
    parser.add_argument("--exclude-edge-proposals", action="store_true",
                        help="Exclude proposals at image-boundary anchors")
    parser.add_argument("--dump-anchors", metavar="dir",
                        help="Render anchors + ground truth from the training "
                             "set into a directory")
    parser.add_argument("--batch-size", metavar="n", type=int, default=1,
                        help="Training batch size (per canvas bucket)")
    parser.add_argument("--eval-batch-size", metavar="n", type=int, default=8)
    parser.add_argument("--compute-dtype", metavar="dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="Conv/matmul compute dtype")
    parser.add_argument("--synthetic", metavar="count", type=int, default=0,
                        help="Use a synthetic dataset of N samples instead of "
                             "VOC (no dataset required)")
    parser.add_argument("--seed", metavar="n", type=int, default=0)
    parser.add_argument("--custom-roi-pool", action="store_true",
                        help="Use exact RoIPool quantization instead of "
                             "crop-and-resize (use when loading RoIPool-trained "
                             "reference checkpoints)")
    parser.add_argument("--tiny", action="store_true",
                        help="Smoke-test mode: small synthetic images and "
                             "reduced proposal caps")
    parser.add_argument("--memory-stats", action="store_true",
                        help="Print device memory and the train step's "
                             "memory after the first epoch")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Raise at the first NaN-producing op (autograd "
                             "anomaly mode; the train loop runs uncaptured)")
    parser.add_argument("--profile-dir", metavar="dir",
                        help="Write a torch.profiler trace of the first "
                             "epoch's training steps into this directory")
    parser.add_argument("--num-devices", metavar="n", type=int, default=0,
                        help="Shard work over n ranks, one process each, of a "
                             "(dp, tp) mesh (0 or 1 = one device): the first n "
                             "CUDA devices over nccl, or n CPU ranks over gloo "
                             "with --device cpu. Batch sizes must divide by n/tp")
    parser.add_argument("--tp", metavar="n", type=int, default=1,
                        help="Tensor-parallel extent of the mesh (megatron "
                             "split of the detector fc pair, or of ResNet's "
                             "layer4); must divide --num-devices")
    parser.add_argument("--device", metavar="name", default="cuda",
                        help="Torch device to run on: cuda (default) or cpu")
    return parser


def make_datasets(options):
    """(train_dataset, eval_dataset) per flags; synthetic fallback."""
    if options.synthetic:
        from fasterrcnn_torch.data.synthetic import SyntheticDataset

        h, w = (120, 150) if options.tiny else (600, 800)
        train = SyntheticDataset(num_samples=options.synthetic, height=h,
                                 width=w, seed=options.seed)
        evald = SyntheticDataset(num_samples=max(options.synthetic // 4, 1),
                                 height=h, width=w, seed=options.seed + 1)
        return train, evald

    from fasterrcnn_torch.data.voc import Dataset

    train = Dataset(
        split=options.train_split,
        dir=options.dataset_dir,
        augment=not options.no_augment,
        shuffle=True,
        cache=options.cache_images,
        seed=options.seed,
    )
    evald = Dataset(
        split=options.eval_split,
        dir=options.dataset_dir,
        augment=False,
        shuffle=False,
        cache=False,
    )
    return train, evald


def main(argv=None):
    options = build_parser().parse_args(argv)
    if options.num_devices <= 1 and options.tp <= 1:
        run(options)
        return
    import torch

    from fasterrcnn_torch.parallel import mesh as mesh_lib

    cpu = torch.device(options.device).type == "cpu"
    n = options.num_devices or (options.tp if cpu else None)
    mesh = mesh_lib.make_mesh(n, tp=options.tp, devices=["cpu"] * n if cpu else None)
    print("Device mesh       : dp=%d x tp=%d, backend=%s" % (mesh.dp, mesh.tp, mesh.backend), flush=True)
    mesh_lib.spawn(run_rank, mesh, args=(options,))


def run_rank(mesh, options):
    """One rank of --num-devices: `run` on the rank's mesh; the standard
    output of every rank but 0 is dropped."""
    if mesh.is_main:
        run(options, mesh)
        return
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
        run(options, mesh)


def model_config(options):
    """The ModelConfig of the flags: the default one, or with --tiny the
    smoke-test one (anchors and proposal caps scaled to 120x150 images)."""
    from fasterrcnn_torch.config import AnchorConfig, DetectorConfig, ModelConfig, RPNConfig

    roi_mode = "exact_pool" if options.custom_roi_pool else "crop"
    if options.tiny:
        return ModelConfig(
            backbone=options.backbone,
            allow_edge_proposals=not options.exclude_edge_proposals,
            compute_dtype=options.compute_dtype,
            # Anchors scaled to the tiny images (the standard 128/256/512px
            # pyramid exceeds a 120x150 image entirely).
            anchors=AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
            rpn=RPNConfig(
                pre_nms_train=400, post_nms_train=128,
                pre_nms_infer=200, post_nms_infer=64, minibatch_size=64,
            ),
            detector=DetectorConfig(
                dropout=options.dropout,
                proposal_batch_size=32,
            ),
            max_gt_boxes=8,
            roi_mode=roi_mode,
            train_all=options.train_all,
        )
    return ModelConfig(
        backbone=options.backbone,
        allow_edge_proposals=not options.exclude_edge_proposals,
        compute_dtype=options.compute_dtype,
        detector=DetectorConfig(dropout=options.dropout),
        roi_mode=roi_mode,
        train_all=options.train_all,
    )


def run(options, mesh=None):
    """The procedure the flags ask for, on one device or as one rank of
    `mesh`."""
    from fasterrcnn_torch.config import TrainConfig
    from fasterrcnn_torch.engine import Engine

    model_cfg = model_config(options)
    train_cfg = TrainConfig(
        learning_rate=options.learning_rate,
        momentum=options.momentum,
        weight_decay=options.weight_decay,
        epochs=options.epochs,
        augment=not options.no_augment,
        batch_size=options.batch_size,
        clipnorm=options.clipnorm,
        optimizer=options.optimizer,
        beta1=options.beta1,
        beta2=options.beta2,
        lr_schedule=options.lr_schedule,
        warmup_steps=options.warmup_steps,
    )
    if options.lr_schedule == "cosine" and options.train:
        n = make_datasets(options)[0].num_samples
        steps_per_epoch = -(-n // options.batch_size)
        train_cfg = dataclasses.replace(train_cfg, total_steps=options.epochs * steps_per_epoch)

    if mesh is None:
        engine = Engine(model_cfg, train_cfg, seed=options.seed, device=options.device)
    else:
        engine = Engine(model_cfg, train_cfg, seed=options.seed, mesh=mesh)
    if options.load_from:
        engine.load_weights(options.load_from)
    # Predicting runs on rank 0's tp row (one model between its ranks), and
    # rank 0 alone renders.
    row = mesh is None or mesh.dp_index == 0

    if options.dump_anchors and engine.is_main:
        dump_anchors(engine, options)

    if options.train:
        train(engine, options)
    elif options.eval:
        _, eval_data = make_datasets(options)
        engine.evaluate(
            eval_data,
            batch_size=options.eval_batch_size,
            print_average_precisions=True,
            plot=options.plot,
        )
    elif options.predict and row:
        predict_one(engine, options.predict, show_image=True, output_path=None)
    elif options.predict_to_file and row:
        predict_one(engine, options.predict_to_file, show_image=False,
                    output_path="predictions.png")
    elif options.predict_all and row:
        predict_all(engine, options)
    elif not (options.dump_anchors or options.predict or options.predict_to_file or options.predict_all):
        print("Nothing to do. Did you mean to use --train or --predict?")


def train(engine, options):
    from fasterrcnn_torch.utils.checkpoint import BestWeightsTracker, TrainCheckpointManager
    from fasterrcnn_torch.utils.csv_log import CSVLog

    train_data, eval_data = make_datasets(options)
    print("Training Parameters")
    print("-------------------")
    print("Initial weights   : %s" % (options.load_from or "none (random init)"))
    print("Dataset           : %s" % ("synthetic" if options.synthetic else options.dataset_dir))
    print("Backbone          : %s" % options.backbone)
    print("Device            : %s" % engine.device)
    print("Epochs            : %d" % options.epochs)
    print("Batch size        : %d" % options.batch_size)
    print("Optimizer         : %s" % options.optimizer)
    print("Learning rate     : %f" % options.learning_rate)
    print("Momentum          : %f" % options.momentum)
    print("Weight decay      : %f" % options.weight_decay)
    print("Dropout           : %f" % options.dropout)
    print("Compute dtype     : %s" % options.compute_dtype)
    print("Augmentation      : %s" % ("disabled" if options.no_augment else "enabled"))
    print("Edge proposals    : %s" % ("excluded" if options.exclude_edge_proposals else "included"))
    print("CSV log           : %s" % (options.log_csv or "none"))
    print("Checkpoints       : %s" % (options.checkpoint_dir or "disabled"))
    print("Final weights file: %s" % (options.save_to or "none"))
    print("Best weights file : %s" % (options.save_best_to or "none"))

    # On a mesh rank 0 alone writes (save_weights checks for itself).
    writes = engine.is_main
    csv = CSVLog(options.log_csv) if options.log_csv and writes else None
    best = BestWeightsTracker(options.save_best_to) if options.save_best_to and writes else None
    ckpt_mgr = None
    start_epoch = 1
    if options.checkpoint_dir:
        ckpt_mgr = TrainCheckpointManager(options.checkpoint_dir)
        if options.resume:
            restored = ckpt_mgr.restore_latest()
            if restored is not None:
                state, last_epoch = restored
                # Weights only: set_params restarts the optimizer, so the
                # current --learning-rate is honoured.
                engine.set_params(state)
                start_epoch = last_epoch + 1

    from fasterrcnn_torch.utils import profiling as prof_lib

    if engine.device.type == "cuda" and (options.debug_nans or options.custom_roi_pool):
        why = ("--debug-nans: autograd anomaly mode reads values on the host" if options.debug_nans
               else "--custom-roi-pool: exact RoIPool sizes its gathers from the data")
        print("Train loop        : uncaptured, eager steps (%s)" % why)
    # The trace covers the first epoch's training steps, as the JAX CLI's.
    profiler = prof_lib.trace(options.profile_dir) if options.profile_dir and writes else None
    if profiler is not None:
        profiler.__enter__()
    guard = prof_lib.nan_guard() if options.debug_nans else contextlib.nullcontext()
    with guard:
        for epoch in range(start_epoch, 1 + options.epochs):
            print("Epoch %d/%d" % (epoch, options.epochs))
            try:
                stats = engine.train_epoch(train_data, options.batch_size, progress=True)
            finally:
                if profiler is not None:
                    profiler.__exit__(None, None, None)
                    profiler = None
                    print(f"Wrote profiler trace to {options.profile_dir}")
            if epoch == start_epoch and hasattr(train_data, "cache_nbytes"):
                nb = train_data.cache_nbytes()
                if nb:
                    print(
                        "Image cache       : %.1f MiB (%d images, one unflipped "
                        "array each; flips are views)"
                        % (nb / 2**20, len(train_data._cache))
                    )
            if epoch == start_epoch and options.memory_stats:
                print_memory_stats(engine, options.batch_size)
            mean_ap = engine.evaluate(
                eval_data,
                batch_size=options.eval_batch_size,
                num_samples=options.periodic_eval_samples,
            )
            # The full tensors: on a tp mesh every rank joins the gather.
            state = engine.full_state_dict() if ckpt_mgr is not None or options.save_best_to else None
            if ckpt_mgr is not None and writes:
                ckpt_mgr.save(epoch, state, mean_ap)
            if csv:
                log_items = {
                    "epoch": epoch,
                    "learning_rate": options.learning_rate,
                    "momentum": options.momentum,
                    "weight_decay": options.weight_decay,
                    "dropout": options.dropout,
                    "mAP": mean_ap,
                }
                log_items.update(stats.get_progbar_postfix())
                csv.log(log_items)
            if best:
                best.on_epoch_end(state, epoch, mean_ap)
    if profiler is not None:  # no epoch ran
        profiler.__exit__(None, None, None)
    if options.save_to:
        engine.save_weights(options.save_to)
    if best:
        best.save_best_weights()
    print(
        "Evaluating %s model on all samples in '%s'..."
        % ("best" if options.save_best_to else "final",
           getattr(eval_data, "split", "eval"))
    )
    engine.evaluate(
        eval_data,
        batch_size=options.eval_batch_size,
        print_average_precisions=True,
        plot=options.plot,
    )


def print_memory_stats(engine, batch_size):
    """--memory-stats: the JAX CLI's lines, after the first epoch. A value
    the device does not report (a CPU allocator keeps no peak) prints as
    "not measured"."""
    from fasterrcnn_torch.utils import profiling as prof_lib

    for dev, ms in prof_lib.device_memory_summary(engine.device).items():
        print(
            "Device memory     : %s in_use=%.1f MiB peak=%.1f MiB "
            "limit=%.1f MiB"
            % (dev, ms["bytes_in_use_mb"], ms["peak_bytes_in_use_mb"],
               ms["bytes_limit_mb"])
        )
    for canvas in engine.compiled_canvases():
        mem = engine.train_step_memory_analysis(canvas, batch_size)
        temp = "not measured" if mem["temp_mb"] is None else "%.1f MiB" % mem["temp_mb"]
        print(
            "Train step memory : canvas=%s temp=%s "
            "args=%.1f MiB out=%.1f MiB code=%.1f MiB"
            % (canvas, temp, mem["argument_mb"],
               mem["output_mb"], mem["generated_code_mb"])
        )


def predict_one(engine, url, show_image, output_path):
    from fasterrcnn_torch.data import image as image_lib
    from fasterrcnn_torch.data.voc import CLASS_INDEX_TO_NAME, Sample
    from fasterrcnn_torch.utils import visualize

    image_u8, pil_image, _, _ = image_lib.load_image(
        url, min_dimension_pixels=600, max_dimension_pixels=1600
    )
    sample = Sample(
        image_u8=image_u8,
        image_hw=(image_u8.shape[0], image_u8.shape[1]),
        gt_boxes=[],
        filepath=url,
    )
    scored = engine.predict_image(sample, score_threshold=0.7)
    if not engine.is_main:
        return
    visualize.show_detections(
        image=pil_image,
        scored_boxes_by_class_index=scored,
        class_index_to_name=CLASS_INDEX_TO_NAME,
        output_path=output_path,
        show_image=show_image,
    )


def predict_all(engine, options):
    from fasterrcnn_torch.data.voc import CLASS_INDEX_TO_NAME, Dataset
    from fasterrcnn_torch.utils import visualize

    split = options.predict_all
    dirname = "predictions_" + split
    if engine.is_main:
        os.makedirs(dirname, exist_ok=True)
    print("Rendering predictions from '%s' set to '%s'..." % (split, dirname))
    dataset = Dataset(split=split, dir=options.dataset_dir, augment=False, shuffle=False)
    for sample in dataset:
        scored = engine.predict_image(sample, score_threshold=0.7)
        if not engine.is_main:
            continue
        base = os.path.splitext(os.path.basename(sample.filepath))[0]
        visualize.show_detections(
            image=sample.image,
            scored_boxes_by_class_index=scored,
            class_index_to_name=CLASS_INDEX_TO_NAME,
            output_path=os.path.join(dirname, base + ".png"),
        )


def dump_anchors(engine, options):
    """Render anchors + gt from the training set."""
    import torch

    from fasterrcnn_torch.config import select_canvas
    from fasterrcnn_torch.models.faster_rcnn import anchor_grid_for, proposal_masks
    from fasterrcnn_torch.ops import anchors as anchor_ops
    from fasterrcnn_torch.utils import visualize

    train_data, _ = make_datasets(options)
    os.makedirs(options.dump_anchors, exist_ok=True)
    print("Rendering anchors from '%s' to '%s'..."
          % (getattr(train_data, "split", "train"), options.dump_anchors))
    cfg, dev = engine.model_cfg, engine.device
    for sample in train_data:
        canvas = select_canvas(*sample.image_hw)
        grid = anchor_grid_for(cfg, *canvas)
        hw = torch.tensor([[float(sample.image_hw[0]), float(sample.image_hw[1])]], device=dev)
        _, train_valid = proposal_masks(cfg, grid, hw)
        gt_corners = np.zeros((1, cfg.max_gt_boxes, 4), np.float32)
        gt_mask = np.zeros((1, cfg.max_gt_boxes), np.float32)
        for i, b in enumerate(sample.gt_boxes):
            gt_corners[0, i] = b.corners
            gt_mask[0, i] = 1.0
        targets = anchor_ops.generate_rpn_targets(
            torch.as_tensor(grid.centers, device=dev),
            torch.as_tensor(grid.corners, device=dev),
            train_valid > 0,
            torch.as_tensor(gt_corners, device=dev),
            torch.as_tensor(gt_mask, device=dev),
        )
        positive = (targets.trainable * targets.objectness)[0].cpu().numpy()
        out = os.path.join(
            options.dump_anchors,
            "anchors_" + os.path.basename(sample.filepath).replace("/", "_") + ".png",
        )
        # Deferred-decode samples carry no pixels until batch time;
        # materialize them so that rendering always happens.
        sample.materialize()
        visualize.show_anchors(
            image=sample.image,
            anchor_centers=grid.centers,
            positive_mask=positive,
            gt_boxes=sample.gt_boxes,
            output_path=out,
        )

