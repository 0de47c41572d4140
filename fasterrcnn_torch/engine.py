"""Engine: holds the model, its optimizer and per-canvas programs.

`Engine(model_cfg, train_cfg, seed, device)` (the JAX package's argument
order) builds the model with seeded random weights on `device` ("cuda"
unless the caller asks for "cpu"); `set_params` installs a state_dict (see
`utils/weights.py` for one made from the JAX package's parameters) and
restarts the optimizer; `load_weights` does so from any weight file
`utils/checkpoint.load` reads and `save_weights` writes the port's own
`.pth`; `predict` runs a padded canvas batch; `predict_image` stages one
`data/voc.Sample` into its canvas bucket and returns the reference's
per-class dict; `train_step` takes one optimizer step on a padded batch
(eagerly) and `train_epoch` runs the JAX package's production loop over a
dataset: packed single steps and K-step blocks, each one program (a CUDA
graph on a card), with the uploads in the prefetch thread; `evaluate` runs
predict over a dataset and returns the VOC mAP in percent.

`Engine(..., mesh=...)` is one rank of a (dp, tp) mesh (`parallel/mesh.py`,
the counterpart of the JAX package's `Engine(mesh=...)`): every method is
then a collective that each rank calls alike (`predict_image`: each rank
of the caller's tp row). Each rank holds the model on its device, the
tp-sharded parameters as this rank's shard (`parallel/tp.shard_model`), and
takes its dp row's rows of every batch: `train_epoch` and `train_step`
all-reduce the gradients over the dp group (`models/faster_rcnn.
DataParallelStep`; the tp collectives run inside the model), `predict` and
`evaluate` all-gather the detections over it. The parameters start alike
on every rank (the seeded init draws the full model on the CPU, then each
rank keeps its shard); `load_weights` reads the file on every rank and
`set_params` then broadcasts rank 0's full tensors, so every rank holds
its shard of rank 0's bits. `save_weights`, `full_state_dict` and so every
checkpoint hold the full tensors, gathered over the tp group. Only rank 0
prints and writes files.
"""

from __future__ import annotations

import itertools
import math
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fasterrcnn_torch.config import ModelConfig, TrainConfig, select_canvas
from fasterrcnn_torch.data import pipeline
from fasterrcnn_torch.data.pipeline import HostBatch, Prefetcher, batched, make_host_batch
from fasterrcnn_torch.data.voc import Sample
from fasterrcnn_torch.models.faster_rcnn import (
    Batch,
    DataParallelStep,
    Detections,
    FasterRCNN,
    Losses,
    frozen_parameter_names,
    init_params,
    make_predict_fn,
    make_train_step,
    make_train_step_packed,
    make_train_step_scan,
    pack_aux,
    snapshot_train_state,
)
from fasterrcnn_torch.parallel import mesh as mesh_lib
from fasterrcnn_torch.parallel import tp as tp_lib
from fasterrcnn_torch.utils import checkpoint as ckpt_lib
from fasterrcnn_torch.utils import postprocess
from fasterrcnn_torch.utils import profiling
from fasterrcnn_torch.utils.stats import PrecisionRecallCurveCalculator, TrainingStatistics

def resolve_device(device) -> torch.device:
    """The requested device; raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def parameter_labels(model: FasterRCNN) -> Dict[str, str]:
    """Optimizer group of each parameter: "frozen" (the backbone's frozen
    patterns, unless train_all), "decayed" (conv and dense weights, and
    frozen-BN scales, as the JAX package decays names ending in kernel or
    scale) or "plain" (biases)."""
    frozen = set(frozen_parameter_names(model))
    return {
        name: "frozen" if name in frozen else "decayed" if name.endswith(("weight", "scale")) else "plain"
        for name, _ in model.named_parameters()
    }


def warmup_cosine_factor(count: int, warmup_steps: int, total_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, 1, warmup_steps, total_steps) at
    update `count`: linear warmup, then cosine decay to 0 at total_steps
    (the warmup counted inside total_steps)."""
    if count < warmup_steps:
        return count / warmup_steps
    decay = total_steps - warmup_steps
    return 0.5 * (1.0 + math.cos(math.pi * min(count - warmup_steps, decay) / decay))


class TrainOptimizer:
    """The JAX package's optax optimizer on torch parameters.

    Groups as `parameter_labels` gives them: "decayed" with weight decay,
    "plain" without, "frozen" held out (those parameters do not require
    grad). A step runs optax's chain on each group: when clipnorm > 0 the
    group's gradients are clipped by its own global norm (g * clipnorm /
    norm when norm >= clipnorm, as optax.clip_by_global_norm inside each
    multi_transform group); then weight_decay * p is added
    (optax.add_decayed_weights); then optax's sgd (buf = g + momentum * buf,
    update -lr * buf) or adam (moments mu and nu, bias corrections at
    count + 1 in f32, update -lr * mu_hat / (sqrt(nu_hat) + eps)) updates
    the parameters in place. Parameters without a gradient are skipped.

    Everything that changes from step to step lives on the device: the
    count of updates taken (`count`), the learning rate read from `lr_table`
    at that count (the schedule computed on the host, once, and rounded to
    f32 as a Python float given to a kernel is) and the moments. So a step
    reads no host value and runs alike eagerly and replayed from a CUDA
    graph. The moments are made, zero, before the first step.

    On a tp mesh a group's global norm counts every parameter once:
    `sharded` flags, per group, the parameters that hold a tp shard
    (`tp_sharded`, set by `parallel/tp.shard_model`; their moments are
    `zeros_like` of the shard, so they are sharded alike);
    `reduce_tp_squares` sums their gradients' squares over the tp group into
    `tp_squares`, one value a group, between the gradient and the update
    programs, and `step` adds it to the replicated parameters' squares. So
    the update holds no collective, and every rank clips by one device's
    norm, up to the order of the sum.
    """

    def __init__(self, groups: List[Tuple[List[torch.nn.Parameter], float]], train_cfg: TrainConfig,
                 lr_table: List[float], device):
        if train_cfg.optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
        self.kind = train_cfg.optimizer
        self.groups = groups
        self.clipnorm = train_cfg.clipnorm
        self.momentum = train_cfg.momentum
        self.betas = (train_cfg.beta1, train_cfg.beta2)
        self.eps = 1e-8
        self.lr_table = torch.tensor(lr_table, dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.lr = self.lr_table[0].clone()  # the learning rate of the last step
        self._moments: Optional[List[List[List[torch.Tensor]]]] = None
        self.sharded = [[getattr(p, "tp_sharded", False) for p in params] for params, _ in groups]
        self.tp_squares = torch.zeros(len(groups), dtype=torch.float32, device=device)

    def _state(self) -> List[List[List[torch.Tensor]]]:
        """Per group, one list of zero tensors a parameter for each moment
        (sgd: the trace; adam: mu and nu), made at the first call."""
        if self._moments is None:
            n = 1 if self.kind == "sgd" else 2
            self._moments = [[[torch.zeros_like(p) for p in params] for _ in range(n)] for params, _ in self.groups]
        return self._moments

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes besides the parameters."""
        return [self.count, self.lr] + [t for group in self._state() for moment in group for t in moment]

    def zero_grad(self) -> None:
        for params, _ in self.groups:
            for p in params:
                p.grad = None

    @torch.no_grad()
    def reduce_tp_squares(self, group) -> None:
        """`tp_squares`: per group, the sum of the squared gradients of its
        tp-sharded parameters, summed over the tp `group` (a collective of
        the tp group's ranks; run eagerly, before `step`)."""
        for i, ((params, _), flags) in enumerate(zip(self.groups, self.sharded)):
            squares = [(p.grad.float() ** 2).sum() for p, f in zip(params, flags) if f and p.grad is not None]
            self.tp_squares[i] = sum(squares) if squares else 0.0
        dist.all_reduce(self.tp_squares, group=group)

    @torch.no_grad()
    def step(self) -> None:
        moments = self._state()
        index = torch.clamp(self.count, max=self.lr_table.numel() - 1).view(1)
        self.lr.copy_(self.lr_table.index_select(0, index)[0])
        neg_lr = -self.lr
        if self.kind == "adam":
            b1, b2 = self.betas
            t = (self.count + 1).float()
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for group, ((params, weight_decay), state, flags) in enumerate(zip(self.groups, moments, self.sharded)):
            live = [i for i, p in enumerate(params) if p.grad is not None]
            if not live:
                continue
            ps = [params[i] for i in live]
            grads = [p.grad for p in ps]
            if self.clipnorm > 0:
                squares = sum((p.grad.float() ** 2).sum() for p, f in zip(params, flags)
                              if p.grad is not None and not f)
                if any(flags):
                    squares = squares + self.tp_squares[group]
                norm = torch.sqrt(squares)
                factor = torch.where(norm < self.clipnorm, 1.0, self.clipnorm / norm)
                torch._foreach_mul_(grads, factor)
            if weight_decay > 0:
                grads = torch._foreach_add(grads, ps, alpha=weight_decay)
            if self.kind == "sgd":
                trace = [state[0][i] for i in live]
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, grads)
                updates = torch._foreach_mul(trace, neg_lr)
            else:
                mu, nu = ([m[i] for i in live] for m in state)
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, grads, alpha=1.0 - b1)
                torch._foreach_mul_(nu, b2)
                torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
                denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
                torch._foreach_add_(denom, self.eps)
                updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
                torch._foreach_mul_(updates, neg_lr)
            torch._foreach_add_(ps, updates)
        self.count += 1


def make_optimizer(
    model_cfg: ModelConfig, train_cfg: TrainConfig, model: FasterRCNN
) -> Tuple[TrainOptimizer, Dict[str, str]]:
    """The optimizer of `train_cfg` over `model`'s parameters, and each
    parameter's group label. SGD with momentum or Adam; a constant learning
    rate or optax's warmup-cosine schedule."""
    labels = parameter_labels(model)
    params = dict(model.named_parameters())
    groups = [
        ([params[n] for n, g in labels.items() if g == "decayed"], train_cfg.weight_decay),
        ([params[n] for n, g in labels.items() if g == "plain"], 0.0),
    ]
    lr = train_cfg.learning_rate
    if train_cfg.lr_schedule == "cosine":
        warmup = max(train_cfg.warmup_steps, 1)
        if train_cfg.total_steps <= warmup:
            raise ValueError(
                "lr_schedule='cosine' needs total_steps > max(warmup_steps, 1) "
                f"(got total_steps={train_cfg.total_steps})"
            )
        total = train_cfg.total_steps
        # Past total_steps the factor stays at its last value, 0.
        lr_table = [lr * warmup_cosine_factor(n, warmup, total) for n in range(total + 1)]
    elif train_cfg.lr_schedule == "constant":
        lr_table = [lr]
    else:
        raise ValueError(f"unknown lr_schedule {train_cfg.lr_schedule!r}")
    device = next(model.parameters()).device
    return TrainOptimizer(groups, train_cfg, lr_table, device), labels


def pack_detections(det: Detections) -> torch.Tensor:
    """Detections as one (B, C-1, D, 6) f32 tensor: box, score, valid."""
    return torch.cat([det.boxes, det.scores[..., None], det.valid[..., None].float()], dim=-1)


def unpack_detections(packed) -> Detections:
    """`pack_detections` undone (a tensor or a numpy array)."""
    return Detections(boxes=packed[..., :4], scores=packed[..., 4], valid=packed[..., 5])


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a data-parallel rank's default generators."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class Engine:
    """Holds the model on one device, its optimizer, the sampling generator
    and the per-canvas predict and train functions.

    With a `mesh` of more than one rank (`parallel/mesh.py`, joined by
    `spawn`) the engine is that mesh's rank on its device (`device` is then
    left unset). Sampling draws are the whole batch's on every rank (the
    generator is seeded alike), so a mesh samples what one device samples.
    Dropout (`--dropout`, off by default) draws from the default
    generators, which on a mesh are seeded per dp row (`rank_seed` of the
    dp index): the ranks of a dp row draw the same masks (`models/vgg16.
    VGG16Head`), each dp row its own, independent of the other rows, so
    with dropout on dp=N does not draw one device's masks (tp=N does).
    """

    def __init__(
        self,
        model_cfg: ModelConfig = ModelConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        seed: int = 0,
        device=None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        if mesh is not None:
            if device is not None:
                raise ValueError(f"device={device!r} with a mesh: a rank runs on its mesh device ({mesh.device})")
            device = mesh.device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device("cuda" if device is None else device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        model = FasterRCNN(model_cfg)
        init_params(model, seed)
        self.model = model.to(device=self.device, memory_format=torch.channels_last).eval()
        tp_lib.shard_model(self.model, self.mesh)
        # Uniforms of the minibatch and proposal sampling, on the device.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.mesh is not None:
            torch.manual_seed(rank_seed(seed, self.mesh.dp_index))
        self._predict_fns: Dict[Tuple[int, int], callable] = {}
        # One step index per batch trained on, across epochs (pack_aux).
        self._global_step = 0
        # Phase breakdown of the most recent train_epoch (see there).
        self.last_epoch_trace: Dict[str, float] = {}
        # The prefetch thread's uploads run on this stream.
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._restart_optimizer()

    def _restart_optimizer(self) -> None:
        self.optimizer, self.labels = make_optimizer(self.model_cfg, self.train_cfg, self.model)
        # Every step program is bound to the optimizer's state, and every
        # graph of one optimizer allocates from one pool (they replay one at
        # a time). A new set of programs takes a new pool: capturing into
        # the pool of graphs that are gone fails in PyTorch's allocator.
        self._graph_pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._train_steps: Dict[Tuple[int, int], callable] = {}
        self._packed_steps: Dict[Tuple[int, int], callable] = {}
        self._scan_steps: Dict[Tuple[Tuple[int, int], int], callable] = {}
        self._dp_steps: Dict[Tuple[int, int], DataParallelStep] = {}

    @property
    def is_main(self) -> bool:
        """Whether this engine prints and writes: rank 0, or no mesh."""
        return self.mesh is None or self.mesh.is_main

    def set_params(self, state_dict) -> None:
        """Install a full state_dict (no missing or unexpected keys) and
        restart the optimizer, as the JAX package's Engine does. On a mesh,
        rank 0's full tensors are first broadcast to every rank, then each
        rank keeps its shard (`mesh_lib.shard_state_dict`)."""
        if self.mesh is None:
            self.model.load_state_dict(state_dict)
        else:
            full = {k: torch.as_tensor(v).to(self.device, copy=True) for k, v in state_dict.items()}
            mesh_lib.broadcast_tensors(self.mesh, list(full.values()))
            self.model.load_state_dict(mesh_lib.shard_state_dict(self.mesh, full))
        self._restart_optimizer()

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's full state dict: on a tp mesh each sharded tensor
        gathered over the tp group (a collective of every rank), else the
        model's own."""
        if self.mesh is None:
            return self.model.state_dict()
        return mesh_lib.gather_state_dict(self.mesh, self.model.state_dict())

    def load_weights(self, filepath: str) -> None:
        """Load any weight file `utils/checkpoint.load` reads; restarts the
        optimizer. On a mesh every rank reads the file. On a tp mesh the
        model is gathered whole first (`full_state_dict`), as the JAX
        package's `ckpt_lib.load(self.params)` reads its global arrays: a
        partial file (a VGG-16 file without its classifier) keeps the current
        values of what it lacks, fc1 and fc2 included."""
        self.set_params(ckpt_lib.load(self.full_state_dict(), filepath))

    def save_weights(self, filepath: str) -> None:
        """Write the port's .pth of the full tensors (on a mesh every rank
        joins the gather, and rank 0 alone writes)."""
        state = self.full_state_dict()
        if self.is_main:
            ckpt_lib.save_weights(filepath, state)

    def predict_fn_for(self, canvas_hw: Tuple[int, int]):
        canvas_hw = tuple(canvas_hw)
        if canvas_hw not in self._predict_fns:
            self._predict_fns[canvas_hw] = make_predict_fn(self.model, *canvas_hw)
        return self._predict_fns[canvas_hw]

    def train_step_for(self, canvas_hw: Tuple[int, int]):
        canvas_hw = tuple(canvas_hw)
        if canvas_hw not in self._train_steps:
            self._train_steps[canvas_hw] = make_train_step(self.model, self.optimizer, *canvas_hw)
        return self._train_steps[canvas_hw]

    def compiled_canvases(self):
        """Canvas buckets a train step has been built for (any API)."""
        return sorted(set(self._train_steps) | set(self._packed_steps) | {c for c, _ in self._scan_steps}
                      | set(self._dp_steps))

    def dp_step_for(self, canvas_hw: Tuple[int, int]) -> DataParallelStep:
        """The data-parallel step of one canvas (on a mesh only): its
        gradient and update programs serve the packed step and the K-step
        block alike."""
        canvas_hw = tuple(canvas_hw)
        if canvas_hw not in self._dp_steps:
            self._dp_steps[canvas_hw] = DataParallelStep(
                self.model, self.optimizer, *canvas_hw, self.mesh, generator=self.generator, pool=self._graph_pool)
        return self._dp_steps[canvas_hw]

    def packed_step_for(self, canvas_hw: Tuple[int, int]):
        """Single-step packed program (models/faster_rcnn.make_train_step_packed):
        one upload of images and one of aux, one graph replay a step. Used
        for K-block residues and when FRCNN_SCAN_STEPS=1. On a mesh,
        `DataParallelStep.packed`, which also takes the batch's
        denominator."""
        canvas_hw = tuple(canvas_hw)
        if canvas_hw not in self._packed_steps:
            self._packed_steps[canvas_hw] = make_train_step_packed(
                self.model, self.optimizer, *canvas_hw, generator=self.generator, pool=self._graph_pool
            ) if self.mesh is None else self.dp_step_for(canvas_hw).packed
        return self._packed_steps[canvas_hw]

    def scan_step_for(self, canvas_hw: Tuple[int, int], k: int):
        """The production train-loop program: K optimizer steps a replay,
        two stacked uploads per K steps (models/faster_rcnn.make_train_step_scan).
        On a mesh, `DataParallelStep.block`: K steps, each its own
        replays and all-reduce, on the stacked uploads and the K batches'
        denominators."""
        key = (tuple(canvas_hw), k)
        if key not in self._scan_steps:
            self._scan_steps[key] = make_train_step_scan(
                self.model, self.optimizer, *key[0], k, generator=self.generator, pool=self._graph_pool
            ) if self.mesh is None else self.dp_step_for(key[0]).block
        return self._scan_steps[key]

    def train_step_memory_analysis(self, canvas_hw: Tuple[int, int], batch_size: int) -> dict:
        """Memory of one train step at this shape (--memory-stats), from
        `utils/profiling.step_memory_analysis`: one eager step on a blank
        batch, after which the parameters, the optimizer state and the
        generators are put back as they were."""
        ch, cw = canvas_hw
        b, g = batch_size, self.model_cfg.max_gt_boxes
        hb = HostBatch(
            (ch, cw), np.zeros((b, ch, cw, 3), np.uint8), np.tile(np.float32([[ch, cw]]), (b, 1)),
            np.zeros((b, g, 4), np.float32), np.zeros((b, g), np.int32), np.zeros((b, g), np.float32),
            np.ones((b,), np.float32), [],
        )
        batch = self.to_device(hb)
        restore = snapshot_train_state(self.model, self.optimizer, (self.generator,))
        arguments = [*self.model.parameters(), *self.optimizer.state_tensors(), *batch]
        try:
            return profiling.step_memory_analysis(lambda: tuple(self.train_step(batch)), arguments)
        finally:
            restore()

    def to_device(self, batch) -> Batch:
        """A padded batch on this engine's device: `batch` is a
        data/pipeline.HostBatch (numpy) or a Batch."""
        return Batch(*(torch.as_tensor(getattr(batch, f), device=self.device) for f in Batch._fields))

    def train_step(self, batch) -> Losses:
        """One optimizer step on a padded batch (HostBatch or Batch; a host
        batch is copied to the device here). Returns the detached losses,
        still on the device. On a mesh every rank passes the whole batch
        and steps, eagerly, on its rows (`DataParallelStep.eager`); the
        losses are the whole batch's."""
        b = self.to_device(batch)
        canvas_hw = tuple(b.images.shape[1:3])
        if self.mesh is not None:
            denominator = b.sample_weight.float().sum() + 1e-7
            rows = self.mesh.rows(b.images.shape[0])
            return self.dp_step_for(canvas_hw).eager(Batch(*(t[rows] for t in b)), denominator)
        return self.train_step_for(canvas_hw)(b, generator=self.generator)

    def train_epoch(
        self,
        dataset: Iterable,
        batch_size: int,
        stats: Optional[TrainingStatistics] = None,
        progress: bool = False,
        max_steps: Optional[int] = None,
    ) -> TrainingStatistics:
        """One pass over `dataset` (samples, see data/voc.Sample) in padded
        canvas batches; at most max_steps steps (checked before each
        program, so a K-step block may pass it).

        The JAX package's production loop. K consecutive same-canvas
        batches (FRCNN_SCAN_STEPS, default 8) are stacked into one
        (K, B, ...) uint8 image tensor and one (K, B, aux_width) f32 aux
        tensor and run as one K-step program (`scan_step_for`); each
        canvas's residue of fewer than K batches runs as single packed steps
        (`packed_step_for`), never padded: a zero-weight step would still
        move the momentum. Batch assembly and the uploads both run in the
        prefetch thread: each tensor is assembled in pinned host memory and
        copied on the engine's copy stream, and the step's stream waits on
        the copy's event. The losses stay on the device and are copied to
        pinned host memory every FRCNN_LOSS_FLUSH_STEPS steps (default 32),
        the copy started at the flush and read at the next one. Under
        autograd anomaly mode (`utils/profiling.nan_guard`) every step runs
        eagerly and its losses are checked on the host.

        `last_epoch_trace` records, always, the seconds the main thread
        spent waiting for staged batches (wait_s), inside the program calls
        (dispatch_s), in the final drain (drain_s) and elsewhere (other_s);
        FRCNN_EPOCH_TRACE=1 also prints it to stderr.

        On a mesh every rank walks the same batches and stages only its
        rows (`pipeline.batched(shard=...)`); each upload adds the batches'
        loss denominators (`HostBatch.denominator`) to images and aux, and
        a step's losses, read by every rank, are the whole batch's. A
        residue pads to batch_size as on one device, so every rank runs
        the same steps.
        """
        stats = stats or TrainingStatistics()
        mesh_lib.check_batch_size(self.mesh, batch_size)
        start_step = self._global_step
        scan_k = max(1, int(os.environ.get("FRCNN_SCAN_STEPS", "8")))
        flush_every = int(os.environ.get("FRCNN_LOSS_FLUSH_STEPS", "32"))
        cuda = self.device.type == "cuda"
        progress = progress and self.is_main

        def staged(kind, canvas_hw, block, n):
            # block: [(host batch, step index)]
            arrays = [[hb.images for hb, _ in block], [pack_aux(hb, si) for hb, si in block]]
            if self.mesh is not None:
                arrays.append([hb.denominator for hb, _ in block])
            tensors, ready = pipeline.upload(
                tuple(pipeline.stage(a, cuda) for a in arrays), self.device, self._copy_stream)
            if kind == "step":
                tensors = tuple(t[0] for t in tensors)
            return kind, canvas_hw, tensors, ready, n

        def to_device(host_batches):
            # Emitted items: (kind, canvas_hw, (images, aux), ready, n_steps)
            # with kind "scan" (a stacked (K, B, ...) block) or "step".
            idx = 0
            pending: Dict[Tuple[int, int], list] = {}
            for hb in host_batches:
                step_idx = start_step + idx
                idx += 1
                if scan_k == 1:
                    yield staged("step", hb.canvas_hw, [(hb, step_idx)], 1)
                    continue
                block = pending.setdefault(hb.canvas_hw, [])
                block.append((hb, step_idx))
                if len(block) == scan_k:
                    pending[hb.canvas_hw] = []
                    yield staged("scan", hb.canvas_hw, block, scan_k)
            for canvas_hw, block in pending.items():
                for item in block:
                    yield staged("step", canvas_hw, [item], 1)

        # The queue covers a loss-flush window of steps: while the main
        # thread waits on a flush, the worker stages the next window.
        batches = Prefetcher(
            to_device(batched(iter(dataset), batch_size, self.model_cfg.max_gt_boxes, shard=self._shard)),
            depth=max(2, flush_every // scan_k),
        )
        buf: list = []  # device loss blocks, each (n_i, 4)
        buf_rows = 0
        pending_block = None
        steps_done = 0

        def consume(host, ready):
            if ready is not None:
                ready.synchronize()
            for row in host.numpy():
                stats.on_training_step_values(row)
            if progress:
                print(f"step {stats._count}: {stats.get_progbar_postfix()}", file=sys.stderr, flush=True)

        def flush():
            # Start the copy of the buffered blocks and read the previous
            # flush's, whose copy has had a whole flush period to land.
            nonlocal pending_block, buf_rows
            if not buf:
                return
            block = buf[0] if len(buf) == 1 else torch.cat(buf)
            buf.clear()
            buf_rows = 0
            ready = None
            if cuda:
                host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
                host.copy_(block, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host = block
            if pending_block is not None:
                consume(*pending_block)
            pending_block = (host, ready)

        trace = os.environ.get("FRCNN_EPOCH_TRACE") == "1"
        t_wait = t_dispatch = 0.0
        t_begin = time.perf_counter()
        try:
            it = iter(batches)
            while True:
                t0 = time.perf_counter()
                try:
                    kind, canvas_hw, tensors, ready, n = next(it)
                except StopIteration:
                    break
                t_wait += time.perf_counter() - t0
                if max_steps is not None and steps_done >= max_steps:
                    break
                t0 = time.perf_counter()
                pipeline.arrived(tensors, ready)
                if kind == "scan":
                    rows = self.scan_step_for(canvas_hw, n)(*tensors)
                else:
                    rows = self.packed_step_for(canvas_hw)(*tensors)[1][None]
                if torch.is_anomaly_enabled():
                    profiling.check_finite(rows, self._global_step)
                buf.append(rows)
                t_dispatch += time.perf_counter() - t0
                self._global_step += n
                steps_done += n
                buf_rows += n
                if buf_rows >= flush_every:
                    flush()
            t0 = time.perf_counter()
            flush()
            if pending_block is not None:
                consume(*pending_block)
            t_drain = time.perf_counter() - t0
            total = time.perf_counter() - t_begin
            self.last_epoch_trace = {
                "steps": steps_done,
                "total_s": round(total, 3),
                "wait_s": round(t_wait, 3),
                "dispatch_s": round(t_dispatch, 3),
                "drain_s": round(t_drain, 3),
                "other_s": round(total - t_wait - t_dispatch - t_drain, 3),
            }
            if trace and self.is_main:
                print(
                    f"[epoch-trace] steps={steps_done} total={total:.3f}s "
                    f"wait-for-staging={t_wait:.3f}s "
                    f"dispatch-calls={t_dispatch:.3f}s "
                    f"final-drain={t_drain:.3f}s "
                    f"other={total - t_wait - t_dispatch - t_drain:.3f}s",
                    file=sys.stderr,
                    flush=True,
                )
        finally:
            batches.close()
        return stats

    @property
    def _shard(self) -> Tuple[int, int]:
        """(dp index, dp) of `pipeline.batched`."""
        return (0, 1) if self.mesh is None else (self.mesh.dp_index, self.mesh.dp)

    def _predict_rows(self, images_u8, image_hw, score_threshold: float) -> Detections:
        """Predict on this device, with the ranks of its tp row."""
        images = torch.as_tensor(images_u8, device=self.device)
        hw = torch.as_tensor(image_hw, dtype=torch.float32, device=self.device)
        predict = self.predict_fn_for(tuple(images.shape[1:3]))
        return predict(images, hw, score_threshold=score_threshold)

    def predict(self, images_u8, image_hw, score_threshold: float = 0.05) -> Detections:
        """Padded canvas batch (B, H, W, 3) uint8 + real extents (B, 2). On a
        mesh every rank passes the whole batch, its dp row predicts its rows
        and every rank returns the whole batch's detections (all-gathered
        over the dp group)."""
        if self.mesh is None:
            return self._predict_rows(images_u8, image_hw, score_threshold)
        det = self._predict_rows(self.mesh.shard_batch(images_u8), self.mesh.shard_batch(image_hw), score_threshold)
        return unpack_detections(mesh_lib.all_gather_rows(self.mesh, pack_detections(det)).to(self.device))

    def predict_image(self, sample: Sample, score_threshold: float = 0.7) -> Dict[int, np.ndarray]:
        """Single-sample predict -> reference-style per-class dict. On a mesh
        a call that every rank of the caller's tp row joins, with the same
        sample (the row holds one model between them); the other rows need
        not call it."""
        hb = make_host_batch([sample], select_canvas(*sample.image_hw), self.model_cfg.max_gt_boxes)
        det = self._predict_rows(hb.images, hb.image_hw, score_threshold)
        return postprocess.detections_to_dicts(det)[0]

    def evaluate(
        self,
        dataset: Iterable,
        batch_size: int = 8,
        num_samples: Optional[int] = None,
        score_threshold: float = 0.05,
        print_average_precisions: bool = False,
        plot: bool = False,
        progress: bool = True,
    ) -> float:
        """Predict over `dataset` (at most num_samples samples) in padded
        canvas batches assembled in a background thread, and return the VOC
        mAP in percent. Each batch's detections are read, in one copy to the
        host, just after the next batch is dispatched; only real samples
        reach the calculator.

        On a mesh every rank walks the same batches and stages and predicts
        only its dp row's rows; the detections are all-gathered over the dp
        group, rank 0 computes the mAP and every rank returns it."""
        mesh_lib.check_batch_size(self.mesh, batch_size)
        calc = PrecisionRecallCurveCalculator()
        source = iter(dataset)
        if num_samples is not None:
            # Bounds the decode work: the prefetch thread stops after them.
            source = itertools.islice(source, num_samples)
        batches = Prefetcher(batched(source, batch_size, self.model_cfg.max_gt_boxes, shard=self._shard))
        progress = progress and self.is_main
        seen = 0
        finished = 0

        def finish(packed, samples):
            nonlocal seen, finished
            if self.mesh is not None:
                packed = mesh_lib.all_gather_rows(self.mesh, packed)
            det = unpack_detections(packed.cpu().numpy())
            # The batch's real samples come first: the zero-weight padding
            # rows of a residue batch are dropped here.
            if self.is_main:
                for sample, scored in zip(samples, postprocess.detections_to_dicts(det)):
                    calc.add_image_results(scored, sample.gt_boxes)
                    seen += 1
            finished += 1
            if progress and finished % 8 == 0:
                print(f"eval: {seen} images", file=sys.stderr, flush=True)

        # Reading one batch behind lets the calculator's work on a batch
        # overlap the device's on the next. A deeper queue would add
        # nothing: predict's upload of the next batch from pageable memory
        # is a copy PyTorch ends with a stream synchronize, so it already
        # waits for the device to finish every batch before it.
        previous = None
        # On a mesh a dp row predicts its rows; finish gathers them.
        predict_rows = self.predict if self.mesh is None else self._predict_rows
        try:
            for hb in batches:
                packed = pack_detections(predict_rows(hb.images, hb.image_hw, score_threshold))
                if previous is not None:
                    finish(*previous)
                previous = (packed, hb.batch_samples)
            if previous is not None:
                finish(*previous)
        finally:
            batches.close()
        if progress:
            print(f"eval: {seen} images", file=sys.stderr, flush=True)
        mean_ap = None
        if self.is_main:
            class_names = getattr(dataset, "class_index_to_name", {})
            if print_average_precisions:
                calc.print_average_precisions(class_names)
            mean_ap = 100.0 * calc.compute_mean_average_precision()
            print("Mean Average Precision = %1.2f%%" % mean_ap)
            if plot:
                calc.plot_average_precisions(class_names)
        if self.mesh is not None:
            mean_ap = mesh_lib.broadcast_value(self.mesh, mean_ap)
        return mean_ap
