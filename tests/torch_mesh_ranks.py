"""What the ranks of `tests/test_torch_mesh.py`, `tests/test_torch_mesh_eval.py`
and `tests/test_torch_tp.py` run (`parallel/mesh.spawn` pickles a function
by its import path). Torch and the port only: JAX runs in the test process,
which hands the ranks its draws and weights as numpy arrays and files.

Each function returns, per rank, small results and a sha256 digest of the
rank's parameters; rank 0 also writes its parameters (on a tp mesh the
gathered full tensors) to the path given, so that the test reads them once.
The 2-rank groups run their dp=2 runs first, then re-group the same two
processes as dp=1 x tp=2 (`mesh.regroup`) for the tp runs.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

# Each rank's CPU threads, and the test process's while its ranks run: the
# suite runs beside them, one worker a core.
THREADS = 1


def tiny_config(cfg_module):
    """`tests/test_torch_predict.py`'s tiny_config (that module imports JAX)."""
    return cfg_module.ModelConfig(
        num_classes=21,
        anchors=cfg_module.AnchorConfig(areas=(24.0 * 24, 48.0 * 48, 96.0 * 96)),
        rpn=cfg_module.RPNConfig(
            pre_nms_train=400, post_nms_train=128, pre_nms_infer=200, post_nms_infer=64, minibatch_size=64
        ),
        detector=cfg_module.DetectorConfig(proposal_batch_size=32),
        max_gt_boxes=8,
    )


def digest(model) -> str:
    return digest_of(model.state_dict())


def digest_of(state) -> str:
    """sha256 of a state dict's names and values."""
    h = hashlib.sha256()
    for name, t in state.items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def fed_draws(steps):
    """A stand-in for `faster_rcnn.draw_train_uniforms` that returns, call
    after call, the given steps' whole-batch draws (numpy pairs), sliced to
    the rank's rows as the port slices its own."""
    from fasterrcnn_torch.models.faster_rcnn import TrainDraws

    it = iter(steps)

    def draw(cfg, grid, batch_size, generator, device, shard=(0, 1)):
        index, _ = shard
        rows = slice(index * batch_size, (index + 1) * batch_size)
        rpn, det = next(it)
        return TrainDraws(*(tuple(torch.from_numpy(u[rows]).to(device) for u in pair) for pair in (rpn, det)))

    return draw


def epoch(engine, start, data, batch_size, scan_k, train_cfg):
    """One train_epoch from the parameters `start` with a fresh `train_cfg`
    optimizer, generator and step count, at K=scan_k; its (steps, 4) loss
    rows."""
    from fasterrcnn_torch.scripts.reference_train import StepRows

    engine.train_cfg = train_cfg
    engine.set_params(start)  # restarts the optimizer from train_cfg
    engine.generator.manual_seed(0)
    engine._global_step = 0
    os.environ["FRCNN_SCAN_STEPS"] = str(scan_k)
    rows = StepRows()
    engine.train_epoch(data, batch_size, stats=rows)
    return np.array(rows.rows)


# name -> (images, K, optimizer): B=4, so 7 images are a full batch and a
# residue of 3 (2 on rank 0, 1 and a padding row on rank 1), 4 one batch.
RUNS = {
    "jax": (7, 2, {}),
    "adam": (4, 8, dict(optimizer="adam", learning_rate=1e-4)),
}


def dataset(n):
    from fasterrcnn_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(num_samples=n, height=120, width=150, seed=3)


def train_runs(mesh, jax_steps, out_dir):
    """The training runs of `tests/test_torch_mesh.py` on one rank, in one
    process group, each from the seed-0 parameters of the tiny config
    (RUNS: name -> images, K, optimizer): "jax", SGD fed JAX's draws, as
    one K=2 block; "adam", Adam at learning rate 1e-4 on the port's own
    generator, as packed steps. Then the same two ranks as dp=1 x tp=2 run
    TP_RUNS (`tp_train_runs`)."""
    from fasterrcnn_torch import config as torch_config
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models import faster_rcnn

    torch.set_num_threads(THREADS)
    engine = Engine(tiny_config(torch_config), seed=0, mesh=mesh)
    mask = torch.nn.functional.dropout(torch.ones(4096), 0.5, training=True)
    out = {"dropout_mask": mask.numpy(), "initial_seed": torch.initial_seed()}
    start = {k: v.clone() for k, v in engine.model.state_dict().items()}
    real = faster_rcnn.draw_train_uniforms
    for name, (n, k, optimizer) in RUNS.items():
        if name == "jax":
            faster_rcnn.draw_train_uniforms = fed_draws(jax_steps)
        try:
            rows = epoch(engine, start, dataset(n), 4, k, torch_config.TrainConfig(**optimizer))
        finally:
            faster_rcnn.draw_train_uniforms = real
        out[name] = {"rows": rows, "digest": digest(engine.model)}
        if mesh.is_main:
            torch.save(engine.model.state_dict(), os.path.join(out_dir, f"{name}.pth"))
    del engine
    out.update(tp_train_runs(regroup(mesh), jax_steps, out_dir))
    return out


def regroup(mesh):
    """The two ranks of a dp=2 group as dp=1 x tp=2."""
    from fasterrcnn_torch.parallel import mesh as mesh_lib

    return mesh_lib.regroup(mesh, 2)


# The clipping norm of run "tp_vgg_clip": the tiny config's first step has
# a global gradient norm of ~35 in the decayed group, so it clips.
CLIPNORM = 1.0

# name -> (backbone, train_all, dropout, images, optimizer, fed JAX's draws):
# SGD with clipnorm on the tiny VGG-16, fed JAX's draws, 7 images (a full
# batch and a residue with a padding row); the tiny ResNet-50 from scratch
# (train_all), fed JAX's draws, 7 images (its first step leaves layer4's
# closed residual branches without gradient: bn3's scales start at 0);
# VGG-16 with dropout 0.5 on the port's own generator, one batch.
TP_RUNS = {
    "tp_vgg_clip": ("vgg16", False, 0.0, 7, dict(clipnorm=CLIPNORM), True),
    "tp_resnet50": ("resnet50", True, 0.0, 7, {}, True),
    "tp_vgg_dropout": ("vgg16", False, 0.5, 4, {}, False),
}


def tp_config(cfg_module, name):
    """The model config of TP_RUNS[name]."""
    import dataclasses

    backbone, train_all, dropout = TP_RUNS[name][:3]
    cfg = tiny_config(cfg_module)
    return dataclasses.replace(cfg, backbone=backbone, train_all=train_all,
                               detector=dataclasses.replace(cfg.detector, dropout=dropout))


def split_digests(state):
    """(digest of the replicated tensors, digest of the tp-sharded ones) of
    a state dict."""
    from fasterrcnn_torch.parallel.mesh import param_spec

    return tuple(digest_of({k: v for k, v in state.items() if (param_spec(k) is None) == replicated})
                 for replicated in (True, False))


def tp_train_runs(mesh, jax_steps, out_dir):
    """TP_RUNS on one rank of a dp=1 x tp=2 mesh, each from the seed-0
    parameters of its config, at K=8 (so packed steps): each run's loss
    rows; the digests of the replicated and of this rank's sharded
    tensors; the digest of the gathered full state; whether sharding the
    gathered state gives back this rank's tensors bit for bit; the
    default generator's seed. Rank 0 writes the gathered state."""
    from fasterrcnn_torch import config as torch_config
    from fasterrcnn_torch.engine import Engine
    from fasterrcnn_torch.models import faster_rcnn
    from fasterrcnn_torch.parallel import mesh as mesh_lib

    out = {}
    real = faster_rcnn.draw_train_uniforms
    for name, (_, _, _, n, optimizer, fed) in TP_RUNS.items():
        engine = Engine(tp_config(torch_config, name), seed=0, mesh=mesh)
        start = mesh_lib.gather_state_dict(mesh, engine.model.state_dict())
        start = {k: v.clone() for k, v in start.items()}
        if fed:
            faster_rcnn.draw_train_uniforms = fed_draws(jax_steps)
        try:
            rows = epoch(engine, start, dataset(n), 4, 8, torch_config.TrainConfig(**optimizer))
        finally:
            faster_rcnn.draw_train_uniforms = real
        held = engine.model.state_dict()
        full = engine.full_state_dict()
        out[name] = {
            "rows": rows, "digests": split_digests(held), "full_digest": digest_of(full),
            "shards_match": all(torch.equal(a, held[k]) for k, a in mesh_lib.shard_state_dict(mesh, full).items()),
            "initial_seed": torch.initial_seed(), "tp_squares": engine.optimizer.tp_squares.numpy().copy(),
            "fc1_rows": engine.model.state_dict().get("roi_head.fc1.weight", torch.zeros(0)).shape[0],
        }
        if mesh.is_main:
            torch.save({k: v.detach().cpu() for k, v in full.items()}, os.path.join(out_dir, f"{name}.pth"))
        del engine, start, held, full
    return out


def fail_on_rank1(mesh):
    """Rank 1 raises; rank 0 waits in a collective for it."""
    import torch.distributed as dist

    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier(group=mesh.group)


def hang_on_rank1(mesh):
    """Rank 1 never returns."""
    import time

    while mesh.rank == 1:
        time.sleep(1)
    return mesh.rank


# The score threshold of every predict and evaluate of
# `tests/test_torch_mesh_eval.py` (JAX compiles a program a threshold).
THRESHOLD = 0.05


def eval_runs(mesh, weights, images, image_hw, voc_root, out_dir):
    """The predict and eval runs of `tests/test_torch_mesh_eval.py` on one
    rank (`eval_on`): on the dp=2 mesh, then on the same ranks as dp=1 x
    tp=2 (under "tp")."""
    from fasterrcnn_torch.data import native_loader

    torch.set_num_threads(THREADS)
    # As the test process: the reader held to PIL (JAX's reader decodes so).
    native_loader.available = lambda: False
    out = eval_on(mesh, weights, images, image_hw, voc_root, out_dir, "")
    out["tp"] = eval_on(regroup(mesh), weights, images, image_hw, voc_root, out_dir, "tp_")
    return out


def eval_on(mesh, weights, images, image_hw, voc_root, out_dir, prefix):
    """On one rank of `mesh`: load_weights, predict on the whole batch,
    predict_image on one image (every rank of the tp row joins), evaluate
    over the VOC split, save_weights to `<prefix>saved_by_rank<r>.pth`;
    the digests of the full state and (replicated, sharded) of the rank's."""
    from fasterrcnn_torch import config as torch_config
    from fasterrcnn_torch.data import voc
    from fasterrcnn_torch.engine import Engine

    engine = Engine(tiny_config(torch_config), seed=1, mesh=mesh)
    engine.load_weights(weights)
    out = {"digest": digest_of(engine.full_state_dict()), "digests": split_digests(engine.model.state_dict())}
    det = engine.predict(images, image_hw, score_threshold=THRESHOLD)
    out["detections"] = tuple(t.numpy() for t in det)
    sample = voc.Sample(image_u8=images[0, :120, :150], image_hw=(120, 150), gt_boxes=[], filepath="x")
    out["predict_image"] = engine.predict_image(sample, score_threshold=THRESHOLD)
    out["map"] = engine.evaluate(voc.Dataset("test", dir=voc_root, augment=False, shuffle=False, cache=False,
                                             batch_decode=False, min_dimension_pixels=120, max_dimension_pixels=160),
                                 batch_size=4, score_threshold=THRESHOLD, progress=False)
    engine.save_weights(os.path.join(out_dir, f"{prefix}saved_by_rank{mesh.rank}.pth"))
    return out


def tp_layer_checks(mesh):
    """The layer checks of `tests/test_torch_tp.py` on one rank of a dp=2 x
    tp=2 mesh, on small layers: the rank's grid place and the members of
    its groups; the rows `all_gather_rows` gathers over the dp group; the
    replicated gradients `tp.average_replicated` leaves of values that part
    between the ranks; then,
    for a VGG16Head holding a small Linear pair (24 -> 16 -> 8, dropout
    0.5 in training mode, from the default generator seeded alike on
    every rank) and for a layer4 of two small Bottlenecks (16 -> 8 -> 32
    channels, on a (3, 16, 7, 7) input), each built from one seed, the
    largest gaps of the sharded copy (`tp.shard_model`) to the full one in
    the output, the input gradient and each parameter's gradient (the
    full gradient's shard) for one seeded cotangent; the gathered state
    against the full one; the clipping norm of one optimizer group of the
    sharded layers against the full layers' and the updates' largest gap.
    """
    import torch.distributed as dist
    from torch import nn

    from fasterrcnn_torch.config import TrainConfig
    from fasterrcnn_torch.engine import TrainOptimizer
    from fasterrcnn_torch.models.layers import Linear
    from fasterrcnn_torch.models.resnet import ResNetStage
    from fasterrcnn_torch.models.vgg16 import VGG16Head
    from fasterrcnn_torch.parallel import mesh as mesh_lib
    from fasterrcnn_torch.parallel import tp as tp_lib

    torch.set_num_threads(THREADS)
    out = {
        "world": dist.get_world_size(), "index": (mesh.dp_index, mesh.tp_index),
        "tp_ranks": dist.get_process_group_ranks(mesh.tp_group),
        "dp_ranks": dist.get_process_group_ranks(mesh.dp_group),
        "gathered_rows": mesh_lib.all_gather_rows(mesh, torch.tensor([[10.0 * mesh.dp_index + mesh.tp_index]]))
        .flatten().tolist(),
    }
    # Replicated gradients that part by ulps between the ranks, as a card's
    # nondeterministic reductions leave them.
    grads = torch.full((3,), 1.0) + mesh.rank * 2.0 ** -20
    tp_lib.average_replicated(grads, mesh)
    out["averaged"] = grads.numpy().copy()

    def vgg():
        torch.manual_seed(0)
        with torch.device("meta"):
            head = VGG16Head(dropout=0.5)
        head.fc1, head.fc2 = Linear(24, 16), Linear(16, 8)
        model = nn.Module()
        model.roi_head = head
        return model, (5, 2, 3, 4), lambda m, x: m.roi_head(x)

    def resnet():
        torch.manual_seed(0)
        model = nn.Module()
        model.roi_head = nn.Module()
        model.roi_head.layer4 = ResNetStage(2, 16, 8, 2)
        for name, p in model.named_parameters():
            if name.endswith("scale"):  # frozen BN affines away from the identity
                with torch.no_grad():
                    p.uniform_(0.5, 1.5)
        return model, (3, 16, 7, 7), lambda m, x: m.roi_head.layer4(x)

    for tag, make in (("vgg", vgg), ("resnet", resnet)):
        (full, shape, forward), (shard, _, _) = make(), make()
        tp_lib.shard_model(shard, mesh)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(shape, generator=gen)
        xf, xs = x.clone().requires_grad_(), x.clone().requires_grad_()
        full.train(), shard.train()
        with torch.random.fork_rng():
            yf = forward(full, xf)
        with torch.random.fork_rng():
            ys = forward(shard, xs)
        cotangent = torch.randn(yf.shape, generator=gen)
        (yf * cotangent).sum().backward()
        (ys * cotangent).sum().backward()
        gaps = {"output": float((ys - yf).detach().abs().max()), "input_grad": float((xs.grad - xf.grad).abs().max())}
        for name, p in shard.named_parameters():
            want = mesh_lib.shard_tensor(mesh, full.get_parameter(name).grad, mesh_lib.param_spec(name))
            gaps[name] = float((p.grad - want).abs().max())
        full_state = full.state_dict()
        gathered = mesh_lib.gather_state_dict(mesh, shard.state_dict())
        gathered_equal = gathered.keys() == full_state.keys() and all(
            torch.equal(gathered[k], full_state[k]) for k in full_state)
        sharded_names = [n for n, p in shard.named_parameters() if p.shape != full.get_parameter(n).shape]

        def optimizer(model):
            return TrainOptimizer([(list(model.parameters()), 0.0)], TrainConfig(clipnorm=1e-3), [0.1], "cpu")

        opt_full, opt_shard = optimizer(full), optimizer(shard)
        flagged = [n for n, p in shard.named_parameters() if getattr(p, "tp_sharded", False)]
        opt_shard.reduce_tp_squares(mesh.tp_group)
        norm_shard = float(torch.sqrt(sum((p.grad ** 2).sum() for n, p in shard.named_parameters()
                                          if mesh_lib.param_spec(n) is None) + opt_shard.tp_squares[0]))
        norm_full = float(torch.sqrt(sum((p.grad ** 2).sum() for p in full.parameters())))
        opt_full.step(), opt_shard.step()
        update_gap = max(float((p - mesh_lib.shard_tensor(mesh, full.get_parameter(n), mesh_lib.param_spec(n)))
                               .abs().max()) for n, p in shard.named_parameters())
        out[tag] = dict(
            gaps=gaps, sharded=sharded_names, flagged=flagged,
            gathered_equal=gathered_equal,
            norm_shard=norm_shard, norm_full=norm_full, update_gap=update_gap,
            moments_sharded=all(m.shape == p.shape for m, p in zip(opt_shard.state_tensors()[2:], shard.parameters())),
        )
    return out
