"""One production-shape train step on a (dp=4, tp=2) mesh against one device.

The port's counterpart of the JAX package's `scripts/prodshape_mesh_parity.py`:
the packed train step (`Engine.packed_step_for`, the production train
program) at the full 608x800 canvas, B=8, the default `ModelConfig()`
(VGG-16, full anchor pyramid, 12000 -> 2000 proposal caps), f32 with TF32
off, runs once on one device and once on a dp=4 x tp=2 mesh of 8 ranks
(`parallel/mesh.py`: each rank two rows of the batch, fc1 and fc2 split
across each tp pair), from the same seeded parameters, batch and sampling
generator. It compares the (4,) loss vectors and every updated parameter
(the mesh's gathered over tp), prints one JSON line in the JAX record's
keys (plus the device and, on a card, its name and power limit) and exits
nonzero on a mismatch.

Run from the repository root:
  python -m fasterrcnn_torch.scripts.prodshape_mesh_parity            # on the card
  python -m fasterrcnn_torch.scripts.prodshape_mesh_parity --device cpu

On the card the 8 ranks share `cuda:0` over gloo unless there are 8 cards
(then one a rank, over nccl); with --device cpu they are CPU ranks (slow:
minutes a step). The one-device step runs first, in this process, and its
memory is released before the ranks start.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np

CANVAS = (608, 800)
# The JAX script's mesh and batch: dp=4 x tp=2, two rows a dp rank.
DP, TP, BATCH = 4, 2, 8
# Seconds the 8 ranks may take (minutes a step on CPU ranks).
TIMEOUT = 3000.0
# The JAX record's bound on both gaps.
TOLERANCE = 1e-4


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("prodshape_mesh_parity")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def host_batch(b: int, max_gt: int):
    """The JAX script's batch: seeded uint8 images on the 608x800 canvas,
    real extent 600x800, three boxes an image (numpy's default_rng(0))."""
    from fasterrcnn_torch.data.pipeline import HostBatch

    rng = np.random.default_rng(0)
    h, w = CANVAS
    images = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_classes = np.zeros((b, max_gt), np.int32)
    gt_mask = np.zeros((b, max_gt), np.float32)
    for i in range(b):
        for j in range(3):
            y1, x1 = rng.uniform(0, 400), rng.uniform(0, 500)
            gt_boxes[i, j] = [y1, x1, y1 + rng.uniform(60, 180), x1 + rng.uniform(60, 250)]
            gt_classes[i, j] = rng.integers(1, 21)
            gt_mask[i, j] = 1.0
    return HostBatch(CANVAS, images, np.tile(np.float32([[600.0, 800.0]]), (b, 1)), gt_boxes, gt_classes, gt_mask,
                     np.ones((b,), np.float32), [])


def step(engine, hb, mesh=None) -> np.ndarray:
    """One packed step of `engine` on `hb` (on a mesh, on this rank's rows,
    over the whole batch's denominator): the (4,) loss vector."""
    import torch

    from fasterrcnn_torch.models.faster_rcnn import pack_aux

    images, aux = hb.images, pack_aux(hb, 5)
    args = []
    if mesh is not None:
        images, aux = mesh.shard_batch(images), mesh.shard_batch(aux)
        args = [torch.tensor(np.float32(hb.sample_weight.sum()) + np.float32(1e-7), device=engine.device)]
    _, vec = engine.packed_step_for(CANVAS)(torch.as_tensor(images, device=engine.device),
                                            torch.as_tensor(aux, device=engine.device), *args)
    return vec.cpu().numpy()


def make_engine(device=None, mesh=None):
    import torch

    from fasterrcnn_torch.config import ModelConfig
    from fasterrcnn_torch.engine import Engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return Engine(ModelConfig(), seed=0, device=device, mesh=mesh)


def rank_step(mesh, b, out_path):
    """One rank's step; rank 0 writes the gathered parameters to out_path.
    Every rank returns its loss vector."""
    import torch

    engine = make_engine(mesh=mesh)
    vec = step(engine, host_batch(b, engine.model_cfg.max_gt_boxes), mesh)
    full = engine.full_state_dict()
    if mesh.is_main:
        torch.save({k: v.detach().cpu() for k, v in full.items()}, out_path)
    return vec


def compare(vec_mesh, vec_one, params_mesh, params_one) -> dict:
    """The JAX record's gaps: the largest |difference| of the loss vectors
    and of any parameter, and whether both lie below TOLERANCE with finite
    mesh losses (and the two parameter sets name the same tensors)."""
    dloss = float(np.max(np.abs(np.asarray(vec_mesh, np.float64) - np.asarray(vec_one, np.float64))))
    same_names = sorted(params_mesh) == sorted(params_one)
    dparams = max(float(np.max(np.abs(np.asarray(params_mesh[k], np.float32) - np.asarray(params_one[k], np.float32))))
                  for k in params_one if k in params_mesh)
    ok = bool(same_names and dloss < TOLERANCE and dparams < TOLERANCE and np.isfinite(vec_mesh).all())
    return {"dloss_max": dloss, "dparams_max": dparams, "ok": ok}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from fasterrcnn_torch.engine import resolve_device
    from fasterrcnn_torch.parallel import mesh as mesh_lib

    device = resolve_device(args.device)
    n = DP * TP
    b = BATCH
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)] if cards >= n else ["cuda:0"] * n
    else:
        devices = ["cpu"] * n
    mesh = mesh_lib.make_mesh(n, tp=TP, devices=devices)

    t0 = time.perf_counter()
    engine = make_engine(device=device)
    vec_one = step(engine, host_batch(b, engine.model_cfg.max_gt_boxes))
    params_one = {k: v.detach().cpu().numpy() for k, v in engine.model.state_dict().items()}
    t_one = time.perf_counter() - t0
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="mesh_parity_") as tmp:
        path = os.path.join(tmp, "mesh.pth")
        t0 = time.perf_counter()
        vecs = mesh_lib.spawn(rank_step, mesh, args=(b, path), timeout=TIMEOUT)
        t_mesh = time.perf_counter() - t0
        params_mesh = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    vec_mesh = vecs[0]
    record = {
        "canvas": f"{CANVAS[0]}x{CANVAS[1]}",
        "batch_size": b,
        "mesh": f"dp={mesh.dp} x tp={mesh.tp} ({n} ranks on {', '.join(sorted(set(devices)))}, {mesh.backend})",
        "program": "Engine.packed_step_for (production train program), f32, TF32 off",
        "losses_mesh": [round(float(x), 6) for x in vec_mesh],
        **compare(vec_mesh, vec_one, params_mesh, params_one),
        "ranks_agree": bool(all(np.array_equal(v, vec_mesh) for v in vecs)),
        "step_seconds_mesh": round(t_mesh, 1),
        "step_seconds_single": round(t_one, 1),
        "device": str(device),
    }
    record["ok"] = record["ok"] and record["ranks_agree"]
    if device.type == "cuda":
        record["card"] = card_line()
    print(json.dumps(record), flush=True)
    if not record["ok"]:
        raise SystemExit(f"production-shape mesh parity FAILED: {record}")
    return record


if __name__ == "__main__":
    main()
