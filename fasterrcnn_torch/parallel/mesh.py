"""The (dp, tp) mesh: one process a rank, `torch.distributed` between them.

The counterpart of the JAX package's `parallel/mesh.py`. JAX runs one
controller over a (dp, tp) mesh: it shards every batch array along dp and
the tp-sharded parameters along tp, and GSPMD inserts the collectives.
PyTorch's idiom is one process a rank. Rank r sits at (r // tp, r % tp) of
JAX's `devices[:n].reshape(dp, tp)` grid: its dp index is its row, its tp
index its column.

  * dp: each rank takes its dp row's rows of every batch (`Mesh.rows`, the
    counterpart of `P("dp", ...)`) and the gradients are SUM-all-reduced
    over the dp group, the ranks of one tp column, between the steps
    (`models/faster_rcnn.DataParallelStep`).
  * tp: the Megatron split of the heavy head (`param_spec`, JAX's
    `_PARAM_RULES` over the port's names): VGG-16's fc1 holds this rank's
    output rows and fc2 its input columns; each ResNet layer4 block's conv1
    and bn1 hold its output channels and conv2 its input channels. The tp
    group, the ranks of one dp row, runs one all-reduce after fc2 (or
    conv2) forward and one on the input gradient of fc1 (or conv1)
    backward (`parallel/tp.py`).

`make_mesh` plans the mesh (its device list, one a rank) and `spawn` runs a
function in one process a rank, each joined to one process group through a
`FileStore` in a temporary directory (no network), with the tp and dp
subgroups made by `regroup`. The backend follows one rule: nccl when every
rank owns a card of its own, gloo when ranks share a card or run on the CPU
(`backend_for`). Nothing falls back to another backend.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import re
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def backend_for(devices: Sequence[str]) -> str:
    """nccl when every rank owns a CUDA device of its own, else gloo (ranks
    that share a card, or CPU ranks): NCCL refuses two ranks on one card."""
    devs = [torch.device(d) for d in devices]
    cards = [d.index or 0 for d in devs if d.type == "cuda"]
    return "nccl" if len(cards) == len(devs) and len(set(cards)) == len(cards) else "gloo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) mesh, seen from one rank.

    `devices` holds one device a rank; `rank` is this process's, `group`
    the process group of every rank, `tp_group` the ranks of this rank's dp
    row and `dp_group` those of its tp column (all None until `spawn` has
    joined the rank: a mesh from `make_mesh` is the plan every rank starts
    from; a group of one rank stays None, as no collective runs over it)."""

    devices: Tuple[str, ...]
    tp: int = 1
    rank: int = 0
    group: Optional[Any] = None
    tp_group: Optional[Any] = None
    dp_group: Optional[Any] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def dp(self) -> int:
        return len(self.devices) // self.tp

    @property
    def dp_index(self) -> int:
        """This rank's row of the (dp, tp) grid."""
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        """This rank's column of the (dp, tp) grid."""
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def device(self) -> torch.device:
        return torch.device(self.devices[self.rank])

    @property
    def backend(self) -> str:
        return backend_for(self.devices)

    @property
    def is_main(self) -> bool:
        """Rank 0: the one rank that prints and writes files."""
        return self.rank == 0

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a batch of `batch_size`: the dp index-th of
        dp equal blocks, as JAX's dp sharding places them (every rank of a
        dp row holds the same rows)."""
        check_batch_size(self, batch_size)
        n = batch_size // self.dp
        return slice(self.dp_index * n, (self.dp_index + 1) * n)

    def shard_batch(self, x):
        """This rank's rows of a (B, ...) array: JAX's `batch_shardings`,
        P("dp", ...)."""
        return x[self.rows(x.shape[0])]

    def shard_scan_batch(self, x):
        """This rank's rows of a stacked (K, B, ...) block: JAX's
        `scan_batch_shardings`, P(None, "dp", ...)."""
        return x[:, self.rows(x.shape[1])]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Plan a (dp, tp) mesh over the first n_devices of `devices` (default:
    every CUDA device, one a rank). A list that names a device twice puts
    two ranks on it: ["cpu"] * n for CPU ranks, ["cuda:0"] * 2 for two
    ranks sharing a card. tp must divide n_devices (JAX's assertion)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [str(torch.device(d)) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} are available "
            f"({devices or 'no CUDA device'}); for CPU ranks pass devices=['cpu'] * n "
            "(--device cpu)"
        )
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: a mesh needs at least one device")
    if tp < 1 or n_devices % tp != 0:
        raise AssertionError((n_devices, tp))
    return Mesh(tuple(devices[:n_devices]), tp)


def check_batch_size(mesh: Optional[Mesh], batch_size: int) -> None:
    """Every batch is split along dp: the batch size must divide by it."""
    if mesh is None:
        return
    if batch_size % mesh.dp != 0:
        raise ValueError(
            f"batch_size={batch_size} is not divisible by the mesh's "
            f"dp extent {mesh.dp}; every batch is sharded along dp "
            "(residues are padded to batch_size, so only the full size "
            "must divide)"
        )


# Parameter-name regex -> the dimension tp shards, JAX's `_PARAM_RULES` over
# the port's names and layouts (torch's Linear.weight is (out, in), a conv
# weight OIHW). First match wins; no match is replicated.
_PARAM_RULES = (
    # Megatron split of the heavy fc pair (VGG-16 head): fc1 column-sharded
    # (its output rows, and its bias), fc2 row-sharded (its input columns;
    # its bias replicated, added once after the all-reduce).
    (re.compile(r"(.*\.)?roi_head\.fc1\.(weight|bias)"), 0),
    (re.compile(r"(.*\.)?roi_head\.fc2\.weight"), 1),
    # ResNet head (layer4 bottlenecks): conv1 and its BN affine on output
    # channels, conv2 on input channels, one all-reduce after conv2 a
    # block; conv3, bn2, bn3 and the downsample stay replicated.
    (re.compile(r"(.*\.)?roi_head\.layer4\.block\d+\.conv1\.weight"), 0),
    (re.compile(r"(.*\.)?roi_head\.layer4\.block\d+\.bn1\.(scale|bias)"), 0),
    (re.compile(r"(.*\.)?roi_head\.layer4\.block\d+\.conv2\.weight"), 1),
)


def param_spec(name: str) -> Optional[int]:
    """The dimension of parameter `name` (a state-dict key) that tp shards,
    or None when it is replicated."""
    for pattern, dim in _PARAM_RULES:
        if pattern.fullmatch(name):
            return dim
    return None


def warn_if_tp_unused(mesh: Mesh, names: Iterable[str]) -> bool:
    """True iff tp > 1 actually shards at least one of the parameters
    `names` (a state dict's keys will do); warns otherwise: a tp=2 mesh over
    a model no rule matches would replicate everything and do pure
    redundant compute."""
    if mesh.tp <= 1:
        return True
    if any(param_spec(name) is not None for name in names):
        return True
    warnings.warn(
        f"mesh has tp={mesh.tp} but no parameter matches a "
        "tensor-parallel sharding rule — every weight will be replicated "
        "and the tp axis does pure redundant compute. Use tp=1, or add "
        "rules for this model to fasterrcnn_torch/parallel/mesh.py "
        "(_PARAM_RULES).",
        stacklevel=2,
    )
    return False


def shard_tensor(mesh: Mesh, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """This rank's tp shard of the full tensor `t` along `dim` (a view; `t`
    itself when dim is None or tp is 1)."""
    if dim is None or mesh.tp == 1:
        return t
    if t.shape[dim] % mesh.tp != 0:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} does not split along dim {dim} into tp={mesh.tp} shards")
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.tp_index * n, n)


def shard_state_dict(mesh: Mesh, full: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's state dict of a full one: each tp-sharded tensor's shard
    (`param_spec`), every other tensor as it is."""
    return {name: shard_tensor(mesh, torch.as_tensor(t), param_spec(name)) for name, t in full.items()}


def gather_state_dict(mesh: Mesh, sharded: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full state dict of the ranks' shards: each tp-sharded tensor
    all-gathered over the tp group and concatenated in tp order, on the
    shard's device; every other tensor as it is. A collective of every
    rank; `shard_state_dict` undone bit for bit."""
    if mesh.tp == 1:
        return dict(sharded)
    full = {}
    for name, t in sharded.items():
        dim = param_spec(name)
        full[name] = t if dim is None else torch.cat(_all_gather(mesh, t.detach(), mesh.tp_group, mesh.tp),
                                                     dim).to(t.device)
    return full


def _all_gather(mesh: Mesh, x: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    """The n ranks' `x` of `group`, in rank order: on the card under nccl, on
    the CPU under gloo (whose all_gather takes no CUDA tensor)."""
    src = x.contiguous() if mesh.backend == "nccl" else x.cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The dp rows' (b, ...) tensors concatenated in dp order, (dp * b, ...),
    gathered over this rank's dp group (`x` itself when dp is 1)."""
    if mesh.dp == 1:
        return x
    return torch.cat(_all_gather(mesh, x, mesh.dp_group, mesh.dp))


def broadcast_tensors(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite `tensors` (of one device and dtype) in place with rank 0's:
    one broadcast of their flat concatenation over every rank."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0, group=mesh.group)
    with torch.no_grad():
        for t, v in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(v.view(t.shape))


def broadcast_value(mesh: Mesh, value):
    """Rank 0's picklable `value` on every rank."""
    box = [value]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def regroup(mesh: Mesh, tp: int) -> Mesh:
    """The joined mesh's ranks as a (size // tp, tp) mesh, seen from this
    rank: the same process group, with the tp and dp subgroups of the new
    grid. A collective: every rank calls it with the same tp (each subgroup
    is made by every rank, in one order, as `dist.new_group` requires)."""
    plan = make_mesh(mesh.size, tp, mesh.devices)
    dp = plan.dp
    rows = [[d * tp + t for t in range(tp)] for d in range(dp)]
    columns = [[d * tp + t for d in range(dp)] for t in range(tp)]

    def mine(grids):
        if len(grids[0]) == 1:
            return None  # a group of one rank: nothing to reduce over
        if len(grids) == 1:
            return mesh.group
        groups = [dist.new_group(ranks) for ranks in grids]
        return next(g for ranks, g in zip(grids, groups) if mesh.rank in ranks)

    return dataclasses.replace(plan, rank=mesh.rank, group=mesh.group, tp_group=mine(rows),
                               dp_group=mine(columns))


def join(mesh: Mesh, rank: int, store_path: str, collective_timeout_s: float) -> Mesh:
    """Join rank `rank` to the mesh's process group (a FileStore at
    store_path, every rank of the mesh) and return the mesh seen from it,
    its tp and dp subgroups made. A collective that waits longer than
    collective_timeout_s raises."""
    device = torch.device(mesh.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        mesh.backend,
        store=dist.FileStore(store_path, mesh.size),
        rank=rank,
        world_size=mesh.size,
        timeout=datetime.timedelta(seconds=collective_timeout_s),
    )
    return regroup(dataclasses.replace(mesh, rank=rank, group=dist.group.WORLD), mesh.tp)


def _rank_main(fn, mesh, rank, store_path, collective_timeout_s, args, results) -> None:
    try:
        joined = join(mesh, rank, store_path, collective_timeout_s)
        try:
            value = fn(joined, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, value))


def spawn(fn: Callable, mesh: Mesh, args: tuple = (), timeout: Optional[float] = None,
          collective_timeout: float = 1800.0) -> List:
    """Run `fn(mesh_of_rank, *args)` in one new process a rank and return
    the ranks' results in rank order.

    `fn`, `args` and the results are pickled (`fn` by its import path). A
    rank that raises or dies fails the call: every other rank is stopped
    and RuntimeError raised with the rank's traceback. So is a run longer
    than `timeout` seconds (TimeoutError); a collective that waits longer
    than `collective_timeout` raises in its rank.
    """
    ctx = multiprocessing.get_context("spawn")
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="fasterrcnn-mesh-") as tmp:
        channel = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main, name=f"rank{r}",
                        args=(fn, mesh, r, os.path.join(tmp, "store"), collective_timeout, args, channel))
            for r in range(mesh.size)
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        started = []
        try:
            for p in procs:
                p.start()
                started.append(p)
            while len(results) < mesh.size:
                try:
                    rank, ok, value = channel.get(timeout=0.5)
                except queue.Empty:
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(f"the {mesh.size} ranks did not finish within {timeout} s")
                    dead = [(r, p.exitcode) for r, p in enumerate(procs) if r not in results and p.exitcode]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} before it reported")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {mesh.size} failed:\n{value}")
                results[rank] = value
            for p in procs:
                p.join()
        finally:
            for p in started:
                if p.is_alive():
                    p.terminate()
            for p in started:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(mesh.size)]
