"""Fixed-shape greedy non-maximum suppression over batches of problems.

Greedy NMS semantics (torchvision's): visit boxes in descending score order;
keep a box iff it does not overlap (IoU > threshold, strictly) any earlier
*kept* box. Score ties are broken by input order (a stable sort). Inputs are
padded to K boxes with a validity mask; the result is a keep-mask plus the
top `max_outputs` survivors, gathered into fixed-shape tensors.

`nms_keep_mask` is the kernel wrapper: on a CUDA tensor it launches the
hand-written kernel (`ops/kernels/csrc/nms_keep_mask.cu`), on a CPU tensor it
runs `nms_keep_mask_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fasterrcnn_torch.ops import boxes as box_ops
from fasterrcnn_torch.ops.kernels import _build

NEG_INF = -1e30

# Candidates a word of the kernel's suppression mask covers.
WORD = 64

# The kernel's scan keeps two 8-byte words per 64 candidates of a problem in
# a block's shared memory: at most 227 KB on Hopper, less 4 KB for the scan's
# static shared memory. Long before that, the mask scratch (`mask_bytes`)
# outgrows the card: 104 GB a problem at this K.
MAX_KERNEL_K = (232448 - 4096) // 16 * WORD

# Boxes per block of the plain version's blocked scan.
_BLOCK = 256


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # (..., max_outputs, 4) selected boxes, score-ordered
    scores: torch.Tensor  # (..., max_outputs)
    valid: torch.Tensor  # (..., max_outputs) 1.0 for real selections, 0 for padding


def nms_keep_mask_plain(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_keep: int,
) -> torch.Tensor:
    """Greedy keep-mask over score-sorted boxes, in plain PyTorch.

    The blocked scan of the JAX package's `ops/nms.nms`, batched over
    problems: within a block of boxes the greedy triangle runs row by row;
    each finished block then suppresses all later boxes in one parallel
    sweep. The mask is then cut to the first `max_keep` accepts, which is
    what the kernel's early exit leaves.

    Args:
      boxes: (N, K, 4) f32 corner boxes, each problem in descending score order.
      valid: (N, K) candidate mask.

    Returns:
      (N, K) bool mask of accepted boxes (at most max_keep per problem).
    """
    boxes = boxes.float()
    keep = valid.bool().clone()
    k = boxes.shape[1]
    for start in range(0, k, _BLOCK):
        stop = min(start + _BLOCK, k)
        rows = boxes[:, start:stop]
        # sup[n, i, j]: earlier row i would suppress later row j.
        sup = (box_ops.iou_matrix(rows, rows) > iou_threshold).triu(diagonal=1)
        keep_rows = keep[:, start:stop].clone()
        for i in range(stop - start):
            keep_rows &= ~(sup[:, i] & keep_rows[:, i : i + 1])
        keep[:, start:stop] = keep_rows
        if stop < k:
            iou = box_ops.iou_matrix(rows, boxes[:, stop:])  # (N, B, K - stop)
            killed = ((iou > iou_threshold) & keep_rows[:, :, None]).any(dim=1)
            keep[:, stop:] &= ~killed
    return keep & (keep.cumsum(dim=1) <= max_keep)


def mask_bytes(n: int, k: int) -> int:
    """Bytes of the kernel's suppression-mask scratch for N problems of K boxes."""
    return n * k * -(-k // WORD) * 8


def nms_keep_mask(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float, max_keep: int
) -> torch.Tensor:
    """Greedy keep-mask of N problems: (N, K, 4) f32, (N, K) -> (N, K) bool.

    CPU tensors go to `nms_keep_mask_plain`; CUDA tensors launch the kernel
    (`ops/kernels/csrc/nms_keep_mask.cu`), two passes on the current stream:
    every IoU test into a suppression bitmask, `mask[n, i, w]` (int64 words,
    bit b of word w set iff box i suppresses box 64 w + b > i), then a scan
    of each problem over its words in order. The mask is scratch allocated
    here, `mask_bytes(N, K)` (72 MB at 4 x 12000); if it does not fit on the
    card this raises `torch.cuda.OutOfMemoryError`. K is at most
    `MAX_KERNEL_K`, the scan's shared memory.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"boxes {tuple(boxes.shape)} / valid {tuple(valid.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, valid, iou_threshold, max_keep)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    n, k, _ = boxes.shape
    if k > MAX_KERNEL_K:
        raise ValueError(f"K={k} exceeds the kernel's shared-memory limit {MAX_KERNEL_K}")
    boxes = boxes.contiguous()
    valid = valid.to(torch.bool).contiguous()
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    try:
        mask = torch.empty((n, k, -(-k // WORD)), dtype=torch.int64, device=boxes.device)
    except torch.cuda.OutOfMemoryError as err:
        raise torch.cuda.OutOfMemoryError(
            f"nms_keep_mask: the suppression mask of {n} x {k} boxes needs {mask_bytes(n, k)} bytes "
            f"on {boxes.device}, which cannot be allocated"
        ) from err
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "nms_keep_mask",
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(),
            n, k, float(iou_threshold), int(max_keep), stream,
        )
    nms_keep_mask.launches += 1
    return keep


nms_keep_mask.launches = 0


def _gather_survivors(sboxes, sscores, keep, max_outputs: int) -> NMSResult:
    """First max_outputs kept boxes in score order (inputs score-sorted).

    sboxes (N, K, 4), sscores (N, K), keep (N, K) bool.
    """
    n, kp = keep.shape
    k_out = min(max_outputs, kp)
    rank = torch.arange(kp, 0, -1, dtype=torch.int32, device=keep.device)
    priority = torch.where(keep, rank, 0)
    # Stable descending sort: kept boxes in order, then the rest by index,
    # which is what jax.lax.top_k gives.
    sel = torch.sort(priority, dim=1, descending=True, stable=True).indices[:, :k_out]
    sel_valid = torch.gather(keep, 1, sel)
    if k_out < max_outputs:
        pad = max_outputs - k_out
        sel = torch.cat([sel, sel.new_zeros((n, pad))], dim=1)
        sel_valid = torch.cat([sel_valid, sel_valid.new_zeros((n, pad))], dim=1)
    gathered = torch.gather(sboxes, 1, sel[:, :, None].expand(n, max_outputs, 4))
    return NMSResult(
        boxes=torch.where(sel_valid[:, :, None], gathered, 0.0),
        scores=torch.where(sel_valid, torch.gather(sscores, 1, sel), 0.0),
        valid=sel_valid.float(),
    )


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    presorted: bool = False,
) -> NMSResult:
    """Exact greedy NMS of N padded problems; top max_outputs survivors each.

    Args:
      boxes: (N, K, 4) corner boxes (y1, x1, y2, x2).
      scores: (N, K) scores; invalid entries are ignored regardless of value.
      valid: (N, K) mask of real boxes.
      presorted: promise that valid entries already arrive in descending
        score order, which skips the sort.
    """
    valid = valid.bool()
    scores = torch.where(valid, scores.float(), NEG_INF)
    boxes = boxes.float()
    if presorted:
        sboxes, sscores, svalid = boxes, scores, valid
    else:
        sscores, order = torch.sort(scores, dim=1, descending=True, stable=True)
        sboxes = torch.gather(boxes, 1, order[:, :, None].expand_as(boxes))
        svalid = torch.gather(valid, 1, order)
    keep = nms_keep_mask(sboxes.contiguous(), svalid, iou_threshold, max_outputs)
    return _gather_survivors(sboxes, sscores, keep, max_outputs)
