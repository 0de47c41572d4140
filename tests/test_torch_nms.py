"""The NMS kernel's (K1) word-level algorithm, replayed in plain PyTorch.

`fasterrcnn_torch/ops/kernels/csrc/nms_keep_mask.cu` runs in two passes:

  1. the IoU mask: `mask[n, i, w]`, an int64 word a (box, 64 candidates);
     bit b of word w is set iff box i suppresses box j = 64 w + b, which
     needs j > i; only the tiles at or above the diagonal tile (column
     tile >= row tile) are written; a test whose intersection is 0 skips
     the division when the threshold is >= 0;
  2. the scan, a problem at a time, over the words in order: `removed`
     starts at ~valid with the bits past K set; a word's free candidates
     are resolved in rounds from their diagonal words (a candidate that no
     undecided one suppresses is accepted, and what it suppresses is
     rejected); the cut at max_keep keeps the word's lowest accepts; then
     the rows of the word's accepts are ORed into every later word.

This file replays both passes on the CPU, with the kernel's arithmetic, bit
order and tiles, and holds the replay equal to `nms_keep_mask_plain` and to
the TPU kernel in interpret mode: it pins the layout the CUDA code follows,
which `tests/test_torch_cuda.py` then holds on the card. Keep-masks are
decisions, so every comparison demands identical masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fasterrcnn_tpu.ops.pallas.nms_pallas import nms_keep_mask_pallas
from fasterrcnn_torch.ops import nms as torch_nms
from fasterrcnn_torch.scripts.profile_nms import clustered_boxes, sorted_boxes

WORD = torch_nms.WORD
FULL = (1 << 64) - 1
# Bit b of an int64 word: 1 << b, and -2**63 for bit 63.
BITS = torch.tensor([1 << b for b in range(63)] + [-(1 << 63)], dtype=torch.int64)
# What a word below the diagonal tile holds: it is never written (the
# wrapper allocates the mask with torch.empty), so it may hold anything;
# all ones would suppress every candidate if the scan read it.
NEVER_WRITTEN = -1


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., W * 64) bool -> (..., W) int64 words, candidate 64 w + b at bit b."""
    return (bits.reshape(*bits.shape[:-1], -1, WORD).long() * BITS).sum(-1)


def replay_mask(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Pass 1: (N, K, 4) f32 -> (N, K, ceil(K / 64)) int64 suppression words."""
    n, k, _ = boxes.shape
    words = -(-k // WORD)
    y1, x1, y2, x2 = (c[:, :, None] for c in boxes.unbind(-1))  # row i: the earlier box
    yj1, xj1, yj2, xj2 = (c[:, None, :] for c in boxes.unbind(-1))  # column j: the later box
    tly, tlx = torch.maximum(y1, yj1), torch.maximum(x1, xj1)
    bry, brx = torch.minimum(y2, yj2), torch.minimum(x2, xj2)
    inter = torch.where((tly < bry) & (tlx < brx), (bry - tly) * (brx - tlx), 0.0)
    iarea, area = (y2 - y1) * (x2 - x1), (yj2 - yj1) * (xj2 - xj1)
    hit = inter / (iarea + area - inter + 1e-7) > iou_threshold
    if iou_threshold >= 0:
        hit &= inter != 0  # the skipped division
    j = torch.arange(k)
    hit &= j[None, :] > j[:, None]
    packed = pack(F.pad(hit, (0, words * WORD - k)))
    written = torch.arange(words)[None, :] >= (j // WORD)[:, None]
    return torch.where(written, packed, NEVER_WRITTEN)


def lowest_bits(x: int, count: int) -> int:
    if count <= 0:
        return 0
    while bin(x).count("1") > count:
        x &= ~(1 << (x.bit_length() - 1))
    return x


def replay_scan(mask: torch.Tensor, valid: torch.Tensor, max_keep: int) -> torch.Tensor:
    """Pass 2: (N, K, W) int64 words, (N, K) -> (N, K) bool keep-mask."""
    n, k, words = mask.shape
    keep = torch.zeros((n, k), dtype=torch.bool)
    for p in range(n):

        def row_word(i: int, w: int) -> int:
            assert w >= i // WORD, f"read word {w} of row {i}, below the diagonal tile"
            return int(mask[p, i, w]) & FULL

        removed = pack(~F.pad(valid[p].bool(), (0, words * WORD - k)))
        kept = 0
        for w in range(words):
            diag = [row_word(WORD * w + b, w) if WORD * w + b < k else 0 for b in range(WORD)]

            def suppressed_by(cands: int) -> int:
                out = 0
                for b in range(WORD):
                    if cands >> b & 1:
                        out |= diag[b]
                return out

            undecided, acc = ~int(removed[w]) & FULL, 0
            while undecided:
                sure = undecided & ~suppressed_by(undecided)
                acc |= sure
                undecided &= ~sure & ~suppressed_by(sure)
            acc = lowest_bits(acc, max_keep - kept)
            accepts = [b for b in range(WORD) if acc >> b & 1]
            keep[p, [WORD * w + b for b in accepts]] = True
            kept += len(accepts)
            if kept >= max_keep or w == words - 1:
                break
            for b in accepts:  # the OR pass
                i = WORD * w + b
                row_word(i, w + 1)
                removed[w + 1 :] |= mask[p, i, w + 1 :]
    return keep


def replay(boxes, valid, iou_threshold, max_keep):
    return replay_scan(replay_mask(boxes, iou_threshold), valid, max_keep)


def inputs(seed, layout, n, k):
    """Spread boxes, boxes piled onto a few objects, and spread boxes with a
    valid mask that is mostly False."""
    rng = np.random.default_rng(seed)
    if layout == "clustered":
        boxes = clustered_boxes(rng, n, k, 300.0, 400.0)
    else:
        boxes = sorted_boxes(rng, n, k, 300.0, 400.0)
    valid = rng.uniform(size=(n, k)) > (0.8 if layout == "sparse" else 0.1)
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.parametrize("max_keep", [0, 1, 40, None])
@pytest.mark.parametrize("iou_threshold", [0.3, 0.5, 0.7, 1.0])
@pytest.mark.parametrize("k", [1, 37, 63, 64, 65, 300, 1000])
def test_word_replay_matches_plain(k, iou_threshold, max_keep):
    max_keep = k if max_keep is None else max_keep
    for layout in ("spread", "clustered", "sparse"):
        boxes, valid = inputs(k, layout, 2, k)
        want = torch_nms.nms_keep_mask_plain(boxes, valid, iou_threshold, max_keep)
        got = replay(boxes, valid, iou_threshold, max_keep)
        assert torch.equal(got, want), f"{layout}: {int((got != want).sum())} entries differ"


@pytest.mark.parametrize("layout", ["spread", "clustered"])
@pytest.mark.parametrize("iou_threshold,max_keep", [(0.5, None), (0.7, 40)])
@pytest.mark.parametrize("k", [128, 384])
def test_word_replay_matches_pallas_kernel(k, iou_threshold, max_keep, layout):
    max_keep = k if max_keep is None else max_keep
    boxes, valid = inputs(k + 1, layout, 2, k)
    got = replay(boxes, valid, iou_threshold, max_keep)
    for i in range(2):
        want = nms_keep_mask_pallas(
            jnp.asarray(boxes[i].numpy()), jnp.asarray(valid[i].numpy().astype(np.float32)),
            iou_threshold=iou_threshold, max_keep=max_keep, interpret=True,
        )
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want) > 0)


def test_mask_layout_bit_order_diagonal_and_ragged_word():
    """65 copies of one box: each suppresses every later one."""
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]]).repeat(65, 1)[None]
    mask = replay_mask(boxes, 0.5)
    assert mask.shape == (1, 65, 2) and mask.dtype == torch.int64
    assert int(mask[0, 0, 0]) & FULL == FULL - 1  # boxes 1..63: bits 1..63 of word 0
    assert int(mask[0, 0, 1]) == 1  # box 64 is bit 0 of word 1; bits past K stay clear
    assert int(mask[0, 63, 0]) == 0 and int(mask[0, 63, 1]) == 1
    assert int(mask[0, 64, 0]) == NEVER_WRITTEN  # below the diagonal tile
    assert int(mask[0, 64, 1]) == 0
    keep = replay_scan(mask, torch.ones((1, 65), dtype=torch.bool), 10)
    assert keep[0].nonzero().flatten().tolist() == [0]


def test_max_keep_cuts_inside_a_word():
    """Disjoint boxes, every third invalid: the first 40 valid are kept, the
    cut falling in the middle of word 0 and, with a later start, of word 1."""
    k = 130
    boxes = torch.stack([torch.tensor([0.0, 20.0 * i, 10.0, 20.0 * i + 10.0]) for i in range(k)])[None]
    valid = (torch.arange(k) % 3 != 2)[None]
    for max_keep in (40, 70):
        got = replay(boxes, valid, 0.5, max_keep)
        assert torch.equal(got, torch_nms.nms_keep_mask_plain(boxes, valid, 0.5, max_keep))
        assert got[0].nonzero().flatten().tolist() == valid[0].nonzero().flatten().tolist()[:max_keep]


def test_resolve_rounds_follow_a_chain_of_suppression():
    """Boxes in a row, each overlapping only its neighbours (IoU 1/3): box 1
    is suppressed by box 0, box 2 only by box 1 (rejected), and so on, so
    the rounds accept every other box; across a word boundary too."""
    k = 70
    boxes = torch.stack([torch.tensor([0.0, 10.0 * i, 10.0, 10.0 * i + 20.0]) for i in range(k)])[None]
    valid = torch.ones((1, k), dtype=torch.bool)
    got = replay(boxes, valid, 0.3, k)
    assert torch.equal(got, torch_nms.nms_keep_mask_plain(boxes, valid, 0.3, k))
    assert got[0].nonzero().flatten().tolist() == list(range(0, k, 2))


def test_zero_intersection_never_suppresses_at_a_threshold_of_zero_or_more():
    """The skipped division: disjoint, touching, empty and inverted boxes
    have an IoU of 0, -0 or NaN, never above a threshold >= 0."""
    boxes = torch.tensor([
        [0.0, 0.0, 10.0, 10.0], [0.0, 10.0, 10.0, 20.0], [20.0, 20.0, 20.0, 20.0],
        [5.0, 5.0, 5.0, 9.0], [30.0, 30.0, 25.0, 25.0], [0.0, 0.0, -1.0, 1e-8], [50.0, 0.0, 60.0, 10.0],
    ])[None]
    y1, x1, y2, x2 = (c[:, None] for c in boxes[0].T)
    yj1, xj1, yj2, xj2 = (c[None, :] for c in boxes[0].T)
    tly, tlx = torch.maximum(y1, yj1), torch.maximum(x1, xj1)
    bry, brx = torch.minimum(y2, yj2), torch.minimum(x2, xj2)
    inter = torch.where((tly < bry) & (tlx < brx), (bry - tly) * (brx - tlx), 0.0)
    ratio = inter / ((y2 - y1) * (x2 - x1) + (yj2 - yj1) * (xj2 - xj1) - inter + 1e-7)
    assert bool((inter == 0).any())
    assert not bool((ratio[inter == 0] > 0.0).any())
    valid = torch.ones((1, 7), dtype=torch.bool)
    for thr in (-0.5, 0.0, 0.5):
        assert torch.equal(replay(boxes, valid, thr, 7), torch_nms.nms_keep_mask_plain(boxes, valid, thr, 7))


def test_mask_bytes_is_the_scratch_of_the_train_and_predict_shapes():
    assert torch_nms.mask_bytes(4, 12000) == 4 * 12000 * 188 * 8  # 72.2 MB
    assert torch_nms.mask_bytes(4, 6000) == 4 * 6000 * 94 * 8  # 18.0 MB
    assert torch_nms.mask_bytes(80, 300) == 80 * 300 * 5 * 8
    assert torch_nms.MAX_KERNEL_K % WORD == 0
