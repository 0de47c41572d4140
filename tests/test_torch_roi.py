"""Replays of the RoI kernels' geometry on the CPU.

K2 (`csrc/roi_pool_taps.cu`) and K3 (`csrc/roi_pool_taps_bwd.cu`) run only
on the card. What they decide on the host's behalf is replayed here in
plain Python over torch tensors, control flow as the kernels run it:

* the launch: blocks of (RoI, chunk of 32 lanes) by 7 warps, one a pooled
  row; a lane is 16 bytes of channels (4 f32, 8 bf16) when C and every
  pointer allow it, else one channel (`ops/roi.lane_width`);
* the walk (`XWalk`, `RowWalk`, `walk_pairs` in `csrc/roi_taps_common.cuh`):
  a RoI's x-samples taken in the order that makes their tap cells rise
  (reversed for an inverted RoI), each sample row y-interpolating each
  column of the cells' range once and keeping the last two, a sample
  complete at its last tap, the two samples of a pooled column neighbours;
* K3's reduction grouping: each sample row sums the x-taps of its tied
  samples per column (`ColumnSums`), in walk order, and a column leaves
  through the row's two y-taps once the walk has passed it.

The arithmetic is the kernels' own, lane by lane (f32 tensor operations,
each rounded once, then to the map's type where the kernels round), so the
forward replay must equal `roi_pool_features` bit for bit; the backward
replay sums in another order than `roi_pool_taps_bwd_plain` and is held to
the card test's tolerance (`backward_close`), and to the Pallas backward in
interpret mode at the f32 tolerance of `tests/test_torch_train.py`.
"""

import numpy as np
import pytest
import torch

from fasterrcnn_tpu.ops.pallas import roi_pallas
from fasterrcnn_torch.ops import roi as torch_roi
from fasterrcnn_torch.scripts.profile_roi import backward_close
from tests.test_torch_cuda import edge_roi_inputs, roi_inputs

CHUNK_LANES = 32  # kChunkLanes
OUT = 7


def lane_chunks(c, vec):
    return (c // vec + CHUNK_LANES - 1) // CHUNK_LANES


def threads(c, vec):
    """The (RoI-independent) lanes of the launch that do work: (chunk,
    threadIdx.x) -> the channels of that lane."""
    for chunk in range(lane_chunks(c, vec)):
        for tx in range(CHUNK_LANES):
            lane = chunk * CHUNK_LANES + tx
            if lane * vec < c:  # the kernels' early return
                yield range(lane * vec, lane * vec + vec)


class Samples:
    """`sample_positions`: per axis the low cell, the two tap weights
    (rounded to the map's type) and whether each of the 14 samples lies
    inside the map."""

    def __init__(self, rois, norm, b, p, h, w, dtype):
        ys, xs = torch_roi._sample_positions(rois, norm)
        self.axes = []
        for pos, size in ((ys[b, p], h), (xs[b, p], w)):
            cell = torch.floor(pos)
            frac = pos - cell
            inside = (pos >= 0) & (pos <= size - 1)
            self.axes.append((
                [int(v) if ok else 0 for v, ok in zip(cell.tolist(), inside.tolist())],
                torch_roi._round_to(1.0 - frac, dtype), torch_roi._round_to(frac, dtype), inside.tolist(),
            ))


class XWalk:
    """The x-walk: the samples in the order that makes their tap cells
    rise, over the range of columns those cells cover."""

    def __init__(self, smp, w):
        cells, _, _, inside = smp.axes[1]
        live = [q for q in range(14) if inside[q]]
        self.smp, self.w = smp, w
        self.up, self.x0, self.ncols = True, 0, 0
        if live:
            self.up = cells[live[-1]] >= cells[live[0]]
            self.x0 = cells[live[0] if self.up else live[-1]]
            x1 = cells[live[-1] if self.up else live[0]]
            self.ncols = x1 + (2 if x1 + 1 < w else 1) - self.x0

    def q(self, j):
        return j if self.up else 13 - j

    def at(self, q):
        cells, _, _, inside = self.smp.axes[1]
        if not inside[q]:
            return -1
        return cells[q] - self.x0 + (1 if cells[q] + 1 < self.w else 0)


class RowWalk:
    """One sample row along the walk: the row at the previous and current
    columns, each the f32 sum of its two y-taps rounded to the map's type."""

    def __init__(self, smp, s, image, dtype):
        cells, w_lo, w_hi, inside = smp.axes[0]
        self.y, self.wy_lo, self.wy_hi, self.inside = cells[s], w_lo[s], w_hi[s], inside[s]
        self.image, self.dtype = image, dtype
        self.prev = self.cur = None
        self.columns = []  # columns interpolated, in order

    def advance(self, x):
        if not self.inside:
            return
        self.columns.append(x)
        a = self.image[self.y, x]
        if self.y + 1 < self.image.shape[0]:
            v = self.wy_lo * a + self.wy_hi * self.image[self.y + 1, x]
        else:
            v = self.wy_lo * a
        self.prev, self.cur = self.cur, torch_roi._round_to(v, self.dtype)

    def sample(self, x_inside, has_hi, wx_lo, wx_hi):
        if not (self.inside and x_inside):
            return torch.zeros(self.image.shape[-1])
        r = lambda v: torch_roi._round_to(v, self.dtype)  # noqa: E731
        v = r(wx_lo * (self.prev if has_hi else self.cur))
        if has_hi:
            v = r(v + r(wx_hi * self.cur))
        return v


def walk_pairs(smp, image, py, dtype, done, rows_out=None):
    """`walk_pairs`: calls done(px, up, t0, t1, b0, b1) for each pooled
    column in walk order."""
    w = image.shape[1]
    cells, wx_lo, wx_hi, inside = smp.axes[1]
    wk = XWalk(smp, w)
    rows = [RowWalk(smp, 2 * py + r, image, dtype) for r in (0, 1)]
    first = None

    def complete(j):
        nonlocal first
        q = wk.q(j)
        has_hi = cells[q] + 1 < w
        vals = [row.sample(inside[q], has_hi, wx_lo[q], wx_hi[q]) for row in rows]
        if j % 2 == 0:
            first = vals
        elif wk.up:
            done(q // 2, wk.up, first[0], vals[0], first[1], vals[1])
        else:
            done(q // 2, wk.up, vals[0], first[0], vals[1], first[1])

    j = 0
    while j < 14 and wk.at(wk.q(j)) < 0:
        complete(j)
        j += 1
    for k in range(wk.ncols):
        for row in rows:
            row.advance(wk.x0 + k)
        while j < 14 and wk.at(wk.q(j)) <= k:
            complete(j)
            j += 1
    assert j == 14, "every sample completes"
    if rows_out is not None:
        rows_out += rows


class ColumnSums:
    """K3's row cotangent over the two columns the walk is on."""

    def __init__(self, smp, s, grad):
        cells, w_lo, w_hi, _ = smp.axes[0]
        self.y, self.wy_lo, self.wy_hi, self.grad = cells[s], w_lo[s], w_hi[s], grad
        self.key, self.val = [-1, -1], [None, None]

    def flush(self, k):
        if self.key[k] < 0:
            return
        if bool(self.val[k].ne(0).any()):
            self.grad[self.y, self.key[k]] += self.val[k] * self.wy_lo
            if self.y + 1 < self.grad.shape[0]:
                self.grad[self.y + 1, self.key[k]] += self.val[k] * self.wy_hi
        self.key[k] = -1

    def add(self, x, share, weight):
        k = 0 if self.key[0] == x or (self.key[1] != x and self.key[0] < 0) else 1
        t = share * weight
        self.val[k] = t if self.key[k] != x else self.val[k] + t
        self.key[k] = x

    def sample(self, x, wx_lo, wx_hi, share):
        w = self.grad.shape[1]
        has_hi = x + 1 < w
        x_hi = x + 1 if has_hi else x
        for k in (0, 1):
            if self.key[k] not in (x, x_hi):
                self.flush(k)
        self.add(x, share, wx_lo)
        if has_hi:
            self.add(x + 1, share, wx_hi)


def replay_forward(fm, rois, norm, vec, rows=None):
    """K2 as launched: (B, P, 7, 7, C) in the map's type. `rows`, if given,
    collects every RowWalk (each with the columns it interpolated)."""
    b, h, w, c = fm.shape
    p = rois.shape[1]
    out = torch.full((b, p, OUT, OUT, c), float("nan"))
    image_f32 = fm.float()
    channels = [ch for lane in threads(c, vec) for ch in lane]
    assert sorted(channels) == list(range(c)), "each channel in exactly one lane"
    for bi in range(b):
        for pi in range(p):
            smp = Samples(rois, norm, bi, pi, h, w, fm.dtype)
            # Every lane of a warp takes the same branches (the positions are
            # the RoI's), so all lanes are walked at once.
            for py in range(OUT):
                def done(px, up, t0, t1, b0, b1):
                    out[bi, pi, py, px] = torch.fmax(torch.fmax(t0, t1), torch.fmax(b0, b1))
                walk_pairs(smp, image_f32[bi], py, fm.dtype, done, rows)
    return out.to(fm.dtype)


def replay_backward(fm, rois, norm, g, vec):
    """K3 as launched: the f32 cotangent of the map, cast to its type."""
    b, h, w, c = fm.shape
    p = rois.shape[1]
    assert sorted(ch for lane in threads(c, vec) for ch in lane) == list(range(c))
    image_f32, gf = fm.float(), g.float()
    gfm = torch.zeros((b, h, w, c))
    for bi in range(b):
        for pi in range(p):
            smp = Samples(rois, norm, bi, pi, h, w, fm.dtype)
            cells, wx_lo, wx_hi, inside = smp.axes[1]
            y_inside = smp.axes[0][3]
            for py in range(OUT):
                sums = [ColumnSums(smp, 2 * py + r, gfm[bi]) for r in (0, 1)]

                def scatter(q, top, bottom):
                    if not inside[q]:
                        return
                    for r, share in ((0, top), (1, bottom)):
                        if y_inside[2 * py + r]:
                            sums[r].sample(cells[q], wx_lo[q], wx_hi[q], share)

                def done(px, up, t0, t1, b0, b1):
                    v = [t0, t1, b0, b1]
                    m = torch.fmax(torch.fmax(v[0], v[1]), torch.fmax(v[2], v[3]))
                    tied = [vk == m for vk in v]
                    each = gf[bi, pi, py, px] / sum(t.float() for t in tied)
                    s = [torch.where(t, each, 0.0) for t in tied]
                    order = ((2 * px, s[0], s[2]), (2 * px + 1, s[1], s[3]))
                    for q, top, bottom in order if up else order[::-1]:
                        scatter(q, top, bottom)

                walk_pairs(smp, image_f32[bi], py, fm.dtype, done)
                for r in (0, 1):
                    sums[r].flush(0)
                    sums[r].flush(1)
    return gfm.to(fm.dtype)


def vec_of(c, dtype, nbytes=16):
    """The lane width the wrapper picks on aligned data: K2 16 bytes, K3 8."""
    vec = nbytes // torch.empty((), dtype=dtype).element_size()
    return vec if c % vec == 0 else 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 8, 36, 512, 1030])
def test_forward_walk_equals_the_plain_version(c, dtype):
    """Inverted, zero-area, fully- and partly-outside RoIs and RoIs reaching
    pos == size-1, among random ones, on lanes of 4/8 channels or scalar."""
    fm, rois, norm = edge_roi_inputs(c, 2, 6, 8, c, 7)
    fm = fm.to(dtype)
    want = torch_roi.roi_pool_features(fm, rois, norm)
    assert torch.equal(replay_forward(fm, rois, norm, vec_of(c, dtype)), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (5, 1), (2, 2), (2, 7)])
def test_forward_walk_on_maps_one_and_two_cells_wide(hw, dtype):
    h, w = hw
    fm, rois, norm = edge_roi_inputs(h * 10 + w, 1, h, w, 16, 7)
    fm = torch.relu(fm).to(dtype)
    want = torch_roi.roi_pool_features(fm, rois, norm)
    assert torch.equal(replay_forward(fm, rois, norm, vec_of(16, dtype)), want)


def needed_columns(smp, w):
    cells, _, _, inside = smp.axes[1]
    return {x for q in range(14) if inside[q] for x in (cells[q], cells[q] + 1) if x < w}


def test_the_walk_interpolates_each_column_once():
    """A sample row interpolates each column of its RoI's tap range once,
    in rising order, however the cells come: rising, falling (an inverted
    RoI) or all one cell (zero width). Up to 26 cells wide the range holds
    only columns a sample reads; wider, it also holds the cells between
    samples more than 2 cells apart."""
    fm, rois, norm = edge_roi_inputs(3, 1, 6, 60, 4, 8)
    rois[0, 6] = torch.tensor([0.0, 0.0, 96.0, 960.0])  # 59 cells wide: samples 4.5 cells apart
    rois[0, 7] = torch.tensor([0.0, 960.0, 96.0, 0.0])  # the same, inverted
    rows = []
    replay_forward(fm, rois, norm, 4, rows)
    for pi in range(8):
        smp = Samples(rois, norm, 0, pi, 6, 60, fm.dtype)
        needed = needed_columns(smp, 60)
        span = list(range(min(needed), max(needed) + 1)) if needed else []
        for row in rows[pi * 14:(pi + 1) * 14]:
            assert row.columns == (span if row.inside else []), (pi, row.columns, span)
        xs = torch_roi._sample_positions(rois, norm)[1][0, pi]
        if float((xs[1:] - xs[:-1]).abs().max()) <= 2.0:  # no cell between two samples' taps
            assert set(span) == needed
    # The 59-cell RoI: 13 samples of two taps and the last, on the map's
    # last cell, of one: 27 columns read, all 60 walked.
    assert len(needed_columns(Samples(rois, norm, 0, 6, 6, 60, fm.dtype), 60)) == 27
    assert len(rows[6 * 14].columns) == 60
    # A RoI about one cell wide on a 50-wide map: 14 samples read 28 taps
    # from 3 columns, and each row interpolates those 3.
    narrow = torch.tensor([[[100.0, 10.0, 300.0, 26.0]]])
    rows = []
    replay_forward(torch.ones((1, 38, 50, 4)), narrow, torch.tensor([[36 / 600, 49 / 800]]), 4, rows)
    assert [len(row.columns) for row in rows] == [3] * 14


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 8, 36])
def test_backward_grouping_is_within_the_card_tolerance(c, dtype, relu):
    fm, rois, norm = edge_roi_inputs(c + 1, 2, 6, 8, c, 7)
    if relu:
        fm = torch.relu(fm)
    fm = fm.to(dtype)
    g = torch.from_numpy(np.random.default_rng(c).normal(size=(2, 7, 7, 7, c)).astype(np.float32)).to(dtype)
    got = replay_backward(fm, rois, norm, g, vec_of(c, dtype, 8))
    ok, err = backward_close(got, torch_roi.roi_pool_taps_bwd_plain(fm, rois, norm, g))
    assert ok, err


def test_backward_grouping_matches_the_pallas_backward():
    """f32, a normal map (no exact ties), random RoIs partly past the map:
    within 1e-5, as the plain version is held to the Pallas kernel."""
    fm, rois, norm = map(torch.from_numpy, roi_inputs(11, 2, 8, 10, 128, 6, 120.0, 150.0, 8, 10))
    g = np.random.default_rng(11).normal(size=(2, 6, 7, 7, 128)).astype(np.float32)
    want = roi_pallas.roi_pool_taps_pallas_bwd(fm.numpy(), rois.numpy(), norm.numpy(), g, interpret=True)
    got = replay_backward(fm, rois, norm, torch.from_numpy(g), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def aligned(n, dtype, offset=0):
    """A 1-D tensor of n elements whose data starts `offset` elements past a
    64-byte boundary."""
    item = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(n + 64, dtype=dtype)
    start = (-buf.data_ptr() % 64) // item + offset
    return buf[start:start + n]


@pytest.mark.parametrize(
    "c,dtype,offsets,channels,want",
    [
        (512, torch.float32, (0, 0), None, 4), (1024, torch.bfloat16, (0, 0), None, 8),
        (36, torch.float32, (0, 0), None, 4), (36, torch.bfloat16, (0, 0), None, 1),
        (1030, torch.float32, (0, 0), None, 1), (3, torch.float32, (0, 0), None, 1),
        (512, torch.float32, (1, 0), None, 1), (512, torch.bfloat16, (0, 2), None, 1),
        (512, torch.bfloat16, (8, 8), None, 8),
        # K3's 8-byte lanes: four bf16 or two f32 channels.
        (36, torch.bfloat16, (4, 0), 4, 4), (512, torch.bfloat16, (2, 0), 4, 1),
        (36, torch.float32, (2, 0), 2, 2), (35, torch.float32, (0, 0), 2, 1),
    ],
)
def test_lane_width_needs_whole_lanes_and_aligned_data(c, dtype, offsets, channels, want):
    tensors = [aligned(4 * c, dtype, off) for off in offsets]
    assert torch_roi.lane_width(c, *tensors, channels=channels) == want


@pytest.mark.parametrize(
    "c,vec,chunks", [(512, 4, 4), (512, 8, 2), (512, 2, 8), (1024, 4, 8), (1030, 1, 33), (3, 1, 1), (8, 8, 1)]
)
def test_lane_chunks_cover_every_channel_once(c, vec, chunks):
    assert lane_chunks(c, vec) == chunks
    channels = [ch for lane in threads(c, vec) for ch in lane]
    assert sorted(channels) == list(range(c))
