"""The port's conv kernels' wrappers against the JAX package's Pallas convs.

On the CPU `conv3x3` (K5) and `conv3x3_im2col` (K6) run `conv3x3_plain`, the
library conv on f32 copies; here they are held against
`conv_pallas.conv3x3_pallas` and `conv3x3_im2col_pallas` in interpret mode,
on the cases of `tests/test_conv_pallas.py`, with the same inputs (made with
numpy and cast in JAX, the weights carried from HWIO to OIHW by
`utils/weights.from_jax_params`). `tests/test_torch_cuda.py` holds the CUDA
kernels against `conv3x3_plain` on the card.

Tolerances, as the JAX package's own tests use them: bf16 rtol/atol 0.02 (f32
accumulation on both sides in orders of their own, then one rounding to
bf16, so an output may sit a bf16 step apart); f32 1e-5; gradients 1e-4.
The kernels' own arithmetic (their packing, GEMM geometry and, in f32, the
3xTF32 split) is replayed here in PyTorch, since the kernels run only on
the card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fasterrcnn_tpu.ops.pallas import conv_pallas
from fasterrcnn_torch.ops import conv as torch_conv
from fasterrcnn_torch.scripts import profile_conv
from fasterrcnn_torch.utils.weights import from_jax_params


def case(shape_x, cin, cout, seeds, dtype):
    """x, w, b as `tests/test_conv_pallas.py` makes them: N(0, 1) cast to
    dtype, the weights then scaled by 0.05 in dtype."""
    x, w, b = (jnp.asarray(np.random.default_rng(s).normal(0, 1, shape), dtype)
               for s, shape in zip(seeds, (shape_x, (3, 3, cin, cout), (cout,))))
    return x, w * 0.05, b


def to_torch(x, w, b):
    """The JAX arrays as torch tensors of their dtype; w (3,3,C,Cout) HWIO ->
    (Cout,C,3,3) OIHW."""
    dtype = torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
    f32 = lambda a: np.array(a.astype(jnp.float32))  # noqa: E731
    state = from_jax_params({"conv": {"kernel": f32(w), "bias": f32(b)}})
    return (torch.from_numpy(f32(x)).to(dtype), state["conv.weight"].to(dtype), state["conv.bias"].to(dtype))


def assert_close(got, want, tol):
    assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16 else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("tile,cout_split", [(4, 64), (2, 128)])
def test_conv3x3_matches_pallas_kernel(relu, tile, cout_split):
    x, w, b = case((2, 8, 10, 128), 128, 128, (0, 1, 2), jnp.bfloat16)
    want = conv_pallas.conv3x3_pallas(x, w, b, relu, tile, cout_split, True)
    assert_close(torch_conv.conv3x3(*to_torch(x, w, b), relu=relu), want, 0.02)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 128)])
def test_conv3x3_im2col_matches_pallas_kernel(relu, cin, cout):
    x, w, b = case((2, 8, 10, cin), cin, cout, (0, 1, 2), jnp.bfloat16)
    want = conv_pallas.conv3x3_im2col_pallas(x, w, b, relu, 4, True)
    assert_close(torch_conv.conv3x3_im2col(*to_torch(x, w, b), relu=relu), want, 0.02)


@pytest.mark.parametrize("kernel", ["conv3x3", "conv3x3_im2col"])
def test_conv_f32_tight(kernel):
    c = 128 if kernel == "conv3x3" else 64
    x, w, b = case((1, 8, 10, c), c, c, (3, 4, 5), jnp.float32)
    if kernel == "conv3x3":
        want = conv_pallas.conv3x3_pallas(x, w, b, True, 4, 128, True)
    else:
        want = conv_pallas.conv3x3_im2col_pallas(x, w, b, True, 2, True)
    assert_close(getattr(torch_conv, kernel)(*to_torch(x, w, b)), want, 1e-5)


@pytest.mark.parametrize("kernel", ["conv3x3", "conv3x3_im2col"])
def test_conv_gradients_match_jax_grad(kernel):
    """d/d(x, w, b) of sum(conv(x, w, b)**2): autograd of the port's wrapper
    against jax.grad of the Pallas kernel's custom VJP."""
    c = 128 if kernel == "conv3x3" else 64
    x, w, _ = case((1, 4, 6, c), c, c, (6, 7, 8), jnp.float32)
    b = jnp.asarray(np.random.default_rng(9).normal(0, 0.1, (c,)), jnp.float32)
    if kernel == "conv3x3":
        fn = lambda x, w, b: conv_pallas.conv3x3_pallas(x, w, b, True, 2, 128, True)  # noqa: E731
    else:
        fn = lambda x, w, b: conv_pallas.conv3x3_im2col_pallas(x, w, b, True, 2, True)  # noqa: E731
    gx, gw, gb = jax.grad(lambda x, w, b: jnp.sum(fn(x, w, b) ** 2), argnums=(0, 1, 2))(x, w, b)
    tx, tw, tb = (t.requires_grad_() for t in to_torch(x, w, b))
    out = getattr(torch_conv, kernel)(tx, tw, tb)
    assert out.grad_fn is not None
    (out**2).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(tw.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gw), **tol)  # OIHW -> HWIO
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **tol)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    x, w, b = to_torch(*case((1, 5, 7, 16), 16, 32, (10, 11, 12), jnp.float32))
    before = torch_conv.conv3x3.launches, torch_conv.conv3x3_im2col.launches
    want = torch_conv.conv3x3_plain(x, w, b, relu=False)
    assert torch.equal(torch_conv.conv3x3(x, w, b, relu=False), want)
    assert torch.equal(torch_conv.conv3x3_im2col(x, w, b, relu=False), want)
    assert (torch_conv.conv3x3.launches, torch_conv.conv3x3_im2col.launches) == before


def test_conv_wrappers_reject_bad_input():
    x, w, b = to_torch(*case((1, 5, 7, 16), 16, 32, (10, 11, 12), jnp.float32))
    with pytest.raises(ValueError):
        torch_conv.conv3x3(x, w[:, :8], b)
    with pytest.raises(ValueError):
        torch_conv.conv3x3_im2col(x, w, b[:8])
    with pytest.raises(TypeError):
        torch_conv.conv3x3(x.double(), w, b)


def test_profile_conv_runs_on_the_cpu(capsys):
    """The conv A/B entry point at B=1 over one shape: one JSON line per
    implementation, timed on the host, with no device metric."""
    rows = profile_conv.main(["--batch", "1", "--device", "cpu", "--shapes", "block5", "--reps", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert lines == rows
    assert [(r["layer"], r["impl"]) for r in rows] == [("block5", "library"), ("block5", "conv3x3")]
    for r in rows:
        assert r["device"] == "cpu" and r["batch"] == 1 and r["ms"] > 0 and r["mfu"] is None


# The bf16 kernels' host-side geometry. On the card K5 and K6 run bf16 on the
# tensor cores with weights packed by `pack_conv3x3_weights` /
# `pack_conv3x3_im2col_weights`; the kernels themselves run only there
# (`tests/test_torch_cuda.py`). Here the packing is held to the OIHW weights
# bit for bit, and an f32 replay of each kernel's GEMM (the rows it computes,
# the window offsets of its taps, its stage order, its channel padding) is
# held to `conv3x3_plain`: the sums differ from cuDNN's only in order, so
# within 1e-5 of the largest value.

PACKINGS = {
    "conv3x3": (torch_conv.pack_conv3x3_weights, torch_conv.K5_CHUNK),
    "conv3x3_im2col": (torch_conv.pack_conv3x3_im2col_weights, torch_conv.K6_CHUNK),
}


def unpack(kernel, packed):
    """Packed B operand -> (Cout_p, C_p, 3, 3), the inverse of the packing."""
    n_tiles, chunk_dims = packed.shape[0], packed.shape[1:-2]
    if kernel == "conv3x3":  # tile, ky, chunk, kx, group, co, e
        t = packed.permute(0, 5, 2, 4, 6, 1, 3)
    else:  # tile, tap = kx*3 + ky, chunk, group, co, e
        t = packed.reshape(n_tiles, 3, 3, *chunk_dims[1:], *packed.shape[-2:]).permute(0, 5, 3, 4, 6, 2, 1)
    n, co, chunks, groups, e = t.shape[:5]
    return t.reshape(n * co, chunks * groups * e, 3, 3)


@pytest.mark.parametrize("kernel", sorted(PACKINGS))
@pytest.mark.parametrize("c,cout", [(3, 64), (24, 70), (64, 128), (512, 512)])
def test_bf16_weight_packing_round_trips(kernel, c, cout):
    pack, chunk = PACKINGS[kernel]
    w = torch.from_numpy(np.random.default_rng(c + cout).normal(size=(cout, c, 3, 3)).astype(np.float32))
    packed = pack(w)
    cp, np_ = -(-c // chunk) * chunk, -(-cout // torch_conv.TILE_N) * torch_conv.TILE_N
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == np_ * cp * 9
    back = unpack(kernel, packed)
    assert back.shape == (np_, cp, 3, 3)
    assert torch.equal(back[:cout, :c], w.to(torch.bfloat16))
    assert not back[cout:].any() and not back[:, c:].any()


def replay_k5(x, w, b, relu):
    """conv3x3.cu's bf16 GEMM in f32: rows are the positions of the image
    padded to width W + 2 and flattened; stage (ky, chunk of 32 channels)
    reads the padded input at row offset ky*(W+2) + kx for its three kx
    taps; the pad-column rows are dropped at the end."""
    bsz, h, wd, _ = x.shape
    packed = torch_conv.pack_conv3x3_weights(w).float()  # tile, ky, chunk, kx, group, co, e
    n_tiles, _, chunks = packed.shape[:3]
    kc, wp = torch_conv.K5_CHUNK, wd + 2
    x8 = torch_conv.pad_channels8(x.float())
    assert x8.shape[-1] % 8 == 0 and x8.shape[-1] <= chunks * kc
    xp = F.pad(x8, (0, chunks * kc - x8.shape[-1], 1, 1, 1, 1))  # zero ring + channel padding
    flat = F.pad(xp.reshape(bsz, (h + 2) * wp, -1), (0, 0, 0, 2))  # the last row's kx shifts
    acc = torch.zeros(bsz, h * wp, n_tiles * torch_conv.TILE_N)
    for ky in range(3):
        for chunk in range(chunks):
            for kx in range(3):
                off = ky * wp + kx
                a = flat[:, off:off + h * wp, chunk * kc:(chunk + 1) * kc]
                bmat = packed[:, ky, chunk, kx].permute(1, 3, 0, 2).reshape(kc, -1)
                acc += a @ bmat
    out = acc.reshape(bsz, h, wp, -1)[:, :, :wd, : w.shape[0]] + b.float()
    return torch.relu(out) if relu else out


def replay_k6(x, w, b, relu):
    """conv3x3_im2col.cu's bf16 GEMM in f32: rows are the output pixels;
    K-tile (tap = kx*3 + ky, chunk of 64 channels) gathers each pixel's input
    at (y + ky - 1, x + kx - 1), zero outside the image."""
    bsz, h, wd, _ = x.shape
    packed = torch_conv.pack_conv3x3_im2col_weights(w).float()  # tile, tap, chunk, group, co, e
    n_tiles, _, chunks = packed.shape[:3]
    kc = torch_conv.K6_CHUNK
    x8 = torch_conv.pad_channels8(x.float())
    xp = F.pad(x8, (0, chunks * kc - x8.shape[-1], 1, 1, 1, 1))
    acc = torch.zeros(bsz, h * wd, n_tiles * torch_conv.TILE_N)
    for tap in range(9):
        kx, ky = divmod(tap, 3)
        for chunk in range(chunks):
            a = xp[:, ky:ky + h, kx:kx + wd, chunk * kc:(chunk + 1) * kc].reshape(bsz, h * wd, kc)
            acc += a @ packed[:, tap, chunk].permute(1, 3, 0, 2).reshape(kc, -1)
    out = acc.reshape(bsz, h, wd, -1)[..., : w.shape[0]] + b.float()
    return torch.relu(out) if relu else out


@pytest.mark.parametrize("replay", [replay_k5, replay_k6])
@pytest.mark.parametrize("shape", [(2, 9, 20, 24, 70), (1, 6, 7, 64, 128), (1, 5, 4, 3, 130), (1, 4, 6, 40, 8)])
def test_bf16_kernel_geometry_replays_the_conv(replay, shape):
    """Inputs are bf16 values held in f32, so the packing's cast is exact and
    the replay must equal the plain f32 conv up to summation order."""
    b, h, w, c, cout = shape
    rng = np.random.default_rng(sum(shape))
    x, wt, bias = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16().float()
                   for s in ((b, h, w, c), (cout, c, 3, 3), (cout,)))
    for relu in (True, False):
        want = torch_conv.conv3x3_plain(x, wt, bias, relu=relu)
        got = replay(x, wt, bias, relu)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("kernel", ["conv3x3", "conv3x3_im2col"])
def test_bf16_x_with_f32_weights_raises(kernel):
    x, w, b = to_torch(*case((1, 5, 7, 16), 16, 32, (10, 11, 12), jnp.float32))
    fn = getattr(torch_conv, kernel)
    with pytest.raises(TypeError):
        fn(x.bfloat16(), w, b.bfloat16())
    with pytest.raises(TypeError):
        fn(x.bfloat16(), w.bfloat16(), b)


@pytest.mark.parametrize("kernel", ["conv3x3", "conv3x3_im2col"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_three_channel_input_runs_on_the_cpu(kernel, dtype):
    """VGG's conv1_1 (C = 3, which the bf16 kernels pad to 8 channels)."""
    x, w, b = (t.to(dtype) for t in to_torch(*case((1, 6, 9, 3), 3, 64, (13, 14, 15), jnp.float32)))
    got = getattr(torch_conv, kernel)(x, w, b)
    assert got.dtype == dtype and got.shape == (1, 6, 9, 64)
    assert torch.equal(got, torch_conv.conv3x3_plain(x, w, b))


# The f32 kernels' host-side geometry and arithmetic. On the card K5 and K6
# run f32 as 3xTF32 on the tensor cores: x and the weights are each split
# into a TF32 high part and a TF32 low part (`cvt.rna.tf32.f32`, round to
# nearest, ties away from zero, emulated here on int32 views by
# `round_tf32`), and hi.Whi + hi.Wlo + lo.Whi is summed in f32. The weights
# come split and packed by `pack_conv3x3_*weights_f32`, with the channels of
# each 8 in the k order 0, 2, 4, 6 | 1, 3, 5, 7.

PACKINGS_F32 = {
    "conv3x3": (torch_conv.pack_conv3x3_weights_f32, torch_conv.K5_CHUNK_F32),
    "conv3x3_im2col": (torch_conv.pack_conv3x3_im2col_weights_f32, torch_conv.K6_CHUNK_F32),
}


def tf32_parts(kernel, packed, part):
    """One part (0 hi, 1 lo) of a packed f32 B operand -> (Cout_p, C_p, 3, 3):
    K-group 2 kk + h, element e of a chunk holds its channel 8 kk + 2 e + h."""
    n_tiles, _, chunks = packed.shape[:3]
    p = packed.select(3, part)
    if kernel == "conv3x3":  # tile, ky, chunk, kx, group, co, e
        t = p.reshape(n_tiles, 3, chunks, 3, -1, 2, *p.shape[-2:]).permute(0, 6, 2, 4, 7, 5, 1, 3)
    else:  # tile, tap = kx*3 + ky, chunk, group, co, e
        t = p.reshape(n_tiles, 3, 3, chunks, -1, 2, *p.shape[-2:]).permute(0, 6, 3, 4, 7, 5, 2, 1)
    n, co, chunks, steps, e, h = t.shape[:6]
    return t.reshape(n * co, chunks * steps * e * h, 3, 3)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """`round_tf32` keeps 10 mantissa bits as cvt.rna.tf32.f32 does: a tie
    (half a TF32 step) rounds away from zero in both signs, anything below
    it down, the 13 low bits of the result are 0, and powers of two, zero and
    infinities pass through."""
    step = 2.0 ** -10  # TF32 spacing in [1, 2)
    v = torch.tensor([1 + step / 2, -(1 + step / 2), 1 + step / 2 - 2.0 ** -23, 1 + 1.5 * step,
                      3 * step / 4, 2.0 ** -130, 0.0, -0.0, 1024.0, float("inf"), -float("inf")])
    want = torch.tensor([1 + step, -(1 + step), 1.0, 1 + 2 * step, 3 * step / 4, 2.0 ** -130, 0.0, -0.0,
                         1024.0, float("inf"), -float("inf")])
    got = torch_conv.round_tf32(v)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = torch_conv.split_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("kernel", sorted(PACKINGS_F32))
@pytest.mark.parametrize("c,cout", [(3, 64), (24, 70), (64, 128), (512, 512)])
def test_f32_weight_packing_round_trips(kernel, c, cout):
    """Both parts are TF32 values (13 low mantissa bits 0) in the B layout,
    zero in the padding, and hi + lo rebuilds w within 2^-21 relative."""
    pack, chunk = PACKINGS_F32[kernel]
    w = torch.from_numpy(np.random.default_rng(c + cout).normal(size=(cout, c, 3, 3)).astype(np.float32))
    packed = pack(w)
    cp, np_ = -(-c // chunk) * chunk, -(-cout // torch_conv.TILE_N) * torch_conv.TILE_N
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.numel() == 2 * np_ * cp * 9 and packed.shape[3] == 2
    assert not (packed.view(torch.int32) & 0x1FFF).any()
    hi, lo = (tf32_parts(kernel, packed, part) for part in (0, 1))
    assert hi.shape == lo.shape == (np_, cp, 3, 3)
    assert torch.equal(hi[:cout, :c], torch_conv.round_tf32(w))
    rebuilt = hi[:cout, :c].double() + lo[:cout, :c].double()
    assert float(((rebuilt - w.double()).abs() / w.double().abs()).max()) <= 2.0 ** -21
    for part in (hi, lo):
        assert not part[cout:].any() and not part[:, c:].any()


def tf32_products(a, w_hi, w_lo, passes):
    """a (..., K) @ the split weights (K, N) as the kernels sum it: a split
    into hi and lo, then hi.Whi (+ hi.Wlo + lo.Whi with three passes), in f32.
    One pass is plain TF32, the precision the design leaves behind."""
    a_hi, a_lo = torch_conv.split_tf32(a)
    out = a_hi @ w_hi
    return out + a_hi @ w_lo + a_lo @ w_hi if passes == 3 else out


def replay_k5_f32(x, w, b, relu, passes=3):
    """conv3x3.cu's f32 kernel: replay_k5's GEMM geometry (stages of one ky
    and 16 channels, the three kx taps at row offsets of one window), on
    the packed TF32 hi and lo weights and the split f32 window."""
    bsz, h, wd, _ = x.shape
    packed = torch_conv.pack_conv3x3_weights_f32(w)  # tile, ky, chunk, part, kx, group, co, e
    n_tiles, _, chunks = packed.shape[:3]
    kc, wp = torch_conv.K5_CHUNK_F32, wd + 2
    x8 = torch_conv.pad_channels8(x.float())
    assert x8.shape[-1] % 8 == 0 and x8.shape[-1] <= chunks * kc
    xp = F.pad(x8, (0, chunks * kc - x8.shape[-1], 1, 1, 1, 1))
    flat = F.pad(xp.reshape(bsz, (h + 2) * wp, -1), (0, 0, 0, 2))
    hi, lo = (tf32_parts("conv3x3", packed, part) for part in (0, 1))
    acc = torch.zeros(bsz, h * wp, n_tiles * torch_conv.TILE_N)
    for ky in range(3):
        for chunk in range(chunks):
            cs = slice(chunk * kc, (chunk + 1) * kc)
            for kx in range(3):
                off = ky * wp + kx
                acc += tf32_products(flat[:, off:off + h * wp, cs], hi[:, cs, ky, kx].T, lo[:, cs, ky, kx].T, passes)
    out = acc.reshape(bsz, h, wp, -1)[:, :, :wd, : w.shape[0]] + b.float()
    return torch.relu(out) if relu else out


def replay_k6_f32(x, w, b, relu, passes=3):
    """conv3x3_im2col.cu's f32 kernel: replay_k6's patch matrix in K-tiles
    of one tap and 16 channels, on the split operands."""
    bsz, h, wd, _ = x.shape
    packed = torch_conv.pack_conv3x3_im2col_weights_f32(w)  # tile, tap, chunk, part, group, co, e
    n_tiles, _, chunks = packed.shape[:3]
    kc = torch_conv.K6_CHUNK_F32
    x8 = torch_conv.pad_channels8(x.float())
    xp = F.pad(x8, (0, chunks * kc - x8.shape[-1], 1, 1, 1, 1))
    hi, lo = (tf32_parts("conv3x3_im2col", packed, part) for part in (0, 1))
    acc = torch.zeros(bsz, h * wd, n_tiles * torch_conv.TILE_N)
    for tap in range(9):
        kx, ky = divmod(tap, 3)
        for chunk in range(chunks):
            cs = slice(chunk * kc, (chunk + 1) * kc)
            a = xp[:, ky:ky + h, kx:kx + wd, cs].reshape(bsz, h * wd, kc)
            acc += tf32_products(a, hi[:, cs, ky, kx].T, lo[:, cs, ky, kx].T, passes)
    out = acc.reshape(bsz, h, wd, -1)[..., : w.shape[0]] + b.float()
    return torch.relu(out) if relu else out


REPLAYS_F32 = {"conv3x3": replay_k5_f32, "conv3x3_im2col": replay_k6_f32}


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("kernel", sorted(REPLAYS_F32))
def test_f32_replays_match_pallas_kernel(kernel, relu):
    """The 3xTF32 replays against the Pallas convs in interpret mode, on
    `test_conv_f32_tight`'s inputs, at its 1e-5."""
    c = 128 if kernel == "conv3x3" else 64
    x, w, b = case((1, 8, 10, c), c, c, (3, 4, 5), jnp.float32)
    if kernel == "conv3x3":
        want = conv_pallas.conv3x3_pallas(x, w, b, relu, 4, 128, True)
    else:
        want = conv_pallas.conv3x3_im2col_pallas(x, w, b, relu, 2, True)
    assert_close(REPLAYS_F32[kernel](*to_torch(x, w, b), relu), want, 1e-5)


@pytest.mark.parametrize("kernel", sorted(REPLAYS_F32))
@pytest.mark.parametrize("shape", [(2, 9, 20, 24, 70), (1, 6, 7, 64, 128), (1, 5, 4, 3, 130), (1, 4, 6, 40, 8)])
def test_f32_kernel_geometry_replays_the_conv(kernel, shape):
    """Ragged channels (3, 24, 40: padded to 8, then to 16-channel chunks),
    part tiles of output channels, both ReLU settings: within `conv_close`
    of `conv3x3_plain`."""
    b, h, w, c, cout = shape
    rng = np.random.default_rng(sum(shape))
    x, wt, bias = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((b, h, w, c), (cout, c, 3, 3), (cout,)))
    for relu in (True, False):
        want = torch_conv.conv3x3_plain(x, wt, bias, relu=relu)
        got = REPLAYS_F32[kernel](x, wt, bias, relu)
        assert got.shape == want.shape
        ok, err, peak, _ = profile_conv.conv_close(got, want)
        assert ok, f"max abs err {err} of {peak}"


@pytest.mark.parametrize("kernel", sorted(REPLAYS_F32))
def test_three_tf32_passes_keep_f32_parity(kernel):
    """`conv_close`'s f32 bound tells the designs apart at C=512 (x ~ N(0,1),
    w ~ 0.02 N(0,1)): one TF32 pass misses `conv3x3_plain` by ~3e-4 of the
    largest output and fails it; three pass it. Against the conv in f64 the
    three passes stay within 2e-6 of the largest output (~6e-7 here), as
    close as f32 summation gets, and one pass does not."""
    rng = np.random.default_rng(512)
    x = torch.from_numpy(rng.normal(size=(1, 6, 8, 512)).astype(np.float32))
    wt = torch.from_numpy((0.02 * rng.normal(size=(128, 512, 3, 3))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.normal(size=(128,))).astype(np.float32))
    want = torch_conv.conv3x3_plain(x, wt, bias, relu=False)
    exact = F.conv2d(x.double().permute(0, 3, 1, 2), wt.double(), bias.double(), padding=1).permute(0, 2, 3, 1)
    peak = float(exact.abs().max())
    one, three = (REPLAYS_F32[kernel](x, wt, bias, False, passes=p) for p in (1, 3))
    assert not profile_conv.conv_close(one, want)[0]
    assert profile_conv.conv_close(three, want)[0]
    assert float((one.double() - exact).abs().max()) > 1e-4 * peak
    assert float((three.double() - exact).abs().max()) < 2e-6 * peak
