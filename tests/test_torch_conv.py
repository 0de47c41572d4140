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
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
