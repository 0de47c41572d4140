"""The port's native JPEG reader (`fasterrcnn_torch/data/native_loader.py`,
its own build of `fasterrcnn_torch/data/csrc/loader.cc`) against the JAX
package's (`fasterrcnn_tpu/data/native_loader.py` over `native/loader.cc`),
and where the port's reader uses it.

Tolerance: none. The two sources are the same bytes, so every decoded
pixel, extent and error must be the same.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fasterrcnn_tpu.data import native_loader as jax_native_loader
from fasterrcnn_tpu.data import voc as jax_voc
from fasterrcnn_torch.data import image as image_lib
from fasterrcnn_torch.data import native_loader, synthetic_voc, voc
from fasterrcnn_torch.data.pipeline import batched

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def readers():
    if not jax_native_loader.available():
        pytest.skip("the JAX package's native loader does not build here (g++ or libjpeg missing)")
    assert native_loader.available()
    return native_loader, jax_native_loader


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Paths of JPEGs of several extents and aspects, seeded noise over a
    gradient (so the resize has structure to interpolate)."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(75, 100), (100, 75), (64, 64), (90, 200)]):
        grad = np.linspace(0, 200, w)[None, :, None] + np.linspace(0, 50, h)[:, None, None]
        img = np.clip(grad + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        path = root / f"img{i}.jpg"
        Image.fromarray(img).save(path, quality=90)
        paths.append(str(path))
    return paths


def test_the_source_is_the_repositorys_loader_byte_for_byte():
    assert filecmp.cmp(native_loader.SOURCE, REPO / "native" / "loader.cc", shallow=False)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("max_side", [0, 180])
def test_decode_resize_equals_jax(readers, jpegs, flip, max_side):
    """Upscaled to min side 120 (capped at max_side), flipped or not."""
    mine, theirs = readers
    for path in jpegs:
        data = Path(path).read_bytes()
        a, b = np.zeros((300, 300, 3), np.uint8), np.zeros((300, 300, 3), np.uint8)
        got = mine.decode_resize_into(data, a, 120, flip, max_side=max_side)
        want = theirs.decode_resize_into(data, b, 120, flip, max_side=max_side)
        assert got == want and min(got[:2]) > 0
        np.testing.assert_array_equal(a, b)


def test_batch_decode_equals_jax(readers, jpegs):
    mine, theirs = readers
    data = [Path(p).read_bytes() for p in jpegs]
    flips = [False, True, True, False]
    got = mine.decode_batch(data, (240, 480), min_side=120, flips=flips, num_threads=3)
    want = theirs.decode_batch(data, (240, 480), min_side=120, flips=flips, num_threads=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # Rows chosen by dest_indices; the other rows are left alone.
    a = np.full((6, 240, 480, 3), 7, np.uint8)
    b = a.copy()
    mine.decode_batch_into(data[:2], a, dest_indices=[4, 1], min_side=120)
    theirs.decode_batch_into(data[:2], b, dest_indices=[4, 1], min_side=120)
    np.testing.assert_array_equal(a, b)
    assert (a[0] == 7).all()


def test_a_corrupt_jpeg_raises_as_jax(readers, jpegs):
    mine, theirs = readers
    bad = Path(jpegs[0]).read_bytes()[:200]
    for reader in (mine, theirs):
        with pytest.raises(ValueError, match="native decode failed"):
            reader.decode_resize_into(bad, np.zeros((300, 300, 3), np.uint8), 120)
        with pytest.raises(ValueError, match="native decode failed for image 1"):
            reader.decode_batch([Path(jpegs[1]).read_bytes(), bad], (240, 480), min_side=120)


def test_load_image_uses_the_native_reader_for_local_jpegs(readers, jpegs):
    from fasterrcnn_tpu.data import image as jax_image

    for flip in (False, True):
        got, _, scale, shape = image_lib.load_image(jpegs[3], 120, flip, 180)
        want, _, jscale, jshape = jax_image.load_image(jpegs[3], 120, flip, max_dimension_pixels=180)
        np.testing.assert_array_equal(got, want)
        assert (scale, shape) == (jscale, jshape)
    pil, _, _, _ = image_lib.load_image(jpegs[3], 120, False, 180, use_native=False)
    assert pil.shape == got.shape and not np.array_equal(pil, got)  # PIL's resize is not the reader's


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_native") / "VOC2007"
    return str(synthetic_voc.generate_voc_dataset(str(root), {"trainval": 6}, seed=5))


def test_dataset_batch_decode_none_picks_the_native_reader_as_jax(readers, tree, monkeypatch):
    """batch_decode=None: deferred samples where the reader builds, eager
    decodes where it does not, in both packages; the batches are the same
    bytes as JAX's."""
    sizes = dict(min_dimension_pixels=120, max_dimension_pixels=160)
    mine = voc.Dataset("trainval", dir=tree, seed=3, **sizes)
    theirs = jax_voc.Dataset("trainval", dir=tree, seed=3, **sizes)
    assert mine._batch_decode is True and theirs._batch_decode is True
    got = list(batched(iter(mine), 3, 8))
    from fasterrcnn_tpu.data.pipeline import batched as jax_batched

    want = list(jax_batched(iter(theirs), 3, 8))
    assert [g.canvas_hw for g in got] == [w.canvas_hw for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.image_hw, w.image_hw)
        np.testing.assert_array_equal(g.gt_boxes, w.gt_boxes)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(jax_native_loader, "available", lambda: False)
    assert voc.Dataset("trainval", dir=tree, **sizes)._batch_decode is False
    assert jax_voc.Dataset("trainval", dir=tree, **sizes)._batch_decode is False


def test_a_missing_compiler_leaves_the_reader_unavailable(monkeypatch, tmp_path):
    """available() is False, and nothing raises, where the build fails."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_failed", False)
    monkeypatch.setattr(native_loader, "PACKAGE_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader.subprocess, "run", lambda *a, **k: (_ for _ in ()).throw(FileNotFoundError("g++")))
    assert native_loader.available() is False
    assert not list(tmp_path.iterdir())
