"""The port's VOC reader (`fasterrcnn_torch/data/voc.py`) and deferred decode
(`data/pipeline.py`) against the JAX package's, on synthetic VOC trees.

Both readers are held to their PIL paths: with the native loader present
each decodes with its own bilinear resize, which is not PIL's. So every test
here patches `fasterrcnn_tpu.data.native_loader.available` and the port's
`fasterrcnn_torch.data.native_loader.available` to return False and builds
the JAX Dataset with batch_decode=False (`tests/test_torch_native_loader.py`
holds the two native readers to each other). Images are sized so that
every one lands in the 128x160 or 160x128 canvas.

Tolerance: none. The order, the flips, the extents, the gt boxes (class and
corners) and the pixels must be identical.
"""

import filecmp
import os

import numpy as np
import pytest

from fasterrcnn_tpu.data import native_loader as jax_native_loader
from fasterrcnn_tpu.data import synthetic_voc as jax_synthetic_voc
from fasterrcnn_tpu.data import voc as jax_voc
from fasterrcnn_torch.config import select_canvas
from fasterrcnn_torch.data import native_loader, synthetic_voc, voc
from fasterrcnn_torch.data.pipeline import batched, make_host_batch

MAX_GT = 8
SIZES = dict(min_dimension_pixels=120, max_dimension_pixels=160)


@pytest.fixture(autouse=True)
def jax_reader_on_pil(monkeypatch):
    monkeypatch.setattr(jax_native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc") / "VOC2007"
    return str(synthetic_voc.generate_voc_dataset(str(root), {"trainval": 7, "test": 3}, seed=11))


@pytest.fixture(scope="module")
def difficult_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_difficult") / "VOC2007"
    return str(synthetic_voc.generate_voc_dataset(
        str(root), {"trainval": 8}, seed=4, max_boxes=6, difficult_fraction=0.3))


def reader_pair(root, split="trainval", **kwargs):
    kwargs = {**SIZES, **kwargs}
    return (
        voc.Dataset(split, dir=root, batch_decode=False, **kwargs),
        jax_voc.Dataset(split, dir=root, batch_decode=False, **kwargs),
    )


def assert_same_sample(got, want):
    assert got.filepath == want.filepath
    assert got.flip == want.flip
    assert tuple(got.image_hw) == tuple(want.image_hw)
    assert [b.class_index for b in got.gt_boxes] == [b.class_index for b in want.gt_boxes]
    assert [b.class_name for b in got.gt_boxes] == [b.class_name for b in want.gt_boxes]
    for g, w in zip(got.gt_boxes, want.gt_boxes):
        assert g.corners.dtype == w.corners.dtype
        np.testing.assert_array_equal(g.corners, w.corners)
    np.testing.assert_array_equal(got.image_u8, want.image_u8)


def test_generate_voc_dataset_writes_the_jax_packages_files(tmp_path):
    mine = synthetic_voc.generate_voc_dataset(
        str(tmp_path / "torch"), {"trainval": 3, "test": 2}, seed=7, difficult_fraction=0.3)
    theirs = jax_synthetic_voc.generate_voc_dataset(
        str(tmp_path / "jax"), {"trainval": 3, "test": 2}, seed=7, difficult_fraction=0.3)
    files = sorted(os.path.relpath(os.path.join(d, f), mine) for d, _, fs in os.walk(mine) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs) for d, _, fs in os.walk(theirs) for f in fs)
    assert len(files) == 5 + 5 + 2 + 2 * 20  # jpgs, xmls, split lists, per-class lists
    _, mismatch, errors = filecmp.cmpfiles(mine, theirs, files, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("cache", [False, True])
def test_dataset_matches_jax_over_two_epochs(tree, cache):
    mine, theirs = reader_pair(tree, augment=True, shuffle=True, seed=3, cache=cache)
    assert mine.num_samples == theirs.num_samples == 7
    flips = []
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert_same_sample(g, w)
            assert select_canvas(*g.image_hw) in ((128, 160), (160, 128))
        flips += [g.flip for g in got]
    assert any(flips) and not all(flips)  # both branches of the flip ran
    assert mine.cache_nbytes() == theirs.cache_nbytes()


def test_eval_reader_matches_jax_in_file_order(tree):
    mine, theirs = reader_pair(tree, split="test", augment=False, shuffle=False, cache=False)
    got, want = list(mine), list(theirs)
    assert [s.filepath for s in got] == sorted(s.filepath for s in got)
    for g, w in zip(got, want):
        assert_same_sample(g, w)
        assert not g.flip


@pytest.mark.parametrize("allow_difficult", [False, True])
def test_allow_difficult_filters_as_jax(difficult_tree, allow_difficult):
    mine, theirs = reader_pair(difficult_tree, augment=False, shuffle=False, allow_difficult=allow_difficult)
    got, want = list(mine), list(theirs)
    for g, w in zip(got, want):
        assert_same_sample(g, w)
    counts = [len(s.gt_boxes) for s in got]
    everything = sum(len(s.gt_boxes) for s in reader_pair(difficult_tree, augment=False, shuffle=False,
                                                          allow_difficult=True)[0])
    if allow_difficult:
        assert sum(counts) == everything
    else:
        assert 0 < sum(counts) < everything  # some difficult objects were dropped
        assert min(counts) >= 1


def test_decoded_size_mismatch_raises_as_jax(tmp_path):
    from PIL import Image

    root = synthetic_voc.generate_voc_dataset(str(tmp_path / "VOC2007"), {"trainval": 2}, seed=1)
    first = os.path.join(root, "JPEGImages", "trainval00000.jpg")
    Image.fromarray(np.zeros((200, 260, 3), np.uint8)).save(first)
    mine, theirs = reader_pair(root, augment=False, shuffle=False)
    with pytest.raises(ValueError, match="does not match the annotation's <size>"):
        next(iter(mine))
    with pytest.raises(ValueError, match="does not match the annotation's <size>"):
        next(iter(theirs))
    deferred = voc.Dataset("trainval", dir=root, augment=False, shuffle=False, batch_decode=True, **SIZES)
    sample = next(iter(deferred))
    with pytest.raises(ValueError, match="<size> element predicted"):
        make_host_batch([sample], select_canvas(*sample.image_hw), MAX_GT)
    with pytest.raises(ValueError, match="<size> element predicted"):
        next(iter(deferred)).materialize()


def test_cache_holds_one_unflipped_variant(tree):
    mine, theirs = reader_pair(tree, augment=True, shuffle=True, seed=5, cache=True)
    for _ in range(2):
        got = list(mine)
        list(theirs)
    assert sorted(mine._cache) == sorted(theirs._cache) == sorted(mine._filepaths)
    eager = {s.filepath: s for s in reader_pair(tree, augment=False, shuffle=False, cache=False)[0]}
    for path, arr in mine._cache.items():
        np.testing.assert_array_equal(arr, theirs._cache[path])
        np.testing.assert_array_equal(arr, eager[path].image_u8)  # unflipped
    for s in got:
        cached = mine._cache[s.filepath]
        assert np.shares_memory(s.image_u8, cached)  # a view, not a copy
        np.testing.assert_array_equal(s.image_u8, cached[:, ::-1] if s.flip else cached)


@pytest.mark.parametrize("cache", [False, True])
def test_deferred_batches_equal_eager_batches(tree, cache):
    deferred = voc.Dataset("trainval", dir=tree, augment=True, shuffle=True, seed=3, cache=cache,
                           batch_decode=True, **SIZES)
    eager = voc.Dataset("trainval", dir=tree, augment=True, shuffle=True, seed=3, cache=False,
                        batch_decode=False, **SIZES)
    for epoch in range(2):
        got = list(batched(iter(deferred), 3, MAX_GT))
        want = list(batched(iter(eager), 3, MAX_GT))
        assert len(got) == len(want)
        if epoch == 0 or not cache:
            assert all(s.image_u8 is not None and s.deferred is None for hb in got for s in hb.samples)
        for g, w in zip(got, want):
            assert g.canvas_hw == w.canvas_hw
            for field in ("images", "image_hw", "gt_boxes", "gt_classes", "gt_mask", "sample_weight"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field), err_msg=field)
            for gs, ws in zip(g.samples, w.samples):
                assert_same_sample(gs, ws)
    if cache:
        assert sorted(deferred._cache) == sorted(deferred._filepaths)


def test_deferred_samples_are_deferred_until_batch_time(tree):
    deferred = voc.Dataset("trainval", dir=tree, augment=False, shuffle=False, batch_decode=True, **SIZES)
    samples = list(deferred)
    assert all(s.image_u8 is None and s.deferred is not None for s in samples)
    eager = list(reader_pair(tree, augment=False, shuffle=False)[1])
    for s, w in zip(samples, eager):
        assert tuple(s.image_hw) == tuple(w.image_hw)  # known from <size> alone


def test_materialize_decodes_a_deferred_sample(tree):
    deferred = voc.Dataset("trainval", dir=tree, augment=True, shuffle=True, seed=3, cache=True,
                           batch_decode=True, **SIZES)
    _, theirs = reader_pair(tree, augment=True, shuffle=True, seed=3)
    for s, w in zip(deferred, theirs):
        assert s.image is None
        assert s.materialize() is s
        assert s.deferred is None
        assert_same_sample(s, w)
        assert s.image.size == (s.image_hw[1], s.image_hw[0])
        assert s.materialize() is s  # no-op the second time
    assert sorted(deferred._cache) == sorted(deferred._filepaths)  # the sink ran


def test_class_contract_and_box_repr(tree):
    mine = voc.Dataset("trainval", dir=tree, batch_decode=False, **SIZES)
    assert mine.class_index_to_name == jax_voc.CLASS_INDEX_TO_NAME
    assert voc.CLASS_NAME_TO_INDEX == jax_voc.CLASS_NAME_TO_INDEX
    assert voc.NUM_CLASSES == jax_voc.NUM_CLASSES == 21
    corners = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    assert repr(voc.Box(7, "car", corners)) == repr(jax_voc.Box(7, "car", corners))
    with pytest.raises(FileNotFoundError):
        voc.Dataset("trainval", dir=os.path.join(tree, "missing"))
