"""Tensor parallelism of the port (`parallel/mesh.py`, `parallel/tp.py`) in
small pieces: the sharding rules against JAX's, the mesh's grid, its rows
and groups, the shards of a state dict, the tp-aware clipping norm, and the
sharded layers against the unsharded ones. No model-sized run: those are
in `tests/test_torch_mesh.py` and `tests/test_torch_mesh_eval.py`.

One 4-rank gloo group (CPU ranks, dp=2 x tp=2, `tests/torch_mesh_ranks.
tp_layer_checks`) runs the layer checks on small layers: a VGG16Head
holding a small Linear pair and a layer4 of two small Bottlenecks.
Tolerances: forward and gradients of the sharded layers within 1e-5 of the
full ones (the order of one sum differs), the clipping norm within 1e-6
relative, gathered states bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fasterrcnn_tpu.parallel import mesh as jax_mesh
from fasterrcnn_torch.config import ModelConfig
from fasterrcnn_torch.engine import Engine
from fasterrcnn_torch.models.faster_rcnn import FasterRCNN
from fasterrcnn_torch.parallel import mesh as mesh_lib
from fasterrcnn_torch.scripts import prodshape_mesh_parity as parity
from tests import torch_mesh_ranks

BACKBONES = ("vgg16", "vgg16-torch", "resnet50", "resnet101", "resnet152")
# flax axis -> torch dimension of a parameter of each rank (conv kernels
# HWIO <-> OIHW, dense kernels (in, out) <-> (out, in)).
TORCH_DIM = {4: {0: 2, 1: 3, 2: 1, 3: 0}, 2: {0: 1, 1: 0}, 1: {0: 0}}


def cpu_mesh(n, tp):
    return mesh_lib.make_mesh(n, tp=tp, devices=["cpu"] * n)


def jax_name(name: str) -> str:
    *module, leaf = name.split(".")
    return "/".join([*module, "kernel" if leaf == "weight" else leaf])


@pytest.mark.parametrize("backbone", BACKBONES)
def test_param_spec_matches_jax_on_every_parameter(backbone):
    with torch.device("meta"):
        model = FasterRCNN(ModelConfig(backbone=backbone))
    sharded = []
    for name, p in model.named_parameters():
        spec = tuple(jax_mesh.param_spec(jax_name(name)))
        want = TORCH_DIM[p.dim()][spec.index("tp")] if "tp" in spec else None
        assert mesh_lib.param_spec(name) == want, (name, spec)
        if want is not None:
            sharded.append(name)
    blocks = {"resnet50": 3, "resnet101": 3, "resnet152": 3}.get(backbone)
    assert len(sharded) == (3 if blocks is None else 4 * blocks)


def test_warn_if_tp_unused_as_jax():
    mesh2 = cpu_mesh(8, 2)
    assert mesh_lib.warn_if_tp_unused(mesh2, ["roi_head.fc1.weight"])
    assert mesh_lib.warn_if_tp_unused(mesh2, {"roi_head.layer4.block0.conv1.weight": None})
    unmatched = ["feature_extractor.conv.weight"]
    with pytest.warns(UserWarning, match="tensor-parallel(.|\n)*fasterrcnn_torch/parallel/mesh.py"):
        assert not mesh_lib.warn_if_tp_unused(mesh2, unmatched)
    assert mesh_lib.warn_if_tp_unused(cpu_mesh(8, 1), unmatched)


def test_make_mesh_8_tp_2_and_the_indivisible_case_follow_jax():
    assert cpu_mesh(8, 2).shape == dict(jax_mesh.make_mesh(8, tp=2).shape) == {"dp": 4, "tp": 2}
    errors = []
    for make in (lambda: jax_mesh.make_mesh(3, tp=2), lambda: cpu_mesh(3, 2)):
        with pytest.raises(AssertionError) as err:
            make()
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "(3, 2)"


def test_rows_and_batch_shards_follow_the_dp_index():
    """Every rank of a dp row holds that row's rows; on tp=1 a rank's dp
    index is its rank, so a dp=2 x tp=1 mesh keeps its rank-order rows."""
    x = np.arange(8 * 3).reshape(8, 3)
    for n, tp in ((4, 2), (2, 1), (2, 2)):
        for r in range(n):
            mesh = dataclasses.replace(cpu_mesh(n, tp), rank=r)
            d = r // tp
            assert (mesh.dp_index, mesh.tp_index) == (d, r % tp)
            b = 8 // mesh.dp
            assert mesh.rows(8) == slice(d * b, (d + 1) * b)
            np.testing.assert_array_equal(mesh.shard_batch(x), x[d * b:(d + 1) * b])
            np.testing.assert_array_equal(mesh.shard_scan_batch(np.stack([x, x])), np.stack([x, x])[:, d * b:(d + 1) * b])
            engine = Engine.__new__(Engine)
            engine.mesh = mesh
            assert engine._shard == (d, mesh.dp)
    # dp=1: the one row's rows are the batch, nothing to gather.
    ones = torch.ones(3)
    assert mesh_lib.all_gather_rows(cpu_mesh(2, 2), ones) is ones


def test_shard_state_dict_shards_along_the_rules_and_concatenates_back():
    gen = torch.Generator().manual_seed(0)
    full = {
        "roi_head.fc1.weight": torch.randn(8, 6, generator=gen),
        "roi_head.fc1.bias": torch.randn(8, generator=gen),
        "roi_head.fc2.weight": torch.randn(5, 8, generator=gen),
        "roi_head.fc2.bias": torch.randn(5, generator=gen),
        "roi_head.layer4.block1.conv2.weight": torch.randn(4, 6, 3, 3, generator=gen),
        "rpn_head.conv.weight": torch.randn(4, 4, 3, 3, generator=gen),
    }
    shards = [mesh_lib.shard_state_dict(dataclasses.replace(cpu_mesh(2, 2), rank=r), full) for r in range(2)]
    assert shards[0]["roi_head.fc1.weight"].shape == (4, 6) and shards[1]["roi_head.fc2.weight"].shape == (5, 4)
    assert shards[0]["roi_head.layer4.block1.conv2.weight"].shape == (4, 3, 3, 3)
    for name, t in full.items():
        dim = mesh_lib.param_spec(name)
        if dim is None:
            assert all(s[name] is t for s in shards), name
        else:
            assert torch.equal(torch.cat([s[name] for s in shards], dim), t), name
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.shard_state_dict(cpu_mesh(2, 2), {"roi_head.fc1.bias": torch.zeros(3)})


def test_parity_script_parses_its_flags():
    """--device is the one flag (the card by default); the mesh and batch are
    the JAX script's dp=4 x tp=2, B=8 at 608x800."""
    assert vars(parity.build_parser().parse_args([])) == {"device": "cuda"}
    assert parity.build_parser().parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        parity.build_parser().parse_args(["--tp", "4"])
    assert (parity.DP, parity.TP, parity.BATCH, parity.CANVAS) == (4, 2, 8, (608, 800))
    hb = parity.host_batch(2, 100)
    assert hb.images.shape == (2, 608, 800, 3) and hb.gt_mask.sum() == 6


def test_parity_script_compares_losses_and_parameters_as_jax():
    params = {"a": np.ones((2, 2), np.float32), "b": np.zeros(3, np.float32)}
    near = {"a": params["a"] + np.float32(5e-5), "b": params["b"]}
    vec = np.array([0.5, 0.1, 2.0, 0.3], np.float32)
    got = parity.compare(vec + np.float32(1e-6), vec, near, params)
    assert got["ok"] and got["dparams_max"] == pytest.approx(5e-5, rel=1e-2)
    assert got["dloss_max"] == pytest.approx(1e-6, rel=0.1)
    assert not parity.compare(vec + np.float32(2e-4), vec, params, params)["ok"]
    assert not parity.compare(vec, vec, {"a": params["a"] + 1, "b": params["b"]}, params)["ok"]
    assert not parity.compare(vec, vec, {"a": params["a"]}, params)["ok"]
    assert not parity.compare(vec * np.nan, vec * np.nan, params, params)["ok"]


@pytest.fixture(scope="module")
def layers():
    return mesh_lib.spawn(torch_mesh_ranks.tp_layer_checks, cpu_mesh(4, 2), timeout=300, collective_timeout=120)


def test_the_groups_follow_jaxs_reshape_grid(layers):
    grid = np.array([d.id for d in jax_mesh.make_mesh(4, tp=2).devices.flat]).reshape(2, 2)
    assert grid.tolist() == np.arange(4).reshape(2, 2).tolist()
    for r, out in enumerate(layers):
        d, t = r // 2, r % 2
        assert out["world"] == 4 and out["index"] == (d, t)
        assert out["tp_ranks"] == grid[d].tolist() and out["dp_ranks"] == grid[:, t].tolist()
        # all_gather_rows gathers the dp column: each row's value, in dp order.
        assert out["gathered_rows"] == [10.0 * dd + t for dd in range(2)]


def test_average_replicated_gives_every_rank_one_gradient(layers):
    """Replicated gradients parting between the ranks (on a card the tp
    ranks compute them alike only up to nondeterministic reductions) come
    out as one value on every rank: the sum over the dp rows of the tp
    ranks' mean."""
    got = [out["averaged"] for out in layers]
    want = sum(1.0 + r * 2.0 ** -20 for r in range(4)) / 2
    for g in got:
        np.testing.assert_array_equal(g, got[0])
        np.testing.assert_allclose(g, want, rtol=1e-6)


@pytest.mark.parametrize("tag", ["vgg", "resnet"])
def test_sharded_layers_give_the_unsharded_forward_and_gradients(layers, tag):
    for out in layers:
        res = out[tag]
        assert len(res["sharded"]) == (3 if tag == "vgg" else 8) and res["flagged"] == res["sharded"]
        for name, gap in res["gaps"].items():
            assert gap <= 1e-5, (name, gap)


@pytest.mark.parametrize("tag", ["vgg", "resnet"])
def test_gather_state_dict_undoes_the_shards_bit_for_bit(layers, tag):
    assert all(out[tag]["gathered_equal"] for out in layers)


@pytest.mark.parametrize("tag", ["vgg", "resnet"])
def test_the_clipping_norm_of_a_sharded_group_is_the_unsharded_ones(layers, tag):
    for out in layers:
        res = out[tag]
        assert res["norm_full"] > 1e-3  # the clip is active
        assert res["norm_shard"] == pytest.approx(res["norm_full"], rel=1e-6)
        assert res["update_gap"] <= 1e-7
        assert res["moments_sharded"]
