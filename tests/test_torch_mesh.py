"""Data- and tensor-parallel training of the port (`parallel/mesh.py`,
`parallel/tp.py`, `models/faster_rcnn.DataParallelStep`, `Engine(mesh=...)`)
against JAX's dp and tp meshes and against the port on one device, on the
CPU.

One 2-rank gloo group (`mesh.spawn`, CPU ranks) runs every training run of
this file (`tests/torch_mesh_ranks.train_runs`): RUNS on dp=2 x tp=1, then
TP_RUNS on the same ranks re-grouped as dp=1 x tp=2. Meanwhile this
process runs JAX's `Engine` on `make_mesh(2, tp=1)` and `make_mesh(2,
tp=2)` of the 8 virtual CPU devices and the port's one-device runs; the
tests read the results. The model is `tests/test_torch_predict.py`'s tiny
config (full-width VGG-16, 128x160 canvas), or the tiny ResNet-50 in
from-scratch mode, B=4; every run starts from the port's seed-0 parameters
of its config, and JAX's engine is given the same. 7 images make a full
batch and a residue of 3 real images, of which rank 0 holds 2 and rank 1
one beside a padding row under dp (under tp both ranks hold all 4 rows).

Tolerances:
  * against JAX (the run fed JAX's draws): losses 1e-4 relative
    and each parameter tensor's update within 2e-3 in relative norm, as
    `tests/test_torch_train.py` holds one device's steps to JAX's;
  * against the port on one device: losses 1e-5 absolute, parameters
    rtol 1e-4, atol 1e-6, as JAX's `tests/test_mesh.py` holds its dp mesh
    to one device (the order of the gradient sum is the only difference);
    Adam's updates as stated there; the tp ResNet-50 run losses 1e-4 and
    parameters rtol 1e-4, atol 1e-5, as that file holds JAX's ResNet tp
    step;
  * across ranks: parameters identical bit for bit (under tp, the
    replicated ones, and the gathered full state).
"""

import threading
from typing import Tuple

import jax
import numpy as np
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu import engine as jax_engine
from fasterrcnn_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from fasterrcnn_tpu.models import faster_rcnn as jax_frcnn
from fasterrcnn_tpu.parallel import mesh as jax_mesh
from fasterrcnn_tpu.utils.stats import TrainingStatistics
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch.data import pipeline
from fasterrcnn_torch.data.synthetic import SyntheticDataset
from fasterrcnn_torch.engine import Engine, rank_seed
from fasterrcnn_torch.models import faster_rcnn as torch_frcnn
from fasterrcnn_torch.parallel import mesh as mesh_lib
from fasterrcnn_torch.utils.weights import from_jax_params, to_jax_params
from tests import torch_mesh_ranks
from tests.test_torch_predict import CANVAS_H, CANVAS_W, tiny_config
from tests.test_torch_train import jax_draws

B = 4
RUNS = torch_mesh_ranks.RUNS
TP_RUNS = torch_mesh_ranks.TP_RUNS
JAX_N = RUNS["jax"][0]
# The tp runs JAX's engine runs too (the dropout run is the port's alone).
JAX_TP_RUNS = [name for name, run in TP_RUNS.items() if run[5]]


class RecordingStats(TrainingStatistics):
    def __init__(self):
        super().__init__()
        self.rows = []

    def on_training_step_values(self, row):
        self.rows.append(np.asarray(row, np.float64).copy())
        return super().on_training_step_values(row)


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| of f32 tensors, the norms in f64."""
    return float(torch.linalg.vector_norm(got - want, dtype=torch.float64)
                 / torch.linalg.vector_norm(want, dtype=torch.float64))


def cpu_mesh(n=2):
    return mesh_lib.make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = tiny_config(jax_config)
    # JAX's per-step draws: its train_epoch folds the step index into key(seed).
    grid = jax_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    steps = []
    for s in range(-(-JAX_N // B)):
        d = jax_draws(jax.random.fold_in(jax.random.key(0), s), B, grid.total, cfg.rpn.post_nms_train + cfg.max_gt_boxes)
        steps.append(tuple(tuple(u.numpy() for u in pair) for pair in d))

    box = {}

    def ranks():
        try:
            box["ranks"] = mesh_lib.spawn(torch_mesh_ranks.train_runs, cpu_mesh(), args=(steps, str(tmp)),
                                          timeout=600, collective_timeout=300)
        except BaseException as err:  # re-raised below, in the test's thread
            box["error"] = err

    thread = threading.Thread(target=ranks)
    thread.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(torch_mesh_ranks.THREADS)
    try:
        # Every run starts from the port's seed-0 parameters, as the ranks'.
        engine = Engine(tiny_config(torch_config), seed=0, device="cpu")
        start = {k: v.clone() for k, v in engine.model.state_dict().items()}
        # JAX's engine takes the same parameters: its own init, which
        # compiles the whole model, would be thrown away.
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jax_engine, "init_params", lambda *args, **kwargs: to_jax_params(start))
            jax_eng = jax_engine.Engine(cfg, jax_config.TrainConfig(batch_size=B), seed=0,
                                        init_canvas=(CANVAS_H, CANVAS_W), mesh=jax_mesh.make_mesh(2, tp=1))
        stats = RecordingStats()
        jax_eng.train_epoch(JaxSyntheticDataset(num_samples=JAX_N, height=120, width=150, seed=3), batch_size=B,
                            stats=stats, progress=False)
        jax_after = from_jax_params(jax_eng.params)
        try:
            jax_eng._check_batch_size(3)
        except ValueError as err:
            jax_batch_error = str(err)

        # The port on one device: each run's K=8 epoch (on the CPU its K=2
        # block is its packed steps bit for bit, `tests/test_torch_epoch.py`).
        one = {}
        for name, (n, _, optimizer) in RUNS.items():
            draws = torch_mesh_ranks.fed_draws(steps) if name == "jax" else torch_frcnn.draw_train_uniforms
            with pytest.MonkeyPatch.context() as patch:
                patch.setattr(torch_frcnn, "draw_train_uniforms", draws)
                rows = torch_mesh_ranks.epoch(engine, start, torch_mesh_ranks.dataset(n), B, 8,
                                              torch_config.TrainConfig(**optimizer))
            one[name] = (rows, {k: v.detach().clone() for k, v in engine.model.named_parameters()})
        one_labels, one_model = engine.labels, engine.model
        del engine, jax_eng
        tp = {name: tp_references(name, steps) for name in TP_RUNS}
    finally:
        torch.set_num_threads(threads)
        thread.join(timeout=900)
    assert not thread.is_alive()
    if "error" in box:
        raise box["error"]
    dp = {}
    for name in [*RUNS, *TP_RUNS]:
        dp[name] = torch.load(tmp / f"{name}.pth", weights_only=True)
        (tmp / f"{name}.pth").unlink()
    return dict(
        ranks=box["ranks"], dp=dp, one=one, start=start, jax_rows=np.stack(stats.rows), jax_after=jax_after,
        jax_batch_error=jax_batch_error, labels=one_labels, model=one_model, tp=tp,
    )


def tp_references(name, steps):
    """TP_RUNS[name] on the port's one device and, where the run is fed
    JAX's draws, on JAX's `Engine` over `make_mesh(2, tp=2)`, from the
    port's seed-0 parameters of its config: the start state, each run's
    loss rows and parameters after, and the parameters' group labels."""
    _, _, _, n, optimizer, fed = TP_RUNS[name]
    engine = Engine(torch_mesh_ranks.tp_config(torch_config, name), seed=0, device="cpu")
    start = {k: v.clone() for k, v in engine.model.state_dict().items()}
    draws = torch_mesh_ranks.fed_draws(steps) if fed else torch_frcnn.draw_train_uniforms
    # The ranks' default generators: rank_seed of dp index 0 (dropout draws).
    torch.manual_seed(rank_seed(0, 0))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch_frcnn, "draw_train_uniforms", draws)
        rows = torch_mesh_ranks.epoch(engine, start, torch_mesh_ranks.dataset(n), B, 8,
                                      torch_config.TrainConfig(**optimizer))
    out = dict(start=start, labels=engine.labels, one=(rows, {k: v.detach().clone()
                                                              for k, v in engine.model.named_parameters()}))
    if fed:
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jax_engine, "init_params", lambda *args, **kwargs: to_jax_params(start))
            jax_eng = jax_engine.Engine(torch_mesh_ranks.tp_config(jax_config, name),
                                        jax_config.TrainConfig(batch_size=B, **optimizer), seed=0,
                                        init_canvas=(CANVAS_H, CANVAS_W), mesh=jax_mesh.make_mesh(2, tp=2))
        stats = RecordingStats()
        jax_eng.train_epoch(JaxSyntheticDataset(num_samples=n, height=120, width=150, seed=3), batch_size=B,
                            stats=stats, progress=False)
        out["jax"] = (np.stack(stats.rows), from_jax_params(jax_eng.params))
    return out


def test_make_mesh_shapes_and_its_too_many_devices_error_follow_jax():
    for n in (2, 8):
        assert cpu_mesh(n).shape == dict(jax_mesh.make_mesh(n, tp=1).shape) == {"dp": n, "tp": 1}
    with pytest.raises(ValueError, match="requested 9 devices but only 8 are available"):
        jax_mesh.make_mesh(9, tp=1)
    with pytest.raises(ValueError, match="requested 9 devices but only 8 are available"):
        mesh_lib.make_mesh(9, devices=["cpu"] * 8)
    assert mesh_lib.make_mesh(2, tp=2, devices=["cpu"] * 2).shape == dict(jax_mesh.make_mesh(2, tp=2).shape) == {
        "dp": 1, "tp": 2}


@pytest.mark.parametrize(
    "devices, backend",
    [(["cpu"] * 2, "gloo"), (["cuda:0", "cuda:0"], "gloo"), (["cuda:0", "cuda:1"], "nccl"), (["cuda", "cuda:1"], "nccl")],
)
def test_the_backend_is_nccl_only_when_every_rank_owns_a_card(devices, backend):
    assert mesh_lib.backend_for(devices) == backend


def test_check_batch_size_raises_as_jax(runs):
    with pytest.raises(ValueError) as err:
        mesh_lib.check_batch_size(cpu_mesh(), 3)
    assert str(err.value) == runs["jax_batch_error"]
    mesh_lib.check_batch_size(cpu_mesh(), 4)
    assert cpu_mesh().rows(4) == slice(0, 2)


def test_batched_stages_each_rank_its_rows_of_the_same_batches():
    data = list(torch_mesh_ranks.dataset(11))
    whole = list(pipeline.batched(iter(data), B, 8))
    shards = [list(pipeline.batched(iter(data), B, 8, shard=(r, 2))) for r in range(2)]
    assert len(whole) == len(shards[0]) == len(shards[1]) == 3
    for hb, parts in zip(whole, zip(*shards)):
        for field in ("images", "image_hw", "gt_boxes", "gt_classes", "gt_mask", "sample_weight"):
            np.testing.assert_array_equal(np.concatenate([getattr(p, field) for p in parts]), getattr(hb, field))
        assert all(p.batch_samples == hb.samples for p in parts)
        assert all(p.denominator == np.float32(hb.sample_weight.sum()) + np.float32(1e-7) for p in parts)
    # The residue: 3 real images, 2 on rank 0 and 1 beside padding on rank 1.
    assert [len(p.samples) for p in (shards[0][-1], shards[1][-1])] == [2, 1]


def test_each_rank_draws_its_rows_of_the_whole_batchs_uniforms():
    cfg = tiny_config(torch_config)
    grid = torch_frcnn.anchor_grid_for(cfg, CANVAS_H, CANVAS_W)
    whole = torch_frcnn.draw_train_uniforms(cfg, grid, B, torch.Generator().manual_seed(5), "cpu")
    for r in range(2):
        part = torch_frcnn.draw_train_uniforms(cfg, grid, B // 2, torch.Generator().manual_seed(5), "cpu", (r, 2))
        for w, p in zip((*whole.rpn, *whole.detector), (*part.rpn, *part.detector)):
            assert torch.equal(p, w[r * 2:(r + 1) * 2])


def test_the_ranks_losses_over_the_whole_batchs_denominator_sum_to_its_loss(runs):
    """The denominator case: a batch of 3 real images and a padding row
    split 2 / 1+pad. Each rank divides by the whole batch's weight sum, so
    the ranks' losses sum to one device's; dividing by a rank's own sum
    would not."""
    data = list(SyntheticDataset(num_samples=3, height=120, width=150, seed=3))
    (hb,) = pipeline.batched(iter(data), B, 8)
    model = runs["model"]  # any weights do
    grid = torch_frcnn.anchor_grid_for(model.cfg, CANVAS_H, CANVAS_W)

    def losses(rows, shard, denominator):
        batch = torch_frcnn.Batch(*(torch.as_tensor(getattr(hb, f)[rows]) for f in torch_frcnn.Batch._fields))
        with torch.no_grad():
            return float(torch_frcnn.compute_losses(model, batch, grid, generator=torch.Generator().manual_seed(1),
                                                    denominator=denominator, shard=shard)[0])

    whole = losses(slice(0, 4), (0, 1), None)
    denominator = torch.tensor(hb.denominator)
    parts = [losses(slice(0, 2), (0, 2), denominator), losses(slice(2, 4), (1, 2), denominator)]
    np.testing.assert_allclose(sum(parts), whole, rtol=1e-6)
    # Each rank's own denominator (2 real images on rank 0, 1 on rank 1).
    own = parts[0] * hb.denominator / 2 + parts[1] * hb.denominator / 1
    assert abs(own - whole) > 0.1 * whole


def test_dp2_losses_match_jax_mesh(runs):
    got = runs["ranks"][0]["jax"]["rows"]
    assert got.shape == runs["jax_rows"].shape == (2, 4)
    np.testing.assert_allclose(got, runs["jax_rows"], rtol=1e-4)


def test_dp2_updates_match_jax_mesh(runs):
    start, after, want = runs["start"], runs["dp"]["jax"], runs["jax_after"]
    for name, label in runs["labels"].items():
        got_update, want_update = after[name] - start[name], want[name] - start[name]
        if label == "frozen":
            assert not got_update.any() and not want_update.any(), name
            continue
        assert rel_norm(got_update, want_update) <= 2e-3, (name, rel_norm(got_update, want_update))


def test_dp2_matches_one_device(runs):
    """A full batch and the uneven residue as one K=2 block fed JAX's draws,
    against one device's two packed steps (on the CPU one device's K=2
    block is its packed steps bit for bit, `tests/test_torch_epoch.py`)."""
    rows, params = runs["one"]["jax"]
    got = runs["ranks"][0]["jax"]["rows"]
    assert got.shape == rows.shape == (2, 4)
    np.testing.assert_allclose(got, rows, rtol=0, atol=1e-5)
    for name, p in params.items():
        torch.testing.assert_close(runs["dp"]["jax"][name], p, rtol=1e-4, atol=1e-6, msg=name)


def test_adam_on_dp2_matches_one_device(runs):
    """Adam as packed steps on the port's own generator (each rank draws
    the whole batch's uniforms and keeps its rows): the losses as above.
    Adam's update does not depend on the gradient's scale, and where a
    gradient is near 0 the order of the gradient sum alone moves it by up
    to the learning rate: each tensor's update is held to 1e-2 in relative
    norm (measured at most 2.1e-3), against the O(1) of a rank stepping on
    its own rows' gradient."""
    rows, params = runs["one"]["adam"]
    np.testing.assert_allclose(runs["ranks"][0]["adam"]["rows"], rows, rtol=0, atol=1e-5)
    for name, label in runs["labels"].items():
        if label != "frozen":
            got, want = runs["dp"]["adam"][name] - runs["start"][name], params[name] - runs["start"][name]
            assert rel_norm(got, want) <= 1e-2, (name, rel_norm(got, want))


def test_the_uneven_residue_gives_one_devices_loss(runs):
    """Run "jax"'s second step: 3 real images, rank 0 holding 2 and rank 1
    one beside a padding row."""
    rows, _ = runs["one"]["jax"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["jax"]["rows"][1], rows[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("run", RUNS)
def test_parameters_are_bit_identical_across_ranks(runs, run):
    rank0, rank1 = runs["ranks"]
    assert rank0[run]["digest"] == rank1[run]["digest"]
    assert rank0[run]["digest"] == torch_mesh_ranks.digest_of(runs["dp"][run])
    np.testing.assert_array_equal(rank0[run]["rows"], rank1[run]["rows"])


def test_dropout_masks_are_each_ranks_own_draws(runs):
    """Under dp the default generators, which dropout draws from, are
    seeded per rank (`engine.rank_seed`): each rank draws its own masks."""
    masks = []
    for r, out in enumerate(runs["ranks"]):
        assert out["initial_seed"] == rank_seed(0, r)
        with torch.random.fork_rng():
            torch.manual_seed(rank_seed(0, r))
            want = torch.nn.functional.dropout(torch.ones(4096), 0.5, training=True).numpy()
        np.testing.assert_array_equal(out["dropout_mask"], want)
        masks.append(want)
    assert (masks[0] != masks[1]).any()


def update_gap(after, want, start, labels) -> Tuple[float, str]:
    """The worst relative norm of a trained tensor's update against the
    wanted one (frozen tensors must not move), and its tensor."""
    worst = (0.0, "")
    for name, label in labels.items():
        got_update, want_update = after[name] - start[name], want[name] - start[name]
        if label == "frozen":
            assert not got_update.any() and not want_update.any(), name
            continue
        worst = max(worst, (rel_norm(got_update, want_update), name))
    return worst


@pytest.mark.parametrize("run", JAX_TP_RUNS)
def test_tp2_losses_match_jax_mesh(runs, run):
    got, want = runs["ranks"][0][run]["rows"], runs["tp"][run]["jax"][0]
    assert got.shape == want.shape == (2, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("run", JAX_TP_RUNS)
def test_tp2_updates_match_jax_mesh(runs, run):
    ref = runs["tp"][run]
    gap, name = update_gap(runs["dp"][run], ref["jax"][1], ref["start"], ref["labels"])
    assert gap <= 2e-3, (name, gap)


@pytest.mark.parametrize("run", TP_RUNS)
def test_tp2_matches_one_device(runs, run):
    """Each tp run against the same run on one device, with JAX's own
    bounds for its tp mesh against one device (`tests/test_mesh.py`): the
    VGG runs (clipping; dropout, whose masks the tp row draws as one device
    does) as its fc-pair oracle, ResNet-50 as its layer4 oracle."""
    rows, params = runs["tp"][run]["one"]
    loss_atol, atol = (1e-4, 1e-5) if run == "tp_resnet50" else (1e-5, 1e-6)
    got = runs["ranks"][0][run]["rows"]
    assert got.shape == rows.shape
    np.testing.assert_allclose(got, rows, rtol=0, atol=loss_atol)
    for name, p in params.items():
        torch.testing.assert_close(runs["dp"][run][name], p, rtol=1e-4, atol=atol, msg=name)


@pytest.mark.parametrize("run", TP_RUNS)
def test_tp2_replicated_parameters_are_bit_identical_and_the_shards_gather_to_one_state(runs, run):
    rank0, rank1 = (r[run] for r in runs["ranks"])
    assert rank0["digests"][0] == rank1["digests"][0]  # the replicated tensors
    assert rank0["digests"][1] != rank1["digests"][1]  # each rank's shards
    assert rank0["full_digest"] == rank1["full_digest"] == torch_mesh_ranks.digest_of(runs["dp"][run])
    assert rank0["shards_match"] and rank1["shards_match"]
    np.testing.assert_array_equal(rank0["rows"], rank1["rows"])
    assert rank0["fc1_rows"] == (0 if run == "tp_resnet50" else 2048)


def test_tp2_ranks_of_a_dp_row_share_their_default_generators(runs):
    for out in runs["ranks"]:
        assert {out[run]["initial_seed"] for run in TP_RUNS} == {rank_seed(0, 0)}


def test_tp2_clipping_counts_the_sharded_gradients_once(runs):
    """The clip run's sharded squares, summed over the tp group, alike on
    both ranks; their norm alone exceeds clipnorm, so the clip acted (and
    the run matches one device above)."""
    squares = [out["tp_vgg_clip"]["tp_squares"] for out in runs["ranks"]]
    np.testing.assert_array_equal(squares[0], squares[1])
    assert np.sqrt(squares[0][0]) > torch_mesh_ranks.CLIPNORM
    assert not any(out[run]["tp_squares"].any() for out in runs["ranks"] for run in ("tp_resnet50", "tp_vgg_dropout"))


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*rank 1 fails on purpose"):
        mesh_lib.spawn(torch_mesh_ranks.fail_on_rank1, cpu_mesh(), timeout=120, collective_timeout=60)


def test_a_hanging_rank_fails_the_run():
    with pytest.raises(TimeoutError, match="did not finish within 5"):
        mesh_lib.spawn(torch_mesh_ranks.hang_on_rank1, cpu_mesh(), timeout=5)
