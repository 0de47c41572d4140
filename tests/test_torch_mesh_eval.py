"""Data- and tensor-parallel predict, evaluate, weights and the CLI of the
port (`Engine(mesh=...)`, `python -m fasterrcnn_torch --num-devices 2
[--tp 2]`) against JAX's dp mesh and against the port on one device, on
the CPU.

One 2-rank gloo group (CPU ranks, `tests/torch_mesh_ranks.eval_runs`)
loads the port's seed-0 weights from a file, predicts a batch of 4, runs
predict_image and evaluates a 6-image VOC split (two canvas buckets, so
residue batches, at batch_size 4), at score threshold 0.05, and saves the
weights, first as dp=2 x tp=1, then re-grouped as dp=1 x tp=2, while
this process runs the same on JAX's `Engine` over `make_mesh(2, tp=1)`
(same weights) and on the port's one-device engine. Both readers are held
to PIL, as in `tests/test_torch_eval.py`.

Tolerances: dp=2 against one device, none (each rank predicts its rows as
one device does: the same images, the same programs); tp=2 against one
device and against JAX, those of `tests/test_torch_predict.py` (scores
1e-5, boxes 1e-3 pixels, the same valid slots: fc2's sum is split across
the ranks) and the mAP equal, as `tests/test_torch_eval.py` holds one
device's; saved weights bit for bit.
"""

import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from fasterrcnn_tpu import config as jax_config
from fasterrcnn_tpu import engine as jax_engine
from fasterrcnn_tpu.data import native_loader as jax_native_loader
from fasterrcnn_tpu.data import voc as jax_voc
from fasterrcnn_tpu.parallel import mesh as jax_mesh
from fasterrcnn_torch import __main__ as cli
from fasterrcnn_torch import config as torch_config
from fasterrcnn_torch.data import native_loader, synthetic_voc, voc
from fasterrcnn_torch.engine import Engine
from fasterrcnn_torch.parallel import mesh as mesh_lib
from fasterrcnn_torch.utils.weights import to_jax_params
from tests import torch_mesh_ranks
from tests.test_torch_predict import CANVAS_H, CANVAS_W, synthetic_images, tiny_config

THRESHOLD = torch_mesh_ranks.THRESHOLD
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split(module, root):
    return module.Dataset("test", dir=root, augment=False, shuffle=False, cache=False, batch_decode=False,
                          min_dimension_pixels=120, max_dimension_pixels=160)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_eval")
    root = synthetic_voc.generate_voc_dataset(str(tmp / "VOC2007"), {"test": 6}, seed=2)
    images, image_hw = synthetic_images(21, b=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(torch_mesh_ranks.THREADS)
    try:
        port = Engine(tiny_config(torch_config), seed=0, device="cpu")
        weights = str(tmp / "weights.pth")
        port.save_weights(weights)
        box = {}

        def ranks():
            try:
                box["ranks"] = mesh_lib.spawn(torch_mesh_ranks.eval_runs, mesh_lib.make_mesh(2, devices=["cpu"] * 2),
                                              args=(weights, images, image_hw, root, str(tmp)),
                                              timeout=600, collective_timeout=300)
            except BaseException as err:  # re-raised below, in the test's thread
                box["error"] = err

        thread = threading.Thread(target=ranks)
        thread.start()
        try:
            state = port.model.state_dict()
            with pytest.MonkeyPatch.context() as patch:
                # JAX's engine takes the port's weights (its own init would
                # compile the whole model, to be thrown away), and both
                # readers decode with PIL.
                patch.setattr(jax_engine, "init_params", lambda *args, **kwargs: to_jax_params(state))
                patch.setattr(jax_native_loader, "available", lambda: False)
                patch.setattr(native_loader, "available", lambda: False)
                jax_eng = jax_engine.Engine(tiny_config(jax_config), seed=0, init_canvas=(CANVAS_H, CANVAS_W),
                                            mesh=jax_mesh.make_mesh(2, tp=1))
                jax_map = jax_eng.evaluate(split(jax_voc, root), batch_size=4, score_threshold=THRESHOLD,
                                           progress=False)
                one_map = port.evaluate(split(voc, root), batch_size=4, score_threshold=THRESHOLD, progress=False)
            jax_det = jax_mesh_predict(jax_eng, images, image_hw)
            one_det = tuple(t.numpy() for t in port.predict(images, image_hw, score_threshold=THRESHOLD))
            sample = voc.Sample(image_u8=images[0, :120, :150], image_hw=(120, 150), gt_boxes=[], filepath="x")
            one_image = port.predict_image(sample, score_threshold=THRESHOLD)
            digest = torch_mesh_ranks.digest(port.model)
        finally:
            thread.join(timeout=900)
        assert not thread.is_alive()
        if "error" in box:
            raise box["error"]
        saved = sorted(f for f in os.listdir(tmp) if "saved_by_rank" in f)
        file_state = torch.load(weights, weights_only=True)
        tp_saved = torch.load(tmp / "tp_saved_by_rank0.pth", weights_only=True)
        tp_saved_equal = tp_saved.keys() == file_state.keys() and all(
            torch.equal(tp_saved[k], file_state[k]) for k in file_state)
        del file_state, tp_saved
        for name in saved:
            os.remove(tmp / name)
        os.remove(weights)
    finally:
        torch.set_num_threads(threads)
    return dict(ranks=box["ranks"], jax_map=jax_map, one_map=one_map, jax_det=jax_det, one_det=one_det,
                one_image=one_image, digest=digest, saved=saved, tp_saved_equal=tp_saved_equal)


def jax_mesh_predict(jax_eng, images, image_hw):
    """JAX's predict with the batch sharded along dp, as its tests do."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax

    predict = jax_eng.predict_fn_for((CANVAS_H, CANVAS_W))
    images_m = jax.device_put(images, NamedSharding(jax_eng.mesh, P("dp", None, None, None)))
    hw_m = jax.device_put(image_hw, NamedSharding(jax_eng.mesh, P("dp", None)))
    return tuple(np.asarray(x) for x in predict(jax_eng.params, images_m, hw_m, score_threshold=THRESHOLD))


def test_load_weights_gives_every_rank_the_files_tensors(evals):
    assert [r["digest"] for r in evals["ranks"]] == [evals["digest"]] * 2


def test_dp2_predict_equals_one_device(evals):
    for rank in evals["ranks"]:
        for got, want in zip(rank["detections"], evals["one_det"]):
            np.testing.assert_array_equal(got, want)


def test_dp2_predict_matches_jax_mesh(evals):
    (boxes, scores, valid), (jboxes, jscores, jvalid) = evals["ranks"][0]["detections"], evals["jax_det"]
    np.testing.assert_array_equal(valid, jvalid)
    live = valid > 0
    assert live.sum() > 0
    np.testing.assert_allclose(scores[live], jscores[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes[live], jboxes[live], rtol=0, atol=1e-3)


def test_predict_image_runs_unsharded_on_a_rank(evals):
    want = evals["one_image"]
    for rank in evals["ranks"]:
        got = rank["predict_image"]
        assert sorted(got) == sorted(want) and sum(len(r) for r in want.values()) > 0
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])


def test_dp2_map_equals_one_devices_and_jax_meshs(evals):
    got = [rank["map"] for rank in evals["ranks"]]
    assert 0.0 < evals["jax_map"] < 100.0
    assert got == [evals["one_map"]] * 2 == [evals["jax_map"]] * 2


def test_save_weights_writes_on_rank_0_only(evals):
    assert evals["saved"] == ["saved_by_rank0.pth", "tp_saved_by_rank0.pth"]


def test_tp2_load_and_save_weights_keep_the_files_tensors_bit_for_bit(evals):
    """Each tp rank holds its shard of the file's tensors (the gathered
    state is the file's), and the file rank 0 writes is the file a tp=1
    engine wrote, bit for bit."""
    tp = [rank["tp"] for rank in evals["ranks"]]
    assert [r["digest"] for r in tp] == [evals["digest"]] * 2
    assert tp[0]["digests"][0] == tp[1]["digests"][0] and tp[0]["digests"][1] != tp[1]["digests"][1]
    assert evals["tp_saved_equal"]


def check_detections(got, want):
    (boxes, scores, valid), (wboxes, wscores, wvalid) = got, want
    np.testing.assert_array_equal(valid, wvalid)
    live = valid > 0
    assert live.sum() > 0
    np.testing.assert_allclose(scores[live], wscores[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes[live], wboxes[live], rtol=0, atol=1e-3)


def test_tp2_predict_matches_one_device_and_jax_mesh(evals):
    for rank in evals["ranks"]:
        check_detections(rank["tp"]["detections"], evals["one_det"])
        check_detections(rank["tp"]["detections"], evals["jax_det"])
    for got, want in zip(*(rank["tp"]["detections"] for rank in evals["ranks"])):
        np.testing.assert_array_equal(got, want)


def test_tp2_predict_image_joins_the_tp_row(evals):
    want = evals["one_image"]
    for rank in evals["ranks"]:
        got = rank["tp"]["predict_image"]
        assert sorted(got) == sorted(want)
        for c in want:
            np.testing.assert_allclose(got[c], want[c], rtol=0, atol=1e-3)


def test_tp2_map_equals_one_devices(evals):
    assert [rank["tp"]["map"] for rank in evals["ranks"]] == [evals["one_map"]] * 2


@pytest.fixture
def in_tmp_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def run_module_cli(cwd, *args) -> str:
    """`python -m fasterrcnn_torch *args` in a child process, as a user runs
    it (the rank entry is then pickled by the path a spawned rank imports),
    with one thread a rank as the fixture's ranks: the suite runs beside
    them, one worker a core. Returns its standard output."""
    env = dict(os.environ, OMP_NUM_THREADS=str(torch_mesh_ranks.THREADS),
               PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    done = subprocess.run([sys.executable, "-m", "fasterrcnn_torch", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return done.stdout


def test_cli_num_devices_2_trains_on_two_cpu_ranks_and_rank_0_alone_writes(in_tmp_path):
    out = run_module_cli(in_tmp_path, "--device", "cpu", "--tiny", "--num-devices", "2", "--train", "--synthetic",
                         "2", "--batch-size", "2", "--epochs", "1", "--eval-batch-size", "2", "--log-csv", "log.csv",
                         "--checkpoint-dir", "ck", "--save-to", "w.pth")
    assert "Device mesh       : dp=2 x tp=1, backend=gloo" in out
    assert out.count("Epoch 1/1") == 1 and out.count("Mean Average Precision = ") == 2
    lines = (in_tmp_path / "log.csv").read_text().strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith("1,")
    assert os.listdir(in_tmp_path / "ck") == ["1"]
    final = torch.load(in_tmp_path / "w.pth", weights_only=True)
    epoch1 = torch.load(in_tmp_path / "ck" / "1" / "params.pth", weights_only=True)
    assert final.keys() == epoch1.keys() and all(torch.equal(final[k], epoch1[k]) for k in final)


def test_cli_num_devices_beyond_the_cards_raises_as_jax():
    with pytest.raises(ValueError, match=r"requested 99 devices but only \d+ are available"):
        cli.main(["--tiny", "--num-devices", "99", "--train", "--synthetic", "4"])


def test_cli_tp_2_still_raises_naming_the_tp_slice(in_tmp_path, capfd, monkeypatch):
    """--num-devices 2 --tp 2, which waited for the tp slice, now runs on
    two CPU ranks: one epoch of training, rank 0 alone writing the full
    tensors; then --predict-to-file from the saved weights on the tp row
    and on one device render the same file."""
    from PIL import Image

    mesh = ["--device", "cpu", "--tiny", "--num-devices", "2", "--tp", "2"]
    out = run_module_cli(in_tmp_path, *mesh, "--train", "--synthetic", "2", "--batch-size", "2", "--epochs", "1",
                         "--eval-batch-size", "2", "--checkpoint-dir", "ck", "--save-to", "w.pth")
    assert "Device mesh       : dp=1 x tp=2, backend=gloo" in out
    assert out.count("Epoch 1/1") == 1 and out.count("Mean Average Precision = ") == 2
    assert out.count("Saved model weights to") == 1
    assert os.listdir(in_tmp_path / "ck") == ["1"]
    final = torch.load(in_tmp_path / "w.pth", weights_only=True)
    epoch1 = torch.load(in_tmp_path / "ck" / "1" / "params.pth", weights_only=True)
    assert final["roi_head.fc1.weight"].shape == (4096, 25088) and final["roi_head.fc2.weight"].shape == (4096, 4096)
    assert final.keys() == epoch1.keys() and all(torch.equal(final[k], epoch1[k]) for k in final)

    monkeypatch.setenv("OMP_NUM_THREADS", str(torch_mesh_ranks.THREADS))
    image = in_tmp_path / "test.jpg"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (120, 150, 3), dtype=np.uint8)).save(image)
    rendered = []
    for flags in (mesh, ["--device", "cpu", "--tiny"]):
        cli.main([*flags, "--load-from", "w.pth", "--predict-to-file", str(image)])
        rendered.append((in_tmp_path / "predictions.png").read_bytes())
        os.remove(in_tmp_path / "predictions.png")
    assert rendered[0] == rendered[1]
    assert capfd.readouterr().out.count("Wrote detection results to 'predictions.png'") == 2


def test_an_engine_on_a_mesh_takes_its_device_from_the_mesh():
    with pytest.raises(ValueError, match="a rank runs on its mesh device"):
        Engine(tiny_config(torch_config), device="cpu", mesh=mesh_lib.make_mesh(2, devices=["cpu"] * 2))
