"""The frozen metric arithmetic, pinned to shapes worked by hand."""

from __future__ import annotations

import json

import pytest
import torch

from bench_h100.tracing import Trace
from bench_h100.yardstick import bounds, flops, kernels, peaks

from conftest import BENCH, REPO

VGG = {"backbone": "vgg16", "num_classes": 21}
R101 = {"backbone": "resnet101", "num_classes": 21}


def conv(h, w, k, cin, cout):
    return 2 * h * w * k * k * cin * cout


def test_vgg16_predict_flops_by_hand():
    c = conv(608, 800, 3, 3, 64) + conv(608, 800, 3, 64, 64)
    c += conv(304, 400, 3, 64, 128) + conv(304, 400, 3, 128, 128)
    c += conv(152, 200, 3, 128, 256) + 2 * conv(152, 200, 3, 256, 256)
    c += conv(76, 100, 3, 256, 512) + 2 * conv(76, 100, 3, 512, 512)
    c += 3 * conv(38, 50, 3, 512, 512)
    rpn = conv(38, 50, 3, 512, 512) + conv(38, 50, 1, 512, 45)
    head = 2 * 300 * (25088 * 4096 + 4096 * 4096) + 2 * 300 * 4096 * (21 + 80)
    assert flops.flops_per_image(VGG, (608, 800), 300, train=False) == c + rpn + head == 378_560_409_600


def test_vgg16_train_flops_by_hand():
    """Forward; weight gradients of blocks 3-5, the RPN and the heads;
    input gradients of the same less block3_conv1 (its input is cut)."""
    frozen = conv(608, 800, 3, 3, 64) + conv(608, 800, 3, 64, 64) + conv(304, 400, 3, 64, 128) + conv(
        304, 400, 3, 128, 128)
    fwd = flops.flops_per_image(VGG, (608, 800), 128, train=False)
    trainable = fwd - frozen
    first = conv(152, 200, 3, 128, 256)
    assert flops.flops_per_image(VGG, (608, 800), 128, train=True) == fwd + trainable + trainable - first


def test_resnet101_flops_by_hand():
    layers = flops.resnet_layers(608, 800, 300)
    # conv1 7x7/2 on the 304x400 map, frozen
    assert layers[0] == (conv(304, 400, 7, 3, 64), False, False)
    # layer1 block0 on the 152x200 map after the pool: 1x1, 3x3, 1x1, projection
    assert [f for f, _, _ in layers[1:5]] == [conv(152, 200, 1, 64, 64), conv(152, 200, 3, 64, 64),
                                              conv(152, 200, 1, 64, 256), conv(152, 200, 1, 64, 256)]
    # layer4 block0 on 300 RoIs: conv1 at 7x7, the strided 3x3 and the rest at 4x4
    head = [f for f, _, _ in layers[-10:]]
    assert conv(7, 7, 1, 1024, 512) * 300 in head and conv(4, 4, 3, 512, 512) * 300 in head
    n_convs = 1 + sum(3 * n + 1 for n in (3, 4, 23)) + 2 + 1 + 3 * 3 + 1
    assert len(layers) == n_convs
    assert flops.flops_per_image(R101, (608, 800), 300, train=False) == 325_509_324_800


def test_roi_bytes_by_hand():
    fm = 32 * 38 * 50 * 512 * 2
    out = 32 * 300 * 49 * 512 * 2
    assert bounds.forward_bytes(32, 38, 50, 512, 300, 2) == fm + 32 * 300 * 16 + 32 * 8 + out
    g = 8 * 128 * 49 * 1024 * 2
    assert bounds.backward_bytes(8, 38, 50, 1024, 128, 2) == 2 * 8 * 38 * 50 * 1024 * 2 + g + 8 * 128 * 16 + 8 * 8
    assert bounds.seconds(peaks.HBM_BYTES_PER_S) == 1.0


def test_peaks():
    assert (peaks.BF16_FLOPS, peaks.F32_FLOPS, peaks.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)


def test_union_and_gaps():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert kernels.union_seconds(spans) == 4.0
    assert kernels.gaps(spans, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]


@pytest.mark.parametrize("name,layer", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv (cuDNN)"),
    ("nms_scan_kernel", "nms_keep_mask"), ("nms_iou_mask_kernel", "nms_keep_mask"),
    ("roi_pool_taps_bwd_kernel<float>", "roi_pool_taps_bwd"), ("roi_pool_taps_kernel<bf16>", "roi_pool_taps"),
    ("Memcpy HtoD (Pageable -> Device)", "host-to-device copy"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel", "optimizer"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", "matmul (cuBLAS, and cuDNN GEMMs)"),
    ("some_new_kernel", "other")])
def test_layer_table(name, layer):
    assert kernels.layer_of(name) == layer


class Ev:
    def __init__(self, name, start_us, dur_us, cuda):
        self._n, self._s, self._d, self._c = name, start_us, dur_us, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int(self._d * 1e3)

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


def fake_trace(train: bool) -> Trace:
    """10 ms of host time; 1 ms of copy, 4 ms of convs overlapping it by
    0.5 ms, 0.5 ms of K2 and, in training, 0.5 ms of K3 on the device."""
    cfg = json.loads((BENCH / "configs" / "vgg16-bf16.json").read_text())
    mix = json.loads((BENCH / "traffic" / ("train-b8.json" if train else "predict-b32.json")).read_text())
    events = [Ev("host_loop", 0, 10_000, False),
              Ev("Memcpy HtoD (Pageable -> Device)", 0, 1_000, True),
              Ev("sm90_xmma_fprop_implicit_gemm", 500, 4_000, True),
              Ev("roi_pool_taps_kernel", 5_000, 500, True)]
    if train:
        events.append(Ev("roi_pool_taps_bwd_kernel", 6_000, 500, True))
    return Trace(events, cfg, mix, images=16, batches=2, steps=2)


def test_trace_busy_is_the_union():
    t = fake_trace(True)
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.0055)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "sm90_xmma_fprop_implicit_gemm"
    assert b["idle_gaps"] == [["host_loop", pytest.approx(0.0045)]]


def read(name: str, trace: Trace):
    from bench_h100 import harness

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return harness.Cell(bench, "vgg16-bf16.predict-b32").metric_reader(name).read(trace)


def test_metric_readers_on_a_known_trace():
    p, t = fake_trace(False), fake_trace(True)
    assert read("predict.h2d_ms_per_batch", p) == pytest.approx(0.5)
    assert read("conv_ms_per_img.predict", p) == pytest.approx(4.0 / 16)
    assert read("device_idle_share.predict", p) == pytest.approx(50.0)
    assert read("nms_ms_per_img.predict", p) is None  # nothing to read: left out
    k2 = bounds.seconds(bounds.forward_bytes(32, 38, 50, 512, 300, 2))
    assert read("roi_roofline.predict", p) == pytest.approx(100 * k2 / 0.0005)
    k23 = bounds.seconds(bounds.forward_bytes(8, 38, 50, 512, 128, 2) + bounds.backward_bytes(8, 38, 50, 512, 128, 2))
    assert read("roi_roofline.train", t) == pytest.approx(100 * k23 / 0.001)
    assert read("mfu.predict", p) == pytest.approx(100 * 378_560_409_600 * 16 / 0.010 / 989e12)
    assert read("optimizer_ms_per_step", t) is None
    t.epochs = [{"wait_s": 1.0, "total_s": 4.0}, {"wait_s": 0.0, "total_s": 6.0}]
    assert read("train_loop.wait_share", t) == pytest.approx(10.0)
