"""Hand-written CUDA kernels (sources in `csrc/`) and their nvcc build.

Each kernel's wrapper lives beside its plain PyTorch version:
`ops/nms.nms_keep_mask` (K1); `ops/roi.roi_pool_taps` (K2) with its backward
`ops/roi.roi_pool_taps_bwd` (K3), and `ops/roi.roi_pool_fused` (K4);
`ops/conv.conv3x3` (K5) and `ops/conv.conv3x3_im2col` (K6).
"""
