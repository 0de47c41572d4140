"""Hand-written CUDA kernels (sources in `csrc/`) and their nvcc build.

Each kernel's wrapper lives beside its plain PyTorch version:
`ops/nms.nms_keep_mask`, and `ops/roi.roi_pool_taps` with its backward
`ops/roi.roi_pool_taps_bwd`.
"""
