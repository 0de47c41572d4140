"""Faster R-CNN in PyTorch with hand-written CUDA kernels for Hopper (H100).

A port of the JAX package `fasterrcnn_tpu`, which stays the reference it is
tested against. This package imports torch, numpy and PIL at module level.
Three more packages are imported only inside the functions that need them:
h5py (Keras VGG-16 weights), msgpack (the JAX package's weight files) and
matplotlib (`--plot`). Its entry points (`engine.Engine`, `python -m
fasterrcnn_torch`) run on the CUDA device unless the caller asks for the CPU
(device="cpu", `--device cpu`); the kernels (`ops/kernels/csrc/`) are built
with nvcc at first use.
"""
