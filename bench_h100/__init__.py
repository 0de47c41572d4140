"""Benchmark of the PyTorch and CUDA port of Faster R-CNN (`fasterrcnn_torch`) on an NVIDIA H100."""
