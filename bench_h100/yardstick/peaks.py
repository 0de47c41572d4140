"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its full
700 W power limit (NVIDIA's data sheet)."""

BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80e9
