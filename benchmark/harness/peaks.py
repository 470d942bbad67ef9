"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).

Frozen copy of the constants of `chip_smoke.py` (its lines 206-209)."""
F32_PEAK_FLOPS = 67e12        # float32 outside the tensor cores
F64_PEAK_FLOPS = 34e12        # float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
BF16_PEAK_FLOPS = 989e12      # dense bf16 tensor cores
