"""PyTorch/CUDA port of `animals3d_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (`networks/`, `geometry/`,
`ops/`, `render/`, `predictors/`, `models/`) and imports nothing of it.
Entry points take an explicit `device` (default ``"cuda"``); the CPU is
used only when a caller asks for it.
"""
