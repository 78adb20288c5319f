"""Benchmark of morfem_tpu_torch (the PyTorch/CUDA port); see README.md."""
