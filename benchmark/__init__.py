"""The benchmark of gof_tpu_torch on NVIDIA GPUs (README.md)."""
