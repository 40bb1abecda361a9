"""The benchmark of `ozone_tpu_torch` on one NVIDIA H100 (see README.md)."""
