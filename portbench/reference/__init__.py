"""Plain reference of what the benchmark's cells compare: Ozone's RS(k, p)
generator over GF(2^8), its parity products, and CRC32C per slice.

Worked out here from the definitions, in NumPy and plain PyTorch. Nothing
here imports `jax`, `ozone_tpu` or `ozone_tpu_torch`, and nothing takes a
table or matrix the program made.
"""
