"""Build the CUDA kernels ahead of first use: ``python -m aegis_tpu.cuda``."""

from aegis_tpu.cuda import build

print(build())
