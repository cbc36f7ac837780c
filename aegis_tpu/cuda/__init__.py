"""CUDA kernels for NVIDIA Hopper, called from JAX through ``jax.ffi``.

The sources in this directory are compiled with ``nvcc`` for ``sm_90a`` into
``<checkout>/.build/cuda/`` (listed in ``.gitignore``) on first use, keyed by
a hash of the sources, then registered as XLA FFI targets for the CUDA
platform.  ``python -m aegis_tpu.cuda`` builds the library ahead of time.

``viterbi_decode_gpu`` is the pYIN Viterbi decode (``viterbi.cu``): one
cluster of 8 thread blocks per sequence, any number of leading batch axes
(``jax.vmap`` maps onto the grid).  Its plain reference is
``core.pyin.viterbi_scan``; the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import List

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "viterbi.cu")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".build",
                         "cuda")
VITERBI_TARGET = "aegis_viterbi"


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> str:
    hasher = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            hasher.update(f.read())
    return os.path.join(BUILD_DIR, f"libaegis_cuda_{hasher.hexdigest()[:16]}.so")


def build_command(out: str) -> List[str]:
    import jax.ffi

    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), *_SRCS, "-o", out]


def build() -> str:
    """Compile the kernels unless the library for these sources exists."""
    so_path = library_path()
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        proc = subprocess.run(build_command(tmp), capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
        os.replace(tmp, so_path)
    return so_path


@functools.lru_cache(maxsize=None)
def register() -> None:
    """Build (if needed), load and register the FFI targets once per process."""
    import jax.ffi

    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(VITERBI_TARGET,
                                jax.ffi.pycapsule(lib.AegisViterbi),
                                platform="CUDA")


def band_table(log_local: np.ndarray, width: int):
    """Compress the in-band part of the (n, n) log transition matrix.

    Row ``r`` holds, for a source bin i with ``table_row(i) == r``, the values
    ``log_local[i, i - width + k]`` for k in [0, 2*width] (0 where the target
    is off the grid).  Sources in ``[width, n - width)`` share one row when
    their band values are bit-identical (they are for the pYIN triangle);
    otherwise every source keeps its own row.  Returns
    ``(table, row_lo, row_hi)`` with ``table_row(i) = i if i < row_lo,
    row_lo if i < row_hi, else i - row_hi + row_lo + 1``.
    """
    n = log_local.shape[0]
    band = 2 * width + 1
    rows = np.zeros((n, band), np.float32)
    for i in range(n):
        lo_j, hi_j = max(0, i - width), min(n, i + width + 1)
        rows[i, lo_j - (i - width): hi_j - (i - width)] = log_local[i, lo_j:hi_j]
    lo, hi = width, n - width
    if lo < hi and (rows[lo:hi] == rows[lo]).all():
        return np.concatenate([rows[:lo + 1], rows[hi:]]), lo, hi
    return rows, n, n


@functools.lru_cache(maxsize=None)
def _decoder(n: int, width: int, switch_prob: float):
    import jax
    import jax.numpy as jnp

    from aegis_tpu.core.pyin import log_transition

    log_local = log_transition(n, width)
    width = min(width, n - 1)  # a band past the grid edge covers every bin
    table, row_lo, row_hi = band_table(log_local, width)
    table = np.ascontiguousarray(table.T)  # the kernel reads [k][row]
    attrs = dict(width=np.int64(width), row_lo=np.int64(row_lo),
                 row_hi=np.int64(row_hi),
                 log_stay=np.float32(np.log1p(-switch_prob)),
                 log_switch=np.float32(np.log(switch_prob)),
                 log_eps=np.float32(np.log(1e-30)))

    @jax.custom_batching.custom_vmap
    def decode(init_v, init_u, lov, lou):
        *lead, tm1, _ = lov.shape
        out = (jax.ShapeDtypeStruct((*lead, tm1 + 1), jnp.int32),
               jax.ShapeDtypeStruct((*lead, tm1, 2, n), jnp.int16))
        states, _ = jax.ffi.ffi_call(VITERBI_TARGET, out)(
            init_v, init_u, lov, lou, jnp.asarray(table), **attrs)
        return states

    @decode.def_vmap
    def _batched(axis_size, in_batched, *args):
        # every input gets the batch axis in front; the table stays shared
        args = [a if b else jnp.broadcast_to(a, (axis_size, *a.shape))
                for a, b in zip(args, in_batched)]
        return decode(*args), True

    return decode


def viterbi_decode_gpu(init_v, init_u, log_obs_v, log_obs_u, width: int,
                       switch_prob: float):
    """Banded Viterbi decode on the GPU, with the contract of
    ``core.pyin.viterbi_scan`` (same inputs from ``core.pyin.viterbi_inputs``,
    same int32 states).  ``width`` is the half-width of the pitch transition
    band.  Inputs may carry leading batch axes; so may ``jax.vmap``."""
    n = log_obs_v.shape[-1]
    if log_obs_v.shape[-2] == 0:  # one frame: nothing to decode
        import jax.numpy as jnp

        both = jnp.concatenate([init_v, init_u], axis=-1)
        return jnp.argmax(both, axis=-1).astype(jnp.int32)[..., None]
    register()
    return _decoder(n, int(width), float(switch_prob))(
        init_v, init_u, log_obs_v, log_obs_u)
