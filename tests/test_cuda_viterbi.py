"""The Viterbi decode's two paths: the dense ``lax.scan`` everywhere but the
GPU, and the CUDA kernel (``aegis_tpu.cuda``) on the GPU.

The kernel has no interpret mode, so the CPU tests cover what surrounds it:
the dispatch, the compressed band table it reads, the shapes and batch axes
of the FFI call it lowers to, and its build command.  Its arithmetic is
checked against the scan on the card (``gpu`` marker; ``chip_smoke.py``
phase 2 at full size)."""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aegis_tpu import cuda
from aegis_tpu.config import PyinConfig
from aegis_tpu.core import pyin
from aegis_tpu.tools.viterbi_bench import synthetic_obs

CFG = PyinConfig()
N = CFG.n_pitch_bins
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sr,hop", [(22050, 512), (44100, 512), (22050, 2048)])
def test_dispatch_uses_scan_on_cpu(sr, hop, monkeypatch):
    """On the CPU the decode is the dense scan, for every band width (the
    hop-2048 band is wider than the grid), and the GPU path is never
    traced: no kernel, no interpret mode, no fallback."""
    def no_gpu(*a, **k):
        raise AssertionError("GPU decode traced on the CPU")

    monkeypatch.setattr(cuda, "viterbi_decode_gpu", no_gpu)
    width = CFG.transition_width(sr, hop)
    obs, vp = synthetic_obs(30, N, seed=width)
    got = pyin.decode_states(jnp.asarray(obs), jnp.asarray(vp), width, CFG)
    want = pyin.viterbi_scan(
        *pyin.viterbi_inputs(jnp.asarray(obs), jnp.asarray(vp)),
        jnp.asarray(pyin.log_transition(N, width)), CFG.switch_prob)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    jaxpr = str(jax.make_jaxpr(
        lambda o, v: pyin.decode_states(o, v, width, CFG))(obs, vp))
    assert "scan" in jaxpr and "custom_call" not in jaxpr


@pytest.mark.parametrize("width", [101, 51, 401, 24])
def test_band_table_reproduces_transition(width):
    """Every in-band log transition the kernel reads equals the dense
    matrix's float32 value; interior sources share one row."""
    log_local = pyin.log_transition(N, width)
    wb = min(width, N - 1)
    table, lo, hi = cuda.band_table(log_local, wb)
    i, j = np.nonzero(np.abs(np.subtract.outer(np.arange(N), np.arange(N)))
                      <= wb)
    # the kernel's table_row(): own rows below lo and from hi, one shared row
    rows = np.where(i < lo, i, np.where(i < hi, lo, i - hi + lo + 1))
    np.testing.assert_array_equal(table[rows, j - i + wb], log_local[i, j])
    if 2 * wb < N - 1:
        assert table.shape == (2 * wb + 1, 2 * wb + 1) and (lo, hi) == (wb, N - wb)
    else:
        assert table.shape == (N, 2 * wb + 1) and lo == hi == N


def _custom_calls(fn, *args):
    text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    return [ln for ln in text.splitlines() if "custom_call @aegis_viterbi" in ln]


@pytest.mark.parametrize("batch", [(), (3,), (2, 3)])
def test_gpu_decode_lowers_to_one_call_per_batch(batch, monkeypatch):
    """Unbatched, vmapped and doubly vmapped decodes each lower to ONE FFI
    call whose leading axes are the batch (the kernel's grid), with the
    band table shared, not broadcast."""
    monkeypatch.setattr(cuda, "register", lambda: None)  # lowering only
    T, width = 12, 101
    args = (jnp.zeros(batch + (N,)), jnp.zeros(batch + (N,)),
            jnp.zeros(batch + (T - 1, N)), jnp.zeros(batch + (T - 1,)))

    def decode(iv, iu, lov, lou):
        return cuda.viterbi_decode_gpu(iv, iu, lov, lou, width, CFG.switch_prob)

    fn = decode
    for _ in batch:
        fn = jax.vmap(fn)
    calls = _custom_calls(fn, *args)
    assert len(calls) == 1
    dims = "x".join(str(d) for d in batch)
    lead = f"{dims}x" if dims else ""
    assert f"tensor<{lead}{T - 1}x{N}xf32>" in calls[0]
    assert f"tensor<{lead}{T}xi32>" in calls[0]
    assert f"tensor<{2 * width + 1}x{2 * width + 1}xf32>" in calls[0]
    assert "width = 101" in calls[0]


def test_gpu_decode_single_frame_needs_no_kernel():
    init_v = jnp.asarray(np.linspace(-5, -1, N, dtype=np.float32))
    init_u = jnp.full((N,), -3.0)
    states = cuda.viterbi_decode_gpu(init_v, init_u, jnp.zeros((0, N)),
                                     jnp.zeros((0,)), 101, CFG.switch_prob)
    assert np.asarray(states).tolist() == [N - 1]


def test_build_command_targets_hopper():
    out = cuda.library_path()
    cmd = cuda.build_command(out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert os.path.dirname(out) == os.path.join(REPO, ".build", "cuda")
    assert ".build/" in open(os.path.join(REPO, ".gitignore")).read().split()


def test_build_compiles_once_into_build_dir(tmp_path, monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda, "BUILD_DIR", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda.subprocess, "run", fake_run)
    so = cuda.build()
    assert so.startswith(str(tmp_path / "cuda")) and os.path.exists(so)
    assert cuda.build() == so and len(calls) == 1  # keyed by source hash


def test_build_reports_nvcc_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda, "BUILD_DIR", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 1, "", "bad ptx"))
    with pytest.raises(RuntimeError, match="bad ptx"):
        cuda.build()


@pytest.mark.gpu
def test_kernel_matches_scan_on_gpu(gpu):
    from aegis_tpu.tools.viterbi_bench import parity

    obs, vp = synthetic_obs(300, N, seed=5)
    for width in (101, 51):
        assert parity(obs, vp, width, CFG, "small")["ok"]
    tiles = np.stack([synthetic_obs(64, N, seed=s)[0] for s in range(4)])
    vps = np.clip(tiles.sum(-1), 0, 1).astype(np.float32)
    assert parity(tiles, vps, 101, CFG, "vmap")["ok"]
