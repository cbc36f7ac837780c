"""The pYIN Viterbi decode on the GPU: the CUDA kernel against the dense scan.

    python -m aegis_tpu.tools.viterbi_bench [--parity-only]

Checks that the kernel (``aegis_tpu.cuda``) and ``core.pyin.viterbi_scan``
give identical states at the real shapes (a 60 s track at 22.05 kHz and at
44.1 kHz band width, seeded random observations, and a vmapped batch of turbo
tiles), then times the decode alone (kernel, scan, scan with ``unroll``) and
the 60 s v1 analyze end to end with each decode.  Needs a GPU; prints one
JSON object per line.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np

from aegis_tpu.config import PyinConfig, TurboConfig

SR = 22050
HOP = 512
SECONDS = 60.0
UNROLLS = (2, 4, 8, 16)


def synthetic_obs(T: int, n: int, seed: int):
    """Sparse trough mass around a wandering pitch, with long jumps (the
    out-of-band path) and unvoiced stretches."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((T, n), np.float32)
    center = n // 2
    for t in range(T):
        center = int(np.clip(center + rng.integers(-8, 9), 5, n - 6))
        if t % 97 < 80:
            for d in (-2, -1, 0, 1, 2):
                obs[t, center + d] = rng.random() * 0.2
        if t % 13 == 7:
            obs[t, (center + 230) % n] = 0.9
    voiced_prob = np.clip(obs.sum(axis=1), 0.0, 1.0).astype(np.float32)
    return obs, voiced_prob


def track_obs(y: np.ndarray, sr: int, cfg: PyinConfig):
    """The observations pYIN decodes for a real signal."""
    import jax
    import jax.numpy as jnp

    from aegis_tpu.core import pyin

    frames = pyin.extract_pyin_frames(jnp.asarray(y, jnp.float32), HOP, cfg)
    obs, vp = jax.jit(pyin.pyin_observations, static_argnums=(1, 2))(
        frames, sr, cfg)
    return np.asarray(obs), np.asarray(vp)


def _decoders(width: int, cfg: PyinConfig, unroll: int = 1):
    import functools

    import jax
    import jax.numpy as jnp

    from aegis_tpu.core import pyin
    from aegis_tpu.cuda import viterbi_decode_gpu

    log_local = jnp.asarray(pyin.log_transition(cfg.n_pitch_bins, width))
    kernel = jax.jit(functools.partial(
        viterbi_decode_gpu, width=width, switch_prob=cfg.switch_prob))
    scan = jax.jit(lambda *a: pyin.viterbi_scan(
        *a, log_local, cfg.switch_prob, unroll=unroll))
    return kernel, scan


def parity(obs: np.ndarray, vp: np.ndarray, width: int, cfg: PyinConfig,
           label: str) -> dict:
    """Kernel vs scan states on the same decode inputs; obs may carry one
    leading batch axis, decoded through ``jax.vmap``."""
    import jax

    from aegis_tpu.core import pyin

    batched = obs.ndim == 3
    prep = jax.jit(jax.vmap(pyin.viterbi_inputs) if batched
                   else pyin.viterbi_inputs)
    inputs = prep(obs, vp)
    kernel, scan = _decoders(width, cfg)
    if batched:
        kernel, scan = jax.jit(jax.vmap(kernel)), jax.jit(jax.vmap(scan))
    got = np.asarray(kernel(*inputs))
    ref = np.asarray(scan(*inputs))
    bad = np.argwhere(got != ref)
    return {"phase": "viterbi_parity", "case": label, "shape": list(obs.shape),
            "width": width, "mismatches": int(len(bad)),
            "first_mismatch": bad[0].tolist() if len(bad) else None,
            "ok": got.shape == ref.shape and not len(bad)}


def parity_cases(cfg: PyinConfig | None = None):
    """(label, obs, voiced_prob, width) for every parity case at real size."""
    from aegis_tpu.tools.signal_gen import generate_bench_track

    cfg = cfg or PyinConfig()
    n = cfg.n_pitch_bins
    T = int(SECONDS * SR) // HOP + 1
    y = generate_bench_track(SECONDS, SR)
    track = track_obs(y, SR, cfg)
    cases = []
    for sr in (22050, 44100):
        w = cfg.transition_width(sr, HOP)
        cases.append((f"seeded_T{T}_w{w}", *synthetic_obs(T, n, seed=w), w))
        cases.append((f"bench_track_T{T}_w{w}", *track, w))
    turbo = TurboConfig()
    tile = turbo.tile_frames + 2 * turbo.halo_frames
    tiles = [synthetic_obs(tile, n, seed=100 + k) for k in range(8)]
    w = cfg.transition_width(SR, HOP)
    cases.append((f"vmap_8x{tile}_w{w}", np.stack([t[0] for t in tiles]),
                  np.stack([t[1] for t in tiles]), w))
    return cases


def _median_s(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


@contextlib.contextmanager
def scan_decode():
    """Route pyin's decode to the dense scan (for the end-to-end comparison)."""
    import jax
    import jax.numpy as jnp

    from aegis_tpu.core import pyin

    orig = pyin.decode_states

    def scan_only(obs, voiced_prob, width, cfg):
        return pyin.viterbi_scan(
            *pyin.viterbi_inputs(obs, voiced_prob),
            jnp.asarray(pyin.log_transition(cfg.n_pitch_bins, width)),
            cfg.switch_prob)

    pyin.decode_states = scan_only
    jax.clear_caches()
    try:
        yield
    finally:
        pyin.decode_states = orig
        jax.clear_caches()


def timings(cfg: PyinConfig) -> list:
    import jax

    from aegis_tpu.core import pyin

    rows = []
    for label, obs, vp, w in parity_cases(cfg):
        if label.startswith("bench_track"):
            continue
        batched = obs.ndim == 3
        prep = jax.jit(jax.vmap(pyin.viterbi_inputs) if batched
                       else pyin.viterbi_inputs)
        inputs = jax.block_until_ready(prep(obs, vp))
        row = {"phase": "viterbi_time", "case": label}
        for unroll in (1, *UNROLLS):
            kernel, scan = _decoders(w, cfg, unroll)
            if batched:
                kernel, scan = jax.jit(jax.vmap(kernel)), jax.jit(jax.vmap(scan))
            if unroll == 1:
                row["kernel_ms"] = 1e3 * _median_s(
                    lambda: jax.block_until_ready(kernel(*inputs)))
                row["scan_ms"] = 1e3 * _median_s(
                    lambda: jax.block_until_ready(scan(*inputs)))
            else:
                row[f"scan_unroll{unroll}_ms"] = 1e3 * _median_s(
                    lambda: jax.block_until_ready(scan(*inputs)), reps=3)
        rows.append(row)
    return rows


def end_to_end() -> dict:
    """60 s v1 analyze (device program + host extraction), kernel vs scan,
    in turns (kernel, scan, scan, kernel); and whether two runs agree, both
    end to end and in the observations pYIN decodes."""
    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.tools.signal_gen import generate_bench_track

    y = generate_bench_track(SECONDS, SR)
    eng = AegisEngine(sample_rate=SR, backend="device")

    def run():
        raw = eng.audio_to_midi(y, None, fetch_mel=False)
        return raw, eng.extract_events(raw, None)

    def measure():
        t0 = time.perf_counter()
        raw, _ = run()
        cold = time.perf_counter() - t0
        return cold, _median_s(run), raw

    out = {"phase": "v1_60s_end_to_end"}
    cold_k, warm_k1, raw_k = measure()
    with scan_decode():
        cold_s, warm_s1, raw_s = measure()
        warm_s2 = _median_s(run)
    warm_k2 = _median_s(run)
    raw_k2, _ = run()
    f0 = lambda r: np.nan_to_num(np.asarray(r["f0"]), nan=-1.0)  # noqa: E731
    # the observation scatter-add (duplicate bins) runs as atomics on the GPU
    obs = [track_obs(y, SR, PyinConfig())[0] for _ in range(2)]
    out.update(
        obs_repeat_max_abs_diff=float(np.abs(obs[0] - obs[1]).max()),
        kernel_cold_s=cold_k, scan_cold_s=cold_s,
        kernel_warm_ms=[1e3 * warm_k1, 1e3 * warm_k2],
        scan_warm_ms=[1e3 * warm_s1, 1e3 * warm_s2],
        kernel_equals_scan=bool((f0(raw_k) == f0(raw_s)).all()),
        repeat_identical=bool((f0(raw_k) == f0(raw_k2)).all()))
    return out


def main(argv=None) -> int:
    import argparse

    import jax

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parity-only", action="store_true")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("no GPU: the CUDA decode cannot run here", file=sys.stderr)
        return 2
    cfg = PyinConfig()
    ok = True
    for label, obs, vp, w in parity_cases(cfg):
        row = parity(obs, vp, w, cfg, label)
        ok &= row["ok"]
        print(json.dumps(row), flush=True)
    if not args.parity_only:
        for row in timings(cfg):
            print(json.dumps(row), flush=True)
        print(json.dumps(end_to_end()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
