"""pYIN probabilistic pitch tracking on the device (JAX).

Line-for-line the same math as the CPU oracle ``aegis_tpu.ref.pyin_ref`` (see
its docstring for the algorithm description and reference citations), but
expressed as fixed-shape XLA programs:

  * CMNDF for all frames at once: batched rFFT autocorrelation + cumulative
    energy sums — one (T, 2*frame_length) rFFT instead of librosa's per-frame
    Python work (replaces the reference's hottest loop, SURVEY.md §3.1).
  * Probabilistic thresholding as a ``lax.fori_loop`` over the 100 thresholds
    with (T, L) vector work per step — no ragged trough lists.
  * Observation scatter-add into 0.1-semitone pitch bins.
  * Viterbi: on the GPU one launch of a banded CUDA kernel
    (``aegis_tpu.cuda``) per batch of sequences; elsewhere a ``lax.scan``
    over frames with dense max-plus steps and a reverse-scan backtrace.

The whole thing jits into a single device program; `pyin_from_frames` is the
jittable core so the turbo path can feed pre-framed, sharded tiles.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from aegis_tpu.config import PyinConfig
from aegis_tpu.ref.pyin_ref import beta_threshold_probs, local_transition


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

def cmndf_frames(frames: jnp.ndarray, win_length: int, min_period: int,
                 max_period: int) -> jnp.ndarray:
    """Cumulative-mean-normalized difference function, (T, L)."""
    T, frame_length = frames.shape
    n_fft = 2 * frame_length

    head = jnp.concatenate(
        [frames[:, :win_length],
         jnp.zeros((T, frame_length - win_length), frames.dtype)],
        axis=-1,
    )
    F = jnp.fft.rfft(frames, n_fft, axis=-1)
    G = jnp.fft.rfft(head, n_fft, axis=-1)
    corr = jnp.fft.irfft(F * jnp.conj(G), n_fft, axis=-1)[:, : max_period + 1]

    sq = frames * frames
    cum = jnp.concatenate(
        [jnp.zeros((T, 1), frames.dtype), jnp.cumsum(sq, axis=-1)], axis=-1
    )
    taus = np.arange(max_period + 1)
    e_tau = cum[:, taus + win_length] - cum[:, taus]
    e0 = e_tau[:, :1]

    diff = jnp.maximum(e0 + e_tau - 2.0 * corr, 0.0)

    tau_range = jnp.asarray(np.arange(1, max_period + 1), frames.dtype)
    cumulative = jnp.cumsum(diff[:, 1:], axis=-1)
    tiny = jnp.asarray(np.finfo(np.float32).tiny, frames.dtype)
    cmndf = diff[:, 1:] * tau_range[None, :] / jnp.maximum(cumulative, tiny)
    cmndf = jnp.concatenate([jnp.ones((T, 1), frames.dtype), cmndf], axis=-1)
    return cmndf[:, min_period : max_period + 1]


def parabolic_shifts(yin: jnp.ndarray) -> jnp.ndarray:
    T, L = yin.shape
    if L < 3:
        return jnp.zeros_like(yin)
    a, b, c = yin[:, :-2], yin[:, 1:-1], yin[:, 2:]
    denom = a - 2.0 * b + c
    s = jnp.where(jnp.abs(denom) > 0, (a - c) / (2.0 * denom), 0.0)
    s = jnp.clip(jnp.nan_to_num(s), -0.5, 0.5)
    return jnp.pad(s, ((0, 0), (1, 1)))


def trough_mask(yin: jnp.ndarray) -> jnp.ndarray:
    T, L = yin.shape
    inner = (yin[:, 1:-1] < yin[:, :-2]) & (yin[:, 1:-1] <= yin[:, 2:])
    first = (yin[:, 0] < yin[:, 1])[:, None]
    return jnp.concatenate(
        [first, inner, jnp.zeros((T, 1), bool)], axis=-1
    )


def trough_probabilities(yin: jnp.ndarray, mask: jnp.ndarray,
                         cfg: PyinConfig) -> jnp.ndarray:
    """(T, L) Beta-weighted Boltzmann trough probabilities."""
    T, L = yin.shape
    thresholds_np, beta_np = beta_threshold_probs(cfg)
    thr_arr = jnp.asarray(thresholds_np, yin.dtype)
    beta_arr = jnp.asarray(beta_np, yin.dtype)
    lam = cfg.boltzmann_parameter
    one_m = -np.expm1(-lam)

    heights = jnp.where(mask, yin, jnp.inf)
    any_trough = mask.any(axis=1)
    gmin_onehot = jax.nn.one_hot(jnp.argmin(heights, axis=1), L, dtype=yin.dtype)

    def body(i, acc):
        thr, bp = thr_arr[i], beta_arr[i]
        below = mask & (yin < thr)
        n_below = below.sum(axis=1)
        rank = jnp.cumsum(below, axis=1) - 1
        denom = -jnp.expm1(-lam * jnp.maximum(n_below, 1).astype(yin.dtype))
        pmf = jnp.exp(-lam * rank.astype(yin.dtype)) * one_m / denom[:, None]
        acc = acc + jnp.where(below, bp * pmf, 0.0)
        no_trough = (~below.any(axis=1)) & any_trough
        bump = jnp.where(no_trough, bp * cfg.no_trough_prob, 0.0)
        return acc + bump[:, None] * gmin_onehot

    return jax.lax.fori_loop(0, len(thresholds_np), body, jnp.zeros((T, L), yin.dtype))


def observations(probs: jnp.ndarray, shifts: jnp.ndarray, sr: int,
                 min_period: int, cfg: PyinConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter trough probabilities into pitch bins.  (T, n_bins), (T,)."""
    T, L = probs.shape
    n_bins = cfg.n_pitch_bins
    nbps = cfg.n_bins_per_semitone

    periods = min_period + jnp.asarray(np.arange(L), probs.dtype)[None, :] + shifts
    freqs = sr / jnp.maximum(periods, 1e-6)
    bins = jnp.round(12 * nbps * jnp.log2(jnp.maximum(freqs, 1e-6) / cfg.fmin))
    bins = jnp.clip(bins, 0, n_bins - 1).astype(jnp.int32)

    obs = jnp.zeros((T, n_bins), probs.dtype)
    row = jnp.broadcast_to(jnp.arange(T)[:, None], (T, L))
    obs = obs.at[row, bins].add(probs)
    voiced_prob = jnp.clip(obs.sum(axis=1), 0.0, 1.0)
    return obs, voiced_prob


@functools.lru_cache(maxsize=None)
def log_transition(n: int, width: int) -> np.ndarray:
    """(n, n) float32 log of the banded pitch transition, floored at 1e-30
    (cached, read-only)."""
    out = np.log(local_transition(n, width) + 1e-30).astype(np.float32)
    out.flags.writeable = False
    return out


def viterbi_inputs(obs: jnp.ndarray, voiced_prob: jnp.ndarray):
    """Initial deltas and per-step log observations of the decode:
    (init_v (n,), init_u (n,), log_obs_v[1:] (T-1, n), log_obs_u[1:] (T-1,))."""
    T, n = obs.shape
    eps = 1e-30
    log_obs_v = jnp.log(obs + eps)
    log_obs_u = jnp.log((1.0 - voiced_prob) / n + eps)
    init = jnp.full((n,), np.log(1.0 / (2 * n)), jnp.float32)
    return init + log_obs_v[0], init + log_obs_u[0], log_obs_v[1:], log_obs_u[1:]


def viterbi_scan(init_v: jnp.ndarray, init_u: jnp.ndarray, log_obs_v: jnp.ndarray,
                 log_obs_u: jnp.ndarray, log_local: jnp.ndarray,
                 switch_prob: float, unroll: int = 1) -> jnp.ndarray:
    """Dense max-product decode over 2*n states as a ``lax.scan``; states[t]
    in [0, 2n).  Argmax ties go to the smallest source index."""
    n = init_v.shape[0]
    log_stay = float(np.log1p(-switch_prob))
    log_switch = float(np.log(switch_prob))

    def step(carry, inputs):
        delta_v, delta_u = carry
        lov, lou = inputs
        scores_v = delta_v[:, None] + log_local
        scores_u = delta_u[:, None] + log_local
        best_v = jnp.argmax(scores_v, axis=0).astype(jnp.int32)
        best_u = jnp.argmax(scores_u, axis=0).astype(jnp.int32)
        m_v = jnp.max(scores_v, axis=0)
        m_u = jnp.max(scores_u, axis=0)

        stay, switch = m_v + log_stay, m_u + log_switch
        take_stay = stay >= switch
        dv = jnp.where(take_stay, stay, switch) + lov
        pv = jnp.where(take_stay, best_v, best_u + n)

        sw, st = m_v + log_switch, m_u + log_stay
        take_sw = sw >= st
        du = jnp.where(take_sw, sw, st) + lou
        pu = jnp.where(take_sw, best_v, best_u + n)
        return (dv, du), (pv, pu)

    (dv, du), (psi_v, psi_u) = jax.lax.scan(
        step, (init_v, init_u), (log_obs_v, log_obs_u), unroll=unroll
    )

    last = jnp.argmax(jnp.concatenate([dv, du])).astype(jnp.int32)

    def back(state, psis):
        pv, pu = psis
        prev = jnp.where(state < n, pv[jnp.minimum(state, n - 1)],
                         pu[jnp.minimum(state - n, n - 1)])
        return prev, prev

    _, earlier = jax.lax.scan(back, last, (psi_v, psi_u), reverse=True,
                              unroll=unroll)
    return jnp.concatenate([earlier, last[None]])


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def decode_states(obs: jnp.ndarray, voiced_prob: jnp.ndarray,
                  width: int, cfg: PyinConfig) -> jnp.ndarray:
    """Viterbi dispatch, chosen at trace time: the banded CUDA kernel
    (``aegis_tpu.cuda``) on the GPU, the dense ``lax.scan`` elsewhere."""
    inputs = viterbi_inputs(obs, voiced_prob)
    if jax.default_backend() == "gpu":
        from aegis_tpu.cuda import viterbi_decode_gpu

        return viterbi_decode_gpu(*inputs, width, cfg.switch_prob)
    log_local = jnp.asarray(log_transition(cfg.n_pitch_bins, width))
    return viterbi_scan(*inputs, log_local, cfg.switch_prob)


def pyin_observations(frames: jnp.ndarray, sr: int,
                      cfg: PyinConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pitch-bin observations (T, n_bins) and voiced probability (T,) of
    pre-extracted frames: everything of pYIN ahead of the Viterbi decode."""
    min_p, max_p = cfg.min_period(sr), cfg.max_period(sr)

    yin = cmndf_frames(frames.astype(jnp.float32), cfg.win_length, min_p, max_p)
    shifts = parabolic_shifts(yin)
    mask = trough_mask(yin)
    probs = trough_probabilities(yin, mask, cfg)
    return observations(probs, shifts, sr, min_p, cfg)


@functools.partial(jax.jit, static_argnames=("sr", "hop_length", "cfg"))
def pyin_from_frames(frames: jnp.ndarray, sr: int, hop_length: int,
                     cfg: PyinConfig) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Jittable pYIN core over pre-extracted frames (T, frame_length).

    Returns (f0, voiced_flag, voiced_prob); f0 is NaN on unvoiced frames.
    """
    obs, voiced_prob = pyin_observations(frames, sr, cfg)
    states = decode_states(obs, voiced_prob,
                           cfg.transition_width(sr, hop_length), cfg)

    n = cfg.n_pitch_bins
    bin_idx = states % n
    voiced_flag = states < n
    freqs = cfg.fmin * 2.0 ** (bin_idx.astype(jnp.float32) / (12.0 * cfg.n_bins_per_semitone))
    f0 = jnp.where(voiced_flag, freqs, jnp.nan)
    return f0, voiced_flag, voiced_prob


def extract_pyin_frames(y: jnp.ndarray, hop_length: int, cfg: PyinConfig) -> jnp.ndarray:
    """Centered zero-padded frames for pYIN, (T, frame_length).

    Delegates to dsp.frame_signal, which builds overlapping frames from
    contiguous slices instead of a gather.
    """
    from aegis_tpu.core import dsp

    return dsp.frame_signal(y, cfg.frame_length, hop_length, "constant")


def pyin(y: jnp.ndarray, sr: int, hop_length: int = 512,
         cfg: PyinConfig | None = None):
    """Full pYIN from a 1-D signal (host convenience wrapper)."""
    if cfg is None:
        cfg = PyinConfig()
    frames = extract_pyin_frames(jnp.asarray(y, jnp.float32), hop_length, cfg)
    return pyin_from_frames(frames, sr, hop_length, cfg)
