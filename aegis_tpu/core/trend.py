"""Device-side "financial" trend/noise filters (JAX).

Recurrent filters (EMA, Kalman, Holt-Winters, Wilder RSI) are expressed as
**affine recurrences y[t] = a[t]*y[t-1] + b[t]** and evaluated with
log-depth ``jax.lax.associative_scan`` — a sequential ``lax.scan`` over T
frames costs ~T * step-latency on the device; the associative form is
embarrassingly parallel.
Hold-last-value recurrences (ATR spike replacement, the Bollinger
articulation state machine's counter) reduce to cummax-of-index + gather.
Windowed statistics (SMA, Bollinger std, Ichimoku, stochastic) are
cumulative-sum / gathered-window reductions.  No per-frame Python loops
(replaces the reference's frame loops at financial_analysis.py /
financial_filters.py; see SURVEY.md §7.1).

Semantics contract is defined by the CPU oracle ``aegis_tpu.ref.trend_ref``
(including the documented Savitzky-Golay forward-fill deviation); every
function here is parity-tested against it.

NaN convention: f0 is NaN on unvoiced frames throughout, matching the
reference's librosa contract (midi_logic_financial.py:157-158).

Precision note: rolling variance uses a global-mean shift before the moment
cumsums so float32 cancellation stays benign at Hz magnitudes.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from aegis_tpu.ref.trend_ref import _savgol_kernel

NAN = jnp.nan

# Articulation / slide codes (shared with ref.trend_ref)
ARTIC_NONE, ARTIC_NORMAL, ARTIC_BEND, ARTIC_VIBRATO, ARTIC_NOISE = 0, 1, 2, 3, 4
SLIDE_NONE, SLIDE_UP, SLIDE_DOWN, SLIDE_NORMAL = 0, 1, 2, 3


def _isnan(x):
    return jnp.isnan(x)


def _affine_scan(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """y[t] = a[t] * y[t-1] + b[t] with y[-1] = 0, in log depth.

    Affine maps compose associatively: (a2,b2)∘(a1,b1) = (a1*a2, a2*b1+b2).
    Callers encode "reset to v" elements as (a=0, b=v) and "skip" elements
    as (a=1, b=0); b must be finite everywhere (NaNs are re-applied by the
    caller) so 0*NaN can never poison a later segment.
    """

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, a_r * b_l + b_r

    _, y = jax.lax.associative_scan(combine, (a.astype(jnp.float32),
                                              b.astype(jnp.float32)))
    return y


def _affine_scan_2x2(M: jnp.ndarray, v: jnp.ndarray,
                     init: jnp.ndarray) -> jnp.ndarray:
    """State recurrence s[t] = M[t] @ s[t-1] + v[t], s[-1] = init, log depth.

    M: (T, 2, 2), v: (T, 2), init: (2,).  Returns states (T, 2).
    """

    # precision HIGHEST: at default precision f32 contraction inputs may be
    # rounded (bf16 / TF32) — repeated 2x2 compositions then drift ~1e-3
    # relative, i.e. ~0.3 Hz on a pitch trend (see savgol note)
    hp = jax.lax.Precision.HIGHEST

    def combine(left, right):
        M_l, v_l = left
        M_r, v_r = right
        return (jnp.einsum("tij,tjk->tik", M_r, M_l, precision=hp),
                jnp.einsum("tij,tj->ti", M_r, v_l, precision=hp) + v_r)

    M_c, v_c = jax.lax.associative_scan(combine, (M, v))
    return jnp.einsum("tij,j->ti", M_c, init, precision=hp) + v_c


def _trailing_window(x: jnp.ndarray, w: int, include_current: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gathered trailing windows.  Returns (vals (T, w), valid_pos (T, w)).

    include_current=True  -> window [i-w+1, i]
    include_current=False -> window [i-w, i-1]
    """
    T = x.shape[0]
    idx = jnp.arange(T)[:, None]
    if include_current:
        offs = jnp.arange(-w + 1, 1)[None, :]
    else:
        offs = jnp.arange(-w, 0)[None, :]
    pos = idx + offs
    in_range = pos >= 0
    vals = x[jnp.clip(pos, 0, T - 1)]
    return vals, in_range


# ---------------------------------------------------------------- moving avgs

def sma(data: jnp.ndarray, window: int = 5) -> jnp.ndarray:
    valid = jnp.where(_isnan(data), 0.0, data)
    kernel = jnp.ones((window,)) / window
    # full f32 precision: see savgol
    out = jnp.convolve(valid, kernel, mode="same",
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.where(_isnan(data), NAN, out)


def ema(data: jnp.ndarray, span: int = 5) -> jnp.ndarray:
    """EMA with NaN-gap reset (see ref.trend_ref.ema), as an affine scan.

    The EMA state is NaN exactly when the previous sample was NaN, so every
    valid sample that follows a NaN (or t=0) is a segment start emitting x
    verbatim — encoded (a=0, b=x); other valid samples are (1-α, αx); NaN
    samples contribute (0, 0) and get their NaN re-applied afterwards.
    """
    alpha = 2.0 / (span + 1.0)
    data = data.astype(jnp.float32)
    valid = ~_isnan(data)
    prev_valid = jnp.concatenate([jnp.array([False]), valid[:-1]])
    start = valid & ~prev_valid
    x = jnp.where(valid, data, 0.0)
    a = jnp.where(start | ~valid, 0.0, 1.0 - alpha)
    b = jnp.where(start, x, jnp.where(valid, alpha * x, 0.0))
    return jnp.where(valid, _affine_scan(a, b), NAN)


def _rolling_std_trailing(data: jnp.ndarray, window: int) -> jnp.ndarray:
    """NaN-aware std over trailing windows [i-window+1, i]; NaN when < 2 valid.

    Per-window TWO-PASS variance: the textbook E[x^2]-E[x]^2 form cancels
    catastrophically in float32 at pitch magnitudes (x ~ 300 Hz, window
    variance ~ 0.01 -> ~7 digits lost, which showed up as 0.08-level
    financial-confidence divergence vs the f64 oracle on the 60 s bench
    track).  Subtracting each window's own mean first keeps the error at
    ~eps*var."""
    valid = ~_isnan(data)
    v = jnp.where(valid, data, 0.0)
    vals, _ = _trailing_window(v, window, include_current=True)
    mask, in_range = _trailing_window(valid.astype(jnp.float32), window, True)
    mask = mask * in_range
    cnt = jnp.sum(mask, axis=1)
    c = jnp.maximum(cnt, 1.0)
    mean_w = jnp.sum(vals * mask, axis=1) / c
    dev = (vals - mean_w[:, None]) * mask
    var = jnp.sum(dev * dev, axis=1) / c
    return jnp.where(cnt > 1, jnp.sqrt(var), NAN)


def bollinger(data: jnp.ndarray, window: int = 20, num_std: float = 2.0):
    ma = sma(data, window)
    std = _rolling_std_trailing(data, window)
    return ma, ma + num_std * std, ma - num_std * std


# -------------------------------------------------------------- articulations

def detect_articulation_bollinger(f0: jnp.ndarray, window: int = 10,
                                  sensitivity: float = 2.0) -> jnp.ndarray:
    """(T,) int8 articulation codes; state machine as a scan."""
    _, upper, lower = bollinger(f0, window, sensitivity)
    above = (~_isnan(upper)) & (f0 > upper)
    below = (~_isnan(lower)) & (f0 < lower)
    state = jnp.where(above, 1, jnp.where(below, 2, 0)).astype(jnp.int32)
    valid = ~_isnan(f0)
    T = f0.shape[0]
    idx = jnp.arange(T)

    # The scan carry (prev_state, counter) only advances on valid frames, so
    # both resolve to gathers over the valid-frame subsequence:
    #   prev_state[t] = state at the previous valid frame (0 if none)
    #   counter[t]    = valid-rank distance since the last "crossed=False"
    #                   valid frame (the first valid frame is always one).
    last_valid = jax.lax.cummax(jnp.where(valid, idx, -1))
    prev_valid = jnp.concatenate([jnp.array([-1]), last_valid[:-1]])
    prev_state = jnp.where(prev_valid >= 0,
                           state[jnp.clip(prev_valid, 0, T - 1)], 0)
    crossed = valid & (prev_state != state) & (prev_state != 0)

    rank = jnp.cumsum(valid) - 1
    zero_rank = jax.lax.cummax(jnp.where(valid & ~crossed, rank, -1))
    counter = rank - zero_rank

    artic = jnp.where(
        counter >= 2,
        ARTIC_VIBRATO,
        jnp.where(state == 1, ARTIC_BEND,
                  jnp.where(state == 2, ARTIC_NOISE, ARTIC_NORMAL)),
    )
    return jnp.where(valid, artic, ARTIC_NONE).astype(jnp.int8)


# ---------------------------------------------------------------------- MACD

def macd(data: jnp.ndarray, fast: int = 12, slow: int = 26, signal: int = 9):
    macd_line = ema(data, fast) - ema(data, slow)
    signal_line = ema(macd_line, signal)
    return macd_line, signal_line, macd_line - signal_line


def detect_slides_macd(f0: jnp.ndarray, threshold: float = 0.5) -> jnp.ndarray:
    semis = 12.0 * jnp.log2(f0 / 440.0) + 69.0  # NaN propagates
    macd_line, _, hist = macd(semis, fast=5, slow=20, signal=9)
    out = jnp.where(
        (macd_line > threshold) & (hist > 0),
        SLIDE_UP,
        jnp.where((macd_line < -threshold) & (hist < 0), SLIDE_DOWN, SLIDE_NORMAL),
    )
    return jnp.where(_isnan(macd_line), SLIDE_NONE, out).astype(jnp.int8)


# ----------------------------------------------------------------------- RSI

def rsi(data: jnp.ndarray, period: int = 14) -> jnp.ndarray:
    """Wilder-smoothed RSI (scan), default 50."""
    n = data.shape[0]
    if n <= period:
        return jnp.full((n,), 50.0)
    deltas = jnp.diff(data)
    gains = jnp.maximum(deltas, 0.0)
    losses = jnp.maximum(-deltas, 0.0)

    init_g = jnp.mean(gains[:period])
    init_l = jnp.mean(losses[:period])

    # Wilder smoothing is a constant-coefficient affine recurrence
    # avg' = avg*(p-1)/p + g/p; seed with (a=0, b=init) and evaluate both
    # gain/loss paths in log depth.
    a_const = (period - 1.0) / period
    g_tail, l_tail = gains[period:], losses[period:]
    a = jnp.concatenate([jnp.zeros((1,)), jnp.full(g_tail.shape, a_const)])
    avg_g_tail = _affine_scan(
        a, jnp.concatenate([init_g[None], g_tail / period]))[1:]
    avg_l_tail = _affine_scan(
        a, jnp.concatenate([init_l[None], l_tail / period]))[1:]
    avg_g = jnp.concatenate([init_g[None], avg_g_tail])
    avg_l = jnp.concatenate([init_l[None], avg_l_tail])
    vals = jnp.where(
        avg_l == 0, 100.0, 100.0 - 100.0 / (1.0 + avg_g / jnp.maximum(avg_l, 1e-30))
    )
    return jnp.concatenate([jnp.full((period,), 50.0), vals])


# -------------------------------------------------------------- noise filters

def kalman(data: jnp.ndarray, process_variance: float = 1e-5,
           measurement_variance: float = 1e-1) -> jnp.ndarray:
    """Scalar Kalman with NaN skip, as an affine scan.

    The error-covariance path p/k only advances on valid samples and never
    depends on their values, so the gain for the j-th valid sample is a
    trace-time constant: precompute k[1..T] in NumPy, gather by the running
    valid count, and the x path becomes x' = (1-k_j)x + k_j z — affine.
    The very first valid sample yields exactly z (x_est is initialized to
    it), encoded (a=0, b=z).
    """
    data = data.astype(jnp.float32)
    T = data.shape[0]
    valid = ~_isnan(data)

    ks = np.empty(T + 1, np.float32)
    ks[0] = 0.0  # unused (j is 1-indexed over valid samples)
    p = 1.0
    for j in range(1, T + 1):
        p_pred = p + process_variance
        ks[j] = p_pred / (p_pred + measurement_variance)
        p = (1.0 - ks[j]) * p_pred
    k_table = jnp.asarray(ks)

    j = jnp.cumsum(valid)  # 1-indexed rank at valid positions
    k = k_table[j]
    z = jnp.where(valid, data, 0.0)
    first = valid & (j == 1)
    a = jnp.where(first, 0.0, jnp.where(valid, 1.0 - k, 1.0))
    b = jnp.where(first, z, jnp.where(valid, k * z, 0.0))
    out = jnp.where(valid, _affine_scan(a, b), NAN)
    return jnp.where(valid.any(), out, data)


def holt_winters(data: jnp.ndarray, alpha: float = 0.3, beta: float = 0.1) -> jnp.ndarray:
    valid = ~_isnan(data)
    idx = jnp.arange(data.shape[0])
    fv0 = jnp.argmax(valid)
    fv1 = jnp.argmax(valid & (idx > fv0))
    enough = valid.sum() >= 2
    level0 = data[fv0]
    trend0 = data[fv1] - data[fv0]

    # (level, trend) is a 2-state affine recurrence:
    #   level' = αx + (1-α)level + (1-α)trend
    #   trend' = βαx −  βα level + (1-βα)trend
    # NaN samples apply the identity map.  Evaluated in log depth.
    data = data.astype(jnp.float32)
    T = data.shape[0]
    vmask = ~_isnan(data)
    x = jnp.where(vmask, data, 0.0)
    M_upd = jnp.array([[1 - alpha, 1 - alpha],
                       [-beta * alpha, 1 - beta * alpha]], jnp.float32)
    M = jnp.where(vmask[:, None, None], M_upd[None],
                  jnp.eye(2, dtype=jnp.float32)[None])
    v = jnp.where(vmask[:, None],
                  jnp.stack([alpha * x, beta * alpha * x], axis=1), 0.0)
    init = jnp.stack([level0, trend0]).astype(jnp.float32)
    states = _affine_scan_2x2(M, v, init)
    out = jnp.where(vmask, states[:, 0], NAN)
    return jnp.where(enough, out, data)


def forward_fill(data: jnp.ndarray) -> jnp.ndarray:
    """Hold-last-value fill; leading NaNs back-filled with the first valid."""
    T = data.shape[0]
    valid = ~_isnan(data)
    idx = jnp.arange(T)
    lvi = jax.lax.cummax(jnp.where(valid, idx, -1))
    first = jnp.argmax(valid)
    filled = data[jnp.clip(lvi, 0, T - 1)]
    return jnp.where(lvi >= 0, filled, data[first])


def savgol(data: jnp.ndarray, window: int = 11, polyorder: int = 3) -> jnp.ndarray:
    """Savitzky-Golay on forward-filled data, NaNs restored; all-NaN when
    fewer than `window` valid samples (see ref.trend_ref docstring)."""
    valid = ~_isnan(data)
    filled = forward_fill(data)
    half = window // 2
    padded = jnp.pad(filled, half, mode="edge")
    kernel = jnp.asarray(_savgol_kernel(window, polyorder)[::-1].copy(), jnp.float32)
    # precision HIGHEST: reduced-precision conv inputs (bf16 / TF32 at
    # default precision) have ~1e-3 relative error, which is ~0.3 Hz at
    # pitch magnitudes — enough to flip rounded notes at semitone
    # boundaries (60 s bench F1 regression)
    out = jnp.convolve(padded, kernel, mode="valid",
                       precision=jax.lax.Precision.HIGHEST)
    out = jnp.where(valid, out, NAN)
    return jnp.where(valid.sum() > window, out, jnp.full_like(data, NAN))


def atr_filter(data: jnp.ndarray, window: int = 14, threshold: float = 2.0):
    """(filtered, noise_mask) — spike suppression with hold-last replacement."""
    n = data.shape[0]
    tr = jnp.abs(jnp.diff(data))  # length n-1, NaN propagates
    tr_valid = ~_isnan(tr)
    trv = jnp.where(tr_valid, tr, 0.0)
    cum = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(trv)])
    cnt = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(tr_valid.astype(jnp.float32))])
    i = jnp.arange(n)
    lo = jnp.maximum(i - window, 0)
    hi = jnp.minimum(i, n - 1)  # window tr[lo:i]
    s = cum[hi] - cum[lo]
    c = cnt[hi] - cnt[lo]
    atr = jnp.where((i >= window) & (i < n - 1) & (c > 0), s / jnp.maximum(c, 1), NAN)

    prev_vals = jnp.concatenate([data[:1], data[:-1]])
    noise = (~_isnan(atr)) & (~_isnan(data)) & (
        jnp.abs(data - prev_vals) > atr * threshold
    )
    noise = noise.at[0].set(False)

    # hold-last-value = gather at the most recent non-noise index
    # (noise[0] is forced False so the cummax is always >= 0)
    keep_idx = jax.lax.cummax(jnp.where(noise, -1, i))
    filtered = data[keep_idx]
    return filtered, noise


def ichimoku_baseline(data: jnp.ndarray, kijun: int = 26) -> jnp.ndarray:
    T = data.shape[0]
    vals, in_range = _trailing_window(data, kijun, include_current=False)
    ok = in_range & ~_isnan(vals)
    hi = jnp.max(jnp.where(ok, vals, -jnp.inf), axis=1)
    lo = jnp.min(jnp.where(ok, vals, jnp.inf), axis=1)
    has = ok.any(axis=1) & (jnp.arange(T) >= kijun)
    return jnp.where(has, (hi + lo) / 2.0, NAN)


def stochastic(data: jnp.ndarray, k_period: int = 14, smooth: int = 3) -> jnp.ndarray:
    T = data.shape[0]
    any_valid = (~_isnan(data)).any()
    vals, in_range = _trailing_window(data, k_period + 1, include_current=True)
    ok = in_range & ~_isnan(vals)
    hi = jnp.max(jnp.where(ok, vals, -jnp.inf), axis=1)
    lo = jnp.min(jnp.where(ok, vals, jnp.inf), axis=1)
    k_raw = (data - lo) / (hi - lo) * 100.0  # NaN where data NaN
    use = (jnp.arange(T) >= k_period) & ok.any(axis=1) & (hi - lo > 0)
    k_values = jnp.where(use, k_raw, 50.0)

    dvals, dir_ok = _trailing_window(k_values, smooth + 1, include_current=True)
    d_raw = jnp.sum(jnp.where(dir_ok, dvals, 0.0), axis=1) / jnp.maximum(
        jnp.sum(dir_ok, axis=1), 1
    )
    # np.mean over a window containing NaN propagates NaN
    has_nan = (dir_ok & _isnan(dvals)).any(axis=1)
    d_values = jnp.where(jnp.arange(T) >= smooth, jnp.where(has_nan, NAN, d_raw), 50.0)
    return jnp.where(any_valid, d_values, jnp.full((T,), 50.0))


# ------------------------------------------------------------------ consensus

def _nan_stats3(a, b, c):
    """(nanmedian, nanstd) across three arrays, elementwise."""
    stack = jnp.stack([a, b, c])
    valid = ~_isnan(stack)
    cnt = valid.sum(axis=0)
    big = jnp.where(valid, stack, jnp.inf)
    s = jnp.sort(big, axis=0)
    median = jnp.where(
        cnt == 3,
        s[1],
        jnp.where(cnt == 2, (s[0] + s[1]) / 2.0, jnp.where(cnt == 1, s[0], NAN)),
    )
    v = jnp.where(valid, stack, 0.0)
    c1 = jnp.maximum(cnt, 1)
    mean = v.sum(axis=0) / c1
    # two-pass variance: avoids f32 cancellation at Hz magnitudes
    dev = jnp.where(valid, stack - mean, 0.0)
    var = (dev * dev).sum(axis=0) / c1
    std = jnp.where(cnt > 0, jnp.sqrt(var), NAN)
    return median, std


def multi_filter_consensus(data: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    consensus, std = _nan_stats3(savgol(data), kalman(data), holt_winters(data))
    return consensus, 1.0 / (1.0 + std)


def bollinger_confidence(f0: jnp.ndarray, window: int = 10) -> jnp.ndarray:
    _, upper, lower = bollinger(f0, window)
    bw = upper - lower
    conf = jnp.where(bw > 0, 1.0 / (1.0 + bw), 1.0)
    return jnp.where(_isnan(f0) | _isnan(bw), 0.0, conf)


def analyze_pitch_financial(f0_clean: jnp.ndarray) -> dict:
    """Integrated device-side financial analysis (financial_analysis.py:368-423)."""
    trend, filter_conf = multi_filter_consensus(f0_clean)
    return {
        "trend": trend,
        "filter_confidence": filter_conf,
        "articulations": detect_articulation_bollinger(f0_clean, window=10),
        "slides": detect_slides_macd(f0_clean, threshold=0.3),
        "confidence": bollinger_confidence(f0_clean, window=10),
    }


def adaptive_confidence_threshold(conf: jnp.ndarray) -> jnp.ndarray:
    """Bollinger-style adaptive threshold: clip(mean - std, 0.3, 0.8)."""
    pos = conf > 0
    cnt = pos.sum()
    c = jnp.maximum(cnt, 1)
    mean = jnp.where(pos, conf, 0.0).sum() / c
    var = jnp.maximum(jnp.where(pos, conf * conf, 0.0).sum() / c - mean * mean, 0.0)
    thr = jnp.clip(mean - jnp.sqrt(var), 0.3, 0.8)
    return jnp.where(cnt > 0, thr, 0.5)
