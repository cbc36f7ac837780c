"""Constant-Q spectra, chroma and onset strength on device (JAX).

Device front end for the driver bench configs the reference only hints
at (BASELINE.json configs 2 and 4): a pseudo-CQT as |STFT|^2 projected onto
a log-frequency filterbank (one matmul, `core.filters.cqt_filterbank`),
CQT-folded chroma (the reference used librosa.feature.chroma_cqt in
auto_matcher.py:62-85), and a mel spectral-flux onset-strength envelope with
librosa.onset.onset_strength semantics (dB mel, first difference, half-wave
rectified, mean over bands, lag compensation).

Everything is fixed-shape matmul/elementwise work that fuses into the
analyze program; onset *peak picking* stays host-side (`pick_onsets`) — it
is a tiny O(T) pass over the envelope with data-dependent output length.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aegis_tpu.core import dsp
from aegis_tpu.core.filters import chroma_fold, cqt_filterbank

CQT_FMIN_MIDI = 24.0  # C1, matching filters.cqt_filterbank's default fmin


def pseudo_cqt_t(y: jnp.ndarray, sr: int, n_fft: int = 2048,
                 hop_length: int = 512, n_bins: int = 84,
                 bins_per_octave: int = 12) -> jnp.ndarray:
    """Pseudo-CQT power, time-major (T, n_bins)."""
    power = dsp.stft_power(y, n_fft, hop_length)
    fb = jnp.asarray(cqt_filterbank(sr, n_fft, n_bins, bins_per_octave).T)
    return jnp.dot(power, fb, preferred_element_type=jnp.float32)


def chroma_cqt_t(y: jnp.ndarray, sr: int, n_fft: int = 2048,
                 hop_length: int = 512, n_bins: int = 84,
                 bins_per_octave: int = 12) -> jnp.ndarray:
    """Column-normalized CQT chroma, time-major (T, 12)."""
    cqt = pseudo_cqt_t(y, sr, n_fft, hop_length, n_bins, bins_per_octave)
    fold = jnp.asarray(chroma_fold(n_bins, bins_per_octave).T)
    ch = jnp.dot(cqt, fold, preferred_element_type=jnp.float32)
    peak = jnp.max(ch, axis=1, keepdims=True)
    return ch / jnp.maximum(peak, 1e-10)


def onset_from_db(mel_db_t: jnp.ndarray, lag: int = 1) -> jnp.ndarray:
    """Spectral-flux onset envelope from a time-major dB mel spectrogram:
    lagged first difference, half-wave rectified, mean over bands; the
    first `lag` frames are zero.  Shape (T,)."""
    diff = mel_db_t[lag:] - mel_db_t[:-lag]
    flux = jnp.mean(jnp.maximum(diff, 0.0), axis=1)
    return jnp.concatenate([jnp.zeros((lag,), flux.dtype), flux])


def onset_strength_t(mel_power_t: jnp.ndarray, lag: int = 1) -> jnp.ndarray:
    """librosa.onset.onset_strength semantics from mel POWER: dB scale then
    onset_from_db."""
    return onset_from_db(dsp.power_to_db(mel_power_t), lag)


@functools.partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length",
                                             "n_mels"))
def onset_envelope_program(y: jnp.ndarray, sr: int, n_fft: int = 2048,
                           hop_length: int = 512,
                           n_mels: int = 128) -> jnp.ndarray:
    """One fused program: audio -> mel -> onset-strength envelope (T,)."""
    mel = dsp.melspectrogram_t(y, sr, n_fft, hop_length, n_mels)
    return onset_strength_t(mel)


def pick_onsets(envelope: np.ndarray, sr: int, hop_length: int,
                pre_max_ms: float = 30.0, post_max_ms: float = 0.0,
                pre_avg_ms: float = 100.0, post_avg_ms: float = 100.0,
                delta: float = 0.07, wait_ms: float = 30.0,
                ) -> np.ndarray:
    """Peak-pick onset frames from the envelope (host, librosa-style).

    A frame is an onset iff it is the max of [t-pre_max, t+post_max], at
    least `delta` above the mean of [t-pre_avg, t+post_avg], and at least
    `wait` frames after the previous onset.  Returns frame indices.

    Note: every window size is floored at 1 frame, so the default
    post_max_ms=0.0 still requires env[t] >= env[t+1] — onsets land on
    the local flux PEAK, one frame later than a pure rising-edge pick.
    This inclusive-window convention is what every downstream snap/birth
    gate was truth-measured against (VALIDATION.md); do not "fix" it to
    the exclusive-slice reading without re-running those sweeps.
    """
    env = np.asarray(envelope, np.float64)
    T = len(env)
    if T == 0:
        return np.zeros(0, np.int64)
    spf = hop_length / sr * 1000.0
    pre_max = max(int(round(pre_max_ms / spf)), 1)
    post_max = max(int(round(post_max_ms / spf)), 1)
    pre_avg = max(int(round(pre_avg_ms / spf)), 1)
    post_avg = max(int(round(post_avg_ms / spf)), 1)
    wait = max(int(round(wait_ms / spf)), 1)

    env_n = env / max(env.max(), 1e-10)

    def _window(arr, pre, post, pad, reducer):
        """Sliding [t-pre, t+post] reduction via a strided window view."""
        w = pre + post + 1
        padded = np.concatenate([np.full(pre, pad), arr, np.full(post, pad)])
        view = np.lib.stride_tricks.sliding_window_view(padded, w)
        return reducer(view, axis=1)

    # edge windows are CLIPPED in the sequential formulation, so the mean
    # pad must not bias it: use NaN + nanmean (max pads with -inf)
    win_max = _window(env_n, pre_max, post_max, -np.inf, np.max)
    win_mean = _window(env_n, pre_avg, post_avg, np.nan, np.nanmean)
    candidate = (env_n >= win_max) & (env_n >= win_mean + delta) & (env_n > 0)

    # the `wait` debounce is inherently sequential, but only over the few
    # candidate frames
    onsets = []
    last = -wait - 1
    for t in np.where(candidate)[0]:
        if t - last >= wait:
            onsets.append(t)
            last = t
    return np.asarray(onsets, np.int64)


def pick_onsets_incremental(envelope: np.ndarray, sr: int, hop_length: int,
                            state: dict | None,
                            pre_max_ms: float = 30.0,
                            post_max_ms: float = 0.0,
                            pre_avg_ms: float = 100.0,
                            post_avg_ms: float = 100.0,
                            delta: float = 0.07, wait_ms: float = 30.0,
                            ) -> tuple:
    """pick_onsets with an append-only cache: (onsets, new_state).

    A live poll re-picked onsets over the WHOLE accumulated envelope
    (O(T) sliding windows + nanmean — the largest remaining linear term
    of every live poll at 10 minutes).  The envelope only ever
    grows (the transcribers append immutable tile rows), so when the
    global max is unchanged every window that never saw the old padded
    right edge is provably identical: positions t < S := T_prev - post
    read only real frames [t-pre, t+post] ⊆ [0, T_prev).  This
    recomputes candidates from S - pre on (their windows never touch the
    slice's left pad) with the SAME normalization scale and window
    reducers, and continues the wait debounce from the last frozen onset
    — the result is ELEMENT-IDENTICAL to the full pick_onsets, pinned by
    tests/test_onsets_incremental.py at every appended step.

    A new global max rescales every normalized value, and the first call
    has no state: both fall back to the full computation.  ``state`` is
    opaque; pass None initially and the previous return value after.
    """
    env = np.asarray(envelope, np.float64)
    T = len(env)
    if T == 0:
        return np.zeros(0, np.int64), None
    spf = hop_length / sr * 1000.0
    pre_max = max(int(round(pre_max_ms / spf)), 1)
    post_max = max(int(round(post_max_ms / spf)), 1)
    pre_avg = max(int(round(pre_avg_ms / spf)), 1)
    post_avg = max(int(round(post_avg_ms / spf)), 1)
    wait = max(int(round(wait_ms / spf)), 1)
    params = (pre_max, post_max, pre_avg, post_avg, wait, delta)
    m = env.max()
    pre = max(pre_max, pre_avg)
    post = max(post_max, post_avg)
    if (state is not None and state["params"] == params
            and state["T"] <= T and state["m"] == m
            and state["T"] - post > 0):
        if state["T"] == T:
            return state["onsets"], state
        S = state["T"] - post
        lo = S - pre if S - pre > 0 else 0
        prev = state["onsets"]
        prefix = prev[prev < S]
        seg = env[lo:] / max(m, 1e-10)  # same scale expression as the full

        def _window(arr, p, q, pad, reducer):
            w = p + q + 1
            padded = np.concatenate([np.full(p, pad), arr, np.full(q, pad)])
            view = np.lib.stride_tricks.sliding_window_view(padded, w)
            return reducer(view, axis=1)

        win_max = _window(seg, pre_max, post_max, -np.inf, np.max)
        win_mean = _window(seg, pre_avg, post_avg, np.nan, np.nanmean)
        cand = (seg >= win_max) & (seg >= win_mean + delta) & (seg > 0)
        last = int(prefix[-1]) if len(prefix) else -wait - 1
        out = []
        for t in (np.where(cand[S - lo:])[0] + S).tolist():
            if t - last >= wait:
                out.append(t)
                last = t
        onsets = np.concatenate([prefix, np.asarray(out, np.int64)])
    else:
        onsets = pick_onsets(env, sr, hop_length, pre_max_ms, post_max_ms,
                             pre_avg_ms, post_avg_ms, delta, wait_ms)
    return onsets, {"T": T, "m": m, "onsets": onsets, "params": params}


def split_events_at_onsets(events: list, onsets: np.ndarray,
                           min_frames: int = 2,
                           tail_frames: int | None = None) -> list:
    """Split note events whose span contains an interior onset — re-attacks
    of the same pitch that pitch-only segmentation merges (driver config 2:
    onset detection + RMS dynamic-velocity mapping).

    ``tail_frames`` (default: min_frames) is the minimum length of the
    piece AFTER a cut.  Pass the pitch tracker's lock-lag there (~100 ms
    for pYIN) to reject cuts near the event END: an onset that close to
    the end is the NEXT note's attack bleeding into this event's
    overhanging voicing tail, not a re-attack — splitting there mints a
    phantom stub of the old pitch covering the new note's attack frames
    (measured on the scale track: a 3-frame note-62 stub at the note-64
    boundary) and the stub then blocks snap_starts_to_onsets from
    claiming the onset for the real next note."""
    if len(onsets) == 0:
        return events
    if tail_frames is None:
        tail_frames = min_frames
    # onsets arrive ascending (pick_onsets emits peak indices in order);
    # searchsorted restricts each event to its own onset window — the old
    # full scan per event was O(events x onsets) and dominated the LIVE
    # poll cost on long sessions (profiled round 3: 0.52 s of a 0.65 s
    # poll at 5 min was this loop's 1.45M generator steps)
    ons = np.asarray(onsets, np.int64)
    out = []
    # keep each cut at least min_frames from BOTH the event bounds and
    # the previous accepted cut, so no sub-minimum segment is created.
    # Strict lower bound: a segment [prev, o-1] has duration
    # (end - start) == o - prev - 1, so o == prev + min_frames would
    # emit a segment one frame below the caller's minimum.  Both window
    # bounds are ONE vectorized searchsorted over all events (identical
    # indices to the per-event calls they replace).
    starts_a = np.fromiter((e["start"] for e in events), np.int64,
                           len(events))
    ends_a = np.fromiter((e["end"] for e in events), np.int64, len(events))
    los = np.searchsorted(ons, starts_a + min_frames, side="right")
    his = np.searchsorted(ons, ends_a - tail_frames, side="right")
    for e, lo, hi in zip(events, los.tolist(), his.tolist()):
        cuts = []
        prev = e["start"]
        for o in ons[lo:hi].tolist():
            if prev + min_frames < o:
                cuts.append(o)
                prev = o
        if not cuts:
            out.append(e)
            continue
        bounds = [e["start"]] + cuts + [e["end"] + 1]
        for i in range(len(bounds) - 1):
            seg = dict(e)
            seg["start"], seg["end"] = bounds[i], bounds[i + 1] - 1
            out.append(seg)
    return out
