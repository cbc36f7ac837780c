"""Tempo estimation from the onset-strength envelope (host side).

Beyond-reference capability: the reference hard-codes 120 BPM in both MIDI
encoders (aegis_engine.py:104 tick math, aegis_engine_financial.py:203-219),
so imported MIDI never aligns with the musical grid of the source audio.
Here the device analyze program already produces an onset-strength envelope
(core.cqt.onset_strength_t rides the fused mel); tempo falls out of its
autocorrelation on host — an O(T log T) pass over a few-thousand-sample
row, cheaper than a device dispatch and fetch, so host NumPy is the right
placement (same reasoning as core.cqt.pick_onsets).

Method (librosa.beat.tempo-style global estimate):
  * autocorrelate the mean-subtracted envelope (FFT-based),
  * map lags to BPM, weight by a log-normal prior centered at
    ``start_bpm`` with ``std_bpm`` octaves of spread,
  * take the argmax and refine it with parabolic interpolation around the
    autocorrelation peak (sub-lag resolution: at 43 fps a raw lag grid is
    only ~±3 BPM near 120).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np


def parse_bpm(value) -> Union[float, str, None]:
    """Validate a user-supplied bpm (CLI flag / query param / kwarg).

    Returns None (absent), the literal string "auto", or a positive finite
    float.  Raises ValueError otherwise — one shared gate for every
    surface, because 60e6 / bpm in the MIDI tick math turns 0 into a
    ZeroDivisionError and nan into int(round(nan)) deep inside the encoder
    (these used to surface as HTTP 500s / CLI tracebacks)."""
    if value is None or value == "":
        return None
    if value == "auto":
        return "auto"
    bpm = float(value)  # ValueError on non-numeric strings
    if not np.isfinite(bpm) or bpm <= 0:
        raise ValueError(f"bpm must be a positive finite number, got {bpm}")
    return bpm


def estimate_bpm(analysis: dict, sr: int, hop_length: int) -> Optional[float]:
    """Tempo from an analysis/raw_data dict's onset envelope (None when the
    envelope is absent or carries no periodicity) — the one shared body
    behind every engine facade's ``estimate_bpm``."""
    env = analysis.get("onset_env")
    if env is None:
        return None
    return estimate_tempo(env, sr, hop_length)


def estimate_tempo(
    onset_env: np.ndarray,
    sr: int,
    hop_length: int,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    min_bpm: float = 30.0,
    max_bpm: float = 300.0,
) -> Optional[float]:
    """Global tempo estimate in BPM, or None when the envelope carries no
    periodicity (silence / a single sustained note)."""
    env = np.asarray(onset_env, np.float64)
    if env.size < 8 or not np.any(env > 0):
        return None
    fps = sr / hop_length

    x = env - env.mean()
    n = len(x)
    # FFT autocorrelation, positive lags only
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    spec = np.fft.rfft(x, nfft)
    ac = np.fft.irfft(spec * np.conj(spec), nfft)[:n]
    if ac[0] <= 0:
        return None
    ac = ac / ac[0]

    lags = np.arange(n, dtype=np.float64)
    with np.errstate(divide="ignore"):
        bpms = 60.0 * fps / np.maximum(lags, 1e-12)
    valid = (bpms >= min_bpm) & (bpms <= max_bpm) & (lags > 0)
    if not valid.any():
        return None
    prior = np.exp(-0.5 * ((np.log2(np.maximum(bpms, 1e-12))
                            - np.log2(start_bpm)) / std_bpm) ** 2)
    score = np.where(valid, ac * prior, -np.inf)
    k = int(np.argmax(score))
    if not np.isfinite(score[k]) or ac[k] <= 0:
        return None

    # parabolic interpolation on the raw autocorrelation around the peak
    lag = float(k)
    if 1 <= k < n - 1:
        a, b, c = ac[k - 1], ac[k], ac[k + 1]
        denom = a - 2 * b + c
        if abs(denom) > 1e-12:
            delta = 0.5 * (a - c) / denom
            if abs(delta) <= 1.0:
                lag = k + float(delta)
    bpm = 60.0 * fps / lag
    return float(np.clip(bpm, min_bpm, max_bpm))
