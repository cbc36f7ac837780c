"""Audio similarity features on device.

* ``audio_similarity`` — 0.4 * mel-spectrogram cosine + 0.6 * chroma cosine
  between two signals (the auto-matcher objective, reference
  auto_matcher.py:51-85; the batched sweep variant lives in
  verify.auto_match._score_sweep).  Chroma is CQT-folded like the reference's
  librosa.feature.chroma_cqt: |STFT|^2 projected onto the log-frequency
  pseudo-CQT filterbank, folded into 12 pitch classes — two matmuls
  (core.filters.cqt_filterbank / chroma_fold).
* ``note_slice_similarity`` — batched per-note similarity: 0.5 * RMS-envelope
  Pearson correlation + 0.3 * spectral-centroid similarity + 0.2 * zero-
  crossing-rate similarity (the per-note optimizer objective, reference
  per_note_optimizer.py:72-164) — evaluated for a whole (B, L) batch of
  slices in one program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aegis_tpu.core import dsp
from aegis_tpu.core.filters import chroma_fold, cqt_filterbank, mel_filterbank


def _chroma_matrix(sr: int, n_fft: int, n_bins: int = 84,
                   bins_per_octave: int = 12) -> np.ndarray:
    """(n_fft_bins, 12): CQT-folded chroma projection (pseudo-CQT filterbank
    composed with the pitch-class fold), matching the role of the
    reference's chroma_cqt features."""
    fb = cqt_filterbank(sr, n_fft, n_bins, bins_per_octave)  # (n_bins, fft)
    fold = chroma_fold(n_bins, bins_per_octave)              # (12, n_bins)
    return (fold @ fb).T.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("sr", "n_fft", "hop"))
def _similarity_program(y_a: jnp.ndarray, y_b: jnp.ndarray, sr: int,
                        n_fft: int = 2048, hop: int = 512) -> jnp.ndarray:
    pa = dsp.stft_power(y_a, n_fft, hop)
    pb = dsp.stft_power(y_b, n_fft, hop)
    fb = jnp.asarray(mel_filterbank(sr, n_fft, 128).T)
    mel_a = jnp.dot(pa, fb, preferred_element_type=jnp.float32).ravel()
    mel_b = jnp.dot(pb, fb, preferred_element_type=jnp.float32).ravel()
    mel_sim = jnp.dot(mel_a, mel_b) / (
        jnp.linalg.norm(mel_a) * jnp.linalg.norm(mel_b) + 1e-8
    )

    cm = jnp.asarray(_chroma_matrix(sr, n_fft))
    ch_a = jnp.dot(pa, cm, preferred_element_type=jnp.float32).ravel()
    ch_b = jnp.dot(pb, cm, preferred_element_type=jnp.float32).ravel()
    ch_sim = jnp.dot(ch_a, ch_b) / (
        jnp.linalg.norm(ch_a) * jnp.linalg.norm(ch_b) + 1e-8
    )
    return jnp.clip(0.4 * mel_sim + 0.6 * ch_sim, 0.0, 1.0)


def audio_similarity(y_a: np.ndarray, y_b: np.ndarray, sr: int) -> float:
    """Similarity in [0, 1]; signals truncated to the common length (>=0.5 s
    required, else 0 — matching the reference's guard)."""
    n = min(len(y_a), len(y_b))
    if n < sr * 0.5:
        return 0.0
    # bucket length to stabilize compile count
    b = 1 << 14
    while b < n:
        b <<= 1
    ya = np.zeros(b, np.float32)
    yb = np.zeros(b, np.float32)
    ya[:n] = y_a[:n]
    yb[:n] = y_b[:n]
    return float(_similarity_program(jnp.asarray(ya), jnp.asarray(yb), sr))


# --------------------------------------------------------------------------
# Batched per-note slice similarity
# --------------------------------------------------------------------------

def _frame_view(x: jnp.ndarray, frame: int, hop: int) -> jnp.ndarray:
    n = x.shape[-1]
    n_frames = max(1 + (n - frame) // hop, 1)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    return x[..., idx]


@functools.partial(jax.jit, static_argnames=("sr",))
def note_slice_similarity(orig: jnp.ndarray, synth: jnp.ndarray,
                          sr: int) -> jnp.ndarray:
    """(B, L), (B, L) -> (B,) similarity scores (see module docstring)."""
    frame = max(512, int(sr * 0.01))
    hop = frame // 2

    fo = _frame_view(orig, frame, hop)
    fs = _frame_view(synth, frame, hop)
    rms_o = jnp.sqrt(jnp.mean(fo * fo, axis=-1))
    rms_s = jnp.sqrt(jnp.mean(fs * fs, axis=-1))

    def pearson(a, b):
        am = a - a.mean(axis=-1, keepdims=True)
        bm = b - b.mean(axis=-1, keepdims=True)
        denom = jnp.sqrt((am * am).sum(-1) * (bm * bm).sum(-1))
        return jnp.where(denom > 1e-10, (am * bm).sum(-1) / jnp.maximum(denom, 1e-10), 0.0)

    std_o = rms_o.std(axis=-1)
    std_s = rms_s.std(axis=-1)
    corr = jnp.clip((pearson(rms_o, rms_s) + 1.0) / 2.0, 0.0, 1.0)
    rms_corr = jnp.where((std_o < 1e-10) & (std_s < 1e-10), 1.0,
                         jnp.where((std_o < 1e-10) | (std_s < 1e-10), 0.0, corr))

    # spectral centroid via per-frame FFT power
    n_fft = 1024
    fo2 = _frame_view(orig, n_fft, 512)
    fs2 = _frame_view(synth, n_fft, 512)
    freqs = jnp.asarray(np.linspace(0, sr / 2, 1 + n_fft // 2, dtype=np.float32))

    def centroid(frames):
        spec = jnp.fft.rfft(frames, axis=-1)
        p = spec.real**2 + spec.imag**2
        return (p * freqs).sum(-1) / jnp.maximum(p.sum(-1), 1e-10)

    c_o = centroid(fo2).mean(axis=-1)
    c_s = centroid(fs2).mean(axis=-1)
    max_c = jnp.maximum(jnp.maximum(c_o, c_s), 1.0)
    centroid_sim = jnp.clip(1.0 - jnp.abs(c_o - c_s) / max_c, 0.0, 1.0)

    # zero crossing rate
    def zcr(x):
        s = jnp.signbit(x)
        return (s[..., 1:] != s[..., :-1]).mean(axis=-1)

    z_o, z_s = zcr(orig), zcr(synth)
    max_z = jnp.maximum(jnp.maximum(z_o, z_s), 1e-10)
    zcr_sim = jnp.clip(1.0 - jnp.abs(z_o - z_s) / max_z, 0.0, 1.0)

    return jnp.clip(0.5 * rms_corr + 0.3 * centroid_sim + 0.2 * zcr_sim, 0.0, 1.0)
