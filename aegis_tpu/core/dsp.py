"""Device DSP kernels (JAX): framing, STFT, mel spectrogram, dB, RMS.

Design notes:
  * Framing is a static gather (shapes fixed by input length); everything
    downstream is fixed-shape so XLA fuses and tiles it.
  * The STFT has two interchangeable paths: ``jnp.fft.rfft`` and a real-DFT
    matmul pair (frames @ cos, frames @ sin) that fuses with the mel
    projection into back-to-back matmuls.  Which is faster on the GPU is
    not measured yet.
  * The mel projection is a single (T, n_bins) @ (n_bins, n_mels) matmul.

CPU oracle mirror: aegis_tpu.ref.dsp_ref (parity-tested).
Behavioral contract from the reference engine: aegis_engine.py:22-27,70.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aegis_tpu.core.filters import dft_matrices, hann_window, mel_filterbank


def frame_signal(y: jnp.ndarray, frame_length: int, hop_length: int,
                 pad_mode: str = "reflect") -> jnp.ndarray:
    """Centered framing, shape (T, frame_length), T = 1 + len(y)//hop.

    When frame_length is a multiple of hop_length (the standard 2048/512
    case) frames are built from frame_length//hop_length contiguous
    slice+reshape views concatenated along the last axis — XLA lowers this
    to plain copies.  The general case uses a row gather.
    """
    pad = frame_length // 2
    mode = "reflect" if pad_mode == "reflect" else "constant"
    y_p = jnp.pad(y, pad, mode=mode)
    n_frames = 1 + y.shape[0] // hop_length
    if frame_length % hop_length == 0:
        k = frame_length // hop_length
        need = (n_frames + k - 1) * hop_length
        if y_p.shape[0] < need:  # ragged tail (len(y) not hop-aligned)
            y_p = jnp.pad(y_p, (0, need - y_p.shape[0]))
        parts = [
            y_p[i * hop_length: (i + n_frames) * hop_length].reshape(
                n_frames, hop_length)
            for i in range(k)
        ]
        return jnp.concatenate(parts, axis=1)
    idx = (
        np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    )
    return y_p[idx]


@functools.partial(jax.jit, static_argnames=("n_fft", "hop_length", "use_matmul_dft"))
def stft_power(y: jnp.ndarray, n_fft: int, hop_length: int,
               use_matmul_dft: bool = True) -> jnp.ndarray:
    """|STFT|^2, centered reflect padding, periodic Hann.  (T, 1+n_fft//2)."""
    frames = frame_signal(y, n_fft, hop_length, "reflect")
    window = jnp.asarray(hann_window(n_fft))
    fw = frames * window[None, :]
    if use_matmul_dft:
        cos_m, sin_m = dft_matrices(n_fft)
        re = jnp.dot(fw, jnp.asarray(cos_m), preferred_element_type=jnp.float32)
        im = jnp.dot(fw, jnp.asarray(sin_m), preferred_element_type=jnp.float32)
        return re * re + im * im
    spec = jnp.fft.rfft(fw, axis=-1)
    return (spec.real**2 + spec.imag**2).astype(jnp.float32)


def melspectrogram_t(y: jnp.ndarray, sr: int, n_fft: int, hop_length: int,
                     n_mels: int = 128, use_matmul_dft: bool = True) -> jnp.ndarray:
    """Power mel spectrogram in *time-major* layout (T, n_mels) — the natural
    device layout.  Transpose at the host boundary for the (n_mels, T) librosa
    layout the reference visualizers expect."""
    power = stft_power(y, n_fft, hop_length, use_matmul_dft)
    fb = jnp.asarray(mel_filterbank(sr, n_fft, n_mels).T)  # (bins, mels)
    return jnp.dot(power, fb, preferred_element_type=jnp.float32)


def power_to_db(S: jnp.ndarray, amin: float = 1e-10, top_db: float = 80.0) -> jnp.ndarray:
    """10*log10(S / max(S)), floored at max - top_db (ref=max semantics)."""
    ref = jnp.max(S)
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, S))
    log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(amin, ref))
    return jnp.maximum(log_spec, jnp.max(log_spec) - top_db)


def amplitude_to_db(S: jnp.ndarray, amin: float = 1e-5, top_db: float = 80.0) -> jnp.ndarray:
    return power_to_db(S**2, amin=amin**2, top_db=top_db)


def rms(y: jnp.ndarray, frame_length: int = 2048, hop_length: int = 512) -> jnp.ndarray:
    """Frame-wise RMS with centered zero padding, shape (T,)."""
    frames = frame_signal(y, frame_length, hop_length, "constant")
    return jnp.sqrt(jnp.mean(frames**2, axis=-1))


def hz_to_midi(hz):
    return 12.0 * jnp.log2(hz / 440.0) + 69.0


def midi_to_hz(midi):
    return 440.0 * 2.0 ** ((midi - 69.0) / 12.0)
