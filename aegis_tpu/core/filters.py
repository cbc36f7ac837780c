"""Host-side constant generation: windows and mel filterbanks.

Pure NumPy (no JAX import) so both the CPU oracle (aegis_tpu.ref) and the
device pipeline (aegis_tpu.core) share bit-identical constants.

The mel filterbank follows the Slaney formulation (the default used by the
reference's librosa.feature.melspectrogram calls, aegis_engine.py:25): 128
triangular filters, Slaney area normalization, fmin=0, fmax=sr/2.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = _F_SP * mel
    log_region = mel >= _MIN_LOG_MEL
    freq = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mel, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freq,
    )
    return freq


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window.  periodic=True matches scipy.signal.get_window('hann', n,
    fftbins=True), the STFT default."""
    m = n if periodic else n - 1
    if m <= 0:
        return np.ones(n, dtype=np.float32)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / m)
    return w.astype(np.float32)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1+n_fft//2)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    weights = np.zeros((n_mels, n_bins), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def cqt_filterbank(
    sr: int,
    n_fft: int,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.70319566257483,  # C1
) -> np.ndarray:
    """Pseudo-CQT projection matrix, shape (n_bins, 1+n_fft//2).

    Triangular filters centered at the log-spaced constant-Q frequencies
    f_k = fmin * 2^(k/bpo), with neighbors as band edges (the shape of
    librosa's pseudo-CQT response).  Applied to |STFT|^2 as one matmul —
    the device replacement for the reference's librosa chroma_cqt path
    (auto_matcher.py:51-85) and the polyphonic salience front end.
    """
    n_fft_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft_bins)
    k = np.arange(n_bins + 2) - 1.0  # one extra edge on each side
    centers = fmin * 2.0 ** (k / bins_per_octave)

    weights = np.zeros((n_bins, n_fft_bins), dtype=np.float64)
    for i in range(n_bins):
        lo, mid, hi = centers[i], centers[i + 1], centers[i + 2]
        up = (fft_freqs - lo) / max(mid - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - mid, 1e-9)
        weights[i] = np.maximum(0.0, np.minimum(up, down))
        ssum = weights[i].sum()
        if ssum > 0:
            weights[i] /= ssum
        else:
            # Narrow low-frequency triangles can fall between coarse FFT bins
            # (e.g. F#2 at sr=44100/n_fft=2048); give the row minimum support
            # at the nearest bin so every CQT semitone stays detectable.
            weights[i, int(np.argmin(np.abs(fft_freqs - mid)))] = 1.0
    return weights.astype(np.float32)


def chroma_fold(n_bins: int, bins_per_octave: int = 12,
                fmin_midi: float = 24.0) -> np.ndarray:
    """(12, n_bins) fold of CQT bins into pitch classes.

    fmin_midi: MIDI number of CQT bin 0 (C1 = 24)."""
    fold = np.zeros((12, n_bins), dtype=np.float32)
    for b in range(n_bins):
        midi = fmin_midi + 12.0 * b / bins_per_octave
        fold[int(round(midi)) % 12, b] = 1.0
    return fold


def dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as two matmul operands: (cos, sin) with shape (n_fft, 1+n_fft//2).

    power_spectrum = (frames @ cos)**2 + (frames @ sin)**2: the STFT as two
    matmuls, an alternative to the FFT.
    """
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
