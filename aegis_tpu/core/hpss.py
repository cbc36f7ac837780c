"""Harmonic/percussive source separation (HPSS) on device.

An on-device stem separator (Fitzgerald 2010, the librosa.effects.hpss
algorithm family): harmonic content forms time-continuous ridges in the
spectrogram, percussive content forms frequency-continuous columns, so a
median filter along time enhances harmonics, one along frequency enhances
percussion, and soft Wiener masks split the complex STFT.

This backs the reference's Demucs wrapper (aegis_engine_core/stems.py:12-29)
when the external binary is unavailable: instead of silently returning the
original mix, the engine can strip drums/transients on the device
(synth/stems.py method="hpss"/"auto").

Design choices:
  * STFT/iSTFT are matmul-DFTs (core/filters.dft_matrices), frames built
    from contiguous slice+reshape copies (core/dsp.frame_signal) — no
    gathers.
  * The overlap-add inverse is scatter-free: with hop | n_fft the output is
    the sum of n_fft/hop statically-shifted contiguous reshapes (the exact
    adjoint of frame_signal's fast path): shifted adds, no scatter.
  * Median windows are built as stacked shifted slices and reduced with
    jnp.median (a sort over a 17-wide trailing axis — tiny).

NumPy oracle: aegis_tpu/ref/hpss_ref.py (parity-tested).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from aegis_tpu.core.dsp import frame_signal
from aegis_tpu.core.filters import dft_matrices, hann_window


def _idft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse one-sided DFT as matmul operands: frame = R @ icos - I @ isin
    (the imaginary term SUBTRACTS — Re[X_k e^{i ang}] = R cos - I sin; see
    istft) with shapes (n_bins, n_fft).  Interior bins carry the
    conjugate-symmetry factor 2."""
    n_bins = 1 + n_fft // 2
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_bins, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    icos = (w * np.cos(ang) / n_fft).astype(np.float32)
    isin = (w * np.sin(ang) / n_fft).astype(np.float32)
    return icos, isin


def stft_complex(y: jnp.ndarray, n_fft: int, hop_length: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Centered Hann STFT as (real, imag), each (T, 1+n_fft//2)."""
    cos, nsin = dft_matrices(n_fft)  # nsin is already -sin(ang)
    frames = frame_signal(y, n_fft, hop_length, "constant")
    fw = frames * jnp.asarray(hann_window(n_fft))[None, :]
    return fw @ jnp.asarray(cos), fw @ jnp.asarray(nsin)


def istft(real: jnp.ndarray, imag: jnp.ndarray, n_fft: int, hop_length: int,
          length: int, valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """Inverse STFT with Hann synthesis window and window-sum-square
    normalization, scatter-free overlap-add (requires hop | n_fft).

    ``valid`` (optional (T,) f32 0/1 mask) restricts the overlap-add — both
    the signal accumulation AND the window-sum normalization — to the first
    ``sum(valid)`` frames, making a bucket-padded run bit-consistent with an
    exact-length run of the true frame count (the window sum is then
    data-dependent, so it is accumulated on device with the same shifted
    adds instead of precomputed on host)."""
    assert n_fft % hop_length == 0, "istft fast path needs hop | n_fft"
    icos, isin = _idft_matrices(n_fft)
    win = hann_window(n_fft)
    frames = (real @ jnp.asarray(icos) - imag @ jnp.asarray(isin))
    frames = frames * jnp.asarray(win)[None, :]
    if valid is not None:
        frames = frames * valid[:, None]

    T = frames.shape[0]
    k = n_fft // hop_length
    pad = n_fft // 2  # centered framing offset
    out_len = T * hop_length + n_fft
    out = jnp.zeros(out_len, frames.dtype)
    for j in range(k):
        seg = frames[:, j * hop_length:(j + 1) * hop_length].reshape(-1)
        out = out.at[j * hop_length: j * hop_length + T * hop_length].add(seg)

    w2 = (win * win).astype(np.float32)
    if valid is None:
        # window-sum-square normalization (precomputed on host: same
        # shifted accumulation of win^2 — data-independent)
        wss_np = np.zeros(out_len, np.float32)
        for t in range(T):
            wss_np[t * hop_length: t * hop_length + n_fft] += w2
        wss = jnp.asarray(np.maximum(wss_np, 1e-8))
    else:
        w2f = valid[:, None] * jnp.asarray(w2)[None, :]  # (T, n_fft)
        wss = jnp.zeros(out_len, jnp.float32)
        for j in range(k):
            seg = w2f[:, j * hop_length:(j + 1) * hop_length].reshape(-1)
            wss = wss.at[j * hop_length:
                         j * hop_length + T * hop_length].add(seg)
        wss = jnp.maximum(wss, 1e-8)
    out = out / wss
    return out[pad: pad + length]


def _median_along(x: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """Running median of odd window `size` along `axis`, edge-padded —
    built from `size` statically shifted slices (no gathers)."""
    half = size // 2
    pads = [(0, 0), (0, 0)]
    pads[axis] = (half, half)
    xp = jnp.pad(x, pads, mode="edge")
    n = x.shape[axis]
    slices = []
    for j in range(size):
        sl = [slice(None), slice(None)]
        sl[axis] = slice(j, j + n)
        slices.append(xp[tuple(sl)])
    return jnp.median(jnp.stack(slices, axis=-1), axis=-1)


@functools.partial(jax.jit, static_argnames=("n_fft", "hop_length",
                                             "kernel_time", "kernel_freq",
                                             "length"))
def hpss_program(y: jnp.ndarray, n_fft: int = 2048, hop_length: int = 512,
                 kernel_time: int = 17, kernel_freq: int = 17,
                 power: float = 2.0, length: int | None = None,
                 n_frames: jnp.ndarray | None = None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One fused program: STFT -> dual median filters -> soft masks ->
    two iSTFTs.  Returns (harmonic, percussive) waveforms of `length`.

    ``n_frames`` (optional traced int) marks how many leading STFT frames
    are real audio: frames past it are replaced by edge replication inside
    the time median and excluded from the overlap-add, so a bucket-padded
    call produces EXACTLY the output of an exact-length run on the first
    ``n_frames`` frames (one compiled program per bucket, any true length)."""
    y = y.astype(jnp.float32)
    n = length if length is not None else y.shape[0]
    real, imag = stft_complex(y, n_fft, hop_length)
    S = jnp.sqrt(real * real + imag * imag)  # (T, F) magnitude

    valid = None
    if n_frames is not None:
        T = S.shape[0]
        t_idx = jnp.arange(T)
        # replicate the last real frame over the padded tail: the time
        # median then sees the oracle's edge-padding semantics at the true
        # end of track instead of the bucket's zero frames.  Gather-free:
        # fetch the one replicated row via a one-hot matvec and select.
        onehot = (t_idx == jnp.clip(n_frames - 1, 0, T - 1)).astype(S.dtype)
        last_row = onehot @ S  # (F,)
        S = jnp.where((t_idx < n_frames)[:, None], S, last_row[None, :])
        valid = (t_idx < n_frames).astype(jnp.float32)

    H = _median_along(S, kernel_time, axis=0)   # harmonic: smooth in time
    P = _median_along(S, kernel_freq, axis=1)   # percussive: smooth in freq

    Hp = H ** power
    Pp = P ** power
    denom = Hp + Pp + 1e-10
    mh = Hp / denom
    mp = Pp / denom

    y_h = istft(real * mh, imag * mh, n_fft, hop_length, n, valid)
    y_p = istft(real * mp, imag * mp, n_fft, hop_length, n, valid)
    # ONE stacked output = one device->host transfer
    return jnp.stack([y_h, y_p])


# Above this many samples the fused program's (T, F, kernel) median stacks
# get large (~17x the spectrogram); process in exact overlapping slabs.
_SLAB_SAMPLES = 1 << 21  # ~95 s @ 22050


def hpss(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512,
         kernel_time: int = 17, kernel_freq: int = 17,
         power: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: bucket-pad (compile-cache friendly), int16 transport,
    one packed (2, n) fetch.

    The true frame count rides into the program as a traced ``n_frames``,
    so the bucket's zero tail never reaches the time median or the
    overlap-add: the result equals an exact-length hpss_program run (which
    the oracle parity test pins) for ANY length, while every track in a
    bucket shares one compiled program.  Tracks longer than ~95 s run as overlapping
    slabs with a halo of (kernel_time//2)*hop + 2*n_fft samples: a kept
    sample depends on frames within n_fft/hop of it, whose median context
    reaches kernel_time//2 frames further, whose analysis windows reach
    n_fft/2 further still — the halo covers that whole chain.  Slab starts
    are hop-aligned (so slab frames sit on the SAME grid as the unsliced
    run) and the whole track is quantized with ONE int16 scale, so every
    kept sample sees the identical median context, overlap-add window sum,
    and transport quantization as the unsliced program (exact, bounded
    memory)."""
    from aegis_tpu.core.analyze import pad_to_bucket, quantize_pcm16

    y = np.asarray(y, np.float32)
    n = len(y)
    # ONE track-global scale: per-slab peaks would quantize each slab on a
    # different int16 grid than the unsliced run
    y16_full, scale = quantize_pcm16(y)

    def run(seg16: np.ndarray) -> np.ndarray:
        true_len = len(seg16)
        seg_pad = pad_to_bucket(seg16)
        y_dev = jnp.asarray(seg_pad).astype(jnp.float32) * jnp.float32(scale)
        hp = hpss_program(y_dev, n_fft, hop_length, kernel_time,
                          kernel_freq, power, length=len(seg_pad),
                          n_frames=jnp.int32(1 + true_len // hop_length))
        return np.asarray(hp)[:, :true_len]

    if n <= _SLAB_SAMPLES:
        out = run(y16_full)
        return out[0][:n], out[1][:n]

    halo = (kernel_time // 2) * hop_length + 2 * n_fft  # hop | n_fft (istft)
    # step must be a hop multiple: a slab starting off-grid would put every
    # frame on a shifted grid and break exactness for non-2^k hops
    step = ((_SLAB_SAMPLES - 2 * halo) // hop_length) * hop_length
    parts = []
    for start in range(0, n, step):
        a = max(start - halo, 0)
        b = min(start + step + halo, n)
        seg_out = run(y16_full[a:b])
        keep_lo = start - a
        keep_hi = keep_lo + min(step, n - start)
        parts.append(seg_out[:, keep_lo:keep_hi])
    out = np.concatenate(parts, axis=1)
    return out[0][:n], out[1][:n]
