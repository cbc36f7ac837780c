"""The fused device analyze step — the framework's hot path.

One jitted XLA program per (sample-count bucket, config):

    y ──► frames ──► |STFT|² (matmul-DFT) ──► mel ──► dB ──► rake mask
      └─► pYIN frames ──► CMNDF ──► trough probs ──► observations ─► Viterbi
      └─► RMS

plus, for the financial engine, the guitar-specific filters and the full
financial trend/articulation analysis — all inside the same program so
nothing round-trips to host between stages (the reference runs each stage as
a separate librosa/NumPy pass, SURVEY.md §3.1/§3.3).

Input lengths are bucketed to a 32-steps-per-octave grid (<= ~3.2% padding;
see bucket_length) so recompilation is rare; callers truncate the returned
frame arrays to ``n_frames(true_length)``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core import dsp, masks, trend
from aegis_tpu.core.pyin import extract_pyin_frames, pyin_from_frames

MIN_BUCKET = 1 << 16  # ~3 s @ 22050


def bucket_length(n: int) -> int:
    """Smallest padded length >= n on a 32-steps-per-octave grid.

    Pure power-of-two buckets padded a 60 s track by 58%, all of it
    uploaded and computed.  Sub-octave
    steps of 2^(k-6) bound padding at ~3.2% above 2^17 samples (~6 s);
    below that the 2^12 grid floor (which caps the count of distinct
    compiled programs for short clips) raises the worst case to 6.25%,
    ~4k samples — under 0.2 s of extra int16 upload either way.  One
    compiled program per length actually used, warmed by the persistent
    compile cache."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    g = 1 << max((n - 1).bit_length() - 6, 12)
    return -(-n // g) * g


def pad_to_bucket(y: np.ndarray) -> np.ndarray:
    b = bucket_length(len(y))
    if b == len(y):
        return y
    return np.pad(y, (0, b - len(y)))


def reflect_head(x: np.ndarray, ctx: int, half_window: int,
                 true_len: Optional[int] = None) -> np.ndarray:
    """Track-head left context for a FIRST tile: the offline frame_signal
    'reflect' pad convention (x[1..m] reversed, m bounded by the window
    half and the true track length) placed at the tail of a ``ctx``-wide
    zero pad.  ONE definition shared by the offline poly turbo path and
    the live streaming transcribers — the streamed==offline parity tests
    depend on the two conventions staying byte-identical.  Works on 1-D
    samples or a (B, n) batch (last axis = time)."""
    L = x.shape[-1] if true_len is None else true_len
    m = min(half_window, max(L - 1, 0))
    out = np.zeros(x.shape[:-1] + (ctx,), x.dtype)
    if m:
        out[..., ctx - m:] = x[..., m:0:-1]
    return out


def quantize_pcm16(y: np.ndarray):
    """ONE track -> (int16 PCM, dequant scale float): the per-track
    peak-scaled transport convention every device ingest path shares
    (engine.turbo.quantize_tracks is the batched/padded variant built on
    the same math).  A silent track returns scale 0.0."""
    y = np.asarray(y)
    peak = float(np.max(np.abs(y))) if y.size else 0.0
    if peak <= 0:
        return np.zeros(y.shape, np.int16), 0.0
    return np.round(y * (32767.0 / peak)).astype(np.int16), peak / 32767.0


# Block size for the int8 block-float transport.  1024 samples = 46 ms at
# 22050 — short against a plucked-string decay, so each block's peak scale
# tracks the envelope and the quantization floor stays ~42 dB below the
# LOCAL signal level, not the track peak.  Must divide every bucket length
# (bucket_length returns multiples of 4096).
PCM8_BLOCK = 1024


def quantize_pcm8(y: np.ndarray):
    """ONE bucket-padded track -> (int8 PCM, per-block float32 scales):
    block-floating-point transport at HALF the int16 bytes (+0.4% scale
    overhead).

    Accuracy (measured 2026-08-18, CPU oracle, block sizes 512/1024/2048):
    note-event F1 = 1.0000 vs float ingest on ALL gating clips — KS 22k/44k,
    scale track, and the 60 s bench track at exact 152/152 events, v1 AND
    financial.  Per-block peak scaling keeps the noise floor pinned to the
    local envelope; the all-positive round cannot exceed |127| so no clip
    step is needed.  Silent blocks return scale 0.0."""
    y = np.asarray(y, np.float32)
    if len(y) % PCM8_BLOCK:
        raise ValueError(f"int8 transport needs len % {PCM8_BLOCK} == 0 "
                         f"(bucket-pad first), got {len(y)}")
    b = y.reshape(-1, PCM8_BLOCK)
    peak = np.abs(b).max(axis=1)
    q = np.round(b * (127.0 / np.maximum(peak[:, None], 1e-30)))
    return q.astype(np.int8).reshape(-1), (peak / 127.0).astype(np.float32)


# Block size for the int4 packed block-float transport.  Much smaller than
# PCM8_BLOCK: with only ±7 quantization levels the noise floor sits
# ~19 dB under the block peak, so the scale must hug the local envelope
# tighter.  Swept offline 2026-08-19 (CPU oracle, all four gating clips,
# v1 AND financial): 128 scores F1 1.0000 everywhere with exact event
# counts; 256 and 512 each mint a spurious event on the 44.1 kHz KS clip.
# Must divide every bucket length and be even (two samples pack a byte).
PCM4_BLOCK = 128


def quantize_pcm4(y: np.ndarray, block: int = PCM4_BLOCK):
    """ONE bucket-padded track -> (packed uint8 nibble pairs of length
    len(y)//2, per-block float32 scales): int4 block-floating-point
    transport at a QUARTER of the int16 bytes (+1.6% scale overhead at
    block=256).  Sample 2i rides the LOW nibble of byte i, sample 2i+1
    the HIGH nibble, two's-complement in [-7, 7].

    Halves the int8 upload again.  OPT-IN, not the default: the ~19 dB noise floor is transparent on every GATING clip
    (F1 1.0000, exact counts, v1 AND financial) but measurably lossy
    off-gate — fresh bench seeds flip ~1 event per 70, and the
    reverb-wash preset mints 1-2 extra events (echo-guard decisions sit
    on ~0.1 dB margins); int8 measures 1.0000 on all of those
    (VALIDATION.md §A).  For throughput-over-fidelity deployments:
    run_analyze(..., transport="int4")."""
    y = np.asarray(y, np.float32)
    if len(y) % block or block % 2:
        raise ValueError(f"int4 transport needs even block | len "
                         f"({block}, {len(y)})")
    b = y.reshape(-1, block)
    peak = np.abs(b).max(axis=1)
    q = np.round(b * (7.0 / np.maximum(peak[:, None], 1e-30)))
    qi = q.astype(np.int8).reshape(-1)
    packed = ((qi[0::2] & 0xF) | ((qi[1::2] & 0xF) << 4)).astype(np.uint8)
    return packed, (peak / 7.0).astype(np.float32)


def dequant_transport(y: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """Device-side dequant shared by the packed programs: a scalar ``scale``
    is the int16 (or float32 pass-through) convention; a rank-1 ``scale``
    selects block-float — int8 (one scale per PCM8_BLOCK samples), or int4
    nibble pairs (quantize_pcm4) when ``y`` arrives as packed uint8.
    Rank and dtype are static under jit, so each transport traces its own
    program.

    (An int6 byte-triple variant was built and removed: it saved only
    ~0.3 MB on a 60 s upload while already flipping one wet-track event
    timing; see VALIDATION.md §A.)"""
    if y.dtype == jnp.uint8:  # packed int4 nibble pairs
        b = y.astype(jnp.int32)
        lo = b & 0xF
        hi = (b >> 4) & 0xF
        lo = lo - jnp.where(lo >= 8, 16, 0)
        hi = hi - jnp.where(hi >= 8, 16, 0)
        yf = jnp.stack([lo, hi], axis=-1).reshape(-1).astype(jnp.float32)
        return (yf.reshape(scale.shape[0], -1) * scale[:, None]).reshape(-1)
    y = y.astype(jnp.float32)
    if scale.ndim == 1:
        return (y.reshape(scale.shape[0], -1) * scale[:, None]).reshape(-1)
    return y * scale


@functools.partial(jax.jit, static_argnames=("audio", "pyin_cfg"))
def analyze_program(
    y: jnp.ndarray,
    rake_sensitivity: jnp.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
) -> Dict[str, jnp.ndarray]:
    """v1 Perception Phase (reference aegis_engine.py:41-75) as one program.

    Returns time-major arrays; f0 is NaN on unvoiced frames.
    """
    y = y.astype(jnp.float32)
    mel = dsp.melspectrogram_t(y, audio.sample_rate, audio.n_fft, audio.hop_length,
                               audio.n_mels)
    mel_db = dsp.power_to_db(mel)
    rake = masks.detect_rake(mel_db, audio.hop_length, audio.sample_rate,
                             rake_sensitivity)

    frames = extract_pyin_frames(y, audio.hop_length, pyin_cfg)
    f0, voiced, probs = pyin_from_frames(frames, audio.sample_rate,
                                         audio.hop_length, pyin_cfg)
    rms_ = dsp.rms(y, pyin_cfg.frame_length, audio.hop_length)
    from aegis_tpu.core.cqt import onset_strength_t

    onset_env = onset_strength_t(mel)  # same fused mel, ~free
    return {
        "mel_db": mel_db,
        "rake_mask": rake,
        "f0": f0,
        "voiced_flag": voiced,
        "voiced_probs": probs,
        "rms": rms_,
        "onset_env": onset_env,
    }


def financial_tail(base: Dict[str, jnp.ndarray], audio: AudioConfig,
                   use_guitar_filters: bool = True) -> Dict[str, jnp.ndarray]:
    """Phases 3.5-4a on top of ANY base analysis dict with
    {f0, voiced_flag, voiced_probs, rake_mask, mel_db}: guitar-specific
    filters plus the financial trend/articulation/slide/confidence stack.
    Shared by the pYIN and neural (models/pitchnet.py) financial programs."""
    f0, voiced, rake = base["f0"], base["voiced_flag"], base["rake_mask"]
    mel_db = base["mel_db"]

    if use_guitar_filters:
        f0, voiced = masks.filter_subharmonic(f0, voiced, fmin_hz=82.4)
        rake = masks.enhance_rake(mel_db, audio.hop_length, audio.sample_rate, rake)
        mute = masks.detect_palm_mute(mel_db, audio.hop_length, audio.sample_rate)
        voiced = voiced & ~mute
        dist = masks.distortion_score(mel_db)
    else:
        mute = jnp.zeros_like(rake)
        dist = jnp.float32(0.0)

    f0_clean = jnp.where(voiced, f0, jnp.nan)
    fin = trend.analyze_pitch_financial(f0_clean)
    combined_conf = base["voiced_probs"] * 0.5 + fin["confidence"] * 0.5
    adaptive_thr = trend.adaptive_confidence_threshold(combined_conf)

    return {
        **base,
        "f0": f0,
        "voiced_flag": voiced,
        "rake_mask": rake,
        "mute_mask": mute,
        "distortion_score": dist,
        "trend": fin["trend"],
        "artic_codes": fin["articulations"],
        "slide_codes": fin["slides"],
        "financial_confidence": fin["confidence"],
        "combined_confidence": combined_conf,
        "adaptive_threshold": adaptive_thr,
    }


@functools.partial(jax.jit, static_argnames=("audio", "pyin_cfg", "use_guitar_filters"))
def analyze_financial_program(
    y: jnp.ndarray,
    rake_sensitivity: jnp.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    use_guitar_filters: bool = True,
) -> Dict[str, jnp.ndarray]:
    """v2 pipeline phases 1-4a on device (reference
    aegis_engine_financial.py:73-188 + financial_analysis.py:368-423):
    mel/rake/pYIN/RMS plus guitar-specific filters and the financial trend,
    articulation, slide and confidence analysis."""
    base = analyze_program(y, rake_sensitivity, audio, pyin_cfg)
    return financial_tail(base, audio, use_guitar_filters)


# Per-frame output rows packed alongside mel_db into ONE device buffer: one
# device->host transfer instead of 14, each of which pays its own latency.
# Scalars ride along broadcast to (T,).
_V1_ROWS = ("f0", "voiced_flag", "voiced_probs", "rms", "rake_mask",
            "onset_env")
_FIN_ROWS = _V1_ROWS + (
    "mute_mask", "trend", "artic_codes", "slide_codes",
    "financial_confidence", "combined_confidence",
    "adaptive_threshold", "distortion_score",
)
# streamed-slab rows: the financial per-tile (local) outputs without the
# whole-track trend stack, which run_analyze_streamed computes afterwards in
# one tiny full-track device pass (engine.turbo)
_GTR_ROWS = _V1_ROWS + ("mute_mask", "dist_high_sum", "dist_total_sum")
_BOOL_ROWS = {"voiced_flag", "rake_mask", "mute_mask"}
_INT_ROWS = {"artic_codes": np.int8, "slide_codes": np.int8}


def _pack(out: Dict[str, jnp.ndarray], rows, include_mel: bool) -> jnp.ndarray:
    T = out["f0"].shape[0]
    cols = [jnp.broadcast_to(out[k].astype(jnp.float32), (T,))[:, None]
            for k in rows]
    head = [out["mel_db"]] if include_mel else []
    return jnp.concatenate(head + cols, axis=1)


@functools.partial(jax.jit, static_argnames=("audio", "pyin_cfg",
                                             "include_mel"))
def analyze_program_packed(y, scale, rake_sensitivity, audio, pyin_cfg,
                           include_mel=True):
    y = dequant_transport(y, scale)
    return _pack(analyze_program(y, rake_sensitivity, audio, pyin_cfg),
                 _V1_ROWS, include_mel)


@functools.partial(jax.jit, static_argnames=("audio", "pyin_cfg",
                                             "use_guitar_filters",
                                             "include_mel"))
def analyze_financial_program_packed(y, scale, rake_sensitivity, audio,
                                     pyin_cfg, use_guitar_filters=True,
                                     include_mel=True):
    y = dequant_transport(y, scale)
    return _pack(
        analyze_financial_program(y, rake_sensitivity, audio, pyin_cfg,
                                  use_guitar_filters),
        _FIN_ROWS, include_mel,
    )


def _unpack(buf: np.ndarray, rows, n_mels: int) -> Dict[str, np.ndarray]:
    """Packed buffer (..., n_mels+len(rows)) -> named arrays.  Works for the
    single-track (T, C) layout and the turbo (B, T, C) layout alike."""
    result: Dict[str, np.ndarray] = (
        {"mel_db": buf[..., :n_mels]} if n_mels else {})
    for i, k in enumerate(rows):
        col = buf[..., n_mels + i]
        if k in _BOOL_ROWS:
            result[k] = col > 0.5
        elif k in _INT_ROWS:
            result[k] = col.astype(_INT_ROWS[k])
        elif k in ("adaptive_threshold", "distortion_score"):
            # per-track scalar: (B,) in the batch layout, float in the
            # single-track layout
            result[k] = (col[:, 0].astype(np.float32) if col.ndim == 2
                         else np.float32(col.reshape(-1)[0]))
        else:
            result[k] = col.astype(np.float64) if k == "f0" else col
    return result


def dispatch_analyze(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    financial: bool = False,
    use_guitar_filters: bool = True,
    fetch_mel: bool = True,
    transport: str = "int8",
):
    """Async half of run_analyze: bucket-pad, upload, dispatch the device
    program, and return an opaque handle WITHOUT blocking — JAX dispatch is
    asynchronous, so multiple tracks can be in flight before any fetch.
    Resolve with fetch_analyze(handle).
    """
    true_frames = audio.n_frames(len(y))
    y_pad = pad_to_bucket(np.asarray(y, np.float32))
    if transport == "int8":
        y8, s8 = quantize_pcm8(y_pad)
        y_dev = jnp.asarray(y8)
        scale = jnp.asarray(s8)
    elif transport == "int4":
        y4, s4 = quantize_pcm4(y_pad)
        y_dev = jnp.asarray(y4)
        scale = jnp.asarray(s4)
    elif transport == "int16":
        y16, s = quantize_pcm16(y_pad)
        y_dev = jnp.asarray(y16)
        scale = jnp.float32(s)
    elif transport == "float32":
        y_dev = jnp.asarray(y_pad)
        scale = jnp.float32(1.0)
    else:
        raise ValueError(f"unknown transport {transport!r} "
                         "(int8 | int4 | int16 | float32)")
    rs = jnp.float32(rake_sensitivity)
    if financial:
        packed = analyze_financial_program_packed(
            y_dev, scale, rs, audio, pyin_cfg, use_guitar_filters, fetch_mel)
        rows = _FIN_ROWS
    else:
        packed = analyze_program_packed(y_dev, scale, rs, audio, pyin_cfg,
                                        fetch_mel)
        rows = _V1_ROWS
    return packed, rows, true_frames, (audio.n_mels if fetch_mel else 0)


def fetch_analyze(handle) -> Dict[str, np.ndarray]:
    """Blocking half: transfer the packed buffer and unpack it."""
    packed, rows, true_frames, n_mels = handle
    return _unpack(np.asarray(packed)[:true_frames], rows, n_mels)


def run_analyze(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    financial: bool = False,
    use_guitar_filters: bool = True,
    fetch_mel: bool = True,
    transport: str = "int8",
) -> Dict[str, np.ndarray]:
    """Host wrapper: bucket-pad, run the device program, fetch the single
    packed buffer, truncate to the true frame count, return NumPy arrays.

    transport="int8" (default) uploads block-floating-point 8-bit PCM — a
    QUARTER of float32's bytes (quantize_pcm8: per-1024-sample peak scales
    keep the noise floor ~42 dB under the local envelope; measured
    note-event F1 = 1.0000 vs float ingest on every gating clip incl. the
    60 s bench track at exact 152/152 events).  "int16" is the
    conservative -96 dBFS variant; pass "float32" for bit-exact ingest;
    "int4" (quantize_pcm4) halves the upload again but is NOT
    event-transparent off the gating clips — opt-in only, see its
    docstring.  fetch_mel=False drops the (T, n_mels)
    spectrogram from the device->host fetch (the reference's raw_data
    contract has no mel; aegis_engine.py:72-75) — event extraction never
    reads it.
    """
    return fetch_analyze(dispatch_analyze(
        y, audio, pyin_cfg, rake_sensitivity, financial, use_guitar_filters,
        fetch_mel, transport))
