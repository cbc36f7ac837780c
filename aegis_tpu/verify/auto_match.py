"""Auto parameter matcher: coarse-to-fine grid search over extraction
parameters, scored by synthesized-audio similarity.

Grid structure mirrors the reference (auto_matcher.py:92-269): 3x3x3 coarse
over (confidence, min-duration, sustain), then 3x3x3 fine around the winner.
Phase 2 extraction is host-vectorized and the similarity objective runs on
device (verify.similarity), so the 54 evaluations are dominated by the ADSR
synth + two STFTs each — all device work.
"""

from __future__ import annotations

import functools
import io
from typing import Callable, Dict, List, Optional

import jax
import numpy as np

from aegis_tpu.io.audio import to_mono
from aegis_tpu.io.wav import read_wav
from aegis_tpu.synth.fluidsynth import synthesize_midi
from aegis_tpu.utils.logging import get_logger
from aegis_tpu.verify.similarity import audio_similarity

log = get_logger("AutoMatcher")

COARSE_GRID = {
    "confidence_threshold": [0.2, 0.4, 0.6],
    "min_note_duration_ms": [50, 150, 250],
    "sustain_ms": [100, 300, 500],
}


def _fine_grid(best: Dict) -> Dict[str, List]:
    return {
        "confidence_threshold": [
            max(0.1, best["confidence_threshold"] - 0.1),
            best["confidence_threshold"],
            min(0.9, best["confidence_threshold"] + 0.1),
        ],
        "min_note_duration_ms": [
            max(10, best["min_note_duration_ms"] - 50),
            best["min_note_duration_ms"],
            min(500, best["min_note_duration_ms"] + 50),
        ],
        "sustain_ms": [
            max(0, best["sustain_ms"] - 100),
            best["sustain_ms"],
            min(1000, best["sustain_ms"] + 100),
        ],
    }


def _evaluate(engine, raw_data, y_orig: np.ndarray, sample_rate: int,
              conf: float, min_dur: int, sustain: int) -> float:
    buf = io.BytesIO()
    engine.extract_events(
        raw_data, buf,
        confidence_threshold=conf,
        min_note_duration_ms=int(min_dur),
        sustain_ms=int(sustain),
        midi_program=27,
    )
    midi_data = buf.getvalue()
    if len(midi_data) < 60:  # effectively empty output
        return -1.0
    wav_data = synthesize_midi(midi_data, sample_rate=sample_rate)
    if wav_data is None:
        return -1.0
    y_synth, sr = read_wav(wav_data)
    y_synth = to_mono(y_synth)
    if sr != sample_rate:
        from aegis_tpu.io.audio import resample

        y_synth = resample(y_synth, sr, sample_rate)
    return audio_similarity(y_orig, y_synth, sample_rate)


def _combo_events(engine, raw_data, conf, min_dur, sustain):
    return engine.extract_events(
        raw_data, None,
        confidence_threshold=conf,
        min_note_duration_ms=int(min_dur),
        sustain_ms=int(sustain),
    )


def _feat_mats(sample_rate, n_fft=2048):
    import jax.numpy as jnp

    from aegis_tpu.core.filters import mel_filterbank
    from aegis_tpu.verify.similarity import _chroma_matrix

    return (jnp.asarray(mel_filterbank(sample_rate, n_fft, 128).T),
            jnp.asarray(_chroma_matrix(sample_rate, n_fft)))


@functools.partial(jax.jit, static_argnames=("sample_rate",))
def _ref_feats(y_ref, sample_rate):
    """Reference-audio mel/chroma feature rows as device arrays — computed
    ONCE per auto-match call; both sweep phases reuse them (recomputing the
    ~1M-sample reference STFT per phase and re-uploading y_ref dominated
    the warm sweep time)."""
    import jax.numpy as jnp

    from aegis_tpu.core import dsp

    n_fft, hop = 2048, 512
    fb, cm = _feat_mats(sample_rate, n_fft)
    p = dsp.stft_power(y_ref, n_fft, hop)
    return (jnp.dot(p, fb, preferred_element_type=jnp.float32).ravel(),
            jnp.dot(p, cm, preferred_element_type=jnp.float32).ravel())


@functools.partial(jax.jit, static_argnames=("sample_rate", "mb", "total",
                                             "n_chunks"))
def _score_sweep(mel_r, ch_r, freqs, starts, lengths, vels, sample_rate, mb,
                 total, n_chunks):
    """(B,) similarity scores for B padded note-array combos, ONE dispatch.

    Renders each combo with the vmapped ADSR synth and scores it against the
    precomputed reference feature rows (mel + chroma cosine); lax.map over
    chunks bounds the live (chunk, nb, mb) note-buffer footprint without
    host round trips."""
    import jax.numpy as jnp

    from aegis_tpu.core import dsp
    from aegis_tpu.synth.adsr import render_notes

    n_fft, hop = 2048, 512
    fb, cm = _feat_mats(sample_rate, n_fft)

    def feats(y):
        p = dsp.stft_power(y, n_fft, hop)
        return (jnp.dot(p, fb, preferred_element_type=jnp.float32).ravel(),
                jnp.dot(p, cm, preferred_element_type=jnp.float32).ravel())

    nrm_mel = jnp.linalg.norm(mel_r)
    nrm_ch = jnp.linalg.norm(ch_r)

    def render_one(f, st, ln, v):
        n = f.shape[0]
        const = lambda val: jnp.full((n,), val, jnp.float32)  # noqa: E731
        return render_notes(f, st, ln, v, const(10.0), const(50.0),
                            const(0.7), const(100.0),
                            jnp.zeros((n,), jnp.int32), sample_rate,
                            mb, total)

    def score_chunk(args):
        f, st, ln, v = args
        synths = jax.vmap(render_one)(f, st, ln, v)  # (chunk, total)

        def one(y):
            mel, ch = feats(y)
            mel_sim = jnp.dot(mel_r, mel) / (
                nrm_mel * jnp.linalg.norm(mel) + 1e-8)
            ch_sim = jnp.dot(ch_r, ch) / (
                nrm_ch * jnp.linalg.norm(ch) + 1e-8)
            return jnp.clip(0.4 * mel_sim + 0.6 * ch_sim, 0.0, 1.0)

        return jax.vmap(one)(synths)

    b = freqs.shape[0]
    xs = tuple(a.reshape(n_chunks, b // n_chunks, *a.shape[1:])
               for a in (freqs, starts, lengths, vels))
    return jax.lax.map(score_chunk, xs).reshape(b)


def _sweep_batched(engine, raw_data, mel_r, ch_r, total, sample_rate, grid,
                   phase, progress_callback):
    """All grid combos scored in ONE device program: per-combo event lists
    (host, fast phase-2 re-extraction) are padded into (B, Nmax) note
    arrays, rendered with the vmapped ADSR synth, and scored against the
    precomputed reference feature rows — 1 dispatch per sweep instead of
    ~4 per combo (SURVEY.md §7.4: iterative grid loops become batched
    device sweeps).  ``total`` is the render length in samples (the
    reference features were computed over the same padded window).
    """
    import jax.numpy as jnp

    combos = [
        (c, d, s)
        for c in grid["confidence_threshold"]
        for d in grid["min_note_duration_ms"]
        for s in grid["sustain_ms"]
    ]
    hop = engine.hop_length
    spf = hop / sample_rate
    release_s = 0.1

    event_lists = []
    for i, (conf, min_dur, sustain) in enumerate(combos):
        if progress_callback:
            progress_callback((i + 1) / len(combos),
                              f"{phase} extract {i + 1}/{len(combos)}")
        try:
            event_lists.append(_combo_events(engine, raw_data, conf,
                                             min_dur, sustain))
        except Exception as e:
            log.warning(f"combo failed ({conf},{min_dur},{sustain}): {e}")
            event_lists.append([])

    B = len(combos)
    n_max = max(1, max(len(e) for e in event_lists))
    nb = 1
    while nb < n_max:
        nb <<= 1

    freqs = np.full((B, nb), 440.0, np.float32)
    starts = np.zeros((B, nb), np.int32)
    lengths = np.ones((B, nb), np.int32)
    vels = np.zeros((B, nb), np.float32)  # zero velocity = silent padding
    max_note = 1
    for b, evs in enumerate(event_lists):
        for j, e in enumerate(evs):
            freqs[b, j] = 440.0 * 2.0 ** ((e["note"] - 69) / 12.0)
            s = min(int(e["start"] * spf * sample_rate), total - 1)
            dur = int(((e["end"] - e["start"] + 1) * spf + release_s)
                      * sample_rate)
            dur = max(min(dur, total - s), 1)
            starts[b, j] = s
            lengths[b, j] = dur
            vels[b, j] = e["velocity"]
            max_note = max(max_note, dur)
    mb = 1 << 10
    while mb < max_note:
        mb <<= 1

    # the render materializes (chunk, nb, mb) f32 note buffers; cap the live
    # footprint (long clips with permissive grids can reach hundreds of
    # notes x multi-second sustains).  Chunking happens INSIDE one jitted
    # program via lax.map — a host-side chunk loop pays a dispatch and a
    # repeated 4 MB y_ref upload per chunk.
    budget = 256 << 20
    chunk = max(1, min(B, budget // max(nb * mb * 4, 1)))
    n_chunks = -(-B // chunk)
    b_pad = n_chunks * chunk
    if b_pad > B:  # pad with silent combos (velocity 0)
        pad = b_pad - B
        freqs = np.concatenate([freqs, np.full((pad, nb), 440.0, np.float32)])
        starts = np.concatenate([starts, np.zeros((pad, nb), np.int32)])
        lengths = np.concatenate([lengths, np.ones((pad, nb), np.int32)])
        vels = np.concatenate([vels, np.zeros((pad, nb), np.float32)])
    scores = np.asarray(_score_sweep(
        mel_r, ch_r, jnp.asarray(freqs), jnp.asarray(starts),
        jnp.asarray(lengths), jnp.asarray(vels), sample_rate, mb, total,
        n_chunks))[:B]
    scores = np.where([len(e) > 0 for e in event_lists], scores, -1.0)
    best = int(np.argmax(scores))
    if scores[best] < 0:
        return None, -1.0
    conf, min_dur, sustain = combos[best]
    return ({"confidence_threshold": conf,
             "min_note_duration_ms": int(min_dur),
             "sustain_ms": int(sustain)}, float(scores[best]))


def auto_match_parameters(
    original_audio, engine, raw_data,
    sample_rate: Optional[int] = None,
    progress_callback: Optional[Callable] = None,
    batched: Optional[bool] = None,
) -> Optional[Dict]:
    """Returns {confidence_threshold, min_note_duration_ms, sustain_ms,
    score} or None when no combination produced usable output.

    ``original_audio`` may be a path or a mono float array at engine.sr.
    ``sample_rate`` defaults to engine.sr and must MATCH it: raw_data's
    events are frame-indexed on the engine's grid, so rendering/scoring
    at a different rate would place every synthesized note at the wrong
    wall-clock position and score garbage (review finding).
    batched=None (default) uses the single-program batched sweep unless
    FluidSynth is available (whose soundfont rendering can't be batched
    on device; the sequential loop keeps the reference's objective there).
    """
    if sample_rate is None:
        sample_rate = engine.sr
    elif sample_rate != engine.sr:
        raise ValueError(
            f"sample_rate={sample_rate} != engine.sr={engine.sr}: the "
            f"comparison must run on the engine's rate (resample the "
            f"audio or build the engine at the audio's rate)")
    if isinstance(original_audio, np.ndarray):
        y_orig = original_audio[: int(sample_rate * 30)]
    else:
        from aegis_tpu.io.audio import load_audio

        y_orig, _ = load_audio(original_audio, sr=sample_rate, duration=30)

    if batched is None:
        from aegis_tpu.synth.fluidsynth import get_synthesizer

        batched = not get_synthesizer().is_available()
    if batched:
        import jax.numpy as jnp

        from aegis_tpu.core.analyze import bucket_length

        # reference features once, reused by both phases (one upload, one
        # STFT; the pow2 render pad also shrinks to the sub-octave bucket)
        total = bucket_length(len(y_orig))
        y_ref = np.zeros(total, np.float32)
        y_ref[: len(y_orig)] = y_orig
        mel_r, ch_r = _ref_feats(jnp.asarray(y_ref), sample_rate)

        coarse, score = _sweep_batched(engine, raw_data, mel_r, ch_r, total,
                                       sample_rate, COARSE_GRID, "coarse",
                                       progress_callback)
        if coarse is None:
            log.warning("no valid combination found")
            return None
        log.info(f"coarse best: {coarse} score={score:.3f}")
        fine, fine_score = _sweep_batched(engine, raw_data, mel_r, ch_r,
                                          total, sample_rate,
                                          _fine_grid(coarse), "fine",
                                          progress_callback)
        if fine is not None and fine_score >= score:
            coarse, score = fine, fine_score
        log.info(f"final best: {coarse} score={score:.3f}")
        return {**coarse, "score": score}

    log.info("coarse grid search (27 combos)")
    best_score, best_params = -1.0, None

    def sweep(grid, phase):
        nonlocal best_score, best_params
        combos = [
            (c, d, s)
            for c in grid["confidence_threshold"]
            for d in grid["min_note_duration_ms"]
            for s in grid["sustain_ms"]
        ]
        for i, (conf, min_dur, sustain) in enumerate(combos):
            if progress_callback:
                progress_callback((i + 1) / len(combos),
                                  f"{phase} {i + 1}/{len(combos)}")
            try:
                score = _evaluate(engine, raw_data, y_orig, sample_rate,
                                  conf, min_dur, sustain)
            except Exception as e:
                log.warning(f"combo failed ({conf},{min_dur},{sustain}): {e}")
                continue
            if score > best_score:
                best_score = score
                best_params = {
                    "confidence_threshold": conf,
                    "min_note_duration_ms": int(min_dur),
                    "sustain_ms": int(sustain),
                }

    sweep(COARSE_GRID, "coarse")
    if best_params is None:
        log.warning("no valid combination found")
        return None
    log.info(f"coarse best: {best_params} score={best_score:.3f}")

    sweep(_fine_grid(best_params), "fine")
    log.info(f"final best: {best_params} score={best_score:.3f}")
    return {**best_params, "score": best_score}
