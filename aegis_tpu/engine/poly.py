"""Polyphonic engine facade + folder batch sweep.

`AegisPolyEngine` is the chord-capable sibling of the monophonic engines
(driver bench config 4): CQT salience peeling on device (core.poly), host
note segmentation, onset-based re-attack splitting (config 2), chord-aware
tab fingering, and the same two-phase analyze/extract surface and MIDI
export as AegisEngine so the serve/apps layers can host it unchanged.

`transcribe_folder` is the Turbo batch entry point (config 5): a folder of
tracks is loaded with optional time-range selection (the reference's
start/end slicing, aegis_engine.py:22-27) and transcribed dispatch-ahead —
every track's fused program in flight before any fetch, each at its own
length bucket — or, given a multi-device mesh, padded to the common bucket
and run as ONE sharded batch (engine.turbo.run_analyze_batch).  Either way
the device replacement for the reference's per-file process-pool sweep.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from aegis_tpu.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu.core import poly as P
from aegis_tpu.core.cqt import pick_onsets, split_events_at_onsets
from aegis_tpu.core.events import extract_events_v1, velocity_from_db
from aegis_tpu.io.audio import load_audio
from aegis_tpu.midi.encode import events_to_midi
from aegis_tpu.midi.tabs import generate_tabs_chords
from aegis_tpu.utils.logging import get_logger

log = get_logger("PolyEngine")

def _pad_bucket(y: np.ndarray) -> np.ndarray:
    from aegis_tpu.core.analyze import bucket_length

    n = bucket_length(len(y))
    return np.pad(y, (0, n - len(y))) if n != len(y) else y


def dispatch_analyze_poly(y: np.ndarray, sr: int, n_fft: int = 2048,
                          hop_length: int = 512, n_bins: int = 84,
                          bins_per_octave: int = 12, max_voices: int = 6,
                          transport: str = "int8"):
    """Async half of the fused polyphonic analyze (mirrors
    core.analyze.dispatch_analyze): bucket-pad, upload quantized PCM,
    dispatch the packed raw-voice program and return a handle WITHOUT
    blocking, so a folder sweep can put every track in flight before
    fetching any.  Resolve with fetch_analyze_poly(handle).

    ``transport``: "int8" (default — block-float,
    core.analyze.quantize_pcm8, half the upload bytes) or "int16"
    (per-track scale).  The peel's
    argmax over near-tied saliences was the int8 accuracy risk; the
    offline sweep measured it transparent: identical truth F1 on all 32
    cases (seeds 1-12 + both octave families, 22.05 AND 44.1 kHz,
    including identical non-1.0 values — 2026-08-20, VALIDATION.md
    round 3) before the default flipped."""
    import jax.numpy as jnp

    from aegis_tpu.core.analyze import quantize_pcm8, quantize_pcm16

    true_frames = 1 + len(y) // hop_length
    # ONE packed buffer = one device->host transfer instead of four
    y_pad = _pad_bucket(np.asarray(y, np.float32))
    if transport == "int8":
        yq, s = quantize_pcm8(y_pad)
        args = (jnp.asarray(yq), jnp.asarray(s))
    else:
        yq, s = quantize_pcm16(y_pad)
        args = (jnp.asarray(yq), jnp.float32(s))
    buf = P.analyze_poly_program_packed(
        *args, sr, n_fft, hop_length, n_bins, bins_per_octave, max_voices)
    return buf, true_frames, max_voices, bins_per_octave


class _LazyPlane:
    """np.ndarray-coercible handle to the f16 CQT plane while its
    device->host transfer is still in flight.

    The plane is the poly fetch's largest part (~424 KB for 60 s), but its
    FIRST consumer is the raw-CQT recovery chain —
    everything before it (roll segmentation, onset split, snap, birth,
    rise, salience attach) needs only the core columns.  Fetching the
    plane in a background thread (np.asarray releases the GIL during the
    transfer) lets that host work overlap the transfer.  ``np.asarray``
    on this object joins the thread and unpacks — every existing consumer
    (refine_poly_events, analyze-auto, npz save, parity asserts) already
    coerces through np.asarray."""

    def __init__(self, plane_dev, true_frames: int, n_bins: int):
        import threading

        self._true_frames = true_frames
        self._n_bins = n_bins
        self._out = None
        self._buf = None
        self._err = None
        self._thread = threading.Thread(
            target=self._fetch, args=(plane_dev,), daemon=True)
        self._thread.start()

    def _fetch(self, plane_dev):
        # a failed transfer must surface at the
        # consumer's coercion with the REAL error, not a cryptic
        # NoneType crash from a silently-dead thread
        try:
            self._buf = np.asarray(plane_dev)
        except BaseException as e:  # noqa: BLE001 — re-raised on join
            self._err = e

    @property
    def shape(self):  # known without joining the transfer
        return (self._true_frames, self._n_bins)

    @property
    def dtype(self):
        return np.dtype(np.float32)

    ndim = 2

    def __len__(self):
        return self._true_frames

    def __array__(self, dtype=None, copy=None):
        if self._out is None:
            self._thread.join()
            if self._err is not None:
                raise RuntimeError(
                    "CQT-plane device->host transfer failed") from self._err
            self._out = P.unpack_cqt_f16(
                self._buf[: self._true_frames], self._n_bins)
            self._buf = None
        return self._out if dtype is None else self._out.astype(dtype)

    def __getitem__(self, idx):
        return np.asarray(self)[idx]


def fetch_analyze_poly(handle) -> Dict[str, np.ndarray]:
    """Blocking half: transfer the packed raw-voice buffer and reconstruct
    the {roll, confidence, salience, rms, onset_env} planes through the
    NumPy oracle (the bucket-padding tail carries ~zero salience, so the
    global acceptance peak over true frames equals the padded device max).
    The f16 CQT plane comes back as a :class:`_LazyPlane` whose transfer
    overlaps the caller's pre-CQT host extraction; its values are the
    same unpack_cqt_f16 output as before, just later."""
    buf, true_frames, max_voices, bins_per_octave = handle
    V = max_voices
    core_dev = buf[:, : 2 * V + 2]
    plane_dev = buf[:, 2 * V + 2:]
    n_cols = int(buf.shape[1]) - (2 * V + 2)
    lazy = (_LazyPlane(plane_dev, true_frames, 2 * n_cols)
            if n_cols > 0 else None)
    out = P.unpack_poly_voices(np.asarray(core_dev)[:true_frames],
                               max_voices, bins_per_octave)
    if lazy is not None:
        out["cqt_mag"] = lazy
    return out


class AegisPolyEngine:
    """Two-phase polyphonic transcription (CQT salience peeling).

    ``n_fft``/``hop_length`` default to sr-proportional values (2048/512
    at 22.05 kHz, 4096/1024 at 44.1 kHz) so the analysis window covers the
    same PHYSICAL duration at every rate: with a fixed 2048 window at
    44.1 kHz the FFT bin spacing (21.5 Hz) exceeds a low-string semitone
    and chord-progression truth F1 measured 0.5-0.79; the scaled window
    restores mean 0.960 over seeds 1-12 with the floored comb
    normalization (core/poly.py::COMB_NORM_FLOOR; 22.05 kHz: 1.0 on the
    same seeds; the 44.1 kHz residue is the same harmonic-ghost tail
    class as the extended 22.05 kHz seeds — measured 2026-08-18)."""

    def __init__(self, sample_rate: int = 22050,
                 hop_length: Optional[int] = None,
                 n_fft: Optional[int] = None, n_bins: int = 84,
                 bins_per_octave: int = 12, max_voices: int = 6,
                 transport: str = "int8"):
        scale = max(1, round(sample_rate / 22050))
        self.sr = sample_rate
        self.transport = transport
        self.hop_length = hop_length if hop_length is not None \
            else 512 * scale
        self.n_fft = n_fft if n_fft is not None else 2048 * scale
        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave
        self.max_voices = max_voices

    # ------------------------------------------------------------- phase one

    def analyze(self, input_wav: Union[str, bytes, np.ndarray],
                **kwargs) -> Optional[Dict[str, np.ndarray]]:
        if isinstance(input_wav, np.ndarray):
            y = input_wav.astype(np.float32)
        else:
            start = kwargs.get("start_time", 0)
            end = kwargs.get("end_time", None)
            y, _ = load_audio(input_wav, sr=self.sr, offset=start,
                              duration=(end - start) if end else None)
        if len(y) == 0:
            return None

        from aegis_tpu.engine.engine import normalize_turbo_mode

        # no slab-streamed poly mode exists; stream/auto requests map to the
        # tiled path (bounded per-tile compute; the packed poly output is
        # ~100 KB/min, so the fixed output buffer is not the constraint)
        mode = normalize_turbo_mode(
            kwargs.get("turbo_mode", False), len(y), self.sr,
            kwargs.get("stream_threshold_s", 240.0), allow_stream=False)
        if mode == "tiles":
            # sharded tiled path (multi-chip or seam-tested single-chip)
            from aegis_tpu.engine.turbo import run_analyze_poly_turbo

            log.info(f"Polyphonic Perception Phase [tiles] "
                     f"({len(y)/self.sr:.1f}s)")
            out = run_analyze_poly_turbo(
                y, sr=self.sr, n_fft=self.n_fft, hop_length=self.hop_length,
                n_bins=self.n_bins, bins_per_octave=self.bins_per_octave,
                max_voices=self.max_voices,
                turbo=kwargs.get("turbo_config"), mesh=kwargs.get("mesh"))
            out["y"] = y
            return out

        log.info(f"Polyphonic Perception Phase ({len(y)/self.sr:.1f}s, "
                 f"<= {self.max_voices} voices)")
        out = fetch_analyze_poly(dispatch_analyze_poly(
            y, self.sr, self.n_fft, self.hop_length, self.n_bins,
            self.bins_per_octave, self.max_voices,
            transport=kwargs.get("transport", self.transport)))
        out["y"] = y
        return out

    # ------------------------------------------------------------- phase two

    def extract_events(self, analysis: Dict[str, np.ndarray],
                       output_mid=None, **kwargs) -> List[dict]:
        """Segment the piano roll into note events.

        ``use_onsets=True`` (library default) runs the full polyphonic
        refinement — silence gate, onset re-attack split, chord-aware
        start snap, decay prune, onset birth + attack-rise gates,
        absolute-salience harmonic dedup (core.poly.refine_poly_events;
        measured mean truth F1 0.34 -> 0.99 over 20 chord-progression
        seeds, precision 1.0 on the gated seeds 1-10).
        ``use_onsets=False`` is the plain pitch-only segmentation."""
        from aegis_tpu.ref.dsp_ref import amplitude_to_db

        use_onsets = kwargs.get("use_onsets", True)
        # refinement replaces duration/gap micro-filtering with explicit
        # attack physics, so it prefers a longer sustain merge (splits are
        # put back by the onset pass); min-duration stays 60 ms in both
        # modes — measured identical on the 20-seed truth sweep, and 100 ms
        # made sub-4-frame notes (fast arpeggios) undetectable by
        # construction
        mindur = kwargs.get("min_note_duration_ms", 60.0)
        sustain = kwargs.get("sustain_ms", 120.0 if use_onsets else 40.0)
        roll = analysis["roll"]
        # rms_ref / rms_floor_db: a windowed caller (the live horizon
        # cache) pins the dB reference and the top_db clamp floor to the
        # TRACK-GLOBAL values, so slice dB planes match the full track's
        rms_ref = kwargs.get("rms_ref")
        rms_db = amplitude_to_db(np.asarray(analysis["rms"]), ref=rms_ref)
        if rms_ref is not None and kwargs.get("rms_floor_db") is not None:
            rms_db = np.maximum(rms_db, np.float32(kwargs["rms_floor_db"]))
        if use_onsets:
            # rms_peak_db: a windowed caller (the live horizon cache)
            # passes the TRACK-GLOBAL rms peak so the silence gate matches
            # the full-track extraction on a slice
            roll = P.silence_gate(
                roll, rms_db, kwargs.get("silence_db", 45.0),
                peak_db=kwargs.get("rms_peak_db"))
        events = P.roll_to_events(
            roll, analysis["confidence"], analysis["rms"],
            self.sr, self.hop_length,
            min_note_duration_ms=mindur,
            sustain_ms=sustain,
            confidence_threshold=kwargs.get("confidence_threshold", 0.5),
            rms_db=rms_db,
        )
        if use_onsets:
            # onsets override: pick_onsets normalizes by the track env max
            # and runs a sequential refractory, so a windowed caller must
            # supply globally-picked onsets (already slice-shifted)
            onsets = kwargs.get("onsets")
            if onsets is None:
                onsets = pick_onsets(analysis["onset_env"], self.sr,
                                     self.hop_length)
            fps = self.sr / self.hop_length
            events = split_events_at_onsets(
                events, onsets,
                min_frames=max(int(mindur / 1000.0 * fps), 1))
            # re-read attack dynamics at each split point — the v1 path's
            # convention (core/events.py apply_onset_refinement): a chord
            # re-plucked at a different dynamic must not inherit the first
            # pluck's velocity.  Deliberately NOT re-read after the snap
            # below, also matching v1.
            velocity = velocity_from_db(rms_db)
            T_rms = len(rms_db)
            for e in events:
                e["velocity"] = int(velocity[min(e["start"], T_rms - 1)])
                e["rms_energy"] = float(rms_db[min(e["start"], T_rms - 1)])
            if "salience" in analysis:
                events = P.refine_poly_events(
                    events, onsets, rms_db, analysis["salience"],
                    self.sr, self.hop_length,
                    total_frames=roll.shape[0],
                    snap_back_ms=kwargs.get("snap_back_ms", 200.0),
                    birth_tol_ms=kwargs.get("birth_tol_ms", 80.0),
                    rise_db=kwargs.get("rise_db", 2.0),
                    sal_ratio=kwargs.get("sal_ratio", 0.55),
                    decay_frac=kwargs.get("decay_frac", 0.5),
                    # octave-doubling recovery off the raw CQT plane
                    # (absent on pre-round-3 cached analyses: skip)
                    cqt_mag=analysis.get("cqt_mag"),
                    # the leakage-physics passes need the FFT bin width
                    n_fft=self.n_fft,
                    # track-global CQT peak override (live horizon cache)
                    track_peak_db=kwargs.get("track_peak_db"))
        if output_mid is not None:
            bpm = kwargs.get("bpm")
            if bpm == "auto":
                from aegis_tpu.core.tempo import estimate_bpm

                bpm = estimate_bpm(analysis, self.sr, self.hop_length)
            events_to_midi(events, self.sr, self.hop_length,
                           midi_program=kwargs.get("midi_program", 25),
                           bpm=bpm, output=output_mid)
        return events

    def audio_to_midi(self, input_wav, output_mid=None, **kwargs):
        analysis = self.analyze(input_wav, **kwargs)
        if analysis is None:
            return None
        self.extract_events(analysis, output_mid, **kwargs)
        return analysis

    def generate_tabs(self, events: List[dict]) -> List[dict]:
        return generate_tabs_chords(events, self.sr, self.hop_length)

    def label_chords(self, events: List[dict],
                     window_ms: float = 50.0) -> List[dict]:
        return label_chords(events, self.sr, self.hop_length, window_ms)


def label_chords(events: List[dict], sr: int, hop_length: int,
                 window_ms: float = 50.0) -> List[dict]:
    """Name each simultaneous note group as a chord symbol
    (beyond-reference: the reference's HarmonicAnalyzer estimates a
    windowed progression internally but never surfaces chord names).
    Returns [{time_sec, name, notes}] in onset order."""
    from aegis_tpu.core.poly import group_chords
    from aegis_tpu.harmony.key import name_chord

    spf = hop_length / sr
    out = []
    for chord in group_chords(events, sr, hop_length, window_ms):
        notes = sorted(e["note"] for e in chord["events"])
        start = min(e["start"] for e in chord["events"])
        name = name_chord(notes)
        if any(e.get("octave_uncertain") for e in chord["events"]):
            # an unprovable octave doubling may hide in this voicing
            # (core.poly.recover_octave_doublings; VALIDATION.md round 4)
            name += " (oct?)"
        out.append({"time_sec": round(start * spf, 4),
                    "name": name, "notes": notes})
    return out


# --------------------------------------------------------------------------
# Folder batch sweep (driver config 5)
# --------------------------------------------------------------------------

def transcribe_folder(
    folder: str,
    output_dir: Optional[str] = None,
    pattern: str = "*.wav",
    sample_rate: int = 22050,
    start_time: float = 0.0,
    end_time: Optional[float] = None,
    turbo: Optional[TurboConfig] = None,
    mesh=None,
    pitch_backend: str = "pyin",
    engine: str = "v1",
    transport: str = "int8",
    **extract_kwargs,
) -> List[Tuple[str, str, int]]:
    """Batch-transcribe every matching file through the device.

    Tracks are loaded with the requested [start_time, end_time) range.  On
    a single device every track's fused program is dispatched before any
    fetch (JAX dispatch is async), each track at its OWN length bucket —
    no pad bytes to upload or compute, and the programs are the
    same ones single-track runs warm.  Given a multi-device ``mesh`` the
    tracks are instead zero-padded to the longest track's bucket, stacked
    on a batch axis and analyzed via engine.turbo.run_analyze_batch
    (data-parallel over the mesh, time-tiled with pYIN halos).  Event
    extraction + MIDI encode run per track on host.  Returns
    [(wav_path, mid_path, n_events)].

    ``engine`` selects the pipeline: "v1" (default, the two-phase
    monophonic engine's extraction defaults), "financial" (the v2 5-phase
    pipeline — trend articulations, adaptive threshold, harmonic filter —
    extracted through AegisFinancialEngine so folder events match the
    per-track facade exactly), or "poly" (chord-capable CQT salience
    peeling via AegisPolyEngine).  Every engine gets the dispatch-ahead
    treatment on a single chip and the sharded batch on a mesh.

    ``transport`` is the dispatch-ahead audio upload packing
    (core.analyze.run_analyze: "int8" default, "int4" opt-in for
    throughput-over-fidelity sweeps, "int16"/"float32" conservative; the
    neural backend takes int8/int16/float32).  The sharded mesh paths and
    the poly engine keep their own conventions (per-track int16, or
    float32 when requested on the pYIN mesh path).

    pitch_backend="neural" runs PitchNet instead of pYIN (v1 and financial;
    the poly engine is pYIN-free already and rejects it): on a single chip
    every track is dispatched before any fetch
    (models.pitchnet.dispatch_analyze_neural), so upload/compute of track
    i+1 overlaps track i's device->host transfer — the neural fused
    program is the fastest single-track path, which makes this the fastest
    folder sweep.  On a multi-device mesh the batch runs data-parallel in
    ONE sharded program (models.pitchnet.run_analyze_neural_batch; native
    22.05 kHz only — other rates keep the per-track dual-rate programs).
    """
    from aegis_tpu.engine.turbo import run_analyze_batch

    if engine not in ("v1", "financial", "poly", "auto"):
        raise ValueError(f"unknown engine: {engine!r} "
                         "(v1 | financial | poly | auto)")
    if engine in ("poly", "auto") and pitch_backend != "pyin":
        raise ValueError("the polyphonic/routed engines embed their own "
                         "pitch stacks (no neural backend)")
    if pitch_backend not in ("pyin", "neural"):
        raise ValueError(f"unknown pitch backend: {pitch_backend!r}")
    if transport not in ("int8", "int4", "int16", "float32"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(int8 | int4 | int16 | float32)")

    paths = sorted(glob.glob(os.path.join(folder, pattern)))
    if not paths:
        return []
    output_dir = output_dir or folder
    os.makedirs(output_dir, exist_ok=True)

    duration = (end_time - start_time) if end_time else None
    tracks, lengths = [], []
    for p in paths:
        y, _ = load_audio(p, sr=sample_rate, offset=start_time,
                          duration=duration)
        tracks.append(y)
        lengths.append(len(y))

    audio = AudioConfig(sample_rate=sample_rate)
    pyin_cfg = PyinConfig()
    rake_sensitivity = extract_kwargs.pop("rake_sensitivity", 0.6)
    financial = engine == "financial"
    log.info(f"Turbo batch [{engine}]: {len(paths)} tracks x "
             f"{max(lengths)/sample_rate:.1f}s max")

    import jax

    single_chip = mesh is None and jax.device_count() == 1

    def _mesh_batch_slices(out):
        """Sharded batch output -> per-track dicts, trimming each track's
        common-pad tail (per-track scalars like adaptive_threshold pass
        through unsliced)."""
        def cut(v, i, tf):
            a = np.asarray(v[i])
            return a[:tf] if a.ndim >= 1 else a
        return [{k: cut(v, i, audio.n_frames(lengths[i]))
                 for k, v in out.items()} for i in range(len(tracks))]

    # The dispatch-ahead paths send each track UNPADDED: dispatch_analyze
    # bucket-pads per track, so a 5 s clip in a folder with a 60 s track
    # costs a 5 s upload/compute, not a 60 s one — and per-track buckets hit the
    # same persistent-cache programs single-track runs compile, where a
    # common max-length pad would mint a shape nothing else uses.  Only
    # the sharded mesh paths need a common-length stacked batch.
    if engine == "auto":
        # the polyphony-aware router (engine/auto.py): dispatch-ahead of
        # the fused dual program per track (no sharded dual program
        # exists; a mesh request still works, one chip's worth at a time,
        # logged rather than refused — the matrix convention the neural
        # tiles fallback set)
        from aegis_tpu.engine.auto import (AegisAutoEngine,
                                           dispatch_analyze_auto,
                                           fetch_analyze_auto)

        if mesh is not None:
            log.info("auto engine has no sharded batch path; running "
                     "dispatch-ahead on the default device")
        aeng = AegisAutoEngine(sample_rate=sample_rate)
        handles = [dispatch_analyze_auto(y, aeng, rake_sensitivity)
                   for y in tracks]
        per_track = [fetch_analyze_auto(h, aeng) for h in handles]
        results = []
        for i, p in enumerate(paths):
            mid_path = os.path.join(
                output_dir,
                os.path.splitext(os.path.basename(p))[0] + ".mid")
            events = aeng.extract_events(per_track[i], output_mid=mid_path,
                                         **extract_kwargs)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    if engine == "poly":
        peng = AegisPolyEngine(sample_rate=sample_rate)
        if single_chip:
            handles = [dispatch_analyze_poly(
                y, sample_rate, peng.n_fft, peng.hop_length, peng.n_bins,
                peng.bins_per_octave, peng.max_voices,
                transport=peng.transport) for y in tracks]
            per_track = [fetch_analyze_poly(h) for h in handles]
        else:
            from aegis_tpu.engine.turbo import run_analyze_poly_turbo

            max_len = max(lengths)
            batch = np.stack([np.pad(y, (0, max_len - len(y)))
                              for y in tracks])
            out = run_analyze_poly_turbo(
                batch, sr=sample_rate, n_fft=peng.n_fft,
                hop_length=peng.hop_length, n_bins=peng.n_bins,
                bins_per_octave=peng.bins_per_octave,
                max_voices=peng.max_voices, turbo=turbo, mesh=mesh)
            # poly frame grid: 1 + n // hop (sr-proportional hop)
            per_track = [
                {k: np.asarray(v[i])[: 1 + lengths[i] // peng.hop_length]
                 for k, v in out.items()} for i in range(len(tracks))]
    elif pitch_backend == "neural":
        from aegis_tpu.models.pitchnet import (SR_NATIVE,
                                               default_params_device,
                                               dispatch_analyze_neural,
                                               fetch_analyze_neural,
                                               run_analyze_neural_batch)

        params = default_params_device()
        if not single_chip and sample_rate == SR_NATIVE:
            # multi-device: ONE data-parallel batch over the mesh (PitchNet
            # is embarrassingly data-parallel; params replicate)
            max_len = max(lengths)
            batch = np.stack([np.pad(y, (0, max_len - len(y)))
                              for y in tracks])
            out = run_analyze_neural_batch(
                batch, sample_rate, audio.hop_length, params,
                rake_sensitivity, n_fft=audio.n_fft, n_mels=audio.n_mels,
                financial=financial, mesh=mesh)
            per_track = _mesh_batch_slices(out)
        else:
            handles = [dispatch_analyze_neural(
                y, sample_rate, audio.hop_length, params, rake_sensitivity,
                n_fft=audio.n_fft, n_mels=audio.n_mels, fetch_mel=False,
                financial=financial, transport=transport) for y in tracks]
            per_track = [fetch_analyze_neural(h) for h in handles]
        # PitchNet fires up to ~a window early; forward-snap such starts
        # to the attack rise (the engine facade's backend convention; the
        # financial facade applies it via the pitch_backend marker below)
        if not financial:
            extract_kwargs.setdefault("onset_fwd_snap_ms", 100.0)
    elif single_chip:
        # single chip: the fused whole-track program beats the tiled path
        # (no halo recompute, better pyin shapes).  Dispatch ALL tracks
        # before fetching any — JAX dispatch is async, so track i+1's
        # upload/compute overlaps track i's device->host transfer.
        from aegis_tpu.core.analyze import dispatch_analyze, fetch_analyze

        handles = [dispatch_analyze(y, audio, pyin_cfg, rake_sensitivity,
                                    financial=financial, fetch_mel=False,
                                    transport=transport)
                   for y in tracks]
        per_track = [fetch_analyze(h) for h in handles]
    else:
        max_len = max(lengths)
        batch = np.stack([np.pad(y, (0, max_len - len(y))) for y in tracks])
        out = run_analyze_batch(
            batch, audio, pyin_cfg, rake_sensitivity, turbo=turbo, mesh=mesh,
            fetch_mel=False, financial=financial,
            # the tiled batch programs take per-track int16 or float32 only
            transport="float32" if transport == "float32" else "int16")
        per_track = _mesh_batch_slices(out)

    results = []
    if engine == "poly":
        for i, p in enumerate(paths):
            mid_path = os.path.join(
                output_dir,
                os.path.splitext(os.path.basename(p))[0] + ".mid")
            events = peng.extract_events(per_track[i], output_mid=mid_path,
                                         **extract_kwargs)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    if financial:
        from aegis_tpu.engine.financial import AegisFinancialEngine
        from aegis_tpu.midi.encode import events_to_midi_financial

        feng = AegisFinancialEngine(sample_rate=sample_rate,
                                    hop_length=audio.hop_length,
                                    n_fft=audio.n_fft)
        for i, p in enumerate(paths):
            r = per_track[i]
            # backend-conditional extraction marker (neural forward snap),
            # exactly as AegisFinancialEngine.analyze records it
            r["pitch_backend"] = pitch_backend
            events, info = feng.extract_events(r, **extract_kwargs)
            mid_path = os.path.join(
                output_dir,
                os.path.splitext(os.path.basename(p))[0] + ".mid")
            events_to_midi_financial(events, sample_rate, audio.hop_length,
                                     bpm=info.get("bpm"), output=mid_path)
            results.append((p, mid_path, len(events)))
            log.info(f"  {os.path.basename(p)}: {len(events)} events")
        return results

    # onset refinement on by default — the library default (engine.py's
    # extract_events, CLAUDE.md invariant); use_onsets=False restores the
    # reference's merge/lag semantics for the golden-comparison mode
    use_onsets = extract_kwargs.pop("use_onsets", True)
    for i, p in enumerate(paths):
        # no-op on the dispatch-ahead paths (fetch already truncated to the
        # track's own frame count); trims the common-pad tail on the mesh path
        true_frames = audio.n_frames(lengths[i])
        r = per_track[i]
        onset_env = None
        if use_onsets and "onset_env" in r:
            onset_env = np.asarray(r["onset_env"],
                                   np.float64)[:true_frames]
        events = extract_events_v1(
            rake_mask=np.asarray(r["rake_mask"])[:true_frames],
            f0=np.nan_to_num(np.asarray(r["f0"], np.float64))[:true_frames],
            voiced_flag=np.asarray(r["voiced_flag"])[:true_frames],
            active_probs=np.asarray(r["voiced_probs"],
                                    np.float64)[:true_frames],
            rms=np.asarray(r["rms"], np.float64)[:true_frames],
            sr=sample_rate, hop_length=audio.hop_length,
            onset_env=onset_env,
            **extract_kwargs,
        )
        mid_path = os.path.join(
            output_dir,
            os.path.splitext(os.path.basename(p))[0] + ".mid")
        events_to_midi(events, sample_rate, audio.hop_length, output=mid_path)
        results.append((p, mid_path, len(events)))
        log.info(f"  {os.path.basename(p)}: {len(events)} events")
    return results
