"""AegisFinancialEngine — the v2 one-shot 5-phase pipeline facade.

Mirrors the reference (aegis_engine_financial.py:30-253):
  [1/5] load audio (sr=22050) + mel spectrogram
  [2/5] rake detection
  [3/5] pYIN pitch tracking
  [3.5/5] guitar-specific filters (sub-E2, rake enhance, palm mute, distortion)
  [4/5] financial analysis (trend consensus, Bollinger articulations, MACD
        slides, RSI ghost filter, adaptive threshold) + harmonic filtering
  [5/5] dual named-track MIDI export (120 BPM tick math)

Phases 1-4a run as ONE device program (core.analyze.analyze_financial_program)
instead of seven sequential NumPy/librosa passes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core.events import extract_events_financial
from aegis_tpu.io.audio import load_audio as _load_audio
from aegis_tpu.midi.encode import events_to_midi_financial
from aegis_tpu.utils.logging import get_logger

log = get_logger("Financial")


class AegisFinancialEngine:
    version = "2.0-financial"

    def __init__(self, sample_rate: int = 22050, hop_length: int = 512,
                 n_fft: int = 2048, backend: str = "auto"):
        self.audio = AudioConfig(sample_rate=sample_rate, hop_length=hop_length,
                                 n_fft=n_fft)
        self.pyin_cfg = PyinConfig()
        self.backend = backend

    @property
    def sr(self) -> int:
        return self.audio.sample_rate

    @property
    def hop_length(self) -> int:
        return self.audio.hop_length

    def _analyze(self, y: np.ndarray, rake_sensitivity: float,
                 use_guitar_filters: bool,
                 fetch_mel: bool = True,
                 turbo=False, turbo_config=None,
                 pitch_backend: str = "pyin") -> Dict[str, np.ndarray]:
        """turbo: False = fused single program, True = sharded tiles,
        "stream" = bounded-memory slab streaming.  pitch_backend="neural"
        swaps pYIN for PitchNet in the fused program (fused mode only;
        see engine.AegisEngine._analyze)."""
        if pitch_backend == "neural":
            from aegis_tpu.models.pitchnet import default_params_device, \
                run_analyze_neural

            if turbo:
                log.warning(f"neural backend runs the fused single program;"
                            f" turbo={turbo!r} ignored")
            return run_analyze_neural(
                y, self.sr, self.hop_length, default_params_device(),
                rake_sensitivity, n_fft=self.audio.n_fft,
                n_mels=self.audio.n_mels, fetch_mel=fetch_mel,
                financial=True, use_guitar_filters=use_guitar_filters)
        if pitch_backend != "pyin":
            raise ValueError(f"unknown pitch backend: {pitch_backend!r}")
        if self.backend != "ref":
            try:
                if turbo == "stream":
                    from aegis_tpu.engine.turbo import run_analyze_streamed

                    return run_analyze_streamed(
                        y, self.audio, self.pyin_cfg, rake_sensitivity,
                        turbo=turbo_config, fetch_mel=fetch_mel,
                        financial=True,
                        use_guitar_filters=use_guitar_filters)
                if turbo:
                    from aegis_tpu.engine.turbo import run_analyze_turbo

                    return run_analyze_turbo(
                        y, self.audio, self.pyin_cfg, rake_sensitivity,
                        turbo=turbo_config, fetch_mel=fetch_mel,
                        financial=True,
                        use_guitar_filters=use_guitar_filters)
                from aegis_tpu.core.analyze import run_analyze

                return run_analyze(y, self.audio, self.pyin_cfg,
                                   rake_sensitivity, financial=True,
                                   use_guitar_filters=use_guitar_filters,
                                   fetch_mel=fetch_mel)
            except Exception as e:
                if self.backend == "device":
                    raise
                log.warning(f"device analyze failed ({e}); NumPy oracle fallback")
        from aegis_tpu.ref.pipeline_ref import run_analyze_ref

        return run_analyze_ref(y, self.audio, self.pyin_cfg, rake_sensitivity,
                               financial=True,
                               use_guitar_filters=use_guitar_filters)

    def analyze(self, input_wav: Union[str, bytes, np.ndarray],
                **kwargs) -> Optional[Dict[str, np.ndarray]]:
        """Phases 1-4a (cacheable raw analysis).  Returns the frame-level
        analysis dict (f0 is NaN on unvoiced frames)."""
        if isinstance(input_wav, np.ndarray):
            y = input_wav.astype(np.float32)
        else:
            start = kwargs.get("start_time", 0.0)
            end = kwargs.get("end_time", None)
            y, _ = _load_audio(input_wav, sr=self.sr, offset=start,
                               duration=(end - start) if end else None)
        if len(y) == 0:
            return None
        from aegis_tpu.engine.engine import normalize_turbo_mode
        from aegis_tpu.utils.prof import phase

        turbo_mode = normalize_turbo_mode(
            kwargs.get("turbo_mode", False), len(y), self.sr,
            kwargs.get("stream_threshold_s", 240.0))
        with phase("financial.perception", quiet=True):
            out = self._analyze(
                y,
                kwargs.get("rake_sensitivity", 0.6),
                kwargs.get("use_guitar_filters", True),
                kwargs.get("fetch_mel", True),
                turbo_mode,
                kwargs.get("turbo_config", None),
                kwargs.get("pitch_backend", "pyin"),
            )
        out["y"] = y
        # marker for backend-conditional extraction (neural forward snap)
        out["pitch_backend"] = kwargs.get("pitch_backend", "pyin")
        return out

    def extract_events(self, analysis: Dict[str, np.ndarray],
                       **kwargs) -> Tuple[List[dict], Dict]:
        """Phase 4b: events from cached analysis (re-runnable per slider).

        kwargs["bpm"]: a number, or "auto" to estimate from the onset
        envelope; the resolved value rides in info["bpm"] and keys the MIDI
        encoder's tempo (beyond-reference; default stays the reference's
        fixed 120 BPM)."""
        bpm = kwargs.get("bpm")
        if bpm == "auto":
            bpm = self.estimate_bpm(analysis)
        events, info = extract_events_financial(
            rake_mask=analysis["rake_mask"],
            f0=analysis["f0"],
            voiced_flag=analysis["voiced_flag"],
            active_probs=analysis["voiced_probs"],
            rms=analysis["rms"],
            sr=self.sr,
            hop_length=self.hop_length,
            trend=analysis["trend"],
            artic_codes=analysis["artic_codes"],
            slide_codes=analysis["slide_codes"],
            financial_confidence=analysis["financial_confidence"],
            confidence_threshold=kwargs.get("confidence_threshold", None),
            noise_gate_db=kwargs.get("noise_gate_db", -40),
            sustain_ms=kwargs.get("sustain_ms", 50),
            min_note_duration_ms=kwargs.get("min_note_duration_ms", 50),
            use_harmonic_filter=kwargs.get("use_harmonic_filter", True),
            harmonic_tolerance=kwargs.get("harmonic_tolerance", 1),
            # onset refinement: the library default, as on the v1 engine;
            # use_onsets=False restores the reference's merge/lag semantics
            onset_env=analysis.get("onset_env")
            if kwargs.get("use_onsets", True) else None,
            # PitchNet fires up to ~a window early; the forward snap moves
            # such starts to the attack rise (engine/engine.py rationale)
            onset_fwd_snap_ms=kwargs.get(
                "onset_fwd_snap_ms",
                100.0 if str(analysis.get("pitch_backend", "")) == "neural"
                else 0.0),
            # "pyin" quantizes notes from the median-smoothed f0 (truth
            # F1 1.0); "trend" is the reference's over-smoothed semantics
            pitch_source=kwargs.get("pitch_source", "pyin"),
        )
        if bpm:
            info["bpm"] = float(bpm)
        return events, info

    def estimate_bpm(self, analysis: Dict[str, np.ndarray]):
        from aegis_tpu.core.tempo import estimate_bpm

        return estimate_bpm(analysis, self.sr, self.hop_length)

    def audio_to_midi_financial(self, input_wav, output_mid,
                                **kwargs) -> Optional[str]:
        """One-shot pipeline; returns output path (None if no notes)."""
        log.info(f"Aegis Financial Engine v{self.version}")
        analysis = self.analyze(input_wav, **kwargs)
        if analysis is None:
            return None
        log.info(f"[2/5] rake frames: {int(np.sum(analysis['rake_mask']))}")
        if "mute_mask" in analysis:
            log.info(f"[3.5/5] mute frames: {int(np.sum(analysis['mute_mask']))}")

        events, info = self.extract_events(analysis, **kwargs)
        if not events:
            log.warning("no notes detected")
            return None

        main = sum(1 for e in events if e["track"] == "main")
        safe = len(events) - main
        log.info(
            f"[4/5] events: {len(events)} (main {main} "
            f"{100.0 * main / len(events):.1f}%, safe {safe}) "
            f"threshold={info['threshold']:.3f}"
        )
        if info.get("key_info"):
            k = info["key_info"]
            log.info(f"[4/5] key: {k['key']} {k['mode']} ({k['confidence']:.2f})")

        events_to_midi_financial(events, self.sr, self.hop_length,
                                 bpm=info.get("bpm"), output=output_mid)
        log.info(f"[5/5] wrote {output_mid}")
        return output_mid
