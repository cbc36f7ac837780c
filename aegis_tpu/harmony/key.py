"""Harmonic (key/scale/chord) analysis for musical-context note filtering.

Host-side NumPy: operates on event lists (tens of notes), not frame data, so
there is nothing to accelerate.  Mirrors the reference's HarmonicAnalyzer
(aegis_engine_core_v2/harmonic_analysis.py): pitch-class histogram scored
against major/minor/blues interval templates over all 12 roots, scale-
membership filtering with semitone tolerance, windowed chord-progression
estimation, and chord-context confidence adjustment.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

CHROMATIC = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

MAJOR_INTERVALS = (0, 2, 4, 5, 7, 9, 11)
MINOR_INTERVALS = (0, 2, 3, 5, 7, 8, 10)
BLUES_INTERVALS = (0, 3, 5, 6, 7, 10)
PENTA_MINOR_INTERVALS = (0, 3, 5, 7, 10)

_MODE_TABLE = {
    "major": MAJOR_INTERVALS,
    "minor": MINOR_INTERVALS,
    "blues": BLUES_INTERVALS,
    "penta_minor": PENTA_MINOR_INTERVALS,
}


class HarmonicAnalyzer:
    """Key detection and music-theory filtering."""

    @staticmethod
    def midi_to_pitch_class(midi_note: int) -> int:
        return int(midi_note) % 12

    def detect_key(
        self,
        midi_notes: np.ndarray,
        use_duration: bool = False,
        durations: Optional[np.ndarray] = None,
    ) -> Dict:
        """Best (root, mode) over major/minor/blues templates by weighted
        pitch-class histogram mass."""
        midi_notes = np.asarray(midi_notes)
        if len(midi_notes) == 0:
            return {"key": "C", "mode": "major", "confidence": 0.0}

        weights = (
            np.asarray(durations, dtype=np.float64)
            if (use_duration and durations is not None)
            else np.ones(len(midi_notes))
        )
        histogram = np.zeros(12)
        np.add.at(histogram, midi_notes.astype(int) % 12, weights)
        histogram = histogram / (histogram.sum() + 1e-6)

        best = ("C", "major", 0.0)
        for root in range(12):
            for mode in ("major", "minor", "blues"):
                score = sum(
                    histogram[(root + iv) % 12] for iv in _MODE_TABLE[mode]
                )
                if score > best[2]:
                    best = (CHROMATIC[root], mode, score)
        return {"key": best[0], "mode": best[1], "confidence": float(best[2])}

    def get_scale_notes(self, key: str, mode: str) -> List[int]:
        root = CHROMATIC.index(key)
        intervals = _MODE_TABLE.get(mode, MAJOR_INTERVALS)
        return [(root + iv) % 12 for iv in intervals]

    def filter_out_of_scale_notes(
        self,
        midi_notes: np.ndarray,
        confidences: np.ndarray,
        key_info: Dict,
        tolerance: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(filtered_midi, filtered_confidence, out_of_scale_mask).

        tolerance: 0 scale-only, 1 allows +/-1 semitone (bends), 2 chromatic.
        """
        midi_notes = np.asarray(midi_notes)
        confidences = np.asarray(confidences)
        scale = np.array(self.get_scale_notes(key_info["key"], key_info["mode"]))
        pcs = midi_notes.astype(int) % 12
        # circular distance of each pitch class to the nearest scale tone
        d = np.abs(pcs[:, None] - scale[None, :])
        dist = np.minimum(d, 12 - d).min(axis=1)
        out_of_scale = dist > tolerance
        return midi_notes[~out_of_scale], confidences[~out_of_scale], out_of_scale

    def analyze_chord_progression(
        self, midi_notes: np.ndarray, times: np.ndarray, window_size: float = 2000.0
    ) -> List[Dict]:
        """Per-2s-window chord estimate: modal pitch class as root, quality
        from the present third.

        One bincount over (window, pitch-class) keys instead of a
        per-window mask scan (the scan was O(events x windows) — ~3 ms of
        every 10-minute live financial poll, round 5).  Tie-break parity
        with the sequential formulation: Counter.most_common picks the
        FIRST pitch class (by first occurrence in window order) among
        equal counts, encoded here as count*(E+1) - first_occurrence so
        argmax decides count first, earliest-seen second.  Non-integer
        window sizes keep the sequential form (its range() stride
        truncates, which floor-division windows would not reproduce)."""
        midi_notes = np.asarray(midi_notes)
        times = np.asarray(times)
        if len(midi_notes) == 0:
            return []
        ws = int(window_size)
        if ws != window_size or ws <= 0:
            return self._chord_progression_seq(midi_notes, times, window_size)
        maxt = int(np.max(times))
        m = times >= 0
        if maxt < 0 or not m.any():
            return []
        wi = np.floor_divide(times[m], window_size).astype(np.int64)
        pcs = midi_notes[m].astype(np.int64) % 12
        W = maxt // ws + 1
        key = wi * 12 + pcs
        cnt = np.bincount(key, minlength=W * 12).reshape(W, 12)
        E = len(key)
        first = np.full(W * 12, E, np.int64)
        np.minimum.at(first, key, np.arange(E))
        score = cnt * (E + 1) - first.reshape(W, 12)
        roots = np.argmax(score, axis=1)
        present = cnt > 0
        chords = []
        for w in np.nonzero(present.any(axis=1))[0].tolist():
            root = int(roots[w])
            if present[w, (root + 4) % 12]:
                quality = "major"
            elif present[w, (root + 3) % 12]:
                quality = "minor"
            else:
                quality = "unknown"
            chords.append({"time": w * ws, "chord": CHROMATIC[root],
                           "quality": quality})
        return chords

    @staticmethod
    def _chord_progression_seq(midi_notes, times, window_size) -> List[Dict]:
        """The sequential spec (kept as the non-integer-window path and the
        parity reference for tests)."""
        chords = []
        for t in range(0, int(np.max(times)) + 1, int(window_size)):
            mask = (times >= t) & (times < t + window_size)
            window_notes = midi_notes[mask]
            if len(window_notes) == 0:
                continue
            pcs = [int(n) % 12 for n in window_notes]
            root = Counter(pcs).most_common(1)[0][0]
            if (root + 4) % 12 in pcs:
                quality = "major"
            elif (root + 3) % 12 in pcs:
                quality = "minor"
            else:
                quality = "unknown"
            chords.append({"time": t, "chord": CHROMATIC[root], "quality": quality})
        return chords

    def adaptive_filter_by_context(
        self,
        midi_notes: np.ndarray,
        times: np.ndarray,
        confidences: np.ndarray,
        key_info: Dict,
        window_size: float = 2000.0,
    ) -> np.ndarray:
        """Confidence penalties for non-chord tones: x0.8 if still in scale,
        x0.5 if fully out of scale."""
        chords = self.analyze_chord_progression(midi_notes, times, window_size)
        adjusted = np.asarray(confidences, dtype=np.float64).copy()
        if not chords:
            return adjusted
        scale_notes = set(self.get_scale_notes(key_info["key"], key_info["mode"]))
        # chord windows are disjoint [t, t+window) at multiples of the
        # window, so the per-event linear scan is a floor-division lookup
        # (the scan was a visible share of a 10-minute live poll; the
        # lookup itself is vectorized — one masked multiply, same
        # floats: each penalized confidence is multiplied once by the
        # identical 0.8/0.5 literal)
        ws = int(window_size)
        if ws != window_size or ws <= 0:
            return self._adaptive_filter_seq(midi_notes, times, adjusted,
                                             scale_notes, chords, window_size)
        W = max(c["time"] for c in chords) // ws + 1
        root_arr = np.full(W, -1, np.int64)
        third_arr = np.zeros(W, np.int64)
        for c in chords:
            if c["quality"] == "unknown":
                continue
            w = c["time"] // ws
            root_arr[w] = CHROMATIC.index(c["chord"])
            third_arr[w] = 4 if c["quality"] == "major" else 3
        times_a = np.asarray(times)
        valid = times_a >= 0
        wi = np.zeros(len(times_a), np.int64)
        wi[valid] = np.floor_divide(times_a[valid],
                                    window_size).astype(np.int64)
        known = valid & (wi < W)
        wi_c = np.minimum(wi, W - 1)
        r = root_arr[wi_c]
        known &= r >= 0
        pc = np.asarray(midi_notes).astype(np.int64) % 12
        third = third_arr[wi_c]
        tone = (pc == r) | (pc == (r + third) % 12) | (pc == (r + 7) % 12)
        in_scale12 = np.zeros(12, bool)
        in_scale12[list(scale_notes)] = True
        pen = known & ~tone
        adjusted[pen] *= np.where(in_scale12[pc[pen]], 0.8, 0.5)
        return adjusted

    @staticmethod
    def _adaptive_filter_seq(midi_notes, times, adjusted, scale_notes,
                             chords, window_size) -> np.ndarray:
        """The sequential spec (non-integer-window path; parity reference
        for tests)."""
        by_start = {c["time"]: c for c in chords}
        for i, (note, time) in enumerate(zip(midi_notes, times)):
            current = (by_start.get(int(time // window_size) * int(window_size))
                       if time >= 0 else None)
            if current is None or current["quality"] == "unknown":
                continue
            root = CHROMATIC.index(current["chord"])
            third = 4 if current["quality"] == "major" else 3
            chord_tones = {root, (root + third) % 12, (root + 7) % 12}
            pc = int(note) % 12
            if pc not in chord_tones:
                adjusted[i] *= 0.8 if pc in scale_notes else 0.5
        return adjusted


# chord spelling templates: pitch-class intervals relative to the root,
# most-specific first (a m7 set must not read as its relative-major triad)
_CHORD_TEMPLATES = [
    ((0, 4, 7, 11), "maj7"),
    ((0, 3, 7, 10), "m7"),
    ((0, 4, 7, 10), "7"),
    ((0, 3, 6, 9), "dim7"),
    ((0, 4, 7), ""),
    ((0, 3, 7), "m"),
    ((0, 3, 6), "dim"),
    ((0, 4, 8), "aug"),
    ((0, 5, 7), "sus4"),
    ((0, 2, 7), "sus2"),
    ((0, 7), "5"),
    ((0, 4), ""),     # rootless third: spell as major dyad
    ((0, 3), "m"),
]


def name_chord(midis) -> str:
    """Spell a simultaneous note group as a chord symbol ("C", "Am", "E5",
    "Gmaj7", ...).  Octave doublings collapse; the bass pitch class wins a
    tie between candidate roots (a first-inversion C major still reads as
    C rather than Em-something).  Falls back to the bass note name when no
    template matches."""
    notes = [int(m) for m in midis]
    if not notes:
        return ""
    bass_pc = min(notes) % 12
    pcs = frozenset(n % 12 for n in notes)
    if len(pcs) == 1:
        return CHROMATIC[bass_pc]
    candidates = []
    for intervals, quality in _CHORD_TEMPLATES:
        if len(intervals) != len(pcs):
            continue
        for root in pcs:
            if frozenset((root + iv) % 12 for iv in intervals) == pcs:
                candidates.append((root != bass_pc, CHROMATIC[root] + quality))
    if candidates:  # bass-rooted spelling first, then template order
        return sorted(candidates, key=lambda c: c[0])[0][1]
    return CHROMATIC[bass_pc]


def apply_harmonic_filter(
    midi_notes: np.ndarray,
    confidences: np.ndarray,
    times: Optional[np.ndarray] = None,
    tolerance: int = 1,
) -> Dict:
    """Standalone harmonic filtering entry point (reference
    harmonic_analysis.py:289-330)."""
    analyzer = HarmonicAnalyzer()
    key_info = analyzer.detect_key(midi_notes)
    filtered_midi, filtered_conf, out_mask = analyzer.filter_out_of_scale_notes(
        np.asarray(midi_notes), np.asarray(confidences), key_info, tolerance
    )
    if times is not None and len(filtered_midi):
        filtered_conf = analyzer.adaptive_filter_by_context(
            filtered_midi, np.asarray(times)[~out_mask], filtered_conf, key_info
        )
    return {
        "key_info": key_info,
        "filtered_midi": filtered_midi,
        "filtered_confidence": filtered_conf,
        "out_of_scale_mask": out_mask,
    }
