"""Polyphony-aware routing engine ("auto") — one entry point for mixed
material.

The monophonic engines (pYIN/neural) resolve fast lines the polyphonic
peel cannot (85 ms/note arpeggios measure F1 ≤ 0.18 through the CQT
window — a physics limit, VALIDATION.md), while the peel resolves chords
the monophonic tracker cannot (pYIN locks to one voice).  The reference
has neither problem because it is monophonic-only (SURVEY.md §0); real
material mixes both, so a user feeding a chords+runs track to either
engine silently loses half of it (VERDICT r2 weak #2).

``AegisAutoEngine`` runs BOTH pipelines in ONE fused device program per
upload — one upload, one dispatch and one fetch serve both engines —
then routes on the host:

  1. the polyphonic chain runs first (core.poly refinement + recovery);
  2. instantaneous polyphony = the count of overlapping REFINED poly
     events per frame (the raw roll over-counts: unrefined segmentation
     measures F1 0.34).  Frames with ≥2 concurrent voices are "chordal",
     the rest "monophonic";
  3. each event keeps to its regime by span majority: poly events whose
     span is mostly chordal, v1 events whose span is mostly monophonic
     (during chords pYIN locks to a single voice — a v1 event there is a
     one-voice shadow of the chord, already represented);
  4. same-pitch overlapping duplicates resolve to the poly event (it
     carries chord-context salience and the recovery chain's physics).

Frame grids: both sub-pipelines run the sr-proportional hop
(512 @ 22.05 kHz, 1024 @ 44.1 kHz) so v1 rows and poly rows share one
(T, ·) buffer and one event grid.  The v1 front-end keeps its validated
n_fft/frame_length (2048); only the hop is scaled — same physics as the
validated 22.05 kHz grid (fps 43.07).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Union

import numpy as np

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core import poly as P
from aegis_tpu.core.analyze import (_V1_ROWS, _pack, _unpack, bucket_length,
                                    dequant_transport, quantize_pcm8)
from aegis_tpu.core.events import extract_events_v1
from aegis_tpu.io.audio import load_audio
from aegis_tpu.midi.encode import events_to_midi
from aegis_tpu.utils.logging import get_logger

log = get_logger("AutoEngine")


@functools.partial(
    __import__("jax").jit,
    static_argnames=("audio", "pyin_cfg", "n_fft_poly", "n_bins",
                     "bins_per_octave", "max_voices"))
def analyze_auto_program_packed(y, scale, rake_sensitivity,
                                audio: AudioConfig, pyin_cfg: PyinConfig,
                                n_fft_poly: int = 2048, n_bins: int = 84,
                                bins_per_octave: int = 12,
                                max_voices: int = 6):
    """ONE device program computing BOTH Perception Phases off one upload:
    [v1 rows (6) | poly packed rows (2V+2+ceil(n_bins/2))] per frame.

    The v1 half is core.analyze.analyze_program (mel/rake/pYIN/RMS/onset,
    reference aegis_engine.py:41-75); the poly half mirrors
    core.poly.analyze_poly_program_packed (CQT peel raw voices + f16 raw
    CQT plane).  Both run on the same sr-proportional hop, so the frame
    counts match and the output is a single packed buffer — one
    device→host transfer."""
    import jax.numpy as jnp

    from aegis_tpu.core import dsp
    from aegis_tpu.core.analyze import analyze_program
    from aegis_tpu.core.cqt import onset_strength_t, pseudo_cqt_t

    yf = dequant_transport(y, scale)
    v1 = analyze_program(yf, rake_sensitivity, audio, pyin_cfg)
    v1_cols = _pack(v1, _V1_ROWS, include_mel=False)

    sr = audio.sample_rate
    hop = audio.hop_length
    cqt = pseudo_cqt_t(yf, sr, n_fft_poly, hop, n_bins, bins_per_octave)
    supp = jnp.asarray(P.harmonic_suppression_matrix(n_bins,
                                                     bins_per_octave))
    sub = jnp.asarray(P.harmonic_subtraction_matrix(n_bins,
                                                    bins_per_octave))
    bins, sals = P.peel_voices(cqt, supp, sub, max_voices)
    rms_ = dsp.rms(yf, n_fft_poly, hop)
    mel = dsp.melspectrogram_t(yf, sr, n_fft_poly, hop, 128)
    onset_env = onset_strength_t(mel)
    poly_cols = jnp.concatenate(
        [bins.astype(jnp.float32), sals.astype(jnp.float32),
         rms_.astype(jnp.float32)[:, None],
         onset_env.astype(jnp.float32)[:, None],
         P.pack_cqt_f16(jnp.sqrt(jnp.maximum(cqt, 0.0)))], axis=1)
    T = min(v1_cols.shape[0], poly_cols.shape[0])
    return jnp.concatenate([v1_cols[:T], poly_cols[:T]], axis=1)


def polyphony_regions(poly_events: List[dict], total_frames: int,
                      min_voices: int = 2,
                      min_chord_frames: int = 8,
                      v1_events: Optional[List[dict]] = None,
                      short_frames: int = 6) -> np.ndarray:
    """(T,) bool — frames where ≥ ``min_voices`` refined poly events
    overlap (the chordal regime).

    Chordal runs shorter than ``min_chord_frames`` (~185 ms) are erased:
    a strummed chord SUSTAINS, while the peel's attack-splash junk at a
    fast-run onset lives a few frames — and because the router keeps
    poly events inside chordal regions, a junk cluster would otherwise
    mark its own region and keep itself (measured: 3-event clusters at
    the chord→run boundary on 2 of 5 mixed-clip seeds)."""
    # only SIMULTANEOUS-ONSET groups count toward polyphony: a strummed
    # chord's voices share an attack (measured ≤2 frames apart on every
    # truth family), while a legato mono line's smeared CQT events
    # overlap with OFFSET starts (one note-duration apart) — counting
    # plain overlap marked 23% of a pure mono track chordal and flooded
    # it with harmonic-ghost poly events
    from aegis_tpu.config import midi_to_hz

    def _independent_notes(group):
        """Distinct notes that evidence REAL polyphony.  A single pluck's
        harmonic-line ghosts share its attack too (measured round 4: a
        lone 50 minted 62/69/83 = its h2/h3/h7 lines, the cluster marked
        its own chordal region and kept itself while displacing the true
        v1 event — 9 of the 9 pure-mono FPs).  Members within 1.2
        semitones of a harmonic line (h2..h10) of the group's LOWEST note
        therefore don't count — unless a recovery pass proved them by
        explicit envelope physics (tagged), which is how true octave
        doublings keep their region (a triad's +3/+4/+5/+7 intervals sit
        on no line, so standard chords are untouched)."""
        gnotes = sorted({e["note"] for e in group})
        root = gnotes[0]
        tagged = {e["note"] for e in group
                  if e.get("recovered_octave") or e.get("recovered_fifth")
                  or e.get("rescued_root") or e.get("repitched_octave")}
        f_root = midi_to_hz(root)
        return [n for n in gnotes
                if n == root or n in tagged
                or not any(abs(12.0 * np.log2(
                    midi_to_hz(n) / (h * f_root))) <= 1.2
                    for h in range(2, 11))]

    def _v1_shadow(group):
        """Is the WHOLE group one v1-tracked string's shadow?  The pYIN
        stream is a second measurement with a Viterbi prior: when every
        voice the peel sees at this attack is a harmonic line (h2..h10,
        ±1.2 semis) or a low-register rim neighbor (±3 semis — measured
        round 4: leakage ghosts at exactly −3 under true 43/45/47) of ONE
        overlapping v1 note, the monophonic reading wins and the group
        must not mark a chordal region (a real chord always contains a
        voice pYIN's one string cannot explain: +3/+4/+5/+7 intervals sit
        on no line and outside the rim)."""
        if not v1_events:
            return False
        gnotes = {e["note"] for e in group}
        lo = min(e["start"] for e in group)
        hi = max(e["end"] for e in group)
        for v in v1_events:
            if not (v["start"] <= hi and lo <= v["end"]):
                continue
            # the witness must be a CREDIBLE locked note: a major triad
            # IS the h3/h4/h5 line set of a root two octaves down, and a
            # junk pYIN shard at that root (measured: 4-8 frames at conf
            # 0.01, minted during a chord attack) must not demote a real
            # chord.  Length is the credibility signal (start-frame
            # confidence is unreliable after the attack snap): the junk
            # shards all ran <= 8 frames, real mono locks >= 9 (a 40 ms
            # min-duration note + pYIN's lock).
            if (v["end"] - v["start"] + 1) < 9:
                continue
            f_v = midi_to_hz(v["note"])
            if all(abs(n - v["note"]) <= 3
                   or any(abs(12.0 * np.log2(
                       midi_to_hz(n) / (h * f_v))) <= 1.2
                       for h in range(2, 11))
                   for n in gnotes):
                return True
        return False

    ordered = sorted(poly_events, key=lambda e: e["start"])
    count = np.zeros(total_frames, np.int32)
    # STRONG regions: marked by a group whose independent voices SUSTAIN
    # (>= 12 frames each).  A strummed chord's voices all sustain; the
    # boundary junk the v1-run demotion below exists for lives 3-8 frames
    # — so a strong region is exempt from that demotion (measured, mixed
    # seed 6: the [45,52,57] chord's 33-37-frame group was erased because
    # pYIN's oscillation minted two short distinct notes and its longest
    # chord lock ran 10 frames, under the has_long threshold).
    strong = np.zeros(total_frames, bool)
    i = 0
    while i < len(ordered):
        j = i
        while (j + 1 < len(ordered)
               and ordered[j + 1]["start"] - ordered[i]["start"] <= 2):
            j += 1
        group = ordered[i:j + 1]
        indep = _independent_notes(group)
        if len(indep) >= min_voices and not _v1_shadow(group):
            lo = max(min(e["start"] for e in group), 0)
            hi = min(max(e["end"] for e in group) + 1, total_frames)
            count[lo:hi] += min_voices
            indep_set = set(indep)
            long_notes = {e["note"] for e in group
                          if e["note"] in indep_set
                          and e["end"] - e["start"] + 1 >= 12}
            if len(long_notes) >= min_voices:
                strong[lo:hi] = True
        i = j + 1
    chordal = count >= min_voices
    # binary opening on the time axis: drop short True runs, then demote
    # regions the v1 stream reads as note SEQUENCES
    out = chordal.copy()
    i = 0
    while i < total_frames:
        if chordal[i]:
            j = i
            while j < total_frames and chordal[j]:
                j += 1
            if j - i < min_chord_frames:
                out[i:j] = False
            elif v1_events is not None:
                # a RUN reads as ≥2 short v1 events with all-DISTINCT
                # pitches and no long locked event; a chord's pYIN
                # oscillation also mints short events, but it REVISITS
                # the few chord voices (measured 43/48/43/48 alternation)
                # and a long locked event rides alongside
                inside = [e for e in v1_events if i <= e["start"] < j]
                shorts = [e["note"] for e in inside
                          if (e["end"] - e["start"] + 1) <= short_frames]
                has_long = any((e["end"] - e["start"] + 1) >= 12
                               for e in inside)
                if (len(shorts) >= 2 and len(set(shorts)) == len(shorts)
                        and not has_long and not strong[i:j].any()):
                    out[i:j] = False
            i = j
        else:
            i += 1
    return out


def adjudicate_poly_stream(poly_events: List[dict],
                           v1_events: List[dict],
                           cqt_mag: np.ndarray, sr: int,
                           hop_length: int) -> List[dict]:
    """Physics re-adjudication of the poly stream BEFORE routing, with
    the v1 stream as extra parent context and WITHOUT the chord engine's
    salience exemption: in dense mono material a ghost's parent poly
    event erodes, the chord chain's salience exemption fires, and
    same-pluck h2/h3/h5/h7 ghosts ride through (measured: precision 0.65
    on a pure mono line when poly events were trusted as-is).  Running
    this before polyphony_regions matters: surviving ghosts otherwise
    mark their own chordal region and keep themselves.  Physics-tagged
    events pass unjudged (their evidence is an explicit measurement);
    true octave voices keep their beat-evidence out (beat_scan).  The
    windows are shorter than the chord engine's (min 4 frames, 70 ms
    attack skip): mono plucks are 0.2-0.35 s and the chord defaults left
    most ghosts unjudged (measured 0.78 -> 0.87 -> 0.92 F1 as the
    window shrank)."""
    tagged = {id(e) for e in poly_events
              if e.get("recovered_octave") or e.get("recovered_fifth")
              or e.get("repitched_octave") or e.get("rescued_root")}
    # poly-internal parents only: the v1 stream oscillates on chords and
    # its bogus locked pitches (a sub-octave 43 under a [48,52,55] strum)
    # would put real chord voices on phantom harmonic lines (measured:
    # pure-chord F1 0.55-0.70 with v1 in the pool).  The eroded-parent
    # problem this pool was meant to fix is already handled by removing
    # the salience exemption — the weak parent EXISTS in the poly stream
    pool = list(poly_events)
    # one dB plane + envelope-stat memo across both judging passes (the
    # same threading refine_poly_events uses; core.poly._EnvCache)
    dbp = P._dbp(cqt_mag)
    ecache = P._EnvCache(dbp, sr / hop_length)
    survived = {id(e) for e in P.drop_leakage_ghosts(
        pool, cqt_mag, sr, hop_length, min_frames=4, db=dbp, cache=ecache)}
    pool2 = [e for e in pool if id(e) in survived or id(e) in tagged]
    survived2 = {id(e) for e in P.drop_straight_harmonic_ghosts(
        pool2, cqt_mag, sr, hop_length,
        line_harmonics=tuple(range(2, 11)), sal_guard=None,
        beat_scan=True, min_frames=4, attack_skip_s=0.07,
        db=dbp, cache=ecache)}
    return [e for e in poly_events
            if id(e) in tagged
            or (id(e) in survived and id(e) in survived2)]


def route_events(v1_events: List[dict], poly_events: List[dict],
                 chordal: np.ndarray,
                 cqt_mag: Optional[np.ndarray] = None,
                 sr: int = 22050, hop_length: int = 512) -> List[dict]:
    """Merge the two streams by regime (span-majority), then drop
    same-pitch overlapping duplicates in favour of the poly event."""
    def frac(e):
        lo = max(e["start"], 0)
        hi = min(e["end"] + 1, len(chordal))
        if hi <= lo:
            return 0.0
        return float(chordal[lo:hi].mean())

    from aegis_tpu.config import midi_to_hz

    # concurrent-candidate rows come from the shared vectorized pair
    # sweep (core.poly._overlap_rows) — the recovery-chain invariant: no
    # routing pass re-scans the whole event list per event (the naive
    # generator regrew O(E^2) here; equivalence pinned by
    # tests/test_recovery_scans.py::test_route_short_ghost_matches_naive)
    rows = P._overlap_rows(poly_events)

    def short_ghost(i, e):
        """A SHORT poly event on a concurrent lower event's partial line
        with sub-parent salience: too short for the raw-CQT physics
        passes to judge (their min_frames window), and exactly the
        same-pluck harmonic residue that flooded a dense mono line when
        trusted (measured: h2/h5/h7-line events of each pluck, all under
        12 frames).  Chord-family voices are all long, so the guard costs
        the chordal regime nothing."""
        if e["end"] - e["start"] + 1 >= 12:
            return False
        f_e = midi_to_hz(e["note"])
        for j in rows[i]:
            o = poly_events[j]
            if e.get("salience", 0.0) >= o.get("salience", 0.0):
                continue
            # sub-octave redirect ghost: a short event whose +12 sits on a
            # stronger concurrent voice is the repitch signature, too short
            # for the raw-CQT physics window's min_frames (measured, mixed
            # seed 10: phantom 40/43 under the real 52/55 at the
            # chord->run boundary, 4-8 frames at 1/13 the salience)
            if o["note"] == e["note"] + 12:
                return True
            if o["note"] < e["note"] and any(
                    abs(12.0 * np.log2(f_e / (h * midi_to_hz(o["note"]))))
                    <= 1.2 for h in range(2, 11)):
                return True
        return False

    # the peel's range runs to the CQT floor (MIDI 24); in the routing
    # context everything below the guitar's E2 (reference range 40-88,
    # guitar_fret_filter.py:10-16) is attack-splash junk the run regime
    # mints at chord boundaries (measured: a 2-frame MIDI-25 event)
    kept = [dict(e, source="poly") for i, e in enumerate(poly_events)
            if frac(e) >= 0.5 and 40 <= e["note"] <= 88
            and not short_ghost(i, e)]
    for e in v1_events:
        if frac(e) >= 0.5:
            continue  # a one-voice shadow of a chord the peel already has
        dup = any(p["note"] == e["note"]
                  and p["start"] <= e["end"] and e["start"] <= p["end"]
                  for p in kept)
        if not dup:
            kept.append(dict(e, source="v1"))
    kept.sort(key=lambda ev: (ev["start"], ev["note"]))
    return kept


def dispatch_analyze_auto(y: np.ndarray, eng: "AegisAutoEngine",
                          rake_sensitivity: float = 0.6):
    """Async half of the dual-program analyze (mirrors
    core.analyze.dispatch_analyze): bucket-pad, int8-quantize, dispatch
    the fused v1+peel program and return a handle WITHOUT blocking — a
    folder sweep puts every track in flight before fetching any.
    Resolve with fetch_analyze_auto(handle, eng)."""
    import jax.numpy as jnp

    true_frames = 1 + len(y) // eng.hop_length
    n = bucket_length(len(y))
    # int8 block-float transport: proven transparent for BOTH halves
    # (v1 gating clips F1 1.0000, core/analyze.py::quantize_pcm8;
    # poly 32-case sweep identical F1, engine/poly.py docstring)
    y8, s = quantize_pcm8(np.pad(np.asarray(y, np.float32),
                                 (0, n - len(y))))
    buf = analyze_auto_program_packed(
        jnp.asarray(y8), jnp.asarray(s), jnp.float32(rake_sensitivity),
        eng.audio, eng.pyin_cfg, eng.n_fft_poly, eng.n_bins,
        eng.bins_per_octave, eng.max_voices)
    return buf, true_frames


def fetch_analyze_auto(handle, eng: "AegisAutoEngine") -> Dict:
    """Blocking half: one packed transfer, host unpack of both halves."""
    buf, true_frames = handle
    buf = np.asarray(buf)[:true_frames]
    n_v1 = len(_V1_ROWS)
    return {"v1": _unpack(buf[:, :n_v1], _V1_ROWS, n_mels=0),
            "poly": P.unpack_poly_voices(buf[:, n_v1:], eng.max_voices,
                                         eng.bins_per_octave)}


class AegisAutoEngine:
    """Two-phase polyphony-aware engine: ONE analyze() upload feeds both
    sub-pipelines; extract_events() routes per the module docstring."""

    def __init__(self, sample_rate: int = 22050, n_bins: int = 84,
                 bins_per_octave: int = 12, max_voices: int = 6):
        scale = max(1, round(sample_rate / 22050))
        self.sr = sample_rate
        self.hop_length = 512 * scale
        self.n_fft_poly = 2048 * scale
        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave
        self.max_voices = max_voices
        self.audio = AudioConfig(sample_rate=sample_rate,
                                 hop_length=self.hop_length)
        self.pyin_cfg = PyinConfig()
        self._poly = P  # namespace convenience

    # ----------------------------------------------------------- phase one

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
        log.info(f"Auto Perception Phase ({len(y)/self.sr:.1f}s, "
                 f"pyin + <= {self.max_voices} voices)")
        out = fetch_analyze_auto(dispatch_analyze_auto(
            y, self, kwargs.get("rake_sensitivity", 0.6)), self)
        out["y"] = y
        return out

    # ----------------------------------------------------------- phase two

    def extract_events(self, analysis: Dict, output_mid=None,
                       **kwargs) -> List[dict]:
        from aegis_tpu.engine.poly import AegisPolyEngine

        poly_an = analysis["poly"]
        v1_an = analysis["v1"]
        peng = AegisPolyEngine(sample_rate=self.sr)
        poly_events = peng.extract_events(poly_an, **kwargs)

        v1_events = extract_events_v1(
            rake_mask=np.asarray(v1_an["rake_mask"]),
            f0=np.nan_to_num(np.asarray(v1_an["f0"], np.float64)),
            voiced_flag=np.asarray(v1_an["voiced_flag"]),
            active_probs=np.asarray(v1_an["voiced_probs"], np.float64),
            rms=np.asarray(v1_an["rms"], np.float64),
            sr=self.sr, hop_length=self.hop_length,
            onset_env=np.asarray(v1_an["onset_env"], np.float64),
            confidence_threshold=kwargs.get("confidence_threshold", 0.70),
            # fast runs are the v1 stream's whole purpose here: an 85 ms
            # pluck loses ~2 frames to pYIN's pitch lock and lands at
            # ~46 ms — the v1 default 50 ms floor dropped exactly the
            # mid-run notes (measured: 64/60 missing from both runs at
            # 50 ms, all 16 run notes present at 40 ms)
            min_note_duration_ms=kwargs.get("min_note_duration_ms", 40.0),
            sustain_ms=kwargs.get("v1_sustain_ms", 50.0),
        )
        T = poly_an["roll"].shape[0]
        if "cqt_mag" in poly_an:
            poly_events = adjudicate_poly_stream(
                poly_events, v1_events, np.asarray(poly_an["cqt_mag"]),
                self.sr, self.hop_length)
        chordal = polyphony_regions(poly_events, T, v1_events=v1_events)
        events = route_events(v1_events, poly_events, chordal)
        if output_mid is not None:
            bpm = kwargs.get("bpm")
            if bpm == "auto":
                from aegis_tpu.core.tempo import estimate_bpm

                bpm = estimate_bpm(v1_an, self.sr, self.hop_length)
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
        from aegis_tpu.midi.tabs import generate_tabs_chords

        return generate_tabs_chords(events, self.sr, self.hop_length)
