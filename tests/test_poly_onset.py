"""Polyphonic CQT transcription, onset detection, chord tabs, folder sweep."""

import os

import numpy as np
import pytest

from aegis_tpu.tools.signal_gen import karplus_strong

SR = 22050


def _chord_clip(midis, dur=1.2, sr=SR, rng=None):
    rng = rng or np.random.default_rng(0)
    n = int(sr * dur)
    y = np.zeros(n, np.float32)
    for m in midis:
        f = 440.0 * 2 ** ((m - 69) / 12)
        y[: n] += karplus_strong(f, dur, sr, rng=rng)[:n]
    return (y / max(np.max(np.abs(y)), 1e-9) * 0.8).astype(np.float32)


@pytest.fixture(scope="module")
def c_major_clip():
    return _chord_clip([60, 64, 67])  # C4 E4 G4


def test_cqt_peak_bin(c_major_clip):
    import jax.numpy as jnp

    from aegis_tpu.core.cqt import CQT_FMIN_MIDI, pseudo_cqt_t

    t = np.arange(SR) / SR
    y = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)  # A3 = 57
    cqt = np.asarray(pseudo_cqt_t(jnp.asarray(y), SR))
    peak_bin = int(np.median(np.argmax(cqt[5:-5], axis=1)))
    midi = CQT_FMIN_MIDI + peak_bin  # 12 bins/octave
    assert abs(midi - 57) <= 1


def test_chroma_cqt(c_major_clip):
    import jax.numpy as jnp

    from aegis_tpu.core.cqt import chroma_cqt_t

    ch = np.asarray(chroma_cqt_t(jnp.asarray(c_major_clip), SR))
    mean = ch.mean(axis=0)
    top3 = set(np.argsort(mean)[-3:])
    assert {0, 4, 7} <= top3  # C, E, G pitch classes dominate


def test_onset_detection():
    import jax.numpy as jnp

    from aegis_tpu.core.cqt import onset_envelope_program, pick_onsets

    rng = np.random.default_rng(3)
    gap = np.zeros(SR // 4, np.float32)

    def pluck(f):
        y = karplus_strong(f, 0.4, SR, rng=rng)
        fade = min(len(y), SR // 20)
        y[-fade:] *= np.linspace(1, 0, fade)  # no end-of-note click
        return y

    # leading silence: spectral flux cannot see an attack at sample 0
    y = np.concatenate([
        gap, pluck(196.0), gap, pluck(246.9), gap, pluck(196.0),
    ]).astype(np.float32)
    env = np.asarray(onset_envelope_program(jnp.asarray(y), SR))
    onsets = pick_onsets(env, SR, 512)
    assert 3 <= len(onsets) <= 5, f"expected ~3 onsets, got {len(onsets)}"
    times = onsets * 512 / SR
    for expect in (0.25, 0.9, 1.55):  # pluck attacks
        assert any(abs(t - expect) < 0.15 for t in times), (expect, times)


def test_polyphonic_chord(c_major_clip):
    from aegis_tpu.engine.poly import AegisPolyEngine

    engine = AegisPolyEngine(sample_rate=SR)
    analysis = engine.analyze(c_major_clip)
    events = engine.extract_events(analysis, use_onsets=False)
    notes = {e["note"] for e in events}
    assert {60, 64, 67} <= notes, f"chord notes missing: {notes}"
    # harmonics of C4 (72, 76, 79...) must not dominate: every detected note
    # should be one of the chord tones or a near neighbor
    spurious = [n for n in notes if min(abs(n - m) for m in (60, 64, 67)) > 1]
    assert len(spurious) <= 1, f"too many spurious notes: {spurious}"


def test_poly_midi_roundtrip(c_major_clip, tmp_path):
    from aegis_tpu.engine.poly import AegisPolyEngine
    from aegis_tpu.midi.decode import midi_to_notes

    engine = AegisPolyEngine(sample_rate=SR)
    out = str(tmp_path / "chord.mid")
    engine.audio_to_midi(c_major_clip, out, use_onsets=False)
    decoded = {n["note"] for n in midi_to_notes(open(out, "rb").read())}
    assert {60, 64, 67} <= decoded


def test_chord_tabs_distinct_strings(c_major_clip):
    from aegis_tpu.midi.tabs import generate_tabs_chords

    events = [
        {"note": 60, "start": 0, "end": 50, "technique": None},
        {"note": 64, "start": 1, "end": 50, "technique": None},
        {"note": 67, "start": 2, "end": 50, "technique": None},
    ]
    tabs = generate_tabs_chords(events, SR, 512)
    assert len(tabs) == 3
    strings = [t["string"] for t in tabs]
    assert len(set(strings)) == 3, f"chord notes share strings: {strings}"
    # fingering is physically playable: frets within a 5-fret span
    frets = [t["fret"] for t in tabs if t["fret"] > 0]
    if frets:
        assert max(frets) - min(frets) <= 5


def test_label_chords(c_major_clip):
    """Poly events -> named chord groups."""
    from aegis_tpu.engine.poly import AegisPolyEngine

    eng = AegisPolyEngine(sample_rate=SR)
    events = eng.extract_events(eng.analyze(c_major_clip))
    chords = eng.label_chords(events)
    assert chords and chords[0]["name"] == "C", chords
    assert set(chords[0]["notes"]) >= {60, 64, 67}
    assert chords[0]["time_sec"] < 0.3


def test_chord_ascii_single_column():
    """Chord notes stack in ONE tab column; lines stay aligned."""
    from aegis_tpu.midi.tabs import generate_tabs_chords, render_ascii_tab

    events = [
        {"note": 60, "start": 0, "end": 50, "technique": None},
        {"note": 64, "start": 1, "end": 50, "technique": None},
        {"note": 67, "start": 2, "end": 50, "technique": None},
        {"note": 62, "start": 40, "end": 90, "technique": None},
    ]
    tabs = generate_tabs_chords(events, SR, 512)
    # the chord's three entries share one column time; the late note doesn't
    assert sorted(set(t["time"] for t in tabs)) == [0, 40]
    # per-note frame bounds are preserved for the UIs
    assert sorted(t["m_start"] for t in tabs) == [0, 1, 2, 40]

    text = render_ascii_tab(tabs)
    block = [ln for ln in text.splitlines() if ln]
    assert len(block) == 6
    assert len({len(ln) for ln in block}) == 1, block  # aligned columns
    # exactly two columns: strings with no note in a column show dashes,
    # so each line contains at most two digit runs
    import re
    for ln in block:
        assert len(re.findall(r"\d+", ln)) <= 2, ln


def test_split_events_at_onsets():
    from aegis_tpu.core.cqt import split_events_at_onsets

    events = [{"note": 60, "start": 0, "end": 100, "velocity": 90}]
    out = split_events_at_onsets(events, np.array([40, 70]))
    assert [(e["start"], e["end"]) for e in out] == [(0, 39), (40, 69),
                                                     (70, 100)]
    # onset too close to the boundary does not split
    out2 = split_events_at_onsets(events, np.array([1, 99.5]))
    assert len(out2) == 1


def test_transcribe_folder(tmp_path):
    from aegis_tpu.engine.poly import transcribe_folder
    from aegis_tpu.io.wav import write_wav
    from aegis_tpu.midi.decode import midi_to_notes

    rng = np.random.default_rng(9)
    expected = {"a.wav": 55, "b.wav": 62}
    for name, midi in expected.items():
        f = 440.0 * 2 ** ((midi - 69) / 12)
        y = karplus_strong(f, 1.0, SR, rng=rng)
        write_wav(str(tmp_path / name), y.astype(np.float32), SR)

    out_dir = tmp_path / "mid"
    results = transcribe_folder(str(tmp_path), str(out_dir),
                                sample_rate=SR,
                                confidence_threshold=0.3)
    assert len(results) == 2
    for wav_path, mid_path, n_events in results:
        assert n_events >= 1
        notes = {n["note"] for n in midi_to_notes(open(mid_path, "rb").read())}
        assert expected[os.path.basename(wav_path)] in notes


def test_transcribe_folder_mixed_lengths(tmp_path):
    """Tracks in DIFFERENT length buckets: the dispatch-ahead path sends
    each track unpadded at its own bucket (per-track frame counts), and
    each track's events match the per-track engine facade exactly."""
    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.engine.poly import transcribe_folder
    from aegis_tpu.io.wav import write_wav
    from aegis_tpu.midi.decode import midi_to_notes

    rng = np.random.default_rng(11)
    clips = {}
    # 1.0 s -> MIN_BUCKET; 4.0 s -> a larger bucket
    for name, midi, dur in (("short.wav", 55, 1.0), ("long.wav", 62, 4.0)):
        f = 440.0 * 2 ** ((midi - 69) / 12)
        y = np.concatenate([karplus_strong(f, 1.0, SR, rng=rng)
                            for _ in range(int(dur))])[: int(SR * dur)]
        write_wav(str(tmp_path / name), y.astype(np.float32), SR)
        clips[name] = midi

    out_dir = tmp_path / "mid"
    results = transcribe_folder(str(tmp_path), str(out_dir), sample_rate=SR,
                                confidence_threshold=0.3)
    assert len(results) == 2

    eng = AegisEngine(sample_rate=SR)
    for wav_path, mid_path, n_events in results:
        raw = eng.audio_to_midi(wav_path, None, fetch_mel=False)
        expected = eng.extract_events(raw, None, confidence_threshold=0.3)
        assert n_events == len(expected), (wav_path, n_events, len(expected))
        notes = {n["note"] for n in midi_to_notes(open(mid_path, "rb").read())}
        assert clips[os.path.basename(wav_path)] in notes

    # transport plumbing: float32 works everywhere, bogus rejected up front
    assert transcribe_folder(str(tmp_path), str(out_dir), sample_rate=SR,
                             transport="float32",
                             confidence_threshold=0.3)
    with pytest.raises(ValueError):
        transcribe_folder(str(tmp_path), str(out_dir), sample_rate=SR,
                          transport="int7")


def test_transcribe_folder_financial(tmp_path):
    """engine='financial' folder sweep == the per-track financial facade
    (same events, same adaptive threshold, same MIDI notes)."""
    from aegis_tpu.engine.financial import AegisFinancialEngine
    from aegis_tpu.engine.poly import transcribe_folder
    from aegis_tpu.io.wav import write_wav
    from aegis_tpu.midi.decode import midi_to_notes

    rng = np.random.default_rng(13)
    expected = {"a.wav": 57, "b.wav": 64}
    for name, midi in expected.items():
        f = 440.0 * 2 ** ((midi - 69) / 12)
        y = karplus_strong(f, 1.2, SR, rng=rng)
        write_wav(str(tmp_path / name), y.astype(np.float32), SR)

    out_dir = tmp_path / "mid"
    results = transcribe_folder(str(tmp_path), str(out_dir), sample_rate=SR,
                                engine="financial")
    assert len(results) == 2

    feng = AegisFinancialEngine(sample_rate=SR)
    for wav_path, mid_path, n_events in results:
        analysis = feng.analyze(wav_path, fetch_mel=False)
        ev, _ = feng.extract_events(analysis)
        assert n_events == len(ev), (wav_path, n_events, len(ev))
        notes = {n["note"] for n in midi_to_notes(open(mid_path, "rb").read())}
        assert expected[os.path.basename(wav_path)] in notes

    # neural financial folder (the sharded neural batch path on the
    # virtual mesh) == the per-track neural financial facade
    from aegis_tpu.models.pitchnet import have_default_weights

    if have_default_weights():
        results_n = transcribe_folder(str(tmp_path), str(tmp_path / "n"),
                                      sample_rate=SR, engine="financial",
                                      pitch_backend="neural")
        for wav_path, mid_path, n_events in results_n:
            analysis = feng.analyze(wav_path, fetch_mel=False,
                                    pitch_backend="neural")
            ev, _ = feng.extract_events(analysis)
            assert n_events == len(ev), (wav_path, n_events, len(ev))
            notes = {n["note"]
                     for n in midi_to_notes(open(mid_path, "rb").read())}
            assert expected[os.path.basename(wav_path)] in notes


def test_transcribe_folder_poly(tmp_path):
    """engine='poly' folder sweep == the per-track poly facade on chords."""
    from aegis_tpu.engine.poly import AegisPolyEngine, transcribe_folder
    from aegis_tpu.io.wav import write_wav
    from aegis_tpu.midi.decode import midi_to_notes

    rng = np.random.default_rng(3)
    chords = {"c.wav": [60, 64, 67], "d.wav": [57, 60, 64]}
    for name, midis in chords.items():
        write_wav(str(tmp_path / name),
                  _chord_clip(midis, rng=rng), SR)

    out_dir = tmp_path / "mid"
    results = transcribe_folder(str(tmp_path), str(out_dir), sample_rate=SR,
                                engine="poly")
    assert len(results) == 2

    peng = AegisPolyEngine(sample_rate=SR)
    for wav_path, mid_path, n_events in results:
        analysis = peng.analyze(wav_path)
        ev = peng.extract_events(analysis)
        assert n_events == len(ev), (wav_path, n_events, len(ev))
        notes = {n["note"] for n in midi_to_notes(open(mid_path, "rb").read())}
        want = set(chords[os.path.basename(wav_path)])
        assert want <= notes, (wav_path, want, notes)

    with pytest.raises(ValueError):
        transcribe_folder(str(tmp_path), str(out_dir), sample_rate=SR,
                          engine="poly", pitch_backend="neural")
    with pytest.raises(ValueError):
        transcribe_folder(str(tmp_path), str(out_dir), sample_rate=SR,
                          engine="bogus")


def test_v1_engine_onset_split():
    """Two same-pitch re-attacks merged by sustain are split by onsets."""
    from aegis_tpu.engine.engine import AegisEngine

    rng = np.random.default_rng(5)

    def pluck():
        y = karplus_strong(196.0, 0.5, SR, rng=rng)
        fade = SR // 20
        y[-fade:] *= np.linspace(1, 0, fade)
        return y

    gap = np.zeros(int(SR * 0.03), np.float32)  # 30ms gap << sustain merge
    y = np.concatenate([np.zeros(SR // 8, np.float32),
                        pluck(), gap, pluck()]).astype(np.float32)

    eng = AegisEngine(sample_rate=SR, backend="device")
    raw = eng.audio_to_midi(y, None)
    assert "onset_env" in raw
    # use_onsets=False: the reference's merge semantics (the library
    # default is the onset-refined path)
    merged = [e for e in eng.extract_events(raw, None, sustain_ms=200,
                                            confidence_threshold=0.3,
                                            use_onsets=False)
              if e["note"] == 55]
    split = [e for e in eng.extract_events(raw, None, sustain_ms=200,
                                           confidence_threshold=0.3,
                                           use_onsets=True)
             if e["note"] == 55]
    assert len(split) > len(merged), (len(merged), len(split))


def test_cqt_filterbank_no_dead_bins():
    """ADVICE r1: at sr=44100/n_fft=2048 narrow low-frequency triangles fall
    between 21.5 Hz FFT bins (e.g. F#2 ~92.5 Hz) and used to be all-zero —
    every CQT row must keep minimum support so every semitone is live."""
    from aegis_tpu.core.filters import cqt_filterbank

    for sr, n_fft in [(44100, 2048), (22050, 2048), (22050, 1024)]:
        fb = cqt_filterbank(sr, n_fft)
        sums = fb.sum(axis=1)
        assert (sums > 0).all(), f"dead CQT bins at sr={sr} n_fft={n_fft}"

    # F#2 specifically: a pure 92.5 Hz tone must register in its own bin
    fb = cqt_filterbank(44100, 2048)
    fft_freqs = np.linspace(0, 22050, 1025)
    fs2_bin = int(round(12 * np.log2(92.5 / 32.70319566257483)))
    col = int(np.argmin(np.abs(fft_freqs - 92.5)))
    assert fb[fs2_bin, max(0, col - 1): col + 2].sum() > 0
