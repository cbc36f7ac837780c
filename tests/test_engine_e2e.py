"""End-to-end engine tests: device pipeline vs CPU oracle vs ground truth.

This is the framework's correctness gate (BASELINE.md): note-event F1 >= 0.99
between the device pipeline and the NumPy oracle.
"""

import io

import numpy as np
import pytest

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.engine.engine import AegisEngine
from aegis_tpu.engine.financial import AegisFinancialEngine
from aegis_tpu.midi.decode import midi_to_notes
from aegis_tpu.tools.signal_gen import generate_scale_benchmark, generate_test_track
from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

SR = 22050


@pytest.fixture(scope="module")
def ks_track():
    return generate_test_track(sr=SR)


def test_v1_device_vs_oracle_f1(ks_track):
    track, truth = ks_track
    dev = AegisEngine(sample_rate=SR, backend="device")
    ref = AegisEngine(sample_rate=SR, backend="ref")
    raw_d = dev.audio_to_midi(track)
    raw_r = ref.audio_to_midi(track)
    ev_d = dev.extract_events(raw_d, None, confidence_threshold=0.5)
    ev_r = ref.extract_events(raw_r, None, confidence_threshold=0.5)
    m = note_event_f1(
        events_to_seconds(ev_r, SR, 512), events_to_seconds(ev_d, SR, 512)
    )
    assert m["f1"] >= 0.99, m

    # against ground truth: all three notes must be found
    truth_f1 = note_event_f1(truth, events_to_seconds(ev_d, SR, 512),
                             onset_tolerance=0.2)
    assert truth_f1["recall"] == 1.0, truth_f1


def test_v1_midi_output(ks_track):
    track, truth = ks_track
    eng = AegisEngine(sample_rate=SR, backend="device")
    raw = eng.audio_to_midi(track)
    buf = io.BytesIO()
    events = eng.extract_events(raw, buf, confidence_threshold=0.5,
                                sustain_ms=150)
    assert events
    notes = midi_to_notes(buf.getvalue())
    assert len(notes) >= 3
    pitches = {n["note"] for n in notes}
    assert {40, 45, 50} <= pitches


def test_raw_data_roundtrip(tmp_path, ks_track):
    track, _ = ks_track
    eng = AegisEngine(sample_rate=SR, backend="ref")
    raw = eng.audio_to_midi(track)
    p = str(tmp_path / "raw.npz")
    eng.save_raw(raw, p)
    raw2 = eng.load_raw(p)
    ev1 = eng.extract_events(raw, None)
    ev2 = eng.extract_events(raw2, None)
    assert ev1 == ev2


def test_financial_device_vs_oracle(tmp_path):
    y, _, truth = generate_scale_benchmark(sr=SR)
    dev = AegisFinancialEngine(sample_rate=SR, backend="device")
    ref = AegisFinancialEngine(sample_rate=SR, backend="ref")
    a_d = dev.analyze(y)
    a_r = ref.analyze(y)
    ev_d, info_d = dev.extract_events(a_d)
    ev_r, info_r = ref.extract_events(a_r)
    assert abs(info_d["threshold"] - info_r["threshold"]) < 0.02
    m = note_event_f1(
        events_to_seconds(ev_r, SR, 512), events_to_seconds(ev_d, SR, 512)
    )
    assert m["f1"] >= 0.99, m

    # end-to-end file output
    out = str(tmp_path / "fin.mid")
    path = dev.audio_to_midi_financial(y, out)
    assert path == out
    notes = midi_to_notes(out)
    assert len(notes) >= 6  # most of the 8 scale notes survive filtering


def test_financial_key_detection():
    y, _, _ = generate_scale_benchmark(sr=SR, with_rake=False, hiss=0.0)
    eng = AegisFinancialEngine(sample_rate=SR, backend="ref")
    a = eng.analyze(y)
    events, info = eng.extract_events(a)
    assert info["key_info"] is not None
    assert info["key_info"]["key"] == "C"


def test_tabs_and_musicxml(tmp_path, ks_track):
    track, _ = ks_track
    eng = AegisEngine(sample_rate=SR, backend="ref")
    raw = eng.audio_to_midi(track)
    events = eng.extract_events(raw, None, confidence_threshold=0.5)
    tabs = eng.generate_tabs(events)
    assert tabs and all(0 <= t["fret"] <= 24 for t in tabs)
    xml_path = str(tmp_path / "tab.xml")
    eng.export_musicxml(tabs, xml_path)
    content = open(xml_path).read()
    assert "<string>" in content and "<fret>" in content


def test_edge_inputs():
    """Degenerate inputs: silence, near-empty audio, zero-event extraction."""
    import numpy as np

    from aegis_tpu.engine.engine import AegisEngine

    eng = AegisEngine(sample_rate=22050, backend="device")
    # pure silence: analysis succeeds, zero (or noise-gated) events
    raw = eng.audio_to_midi(np.zeros(22050, np.float32), None)
    events = eng.extract_events(raw, None)
    assert events == []
    # sub-frame audio: one frame, no crash
    raw = eng.audio_to_midi(np.zeros(100, np.float32), None)
    assert raw is not None and len(raw["f0"]) >= 1
    # empty audio: None per the facade contract
    assert eng.audio_to_midi(np.zeros(0, np.float32), None) is None


def test_turbo_quantize_edge():
    import numpy as np

    from aegis_tpu.engine.turbo import quantize_tracks

    # all-zero batch: scale 1.0, zeros, no divide-by-zero
    q, scale = quantize_tracks(np.zeros((2, 100), np.float32), 128)
    assert q.shape == (2, 128) and (q == 0).all() and (scale == 1.0).all()
    # round trip is within the int16 LSB
    y = np.linspace(-0.5, 0.5, 64).astype(np.float32)[None]
    q, scale = quantize_tracks(y, 64)
    err = np.abs(q[0].astype(np.float64) * scale[0] - y[0]).max()
    assert err < 2e-5
    # per-track scaling: a 40 dB quieter track keeps full int16 range
    loud = np.sin(np.linspace(0, 50, 256)).astype(np.float32)
    quiet = 0.01 * loud
    q, scale = quantize_tracks(np.stack([loud, quiet]), 256)
    assert scale[1] < scale[0] / 50
    assert np.abs(q[1]).max() > 30000  # quiet track uses the full range


def test_pcm8_transport_roundtrip():
    """int8 block-float transport: per-block error bounded by the LOCAL
    block peak (half an LSB of that block's scale), silent blocks exact,
    non-block-multiple lengths rejected."""
    from aegis_tpu.core.analyze import PCM8_BLOCK, quantize_pcm8

    rng = np.random.default_rng(0)
    # decaying envelope: late blocks are ~40 dB below the track peak
    n = 8 * PCM8_BLOCK
    y = (np.exp(-np.arange(n) / (n / 9.2)) *
         np.sin(2 * np.pi * 196.0 * np.arange(n) / 22050) +
         1e-4 * rng.standard_normal(n)).astype(np.float32)
    q, scales = quantize_pcm8(y)
    assert q.dtype == np.int8 and scales.shape == (8,)
    back = (q.astype(np.float64).reshape(-1, PCM8_BLOCK) *
            scales[:, None].astype(np.float64))
    blocks = y.reshape(-1, PCM8_BLOCK)
    for i in range(8):
        peak = np.abs(blocks[i]).max()
        assert np.abs(back[i] - blocks[i]).max() <= peak / 252
    # a track-global int8 scale could NOT bound the late blocks this way:
    # the local bound is far below one global LSB
    assert scales[-1] < scales[0] / 50

    q, scales = quantize_pcm8(np.zeros(PCM8_BLOCK, np.float32))
    assert (q == 0).all() and (scales == 0).all()
    with pytest.raises(ValueError):
        quantize_pcm8(np.zeros(PCM8_BLOCK + 1, np.float32))


def test_pcm8_transport_event_parity():
    """The default int8 transport must extract the SAME note events as
    bit-exact float32 ingest (measured F1 1.0000 on every gating clip incl.
    the 60 s bench track; this pins the KS clip in CI)."""
    from aegis_tpu.core.analyze import run_analyze
    from aegis_tpu.core.events import extract_events_v1

    track, _ = generate_test_track(sr=SR)
    audio = AudioConfig(sample_rate=SR)
    pyin = PyinConfig()

    def events(transport):
        out = run_analyze(track, audio, pyin, 0.6, transport=transport)
        f0 = np.nan_to_num(out["f0"])
        return extract_events_v1(
            out["rake_mask"], f0, out["voiced_flag"], out["voiced_probs"],
            out["rms"], SR, audio.hop_length, confidence_threshold=0.3,
            onset_env=out["onset_env"])

    e8, ef = events("int8"), events("float32")
    m = note_event_f1(events_to_seconds(ef, SR, 512),
                      events_to_seconds(e8, SR, 512))
    assert m["f1"] == 1.0, m
    assert len(e8) == len(ef)


def test_pcm4_transport_roundtrip():
    """int4 packed transport: device-side nibble decode (dequant_transport)
    must invert the host pack exactly, per-block error bounded by half an
    LSB of the LOCAL block scale (peak/14), silent blocks exact."""
    import jax.numpy as jnp

    from aegis_tpu.core.analyze import (PCM4_BLOCK, dequant_transport,
                                        quantize_pcm4)

    rng = np.random.default_rng(1)
    n = 8 * PCM4_BLOCK
    y = (np.exp(-np.arange(n) / (n / 9.2)) *
         np.sin(2 * np.pi * 196.0 * np.arange(n) / 22050) +
         1e-4 * rng.standard_normal(n)).astype(np.float32)
    packed, scales = quantize_pcm4(y)
    assert packed.dtype == np.uint8 and packed.shape == (n // 2,)
    assert scales.shape == (8,)
    back = np.asarray(dequant_transport(jnp.asarray(packed),
                                        jnp.asarray(scales)))
    assert back.shape == (n,)
    blocks = y.reshape(8, -1)
    backb = back.astype(np.float64).reshape(8, -1)
    for i in range(8):
        peak = np.abs(blocks[i]).max()
        assert np.abs(backb[i] - blocks[i]).max() <= peak / 13.9
    # block scales track the decaying local envelope
    assert scales[-1] < scales[0] / 50

    packed, scales = quantize_pcm4(np.zeros(PCM4_BLOCK, np.float32))
    assert (packed == 0).all() and (scales == 0).all()
    with pytest.raises(ValueError):
        quantize_pcm4(np.zeros(PCM4_BLOCK + 2, np.float32), PCM4_BLOCK + 1)
    with pytest.raises(ValueError):
        quantize_pcm4(np.zeros(PCM4_BLOCK + 2, np.float32))


def test_pcm4_transport_event_parity():
    """transport="int4" must extract the SAME note events as bit-exact
    float32 ingest on the gating clips (offline oracle sweep 2026-08-19:
    F1 1.0000 at block=128 everywhere).  Pins BOTH production rates —
    44.1 kHz is where the neighboring block sizes (64 and 256) each mint
    a spurious event, so it is the rate that would catch a drift."""
    from aegis_tpu.core.analyze import run_analyze
    from aegis_tpu.core.events import extract_events_v1

    for sr in (SR, 44100):
        track, _ = generate_test_track(sr=sr)
        audio = AudioConfig(sample_rate=sr)
        pyin = PyinConfig()

        def events(transport):
            out = run_analyze(track, audio, pyin, 0.6, transport=transport)
            f0 = np.nan_to_num(out["f0"])
            return extract_events_v1(
                out["rake_mask"], f0, out["voiced_flag"],
                out["voiced_probs"], out["rms"], sr, audio.hop_length,
                confidence_threshold=0.3, onset_env=out["onset_env"])

        e4, ef = events("int4"), events("float32")
        m = note_event_f1(events_to_seconds(ef, sr, audio.hop_length),
                          events_to_seconds(e4, sr, audio.hop_length))
        assert m["f1"] == 1.0, (sr, m)
        assert len(e4) == len(ef)


def test_validate_device_gate():
    """The driver's F1 gate (tools.validate_device) must pass on every
    gating clip — incl. sr=44100 — on this backend (CPU here; the tool also
    runs on the GPU, chip_smoke.py phase 3).  VERDICT r1 #3: wired into the
    suite so a drift below 0.99 fails CI, not just the on-device tool."""
    from aegis_tpu.tools.validate_device import validate

    res = validate(include_bench=False, quiet=True)
    assert res["pass"], res


def test_bench_track_truth():
    """generate_bench_track's return_truth timeline must be consistent with
    the audio it labels: monotonic non-overlapping notes from the pentatonic
    set, rake offsets accounted for, and the audio bit-identical to the
    truth-less call (bench.py and validate_device must measure the exact
    same track)."""
    from aegis_tpu.tools.signal_gen import generate_bench_track

    y_plain = generate_bench_track(10.0)
    y, truth = generate_bench_track(10.0, return_truth=True)
    assert np.array_equal(y_plain, y)
    assert len(truth) >= 10
    allowed = {40, 43, 45, 47, 50, 52, 55, 57, 60}
    prev_end = 0.0
    for e in truth:
        assert e["note"] in allowed
        assert 0.0 <= e["start"] < 10.0
        assert e["start"] >= prev_end - 1e-9  # rakes only push notes later
        assert e["end"] <= 10.0 + 1e-9
        assert e["end"] > e["start"]
        prev_end = e["end"]
    # each labeled onset has real energy right after it (the pluck is there)
    sr = 22050
    for e in truth[:20]:
        s = int(e["start"] * sr)
        assert np.abs(y[s:s + 512]).max() > 0.01, e


def test_default_pipeline_truth_f1():
    """The onset-refined default pipeline hits ground truth exactly on the
    truth clips (measured 1.0000 on all four incl. the 60 s bench track on
    the GPU; the two short clips gate here).  use_onsets=False
    (the reference's merge/lag semantics) measures 0.75 on the scale
    track — this test pins the improvement."""
    from aegis_tpu.tools.signal_gen import generate_bench_track

    hop = 512
    kst_y, kst_truth = generate_test_track(sr=22050)
    sc = generate_scale_benchmark(sr=22050)
    bench_y, bench_truth = generate_bench_track(10.0, return_truth=True)
    # a note whose onset falls within ~150 ms of the hard clip end has
    # only unpitched pluck-transient frames before the audio stops — no
    # tracker can report it; the generator can emit one at any duration
    bench_truth = [t for t in bench_truth if t["start"] < 10.0 - 0.15]
    for y, truth, sr in ((kst_y, kst_truth, 22050),
                         (sc[0], sc[2], 22050),
                         (bench_y, bench_truth, 22050)):
        eng = AegisEngine(sample_rate=sr, backend="device")
        raw = eng.audio_to_midi(y, None)
        ev = eng.extract_events(raw, None, confidence_threshold=0.3)
        f1 = note_event_f1(truth, events_to_seconds(ev, sr, hop))["f1"]
        assert f1 >= 0.99, (len(y) / sr, f1)

    # the financial engine's default (pitch_source="pyin") matches truth
    # too; pitch_source="trend" (the reference's over-smoothed series)
    # measured 0.11 on this clip — pinned as strictly worse
    feng = AegisFinancialEngine(sample_rate=22050, backend="device")
    a = feng.analyze(sc[0], fetch_mel=False)
    fev, _ = feng.extract_events(a)
    f1 = note_event_f1(sc[2], events_to_seconds(fev, 22050, hop))["f1"]
    assert f1 >= 0.99, f1
    tev, _ = feng.extract_events(a, pitch_source="trend")
    f1_trend = note_event_f1(sc[2], events_to_seconds(tev, 22050, hop))["f1"]
    assert f1_trend < f1


def test_truth_f1_under_delay_effects(ks_track):
    """Delay/reverb presets used to mint one event per echo (the splitter
    cut sustained notes at echo attacks: truth precision 0.27 on the
    "ambient" preset).  The echo guard (core/events.py SPLIT_MIN_RISE_DB)
    rejects flat-RMS interior onsets; the wet test track must transcribe
    exactly again.  Measured on the 60 s bench track: ambient F1
    0.56 -> 0.85, full_fx 0.76 -> 0.97, clean unchanged at 1.0000."""
    from aegis_tpu.synth.effects import apply_effect_chain
    from aegis_tpu.synth.presets import EFFECT_PRESETS

    track, truth = ks_track
    eng = AegisEngine(sample_rate=SR, backend="device")
    for preset in ("ambient", "full_fx"):
        yfx = np.asarray(
            apply_effect_chain(track, EFFECT_PRESETS[preset], SR),
            np.float32)
        yfx = yfx / (np.abs(yfx).max() / 0.9)
        ev = eng.extract_events(eng.audio_to_midi(yfx, None), None,
                                confidence_threshold=0.3)
        m = note_event_f1(truth, events_to_seconds(ev, SR, 512))
        assert m["f1"] >= 0.99, (preset, m)


# --------------------------------------------------------------------------
# Technique ground truth: audio with a KNOWN articulation -> event label
# --------------------------------------------------------------------------

def _fm_tone(sr, dur, f_of_t, decay=0.6):
    t = np.arange(int(sr * dur)) / sr
    f = f_of_t(t)
    ph = 2 * np.pi * np.cumsum(f) / sr
    return (0.5 * np.sin(ph) * np.exp(-decay * t)).astype(np.float32)


def test_articulation_truth_from_audio():
    """Synthesized vibrato / bend / steady tones, through the FULL pipeline,
    must come out labeled vibrato / bend / unornamented — the audio-level
    truth gate for detect_articulations_v1 (the unit tests feed it f0
    arrays; this feeds it the pipeline's own pitch track)."""
    eng = AegisEngine(sample_rate=SR, backend="device")

    def run(y):
        raw = eng.audio_to_midi(y, None, fetch_mel=False)
        return eng.extract_events(raw, None, confidence_threshold=0.3)

    # vibrato: +-0.45 semitone LFO at 5.5 Hz around A3
    vib = run(_fm_tone(SR, 1.2,
                       lambda t: 220.0 * 2 ** (0.45 / 12 * np.sin(
                           2 * np.pi * 5.5 * t))))
    assert any(e["technique"] == "vibrato" for e in vib), vib

    # bend: a real bend gesture — up 1.0 semitone within 0.3 s, then hold
    # (the rising constant-note segment's slope ~0.08 st/frame clears the
    # 0.05 bend threshold)
    bend = run(_fm_tone(SR, 0.9,
                        lambda t: 220.0 * 2 ** (
                            1.0 / 12 * np.minimum(t / 0.3, 1.0))))
    assert any(e["technique"] == "bend" and e["slope"] > 0 for e in bend), bend

    # slide: a slow 0.9-semitone glide over 0.8 s (slope ~0.026 st/frame —
    # above the 0.02 slide threshold, below the bend one)
    slide = run(_fm_tone(SR, 0.8,
                         lambda t: 220.0 * 2 ** (0.9 / 12 * t / 0.8)))
    assert any(e["technique"] == "slide" for e in slide), slide

    # steady tone: no articulation may be invented
    steady = run(_fm_tone(SR, 1.0, lambda t: 220.0 * np.ones_like(t)))
    assert steady and all(e["technique"] is None for e in steady), steady


def test_noise_robustness_floor():
    """Additive white noise at the measured all-seeds-perfect SNR must not
    move truth F1 (the reference's core value prop is noise-robust
    transcription; VALIDATION.md records the deeper-SNR floor sweep:
    KS stays 1.0 to 10 dB and 4/5 seeds at 5 dB; scale stays 1.0 to
    20 dB and 4/5 seeds at 10 dB)."""
    from aegis_tpu.tools.signal_gen import generate_test_track

    y, truth = generate_test_track(sr=SR)
    eng = AegisEngine(sample_rate=SR, backend="device")

    def with_snr(yy, snr_db, seed):
        rng = np.random.default_rng(seed)
        p = np.mean(yy ** 2) / (10 ** (snr_db / 10))
        return (yy + rng.normal(0, np.sqrt(p), len(yy))).astype(np.float32)

    for snr, yy, tt in ((10.0, y, truth), (20.0, *_scale_truth())):
        for seed in (0, 3):
            ev = eng.extract_events(
                eng.audio_to_midi(with_snr(yy, snr, seed), None,
                                  fetch_mel=False),
                None, confidence_threshold=0.3)
            m = note_event_f1(tt, events_to_seconds(ev, SR, 512))
            assert m["f1"] == 1.0, (snr, seed, m)


def _scale_truth():
    s_y, _, s_truth = generate_scale_benchmark(sr=SR)
    return s_y, s_truth
