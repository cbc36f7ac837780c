"""Online streaming transcriber: chunked feeding matches the offline turbo
pipeline once the causal dB reference has locked (loud-first clip)."""

import numpy as np

from aegis_tpu.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu.engine.realtime import StreamingTranscriber
from aegis_tpu.engine.turbo import run_analyze_turbo
from aegis_tpu.tools.signal_gen import karplus_strong

SR = 22050
AUDIO = AudioConfig(sample_rate=SR)


def _loud_first_clip():
    """Loudest attack first, so the running dB reference equals the global
    one from tile 0 (the causal-vs-offline difference vanishes)."""
    rng = np.random.default_rng(3)
    parts = [karplus_strong(110.0, 0.8, SR, rng=rng),          # loud A2
             0.5 * karplus_strong(146.83, 0.7, SR, rng=rng),   # D3
             0.4 * karplus_strong(196.0, 0.7, SR, rng=rng)]    # G3
    y = np.concatenate(parts)
    return (y / max(np.max(np.abs(y)), 1e-9) * 0.8).astype(np.float32)


def test_streaming_matches_turbo_events():
    from aegis_tpu.core.events import extract_events_v1
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    y = _loud_first_clip()
    tile, halo = 16, 8
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=tile, halo_frames=halo,
                              confidence_threshold=0.5)
    rng = np.random.default_rng(0)
    pos = 0
    while pos < len(y):  # arbitrary chunk sizes incl. tiny ones
        n = int(rng.integers(100, 9000))
        rt.feed(y[pos: pos + n])
        pos += n
    live = rt.poll_events()  # callable mid-stream
    got = rt.finalize()
    assert got, "no events from the stream"
    assert len(live) <= len(got) + 1

    tr = run_analyze_turbo(y, AUDIO, PyinConfig(),
                           turbo=TurboConfig(tile_frames=tile,
                                             halo_frames=halo))
    ref = extract_events_v1(
        rake_mask=tr["rake_mask"], f0=np.nan_to_num(tr["f0"]),
        voiced_flag=tr["voiced_flag"], active_probs=tr["voiced_probs"],
        rms=tr["rms"], sr=SR, hop_length=512, confidence_threshold=0.5,
        onset_env=tr["onset_env"])  # the stream refines by default too
    m = note_event_f1(events_to_seconds(ref, SR, 512),
                      events_to_seconds(got, SR, 512))
    assert m["f1"] == 1.0, (m, ref, got)


def test_streaming_lookahead_and_empty():
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8)
    assert 0 < rt.lookahead_s < 2.0
    assert rt.poll_events() == []
    assert rt.finalize() == []
    # silence stream: analyzes tiles, emits nothing
    rt2 = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8)
    rt2.feed(np.zeros(SR, np.float32))
    assert rt2.finalize() == []


def test_streaming_incremental_tiles():
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8)
    tile_samp = 16 * 512
    ctx = rt._ctx
    # not enough for the first tile's right halo yet
    assert rt.feed(np.zeros(tile_samp, np.float32)) == 0
    # completing the halo releases exactly one tile
    assert rt.feed(np.zeros(2 * ctx, np.float32)) == 1


# -------------------------------------------------------------------- poly

def test_streaming_poly_matches_offline():
    """Polyphonic live streaming: finalize() reproduces the offline
    AegisPolyEngine events exactly — the raw-voice transport lets the host
    apply the TRUE global acceptance peak retroactively at poll time, so
    unlike the v1 stream there is no causal-reference caveat (the onset
    envelope's running dB ref cancels in the flux difference)."""
    from aegis_tpu.engine.poly import AegisPolyEngine
    from aegis_tpu.engine.realtime import StreamingPolyTranscriber
    from aegis_tpu.tools.signal_gen import generate_chord_progression
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    y, truth = generate_chord_progression(7, sr=SR)
    eng = AegisPolyEngine(sample_rate=SR)
    offline = eng.extract_events(eng.analyze(y))

    rt = StreamingPolyTranscriber(sample_rate=SR)
    assert rt.poll_events() == []
    assert 0 < rt.lookahead_s < 3.0
    rng = np.random.default_rng(0)
    pos = 0
    while pos < len(y):  # arbitrary chunk sizes incl. tiny ones
        n = int(rng.integers(100, 9000))
        rt.feed(y[pos: pos + n])
        pos += n
    live = rt.poll_events()  # callable mid-stream
    got = rt.finalize()
    assert got and live
    m = note_event_f1(events_to_seconds(offline, SR, 512),
                      events_to_seconds(got, SR, 512))
    assert m["f1"] == 1.0, (m, offline, got)
    # and both match the generator's ground truth
    assert note_event_f1(truth, events_to_seconds(got, SR, 512))["f1"] == 1.0


def test_low_latency_configs():
    """The documented low-latency presets (VALIDATION.md round 3: the device
    sweep measured truth F1 1.0000 at every config) hold event accuracy
    on the virtual mesh too: smaller tiles change seam positions, not
    event content."""
    from aegis_tpu.config import AudioConfig
    from aegis_tpu.engine.realtime import (StreamingPolyTranscriber,
                                           StreamingTranscriber)
    from aegis_tpu.tools.signal_gen import (generate_bench_track,
                                            generate_chord_progression)
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    # the sweep's exact 20 s clip (a 10 s cut loses its duration-truncated
    # final note to the min-duration floor — measured, not seam-related)
    y, truth = generate_bench_track(20.0, sr=SR, return_truth=True)
    rt = StreamingTranscriber(audio=AudioConfig(sample_rate=SR),
                              tile_frames=16, halo_frames=8,
                              confidence_threshold=0.5)
    rt.feed(y)
    got = rt.finalize()
    assert rt.lookahead_s < 0.7
    f1 = note_event_f1(truth, events_to_seconds(got, SR, 512))["f1"]
    assert f1 == 1.0, f1

    yc, tc = generate_chord_progression(7, sr=SR)
    rp = StreamingPolyTranscriber(sample_rate=SR, tile_frames=24,
                                  halo_frames=8)
    rp.feed(yc)
    gotp = rp.finalize()
    assert rp.lookahead_s < 0.9
    f1p = note_event_f1(tc, events_to_seconds(gotp, SR, 512))["f1"]
    assert f1p == 1.0, f1p


def test_streaming_poly_buffer_bounded():
    """The raw-sample buffer is trimmed as tiles complete — host memory is
    bounded by (tile + 2*ctx) samples plus the per-frame output rows."""
    from aegis_tpu.engine.realtime import StreamingPolyTranscriber

    rt = StreamingPolyTranscriber(sample_rate=SR, tile_frames=16,
                                  halo_frames=4)
    rng = np.random.default_rng(1)
    for _ in range(40):
        rt.feed(rng.standard_normal(4096).astype(np.float32) * 0.2)
    bound = rt._tile_samp + 2 * rt._ctx + 4096
    assert len(rt._buf) <= bound, (len(rt._buf), bound)
    assert rt.frames_analyzed > 0


# --------------------------------------------------------------- financial

def test_streaming_financial_matches_offline():
    """financial=True live streaming: per-tile guitar filters on device,
    the whole-track trend stack recomputed over everything-so-far via the
    CPU oracle at poll time.  finalize() must match the offline financial
    engine's events on a loud-first clip (where the causal dB reference
    equals the global one)."""
    from aegis_tpu.engine.financial import AegisFinancialEngine
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    y = _loud_first_clip()
    eng = AegisFinancialEngine(sample_rate=SR, backend="ref")
    offline, _ = eng.extract_events(eng.analyze(y))

    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              financial=True)
    assert rt.poll_events() == []
    rng = np.random.default_rng(0)
    pos = 0
    while pos < len(y):
        n = int(rng.integers(100, 9000))
        rt.feed(y[pos: pos + n])
        pos += n
    live = rt.poll_events()
    got = rt.finalize()
    assert got and live
    m = note_event_f1(events_to_seconds(offline, SR, 512),
                      events_to_seconds(got, SR, 512))
    assert m["f1"] >= 0.99, (m, offline, got)


def test_streaming_financial_incremental_trend():
    """Live polls use an O(new-frames) incremental trend (warmup-overlap
    tail recompute); its output must be numerically indistinguishable from
    the full-track oracle pass, and poll events must equal finalize's
    exact-pass events."""
    y = _loud_first_clip()
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              financial=True)
    rt._TREND_WARMUP = 64  # exercise several incremental appends
    rng = np.random.default_rng(2)
    pos = 0
    polls = 0
    while pos < len(y):
        n = int(rng.integers(3000, 12000))
        rt.feed(y[pos: pos + n])
        pos += n
        rt.poll_events()  # grow the cache incrementally
        polls += 1
    assert polls >= 3
    inc = rt._analysis()          # incremental path
    full = rt._analysis(exact=True)
    T = len(full["trend"])
    np.testing.assert_allclose(inc["trend"][:T], full["trend"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(inc["artic_codes"][:T],
                                  full["artic_codes"])
    live = rt._extract({k: (v[:T] if getattr(v, "ndim", 0) else v)
                        for k, v in inc.items()})
    final = rt.finalize()
    assert [e["note"] for e in live] == [e["note"] for e in final]


def test_finalize_is_terminal_and_idempotent():
    """feed() after finalize() must raise (the tail pad would time-shift
    later events and a re-finalize would trim real audio); repeat
    finalize() and post-finalize polls serve the finalized result."""
    import pytest

    from aegis_tpu.engine.realtime import StreamingPolyTranscriber

    y = _loud_first_clip()
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              confidence_threshold=0.5)
    rt.feed(y)
    final = rt.finalize()
    assert final
    assert [e["note"] for e in rt.finalize()] == [e["note"] for e in final]
    assert [e["note"] for e in rt.poll_events()] == \
        [e["note"] for e in final]
    with pytest.raises(RuntimeError):
        rt.feed(np.zeros(1000, np.float32))

    rp = StreamingPolyTranscriber(sample_rate=SR, tile_frames=32,
                                  halo_frames=8)
    rp.feed(y)
    pf = rp.finalize()
    assert [e["note"] for e in rp.finalize()] == [e["note"] for e in pf]
    assert [e["note"] for e in rp.poll_events()] == [e["note"] for e in pf]
    with pytest.raises(RuntimeError):
        rp.feed(np.zeros(1000, np.float32))


# ---------------------------------------------------------------------------
# Finalized-event horizon (round 4): poll_events must equal the cache-free
# full re-extraction at EVERY poll of a growing session, including across
# fingerprint invalidations (a new loudest attack) and cut advances.
# ---------------------------------------------------------------------------

def _melody_clip(seconds: float, louder_at: float | None = None):
    """Looped short melody; optionally a mid-stream louder attack (peak
    fingerprint invalidation coverage)."""
    rng = np.random.default_rng(5)
    notes = [110.0, 146.83, 196.0, 164.81]
    parts = []
    t = 0.0
    k = 0
    while t < seconds:
        amp = 0.5
        if louder_at is not None and t >= louder_at:
            amp = 0.9 if t < louder_at + 0.8 else 0.6
        parts.append(amp * karplus_strong(notes[k % len(notes)], 0.7, SR,
                                          rng=rng))
        k += 1
        t += 0.7
    y = np.concatenate(parts)
    return (y / max(np.max(np.abs(y)), 1e-9) * 0.8).astype(np.float32)


def _drive_horizon(rt, y, poll_every_s=3.0, sr=SR):
    """Feed in chunks; at each poll assert poll_events == _poll_full."""
    chunk = int(0.5 * sr)
    next_poll = poll_every_s
    cuts = []
    for i in range(0, len(y), chunk):
        rt.feed(y[i:i + chunk])
        if (i + chunk) / sr >= next_poll:
            next_poll += poll_every_s
            got = rt.poll_events()
            full = rt._poll_full()
            assert got == full, (len(got), len(full),
                                 [(a, b) for a, b in zip(got, full)
                                  if a != b][:2])
            if rt._hzn is not None:
                cuts.append(rt._hzn["cut"])
    return cuts


def test_horizon_poll_equals_full_v1():
    y = _melody_clip(30.0, louder_at=14.0)
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              confidence_threshold=0.5)
    cuts = _drive_horizon(rt, y)
    assert cuts and cuts[-1] > cuts[0], cuts  # the cut engaged and advanced
    # finalize is unaffected by the poll cache
    final = rt.finalize()
    assert final and rt.poll_events() == final


def test_horizon_poll_equals_full_financial():
    y = _melody_clip(35.0)
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              financial=True)
    cuts = _drive_horizon(rt, y)
    assert cuts, "financial horizon never engaged"
    final = rt.finalize()
    assert final and rt.poll_events() == final


def test_horizon_poll_equals_full_poly():
    from aegis_tpu.engine.realtime import StreamingPolyTranscriber
    from aegis_tpu.tools.signal_gen import generate_chord_progression

    y7, _ = generate_chord_progression(7, sr=SR)
    y3, _ = generate_chord_progression(3, sr=SR)
    y = np.tile(np.concatenate([y7, y3]), 3)[: int(30 * SR)]
    rt = StreamingPolyTranscriber(sample_rate=SR)
    cuts = _drive_horizon(rt, y)
    assert cuts and cuts[-1] > cuts[0], cuts
    final = rt.finalize()
    assert final and rt.poll_events() == final


def test_horizon_poll_equals_full_v1_chug():
    """Chain-merged same-pitch material (palm-mute chug: re-attacks whose
    gaps sit under the sustain merge) re-split at every onset: split
    pieces inherit the chain head's attributes, so cuts inside a chain
    would splice wrong confidences — the chain-span crossing test must
    keep the cut outside (round-4 self-review fix)."""
    rng = np.random.default_rng(9)
    parts = []
    t = 0.0
    while t < 30.0:
        seg = karplus_strong(110.0, 0.24, SR, rng=rng)  # same pitch, dense
        parts.append(seg[: int(0.23 * SR)])
        t += 0.23
    y = np.concatenate(parts)
    y = (y / max(np.max(np.abs(y)), 1e-9) * 0.8).astype(np.float32)
    rt = StreamingTranscriber(audio=AUDIO, tile_frames=16, halo_frames=8,
                              confidence_threshold=0.5)
    _drive_horizon(rt, y)
    final = rt.finalize()
    assert final and rt.poll_events() == final


def test_rowcat_view_equals_fresh_concatenate():
    """The _RowCat append-only cache must return exactly what a fresh
    np.concatenate over the row blocks would, at every growth step, and
    reset itself if the block list ever shrinks."""
    import numpy as np

    from aegis_tpu.engine.realtime import _RowCat

    rng = np.random.default_rng(1)
    cat = _RowCat()
    rows = []
    for _ in range(40):
        rows.append(rng.normal(0, 1, (int(rng.integers(1, 50)), 7))
                    .astype(np.float32))
        got = cat.view(rows)
        want = np.concatenate(rows, axis=0)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    rows = rows[:5]
    got = cat.view(rows)
    assert got.tobytes() == np.concatenate(rows, axis=0).tobytes()
