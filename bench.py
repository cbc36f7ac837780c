"""Headline benchmark: every pipeline's speed on the GPU, ONE JSON line.

The headline metric stays the financial two-phase realtime factor on a 60 s
synthetic guitar-style track (device analyze = fused mel+rake+pYIN+RMS+trend
program; host event extraction + MIDI encode).  Additional fields substantiate
the other pipelines' claims without breaking the one-line
contract:

    {"metric": "realtime_factor", "value": N, "unit": "x_realtime",
     "vs_baseline": N/4.8,
     "v1_rtf": ..., "neural_rtf": ..., "poly_rtf": ..., "folder_sweep_s": ...,
     "folder_rtf_aggregate": ..., "auto_match_s": ..., "reverse_s": ...,
     "per_note_s": ..., "technique_s": ...}

Baselines (BASELINE.md): financial engine 4.8x realtime on an M1; auto-match
~30 s for a 30 s clip (54 grid evals); reverse analysis ~13 s for a 10 s clip.

Timing: every timed section ends in host work that needs the device's
results (event extraction), or in ``jax.block_until_ready``.  Medians, not
means.  Runs as one process on one GPU; without a GPU it exits non-zero.
The record names the device: JAX's platform, ``device_kind`` and count, and
the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import time

import numpy as np

# The aegis logger mirrors the reference's stdout tags; under the bench's
# ONE-JSON-line stdout contract every log line must go to stderr instead.
from aegis_tpu.utils.logging import get_logger

get_logger("bench")  # force handler setup, then retarget it
for _h in logging.getLogger("aegis").handlers:
    if isinstance(_h, logging.StreamHandler):
        _h.setStream(sys.stderr)


def _median_time(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    print(f"#   iters: {[round(t, 3) for t in times]}", file=sys.stderr)
    return sorted(times)[n // 2]


def measure(device: dict) -> None:
    duration = 60.0
    sr = 22050
    from aegis_tpu.tools.signal_gen import (generate_bench_track,
                                            generate_scale_benchmark,
                                            generate_test_track)

    y = generate_bench_track(duration, sr)

    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.engine.financial import AegisFinancialEngine

    engine = AegisFinancialEngine(sample_rate=sr, backend="device")

    # ---------------- headline: financial two-phase (compile + warm) -------
    t0 = time.perf_counter()
    analysis = engine.analyze(y, fetch_mel=False)
    events, _ = engine.extract_events(analysis)
    warm = time.perf_counter() - t0
    print(f"# warmup (incl. compile): {warm:.1f}s, events={len(events)}",
          file=sys.stderr)

    def fin_iter():
        a = engine.analyze(y, fetch_mel=False)
        engine.extract_events(a)

    fin_iter()
    print("# financial 60s two-phase:", file=sys.stderr)
    elapsed = _median_time(fin_iter, 15)
    rtf = duration / elapsed
    print(f"# steady-state (median): {elapsed:.3f}s per {duration:.0f}s audio",
          file=sys.stderr)

    # ---------------- v1 two-phase on the same track ------------------------
    v1 = AegisEngine(sample_rate=sr, backend="device")

    def v1_iter():
        raw = v1.audio_to_midi(y, None, fetch_mel=False)
        v1.extract_events(raw, None)

    v1_iter()  # compile; measured below interleaved with the 60 s poly loop

    # ---------------- neural (PitchNet) backend on the same track -----------
    from aegis_tpu.models.pitchnet import have_default_weights

    neural_rtf = 0.0
    if have_default_weights():
        def neural_iter():
            raw = v1.audio_to_midi(y, None, fetch_mel=False,
                                   pitch_backend="neural")
            v1.extract_events(raw, None)

        neural_iter()  # compile
        print("# neural (PitchNet) 60s two-phase:", file=sys.stderr)
        neural_rtf = duration / _median_time(neural_iter, 3)

    # ---------------- polyphonic CQT engine (10 s chord track) --------------
    from aegis_tpu.engine.poly import AegisPolyEngine

    rng = np.random.default_rng(7)
    from aegis_tpu.tools.signal_gen import karplus_strong

    tpoly = 10.0
    yp = np.zeros(int(sr * tpoly), np.float32)
    for k, chord in enumerate([(60, 64, 67), (57, 60, 64), (55, 59, 62)] * 4):
        at = int(k * 0.8 * sr)
        for m in chord:
            f = 440.0 * 2 ** ((m - 69) / 12)
            seg = karplus_strong(f, 0.7, sr, rng=rng)
            end = min(at + len(seg), len(yp))
            yp[at:end] += seg[: end - at]
    yp = (yp / max(np.max(np.abs(yp)), 1e-9) * 0.8).astype(np.float32)

    poly = AegisPolyEngine(sample_rate=sr)

    def poly_iter():
        poly.extract_events(poly.analyze(yp))

    poly_iter()  # compile
    print("# poly 10s:", file=sys.stderr)
    poly_rtf = tpoly / _median_time(poly_iter, 3)

    # 60 s chord loop: the engine's amortized throughput on track-length
    # material, comparable with the v1/financial/neural 60 s rows.
    yp60_off = np.tile(yp, 6)[: int(60 * sr)]

    def poly60_iter():
        poly.extract_events(poly.analyze(yp60_off))

    poly60_iter()  # compile
    print("# v1 60s + poly 60s (interleaved):",
          file=sys.stderr)
    tv, tp = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        v1_iter()
        tv.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        poly60_iter()
        tp.append(time.perf_counter() - t0)
    print(f"#   v1 iters: {[round(t, 3) for t in tv]}", file=sys.stderr)
    print(f"#   poly iters: {[round(t, 3) for t in tp]}", file=sys.stderr)
    v1_rtf = duration / sorted(tv)[3]
    poly_rtf_60s = 60.0 / sorted(tp)[3]

    # ---------------- folder sweep: 4 x 60 s dispatch-all-then-fetch --------
    from aegis_tpu.core.analyze import dispatch_analyze, fetch_analyze
    from aegis_tpu.core.events import extract_events_financial

    tracks = [y, y[::-1].copy(), np.roll(y, sr), np.roll(y, -sr)]

    def folder_iter():
        handles = [dispatch_analyze(tr, engine.audio, engine.pyin_cfg,
                                    financial=True, fetch_mel=False)
                   for tr in tracks]
        for h in handles:
            raw = fetch_analyze(h)
            extract_events_financial(
                rake_mask=raw["rake_mask"], f0=raw["f0"],
                voiced_flag=raw["voiced_flag"],
                active_probs=raw["voiced_probs"], rms=raw["rms"],
                sr=sr, hop_length=512, trend=raw["trend"],
                artic_codes=raw["artic_codes"], slide_codes=raw["slide_codes"],
                financial_confidence=raw["financial_confidence"])

    folder_iter()  # compile (reversed/rolled tracks share the bucket)
    print("# folder sweep 4x60s:", file=sys.stderr)
    folder_s = _median_time(folder_iter, 3)
    folder_rtf = 4 * duration / folder_s

    # ---------------- neural folder sweep: same 4 tracks, PitchNet ---------
    from aegis_tpu.core.events import extract_events_v1

    neural_folder_rtf = 0.0
    if have_default_weights():
        from aegis_tpu.models.pitchnet import default_params_device, \
            dispatch_analyze_neural, fetch_analyze_neural

        nparams = default_params_device()

        def neural_folder_iter():
            handles = [dispatch_analyze_neural(
                tr, sr, 512, nparams, fetch_mel=False) for tr in tracks]
            for h in handles:
                raw = fetch_analyze_neural(h)
                extract_events_v1(
                    rake_mask=raw["rake_mask"], f0=np.nan_to_num(raw["f0"]),
                    voiced_flag=raw["voiced_flag"],
                    active_probs=raw["voiced_probs"], rms=raw["rms"],
                    sr=sr, hop_length=512, onset_env=raw["onset_env"],
                    onset_fwd_snap_ms=100.0)

        neural_folder_iter()  # compile
        print("# neural folder sweep 4x60s:", file=sys.stderr)
        neural_folder_rtf = 4 * duration / _median_time(neural_folder_iter, 3)

    # ---------------- warm auto-match (54-combo batched sweep) -------------
    from aegis_tpu.verify.auto_match import auto_match_parameters

    y30 = y[: int(30 * sr)]
    raw30 = v1.audio_to_midi(y30, None, fetch_mel=False)
    auto_match_parameters(y30, v1, raw30, sample_rate=sr, batched=True)
    print("# auto-match 30s, 54 combos:", file=sys.stderr)
    auto_match_s = _median_time(
        lambda: auto_match_parameters(y30, v1, raw30, sample_rate=sr,
                                      batched=True), 3)

    # ---------------- reverse analysis (10 s scale clip, ADSR synth) -------
    from aegis_tpu.verify.reverse import reverse_analysis

    _, midi_bytes, _ = generate_scale_benchmark(sr=sr)
    reverse_analysis(midi_bytes, v1, sample_rate=sr)  # compile
    print("# reverse analysis:", file=sys.stderr)
    reverse_s = _median_time(
        lambda: reverse_analysis(midi_bytes, v1, sample_rate=sr), 3)

    # ---------------- per-note ADSR optimizer (precise 27-combo grid) ------
    from aegis_tpu.verify.per_note import optimize_all_notes

    ytest, _ = generate_test_track(sr=sr)
    raw_t = v1.audio_to_midi(ytest, None, fetch_mel=False)
    ev_t = v1.extract_events(raw_t, None, confidence_threshold=0.3)
    optimize_all_notes(ytest, ev_t, sr, 512, mode="precise")  # compile
    print(f"# per-note optimizer ({len(ev_t)} notes x 27 combos):",
          file=sys.stderr)
    per_note_s = _median_time(
        lambda: optimize_all_notes(ytest, ev_t, sr, 512, mode="precise"), 3)

    # ---------------- effect learning loop (1 iteration, clean preset) ------
    from aegis_tpu.verify.effect_loop import learning_loop

    learning_loop(midi_bytes, v1, preset="clean", max_iterations=1,
                  sample_rate=sr)  # compile
    print("# effect loop (1 iteration):", file=sys.stderr)
    effect_loop_s = _median_time(
        lambda: learning_loop(midi_bytes, v1, preset="clean",
                              max_iterations=1, sample_rate=sr), 3)

    # ---------------- streamed 10-minute track (bounded memory) -------------
    from aegis_tpu.engine.turbo import run_analyze_streamed

    ylong = generate_bench_track(600.0, sr)

    def stream_iter():
        raw = run_analyze_streamed(ylong, engine.audio, engine.pyin_cfg,
                                   financial=True)
        extract_events_financial(
            rake_mask=raw["rake_mask"], f0=raw["f0"],
            voiced_flag=raw["voiced_flag"], active_probs=raw["voiced_probs"],
            rms=raw["rms"], sr=sr, hop_length=512, trend=raw["trend"],
            artic_codes=raw["artic_codes"], slide_codes=raw["slide_codes"],
            financial_confidence=raw["financial_confidence"])

    stream_iter()  # compile
    print("# streamed 600s financial:", file=sys.stderr)
    stream_rtf = 600.0 / _median_time(stream_iter, 3)

    # ---------------- streamed 10-minute track, neural backend --------------
    neural_stream_rtf = 0.0
    if have_default_weights():
        from aegis_tpu.engine.engine import AegisEngine as _V1
        from aegis_tpu.models.pitchnet import load_params, \
            run_analyze_neural_streamed

        _params = load_params()

        def neural_stream_iter():
            raw = run_analyze_neural_streamed(ylong, sr, 512, _params,
                                              fetch_mel=False)
            raw["f0"] = np.nan_to_num(raw["f0"])
            _v1ex.extract_events(raw, None)

        _v1ex = _V1(sample_rate=sr, backend="device")
        neural_stream_iter()  # compile
        print("# streamed 600s neural:", file=sys.stderr)
        neural_stream_rtf = 600.0 / _median_time(neural_stream_iter, 3)

    # ---------------- device-bound RTF probe (resident buffers) -------------
    # Upload once, enqueue N dispatches against the resident buffer, wait
    # for the last output; (t_N - t_1)/(N-1) is the per-iteration device
    # time of the program alone.
    import jax
    import jax.numpy as jnp

    from aegis_tpu.core.analyze import (analyze_financial_program_packed,
                                        analyze_program_packed,
                                        pad_to_bucket, quantize_pcm8)

    y_pad = pad_to_bucket(y)
    y8, s8 = quantize_pcm8(y_pad)
    y_dev, s_dev = jnp.asarray(y8), jnp.asarray(s8)
    rs_dev = jnp.float32(0.6)

    def _device_rtf(call, audio_s: float) -> float:
        jax.block_until_ready(call())  # compile + warm

        def probe(k):
            outs = [call() for _ in range(k)]
            jax.block_until_ready(outs[-1])

        # grow n until the delta is measurable, and floor per-iter at the
        # timer's noise so the row reports a cap, not noise
        for n in (9, 33, 129):
            t1 = _median_time(lambda: probe(1), 3)
            tn = _median_time(lambda: probe(n), 3)
            delta = tn - t1
            if delta >= 0.01:
                break
        per_iter = max(delta / (n - 1), 0.01 / (n - 1))
        return audio_s / per_iter

    print("# device-bound probe: financial", file=sys.stderr)
    device_rtf_fin = _device_rtf(
        lambda: analyze_financial_program_packed(
            y_dev, s_dev, rs_dev, engine.audio, engine.pyin_cfg, True,
            False), duration)
    print("# device-bound probe: v1", file=sys.stderr)
    device_rtf_v1 = _device_rtf(
        lambda: analyze_program_packed(y_dev, s_dev, rs_dev, engine.audio,
                                       engine.pyin_cfg, False), duration)
    from aegis_tpu.core.analyze import quantize_pcm16 as _q16

    yp_pad = pad_to_bucket(yp)
    yp16, sp = _q16(yp_pad)
    yp_dev, sp_dev = jnp.asarray(yp16), jnp.float32(sp)
    print("# device-bound probe: poly", file=sys.stderr)
    from aegis_tpu.core.poly import analyze_poly_program_packed

    device_rtf_poly = _device_rtf(
        lambda: analyze_poly_program_packed(yp_dev, sp_dev, sr, poly.n_fft,
                                            poly.hop_length, poly.n_bins,
                                            poly.bins_per_octave,
                                            poly.max_voices), tpoly)

    # ---------------- live streaming: feed->first-event latency + poll ------
    # Latency = audio time fed when poll_events()
    # first returns a note, minus that note's onset — the intrinsic tile+
    # halo lookahead plus detection physics.  Poll cost = median wall per
    # poll_events() at steady state on a 60 s session.
    from aegis_tpu.engine.realtime import (StreamingPolyTranscriber,
                                           StreamingTranscriber)

    def _live_bench(make, y_src, hop, poll_every_s: float = 0.5,
                    chunk_s: float = 0.1):
        rt = make()
        chunk = int(chunk_s * sr)
        poll_every = max(1, int(poll_every_s / chunk_s))
        latency = None
        polls = []
        for k, i in enumerate(range(0, len(y_src), chunk)):
            rt.feed(y_src[i:i + chunk])
            if k % poll_every:
                continue
            t0 = time.perf_counter()
            ev = rt.poll_events()
            polls.append(time.perf_counter() - t0)
            if ev and latency is None:
                onset = min(e["start"] for e in ev) * hop / sr
                latency = (i + chunk) / sr - onset
        steady = sorted(polls[len(polls) // 2:])
        return latency, 1e3 * steady[len(steady) // 2]

    y60 = y[: int(60 * sr)]
    print("# live v1 60s:", file=sys.stderr)
    lat_v1, poll_v1 = _live_bench(lambda: StreamingTranscriber(), y60, 512)
    print("# live financial 60s:", file=sys.stderr)
    lat_fin, poll_fin = _live_bench(
        lambda: StreamingTranscriber(financial=True), y60, 512)
    print("# live poly 60s (chord loop):", file=sys.stderr)
    yp60 = np.tile(yp, 6)[: int(60 * sr)]
    lat_poly, poll_poly = _live_bench(
        lambda: StreamingPolyTranscriber(sample_rate=sr), yp60, 512)
    # 10-minute sessions: does the poll cost stay bounded as history
    # grows?  (All three engines, at both lengths.)
    print("# live v1 10min (poll scaling):", file=sys.stderr)
    _, poll_v1_10m = _live_bench(lambda: StreamingTranscriber(), ylong,
                                 512, poll_every_s=5.0)
    print("# live financial 10min (poll scaling):", file=sys.stderr)
    _, poll_fin_10m = _live_bench(
        lambda: StreamingTranscriber(financial=True), ylong,
        512, poll_every_s=5.0)
    print("# live poly 10min (poll scaling):", file=sys.stderr)
    yp10 = np.tile(yp, 60)[: len(ylong)]
    _, poll_poly_10m = _live_bench(
        lambda: StreamingPolyTranscriber(sample_rate=sr), yp10,
        512, poll_every_s=5.0)

    # ---------------- technique verifier ------------------------------------
    # the KS test track has no bends — craft a vibrato+bend clip so the
    # verifier actually exercises its with/without synthesis comparison
    from aegis_tpu.verify.technique import verify_technique_by_audio_matching

    tv = np.arange(int(sr * 1.6)) / sr
    vib = 220.0 * 2 ** (0.3 / 12 * np.sin(2 * np.pi * 5.0 * tv))
    ph = 2 * np.pi * np.cumsum(vib) / sr
    ytech = (0.4 * np.sin(ph) * np.exp(-0.8 * tv)).astype(np.float32)
    fpb = 512 / sr
    ev_tech = [
        {"note": 57, "start": 2, "end": int(0.7 / fpb), "confidence": 0.9,
         "velocity": 100, "track": "main", "technique": "vibrato",
         "slope": 0.0, "rms_energy": 0.2},
        {"note": 57, "start": int(0.8 / fpb), "end": int(1.5 / fpb),
         "confidence": 0.9, "velocity": 100, "track": "main",
         "technique": "bend", "slope": 1.0, "rms_energy": 0.2},
    ]
    verify_technique_by_audio_matching(ytech, ev_tech, sr, 512)  # compile
    print("# technique verifier (2 technique events):", file=sys.stderr)
    technique_s = _median_time(
        lambda: verify_technique_by_audio_matching(ytech, ev_tech, sr, 512), 3)

    print(json.dumps({
        "metric": "realtime_factor",
        "value": round(rtf, 1),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 4.8, 2),
        "v1_rtf": round(v1_rtf, 1),
        "neural_rtf": round(neural_rtf, 1),
        "poly_rtf": round(poly_rtf, 1),
        "poly_rtf_60s": round(poly_rtf_60s, 1),
        "folder_sweep_s": round(folder_s, 3),
        "folder_rtf_aggregate": round(folder_rtf, 1),
        "neural_folder_rtf": round(neural_folder_rtf, 1),
        "auto_match_s": round(auto_match_s, 3),
        "reverse_s": round(reverse_s, 3),
        "per_note_s": round(per_note_s, 3),
        "technique_s": round(technique_s, 3),
        "effect_loop_s": round(effect_loop_s, 3),
        "stream_10min_rtf": round(stream_rtf, 1),
        "neural_stream_10min_rtf": round(neural_stream_rtf, 1),
        "device_rtf_fin": round(device_rtf_fin, 1),
        "device_rtf_v1": round(device_rtf_v1, 1),
        "device_rtf_poly": round(device_rtf_poly, 1),
        "live_latency_s_v1": round(lat_v1, 3) if lat_v1 else None,
        "live_latency_s_fin": round(lat_fin, 3) if lat_fin else None,
        "live_latency_s_poly": round(lat_poly, 3) if lat_poly else None,
        "live_poll_ms_v1": round(poll_v1, 1),
        "live_poll_ms_fin": round(poll_fin, 1),
        "live_poll_ms_poly": round(poll_poly, 1),
        "live_poll_ms_v1_10min": round(poll_v1_10m, 1),
        "live_poll_ms_fin_10min": round(poll_fin_10m, 1),
        "live_poll_ms_poly_10min": round(poll_poly_10m, 1),
        "device": device,
    }))


def device_record() -> dict:
    """The device the numbers were taken on; exits when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()}


if __name__ == "__main__":
    measure(device_record())
