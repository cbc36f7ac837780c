"""Smoke test of the transcription system on NVIDIA GPUs.

    python chip_smoke.py               # phases 1-6 on one GPU
    python chip_smoke.py --four-cards  # phase 7 only: sharded paths on 4 GPUs

Drives the main paths once through the entry points a user calls, at real
sizes, and checks the results by the repository's own means:

  1. device: JAX's first device is a GPU (no CPU fallback);
  2. viterbi_parity: the CUDA Viterbi decode gives the same states as the
     dense ``lax.scan`` at T = 2584, band half-widths 101 and 51, on seeded
     and real observations, and in a vmapped batch of turbo tiles;
  3. f1_gates: ``tools.validate_device.validate(include_bench=True)``, v1 and
     financial events against the CPU oracle on four clips and poly truth
     F1 on six seeds, all >= 0.99;
  4. served: ``AegisServer`` on an HTTP thread of this process; a 60 s
     44.1 kHz upload through analyze / analyze-poly / analyze-auto / midi,
     and a live 44.1 kHz session; events equal the library facades';
  5. neural: ``pitch_backend="neural"`` on the 60 s track;
  6. long_track: ``run_analyze_streamed`` on a 10-minute track, v1 rows
     bit-exact with the unstreamed turbo path;
  7. four_cards: turbo tiles (halo ppermute / pmax), the folder batch over
     ``data``, the financial and poly turbo paths and the PitchNet
     data-parallel train step on a (data=2, time=2) mesh of four GPUs, each
     against the same path on one GPU.

Each phase prints one JSON line (with its wall time); any failure exits
non-zero.  The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import threading
import time

import numpy as np

import aegis_tpu  # noqa: F401  (the program must be beside this script)

SR = 22050
SR_44K = 44100
TRACK_S = 60.0  # the bench track
LONG_S = 600.0  # the streamed long track


def phase(name, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    result = {"phase": name, "seconds": round(time.perf_counter() - t0, 3),
              **result}
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        raise SystemExit(f"phase {name} failed")
    return result


def f1(ref, est, sr, hop):
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    return note_event_f1(events_to_seconds(ref, sr, hop),
                         events_to_seconds(est, sr, hop))["f1"]


# ------------------------------------------------------------------ phases


def viterbi_parity():
    from aegis_tpu.config import PyinConfig
    from aegis_tpu.tools.viterbi_bench import parity, parity_cases

    cfg = PyinConfig()
    rows = [parity(obs, vp, w, cfg, label)
            for label, obs, vp, w in parity_cases(cfg)]
    return {"ok": all(r["ok"] for r in rows),
            "cases": {r["case"]: r["mismatches"] for r in rows}}


def f1_gates():
    import jax

    from aegis_tpu.tools.validate_device import validate

    res = validate(threshold=0.99, include_bench=True, quiet=True)
    return {"ok": bool(res["pass"]),
            "matmul_precision": str(jax.config.jax_default_matmul_precision
                                    or "default"),
            "clips": res["clips"]}


def served():
    import urllib.request
    from http.server import ThreadingHTTPServer

    from aegis_tpu.engine.auto import AegisAutoEngine
    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.engine.poly import AegisPolyEngine
    from aegis_tpu.engine.realtime import StreamingTranscriber
    from aegis_tpu.io.audio import load_audio
    from aegis_tpu.io.wav import write_wav
    from aegis_tpu.serve.http import make_handler
    from aegis_tpu.serve.server import AegisServer, _events_json
    from aegis_tpu.tools.signal_gen import generate_bench_track

    y = generate_bench_track(TRACK_S, SR_44K)
    wav = io.BytesIO()
    write_wav(wav, y, SR_44K)

    srv = AegisServer()  # the server's default engine: v1 at 44.1 kHz
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv.router))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def req(path, body=None, method="POST"):
        r = urllib.request.Request(url + path, data=body, method=method)
        with urllib.request.urlopen(r, timeout=900) as resp:
            data = resp.read()
            return (json.loads(data) if "json" in resp.headers.get(
                "Content-Type", "") else data)

    out, ok = {}, True
    try:
        sid = req("/api/upload?name=bench.wav", wav.getvalue())["session_id"]
        path = srv.sessions.get(sid)["file_path"]
        y_dec, _ = load_audio(path, sr=SR_44K)

        t0 = time.perf_counter()
        got = req(f"/api/analyze/{sid}")
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = req(f"/api/analyze/{sid}")
        warm = time.perf_counter() - t0
        eng = AegisEngine(sample_rate=SR_44K)
        want = eng.extract_events(
            eng.audio_to_midi(y_dec, None, turbo_mode="off"), None,
            confidence_threshold=0.70, min_note_duration_ms=100,
            sustain_ms=200, midi_program=27, noise_gate_db=-40.0)
        out["analyze"] = {"events": got["num_events"], "cold_s": cold,
                          "warm_s": warm,
                          "equal": got["events"] == _events_json(want)}

        got = req(f"/api/analyze-poly/{sid}")
        poly = AegisPolyEngine(sample_rate=SR_44K)
        analysis = poly.analyze(y_dec)
        analysis.pop("y", None)  # as the server keeps it
        want = poly.extract_events(analysis, None, confidence_threshold=0.5,
                                   midi_program=25)
        out["analyze_poly"] = {"events": got["num_events"],
                               "equal": got["events"] == _events_json(want)}

        got = req(f"/api/analyze-auto/{sid}")
        auto = AegisAutoEngine(sample_rate=SR_44K)
        analysis = auto.analyze(y_dec)
        analysis.pop("y", None)
        want = auto.extract_events(analysis, None, midi_program=25)
        out["analyze_auto"] = {"events": got["num_events"],
                               "equal": got["events"] == _events_json(want)}

        midi = req(f"/api/midi/{sid}", method="GET")
        out["midi_bytes"] = len(midi)
        ok &= midi[:4] == b"MThd"

        # live session: 250 ms int16 posts, as the SPA's live tab sends them
        live = req(f"/api/stream-start?sr={SR_44K}")
        lid = live["session_id"]
        pcm = (np.clip(y_dec, -1, 1) * 32767).astype("<i2")
        step = SR_44K // 4
        rt = StreamingTranscriber(
            audio=eng.audio, tile_frames=24, halo_frames=8,
            rake_sensitivity=0.6, financial=False, confidence_threshold=0.5)
        feeds = []
        for i in range(0, len(pcm), step):
            chunk = pcm[i:i + step]
            t0 = time.perf_counter()
            req(f"/api/stream-feed/{lid}", chunk.tobytes())
            feeds.append(time.perf_counter() - t0)
            rt.feed(chunk.astype(np.float32) / 32768.0)
        polled = req(f"/api/stream-events/{lid}", method="GET")
        got = req(f"/api/stream-finalize/{lid}")
        want = rt.finalize()
        out["live"] = {"posts": len(feeds), "polled": polled["num_events"],
                       "events": got["num_events"],
                       "feed_ms_median": 1e3 * sorted(feeds)[len(feeds) // 2],
                       "equal": got["events"] == _events_json(want)}
    finally:
        httpd.shutdown()
    for key in ("analyze", "analyze_poly", "analyze_auto", "live"):
        ok &= out[key]["equal"] and out[key]["events"] > 0
    return {"ok": bool(ok), **out}


def neural():
    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.tools.signal_gen import generate_bench_track

    y = generate_bench_track(TRACK_S, SR)
    eng = AegisEngine(sample_rate=SR)
    t0 = time.perf_counter()
    raw = eng.audio_to_midi(y, None, pitch_backend="neural")
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = eng.audio_to_midi(y, None, pitch_backend="neural")
    warm = time.perf_counter() - t0
    events = eng.extract_events(raw, None, confidence_threshold=0.3)
    ref = eng.extract_events(eng.audio_to_midi(y, None), None,
                             confidence_threshold=0.3)
    agree = f1(ref, events, SR, eng.hop_length)
    return {"ok": bool(events),
            "events": len(events), "f1_vs_pyin": round(agree, 4),
            "cold_s": cold, "warm_s": warm}


def long_track():
    from aegis_tpu.config import AudioConfig, PyinConfig
    from aegis_tpu.engine.turbo import run_analyze_streamed, run_analyze_turbo
    from aegis_tpu.tools.signal_gen import generate_bench_track

    audio, cfg = AudioConfig(sample_rate=SR), PyinConfig()
    y = generate_bench_track(LONG_S, SR)
    t0 = time.perf_counter()
    st = run_analyze_streamed(y, audio, cfg, 0.6, transport="int16")
    streamed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = run_analyze_turbo(y, audio, cfg, 0.6, fetch_mel=False)
    turbo_s = time.perf_counter() - t0
    m = st["voiced_flag"]
    exact = (bool((st["voiced_flag"] == tr["voiced_flag"]).all())
             and np.array_equal(st["f0"][m], tr["f0"][m])
             and np.array_equal(st["rms"], tr["rms"]))
    return {"ok": exact, "frames": int(len(m)), "voiced": float(m.mean()),
            "streamed_s": streamed_s, "turbo_s": turbo_s}


def four_cards():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from aegis_tpu.config import AudioConfig, PyinConfig
    from aegis_tpu.core.events import extract_events_financial, \
        extract_events_v1
    from aegis_tpu.core.poly import roll_to_events
    from aegis_tpu.engine.turbo import run_analyze_batch, \
        run_analyze_poly_turbo
    from aegis_tpu.models import pitchnet as pn
    from aegis_tpu.models.data import make_clips
    from aegis_tpu.tools.signal_gen import (generate_bench_track,
                                            generate_chord_progression)

    devs = jax.devices()
    if len(devs) < 4:
        return {"ok": False, "error": f"{len(devs)} devices, need 4"}
    four = Mesh(np.array(devs[:4]).reshape(2, 2), ("data", "time"))
    one = Mesh(np.array(devs[:1]).reshape(1, 1), ("data", "time"))
    audio, cfg = AudioConfig(sample_rate=SR), PyinConfig()
    hop = audio.hop_length
    ys = np.stack([generate_bench_track(TRACK_S, SR, seed=s) for s in (42, 7)])

    def v1_events(raw, b):
        return extract_events_v1(
            rake_mask=raw["rake_mask"][b], f0=np.nan_to_num(raw["f0"][b]),
            voiced_flag=raw["voiced_flag"][b],
            active_probs=raw["voiced_probs"][b], rms=raw["rms"][b], sr=SR,
            hop_length=hop, onset_env=raw["onset_env"][b])

    def fin_events(raw, b):
        return extract_events_financial(
            rake_mask=raw["rake_mask"][b], f0=raw["f0"][b],
            voiced_flag=raw["voiced_flag"][b],
            active_probs=raw["voiced_probs"][b], rms=raw["rms"][b], sr=SR,
            hop_length=hop, trend=raw["trend"][b],
            artic_codes=raw["artic_codes"][b],
            slide_codes=raw["slide_codes"][b],
            financial_confidence=raw["financial_confidence"][b])[0]

    out = {"mesh": dict(four.shape)}
    for name, kw, events in (("v1_tiles", {}, v1_events),
                             ("financial_tiles", {"financial": True},
                              fin_events)):
        sharded = run_analyze_batch(ys, audio, cfg, 0.6, mesh=four,
                                    fetch_mel=False, **kw)
        single = run_analyze_batch(ys, audio, cfg, 0.6, mesh=one,
                                   fetch_mel=False, **kw)
        scores = [f1(events(single, b), events(sharded, b), SR, hop)
                  for b in range(len(ys))]
        out[name] = {"f1": scores,
                     "events": [len(events(sharded, b)) for b in range(2)]}

    chords = np.stack([generate_chord_progression(s, sr=SR)[0]
                       for s in (1, 3)])

    def poly_events(raw, b):
        return roll_to_events(raw["roll"][b], raw["confidence"][b],
                              raw["rms"][b], SR, 512)

    sharded = run_analyze_poly_turbo(chords, sr=SR, mesh=four)
    single = run_analyze_poly_turbo(chords, sr=SR, mesh=one)
    out["poly_tiles"] = {
        "f1": [f1(poly_events(single, b), poly_events(sharded, b), SR, 512)
               for b in range(2)],
        "events": [len(poly_events(sharded, b)) for b in range(2)]}

    d = make_clips(32, clip_len=4096, seed=0)
    bank = [jnp.asarray(d[k]) for k in ("tracks", "scale", "f0_hz", "voiced",
                                        "label_w")]
    losses = {}
    for name, mesh in (("four", four), ("one", None)):
        params, opt = pn.init_train_state(0)
        step = pn.make_train_step(mesh, batch=256)
        seq = []
        for i in range(3):
            params, opt, loss = step(params, opt, jax.random.PRNGKey(1),
                                     np.int32(i), *bank)
            seq.append(float(loss))
        losses[name] = seq
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["four"],
                                                  losses["one"]))
    out["train_step"] = {"losses": losses, "max_rel_diff": rel}

    # every card held part of the sharded work, not device 0 alone
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs[:4]]
    out["peak_bytes_per_device"] = peaks
    ok = (all(s == 1.0 for k in ("v1_tiles", "financial_tiles", "poly_tiles")
              for s in out[k]["f1"])
          and all(min(out[k]["events"]) > 0
                  for k in ("v1_tiles", "financial_tiles", "poly_tiles"))
          and rel < 1e-3 and min(peaks) > 0)
    return {"ok": bool(ok), **out}


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    phase("device", lambda: {"ok": True, "platform": dev.platform,
                             "kind": dev.device_kind,
                             "count": len(jax.devices())})
    if args.four_cards:
        phase("four_cards", four_cards)
    else:
        phase("viterbi_parity", viterbi_parity)
        phase("f1_gates", f1_gates)
        phase("served", served)
        phase("neural", neural)
        phase("long_track", long_track)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
