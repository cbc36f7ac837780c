"""Unified CLI: ``python -m aegis_tpu <command> ...``

The reference exposes its pipelines as per-file ``__main__`` blocks
(aegis_engine_financial.py:260-291) and leaves the rest to the UIs; here
every pipeline is one command on a single entry point:

  transcribe  WAV/MP3 -> MIDI via the v1 engine (two-phase)
  financial   WAV/MP3 -> MIDI via the v2 financial engine (5-phase)
  poly        WAV/MP3 -> MIDI via the polyphonic CQT engine
  stems       separate stems (Demucs if present, on-device HPSS otherwise)
  stream      live transcription from an s16le PCM pipe (ffmpeg/sox/mic);
              prints live event JSON, writes MIDI at EOF (any engine)
  warmup      precompile device programs into the persistent XLA cache
  tabs        MIDI-adjacent: transcribe then print ASCII tablature
  serve       start the REST API + SPA  (same as -m aegis_tpu.serve.server)
  train       train the PitchNet checkpoint (same as -m aegis_tpu.models.train)
  validate    on-device F1 gate (same as -m aegis_tpu.tools.validate_device)
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("input", help="input audio file (wav/mp3/...)")
    p.add_argument("output", nargs="?", default=None,
                   help="output .mid path (default: input stem + .mid)")
    p.add_argument("--start", type=float, default=0.0)
    p.add_argument("--end", type=float, default=None)
    p.add_argument("--confidence", type=float, default=None)
    p.add_argument("--min-duration-ms", type=float, default=None)
    p.add_argument("--sustain-ms", type=float, default=None)
    p.add_argument("--bpm", default=None,
                   help="a number, or 'auto' to estimate the tempo")
    p.add_argument("--turbo", default="auto",
                   choices=["off", "tiles", "stream", "auto"])
    p.add_argument("--no-onsets", action="store_true",
                   help="disable onset-envelope event refinement "
                        "(re-attack splitting + attack-time snap); "
                        "matches the reference's merge/lag semantics")


def _out_path(args) -> str:
    if args.output:
        return args.output
    import os

    return os.path.splitext(args.input)[0] + ".mid"


def _extract_kwargs(args) -> dict:
    kw = {}
    if getattr(args, "no_onsets", False):
        kw["use_onsets"] = False
    if args.confidence is not None:
        kw["confidence_threshold"] = args.confidence
    if args.min_duration_ms is not None:
        kw["min_note_duration_ms"] = args.min_duration_ms
    if args.sustain_ms is not None:
        kw["sustain_ms"] = args.sustain_ms
    if args.bpm is not None:
        from aegis_tpu.core.tempo import parse_bpm

        try:
            kw["bpm"] = parse_bpm(args.bpm)
        except ValueError:
            print(f"error: --bpm must be a positive number or 'auto', "
                  f"got {args.bpm!r}", file=sys.stderr)
            raise SystemExit(2)
    return kw


def cmd_transcribe(args) -> int:
    from aegis_tpu.engine.engine import AegisEngine

    eng = AegisEngine(sample_rate=args.sr)
    raw = eng.audio_to_midi(args.input, None, start_time=args.start,
                            end_time=args.end, turbo_mode=args.turbo,
                            rake_sensitivity=args.rake,
                            pitch_backend=args.pitch_backend)
    if raw is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    out = _out_path(args)
    events = eng.extract_events(raw, out, **_extract_kwargs(args))
    print(f"{len(events)} events -> {out}")
    return 0


def cmd_financial(args) -> int:
    from aegis_tpu.engine.financial import AegisFinancialEngine

    eng = AegisFinancialEngine(sample_rate=args.sr)
    out = _out_path(args)
    result = eng.audio_to_midi_financial(
        args.input, out, start_time=args.start, end_time=args.end,
        rake_sensitivity=args.rake, turbo_mode=args.turbo,
        pitch_backend=args.pitch_backend, pitch_source=args.pitch_source,
        **_extract_kwargs(args))
    if result is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    print(f"-> {out}")
    return 0


def cmd_poly(args) -> int:
    from aegis_tpu.engine.poly import AegisPolyEngine

    eng = AegisPolyEngine(sample_rate=args.sr)
    out = _out_path(args)
    analysis = eng.analyze(args.input, start_time=args.start,
                           end_time=args.end, turbo_mode=args.turbo)
    if analysis is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    events = eng.extract_events(analysis, out, **_extract_kwargs(args))
    print(f"{len(events)} events -> {out}")
    return 0


def cmd_auto(args) -> int:
    """Polyphony-aware routed transcription: chords through the CQT peel,
    fast monophonic lines through pYIN, merged on one frame grid
    (engine/auto.py)."""
    from aegis_tpu.engine.auto import AegisAutoEngine

    eng = AegisAutoEngine(sample_rate=args.sr)
    out = _out_path(args)
    analysis = eng.analyze(args.input, start_time=args.start,
                           end_time=args.end)
    if analysis is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    events = eng.extract_events(analysis, out, **_extract_kwargs(args))
    print(f"{len(events)} events -> {out}")
    return 0


def cmd_batch(args) -> int:
    """Folder sweep: every track as ONE sharded device batch."""
    from aegis_tpu.engine.poly import transcribe_folder

    kw = {}
    if args.confidence is not None:
        kw["confidence_threshold"] = args.confidence
    if getattr(args, "no_onsets", False):
        kw["use_onsets"] = False
    results = transcribe_folder(args.folder, args.output_dir,
                                pattern=args.pattern,
                                sample_rate=args.sr,
                                pitch_backend=args.pitch_backend,
                                engine=args.engine,
                                transport=args.transport, **kw)
    if not results:
        print("no matching audio files", file=sys.stderr)
        return 1
    for wav, mid, n in results:
        print(f"{wav} -> {mid} ({n} events)")
    return 0


def cmd_warmup(args) -> int:
    """Precompile the device programs a deployment will hit.

    The fused programs are bucketed by padded track length (one compiled
    program per ~3% length bucket, core.analyze.bucket_length); a cold
    compile of the biggest program (financial + neural backend) takes
    seconds, hidden afterwards by the persistent XLA cache
    ($JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache).  This command pays that
    cost deliberately at install time instead of on the first user request:
    it synthesizes a silent clip per requested duration and runs each
    requested pipeline's Perception Phase once.  Streamed modes use fixed
    slab shapes, so one short stream warm covers every track length.
    """
    import time

    import numpy as np

    sec_list = [float(s) for s in args.seconds.split(",")]
    pipes = args.pipelines.split(",")
    known = {"v1", "neural", "financial", "neural-financial", "poly",
             "stream", "neural-stream",
             "live-v1", "live-financial", "live-poly"}
    bad = set(pipes) - known
    if bad:
        print(f"error: unknown pipeline(s) {sorted(bad)}; "
              f"choose from {sorted(known)}", file=sys.stderr)
        return 1

    def run(pipe: str, y: np.ndarray) -> None:
        if pipe.startswith("live-"):
            # live-stream tile programs have FIXED slab shapes (one compile
            # per tile/halo config, duration-independent): feed enough
            # silence for one tile so the first real session never pays a
            # cold remote compile mid-stream
            from aegis_tpu.engine import realtime as _rt

            if pipe == "live-poly":
                rt = _rt.StreamingPolyTranscriber(sample_rate=args.sr)
            else:
                from aegis_tpu.config import AudioConfig

                rt = _rt.StreamingTranscriber(
                    audio=AudioConfig(sample_rate=args.sr),
                    financial=(pipe == "live-financial"))
            rt.feed(np.zeros(rt._tile_samp + 2 * rt._ctx + 1, np.float32))
            return
        if pipe == "poly":
            from aegis_tpu.engine.poly import AegisPolyEngine

            AegisPolyEngine(sample_rate=args.sr).analyze(y)
            return
        kw = {}
        if pipe in ("neural", "neural-financial", "neural-stream"):
            kw["pitch_backend"] = "neural"
        if pipe.endswith("stream"):
            kw["turbo_mode"] = "stream"
        if pipe in ("financial", "neural-financial"):
            from aegis_tpu.engine.financial import AegisFinancialEngine

            AegisFinancialEngine(sample_rate=args.sr).audio_to_midi_financial(
                y, None, **kw)
        else:
            from aegis_tpu.engine.engine import AegisEngine

            AegisEngine(sample_rate=args.sr).audio_to_midi(y, None, **kw)

    for sec in sec_list:
        y = np.zeros(int(sec * args.sr), np.float32)
        for pipe in pipes:
            t0 = time.time()
            run(pipe, y)
            print(f"warm {pipe:>17s} @ {sec:g}s/{args.sr}Hz: "
                  f"{time.time() - t0:.1f}s")
    return 0


def cmd_stream(args) -> int:
    """Live transcription from a PCM pipe.

    Reads signed 16-bit little-endian mono PCM from stdin (what
    ``ffmpeg -f s16le -ac 1`` or ``sox -t raw -e signed -b 16`` emit, or a
    microphone bridge), prints a JSON line of the live event list every
    ``--poll-every`` seconds of audio, and on EOF finalizes — writing MIDI
    when an output path is given.  Works with every engine:
    v1 / financial / poly (engine.realtime transcribers, same semantics
    as /api/stream-start?engine=...).

        ffmpeg -i in.wav -f s16le -ac 1 -ar 22050 - | \
            python -m aegis_tpu stream --engine poly out.mid
    """
    import json

    import numpy as np

    lat = {}
    if getattr(args, "tile_frames", None):
        lat["tile_frames"] = args.tile_frames
    if getattr(args, "halo_frames", None):
        lat["halo_frames"] = args.halo_frames
    if args.engine == "poly":
        from aegis_tpu.engine.realtime import StreamingPolyTranscriber

        kw = ({"confidence_threshold": args.confidence}
              if args.confidence is not None else {})
        rt = StreamingPolyTranscriber(sample_rate=args.sr, **kw, **lat)
    else:
        from aegis_tpu.config import AudioConfig
        from aegis_tpu.engine.realtime import StreamingTranscriber

        kw = {}
        if args.confidence is not None:
            kw["confidence_threshold"] = args.confidence
        elif args.engine == "v1":
            kw["confidence_threshold"] = 0.5
        rt = StreamingTranscriber(audio=AudioConfig(sample_rate=args.sr),
                                  financial=(args.engine == "financial"),
                                  **kw, **lat)
    print(f"# engine={args.engine} sr={args.sr} "
          f"lookahead={rt.lookahead_s:.2f}s", file=sys.stderr)

    # hop differs by engine/sr (poly scales its window with sr)
    hop = getattr(rt, "hop", None) or rt.audio.hop_length
    spf = hop / float(args.sr)  # seconds per frame

    def _jsonable(events, live):
        return json.dumps({
            "live": live, "n": len(events),
            "events": [{
                "note": int(e["note"]),
                "start": int(e["start"]), "end": int(e["end"]),
                "start_s": round(e["start"] * spf, 4),
                "end_s": round(e["end"] * spf, 4),
                "confidence": round(float(e.get("confidence", 0.0)), 4),
                "velocity": int(e.get("velocity", 0)),
                "track": e.get("track", "main"),
            } for e in events]})

    poll_samples = max(int(args.poll_every * args.sr), 1)
    src = sys.stdin.buffer
    fed_since_poll = 0
    carry = b""  # odd trailing byte of a short read belongs to the NEXT
    # sample — dropping it would byte-shift (byte-swap) the whole rest of
    # the s16le stream
    while True:
        data = src.read(8192)
        if not data:
            break
        data = carry + data
        cut = len(data) // 2 * 2
        carry = data[cut:]
        pcm = np.frombuffer(data[:cut],
                            dtype="<i2").astype(np.float32) / 32768.0
        rt.feed(pcm)
        fed_since_poll += len(pcm)
        if fed_since_poll >= poll_samples:
            fed_since_poll = 0
            print(_jsonable(rt.poll_events(), live=True), flush=True)
    events = rt.finalize()
    if not events:
        print("# no events detected", file=sys.stderr)
    if args.output:
        # engine-matched encoders, same defaults as the offline facades:
        # poly program 25, v1 program 27, financial named-track layout
        if args.engine == "financial":
            from aegis_tpu.midi.encode import events_to_midi_financial

            events_to_midi_financial(events, args.sr, hop,
                                     output=args.output)
        else:
            from aegis_tpu.midi.encode import events_to_midi

            program = args.midi_program if args.midi_program is not None \
                else (25 if args.engine == "poly" else 27)
            events_to_midi(events, args.sr, hop,
                           midi_program=program, output=args.output)
        print(f"# wrote {args.output}", file=sys.stderr)
    print(_jsonable(events, live=False), flush=True)
    return 0


def cmd_stems(args) -> int:
    from aegis_tpu.synth.stems import separate_stems

    path = separate_stems(args.input, args.output_dir, method=args.method)
    print(path)
    return 0 if path != args.input else 2


def cmd_tabs(args) -> int:
    from aegis_tpu.midi.tabs import generate_tabs, render_ascii_tab

    if getattr(args, "engine", "v1") == "poly":
        if args.pitch_backend != "pyin":
            print("error: the polyphonic engine has no neural backend",
                  file=sys.stderr)
            return 2
        from aegis_tpu.engine.poly import AegisPolyEngine

        peng = AegisPolyEngine(sample_rate=args.sr)
        analysis = peng.analyze(args.input, start_time=args.start,
                                end_time=args.end, turbo_mode=args.turbo)
        if analysis is None:
            print("error: empty audio", file=sys.stderr)
            return 1
        events = peng.extract_events(analysis, args.output,
                                     **_extract_kwargs(args))
        chords = peng.label_chords(events)
        if chords:
            print("  ".join(f"{c['time_sec']:.2f}s {c['name']}"
                            for c in chords))
            print()
        print(render_ascii_tab(peng.generate_tabs(events)))
        if args.output:
            print(f"# wrote {args.output}", file=sys.stderr)
        return 0

    from aegis_tpu.engine.engine import AegisEngine

    eng = AegisEngine(sample_rate=args.sr)
    raw = eng.audio_to_midi(args.input, None, start_time=args.start,
                            end_time=args.end, turbo_mode=args.turbo,
                            rake_sensitivity=args.rake,
                            pitch_backend=args.pitch_backend)
    if raw is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    # the optional positional writes the MIDI alongside the ASCII tab
    # (extract_events encodes when given an output target)
    events = eng.extract_events(raw, args.output, **_extract_kwargs(args))
    print(render_ascii_tab(generate_tabs(events)))
    if args.output:
        print(f"# wrote {args.output}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="aegis_tpu", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    for name, fn in (("transcribe", cmd_transcribe),
                     ("financial", cmd_financial),
                     ("poly", cmd_poly), ("auto", cmd_auto),
                     ("tabs", cmd_tabs)):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--sr", type=int,
                       default=44100 if name in ("transcribe", "tabs")
                       else 22050)
        if name not in ("poly", "auto"):  # CQT/routed: no pitch backend
            p.add_argument("--rake", type=float, default=0.6)
            p.add_argument("--pitch-backend", default="pyin",
                           choices=["pyin", "neural"])
        if name == "financial":
            p.add_argument("--pitch-source", default="pyin",
                           choices=["pyin", "trend"],
                           help="series that note pitches quantize from: "
                                "the median-smoothed pYIN f0 (default) or "
                                "the consensus trend (the reference's v2 "
                                "semantics; smooths across note boundaries "
                                "— see VALIDATION.md)")
        if name == "tabs":
            p.add_argument("--engine", default="v1",
                           choices=["v1", "poly"],
                           help="poly = chord-capable engine: chord-aware "
                                "fingering + named chord line")
        p.set_defaults(fn=fn)

    p = sub.add_parser("batch")
    p.add_argument("folder")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--pattern", default="*.wav")
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--confidence", type=float, default=None)
    p.add_argument("--no-onsets", action="store_true",
                   help="disable onset event refinement (the reference's "
                        "exact merge/lag semantics)")
    p.add_argument("--pitch-backend", default="pyin",
                   choices=["pyin", "neural"],
                   help="neural = PitchNet dispatch-ahead sweep (the "
                        "fastest folder path)")
    p.add_argument("--engine", default="v1",
                   choices=["v1", "financial", "poly", "auto"],
                   help="pipeline per track: v1 two-phase (default), "
                        "financial 5-phase, polyphonic CQT, or the "
                        "polyphony-aware router (auto)")
    p.add_argument("--transport", default="int8",
                   choices=["int8", "int4", "int16", "float32"],
                   help="audio upload packing (int4 = throughput-over-"
                        "fidelity, see VALIDATION.md; poly ignores this)")
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("warmup", description=cmd_warmup.__doc__)
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--seconds", default="60",
                   help="comma-separated durations to warm (buckets are "
                        "~3%% wide, so warm the lengths you expect)")
    p.add_argument("--pipelines",
                   default="v1,financial",
                   help="comma-separated: v1,neural,financial,"
                        "neural-financial,poly,stream,neural-stream,"
                        "live-v1,live-financial,live-poly (the live-* "
                        "tile programs are what /api/stream-* compiles)")
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("stream", description=cmd_stream.__doc__,
                       formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("output", nargs="?", default=None,
                   help="optional .mid written at EOF")
    p.add_argument("--engine", default="v1",
                   choices=["v1", "financial", "poly"])
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--confidence", type=float, default=None)
    p.add_argument("--poll-every", type=float, default=2.0,
                   help="seconds of audio between live event prints")
    p.add_argument("--tile-frames", type=int, default=None,
                   help="live tile size in frames (default 64); smaller "
                        "tiles cut the feed->event lookahead at more "
                        "dispatches/sec (see engine/realtime.py)")
    p.add_argument("--halo-frames", type=int, default=None,
                   help="halo context frames per side (default 32 v1/"
                        "financial, 8 poly)")
    p.add_argument("--midi-program", type=int, default=None,
                   help="GM program (default: the engine's own — poly 25, "
                        "v1 27; financial uses its named-track encoder)")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("stems")
    p.add_argument("input")
    p.add_argument("output_dir")
    p.add_argument("--method", default="auto",
                   choices=["auto", "demucs", "hpss"])
    p.set_defaults(fn=cmd_stems)

    p = sub.add_parser("serve", description="REST API + SPA server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8508)
    p.set_defaults(fn=None, module="aegis_tpu.serve.server")

    for name, mod, note in (
            ("train", "aegis_tpu.models.train",
             "PitchNet trainer; module flags: --steps --batch --clips "
             "--clip-len --seed --out --platform"),
            ("validate", "aegis_tpu.tools.validate_device",
             "on-device F1 gate; module flags: --quick")):
        p = sub.add_parser(name, description=note)
        p.set_defaults(fn=None, module=mod)

    args, rest = ap.parse_known_args(argv)
    if args.fn is None:  # delegate to the module's own CLI
        import importlib

        if args.module == "aegis_tpu.serve.server":
            if rest:
                ap.error(f"unrecognized arguments: {' '.join(rest)}")
            importlib.import_module(args.module).main(args.host, args.port)
            return 0
        sys.argv = [args.module] + rest
        importlib.import_module(args.module).main()
        return 0
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if getattr(args, "end", None) is not None and args.end <= getattr(
            args, "start", 0.0):
        ap.error(f"--end ({args.end}) must be greater than --start "
                 f"({getattr(args, 'start', 0.0)})")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
