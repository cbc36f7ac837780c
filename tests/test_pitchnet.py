"""PitchNet (models/) tests: data generator invariants, decode math,
learning sanity, committed-checkpoint accuracy, engine integration, and the
mesh-sharded training step."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aegis_tpu.models import pitchnet as pn
from aegis_tpu.models.data import LABEL_HOP, make_clips


def _tone(sr, f, dur=1.0, decay=2.0):
    t = np.arange(int(sr * dur)) / sr
    env = np.exp(-decay * t)
    y = env * sum(a * np.sin(2 * np.pi * f * (k + 1) * t)
                  for k, a in enumerate([1.0, 0.5, 0.25]))
    return (0.8 * y / np.max(np.abs(y))).astype(np.float32)


# ----------------------------------------------------------------- data gen


def test_make_clips_shapes_and_labels():
    d = make_clips(32, clip_len=4096, seed=3, voiced_frac=0.75)
    assert d["tracks"].shape == (32, 4096) and d["tracks"].dtype == np.int16
    assert d["f0_hz"].shape == (32, 4096 // LABEL_HOP)
    # labels: voiced frames carry a positive f0, unvoiced carry 0
    assert (d["f0_hz"][d["voiced"]] > 0).all()
    assert (d["f0_hz"][~d["voiced"]] == 0).all()
    # roughly the requested voiced fraction (clip-level)
    frac = d["voiced"].any(axis=1).mean()
    assert 0.5 < frac <= 0.85
    # per-clip peak scaling uses the full int16 range for normal clips;
    # near-silent clips stay at a few LSBs (what a track-peak-scaled quiet
    # passage really looks like after int16 transport)
    peaks = np.abs(d["tracks"]).max(axis=1)
    assert ((peaks == 32767) | (peaks < 100)).all()
    assert (peaks < 100).any(), "expected some near-silence clips"


def test_label_weights_mask_decay_boundaries():
    from aegis_tpu.models.data import DECAY_AMBIG_BLOCKS

    from aegis_tpu.models.data import ONSET_AMBIG_BLOCKS, ONSET_PRE_W

    d = make_clips(64, clip_len=8192, seed=7)
    w, v = d["label_w"], d["voiced"]
    assert w.shape == v.shape and w.dtype == np.float32
    # weights: 0 (ambiguous), ONSET_PRE_W (pre-onset span, labeled voiced
    # with the upcoming pitch), 1 (fully supervised)
    assert set(np.unique(w)) <= {0.0, np.float32(ONSET_PRE_W), 1.0}
    # every voiced->unvoiced transition is weight-0 on both sides; onsets
    # (unvoiced->voiced) keep weight 1 right AT the rising edge's voiced
    # side unless a decay boundary sits within the ambiguity radius
    fall = np.zeros_like(v)
    fall[:, 1:] = v[:, :-1] & ~v[:, 1:]
    ci, bi = np.nonzero(fall)
    assert len(ci), "fixture should contain decay boundaries"
    for c, b in zip(ci[:50], bi[:50]):
        lo = max(b - DECAY_AMBIG_BLOCKS, 0)
        hi = min(b + DECAY_AMBIG_BLOCKS + 1, w.shape[1])
        assert (w[c, lo:hi] == 0).all()
    # the pre-onset span is voiced at ONSET_PRE_W with the UPCOMING pitch:
    # each rising edge is preceded by up to ONSET_AMBIG_BLOCKS blocks of
    # weight-0.3 voiced labels carrying the onset block's f0
    pre = w == np.float32(ONSET_PRE_W)
    assert pre.any(), "fixture should contain pre-onset spans"
    assert v[pre].all() and (d["f0_hz"][pre] > 0).all()
    ci, bi = np.nonzero(pre)
    for c, b in zip(ci[:50], bi[:50]):
        on = np.nonzero(v[c, b:b + ONSET_AMBIG_BLOCKS + 1]
                        & (w[c, b:b + ONSET_AMBIG_BLOCKS + 1] > 0.5))[0]
        if len(on):  # nearest fully-supervised voiced block ahead
            assert d["f0_hz"][c, b] == d["f0_hz"][c, b + on[0]]
    # supervision survives: most blocks still carry weight
    assert w.mean() > 0.6


def test_fx_augmentation_preserves_pitch_labels():
    """Effect-augmented voiced clips keep a valid f0 label where weighted:
    the dominant low partial of the wet signal sits on the labeled pitch."""
    d_clean = make_clips(48, clip_len=8192, seed=9, fx_frac=0.0)
    d_fx = make_clips(48, clip_len=8192, seed=9, fx_frac=1.0)
    # same RNG stream until augmentation, so labels are comparable pre-ring
    changed = (d_clean["tracks"] != d_fx["tracks"]).any(axis=1)
    assert changed.sum() >= 24, "fx_frac=1.0 should rewrite voiced clips"
    np.testing.assert_array_equal(d_clean["f0_hz"], d_fx["f0_hz"])
    np.testing.assert_array_equal(d_clean["voiced"], d_fx["voiced"])


# ------------------------------------------------------------- decode math


def test_decode_f0_bin_roundtrip():
    for b in (5, 60, 150):
        logits = np.full((1, pn.N_BINS), -10.0, np.float32)
        logits[0, b] = 10.0
        f0, vp = pn.decode_f0(jnp.asarray(logits), jnp.asarray([3.0]))
        want = pn.FMIN_HZ * 2.0 ** (b * pn.CENTS_PER_BIN / 1200.0)
        assert abs(float(f0[0]) / want - 1.0) < 1e-3
        assert float(vp[0]) > 0.9


def test_pitch_target_peak_at_true_bin():
    f0 = np.array([pn.FMIN_HZ * 2 ** (40 * pn.CENTS_PER_BIN / 1200.0)],
                  np.float32)
    tgt = np.asarray(pn.pitch_target(jnp.asarray(f0), jnp.asarray([True])))
    assert tgt.shape == (1, pn.N_BINS)
    assert tgt[0].argmax() == 40
    assert abs(tgt[0].sum() - 1.0) < 1e-3


def test_forward_matches_numpy_on_committed_checkpoint():
    """The plain-jnp MLP reads the committed Dense_k/{kernel,bias} tree
    unchanged and computes what a float64 NumPy forward pass does."""
    params = pn.load_params()
    feats = np.random.default_rng(0).standard_normal(
        (16, pn.N_RFFT)).astype(np.float32)
    logits, vlogit = pn.apply_model(params, jnp.asarray(feats))

    def dense(k, x):
        d = params[f"Dense_{k}"]
        return x @ d["kernel"].astype(np.float64) + d["bias"]

    x = feats.astype(np.float64)
    for k in range(len(pn.HIDDEN)):
        x = np.maximum(dense(k, x), 0.0)
    np.testing.assert_allclose(np.asarray(logits), dense(len(pn.HIDDEN), x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(vlogit),
                               dense(len(pn.HIDDEN) + 1, x)[:, 0],
                               rtol=1e-4, atol=1e-4)


def test_init_params_tree_matches_checkpoint():
    fresh = pn.init_params(0)
    saved = pn.load_params()
    assert fresh.keys() == saved.keys()
    for k in saved:
        for leaf in ("kernel", "bias"):
            assert fresh[k][leaf].shape == saved[k][leaf].shape
        assert not np.asarray(fresh[k]["bias"]).any()


# ------------------------------------------------------------ learning loop


def test_train_step_learns():
    d = make_clips(96, clip_len=4096, seed=11)
    params, opt_state = pn.init_train_state(0, hidden=(64,))
    step = pn.make_train_step(None, batch=64, hidden=(64,))
    args = (jnp.asarray(d["tracks"]), jnp.asarray(d["scale"]),
            jnp.asarray(d["f0_hz"]), jnp.asarray(d["voiced"]),
            jnp.asarray(d["label_w"]))
    key = jax.random.PRNGKey(2)
    first = None
    for i in range(120):
        params, opt_state, loss = step(params, opt_state, key, np.int32(i),
                                       *args)
        if first is None:
            first = float(loss)
    assert float(loss) < 0.7 * first, (first, float(loss))


def test_train_step_sharded_matches_finite():
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("data", "time"))
    d = make_clips(32, clip_len=4096, seed=5)
    params, opt_state = pn.init_train_state(0, hidden=(64,))
    step = pn.make_train_step(mesh, batch=32, hidden=(64,))
    params, opt_state, loss = step(
        params, opt_state, jax.random.PRNGKey(0), np.int32(0),
        jnp.asarray(d["tracks"]), jnp.asarray(d["scale"]),
        jnp.asarray(d["f0_hz"]), jnp.asarray(d["voiced"]),
        jnp.asarray(d["label_w"]))
    assert np.isfinite(float(loss))


# ------------------------------------------- committed checkpoint accuracy


needs_weights = pytest.mark.skipif(not pn.have_default_weights(),
                                   reason="no committed pitchnet checkpoint")


@needs_weights
def test_checkpoint_tracks_clean_tones():
    params = pn.load_params()
    for f in (110.0, 196.0, 440.0):
        y = _tone(pn.SR_NATIVE, f)
        out = pn.run_analyze_neural(y, pn.SR_NATIVE, 512, params,
                                    fetch_mel=False)
        v = out["voiced_flag"]
        assert v.mean() > 0.5, f
        med = np.median(out["f0"][v])
        cents = abs(1200 * np.log2(med / f))
        assert cents < 50, (f, med, cents)


@needs_weights
def test_non_native_rates_align():
    """44100 (uniform 256-hop) and 48000 (centers-gather) both produce
    original-grid frame counts with correct pitch — no cumulative drift."""
    params = pn.load_params()
    for sr in (44100, 48000):
        y = _tone(sr, 196.0, 1.0)
        out = pn.run_analyze_neural(y, sr, 512, params, fetch_mel=False)
        assert out["f0"].shape == (1 + len(y) // 512,)
        v = out["voiced_flag"]
        assert v.mean() > 0.5, sr
        med = np.median(out["f0"][v])
        assert abs(1200 * np.log2(med / 196.0)) < 50, (sr, med)
        # the tone dies at the end; the last frames must not be voiced
        # at a wrong time position (alignment, not just accuracy)
        first_half = v[: len(v) // 2].mean()
        assert first_half > 0.9, sr


@needs_weights
def test_neural_financial_pipeline():
    """pitch_backend='neural' through the financial engine: _FIN_ROWS all
    present, events detected, adaptive threshold finite."""
    from aegis_tpu.engine.financial import AegisFinancialEngine
    from aegis_tpu.tools.signal_gen import two_tone

    eng = AegisFinancialEngine(backend="device")
    a = eng.analyze(two_tone(sr=22050), pitch_backend="neural")
    for k in ("trend", "artic_codes", "slide_codes", "adaptive_threshold",
              "mute_mask", "combined_confidence"):
        assert k in a, k
    assert np.isfinite(a["adaptive_threshold"])
    ev, info = eng.extract_events(a, confidence_threshold=0.3)
    assert {55, 62} <= {e["note"] for e in ev}

    # non-native rate runs through the dual-rate financial program
    eng44 = AegisFinancialEngine(sample_rate=44100, backend="device")
    a44 = eng44.analyze(two_tone(sr=44100), pitch_backend="neural")
    assert a44["trend"].shape == a44["f0"].shape
    ev44, _ = eng44.extract_events(a44, confidence_threshold=0.3)
    assert {55, 62} <= {e["note"] for e in ev44}


@needs_weights
def test_neural_int8_transport_event_parity():
    """The default int8 block-float ingest must extract the SAME events as
    int16 through the neural backend, at the native rate AND through the
    dual-rate 44.1 kHz program (featurize standardizes per window, so the
    net is gain-invariant; this pins that the transport swap stays
    event-invisible)."""
    from aegis_tpu.core.events import extract_events_v1
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1
    from aegis_tpu.tools.signal_gen import generate_test_track

    params = pn.load_params()
    for sr in (pn.SR_NATIVE, 44100):
        y, _ = generate_test_track(sr=sr)

        def events(transport):
            out = pn.run_analyze_neural(y, sr, 512, params, fetch_mel=False,
                                        transport=transport)
            return extract_events_v1(
                out["rake_mask"], np.nan_to_num(out["f0"]),
                out["voiced_flag"], out["voiced_probs"], out["rms"],
                sr, 512, confidence_threshold=0.3,
                onset_env=out["onset_env"])

        e8, e16 = events("int8"), events("int16")
        m = note_event_f1(events_to_seconds(e16, sr, 512),
                          events_to_seconds(e8, sr, 512))
        assert m["f1"] == 1.0, (sr, m)


@needs_weights
def test_checkpoint_rejects_noise():
    rng = np.random.default_rng(0)
    y = (0.3 * rng.standard_normal(pn.SR_NATIVE)).astype(np.float32)
    out = pn.run_analyze_neural(y, pn.SR_NATIVE, 512, None or pn.load_params(),
                                fetch_mel=False)
    assert out["voiced_flag"].mean() < 0.4


@needs_weights
def test_engine_neural_backend():
    from aegis_tpu.engine.engine import AegisEngine

    for sr in (22050, 44100):
        eng = AegisEngine(sample_rate=sr)
        y = np.concatenate([_tone(sr, 196.0, 0.6), _tone(sr, 293.66, 0.6)])
        raw = eng.audio_to_midi(y, None, pitch_backend="neural")
        assert raw["f0"].shape == (1 + len(y) // eng.hop_length,)
        buf = io.BytesIO()
        ev = eng.extract_events(raw, buf, confidence_threshold=0.3)
        notes = {e["note"] for e in ev}
        assert {55, 62} <= notes, (sr, notes)

    with pytest.raises(ValueError):
        AegisEngine()._analyze(np.zeros(2048, np.float32), 0.6, False,
                               pitch_backend="bogus")


# --------------------------------------------------------- checkpoint io


def test_save_load_roundtrip(tmp_path):
    params = pn.init_params(0, hidden=(32,))
    path = str(tmp_path / "w.npz")
    pn.save_params(jax.device_get(params), path)
    loaded = pn.load_params(path)
    flat_a = jax.tree_util.tree_leaves(params)
    flat_b = jax.tree_util.tree_leaves(loaded)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a), b, atol=2e-3)


def test_checkpoint_metadata_and_version_gate(tmp_path):
    params = pn.init_params(0, hidden=(16,))
    path = str(tmp_path / "w.npz")
    pn.save_params(jax.device_get(params), path, metrics={"loss": 1.0})
    meta = pn.load_meta(path)
    assert meta["feature_version"] == pn.FEATURE_VERSION
    assert meta["metrics"]["loss"] == 1.0
    pn.load_params(path)  # matching version loads

    # a mismatched feature version must refuse to load
    import json

    z = dict(np.load(path))
    bad = json.loads(bytes(z["__meta__"]).decode())
    bad["feature_version"] = 999
    z["__meta__"] = np.frombuffer(json.dumps(bad).encode(),
                                  dtype=np.uint8).copy()
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError):
        pn.load_params(path)


@needs_weights
def test_committed_checkpoint_has_metadata():
    meta = pn.load_meta()
    assert meta.get("feature_version") == pn.FEATURE_VERSION
    assert meta["hidden"] == list(pn.HIDDEN)


# ------------------------------------ deterministic post-processing parity


def test_smooth_f0_median_parity():
    from aegis_tpu.ref.pitchnet_post_ref import smooth_f0_median_ref

    rng = np.random.default_rng(3)
    for trial in range(5):
        T = 64
        voiced = rng.random(T) < 0.7
        cents = rng.uniform(0, 4000, T)
        # inject octave-flip outliers the median should remove
        cents[rng.random(T) < 0.1] += 1200.0
        f0 = pn.FMIN_HZ * 2 ** (cents / 1200.0)
        f0 = np.where(voiced, f0, np.nan)
        dev = np.asarray(pn.smooth_f0_median(jnp.asarray(f0),
                                             jnp.asarray(voiced)))
        ref = smooth_f0_median_ref(np.nan_to_num(f0, nan=1.0), voiced)
        m = voiced
        np.testing.assert_allclose(dev[m], ref[m], rtol=1e-5)
        assert np.isnan(dev[~m]).all()


def test_onset_backfill_parity():
    from aegis_tpu.ref.pitchnet_post_ref import onset_backfill_ref

    rng = np.random.default_rng(7)
    for fps in (43.07, 86.13):
        for trial in range(5):
            T = 96
            voiced = np.zeros(T, bool)
            # a few voiced runs with silent gaps before them
            for s in rng.integers(10, T - 10, 4):
                voiced[s:s + rng.integers(3, 12)] = True
            f0 = np.where(voiced, rng.uniform(80, 800, T), np.nan)
            vprob = np.where(voiced, rng.uniform(0.5, 1.0, T), 0.05)
            env = rng.random(T).astype(np.float32) * 0.15
            env[rng.integers(0, T, 6)] = rng.uniform(0.5, 1.0, 6)
            pitch = {"f0": jnp.asarray(f0),
                     "voiced_flag": jnp.asarray(voiced),
                     "voiced_probs": jnp.asarray(vprob)}
            dev = pn._onset_backfill(pitch, jnp.asarray(env), fps)
            ref = onset_backfill_ref(
                {"f0": f0, "voiced_flag": voiced, "voiced_probs": vprob},
                env, fps)
            np.testing.assert_array_equal(np.asarray(dev["voiced_flag"]),
                                          ref["voiced_flag"])
            m = ref["voiced_flag"]
            np.testing.assert_allclose(np.asarray(dev["f0"])[m],
                                       ref["f0"][m], rtol=1e-6)
            np.testing.assert_allclose(np.asarray(dev["voiced_probs"]),
                                       ref["voiced_probs"], rtol=1e-6)


@needs_weights
def test_streamed_matches_fused():
    """Streamed slabs must reproduce the fused program's rows exactly:
    same int16 content (one per-track scale), same dB reference, every
    stage frame-local within the halo."""
    params = pn.load_params()
    rng = np.random.default_rng(5)
    sr = pn.SR_NATIVE
    segs = []
    # strongly varying segment amplitudes: a quiet late section exposed a
    # bug where the backfill's onset-peak threshold and the dB reference
    # were evaluated per slab instead of track-globally
    for f, amp in ((110.0, 0.9), (196.0, 0.08), (330.0, 0.5),
                   (247.0, 0.04)):
        t = np.arange(int(sr * 0.8)) / sr
        segs.append(amp * np.exp(-1.5 * t) * np.sin(2 * np.pi * f * t))
    y = np.concatenate(segs).astype(np.float32)
    y += (0.003 * rng.standard_normal(len(y))).astype(np.float32)

    # transport="int16": the slab mode ships int16 with ONE per-track scale
    # (block-float slab splices wouldn't be bit-exact), so the exactness
    # contract is defined — and tested — at matching int16 ingest
    fused = pn.run_analyze_neural(y, sr, 512, params, fetch_mel=False,
                                  transport="int16")
    streamed = pn.run_analyze_neural_streamed(
        y, sr, 512, params, fetch_mel=False,
        slab_frames=32, halo_frames=16)  # force many slabs
    for k in ("voiced_flag", "rake_mask"):
        np.testing.assert_array_equal(streamed[k], fused[k], err_msg=k)
    for k in ("f0", "voiced_probs", "rms", "onset_env"):
        np.testing.assert_allclose(
            np.nan_to_num(streamed[k]), np.nan_to_num(fused[k]),
            rtol=1e-5, atol=1e-6, err_msg=k)


@needs_weights
def test_streamed_matches_fused_high_fps():
    """Same contract at a HIGH frame rate (sr=44100, hop=256: ~172 fps,
    22.05 kHz hop 128 integral): the onset backfill's anchor window is
    k = round(0.14*fps) = 24 frames, so the slab halo must reach k+2
    frames left of every interior frame.  The old halo bound
    (0.08+0.04)*fps+4 = 25 < 26 broke exactness here — anchors near slab
    starts read a lag-padded flux predecessor (caught by review
    2026-08-18; the bound is now 0.14*fps+4)."""
    params = pn.load_params()
    rng = np.random.default_rng(11)
    sr = 44100
    segs = []
    for f, amp in ((110.0, 0.9), (196.0, 0.08), (330.0, 0.5),
                   (247.0, 0.04), (147.0, 0.3)):
        t = np.arange(int(sr * 0.5)) / sr
        segs.append(amp * np.exp(-2.5 * t) * np.sin(2 * np.pi * f * t))
    y = np.concatenate(segs).astype(np.float32)
    y += (0.003 * rng.standard_normal(len(y))).astype(np.float32)

    fused = pn.run_analyze_neural(y, sr, 256, params, fetch_mel=False,
                                  transport="int16")
    streamed = pn.run_analyze_neural_streamed(
        y, sr, 256, params, fetch_mel=False,
        slab_frames=48, halo_frames=8)  # many slabs; halo floor must lift
    for k in ("voiced_flag", "rake_mask"):
        np.testing.assert_array_equal(streamed[k], fused[k], err_msg=k)
    for k in ("f0", "voiced_probs", "rms", "onset_env"):
        np.testing.assert_allclose(
            np.nan_to_num(streamed[k]), np.nan_to_num(fused[k]),
            rtol=1e-5, atol=1e-6, err_msg=k)


@needs_weights
def test_streamed_44k_and_engine_route():
    from aegis_tpu.engine.engine import AegisEngine

    sr = 44100
    y = np.concatenate([_tone(sr, 196.0, 0.7), _tone(sr, 293.66, 0.7)])
    eng = AegisEngine(sample_rate=sr)
    raw = eng.audio_to_midi(y, None, pitch_backend="neural",
                            turbo_mode="stream")
    assert raw["f0"].shape == (1 + len(y) // 512,)
    import io as _io

    ev = eng.extract_events(raw, _io.BytesIO(), confidence_threshold=0.3)
    assert {55, 62} <= {e["note"] for e in ev}

    with pytest.raises(ValueError):  # exotic rate: no integral 22k hop
        pn.run_analyze_neural_streamed(y[:4096], 48000, 512, params=None)


@needs_weights
def test_neural_beats_pyin_on_scale_truth():
    """Against the scale benchmark's GROUND TRUTH (not pyin agreement),
    the neural backend must be perfect and at least as good as pyin.
    pyin locks ~91 ms late on the post-rake note (its conf there is 0.09),
    so neural-vs-pyin agreement caps at 0.875 on this clip while the
    neural onsets are all within ~31 ms of the actual notes — the truth
    comparison is what validate_device reports as *_truth_f1."""
    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.tools.signal_gen import generate_scale_benchmark
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    sr = 22050
    y, _, truth = generate_scale_benchmark(sr=sr)
    eng = AegisEngine(sample_rate=sr)
    ep = eng.extract_events(eng.audio_to_midi(y, None), None,
                            confidence_threshold=0.3)
    en = eng.extract_events(
        eng.audio_to_midi(y, None, pitch_backend="neural"), None,
        confidence_threshold=0.3)
    f1_p = note_event_f1(truth, events_to_seconds(ep, sr, 512))["f1"]
    f1_n = note_event_f1(truth, events_to_seconds(en, sr, 512))["f1"]
    assert f1_n == 1.0, (f1_n, en)
    assert f1_n >= f1_p


@needs_weights
def test_neural_44k_canonical_events_match_pyin():
    """validate_device's non-gating neural_f1 on the 44.1 kHz canonical
    clip (silence-E2-rake-A2-rake-D3), pinned as a pytest gate: a
    retrained checkpoint once shipped a ~70 ms post-rake onset lag that
    only this clip catches (rake-then-attack windows were out of the
    training distribution)."""
    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.tools.signal_gen import generate_test_track
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    sr = 44100
    y, _ = generate_test_track(sr=sr)
    eng = AegisEngine(sample_rate=sr)
    ep = eng.extract_events(eng.audio_to_midi(y, None), None,
                            confidence_threshold=0.3)
    en = eng.extract_events(
        eng.audio_to_midi(y, None, pitch_backend="neural"), None,
        confidence_threshold=0.3)
    f1 = note_event_f1(events_to_seconds(ep, sr, 512),
                       events_to_seconds(en, sr, 512))["f1"]
    assert f1 == 1.0, (f1, ep, en)


@needs_weights
def test_neural_robust_to_effects():
    """Neural-vs-pYIN event agreement survives the framework's own effect
    chain (measured F1 1.0 on every preset on the device; the two hardest
    presets gate here)."""
    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.synth.effects import apply_effect_chain
    from aegis_tpu.synth.presets import EFFECT_PRESETS
    from aegis_tpu.tools.signal_gen import generate_test_track
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    sr = 22050
    y = generate_test_track(sr=sr)[0]
    eng = AegisEngine(sample_rate=sr, backend="device")
    for preset in ("heavy_distortion", "ambient"):
        yfx = np.asarray(apply_effect_chain(y, EFFECT_PRESETS[preset], sr),
                         np.float32)
        ep = eng.extract_events(eng.audio_to_midi(yfx, None), None,
                                confidence_threshold=0.3)
        en = eng.extract_events(
            eng.audio_to_midi(yfx, None, pitch_backend="neural"), None,
            confidence_threshold=0.3)
        f1 = note_event_f1(events_to_seconds(ep, sr, 512),
                           events_to_seconds(en, sr, 512))["f1"]
        assert f1 >= 0.9, (preset, f1, ep, en)


def test_neural_folder_sweep_matches_engine(tmp_path):
    """transcribe_folder(pitch_backend='neural') — the dispatch-ahead
    sweep must produce exactly the per-track engine facade's events
    (same rows, same extraction defaults, incl. the neural forward
    onset snap)."""
    import os

    from aegis_tpu.engine.engine import AegisEngine
    from aegis_tpu.engine.poly import transcribe_folder
    from aegis_tpu.io.wav import write_wav
    from aegis_tpu.midi.decode import midi_to_notes

    sr = 22050
    clips = {
        "g.wav": np.concatenate([_tone(sr, 196.0, 0.6),
                                 _tone(sr, 293.66, 0.6)]),
        "a.wav": _tone(sr, 220.0, 0.9),
    }
    for name, y in clips.items():
        write_wav(str(tmp_path / name), y.astype(np.float32), sr)

    out_dir = tmp_path / "mid"
    results = transcribe_folder(str(tmp_path), str(out_dir),
                                sample_rate=sr, pitch_backend="neural",
                                confidence_threshold=0.3)
    assert len(results) == 2

    eng = AegisEngine(sample_rate=sr)
    for wav_path, mid_path, n_events in results:
        assert os.path.basename(wav_path) in clips
        # the engine must see exactly what the folder sweep loaded
        # (write_wav round-trips through int16 PCM)
        raw = eng.audio_to_midi(wav_path, None, pitch_backend="neural",
                                fetch_mel=False)
        expected = eng.extract_events(raw, None, confidence_threshold=0.3)
        assert n_events == len(expected), (wav_path, n_events, expected)
        got = sorted(n["note"] for n in
                     midi_to_notes(open(mid_path, "rb").read()))
        assert got == sorted(e["note"] for e in expected)

    with pytest.raises(ValueError):
        transcribe_folder(str(tmp_path), str(out_dir), sample_rate=sr,
                          pitch_backend="bogus")


def test_neural_batch_sharded_matches_fused():
    """run_analyze_neural_batch over the full 8-device mesh == the fused
    per-track program (data-parallel sharding must not change any row)."""
    from jax.sharding import Mesh

    if not pn.have_default_weights():
        pytest.skip("no committed checkpoint")
    sr = 22050
    t = np.arange(sr) / sr
    ys = np.stack([(0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32)
                   for f in (196.0, 261.63, 329.63)])  # 3 tracks, 8 devices
    params = pn.load_params()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "time"))
    out = pn.run_analyze_neural_batch(ys, sr, 512, params, financial=True,
                                      mesh=mesh)
    for i in range(len(ys)):
        ref = pn.run_analyze_neural(ys[i], sr, 512, params, fetch_mel=False,
                                    financial=True, transport="int16")
        assert (out["voiced_flag"][i] == ref["voiced_flag"]).all()
        m = ref["voiced_flag"]
        np.testing.assert_allclose(np.asarray(out["f0"][i])[m],
                                   np.asarray(ref["f0"])[m], rtol=1e-4)
        np.testing.assert_allclose(out["trend"][i], ref["trend"],
                                   rtol=1e-4, atol=1e-3)
        assert np.isclose(out["adaptive_threshold"][i],
                          ref["adaptive_threshold"], atol=1e-5)

    with pytest.raises(ValueError):
        pn.run_analyze_neural_batch(ys, 44100, 1024, params, mesh=mesh)
    with pytest.raises(ValueError):
        pn.run_analyze_neural_batch(ys[0], sr, 512, params, mesh=mesh)
