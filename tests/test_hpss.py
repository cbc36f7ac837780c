"""HPSS (core/hpss.py): iSTFT exactness, device-vs-oracle parity,
separation quality, and the stems-wrapper fallback."""

import os

import jax.numpy as jnp
import numpy as np

from aegis_tpu.core.hpss import hpss, hpss_program, istft, stft_complex
from aegis_tpu.ref.hpss_ref import hpss_ref

SR = 22050


def _mix(dur=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * dur)) / SR
    tone = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.25 * np.sin(2 * np.pi * 440 * t)
    clicks = np.zeros_like(t)
    for c in np.arange(0.1, dur - 0.05, 0.15):
        k = int(c * SR)
        clicks[k:k + 80] += rng.standard_normal(80) * 0.6
    return (tone + clicks).astype(np.float32), tone, clicks


def test_istft_roundtrip_exact():
    t = np.arange(8192) / SR
    y = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    r, i = stft_complex(jnp.asarray(y), 2048, 512)
    rec = np.asarray(istft(r, i, 2048, 512, len(y)))
    assert np.abs(rec - y).max() < 1e-5


def test_hpss_program_matches_oracle():
    y, _, _ = _mix()
    out = np.asarray(hpss_program(jnp.asarray(y), length=len(y)))
    yh_r, yp_r = hpss_ref(y)
    assert np.abs(out[0] - yh_r).max() < 1e-4
    assert np.abs(out[1] - yp_r).max() < 1e-4


def test_hpss_wrapper_exact_at_any_length():
    """The bucket-padded wrapper equals an exact-length program run at EVERY
    sample — including the last ~kernel_time//2 frames, whose time-median
    context is edge-replicated via the traced n_frames mask rather than
    polluted by the bucket's zero tail."""
    from aegis_tpu.core.analyze import quantize_pcm16

    y, _, _ = _mix(1.37, seed=3)  # length far off any bucket edge
    yh, yp = hpss(y)
    y16, s = quantize_pcm16(y)  # the wrapper's int16 transport, replayed
    yq = y16.astype(np.float32) * s
    exact = np.asarray(hpss_program(jnp.asarray(yq), length=len(y)))
    # not bit-identical: the masked on-device window-sum accumulates in a
    # different f32 order than the host-precomputed one (~1e-5 on the device)
    assert np.abs(yh - exact[0]).max() < 5e-5
    assert np.abs(yp - exact[1]).max() < 5e-5
    # and the tail agrees with the float64 oracle to transport precision
    yh_r, yp_r = hpss_ref(yq)
    tail = slice(len(y) - 10 * 512, len(y))
    assert np.abs(yh[tail] - yh_r[tail]).max() < 1e-4
    assert np.abs(yp[tail] - yp_r[tail]).max() < 1e-4


def test_hpss_slab_mode_matches_unsliced():
    """Force the slab path on a short mix and check it equals the one-shot
    program (the halo argument: exact, not approximate)."""
    from aegis_tpu.core import hpss as H

    y, _, _ = _mix(2.0)
    yh1, yp1 = hpss(y)
    old = H._SLAB_SAMPLES
    try:
        H._SLAB_SAMPLES = 1 << 15  # ~1.5 s -> several slabs
        yh2, yp2 = hpss(y)
    finally:
        H._SLAB_SAMPLES = old
    # one track-global int16 scale + hop-aligned slab starts: the slab
    # path is EXACT vs unsliced now (only float accumulation order noise)
    assert np.abs(yh1 - yh2).max() < 5e-5
    assert np.abs(yp1 - yp2).max() < 5e-5


def test_hpss_slab_mode_non_pow2_hop():
    """Review r2: a legal non-power-of-2 hop (hop | n_fft still holds) used
    to put slab frames on a shifted grid — slab starts are now hop-aligned,
    so the slab path stays exact."""
    from aegis_tpu.core import hpss as H

    y, _, _ = _mix(2.0)
    kw = dict(n_fft=1800, hop_length=600)
    yh1, yp1 = hpss(y, **kw)
    old = H._SLAB_SAMPLES
    try:
        H._SLAB_SAMPLES = 1 << 15
        yh2, yp2 = hpss(y, **kw)
    finally:
        H._SLAB_SAMPLES = old
    assert np.abs(yh1 - yh2).max() < 5e-5
    assert np.abs(yp1 - yp2).max() < 5e-5


def test_hpss_separates_tone_from_clicks():
    y, tone, clicks = _mix()
    yh, yp = hpss(y)
    assert np.corrcoef(yh, tone)[0, 1] > 0.95
    assert np.corrcoef(yp, clicks)[0, 1] > 0.7
    # energy conservation within the masked decomposition (soft masks sum
    # to ~1 per bin)
    assert abs((yh + yp).mean() - y.mean()) < 0.05


def test_separate_stems_hpss_fallback(tmp_path, monkeypatch):
    from aegis_tpu.io.wav import write_wav
    from aegis_tpu.synth import stems

    y, _, _ = _mix(0.5)
    src = str(tmp_path / "in.wav")
    write_wav(src, y, SR)

    monkeypatch.setattr(stems, "find_demucs", lambda: None)
    out = stems.separate_stems(src, str(tmp_path), method="auto")
    assert out != src and out.endswith("other.wav") and os.path.exists(out)
    assert os.path.exists(os.path.join(os.path.dirname(out), "drums.wav"))

    forced = stems.separate_stems(src, str(tmp_path / "f"), method="hpss")
    assert forced.endswith("other.wav")

    from aegis_tpu.io.wav import read_wav

    yh, sr2 = read_wav(out)
    assert sr2 == SR and len(yh) == len(y)
