"""pYIN: JAX device implementation vs NumPy oracle, and absolute accuracy."""

import numpy as np
import pytest

from aegis_tpu.core.pyin import pyin as jpyin
from aegis_tpu.ref.pyin_ref import pyin as rpyin


def test_pyin_parity(two_tone_22k):
    y, sr = two_tone_22k
    f0r, vfr, vpr = rpyin(y, sr)
    f0j, vfj, vpj = (np.asarray(a) for a in jpyin(y, sr))

    assert (vfr == vfj).mean() == 1.0
    m = vfr & vfj
    assert np.max(np.abs(f0r[m] - f0j[m]) / f0r[m]) < 1e-4
    assert np.max(np.abs(vpr - vpj)) < 1e-4


@pytest.mark.parametrize("freq", [110.0, 220.0, 440.0, 880.0])
def test_pyin_absolute_accuracy(freq):
    sr = 22050
    t = np.arange(int(sr * 0.5)) / sr
    y = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    f0, vf, vp = rpyin(y, sr)
    # ignore attack/decay edges
    inner = slice(4, len(f0) - 4)
    assert vf[inner].mean() > 0.9
    med = np.nanmedian(f0[inner])
    # within half a pitch bin (0.05 semitone)
    cents = 1200 * np.log2(med / freq)
    assert abs(cents) < 10


def test_pyin_silence_is_unvoiced():
    sr = 22050
    y = np.zeros(sr // 2, dtype=np.float32)
    f0, vf, vp = rpyin(y, sr)
    assert vf.mean() < 0.1
    assert np.all(np.isnan(f0[~vf]))

    f0j, vfj, _ = (np.asarray(a) for a in jpyin(y, sr))
    assert np.asarray(vfj).mean() < 0.1


def test_pyin_noise_low_confidence(rng):
    sr = 22050
    y = rng.normal(0, 0.1, sr // 2).astype(np.float32)
    _, _, vp = rpyin(y, sr)
    assert vp.mean() < 0.55


