"""Golden-fixture tests: pin the CPU oracle to REAL librosa outputs.

Fixtures are produced by ``python -m aegis_tpu.tools.make_golden`` in any
environment with librosa installed (it is not installed in the test image —
zero egress).  While absent these tests SKIP loudly; once committed they make
the F1-vs-librosa gate non-self-referential: ``aegis_tpu.ref`` is compared
against actual librosa arrays, and the device kernels are parity-tested
against ``ref`` elsewhere, closing the chain
device == ref == librosa  (VERDICT r1, "What's missing" #1).
"""

import glob
import os

import numpy as np
import pytest

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.tools.signal_gen import generate_test_track, two_tone

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SKIP_MSG = ("golden fixtures absent — generate with "
            "`python -m aegis_tpu.tools.make_golden` in a librosa "
            "environment (librosa is not installed in the test image)")

_CLIPS = {
    "two_tone_22050": (22050, lambda: two_tone(sr=22050)),
    "ks_track_22050": (22050, lambda: generate_test_track(sr=22050)[0]),
    "ks_track_44100": (44100, lambda: generate_test_track(sr=44100)[0]),
}


def _fixture(name):
    path = os.path.join(GOLDEN, f"librosa_{name}.npz")
    if not os.path.exists(path):
        pytest.skip(SKIP_MSG)
    return np.load(path)


@pytest.mark.parametrize("name", list(_CLIPS))
def test_pyin_matches_librosa(name):
    from aegis_tpu.ref.pyin_ref import pyin as rpyin

    sr, make = _CLIPS[name]
    g = _fixture(name)
    y = make()
    f0, vf, vp = rpyin(y, sr)
    n = min(len(f0), len(g["f0"]))

    assert (vf[:n] == g["voiced_flag"][:n]).mean() > 0.99
    both = vf[:n] & g["voiced_flag"][:n]
    cents = 1200 * np.log2(f0[:n][both] / g["f0"][:n][both])
    assert np.nanmax(np.abs(cents)) < 10  # within one pitch bin
    assert np.nanmax(np.abs(vp[:n] - g["voiced_probs"][:n])) < 0.05


@pytest.mark.parametrize("name", list(_CLIPS))
def test_mel_rms_match_librosa(name):
    from aegis_tpu.ref.dsp_ref import melspectrogram, power_to_db, rms

    sr, make = _CLIPS[name]
    g = _fixture(name)
    y = make()
    mel_db = power_to_db(melspectrogram(y, sr, 2048, 512, 128)).T
    n = min(len(mel_db), len(g["mel_db"]))
    assert np.abs(mel_db[:n] - g["mel_db"][:n]).max() < 0.05  # dB
    r = rms(y, 2048, 512)
    n = min(len(r), len(g["rms"]))
    np.testing.assert_allclose(r[:n], g["rms"][:n], atol=1e-5)


def test_e2e_f1_vs_librosa_events():
    """End-to-end: note events from LIBROSA's pyin arrays vs the oracle's —
    the actual F1 gate with a librosa-derived reference side."""
    from aegis_tpu.core.events import extract_events_v1
    from aegis_tpu.ref.pipeline_ref import run_analyze_ref
    from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1

    sr, make = _CLIPS["ks_track_22050"]
    g = _fixture("ks_track_22050")
    y = make()
    raw = run_analyze_ref(y, AudioConfig(sample_rate=sr), PyinConfig())
    n = min(len(raw["f0"]), len(g["f0"]))

    def events(f0, vf, vp):
        return extract_events_v1(
            rake_mask=raw["rake_mask"][:n], f0=np.nan_to_num(f0[:n]),
            voiced_flag=vf[:n], active_probs=vp[:n], rms=raw["rms"][:n],
            sr=sr, hop_length=512, confidence_threshold=0.5)

    ours = events(raw["f0"], raw["voiced_flag"], raw["voiced_probs"])
    theirs = events(g["f0"], g["voiced_flag"], g["voiced_probs"])
    assert theirs, "librosa-side extraction produced no events"
    m = note_event_f1(events_to_seconds(theirs, sr, 512),
                      events_to_seconds(ours, sr, 512))
    assert m["f1"] >= 0.99, m


def test_resample_matches_librosa():
    from aegis_tpu.io.audio import resample

    path = os.path.join(GOLDEN, "librosa_resample_44to22.npz")
    if not os.path.exists(path):
        pytest.skip(SKIP_MSG)
    g = np.load(path)
    y44 = generate_test_track(sr=44100)[0]
    y22 = resample(np.asarray(y44, np.float32), 44100, 22050)
    n = min(len(y22), len(g["y22"]))
    # different resamplers (polyphase vs soxr): assert sample-domain
    # closeness away from the edges rather than bit equality
    err = np.abs(y22[100:n - 100] - g["y22"][100:n - 100])
    assert float(np.sqrt(np.mean(err ** 2))) < 5e-3
