"""Source-separation (stem) wrapper.

The reference shells out to the Demucs CLI and falls back to the original mix
when it is unavailable (aegis_engine_core/stems.py:12-29, with a hardcoded
user path we do not replicate).  Demucs is discovered on PATH or via
$AEGIS_DEMUCS_BIN; retraining/porting the model is out of scope (SURVEY.md
§2.7).

Beyond-reference: when Demucs is absent, ``method="auto"`` (the default)
degrades to on-device harmonic/percussive separation (core/hpss.py) instead
of silently returning the unseparated mix — drums and pick transients are
stripped on the device, which is exactly what the downstream
monophonic pitch tracker wants.  ``method="hpss"`` forces it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

from aegis_tpu.utils.logging import get_logger

log = get_logger("Stems")

DEMUCS_MODELS = ("htdemucs", "htdemucs_ft", "mdx_extra")


def find_demucs() -> Optional[str]:
    env = os.environ.get("AEGIS_DEMUCS_BIN")
    if env and os.path.exists(env):
        return env
    return shutil.which("demucs")


def separate_hpss(input_wav: str, output_dir: str) -> str:
    """On-device harmonic/percussive split; returns the harmonic stem path
    (the guitar-ish content) and writes the percussive stem alongside it."""
    import numpy as np

    from aegis_tpu.core.hpss import hpss
    from aegis_tpu.io.audio import load_audio
    from aegis_tpu.io.wav import write_wav

    y, sr = load_audio(input_wav, sr=None)
    y_h, y_p = hpss(np.asarray(y, np.float32))
    base = os.path.splitext(os.path.basename(input_wav))[0]
    stem_dir = os.path.join(output_dir, "hpss", base)
    os.makedirs(stem_dir, exist_ok=True)
    harm = os.path.join(stem_dir, "other.wav")
    write_wav(harm, y_h, sr)
    write_wav(os.path.join(stem_dir, "drums.wav"), y_p, sr)
    log.info(f"HPSS stems written to {stem_dir}")
    return harm


def separate_stems(input_wav: str, output_dir: str,
                   model: str = "htdemucs", timeout: float = 600.0,
                   method: str = "auto") -> str:
    """Return the guitar-ish stem: Demucs 'other' when available, the
    on-device HPSS harmonic stem otherwise (method="auto"); "demucs" and
    "hpss" force one path.  Falls back to the original input only when the
    forced method fails."""
    if method == "hpss":
        return separate_hpss(input_wav, output_dir)
    binary = find_demucs()
    if binary is None:
        if method == "auto":
            log.info("demucs not found; on-device HPSS fallback")
            try:
                return separate_hpss(input_wav, output_dir)
            except Exception as e:
                log.warning(f"HPSS failed ({e}); using original mix")
                return input_wav
        log.warning("demucs not found; using original mix")
        return input_wav
    try:
        subprocess.run(
            [binary, "-n", model, "-o", output_dir, input_wav],
            check=True, capture_output=True, timeout=timeout,
        )
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        log.warning(f"demucs failed ({e}); using original mix")
        return input_wav
    base = os.path.splitext(os.path.basename(input_wav))[0]
    other = os.path.join(output_dir, model, base, "other.wav")
    if os.path.exists(other):
        return other
    log.warning("demucs produced no 'other' stem; using original mix")
    return input_wav


def separate_all_stems(input_wav: str, output_dir: str,
                       model: str = "htdemucs") -> List[str]:
    """All four stems (drums/bass/other/vocals) or [] when unavailable."""
    binary = find_demucs()
    if binary is None:
        return []
    try:
        subprocess.run([binary, "-n", model, "-o", output_dir, input_wav],
                       check=True, capture_output=True, timeout=600)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return []
    base = os.path.splitext(os.path.basename(input_wav))[0]
    stem_dir = os.path.join(output_dir, model, base)
    return [
        os.path.join(stem_dir, f)
        for f in ("drums.wav", "bass.wav", "other.wav", "vocals.wav")
        if os.path.exists(os.path.join(stem_dir, f))
    ]
