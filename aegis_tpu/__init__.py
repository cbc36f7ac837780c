"""aegis_tpu — guitar audio → MIDI/tablature transcription framework in JAX.

A ground-up JAX/XLA redesign with the capabilities of the reference
"Aegis Engine" (avabag01-ai/spectrogram-midi): spectrogram → pitch salience →
noise masks → trend filters → note events → MIDI, plus the surrounding
self-verification loops, synthesis, harmony analysis, tablature and serving
layers.

Design stance (see SURVEY.md §7):
  * The hot loop (STFT → mel → pYIN → RMS) runs as one jitted device program,
    batched over fixed-size frame tiles; long audio is sharded over a
    ``jax.sharding.Mesh`` time axis with halo overlap (``engine.turbo``).
  * Per-frame Python loops of the reference are re-expressed as ``lax.scan``
    recurrences / windowed reductions (``core.trend``), segment reductions
    (``core.masks``) and fixed-shape vectorized math (``core.pyin``).
  * A faithful NumPy implementation of every device kernel lives in
    ``aegis_tpu.ref`` and serves as the CPU oracle for parity tests.
  * Host-side: MIDI SMF codec, MusicXML, tabs, WAV I/O, servers.
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


# Persistent XLA compilation cache: the fused analyze program takes seconds to
# compile and milliseconds to load.  Set here, before any jax import (the
# package imports jax lazily), so every entry point shares it.
_os.environ["JAX_COMPILATION_CACHE_DIR"] = compile_cache_dir()
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1.0")
if "jax" in __import__("sys").modules:  # imported first: env was read already
    import jax as _jax

    if _jax.config.jax_compilation_cache_dir is None:
        _jax.config.update("jax_compilation_cache_dir",
                           _os.environ["JAX_COMPILATION_CACHE_DIR"])
        _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from aegis_tpu.config import AudioConfig, DetectorConfig, PyinConfig  # noqa: F401


def __getattr__(name):
    # Lazy imports keep `import aegis_tpu` cheap (no jax import until needed).
    if name == "AegisEngine":
        from aegis_tpu.engine.engine import AegisEngine

        return AegisEngine
    if name == "AegisFinancialEngine":
        from aegis_tpu.engine.financial import AegisFinancialEngine

        return AegisFinancialEngine
    raise AttributeError(f"module 'aegis_tpu' has no attribute {name!r}")
