"""Turbo: sharded/tiled device execution for long audio and track batches.

The reference's Turbo mode chunks the waveform across CPU processes with *no
overlap*, accepting pYIN seam artifacts (aegis_engine.py:183-216, SURVEY.md
§5.7).  Here Turbo is a ``shard_map`` over a ``jax.sharding.Mesh``:

  * axis "time" — the audio is cut into fixed tiles of ``tile_frames`` frames
    with ``halo_frames`` of context on each side; every tile runs the full
    analyze program (mel → rake → pYIN Viterbi → RMS) and the halo frames are
    dropped on merge, so the HMM has warm context at every seam (what the
    reference's chunking approximates, done properly).
  * axis "data" — independent tracks batch along the leading axis (the
    reference's "folder sweep" scenario).
  * raw int16 PCM is sharded CONTIGUOUSLY over the time axis (half the
    upload bytes of float32, no host-side halo duplication); each device
    fetches its halo context from mesh neighbors with one
    ``jax.lax.ppermute`` per direction — unmatched edge devices
    receive zeros, which is exactly the global center/tail padding.
  * the only other cross-tile communication is a ``jax.lax.pmax`` over the
    time axis so each track's dB reference (power_to_db ref=max, SURVEY's
    load-bearing convention) is track-global rather than per-tile — one
    per-track scalar collective.

Single-device execution uses the same code with a 1-device mesh (vmap over
tiles); multi-device correctness is validated on a virtual CPU mesh
(tests/test_turbo.py, __graft_entry__.dryrun_multichip) and on four GPUs
(``chip_smoke.py --four-cards``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from aegis_tpu.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu.core import masks
from aegis_tpu.core.filters import dft_matrices, hann_window, mel_filterbank
from aegis_tpu.core.analyze import (_FIN_ROWS, _GTR_ROWS, _V1_ROWS,
                                    PCM8_BLOCK, _unpack)
from aegis_tpu.core.pyin import pyin_from_frames


def _slab_span(tile_frames: int, halo: int, hop: int, frame_length: int) -> int:
    return (tile_frames + 2 * halo - 1) * hop + frame_length



# --------------------------------------------------------------------------
# Per-tile device program
# --------------------------------------------------------------------------


def _frame_slab(slab: jnp.ndarray, n_frames: int, hop: int, frame_len: int,
                offset: int) -> jnp.ndarray:
    """Overlapping frames of a 1-D slab via contiguous slice+reshape copies
    (frame_len % hop == 0 here), no row gather, as in dsp.frame_signal."""
    if frame_len % hop == 0:
        k = frame_len // hop
        need = offset + (n_frames + k - 1) * hop
        x = slab[offset:]
        if need - offset > x.shape[0]:
            x = jnp.pad(x, (0, need - offset - x.shape[0]))
        parts = [x[i * hop:(i + n_frames) * hop].reshape(n_frames, hop)
                 for i in range(k)]
        return jnp.concatenate(parts, axis=1)
    idx = np.arange(n_frames)[:, None] * hop + offset + \
        np.arange(frame_len)[None, :]
    return slab[idx]


def _tile_mel_power(slab: jnp.ndarray, audio: AudioConfig,
                    pyin_cfg: PyinConfig, turbo: TurboConfig) -> jnp.ndarray:
    """(T2, n_mels) mel power for one slab (T2 = tile + 2*halo frames)."""
    hop, fl, n_fft = audio.hop_length, pyin_cfg.frame_length, audio.n_fft
    t2 = turbo.tile_frames + 2 * turbo.halo_frames
    # STFT frames: window n_fft centered at frame*hop + fl//2 within the slab
    # (slab already includes the center padding offset).
    off = (fl - n_fft) // 2
    frames = _frame_slab(slab, t2, hop, n_fft, off)
    frames = frames * jnp.asarray(hann_window(n_fft))[None, :]
    cos_m, sin_m = dft_matrices(n_fft)
    re = jnp.dot(frames, jnp.asarray(cos_m), preferred_element_type=jnp.float32)
    im = jnp.dot(frames, jnp.asarray(sin_m), preferred_element_type=jnp.float32)
    power = re * re + im * im
    fb = jnp.asarray(mel_filterbank(audio.sample_rate, n_fft, audio.n_mels).T)
    return jnp.dot(power, fb, preferred_element_type=jnp.float32)


def _tile_analyze(slab: jnp.ndarray, mel_db: jnp.ndarray, rake_sens: jnp.ndarray,
                  audio: AudioConfig, pyin_cfg: PyinConfig,
                  turbo: TurboConfig,
                  financial: bool = False,
                  use_guitar_filters: bool = True) -> Dict[str, jnp.ndarray]:
    """pYIN + RMS + rake for one slab, cropped to the tile interior.

    With ``financial=True`` the guitar-specific filters (sub-E2 correction,
    rake enhancement, palm-mute mask — analyze_financial_program's phase
    3.5) also run here, ON THE HALOED ARRAYS: every one of them has bounded
    temporal extent (rake runs <= 30 ms, palm-mute runs <= 50 ms, rake
    enhancement window 30 ms — all of it 1-3 frames at hop 512, far inside
    the >= 64-frame halo), so cropping to the interior afterwards is exact.
    The whole-track trend recurrences do NOT run per tile — see the
    financial branch of analyze_audio_sharded."""
    hop, fl = audio.hop_length, pyin_cfg.frame_length
    tile, halo = turbo.tile_frames, turbo.halo_frames
    t2 = tile + 2 * halo

    frames = _frame_slab(slab, t2, hop, fl, 0)
    f0, voiced, probs = pyin_from_frames(frames, audio.sample_rate, hop, pyin_cfg)
    rms_ = jnp.sqrt(jnp.mean(frames * frames, axis=-1))
    rake = masks.detect_rake(mel_db, hop, audio.sample_rate, rake_sens)

    from aegis_tpu.core.cqt import onset_from_db

    # flux over the haloed tile so the lagged diff is seam-exact
    onset_env = onset_from_db(mel_db)

    sl = slice(halo, halo + tile)
    out = {}
    if financial:
        if use_guitar_filters:
            f0, voiced = masks.filter_subharmonic(f0, voiced, fmin_hz=82.4)
            rake = masks.enhance_rake(mel_db, hop, audio.sample_rate, rake)
            mute = masks.detect_palm_mute(mel_db, hop, audio.sample_rate)
            voiced = voiced & ~mute
            out["mute_mask"] = mute[sl]
        else:
            out["mute_mask"] = jnp.zeros((tile,), bool)
        # distortion_score partial sums, PER INTERIOR FRAME — reduced
        # across tiles with one psum (turbo) or on host over the true
        # frames (streamed)
        n_mels = mel_db.shape[1]
        hi = int(n_mels * 0.7)
        out["dist_high_sum"] = jnp.sum(mel_db[sl, hi:], axis=1)
        out["dist_total_sum"] = jnp.sum(mel_db[sl], axis=1)
    out.update({
        "f0": f0[sl],
        "voiced_flag": voiced[sl],
        "voiced_probs": probs[sl],
        "rms": rms_[sl],
        "rake_mask": rake[sl],
        "mel_db": mel_db[sl],
        "onset_env": onset_env[sl],
    })
    return out


# --------------------------------------------------------------------------
# Sharded program (on-device halo exchange)
# --------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("audio", "pyin_cfg", "turbo", "mesh", "n_tiles",
                     "data_axis", "time_axis", "include_mel", "financial",
                     "use_guitar_filters", "guitar_only", "peak_only"),
)
def analyze_audio_sharded(
    y16: jnp.ndarray,  # (B, n_tiles*tile*hop) int16 PCM, time-sharded
    scale: jnp.ndarray,
    rake_sens: jnp.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    turbo: TurboConfig,
    mesh: Mesh,
    n_tiles: int,
    data_axis: str = "data",
    time_axis: str = "time",
    include_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
    guitar_only: bool = False,
    peak_only: bool = False,
    edge16: jnp.ndarray | None = None,   # (B, 2*ctx) int16: real slab-edge
                                         # context (streamed mode); None = the
                                         # zero-fill track-edge convention
    db_ref: jnp.ndarray | None = None,   # (B,) mel-power dB reference; None =
                                         # track-global pmax (ref=max)
    edge_scale: jnp.ndarray | None = None,  # (B,) per-track int16 scale for
                                         # edge16 when ``scale`` is the 2-D
                                         # int8 block-scale plane; None =
                                         # dequantize edges with ``scale``
) -> jnp.ndarray:
    """shard_map over (data, time) with ON-DEVICE halo exchange.

    Returns ONE packed (B, n_tiles, tile, [n_mels +] len(rows)) float32
    buffer (columns: optional mel_db then _V1_ROWS / _FIN_ROWS) — unpack
    with _unpack.

    ``financial=True`` runs the full v2 pipeline sharded (reference
    aegis_engine_financial.py:73-188).  The guitar-specific filters run
    per tile on the haloed window (bounded temporal extent — exact, see
    _tile_analyze).  The whole-track trend recurrences (EMA/Kalman/Holt
    consensus, Bollinger, MACD, RSI) are NOT tiled: their input is just a
    handful of (T,) float rows (~10 KB per minute of audio), so each
    time-axis device ``all_gather``s the full-track f0/confidence rows
    and computes the trend stack REPLICATED, then keeps its local
    slice.  That is exact by construction (identical op order on identical
    full-length input — no halo-sufficiency argument needed) and costs less
    than one halo exchange; the expensive work (mel/pYIN, ~99% of FLOPs)
    stays sharded.  Global scalars (adaptive threshold, distortion score)
    come out identical on every device the same way.

    The raw int16 audio is sharded contiguously over the time axis — no
    host-side slab duplication and half the upload bytes of float32.  Each
    device dequantizes its block and fetches halo context (halo*hop +
    frame_length//2 samples each side) from its mesh neighbors with ONE
    ``jax.lax.ppermute`` per direction; unmatched edge devices
    receive zeros, which is exactly the global center-pad / tail-pad
    convention of the single-device path.  Local tile slabs are then plain
    static slices of the extended block.
    """
    hop, fl = audio.hop_length, pyin_cfg.frame_length
    tile, halo = turbo.tile_frames, turbo.halo_frames
    span = _slab_span(tile, halo, hop, fl)
    ctx = halo * hop + fl // 2  # halo context per side
    n_time = mesh.shape[time_axis]
    k_local = n_tiles // n_time
    if ctx > k_local * tile * hop:
        raise ValueError(
            f"halo context ({ctx} samples) exceeds a device's local block "
            f"({k_local * tile * hop} samples): the one-hop ppermute cannot "
            f"fetch it. Increase tile_frames or reduce halo_frames/mesh "
            f"time-axis size.")

    has_edge = edge16 is not None
    has_ref = db_ref is not None

    def worker(y_loc, sc, rs, edge, dref, esc):
        b, s_local = y_loc.shape
        if sc.ndim == 2:
            # int8 block-float slab transport (streamed mode): ``sc`` is
            # the (B, s_local/PCM8_BLOCK) local slice of the per-block
            # scale plane, time-sharded alongside the audio; the local
            # block length is a PCM8_BLOCK multiple by construction
            # (tile*hop is) so block boundaries never cross devices
            y_f = (y_loc.astype(jnp.float32)
                   .reshape(b, -1, PCM8_BLOCK)
                   * sc[:, :, None]).reshape(b, s_local)
        else:
            y_f = y_loc.astype(jnp.float32) * sc[:, None]  # per-track

        fwd = [(i, i + 1) for i in range(n_time - 1)]   # tail -> next dev
        bwd = [(i + 1, i) for i in range(n_time - 1)]   # head -> prev dev
        left = jax.lax.ppermute(y_f[:, -ctx:], time_axis, fwd)
        right = jax.lax.ppermute(y_f[:, :ctx], time_axis, bwd)
        if has_edge:
            # streamed slabs: the outermost devices splice REAL neighboring
            # audio (passed replicated, always int16 with a per-track
            # scale — ``esc`` in block mode, ``sc`` itself otherwise)
            # instead of the zero-fill track-edge convention
            e_sc = esc if sc.ndim == 2 else sc
            idx_t = jax.lax.axis_index(time_axis)
            e_l = edge[:, :ctx].astype(jnp.float32) * e_sc[:, None]
            e_r = edge[:, ctx:].astype(jnp.float32) * e_sc[:, None]
            left = jnp.where(idx_t == 0, e_l, left)
            right = jnp.where(idx_t == n_time - 1, e_r, right)
        y_ext = jnp.concatenate([left, y_f, right], axis=1)

        # slab j starts at raw coord (g*tile - halo)*hop - fl//2 with
        # g = dev*k_local + j; y_ext[0] sits exactly at j=0's start.
        slabs = jnp.stack(
            [y_ext[:, j * tile * hop: j * tile * hop + span]
             for j in range(k_local)], axis=1)  # (b, k_local, span)
        flat = slabs.reshape(b * k_local, span)

        mel_power = jax.vmap(
            lambda s: _tile_mel_power(s, audio, pyin_cfg, turbo)
        )(flat)
        # PER-TRACK dB reference (matching the single-device power_to_db
        # ref=max semantics): max over this track's local tiles, then pmax
        # across the time axis only — NOT across the data axis, which would
        # reference quiet tracks to the loudest track in the batch
        local_max = jnp.max(
            mel_power.reshape(b, k_local, -1), axis=(1, 2))  # (b,)
        gmax = dref if has_ref else jax.lax.pmax(local_max, time_axis)  # (b,)
        if peak_only:
            # pass-1 of the streamed mode: just the slab's mel-power peak
            # over the tile INTERIORS (halo copies equal their interior
            # twins, so this matches the haloed max exactly)
            t2 = tile + 2 * halo
            interior = mel_power.reshape(b, k_local, t2, -1)[
                :, :, halo: halo + tile]
            return jax.lax.pmax(jnp.max(interior, axis=(1, 2, 3)), time_axis)
        gmax_t = jnp.repeat(gmax, k_local)[:, None, None]
        amin = 1e-10
        log_spec = 10.0 * jnp.log10(jnp.maximum(amin, mel_power))
        log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(amin, gmax_t))
        mel_db = jnp.maximum(log_spec, -80.0)

        out = jax.vmap(
            lambda s, m: _tile_analyze(s, m, rs, audio, pyin_cfg, turbo,
                                       financial=financial or guitar_only,
                                       use_guitar_filters=use_guitar_filters)
        )(flat, mel_db)

        if financial:
            from aegis_tpu.core import trend

            L = k_local * tile  # frames per device
            f0_loc = out["f0"].reshape(b, L)
            voiced_loc = out["voiced_flag"].reshape(b, L)
            probs_loc = out["voiced_probs"].reshape(b, L)
            f0_clean = jnp.where(voiced_loc, f0_loc, jnp.nan)
            # full-track rows on every time-axis device (tiny: 4B/frame)
            f0_full = jax.lax.all_gather(f0_clean, time_axis, axis=1,
                                         tiled=True)       # (b, n_time*L)
            probs_full = jax.lax.all_gather(probs_loc, time_axis, axis=1,
                                            tiled=True)
            fin = jax.vmap(trend.analyze_pitch_financial)(f0_full)
            combined = probs_full * 0.5 + fin["confidence"] * 0.5
            thr = jax.vmap(trend.adaptive_confidence_threshold)(combined)

            # distortion_score: one psum of the tile-interior partial sums
            n_mels = audio.n_mels
            hi_bins = n_mels - int(n_mels * 0.7)
            t_full = n_tiles * tile
            high = jax.lax.psum(
                out["dist_high_sum"].reshape(b, -1).sum(1), time_axis)
            tot = jax.lax.psum(
                out["dist_total_sum"].reshape(b, -1).sum(1), time_axis)
            dist = (high / (t_full * hi_bins)) / (
                tot / (t_full * n_mels) + 1e-6)             # (b,)
            if not use_guitar_filters:
                dist = jnp.zeros_like(dist)  # matches analyze_financial_program

            idx = jax.lax.axis_index(time_axis)

            def _loc(x):  # local slice of a full-track row, tile-major
                return jax.lax.dynamic_slice_in_dim(
                    x, idx * L, L, axis=1).reshape(b * k_local, tile)

            out["trend"] = _loc(fin["trend"])
            out["artic_codes"] = _loc(fin["articulations"])
            out["slide_codes"] = _loc(fin["slides"])
            out["financial_confidence"] = _loc(fin["confidence"])
            out["combined_confidence"] = _loc(combined)
            out["adaptive_threshold"] = jnp.broadcast_to(
                jnp.repeat(thr, k_local)[:, None], (b * k_local, tile))
            out["distortion_score"] = jnp.broadcast_to(
                jnp.repeat(dist, k_local)[:, None], (b * k_local, tile))

        # ONE packed output buffer (same trick as core.analyze._pack): one
        # device->host transfer instead of one per array.  Every row is (b*k_local, tile) per-frame here, incl. the
        # distortion partial sums.
        rows = (_FIN_ROWS if financial
                else _GTR_ROWS if guitar_only else _V1_ROWS)
        cols = [out[k_].astype(jnp.float32)[..., None] for k_ in rows]
        head = [out["mel_db"]] if include_mel else []
        packed = jnp.concatenate(head + cols, axis=-1)
        return packed.reshape((b, k_local) + packed.shape[1:])

    from jax import shard_map

    # block-scale planes shard with the audio; scalar scales replicate
    scale_spec = (P(data_axis, time_axis) if getattr(scale, "ndim", 1) == 2
                  else P(data_axis))
    args = (y16, scale, rake_sens,
            edge16 if has_edge
            else jnp.zeros((y16.shape[0], 2 * ctx), jnp.int16),
            db_ref if has_ref else jnp.zeros((y16.shape[0],), jnp.float32),
            edge_scale if edge_scale is not None
            else jnp.zeros((y16.shape[0],), jnp.float32))
    in_specs = (P(data_axis, time_axis), scale_spec, P(),
                P(data_axis), P(data_axis), P(data_axis))

    if peak_only:
        return shard_map(
            worker, mesh=mesh, in_specs=in_specs,
            out_specs=P(data_axis),
            check_vma=False,
        )(*args)

    return shard_map(
        worker,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(data_axis, time_axis),
        check_vma=False,
    )(*args)


def quantize_tracks(ys: np.ndarray, n_samples: int) -> tuple:
    """(B, *) float tracks -> zero-padded (B, n_samples) int16 + (B,) scales.

    The scale is PER TRACK: with one batch-global peak a track 40 dB quieter
    than the loudest would be quantized with only ~56 dB SNR (and its f0
    confidence measurably degraded); per-track scaling gives every track the
    full 90 dB int16 range regardless of batch company."""
    out = np.zeros((len(ys), n_samples), np.int16)
    scales = np.ones(len(ys), np.float32)
    for i, y in enumerate(ys):
        n = min(len(y), n_samples)
        peak = float(np.max(np.abs(np.asarray(y[:n])))) if n else 0.0
        if peak > 0:
            scales[i] = peak / 32767.0
            out[i, :n] = np.round(np.asarray(y[:n], np.float64)
                                  / scales[i]).astype(np.int16)
    return out, scales


def _default_mesh(time_only: bool = True) -> Mesh:
    devs = np.array(jax.devices())
    if time_only:
        return Mesh(devs.reshape(1, -1), ("data", "time"))
    return Mesh(devs.reshape(-1, 1), ("data", "time"))


def run_analyze_turbo(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    turbo: Optional[TurboConfig] = None,
    mesh: Optional[Mesh] = None,
    transport: str = "int16",
    fetch_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
) -> Dict[str, np.ndarray]:
    """Single-track turbo analyze: tile over the time axis of the mesh and
    stitch the interiors back together.  Output schema matches
    core.analyze.run_analyze (incl. the int16 PCM transport; pass
    transport="float32" for bit-exact ingest).  financial=True runs the
    sharded v2 pipeline and returns the _FIN_ROWS schema."""
    turbo = turbo or TurboConfig()
    mesh = mesh or _default_mesh(time_only=True)
    n_time = mesh.shape["time"]

    tile = turbo.tile_frames
    true_frames = audio.n_frames(len(y))
    n_tiles = max(1, -(-true_frames // tile))
    n_tiles = -(-n_tiles // n_time) * n_time
    n_samp = n_tiles * tile * audio.hop_length
    if transport not in ("int16", "float32"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(sharded tile paths: int16 | float32)")
    if transport == "int16":
        y_dev, scale = quantize_tracks(np.asarray(y, np.float32)[None], n_samp)
    else:
        y_dev = np.zeros((1, n_samp), np.float32)
        y_dev[0, : len(y)] = np.asarray(y, np.float32)
        scale = np.ones(1, np.float32)
    packed = analyze_audio_sharded(
        jnp.asarray(y_dev), jnp.asarray(scale), jnp.float32(rake_sensitivity),
        audio, pyin_cfg, turbo, mesh, n_tiles, include_mel=fetch_mel,
        financial=financial, use_guitar_filters=use_guitar_filters,
    )
    buf = np.array(packed)[0]  # np.array: writable (onset fix below)
    buf = buf.reshape(-1, buf.shape[-1])[:true_frames]
    rows = _FIN_ROWS if financial else _V1_ROWS
    result = _unpack(buf, rows, audio.n_mels if fetch_mel else 0)
    # first tile's left halo is synthetic silence; match the single-device
    # convention onset_env[0] == 0
    result["onset_env"][0] = 0.0
    return result


def run_analyze_batch(
    ys: np.ndarray,  # (B, n_samples) equal-length tracks
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    turbo: Optional[TurboConfig] = None,
    mesh: Optional[Mesh] = None,
    fetch_mel: bool = True,
    transport: str = "int16",
    financial: bool = False,
    use_guitar_filters: bool = True,
) -> Dict[str, np.ndarray]:
    """Batched multi-track analyze sharded over (data, time).

    transport="float32" skips int16 quantization for bit-exact ingest at
    twice the upload bytes; financial=True runs the sharded v2 pipeline."""
    turbo = turbo or TurboConfig()
    if mesh is None:
        devs = np.array(jax.devices())
        b_axis = int(np.gcd(len(devs), len(ys)))
        mesh = Mesh(devs.reshape(b_axis, -1), ("data", "time"))
    n_time = mesh.shape["time"]

    tile = turbo.tile_frames
    true_frames = audio.n_frames(ys.shape[1])
    n_tiles = max(1, -(-true_frames // tile))
    n_tiles = -(-n_tiles // n_time) * n_time
    n_samp = n_tiles * tile * audio.hop_length
    if transport not in ("int16", "float32"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(sharded tile paths: int16 | float32)")
    if transport == "int16":
        y_dev, scale = quantize_tracks(np.asarray(ys, np.float32), n_samp)
    else:
        y_dev = np.zeros((len(ys), n_samp), np.float32)
        y_dev[:, : ys.shape[1]] = np.asarray(ys, np.float32)
        scale = np.ones(len(ys), np.float32)
    packed = analyze_audio_sharded(
        jnp.asarray(y_dev), jnp.asarray(scale), jnp.float32(rake_sensitivity),
        audio, pyin_cfg, turbo, mesh, n_tiles, include_mel=fetch_mel,
        financial=financial, use_guitar_filters=use_guitar_filters,
    )
    buf = np.array(packed)  # np.array: writable (onset fix below)
    buf = buf.reshape(buf.shape[0], -1, buf.shape[-1])[:, :true_frames]
    rows = _FIN_ROWS if financial else _V1_ROWS
    result = _unpack(buf, rows, audio.n_mels if fetch_mel else 0)
    result["onset_env"][:, 0] = 0.0  # synthetic first-tile halo
    return result


# --------------------------------------------------------------------------
# Sharded polyphonic program (CQT salience peeling over the mesh)
# --------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("sr", "n_fft", "hop", "n_mels", "n_bins",
                     "bins_per_octave", "max_voices", "mesh", "n_tiles",
                     "tile", "halo", "data_axis", "time_axis"),
)
def analyze_poly_sharded(
    y16: jnp.ndarray,    # (B, n_tiles*tile*hop) int16 PCM, time-sharded
    scale: jnp.ndarray,  # (B,) dequant scales
    edge16: jnp.ndarray,  # (B, 2*ctx) int16 track-edge context: the host's
                          # reflect padding on the left (STFT pad_mode), zeros
                          # on the right (past the padded tail)
    sr: int, n_fft: int, hop: int, n_mels: int, n_bins: int,
    bins_per_octave: int, max_voices: int,
    mesh: Mesh, n_tiles: int, tile: int, halo: int,
    data_axis: str = "data", time_axis: str = "time",
) -> jnp.ndarray:
    """The polyphonic Perception Phase (core.poly.analyze_poly_program)
    sharded over a (data, time) mesh with on-device halo exchange.

    Per-frame work (CQT projection, harmonic peeling, RMS, onset flux) is
    local to a haloed tile; the only cross-tile state is one per-track
    scalar — the mel-power dB reference (onset envelope) — a ``pmax``
    over the time axis.  Returns ONE packed
    (B, n_tiles, tile, 2*max_voices + 2 + ceil(n_bins/2)) buffer of RAW
    VOICES plus the f16-packed raw CQT magnitude plane (the host
    octave-recovery input, core.poly.pack_cqt_f16):
    [bins(V) | saliences(V) | rms | onset_env | cqt] — the host reconstructs
    the roll/confidence/salience planes through the NumPy oracle with the
    track-global acceptance peak (max over the shipped saliences), so no
    salience pmax is needed on device and the transport shrinks 18x
    (core.poly.analyze_poly_program_packed docstring).
    """
    from aegis_tpu.core.cqt import onset_from_db
    from aegis_tpu.core.filters import cqt_filterbank
    from aegis_tpu.core.poly import (harmonic_subtraction_matrix,
                                     harmonic_suppression_matrix,
                                     peel_voices)

    span = _slab_span(tile, halo, hop, n_fft)
    ctx = halo * hop + n_fft // 2
    n_time = mesh.shape[time_axis]
    k_local = n_tiles // n_time
    if ctx > k_local * tile * hop:
        raise ValueError(
            f"halo context ({ctx} samples) exceeds a device's local block "
            f"({k_local * tile * hop} samples); increase tile_frames or "
            f"reduce halo_frames/mesh time-axis size.")
    t2 = tile + 2 * halo

    window = jnp.asarray(hann_window(n_fft))
    cos_m, sin_m = dft_matrices(n_fft)
    cqt_fb = jnp.asarray(cqt_filterbank(sr, n_fft, n_bins, bins_per_octave).T)
    mel_fb = jnp.asarray(mel_filterbank(sr, n_fft, n_mels).T)
    supp = jnp.asarray(harmonic_suppression_matrix(n_bins, bins_per_octave))
    subm = jnp.asarray(harmonic_subtraction_matrix(n_bins, bins_per_octave))

    def worker(y_loc, sc, edge):
        b, _ = y_loc.shape
        y_f = y_loc.astype(jnp.float32) * sc[:, None]

        fwd = [(i, i + 1) for i in range(n_time - 1)]
        bwd = [(i + 1, i) for i in range(n_time - 1)]
        left = jax.lax.ppermute(y_f[:, -ctx:], time_axis, fwd)
        right = jax.lax.ppermute(y_f[:, :ctx], time_axis, bwd)
        idx_t = jax.lax.axis_index(time_axis)
        zero = jnp.zeros_like(left)
        # STFT frames reflect-pad at the track edges (dsp.frame_signal);
        # RMS frames zero-pad (dsp.rms) — splice each convention separately
        e_l = edge[:, :ctx].astype(jnp.float32) * sc[:, None]
        e_r = edge[:, ctx:].astype(jnp.float32) * sc[:, None]
        y_s = jnp.concatenate([jnp.where(idx_t == 0, e_l, left), y_f,
                               jnp.where(idx_t == n_time - 1, e_r, right)],
                              axis=1)
        y_z = jnp.concatenate([jnp.where(idx_t == 0, zero, left), y_f,
                               jnp.where(idx_t == n_time - 1, zero, right)],
                              axis=1)

        def slabs(yx):
            s = jnp.stack([yx[:, j * tile * hop: j * tile * hop + span]
                           for j in range(k_local)], axis=1)
            return s.reshape(b * k_local, span)

        def tilefn(slab_s, slab_z):
            fr = _frame_slab(slab_s, t2, hop, n_fft, 0) * window[None, :]
            re = jnp.dot(fr, cos_m, preferred_element_type=jnp.float32)
            im = jnp.dot(fr, sin_m, preferred_element_type=jnp.float32)
            power = re * re + im * im
            cqt_p = jnp.dot(power, cqt_fb,
                            preferred_element_type=jnp.float32)
            mel_p = jnp.dot(power, mel_fb,
                            preferred_element_type=jnp.float32)
            frz = _frame_slab(slab_z, t2, hop, n_fft, 0)
            rms_ = jnp.sqrt(jnp.mean(frz * frz, axis=-1))
            bins_v, sals_v = peel_voices(cqt_p, supp, subm, max_voices)
            return bins_v, sals_v, mel_p, rms_, \
                jnp.sqrt(jnp.maximum(cqt_p, 0.0))

        bins_v, sals_v, mel_p, rms_, cqtm = jax.vmap(tilefn)(slabs(y_s),
                                                             slabs(y_z))
        sl = slice(halo, halo + tile)

        # per-track global scalar over the time axis only (NOT data);
        # vmapped outputs are (b*k_local, t2, ...)
        mel_glob = jax.lax.pmax(
            jnp.max(mel_p[:, sl].reshape(b, -1), axis=1), time_axis)

        # onset envelope: dB with the track-global ref, lag-1 flux on the
        # haloed tile so seams are exact (halo >= 1 frame)
        amin = 1e-10
        ref_db = 10.0 * jnp.log10(jnp.maximum(amin, jnp.repeat(mel_glob,
                                                               k_local)))
        mel_db = (10.0 * jnp.log10(jnp.maximum(amin, mel_p))
                  - ref_db[:, None, None])
        mel_db = jnp.maximum(mel_db, -80.0)
        onset = jax.vmap(onset_from_db)(
            mel_db.reshape(b * k_local, t2, n_mels))[:, sl]

        from aegis_tpu.core.poly import cqt_plane_cols, pack_cqt_f16

        packed = jnp.concatenate(
            [bins_v.reshape(b * k_local, t2, -1)[:, sl].astype(jnp.float32),
             sals_v.reshape(b * k_local, t2, -1)[:, sl].astype(jnp.float32),
             rms_.reshape(b * k_local, t2)[:, sl, None],
             onset[..., None],
             pack_cqt_f16(cqtm.reshape(b * k_local, t2, -1)[:, sl])],
            axis=-1)
        assert packed.shape[-1] == 2 * max_voices + 2 + cqt_plane_cols(n_bins)
        return packed.reshape((b, k_local) + packed.shape[1:])

    from jax import shard_map

    return shard_map(
        worker, mesh=mesh,
        in_specs=(P(data_axis, time_axis), P(data_axis), P(data_axis)),
        out_specs=P(data_axis, time_axis),
        check_vma=False,
    )(y16, scale, edge16)


def run_analyze_poly_turbo(
    ys: np.ndarray,  # (n_samples,) one track or (B, n_samples) equal-length
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    max_voices: int = 6,
    n_mels: int = 128,
    turbo: Optional[TurboConfig] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Sharded polyphonic analyze: tile over the mesh time axis (and tracks
    over the data axis) and stitch tile interiors.  Output schema matches
    AegisPolyEngine.analyze: {roll, confidence, salience, rms, onset_env},
    batched
    along axis 0 when ``ys`` is 2-D."""
    from aegis_tpu.core.poly import unpack_poly_voices

    single = ys.ndim == 1
    ys2 = np.asarray(ys, np.float32)[None] if single else np.asarray(
        ys, np.float32)
    turbo = turbo or TurboConfig()
    if mesh is None:
        if single:
            mesh = _default_mesh(time_only=True)
        else:
            devs = np.array(jax.devices())
            b_axis = int(np.gcd(len(devs), len(ys2)))
            mesh = Mesh(devs.reshape(b_axis, -1), ("data", "time"))
    n_time = mesh.shape["time"]

    tile, halo = turbo.tile_frames, turbo.halo_frames
    ctx = halo * hop_length + n_fft // 2
    true_frames = 1 + ys2.shape[1] // hop_length
    n_tiles = max(1, -(-true_frames // tile))
    n_tiles = -(-n_tiles // n_time) * n_time
    n_samp = n_tiles * tile * hop_length

    y16, scale = quantize_tracks(ys2, n_samp)
    # left context = the track's reflect padding (same int16 samples, so the
    # dequantized slab equals frame_signal's reflect pad exactly); shared
    # helper with the live poly transcriber (core.analyze.reflect_head)
    from aegis_tpu.core.analyze import reflect_head

    edge = np.zeros((len(ys2), 2 * ctx), np.int16)
    edge[:, :ctx] = reflect_head(y16, ctx, n_fft // 2,
                                 true_len=ys2.shape[1])

    packed = analyze_poly_sharded(
        jnp.asarray(y16), jnp.asarray(scale), jnp.asarray(edge),
        sr, n_fft, hop_length, n_mels, n_bins, bins_per_octave, max_voices,
        mesh, n_tiles, tile, halo)
    buf = np.array(packed)
    buf = buf.reshape(buf.shape[0], -1, buf.shape[-1])[:, :true_frames]
    # per-track plane reconstruction through the oracle; the acceptance
    # peak is per-track (max over that track's shipped saliences), matching
    # the fused single-track program exactly
    tracks = [unpack_poly_voices(buf[i], max_voices, bins_per_octave)
              for i in range(buf.shape[0])]
    out = {k: np.stack([t[k] for t in tracks]) for k in tracks[0]}
    out["onset_env"][:, 0] = 0.0  # first-frame convention (lag pad)
    if single:
        out = {k: v[0] for k, v in out.items()}
    return out


# --------------------------------------------------------------------------
# Streamed long-track mode (bounded device/host memory)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("hi_bins", "n_mels"))
def _trend_full_program(f0_clean, probs, high_sum, total_sum, n_frames_f,
                        hi_bins: int, n_mels: int):
    """Whole-track financial trend rows over the streamed f0 — ONE tiny
    device pass (O(T) scalar rows; the heavy per-sample work already ran
    slab by slab)."""
    from aegis_tpu.core import trend

    fin = trend.analyze_pitch_financial(f0_clean)
    combined = probs * 0.5 + fin["confidence"] * 0.5
    thr = trend.adaptive_confidence_threshold(combined)
    dist = (high_sum / (n_frames_f * hi_bins)) / (
        total_sum / (n_frames_f * n_mels) + 1e-6)
    return {
        "trend": fin["trend"],
        "artic_codes": fin["articulations"],
        "slide_codes": fin["slides"],
        "financial_confidence": fin["confidence"],
        "combined_confidence": combined,
        "adaptive_threshold": thr,
        "distortion_score": dist,
    }


def run_analyze_streamed(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    turbo: Optional[TurboConfig] = None,
    mesh: Optional[Mesh] = None,
    slab_tiles: Optional[int] = None,
    financial: bool = False,
    use_guitar_filters: bool = True,
    fetch_mel: bool = False,
    fetch_group: int = 8,
    transport: str = "int8",
) -> Dict[str, np.ndarray]:
    """Bounded-memory turbo analyze for multi-minute tracks (VERDICT r1 #7).

    The track is processed in fixed slabs of ``slab_tiles`` tiles through
    the same sharded program as run_analyze_turbo; device memory is bounded
    by the slab size regardless of duration, and host accumulates only the
    per-frame output rows (~40 B/frame with fetch_mel=False — the mel
    spectrogram grows with duration, so leave it off for long tracks).

    Exactness vs run_analyze_turbo:
      * slab edges splice REAL neighboring audio via ``edge16`` (no
        synthetic-zero seams), so every tile computes on the same haloed
        window as the unstreamed program;
      * the track-global dB reference (power_to_db ref=max) is found in a
        cheap pass-1 over the mel power only (~15% of the full program's
        FLOPs), then passed as ``db_ref`` so rake/palm-mute thresholds are
        identical in every slab;
      * for financial=True, the per-tile guitar filters stream with the
        slabs and the whole-track trend recurrences run afterwards in one
        tiny full-track device pass over the assembled f0 row (identical
        code path as the sharded worker's replicated trend stack).

    The reference handles long tracks by hard caps / manual region slicing
    (aegis_app.py:274-281) — this does it losslessly.

    ``fetch_group``: pass-2 slab outputs are fetched in groups of this
    many through one device-side concat each — one device->host transfer
    per group instead of per slab (pass 1 dispatches every slab at once; the
    queued programs hold only already-resident input refs, so memory
    stays slab-bounded either way).

    ``transport``: "int8" (default) ships the slabs as block-float int8 —
    half the upload bytes of int16 — and the dequantized samples are bit-identical to the fused int8
    path's (same PCM8_BLOCK grid from sample 0).  Slab edges stay int16
    with the per-track scale (their length need not divide the block).
    "int16" preserves the bit-exact-vs-run_analyze_turbo contract the
    seam tests pin.  Falls back to int16 when the slab length is not a
    block multiple (tile*hop < 1024 configurations).
    """
    turbo = turbo or TurboConfig()
    mesh = mesh or _default_mesh(time_only=True)
    n_time = mesh.shape["time"]
    tile, halo = turbo.tile_frames, turbo.halo_frames
    hop, fl = audio.hop_length, pyin_cfg.frame_length
    ctx = halo * hop + fl // 2

    true_frames = audio.n_frames(len(y))
    n_tiles_total = max(1, -(-true_frames // tile))

    # default slab size: 16 tiles per time-axis device (fewer slabs mean
    # fewer round trips; the best size on the GPU is not measured yet).
    # Memory stays bounded by the fixed slab size regardless of duration
    # (~17 MB of int16 audio per 16-tile slab at 22.05 kHz).
    slab_tiles = slab_tiles or 16 * n_time
    slab_tiles = -(-slab_tiles // n_time) * n_time
    # never pad a short track past its own tile count (rounded to the mesh)
    slab_tiles = min(slab_tiles, -(-n_tiles_total // n_time) * n_time)
    slab_samp = slab_tiles * tile * hop

    n_slabs = max(1, -(-n_tiles_total // slab_tiles))
    n_samp = n_slabs * slab_samp

    if transport == "int8" and slab_samp % PCM8_BLOCK == 0:
        from aegis_tpu.core.analyze import quantize_pcm8

        y_pad = np.zeros(n_samp, np.float32)
        y_pad[: len(y)] = np.asarray(y, np.float32)
        q8, bscales = quantize_pcm8(y_pad)
        q8, bscales = q8[None], bscales[None]
        nblk = slab_samp // PCM8_BLOCK
        peak = float(np.max(np.abs(y_pad)))
        esc = np.float32(peak / 32767.0 if peak > 0 else 0.0)
        y16 = (np.round(y_pad * (32767.0 / peak)).astype(np.int16)[None]
               if peak > 0 else np.zeros((1, n_samp), np.int16))
        slabs_np = [q8[:, s * slab_samp: (s + 1) * slab_samp]
                    for s in range(n_slabs)]
        scales_np = [bscales[:, s * nblk: (s + 1) * nblk]
                     for s in range(n_slabs)]
        edge_scale_j = jnp.asarray(np.array([esc], np.float32))
    else:
        y16, scale = quantize_tracks(np.asarray(y, np.float32)[None], n_samp)
        slabs_np = [y16[:, s * slab_samp: (s + 1) * slab_samp]
                    for s in range(n_slabs)]
        scales_np = [scale] * n_slabs
        edge_scale_j = None
    rs = jnp.float32(rake_sensitivity)

    def _edge_np(s: int) -> np.ndarray:
        lo, hi = s * slab_samp, (s + 1) * slab_samp
        left = y16[:, max(lo - ctx, 0): lo]
        if left.shape[1] < ctx:
            left = np.pad(left, ((0, 0), (ctx - left.shape[1], 0)))
        right = y16[:, hi: hi + ctx]
        if right.shape[1] < ctx:
            right = np.pad(right, ((0, 0), (0, ctx - right.shape[1])))
        return np.concatenate([left, right], axis=1)

    # upload each slab ONCE and reuse the device buffer in both passes
    # (int8 transport halves the upload).  Device residency is the
    # quantized input only; the big per-frame buffers stay slab-bounded.
    slabs_dev = [jnp.asarray(a) for a in slabs_np]
    scales_dev = [jnp.asarray(a) for a in scales_np]
    edges_dev = [jnp.asarray(_edge_np(s)) for s in range(n_slabs)]

    # pass 1: track-global mel-power reference.  The per-slab peaks are
    # reduced ON DEVICE (jnp.max over the stacked handles) and the result
    # stays device-resident as pass 2's db_ref input — the old loop
    # fetched one scalar per slab and re-uploaded the max, paying one
    # round trip per slab.  Queued programs hold only their
    # (already-resident) input refs and scalar outputs, so memory stays
    # slab-bounded with every slab in flight.
    peaks = [analyze_audio_sharded(
        slabs_dev[s], scales_dev[s], rs, audio, pyin_cfg, turbo, mesh,
        slab_tiles, peak_only=True, edge16=edges_dev[s],
        edge_scale=edge_scale_j)
        for s in range(n_slabs)]
    gmax_j = jnp.max(jnp.concatenate(peaks)).reshape(1)

    # pass 2: the full analyze per slab, dispatch-ahead pipelined.  The
    # per-frame output rows are tiny (~40 B/frame), so slab outputs are
    # fetched in GROUPS through one device-side concat each — one
    # round trip per ``fetch_group`` slabs instead of per slab — while
    # the big activations stay per-program (freed as each slab's program
    # retires); bounded memory is unchanged.
    rows = _GTR_ROWS if financial else _V1_ROWS
    n_mels = audio.n_mels if fetch_mel else 0
    fetch_group = max(1, fetch_group)
    outs, pending = [], []

    def fetch_batch(hs) -> np.ndarray:
        buf = np.asarray(hs[0] if len(hs) == 1
                         else jnp.concatenate(hs, axis=1))[0]
        return buf.reshape(-1, buf.shape[-1])

    for s in range(n_slabs):
        pending.append(analyze_audio_sharded(
            slabs_dev[s], scales_dev[s], rs, audio, pyin_cfg, turbo, mesh,
            slab_tiles, include_mel=fetch_mel, guitar_only=financial,
            use_guitar_filters=use_guitar_filters,
            edge16=edges_dev[s], db_ref=gmax_j, edge_scale=edge_scale_j))
        if len(pending) >= fetch_group:
            outs.append(fetch_batch(pending))
            pending = []
    if pending:
        outs.append(fetch_batch(pending))
    buf = np.concatenate(outs, axis=0)  # (n_slabs*slab_frames, C)
    del outs

    high_sum = total_sum = 0.0
    if financial:
        # the last two columns carry PER-FRAME distortion partial sums,
        # summed over the full padded window — the same CONVENTION as the
        # single-device program and the CPU oracle (all compute the
        # informational distortion scalar over their padded mel).  The
        # padding LENGTH differs per mode (bucket vs tile vs slab multiple),
        # so the scalar can differ in its low digits between modes; it feeds
        # only the coarse clean/light/heavy classification
        sums = buf[:, n_mels + len(rows) - 2:]
        high_sum, total_sum = sums.sum(axis=0)
        buf = buf[:, : n_mels + len(rows) - 2]
        rows = rows[:-2]

    full = _unpack(buf, rows, n_mels)
    t_pad = buf.shape[0]

    result = {k: (v[:true_frames] if getattr(v, "ndim", 0) else v)
              for k, v in full.items()}
    result["onset_env"][0] = 0.0  # synthetic first-tile halo convention

    if financial:
        from aegis_tpu.core.analyze import _INT_ROWS

        f0c = np.where(full["voiced_flag"], full["f0"], np.nan).astype(np.float32)
        probs = np.asarray(full["voiced_probs"], np.float32)
        n_mels_a = audio.n_mels
        hi_bins = n_mels_a - int(n_mels_a * 0.7)
        if not use_guitar_filters:
            high_sum = total_sum = 0.0  # distortion_score -> 0, matching
            # analyze_financial_program's use_guitar_filters=False branch
        fin = _trend_full_program(
            jnp.asarray(f0c), jnp.asarray(probs),
            jnp.float32(high_sum), jnp.float32(total_sum),
            jnp.float32(t_pad), hi_bins, n_mels_a)
        for k, v in fin.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                result[k] = np.float32(arr)
            elif k in _INT_ROWS:
                result[k] = arr[:true_frames].astype(_INT_ROWS[k])
            else:
                result[k] = arr[:true_frames]
    return result
