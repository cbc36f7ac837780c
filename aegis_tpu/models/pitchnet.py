"""PitchNet — a learned monophonic pitch tracker as an alternative backend.

A small spectrum-input MLP (SwiftF0/CREPE-tiny family, PAPERS.md) mapping a
2048-sample window's normalized log-magnitude spectrum to a 192-bin pitch
salience distribution (25-cent bins from one semitone below E2) plus a
voicing logit.  Everything is matmul-shaped: featurization is one matmul-DFT,
the trunk is dense layers, inference over a whole track is a single fused
XLA program (frames -> features -> net -> f0 decode, packed output buffer).

Design rationale vs the reference: the reference's only pitch tracker is
librosa.pyin (aegis_engine_core/worker.py:9-15).  pYIN's cost is the
O(frame_len x max_lag) CMNDF plus a sequential Viterbi scan; PitchNet
replaces both with two dense matmuls per frame — no recurrence at all —
which makes it the fastest analyze path and a second, independent opinion
on pitch for verification work.

The engines expose it as ``audio_to_midi(..., pitch_backend="neural")``;
the default remains pYIN (the F1-gated parity path).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Tuple

import jax
import numpy as np

from aegis_tpu.config import NOTE_E2_HZ

SR_NATIVE = 22050  # the net is trained at this rate; other rates resample
WIN = 2048
N_RFFT = WIN // 2 + 1
FMIN_HZ = float(NOTE_E2_HZ * 2.0 ** (-1.0 / 12.0))  # one semitone below E2
CENTS_PER_BIN = 25.0
N_BINS = 192  # covers FMIN .. FMIN * 2^(191*25/1200) ~ 1226 Hz (above C6)
HIDDEN = (512, 256)

_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights",
                                "pitchnet_v1.npz")


# --------------------------------------------------------------------- model


def init_params(seed: int = 0, hidden: Tuple[int, ...] = HIDDEN):
    """Fresh parameters: ``Dense_k/{kernel,bias}`` for the hidden layers, then
    the pitch head and the voicing head; LeCun-normal kernels, zero biases."""
    import jax.numpy as jnp

    ins = (N_RFFT, *hidden, hidden[-1])
    outs = (*hidden, N_BINS, 1)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(outs))
    init = jax.nn.initializers.lecun_normal()
    return {f"Dense_{k}": {"kernel": init(key, (i, o), jnp.float32),
                           "bias": jnp.zeros((o,), jnp.float32)}
            for k, (key, i, o) in enumerate(zip(keys, ins, outs))}


def apply_model(params, feats, hidden: Tuple[int, ...] = HIDDEN):
    """(B, N_RFFT) features -> ((B, N_BINS) pitch logits, (B,) voicing logit)."""
    def dense(k, x):
        return x @ params[f"Dense_{k}"]["kernel"] + params[f"Dense_{k}"]["bias"]

    x = feats
    for k in range(len(hidden)):
        x = jax.nn.relu(dense(k, x))
    return dense(len(hidden), x), dense(len(hidden) + 1, x)[..., 0]


def featurize(windows):
    """(B, WIN) f32 audio windows -> (B, N_RFFT) standardized log-magnitude.

    Per-window standardization makes the features gain-invariant, so deep
    into a note's decay the spectrum still looks like the attack's — the
    voicing head learns tone-vs-noise shape, not level."""
    import jax.numpy as jnp

    from aegis_tpu.core.filters import dft_matrices, hann_window

    cos, sin = dft_matrices(WIN)  # the spectrum as one matmul-DFT
    w = windows * jnp.asarray(hann_window(WIN))[None, :]
    power = (w @ jnp.asarray(cos)) ** 2 + (w @ jnp.asarray(sin)) ** 2
    logm = 0.5 * jnp.log1p(power)
    mu = logm.mean(axis=-1, keepdims=True)
    sd = logm.std(axis=-1, keepdims=True)
    return (logm - mu) / (sd + 1e-5)


def bin_centers_cents() -> np.ndarray:
    return (np.arange(N_BINS) * CENTS_PER_BIN).astype(np.float32)


def decode_f0(pitch_logits, voiced_logit):
    """Logits -> (f0_hz, voiced_prob): local expectation over the 9 bins
    around the argmax (CREPE's decoding), giving sub-bin cents precision."""
    import jax
    import jax.numpy as jnp

    p = jax.nn.softmax(pitch_logits, axis=-1)  # (B, N_BINS)
    centers = jnp.asarray(bin_centers_cents())
    best = jnp.argmax(p, axis=-1)  # (B,)
    offs = jnp.arange(-4, 5)
    idx = jnp.clip(best[:, None] + offs[None, :], 0, N_BINS - 1)
    pw = jnp.take_along_axis(p, idx, axis=-1)
    cw = centers[idx]
    cents = (pw * cw).sum(-1) / (pw.sum(-1) + 1e-9)
    f0 = FMIN_HZ * jnp.exp2(cents / 1200.0)
    return f0, jax.nn.sigmoid(voiced_logit)


# ---------------------------------------------------------------- training


def pitch_target(f0_hz, voiced):
    """Gaussian-blurred one-hot over the cents grid (sigma ~30 cents);
    uniform for unvoiced frames (they carry no pitch loss anyway)."""
    import jax.numpy as jnp

    cents = 1200.0 * jnp.log2(jnp.maximum(f0_hz, 1e-3) / FMIN_HZ)
    centers = jnp.asarray(bin_centers_cents())
    d = (centers[None, :] - cents[:, None]) / (1.2 * CENTS_PER_BIN)
    g = jnp.exp(-0.5 * d * d)
    g = g / (g.sum(-1, keepdims=True) + 1e-9)
    uni = jnp.full((1, N_BINS), 1.0 / N_BINS)
    return jnp.where(voiced[:, None], g, uni)


def loss_fn(params, windows, f0_hz, voiced, hidden: Tuple[int, ...] = HIDDEN,
            label_w=None):
    """``label_w`` (B,) f32 in [0, 1] down-weights ambiguous frames (decay
    boundaries, reverb tails — models/data.py builds it); None = all 1."""
    import jax.numpy as jnp
    import optax

    logits, vlogit = apply_model(params, featurize(windows), hidden)
    target = pitch_target(f0_hz, voiced)
    ce = optax.softmax_cross_entropy(logits, target)  # (B,)
    vmask = voiced.astype(jnp.float32)
    w = jnp.ones_like(vmask) if label_w is None else label_w
    pw = vmask * w
    pitch_loss = (ce * pw).sum() / (pw.sum() + 1e-6)
    vce = optax.sigmoid_binary_cross_entropy(vlogit, vmask)
    voiced_loss = (vce * w).sum() / (w.sum() + 1e-6)
    return pitch_loss + voiced_loss


def sample_windows(rng, tracks16, scale, f0_hz, voiced, batch: int,
                   label_w=None):
    """Device-side batch sampler: random (clip, offset) crops gathered from
    the resident int16 clip bank; labels (and per-block loss weights, when
    given) read at the window center."""
    import jax
    import jax.numpy as jnp

    n, L = tracks16.shape
    r1, r2, r3, r4 = jax.random.split(rng, 4)
    ci = jax.random.randint(r1, (batch,), 0, n)
    # 35% of windows drawn from the attack region (window centers within
    # ~46-139 ms of the pluck): onset frames (half window silence + pluck +
    # early ringing) are the hardest voicing decisions and only ~2% of
    # uniformly-sampled offsets — undersampling them cost ~100 ms of onset
    # lag on real plucks
    off_uni = jax.random.randint(r2, (batch,), 0, L - WIN + 1)
    off_atk = jax.random.randint(r3, (batch,), 0, min(WIN, L - WIN + 1))
    off = jnp.where(jax.random.uniform(r4, (batch,)) < 0.35, off_atk,
                    off_uni)

    def crop(i, o):
        row = jax.lax.dynamic_slice(tracks16, (i, o), (1, WIN))[0]
        return row.astype(jnp.float32)

    from aegis_tpu.models.data import LABEL_HOP

    wins = jax.vmap(crop)(ci, off) * scale[ci][:, None]
    lab = jnp.clip((off + WIN // 2) // LABEL_HOP, 0, f0_hz.shape[1] - 1)
    w = None if label_w is None else label_w[ci, lab]
    return wins, f0_hz[ci, lab], voiced[ci, lab], w


def make_train_step(mesh=None, batch: int = 256,
                    hidden: Tuple[int, ...] = HIDDEN, lr=3e-4):
    """Build the jitted training step:
    (params, opt_state, base_rng, step_idx, bank...) -> (params, opt_state,
    loss).  The per-step RNG is folded INSIDE the program (one dispatch per
    step — host-side key splitting would double the dispatch count).  With a mesh, the sampled window batch is sharded over every
    mesh axis (pure data parallelism; params stay replicated and XLA
    inserts the gradient psum)."""
    import optax

    def step(params, opt_state, base_rng, step_idx, tracks16, scale,
             f0_hz, voiced, label_w=None):
        rng = jax.random.fold_in(base_rng, step_idx)
        wins, f0b, vb, wb = sample_windows(rng, tracks16, scale, f0_hz,
                                           voiced, batch, label_w)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            dp = PartitionSpec(mesh.axis_names)
            wins = jax.lax.with_sharding_constraint(
                wins, NamedSharding(mesh, PartitionSpec(mesh.axis_names,
                                                        None)))
            f0b = jax.lax.with_sharding_constraint(
                f0b, NamedSharding(mesh, dp))
            vb = jax.lax.with_sharding_constraint(vb, NamedSharding(mesh, dp))
            if wb is not None:
                wb = jax.lax.with_sharding_constraint(
                    wb, NamedSharding(mesh, dp))
        loss, grads = jax.value_and_grad(loss_fn)(params, wins, f0b, vb,
                                                  hidden, wb)
        updates, opt_state = _optimizer(lr).update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step, donate_argnums=(0, 1))


def _optimizer(lr=3e-4):
    """lr: float or optax schedule.  A schedule adds a count to the
    opt_state, so init_train_state must be built with the SAME lr."""
    import optax

    return optax.adamw(lr, weight_decay=1e-5)


def init_train_state(seed: int = 0, hidden: Tuple[int, ...] = HIDDEN,
                     lr=3e-4):
    params = init_params(seed, hidden)
    return params, _optimizer(lr).init(params)


# ------------------------------------------------------------- checkpoints


# Bump whenever featurize()/decode semantics change: a checkpoint trained
# against different features silently mistracks, so load_params refuses
# mismatched versions instead.
FEATURE_VERSION = 1


def save_params(params, path: str, metrics: Optional[Dict] = None) -> str:
    """f16 npz checkpoint with a __meta__ JSON record (feature version,
    architecture, bin grid, and any training metrics provided).  Returns
    the path actually written (np.savez appends .npz to bare names)."""
    import json

    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v).astype(np.float16)

    walk(params)
    meta = {"feature_version": FEATURE_VERSION, "win": WIN,
            "sr_native": SR_NATIVE, "n_bins": N_BINS,
            "cents_per_bin": CENTS_PER_BIN, "fmin_hz": FMIN_HZ,
            "hidden": list(HIDDEN), "metrics": metrics or {}}
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8).copy()
    if not path.endswith(".npz"):
        path += ".npz"  # savez appends it silently; keep names honest
    d = os.path.dirname(path)
    if d:  # bare filenames: makedirs("") raises
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **flat)
    return path


def load_meta(path: Optional[str] = None) -> Dict:
    """Checkpoint metadata ({} for pre-metadata checkpoints)."""
    import json

    path = path or _DEFAULT_WEIGHTS
    with np.load(path) as z:
        if "__meta__" not in z.files:
            return {}
        return json.loads(bytes(z["__meta__"]).decode())


def load_params(path: Optional[str] = None) -> Dict:
    """Load a checkpoint as a nested f32 param dict.  Raises
    FileNotFoundError when no checkpoint exists (callers surface that as
    'neural backend unavailable') and ValueError on a feature-version
    mismatch (weights trained against different featurize() semantics
    would silently mistrack)."""
    import json

    path = path or _DEFAULT_WEIGHTS
    with np.load(path) as z:
        tree: Dict = {}
        ver = None
        hidden = None
        for key in z.files:
            if key == "__meta__":
                meta = json.loads(bytes(z[key]).decode())
                ver = meta.get("feature_version")
                hidden = meta.get("hidden")
                continue
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key].astype(np.float32)
    if ver != FEATURE_VERSION:  # includes pre-metadata checkpoints (None)
        raise ValueError(
            f"checkpoint {path} has feature_version {ver}, this build "
            f"expects {FEATURE_VERSION}; retrain with "
            f"python -m aegis_tpu.models.train")
    if hidden is not None and tuple(hidden) != HIDDEN:
        # a clear error now beats a kernel-shape mismatch later
        raise ValueError(
            f"checkpoint {path} was trained with hidden={tuple(hidden)}, "
            f"this build uses {HIDDEN}")
    return tree


def have_default_weights() -> bool:
    return os.path.exists(_DEFAULT_WEIGHTS)


_DEVICE_PARAMS = None


def default_params_device():
    """The default checkpoint, loaded once per process and kept
    device-resident — the one shared lazy loader behind every engine
    facade's neural backend."""
    global _DEVICE_PARAMS
    if _DEVICE_PARAMS is None:
        _DEVICE_PARAMS = jax.device_put(load_params())
    return _DEVICE_PARAMS


# ------------------------------------------------------- fused analyze path


def _onset_backfill(pitch, onset_env, frames_per_second: float,
                    env_max=None):
    """Extend voicing backward toward the attack at spectral-flux onsets.

    A window-centered spectrum classifier hears a pluck a few frames after
    its attack (half the window is still silence); the onset envelope —
    computed in the same fused program — marks the physical attack.  pYIN
    itself locks 2-4 frames after the attack (the pluck is unpitched
    noise), so the fill is capped at ~95 ms (half a 2048 window at 22.05 k,
    the classifier's worst-case lag: a rake-then-attack mix can hold the
    voicing head off until the window center clears the noise) before the
    first voiced frame, gated on a strong local onset peak within ~140 ms
    that leads into the voiced run; filled frames inherit the run's first
    f0/vprob.  The fill cannot fire early: a peak anchors only if a voiced
    run follows within the window, frames further than max_fill before the
    run stay untouched, and filling starts a pitch-lock delay (~45 ms)
    AFTER the anchor peak — pYIN itself locks that long after the physical
    attack (the pluck is unpitched noise), so snapping all the way to the
    peak overshot pYIN by up to 70 ms at 22.05 kHz hop 512, where the
    50 ms event tolerance is barely two frames.  This is what closes the
    50 ms+ onset gaps vs pYIN at 44.1 kHz and under heavy distortion."""
    import jax.numpy as jnp

    k = max(int(round(0.14 * frames_per_second)), 1)       # peak window
    max_fill = max(int(round(0.095 * frames_per_second)), 1)
    lock = max(int(round(0.045 * frames_per_second)), 0)   # pyin lock delay

    voiced, f0, vprob = pitch["voiced_flag"], pitch["f0"], pitch["voiced_probs"]

    def future(width):
        near = voiced
        ff, fp = f0, vprob
        for s in range(1, width + 1):
            sv = jnp.concatenate([voiced[s:], jnp.zeros(s, bool)])
            sf = jnp.concatenate([f0[s:], jnp.full(s, jnp.nan, f0.dtype)])
            sp = jnp.concatenate([vprob[s:], jnp.zeros(s, vprob.dtype)])
            take = ~near & sv
            ff = jnp.where(take, sf, ff)
            fp = jnp.where(take, sp, fp)
            near = near | sv
        return near, ff, fp

    near_k, _, _ = future(k)
    near_fill, fut_f0, fut_p = future(max_fill)

    prev = jnp.concatenate([onset_env[:1], onset_env[:-1]])
    nxt = jnp.concatenate([onset_env[1:], onset_env[-1:]])
    if env_max is None:  # fused: track max; streamed slabs pass the global
        env_max = jnp.max(onset_env)
    peak = (onset_env >= prev) & (onset_env >= nxt) & (
        onset_env > 0.2 * env_max)
    anchor = peak & near_k  # an attack that leads into a voiced run
    seen = anchor if lock == 0 else jnp.zeros_like(anchor)
    for s in range(max(lock, 1), k + 1):
        seen = seen | jnp.concatenate([jnp.zeros(s, bool), anchor[:-s]])
    add = ~voiced & near_fill & seen
    return {
        "f0": jnp.where(add, fut_f0, f0),
        "voiced_flag": voiced | add,
        "voiced_probs": jnp.where(add, fut_p, vprob),
    }


def _neural_native_rows(y16, scale, rake_sensitivity, params, sample_rate,
                        hop_length, n_fft, n_mels):
    """Shared body of the native-rate (22.05 kHz single-input) programs.
    ``scale`` rank selects the transport (core.analyze.dequant_transport):
    scalar = per-track int16, rank-1 = int8 block-float."""
    from aegis_tpu.core import dsp
    from aegis_tpu.core.analyze import dequant_transport

    y = dequant_transport(y16, scale)
    out = _neural_host_rows(y, rake_sensitivity, sample_rate, hop_length,
                            n_fft, n_mels)
    frames = dsp.frame_signal(y, WIN, hop_length, "constant")  # (T, WIN)
    out.update(_onset_backfill(_neural_pitch(params, frames),
                               out["onset_env"],
                               sample_rate / hop_length))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("sample_rate", "hop_length", "n_fft", "n_mels",
                     "include_mel"))
def analyze_neural_program_packed(y16, scale, rake_sensitivity, params,
                                  sample_rate: int, hop_length: int,
                                  n_fft: int, n_mels: int,
                                  include_mel: bool = True):
    """The v1 Perception Phase with PitchNet in place of pYIN — mel, rake,
    RMS, onset envelope and neural f0/voicing in ONE fused program with the
    same packed (T, n_mels + 6) output layout as core.analyze._V1_ROWS.
    Native-rate (22.05 kHz) single-input variant."""
    from aegis_tpu.core.analyze import _V1_ROWS, _pack

    out = _neural_native_rows(y16, scale, rake_sensitivity, params,
                              sample_rate, hop_length, n_fft, n_mels)
    return _pack(out, _V1_ROWS, include_mel)


def _neural_host_rows(y, rake_sensitivity, sample_rate, hop_length, n_fft,
                      n_mels):
    """mel/rake/RMS/onset at the caller's ORIGINAL rate and hop — identical
    semantics to core.analyze.analyze_program's non-pitch rows."""
    from aegis_tpu.core import dsp, masks
    from aegis_tpu.core.cqt import onset_from_db

    mel = dsp.melspectrogram_t(y, sample_rate, n_fft, hop_length, n_mels)
    mel_db = dsp.power_to_db(mel)
    rake = masks.detect_rake(mel_db, hop_length, sample_rate,
                             rake_sensitivity)
    return {
        "mel_db": mel_db,
        "rake_mask": rake,
        "rms": dsp.rms(y, WIN, hop_length),
        # onset flux from the SAME dB array (power_to_db ref=max makes
        # onset_strength_t(mel) identical; reusing mel_db keeps the
        # streamed mode's explicit-reference slabs bit-identical)
        "onset_env": onset_from_db(mel_db),
    }


def _neural_pitch(params, frames, smooth: int = 5, valid=None):
    """Per-frame net outputs -> pitch rows, with a `smooth`-frame NaN-aware
    median over the cents track.  The net decodes every frame independently
    (no Viterbi), so isolated octave flips on rich attack spectra survive;
    a short temporal median removes them the way the HMM's transition prior
    does for pYIN (measured on the KS gating clip: event F1 0.0 -> see
    tests).  `valid` (bool (T,)) forces frames outside it unvoiced BEFORE
    smoothing — the streamed mode marks its synthetic before-track halo
    frames invalid so they can't leak into medians or backfill."""
    import jax.numpy as jnp

    logits, vlogit = apply_model(params, featurize(frames))
    f0, vprob = decode_f0(logits, vlogit)
    # 0.4, not 0.5: onset windows (half silence + pluck) sit on the voicing
    # decision boundary and a symmetric threshold lags real attacks by a
    # frame or two; noise stays at vprob ~0, so the lower cut costs nothing
    # (measured: all KS onsets within the 50 ms F1 tolerance at 0.4)
    voiced = vprob > 0.4
    if valid is not None:
        voiced = voiced & valid
        vprob = jnp.where(valid, vprob, 0.0)
    f0 = smooth_f0_median(f0, voiced, smooth)
    return {"f0": f0, "voiced_flag": voiced, "voiced_probs": vprob}


def smooth_f0_median(f0, voiced, smooth: int = 5):
    """NaN-aware running median over the cents track on voiced frames;
    unvoiced frames come back NaN.  Oracle: ref/pitchnet_post_ref.py."""
    import jax.numpy as jnp

    cents = jnp.where(voiced, 1200.0 * jnp.log2(f0 / FMIN_HZ), jnp.nan)
    if smooth > 1:
        half = smooth // 2
        # NaN padding (not edge): out-of-track frames contribute nothing,
        # which keeps the streamed slab mode bit-identical to the fused
        # program at track boundaries
        cp = jnp.pad(cents, half, constant_values=jnp.nan)
        stack = jnp.stack([cp[j:j + cents.shape[0]]
                           for j in range(smooth)], axis=-1)
        med = jnp.nanmedian(stack, axis=-1)
        cents = jnp.where(jnp.isnan(cents), cents, med)
    return FMIN_HZ * jnp.exp2(cents / 1200.0)


def _neural_dual_rows(y16, scale, y22_16, scale22, centers,
                      rake_sensitivity, params, sample_rate, hop_length,
                      n_fft, n_mels, uniform_hop22):
    """Shared body of the two-rate programs: original-rate base rows +
    22.05 kHz pitch head (uniform framing or rounded-center gather).
    Scale ranks select each input's transport (dequant_transport)."""
    import jax.numpy as jnp

    from aegis_tpu.core import dsp
    from aegis_tpu.core.analyze import dequant_transport

    y = dequant_transport(y16, scale)
    out = _neural_host_rows(y, rake_sensitivity, sample_rate, hop_length,
                            n_fft, n_mels)
    T = out["rms"].shape[0]

    y22 = dequant_transport(y22_16, scale22)
    if uniform_hop22:
        frames = dsp.frame_signal(y22, WIN, uniform_hop22, "constant")
        frames = frames[:T]
    else:
        pad = WIN // 2
        y22p = jnp.pad(y22, pad)
        idx = centers[:T, None] + jnp.arange(WIN)[None, :]  # centered
        frames = y22p[jnp.clip(idx, 0, y22p.shape[0] - 1)]
    out.update(_onset_backfill(_neural_pitch(params, frames),
                               out["onset_env"],
                               sample_rate / hop_length))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("sample_rate", "hop_length", "n_fft", "n_mels",
                     "include_mel", "uniform_hop22"))
def analyze_neural_program_dual(y16, scale, y22_16, scale22, centers,
                                rake_sensitivity, params,
                                sample_rate: int, hop_length: int,
                                n_fft: int, n_mels: int,
                                include_mel: bool = True,
                                uniform_hop22: int = 0):
    """Two-rate variant for sample rates other than 22.05 kHz: the mel /
    rake / RMS / onset rows run on the ORIGINAL-rate signal with the
    original hop (exact frame grid, same semantics as the pYIN path), while
    the pitch head runs on the 22.05 kHz resample — framed uniformly when
    hop*22050/sr is integral (uniform_hop22 > 0, e.g. 44100/512 -> 256), or
    gathered at per-frame rounded centers otherwise (exact alignment at any
    rate; a (T, WIN) gather is slower but correct)."""
    from aegis_tpu.core.analyze import _V1_ROWS, _pack

    out = _neural_dual_rows(y16, scale, y22_16, scale22, centers,
                            rake_sensitivity, params, sample_rate,
                            hop_length, n_fft, n_mels, uniform_hop22)
    return _pack(out, _V1_ROWS, include_mel)


@functools.partial(
    jax.jit,
    static_argnames=("sample_rate", "hop_length", "n_fft", "n_mels",
                     "include_mel", "use_guitar_filters", "uniform_hop22"))
def analyze_neural_financial_dual(y16, scale, y22_16, scale22, centers,
                                  rake_sensitivity, params,
                                  sample_rate: int, hop_length: int,
                                  n_fft: int, n_mels: int,
                                  include_mel: bool = True,
                                  use_guitar_filters: bool = True,
                                  uniform_hop22: int = 0):
    """Two-rate financial variant: dual base rows + the shared
    guitar-filter/trend tail, packed as _FIN_ROWS — pitch_backend="neural"
    on the financial engine at any sample rate."""
    from aegis_tpu.config import AudioConfig
    from aegis_tpu.core.analyze import _FIN_ROWS, _pack, financial_tail

    out = _neural_dual_rows(y16, scale, y22_16, scale22, centers,
                            rake_sensitivity, params, sample_rate,
                            hop_length, n_fft, n_mels, uniform_hop22)
    audio = AudioConfig(sample_rate=sample_rate, hop_length=hop_length,
                        n_fft=n_fft, n_mels=n_mels)
    return _pack(financial_tail(out, audio, use_guitar_filters),
                 _FIN_ROWS, include_mel)


@functools.partial(
    jax.jit,
    static_argnames=("sample_rate", "hop_length", "n_fft", "n_mels",
                     "include_mel", "use_guitar_filters"))
def analyze_neural_financial_packed(y16, scale, rake_sensitivity, params,
                                    sample_rate: int, hop_length: int,
                                    n_fft: int, n_mels: int,
                                    include_mel: bool = True,
                                    use_guitar_filters: bool = True):
    """The v2 financial Perception Phase with PitchNet in place of pYIN:
    neural base rows + the shared guitar-filter/trend tail
    (core.analyze.financial_tail), packed as _FIN_ROWS."""
    from aegis_tpu.config import AudioConfig
    from aegis_tpu.core.analyze import _FIN_ROWS, _pack, financial_tail

    out = _neural_native_rows(y16, scale, rake_sensitivity, params,
                              sample_rate, hop_length, n_fft, n_mels)
    audio = AudioConfig(sample_rate=sample_rate, hop_length=hop_length,
                        n_fft=n_fft, n_mels=n_mels)
    return _pack(financial_tail(out, audio, use_guitar_filters),
                 _FIN_ROWS, include_mel)


@functools.partial(
    jax.jit, static_argnames=("sample_rate", "hop_length", "n_fft",
                              "n_mels", "keep_lo", "keep_hi"))
def _neural_mel_peak(y16, scale, sample_rate: int, hop_length: int,
                     n_fft: int, n_mels: int, keep_lo: int = 0,
                     keep_hi: int = -1):
    """Pass-1a of the streamed mode: a slab's mel-power peak over its
    INTERIOR frames [keep_lo, keep_hi) — the outermost ~2 frames of each
    extended slab are palindromic reflect-padding windows whose power can
    exceed any real frame's, which would inflate the global dB reference
    above the fused program's."""
    import jax.numpy as jnp

    from aegis_tpu.core import dsp

    y = y16.astype(jnp.float32) * scale
    mel = dsp.melspectrogram_t(y, sample_rate, n_fft, hop_length, n_mels)
    return jnp.max(mel[keep_lo:keep_hi])


@functools.partial(
    jax.jit, static_argnames=("sample_rate", "hop_length", "n_fft",
                              "n_mels", "keep_lo", "keep_hi"))
def _neural_onset_max(y16, scale, ref_power, n_invalid_left,
                      sample_rate: int, hop_length: int, n_fft: int,
                      n_mels: int, keep_lo: int = 0, keep_hi: int = -1):
    """Pass-1b: a slab's onset-flux maximum over its interior frames, with
    the GLOBAL dB reference (flux at silence->attack boundaries depends on
    the floored predecessor frame, so a slab-local reference would differ).
    Feeds the backfill's track-global 20% peak threshold."""
    import jax.numpy as jnp

    from aegis_tpu.core import dsp
    from aegis_tpu.core.cqt import onset_from_db

    y = y16.astype(jnp.float32) * scale
    mel = dsp.melspectrogram_t(y, sample_rate, n_fft, hop_length, n_mels)
    mel_db = _mel_db_with_ref(mel, ref_power)
    env = onset_from_db(mel_db)
    idx = jnp.arange(env.shape[0])
    env = jnp.where(idx >= n_invalid_left + 1, env, 0.0)
    return jnp.max(env[keep_lo:keep_hi])


def _mel_db_with_ref(mel, ref_power):
    """power_to_db with an EXPLICIT reference: with ref == the track-global
    mel max, max(log_spec) == 0, so the fused path's max-80 floor is the
    constant -80 here — identical output, slab-safe."""
    import jax.numpy as jnp

    amin = 1e-10
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, mel))
    log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(amin, ref_power))
    return jnp.maximum(log_spec, -80.0)


@functools.partial(
    jax.jit, static_argnames=("sample_rate", "hop_length", "n_fft",
                              "n_mels", "include_mel", "hop22"))
def _neural_slab_program(y16, scale, y22_16, scale22, rake_sensitivity,
                         params, ref_power, onset_ref, n_invalid_left,
                         n_valid_right,
                         sample_rate: int,
                         hop_length: int, n_fft: int, n_mels: int,
                         include_mel: bool = False, hop22: int = 0):
    """Pass-2 slab rows with an explicit track-global mel-power dB
    reference (identical rake/mel thresholds in every slab).  hop22=0 means
    the native single-input layout (y22_16/scale22 ignored)."""
    import jax.numpy as jnp

    from aegis_tpu.core import dsp, masks
    from aegis_tpu.core.analyze import _V1_ROWS, _pack
    from aegis_tpu.core.cqt import onset_from_db

    y = y16.astype(jnp.float32) * scale
    # slab 0's leading halo carries REFLECTED audio for the mel path
    # (fused framing reflects at the track start), and the final slab's
    # tail carries the bucket-end reflect (samples >= n_valid_right) —
    # but rms and the pitch framing use constant-zero padding, so zero
    # both regions for those paths to match the fused program exactly
    s_idx = jnp.arange(y.shape[0])
    y_zero = jnp.where((s_idx >= n_invalid_left * hop_length)
                       & (s_idx < n_valid_right), y, 0.0)
    mel = dsp.melspectrogram_t(y, sample_rate, n_fft, hop_length, n_mels)
    mel_db = _mel_db_with_ref(mel, ref_power)
    out = {
        "mel_db": mel_db,
        "rake_mask": masks.detect_rake(mel_db, hop_length, sample_rate,
                                       rake_sensitivity),
        "rms": dsp.rms(y_zero, WIN, hop_length),
        "onset_env": onset_from_db(mel_db),
    }
    if hop22:
        y22 = y22_16.astype(jnp.float32) * scale22
        s22 = jnp.arange(y22.shape[0])
        y22 = jnp.where(s22 >= n_invalid_left * hop22, y22, 0.0)
        frames = dsp.frame_signal(y22, WIN, hop22, "constant")
        frames = frames[:out["rms"].shape[0]]
    else:
        frames = dsp.frame_signal(y_zero, WIN, hop_length, "constant")
    # frames before the track start (first slab's synthetic left halo) are
    # invalid: force them unvoiced and zero their onset flux so medians /
    # backfill see exactly what the fused program sees at frame 0
    idx = jnp.arange(out["rms"].shape[0])
    valid = idx >= n_invalid_left
    out["onset_env"] = jnp.where(idx >= n_invalid_left + 1,
                                 out["onset_env"], 0.0)
    out.update(_onset_backfill(
        _neural_pitch(params, frames, valid=valid),
        out["onset_env"], sample_rate / hop_length, env_max=onset_ref))
    return _pack(out, _V1_ROWS, include_mel)


def run_analyze_neural_streamed(
    y: np.ndarray,
    sr: int,
    hop_length: int,
    params,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = False,
    slab_frames: int = 16384,
    halo_frames: int = 16,
) -> Dict[str, np.ndarray]:
    """Bounded-memory streamed neural analyze for multi-minute tracks.

    Memory stays bounded by the fixed slab (~17 MB int16 at 22.05 kHz).

    Every stage of the neural pipeline is frame-local (window 2048, rake
    run-length <= 3 frames, cents median +-2, onset backfill bounded by
    the frame rate), so slabs with enough halo overlap reproduce the fused
    program EXACTLY except for the dB reference — which pass 1 recovers as
    the track-global mel peak (upload-once: the int16 slabs stay device-
    resident between the passes).  The whole track is quantized with ONE
    per-track scale, so slab rows are bit-identical to the fused program's.
    `halo_frames` is a floor: the halo grows with the frame rate so the
    onset backfill's full ~0.14 s anchor window (plus its flux/mel frame
    lookback) always fits.
    Non-native rates resample once host-side (uniform hops only)."""
    import jax.numpy as jnp

    from aegis_tpu.core.analyze import _V1_ROWS, _unpack, bucket_length, \
        quantize_pcm16

    fps = sr / hop_length
    # The widest frame dependency is the onset backfill: a filled frame
    # reads anchors up to k = round(0.14*fps) frames back, and an anchor's
    # peak test reads onset flux one frame earlier, itself one mel frame
    # back — a left reach of k+2 (the right reach is k+1 via future(k);
    # the +4 also covers the cents median +-2 and rake run-length <= 3).
    halo_frames = max(halo_frames, int(round(0.14 * fps)) + 4)
    true_frames = 1 + len(y) // hop_length
    if sr == SR_NATIVE:
        hop22 = 0
    else:
        num = hop_length * SR_NATIVE
        if num % sr != 0:
            raise ValueError(
                f"streamed neural analysis needs an integral 22.05 kHz hop "
                f"(sr={sr}, hop={hop_length}); resample the audio first")
        hop22 = num // sr
        from aegis_tpu.io.audio import resample

        y22 = resample(np.asarray(y, np.float32), sr, SR_NATIVE)
        need22 = true_frames * hop22 + WIN
        y22 = np.pad(y22, (0, max(need22 - len(y22), 0)))

    # The fused program frames the BUCKET-padded signal (length B): mel
    # framing reflects past the bucket's far end — back through the
    # bucket's zero band into real samples when the window outreach
    # exceeds B - len(y) — and its dB/onset references max over the full
    # padded grid of T_pad = 1 + B//hop frames.  Slabs must reproduce
    # both (caught by test_streamed_matches_fused_high_fps: the last true
    # frame's window reached 1536 samples past the bucket end), so the
    # slab grid covers T_pad, not just true_frames.
    B_len = bucket_length(len(y))
    T_pad = 1 + B_len // hop_length

    S, H = slab_frames, halo_frames
    n_slabs = -(-T_pad // S)
    ext_len = (S + 2 * H) * hop_length  # samples per extended slab
    y16_full, scale = quantize_pcm16(np.asarray(y, np.float32))
    if hop22:
        y22_16_full, scale22 = quantize_pcm16(np.asarray(y22))
        ext22_len = (S + 2 * H) * hop22

    def slab16(full, a, length, bucket_len=None):
        lo, hi = max(a, 0), min(a + length, len(full))
        out = np.zeros(length, np.int16)
        if hi > lo:
            out[lo - a: hi - a] = full[lo:hi]
        if a < 0:
            # reflect the track start into the leading halo — the fused
            # program's mel framing uses reflect padding at frame 0, so
            # slab 0 must see the same pre-track samples (np.pad 'reflect'
            # convention: x[1..p] reversed)
            p = min(-a, len(full) - 1)
            out[-a - p: -a] = full[1:1 + p][::-1]
        if bucket_len is not None and a + length > bucket_len:
            # fused mel framing reflects past the bucket's far end: the
            # virtual sample at position p >= bucket_len is
            # padded_bucket[2*bucket_len - 2 - p] — zero inside the
            # bucket's zero band, a real sample below it (single reflect
            # covers every fused frame: the deepest window reach is
            # bucket_len + n_fft//2 - hop)
            p = np.arange(max(a, bucket_len), a + length)
            q = 2 * bucket_len - 2 - p
            m = (q >= 0) & (q < len(full))
            out[p[m] - a] = full[q[m]]
        return jnp.asarray(out)

    # pass 1a: upload every slab once (device-resident); track-global mel
    # peak over interior frames, clamped to the fused grid [0, T_pad) —
    # the outermost reflect-padding frames of each extended slab are
    # palindromic windows whose power can exceed any real frame's and
    # would inflate the reference above the fused one, while frames the
    # FUSED program computes (including its bucket-tail reflect frames up
    # to T_pad - 1) must all contribute
    slabs = []
    peaks = []
    for k in range(n_slabs):
        a = (k * S - H) * hop_length
        s16 = slab16(y16_full, a, ext_len, bucket_len=B_len)
        s22 = (slab16(y22_16_full, (k * S - H) * hop22, ext22_len)
               if hop22 else None)
        slabs.append((s16, s22))
        peaks.append(_neural_mel_peak(s16, jnp.float32(scale), sr,
                                      hop_length, n_fft, n_mels,
                                      keep_lo=H,
                                      keep_hi=H + min(S, T_pad - k * S)))
    ref = jnp.max(jnp.stack(peaks))

    # pass 1b: track-global onset-flux max (with the global dB reference)
    # — the backfill's 20% peak threshold must be global, not per-slab
    omaxes = [
        _neural_onset_max(s16, jnp.float32(scale), ref,
                          jnp.int32(H if k == 0 else 0), sr, hop_length,
                          n_fft, n_mels, keep_lo=H,
                          keep_hi=H + min(S, T_pad - k * S))
        for k, (s16, _) in enumerate(slabs)
    ]
    onset_ref = jnp.max(jnp.stack(omaxes))

    # pass 2: per-slab rows with the global references, dispatch-ahead
    # (fetching slab k only after slab k+1 is dispatched keeps the
    # per-transfer latency overlapped with device compute).  Slabs past
    # true_frames exist only to feed the reference maxima — skip them.
    # n_valid_right: first slab-coordinate SAMPLE of the bucket-tail
    # reflect region, which the pitch/rms zero-padding conventions must
    # see as zeros (the mel path reads the reflected samples).
    handles = []
    for k, (s16, s22) in enumerate(slabs):
        if k * S >= true_frames:
            break
        a = (k * S - H) * hop_length
        handles.append(_neural_slab_program(
            s16, jnp.float32(scale),
            s22 if s22 is not None else s16,
            jnp.float32(scale22 if hop22 else 0.0),
            jnp.float32(rake_sensitivity), params, ref, onset_ref,
            jnp.int32(H if k == 0 else 0),
            jnp.int32(np.clip(B_len - a, 0, ext_len)),
            sr, hop_length, n_fft, n_mels, fetch_mel, hop22))
    parts = [np.asarray(h)[H: H + S] for h in handles]
    buf = np.concatenate(parts)[:true_frames]
    return _unpack(buf, _V1_ROWS, n_mels if fetch_mel else 0)


def dispatch_analyze_neural(
    y: np.ndarray,
    sr: int,
    hop_length: int,
    params,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
    transport: str = "int8",
):
    """Async half of run_analyze_neural (mirrors
    core.analyze.dispatch_analyze): quantize, upload, dispatch the fused
    neural device program and return an opaque handle WITHOUT blocking.
    JAX dispatch is asynchronous, so a folder sweep can put every track in
    flight before fetching any — track i+1's upload/compute overlaps track
    i's device->host transfer.  Resolve with
    fetch_analyze_neural(handle)."""
    from aegis_tpu.core.analyze import _FIN_ROWS, _V1_ROWS, \
        pad_to_bucket, quantize_pcm16, quantize_pcm8, PCM8_BLOCK

    import jax.numpy as jnp

    if transport not in ("int8", "int16", "float32"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(neural backend: int8 | int16 | float32)")

    def _quant(arr):
        if transport == "int8":
            pad = (-len(arr)) % PCM8_BLOCK
            q, sc = quantize_pcm8(np.pad(arr, (0, pad)))
            return jnp.asarray(q), jnp.asarray(sc)
        if transport == "float32":
            return jnp.asarray(arr), jnp.float32(1.0)
        q, sc = quantize_pcm16(arr)
        return jnp.asarray(q), jnp.float32(sc)

    true_frames = 1 + len(y) // hop_length
    y_pad = pad_to_bucket(np.asarray(y, np.float32))
    y16, s = _quant(y_pad)
    rs = jnp.float32(rake_sensitivity)
    rows = _FIN_ROWS if financial else _V1_ROWS

    if sr == SR_NATIVE:
        if financial:
            packed = analyze_neural_financial_packed(
                y16, s, rs, params, sr,
                hop_length, n_fft, n_mels, fetch_mel, use_guitar_filters)
        else:
            packed = analyze_neural_program_packed(
                y16, s, rs, params, sr,
                hop_length, n_fft, n_mels, fetch_mel)
    else:
        from aegis_tpu.io.audio import resample

        y22 = resample(np.asarray(y, np.float32), sr, SR_NATIVE)
        num = hop_length * SR_NATIVE
        uniform = num % sr == 0
        hop22 = num // sr if uniform else 0
        # pad so the pitch framing covers every original-grid frame
        T_pad = 1 + len(y_pad) // hop_length
        need = (T_pad * (hop22 or int(np.ceil(num / sr)))) + WIN
        y22_pad = np.pad(y22, (0, max(need - len(y22), 0)))
        y22_16, s22 = _quant(y22_pad)
        if uniform:
            centers = jnp.zeros((1,), jnp.int32)  # unused placeholder
        else:
            # window start in the WIN//2-padded y22 = the rounded center
            # itself (start = c - WIN//2 unpadded, +WIN//2 pad offset)
            c = np.round(np.arange(T_pad) * num / sr).astype(np.int32)
            centers = jnp.asarray(c)
        args = (y16, s, y22_16, s22, centers, rs, params, sr, hop_length,
                n_fft, n_mels, fetch_mel)
        if financial:
            packed = analyze_neural_financial_dual(
                *args, use_guitar_filters, hop22)
        else:
            packed = analyze_neural_program_dual(*args, hop22)
    return packed, rows, true_frames, (n_mels if fetch_mel else 0)


def fetch_analyze_neural(handle) -> Dict[str, np.ndarray]:
    """Blocking half: transfer the packed buffer and unpack it."""
    from aegis_tpu.core.analyze import _unpack

    packed, rows, true_frames, n_mels = handle
    return _unpack(np.asarray(packed)[:true_frames], rows, n_mels)


def run_analyze_neural(
    y: np.ndarray,
    sr: int,
    hop_length: int,
    params,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = True,
    financial: bool = False,
    use_guitar_filters: bool = True,
    transport: str = "int8",
) -> Dict[str, np.ndarray]:
    """Host wrapper mirroring core.analyze.run_analyze for the neural
    backend.  The non-pitch rows (mel/rake/RMS/onset) always use the
    caller's exact (sr, hop) frame grid; only the pitch head sees a
    22.05 kHz resample, aligned per frame (uniform stride when divisible,
    rounded centers otherwise) — no cumulative timing drift at any rate.
    financial=True appends the guitar-filter/trend tail (_FIN_ROWS) at any
    rate.

    transport="int8" (default) is the fused paths' block-float convention
    (core.analyze.quantize_pcm8) — safe here because featurize()
    standardizes every analysis window, so the net is gain-invariant by
    construction and the per-block noise floor (~42 dB under the local
    envelope) sits far below the feature scale.  "int16" is what the
    streamed slab mode ships (its slab slicing needs one per-track scale
    for bit-exact splices); the streamed==fused parity test compares both
    at int16."""
    return fetch_analyze_neural(dispatch_analyze_neural(
        y, sr, hop_length, params, rake_sensitivity, n_fft, n_mels,
        fetch_mel, financial, use_guitar_filters, transport))


def run_analyze_neural_batch(
    ys: np.ndarray,
    sr: int,
    hop_length: int,
    params,
    rake_sensitivity: float = 0.6,
    n_fft: int = 2048,
    n_mels: int = 128,
    fetch_mel: bool = False,
    financial: bool = False,
    use_guitar_filters: bool = True,
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Sharded neural batch: data-parallel PitchNet inference over a mesh.

    The (B, n_samples) track batch shards over EVERY mesh axis flattened
    (PitchNet inference is embarrassingly data-parallel: all rows are
    frame-local and the net itself is tiny, so unlike pYIN's Viterbi there
    is nothing to time-tile — per-track programs on per-device track
    subsets are the whole story; params replicate and XLA inserts no
    collectives).  Output schema matches engine.turbo.run_analyze_batch:
    _V1_ROWS (or _FIN_ROWS with financial=True) batched on axis 0.

    Native rate (22.05 kHz) only: other rates use the per-track dual-rate
    resample programs via dispatch_analyze_neural, which a caller can
    dispatch-ahead instead.  Tracks quantize per-track int16 (the batched
    transport convention, engine.turbo.quantize_tracks)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from aegis_tpu.config import AudioConfig
    from aegis_tpu.core.analyze import (_FIN_ROWS, _V1_ROWS, _pack, _unpack,
                                        bucket_length, financial_tail)
    from aegis_tpu.engine.turbo import quantize_tracks

    if sr != SR_NATIVE:
        raise ValueError(
            f"run_analyze_neural_batch is native-rate ({SR_NATIVE}) only; "
            f"got sr={sr} — dispatch the dual-rate per-track programs "
            "instead (dispatch_analyze_neural)")
    ys2 = np.asarray(ys, np.float32)
    if ys2.ndim != 2:
        raise ValueError(f"expected a (B, n_samples) batch, got {ys2.shape}")

    if mesh is None:
        devs = np.array(jax.devices())
        mesh = Mesh(devs.reshape(len(devs), 1), ("data", "time"))
    n_dev = int(np.prod(list(mesh.shape.values())))

    B = ys2.shape[0]
    true_frames = 1 + ys2.shape[1] // hop_length
    n_samp = bucket_length(ys2.shape[1])
    y16, scales = quantize_tracks(ys2, n_samp)
    pad = (-B) % n_dev
    if pad:  # silent filler tracks shard-align the batch; dropped on fetch
        y16 = np.concatenate([y16, np.zeros((pad, n_samp), np.int16)])
        scales = np.concatenate([scales, np.ones(pad, np.float32)])

    rows = _FIN_ROWS if financial else _V1_ROWS
    audio = AudioConfig(sample_rate=sr, hop_length=hop_length, n_fft=n_fft,
                        n_mels=n_mels)
    dp = NamedSharding(mesh, P(("data", "time")))
    rep = NamedSharding(mesh, P())

    def one(y16_i, scale_i, params_):
        out = _neural_native_rows(y16_i, scale_i,
                                  jnp.float32(rake_sensitivity), params_,
                                  sr, hop_length, n_fft, n_mels)
        if financial:
            out = financial_tail(out, audio, use_guitar_filters)
        return _pack(out, rows, fetch_mel)

    batch_prog = jax.jit(
        lambda yb, sb, p: jax.vmap(lambda yy, ss: one(yy, ss, p))(yb, sb),
        in_shardings=(dp, dp, rep), out_shardings=dp)
    buf = np.asarray(batch_prog(y16, scales, params))[:B, :true_frames]
    return _unpack(buf, rows, n_mels if fetch_mel else 0)
