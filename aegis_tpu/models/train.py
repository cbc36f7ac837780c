"""PitchNet trainer: ``python -m aegis_tpu.models.train [--steps N] ...``

The whole synthetic clip bank lives device-resident (int16, one upload);
each step is ONE device dispatch (crop sampling, featurization, loss,
grads, optimizer all fused).  Multi-device data-parallel training is available from
the API — ``train(..., mesh=your_mesh)`` — and is exercised by
``__graft_entry__.dryrun_multichip``.

Prints progress to stderr and a final JSON metrics line to stdout:
  {"loss": ..., "rpa_50c": ..., "voicing_acc": ..., "median_cents_err": ...}
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def evaluate(params, n_clips: int = 192, clip_len: int = 16384,
             seed: int = 777, windows_per_clip: int = 6):
    """Held-out synthetic eval: raw pitch accuracy (<=50 cents), voicing
    accuracy, median |cents| error on voiced frames."""
    import jax.numpy as jnp

    from aegis_tpu.models import pitchnet as pn
    from aegis_tpu.models.data import LABEL_HOP, make_clips

    d = make_clips(n_clips, clip_len, seed=seed)
    y = d["tracks"].astype(np.float32) * d["scale"][:, None]
    offs = np.linspace(0, clip_len - pn.WIN, windows_per_clip).astype(int)
    wins, f0_true, v_true, w_true = [], [], [], []
    for o in offs:
        wins.append(y[:, o:o + pn.WIN])
        li = min((o + pn.WIN // 2) // LABEL_HOP, d["f0_hz"].shape[1] - 1)
        f0_true.append(d["f0_hz"][:, li])
        v_true.append(d["voiced"][:, li])
        w_true.append(d["label_w"][:, li])
    wins = np.concatenate(wins)
    f0_true = np.concatenate(f0_true)
    v_true = np.concatenate(v_true)
    # ambiguous frames (decay boundaries, reverb tails) carry no training
    # signal — scoring them would measure label noise, not the model
    keep = np.concatenate(w_true) > 0.0
    wins, f0_true, v_true = wins[keep], f0_true[keep], v_true[keep]

    logits, vlogit = pn.apply_model(params, pn.featurize(jnp.asarray(wins)))
    f0_hat, vprob = pn.decode_f0(logits, vlogit)
    f0_hat = np.asarray(f0_hat)
    # 0.4 = the production decode threshold (_neural_pitch): the gate must
    # measure the deployed operating point, not a different one
    v_hat = np.asarray(vprob) > 0.4

    voicing_acc = float((v_hat == v_true).mean())
    m = v_true & (f0_true > 0)
    cents = 1200.0 * np.abs(np.log2(f0_hat[m] / f0_true[m]))
    return {
        "rpa_50c": float((cents <= 50).mean()) if m.any() else 0.0,
        "voicing_acc": voicing_acc,
        "median_cents_err": float(np.median(cents)) if m.any() else -1.0,
        "n_eval_frames": int(m.sum()),
    }


def train(steps: int = 3000, batch: int = 256, clips: int = 2048,
          clip_len: int = 16384, seed: int = 0, out: str | None = None,
          mesh=None, log_every: int = 200, data_kwargs: dict | None = None):
    import jax
    import jax.numpy as jnp

    from aegis_tpu.models import pitchnet as pn
    from aegis_tpu.models.data import make_clips

    from aegis_tpu.models.pitchnet import WIN

    if clip_len < 2 * WIN:
        # the crop sampler needs room for a full window plus the attack
        # region; a smaller clip would feed randint a non-positive range
        raise ValueError(f"clip_len must be >= {2 * WIN} (got {clip_len})")
    t0 = time.time()
    d = make_clips(clips, clip_len, seed=seed, **(data_kwargs or {}))
    print(f"# data: {clips} clips x {clip_len} samples "
          f"({time.time() - t0:.1f}s to synthesize)", file=sys.stderr)

    tracks = jnp.asarray(d["tracks"])  # int16 resident bank
    scale = jnp.asarray(d["scale"])
    f0_hz = jnp.asarray(d["f0_hz"])
    voiced = jnp.asarray(d["voiced"])
    label_w = jnp.asarray(d["label_w"])

    import optax

    lr = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup_steps=min(100, steps // 10 + 1),
        decay_steps=steps, end_value=1e-5)
    params, opt_state = pn.init_train_state(seed, lr=lr)
    base_rng = jax.random.PRNGKey(seed + 1)
    step_fn = pn.make_train_step(mesh, batch, lr=lr)

    t0 = time.time()
    loss = None
    for i in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, base_rng,
                                          np.int32(i), tracks, scale,
                                          f0_hz, voiced, label_w)
        if i % log_every == 0 or i == steps - 1:
            print(f"# step {i:5d}  loss {float(loss):.4f}  "
                  f"({time.time() - t0:.1f}s)", file=sys.stderr)
    train_s = time.time() - t0

    metrics = {"loss": float(loss), "steps": steps, "train_s": round(train_s, 1),
               **evaluate(params)}
    if out:
        saved = pn.save_params(jax.device_get(params), out, metrics=metrics)
        print(f"# saved {saved}", file=sys.stderr)
    return params, metrics


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--clips", type=int, default=2048)
    ap.add_argument("--clip-len", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="checkpoint path (default: packaged weights path)")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu) before init")
    args = ap.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from aegis_tpu.models import pitchnet as pn

    out = args.out or pn._DEFAULT_WEIGHTS
    _, metrics = train(args.steps, args.batch, args.clips, args.clip_len,
                       args.seed, out)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
