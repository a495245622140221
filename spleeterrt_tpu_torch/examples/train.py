"""Train stem nets on a musdb-layout corpus with checkpoint-resume + eval.

Layout (the convention upstream Spleeter models were trained on):

    <root>/train/<track>/{mixture.wav, vocals.wav|.flac, accompaniment.wav|.flac, ...}
    <root>/test/<track>/...            (holdout; SI-SDR eval)

The reference package's `examples/train.py` on one device, without its
mesh. The dataset streams crops from disk (seeked WAV reads; FLAC stems go
through a bounded decode cache), silent-stem crops are masked out of the
loss, params keep an EMA shadow for deployment, and checkpoints resume
exactly (params + Adam state + step + EMA, core/checkpoint.py): with
`--ckpt`, a run starts from the newest `step_N` there. Eval runs the real
separation graph (the hand kernels on a card) and reports per-stem SI-SDR
on the holdout; `--export` writes the EMA nets as the reference's .dat
blobs.

Run: python -m spleeterrt_tpu_torch.examples.train --data <root>
     [--stems vocals accompaniment] [--steps 2000 --batch 8 --ckpt ckpts]
     [--device cuda|cpu] [--fp32]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from spleeterrt_tpu_torch.cli import open_device
from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.core import checkpoint, model, train, weights
from spleeterrt_tpu_torch.data import dataset as ds


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="musdb-layout root")
    ap.add_argument("--stems", nargs="+", default=["vocals", "accompaniment"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("--ckpt", default=None, help="checkpoint root (resume)")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--eval-seconds", type=float, default=12.0)
    ap.add_argument("--export", default=None, help=".dat blob dir")
    ap.add_argument("--bin-limit", type=int, default=1024)
    ap.add_argument("--time-step", type=int, default=256)
    ap.add_argument("--fp32", action="store_true",
                    help="float32 U-Net compute (default bfloat16)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = open_device(args.device)
    stems = tuple(args.stems)
    cfg = SeparatorConfig(
        bin_limit=args.bin_limit, time_step=args.time_step,
        num_stems=len(stems),
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
    )
    train_set = ds.StemDataset(os.path.join(args.data, "train"), stems)
    eval_dir = os.path.join(args.data, "test")
    eval_set = ds.StemDataset(eval_dir, stems) if os.path.isdir(eval_dir) else None
    n_streaming = sum(t.streaming for t in train_set.tracks)
    print(
        f"{len(train_set.tracks)} train tracks ({n_streaming} streamed from"
        f" disk), {len(eval_set.tracks) if eval_set else 0} eval tracks"
    )

    nets = [model.init_params(torch.Generator().manual_seed(i))
            for i in range(len(stems))]
    stacked = weights.params_to(weights.stack_params(nets), device)
    state = train.init_train_state(stacked, args.lr, ema=args.ema > 0)
    if args.ckpt:
        latest = checkpoint.latest_step_dir(args.ckpt)
        if latest:
            state = checkpoint.restore(latest, state)
            print(f"resumed from {latest} (step {state.step})")
    step_fn = train.make_train_step(compute_dtype=cfg.compute_dtype,
                                    ema_decay=args.ema)
    print(f"training on {device}, {cfg.compute_dtype}")

    def save():
        if args.ckpt:
            checkpoint.save(os.path.join(args.ckpt, f"step_{state.step}"), state)

    def deployable():
        return state.ema_params if state.ema_params is not None else state.params

    def evaluate():
        if eval_set is None:
            return
        rep = train.evaluate_si_sdr(deployable(), eval_set, cfg,
                                    seconds=args.eval_seconds)
        line = "  ".join(f"{k} {v:+.2f} dB" for k, v in rep.items())
        print(f"eval @ step {state.step}: {line}")

    t0 = time.perf_counter()
    it = ds.batches(train_set, cfg, args.batch, seed=state.step,
                    steps=max(0, args.steps - state.step), device=device)
    for mix_mag, tgt, active in it:
        state, loss = step_fn(state, mix_mag, tgt, active)
        s = state.step
        if s % 25 == 0 or s == args.steps:
            dt = time.perf_counter() - t0
            print(f"step {s:5d}  loss {float(loss):.5f}  ({dt:.1f}s)")
        if args.ckpt_every and s % args.ckpt_every == 0:
            save()
        if args.eval_every and s % args.eval_every == 0:
            evaluate()

    save()
    evaluate()

    if args.export:
        os.makedirs(args.export, exist_ok=True)
        folded = train.deploy_params(deployable(), cfg.transform.fft_size)
        for i, name in enumerate(stems):
            weights.save_coeff_file(model.stem_params(folded, i),
                                    os.path.join(args.export, f"{name}.dat"))
        print(f"exported {len(stems)} blobs to {args.export}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
