"""Train-and-deploy demonstration: the full loop over the process group.

The reference package's `examples/train_and_deploy.py`, with its mesh:
the ranks of the process group (world 1 under a plain `python` start)
train the 2 stem nets on a (stem, data) mesh, 2 stem groups where the
world is even (core/train.py::make_sharded_train_step). It proves the
training subsystem closes end to end (the reference ships fixed weights
only and cannot train at all):

1. synthesize a tone-vs-noise corpus (train batches + holdout tracks),
2. evaluate holdout SI-SDR with the INITIAL weights through the REAL
   separation graph (core/train.py::evaluate_si_sdr; the hand kernels on a
   card),
3. train the 2 stem nets,
4. re-evaluate: SI-SDR must improve,
5. export the stems to the reference's raw .dat blob format
   (core/weights.py::save_coeff_file), reload the blobs, and check that
   the reloaded nets separate a holdout mixture as the in-memory deployed
   nets do (within 1e-5).

Run: python -m spleeterrt_tpu_torch.examples.train_and_deploy [--steps 120]
     [--batch 4] [--out DIR] [--device cuda|cpu]
 or: torchrun --nproc-per-node N -m spleeterrt_tpu_torch.examples.train_and_deploy
Every rank evaluates the gathered nets; rank 0 writes the blobs and prints
a JSON log, which it writes to DIR/train_and_deploy_log.json.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from spleeterrt_tpu_torch.cli import open_device
from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.core import model, separate, train, transform, weights
from spleeterrt_tpu_torch.parallel import distributed
from spleeterrt_tpu_torch.parallel.mesh import gather_params, make_mesh
from spleeterrt_tpu_torch.utils import metrics

SR = 44100
ROUNDTRIP_MAX_ERR = 1e-5  # |separation with reloaded blobs - in memory|


class _ToneNoiseTrack:
    """Duck-typed dataset track: deterministic tone + noise stems."""

    def __init__(self, seed: int, n: int):
        self.n_frames = n
        rng = np.random.default_rng(seed)
        t = np.arange(n) / SR
        freq = rng.uniform(300, 1500)
        tone = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        noise = (0.1 * rng.standard_normal(n)).astype(np.float32)
        self._stems = np.stack(
            [np.stack([tone, tone]), np.stack([noise, noise])]
        )  # (2 stems, 2 ch, n)

    def read_crop(self, start: int, n: int):
        stems = self._stems[..., start : start + n]
        return stems.sum(axis=0), stems


class _ToneNoiseDataset:
    stem_names = ("tone", "noise")
    sample_rate = SR

    def __init__(self, seeds, n):
        self.tracks = [_ToneNoiseTrack(s, n) for s in seeds]


def make_batch(rng: np.random.Generator, cfg: SeparatorConfig, batch: int,
               device: torch.device):
    """`batch` tone + noise crops -> (mix_mag (B,T,F,2), target_mags
    (S,B,T,F,2)) on `device`, scaled by 1/fft_size as in training."""
    n = cfg.time_step * cfg.transform.hop + cfg.transform.fft_size
    t = np.arange(n) / SR
    freqs = rng.uniform(300, 1500, size=batch)
    tone = 0.4 * np.sin(2 * np.pi * freqs[:, None] * t)[:, None, :]
    noise = 0.1 * rng.standard_normal((batch, 1, n))
    tone = np.repeat(tone, 2, axis=1).astype(np.float32)
    noise = np.repeat(noise, 2, axis=1).astype(np.float32)
    mix = tone + noise

    def mags(x):
        spec = transform.stft(torch.from_numpy(x).to(device), cfg.transform, n)
        m = spec[..., : cfg.bin_limit].abs()[:, :, : cfg.time_step]
        return (m / cfg.transform.fft_size).permute(0, 2, 3, 1)

    return mags(mix), torch.stack([mags(tone), mags(noise)])


def run(steps: int, batch: int, out_dir: str, device: torch.device) -> dict:
    """The five steps above on this rank's device -> the log; raises if
    training does not improve SI-SDR or the blob round trip moves the
    separation. Brings a world-1 process group up for the call where none
    is up; in a group, every rank calls it."""
    with distributed.process_group(torch.device(device).type) as dev:
        return _run(steps, batch, out_dir, dev)


def _run(steps: int, batch: int, out_dir: str, device: torch.device) -> dict:
    # fp32 throughout: the toy corpus's loss magnitudes (~6e-4) sit at
    # bf16's rounding scale (the reference package's choice for this demo).
    cfg = SeparatorConfig(bin_limit=512, time_step=64, num_stems=2,
                          compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    holdout = _ToneNoiseDataset(seeds=(101, 102), n=8 * SR)
    world = dist.get_world_size()
    mesh = make_mesh(stem_parallel=2 if world % 2 == 0 else 1)
    log = {"device": str(device), "steps": steps, "batch": batch,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}

    nets = [model.init_params(torch.Generator().manual_seed(i)) for i in range(2)]
    stacked = weights.params_to(weights.stack_params(nets), device)
    state = train.init_train_state(stacked, 3e-4)

    before = train.evaluate_si_sdr(state.params, holdout, cfg, seconds=6.0)
    log["si_sdr_init"] = before

    state = train.shard_train_state(state, mesh, n_stems=2)
    step = train.make_sharded_train_step(mesh, compute_dtype=cfg.compute_dtype)
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        mix, targets = make_batch(rng, cfg, batch, device)
        state, loss = step(state, mix, targets)
        if i % 20 == 0 or i == steps - 1:
            losses.append(float(loss))
    log["loss_curve"] = losses
    log["train_seconds"] = time.perf_counter() - t0

    trained = gather_params(state.params, mesh)
    after = train.evaluate_si_sdr(trained, holdout, cfg, seconds=6.0)
    log["si_sdr_trained"] = after
    log["si_sdr_gain_db"] = after["mean"] - before["mean"]
    if not after["mean"] > before["mean"]:
        raise RuntimeError(f"training did not improve SI-SDR: {log}")

    # --- deploy: export .dat blobs, reload, check the same separation ---
    deployed = train.deploy_params(trained, cfg.transform.fft_size)
    blob_paths = [os.path.join(out_dir, f"{name}.dat")
                  for name in holdout.stem_names]
    if distributed.is_coordinator():
        for s, path in enumerate(blob_paths):
            weights.save_coeff_file(model.stem_params(deployed, s), path)
    dist.barrier()
    log["blobs"] = [os.path.basename(p) for p in blob_paths]
    log["blob_bytes"] = os.path.getsize(blob_paths[0])
    reloaded = weights.params_to(
        weights.stack_params([weights.load_coeff_file(p) for p in blob_paths]),
        device)

    mix, stems = holdout.tracks[0].read_crop(0, 4 * SR)
    padded = transform.pad_offline(torch.from_numpy(mix).to(device),
                                   cfg.transform).contiguous()
    with torch.no_grad():
        est_mem = separate.separate_nstem(deployed, padded, cfg, (0.0, 0.0))
        est_blob = separate.separate_nstem(reloaded, padded, cfg, (0.0, 0.0))
    roundtrip_err = float((est_mem - est_blob).abs().max())
    log["deploy_roundtrip_max_err"] = roundtrip_err
    if not roundtrip_err <= ROUNDTRIP_MAX_ERR:
        raise RuntimeError(f"blob round trip changed the separation: {log}")

    preshift, _ = transform.offline_pad_sizes(mix.shape[-1], cfg.transform)
    est = est_blob.cpu().numpy()[..., preshift : preshift + mix.shape[-1]]
    log["deployed_si_sdr_db"] = {
        name: metrics.si_sdr_db(est[i], stems[i])
        for i, name in enumerate(holdout.stem_names)
    }
    return log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    device = open_device(args.device)
    out_dir = args.out or tempfile.mkdtemp(prefix="spleeterrt_deploy_")
    os.makedirs(out_dir, exist_ok=True)
    log = run(args.steps, args.batch, out_dir, device)
    if distributed.is_coordinator():
        print(json.dumps(log, indent=1))
        with open(os.path.join(out_dir, "train_and_deploy_log.json"), "w") as f:
            json.dump(log, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
