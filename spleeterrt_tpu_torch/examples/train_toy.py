"""Toy training run: fit 2 stem nets on synthetic tone-vs-noise mixtures.

The reference package's `examples/train_toy.py`: data synthesis -> STFT
magnitudes -> the sharded train step over the process group's (stem,
data) mesh (2 stem groups where the world is even; world 1 under a plain
`python` start) -> checkpoint -> stem 0 exported to the reference's .dat
blob format.

Run: python -m spleeterrt_tpu_torch.examples.train_toy [--steps 50]
     [--batch 4] [--ckpt DIR] [--device cuda|cpu]
 or: torchrun --nproc-per-node N -m spleeterrt_tpu_torch.examples.train_toy ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from spleeterrt_tpu_torch.cli import open_device
from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.core import checkpoint, model, train, weights
from spleeterrt_tpu_torch.examples.train_and_deploy import make_batch
from spleeterrt_tpu_torch.parallel import distributed
from spleeterrt_tpu_torch.parallel.mesh import gather_params, make_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device type of the ranks (default cuda: under "
                         "torchrun, cuda:LOCAL_RANK for each rank)")
    args = ap.parse_args(argv)
    with distributed.process_group(open_device(args.device).type) as device:
        return run(args, device)


def run(args, device) -> int:
    say = print if distributed.is_coordinator() else (lambda *a, **k: None)
    cfg = SeparatorConfig(bin_limit=512, time_step=64, num_stems=2)
    rng = np.random.default_rng(0)
    nets = [model.init_params(torch.Generator().manual_seed(i)) for i in range(2)]
    stacked = weights.params_to(weights.stack_params(nets), device)
    state = train.init_train_state(stacked, 3e-4)

    world = dist.get_world_size()
    mesh = make_mesh(stem_parallel=2 if world % 2 == 0 else 1)
    state = train.shard_train_state(state, mesh, n_stems=2)
    step = train.make_sharded_train_step(mesh, compute_dtype=cfg.compute_dtype)

    say(f"training on {world} rank(s), mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    t0 = time.perf_counter()
    for i in range(args.steps):
        mix, targets = make_batch(rng, cfg, args.batch, device)
        state, loss = step(state, mix, targets)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {state.step:4d}  loss {float(loss):.5f}")
    say(f"{args.steps} steps in {time.perf_counter() - t0:.1f} s")

    if args.ckpt:
        checkpoint.save(os.path.join(args.ckpt, f"step_{state.step}"), state)
        # Export stem 0 back to the reference's raw blob format.
        p0 = model.stem_params(gather_params(state.params, mesh), 0)
        if distributed.is_coordinator():
            weights.save_coeff_file(p0, os.path.join(args.ckpt, "tone.dat"))
        say(f"saved checkpoint + blob under {args.ckpt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
