"""Concurrent streams, a closed loop with one caller: each call is one block
step of `runtime/stream.py::block_step_streams` over every stream, back to
back, the state carried on the device.

Block inputs are made from the seed on the device: `pool_blocks` distinct
blocks of every stream, block n of a stream is pool block n % pool_blocks.
Parameters: `streams`, `pool_blocks`, `warmup_steps` (at least the
reference's lead, so that every step of the window can be recomputed from
its inputs alone), `check_samples` (block steps kept for the check),
`check_streams` (streams of each compared), `trace_seconds`.
"""

from __future__ import annotations

import random

import torch

from portbench import inputs
from portbench.drivers import (
    SAMPLE_RATE, Sampler, closed_loop, merge_worst, require_spleeter, stem_errors,
    warm_up,
)
from portbench.families.spleeter import base_shapes, make_weights, net_list, program_config

HOP = 1024
SMALL = {"streams": 2, "pool_blocks": 3, "warmup_steps": 6, "check_samples": 1,
         "check_streams": 2}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.p, self.dev, self.seed = cell.config, cell.params, device, seed
        self.k = self.p["streams"]
        self.block_len = self.cfg["time_step"] * HOP
        self.audio_per_unit = self.k * self.block_len / SAMPLE_RATE
        self.replacement = None

    def setup(self) -> None:
        require_spleeter(self.cfg, "stream")
        from spleeterrt_tpu_torch.runtime import stream

        from portbench.reference.stream import LEAD

        if self.p["warmup_steps"] < LEAD:
            raise ValueError(f"warmup_steps must be at least {LEAD}")
        self.stream = stream
        gen = torch.Generator(self.dev).manual_seed(self.seed)
        self.nets = make_weights(self.cfg, gen, self.dev)
        self.pcfg = program_config(self.cfg)
        pool = self.p["pool_blocks"]
        self.pool = inputs.tones_plus_noise(
            pool * self.k, self.block_len, gen, self.dev).view(pool, self.k, 2, -1)
        self.state = stream.init_state_streams(self.pcfg, self.cfg["nets"], self.k,
                                               self.dev)
        self.step = 0
        self.setup_note = warm_up(self.call, self.p["warmup_steps"], self.dev)

    def call(self, i: int):
        n = self.step
        block = self.pool[n % self.pool.shape[0]]
        if self.replacement is not None:
            out = self.replacement(n)
        else:
            self.state, out = self.stream.block_step_streams(
                self.nets, self.state, block, self.pcfg, self.cfg["nets"],
                tuple(self.cfg["out_band"]))
        self.step += 1
        return n, out

    def window(self, seconds: float, spans, keep: bool):
        sampler = Sampler(self.p["check_samples"], self.seed) if keep else None
        return closed_loop(self.call, seconds, self.dev, spans, sampler,
                           self.audio_per_unit)

    def unit_shapes(self) -> dict:
        t, s, k = self.cfg["time_step"], self.cfg["nets"], self.k
        return base_shapes(self.cfg) | {
            "S": s, "K": k, "rows": 2 * k, "data_size": (t + 3) * HOP,
            "n_comp": t, "n_req": t, "tiles": k, "images": s * k,
            "irfft_frames": k * s * 2 * t, "forward_ffts": 2 * k * t,
            "inverse_ffts": k * s * 2 * t,
        }

    def release(self) -> None:
        self.state = None

    def _block_of(self, stream: int):
        return lambda i: self.pool[i % self.pool.shape[0], stream]

    def check(self, samples) -> dict[str, float]:
        from portbench import reference
        from portbench.reference import stream as ref

        nets = net_list(self.nets)
        rng = random.Random(self.seed)
        worst = {}
        with reference.fp32_exact(), torch.no_grad():
            for n, out in samples:
                for k in rng.sample(range(self.k), min(self.p["check_streams"], self.k)):
                    r = [ref.output_at(self._block_of(k), n, nets, self.cfg, p)
                         for p in ("fp32", "fp8")]
                    worst = merge_worst(worst, stem_errors(out[k], *r))
        return worst

    def use_reference(self, precision: str) -> None:
        """Block steps by the reference at `precision`, from silence a few
        blocks back as the check computes them; a stream's block is worked
        out when the check reads it."""
        from portbench import reference
        from portbench.reference import stream as ref

        nets = net_list(self.nets)
        driver = self

        class Step:
            def __init__(self, n):
                self.n = n

            def __getitem__(self, k):
                with reference.fp32_exact(), torch.no_grad():
                    return ref.output_at(driver._block_of(k), self.n, nets,
                                         driver.cfg, precision)

        self.replacement = Step
