"""Offline tracks, a closed loop with one caller: each call is one whole
track, already on the device, through the configuration's family's
`program` (Spleeter: `core/separate.py::separate`), whose stems stay on the
device.

Parameters: `track_seconds` (every track's length), `tracks` (distinct
tracks made from the seed, cycled), `warmup_calls`, `check_samples`
(answers kept for the check), `trace_seconds` (the traced window).
"""

from __future__ import annotations

import torch

from portbench import inputs, spec
from portbench.drivers import (
    SAMPLE_RATE, Sampler, closed_loop, merge_worst, stem_errors, warm_up,
)

SMALL = {"track_seconds": 3, "tracks": 2, "warmup_calls": 1, "check_samples": 2}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.p, self.dev, self.seed = cell.config, cell.params, device, seed
        self.family = spec.family(self.cfg)
        self.n = round(self.p["track_seconds"] * SAMPLE_RATE)
        self.audio_per_unit = self.n / SAMPLE_RATE
        self.replacement = None  # the control: the reference in the program's place

    def setup(self) -> None:
        gen = torch.Generator(self.dev).manual_seed(self.seed)
        self.weights = self.family.make_weights(self.cfg, gen, self.dev)
        self.program = self.family.program(self.cfg, self.weights, self.dev)
        self.tracks = inputs.tones_plus_noise(self.p["tracks"], self.n, gen, self.dev)
        self.setup_note = warm_up(self.call, self.p["warmup_calls"], self.dev)

    def call(self, i: int):
        k = i % self.tracks.shape[0]
        return k, (self.replacement or self.program)(self.tracks[k])

    def window(self, seconds: float, spans, keep: bool):
        sampler = Sampler(self.p["check_samples"], self.seed) if keep else None
        return closed_loop(self.call, seconds, self.dev, spans, sampler,
                           self.audio_per_unit)

    def unit_shapes(self) -> dict:
        """The shape variables of one call (stage formulas, useful FLOPs)."""
        return self.family.unit_shapes(self.cfg, self.n)

    def release(self) -> None:
        self.program = None

    def _reference(self, track, precision: str) -> torch.Tensor:
        from portbench import reference

        with reference.fp32_exact(), torch.no_grad():
            return self.family.reference(track, self.weights, self.cfg, precision)

    def check(self, samples) -> dict[str, float]:
        refs, worst = {}, {}
        for k, answer in samples:
            if k not in refs:
                refs[k] = [self._reference(self.tracks[k], p) for p in ("fp32", "fp8")]
            worst = merge_worst(worst, stem_errors(
                stacked(answer, self.cfg["stem_names"]), *refs[k]))
        return worst

    def use_reference(self, precision: str) -> None:
        def run(track):
            return dict(zip(self.cfg["stem_names"], self._reference(track, precision)))

        self.replacement = run


def stacked(answer: dict, names) -> torch.Tensor:
    """(stems, 2, n) in the configuration's order; a missing stem reads as
    an empty answer."""
    if set(answer) != set(names):
        return torch.empty(0)
    return torch.stack([answer[s] for s in names])
