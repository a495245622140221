"""Offline tracks, a closed loop with one caller: each call is one whole
track, already on the device, through `core/separate.py::separate`, whose
stems stay on the device.

Parameters: `track_seconds` (every track's length), `tracks` (distinct
tracks made from the seed, cycled), `warmup_calls`, `check_samples`
(answers kept for the check), `trace_seconds` (the traced window).
"""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.drivers import (
    SAMPLE_RATE, Sampler, base_shapes, closed_loop, merge_worst, net_kwargs,
    program_config, stem_errors, warm_up,
)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.p, self.dev, self.seed = cell.config, cell.params, device, seed
        self.n = round(self.p["track_seconds"] * SAMPLE_RATE)
        self.audio_per_unit = self.n / SAMPLE_RATE
        self.replacement = None  # the control: the reference in the program's place

    def setup(self) -> None:
        from spleeterrt_tpu_torch.core import separate

        self.separate = separate
        gen = torch.Generator(self.dev).manual_seed(self.seed)
        self.nets = inputs.make_nets(self.cfg, self.cfg["nets"], gen, self.dev)
        self.kwargs = net_kwargs(self.cfg, self.nets)
        self.pcfg = program_config(self.cfg)
        self.tracks = inputs.tones_plus_noise(self.p["tracks"], self.n, gen, self.dev)
        self.setup_note = warm_up(self.call, self.p["warmup_calls"], self.dev)

    def call(self, i: int):
        k = i % self.tracks.shape[0]
        if self.replacement is not None:
            return k, self.replacement(self.tracks[k])
        return k, self.separate.separate(self.tracks[k], cfg=self.pcfg,
                                         device=self.dev, **self.kwargs)

    def window(self, seconds: float, spans, keep: bool):
        sampler = Sampler(self.p["check_samples"], self.seed) if keep else None
        return closed_loop(self.call, seconds, self.dev, spans, sampler,
                           self.audio_per_unit)

    def unit_shapes(self) -> dict:
        """The shape variables of one call (stage formulas, useful FLOPs)."""
        fft, hop, t = self.cfg["fft_size"], self.cfg["hop"], self.cfg["time_step"]
        size = fft * -(-self.n // fft) + 2 * fft
        n_out = -(-size // hop)
        n_comp = (size - fft + hop // 4) // hop + 1
        tiles = -(-n_out // t)
        s = self.cfg["nets"]
        return base_shapes(self.cfg) | {
            "S": s, "rows": 2, "data_size": size, "n_comp": n_comp,
            "n_req": tiles * t, "tiles": tiles, "images": s * tiles,
            "istft_frames": n_out, "forward_ffts": 2 * n_comp,
            "inverse_ffts": s * 2 * n_out,
        }

    def release(self) -> None:
        self.kwargs = None

    def check(self, samples) -> dict[str, float]:
        from portbench import reference
        from portbench.reference import offline

        nets = inputs.net_list(self.nets)
        refs, worst = {}, {}
        with reference.fp32_exact(), torch.no_grad():
            for k, answer in samples:
                if k not in refs:
                    refs[k] = [offline.separate(self.tracks[k], nets, self.cfg, p)
                               for p in ("fp32", "fp8")]
                worst = merge_worst(worst, stem_errors(
                    stacked(answer, self.cfg["stem_names"]), *refs[k]))
        return worst

    def use_reference(self, precision: str) -> None:
        from portbench import reference
        from portbench.reference import offline

        nets = inputs.net_list(self.nets)

        def run(track):
            with reference.fp32_exact(), torch.no_grad():
                stems = offline.separate(track, nets, self.cfg, precision)
            return dict(zip(self.cfg["stem_names"], stems))

        self.replacement = run


def stacked(answer: dict, names) -> torch.Tensor:
    """(stems, 2, n) in the configuration's order; a missing stem reads as
    an empty answer."""
    if set(answer) != set(names):
        return torch.empty(0)
    return torch.stack([answer[s] for s in names])

