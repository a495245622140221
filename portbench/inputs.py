"""The audio the benchmark makes from `--seed` and hands to both sides (a
family's `make_weights` makes the weights, from the same generator, first).

Audio is tones plus noise, in float64 phase so that a 300 s track keeps its
pitch: eight partials a channel at log-uniform frequencies from 55 Hz to
8 kHz, and white noise, which reaches the bins above `bin_limit` where
the out-of-band weights act.
"""

from __future__ import annotations

import math

import torch

SAMPLE_RATE = 44100


def tones_plus_noise(
    n_tracks: int, n_samples: int, gen: torch.Generator, device,
    noise: float = 0.02,
) -> torch.Tensor:
    """(n_tracks, 2, n_samples) float32 in about [-1, 1]."""
    partials = 8
    u = torch.rand((n_tracks, 2, partials, 3), generator=gen, device=device,
                   dtype=torch.float64)
    freq = 55.0 * (8000.0 / 55.0) ** u[..., 0]
    amp = 0.02 + 0.1 * u[..., 1]
    phase = 2.0 * math.pi * u[..., 2]
    t = torch.arange(n_samples, device=device, dtype=torch.float64) / SAMPLE_RATE
    out = torch.zeros((n_tracks, 2, n_samples), device=device, dtype=torch.float64)
    for p in range(partials):
        out += amp[..., p, None] * torch.sin(
            2.0 * math.pi * freq[..., p, None] * t + phase[..., p, None])
    out += noise * torch.randn((n_tracks, 2, n_samples), generator=gen,
                               device=device, dtype=torch.float64)
    return out.float()
