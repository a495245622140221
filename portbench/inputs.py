"""What the benchmark makes from `--seed` and hands to both sides: the nets'
weights and the audio.

Weights follow a configuration's channel ladder: he-normal fan-in weights,
as the program's `init_params` draws them, and biases and batch norms drawn
around their identity (bias 0.1 N, scale 1 + 0.3 N, shift 0.2 N), so that a
kernel that misreads its epilogue shows in the check. They are made on the
device in two draws, one for every weight of every net and one for the
vectors, and carved into views.

Audio is tones plus noise, in float64 phase so that a 300 s track keeps its
pitch: eight partials a channel at log-uniform frequencies from 55 Hz to
8 kHz, and white noise, which reaches the bins above `bin_limit` where
the out-of-band weights act.
"""

from __future__ import annotations

import math

import torch

SAMPLE_RATE = 44100


def layer_table(cfg: dict) -> list[tuple[str, tuple[int, ...], int, bool]]:
    """(layer, weight shape, fan-in, has batch norm) of one net."""
    out = []
    enc, dec = cfg["encoder_channels"], cfg["decoder_channels"]
    for i, (cin, cout) in enumerate(enc, start=1):
        out.append((f"down{i}", (cout, cin, 5, 5), 25 * cin, i < len(enc)))
    for i, (cin, cout) in enumerate(dec, start=1):
        out.append((f"up{i}", (cin, cout, 5, 5), 25 * cin, True))
    cin, cout = cfg["final_channels"]
    out.append((f"up{len(dec) + 1}", (cout, cin, 4, 4), 16 * cin, False))
    return out


def make_nets(cfg: dict, n_nets: int, gen: torch.Generator, device) -> dict:
    """{layer: {"w", "b"[, "bn_scale", "bn_shift"]}}, each (n_nets, ...)
    float32 on `device`."""
    table = layer_table(cfg)
    sizes = [n_nets * math.prod(shape) for _, shape, _, _ in table]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    widths = [shape[1] if name.startswith("up") and bn else shape[0]
              for name, shape, _, bn in table]
    vec = torch.randn(3 * n_nets * sum(widths), generator=gen, device=device)
    nets, pos, vpos = {}, 0, 0
    for (name, shape, fan_in, bn), size, width in zip(table, sizes, widths):
        w = flat[pos : pos + size].view(n_nets, *shape)
        w.mul_(math.sqrt(2.0 / fan_in))
        pos += size
        v = vec[vpos : vpos + 3 * n_nets * width].view(3, n_nets, width)
        vpos += 3 * n_nets * width
        layer = {"w": w, "b": v[0].mul(0.1)}
        if bn:
            layer["bn_scale"] = v[1].mul(0.3).add_(1.0)
            layer["bn_shift"] = v[2].mul(0.2)
        nets[name] = layer
    return nets


def net_list(nets: dict) -> list[dict]:
    """The stacked nets as one dict a net (views)."""
    n = nets["down1"]["w"].shape[0]
    return [{ln: {fn: v[s] for fn, v in ly.items()} for ln, ly in nets.items()}
            for s in range(n)]


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
