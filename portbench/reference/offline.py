"""Offline separation in plain float32 PyTorch: the reference of the
`track` and `clips` cells.

Written from SpleeterRT's offline CLI (Executable/main.c:444-674, 762-808,
Executable/stftFix.c:48-75, 363-579), independent of the program under
test:

- the input is shifted right by FFT zeros and padded to FFT * ceil(n / FFT)
  + 2 FFT samples; the stems are read back from sample FFT on;
- frames at 0, hop, .., ((size - FFT + hop / 4) // hop) * hop, the rest of
  ceil(size / hop) rows zero; analysis window 0.5 (1 - cos(2 pi (i + 0.5)
  / FFT)); real FFT;
- the U-Net sees |spectrum| below `bin_limit`, cut into tiles of
  `time_step` frames (the last one zero-padded), one image of 2 channels a
  tile;
- each net's mask scales the complex bins below `bin_limit`; the bins
  from there on take the stem's out-of-band weight;
- inverse real FFT (imaginary parts of DC and Nyquist dropped), times the
  synthesis window (the analysis window * 2 / 3), overlap-added at the
  hop;
- 2 stems: the accompaniment is the padded input minus the vocals in the
  time domain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import unet


def analysis_window(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 * (1.0 - torch.cos(2.0 * math.pi * (i + 0.5) / n))).float()


def frame_counts(size: int, fft: int, hop: int) -> tuple[int, int]:
    """(rows of the spectrum, frames computed)."""
    n_out = -(-size // hop)
    n_comp = ((size - fft + hop // 4) // hop) + 1
    return n_out, n_comp


def stft(x: torch.Tensor, fft: int, hop: int) -> torch.Tensor:
    """(C, size) -> (C, n_out, fft / 2 + 1) complex64."""
    size = x.shape[-1]
    n_out, n_comp = frame_counts(size, fft, hop)
    need = (n_comp - 1) * hop + fft
    x = F.pad(x, (0, max(0, need - size)))[:, :need]
    frames = x.unfold(-1, fft, hop)
    spec = torch.fft.rfft(frames * analysis_window(fft, x.device), n=fft, dim=-1)
    return F.pad(spec, (0, 0, 0, n_out - n_comp))


def istft(spec: torch.Tensor, fft: int, hop: int, gain: float) -> torch.Tensor:
    """(..., n_frames, fft / 2 + 1) -> (..., n_frames * hop + fft - hop)."""
    spec = spec.clone()
    spec[..., 0].imag.zero_()
    spec[..., -1].imag.zero_()
    frames = torch.fft.irfft(spec, n=fft, dim=-1) * (
        analysis_window(fft, spec.device) * gain)
    n_frames, lap = frames.shape[-2], fft // hop
    out = torch.zeros((*frames.shape[:-2], (n_frames + lap - 1) * hop),
                      device=frames.device)
    for c in range(lap):
        part = frames[..., c * hop : (c + 1) * hop].flatten(-2)
        out[..., c * hop : c * hop + part.shape[-1]] += part
    return out


def tiles(spec: torch.Tensor, bin_limit: int, time_step: int) -> torch.Tensor:
    """(2, n_frames, bins) -> magnitude images (n_tiles, 2, T, bin_limit)."""
    c, n_frames, _ = spec.shape
    nt = max(1, -(-n_frames // time_step))
    mag = F.pad(spec[..., :bin_limit].abs(), (0, 0, 0, nt * time_step - n_frames))
    return mag.reshape(c, nt, time_step, bin_limit).transpose(0, 1)


def tile_frames(m: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(n_tiles, 2, T, F) -> (2, n_frames, F)."""
    nt, c, t, f = m.shape
    return m.transpose(0, 1).reshape(c, nt * t, f)[:, :n_frames]


def separate(
    audio: torch.Tensor,  # (2, n) float32
    nets: list[dict],
    cfg: dict,
    precision: str = "fp32",
) -> torch.Tensor:
    """-> (stems, 2, n) float32 in the configuration's stem order.

    `cfg` is a configuration file of portbench/configs/: fft_size, hop,
    bin_limit, time_step, synthesis_gain, enc_act, dec_act, out_band (one
    weight a net) and residual (the 2-stem accompaniment)."""
    fft, hop = cfg["fft_size"], cfg["hop"]
    n = audio.shape[-1]
    size = fft * -(-n // fft) + 2 * fft
    padded = F.pad(audio.float(), (fft, size - fft - n))
    spec = stft(padded, fft, hop)
    images = tiles(spec, cfg["bin_limit"], cfg["time_step"])
    bl = cfg["bin_limit"]
    stems = []
    for net, weight in zip(nets, cfg["out_band"]):
        m = tile_frames(unet.masks(net, images, cfg["enc_act"], cfg["dec_act"],
                                   precision), spec.shape[1])
        masked = torch.cat([spec[..., :bl] * m, spec[..., bl:] * weight], -1)
        stems.append(istft(masked, fft, hop, cfg["synthesis_gain"]))
    if cfg.get("residual"):
        stems.append(F.pad(padded, (0, stems[0].shape[-1] - size)) - stems[0])
    return torch.stack(stems)[..., fft : fft + n]
