"""The streaming engine of one stream in plain float32 PyTorch: the
reference of the `streams` cells.

Written from SpleeterRT's VST engine (VST/Source/Spleeter4Stems.c:383-401
for the windows, :456-582 for the double-buffered blocks), independent of
the program under test. FFT 4096, hop 1024, blocks of `time_step` hops:

- the asymmetric analysis window (rising Hann over the first FFT - hop
  samples, a square-root Hann fall over the last hop) and the synthesis
  window (a Hann over the last 2 hop samples, divided by the analysis
  window), which lives in the most recent 2 hop samples of a frame;
- per block: the output is synthesised from the spectra of the block two
  back under the masks computed from those same spectra (each stem's mask
  below `bin_limit`, its out-of-band weight above), inverse real FFT, the
  windowed last 2 hop samples of each frame overlap-added at the hop with
  the tail carried from the block before; the incoming block is analysed
  (frame c is the last FFT - hop input samples and the block, from c hop
  on); the nets compute the masks of the block one back.

A block's output depends on the blocks two, three and (its last FFT - hop
samples) four back, so `output_at` restarts the engine from silence a
few blocks earlier and gives the output of any block of a stream.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import unet

FFT = 4096
HOP = 1024
SHIFT = FFT - 2 * HOP  # the synthesis window's start within a frame
# Blocks before the one compared that `output_at` runs from silence: its
# output reads the blocks 2, 3 and 4 back; two more for margin.
LEAD = 6


def windows(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(analysis (FFT,), synthesis (2 HOP,)) float32, from float64."""
    k, m = FFT, HOP
    wa = torch.zeros(k, dtype=torch.float64)
    i = torch.arange(k - m, dtype=torch.float64)
    wa[: k - m] = 0.5 * (1.0 - torch.cos(2.0 * math.pi * (i + 1.0) / (2 * (k - m) + 2)))
    j = torch.arange(m, dtype=torch.float64)
    wa[k - m :] = torch.sqrt(0.5 * (1.0 - torch.cos(
        2.0 * math.pi * (m + j + 1.0) / (2 * m + 2))))
    i = torch.arange(2 * m, dtype=torch.float64)
    ws = 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / (2 * m))) / wa[k - 2 * m :]
    return wa.float().to(device), ws.float().to(device)


def run(
    blocks: list[torch.Tensor],  # each (2, T * HOP) float32
    nets: list[dict],
    cfg: dict,
    precision: str = "fp32",
) -> list[torch.Tensor]:
    """The engine from silence over `blocks` -> each block's output (stems,
    2, T * HOP)."""
    dev = blocks[0].device
    t, bl = cfg["time_step"], cfg["bin_limit"]
    n_bins = FFT // 2 + 1
    s = len(nets)
    wa, ws = windows(dev)
    out_band = torch.tensor(cfg["out_band"], device=dev)[:, None, None, None]
    in_tail = torch.zeros((2, FFT - HOP), device=dev)
    spec1 = spec2 = torch.zeros((2, t, n_bins), dtype=torch.complex64, device=dev)
    mag1 = torch.zeros((2, t, bl), device=dev)
    masks2 = torch.ones((s, 2, t, bl), device=dev)
    ola = torch.zeros((s, 2, HOP), device=dev)
    outs = []
    for block in blocks:
        masked = torch.cat([spec2[..., :bl] * masks2, spec2[..., bl:] * out_band], -1)
        masked[..., 0].imag.zero_()
        masked[..., -1].imag.zero_()
        tails = torch.fft.irfft(masked, n=FFT, dim=-1)[..., SHIFT:] * ws
        prevs = torch.cat([ola[:, :, None], tails[..., :-1, HOP:]], dim=2)
        outs.append((tails[..., :HOP] + prevs).flatten(-2))
        ola = tails[..., -1, HOP:]

        ext = torch.cat([in_tail, block.float()], -1)
        frames = ext.unfold(-1, FFT, HOP)[:, :t]
        spec_cur = torch.fft.rfft(frames * wa, n=FFT, dim=-1)
        masks_new = torch.stack([
            unet.forward(net, mag1[None], cfg["enc_act"], cfg["dec_act"], precision)[0]
            for net in nets
        ])
        in_tail = ext[:, -(FFT - HOP):]
        spec2, spec1 = spec1, spec_cur
        mag1 = spec_cur[..., :bl].abs()
        masks2 = masks_new
    return outs


def output_at(
    block_of, n: int, nets: list[dict], cfg: dict, precision: str = "fp32",
) -> torch.Tensor:
    """The output (stems, 2, T * HOP) of block n of one stream whose block
    i is `block_of(i)` (2, T * HOP): the engine from silence over blocks n -
    LEAD .. n (blocks before 0 are silence)."""
    first = block_of(max(n, 0))
    blocks = [block_of(i) if i >= 0 else torch.zeros_like(first)
              for i in range(n - LEAD, n + 1)]
    return run(blocks, nets, cfg, precision)[-1]
