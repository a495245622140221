"""Batched STFT / iSTFT with the reference's exact window semantics.

The reference implements the transform as a hand-unrolled 4096-point fast
Hartley transform plus Hartley<->complex unpacking (Executable/codelet.c:2,
Executable/stftFix.c:144-155). Numerically that detour is a standard real FFT
with a chain of scale factors, folded here into the windows:

- Analysis window (Executable/stftFix.c:48-57, :302-308): periodic Hann with a
  half-sample offset, `0.5 * (1 - cos(2*pi*(i+0.5)/N))`. The magnitude the
  U-Net sees is exactly `|rfft(frame * hann_offset)|`.
- Synthesis ("post") window (Executable/stftFix.c:64-75, :310-312): the same
  Hann times 2/3 for 75% overlap, giving a unity-gain mask-of-ones round trip.

Frame layout matches the reference's offline path (Executable/stftFix.c:363-495):
frames at positions 0, hop, .., rangeM where
`rangeM = ((data_size - N + hop/LAP) // hop) * hop`, and `ceil(data_size /
hop)` total rows (the excess rows stay zero). iSTFT overlap-adds all rows
(Executable/stftFix.c:496-579).

These are the plain formulations (`torch.fft`) that the fused kernels in
kernels/stft_fused.py are held against. The one exception is `irfft`, which
routes every 4096-point inverse FFT to the K8 kernel
(kernels/pallas_fft.py) as the reference's `irfft` routes it to its Pallas
kernel; on CPU tensors that is the kernel's plain torch.fft version.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import TransformConfig
from spleeterrt_tpu_torch.kernels import pallas_fft


def analysis_window(
    fft_size: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Periodic Hann with half-sample offset (Executable/stftFix.c:48-57)."""
    i = np.arange(fft_size, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * (i + 0.5) / fft_size))
    return torch.as_tensor(w, dtype=dtype, device=device)


def synthesis_window(
    cfg: TransformConfig, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Post window: Hann * 2/3 for LAP=4 (Executable/stftFix.c:64-75,310-312)."""
    return analysis_window(cfg.fft_size, dtype, device) * cfg.synthesis_gain


def num_output_frames(data_size: int, cfg: TransformConfig) -> int:
    """Rows of the spectrogram: ceil(data_size/hop) (Executable/stftFix.c:367)."""
    return -(-data_size // cfg.hop)


def num_computed_frames(data_size: int, cfg: TransformConfig) -> int:
    """Frames actually transformed; the rest stay zero (stftFix.c:377,460)."""
    hop = cfg.hop
    range_m = ((data_size - cfg.fft_size + hop // cfg.overlap) // hop) * hop
    return range_m // hop + 1


def frame_signal(
    x: torch.Tensor, cfg: TransformConfig, data_size: int
) -> torch.Tensor:
    """Slice (..., data_size) into (..., n_frames, fft_size) hop-strided frames.

    hop divides fft_size, so framing is `overlap` shifted block views
    concatenated along the window axis. Rows beyond the computed range are
    zero, matching the reference.
    """
    hop = cfg.hop
    lap = cfg.overlap
    n_out = num_output_frames(data_size, cfg)
    n_comp = num_computed_frames(data_size, cfg)
    # Blocks needed so every computed frame can read `lap` consecutive blocks.
    n_blocks = n_comp - 1 + lap
    pad = n_blocks * hop - data_size
    x = x[..., : n_blocks * hop] if pad < 0 else F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], n_blocks, hop)
    frames = torch.cat(
        [blocks[..., k : k + n_comp, :] for k in range(lap)], dim=-1
    )
    if n_out > n_comp:
        frames = F.pad(frames, (0, 0, 0, n_out - n_comp))
    return frames


def stft(x: torch.Tensor, cfg: TransformConfig, data_size: int) -> torch.Tensor:
    """STFT of (..., data_size) real audio -> (..., n_frames, num_bins) complex.

    `abs(spec)` equals the magnitude the reference feeds the U-Net
    (hypotf(re, im) * FFTSIZE, Executable/main.c:468 with the C window
    scaling folded in).
    """
    frames = frame_signal(x, cfg, data_size)
    w = analysis_window(cfg.fft_size, frames.dtype, frames.device)
    return torch.fft.rfft(frames * w, n=cfg.fft_size, dim=-1)


def overlap_add(frames: torch.Tensor, cfg: TransformConfig) -> torch.Tensor:
    """(..., n_frames, fft_size) -> (..., n_frames*hop + (fft_size-hop)).

    hop divides fft_size: output block b (of n_frames + lap - 1) sums
    frames[b - c, c*hop:(c+1)*hop] over the `lap` chunk streams c.
    """
    hop, lap = cfg.hop, cfg.overlap
    n_frames = frames.shape[-2]
    out = None
    for c in range(lap):
        part = F.pad(
            frames[..., :, c * hop : (c + 1) * hop], (0, 0, c, lap - 1 - c)
        )
        out = part if out is None else out + part
    return out.reshape(*frames.shape[:-2], (n_frames + lap - 1) * hop)


def irfft(
    spec: torch.Tensor, n: int, window: torch.Tensor | None = None
) -> torch.Tensor:
    """Inverse real FFT along the last axis, times `window` if one is given.

    n == 4096 goes to the K8 kernel (`pallas_fft.irfft4096`; its plain
    version on CPU tensors); any other n to torch.fft, where the reference
    has no kernel either."""
    if n == pallas_fft.N:
        return pallas_fft.irfft4096(spec.contiguous(), window)
    out = torch.fft.irfft(spec, n=n, dim=-1)
    return out if window is None else out * window


def istft(spec: torch.Tensor, cfg: TransformConfig) -> torch.Tensor:
    """Inverse of :func:`stft` (with masks applied in between).

    Returns (..., n_frames*hop + fft_size - hop) audio; a mask-of-ones round
    trip reproduces the input at unity gain (Executable/stftFix.c:496-579).
    """
    win = synthesis_window(cfg, torch.float32, spec.device)
    return overlap_add(irfft(spec, cfg.fft_size, win), cfg)


def offline_pad_sizes(num_pcm_frames: int, cfg: TransformConfig) -> tuple[int, int]:
    """(preshift, final_size) of the offline CLI's zero padding.

    The CLI shifts the input right by FFTSIZE zeros and pads the total to
    `FFTSIZE * ceil(n / FFTSIZE) + 2 * FFTSIZE` (Executable/main.c:762-767);
    separated stems are read back starting at sample FFTSIZE
    (Executable/main.c:806-808).
    """
    n = cfg.fft_size
    readcount = -(-num_pcm_frames // n)
    return n, n * readcount + 2 * n


def pad_offline(x: torch.Tensor, cfg: TransformConfig) -> torch.Tensor:
    """Apply the offline CLI's preshift/tail padding to (..., n) audio."""
    preshift, final_size = offline_pad_sizes(x.shape[-1], cfg)
    return F.pad(x, (preshift, final_size - preshift - x.shape[-1]))
