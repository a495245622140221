"""Chunked offline executor for arbitrarily long tracks.

The port of spleeterrt_tpu/runtime/executor.py. The reference's offline
loop holds the whole track's spectrogram in RAM (Executable/stftFix.c:
367-371), fine for songs, not for hours of audio on a card of fixed
memory. This executor runs the 4-stem graph over chunks of `chunk_tiles`
whole timeStep tiles, so device memory is bounded by the chunk, not the
track. Each chunk reads an analysis lookahead of FFT - HOP samples past
its end and yields its audio plus an overlap-add tail of the same length,
which is added to the next chunk's head on the device.

Each chunk runs the port's graph, not a canonical re-statement:

- hop 1024: K1 over the chunk (its own count of computed frames), the
  U-Net over the chunk's tiles (any route), K7 with n_frames = the
  chunk's frames, whose output is the chunk plus its 3072-sample tail;
- another hop of a 4096-point FFT: framing with the global zeroing, the
  U-Net, K9 and the overlap-add (`separate_nstem`'s non-fused branch);
- another FFT size: the canonical graph, one inverse transform a stem.

Tile boundaries and frame zeroing use global frame indices, so the
result equals the monolithic `separate.separate` up to the order of the
overlap-add's sums at chunk seams. Finished chunks go to the host with
one chunk in flight: chunk k's copy is waited on only after chunk k + 1
is queued, the overlap the reference package gets from async dispatch.
"""

from __future__ import annotations

import numpy as np
import torch

from spleeterrt_tpu_torch.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import separate, transform
from spleeterrt_tpu_torch.core.model import Params, multi_stem_masks, num_stems
from spleeterrt_tpu_torch.kernels import pallas_fft, stft_fused


def _chunk_frames(
    ext: torch.Tensor, cfg: SeparatorConfig, n_frames: int, first_frame: int,
    n_comp: int,
) -> torch.Tensor:
    """(2, n_frames * hop + fft - hop) -> frames (2, n_frames, fft); frames
    at global index >= n_comp are zero, as in the monolithic graph."""
    tcfg = cfg.transform
    blocks = ext.reshape(ext.shape[0], n_frames + tcfg.overlap - 1, tcfg.hop)
    frames = torch.cat(
        [blocks[:, k : k + n_frames] for k in range(tcfg.overlap)], dim=-1
    )
    live = max(0, min(n_frames, n_comp - first_frame))
    frames[:, live:] = 0
    return frames


def chunk_step(
    stacked_params: Params,
    ext: torch.Tensor,  # (2, n_frames * hop + fft - hop): chunk + lookahead
    first_frame: int,  # global index of the chunk's first frame
    n_comp: int,  # global computed-frame count
    cfg: SeparatorConfig,
    n_frames: int,  # frames in the chunk, whole tiles
    out_band: torch.Tensor,  # (S,) float32
) -> torch.Tensor:
    """One chunk -> (S, 2, n_frames * hop + fft - hop): its audio, then the
    overlap-add tail that belongs to the next chunk's head."""
    tcfg = cfg.transform
    dev = ext.device
    t, bl = cfg.time_step, cfg.bin_limit
    swin = transform.synthesis_window(tcfg, device=dev)
    if separate.fused_transform(cfg):
        n_comp_chunk = min(n_comp - first_frame, n_frames)
        if n_comp_chunk < 1:
            raise ValueError(
                f"chunk at frame {first_frame} holds no computed frame (n_comp "
                f"{n_comp}); time_step ({t}) must be a multiple of 4"
            )
        spec, mag = separate.fused_stft(ext, cfg, n_comp_chunk, n_frames)
        masks = multi_stem_masks(stacked_params, mag, STEM_MODE_4,
                                 cfg.compute_dtype, cfg.sigmoid)
        return stft_fused.masked_istft4096(spec, masks, out_band, swin, n_frames)
    frames = _chunk_frames(ext, cfg, n_frames, first_frame, n_comp)
    wa = transform.analysis_window(tcfg.fft_size, device=dev)
    spec = torch.fft.rfft(frames * wa, n=tcfg.fft_size, dim=-1)
    nt = n_frames // t
    mag = spec[..., :bl].abs().reshape(2, nt, t, bl).transpose(0, 1).contiguous()
    masks = multi_stem_masks(stacked_params, mag, STEM_MODE_4,
                             cfg.compute_dtype, cfg.sigmoid)  # (S, nt, 2, T, F)
    masks = masks.transpose(1, 2).reshape(masks.shape[0], 2, n_frames, bl)
    if tcfg.fft_size == pallas_fft.N:
        y = pallas_fft.masked_irfft4096(spec, masks, out_band, bl, swin)
    else:
        oob = spec[..., bl:] * out_band[:, None, None, None]
        y = transform.irfft(torch.cat([spec[..., :bl] * masks, oob], dim=-1),
                            tcfg.fft_size, swin)
    return transform.overlap_add(y, tcfg)


def separate_4stem_chunked(
    stacked_params: Params,
    audio,  # (2, n) float32 at 44.1 kHz, array or tensor
    cfg: SeparatorConfig,
    chunk_tiles: int = 8,
    out_band: tuple[float, ...] = separate.OUT_BAND_4,
) -> np.ndarray:
    """Bounded-memory 4-stem separation; equals the monolithic graph.

    `chunk_tiles` timeStep tiles per chunk (peak device memory grows with
    it). The nets' device is the device the chunks run on. Returns (S, 2,
    n) float32 on the host."""
    tcfg = cfg.transform
    hop = tcfg.hop
    halo = tcfg.fft_size - hop
    audio = np.asarray(audio, np.float32)
    n = audio.shape[-1]
    preshift, final_size = transform.offline_pad_sizes(n, tcfg)
    n_comp = transform.num_computed_frames(final_size, tcfg)
    n_frames = chunk_tiles * cfg.time_step
    chunk_len = n_frames * hop
    total_frames = -(-final_size // hop)
    n_chunks = -(-total_frames // n_frames)

    padded = np.zeros((2, n_chunks * chunk_len + halo), np.float32)
    padded[:, preshift : preshift + n] = audio[:, :n]
    dev = stacked_params["up7"]["w"].device
    ob = transform.out_band_tensor(out_band, dev)
    out = np.zeros((num_stems(stacked_params), 2, n_chunks * chunk_len + halo),
                   np.float32)
    pending = None  # (offset, host tensor, event) of the chunk in flight
    carry = None  # the last chunk's tail, on the device
    for k in range(n_chunks):
        at = k * chunk_len
        ext = torch.from_numpy(
            np.ascontiguousarray(padded[:, at : at + chunk_len + halo])).to(dev)
        y = chunk_step(stacked_params, ext, k * n_frames, n_comp, cfg,
                       n_frames, ob)
        if carry is not None:
            y[..., :halo] += carry
        carry = y[..., chunk_len:]
        copy = _to_host(y[..., :chunk_len])
        if pending is not None:
            _land(out, *pending)
        pending = (at, *copy)
    _land(out, *pending)
    out[..., n_chunks * chunk_len :] = carry.cpu().numpy()
    return out[..., preshift : preshift + n]


def _to_host(x: torch.Tensor):
    """Start copying x to the host -> (host tensor, event or None)."""
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    return host, event


def _land(out: np.ndarray, at: int, host: torch.Tensor, event) -> None:
    """Wait for a chunk's copy and write it into `out` at sample `at`."""
    if event is not None:
        event.synchronize()
    out[..., at : at + host.shape[-1]] = host.numpy()
