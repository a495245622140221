"""Streaming (real-time) separation engine.

Port of the reference package's block engine
(spleeterrt_tpu/runtime/stream.py), the VST's double-buffered engine
(VST/Source/Spleeter4Stems.c) as a block-level pipeline:

- An asymmetric analysis/synthesis window pair (`getAsymmetricWindow`,
  VST/Source/Spleeter4Stems.c:383-401) with SAMPLE_SHIFT = FFT_SIZE -
  2 * OVP_SIZE: the synthesis window lives in the most recent 2 * hop
  samples of each frame.
- Per block of `time_step` hops: the outgoing block is synthesized from
  the spectra captured two blocks ago and the masks computed from those
  same spectra; the incoming block is analysed; the U-Net computes the
  masks of the block that enters the two-blocks-ago slot. Output lags
  input by exactly (2 * time_step + 1) * HOP samples, and a block's
  output depends only on the carry (tests/oracle/streaming_oracle.py
  checks this hop by hop against the C engine's semantics).

Per block on a CUDA device the kernels are one synthesis kernel
(`stream_synthesis.stream_synthesis4096`: the mask multiply, the inverse
FFTs, the synthesis window and the overlap-add), K1
(`stft_fused.stft4096`, whose window is an argument) for the analysis,
and the packed U-Net (K2, K3 x3, the mid trunk, K4, K5, K6) with the K
streams as its batch. CPU tensors take the kernels' plain versions.

The carry differs from the reference's inside: it keeps the magnitude of
the last block in K1's NCHW tiles (the next U-Net input) beside its
spectrum, and the masks in the U-Net's (S, K, 2, T, F) layout. Every
state carries the stream axis K; a single stream's state is the K = 1
state. Out-of-band bins (>= bin_limit) use the engine's fixed masks: 0.25
for drums, accompaniment and vocals, 0.0 for bass
(Spleeter4Stems.c:73,281).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from spleeterrt_tpu_torch.config import STEM_MODE_4, SeparatorConfig, require_spleeter
from spleeterrt_tpu_torch.core.model import Params, multi_stem_masks
from spleeterrt_tpu_torch.kernels import stft_fused
from spleeterrt_tpu_torch.kernels.stream_synthesis import stream_synthesis4096
from spleeterrt_tpu_torch.utils.timing import span

# Fixed engine geometry (VST/Source/Spleeter4Stems.h:1-13).
FFT_SIZE = 4096
OVP_SIZE = 1024  # analysis overlap quantum
HOP = OVP_SIZE  # OUTPUTSEG
SAMPLE_SHIFT = FFT_SIZE - 2 * OVP_SIZE  # 2048
SYNTH_LEN = FFT_SIZE - SAMPLE_SHIFT  # 2048: active synthesis region
N_BINS = FFT_SIZE // 2 + 1

RT_OUT_BAND = (0.25, 0.0, 0.25, 0.25)  # drums, bass, accompaniment, vocals


def asymmetric_windows(
    freq_temporal: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(analysis[FFT_SIZE], synthesis_eff[SYNTH_LEN]) in float64.

    Port of VST/Source/Spleeter4Stems.c:383-401 with k = FFT_SIZE,
    m = OVP_SIZE; `synthesis_eff[j]` multiplies frame sample
    SAMPLE_SHIFT + j. `freq_temporal` is the reference's
    frequency-vs-temporal-resolution exponent, clamped to 2.0 on the rising
    tail (Spleeter4Stems.c:391-394); the synthesis window divides by the
    analysis window, so the pair overlap-adds to one for every value.
    """
    k, m = FFT_SIZE, OVP_SIZE
    wa = np.zeros(k)
    n1 = 2 * (k - m) + 2
    i = np.arange(k - m)
    wa[: k - m] = (
        0.5 * (1.0 - np.cos(2.0 * np.pi * (i + 1.0) / n1))
    ) ** freq_temporal
    ft2 = min(freq_temporal, 2.0)
    n2 = 2 * m + 2
    j = np.arange(k - m, k)
    wa[k - m :] = np.sqrt(
        0.5 * (1.0 - np.cos(2.0 * np.pi * ((m + j - (k - m)) + 1.0) / n2))
    ) ** ft2
    n3 = 2 * m
    ws = np.zeros(k)
    i = np.arange(k - 2 * m, k)
    ws[k - 2 * m :] = (
        0.5 * (1.0 - np.cos(2.0 * np.pi * (i - (k - 2 * m)) / n3))
    ) / wa[k - 2 * m :]
    return wa, ws[SAMPLE_SHIFT:]


@functools.cache
def window_tensors(
    freq_temporal: float, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """`asymmetric_windows` as float32 tensors on `device`."""
    wa, ws = asymmetric_windows(freq_temporal)
    return (torch.as_tensor(wa, dtype=torch.float32, device=device),
            torch.as_tensor(ws, dtype=torch.float32, device=device))


@functools.cache
def out_band_tensor(out_band: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The out-of-band weights as a float32 tensor on `device`."""
    return torch.tensor(out_band, dtype=torch.float32, device=device)


class StreamState(NamedTuple):
    """The carry between blocks of K streams (T = time_step, S stems)."""

    in_tail: torch.Tensor  # (K, 2, FFT_SIZE - HOP) last input samples
    spec1: torch.Tensor  # (K, 2, T, N_BINS) complex64: block B-1 spectra
    mag1: torch.Tensor  # (K, 2, T, bin_limit): |spec1| below bin_limit
    spec2: torch.Tensor  # (K, 2, T, N_BINS) complex64: block B-2 spectra
    masks2: torch.Tensor  # (S, K, 2, T, bin_limit): masks for spec2
    ola_tail: torch.Tensor  # (K, S, 2, HOP) overlap-add tail across blocks


def init_state_streams(
    cfg: SeparatorConfig, n_stems: int, n_streams: int, device=None
) -> StreamState:
    """The carry before the first block of `n_streams` streams: silence,
    and masks of 1.0 (pass-through until the first inference, as the C
    engine initializes its mask buffers, Spleeter4Stems.c:456-467)."""
    require_spleeter(cfg, "the streaming engine")
    k, t, bl = n_streams, cfg.time_step, cfg.bin_limit
    zspec = torch.zeros((k, 2, t, N_BINS), dtype=torch.complex64, device=device)
    return StreamState(
        in_tail=torch.zeros((k, 2, FFT_SIZE - HOP), device=device),
        spec1=zspec,
        mag1=torch.zeros((k, 2, t, bl), device=device),
        spec2=zspec,
        masks2=torch.ones((n_stems, k, 2, t, bl), device=device),
        ola_tail=torch.zeros((k, n_stems, 2, HOP), device=device),
    )


def init_state(cfg: SeparatorConfig, n_stems: int, device=None) -> StreamState:
    """The carry of one stream (the K = 1 state)."""
    return init_state_streams(cfg, n_stems, 1, device)


def block_step_streams(
    stacked_params: Params,
    state: StreamState,
    block_in: torch.Tensor,  # (K, 2, T * HOP) float32
    cfg: SeparatorConfig,
    n_stems: int = 4,
    out_band: tuple[float, ...] = RT_OUT_BAND,
    freq_temporal: float = 1.0,
) -> tuple[StreamState, torch.Tensor]:
    """One block of K concurrent independent streams -> (new_state,
    out_block (K, S, 2, T * HOP)), the audio played while `block_in`
    arrives. All K streams' images batch through one U-Net call; stream k's
    output is that of running it alone.

    The step is one span `graph.block_step` (attribute `streams`) around
    `graph.synthesis`, `graph.analysis`, the U-Net's `model.unet` and
    `graph.state`."""
    k, t, bl = block_in.shape[0], cfg.time_step, cfg.bin_limit
    with span("graph.block_step", streams=k):
        dev = block_in.device
        wa, ws = window_tensors(freq_temporal, dev)
        if state.masks2.shape[0] != n_stems or len(out_band) != n_stems:
            raise ValueError("state, out_band and n_stems disagree on stems")

        # Synthesis of this block's output from the carry: the spectra of
        # block B-2 under their own masks, overlap-added after the tails of
        # the block before, in one kernel.
        with span("graph.synthesis"):
            out_block, ola_tail = stream_synthesis4096(
                state.spec2, state.masks2, out_band_tensor(tuple(out_band), dev),
                ws, state.ola_tail)

        # Analysis of the incoming block: frame c = ext[c*HOP : c*HOP +
        # FFT_SIZE] of each channel, through K1 with the analysis window.
        with span("graph.analysis"):
            ext = torch.cat([state.in_tail, block_in], dim=-1)  # (K, 2, (T+3) * HOP)
            spec_cur, mag_cur = stft_fused.stft4096(
                ext.reshape(2 * k, -1), wa, t, t, bl, t
            )

        # Masks for the block now entering the spec2 slot, from its own
        # magnitudes: what the C engine's background threads (started at
        # that block's boundary, joined one block later) produce.
        masks_new = multi_stem_masks(
            stacked_params, state.mag1, STEM_MODE_4, cfg.compute_dtype,
            cfg.sigmoid
        )  # (S, K, 2, T, bl)

        with span("graph.state"):
            new_state = StreamState(
                in_tail=ext[..., -(FFT_SIZE - HOP):].clone(),
                spec1=spec_cur.view(k, 2, t, N_BINS),
                mag1=mag_cur.view(k, 2, t, bl),
                spec2=state.spec1,
                masks2=masks_new,
                ola_tail=ola_tail,
            )
        return new_state, out_block


def block_step(
    stacked_params: Params,
    state: StreamState,  # a K = 1 state
    block_in: torch.Tensor,  # (2, T * HOP)
    cfg: SeparatorConfig,
    n_stems: int = 4,
    out_band: tuple[float, ...] = RT_OUT_BAND,
    freq_temporal: float = 1.0,
) -> tuple[StreamState, torch.Tensor]:
    """One block of one stream -> (new_state, out_block (S, 2, T * HOP)).

    `out_block` is the audio played while `block_in` arrives; it depends
    only on the carry, which keeps the C engine's causality and two-block
    latency."""
    new_state, out = block_step_streams(
        stacked_params, state, block_in[None], cfg, n_stems, out_band,
        freq_temporal,
    )
    return new_state, out[0]


def stream_scan(
    stacked_params: Params,
    audio: torch.Tensor,  # (2, n) float32
    cfg: SeparatorConfig,
    n_stems: int = 4,
    out_band: tuple[float, ...] = RT_OUT_BAND,
    freq_temporal: float = 1.0,
) -> torch.Tensor:
    """Run the whole blocks of a signal through the engine, one after the
    other -> (S, 2, n_blocks * T * HOP). Output sample i corresponds to
    input sample i - (2 * time_step + 1) * HOP."""
    block_len = cfg.time_step * HOP
    n_blocks = audio.shape[-1] // block_len
    state = init_state(cfg, n_stems, audio.device)
    outs = []
    for b in range(n_blocks):
        state, out = block_step(
            stacked_params, state, audio[:, b * block_len : (b + 1) * block_len],
            cfg, n_stems, out_band, freq_temporal,
        )
        outs.append(out)
    if not outs:
        return torch.zeros((n_stems, 2, 0), device=audio.device)
    return torch.cat(outs, dim=-1)


class StreamingSeparator:
    """Sample-granular push API mirroring `Spleeter4StemsProcessSamples`
    (VST/Source/Spleeter4Stems.c:512-582): feed chunks of any size, get the
    same number of output samples per stem back. Host-side buffering; the
    DSP runs on the device of `stacked_params`, one block step per block,
    with one copy of the block's output back to the host.

    The first block of output is silence played while the first input block
    fills, so output lags input by one block more than `stream_scan`'s:
    (3 * time_step + 1) * HOP samples, as in the reference's push API.
    """

    def __init__(
        self,
        stacked_params: Params,
        cfg: SeparatorConfig,
        n_stems: int = 4,
        out_band: tuple[float, ...] = RT_OUT_BAND,
        freq_temporal: float = 1.0,
    ):
        self.params = stacked_params
        self.cfg = cfg
        self.n_stems = n_stems
        self.out_band = out_band
        self.freq_temporal = freq_temporal
        self.device = stacked_params["up7"]["w"].device
        self.state = init_state(cfg, n_stems, self.device)
        self.block_len = cfg.time_step * HOP
        self._in_buf = np.zeros((2, 0), np.float32)
        self._out_buf = np.zeros((n_stems, 2, self.block_len), np.float32)
        self._out_pos = 0

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """(2, n) or (n,) in -> (S, 2, n) out, delayed by the latency."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 1:
            chunk = np.stack([chunk, chunk])
        n = chunk.shape[-1]
        self._in_buf = np.concatenate([self._in_buf, chunk], axis=-1)
        out = np.zeros((self.n_stems, 2, n), np.float32)
        produced = 0
        while produced < n:
            avail = self._out_buf.shape[-1] - self._out_pos
            if avail == 0:
                if self._in_buf.shape[-1] < self.block_len:
                    break  # the next block has not arrived yet
                block = torch.from_numpy(
                    np.ascontiguousarray(self._in_buf[:, : self.block_len])
                ).to(self.device)
                self._in_buf = self._in_buf[:, self.block_len :]
                self.state, out_block = block_step(
                    self.params, self.state, block, self.cfg, self.n_stems,
                    self.out_band, self.freq_temporal,
                )
                self._out_buf = out_block.cpu().numpy()
                self._out_pos = 0
                avail = self._out_buf.shape[-1]
            take = min(avail, n - produced)
            out[..., produced : produced + take] = self._out_buf[
                ..., self._out_pos : self._out_pos + take
            ]
            self._out_pos += take
            produced += take
        return out
