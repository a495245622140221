"""The separation pipeline: offline 4-stem graph.

Reference: the offline frame-block loop `processMT`
(Executable/main.c:444-674) and the VST's 4-stem graph
(VST/Source/Spleeter4Stems.c:114-147). The C code tiles the spectrogram into
`timeStep`-frame windows; here every tile is one row of a batch axis and
each stem's U-Net runs once over all tiles.

Dataflow of `separate_nstem` at the reference's transform (FFT 4096, hop
1024; the reference package's fused graph,
spleeterrt_tpu/core/separate.py::_separate_nstem_fused): one fused STFT
kernel writes the complex spectrum and the U-Net's magnitude tiles; the
U-Net emits per-stem masks; one fused masked iSTFT kernel emits
overlap-added audio for every stem. At any other hop of a 4096-point FFT
(in practice `TransformConfig(overlap=2)`) it is the reference's
non-fused branch: a plain torch.fft STFT, the U-Net, the masked inverse
FFT kernel K9 with frames out, and a plain overlap-add.

Scale conventions: with core/transform.py's windows, `abs(stft(x))` equals
the `hypotf(re, im) * FFTSIZE` magnitude the C code computes
(Executable/main.c:468), and masks multiply the complex spectrogram exactly
as the in-place `re *= mask; im *= mask` loops (Executable/main.c:473-494).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.core.model import (
    Params,
    multi_stem_forward,
    multi_stem_masks,
)
from spleeterrt_tpu_torch.kernels import pallas_fft, stft_fused

# Out-of-band weights of the 4-stem family: the RT engine fixes 0.25 for
# every stem except bass at 0.0 (VST/Source/Spleeter4Stems.c:73,281).
OUT_BAND_4 = (0.25, 0.0, 0.25, 0.25)  # drums, bass, accompaniment, vocals

_NOT_PORTED = (
    "{} is not ported to the PyTorch package yet; see ROADMAP.md "
    "(the reference package spleeterrt_tpu has it)"
)


def num_tiles(n_frames: int, time_step: int) -> int:
    """ceil; the reference always runs one (possibly zero-padded) tail tile
    (Executable/main.c:496-537)."""
    return max(1, -(-n_frames // time_step))


def spec_to_tiles(spec: torch.Tensor, cfg: SeparatorConfig) -> torch.Tensor:
    """(2, n_frames, n_bins) complex -> magnitude tiles (n_tiles, T, binL, 2).

    Tail frames are zero-padded to a full tile (Executable/main.c:507-514).
    """
    n_frames = spec.shape[-2]
    t = cfg.time_step
    nt = num_tiles(n_frames, t)
    mag = F.pad(spec[..., : cfg.bin_limit].abs(), (0, 0, 0, nt * t - n_frames))
    return mag.reshape(2, nt, t, cfg.bin_limit).permute(1, 2, 3, 0)


def tiles_to_frames(tiles: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(n_tiles, T, F, 2) -> (2, n_frames, F), dropping tail padding."""
    nt, t, f, _ = tiles.shape
    return tiles.permute(3, 0, 1, 2).reshape(2, nt * t, f)[:, :n_frames]


def apply_mask(
    spec: torch.Tensor, mask_frames: torch.Tensor, cfg: SeparatorConfig,
    unaffected_weight: float | None = None,
) -> torch.Tensor:
    """Multiply complex spec by a per-bin real mask; out-of-band bins get
    `unaffected_weight` (Executable/main.c:473-494)."""
    uw = cfg.unaffected_weight if unaffected_weight is None else unaffected_weight
    in_band = spec[..., : cfg.bin_limit] * mask_frames.to(spec.real.dtype)
    return torch.cat([in_band, spec[..., cfg.bin_limit :] * uw], dim=-1)


def compute_masks_multi(
    stacked_params: Params, spec: torch.Tensor, cfg: SeparatorConfig,
    stem_mode: int,
) -> torch.Tensor:
    """S stacked nets -> (S, 2, n_frames, bin_limit)."""
    masks = multi_stem_forward(
        stacked_params, spec_to_tiles(spec, cfg), stem_mode, cfg.compute_dtype,
        cfg.sigmoid,
    )
    return torch.stack([tiles_to_frames(m, spec.shape[-2]) for m in masks])


def separate_nstem(
    stacked_params: Params,
    audio: torch.Tensor,  # (2, data_size) pre-padded, see transform.pad_offline
    cfg: SeparatorConfig,
    out_band: tuple[float, ...],
) -> torch.Tensor:
    """S independent nets over the same input, one mask per stem -> stems
    (S, 2ch, out_len) with out_len = n_frames * hop + fft_size - hop >=
    data_size.

    Tensors on a CUDA device run the kernels; CPU tensors run their plain
    versions (kernels/stft_fused.py, kernels/pallas_fft.py)."""
    tcfg = cfg.transform
    if tcfg.fft_size != stft_fused.N:
        raise NotImplementedError(
            _NOT_PORTED.format("a transform other than FFT 4096")
        )
    data_size = audio.shape[-1]
    dev = audio.device
    out_band_t = torch.tensor(out_band, dtype=torch.float32, device=dev)
    if tcfg.hop != stft_fused.HOP:
        spec = transform.stft(audio, tcfg, data_size)
        masks = compute_masks_multi(stacked_params, spec, cfg, STEM_MODE_4)
        frames = pallas_fft.masked_irfft4096(
            spec, masks, out_band_t, cfg.bin_limit,
            transform.synthesis_window(tcfg, device=dev),
        )
        return transform.overlap_add(frames, tcfg)
    n_out = transform.num_output_frames(data_size, tcfg)
    n_comp = transform.num_computed_frames(data_size, tcfg)
    n_req = num_tiles(n_out, cfg.time_step) * cfg.time_step

    spec, mag = stft_fused.stft4096(
        audio, transform.analysis_window(tcfg.fft_size, device=dev), n_comp,
        n_req, cfg.bin_limit, cfg.time_step,
    )
    masks = multi_stem_masks(
        stacked_params, mag, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
    )  # (S, n_tiles, 2, T, F)
    return stft_fused.masked_istft4096(
        spec, masks, out_band_t, transform.synthesis_window(tcfg, device=dev),
        n_out,
    )


def separate_4stem(
    stacked_params: Params, audio: torch.Tensor, cfg: SeparatorConfig
) -> torch.Tensor:
    """4-stem graph ordered (drums, bass, accompaniment, vocals)."""
    return separate_nstem(stacked_params, audio, cfg, OUT_BAND_4)


def check_ported(cfg: SeparatorConfig) -> None:
    """Raise NotImplementedError for stem counts this package lacks."""
    if cfg.num_stems != 4:
        raise NotImplementedError(
            _NOT_PORTED.format(f"{cfg.num_stems}-stem separation")
        )


def separate(
    audio,
    *,
    stacked_params: Params,
    cfg: SeparatorConfig,
    device: torch.device | str = "cuda",
) -> dict[str, torch.Tensor]:
    """High-level entry: pad, run the stem graph for cfg.num_stems, crop.

    `audio` is (2, n) or (n,) float32 at 44.1 kHz (array or tensor);
    `stacked_params` must already live on `device`. Returns
    {stem_name: (2, n) tensor on `device`}.
    """
    check_ported(cfg)
    audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
    if audio.ndim == 1:
        audio = torch.stack([audio, audio])
    n = audio.shape[-1]
    preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    stems = separate_4stem(stacked_params, padded, cfg)
    cropped = stems[..., preshift : preshift + n]
    return dict(zip(cfg.stem_names, cropped))
