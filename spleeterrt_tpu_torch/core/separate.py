"""The separation pipeline: offline 2-, 3-, 4- and 5-stem graphs.

Reference: the offline frame-block loop `processMT`
(Executable/main.c:444-674), the stem arithmetic of the exe's `main`
(Executable/main.c:779-970) and the VST's 4-stem graph
(VST/Source/Spleeter4Stems.c:114-147). The C code tiles the spectrogram into
`timeStep`-frame windows; here every tile is one row of a batch axis and
each stem's U-Net runs once over all tiles.

The 2-stem graph masks vocals and takes the accompaniment as the input
minus the vocals in the time domain; the 3-stem graph is the exe's two
passes (a 4-stem-family net masks drums, the 2-stem net masks vocals in
the frequency-domain residual), fused at hop 1024 into one STFT and one
masked iSTFT as the reference package fuses it (`separate_3stem`); 4 and 5
stems are `separate_nstem` with one net per stem.

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

from spleeterrt_tpu_torch.config import STEM_MODE_2, STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.core.model import (
    Params,
    multi_stem_forward,
    multi_stem_masks,
    unet_forward,
    with_stem_axis,
)
from spleeterrt_tpu_torch.kernels import pallas_fft, stft_fused

# Out-of-band weights per stem family: the RT engine fixes 0.25 for every
# stem except bass at 0.0 (VST/Source/Spleeter4Stems.c:73,281).
OUT_BAND_4 = (0.25, 0.0, 0.25, 0.25)  # drums, bass, accompaniment, vocals
OUT_BAND_5 = (0.25, 0.25, 0.0, 0.25, 0.25)  # vocals, drums, bass, piano, other

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


def compute_masks(
    params: Params, spec: torch.Tensor, cfg: SeparatorConfig, stem_mode: int,
) -> torch.Tensor:
    """Single-net masks for every frame: (2, n_frames, bin_limit)."""
    masks = unet_forward(params, spec_to_tiles(spec, cfg), stem_mode,
                         cfg.compute_dtype, cfg.sigmoid)
    return tiles_to_frames(masks, spec.shape[-2])


def single_net_masks(
    params: Params, mag: torch.Tensor, cfg: SeparatorConfig, stem_mode: int,
) -> torch.Tensor:
    """One net over NCHW magnitude tiles (n_tiles, 2, T, F) -> masks (1,
    n_tiles, 2, T, F) float32, the masked iSTFT's layout, whichever route
    the U-Net takes (the reference's `_masks_cd_tracks` for one track)."""
    return multi_stem_masks(with_stem_axis(params), mag, stem_mode,
                            cfg.compute_dtype, cfg.sigmoid)


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


def _fused(cfg: SeparatorConfig) -> bool:
    """The fused kernels' transform: FFT 4096, hop 1024 (K1 and K7)."""
    return cfg.transform.fft_size == stft_fused.N and cfg.transform.hop == stft_fused.HOP


def _fused_stft(audio: torch.Tensor, cfg: SeparatorConfig):
    """K1 over pre-padded audio (2, data_size) -> (spec (2, n_req, 2049),
    magnitude tiles (n_tiles, 2, T, bin_limit), n_out frames)."""
    tcfg = cfg.transform
    data_size = audio.shape[-1]
    n_out = transform.num_output_frames(data_size, tcfg)
    n_comp = transform.num_computed_frames(data_size, tcfg)
    n_req = num_tiles(n_out, cfg.time_step) * cfg.time_step
    spec, mag = stft_fused.stft4096(
        audio, transform.analysis_window(tcfg.fft_size, device=audio.device),
        n_comp, n_req, cfg.bin_limit, cfg.time_step,
    )
    return spec, mag, n_out


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
    spec, mag, n_out = _fused_stft(audio, cfg)
    masks = multi_stem_masks(
        stacked_params, mag, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
    )  # (S, n_tiles, 2, T, F)
    return stft_fused.masked_istft4096(
        spec, masks, out_band_t, transform.synthesis_window(tcfg, device=dev),
        n_out,
    )


def separate_2stem(
    params: Params, audio: torch.Tensor, cfg: SeparatorConfig
) -> torch.Tensor:
    """vocals = istft(mask * spec), `unaffected_weight` out of band;
    accompaniment = input - vocals in the time domain (Executable/main.c:
    779-808). Returns (2, 2ch, out_len).

    At hop 1024: K1, the U-Net (any route), K7 with one stem. At any other
    hop: the plain STFT, the U-Net and `transform.istft` (K8 at FFT 4096)."""
    data_size = audio.shape[-1]
    tcfg = cfg.transform
    if _fused(cfg):
        spec, mag, n_out = _fused_stft(audio, cfg)
        masks = single_net_masks(params, mag, cfg, STEM_MODE_2)
        uw = torch.tensor([cfg.unaffected_weight], device=audio.device)
        vocal = stft_fused.masked_istft4096(
            spec, masks, uw, transform.synthesis_window(tcfg, device=audio.device),
            n_out,
        )[0]
    else:
        spec = transform.stft(audio, tcfg, data_size)
        masks = compute_masks(params, spec, cfg, STEM_MODE_2)
        vocal = transform.istft(apply_mask(spec, masks, cfg), tcfg)
    residual = F.pad(audio, (0, vocal.shape[-1] - data_size)) - vocal
    return torch.stack([vocal, residual])


def separate_3stem(
    params4: Params, params2: Params, audio: torch.Tensor, cfg: SeparatorConfig,
) -> torch.Tensor:
    """The exe's two-pass graph (Executable/main.c:845-970): pass 1 (the
    4-stem-family net, ELU) masks drums; the FREQUENCY-domain residual
    feeds pass 2 (the 2-stem net) for vocals; accompaniment =
    istft(residual) - vocals in time. Returns (3, 2ch, out_len) ordered
    (drums, vocals, accompaniment).

    At hop 1024 it is the reference package's fused form
    (`_separate_3stem_fused_tracks`): one K1, both U-Net passes, one K7
    launch for all three stems, each written as a mask on the ORIGINAL
    spectrum, which is exact because masks scale the complex bins by real
    factors:

      drums    = istft(dm . s            | uw . s          out of band)
      vocals   = istft((1-dm) vm . s     | uw (1-uw) . s   out of band)
      residual = istft((1-dm) . s        | (1-uw) . s      out of band)
      accompaniment = residual - vocals

    Pass 2's magnitude |(1-dm) . s| is taken in band from K1's spectrum; the
    residual spectrum is never formed. At any other hop: the canonical
    graph with three `transform.istft` calls (K8 at FFT 4096)."""
    data_size = audio.shape[-1]
    tcfg = cfg.transform
    uw = cfg.unaffected_weight
    if not _fused(cfg):
        spec = transform.stft(audio, tcfg, data_size)
        drum_masks = compute_masks(params4, spec, cfg, STEM_MODE_4)
        drum_spec = apply_mask(spec, drum_masks, cfg)
        residual_spec = spec - drum_spec
        drums = transform.istft(drum_spec, tcfg)
        vocal_masks = compute_masks(params2, residual_spec, cfg, STEM_MODE_2)
        vocals = transform.istft(apply_mask(residual_spec, vocal_masks, cfg), tcfg)
        accompaniment = transform.istft(residual_spec, tcfg) - vocals
        return torch.stack([drums, vocals, accompaniment])
    dev = audio.device
    spec, mag, n_out = _fused_stft(audio, cfg)
    nt, rows, t, f = mag.shape
    dm = single_net_masks(params4, mag, cfg, STEM_MODE_4)  # (1, nt, 2, T, F)
    inv = 1.0 - dm  # the residual's in-band factor
    in_band = spec[:, : nt * t, :f].reshape(rows, nt, t, f).transpose(0, 1)
    mag2 = (in_band * inv[0]).abs().contiguous()
    vm = single_net_masks(params2, mag2, cfg, STEM_MODE_2)
    masks3 = torch.cat([dm, inv * vm, inv])
    out_band = torch.tensor([uw, uw * (1.0 - uw), 1.0 - uw], device=dev)
    drums, vocals, residual = stft_fused.masked_istft4096(
        spec, masks3, out_band, transform.synthesis_window(tcfg, device=dev),
        n_out,
    )
    return torch.stack([drums, vocals, residual - vocals])


def separate_4stem(
    stacked_params: Params, audio: torch.Tensor, cfg: SeparatorConfig
) -> torch.Tensor:
    """4-stem graph ordered (drums, bass, accompaniment, vocals)."""
    return separate_nstem(stacked_params, audio, cfg, OUT_BAND_4)


def check_ported(cfg: SeparatorConfig) -> None:
    """Raise NotImplementedError for the graphs this package lacks: 4 and
    5 stems need the FFT 4096 kernels (K7 or K9); 2 and 3 stems run any
    transform."""
    if cfg.num_stems in (4, 5) and cfg.transform.fft_size != stft_fused.N:
        raise NotImplementedError(
            _NOT_PORTED.format(f"{cfg.num_stems}-stem separation at a "
                               f"transform other than FFT 4096")
        )


def separate(
    audio,
    *,
    params: Params | None = None,
    params4: Params | None = None,
    params2: Params | None = None,
    stacked_params: Params | None = None,
    cfg: SeparatorConfig,
    device: torch.device | str = "cuda",
) -> dict[str, torch.Tensor]:
    """High-level entry: pad, run the stem graph for cfg.num_stems, crop.

    `audio` is (2, n) or (n,) float32 at 44.1 kHz (array or tensor). The
    nets, already on `device`, are `params` for 2 stems, `params4` and
    `params2` for 3, and `stacked_params` (a leading stem axis) for 4 and
    5. Returns {stem_name: (2, n) tensor on `device`}.
    """
    check_ported(cfg)
    audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
    if audio.ndim == 1:
        audio = torch.stack([audio, audio])
    n = audio.shape[-1]
    preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    if cfg.num_stems == 2:
        stems = separate_2stem(params, padded, cfg)
    elif cfg.num_stems == 3:
        stems = separate_3stem(params4, params2, padded, cfg)
    elif cfg.num_stems == 4:
        stems = separate_4stem(stacked_params, padded, cfg)
    else:
        stems = separate_nstem(stacked_params, padded, cfg, OUT_BAND_5)
    cropped = stems[..., preshift : preshift + n]
    return dict(zip(cfg.stem_names, cropped))
