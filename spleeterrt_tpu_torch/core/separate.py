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
FFT kernel K9 with frames out, and a plain overlap-add; at any other FFT
size the reference's canonical graph, one `transform.istft` a stem.

Each graph has a batched form over B equal-length tracks (B, 2, n), the
server's serving shape (`separate_nstem_batch`, `separate_2stem_batch`,
`separate_3stem_batch`). At hop 1024 the tracks fold into the kernels'
rows, track-major: K1 writes each (track, tile) as one U-Net image and K7
reads the masks of the B * n_tiles images as the U-Net emits them, so one
launch of each serves the batch and no interleave pass runs between
them. The single-track fused graphs are the B = 1 case; at any other hop
the batch runs track by track.

Scale conventions: with core/transform.py's windows, `abs(stft(x))` equals
the `hypotf(re, im) * FFTSIZE` magnitude the C code computes
(Executable/main.c:468), and masks multiply the complex spectrogram exactly
as the in-place `re *= mask; im *= mask` loops (Executable/main.c:473-494).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import STEM_MODE_2, STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.core.model import (
    Params,
    multi_stem_masks,
    with_stem_axis,
)
from spleeterrt_tpu_torch.kernels import pallas_fft, stft_fused
from spleeterrt_tpu_torch.utils.timing import span, traced

# Out-of-band weights per stem family: the RT engine fixes 0.25 for every
# stem except bass at 0.0 (VST/Source/Spleeter4Stems.c:73,281).
OUT_BAND_4 = (0.25, 0.0, 0.25, 0.25)  # drums, bass, accompaniment, vocals
OUT_BAND_5 = (0.25, 0.25, 0.0, 0.25, 0.25)  # vocals, drums, bass, piano, other

# The U-Net call of every graph: (stacked params, NCHW magnitude tiles (B,
# 2, T, F), stem_mode, compute_dtype, sigmoid) -> (S, B, 2, T, F) float32
# masks. The graphs take it as `unet`; model.multi_stem_masks runs every
# stem over every tile on this device, and parallel/mesh.py passes one that
# spreads stems and tiles over the ranks of a device mesh.
UNet = Callable[..., torch.Tensor]


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
    unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """Single-net masks for every frame: (2, n_frames, bin_limit)."""
    return compute_masks_multi(with_stem_axis(params), spec, cfg, stem_mode,
                               unet)[0]


def single_net_masks(
    params: Params, mag: torch.Tensor, cfg: SeparatorConfig, stem_mode: int,
    unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """One net over NCHW magnitude tiles (n_tiles, 2, T, F) -> masks (1,
    n_tiles, 2, T, F) float32, the masked iSTFT's layout, whichever route
    the U-Net takes (the reference's `_masks_cd_tracks` for one track)."""
    return unet(with_stem_axis(params), mag, stem_mode, cfg.compute_dtype,
                cfg.sigmoid)


def compute_masks_multi(
    stacked_params: Params, spec: torch.Tensor, cfg: SeparatorConfig,
    stem_mode: int, unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """S stacked nets -> (S, 2, n_frames, bin_limit)."""
    tiles = spec_to_tiles(spec, cfg).permute(0, 3, 1, 2).contiguous()
    masks = unet(stacked_params, tiles, stem_mode, cfg.compute_dtype,
                 cfg.sigmoid)  # (S, n_tiles, 2, T, F)
    s, nt, c, t, f = masks.shape
    frames = masks.transpose(1, 2).reshape(s, c, nt * t, f)
    return frames[:, :, : spec.shape[-2]].contiguous()


def fused_transform(cfg: SeparatorConfig) -> bool:
    """The fused kernels' transform: FFT 4096, hop 1024 (K1 and K7)."""
    return cfg.transform.fft_size == stft_fused.N and cfg.transform.hop == stft_fused.HOP


def frame_counts(data_size: int, cfg: SeparatorConfig) -> tuple[int, int, int]:
    """(n_out, n_comp, n_req) of pre-padded audio: the spectrogram's frames,
    those computed (the rest are zero), and n_out rounded up to whole
    tiles."""
    tcfg = cfg.transform
    n_out = transform.num_output_frames(data_size, tcfg)
    n_comp = transform.num_computed_frames(data_size, tcfg)
    return n_out, n_comp, num_tiles(n_out, cfg.time_step) * cfg.time_step


def fused_stft(
    audio: torch.Tensor, cfg: SeparatorConfig, n_comp: int, n_req: int,
    tracks: int = 1,
):
    """K1 over (rows, n) audio, `tracks` tracks of rows / tracks channels:
    (spec (rows, n_req, 2049), magnitude tiles (tracks * n_req / T,
    rows / tracks, T, bin_limit)), frames from n_comp on zero."""
    return stft_fused.stft4096(
        audio, transform.analysis_window(stft_fused.N, device=audio.device),
        n_comp, n_req, cfg.bin_limit, cfg.time_step, tracks,
    )


def _nstem_fused(
    stacked_params: Params,
    tracks: torch.Tensor,  # (B, 2, data_size) pre-padded, equal lengths
    cfg: SeparatorConfig,
    out_band: tuple[float, ...],
    stem_mode: int,
    unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """The fused N-stem body over B tracks -> (B, S, 2, out_len), a view:
    one K1 with the tracks folded into its rows, one U-Net pass over the
    B * n_tiles images (any route), one K7 (the reference package's
    `_nstem_batch_fused`, whose track interleave the kernels' layout makes
    unnecessary)."""
    b, rows, data_size = tracks.shape
    dev = tracks.device
    n_out, n_comp, n_req = frame_counts(data_size, cfg)
    spec, mag = fused_stft(tracks.reshape(b * rows, data_size), cfg, n_comp,
                           n_req, b)
    masks = unet(stacked_params, mag, stem_mode, cfg.compute_dtype,
                 cfg.sigmoid)  # (S, B * n_tiles, 2, T, F)
    out = stft_fused.masked_istft4096(
        spec, masks, torch.tensor(out_band, dtype=torch.float32, device=dev),
        transform.synthesis_window(cfg.transform, device=dev), n_out, b,
    )  # (S, B * 2, out_len)
    return out.view(out.shape[0], b, rows, -1).transpose(0, 1)


def _per_track(graph, tracks: torch.Tensor) -> torch.Tensor:
    """A single-track graph over each of (B, 2, n) tracks -> (B, ...): the
    reference's vmap, each track on the port's kernels."""
    return torch.stack([graph(a) for a in tracks])


def separate_nstem(
    stacked_params: Params,
    audio: torch.Tensor,  # (2, data_size) pre-padded, see transform.pad_offline
    cfg: SeparatorConfig,
    out_band: tuple[float, ...],
    unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """S independent nets over the same input, one mask per stem -> stems
    (S, 2ch, out_len) with out_len = n_frames * hop + fft_size - hop >=
    data_size.

    At hop 1024 the B = 1 case of :func:`separate_nstem_batch`. At any
    other hop of a 4096-point FFT: the plain STFT, the U-Net, K9 and the
    overlap-add; at any other FFT size the canonical graph, one
    `transform.istft` a stem (the reference's vmap over stems).

    Tensors on a CUDA device run the kernels; CPU tensors run their plain
    versions (kernels/stft_fused.py, kernels/pallas_fft.py). `unet` is the
    U-Net call (see `UNet`)."""
    tcfg = cfg.transform
    if fused_transform(cfg):
        return _nstem_fused(stacked_params, audio[None], cfg, out_band,
                            STEM_MODE_4, unet)[0]
    data_size = audio.shape[-1]
    dev = audio.device
    spec = transform.stft(audio, tcfg, data_size)
    masks = compute_masks_multi(stacked_params, spec, cfg, STEM_MODE_4, unet)
    if tcfg.fft_size == pallas_fft.N:
        frames = pallas_fft.masked_irfft4096(
            spec, masks, torch.tensor(out_band, dtype=torch.float32, device=dev),
            cfg.bin_limit, transform.synthesis_window(tcfg, device=dev),
        )
        return transform.overlap_add(frames, tcfg)
    return torch.stack([
        transform.istft(apply_mask(spec, m, cfg, w), tcfg)
        for m, w in zip(masks, out_band)
    ])


@traced("graph.separate_batch")
def separate_nstem_batch(
    stacked_params: Params,
    tracks: torch.Tensor,  # (B, 2, data_size) pre-padded, equal lengths
    cfg: SeparatorConfig,
    out_band: tuple[float, ...],
) -> torch.Tensor:
    """Batched multi-track N-stem graph -> (B, S, 2, out_len).

    At hop 1024 the tracks fold into the kernels' rows: one K1, one U-Net
    pass over B * n_tiles images and one K7 serve the whole batch. At any
    other hop each track runs :func:`separate_nstem` (its kernels, K9
    among them)."""
    if fused_transform(cfg):
        return _nstem_fused(stacked_params, tracks, cfg, out_band, STEM_MODE_4)
    return _per_track(
        lambda a: separate_nstem(stacked_params, a, cfg, out_band), tracks)


def _residual(tracks: torch.Tensor, vocal: torch.Tensor) -> torch.Tensor:
    """The accompaniment: the (padded) input minus the vocals in time."""
    return F.pad(tracks, (0, vocal.shape[-1] - tracks.shape[-1])) - vocal


@traced("graph.separate_batch")
def separate_2stem_batch(
    params: Params,  # one net, no stem axis
    tracks: torch.Tensor,  # (B, 2, data_size) pre-padded, equal lengths
    cfg: SeparatorConfig,
) -> torch.Tensor:
    """Batched 2-stem graph -> (B, 2 stems, 2ch, out_len), the reference's
    offline 2-stem semantics per track (Executable/main.c:773,779-808).

    At hop 1024: K1, the U-Net over B * n_tiles images and K7 with one
    stem (`unaffected_weight` out of band), then accompaniment = track -
    vocals. At any other hop each track runs :func:`separate_2stem`."""
    if not fused_transform(cfg):
        return _per_track(lambda a: separate_2stem(params, a, cfg), tracks)
    return _2stem_fused(params, tracks, cfg, multi_stem_masks)


def _2stem_fused(
    params: Params, tracks: torch.Tensor, cfg: SeparatorConfig, unet: UNet,
) -> torch.Tensor:
    """The fused 2-stem body over B tracks -> (B, 2 stems, 2ch, out_len)."""
    vocal = _nstem_fused(with_stem_axis(params), tracks, cfg,
                         (cfg.unaffected_weight,), STEM_MODE_2, unet)[:, 0]
    with span("graph.residual"):
        return torch.stack([vocal, _residual(tracks, vocal)], dim=1)


def separate_2stem(
    params: Params, audio: torch.Tensor, cfg: SeparatorConfig,
    unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """vocals = istft(mask * spec), `unaffected_weight` out of band;
    accompaniment = input - vocals in the time domain (Executable/main.c:
    779-808). Returns (2, 2ch, out_len).

    At hop 1024 the B = 1 case of :func:`separate_2stem_batch`. At any
    other hop: the plain STFT, the U-Net and `transform.istft` (K8 at FFT
    4096). `unet` is the U-Net call (see `UNet`)."""
    if fused_transform(cfg):
        return _2stem_fused(params, audio[None], cfg, unet)[0]
    tcfg = cfg.transform
    spec = transform.stft(audio, tcfg, audio.shape[-1])
    masks = compute_masks(params, spec, cfg, STEM_MODE_2, unet)
    vocal = transform.istft(apply_mask(spec, masks, cfg), tcfg)
    with span("graph.residual"):
        return torch.stack([vocal, _residual(audio, vocal)])


def _separate_3stem_fused(
    params4: Params, params2: Params, tracks: torch.Tensor, cfg: SeparatorConfig,
    unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """The fused two-pass 3-stem graph over B tracks (B, 2, n) -> (B, 3,
    2ch, out_len), the reference package's `_separate_3stem_fused_tracks`:
    one K1, both U-Net passes over B * n_tiles images, one K7 launch for
    all three stems, each written as a mask on the ORIGINAL spectrum,
    which is exact because masks scale the complex bins by real factors:

      drums    = istft(dm . s            | uw . s          out of band)
      vocals   = istft((1-dm) vm . s     | uw (1-uw) . s   out of band)
      residual = istft((1-dm) . s        | (1-uw) . s      out of band)
      accompaniment = residual - vocals

    Pass 2's magnitude |(1-dm) . s| is taken in band from K1's spectrum,
    track by track in the tiles' layout; the residual spectrum is never
    formed."""
    b, rows, data_size = tracks.shape
    dev = tracks.device
    uw = cfg.unaffected_weight
    n_out, n_comp, n_req = frame_counts(data_size, cfg)
    t, f = cfg.time_step, cfg.bin_limit
    nt = n_req // t
    spec, mag = fused_stft(tracks.reshape(b * rows, data_size), cfg, n_comp,
                           n_req, b)
    dm = single_net_masks(params4, mag, cfg, STEM_MODE_4, unet)  # (1, B * nt, 2, T, F)
    inv = 1.0 - dm  # the residual's in-band factor
    in_band = (spec[:, :, :f].reshape(b, rows, nt, t, f).transpose(1, 2)
               .reshape(b * nt, rows, t, f))
    mag2 = (in_band * inv[0]).abs().contiguous()
    vm = single_net_masks(params2, mag2, cfg, STEM_MODE_2, unet)
    masks3 = torch.cat([dm, inv * vm, inv])
    out_band = torch.tensor([uw, uw * (1.0 - uw), 1.0 - uw], device=dev)
    drums, vocals, residual = stft_fused.masked_istft4096(
        spec, masks3, out_band,
        transform.synthesis_window(cfg.transform, device=dev), n_out, b,
    ).view(3, b, rows, -1)
    return torch.stack([drums, vocals, residual - vocals], dim=1)


@traced("graph.separate_batch")
def separate_3stem_batch(
    params4: Params, params2: Params, tracks: torch.Tensor, cfg: SeparatorConfig,
) -> torch.Tensor:
    """Batched two-pass 3-stem graph -> (B, 3, 2ch, out_len) ordered
    (drums, vocals, accompaniment), Executable/main.c:845-970 per track:
    the fused graph at hop 1024, :func:`separate_3stem` per track at any
    other hop."""
    if fused_transform(cfg):
        return _separate_3stem_fused(params4, params2, tracks, cfg)
    return _per_track(lambda a: separate_3stem(params4, params2, a, cfg), tracks)


def separate_3stem(
    params4: Params, params2: Params, audio: torch.Tensor, cfg: SeparatorConfig,
    unet: UNet = multi_stem_masks,
) -> torch.Tensor:
    """The exe's two-pass graph (Executable/main.c:845-970): pass 1 (the
    4-stem-family net, ELU) masks drums; the FREQUENCY-domain residual
    feeds pass 2 (the 2-stem net) for vocals; accompaniment =
    istft(residual) - vocals in time. Returns (3, 2ch, out_len) ordered
    (drums, vocals, accompaniment).

    At hop 1024 the B = 1 case of the fused batch graph
    (:func:`separate_3stem_batch`), as the reference package's
    `_separate_3stem_fused` is. At any other hop: the canonical graph
    with three `transform.istft` calls (K8 at FFT 4096). `unet` is the
    U-Net call (see `UNet`)."""
    if fused_transform(cfg):
        return _separate_3stem_fused(params4, params2, audio[None], cfg,
                                     unet)[0]
    tcfg = cfg.transform
    spec = transform.stft(audio, tcfg, audio.shape[-1])
    drum_masks = compute_masks(params4, spec, cfg, STEM_MODE_4, unet)
    drum_spec = apply_mask(spec, drum_masks, cfg)
    residual_spec = spec - drum_spec
    drums = transform.istft(drum_spec, tcfg)
    vocal_masks = compute_masks(params2, residual_spec, cfg, STEM_MODE_2, unet)
    vocals = transform.istft(apply_mask(residual_spec, vocal_masks, cfg), tcfg)
    accompaniment = transform.istft(residual_spec, tcfg) - vocals
    return torch.stack([drums, vocals, accompaniment])


def separate_4stem(
    stacked_params: Params, audio: torch.Tensor, cfg: SeparatorConfig
) -> torch.Tensor:
    """4-stem graph ordered (drums, bass, accompaniment, vocals)."""
    return separate_nstem(stacked_params, audio, cfg, OUT_BAND_4)


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

    The call is one span `graph.separate` (attributes `stems`, `samples`)
    around `graph.pad`, the graph's kernel and U-Net spans, and
    `graph.crop`.
    """
    with span("graph.separate") as sp:
        with span("graph.pad"):
            audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
            if audio.ndim == 1:
                audio = torch.stack([audio, audio])
            n = audio.shape[-1]
            preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
            padded = transform.pad_offline(audio, cfg.transform).contiguous()
        sp.note(stems=cfg.num_stems, samples=n)
        if cfg.num_stems == 2:
            stems = separate_2stem(params, padded, cfg)
        elif cfg.num_stems == 3:
            stems = separate_3stem(params4, params2, padded, cfg)
        elif cfg.num_stems == 4:
            stems = separate_4stem(stacked_params, padded, cfg)
        else:
            stems = separate_nstem(stacked_params, padded, cfg, OUT_BAND_5)
        with span("graph.crop"):
            cropped = stems[..., preshift : preshift + n]
            return dict(zip(cfg.stem_names, cropped))
