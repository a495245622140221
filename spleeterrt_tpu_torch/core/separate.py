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

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import (
    STEM_MODE_2,
    STEM_MODE_4,
    RoformerConfig,
    SeparatorConfig,
)
from spleeterrt_tpu_torch.core import model, replay, roformer, transform
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


def _nstem_front(
    stacked_params: Params,
    tracks: torch.Tensor,  # (B, 2, data_size) pre-padded, equal lengths
    cfg: SeparatorConfig,
    stem_mode: int,
    unet: UNet = multi_stem_masks,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused N-stem body up to K7 -> (spec (B * 2, n_req, 2049), masks
    (S, B * n_tiles, 2, T, F)): one K1 with the tracks folded into its
    rows, one U-Net pass over the B * n_tiles images (any route)."""
    b, rows, data_size = tracks.shape
    _, n_comp, n_req = frame_counts(data_size, cfg)
    spec, mag = fused_stft(tracks.reshape(b * rows, data_size), cfg, n_comp,
                           n_req, b)
    return spec, unet(stacked_params, mag, stem_mode, cfg.compute_dtype,
                      cfg.sigmoid)


def _synthesis(
    spec: torch.Tensor, masks: torch.Tensor, cfg: SeparatorConfig,
    out_band: tuple[float, ...], b: int, data_size: int,
) -> torch.Tensor:
    """K7 over a fused front's spectrum and masks -> (B, S, 2, out_len), a
    view of one new tensor."""
    dev = spec.device
    out = stft_fused.masked_istft4096(
        spec, masks, transform.out_band_tensor(out_band, dev),
        transform.synthesis_window(cfg.transform, device=dev),
        frame_counts(data_size, cfg)[0], b,
    )  # (S, B * 2, out_len)
    return out.view(out.shape[0], b, spec.shape[0] // b, -1).transpose(0, 1)


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
    spec, masks = _nstem_front(stacked_params, tracks, cfg, stem_mode, unet)
    return _synthesis(spec, masks, cfg, out_band, tracks.shape[0],
                      tracks.shape[-1])


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
            spec, masks, transform.out_band_tensor(out_band, dev),
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


def _residual(tracks: torch.Tensor, vocal: torch.Tensor, out=None) -> torch.Tensor:
    """The accompaniment: the (padded) input minus the vocals in time,
    into `out` where given."""
    pad = vocal.shape[-1] - tracks.shape[-1]
    return torch.sub(F.pad(tracks, (0, pad)) if pad else tracks, vocal, out=out)


def _two_stems(tracks: torch.Tensor, vocal: torch.Tensor) -> torch.Tensor:
    """(..., 2 stems, 2ch, L): the vocals (..., 2ch, L) and the
    accompaniment (`_residual`), written into one new tensor
    (Executable/main.c:794-798); the residual straight into it unless
    autograd records the call (`out=` refuses that)."""
    with span("graph.residual"):
        out = vocal.new_empty((*vocal.shape[:-2], 2, *vocal.shape[-2:]))
        out.select(-3, 0).copy_(vocal)
        if _autograd_records(tracks, [vocal]):
            out.select(-3, 1).copy_(_residual(tracks, vocal))
        else:
            _residual(tracks, vocal, out=out.select(-3, 1))
        return out


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
    return _two_stems(tracks, vocal)


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
    return _two_stems(audio, vocal)


def _3stem_front(
    params4: Params, params2: Params, tracks: torch.Tensor, cfg: SeparatorConfig,
    unet: UNet = multi_stem_masks,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused 3-stem graph up to K7 -> (spec, the three stems' masks
    (3, B * n_tiles, 2, T, F)); see :func:`_separate_3stem_fused`."""
    b, rows, data_size = tracks.shape
    t, f = cfg.time_step, cfg.bin_limit
    spec, dm = _nstem_front(with_stem_axis(params4), tracks, cfg, STEM_MODE_4,
                            unet)  # dm (1, B * nt, 2, T, F)
    nt = spec.shape[1] // t
    inv = 1.0 - dm  # the residual's in-band factor
    in_band = (spec[:, :, :f].reshape(b, rows, nt, t, f).transpose(1, 2)
               .reshape(b * nt, rows, t, f))
    mag2 = (in_band * inv[0]).abs().contiguous()
    vm = single_net_masks(params2, mag2, cfg, STEM_MODE_2, unet)
    return spec, torch.cat([dm, inv * vm, inv])


def _3stem_back(spec: torch.Tensor, masks3: torch.Tensor, cfg: SeparatorConfig,
                b: int, data_size: int) -> torch.Tensor:
    """K7 over the 3-stem front -> (B, 3, 2ch, out_len): drums, vocals and
    the residual less the vocals."""
    uw = cfg.unaffected_weight
    drums, vocals, residual = _synthesis(
        spec, masks3, cfg, (uw, uw * (1.0 - uw), 1.0 - uw), b, data_size,
    ).unbind(1)
    return torch.stack([drums, vocals, residual - vocals], dim=1)


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
    spec, masks3 = _3stem_front(params4, params2, tracks, cfg, unet)
    return _3stem_back(spec, masks3, cfg, tracks.shape[0], tracks.shape[-1])


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


def _separate_roformer(audio: torch.Tensor, params: Params, cfg: RoformerConfig,
                       sp) -> dict[str, torch.Tensor]:
    """BS-RoFormer's graph: the chunked model (core/roformer.py) gives the
    masked stems over the padded track, cropped to the input; the residual
    stem is the input minus the first, as the 2-stem graph's
    accompaniment."""
    n = audio.shape[-1]
    sp.note(arch="bs-roformer", stems=len(cfg.stem_names), samples=n)
    masked = roformer.separate_roformer(audio, params, cfg)
    with span("graph.crop"):
        start = roformer.border(n, cfg)
        masked = masked[..., start : start + n]
    stems = dict(zip(cfg.stems, masked))
    if cfg.residual_stem:
        with span("graph.residual"):
            stems[cfg.residual_stem] = _residual(audio, masked[0])
    return stems


def _stereo(audio: torch.Tensor) -> torch.Tensor:
    return torch.stack([audio, audio]) if audio.ndim == 1 else audio


def _out_band(cfg: SeparatorConfig) -> tuple[float, ...]:
    """The N-stem graphs' out-of-band weights (2 stems: one, the vocals')."""
    return {2: (cfg.unaffected_weight,), 4: OUT_BAND_4}.get(cfg.num_stems, OUT_BAND_5)


def _padded(audio: torch.Tensor, cfg: SeparatorConfig) -> torch.Tensor:
    with span("graph.pad"):
        return transform.pad_offline(_stereo(audio), cfg.transform).contiguous()


def _unfused(audio: torch.Tensor, nets: tuple, cfg: SeparatorConfig) -> torch.Tensor:
    """Spleeter's graph of :func:`separate` at a transform other than the
    fused kernels' -> stems (S, 2, n): pad, the stem graph, crop."""
    params, params4, params2, stacked_params = nets
    padded = _padded(audio, cfg)
    if cfg.num_stems == 2:
        stems = separate_2stem(params, padded, cfg)
    elif cfg.num_stems == 3:
        stems = separate_3stem(params4, params2, padded, cfg)
    else:
        stems = separate_nstem(stacked_params, padded, cfg, _out_band(cfg))
    with span("graph.crop"):
        preshift, _ = transform.offline_pad_sizes(audio.shape[-1], cfg.transform)
        return stems[..., preshift : preshift + audio.shape[-1]]


def _graph_size(n: int, cfg: SeparatorConfig) -> int:
    """The padded length a graph of an n-sample call runs at: the longest
    `pad_offline` length with n's tile count, so that every length of one
    tile count shares a graph. Its frames past n's own padded length
    transform zeros and reach no sample the crop keeps, so the stems are
    those of n's own padded length."""
    tcfg = cfg.transform
    n_req = frame_counts(transform.offline_pad_sizes(n, tcfg)[1], cfg)[2]
    return tcfg.hop * n_req // tcfg.fft_size * tcfg.fft_size


def _load(buf: torch.Tensor | None, audio: torch.Tensor, cfg: SeparatorConfig,
          size: int) -> torch.Tensor:
    """`audio` written into a graph's padded input `buf` (2, size) as
    `pad_offline` lays it out (zeros, the audio, zeros to the end) ->
    `buf`, a new one where `buf` is None."""
    if buf is None:
        buf = audio.new_zeros((2, size))
    preshift, _ = transform.offline_pad_sizes(audio.shape[-1], cfg.transform)
    end = preshift + audio.shape[-1]
    buf[:, preshift:end].copy_(audio)
    buf[:, end:].zero_()
    return buf


def _front(padded: torch.Tensor, nets: tuple, cfg: SeparatorConfig) -> tuple:
    """The fused graph of :func:`separate` over the padded audio (2, size)
    up to what writes the caller's stems, the part a replay captures: K1
    and the nets -> (spec, masks); for 2 stems K7 too -> (the vocals (2,
    out_len),)."""
    params, params4, params2, stacked_params = nets
    tracks = padded[None]
    if cfg.num_stems == 3:
        return _3stem_front(params4, params2, tracks, cfg)
    if cfg.num_stems != 2:
        return _nstem_front(stacked_params, tracks, cfg, STEM_MODE_4)
    return (_nstem_fused(with_stem_axis(params), tracks, cfg, _out_band(cfg),
                         STEM_MODE_2)[0, 0],)


def _back(front: tuple, padded: torch.Tensor, audio: torch.Tensor,
          cfg: SeparatorConfig) -> torch.Tensor:
    """The rest of the fused graph after :func:`_front` over `padded`,
    written into new memory that no replay overwrites -> stems (S, 2, n):
    K7 and the crop, 3 stems' accompaniment, or 2 stems' vocals and
    residual (over the cropped samples alone)."""
    n, size = audio.shape[-1], padded.shape[-1]
    preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
    if cfg.num_stems == 3:
        stems = _3stem_back(*front, cfg, 1, size)[0]
    elif cfg.num_stems != 2:
        stems = _synthesis(*front, cfg, _out_band(cfg), 1, size)[0]
    else:
        stems = front[0]
    with span("graph.crop"):
        stems = stems[..., preshift : preshift + n]
        return stems if cfg.num_stems != 2 else _two_stems(_stereo(audio), stems)


def _weights(nets: tuple) -> list[torch.Tensor]:
    """The tensors of the nets (each a Params, or None)."""
    return [t for net in nets if net is not None
            for layer in net.values() for t in layer.values()]


def _autograd_records(audio: torch.Tensor, weights: list[torch.Tensor]) -> bool:
    """Grad mode is on and the input or a weight requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in [audio, *weights])


def _replayable(audio: torch.Tensor, weights: list[torch.Tensor]) -> bool:
    """Whether a call may replay a graph: on a CUDA device, from the
    device's default stream, with nothing for autograd to record."""
    return (audio.is_cuda
            and torch.cuda.current_stream(audio.device)
            == torch.cuda.default_stream(audio.device)
            and not _autograd_records(audio, weights))


def separate(
    audio,
    *,
    params: Params | None = None,
    params4: Params | None = None,
    params2: Params | None = None,
    stacked_params: Params | None = None,
    cfg: SeparatorConfig | RoformerConfig,
    device: torch.device | str = "cuda",
) -> dict[str, torch.Tensor]:
    """High-level entry: pad, run the stem graph for cfg.num_stems, crop.

    `audio` is (2, n) or (n,) float32 at 44.1 kHz (array or tensor). The
    nets, already on `device`, are `params` for 2 stems, `params4` and
    `params2` for 3, and `stacked_params` (a leading stem axis) for 4 and
    5. A `RoformerConfig` runs BS-RoFormer (core/roformer.py) with its
    weights in `params`. Returns {stem_name: (2, n) tensor on `device`}.

    A Spleeter call on a CUDA device at the fused kernels' transform
    whose key repeats (core/replay.py: the input's tile count, the
    configuration, the weight tensors) replays one captured CUDA graph of
    K1 and the nets (for 2 stems K7 too): the key's first call runs
    eager, its second captures the graph, later calls replay it. The
    graph runs at the longest padded length of the tile count
    (`_graph_size`), which gives the stems of the call's own. What
    writes the caller's stems (K7, or 2 stems' vocals and residual) runs
    after the graph into new memory, so no later call overwrites them.
    CPU calls, calls autograd would record, calls from another stream
    than the device's default one, calls at another transform and
    BS-RoFormer's calls run eager.

    The call is one span `graph.separate` (attributes `stems`, `samples`,
    `graph` (eager, capture or replay), and on BS-RoFormer's calls `arch`)
    around `graph.pad`, the graph's kernel and model spans, and
    `graph.crop` (with `graph.residual` inside it for 2 stems). A
    replayed call records `graph.replay` (the audio written into the
    graph's padded input, the graph launched) in place of `graph.pad` and
    the spans of what the graph holds: those fire where their launches
    are made, at the eager call and at the capture.
    """
    with span("graph.separate") as sp:
        if isinstance(cfg, RoformerConfig):
            with span("graph.pad"):
                audio = _stereo(torch.as_tensor(audio, dtype=torch.float32,
                                                 device=device))
            replay.count("eager")
            sp.note(graph="eager")
            return _separate_roformer(audio, params, cfg, sp)
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        sp.note(stems=cfg.num_stems, samples=audio.shape[-1])
        nets = (params, params4, params2, stacked_params)
        weights = _weights(nets)
        if not fused_transform(cfg):
            mode, stems = "eager", _unfused(audio, nets, cfg)
        else:
            front = functools.partial(_front, nets=nets, cfg=cfg)
            back = functools.partial(_back, audio=audio, cfg=cfg)
            eager_in = functools.partial(_padded, audio, cfg)
            if _replayable(audio, weights):
                size = _graph_size(audio.shape[-1], cfg)
                key = replay.call_key(audio.device, weights,
                                      (cfg, model.route_switches(), size))
                load = functools.partial(_load, audio=audio, cfg=cfg, size=size)
                mode, stems = replay.GRAPHS.run(key, weights, front, back,
                                                eager_in, load)
            else:
                padded = eager_in()
                mode, stems = "eager", back(front(padded), padded)
        replay.count(mode)
        sp.note(graph=mode)
        return dict(zip(cfg.stem_names, stems))
