"""Sequence-parallel separation: the signal axis sharded over the mesh.

The reference package's parallel/timeshard.py maps the reference's
frame-level data parallelism (contiguous sample ranges per STFT worker,
Executable/stftFix.c:379-427; timeStep-tile ranges per thread,
Executable/main.c:550-575) onto the "data" axis: each rank owns one
contiguous chunk of the signal end to end (STFT, U-Net masks, iSTFT) and
trades only the transform halos with its neighbours:

- analysis halo: a frame reads FFT - HOP = 3072 samples past its chunk,
  so each rank sends the head of its chunk to its left neighbour before
  framing;
- synthesis halo: the local overlap-add runs 3072 samples past the chunk,
  so each rank sends that tail to its right neighbour, which adds it into
  its head.

Here both ends are the hand kernels, not a plain FFT with a scattered
overlap-add: K1 frames the chunk and its halo (n_req = chunk / 1024
frames, the computed ones counted locally), the packed U-Net (K2-K6) runs
the local tiles with the params replicated, and K7 writes exactly the
chunk plus its synthesis halo (n_req * 1024 + 3072 samples). The halos are
point-to-point exchanges over the rank's "data" group; ranks of different
stem groups with the same data index compute the same chunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from spleeterrt_tpu_torch.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import separate, transform
from spleeterrt_tpu_torch.core.model import Params, multi_stem_masks, num_stems
from spleeterrt_tpu_torch.kernels import stft_fused
from spleeterrt_tpu_torch.parallel.distributed import all_gather_cat, exchange

HALO = stft_fused.N - stft_fused.HOP  # 3072 samples each way


def padded_length(n: int, cfg: SeparatorConfig, n_devices: int) -> int:
    """Smallest length >= n divisible by n_devices * time_step * hop so each
    device holds a whole number of spectrogram tiles."""
    quantum = n_devices * cfg.time_step * cfg.transform.hop
    return -(-n // quantum) * quantum


def _data_axis(mesh: DeviceMesh) -> tuple[object, int, int, list[int]]:
    """(group, size, index, global ranks in data order) of this rank's
    "data" axis."""
    s, d = mesh.get_coordinate()
    ranks = mesh.mesh[s].tolist()
    return mesh.get_group("data"), len(ranks), d, ranks


def separate_4stem_timesharded(
    stacked_params: Params,
    chunk: torch.Tensor,  # (2, n_pad / n_data): this rank's slice
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
    data_size: int,
    out_band: tuple[float, ...] = separate.OUT_BAND_4,
) -> torch.Tensor:
    """Masked separation with the sample axis sharded over "data".

    `chunk` is data rank d's slice [d * c, (d + 1) * c) of the padded
    audio (n_pad from padded_length); `data_size` is the signal's length
    before that padding: frames past the reference's computed range stay
    zero (Executable/stftFix.c:460-495), so the sharding pad only adds
    zero frames. A rank that lies wholly past the computed frames holds a
    zero spectrum and so zero stems; it runs no kernel but still trades
    its halos. Returns this rank's (S, 2, c) slice of the stems, which
    match separate.separate_nstem's on [0, data_size + 3072). Collective
    over the ranks of each "data" group."""
    if not separate.fused_transform(cfg):
        raise ValueError("the time-sharded graph runs K1 and K7: FFT 4096, "
                         "hop 1024")
    if len(out_band) != num_stems(stacked_params):
        raise ValueError(f"{len(out_band)} out-of-band weights for "
                         f"{num_stems(stacked_params)} nets")
    group, n_data, d, ranks = _data_axis(mesh)
    c = chunk.shape[-1]
    n_req = c // stft_fused.HOP
    if n_req * stft_fused.HOP != c or n_req % cfg.time_step or c < HALO:
        raise ValueError("pad audio with padded_length() first")
    left = ranks[d - 1] if d > 0 else None
    right = ranks[d + 1] if d + 1 < n_data else None
    dev = chunk.device

    # Analysis halo: the right neighbour's head (zeros past the last rank).
    halo = torch.zeros((2, HALO), dtype=chunk.dtype, device=dev)
    exchange(chunk[:, :HALO], left, halo, right, group)

    n_comp = transform.num_computed_frames(data_size, cfg.transform)
    local_comp = min(max(n_comp - d * n_req, 0), n_req)
    if local_comp == 0:
        y = torch.zeros((num_stems(stacked_params), 2, c + HALO), device=dev)
    else:
        ext = torch.cat([chunk, halo], dim=-1)
        spec, mag = separate.fused_stft(ext, cfg, local_comp, n_req)
        masks = multi_stem_masks(stacked_params, mag, STEM_MODE_4,
                                 cfg.compute_dtype, cfg.sigmoid)
        y = stft_fused.masked_istft4096(
            spec, masks, torch.tensor(out_band, dtype=torch.float32, device=dev),
            transform.synthesis_window(cfg.transform, device=dev), n_req,
        )  # (S, 2, c + HALO)

    # Synthesis halo: this tail into the right neighbour's head.
    from_left = torch.zeros((y.shape[0], 2, HALO), device=dev)
    exchange(y[..., c:], right, from_left, left, group)
    out = y[..., :c]
    out[..., :HALO] += from_left
    return out


def separate_4stem_timesharded_padded(
    stacked_params: Params,
    audio: torch.Tensor,  # (2, n) raw audio, the same on every rank
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """The offline padding, the sharding padding, each data rank's chunk
    through separate_4stem_timesharded, the chunks gathered and the
    reference's crop (Executable/main.c:806-808): (4, 2, n) stems on every
    rank, as separate.separate returns them. Collective."""
    tcfg = cfg.transform
    n = audio.shape[-1]
    preshift, final_size = transform.offline_pad_sizes(n, tcfg)
    group, n_data, d, _ = _data_axis(mesh)
    n_pad = padded_length(final_size, cfg, n_data)
    padded = F.pad(transform.pad_offline(audio, tcfg), (0, n_pad - final_size))
    c = n_pad // n_data
    stems = separate_4stem_timesharded(
        stacked_params, padded[:, d * c:(d + 1) * c].contiguous(), cfg, mesh,
        data_size=final_size)
    return all_gather_cat(stems, group, dim=-1)[..., preshift:preshift + n]
