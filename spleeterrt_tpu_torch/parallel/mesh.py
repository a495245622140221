"""Device-mesh sharding for separation and streaming, over torch.distributed.

The reference package's parallel/mesh.py maps the reference's pthread
pools (spectrogram tiles across threads, Executable/main.c:550-575; one
U-Net per stem thread, VST/Source/Spleeter4Stems.c:135) onto a (stem,
data) device mesh with `shard_map`. Here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the default
process group (parallel/distributed.py), one rank a device:

- "stem": the per-stem U-Nets, expert-style; each stem group runs its
  slice of the stacked nets;
- "data": spectrogram tiles (or tracks, or streams) of the data
  parallelism; tiles are independent by design (no cross-tile context), so
  mask inference needs no halo.

Every entry point is collective: every rank of the group calls it with the
same arguments (the whole stacked params and the whole input), takes its
slice, runs the hand kernels on its own device (K1, the packed U-Net's
K2-K6 or the round-3 route's K2, K3 and K10, K7; the streaming synthesis
on the streams, K9 at hops other than 1024), and gathers what the reference's `out_specs` make
replicated, so every rank returns the same result. Where the stems do not
divide the "stem" axis, each group's slice is padded with zero masks to
the ceiling for the gather and cropped after it: the kernels stay live on
every split (the reference turns them off there, because XLA's GSPMD
partitioner cannot split a custom call). Tiles, tracks and streams are
zero-padded to a multiple of their axis and cropped in the same way.

The single-track graphs are core/separate.py's, with the U-Net call
(`separate.UNet`) replaced by one that spreads stems and tiles over the
mesh (`sharded_unet`); K1 and K7 run on every rank, each over the whole
track, as the reference replicates its transforms.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from spleeterrt_tpu_torch.config import STEM_MODE_4, SeparatorConfig, require_spleeter
from spleeterrt_tpu_torch.core import separate
from spleeterrt_tpu_torch.core.model import Params, multi_stem_masks, num_stems
from spleeterrt_tpu_torch.parallel.distributed import all_gather_cat, rank_device
from spleeterrt_tpu_torch.runtime import stream as stream_mod


def make_mesh(stem_parallel: int = 1) -> DeviceMesh:
    """The (stem, data) mesh over every rank of the process group:
    `stem_parallel` stem groups, the remaining ranks data parallel. Rank r
    sits at (r // n_data, r % n_data). Collective."""
    world = dist.get_world_size()
    if stem_parallel < 1 or world % stem_parallel:
        raise ValueError(
            f"{world} ranks not divisible by stem_parallel={stem_parallel}")
    return init_device_mesh(rank_device().type,
                            (stem_parallel, world // stem_parallel),
                            mesh_dim_names=("stem", "data"))


def _axis(mesh: DeviceMesh, name: str) -> tuple[object, int, int]:
    """(group, size, this rank's index) of one mesh axis."""
    index = mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]
    return mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)), index


def _flat(mesh: DeviceMesh) -> tuple[object, int, int]:
    """(group, size, index) of the flattened mesh: every rank, rank order."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the group")
    return dist.group.WORLD, mesh.size(), dist.get_rank()


def _share(n: int, parts: int, index: int) -> tuple[int, int, int]:
    """(lo, hi, ceil(n / parts)): part `index` of n items cut into `parts`
    runs of the ceiling, the last ones short or empty."""
    per = -(-n // parts)
    lo = min(index * per, n)
    return lo, min(lo + per, n), per


def _stem_slice(stacked_params: Params, lo: int, hi: int) -> Params:
    return {ln: {fn: v[lo:hi] for fn, v in ly.items()}
            for ln, ly in stacked_params.items()}


def _pad_rows(x: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    """x zero-padded along `dim` to `rows`."""
    extra = rows - x.shape[dim]
    if extra == 0:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, extra]
    return F.pad(x, pad)


def shard_params(params: Params, mesh: DeviceMesh, stem_sharded: bool) -> Params:
    """This rank's share of `params`: its stem group's slice of the stacked
    stem axis (views; the last group's may be short) if `stem_sharded`,
    else all of it."""
    if not stem_sharded:
        return params
    _, n_groups, g = _axis(mesh, "stem")
    lo, hi, _ = _share(num_stems(params), n_groups, g)
    return _stem_slice(params, lo, hi)


def gather_params(params: Params, mesh: DeviceMesh) -> Params:
    """The inverse of shard_params(..., True) for an even split: every stem
    group's slice, stacked again on every rank. Collective."""
    group, _, _ = _axis(mesh, "stem")
    return {ln: {fn: all_gather_cat(v.detach(), group) for fn, v in ly.items()}
            for ln, ly in params.items()}


def sharded_unet(mesh: DeviceMesh, stems_over_mesh: bool = True) -> separate.UNet:
    """A `separate.UNet` over the mesh. With `stems_over_mesh` the stems
    spread over "stem" and the tiles over "data"; without, every rank runs
    every stem (the single-net graphs) and the tiles spread over the
    flattened mesh. Each rank runs model.multi_stem_masks (its hand
    kernels) on its stems x its tiles; the masks are gathered over the tile
    axis, then over "stem", and every rank returns all (S, B, 2, T, F)."""

    def unet(stacked_params, mag, stem_mode, compute_dtype, sigmoid):
        if stems_over_mesh:
            stem_group, n_groups, g = _axis(mesh, "stem")
            tile_group, n_tile, t = _axis(mesh, "data")
        else:
            stem_group, n_groups, g = None, 1, 0
            tile_group, n_tile, t = _flat(mesh)
        n_stems, n_images = num_stems(stacked_params), mag.shape[0]
        lo, hi, per_stem = _share(n_stems, n_groups, g)
        _, _, per_tile = _share(n_images, n_tile, t)
        local = _pad_rows(mag, per_tile * n_tile)[t * per_tile:(t + 1) * per_tile]
        if hi > lo:
            masks = multi_stem_masks(_stem_slice(stacked_params, lo, hi), local,
                                     stem_mode, compute_dtype, sigmoid)
        else:  # more stem groups than stems: this group has none
            masks = torch.zeros((0, *local.shape), device=mag.device)
        masks = all_gather_cat(_pad_rows(masks, per_stem), tile_group, dim=1)
        if stem_group is not None:
            masks = all_gather_cat(masks, stem_group, dim=0)
        return masks[:n_stems, :n_images].contiguous()

    return unet


def compute_masks_sharded(
    stacked_params: Params,
    spec: torch.Tensor,
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
    stem_mode: int = STEM_MODE_4,
) -> torch.Tensor:
    """Multi-stem masks with tiles over "data" and stems over "stem"
    (separate.compute_masks_multi through `sharded_unet`): (S, 2,
    n_frames, bin_limit) on every rank. Collective."""
    require_spleeter(cfg, "the mesh")
    return separate.compute_masks_multi(stacked_params, spec, cfg, stem_mode,
                                        sharded_unet(mesh))


def separate_4stem_sharded(
    stacked_params: Params,
    audio: torch.Tensor,  # (2, data_size) pre-padded
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """The 4-stem offline graph (separate.separate_nstem with OUT_BAND_4)
    with its U-Net sharded over the mesh: at hop 1024 K1 on every rank,
    each rank's stems x tiles through the packed U-Net (K2-K6), the masks
    gathered, K7 on every rank; at other hops of a 4096-point FFT K9 in
    place of K7. Returns (4, 2, out_len) on every rank. Collective."""
    require_spleeter(cfg, "the mesh")
    return separate.separate_nstem(stacked_params, audio, cfg,
                                   separate.OUT_BAND_4, sharded_unet(mesh))


def _over_ranks(mesh: DeviceMesh, graph):
    """(fn, n_ranks): fn(*nets, tracks) runs `graph(*nets, rank's tracks)`
    on each rank's equal share of the tracks, spread over the flattened
    mesh, and gathers the results in track order on every rank."""
    group, n, r = _flat(mesh)

    def fn(*args):
        *nets, tracks = args
        if tracks.shape[0] % n:
            raise ValueError(f"{tracks.shape[0]} tracks do not split over "
                             f"{n} ranks; pad them to a multiple")
        per = tracks.shape[0] // n
        return all_gather_cat(graph(*nets, tracks[r * per:(r + 1) * per]), group)

    return fn, n


def _padded_dispatch(fn, n_ranks: int, nets: tuple, tracks: torch.Tensor):
    """fn over the tracks zero-padded to a multiple of n_ranks, cropped."""
    n_tracks = tracks.shape[0]
    padded = -(-n_tracks // n_ranks) * n_ranks
    return fn(*nets, _pad_rows(tracks, padded))[:n_tracks]


def make_batch_fn(cfg: SeparatorConfig, mesh: DeviceMesh, n_stems: int):
    """(fn, n_ranks): fn(stacked_params, tracks) -> (B, S, 2, out_len), the
    tracks (B a multiple of n_ranks) spread over the flattened mesh, each
    rank running separate.separate_nstem_batch (one K1, one U-Net pass, one
    K7) on its tracks, the stems gathered on every rank. Tracks are
    independent, so nothing else crosses ranks."""
    require_spleeter(cfg, "the mesh")
    if n_stems not in (4, 5):
        # The per-stem out-of-band weights are a property of the stem
        # family, not the count: a 2-net stack is not the 2-stem offline
        # graph (unaffected_weight 0.1 plus a time-domain residual,
        # Executable/main.c:773,794-798), which is make_batch2_fn.
        raise ValueError(
            f"make_batch_fn supports the 4- and 5-stem families, got "
            f"{n_stems} stacked nets; for the single-net 2-stem offline "
            f"graph use make_batch2_fn / separate_2stem_batch_sharded")
    out_band = {4: separate.OUT_BAND_4, 5: separate.OUT_BAND_5}[n_stems]
    return _over_ranks(mesh, lambda p, tracks: separate.separate_nstem_batch(
        p, tracks, cfg, out_band))


def make_batch2_fn(cfg: SeparatorConfig, mesh: DeviceMesh):
    """(fn, n_ranks): fn(params, tracks) -> (B, 2, 2ch, out_len), the
    single-net 2-stem offline graph (Executable/main.c:779-808) with the
    tracks spread over the flattened mesh."""
    require_spleeter(cfg, "the mesh")
    return _over_ranks(mesh, lambda p, tracks: separate.separate_2stem_batch(
        p, tracks, cfg))


def make_batch3_fn(cfg: SeparatorConfig, mesh: DeviceMesh):
    """(fn, n_ranks): fn(params4, params2, tracks) -> (B, 3, 2ch, out_len),
    the two-pass 3-stem graph (Executable/main.c:845-970) with the tracks
    spread over the flattened mesh."""
    require_spleeter(cfg, "the mesh")
    return _over_ranks(mesh, lambda p4, p2, tracks: separate.separate_3stem_batch(
        p4, p2, tracks, cfg))


def separate_2stem_batch_sharded(
    params: Params,  # one net, no stem axis
    tracks: torch.Tensor,  # (B, 2, n) pre-padded to equal length
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """Batched 2-stem separation with the tracks spread over the mesh ->
    (B, 2 stems, 2ch, out_len) on every rank; B is zero-padded to a
    multiple of the ranks and cropped. Collective."""
    fn, n = make_batch2_fn(cfg, mesh)
    return _padded_dispatch(fn, n, (params,), tracks)


def separate_3stem_batch_sharded(
    params4: Params,  # pass-1 (4-stem-family) net, no stem axis
    params2: Params,  # pass-2 (2-stem) net
    tracks: torch.Tensor,  # (B, 2, n) pre-padded to equal length
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """Batched 3-stem separation with the tracks spread over the mesh ->
    (B, 3, 2ch, out_len) on every rank, padded and cropped as the 2-stem
    batch. Collective."""
    fn, n = make_batch3_fn(cfg, mesh)
    return _padded_dispatch(fn, n, (params4, params2), tracks)


def separate_batch_sharded(
    stacked_params: Params,
    tracks: torch.Tensor,  # (B, 2, n) pre-padded to equal length
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """Batched multi-track separation with the tracks spread over the mesh:
    the BASELINE "64 stereo tracks concurrently, sharded across chips"
    shape. Every rank runs the full N-stem fused graph on its tracks;
    returns (B, S, 2, out_len) on every rank, B zero-padded to a multiple
    of the ranks and cropped. Collective."""
    fn, n = make_batch_fn(cfg, mesh, num_stems(stacked_params))
    return _padded_dispatch(fn, n, (stacked_params,), tracks)


def compute_masks_sharded_single(
    params: Params,
    spec: torch.Tensor,
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
    stem_mode: int,
) -> torch.Tensor:
    """Single-net masks with the tiles spread over every rank of the mesh
    (the frame-block data parallelism of the 2- and 3-stem graphs,
    Executable/main.c:779-970): (2, n_frames, bin_limit) on every rank.
    Collective."""
    require_spleeter(cfg, "the mesh")
    return separate.compute_masks(params, spec, cfg, stem_mode,
                                  sharded_unet(mesh, stems_over_mesh=False))


def separate_2stem_sharded(
    params: Params,
    audio: torch.Tensor,  # (2, data_size) pre-padded
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """The 2-stem graph (separate.separate_2stem: vocals through the masked
    iSTFT, accompaniment = input - vocals in time) with its tiles spread
    over every rank -> (2, 2ch, out_len) on every rank. Collective."""
    require_spleeter(cfg, "the mesh")
    return separate.separate_2stem(params, audio, cfg,
                                   sharded_unet(mesh, stems_over_mesh=False))


def separate_3stem_sharded(
    params4: Params,
    params2: Params,
    audio: torch.Tensor,  # (2, data_size) pre-padded
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """The two-pass 3-stem graph (separate.separate_3stem: the frequency-
    domain residual of pass 1 feeds pass 2) with the tiles of both passes
    spread over every rank -> (3, 2ch, out_len) = (drums, vocals,
    accompaniment) on every rank. Collective."""
    require_spleeter(cfg, "the mesh")
    return separate.separate_3stem(params4, params2, audio, cfg,
                                   sharded_unet(mesh, stems_over_mesh=False))


def make_stream_fn(cfg: SeparatorConfig, mesh: DeviceMesh, n_stems: int = 4,
                   out_band: tuple[float, ...] | None = None):
    """(step_fn, n_ranks) for K concurrent streams spread over the
    flattened mesh, the multi-card serving shape of the RT engine (one VST
    instance a stream, VST/Source/Spleeter4Stems.c:512-582).

    step_fn(params, state, blocks) -> (new_state, out_blocks): `blocks`
    (K, 2, T * HOP) holds every stream's block (K a multiple of n_ranks),
    `state` this rank's K / n_ranks streams' carry
    (stream.init_state_streams(cfg, n_stems, K // n_ranks, device) before
    the first block), sharded on its leading stream axis as the
    reference's. Each rank runs stream.block_step_streams (K1, the U-Net,
    the streaming synthesis) on its streams; `out_blocks` (K, S, 2, T * HOP) is gathered on
    every rank. Collective."""
    require_spleeter(cfg, "the mesh")
    if out_band is None:
        out_band = stream_mod.RT_OUT_BAND[:n_stems]
    group, n, r = _flat(mesh)

    def step_fn(params, state, blocks):
        if blocks.shape[0] % n:
            raise ValueError(f"{blocks.shape[0]} streams do not split over "
                             f"{n} ranks")
        per = blocks.shape[0] // n
        if state.in_tail.shape[0] != per:
            raise ValueError(f"the state holds {state.in_tail.shape[0]} "
                             f"streams, this rank's share is {per}")
        new_state, out = stream_mod.block_step_streams(
            params, state, blocks[r * per:(r + 1) * per], cfg, n_stems,
            out_band)
        return new_state, all_gather_cat(out, group)

    return step_fn, n


def stream_scan_sharded(
    stacked_params: Params,
    audio: torch.Tensor,  # (2, n_blocks * T * HOP)
    cfg: SeparatorConfig,
    mesh: DeviceMesh,
    n_stems: int = 4,
    out_band: tuple[float, ...] | None = None,
    freq_temporal: float = 1.0,
) -> torch.Tensor:
    """The streaming engine with the per-stem U-Nets spread over "stem"
    (the VST's per-stem NN threads, Spleeter4Stems.c TASK_NB=5): each stem
    group scans the whole signal for its own stems (stream.stream_scan, its
    kernels live), since mask inference, masked synthesis and overlap-add
    are per stem; the analysis (K1) runs in every group. Returns (S, 2,
    n_blocks * T * HOP) on every rank, as stream.stream_scan. Stem counts
    that do not divide the "stem" axis pad the last groups' output with
    silence for the gather. Collective."""
    require_spleeter(cfg, "the mesh")
    if out_band is None:
        out_band = stream_mod.RT_OUT_BAND[:n_stems]
    if len(out_band) != n_stems or num_stems(stacked_params) != n_stems:
        raise ValueError(
            f"out_band has {len(out_band)} weights and the params "
            f"{num_stems(stacked_params)} nets for {n_stems} stems")
    group, n_groups, g = _axis(mesh, "stem")
    lo, hi, per = _share(n_stems, n_groups, g)
    n_out = audio.shape[-1] // (cfg.time_step * stream_mod.HOP) * (
        cfg.time_step * stream_mod.HOP)
    if hi > lo:
        out = stream_mod.stream_scan(
            _stem_slice(stacked_params, lo, hi), audio, cfg, hi - lo,
            tuple(out_band[lo:hi]), freq_temporal)
    else:
        out = torch.zeros((0, 2, n_out), device=audio.device)
    return all_gather_cat(_pad_rows(out, per), group)[:n_stems]
