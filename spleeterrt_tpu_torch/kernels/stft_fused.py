"""Fused forward STFT and fused masked iSTFT-to-audio: wrappers, plain
versions and launch counts.

Two kernels written for Hopper in CUDA C++ (csrc/stft.cu, csrc/istft.cu;
built by kernels/_build.py) replace the reference package's Pallas kernels
spleeterrt_tpu/kernels/stft_fused.py::_stft_kernel (K1) and
::_mistft_kernel (K7). They compute what those compute, not how: the
spectrum is stored as plain complex bins (rows, frames, 2049), the
magnitude is written straight into the U-Net's NCHW tiles, and the masks
are read in the layout the U-Net emits, (S, tracks * n_tiles, rows /
tracks, time_step, bin_limit). A batch of tracks folds into the rows,
track-major (row = track * channels + channel), and each (track, tile)
is one image of the U-Net, so the batch graphs need no interleave pass
between the kernels and the network.

Both run the register-radix 2048-point FFT of K8/K9
(csrc/fft2048_radix.cuh, twiddles `kernels.irfft_twiddles`), one
128-thread group a frame. K1 runs it forward, as conj(inverse(conj z)),
and a block holds STFT_GROUPS groups on consecutive frames of one row
(chosen by `python -m spleeterrt_tpu_torch.kernels.sweep_front` on the
card). K7 overlap-adds in registers: a group walks RUN_HOPS output hops
of one (stem, row) with a three-frame carry, and a block holds
ISTFT_GROUPS groups (both chosen by `python -m
spleeterrt_tpu_torch.kernels.sweep_ends`). Both kernels are float32
throughout, so neither has a rule on dtype.

Each wrapper checks device, dtype, shape and contiguity. A tensor on the
CPU goes to the plain version (`*_plain`, torch.fft) beside it; a CUDA
tensor launches the kernel or raises. Launches are counted in the
package's registry (`spleeterrt_tpu_torch.kernels.launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spleeterrt_tpu_torch.config import TransformConfig
from spleeterrt_tpu_torch.core.transform import overlap_add
from spleeterrt_tpu_torch.kernels import (
    _build,
    check_grid,
    check_no_grad,
    check_tensor as _check,
    count_launch,
    irfft_twiddles,
    launch as _launch,
    stream_of,
)
from spleeterrt_tpu_torch.utils.timing import traced

N = 4096
HOP = 1024  # the reference's only hop (Executable/stftFix.h:14-18)
N_BINS = N // 2 + 1
# K1's shape, chosen by kernels/sweep_front.py on the card: 128-thread
# groups (frames) a block, 1 to 4.
STFT_GROUPS = 2
# K7's shape, chosen by kernels/sweep_ends.py on the card: output hops a
# 128-thread group walks (a multiple of 4), and groups a block (1 to 4).
RUN_HOPS = 32
ISTFT_GROUPS = 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spleeterrt_stft4096.argtypes = [p, ll, ll, p, p, i, i, i, i, i, i, p, p, p]
    lib.spleeterrt_stft4096.restype = i
    lib.spleeterrt_stft4096_attrs.argtypes = [i, ctypes.POINTER(i)]
    lib.spleeterrt_stft4096_attrs.restype = i
    lib.spleeterrt_masked_istft4096.argtypes = [
        p, p, p, p, p, i, ll, i, i, i, i, i, i, i, i, p, p,
    ]
    lib.spleeterrt_masked_istft4096.restype = i
    lib.spleeterrt_masked_istft4096_attrs.argtypes = [i, ctypes.POINTER(i)]
    lib.spleeterrt_masked_istft4096_attrs.restype = i
    return lib


# ---------------------------------------------------------------------------
# Forward: audio -> complex spectrum + magnitude tiles
# ---------------------------------------------------------------------------


def check_tracks(rows: int, tracks: int) -> int:
    """Channels a track: rows / tracks, where `tracks` must divide rows."""
    if tracks < 1 or rows % tracks:
        raise ValueError(f"tracks ({tracks}) must divide the {rows} rows")
    return rows // tracks


def stft4096_plain(
    audio: torch.Tensor, window: torch.Tensor, n_comp: int, n_req: int,
    bin_limit: int, time_step: int, tracks: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`stft4096` (torch.fft)."""
    rows, data_size = audio.shape
    chans = check_tracks(rows, tracks)
    need = (n_comp - 1) * HOP + N
    x = torch.nn.functional.pad(audio, (0, max(0, need - data_size)))[:, :need]
    frames = x.unfold(-1, N, HOP)  # (rows, n_comp, N)
    spec = torch.zeros(
        (rows, n_req, N_BINS), dtype=torch.complex64, device=audio.device
    )
    spec[:, :n_comp] = torch.fft.rfft(frames * window, n=N, dim=-1)
    nt = n_req // time_step
    mag = (
        spec[..., :bin_limit].abs()
        .reshape(tracks, chans, nt, time_step, bin_limit)
        .transpose(1, 2)
        .reshape(tracks * nt, chans, time_step, bin_limit)
        .contiguous()
    )
    return spec, mag


@traced("kernels.stft4096")
def stft4096(
    audio: torch.Tensor,  # (rows, data_size) float32
    window: torch.Tensor,  # (4096,) analysis window
    n_comp: int,  # frames computed; frames in [n_comp, n_req) are zero
    n_req: int,  # frames out, a multiple of time_step
    bin_limit: int,
    time_step: int,
    tracks: int = 1,  # the rows are `tracks` tracks of rows / tracks channels
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (spec, mag): spec (rows, n_req, 2049) complex64, the rfft of each
    hop-1024 frame times `window`; mag (tracks * n_tiles, rows / tracks,
    time_step, bin_limit) float32 with n_tiles = n_req // time_step, |spec|
    on bins < bin_limit in the U-Net's NCHW tile layout: row track * c + ch
    (c = rows / tracks) and frame tile * time_step + t land in image track *
    n_tiles + tile, channel ch, row t. With one track that is (n_tiles,
    rows, time_step, bin_limit)."""
    check_no_grad("stft4096", audio, window)
    dev = audio.device
    _check(audio, "audio", torch.float32, 2, dev)
    _check(window, "window", torch.float32, 1, dev)
    rows, data_size = audio.shape
    chans = check_tracks(rows, tracks)
    if window.shape[0] != N:
        raise ValueError(f"window must have {N} samples")
    if not (0 < n_comp <= n_req) or n_req % time_step:
        raise ValueError("need 0 < n_comp <= n_req and time_step | n_req")
    if not 0 < bin_limit <= N_BINS:
        raise ValueError(f"bin_limit must be in (0, {N_BINS}]")
    if dev.type == "cpu":
        return stft4096_plain(audio, window, n_comp, n_req, bin_limit,
                              time_step, tracks)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if window.data_ptr() % 8:
        raise ValueError("window must be 8-byte aligned")  # float2 loads
    check_grid(rows, "K1's rows (grid y)")
    spec = torch.empty((rows, n_req, N_BINS), dtype=torch.complex64, device=dev)
    mag = torch.empty(
        (tracks * (n_req // time_step), chans, time_step, bin_limit),
        dtype=torch.float32, device=dev,
    )
    with torch.cuda.device(dev):
        _launch(
            _lib().spleeterrt_stft4096,
            audio.data_ptr(), rows, data_size, window.data_ptr(),
            irfft_twiddles(dev).data_ptr(), n_comp, n_req, bin_limit, time_step,
            tracks, STFT_GROUPS, spec.data_ptr(), mag.data_ptr(), stream_of(dev),
        )
    count_launch("stft4096")
    return spec, mag


# ---------------------------------------------------------------------------
# Inverse: spectrum + per-stem masks -> overlap-added audio
# ---------------------------------------------------------------------------


def masked_bins(
    spec: torch.Tensor, masks: torch.Tensor, out_band: torch.Tensor, n_frames: int,
    tracks: int = 1,
) -> torch.Tensor:
    """The spectrum K7 transforms, (S, rows, n_frames, 2049): frame f of
    row track * c + ch times masks[s, track * n_tiles + f // time_step, ch,
    f % time_step] in band and out_band[s] above it."""
    s, images, c, t, f = masks.shape
    nt = images // tracks
    m = (masks.reshape(s, tracks, nt, c, t, f).transpose(2, 3)
         .reshape(s, tracks * c, nt * t, f)[:, :, :n_frames])
    x = spec[:, :n_frames]
    return torch.cat(
        [x[..., :f] * m, x[..., f:] * out_band[:, None, None, None]], dim=-1
    )


def masked_istft4096_plain(
    spec: torch.Tensor, masks: torch.Tensor, out_band: torch.Tensor,
    window: torch.Tensor, n_frames: int, tracks: int = 1,
) -> torch.Tensor:
    """Plain version of :func:`masked_istft4096` (torch.fft)."""
    y = masked_bins(spec, masks, out_band, n_frames, tracks)
    # irfft semantics: the imaginary parts of DC and Nyquist are dropped.
    y[..., 0].imag.zero_()
    y[..., -1].imag.zero_()
    frames = torch.fft.irfft(y, n=N, dim=-1) * window
    return overlap_add(frames, TransformConfig(N, N // HOP))


@traced("kernels.masked_istft4096")
def masked_istft4096(
    spec: torch.Tensor,  # (rows, >= n_frames, 2049) complex64
    masks: torch.Tensor,  # (S, tracks * n_tiles, rows / tracks, T, bin_limit) float32
    out_band: torch.Tensor,  # (S,) float32 weight of bins >= bin_limit
    window: torch.Tensor,  # (4096,) synthesis window
    n_frames: int,
    tracks: int = 1,  # the rows are `tracks` tracks of rows / tracks channels
) -> torch.Tensor:
    """-> (S, rows, n_frames*1024 + 3072) float32 audio: for each stem s,
    overlap_add(irfft(spec * blend(mask_s, out_band_s)) * window), where
    frame f of row track * c + ch reads mask row masks[s, track * n_tiles +
    f // time_step, ch, f % time_step] (the layout :func:`stft4096` gives
    the magnitude, and the U-Net its masks)."""
    check_no_grad("masked_istft4096", spec, masks, out_band, window)
    dev = spec.device
    _check(spec, "spec", torch.complex64, 3, dev)
    _check(masks, "masks", torch.float32, 5, dev)
    _check(out_band, "out_band", torch.float32, 1, dev)
    _check(window, "window", torch.float32, 1, dev)
    rows, n_spec, bins = spec.shape
    s, images, mchans, t, f = masks.shape
    chans = check_tracks(rows, tracks)
    nt = images // tracks
    if bins != N_BINS or window.shape[0] != N:
        raise ValueError(f"spec needs {N_BINS} bins and window {N} samples")
    if (mchans != chans or images != tracks * nt or out_band.shape[0] != s
            or not 0 < f <= N_BINS):
        raise ValueError("masks, spec and out_band disagree on rows, tracks or stems")
    if not 0 < n_frames <= min(n_spec, nt * t):
        raise ValueError("n_frames exceeds the frames of spec or masks")
    if dev.type == "cpu":
        return masked_istft4096_plain(spec, masks, out_band, window, n_frames,
                                      tracks)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if window.data_ptr() % 8:
        raise ValueError("window must be 8-byte aligned")  # float2 loads
    out = torch.empty(
        (s, rows, n_frames * HOP + N - HOP), dtype=torch.float32, device=dev
    )
    with torch.cuda.device(dev):
        _launch(
            _lib().spleeterrt_masked_istft4096,
            spec.data_ptr(), masks.data_ptr(), out_band.data_ptr(),
            window.data_ptr(), irfft_twiddles(dev).data_ptr(), s, rows, tracks,
            n_frames, n_spec, nt, t, f, RUN_HOPS, ISTFT_GROUPS, out.data_ptr(),
            stream_of(dev),
        )
    count_launch("masked_istft4096")
    return out


def istft_attributes(device: torch.device, groups: int | None = None) -> dict[str, int]:
    """K7's resources with `groups` 128-thread groups a block (default
    ISTFT_GROUPS), as the CUDA runtime reports them on `device`: registers
    a thread, dynamic shared memory a block (bytes), threads a block and
    resident blocks an SM."""
    attrs = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _launch(_lib().spleeterrt_masked_istft4096_attrs,
                ISTFT_GROUPS if groups is None else groups, attrs)
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"), attrs))


def stft_attributes(device: torch.device, groups: int | None = None) -> dict[str, int]:
    """K1's resources with `groups` 128-thread groups a block (default
    STFT_GROUPS), as the CUDA runtime reports them on `device`: registers
    a thread, dynamic shared memory a block (bytes), threads a block and
    resident blocks an SM."""
    attrs = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _launch(_lib().spleeterrt_stft4096_attrs,
                STFT_GROUPS if groups is None else groups, attrs)
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"), attrs))
