"""The streaming engine's synthesis in one kernel: wrapper, plain version and
launch count.

One CUDA kernel (csrc/stream_synthesis.cu, on the register-radix FFT core
of csrc/fft2048_radix.cuh; built by kernels/_build.py) turns a block's
spectra and each stem's masks into the block's output audio: the mask
multiply, the 4096-point inverse FFTs, the synthesis window on each frame's
last 2048 samples and the overlap-add with the carry from the block before.
It replaces no TPU kernel: the reference package runs the same chain as
plain XLA around its K8 (spleeterrt_tpu/runtime/stream.py).

The wrapper checks device, dtype, shape, contiguity and alignment. A tensor
on the CPU goes to the plain version beside it (the mask multiply, K8's
plain version and the overlap-add in torch); a CUDA tensor launches the
kernel or raises. Launches are counted in the package's registry
(`spleeterrt_tpu_torch.kernels.launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spleeterrt_tpu_torch.kernels import (
    _build,
    check_no_grad,
    check_tensor as _check,
    count_launch,
    irfft_twiddles,
    launch as _launch,
    pallas_fft,
    stream_of,
)
from spleeterrt_tpu_torch.utils.timing import traced

N = 4096
N_BINS = N // 2 + 1
HOP = 1024
SAMPLE_SHIFT = N - 2 * HOP  # 2048: the synthesis window is zero before it
SYNTH_LEN = N - SAMPLE_SHIFT  # 2048

# A group of 128 threads walks SYNTH_RUN_HOPS output hops of one (stem,
# stream, channel); a block holds SYNTH_GROUPS groups (1 or 2). Chosen with
# `python -m spleeterrt_tpu_torch.kernels.sweep_ends` (csrc/stream_synthesis.cu).
SYNTH_RUN_HOPS = 32
SYNTH_GROUPS = 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spleeterrt_stream_synthesis4096.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.spleeterrt_stream_synthesis4096.restype = i
    lib.spleeterrt_stream_synthesis4096_attrs.argtypes = [i, p]
    lib.spleeterrt_stream_synthesis4096_attrs.restype = i
    return lib


def masked_spectrum(
    spec2: torch.Tensor,  # (K, 2, T, N_BINS) complex64
    masks2: torch.Tensor,  # (S, K, 2, T, bin_limit)
    out_band: torch.Tensor,  # (S,) float32
) -> torch.Tensor:
    """-> (K, S, 2, T, N_BINS) complex64: each stem's mask below bin_limit
    and its out-of-band weight from there on."""
    bl = masks2.shape[-1]
    spec = spec2[:, None]
    return torch.cat([
        spec[..., :bl] * masks2.transpose(0, 1),
        spec[..., bl:] * out_band[:, None, None, None],
    ], dim=-1)


def synthesize(
    frames: torch.Tensor,  # (K, S, 2, T, N) inverse FFTs
    ola_tail: torch.Tensor,  # (K, S, 2, HOP)
    ws: torch.Tensor,  # (SYNTH_LEN,) synthesis window
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out_block (K, S, 2, T * HOP), the next ola_tail): the windowed
    last SYNTH_LEN samples of each frame, overlap-added at HOP. Out hop c
    is tails[c][:HOP] + tails[c-1][HOP:], with c-1 = -1 from the carry."""
    tails = frames[..., SAMPLE_SHIFT:] * ws
    prevs = torch.cat([ola_tail[:, :, :, None], tails[..., :-1, HOP:]], dim=3)
    return (tails[..., :HOP] + prevs).flatten(-2), tails[..., -1, HOP:].clone()


def stream_synthesis4096_plain(
    spec2: torch.Tensor, masks2: torch.Tensor, out_band: torch.Tensor,
    ws: torch.Tensor, ola_tail: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`stream_synthesis4096`: the masked spectrum,
    K8's plain version (torch.fft) and the overlap-add in torch."""
    frames = pallas_fft.irfft4096_plain(masked_spectrum(spec2, masks2, out_band))
    return synthesize(frames, ola_tail, ws)


def _check_args(spec2, masks2, out_band, ws, ola_tail) -> tuple[int, int, int, int]:
    """Check the arguments; returns (K, S, T, bin_limit)."""
    dev = spec2.device
    _check(spec2, "spec2", torch.complex64, 4, dev)
    _check(masks2, "masks2", torch.float32, 5, dev)
    _check(out_band, "out_band", torch.float32, 1, dev)
    _check(ws, "ws", torch.float32, 1, dev)
    _check(ola_tail, "ola_tail", torch.float32, 4, dev)
    k, chans, t, bins = spec2.shape
    s, bl = masks2.shape[0], masks2.shape[-1]
    if chans != 2 or bins != N_BINS:
        raise ValueError(f"spec2: expected (K, 2, T, {N_BINS}), got {tuple(spec2.shape)}")
    if not (k and s and t):
        raise ValueError("need at least one stream, one stem and one frame")
    if tuple(masks2.shape[1:4]) != (k, 2, t) or not 0 < bl <= N_BINS:
        raise ValueError(
            f"masks2: expected (S, {k}, 2, {t}, bin_limit) with 0 < bin_limit "
            f"<= {N_BINS}, got {tuple(masks2.shape)}")
    if out_band.shape[0] != s:
        raise ValueError(f"out_band: expected {s} weights, one a stem, got "
                         f"{out_band.shape[0]}")
    if ws.shape[0] != SYNTH_LEN:
        raise ValueError(f"ws must have {SYNTH_LEN} samples, got {ws.shape[0]}")
    if tuple(ola_tail.shape) != (k, s, 2, HOP):
        raise ValueError(f"ola_tail: expected ({k}, {s}, 2, {HOP}), got "
                         f"{tuple(ola_tail.shape)}")
    if ws.data_ptr() % 8 or ola_tail.data_ptr() % 8:  # read as float2
        raise ValueError("ws and ola_tail must be 8-byte aligned")
    if s * 2 * k * -(-t // SYNTH_RUN_HOPS) >= 2**31:
        raise ValueError("too many (stem, row, run) groups for one launch")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return k, s, t, bl


@traced("kernels.stream_synthesis4096")
def stream_synthesis4096(
    spec2: torch.Tensor,  # (K, 2, T, 2049) complex64, shared by the stems
    masks2: torch.Tensor,  # (S, K, 2, T, bin_limit) float32
    out_band: torch.Tensor,  # (S,) float32 weight of bins >= bin_limit
    ws: torch.Tensor,  # (2048,) float32 synthesis window of samples 2048..4095
    ola_tail: torch.Tensor,  # (K, S, 2, 1024) float32 carry
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out_block (K, S, 2, T * 1024), the next carry (K, S, 2, 1024)),
    both fresh tensors: for each stream, stem and channel, the masked
    spectra's inverse FFTs, their last 2048 samples times `ws`, overlap-added
    at hop 1024 after the carry."""
    check_no_grad("stream_synthesis4096", spec2, masks2, out_band, ws, ola_tail)
    k, s, t, bl = _check_args(spec2, masks2, out_band, ws, ola_tail)
    if spec2.device.type == "cpu":
        return stream_synthesis4096_plain(spec2, masks2, out_band, ws, ola_tail)
    dev = spec2.device
    out = torch.empty((k, s, 2, t * HOP), dtype=torch.float32, device=dev)
    tail = torch.empty((k, s, 2, HOP), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            _lib().spleeterrt_stream_synthesis4096,
            spec2.data_ptr(), masks2.data_ptr(), out_band.data_ptr(),
            ws.data_ptr(), ola_tail.data_ptr(), irfft_twiddles(dev).data_ptr(),
            s, 2 * k, t, bl, SYNTH_RUN_HOPS, SYNTH_GROUPS, out.data_ptr(),
            tail.data_ptr(), stream_of(dev),
        )
    count_launch("stream_synthesis4096")
    return out, tail


def stream_synthesis4096_attrs(device, groups: int | None = None) -> dict[str, int]:
    """The kernel's resources with `groups` groups a block (default
    SYNTH_GROUPS), as the CUDA runtime reports them on `device`: registers
    a thread, dynamic shared memory a block (bytes), threads a block and
    resident blocks an SM."""
    attrs = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _launch(_lib().spleeterrt_stream_synthesis4096_attrs,
                SYNTH_GROUPS if groups is None else groups, attrs)
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"), attrs))
