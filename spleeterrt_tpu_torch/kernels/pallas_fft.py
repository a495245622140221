"""4096-point inverse real FFT with frames out, plain and masked: wrappers,
plain versions and launch counts.

One CUDA kernel template written for Hopper (csrc/irfft.cu, on the
register-radix FFT core of csrc/fft2048_radix.cuh; built by
kernels/_build.py) replaces the Pallas kernels of the reference package's
module of the same name: K8 `irfft4096` for
spleeterrt_tpu/kernels/pallas_fft.py::_irfft_kernel and K9
`masked_irfft4096` for ::_masked_irfft_kernel. The window is a tensor
argument; the reference's registry of window keys exists only for `jit`'s
static arguments.

Each wrapper checks device, dtype, shape and contiguity. A tensor on the
CPU goes to the plain version (`*_plain`, torch.fft) beside it; a CUDA
tensor launches the kernel or raises. Launches are counted in the
package's registry (`spleeterrt_tpu_torch.kernels.launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from spleeterrt_tpu_torch.kernels import (
    _build,
    check_no_grad,
    check_tensor as _check,
    count_launch,
    irfft_twiddles,
    launch as _launch,
    stream_of,
)
from spleeterrt_tpu_torch.utils.timing import traced

N = 4096
N_BINS = N // 2 + 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spleeterrt_irfft4096.argtypes = [p, p, p, i, p, p]
    lib.spleeterrt_irfft4096.restype = i
    lib.spleeterrt_masked_irfft4096.argtypes = [p, p, p, p, p, i, i, i, p, p]
    lib.spleeterrt_masked_irfft4096.restype = i
    return lib


def _irfft_dc_nyquist_real(y: torch.Tensor, window) -> torch.Tensor:
    """irfft(y) * window with the imaginary parts of DC and Nyquist dropped
    explicitly, as irfft's semantics (and the kernel) drop them."""
    y = y.clone()
    y[..., 0].imag.zero_()
    y[..., -1].imag.zero_()
    out = torch.fft.irfft(y, n=N, dim=-1)
    return out if window is None else out * window


def _check_spec_window(spec: torch.Tensor, window) -> int:
    """Check spec (..., 2049) complex64 and the optional (4096,) window;
    returns the number of frames."""
    dev = spec.device
    _check(spec, "spec", torch.complex64, max(spec.ndim, 1), dev)
    if spec.shape[-1] != N_BINS:
        raise ValueError(f"spec needs {N_BINS} bins, got {spec.shape[-1]}")
    if window is not None:
        _check(window, "window", torch.float32, 1, dev)
        if window.shape[0] != N:
            raise ValueError(f"window must have {N} samples")
        if window.data_ptr() % 16:  # the kernel reads it as float4
            raise ValueError("window must be 16-byte aligned")
    n_frames = math.prod(spec.shape[:-1])
    if not 0 < n_frames < 2**31:
        raise ValueError(f"spec must hold 1 to 2**31 - 1 frames, got {n_frames}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return n_frames


# ---------------------------------------------------------------------------
# K8: spectrum -> frames
# ---------------------------------------------------------------------------


def irfft4096_plain(spec: torch.Tensor, window=None) -> torch.Tensor:
    """Plain version of :func:`irfft4096` (torch.fft)."""
    return _irfft_dc_nyquist_real(spec, window)


@traced("kernels.irfft4096")
def irfft4096(
    spec: torch.Tensor,  # (..., 2049) complex64
    window: torch.Tensor | None = None,  # (4096,) float32
) -> torch.Tensor:
    """-> (..., 4096) float32: irfft(spec) * window (no window: irfft),
    frame by frame."""
    check_no_grad("irfft4096", spec, window)
    n_frames = _check_spec_window(spec, window)
    if spec.device.type == "cpu":
        return irfft4096_plain(spec, window)
    dev = spec.device
    out = torch.empty((*spec.shape[:-1], N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            _lib().spleeterrt_irfft4096,
            spec.data_ptr(), None if window is None else window.data_ptr(),
            irfft_twiddles(dev).data_ptr(), n_frames, out.data_ptr(),
            stream_of(dev),
        )
    count_launch("irfft4096")
    return out


# ---------------------------------------------------------------------------
# K9: spectrum shared by the stems + per-stem masks -> frames per stem
# ---------------------------------------------------------------------------


def masked_irfft4096_plain(
    spec: torch.Tensor, masks: torch.Tensor, out_band: torch.Tensor,
    bin_limit: int, window=None,
) -> torch.Tensor:
    """Plain version of :func:`masked_irfft4096` (torch.fft)."""
    s = masks.shape[0]
    fill = out_band.reshape(s, *([1] * spec.ndim)).expand(
        s, *spec.shape[:-1], N_BINS - bin_limit
    )
    gains = torch.cat([masks, fill], dim=-1)
    return _irfft_dc_nyquist_real(spec * gains, window)


@traced("kernels.masked_irfft4096")
def masked_irfft4096(
    spec: torch.Tensor,  # (..., 2049) complex64, shared by the stems
    masks: torch.Tensor,  # (S, ..., bin_limit) float32
    out_band: torch.Tensor,  # (S,) float32 weight of bins >= bin_limit
    bin_limit: int,
    window: torch.Tensor | None = None,  # (4096,) float32
) -> torch.Tensor:
    """-> (S, ..., 4096) float32: for each stem s, irfft(spec * blend) *
    window, where blend is masks[s] below bin_limit and out_band[s] from
    it on (the reference's contract, with the window as a tensor)."""
    check_no_grad("masked_irfft4096", spec, masks, out_band, window)
    n_frames = _check_spec_window(spec, window)
    dev = spec.device
    _check(masks, "masks", torch.float32, spec.ndim + 1, dev)
    _check(out_band, "out_band", torch.float32, 1, dev)
    s = masks.shape[0]
    if tuple(masks.shape[1:]) != (*spec.shape[:-1], bin_limit):
        raise ValueError(
            f"masks: expected (S, *{tuple(spec.shape[:-1])}, {bin_limit}), "
            f"got {tuple(masks.shape)}"
        )
    if not 0 < bin_limit <= N_BINS or out_band.shape[0] != s:
        raise ValueError("need 0 < bin_limit <= 2049 and one out_band per stem")
    if dev.type == "cpu":
        return masked_irfft4096_plain(spec, masks, out_band, bin_limit, window)
    out = torch.empty((s, *spec.shape[:-1], N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            _lib().spleeterrt_masked_irfft4096,
            spec.data_ptr(), masks.data_ptr(), out_band.data_ptr(),
            None if window is None else window.data_ptr(),
            irfft_twiddles(dev).data_ptr(), s, n_frames, bin_limit,
            out.data_ptr(), stream_of(dev),
        )
    count_launch("masked_irfft4096")
    return out
