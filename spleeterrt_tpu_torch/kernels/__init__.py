"""The port's hand-written CUDA kernels: wrappers, plain versions, counts.

K1 `stft_fused.stft4096`, K2 `encoder.enc1`, K3 `encoder.enc_s2` (enc2,
enc3 and enc4), K4 and K5 `tail.up_shallow` (up4, up5), K6 `tail.head`,
K7 `stft_fused.masked_istft4096`, K8 `pallas_fft.irfft4096`, K9
`pallas_fft.masked_irfft4096` and K10 `mask_head.mask_head` (the round-3
route's head, K6's kernel template with one source). Each wrapper checks its tensors, takes its
plain torch version for a tensor on the CPU, and launches its kernel or
raises for a CUDA tensor.

Launch counts live here, one per kernel name, so one place shows whether a
run went through the kernels: `reset_launch_counts()` before the run,
`launch_counts()` after. A wrapper counts a launch where it launches its
kernel, never for a plain call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# The compute dtypes the U-Net kernels take, and their activation codes
# (csrc/unet.cuh).
DTYPES = (torch.float32, torch.bfloat16)
ACT_CODES = {"elu": 0, "leaky": 1, "relu": 2}

# Kernel names in dataflow order; up_shallow counts up4 and up5 apart.
KERNELS = ("stft4096", "enc1", "enc_s2", "up4", "up5", "head",
           "masked_istft4096", "irfft4096", "masked_irfft4096", "mask_head")
_launches = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    """Raise ValueError unless `t` is a contiguous `ndim`-D tensor of
    `dtype` (or one of a tuple of dtypes) on `device`."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or t.ndim != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-D {' or '.join(map(str, dtypes))} "
            f"tensor, got {t.ndim}-D {t.dtype}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn, *args) -> None:
    """Call a C launcher; raise if it returns a CUDA error code."""
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {err}")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def twiddles4096() -> np.ndarray:
    """The FFT kernels' split and merge table (csrc/fft2048.cuh): tw[j] =
    exp(-2 pi i j / 4096), j < 2048, in float64 math with one rounding to
    complex64."""
    return np.exp(-2j * np.pi * np.arange(2048) / 4096).astype(np.complex64)


def radix_pass_twiddles() -> np.ndarray:
    """The pass twiddles of the register-radix 2048-point FFT core
    (csrc/fft2048_radix.cuh), each in [r][k] order: exp(+2 pi i r k / 256)
    for r, k < 16 (pass 2), then exp(+2 pi i r j / 2048) for r < 8, j <
    256 (pass 3); float64 math, one rounding to complex64."""
    r2, k2 = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    r3, j3 = np.meshgrid(np.arange(8), np.arange(256), indexing="ij")
    return np.concatenate([
        np.exp(2j * np.pi * r2 * k2 / 256).ravel(),
        np.exp(2j * np.pi * r3 * j3 / 2048).ravel(),
    ]).astype(np.complex64)


@functools.cache
def irfft_twiddles(device: torch.device) -> torch.Tensor:
    """The FFT kernels' table (K1, K7, K8, K9; csrc/fft2048_radix.cuh):
    twiddles4096's 2048 entries, then radix_pass_twiddles' 2304."""
    tw = np.concatenate([twiddles4096(), radix_pass_twiddles()])
    return torch.from_numpy(tw).to(device)


def check_layer(
    device, w: torch.Tensor, w_shape: tuple, vectors: dict[str, torch.Tensor],
    width: int, name: str = "w",
) -> int:
    """Check one layer's stacked float32 params: `w` (S, *w_shape) and each
    of `vectors` (S, width). Returns S."""
    check_tensor(w, name, torch.float32, 1 + len(w_shape), device)
    if tuple(w.shape[1:]) != w_shape:
        raise ValueError(f"{name}: expected (S, *{w_shape}), got {tuple(w.shape)}")
    s = w.shape[0]
    for name, v in vectors.items():
        check_tensor(v, name, torch.float32, 2, device)
        if tuple(v.shape) != (s, width):
            raise ValueError(f"{name}: expected ({s}, {width}), got {tuple(v.shape)}")
    return s


def check_act(act: str, allowed: tuple[str, ...]) -> int:
    if act not in allowed:
        raise ValueError(f"act must be one of {allowed}, got {act!r}")
    return ACT_CODES[act]


def epilogue_table(b, bn_scale, bn_shift) -> torch.Tensor:
    """(S, 3, C) float32: bias, bn_scale and bn_shift of each stem."""
    return torch.stack([b, bn_scale, bn_shift], 1).float().contiguous()
