"""BS-RoFormer's rotary embedding in one kernel: wrapper, plain version and
launch count.

One CUDA kernel (csrc/rope.cu; built by kernels/_build.py) takes q and k
from an attention layer's `to_qkvg` product (core/roformer.py::attention)
to the attention's operands: every interleaved pair of each q and k head
turned by the rotary table at its row's position, in float32, and rounded
once to the product's dtype. It replaces no TPU kernel: the JAX package
has no BS-RoFormer.

The wrapper checks device, dtype, shape, row stride and alignment. A
tensor on the CPU goes to the plain version beside it (a float32 copy of
q and k, their complex64 product with the table and the cast back); a
CUDA tensor launches the kernel or raises. Launches are counted in the
package's registry (`spleeterrt_tpu_torch.kernels.launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spleeterrt_tpu_torch.kernels import (
    DTYPES,
    _build,
    check_no_grad,
    check_tensor as _check,
    count_launch,
    launch as _launch,
    stream_of,
)
from spleeterrt_tpu_torch.utils.timing import traced

VEC_BYTES = 16  # the kernel reads and writes 16-byte vectors


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spleeterrt_rope_qk.argtypes = [p, p, i, i, i, i, i, i, p, p]
    lib.spleeterrt_rope_qk.restype = i
    return lib


def rope_qk_plain(qkvg: torch.Tensor, rot: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of :func:`rope_qk`: a float32 copy of q and k, their
    complex64 product with the table, the cast back."""
    n, length, _ = qkvg.shape
    dh = 2 * rot.shape[1]
    qk = torch.view_as_complex(
        qkvg[..., : 2 * heads * dh].float().contiguous().view(n, length, 2 * heads, dh // 2, 2))
    return torch.view_as_real(qk * rot[:, None]).to(qkvg.dtype).view(n, length, 2, heads, dh)


def rope_qk_error(got: torch.Tensor, want: torch.Tensor, qkvg: torch.Tensor,
                  rot: torch.Tensor, heads: int) -> tuple[float, float]:
    """How far :func:`rope_qk`'s `got` lies from its plain version's `want`
    on the same arguments: (the largest |got - want| over its bound, the
    share of values bit-equal). The bound is one rounding to got's dtype,
    plus the float32 roundings of the rotation's two products: the kernel
    rounds each product before the sum, torch's product on the card may
    fuse one into the sum, and where the sum cancels that shows above the
    result's own rounding."""
    n, length, _ = qkvg.shape
    dh = 2 * rot.shape[1]
    a = qkvg[..., : 2 * heads * dh].float().abs().view(n, length, 2 * heads, dh // 2, 2)
    t = torch.view_as_real(rot).abs()[:, None]
    scale = torch.stack([a[..., 0] * t[..., 0] + a[..., 1] * t[..., 1],
                         a[..., 0] * t[..., 1] + a[..., 1] * t[..., 0]], -1)
    del a
    g, w = got.float(), want.float()
    bound = (torch.finfo(got.dtype).eps * torch.maximum(g.abs(), w.abs())
             + 2**-22 * scale.view(got.shape))
    del scale
    diff = (g - w).abs()
    ratio = torch.where(diff == 0, 0.0, diff / bound)  # no 0 / 0 where both are 0
    return ratio.max().item(), (diff == 0).float().mean().item()


def _check_args(qkvg: torch.Tensor, rot: torch.Tensor, heads: int) -> int:
    """Check the arguments; returns dim_head."""
    dev = qkvg.device
    _check(qkvg, "qkvg", DTYPES, 3, dev)
    _check(rot, "rot", torch.complex64, 2, dev)
    n, length, width = qkvg.shape
    dh = 2 * rot.shape[1]
    if not (n and length and dh and heads >= 1):
        raise ValueError("need at least one sequence, one position, one head and one pair")
    if rot.shape[0] != length:
        raise ValueError(f"rot has {rot.shape[0]} positions, the sequences {length}")
    per_vec = VEC_BYTES // qkvg.element_size()
    if dh % per_vec:
        raise ValueError(f"dim_head {dh} is not a whole number of {per_vec}-element vectors")
    if width < 2 * heads * dh:
        raise ValueError(f"qkvg has {width} columns; q and k of {heads} heads of {dh} "
                         f"take {2 * heads * dh}")
    if width % per_vec:
        raise ValueError(f"qkvg's rows ({width} elements) do not start on {VEC_BYTES} bytes")
    if qkvg.data_ptr() % VEC_BYTES or rot.data_ptr() % VEC_BYTES:
        raise ValueError(f"qkvg and rot must be {VEC_BYTES}-byte aligned")
    if n * length >= 2**31:
        raise ValueError("too many rows for one launch")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dh


@traced("kernels.rope_qk")
def rope_qk(
    qkvg: torch.Tensor,  # (N, L, W) bf16 or float32: q, k, v and gates a row
    rot: torch.Tensor,  # (L, dim_head / 2) complex64 rotary table
    heads: int,
) -> torch.Tensor:
    """-> (N, L, 2, heads, dim_head), a fresh tensor of qkvg's dtype: q
    (index 0) and k (index 1), the first 2 * heads * dim_head columns of
    each row, each interleaved pair of a head times the table's entry at
    the row's position l, as a complex product in float32."""
    check_no_grad("rope_qk", qkvg, rot)
    dh = _check_args(qkvg, rot, heads)
    if qkvg.device.type == "cpu":
        return rope_qk_plain(qkvg, rot, heads)
    n, length, width = qkvg.shape
    dev = qkvg.device
    out = torch.empty((n, length, 2, heads, dh), dtype=qkvg.dtype, device=dev)
    with torch.cuda.device(dev):
        _launch(
            _lib().spleeterrt_rope_qk,
            qkvg.data_ptr(), torch.view_as_real(rot).data_ptr(), n * length, length,
            width, 2 * heads * dh, dh // 2, int(qkvg.dtype == torch.bfloat16),
            out.data_ptr(), stream_of(dev),
        )
    count_launch("rope_qk")
    return out
