"""Round-3 U-Net mask head (K10): wrapper, plain version, error bound.

The CUDA kernel (csrc/head.cu, entry `spleeterrt_mask_head`) replaces the
reference package's Pallas kernel spleeterrt_tpu/kernels/mask_head.py::
_head_kernel (reached through mask_head_pallas), the head of the round-3
U-Net route (core/model.py::pallas_head):

    y6   = bn_scale * act(tconv5x5_s2(x, w6) + b6) + bn_shift   (32 -> 1),
           zero outside the image, rounded to x's dtype;
    mask = sigmoid(conv4x4_dil2(y6, w7) + b7) in float32          (1 -> 2).

x = concat[enc1 skip, up5 out] is one NHWC tensor (S * B, T/2, F/2, 32) in
the compute dtype; image s * B + b uses stem s's weights. This is K6's
function (kernels/tail.py::head) with one source instead of two, so both
are one kernel template: K10 reads channels [0, 16) at x and [16, 32) at
x + 16 with a channel stride of 32, and x is never split into two copies.
K6's fixed rule holds (tail._head_tensor_cores): bf16 runs up6 on the
tensor cores, float32 on the FMA template; a bf16 x that is not 16-byte
aligned raises.
The output (S * B, 2, T, F) float32 is channel first, which for one track
is the masked iSTFT's mask layout (S, n_tiles, 2, T, F).

On a CPU tensor the wrapper returns its plain version (torch convolutions
in float32 on the same rounded operands); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from spleeterrt_tpu_torch.kernels import (
    DTYPES,
    check_act,
    check_grid,
    check_no_grad,
    check_tensor,
    count_launch,
    launch,
    stream_of,
    tail,
)
from spleeterrt_tpu_torch.utils.timing import traced

ACTS = tail.ACTS  # elu (4-stem family) / relu (the 2-stem subnet)
WIDTH = 2 * tail.HEAD_WIDTH  # channels of x: [enc1 skip | up5 out]


def _halves(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return x[..., : tail.HEAD_WIDTH], x[..., tail.HEAD_WIDTH :]


def mask_head_plain(x, w6, b6, bn_scale6, bn_shift6, w7, b7, *, act):
    """Plain version of :func:`mask_head`: K6's plain version on x's two
    halves."""
    return tail.head_plain(*_halves(x), w6, b6, bn_scale6, bn_shift6, w7, b7,
                           act=act).flatten(0, 1)


def mask_head_error_bound(x, w6, b6, bn_scale6, bn_shift6, w7, b7, *,
                          act) -> torch.Tensor:
    """Per-pixel bound on |mask_head - mask_head_plain|, (S * B, 2, T, F):
    tail.head_error_bound on x's two halves."""
    return tail.head_error_bound(*_halves(x), w6, b6, bn_scale6, bn_shift6,
                                 w7, b7, act=act).flatten(0, 1)


@traced("kernels.mask_head")
def mask_head(
    x: torch.Tensor,  # (S * B, H, W, 32) NHWC, float32 or bfloat16
    w6: torch.Tensor,  # (S, 32, 1, 5, 5) float32
    b6: torch.Tensor,  # (S, 1) float32; bn_scale6, bn_shift6 the same
    bn_scale6: torch.Tensor,
    bn_shift6: torch.Tensor,
    w7: torch.Tensor,  # (S, 2, 1, 4, 4) float32
    b7: torch.Tensor,  # (S, 2) float32
    *,
    act: str,
) -> torch.Tensor:
    """up6 + up7 + sigmoid -> masks (S * B, 2, 2H, 2W) float32."""
    check_no_grad("mask_head", x, w6, b6, bn_scale6, bn_shift6, w7, b7)
    dev = x.device
    check_tensor(x, "x", DTYPES, 4, dev)
    sb, h, wd, c = x.shape
    if c != WIDTH:
        raise ValueError(f"x must have {WIDTH} channels, got {c}")
    s = tail.check_head_params(dev, sb, w6, b6, bn_scale6, bn_shift6, w7, b7)
    code = check_act(act, ACTS)
    if dev.type == "cpu":
        return mask_head_plain(x, w6, b6, bn_scale6, bn_shift6, w7, b7, act=act)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    tail.check_head_alignment(x.dtype, x)  # x + 16 is then 32 bytes further
    check_grid(sb, "the mask head's images (grid z)")
    masks = torch.empty((sb, 2, 2 * h, 2 * wd), dtype=torch.float32, device=dev)
    w6k, w7k, scal = tail.head_operands(w6, b6, bn_scale6, bn_shift6, w7, b7,
                                        x.dtype)
    with torch.cuda.device(dev):
        launch(
            tail._lib().spleeterrt_mask_head, int(x.dtype == torch.bfloat16),
            x.data_ptr(), w6k.data_ptr(), w7k.data_ptr(), scal.data_ptr(), sb,
            sb // s, h, wd, code, masks.data_ptr(), stream_of(dev),
        )
    count_launch("mask_head")
    return masks
