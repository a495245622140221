"""Stem-grouped U-Net: every stem rides the channel axis.

The counterpart of spleeterrt_tpu/core/grouped.py. S stacked nets run as
one network whose channel axis is [stem-major x channel], channel
s * C + c: each convolution is one library call with groups=S (exactly the
per-stem math, no extra FLOPs), and each bias, batch norm and activation
one pass over every stem. Activations live in channels_last memory, so
cuDNN takes its NHWC tensor-core path in bf16.

The stacked weights need no regrouping: an OIHW conv weight (S, Co, Ci,
kh, kw) is the grouped weight (S * Co, Ci, kh, kw), a transposed conv
weight (S, Cin, Cout, kh, kw) the grouped (S * Cin, Cout, kh, kw) and a
vector (S, C) the grouped (S * C,), each as a view.

core/model.py's round-3 trunk and head and its canonical route (the one
that trains) run on these layers; its mid trunk keeps a loop over stems,
and its single-net functions stay the per-stem formulation. Layer
geometry and fusion order are core/model.py's
(Executable/spleeter.c:111-301).

One library call is not one device kernel: at the U-Net's widths cuDNN
runs a grouped bf16 convolution as one convolution kernel a group with
channel-slice copies around them (PERF.md §6). What
grouping saves is the torch-side work: one weight cast, bias, batch norm,
activation and concat a layer instead of one a stem.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import STEM_MODE_4
from spleeterrt_tpu_torch.core import model
from spleeterrt_tpu_torch.core.model import Params


def gw(stacked: torch.Tensor) -> torch.Tensor:
    """A stacked leaf (S, C, ...) as its grouped form (S * C, ...), a view:
    the reference's `_gw` for conv and transposed conv weights and `_gv`
    for vectors, channel s * C + c."""
    return stacked.flatten(0, 1)


def conv_g(x, w, s: int, b=None) -> torch.Tensor:
    """`model.conv_same` (5x5, stride 2, TF-SAME (1, 2)) with groups=s."""
    return F.conv2d(F.pad(x, (1, 2, 1, 2)), w, b, stride=2, groups=s)


def tconv_g(x, w, s: int) -> torch.Tensor:
    """`model.tconv_same` (5x5 stride-2 TF-SAME transposed) with groups=s."""
    h, wd = x.shape[-2:]
    y = F.conv_transpose2d(x, w, stride=2, padding=1, groups=s)
    return y[..., : 2 * h, : 2 * wd]


def final_g(x, w, s: int) -> torch.Tensor:
    """`model.conv_dilated_final` (4x4, dilation 2, padding 3), groups=s."""
    return F.conv2d(x, w, padding=3, dilation=2, groups=s)


def to_grouped(x: torch.Tensor, s: int) -> torch.Tensor:
    """Image-major NHWC (S * B, H, W, C), image s * B + b (the kernels'
    layout) -> grouped (B, S * C, H, W) in channels_last memory."""
    sb, h, w, c = x.shape
    b = sb // s
    x = x.reshape(s, b, h, w, c).permute(1, 2, 3, 0, 4).reshape(b, h, w, s * c)
    return x.permute(0, 3, 1, 2)


def from_grouped(x: torch.Tensor, s: int) -> torch.Tensor:
    """Grouped (B, S * C, H, W) -> image-major NHWC (S * B, H, W, C),
    contiguous: the inverse of `to_grouped`."""
    b, sc, h, w = x.shape
    c = sc // s
    x = x.permute(0, 2, 3, 1).reshape(b, h, w, s, c).permute(3, 0, 1, 2, 4)
    return x.reshape(s * b, h, w, c).contiguous()


def concat_g(skip: torch.Tensor, y: torch.Tensor, s: int) -> torch.Tensor:
    """The group-aware skip concat: per stem [skip_s, y_s] -> (B, S * (Cs +
    Cy), H, W) in channels_last memory."""
    b, _, h, w = y.shape
    parts = [a.permute(0, 2, 3, 1).reshape(b, h, w, s, -1) for a in (skip, y)]
    return torch.cat(parts, dim=-1).reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _caster(compute_dtype):
    """(cast for vectors, cast for 4-D weights): a weight is cast and put
    in channels_last, the layout cuDNN reads beside channels_last
    activations, in one copy."""
    return (lambda a: a.to(compute_dtype),
            lambda w: w.to(compute_dtype, memory_format=torch.channels_last))


def encoder(stacked: Params, x, layers, skips: list, s: int, stem_mode: int,
            compute_dtype) -> torch.Tensor:
    """Grouped encoder layers `layers` from x, each pre-activation conv
    appended to `skips`; returns the last activation, or down6's
    bias-only output. enc1 reads the stems' one shared 2-channel
    magnitude: one ungrouped convolution with every stem's filters, (S *
    16, 2, 5, 5), in place of the reference's tiled input."""
    cast, wcast = _caster(compute_dtype)
    for i in layers:
        ly = stacked[f"down{i}"]
        conv = conv_g(x, wcast(gw(ly["w"])), 1 if i == 1 else s,
                      cast(gw(ly["b"])))
        if i == 6:
            return conv
        skips.append(conv)
        x = model.act_encoder(cast(gw(ly["bn_scale"]))[:, None, None] * conv
                              + cast(gw(ly["bn_shift"]))[:, None, None],
                              stem_mode)
    return x


def decoder(ly, x: torch.Tensor, s: int, stem_mode: int,
            compute_dtype) -> torch.Tensor:
    """One grouped decoder layer: bn_scale * act(tconv(x) + b) + bn_shift.
    The bias is added to the cropped transposed conv, not by the library
    call before the crop: the same sums, and the pass that reads the crop
    (a strided view) is that one add rather than the activation's."""
    cast, wcast = _caster(compute_dtype)
    y = tconv_g(x, wcast(gw(ly["w"])), s) + cast(gw(ly["b"]))[:, None, None]
    return (cast(gw(ly["bn_scale"]))[:, None, None] * model.act_decoder(y, stem_mode)
            + cast(gw(ly["bn_shift"]))[:, None, None])


def trunk_tail(stacked: Params, x, skips3: list, s: int, stem_mode: int,
               compute_dtype) -> torch.Tensor:
    """Grouped enc4..enc6 + up1..up5 from enc3's activation and the enc1..
    enc3 skips -> up6's input, per stem [enc1 skip, up5 out]."""
    skips = list(skips3)
    x = encoder(stacked, x, range(4, 7), skips, s, stem_mode, compute_dtype)
    for i in range(1, 6):
        y = decoder(stacked[f"up{i}"], x, s, stem_mode, compute_dtype)
        x = concat_g(skips[5 - i], y, s)
    return x


def unet_trunk(stacked: Params, magnitude: torch.Tensor, stem_mode: int,
               compute_dtype) -> torch.Tensor:
    """Every stem's enc1..up5 over the shared NCHW magnitude (B, 2, T, F)
    -> grouped up6 input (B, S * C, T/2, F/2)."""
    s = model.num_stems(stacked)
    x = magnitude.to(compute_dtype).contiguous(memory_format=torch.channels_last)
    skips: list[torch.Tensor] = []
    x = encoder(stacked, x, range(1, 4), skips, s, stem_mode, compute_dtype)
    return trunk_tail(stacked, x, skips, s, stem_mode, compute_dtype)


def head(stacked: Params, x: torch.Tensor, stem_mode: int, compute_dtype,
         sigmoid: str = "exact") -> torch.Tensor:
    """Grouped up6 + up7 + sigmoid over grouped up6 input (B, S * C, T/2,
    F/2) -> masks (S, B, 2, T, F) float32, contiguous. Only the final
    logits are promoted to float32."""
    s = model.num_stems(stacked)
    _, wcast = _caster(compute_dtype)
    y = decoder(stacked["up6"], x, s, stem_mode, compute_dtype)
    ly7 = stacked["up7"]
    logits = (final_g(y, wcast(gw(ly7["w"])), s).float()
              + gw(ly7["b"]).float()[:, None, None])
    mask = model.fast_sigmoid(logits) if sigmoid == "lut" else torch.sigmoid(logits)
    return mask.unflatten(1, (s, 2)).transpose(0, 1).contiguous()


def multi_stem_forward_grouped(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, T, F, 2)
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.bfloat16,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """S stacked nets on one magnitude batch -> (S, B, T, F, 2), the
    reference's `multi_stem_forward_grouped`."""
    x = unet_trunk(stacked_params, magnitude.permute(0, 3, 1, 2), stem_mode,
                   compute_dtype)
    return head(stacked_params, x, stem_mode, compute_dtype,
                sigmoid).permute(0, 1, 3, 4, 2)
