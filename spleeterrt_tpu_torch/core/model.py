"""Spleeter U-Net forward pass as plain functions over a params dict.

Reference semantics (Executable/spleeter.c:111-301) in PyTorch's NCHW
layout, with torch's own weight layouts (the C blob layouts, see
core/weights.py):

- 6 encoder convs: 5x5, stride 2, weights (Cout, Cin, 5, 5). The
  reference's im2col offset arithmetic resolves to input index
  `2*out + k - 1`, i.e. TF-SAME asymmetric padding (1, 2) per spatial dim.
- 6 decoder transposed convs: 5x5, stride 2, weights (Cin, Cout, 5, 5).
  The col2im scatter resolves to `out[2*in + k - 1] += x[in] * w[k]`:
  `conv_transpose2d(stride=2, padding=1)` (2H + 1 rows) cropped to 2H.
- Final conv: 4x4, dilation 2, stride 1, padding 3: taps at {-3,-1,+1,+3}.
- Fusion order (Executable/spleeter.c:177-301): encoder
  `act(bn_scale * (conv + bias) + bn_shift)` with the PRE-activation
  `conv + bias` retained as the skip tensor; bottleneck bias-only; decoder
  `bn_scale * act(tconv + bias) + bn_shift` (activation BEFORE batch norm);
  skip concat is [skip, upsampled] along channels; mask =
  sigmoid(final_conv + bias).

Activations (Executable/spleeter.c:43-56,130-139): stem mode 0 (2-stem
subnet) uses leakyReLU(0.2) encoder / ReLU decoder; mode 1 (4-stem family)
uses ELU everywhere with inputs below -15 clamped to -1.

Public functions keep the reference package's NHWC (batch, time, bins, 2)
layout; the separation pipeline calls the NCHW forms directly.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import STEM_MODE_2, STEM_MODE_4

# (Cin, Cout) per encoder layer (Executable/spleeter.c:144-149).
ENCODER_CHANNELS = ((2, 16), (16, 32), (32, 64), (64, 128), (128, 256), (256, 512))
# (Cin, Cout) per decoder layer; Cin includes the skip concat
# (Executable/spleeter.c:150-155).
DECODER_CHANNELS = ((512, 256), (512, 128), (256, 64), (128, 32), (64, 16), (32, 1))
FINAL_CHANNELS = (1, 2)

Params = dict[str, dict[str, torch.Tensor]]


def init_params(
    generator: torch.Generator, dtype=torch.float32, device=None
) -> Params:
    """Random params with the blob's shapes: he-normal fan-in weights, zero
    bias, unit batch-norm scale, zero shift."""

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dtype)
        return (w * math.sqrt(2.0 / fan_in)).to(device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    params: Params = {}
    for i, (cin, cout) in enumerate(ENCODER_CHANNELS, start=1):
        layer = {"w": normal((cout, cin, 5, 5), 25 * cin), "b": zeros(cout)}
        if i < 6:  # down6 (bottleneck) has no batch norm
            layer["bn_scale"] = torch.ones(cout, dtype=dtype, device=device)
            layer["bn_shift"] = zeros(cout)
        params[f"down{i}"] = layer
    for i, (cin, cout) in enumerate(DECODER_CHANNELS, start=1):
        params[f"up{i}"] = {
            "w": normal((cin, cout, 5, 5), 25 * cin),
            "b": zeros(cout),
            "bn_scale": torch.ones(cout, dtype=dtype, device=device),
            "bn_shift": zeros(cout),
        }
    cin, cout = FINAL_CHANNELS
    params["up7"] = {"w": normal((cout, cin, 4, 4), 16 * cin), "b": zeros(cout)}
    return params


def elu(x: torch.Tensor) -> torch.Tensor:
    # Denormal guard: x < -15 -> -1 exactly (Executable/spleeter.c:51-56).
    return torch.where(x < -15.0, -1.0, F.elu(x))


def act_encoder(x: torch.Tensor, stem_mode: int) -> torch.Tensor:
    if stem_mode == STEM_MODE_2:
        return F.leaky_relu(x, 0.2)  # leakyReLU (spleeter.c:43-46)
    return elu(x)


def act_decoder(x: torch.Tensor, stem_mode: int) -> torch.Tensor:
    if stem_mode == STEM_MODE_2:
        return torch.relu(x)  # ReLU (spleeter.c:47-50)
    return elu(x)


def fast_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear sigmoid over 1025 knots on [-7, 7], clamped outside
    (the reference exe's LUT, Executable/spleeter.c:30-42: sigmoid sampled
    at -7 + i*14/1024 with the last entry forced to 1)."""
    step = 14.0 / 1024.0
    idx = torch.clamp(torch.floor((x + 7.0) / step), 0, 1023)
    x1 = -7.0 + step * idx
    y0 = torch.sigmoid(x1)
    y1 = torch.where(idx >= 1023, 1.0, torch.sigmoid(x1 + step))
    y = y0 + (y1 - y0) / step * (x - x1)
    return torch.where(x > 7.0, 1.0, torch.where(x < -7.0, 0.0, y))


def conv_same(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """5x5 stride-2 conv with the reference's TF-SAME (1,2) padding."""
    return F.conv2d(F.pad(x, (1, 2, 1, 2)), w, b, stride=2)


def tconv_same(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """5x5 stride-2 TF-SAME transposed conv (out[2h + k - 1] += x[h] w[k])."""
    h, wd = x.shape[-2:]
    y = F.conv_transpose2d(x, w, b, stride=2, padding=1)
    return y[..., : 2 * h, : 2 * wd]


def conv_dilated_final(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """4x4 dilation-2 stride-1 conv, padding 3: taps at -3,-1,+1,+3."""
    return F.conv2d(x, w, b, padding=3, dilation=2)


def unet_forward_nchw(
    params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F)
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """Magnitude (B, 2, T, F) -> fp32 soft mask (B, 2, T, F) in [0, 1].

    Everything runs in `compute_dtype`; only the final logits are promoted
    to fp32 for the sigmoid.
    """
    cast = lambda a: a.to(compute_dtype)

    def chan(v):  # per-channel vector, broadcast over (H, W)
        return cast(v)[:, None, None]

    x = cast(magnitude)
    skips = []
    for i in range(1, 7):
        ly = params[f"down{i}"]
        conv = conv_same(x, cast(ly["w"]), cast(ly["b"]))
        if i < 6:
            skips.append(conv)
            x = act_encoder(
                chan(ly["bn_scale"]) * conv + chan(ly["bn_shift"]), stem_mode
            )
        else:
            x = conv  # bottleneck: bias only (spleeter.c:231-238)
    for i in range(1, 7):
        ly = params[f"up{i}"]
        y = tconv_same(x, cast(ly["w"]), cast(ly["b"]))
        x = chan(ly["bn_scale"]) * act_decoder(y, stem_mode) + chan(ly["bn_shift"])
        if i < 6:
            # concat [skip, upsampled]; skips are pre-BN/act conv outputs.
            x = torch.cat([skips[5 - i], x], dim=1)
    ly = params["up7"]
    logits = conv_dilated_final(x, cast(ly["w"])).float() + ly["b"].float()[
        :, None, None
    ]
    if sigmoid == "lut":
        return fast_sigmoid(logits)
    return torch.sigmoid(logits)


def unet_forward(
    params: Params,
    magnitude: torch.Tensor,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """Magnitude (batch, T, F, 2) or (T, F, 2) -> mask of the same shape.

    T and F must be divisible by 64 (six stride-2 halvings)."""
    x = magnitude if magnitude.ndim == 4 else magnitude[None]
    out = unet_forward_nchw(
        params, x.permute(0, 3, 1, 2), stem_mode, compute_dtype, sigmoid
    ).permute(0, 2, 3, 1)
    return out if magnitude.ndim == 4 else out[0]


def stem_params(stacked_params: Params, s: int) -> Params:
    """The s-th net of a stacked (leading stem axis) params dict."""
    return {ln: {fn: v[s] for fn, v in ly.items()} for ln, ly in stacked_params.items()}


def num_stems(stacked_params: Params) -> int:
    return stacked_params["up7"]["w"].shape[0]


def multi_stem_masks(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """S stacked nets over one NCHW magnitude batch -> (S, B, 2, T, F) fp32.

    The reference runs one net per thread (VST/Source/Spleeter4Stems.c:135);
    here the nets run one after the other, each over the whole tile batch.
    """
    return torch.stack([
        unet_forward_nchw(
            stem_params(stacked_params, s), magnitude, stem_mode,
            compute_dtype, sigmoid,
        )
        for s in range(num_stems(stacked_params))
    ])


def multi_stem_forward(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, T, F, 2), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """Run S stacked U-Nets over one magnitude batch -> (S, B, T, F, 2)."""
    return multi_stem_masks(
        stacked_params, magnitude.permute(0, 3, 1, 2), stem_mode,
        compute_dtype, sigmoid,
    ).permute(0, 1, 3, 4, 2)
