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

Two routes, as in the reference package (spleeterrt_tpu/core/model.py):
the packed U-Net (`packed_unet_masks`: the hand kernels K2-K6 of
kernels/encoder.py and kernels/tail.py around a plain-torch mid trunk)
wherever `use_packed_unet` holds, which is the standard architecture at
tile shapes the kernels take with the exact sigmoid; otherwise the
canonical per-stem `unet_forward_nchw`. The gate looks at shapes only, not
at the device: on CPU tensors the packed route runs the kernels' plain
versions, on CUDA tensors the kernels.
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


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """The U-Net's activations by the kernels' names (spleeter.c:43-56)."""
    if name == "elu":
        return elu(x)
    if name == "leaky":
        return F.leaky_relu(x, 0.2)
    if name == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {name!r}")


def encoder_act_name(stem_mode: int) -> str:
    return "leaky" if stem_mode == STEM_MODE_2 else "elu"


def decoder_act_name(stem_mode: int) -> str:
    return "relu" if stem_mode == STEM_MODE_2 else "elu"


def act_encoder(x: torch.Tensor, stem_mode: int) -> torch.Tensor:
    return activation(x, encoder_act_name(stem_mode))


def act_decoder(x: torch.Tensor, stem_mode: int) -> torch.Tensor:
    return activation(x, decoder_act_name(stem_mode))


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


# The weight shapes the packed route takes (the reference's
# _use_packed_unet), in this package's layouts: OIHW convs,
# (Cin, Cout, kh, kw) transposed convs.
PACKED_WEIGHT_SHAPES = {
    "down1": (16, 2, 5, 5),
    "down2": (32, 16, 5, 5),
    "down3": (64, 32, 5, 5),
    "down4": (128, 64, 5, 5),
    "up4": (128, 32, 5, 5),
    "up5": (64, 16, 5, 5),
    "up6": (32, 1, 5, 5),
    "up7": (2, 1, 4, 4),
}


def use_packed_unet(
    stacked_params: Params, magnitude: torch.Tensor, sigmoid: str
) -> bool:
    """The reference's routing to its packed U-Net, without its backend
    check: the standard architecture, the exact sigmoid, and NCHW
    magnitude tiles (B, 2, T, F) with T and F positive multiples of 64.
    (The reference's conditions, encoder.supports4, T % 64, F % 64 and the
    head's 32-row tiling of T/2 and 16-column groups of F/2, reduce to
    that.)"""
    if not all(k in stacked_params for k in PACKED_WEIGHT_SHAPES):
        return False
    _, c, t, f = magnitude.shape
    return (
        sigmoid == "exact"
        and all(
            tuple(stacked_params[k]["w"].shape[-4:]) == shape
            for k, shape in PACKED_WEIGHT_SHAPES.items()
        )
        and c == 2 and t >= 64 and f >= 64 and t % 64 == 0 and f % 64 == 0
    )


def mid_trunk(
    stacked_params: Params,
    act4: torch.Tensor,  # (S * B, T/16, F/16, 128) NHWC: enc4's activation
    skip4: torch.Tensor,  # (S * B, T/16, F/16, 128) NHWC: enc4's skip
    stem_mode: int,
    compute_dtype,
) -> torch.Tensor:
    """enc5 + enc6 + up1..up3 in plain torch convolutions, the reference's
    `_mid_trunk_xla`, stem s's weights on images [s*B, (s+1)*B). Returns
    up3's output (S * B, T/8, F/8, 64) NHWC, before the skip3 concat (the
    up4 kernel takes that concat as split-K)."""
    cast = lambda a: a.to(compute_dtype)
    chan = lambda v: cast(v)[:, None, None]
    n_stems = num_stems(stacked_params)
    b = act4.shape[0] // n_stems
    out = torch.empty(
        (act4.shape[0], 2 * act4.shape[1], 2 * act4.shape[2], 64),
        dtype=compute_dtype, device=act4.device,
    )
    for s in range(n_stems):
        p = stem_params(stacked_params, s)
        rows = slice(s * b, (s + 1) * b)
        ly = p["down5"]
        conv5 = conv_same(act4[rows].permute(0, 3, 1, 2), cast(ly["w"]),
                          cast(ly["b"]))
        x = act_encoder(chan(ly["bn_scale"]) * conv5 + chan(ly["bn_shift"]),
                        stem_mode)
        x = conv_same(x, cast(p["down6"]["w"]), cast(p["down6"]["b"]))
        skips = {1: conv5, 2: skip4[rows].permute(0, 3, 1, 2)}
        for i in range(1, 4):
            ly = p[f"up{i}"]
            y = tconv_same(x, cast(ly["w"]), cast(ly["b"]))
            x = chan(ly["bn_scale"]) * act_decoder(y, stem_mode) + chan(
                ly["bn_shift"])
            if i < 3:
                x = torch.cat([skips[i], x], dim=1)
        out[rows] = x.permute(0, 2, 3, 1)
    return out


def packed_unet_masks(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F) float32, shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """The packed multi-stem U-Net -> (S, B, 2, T, F) float32 masks.

    Dataflow of the reference's `_packed_unet_core`
    (Executable/spleeter.c:177-301 semantics): K2 enc1 and K3 enc2-enc4
    (skips kept in NHWC) -> plain-torch mid trunk -> K4 up4 and K5 up5
    (split-K concats) -> K6 head, whose masks are the masked iSTFT's
    input. Stems ride in the image axis of every kernel."""
    from spleeterrt_tpu_torch.kernels import encoder, tail

    enc_act = encoder_act_name(stem_mode)
    dec_act = decoder_act_name(stem_mode)
    ly = stacked_params["down1"]
    skip, x = encoder.enc1(
        magnitude.float().contiguous(), ly["w"], ly["b"], ly["bn_scale"],
        ly["bn_shift"], act=enc_act, dtype=compute_dtype,
    )
    skips = [skip]
    for i in (2, 3, 4):
        ly = stacked_params[f"down{i}"]
        skip, x = encoder.enc_s2(x, ly["w"], ly["b"], ly["bn_scale"],
                                 ly["bn_shift"], act=enc_act)
        skips.append(skip)
    x = mid_trunk(stacked_params, x, skips[3], stem_mode, compute_dtype)
    for i in (4, 5):
        ly = stacked_params[f"up{i}"]
        x = tail.up_shallow(skips[6 - i], x, ly["w"], ly["b"], ly["bn_scale"],
                            ly["bn_shift"], act=dec_act)
    ly6, ly7 = stacked_params["up6"], stacked_params["up7"]
    return tail.head(skips[0], x, ly6["w"], ly6["b"], ly6["bn_scale"],
                     ly6["bn_shift"], ly7["w"], ly7["b"], act=dec_act)


def multi_stem_masks_canonical(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """S stacked canonical nets -> (S, B, 2, T, F) fp32, in plain torch.

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


def multi_stem_masks(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """S stacked nets over one NCHW magnitude batch -> (S, B, 2, T, F) fp32:
    the packed route where `use_packed_unet` holds, else the canonical."""
    if use_packed_unet(stacked_params, magnitude, sigmoid):
        return packed_unet_masks(stacked_params, magnitude, stem_mode,
                                 compute_dtype)
    return multi_stem_masks_canonical(stacked_params, magnitude, stem_mode,
                                      compute_dtype, sigmoid)


def multi_stem_forward(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, T, F, 2), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """Run S stacked U-Nets over one magnitude batch -> (S, B, T, F, 2)."""
    return multi_stem_masks(
        stacked_params, magnitude.permute(0, 3, 1, 2).contiguous(), stem_mode,
        compute_dtype, sigmoid,
    ).permute(0, 1, 3, 4, 2)
