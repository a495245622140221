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

Three routes, tried in the reference package's order
(spleeterrt_tpu/core/model.py::multi_stem_forward):

1. the packed U-Net (`packed_unet_masks`: the hand kernels K2-K6 of
   kernels/encoder.py and kernels/tail.py around a plain-torch mid trunk,
   enc5..up3)
   wherever `use_packed_unet` holds: the standard architecture at tile
   shapes the kernels take, with the exact sigmoid;
2. the round-3 route wherever `use_pallas_head` or `use_pallas_encoder`
   holds: K2 enc1 and K3 enc2, enc3 (`multi_stem_trunk`), enc4..up5 in
   plain torch (any channel ladder), and the head K10 (`pallas_head`,
   kernels/mask_head.py) or the canonical head. A net whose deep trunk is
   not the standard one, or the standard net with FORCE_PACKED_UNET =
   False, goes this way;
3. the canonical route, every layer in plain torch
   (`multi_stem_masks_canonical`).

Where the reference vmaps the stem axis, the port runs every stem in one
grouped convolution a layer (core/grouped.py) in the round-3 trunk and
head and the canonical route; the mid trunk keeps its loop over stems,
which an H100 ran faster (`mid_trunk`). The single-net functions
(`unet_forward_nchw`, `unet_trunk`, `trunk_tail`, `canonical_head`) stay
the per-stem formulation.

The gates look at shapes only, not at the device: on CPU tensors a route
runs the kernels' plain versions, on CUDA tensors the kernels. The
reference's `pallas_head` / `pallas_encoder` switches, both False, pin the
canonical route, which is the only one autograd can differentiate.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import STEM_MODE_2, STEM_MODE_4
from spleeterrt_tpu_torch.utils.timing import span, traced

# (Cin, Cout) per encoder layer (Executable/spleeter.c:144-149).
ENCODER_CHANNELS = ((2, 16), (16, 32), (32, 64), (64, 128), (128, 256), (256, 512))
# (Cin, Cout) per decoder layer; Cin includes the skip concat
# (Executable/spleeter.c:150-155).
DECODER_CHANNELS = ((512, 256), (512, 128), (256, 64), (128, 32), (64, 16), (32, 1))
FINAL_CHANNELS = (1, 2)

Params = dict[str, dict[str, torch.Tensor]]

# The reference's route switches (spleeterrt_tpu/core/model.py:164-173).
# None lets the gate decide from the shapes (the reference also asks its
# backend; the port runs a route's plain versions on CPU tensors instead),
# True takes the route wherever the shapes allow it, whatever the batch,
# False never takes it. FORCE_PACKED_UNET = False sends the standard net
# down the round-3 route.
FORCE_PACKED_UNET: bool | None = None
FORCE_PALLAS_HEAD: bool | None = None
FORCE_PALLAS_ENCODER: bool | None = None

# Above this many (stem * tile) images the round-3 head and encoder give
# way to the canonical layers: the reference's thresholds (its model.py
# :188 and :317, measured on a TPU and not retuned), kept so that the same
# inputs take the same route in both packages.
PALLAS_HEAD_MAX_BATCH = 64
PALLAS_ENCODER_MAX_BATCH = 64


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


def _encoder(params: Params, x, layers, skips: list, stem_mode: int, cast):
    """Encoder layers `layers` from x; each pre-activation conv (the
    decoder's skip) is appended to `skips`. Returns the last activation, or
    down6's output, which is bias only (spleeter.c:231-238)."""
    for i in layers:
        ly = params[f"down{i}"]
        conv = conv_same(x, cast(ly["w"]), cast(ly["b"]))
        if i == 6:
            return conv
        skips.append(conv)
        x = act_encoder(cast(ly["bn_scale"])[:, None, None] * conv
                        + cast(ly["bn_shift"])[:, None, None], stem_mode)
    return x


def _decoder(ly, x: torch.Tensor, stem_mode: int, cast) -> torch.Tensor:
    """One decoder layer: bn_scale * act(tconv(x) + b) + bn_shift, the
    activation BEFORE batch norm (spleeter.c:239-288)."""
    y = tconv_same(x, cast(ly["w"]), cast(ly["b"]))
    return cast(ly["bn_scale"])[:, None, None] * act_decoder(y, stem_mode) + cast(
        ly["bn_shift"])[:, None, None]


def trunk_tail(
    params: Params,
    x: torch.Tensor,  # enc3's activation (B, C3, T/8, F/8)
    skips3: list[torch.Tensor],  # the pre-activation enc1..enc3 convs
    stem_mode: int,
    compute_dtype,
) -> torch.Tensor:
    """enc4..enc6 + up1..up5 of one net -> up6's input (B, C, T/2, F/2) =
    cat[enc1 skip, up5 out] (the reference's `_trunk_tail`), for whatever
    channel ladder the weights give."""
    cast = lambda a: a.to(compute_dtype)
    skips = list(skips3)
    x = _encoder(params, x, range(4, 7), skips, stem_mode, cast)
    for i in range(1, 6):
        # concat [skip, upsampled]; skips are pre-BN/act conv outputs.
        y = _decoder(params[f"up{i}"], x, stem_mode, cast)
        x = torch.cat([skips[5 - i], y], dim=1)
    return x


def unet_trunk(
    params: Params, magnitude: torch.Tensor, stem_mode: int, compute_dtype
) -> torch.Tensor:
    """Canonical enc1..enc3 + `trunk_tail`: (B, 2, T, F) -> (B, C, T/2, F/2)."""
    cast = lambda a: a.to(compute_dtype)
    skips: list[torch.Tensor] = []
    x = _encoder(params, cast(magnitude), range(1, 4), skips, stem_mode, cast)
    return trunk_tail(params, x, skips, stem_mode, compute_dtype)


def canonical_head(
    params: Params, x: torch.Tensor, stem_mode: int, compute_dtype,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """up6 + up7 + sigmoid in plain torch: up6's input (B, C, T/2, F/2) ->
    fp32 mask (B, 2, T, F). Only the final logits are promoted to fp32."""
    cast = lambda a: a.to(compute_dtype)
    y = _decoder(params["up6"], x, stem_mode, cast)
    ly7 = params["up7"]
    logits = conv_dilated_final(y, cast(ly7["w"])).float() + ly7["b"].float()[
        :, None, None
    ]
    if sigmoid == "lut":
        return fast_sigmoid(logits)
    return torch.sigmoid(logits)


def unet_forward_nchw(
    params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F)
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """The canonical net: magnitude (B, 2, T, F) -> fp32 soft mask (B, 2,
    T, F) in [0, 1], everything in `compute_dtype` but the final logits."""
    x = unet_trunk(params, magnitude, stem_mode, compute_dtype)
    return canonical_head(params, x, stem_mode, compute_dtype, sigmoid)


def with_stem_axis(params: Params) -> Params:
    """One net as a stack of one (a leading stem axis of size 1; views)."""
    return {ln: {fn: v[None] for fn, v in ly.items()} for ln, ly in params.items()}


def unet_forward(
    params: Params,
    magnitude: torch.Tensor,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """Magnitude (batch, T, F, 2) or (T, F, 2) -> mask of the same shape,
    routed as :func:`multi_stem_masks` routes one stem.

    T and F must be divisible by 64 (six stride-2 halvings)."""
    x = magnitude if magnitude.ndim == 4 else magnitude[None]
    out = multi_stem_masks(
        with_stem_axis(params), x.permute(0, 3, 1, 2).contiguous(), stem_mode,
        compute_dtype, sigmoid,
    )[0].permute(0, 2, 3, 1)
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
    that.) FORCE_PACKED_UNET = False turns it off."""
    if not all(k in stacked_params for k in PACKED_WEIGHT_SHAPES):
        return False
    _, c, t, f = magnitude.shape
    ok = (
        sigmoid == "exact"
        and _shapes_are(stacked_params, PACKED_WEIGHT_SHAPES)
        and c == 2 and t >= 64 and f >= 64 and t % 64 == 0 and f % 64 == 0
    )
    return ok if FORCE_PACKED_UNET is None else FORCE_PACKED_UNET and ok


def _shapes_are(stacked_params: Params, shapes: dict) -> bool:
    return all(
        tuple(stacked_params[k]["w"].shape[-4:]) == shapes[k] for k in shapes
    )


def _batch_gate(ok: bool, force: bool | None, n_images: int, limit: int) -> bool:
    if force is not None:
        return force and ok
    return ok and n_images <= limit


def use_pallas_head(
    stacked_params: Params, magnitude: torch.Tensor, sigmoid: str
) -> bool:
    """The reference's `_use_pallas_head` without its backend check: the
    standard up6/up7, the exact sigmoid, NCHW tiles (B, 2, T, F) with T/2 a
    multiple of 32 and F/2 of 16, and at most PALLAS_HEAD_MAX_BATCH stem *
    tile images (FORCE_PALLAS_HEAD = True lifts that limit, False turns the
    gate off)."""
    _, _, t, f = magnitude.shape
    ok = (
        sigmoid == "exact"
        and _shapes_are(stacked_params, {k: PACKED_WEIGHT_SHAPES[k]
                                         for k in ("up6", "up7")})
        and (t // 2) % 32 == 0 and (f // 2) % 16 == 0
    )
    return _batch_gate(ok, FORCE_PALLAS_HEAD,
                       num_stems(stacked_params) * magnitude.shape[0],
                       PALLAS_HEAD_MAX_BATCH)


def use_pallas_encoder(stacked_params: Params, magnitude: torch.Tensor) -> bool:
    """The reference's `_use_pallas_encoder` without its backend check: the
    standard enc1..enc3 (2 -> 16 -> 32 -> 64), NCHW tiles (B, 2, T, F) with
    T a multiple of 8 (>= 16) and F of 32 (>= 32), and at most
    PALLAS_ENCODER_MAX_BATCH stem * tile images (FORCE_PALLAS_ENCODER as
    FORCE_PALLAS_HEAD)."""
    _, c, t, f = magnitude.shape
    ok = (
        _shapes_are(stacked_params, {k: PACKED_WEIGHT_SHAPES[k]
                                     for k in ("down1", "down2", "down3")})
        and c == 2 and t % 8 == 0 and t >= 16 and f % 32 == 0 and f >= 32
    )
    return _batch_gate(ok, FORCE_PALLAS_ENCODER,
                       num_stems(stacked_params) * magnitude.shape[0],
                       PALLAS_ENCODER_MAX_BATCH)


@traced("model.mid_trunk")
def mid_trunk(
    stacked_params: Params,
    act4: torch.Tensor,  # (S * B, T/16, F/16, 128) NHWC: enc4's activation
    skip4: torch.Tensor,  # (S * B, T/16, F/16, 128) NHWC: enc4's skip
    stem_mode: int,
    compute_dtype,
) -> torch.Tensor:
    """enc5 + enc6 + up1..up3 in plain torch convolutions, the reference's
    `vmap(_mid_trunk_xla)`, stem s's weights on images [s*B, (s+1)*B).
    Returns up3's output (S * B, T/8, F/8, 64) NHWC, before the skip3
    concat (the up4 kernel takes that concat as split-K).

    The stems run one after the other. The grouped form (core/grouped.py's
    layers, one grouped convolution a layer) made the 4-stem 300 s graph
    slower on an H100 beyond the spread of repeated calls: cuDNN runs each
    grouped convolution at these widths as a convolution a group with
    channel-slice copies around them (the 300 s graph took 16.185 ms
    grouped against 15.325 ms with the loop; PERF.md §6)."""
    cast = lambda a: a.to(compute_dtype)
    n_stems = num_stems(stacked_params)
    b = act4.shape[0] // n_stems
    out = torch.empty(
        (act4.shape[0], 2 * act4.shape[1], 2 * act4.shape[2], 64),
        dtype=compute_dtype, device=act4.device,
    )
    for s in range(n_stems):
        p = stem_params(stacked_params, s)
        rows = slice(s * b, (s + 1) * b)
        conv5: list[torch.Tensor] = []
        x = _encoder(p, act4[rows].permute(0, 3, 1, 2), range(5, 7), conv5,
                     stem_mode, cast)
        skips = {1: conv5[0], 2: skip4[rows].permute(0, 3, 1, 2)}
        for i in range(1, 4):
            x = _decoder(p[f"up{i}"], x, stem_mode, cast)
            if i < 3:
                x = torch.cat([skips[i], x], dim=1)
        out[rows] = x.permute(0, 2, 3, 1)
    return out


def kernel_encoder(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F) float32, shared across stems
    n_layers: int,
    stem_mode: int,
    compute_dtype,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """K2 enc1 and K3 for enc2..enc{n_layers}, every stem in one launch
    each -> (the pre-activation skips, the last activation), NHWC (S * B,
    ...) in the compute dtype (the reference's `encoder_packed` with four
    layers, `encoder3_pallas` with three)."""
    from spleeterrt_tpu_torch.kernels import encoder

    act = encoder_act_name(stem_mode)
    ly = stacked_params["down1"]
    skip, x = encoder.enc1(
        magnitude.float().contiguous(), ly["w"], ly["b"], ly["bn_scale"],
        ly["bn_shift"], act=act, dtype=compute_dtype,
    )
    skips = [skip]
    for i in range(2, n_layers + 1):
        ly = stacked_params[f"down{i}"]
        skip, x = encoder.enc_s2(x, ly["w"], ly["b"], ly["bn_scale"],
                                 ly["bn_shift"], act=act)
        skips.append(skip)
    return skips, x


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
    from spleeterrt_tpu_torch.kernels import tail

    dec_act = decoder_act_name(stem_mode)
    skips, x = kernel_encoder(stacked_params, magnitude, 4, stem_mode,
                              compute_dtype)
    x = mid_trunk(stacked_params, x, skips[3], stem_mode, compute_dtype)
    for i in (4, 5):
        ly = stacked_params[f"up{i}"]
        x = tail.up_shallow(skips[6 - i], x, ly["w"], ly["b"], ly["bn_scale"],
                            ly["bn_shift"], act=dec_act)
    ly6, ly7 = stacked_params["up6"], stacked_params["up7"]
    return tail.head(skips[0], x, ly6["w"], ly6["b"], ly6["bn_scale"],
                     ly6["bn_shift"], ly7["w"], ly7["b"], act=dec_act)


def multi_stem_trunk(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F) float32, shared across stems
    stem_mode: int,
    compute_dtype,
    pallas_encoder: bool = True,
) -> torch.Tensor:
    """Every stem's trunk -> up6's input (S * B, T/2, F/2, C) NHWC in the
    compute dtype, image s * B + b from stem s (the reference's
    `_multi_stem_trunk`). Where `pallas_encoder` and `use_pallas_encoder`
    hold, K2 enc1 and K3 enc2, enc3 run every stem in one launch each and
    the grouped enc4..up5 take over; otherwise every layer is grouped
    (core/grouped.py)."""
    from spleeterrt_tpu_torch.core import grouped

    s = num_stems(stacked_params)
    if pallas_encoder and use_pallas_encoder(stacked_params, magnitude):
        skips, act3 = kernel_encoder(stacked_params, magnitude, 3, stem_mode,
                                     compute_dtype)
        x = grouped.trunk_tail(
            stacked_params, grouped.to_grouped(act3, s),
            [grouped.to_grouped(a, s) for a in skips], s, stem_mode,
            compute_dtype)
    else:
        x = grouped.unet_trunk(stacked_params, magnitude, stem_mode,
                               compute_dtype)
    return grouped.from_grouped(x, s)


def pallas_head(
    stacked_params: Params, x: torch.Tensor, stem_mode: int
) -> torch.Tensor:
    """K10 over up6's input (S * B, T/2, F/2, 32) NHWC -> masks (S, B, 2, T,
    F) float32 (the reference's `_pallas_head`, whose NHWC transpose the
    port does not need: K10 writes the masked iSTFT's layout)."""
    from spleeterrt_tpu_torch.kernels import mask_head

    ly6, ly7 = stacked_params["up6"], stacked_params["up7"]
    masks = mask_head.mask_head(
        x, ly6["w"], ly6["b"], ly6["bn_scale"], ly6["bn_shift"], ly7["w"],
        ly7["b"], act=decoder_act_name(stem_mode),
    )
    return masks.view(num_stems(stacked_params), -1, *masks.shape[1:])


def multi_stem_masks_canonical(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
) -> torch.Tensor:
    """S stacked canonical nets -> (S, B, 2, T, F) fp32, in plain torch.

    The reference runs one net per thread (VST/Source/Spleeter4Stems.c:135)
    and its package vmaps the stem axis into grouped convolutions; here
    every layer is one grouped convolution over all stems
    (core/grouped.py)."""
    from spleeterrt_tpu_torch.core import grouped

    x = grouped.unet_trunk(stacked_params, magnitude, stem_mode, compute_dtype)
    return grouped.head(stacked_params, x, stem_mode, compute_dtype, sigmoid)


def round3_masks(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F), shared across stems
    stem_mode: int,
    compute_dtype,
    sigmoid: str,
    use_head: bool,
    pallas_encoder: bool,
) -> torch.Tensor:
    """The round-3 route -> (S, B, 2, T, F) fp32: `multi_stem_trunk`, then
    K10 (`pallas_head`) if `use_head`, else the grouped canonical head."""
    from spleeterrt_tpu_torch.core import grouped

    trunk = multi_stem_trunk(stacked_params, magnitude, stem_mode,
                             compute_dtype, pallas_encoder)
    if use_head:
        return pallas_head(stacked_params, trunk, stem_mode)
    return grouped.head(
        stacked_params, grouped.to_grouped(trunk, num_stems(stacked_params)),
        stem_mode, compute_dtype, sigmoid)


def multi_stem_masks(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, 2, T, F), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
    pallas_head: bool = True,
    pallas_encoder: bool = True,
) -> torch.Tensor:
    """S stacked nets over one NCHW magnitude batch -> (S, B, 2, T, F) fp32:
    the packed route where `use_packed_unet` holds, else the round-3 route
    where its head or encoder gate holds, else the canonical.

    `pallas_head` and `pallas_encoder` are the reference's switches
    (spleeterrt_tpu/core/model.py::multi_stem_forward): False shuts the
    head's or the encoder's kernels out, whatever the FORCE_* switches
    say; the packed route needs both. A differentiated call passes both
    False (core/train.py::separation_loss): the kernels have no backward,
    so that call runs the canonical route, every stem grouped.

    The call is one span `model.unet`, its `route` attribute packed,
    round3 or canonical."""
    with span("model.unet") as sp:
        if (pallas_head and pallas_encoder
                and use_packed_unet(stacked_params, magnitude, sigmoid)):
            sp.note(route="packed")
            return packed_unet_masks(stacked_params, magnitude, stem_mode,
                                     compute_dtype)
        use_head = pallas_head and use_pallas_head(stacked_params, magnitude,
                                                   sigmoid)
        use_enc = pallas_encoder and use_pallas_encoder(stacked_params,
                                                        magnitude)
        if use_head or use_enc:
            sp.note(route="round3")
            return round3_masks(stacked_params, magnitude, stem_mode,
                                compute_dtype, sigmoid, use_head,
                                pallas_encoder)
        sp.note(route="canonical")
        return multi_stem_masks_canonical(stacked_params, magnitude,
                                          stem_mode, compute_dtype, sigmoid)


def multi_stem_forward(
    stacked_params: Params,
    magnitude: torch.Tensor,  # (B, T, F, 2), shared across stems
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.float32,
    sigmoid: str = "exact",
    pallas_head: bool = True,
    pallas_encoder: bool = True,
) -> torch.Tensor:
    """Run S stacked U-Nets over one magnitude batch -> (S, B, T, F, 2),
    routed as :func:`multi_stem_masks` routes them."""
    return multi_stem_masks(
        stacked_params, magnitude.permute(0, 3, 1, 2).contiguous(), stem_mode,
        compute_dtype, sigmoid, pallas_head, pallas_encoder,
    ).permute(0, 1, 3, 4, 2)
