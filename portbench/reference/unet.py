"""The Spleeter U-Net in plain float32 PyTorch, one net over NCHW images.

Written from the C engine's semantics (SpleeterRT, Executable/spleeter.c:
111-301), independent of the program under test:

- six encoder convolutions, 5x5, stride 2, TF-SAME padding (1, 2) per
  spatial axis: `skip = conv + bias`, `act(bn_scale * skip + bn_shift)`;
  the sixth keeps its bias only;
- six decoder transposed convolutions, 5x5, stride 2, `out[2i + k - 1] +=
  x[i] w[k]` (padding 1, cropped to 2H): `bn_scale * act(tconv + bias) +
  bn_shift`, the activation before batch norm; up1..up5 are concatenated
  after the encoder skip of their size, [skip, up];
- a final 4x4 convolution with dilation 2 and padding 3, plus bias, then
  the sigmoid;
- activations: ELU everywhere for the 4-stem family, inputs below -15 map
  to -1 exactly; leaky ReLU (0.2) encoder and ReLU decoder for the 2-stem
  net.

`precision="fp8"` is the control of the correctness check: every
convolution's input and weights are rounded to float8 e4m3 with one
scale a tensor (amax / 448) before the float32 convolution, the step that
would tempt a program whose configuration states bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x
    if precision == "fp8":
        return round_fp8(x)
    raise ValueError(f"unknown precision {precision!r}")


def act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "elu":
        return torch.where(x < -15.0, torch.full_like(x, -1.0), F.elu(x))
    if name == "leaky":
        return F.leaky_relu(x, 0.2)
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name!r}")


def _conv(x, w, b, precision):
    x = F.pad(_operand(x, precision), (1, 2, 1, 2))
    return F.conv2d(x, _operand(w, precision), b, stride=2)


def _tconv(x, w, b, precision):
    h, wd = x.shape[-2:]
    y = F.conv_transpose2d(_operand(x, precision), _operand(w, precision), b,
                           stride=2, padding=1)
    return y[..., : 2 * h, : 2 * wd]


def _vec(v: torch.Tensor) -> torch.Tensor:
    return v.float()[:, None, None]


def forward(
    net: dict, x: torch.Tensor, enc_act: str, dec_act: str,
    precision: str = "fp32",
) -> torch.Tensor:
    """net: {"down1".."down6", "up1".."up7": {"w", "b", ["bn_scale",
    "bn_shift"]}} float32 tensors (conv weights OIHW, transposed conv
    weights (Cin, Cout, 5, 5)); x (B, 2, T, F) float32 magnitudes -> masks
    (B, 2, T, F) float32."""
    x = x.float()
    skips = []
    for i in range(1, 7):
        ly = net[f"down{i}"]
        conv = _conv(x, ly["w"].float(), ly["b"].float(), precision)
        if i == 6:
            x = conv
            break
        skips.append(conv)
        x = act(_vec(ly["bn_scale"]) * conv + _vec(ly["bn_shift"]), enc_act)
    for i in range(1, 7):
        ly = net[f"up{i}"]
        y = _tconv(x, ly["w"].float(), ly["b"].float(), precision)
        y = _vec(ly["bn_scale"]) * act(y, dec_act) + _vec(ly["bn_shift"])
        x = torch.cat([skips[5 - i], y], dim=1) if i < 6 else y
    ly = net["up7"]
    logits = F.conv2d(_operand(x, precision), _operand(ly["w"].float(), precision),
                      ly["b"].float(), padding=3, dilation=2)
    return torch.sigmoid(logits)


def masks(
    net: dict, images: torch.Tensor, enc_act: str, dec_act: str,
    precision: str = "fp32", block: int = 8,
) -> torch.Tensor:
    """`forward` over (B, 2, T, F) images in blocks of `block` images, so
    that a whole track's tiles fit beside the program's memory."""
    return torch.cat([
        forward(net, images[i : i + block], enc_act, dec_act, precision)
        for i in range(0, images.shape[0], block)
    ])
