"""Packed U-Net encoder, enc1..enc4: wrappers, plain versions.

Two wrappers over the CUDA kernels of csrc/encoder.cu replace the
reference package's Pallas kernels spleeterrt_tpu/kernels/encoder.py::
_enc1_kernel (K2, enc1, 2 -> 16 channels) and ::_s2_kernel (K3, enc2,
enc3 and enc4, C -> 2C for C = 16, 32, 64). Per layer they compute

    skip = conv5x5_s2(x, w) + b                (the decoder's skip tensor)
    act  = act(bn_scale * skip + bn_shift)     (the next layer's input)

with TF-SAME padding per image, operands in the compute dtype, float32
sums and epilogue, and both outputs stored in the compute dtype. Outputs
are NHWC (S * B, H/2, W/2, C): image s * B + b is stem s's net on tile b.
enc1 reads the stem-shared magnitude tiles (B, 2, T, F) float32 from the
fused STFT and never copies them per stem.

On the card, bf16 layers run an implicit GEMM on the tensor cores
(mma.sync, bf16 operands, float32 sums): enc1 with every stem's channels
in one block over the one staged magnitude patch, enc2-enc4 stem by
stem; float32 layers run an fp32 FMA template. The rule is fixed on
dtype (`_tensor_cores`).
On a CPU tensor each wrapper returns its plain version (`*_plain`, torch
convolutions in float32 on the same rounded operands); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spleeterrt_tpu_torch.core import model
from spleeterrt_tpu_torch.kernels import (
    DTYPES,
    _build,
    check_act,
    check_layer,
    check_tensor,
    count_launch,
    epilogue_table,
    launch,
    stream_of,
)

ACTS = ("elu", "leaky")  # 4-stem family / 2-stem subnet (spleeter.c:43-56)
S2_WIDTHS = (16, 32, 64)  # enc2, enc3, enc4 input channels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spleeterrt_enc_conv.argtypes = [i, i, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.spleeterrt_enc_conv.restype = i
    lib.spleeterrt_enc1_mma_attrs.argtypes = [i, ctypes.POINTER(i)]
    lib.spleeterrt_enc1_mma_attrs.restype = i
    return lib


ENC1_K = 64  # bf16 enc1's K: 25 taps x 2 channels, padded to 4 k16 steps


def _tensor_cores(cin: int, dtype) -> bool:
    """The fixed rule of csrc/encoder.cu: bf16 layers run the tensor-core
    templates (enc1_mma_kernel for Cin 2, enc_mma_kernel for enc2-enc4),
    fp32 layers the FMA template."""
    return dtype == torch.bfloat16


def _conv_weights(w: torch.Tensor, dtype) -> torch.Tensor:
    """(S, Cout, Cin, 5, 5) -> the kernel's layout in dtype. On the tensor
    cores: enc1 (Cin 2) (S, 16, ENC1_K), k = 2 (5 kh + kw) + ci, zero from
    50 on (every stem's B operand, K contiguous); enc2-enc4 (S, 25, Cout,
    Cin) (one tap's B operand). Else (S, 5, 5, Cin, Cout)."""
    s, cout, cin = w.shape[:3]
    if not _tensor_cores(cin, dtype):
        return w.to(dtype).permute(0, 3, 4, 2, 1).contiguous()
    taps = w.to(dtype).permute(0, 1, 3, 4, 2)  # (S, Cout, kh, kw, Cin)
    if cin == 2:
        return torch.nn.functional.pad(taps.reshape(s, cout, 50), (0, ENC1_K - 50))
    return taps.permute(0, 2, 3, 1, 4).reshape(s, 25, cout, cin).contiguous()


def _layer_plain(xs, w, b, bn_scale, bn_shift, act, dtype):
    """Stem s's layer over xs[s] (B, Cin, H, W) float32 -> NHWC (skip, act)
    in dtype, stems stacked along the batch."""
    skips, acts = [], []
    for s, x in enumerate(xs):
        z = model.conv_same(x, w[s].to(dtype).float()) + b[s][:, None, None]
        skips.append(z)
        acts.append(model.activation(
            bn_scale[s][:, None, None] * z + bn_shift[s][:, None, None], act
        ))
    nhwc = lambda ts: torch.cat(ts).permute(0, 2, 3, 1).to(dtype).contiguous()
    return nhwc(skips), nhwc(acts)


def enc1_plain(mag, w, b, bn_scale, bn_shift, *, act, dtype):
    """Plain version of :func:`enc1`."""
    x = mag.to(dtype).float()
    return _layer_plain([x] * w.shape[0], w, b, bn_scale, bn_shift, act, dtype)


def enc1(
    mag: torch.Tensor,  # (B, 2, T, F) float32, shared by the stems
    w: torch.Tensor,  # (S, 16, 2, 5, 5) float32
    b: torch.Tensor,  # (S, 16) float32; bn_scale, bn_shift the same
    bn_scale: torch.Tensor,
    bn_shift: torch.Tensor,
    *,
    act: str,
    dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """enc1 -> (skip, act), each (S * B, T/2, F/2, 16) in `dtype`."""
    dev = mag.device
    check_tensor(mag, "mag", torch.float32, 4, dev)
    bsz, c, t, f = mag.shape
    if c != 2 or t % 2 or f % 2:
        raise ValueError(f"mag must be (B, 2, T, F) with T, F even, got {tuple(mag.shape)}")
    vecs = {"b": b, "bn_scale": bn_scale, "bn_shift": bn_shift}
    s = check_layer(dev, w, (16, 2, 5, 5), vecs, 16)
    code = check_act(act, ACTS)
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
    if dev.type == "cpu":
        return enc1_plain(mag, w, b, bn_scale, bn_shift, act=act, dtype=dtype)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if _tensor_cores(2, dtype) and mag.data_ptr() % 8:  # float2 loads
        raise ValueError("mag must be 8-byte aligned")
    skip = torch.empty((s * bsz, t // 2, f // 2, 16), dtype=dtype, device=dev)
    actv = torch.empty_like(skip)
    # Named, so their memory is not handed to the next allocation before
    # the kernel has read it.
    wk = _conv_weights(w, dtype)
    epi = epilogue_table(b, bn_scale, bn_shift)
    with torch.cuda.device(dev):
        launch(
            _lib().spleeterrt_enc_conv, 2, int(dtype == torch.bfloat16),
            mag.data_ptr(), wk.data_ptr(), epi.data_ptr(), s * bsz, bsz, bsz,
            t, f, code, skip.data_ptr(), actv.data_ptr(), stream_of(dev),
        )
    count_launch("enc1")
    return skip, actv


def enc1_attributes(device: torch.device, n_stems: int) -> dict[str, int]:
    """bf16 enc1's resources at n_stems stems, as the CUDA runtime reports
    them on `device`: registers a thread, dynamic shared memory a block
    (bytes), threads a block and resident blocks an SM."""
    attrs = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        launch(_lib().spleeterrt_enc1_mma_attrs, n_stems, attrs)
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"), attrs))


def enc_s2_plain(x, w, b, bn_scale, bn_shift, *, act):
    """Plain version of :func:`enc_s2`."""
    xs = x.float().permute(0, 3, 1, 2).chunk(w.shape[0])
    return _layer_plain(xs, w, b, bn_scale, bn_shift, act, x.dtype)


def enc_s2(
    x: torch.Tensor,  # (S * B, H, W, C) NHWC, C in S2_WIDTHS, float32 or bf16
    w: torch.Tensor,  # (S, 2C, C, 5, 5) float32
    b: torch.Tensor,  # (S, 2C) float32; bn_scale, bn_shift the same
    bn_scale: torch.Tensor,
    bn_shift: torch.Tensor,
    *,
    act: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """enc2, enc3 or enc4 -> (skip, act), each (S * B, H/2, W/2, 2C) in
    x's dtype; image i uses stem i // B's weights."""
    dev = x.device
    check_tensor(x, "x", DTYPES, 4, dev)
    sb, h, wd, c = x.shape
    if c not in S2_WIDTHS or h % 2 or wd % 2:
        raise ValueError(
            f"x must be (S*B, H, W, C) with C in {S2_WIDTHS} and H, W even, "
            f"got {tuple(x.shape)}"
        )
    vecs = {"b": b, "bn_scale": bn_scale, "bn_shift": bn_shift}
    s = check_layer(dev, w, (2 * c, c, 5, 5), vecs, 2 * c)
    if sb % s:
        raise ValueError(f"x holds {sb} images, not a multiple of {s} stems")
    code = check_act(act, ACTS)
    if dev.type == "cpu":
        return enc_s2_plain(x, w, b, bn_scale, bn_shift, act=act)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if _tensor_cores(c, x.dtype) and x.data_ptr() % 16:  # 16-byte cp.async
        raise ValueError("x must be 16-byte aligned")
    skip = torch.empty((sb, h // 2, wd // 2, 2 * c), dtype=x.dtype, device=dev)
    actv = torch.empty_like(skip)
    wk = _conv_weights(w, x.dtype)
    epi = epilogue_table(b, bn_scale, bn_shift)
    with torch.cuda.device(dev):
        launch(
            _lib().spleeterrt_enc_conv, c, int(x.dtype == torch.bfloat16),
            x.data_ptr(), wk.data_ptr(), epi.data_ptr(), sb, sb // s, sb, h,
            wd, code, skip.data_ptr(), actv.data_ptr(), stream_of(dev),
        )
    count_launch("enc_s2")
    return skip, actv
