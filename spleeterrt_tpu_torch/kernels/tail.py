"""Packed U-Net decoder tail, up4 + up5 + head: wrappers, plain versions.

CUDA kernels (csrc/tail.cu, csrc/head.cu) replace the reference package's
Pallas kernels spleeterrt_tpu/kernels/tail.py::_up_kernel_pair (K4, up4),
::_up_kernel_quad (K5, up5) and ::_head_kernel (K6, up6 + up7 + sigmoid):

    up_shallow:  out  = bn_scale * act(tconv5x5_s2([skip, prev], w) + b)
                        + bn_shift          (activation BEFORE batch norm)
    head:        y6   = the same layer over [skip1, up5out], 32 -> 1,
                        zero outside the image, rounded to the dtype;
                 mask = sigmoid(conv4x4_dil2(y6, w7) + b7) in float32.

The concat [skip, prev] is never materialised (split-K in the kernel:
weight rows [:C] take the skip). Sources are NHWC (S * B, H, W, C) in the
compute dtype; image s * B + b uses stem s's weights. The head writes the
masks (S, B, 2, T, F) float32, the masked iSTFT's input layout.

up4/up5 follow one fixed rule on dtype (`_tensor_cores`, the twin of the
switch in csrc/tail.cu): bf16 runs an implicit GEMM on the tensor cores
(Hopper's wgmma, bf16 operands, float32 sums; weights (S, 25, C/2, 2C)
from `_up_weights`, taps in `_UP_TAPS` order), as the TPU kernels ran on
their matrix unit; float32 runs an fp32 FMA template, the parity path,
which TF32 would not hold to its 1e-5 bound. What bounds them on an H100
at 300 s: bf16 up4 the tensor cores' operations (0.26 ms), bf16 up5 its
bytes (0.38 ms); the float32 path the FMA units (3.83 ms a layer).

The head (K6, and K10 in kernels/mask_head.py, one template) follows the
same kind of rule (`_head_tensor_cores`, the twin of the switch in
csrc/head.cu): bf16 runs up6 as an implicit GEMM on mma.sync (bf16
operands, float32 sums; weights (S, 18, 8, 16) from `_head_weights`: 18
k16 steps of one source's 16 channels at one input shift, the 4 output
parities padded to 8 columns), then up7 and the sigmoid in fp32; float32
runs the fp32 FMA template. What bounds the head on an H100 at 300 s is
its bytes (0.575 ms for the 4-stem graph). No shape or alignment sends a
bf16 call to the FMA template: a bf16 source that is not 16-byte aligned
raises, in up4/up5 and in the head alike (the kernels copy 16 bytes at a
time).

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
    check_grid,
    check_layer,
    check_no_grad,
    check_tensor,
    count_launch,
    epilogue_table,
    launch,
    stream_of,
)
from spleeterrt_tpu_torch.utils.timing import span, traced

ACTS = ("elu", "relu")  # 4-stem family / 2-stem subnet (spleeter.c:43-56)
UP_WIDTHS = {64: "up4", 32: "up5"}  # channels per source -> kernel name
HEAD_WIDTH = 16  # channels per head source (skip1, up5out)


def _up_taps() -> tuple[int, ...]:
    """The tensor-core template's tap order, kh * 5 + kw: output row 2h' +
    dp reads input row h' + dh through tap kh = 1 - 2 dh + dp (columns the
    same); the shifts (dh, dw) in row-major order over {-1, 0, 1}^2, and
    within a shift the parities 2 dp + dq that read it in the kernel's
    accumulator order 0, 1, 3, 2 (csrc/tail.cu::up_parity), in which they
    are one run."""
    taps = []
    for dh in (-1, 0, 1):
        for dw in (-1, 0, 1):
            for p in (0, 1, 3, 2):
                dp, dq = divmod(p, 2)
                kh, kw = 1 - 2 * dh + dp, 1 - 2 * dw + dq
                if 0 <= kh < 5 and 0 <= kw < 5:
                    taps.append(5 * kh + kw)
    return tuple(taps)


_UP_TAPS = _up_taps()


@functools.cache
def _up_tap_index(device: torch.device) -> torch.Tensor:
    """_UP_TAPS as an index tensor on `device`, made once: a list index
    would copy it from pageable host memory at every launch, which waits
    for the stream to drain."""
    return torch.tensor(_UP_TAPS, device=device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spleeterrt_up_tconv.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, p]
    lib.spleeterrt_up_tconv.restype = i
    lib.spleeterrt_up_mma_attrs.argtypes = [i, ctypes.POINTER(i)]
    lib.spleeterrt_up_mma_attrs.restype = i
    lib.spleeterrt_head.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p, p]
    lib.spleeterrt_head.restype = i
    lib.spleeterrt_mask_head.argtypes = [i, p, p, p, p, i, i, i, i, i, p, p]
    lib.spleeterrt_mask_head.restype = i
    lib.spleeterrt_head_mma_attrs.argtypes = [ctypes.POINTER(i)]
    lib.spleeterrt_head_mma_attrs.restype = i
    return lib


def _tensor_cores(c: int, dtype) -> bool:
    """The fixed rule of csrc/tail.cu: bf16 up4/up5 (C = 64, 32 channels a
    source) run the tensor-core template, float32 the FMA template."""
    return dtype == torch.bfloat16 and c in UP_WIDTHS


def _up_weights(w: torch.Tensor, dtype) -> torch.Tensor:
    """(S, 2C, C/2, 5, 5) -> the kernel's layout in dtype: (S, 25, C/2, 2C)
    for the tensor cores (one tap's B operand, K contiguous, taps in
    `_UP_TAPS` order), else (S, 2C, 5, 5, C/2)."""
    s, cin, cout = w.shape[:3]
    if _tensor_cores(cin // 2, dtype):
        taps = w.to(dtype).permute(0, 3, 4, 2, 1).reshape(s, 25, cout, cin)
        return taps.index_select(1, _up_tap_index(w.device))
    return w.to(dtype).permute(0, 1, 3, 4, 2).contiguous()


def _check_sources(a: torch.Tensor, b: torch.Tensor, names: str) -> None:
    check_tensor(a, names[0], DTYPES, 4, a.device)
    check_tensor(b, names[1], a.dtype, 4, a.device)
    if a.shape != b.shape:
        raise ValueError(f"{names}: shapes differ, {tuple(a.shape)} and {tuple(b.shape)}")


def _decoder_plain(skip, prev, w, b, bn_scale, bn_shift, act):
    """Per stem: bn_scale * act(tconv([skip, prev]) + b) + bn_shift in
    float32 from operands rounded to the sources' dtype -> (S, B, C, 2H,
    2W) as a list over stems."""
    dtype = skip.dtype
    x = torch.cat([skip, prev], -1).float().permute(0, 3, 1, 2)
    return [
        bn_scale[s][:, None, None] * model.activation(
            model.tconv_same(xs, w[s].to(dtype).float()) + b[s][:, None, None],
            act,
        ) + bn_shift[s][:, None, None]
        for s, xs in enumerate(x.chunk(w.shape[0]))
    ]


def up_shallow_plain(skip, prev, w, b, bn_scale, bn_shift, *, act):
    """Plain version of :func:`up_shallow`."""
    ys = _decoder_plain(skip, prev, w, b, bn_scale, bn_shift, act)
    return torch.cat(ys).permute(0, 2, 3, 1).to(skip.dtype).contiguous()


def up_shallow(
    skip: torch.Tensor,  # (S * B, H, W, C) NHWC, C = 64 (up4) or 32 (up5)
    prev: torch.Tensor,  # the same shape and dtype: the layer below's output
    w: torch.Tensor,  # (S, 2C, C/2, 5, 5) float32, rows [:C] for the skip
    b: torch.Tensor,  # (S, C/2) float32; bn_scale, bn_shift the same
    bn_scale: torch.Tensor,
    bn_shift: torch.Tensor,
    *,
    act: str,
) -> torch.Tensor:
    """up4 or up5 -> (S * B, 2H, 2W, C/2) in the sources' dtype; past the
    sources' checks, one span `kernels.up4` or `kernels.up5`."""
    check_no_grad("up_shallow", skip, prev, w, b, bn_scale, bn_shift)
    _check_sources(skip, prev, ("skip", "prev"))
    c = skip.shape[-1]
    if c not in UP_WIDTHS:
        raise ValueError(f"skip must have {tuple(UP_WIDTHS)} channels, got {c}")
    with span("kernels." + UP_WIDTHS[c]):
        return _up_shallow(skip, prev, w, b, bn_scale, bn_shift, act=act)


def _up_shallow(skip, prev, w, b, bn_scale, bn_shift, *, act):
    dev = skip.device
    sb, h, wd, c = skip.shape
    vecs = {"b": b, "bn_scale": bn_scale, "bn_shift": bn_shift}
    s = check_layer(dev, w, (2 * c, c // 2, 5, 5), vecs, c // 2)
    if sb % s:
        raise ValueError(f"skip holds {sb} images, not a multiple of {s} stems")
    code = check_act(act, ACTS)
    if dev.type == "cpu":
        return up_shallow_plain(skip, prev, w, b, bn_scale, bn_shift, act=act)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if _tensor_cores(c, skip.dtype) and (skip.data_ptr() % 16 or prev.data_ptr() % 16):
        raise ValueError("skip and prev must be 16-byte aligned")  # cp.async
    check_grid(sb, f"{UP_WIDTHS[c]}'s images (grid z)")
    out = torch.empty((sb, 2 * h, 2 * wd, c // 2), dtype=skip.dtype, device=dev)
    # Named, so their memory is not handed to the next allocation before
    # the kernel has read it.
    wk = _up_weights(w, skip.dtype)
    epi = epilogue_table(b, bn_scale, bn_shift)
    with torch.cuda.device(dev):
        launch(
            _lib().spleeterrt_up_tconv, c, int(skip.dtype == torch.bfloat16),
            skip.data_ptr(), prev.data_ptr(), wk.data_ptr(), epi.data_ptr(),
            sb, sb // s, h, wd, code, out.data_ptr(), stream_of(dev),
        )
    count_launch(UP_WIDTHS[c])
    return out


def up_mma_attributes(c: int, device: torch.device) -> dict[str, int]:
    """The bf16 tensor-core template's resources for C = 64 (up4) or 32
    (up5) channels a source, as the CUDA runtime reports them on `device`:
    registers a thread, dynamic shared memory a block (bytes), threads a
    block and resident blocks an SM."""
    if c not in UP_WIDTHS:
        raise ValueError(f"c must be one of {tuple(UP_WIDTHS)}, got {c}")
    attrs = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        launch(_lib().spleeterrt_up_mma_attrs, c, attrs)
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"), attrs))


def up6_plain(skip1, up5, w6, b6, bn_scale6, bn_shift6, *, act):
    """The head's first half, y6 before its rounding to the sources' dtype:
    (S, B, 1, 2H, 2W) float32."""
    return torch.stack(_decoder_plain(skip1, up5, w6, b6, bn_scale6,
                                      bn_shift6, act))


def head_plain(skip1, up5, w6, b6, bn_scale6, bn_shift6, w7, b7, *, act):
    """Plain version of :func:`head`."""
    ys = up6_plain(skip1, up5, w6, b6, bn_scale6, bn_shift6, act=act)
    dtype = skip1.dtype
    return torch.stack([
        torch.sigmoid(
            model.conv_dilated_final(y.to(dtype).float(), w7[s].to(dtype).float())
            + b7[s][:, None, None]
        )
        for s, y in enumerate(ys)
    ]).contiguous()


def head_error_bound(skip1, up5, w6, b6, bn_scale6, bn_shift6, w7, b7, *,
                     act) -> torch.Tensor:
    """Per-pixel bound on |head - head_plain|, (S, B, 2, 2H, 2W) float32.

    The kernel and the plain version sum y6 in another order, so each y6
    may differ by e: 2 ulps of that y6 in bf16 (a rounding flip), 1e-5 of
    max|y6| in float32. A mask reads 16 of them through its channel's up7
    taps, so its logit may differ by L = sum e * |w7| (zero for taps outside
    the image, where y6 is zero on both sides), plus 1e-6 of the logit's
    own terms; the sigmoid turns that into L times its largest slope within
    L of the logit, and 1e-6 covers its float32 rounding."""
    ys = up6_plain(skip1, up5, w6, b6, bn_scale6, bn_shift6, act=act)
    dtype = skip1.dtype
    bounds = []
    for s, y in enumerate(ys):
        y = y.to(dtype).float()
        if dtype == torch.bfloat16:
            e = 2 * torch.exp2(torch.floor(torch.log2(y.abs().clamp_min(2.0 ** -126))) - 7)
        else:
            e = torch.full_like(y, 1e-5 * ys.abs().max().item())
        w = w7[s].to(dtype).float()
        b = b7[s][:, None, None]
        logit = model.conv_dilated_final(y, w) + b
        terms = model.conv_dilated_final(y.abs(), w.abs()) + b.abs()
        err = model.conv_dilated_final(e, w.abs()) + 1e-6 * terms
        z = (logit.abs() - err).clamp_min(0)
        bounds.append(err * torch.sigmoid(z) * torch.sigmoid(-z) + 1e-6)
    return torch.stack(bounds)


def check_head_params(dev, n_img, w6, b6, bn_scale6, bn_shift6, w7, b7) -> int:
    """Check the head's stacked float32 params for `n_img` images; returns
    the number of stems S (K6 and K10 take the same params)."""
    vecs = {"b6": b6, "bn_scale6": bn_scale6, "bn_shift6": bn_shift6}
    s = check_layer(dev, w6, (32, 1, 5, 5), vecs, 1, name="w6")
    if check_layer(dev, w7, (2, 1, 4, 4), {"b7": b7}, 2, name="w7") != s:
        raise ValueError("w6 and w7 disagree on the number of stems")
    if n_img % s:
        raise ValueError(f"the sources hold {n_img} images, not a multiple of {s} stems")
    return s


def _head_tensor_cores(dtype) -> bool:
    """The fixed rule of csrc/head.cu: the bf16 head (K6, K10) runs up6 on
    the tensor cores, the float32 head the FMA template."""
    return dtype == torch.bfloat16


def _head_taps() -> tuple[int, ...]:
    """The tensor-core head's B operand as up6 taps: for each input shift
    (dh, dw) in row-major order over {-1, 0, 1}^2 and each of 8 columns,
    the tap 5 kh + kw that output parity 2 dp + dq (the column) reads
    through it, kh = 1 - 2 dh + dp and kw = 1 - 2 dw + dq (as `_up_taps`),
    or 25 where there is none: columns 4-7 (padding) and 11 of the 36
    (shift, parity) pairs."""
    taps = []
    for dh in (-1, 0, 1):
        for dw in (-1, 0, 1):
            for col in range(8):
                dp, dq = divmod(col, 2)
                kh, kw = 1 - 2 * dh + dp, 1 - 2 * dw + dq
                taps.append(5 * kh + kw if col < 4 and 0 <= kh < 5 and 0 <= kw < 5 else 25)
    return tuple(taps)


@functools.cache
def _head_tap_index(device: torch.device) -> torch.Tensor:
    """_head_taps as a (9, 8) index tensor on `device`, made once (see
    `_up_tap_index`)."""
    return torch.tensor(_head_taps(), device=device).reshape(9, 8)


def _head_weights(w6: torch.Tensor, dtype) -> torch.Tensor:
    """(S, 32, 1, 5, 5) -> the tensor-core head's B operand in dtype, (S,
    18, 8, 16): k16 step 9 src + shift (skip1's 16 channels at the 9 input
    shifts, then up5's), column 2 dp + dq (zero where the parity does not
    read the shift, and for columns 4-7), K the source's channel,
    contiguous."""
    s = w6.shape[0]
    w = torch.cat([w6.reshape(s, 2, 16, 25), w6.new_zeros(s, 2, 16, 1)], -1)
    b = w[..., _head_tap_index(w6.device)]  # (S, src, channel, shift, column)
    return b.permute(0, 1, 3, 4, 2).reshape(s, 18, 8, 16).to(dtype).contiguous()


def head_operands(w6, b6, bn_scale6, bn_shift6, w7, b7, dtype):
    """The head kernel's weights in `dtype`, up6's (S, 18, 8, 16) from
    `_head_weights` for the tensor cores or (S, 32, 25) for the FMA
    template, up7's (S, 2, 16), and its scalar table (S, 5) float32: b6,
    bn_scale6, bn_shift6, b7. The caller keeps all three bound to names
    until the launch returns."""
    s = w6.shape[0]
    w6k = (_head_weights(w6, dtype) if _head_tensor_cores(dtype)
           else w6.to(dtype).reshape(s, 32, 25).contiguous())
    return (w6k, w7.to(dtype).reshape(s, 2, 16).contiguous(),
            torch.cat([b6, bn_scale6, bn_shift6, b7], 1).contiguous())


def check_head_alignment(dtype, *sources: torch.Tensor) -> None:
    """The tensor-core head copies 16 bytes at a time: raise unless every
    bf16 source is 16-byte aligned."""
    if _head_tensor_cores(dtype) and any(t.data_ptr() % 16 for t in sources):
        raise ValueError("the head's bf16 sources must be 16-byte aligned")


def head_mma_attributes(device: torch.device) -> dict[str, int]:
    """The bf16 tensor-core head's resources (K6's instance; K10's differs
    only in the channel stride), as the CUDA runtime reports them on
    `device`: registers a thread, dynamic shared memory a block (bytes),
    threads a block and resident blocks an SM."""
    attrs = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        launch(_lib().spleeterrt_head_mma_attrs, attrs)
    return dict(zip(("registers", "smem_bytes", "threads", "blocks_per_sm"), attrs))


@traced("kernels.head")
def head(
    skip1: torch.Tensor,  # (S * B, H, W, 16) NHWC: enc1's skip
    up5: torch.Tensor,  # (S * B, H, W, 16): up5's output, same dtype
    w6: torch.Tensor,  # (S, 32, 1, 5, 5) float32, rows [:16] for skip1
    b6: torch.Tensor,  # (S, 1) float32; bn_scale6, bn_shift6 the same
    bn_scale6: torch.Tensor,
    bn_shift6: torch.Tensor,
    w7: torch.Tensor,  # (S, 2, 1, 4, 4) float32
    b7: torch.Tensor,  # (S, 2) float32
    *,
    act: str,
) -> torch.Tensor:
    """up6 + up7 + sigmoid -> masks (S, B, 2, 2H, 2W) float32."""
    check_no_grad("head", skip1, up5, w6, b6, bn_scale6, bn_shift6, w7, b7)
    _check_sources(skip1, up5, ("skip1", "up5"))
    dev = skip1.device
    sb, h, wd, c = skip1.shape
    if c != HEAD_WIDTH:
        raise ValueError(f"skip1 must have {HEAD_WIDTH} channels, got {c}")
    s = check_head_params(dev, sb, w6, b6, bn_scale6, bn_shift6, w7, b7)
    code = check_act(act, ACTS)
    if dev.type == "cpu":
        return head_plain(skip1, up5, w6, b6, bn_scale6, bn_shift6, w7, b7,
                          act=act)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dtype = skip1.dtype
    check_head_alignment(dtype, skip1, up5)
    check_grid(sb, "the head's images (grid z)")
    masks = torch.empty((s, sb // s, 2, 2 * h, 2 * wd), dtype=torch.float32,
                        device=dev)
    w6k, w7k, scal = head_operands(w6, b6, bn_scale6, bn_shift6, w7, b7, dtype)
    with torch.cuda.device(dev):
        launch(
            _lib().spleeterrt_head, int(dtype == torch.bfloat16),
            skip1.data_ptr(), up5.data_ptr(), w6k.data_ptr(), w7k.data_ptr(),
            scal.data_ptr(), sb, sb // s, h, wd, code, masks.data_ptr(),
            stream_of(dev),
        )
    count_launch("head")
    return masks
