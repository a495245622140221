"""Weight stores: the reference's packed blob formats <-> params dicts.

Two on-disk formats, as in the reference:

1. Raw fp32 `spleeterCoeff` blobs, 39,290,900 bytes each, loaded by the
   VST (`drum4stems.dat` etc., VST/Source/PluginProcessor.cpp:50-86).
   Layout is the struct at Executable/spleeter.h:5-31: for each encoder
   layer `convWeight [Cout][Cin][5][5], convBias [Cout], batchNorm
   [2*Cout]` (batchNorm first half = shift, second half = scale); down6
   has no batchNorm; decoder layers store transposed-conv weights as
   `[Cin][Cout][5][5]`; final layer `up7` is `[2][1][4][4] + bias[2]`.
2. The fp16-quantized two-subnet exe model (`spleeterQuantized`,
   Executable/spleeter.h:32-62), decoded with denormals-as-zero
   (Executable/main.c:423-443). Subnet 0 is the 4-stem-family net (ELU),
   subnet 1 the 2-stem net (leaky/ReLU) (Executable/main.c:759-760).

Those C layouts are exactly PyTorch's: OIHW for `conv2d` and
(Cin, Cout, kh, kw) for `conv_transpose2d`, so blobs decode without a
transpose. The reference package keeps HWIO kernels; `params_from_jax`
converts its params (and its npz checkpoints) to this layout and
`params_to_jax` back (`save_npz` writes the reference's npz).
"""

from __future__ import annotations

import os
from typing import BinaryIO

import numpy as np
import torch

from spleeterrt_tpu_torch.core.model import (
    DECODER_CHANNELS,
    ENCODER_CHANNELS,
    FINAL_CHANNELS,
    Params,
)

COEFF_BLOB_BYTES = 39_290_900  # sizeof(spleeterCoeff)
COEFF_BLOB_FLOATS = COEFF_BLOB_BYTES // 4

# Stem order of the VST's four .dat blobs (VST/Source/PluginProcessor.cpp:50-86).
VST_BLOB_STEMS = ("drums", "bass", "accompaniment", "vocals")
VST_BLOB_FILENAMES = {
    "drums": "drum4stems.dat",
    "bass": "bass4stems.dat",
    "accompaniment": "accompaniment4stems.dat",
    "vocals": "vocal4stems.dat",
}


def _blob_fields():
    """Yield (name, shape) in exact struct order; shapes are the C layouts."""
    for i, (cin, cout) in enumerate(ENCODER_CHANNELS, start=1):
        yield f"down{i}/w", (cout, cin, 5, 5)
        yield f"down{i}/b", (cout,)
        if i < 6:
            yield f"down{i}/bn", (2, cout)
    for i, (cin, cout) in enumerate(DECODER_CHANNELS, start=1):
        yield f"up{i}/w", (cin, cout, 5, 5)
        yield f"up{i}/b", (cout,)
        yield f"up{i}/bn", (2, cout)
    cin, cout = FINAL_CHANNELS
    yield "up7/w", (cout, cin, 4, 4)
    yield "up7/b", (cout,)


def blob_to_params(blob: bytes | np.ndarray) -> Params:
    """Decode one raw fp32 `spleeterCoeff` blob into a params dict."""
    if isinstance(blob, (bytes, bytearray, memoryview)):
        flat = np.frombuffer(blob, dtype="<f4")
    else:
        flat = np.asarray(blob, dtype=np.float32).reshape(-1)
    if flat.size != COEFF_BLOB_FLOATS:
        raise ValueError(
            f"blob has {flat.size} floats, expected {COEFF_BLOB_FLOATS}"
        )
    params: Params = {}
    pos = 0
    for name, shape in _blob_fields():
        n = int(np.prod(shape))
        arr = torch.tensor(flat[pos : pos + n].reshape(shape))
        pos += n
        layer_name, field = name.split("/")
        layer = params.setdefault(layer_name, {})
        if field == "bn":  # [0] = shift, [1] = scale
            layer["bn_shift"] = arr[0].clone()
            layer["bn_scale"] = arr[1].clone()
        else:
            layer[field] = arr
    if pos != COEFF_BLOB_FLOATS:
        raise ValueError("blob field table does not cover the blob")
    return params


def params_to_blob(params: Params) -> bytes:
    """Inverse of :func:`blob_to_params` (round-trip exact)."""
    out = np.empty(COEFF_BLOB_FLOATS, dtype="<f4")
    pos = 0
    for name, shape in _blob_fields():
        layer_name, field = name.split("/")
        layer = params[layer_name]
        if field == "bn":
            arr = torch.stack([layer["bn_shift"], layer["bn_scale"]])
        else:
            arr = layer[field]
        arr = arr.detach().cpu().float().numpy()
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, the blob holds {shape}")
        out[pos : pos + arr.size] = arr.reshape(-1)
        pos += arr.size
    return out.tobytes()


def decode_fp16_daz(raw: np.ndarray) -> np.ndarray:
    """fp16 bits -> fp32 with denormals flushed to (signed) zero.

    The decode rule at Executable/main.c:423-434, bit for bit: mantissa
    aligned to fp32, bias adjusted, and any value with a zero fp16 exponent
    (including denormals with nonzero mantissa) becomes +-0.0.
    """
    h = np.asarray(raw, dtype=np.uint16).astype(np.uint32)
    t1 = (h & 0x7FFF) << 13
    t2 = (h & 0x8000) << 16
    t3 = h & 0x7C00
    t1 = t1 + 0x38000000
    t1 = np.where(t3 == 0, np.uint32(0), t1)
    return (t1 | t2).view(np.float32)


def encode_fp16(values: np.ndarray) -> np.ndarray:
    """fp32 -> fp16 bits (round to nearest), the inverse store for tests."""
    return np.asarray(values, dtype=np.float32).astype(np.float16).view(np.uint16)


def load_quantized_model(data: bytes | np.ndarray) -> tuple[Params, Params]:
    """Decode the exe's two-subnet fp16 model (Executable/main.c:435-443).

    Returns (four_stem_family_params, two_stem_params): subnet 0 is consumed
    with stemMode=1 (ELU), subnet 1 with stemMode=0 (Executable/main.c:782,858).
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        halves = np.frombuffer(data, dtype="<u2")
    else:
        halves = np.asarray(data, dtype=np.uint16).reshape(-1)
    if halves.size != 2 * COEFF_BLOB_FLOATS:
        raise ValueError(
            f"quantized model has {halves.size} halfwords, expected "
            f"{2 * COEFF_BLOB_FLOATS}"
        )
    decoded = decode_fp16_daz(halves)
    return (
        blob_to_params(decoded[:COEFF_BLOB_FLOATS]),
        blob_to_params(decoded[COEFF_BLOB_FLOATS:]),
    )


def load_coeff_file(path: str | os.PathLike | BinaryIO) -> Params:
    """Read one raw fp32 blob file (the VST's .dat format)."""
    if hasattr(path, "read"):
        data = path.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    return blob_to_params(data)


def save_coeff_file(params: Params, path: str | os.PathLike | BinaryIO) -> None:
    """Write params as a raw fp32 blob (loadable by the reference VST)."""
    blob = params_to_blob(params)
    if hasattr(path, "write"):
        path.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)


def _is_transposed_conv(layer_name: str) -> bool:
    return layer_name.startswith("up") and layer_name != "up7"


def params_from_jax(tree) -> Params:
    """Reference-package params (HWIO kernels, numpy or array-like leaves)
    -> this package's layout: conv kernels (kh, kw, Cin, Cout) -> OIHW,
    transposed-conv kernels (kh, kw, Cin, Cout) -> (Cin, Cout, kh, kw)."""
    params: Params = {}
    for ln, layer in tree.items():
        out = {}
        for fn, v in layer.items():
            a = np.asarray(v, dtype=np.float32)
            if fn == "w":
                a = (a.transpose(2, 3, 0, 1) if _is_transposed_conv(ln)
                     else a.transpose(3, 2, 0, 1))
            out[fn] = torch.tensor(np.ascontiguousarray(a))
        params[ln] = out
    return params


def params_to_jax(params: Params) -> dict:
    """Inverse of :func:`params_from_jax`: numpy float32 leaves with the
    reference package's HWIO kernels."""
    tree: dict = {}
    for ln, layer in params.items():
        out = {}
        for fn, v in layer.items():
            a = v.detach().cpu().float().numpy()
            if fn == "w":  # (Cin, Cout, kh, kw) or OIHW -> (kh, kw, Cin, Cout)
                a = a.transpose(2, 3, 0, 1) if _is_transposed_conv(ln) else (
                    a.transpose(2, 3, 1, 0))
            out[fn] = np.ascontiguousarray(a)
        tree[ln] = out
    return tree


def load_npz(path: str | os.PathLike) -> Params:
    """Read a reference-package npz checkpoint (flat `layer/field` HWIO
    arrays) into this package's layout."""
    with np.load(path) as data:
        tree: dict = {}
        for key in data.files:
            ln, fn = key.split("/")
            tree.setdefault(ln, {})[fn] = data[key]
    return params_from_jax(tree)


def save_npz(params: Params, path: str | os.PathLike) -> None:
    """Write the reference package's npz checkpoint (flat `layer/field`
    HWIO arrays, which its `load_npz` reads): the inverse of
    :func:`load_npz`."""
    flat = {
        f"{ln}/{fn}": a
        for ln, layer in params_to_jax(params).items()
        for fn, a in layer.items()
    }
    with open(path, "wb") as f:
        np.savez(f, **flat)


def random_blob(rng: np.random.Generator, scale: float = 0.05) -> bytes:
    """A random fp32 blob for parity tests (model.7z is absent upstream)."""
    flat = rng.standard_normal(COEFF_BLOB_FLOATS).astype(np.float32) * scale
    return flat.tobytes()


def stack_params(params_list: list[Params]) -> Params:
    """Stack per-stem params along a leading axis for multi_stem_masks."""
    return {
        ln: {
            fn: torch.stack([p[ln][fn] for p in params_list])
            for fn in params_list[0][ln]
        }
        for ln in params_list[0]
    }


def params_to(params: Params, device) -> Params:
    """Move every tensor of a (stacked) params dict to `device`."""
    return {
        ln: {fn: v.to(device) for fn, v in ly.items()} for ln, ly in params.items()
    }
