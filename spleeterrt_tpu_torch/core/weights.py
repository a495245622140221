"""Weight stores: the reference's packed blob format <-> params dicts.

Raw fp32 `spleeterCoeff` blobs, 39,290,900 bytes each, are loaded by the VST
(`drum4stems.dat` etc., VST/Source/PluginProcessor.cpp:50-86). Layout is
the struct at Executable/spleeter.h:5-31: for each encoder layer
`convWeight [Cout][Cin][5][5], convBias [Cout], batchNorm [2*Cout]`
(batchNorm first half = shift, second half = scale); down6 has no
batchNorm; decoder layers store transposed-conv weights as
`[Cin][Cout][5][5]`; final layer `up7` is `[2][1][4][4] + bias[2]`.

Those C layouts are exactly PyTorch's: OIHW for `conv2d` and
(Cin, Cout, kh, kw) for `conv_transpose2d`, so blobs decode without a
transpose. The reference package keeps HWIO kernels; `params_from_jax`
converts its params (and its npz checkpoints) to this layout.
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


def load_coeff_file(path: str | os.PathLike | BinaryIO) -> Params:
    """Read one raw fp32 blob file (the VST's .dat format)."""
    if hasattr(path, "read"):
        data = path.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    return blob_to_params(data)


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
                transposed = ln.startswith("up") and ln != "up7"
                a = a.transpose(2, 3, 0, 1) if transposed else a.transpose(3, 2, 0, 1)
            out[fn] = torch.tensor(np.ascontiguousarray(a))
        params[ln] = out
    return params


def load_npz(path: str | os.PathLike) -> Params:
    """Read a reference-package npz checkpoint (flat `layer/field` HWIO
    arrays) into this package's layout."""
    with np.load(path) as data:
        tree: dict = {}
        for key in data.files:
            ln, fn = key.split("/")
            tree.setdefault(ln, {})[fn] = data[key]
    return params_from_jax(tree)


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
