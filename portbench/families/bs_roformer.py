"""BS-RoFormer (`spleeterrt_tpu_torch/core/roformer.py`): band-split RoPE
transformers over time and over bands with complex masks, whole tracks in
overlapped 8 s chunks; the instrumental is the input minus the vocals.
The surface `families/__init__.py` describes.

Weights are the program's flat dict of named float32 tensors (linear
weights (out, in)), drawn on the device in one draw and carved into views:
fan-in normal linear weights, norm gains 1 + 0.1 N, biases 0.1 N, so that
a program that drops a gain or a bias shows in the check. The plain
reference is `reference/roformer.py`.

One call's shape variables are all prefixed `rof_`, so that no stage of
another family applies to this unit and no `rof_` stage to theirs.
"""

from __future__ import annotations

import importlib
import math
import types

import torch

from portbench import work
from portbench.families import patched

# The keys of a configuration file that RoformerConfig takes as they are.
_FIELDS = ("dim", "depth", "heads", "dim_head", "ff_mult", "mask_hidden_mult",
           "mask_depth", "n_fft", "hop", "win", "rope_theta", "chunk",
           "num_overlap", "batch", "residual_stem", "audio_channels")


def _fields(cfg: dict) -> dict:
    return {**{k: cfg[k] for k in _FIELDS},
            "freqs_per_bands": tuple(cfg["freqs_per_bands"]),
            "stems": tuple(cfg["stems"])}


def param_table(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every weight, in the program's order (its
    `core/roformer.py::param_shapes`)."""
    d, inner = cfg["dim"], cfg["heads"] * cfg["dim_head"]
    ff, hid = cfg["dim"] * cfg["ff_mult"], cfg["dim"] * cfg["mask_hidden_mult"]
    d_ins = [2 * cfg["audio_channels"] * b for b in cfg["freqs_per_bands"]]
    out = []
    for k, d_in in enumerate(d_ins):
        out += [(f"band_split.{k}.gamma", (d_in,)), (f"band_split.{k}.w", (d, d_in)),
                (f"band_split.{k}.b", (d,))]
    for i in range(cfg["depth"]):
        for axis in ("time", "band"):
            p = f"layers.{i}.{axis}."
            out += [(p + "attn.gamma", (d,)), (p + "attn.w_qkv", (3 * inner, d)),
                    (p + "attn.w_gate", (cfg["heads"], d)), (p + "attn.b_gate", (cfg["heads"],)),
                    (p + "attn.w_out", (d, inner)), (p + "ff.gamma", (d,)),
                    (p + "ff.w1", (ff, d)), (p + "ff.b1", (ff,)), (p + "ff.w2", (d, ff)),
                    (p + "ff.b2", (d,))]
    out.append(("final_norm.gamma", (d,)))
    for s in range(len(cfg["stems"])):
        for k, d_in in enumerate(d_ins):
            p = f"mask.{s}.{k}."
            out += [(p + "w1", (hid, d)), (p + "b1", (hid,)), (p + "w2", (2 * d_in, hid)),
                    (p + "b2", (2 * d_in,))]
    return out


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    table = param_table(cfg)
    flat = torch.randn(sum(math.prod(s) for _, s in table), generator=gen, device=device)
    weights, pos = {}, 0
    for name, shape in table:
        x = flat[pos : pos + math.prod(shape)].view(shape)
        pos += x.numel()
        leaf = name.rsplit(".", 1)[1]
        if leaf == "gamma":
            x.mul_(0.1).add_(1.0)
        elif leaf.startswith("b"):
            x.mul_(0.1)
        else:
            x.mul_(1.0 / math.sqrt(shape[1]))
        weights[name] = x
    return weights


def program_config(cfg: dict):
    """The program's RoformerConfig for a configuration file."""
    from spleeterrt_tpu_torch.config import RoformerConfig

    return RoformerConfig(**_fields(cfg), compute_dtype=getattr(torch, cfg["compute_dtype"]))


def program(cfg: dict, weights: dict, device):
    """`core/separate.py::separate` with the configuration's RoformerConfig,
    looked up at each call so that a planted fault is the one called; the
    stems stay on the device."""
    importlib.import_module("spleeterrt_tpu_torch.core.roformer")
    from spleeterrt_tpu_torch.core import separate

    pcfg = program_config(cfg)

    def call(track):
        return separate.separate(track, params=weights, cfg=pcfg, device=device)

    return call


def reference(track: torch.Tensor, weights: dict, cfg: dict,
              precision: str) -> torch.Tensor:
    from portbench.reference import roformer

    stems = roformer.separate(track, weights, types.SimpleNamespace(**_fields(cfg)),
                              precision)
    return torch.stack([stems[s] for s in cfg["stem_names"]])


def num_chunks(cfg: dict, n_samples: int) -> int:
    """Chunks of one track (the program's and the reference's rule)."""
    chunk, step = cfg["chunk"], cfg["chunk"] // cfg["num_overlap"]
    border = chunk - step if n_samples > 2 * (chunk - step) else 0
    return max(0, -(-(n_samples + 2 * border - chunk) // step)) + 1


def unit_shapes(cfg: dict, n_samples: int) -> dict:
    """The shape variables of one offline call of a track (stage formulas,
    useful FLOPs)."""
    return {
        "rof_chunks": num_chunks(cfg, n_samples),
        "rof_frames": cfg["chunk"] // cfg["hop"] + 1,
        "rof_bands": len(cfg["freqs_per_bands"]),
        "rof_dim": cfg["dim"],
        "rof_heads": cfg["heads"],
        "rof_dim_head": cfg["dim_head"],
        "rof_ff": cfg["dim"] * cfg["ff_mult"],
        "rof_mask_hidden": cfg["dim"] * cfg["mask_hidden_mult"],
        "rof_dim_in": 2 * cfg["audio_channels"] * sum(cfg["freqs_per_bands"]),
        "rof_depth": cfg["depth"],
        "rof_stems": len(cfg["stems"]),
        "rof_channels": cfg["audio_channels"],
        "rof_rfft": work.rfft_flops(cfg["n_fft"]),
        "rof_e": torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8,
    }


def linear_flops(s: dict) -> float:
    """Multiply-adds x 2 of every linear layer of one call: each block's two
    transformer layers (to_qkv with to_gates, to_out, the feed-forward's two)
    over every token, the band split and the mask estimators over every
    frame."""
    inner = s["rof_heads"] * s["rof_dim_head"]
    d = s["rof_dim"]
    layer = d * (3 * inner + s["rof_heads"]) + inner * d + 2 * d * s["rof_ff"]
    frame = (s["rof_bands"] * 2 * s["rof_depth"] * layer + s["rof_dim_in"] * d
             + s["rof_stems"] * (s["rof_bands"] * d * s["rof_mask_hidden"]
                                 + 2 * s["rof_mask_hidden"] * s["rof_dim_in"]))
    return 2.0 * s["rof_chunks"] * s["rof_frames"] * frame


def attention_flops(s: dict) -> float:
    """QK^T and PV of every head: over time (sequences of the frames, one a
    band) and over bands (sequences of the bands, one a frame)."""
    f, b = s["rof_frames"], s["rof_bands"]
    return (4.0 * s["rof_heads"] * s["rof_dim_head"] * (f * f * b + b * b * f)
            * s["rof_depth"] * s["rof_chunks"])


def unit_flops(cfg: dict, shapes: dict) -> float:
    """Useful operations of one call: the linear layers, the attention and
    2.5 N log2 N for each forward and inverse FFT of a channel's frame."""
    ffts = shapes["rof_chunks"] * shapes["rof_frames"] * shapes["rof_channels"] * (
        1 + shapes["rof_stems"])
    return linear_flops(shapes) + attention_flops(shapes) + ffts * shapes["rof_rfft"]


def small_config(cfg: dict) -> dict:
    """The CPU tests' cut: dim 64, 2 blocks of 2 heads x 32, a 256-point
    STFT at hop 64 with its 129 bins in 19 bands, 0.5 s chunks, 3 a batch."""
    return dict(cfg, dim=64, depth=2, heads=2, dim_head=32, n_fft=256, hop=64, win=256,
                freqs_per_bands=[2] * 8 + [4] * 4 + [8] * 4 + [16] * 2 + [33],
                chunk=22050, batch=3)


# The faults, each planted where the program produces what it breaks:
# `altered` (the vocals of one chunk, the middle one, come back silent, as
# a zeroed mask gives), `half_batch` (only the first half of the chunks go
# through the net, the rest come back silent), `band_rope_off` (the band
# layers run without their rotary embedding).

def _altered(fn):
    def wrapper(w, chunks, cfg):
        out = fn(w, chunks, cfg)
        out[out.shape[0] // 2, 0] = 0.0
        return out

    return wrapper


def _half_batch(fn):
    def wrapper(w, chunks, cfg):
        k = chunks.shape[0]
        first = fn(w, chunks[: k // 2], cfg)
        return torch.cat([first, first.new_zeros((k - k // 2, *first.shape[1:]))])

    return wrapper


def _band_rope_off(fn):
    def wrapper(cfg, frames, device):
        time_rot, band_rot = fn(cfg, frames, device)
        return time_rot, torch.ones_like(band_rot)

    return wrapper


def _in_program(name: str, make):
    def plant():
        return patched(importlib.import_module("spleeterrt_tpu_torch.core.roformer"),
                       name, make)

    return plant


FAULTS = {
    "offline": {
        "altered": _in_program("run_chunks", _altered),
        "half_batch": _in_program("run_chunks", _half_batch),
        "band_rope_off": _in_program("rotary_tables", _band_rope_off),
    },
}
