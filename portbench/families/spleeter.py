"""Spleeter's U-Net (`spleeterrt_tpu_torch/core/model.py`): one net a stem
over magnitude tiles of a 4096-point STFT, masks applied to the spectrum,
a masked inverse STFT. The surface `families/__init__.py` describes, and
the helpers of the drivers that run only Spleeter (`stream`, `http`).

Weights follow a configuration's channel ladder: he-normal fan-in weights,
as the program's `init_params` draws them, and biases and batch norms drawn
around their identity (bias 0.1 N, scale 1 + 0.3 N, shift 0.2 N), so that a
kernel that misreads its epilogue shows in the check. They are made on the
device in two draws, one for every weight of every net and one for the
vectors, and carved into views.
"""

from __future__ import annotations

import importlib
import math

import torch

from portbench import work
from portbench.families import patched


def layer_table(cfg: dict) -> list[tuple[str, tuple[int, ...], int, bool]]:
    """(layer, weight shape, fan-in, has batch norm) of one net."""
    out = []
    enc, dec = cfg["encoder_channels"], cfg["decoder_channels"]
    for i, (cin, cout) in enumerate(enc, start=1):
        out.append((f"down{i}", (cout, cin, 5, 5), 25 * cin, i < len(enc)))
    for i, (cin, cout) in enumerate(dec, start=1):
        out.append((f"up{i}", (cin, cout, 5, 5), 25 * cin, True))
    cin, cout = cfg["final_channels"]
    out.append((f"up{len(dec) + 1}", (cout, cin, 4, 4), 16 * cin, False))
    return out


def make_nets(cfg: dict, n_nets: int, gen: torch.Generator, device) -> dict:
    """{layer: {"w", "b"[, "bn_scale", "bn_shift"]}}, each (n_nets, ...)
    float32 on `device`."""
    table = layer_table(cfg)
    sizes = [n_nets * math.prod(shape) for _, shape, _, _ in table]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    widths = [shape[1] if name.startswith("up") and bn else shape[0]
              for name, shape, _, bn in table]
    vec = torch.randn(3 * n_nets * sum(widths), generator=gen, device=device)
    nets, pos, vpos = {}, 0, 0
    for (name, shape, fan_in, bn), size, width in zip(table, sizes, widths):
        w = flat[pos : pos + size].view(n_nets, *shape)
        w.mul_(math.sqrt(2.0 / fan_in))
        pos += size
        v = vec[vpos : vpos + 3 * n_nets * width].view(3, n_nets, width)
        vpos += 3 * n_nets * width
        layer = {"w": w, "b": v[0].mul(0.1)}
        if bn:
            layer["bn_scale"] = v[1].mul(0.3).add_(1.0)
            layer["bn_shift"] = v[2].mul(0.2)
        nets[name] = layer
    return nets


def net_list(nets: dict) -> list[dict]:
    """The stacked nets as one dict a net (views)."""
    n = nets["down1"]["w"].shape[0]
    return [{ln: {fn: v[s] for fn, v in ly.items()} for ln, ly in nets.items()}
            for s in range(n)]


def program_config(cfg: dict):
    """The program's SeparatorConfig for a configuration file."""
    from spleeterrt_tpu_torch.config import SeparatorConfig

    return SeparatorConfig(
        bin_limit=cfg["bin_limit"], time_step=cfg["time_step"],
        num_stems=cfg["num_stems"], unaffected_weight=cfg["unaffected_weight"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        sigmoid=cfg["sigmoid"],
    )


def net_kwargs(cfg: dict, nets: dict) -> dict:
    """The nets as `separate.separate` takes them: a stack for 4 and 5
    stems, one net for 2."""
    if cfg["num_stems"] >= 4:
        return {"stacked_params": nets}
    return {"params": net_list(nets)[0]}


def base_shapes(cfg: dict) -> dict:
    """The shape variables every unit has."""
    n = cfg["fft_size"]
    return {
        "T": cfg["time_step"], "F": cfg["bin_limit"], "N": n, "NB": n // 2 + 1,
        "RFFT": work.rfft_flops(n),
        "e": torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8,
    }


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    return make_nets(cfg, cfg["nets"], gen, device)


def program(cfg: dict, weights: dict, device):
    """`core/separate.py::separate`, looked up at each call so that a
    planted fault is the one called; the stems stay on the device."""
    from spleeterrt_tpu_torch.core import separate

    kwargs = net_kwargs(cfg, weights)
    pcfg = program_config(cfg)

    def call(track):
        return separate.separate(track, cfg=pcfg, device=device, **kwargs)

    return call


def reference(track: torch.Tensor, weights: dict, cfg: dict,
              precision: str) -> torch.Tensor:
    from portbench.reference import offline

    return offline.separate(track, net_list(weights), cfg, precision)


def unit_shapes(cfg: dict, n_samples: int) -> dict:
    """The shape variables of one offline call (stage formulas, useful
    FLOPs)."""
    fft, hop, t = cfg["fft_size"], cfg["hop"], cfg["time_step"]
    size = fft * -(-n_samples // fft) + 2 * fft
    n_out = -(-size // hop)
    n_comp = (size - fft + hop // 4) // hop + 1
    tiles = -(-n_out // t)
    s = cfg["nets"]
    return base_shapes(cfg) | {
        "S": s, "rows": 2, "data_size": size, "n_comp": n_comp,
        "n_req": tiles * t, "tiles": tiles, "images": s * tiles,
        "istft_frames": n_out, "forward_ffts": 2 * n_comp,
        "inverse_ffts": s * 2 * n_out,
    }


def unet_flops_per_image(cfg: dict, t: int, f: int) -> float:
    """Multiply-adds x 2 of one net over one (t, f) image: a convolution's
    from its shapes, a transposed 5x5 stride-2 convolution driving 25 taps
    from every input position. Restates the JAX-era
    `bench.py::_unet_flops_per_tile`."""
    total = 0.0
    th, fh = t, f
    for cin, cout in cfg["encoder_channels"]:
        th, fh = th // 2, fh // 2
        total += 2.0 * th * fh * cout * 25 * cin
    for cin, cout in cfg["decoder_channels"]:
        total += 2.0 * th * fh * cin * 25 * cout
        th, fh = th * 2, fh * 2
    cin, cout = cfg["final_channels"]
    return total + 2.0 * t * f * cout * cin * 16


def unit_flops(cfg: dict, shapes: dict) -> float:
    """Useful operations of one unit (a call or a block step): every net
    over every image, each forward and inverse real FFT (`bench.py::
    _pipeline_flops`)."""
    unet = shapes["images"] * unet_flops_per_image(cfg, shapes["T"], shapes["F"])
    ffts = shapes["forward_ffts"] + shapes["inverse_ffts"]
    return unet + ffts * work.rfft_flops(cfg["fft_size"])


def small_config(cfg: dict) -> dict:
    """64-frame, 512-bin tiles; every width of the nets as published."""
    return dict(cfg, bin_limit=512, time_step=64)


# The faults, each planted where the program produces what it breaks:
# `altered` (one stem of every answer loses one 4096-sample block where the
# graph returns it; `altered_step` the same in a streaming block step),
# `half_batch` (the masks of the second half of the U-Net's images, tiles or
# streams, are dropped), `state_unchanged` (a streaming block step hands back
# the state it was given).

def _altered(fn):
    def wrapper(*args, **kwargs):
        stems = fn(*args, **kwargs)
        first = next(iter(stems))
        x = stems[first].clone()
        x[..., x.shape[-1] // 2 : x.shape[-1] // 2 + 4096] = 0.0
        return {**stems, first: x}

    return wrapper


def _altered_step(fn):
    def wrapper(*args, **kwargs):
        state, out = fn(*args, **kwargs)
        out = out.clone()
        out[:, 0, :, out.shape[-1] // 2 : out.shape[-1] // 2 + 4096] = 0.0
        return state, out

    return wrapper


def _half_batch(fn):
    def wrapper(*args, **kwargs):
        masks = fn(*args, **kwargs).clone()
        masks[:, masks.shape[1] // 2 :] = 0.0
        return masks

    return wrapper


def _state_unchanged(fn):
    def wrapper(params, state, *args, **kwargs):
        _, out = fn(params, state, *args, **kwargs)
        return state, out

    return wrapper


def _in_program(module: str, name: str, make):
    """A factory of the context manager that plants `make` around
    `spleeterrt_tpu_torch.<module>.<name>`."""
    def plant():
        return patched(importlib.import_module(f"spleeterrt_tpu_torch.{module}"),
                       name, make)

    return plant


_ALTERED = _in_program("core.separate", "separate", _altered)
_HALF_BATCH = _in_program("core.model", "packed_unet_masks", _half_batch)

# The faults each driver's cells can have.
FAULTS = {
    "offline": {"altered": _ALTERED, "half_batch": _HALF_BATCH},
    "stream": {
        "altered_step": _in_program("runtime.stream", "block_step_streams", _altered_step),
        "state_unchanged": _in_program("runtime.stream", "block_step_streams",
                                       _state_unchanged),
        "half_batch": _HALF_BATCH,
    },
    "http": {"altered": _ALTERED, "half_batch": _HALF_BATCH},
}
