"""BS-RoFormer in plain float32 PyTorch: the reference the port's
`core/roformer.py` is held against.

Written from lucidrains' `bs_roformer.py` (github.com/lucidrains/
BS-RoFormer) and rotary_embedding_torch, with ZFTurbo's `demix` chunking
(Music-Source-Separation-Training, utils), read as the configuration's
`assumed` states it. Per-band loops, softmax attention written out, one
chunk at a time, no grouping or batching. It imports nothing of the port
and no JAX, and turns TF32 off for matrix products while it runs.
Weights are the flat dict of the port's `init_params`: linear weights
(out, in), names as `param_shapes` lists them; the configuration is any
object with `RoformerConfig`'s fields.

`portbench/reference/roformer.py` is the benchmark's copy, which adds the
float8 control; a test holds the two equal.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms_norm(x, gamma):
    return F.normalize(x, dim=-1) * math.sqrt(x.shape[-1]) * gamma


def linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def rotate(x, pos, theta):
    """Rotary embedding over the last axis of x (..., L, d), pairs
    (2i, 2i + 1) turned by pos * theta ** (-2i / d)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = pos[:, None] * freqs[None]  # (L, d / 2)
    angles = angles.repeat_interleave(2, dim=-1)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rotated = torch.stack((-x2, x1), dim=-1).flatten(-2)
    return x * angles.cos() + rotated * angles.sin()


def attention(p, pre, x, cfg):
    """x + gated multi-head attention of RMSNorm(x), x (N, L, dim)."""
    n, length, _ = x.shape
    h, dh = cfg.heads, cfg.dim_head
    y = rms_norm(x, p[pre + "attn.gamma"])
    qkv = linear(y, p[pre + "attn.w_qkv"]).view(n, length, 3, h, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (N, H, L, dh)
    pos = torch.arange(length, dtype=torch.float32, device=x.device)
    q, k = rotate(q, pos, cfg.rope_theta), rotate(k, pos, cfg.rope_theta)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1)
    out = probs @ v  # (N, H, L, dh)
    gates = torch.sigmoid(linear(y, p[pre + "attn.w_gate"], p[pre + "attn.b_gate"]))
    out = out * gates.transpose(1, 2)[..., None]
    out = out.transpose(1, 2).reshape(n, length, h * dh)
    return x + linear(out, p[pre + "attn.w_out"])


def feed_forward(p, pre, x):
    y = rms_norm(x, p[pre + "ff.gamma"])
    y = F.gelu(linear(y, p[pre + "ff.w1"], p[pre + "ff.b1"]))
    return x + linear(y, p[pre + "ff.w2"], p[pre + "ff.b2"])


def net(p, chunk, cfg):
    """(C, chunk) -> (stems, C, chunk): one chunk through the model."""
    c, n = chunk.shape
    window = torch.hann_window(cfg.win, periodic=True, device=chunk.device)
    spec = torch.stft(chunk, cfg.n_fft, cfg.hop, cfg.win, window=window, center=True,
                      return_complex=True)  # (C, F, T)
    t = spec.shape[-1]
    x = torch.view_as_real(spec).permute(2, 1, 0, 3).reshape(t, -1)  # (T, F * C * 2)
    bands, start = [], 0
    for k, bins in enumerate(cfg.freqs_per_bands):
        width = 2 * c * bins
        xb = x[:, start : start + width]
        xb = rms_norm(xb, p[f"band_split.{k}.gamma"])
        bands.append(linear(xb, p[f"band_split.{k}.w"], p[f"band_split.{k}.b"]))
        start += width
    x = torch.stack(bands, dim=1)  # (T, bands, dim)
    for i in range(cfg.depth):
        x = x.transpose(0, 1)  # (bands, T, dim): sequences over time
        x = attention(p, f"layers.{i}.time.", x, cfg)
        x = feed_forward(p, f"layers.{i}.time.", x)
        x = x.transpose(0, 1)  # (T, bands, dim): sequences over bands
        x = attention(p, f"layers.{i}.band.", x, cfg)
        x = feed_forward(p, f"layers.{i}.band.", x)
    x = rms_norm(x, p["final_norm.gamma"])
    outs = []
    for s in range(len(cfg.stems)):
        parts = []
        for k in range(len(cfg.freqs_per_bands)):
            q = f"mask.{s}.{k}."
            y = torch.tanh(linear(x[:, k], p[q + "w1"], p[q + "b1"]))
            y = linear(y, p[q + "w2"], p[q + "b2"])
            parts.append(F.glu(y, dim=-1))
        mask = torch.cat(parts, dim=-1).view(t, -1, c, 2)  # (T, F, C, 2)
        mask = torch.view_as_complex(mask.contiguous()).permute(2, 1, 0)  # (C, F, T)
        outs.append(torch.istft(spec * mask, cfg.n_fft, cfg.hop, cfg.win, window=window,
                                center=True, length=n))
    return torch.stack(outs)


def demix(track, params, cfg, model=net):
    """(C, n) -> (stems, C, n): chunks of cfg.chunk every chunk /
    num_overlap samples over the reflect-padded track, each through
    `model`, faded, summed and normalised by the summed fades."""
    c, n = track.shape
    step = cfg.chunk // cfg.num_overlap
    border = cfg.chunk - step
    if n <= 2 * border:
        border = 0
    x = F.pad(track[None], (border, border), mode="reflect")[0] if border else track
    length = x.shape[-1]
    fade = cfg.chunk // 10
    ramp = torch.linspace(0.0, 1.0, fade, device=track.device)
    starts = [0]
    while starts[-1] + cfg.chunk < length:
        starts.append(starts[-1] + step)
    x = F.pad(x, (0, starts[-1] + cfg.chunk - length))
    out = torch.zeros((len(cfg.stems), c, x.shape[-1]), device=track.device)
    weight = torch.zeros(x.shape[-1], device=track.device)
    for j, s0 in enumerate(starts):
        w = torch.ones(cfg.chunk, device=track.device)
        if j > 0:
            w[:fade] = ramp
        if j < len(starts) - 1:
            w[-fade:] = ramp.flip(0)
        y = model(params, x[:, s0 : s0 + cfg.chunk], cfg)
        out[..., s0 : s0 + cfg.chunk] += y * w
        weight[s0 : s0 + cfg.chunk] += w
    return (out / weight)[..., border : border + n]


def separate(track, params, cfg):
    """(C, n) -> {stem: (C, n)}: the masked stems and, where the
    configuration has one, the residual stem (the input minus the first)."""
    with no_tf32(), torch.no_grad():
        y = demix(track, params, cfg)
    stems = dict(zip(cfg.stems, y))
    if cfg.residual_stem:
        stems[cfg.residual_stem] = track - y[0]
    return stems
