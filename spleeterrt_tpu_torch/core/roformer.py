"""BS-RoFormer: band-split RoPE transformers over time and over bands.

"Music Source Separation with Band-Split RoPE Transformer" (Lu et al.,
arXiv:2309.02612), as the public implementation computes it
(github.com/lucidrains/BS-RoFormer, `bs_roformer.py`), at the widths of
`config.RoformerConfig` (dim 512, 12 blocks, 8 heads of 64, feed-forward
2048, 62 bands, mask MLPs of 2048 with GLU, STFT 2048 / 441), with whole
tracks cut into chunks and overlap-added as ZFTurbo's
Music-Source-Separation-Training `demix` does.

One chunk of `cfg.chunk` stereo samples:

1. STFT, per channel: `torch.stft(n_fft, hop, win, hann periodic,
   center=True)`, F = n_fft / 2 + 1 bins by T frames, laid out as
   (t, f, s, c) with c = re / im and flattened f-major, so band k of b_k
   bins has 4 b_k inputs.
2. Band split: per band RMSNorm(4 b_k) and Linear(4 b_k -> dim) with bias,
   giving (t, band, dim).
3. `depth` blocks, each a transformer layer over time (sequences of T
   frames, one a band) then one over bands (sequences of the bands, one a
   frame). A layer is pre-norm attention and pre-norm feed-forward, each
   added to its input: RMSNorm; `to_qkv` (no bias); rotary embeddings on
   q and k (interleaved pairs, theta 10,000, all of dim_head; positions are
   frame indices in the time layer and band indices in the band layer, one
   table for each shared by every block); softmax attention at scale
   dim_head ** -0.5; a per-head sigmoid gate `to_gates` (with bias) on the
   heads' outputs; `to_out` (no bias). Feed-forward: RMSNorm, Linear(dim ->
   ff), exact GELU, Linear(ff -> dim), with biases. After the last block
   one RMSNorm.
4. Mask estimators, one a stem: per band Linear(dim -> hidden), tanh,
   Linear(hidden -> 2 * 4 b_k), GLU over the last axis; the bands
   concatenated in the STFT's layout and read as a complex mask.
5. The complex product of the STFT and the mask, and `torch.istft` with
   the same window back to `cfg.chunk` samples.

RMSNorm is lucidrains' `F.normalize(x) * sqrt(d) * gamma`, its statistics
in float32.

Departures from the paper's text, all as the public code has them: the
per-head sigmoid gate on the attention's output (`to_gates`; the paper
does not describe it), the final RMSNorm before the mask estimators, and
GLU in the mask estimators. Departures of this module from lucidrains'
code, none of which changes the function computed: the norms' gains are
folded into the linear layer that follows each norm (the weights are
scaled once a call, in float32, before the cast to the compute dtype);
`to_qkv` and `to_gates` are one matrix product; bands of equal width run
as one batched matrix product (7 groups for the 62 bands) in the band
split and the mask estimators; the attention's output projection adds the
residual in the same matrix product; the rotary embedding is applied as a
complex product in float32.

Chunking (`demix` as the benchmark configuration's `assumed` states it):
the track is reflect-padded by border = chunk - step on both sides (step =
chunk / num_overlap; no padding where the track is not longer than two
borders), zero-padded at the end to whole chunks, and cut at every step:
ceil((n + 2 border - chunk) / step) + 1 chunks (76 for 300 s at 8 s and
overlap 2). Each chunk's output is weighted by a window that is 1 except
for linear fades of chunk / 10 samples (`linspace(0, 1)` in, its reverse
out), the first chunk without its fade-in and the last without its
fade-out; the weighted outputs are added and divided by the summed
weights, and the track is cropped from `border`. The chunks run through
the net `cfg.batch` at a time.

Precision: the weights, the linear layers and the attention in
`cfg.compute_dtype` (bfloat16 on the card, float32 sums); the norms'
statistics, the STFT and iSTFT, the masks, the complex product and the
overlap-add in float32. The residual stream is kept in the compute dtype.

Spans (utils/timing.py): `model.roformer` (attributes `chunks`, `batch`,
`sdpa_backend`) around `roformer.stft`, `roformer.band_split`,
`roformer.time_attn` and `roformer.band_attn` (each block's attention
layers), `roformer.ff` (each feed-forward layer), `roformer.mask`,
`roformer.istft` and `roformer.overlap_add`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from spleeterrt_tpu_torch.config import RoformerConfig
from spleeterrt_tpu_torch.utils.timing import span

Params = dict[str, torch.Tensor]


def band_groups(cfg: RoformerConfig) -> list[tuple[int, int, int, int]]:
    """(first band, bands, inputs a band, offset of the first input) of each
    run of bands of equal width."""
    groups, band, offset = [], 0, 0
    bands = cfg.freqs_per_bands
    while band < len(bands):
        end = band
        while end < len(bands) and bands[end] == bands[band]:
            end += 1
        d_in = 2 * cfg.audio_channels * bands[band]
        groups.append((band, end - band, d_in, offset))
        offset += (end - band) * d_in
        band = end
    return groups


def param_shapes(cfg: RoformerConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the order `init_params` draws
    them. Linear weights are (out, in), as torch.nn.Linear's."""
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    ff, hidden = cfg.dim * cfg.ff_mult, cfg.dim * cfg.mask_hidden_mult
    d_ins = [2 * cfg.audio_channels * b for b in cfg.freqs_per_bands]
    out: dict[str, tuple[int, ...]] = {}
    for k, d_in in enumerate(d_ins):
        out |= {f"band_split.{k}.gamma": (d_in,), f"band_split.{k}.w": (d, d_in),
                f"band_split.{k}.b": (d,)}
    for i in range(cfg.depth):
        for axis in ("time", "band"):
            p = f"layers.{i}.{axis}."
            out |= {p + "attn.gamma": (d,), p + "attn.w_qkv": (3 * inner, d),
                    p + "attn.w_gate": (cfg.heads, d), p + "attn.b_gate": (cfg.heads,),
                    p + "attn.w_out": (d, inner), p + "ff.gamma": (d,),
                    p + "ff.w1": (ff, d), p + "ff.b1": (ff,), p + "ff.w2": (d, ff),
                    p + "ff.b2": (d,)}
    out["final_norm.gamma"] = (d,)
    for s in range(len(cfg.stems)):
        for k, d_in in enumerate(d_ins):
            p = f"mask.{s}.{k}."
            out |= {p + "w1": (hidden, d), p + "b1": (hidden,),
                    p + "w2": (2 * d_in, hidden), p + "b2": (2 * d_in,)}
    return out


def init_params(cfg: RoformerConfig, gen: torch.Generator | None = None,
                device: torch.device | str = "cpu") -> Params:
    """Random float32 weights: fan-in normal linear weights, norm gains 1 +
    0.1 N(0, 1), biases 0.1 N(0, 1), drawn in `param_shapes` order."""
    params = {}
    for name, shape in param_shapes(cfg).items():
        x = torch.randn(shape, generator=gen, device=device)
        leaf = name.rsplit(".", 1)[1]
        if leaf == "gamma":
            x = x.mul_(0.1).add_(1.0)
        elif leaf.startswith("b"):
            x = x.mul_(0.1)
        else:
            x = x.mul_(1.0 / math.sqrt(shape[1]))
        params[name] = x
    return params


def pack(params: Params, cfg: RoformerConfig) -> Params:
    """The weights as the forward pass takes them, in the compute dtype:
    each norm's gain folded into the linear layers after it, `to_qkv` and
    `to_gates` as one weight, equal-width bands stacked into one batched
    weight (transposed for `bmm`)."""
    dt, inner = cfg.compute_dtype, cfg.heads * cfg.dim_head
    p = lambda name: params[name].float()
    out = {}
    for g, (first, n, _, _) in enumerate(band_groups(cfg)):
        ks = range(first, first + n)
        out[f"bs.{g}.w"] = torch.stack(
            [p(f"band_split.{k}.w") * p(f"band_split.{k}.gamma") for k in ks]
        ).transpose(1, 2).to(dt)
        out[f"bs.{g}.b"] = torch.stack([p(f"band_split.{k}.b") for k in ks])[:, None].to(dt)
    for i in range(cfg.depth):
        for axis in ("time", "band"):
            pre, q = f"layers.{i}.{axis}.", f"{i}.{axis}."
            ga, gf = p(pre + "attn.gamma"), p(pre + "ff.gamma")
            out[q + "w_qkvg"] = torch.cat(
                [p(pre + "attn.w_qkv"), p(pre + "attn.w_gate")]).mul(ga).to(dt)
            out[q + "b_qkvg"] = torch.cat(
                [p(pre + "attn.b_gate").new_zeros(3 * inner), p(pre + "attn.b_gate")]).to(dt)
            out[q + "w_out_t"] = p(pre + "attn.w_out").t().to(dt)
            out[q + "w1"] = p(pre + "ff.w1").mul(gf).to(dt)
            out[q + "b1"] = p(pre + "ff.b1").to(dt)
            out[q + "w2_t"] = p(pre + "ff.w2").t().to(dt)
            out[q + "b2"] = p(pre + "ff.b2").to(dt)
    gamma = p("final_norm.gamma")
    for s in range(len(cfg.stems)):
        for g, (first, n, _, _) in enumerate(band_groups(cfg)):
            ks = [f"mask.{s}.{k}." for k in range(first, first + n)]
            out[f"mask.{s}.{g}.w1"] = torch.stack(
                [p(k + "w1") * gamma for k in ks]).transpose(1, 2).to(dt)
            out[f"mask.{s}.{g}.b1"] = torch.stack([p(k + "b1") for k in ks])[:, None].to(dt)
            out[f"mask.{s}.{g}.w2"] = torch.stack([p(k + "w2") for k in ks]).transpose(1, 2).to(dt)
            out[f"mask.{s}.{g}.b2"] = torch.stack([p(k + "b2") for k in ks])[:, None].to(dt)
    return out


def rotary(n: int, cfg: RoformerConfig, device) -> torch.Tensor:
    """(n, dim_head / 2) complex64: position i's rotation of pair j,
    exp(i * pos * theta ** (-2j / dim_head))."""
    inv = cfg.rope_theta ** (
        -torch.arange(0, cfg.dim_head, 2, device=device, dtype=torch.float32) / cfg.dim_head)
    angles = torch.arange(n, device=device, dtype=torch.float32)[:, None] * inv
    return torch.polar(torch.ones_like(angles), angles)


def rotary_tables(cfg: RoformerConfig, frames: int, device):
    """(time table, band table), each shared by every block."""
    return rotary(frames, cfg, device), rotary(len(cfg.freqs_per_bands), cfg, device)


def unit_rms(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x / ||x|| * sqrt(d) over the last axis (F.normalize's eps), the norm
    in float32, the result in `dtype`; the gain is in the next weight."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True, dtype=torch.float32)
    scale = math.sqrt(x.shape[-1]) / norm.clamp_min(1e-12)
    return (x * scale.to(x.dtype)).to(dtype)


def _sdpa(q, k, v):
    """Scaled dot-product attention, with cuDNN's kernel on a card: it took
    a 300 s call in 3.136 s on an H100 at 16 chunks a batch,
    FlashAttention-2's 3.275 s, the memory-efficient one's 3.490 s (torch
    2.11.0+cu128). CPU tensors take PyTorch's own choice."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v)


def attention(w: Params, pre: str, x: torch.Tensor, rot: torch.Tensor,
              cfg: RoformerConfig) -> torch.Tensor:
    """x + attention(RMSNorm(x)) over (N, L, dim) sequences; `rot` (L,
    dim_head / 2) the rotary table. Returns a new tensor."""
    n, length, d = x.shape
    h, dh = cfg.heads, cfg.dim_head
    inner = h * dh
    qkvg = F.linear(unit_rms(x, x.dtype), w[pre + "w_qkvg"], w[pre + "b_qkvg"])
    qk = torch.view_as_complex(
        qkvg[..., : 2 * inner].float().contiguous().view(n, length, 2 * h, dh // 2, 2))
    qk = torch.view_as_real(qk * rot[:, None]).to(x.dtype).view(n, length, 2, h, dh)
    v = qkvg[..., 2 * inner : 3 * inner].view(n, length, h, dh)
    o = _sdpa(qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2), v.transpose(1, 2))
    gates = torch.sigmoid(qkvg[..., 3 * inner :])
    o = o.transpose(1, 2) * gates[..., None]  # (N, L, H, dh)
    return x.reshape(-1, d).addmm(o.reshape(-1, inner), w[pre + "w_out_t"]).view(n, length, d)


def feed_forward(w: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    """x + FF(RMSNorm(x)) over (..., dim), in place on x."""
    d = x.shape[-1]
    hid = F.gelu(F.linear(unit_rms(x, x.dtype), w[pre + "w1"], w[pre + "b1"]))
    flat = x.view(-1, d)
    flat.addmm_(hid.view(-1, hid.shape[-1]), w[pre + "w2_t"]).add_(w[pre + "b2"])
    return x


def band_split(w: Params, feats: torch.Tensor, cfg: RoformerConfig,
               b: int, t: int) -> torch.Tensor:
    """(B * T, F * C * 2) float32 STFT features -> (B, bands, T, dim) in the
    compute dtype, band-major for the time layers."""
    dt = cfg.compute_dtype
    x = feats.new_empty((b, len(cfg.freqs_per_bands), t, cfg.dim), dtype=dt)
    for g, (first, n, d_in, off) in enumerate(band_groups(cfg)):
        a = unit_rms(feats[:, off : off + n * d_in].view(b * t, n, d_in), dt)
        y = torch.baddbmm(w[f"bs.{g}.b"], a.transpose(0, 1), w[f"bs.{g}.w"])
        x[:, first : first + n] = y.view(n, b, t, cfg.dim).transpose(0, 1)
    return x


def masks(w: Params, x: torch.Tensor, cfg: RoformerConfig) -> torch.Tensor:
    """(B, T, bands, dim) after the last block -> (stems, B * T, F * C * 2)
    float32 masks in the STFT features' layout: the final norm, then each
    stem's per-band MLP and GLU."""
    b, t, nb, d = x.shape
    xn = unit_rms(x, x.dtype).view(b * t, nb, d)
    out = x.new_empty((len(cfg.stems), b * t, 2 * cfg.audio_channels * sum(cfg.freqs_per_bands)),
                      dtype=torch.float32)
    for s in range(len(cfg.stems)):
        for g, (first, n, d_in, off) in enumerate(band_groups(cfg)):
            p = f"mask.{s}.{g}."
            hid = torch.baddbmm(w[p + "b1"], xn[:, first : first + n].transpose(0, 1),
                                w[p + "w1"]).tanh_()
            y = torch.baddbmm(w[p + "b2"], hid, w[p + "w2"]).float()
            glu = y[..., :d_in] * torch.sigmoid(y[..., d_in:])  # (n, B * T, d_in)
            out[s, :, off : off + n * d_in].view(b * t, n, d_in).copy_(glu.transpose(0, 1))
    return out


def net(w: Params, audio: torch.Tensor, cfg: RoformerConfig) -> torch.Tensor:
    """(B, C, chunk) float32 chunks -> (B, stems, C, chunk) float32: the
    masked stems of each chunk."""
    b, c, n = audio.shape
    window = torch.hann_window(cfg.win, periodic=True, device=audio.device)
    with span("roformer.stft"):
        spec = torch.stft(audio.reshape(b * c, n), cfg.n_fft, cfg.hop, cfg.win,
                          window=window, center=True, return_complex=True)
        nf, t = spec.shape[-2:]
        feats = (torch.view_as_real(spec).view(b, c, nf, t, 2).permute(0, 3, 2, 1, 4)
                 .reshape(b * t, nf * c * 2))
    time_rot, band_rot = rotary_tables(cfg, t, audio.device)
    nb, d = len(cfg.freqs_per_bands), cfg.dim
    with span("roformer.band_split"):
        x = band_split(w, feats, cfg, b, t)
    del feats
    for i in range(cfg.depth):
        with span("roformer.time_attn"):
            x = attention(w, f"{i}.time.", x.view(b * nb, t, d), time_rot, cfg)
        with span("roformer.ff"):
            x = feed_forward(w, f"{i}.time.", x)
        x = x.view(b, nb, t, d).transpose(1, 2).contiguous()
        with span("roformer.band_attn"):
            x = attention(w, f"{i}.band.", x.view(b * t, nb, d), band_rot, cfg)
        with span("roformer.ff"):
            x = feed_forward(w, f"{i}.band.", x)
        x = x.view(b, t, nb, d)
        if i + 1 < cfg.depth:
            x = x.transpose(1, 2).contiguous()
    with span("roformer.mask"):
        m = masks(w, x, cfg)  # (S, B * T, F * C * 2)
        del x
        s = m.shape[0]
        m = torch.view_as_complex(m.view(s, b, t, nf, c, 2)).permute(1, 0, 4, 3, 2)
        y = spec.view(b, 1, c, nf, t) * m  # (B, S, C, F, T)
    with span("roformer.istft"):
        out = torch.istft(y.reshape(b * s * c, nf, t), cfg.n_fft, cfg.hop, cfg.win,
                          window=window, center=True, length=n)
    return out.view(b, s, c, n)


def run_chunks(w: Params, chunks: torch.Tensor, cfg: RoformerConfig) -> torch.Tensor:
    """(K, C, chunk) -> (K, stems, C, chunk), `cfg.batch` chunks at a time."""
    return torch.cat([net(w, chunks[i : i + cfg.batch].contiguous(), cfg)
                      for i in range(0, chunks.shape[0], cfg.batch)])


def border(n: int, cfg: RoformerConfig) -> int:
    """The reflect padding on each side of an n-sample track, where the
    output's crop starts."""
    b = cfg.chunk - cfg.step
    return b if n > 2 * b else 0


def num_chunks(n: int, cfg: RoformerConfig) -> int:
    length = n + 2 * border(n, cfg)
    return max(0, -(-(length - cfg.chunk) // cfg.step)) + 1


def cut_chunks(audio: torch.Tensor, cfg: RoformerConfig) -> torch.Tensor:
    """(C, n) -> (K, C, chunk) overlapping chunks (a view of the padded
    track)."""
    n = audio.shape[-1]
    pad = border(n, cfg)
    if pad:
        audio = F.pad(audio[None], (pad, pad), mode="reflect")[0]
    k = num_chunks(n, cfg)
    total = (k - 1) * cfg.step + cfg.chunk
    audio = F.pad(audio, (0, total - audio.shape[-1]))
    return audio.unfold(-1, cfg.chunk, cfg.step).transpose(0, 1)


def chunk_weights(k: int, cfg: RoformerConfig, device) -> torch.Tensor:
    """(K, chunk): 1 but for the linear fades, none before the first chunk
    or after the last."""
    fade = cfg.chunk // 10
    ramp = torch.linspace(0.0, 1.0, fade, device=device)
    w = torch.ones((k, cfg.chunk), device=device)
    w[1:, :fade] = ramp
    w[:-1, cfg.chunk - fade :] = ramp.flip(0)
    return w


def overlap_add(y: torch.Tensor, cfg: RoformerConfig) -> torch.Tensor:
    """(K, S, C, chunk) chunk outputs -> (S, C, (K - 1) * step + chunk): the
    weighted sum over the chunks at each sample, over the summed weights."""
    k, s, c, _ = y.shape
    o, step = cfg.num_overlap, cfg.step
    w = chunk_weights(k, cfg, y.device)
    parts = (y * w[:, None, None]).view(k, s, c, o, step)
    wparts = w.view(k, o, step)
    acc = y.new_zeros((k + o - 1, s, c, step))
    den = w.new_zeros((k + o - 1, step))
    for m in range(o):
        acc[m : m + k] += parts[:, :, :, m]
        den[m : m + k] += wparts[:, m]
    acc /= den[:, None, None]
    return acc.permute(1, 2, 0, 3).reshape(s, c, (k + o - 1) * step)


def separate_roformer(audio: torch.Tensor, params: Params,
                      cfg: RoformerConfig) -> torch.Tensor:
    """(C, n) float32 track on the device -> (stems, C, padded length): each
    masked stem over the padded track, from `border(n, cfg)` on the
    track's samples. `params` as `init_params` gives them, on the same
    device."""
    if audio.shape[0] != cfg.audio_channels:
        raise ValueError(f"{audio.shape[0]} channels; the model takes "
                         f"{cfg.audio_channels}")
    with span("model.roformer") as sp, torch.no_grad():
        w = pack(params, cfg)
        chunks = cut_chunks(audio, cfg)
        sp.note(chunks=chunks.shape[0], batch=cfg.batch,
                sdpa_backend="cudnn" if audio.is_cuda else "cpu")
        y = run_chunks(w, chunks, cfg)
        with span("roformer.overlap_add"):
            return overlap_add(y, cfg)
