#!/usr/bin/env python3
"""Smoke run of spleeterrt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. The card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels from csrc/ (nvcc, one process per source, first use).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (30 s stereo, bin_limit 1536, time_step 256, 4 stems),
   with the max error beside its bound and both times: K1 and K7 in
   float32; K2-K6 (the packed U-Net) in float32 and in bfloat16, each on
   the outputs of the plain chain before it, with the CLI's weights but
   random biases and batch norms (K6 held to a per-pixel bound).
3. The main path through the user's entry point: the CLI separates a 30 s
   synthetic WAV into 4 stems (VST config, bf16, random full-width
   weights); the launch counts must be K1, K2, K4, K5, K6, K7 once and K3
   three times, and a profile of the graph must show no library
   convolution beyond those of the plain-torch mid trunk.
4. Quality on the same weights: per-stem SNR of the CLI's stems (bf16,
   kernels) against the plain fp32 path with the canonical U-Net
   (>= 42 dB), and of the fp32 kernel path against it (>= 80 dB).
5. 4-stem separation time at 150 s and 300 s (CUDA events): realtime
   factor, marginal rate, peak device memory, a per-stage breakdown at
   300 s (K1, K2, K3 x3, mid trunk, K4, K5, K6, K7, each kernel beside its
   plain version, and the canonical cuDNN U-Net for comparison), and a
   profile of one 300 s separation (device busy time by kernel).

The last two lines before the final one are the kernel report and the
card's nvidia-smi line; the final line is the JSON status line. Without a
CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from spleeterrt_tpu_torch import cli, kernels
from spleeterrt_tpu_torch.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import model, separate, transform, weights
from spleeterrt_tpu_torch.io import audio as audio_io
from spleeterrt_tpu_torch.kernels import _build, encoder, stft_fused, tail
from spleeterrt_tpu_torch.utils.metrics import snr_db

SR = 44100
SEED = 0
SMOKE_SECONDS = 30.0
BIN_LIMIT, TIME_STEP = 1536, 256  # the VST config (bench.py:89-94)
BENCH_SECONDS = (150.0, 300.0)  # the marginal rate is their slope
SNR_BF16_MIN_DB = 42.0  # production bf16 vs plain fp32 (docs/PARITY.md band)
SNR_FP32_MIN_DB = 80.0  # fp32 kernels vs plain fp32: the kernels alone
# Kernel vs plain version: both are fp32 FFTs that round in another order;
# an indexing fault gives errors of order max|X|, rounding about 1e-7 of it.
K1_REL_BOUND = 1e-5  # of max|X|
K7_REL_BOUND = 1e-5  # of max(1, max|audio|)
# K2-K5 sum in float32 like their plain versions (TF32 off): in float32,
# 1e-5 of max|plain|; in bf16 the outputs round once, so a sum on the other
# side of a rounding boundary is one ulp off: 2 bf16 ulps of max|plain|.
# K6's masks are held pixel by pixel to tail.head_error_bound: the same
# error on each y6 the mask reads, carried through its up7 taps and the
# sigmoid's slope at that pixel.
UNET_F32_REL_BOUND = 1e-5
UNET_BF16_ULPS = 2
# The CLI's one 4-stem separation: every kernel of the path, K3 three times.
MAIN_PATH_LAUNCHES = {"stft4096": 1, "enc1": 1, "enc_s2": 3, "up4": 1,
                      "up5": 1, "head": 1, "masked_istft4096": 1}
# (kernel, source in csrc/, TPU kernel body it replaces in spleeterrt_tpu/kernels/)
KERNEL_TABLE = (
    ("stft4096", "stft.cu", "stft_fused.py:183"),
    ("enc1", "encoder.cu", "encoder.py:184"),
    ("enc_s2", "encoder.cu", "encoder.py:244"),
    ("up4", "tail.cu", "tail.py:220"),
    ("up5", "tail.cu", "tail.py:251"),
    ("head", "head.cu", "tail.py:378"),
    ("masked_istft4096", "istft.cu", "stft_fused.py:318"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def synthetic_audio(seconds: float, seed: int = SEED) -> np.ndarray:
    """(2, n) float32: a few tones per channel plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = np.zeros((2, t.size))
    for ch in range(2):
        for f0 in rng.uniform(60.0, 4000.0, 6):
            x[ch] += 0.08 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    x += 0.05 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def frame_counts(data_size: int, cfg) -> tuple[int, int, int]:
    """(n_out, n_comp, n_req) frames of the 4-stem graph for padded audio."""
    n_out = transform.num_output_frames(data_size, cfg.transform)
    n_comp = transform.num_computed_frames(data_size, cfg.transform)
    n_req = separate.num_tiles(n_out, cfg.time_step) * cfg.time_step
    return n_out, n_comp, n_req


def plain_separate(stacked, audio: np.ndarray, cfg, device) -> dict:
    """The 4-stem graph of separate.separate with no hand kernel: K1 and K7
    by their plain versions (torch.fft) and the canonical per-stem U-Net
    (cuDNN convolutions) in place of the packed one."""
    x = torch.as_tensor(audio, dtype=torch.float32, device=device)
    n = x.shape[-1]
    preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
    padded = transform.pad_offline(x, cfg.transform).contiguous()
    n_out, n_comp, n_req = frame_counts(padded.shape[-1], cfg)
    spec, mag = stft_fused.stft4096_plain(
        padded, transform.analysis_window(4096, device=device), n_comp, n_req,
        cfg.bin_limit, cfg.time_step,
    )
    masks = model.multi_stem_masks_canonical(
        stacked, mag, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
    )
    stems = stft_fused.masked_istft4096_plain(
        spec, masks,
        torch.tensor(separate.OUT_BAND_4, dtype=torch.float32, device=device),
        transform.synthesis_window(cfg.transform, device=device), n_out,
    )
    return dict(zip(cfg.stem_names, stems[..., preshift : preshift + n]))


def vst_config(compute_dtype):
    """The 4-stem VST config at BIN_LIMIT / TIME_STEP."""
    return SeparatorConfig(bin_limit=BIN_LIMIT, time_step=TIME_STEP,
                           num_stems=4, compute_dtype=compute_dtype)


def random_stacked(device):
    """The CLI's --random-weights params (seed SEED), on `device`."""
    gen = torch.Generator().manual_seed(SEED)
    ps = [model.init_params(gen) for _ in range(4)]
    return weights.params_to(weights.stack_params(ps), device)


def with_random_epilogues(stacked):
    """`stacked` with random biases and batch norms (seed SEED): the zero
    biases, unit scales and zero shifts of init_params would hide a kernel
    that misreads its epilogue table or drops the head's y6 domain mask."""
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for name, ly in stacked.items():
        draw = lambda base, scale: (base + scale * torch.randn(
            ly["b"].shape, generator=gen)).to(ly["b"].device)
        out[name] = {**ly, "b": draw(0.0, 0.1)}
        if "bn_scale" in ly:
            out[name].update(bn_scale=draw(1.0, 0.3), bn_shift=draw(0.0, 0.2))
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.3f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(cfg, device) -> dict[str, dict]:
    """Every kernel against its plain version at the 30 s main-path shapes;
    returns {counter name: report entry without its launch count}."""
    audio = torch.from_numpy(synthetic_audio(SMOKE_SECONDS)).to(device)
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    n_out, n_comp, n_req = frame_counts(padded.shape[-1], cfg)
    awin = transform.analysis_window(4096, device=device)
    swin = transform.synthesis_window(cfg.transform, device=device)
    k1_args = (padded, awin, n_comp, n_req, cfg.bin_limit, cfg.time_step)

    spec, mag = stft_fused.stft4096(*k1_args)
    pspec, pmag = stft_fused.stft4096_plain(*k1_args)
    torch.cuda.synchronize()
    scale = pspec.abs().max().item()
    k1_err = max((spec - pspec).abs().max().item(), (mag - pmag).abs().max().item())
    k1_bound = K1_REL_BOUND * scale
    log(f"[K1 stft4096] spec {tuple(spec.shape)} mag {tuple(mag.shape)}: "
        f"max |kernel - plain| = {k1_err:.3e}, bound {k1_bound:.3e}")
    if not k1_err <= k1_bound:
        raise AssertionError("K1 disagrees with its plain version")
    if not (torch.all(spec[:, n_comp:] == 0) and torch.all(
            mag.transpose(0, 1).reshape(2, n_req, -1)[:, n_comp:] == 0)):
        raise AssertionError("K1: frames past n_comp are not exact zeros")

    nt = n_req // cfg.time_step
    gen = torch.Generator(device=device).manual_seed(SEED)
    masks = torch.rand((4, nt, 2, cfg.time_step, cfg.bin_limit), generator=gen,
                       device=device)
    out_band = torch.tensor(separate.OUT_BAND_4, device=device)
    k7_args = (pspec, masks, out_band, swin, n_out)
    y = stft_fused.masked_istft4096(*k7_args)
    y2 = stft_fused.masked_istft4096(*k7_args)
    py = stft_fused.masked_istft4096_plain(*k7_args)
    torch.cuda.synchronize()
    k7_err = (y - py).abs().max().item()
    k7_bound = K7_REL_BOUND * max(1.0, py.abs().max().item())
    log(f"[K7 masked_istft4096] out {tuple(y.shape)}: max |kernel - plain| = "
        f"{k7_err:.3e}, bound {k7_bound:.3e}; two runs bit-identical: "
        f"{torch.equal(y, y2)}")
    if not k7_err <= k7_bound:
        raise AssertionError("K7 disagrees with its plain version")
    if not torch.equal(y, y2):
        raise AssertionError("K7 is not deterministic")

    report = {}
    for name, fn, plain, args, err in (
        ("stft4096", stft_fused.stft4096, stft_fused.stft4096_plain, k1_args,
         k1_err),
        ("masked_istft4096", stft_fused.masked_istft4096,
         stft_fused.masked_istft4096_plain, k7_args, k7_err),
    ):
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        log(f"[{name}] 30 s shapes: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    stacked = with_random_epilogues(random_stacked(device))
    for dtype in (torch.float32, torch.bfloat16):
        for label, name, fn, plain, args, kw in unet_calls(stacked, pmag, dtype)[0]:
            got, ref = fn(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err, bound, worst = unet_error(got, ref, dtype, name, args, kw)
            where = " (per pixel; at the largest error / bound)" * (name == "head")
            log(f"[{label} {name}] {str(dtype)[6:]}: max |kernel - plain| = "
                f"{err:.3e}, bound {bound:.3e}{where}; largest error / bound "
                f"{worst:.3e}")
            if not worst <= 1:
                raise AssertionError(f"{label} disagrees with its plain version")
            if dtype != cfg.compute_dtype:
                continue
            ms = cuda_ms(lambda: fn(*args, **kw))
            plain_ms = cuda_ms(lambda: plain(*args, **kw))
            log(f"[{label} {name}] 30 s shapes, {str(dtype)[6:]}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            entry = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                             "plain_ms": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["ms"] += ms  # K3: enc2 + enc3 + enc4, one path's worth
            entry["plain_ms"] += plain_ms
    return report


def unet_calls(stacked, mag, dtype) -> tuple[list[tuple], tuple]:
    """The packed U-Net's kernel calls at `mag`'s shapes in dataflow order,
    (label, counter, wrapper, plain, args, kwargs), each on the outputs of
    the plain chain before it, and the mid trunk's arguments."""
    def layer(name):
        ly = stacked[name]
        return ly["w"], ly["b"], ly["bn_scale"], ly["bn_shift"]

    calls = []
    kw = {"act": "elu", "dtype": dtype}
    args = (mag, *layer("down1"))
    calls.append(("K2 enc1", "enc1", encoder.enc1, encoder.enc1_plain, args, kw))
    skip, x = encoder.enc1_plain(*args, **kw)
    skips = [skip]
    kw = {"act": "elu"}
    for i in (2, 3, 4):
        args = (x, *layer(f"down{i}"))
        calls.append((f"K3 enc{i}", "enc_s2", encoder.enc_s2,
                      encoder.enc_s2_plain, args, kw))
        skip, x = encoder.enc_s2_plain(*args, **kw)
        skips.append(skip)
    trunk_args = (stacked, x, skips[3], STEM_MODE_4, dtype)
    x = model.mid_trunk(*trunk_args)
    for i in (4, 5):
        args = (skips[6 - i], x, *layer(f"up{i}"))
        calls.append((f"K{i} up{i}", f"up{i}", tail.up_shallow,
                      tail.up_shallow_plain, args, kw))
        x = tail.up_shallow_plain(*args, **kw)
    args = (skips[0], x, *layer("up6"), stacked["up7"]["w"], stacked["up7"]["b"])
    calls.append(("K6 head", "head", tail.head, tail.head_plain, args, kw))
    return calls, trunk_args


def unet_error(got, ref, dtype, name, args, kw) -> tuple[float, float, float]:
    """(max |kernel - plain|, its bound, the largest error / bound) over a
    wrapper's outputs; the head's bound is per pixel, and the one reported
    is that of the pixel with the largest error / bound."""
    if name == "head":
        diff = (got - ref).abs().flatten()
        bound = tail.head_error_bound(*args, **kw).flatten()
        i = (diff / bound).argmax()
        worst = (diff[i] / bound[i]).item()
        return diff.max().item(), bound[i].item(), worst
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.float().abs().max().item() for r in ref)
    if dtype == torch.float32:
        bound = UNET_F32_REL_BOUND * scale
    else:
        bound = UNET_BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
    return err, bound, err / bound


def library_conv_kernels(fn) -> collections.Counter:
    """Device kernels of fn() that are convolutions from a library (cuDNN,
    CUTLASS through cuDNN), by name and count; the port's own kernels
    (namespace spleeterrt) are not counted."""
    keys = ("conv", "cudnn", "dgrad", "wgrad", "implicit", "xmma", "gemm")
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "spleeterrt" not in e.name
        and any(k in e.name.lower() for k in keys)
    )


def phase_main_path(workdir: str, device) -> tuple[dict, dict]:
    """The CLI at the VST config on a 30 s WAV; returns (stems, launches)."""
    x = synthetic_audio(SMOKE_SECONDS)
    song = os.path.join(workdir, "smoke.wav")
    audio_io.write_wav(song, x)
    out_dir = os.path.join(workdir, "stems")
    kernels.reset_launch_counts()
    rc = cli.main([song, "--stems", "4", "--time-step", str(TIME_STEP),
                   "--bin-limit", str(BIN_LIMIT), "--random-weights",
                   "--seed", str(SEED), "--output-dir", out_dir,
                   "--device", str(device)])
    launches = kernels.launch_counts()
    log(f"[main path] cli rc {rc}, launches {launches}")
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    if launches != MAIN_PATH_LAUNCHES:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{MAIN_PATH_LAUNCHES}")
    stems = {}
    for stem, fname in (("drums", "Drum"), ("bass", "Bass"),
                        ("accompaniment", "Accompaniment"), ("vocals", "Vocal")):
        y = audio_io.read_wav(os.path.join(out_dir, f"smoke_{fname}.wav"))
        if y.samples.shape != x.shape or not np.all(np.isfinite(y.samples)):
            raise AssertionError(f"{fname}: shape {y.samples.shape} or non-finite")
        stems[stem] = y.samples
    log(f"[main path] 4 finite stems of shape {x.shape} written")

    # Library convolutions of the graph are the mid trunk's and no more.
    cfg = vst_config(torch.bfloat16)
    stacked = random_stacked(device)
    padded = transform.pad_offline(
        torch.from_numpy(x).to(device), cfg.transform).contiguous()
    graph = library_conv_kernels(
        lambda: separate.separate_4stem(stacked, padded, cfg))
    _, _, n_req = frame_counts(padded.shape[-1], cfg)
    n_img = 4 * (n_req // TIME_STEP)
    t16, f16 = TIME_STEP // 16, BIN_LIMIT // 16
    act4 = torch.zeros((n_img, t16, f16, 128), dtype=torch.bfloat16, device=device)
    trunk = library_conv_kernels(
        lambda: model.mid_trunk(stacked, act4, act4, STEM_MODE_4, torch.bfloat16))
    log(f"[main path] library convolution launches: graph "
        f"{sum(graph.values())}, mid trunk alone {sum(trunk.values())}")
    if not trunk or graph != trunk:
        raise AssertionError(f"library convolutions outside the mid trunk: "
                             f"graph {dict(graph)}, mid trunk {dict(trunk)}")
    return stems, launches


def phase_quality(cli_stems: dict, device) -> None:
    """Per-stem SNR of the CLI's stems and of the fp32 kernel path against
    the fp32 plain path, on the CLI's weights."""
    x = synthetic_audio(SMOKE_SECONDS)
    stacked = random_stacked(device)
    cfg32 = vst_config(torch.float32)
    plain = {k: v.cpu().numpy() for k, v in
             plain_separate(stacked, x, cfg32, device).items()}
    kern = {k: v.cpu().numpy() for k, v in separate.separate(
        x, stacked_params=stacked, cfg=cfg32, device=device).items()}
    for stem in plain:
        bf16 = snr_db(cli_stems[stem], plain[stem])
        fp32 = snr_db(kern[stem], plain[stem])
        log(f"[quality] {stem}: bf16 kernels vs fp32 plain {bf16:.2f} dB "
            f"(>= {SNR_BF16_MIN_DB}), fp32 kernels vs fp32 plain {fp32:.2f} dB "
            f"(>= {SNR_FP32_MIN_DB})")
        if not (bf16 >= SNR_BF16_MIN_DB and fp32 >= SNR_FP32_MIN_DB):
            raise AssertionError(f"{stem}: SNR below its bound")


def phase_timing(device) -> None:
    """separate_4stem on pre-padded device audio at 150 s and 300 s, as
    bench.py times the reference package, plus a stage breakdown and a
    profile at 300 s."""
    cfg = vst_config(torch.bfloat16)
    stacked = random_stacked(device)
    inputs = {}
    for seconds in BENCH_SECONDS:
        rng = np.random.default_rng(SEED)
        audio = torch.as_tensor(
            rng.standard_normal((2, int(seconds * SR))) * 0.3,
            dtype=torch.float32, device=device)
        inputs[seconds] = transform.pad_offline(audio, cfg.transform).contiguous()
        separate.separate_4stem(stacked, inputs[seconds], cfg)  # warm up
    # The sizes take turns, so clocks and caches treat both alike; the
    # best of three rounds of three runs is kept for each.
    times = {s: float("inf") for s in BENCH_SECONDS}
    for _ in range(3):
        for seconds, padded in inputs.items():
            ms = cuda_ms(lambda: separate.separate_4stem(stacked, padded, cfg),
                         iters=3, warmup=0)
            times[seconds] = min(times[seconds], ms)
    for seconds, ms in times.items():
        log(f"[timing] {seconds:.0f} s: {ms:.3f} ms per separate_4stem, "
            f"{seconds / (ms / 1e3):.2f}x realtime")
    padded = inputs.pop(BENCH_SECONDS[-1])
    inputs.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    separate.separate_4stem(stacked, padded, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)  # weights + input included

    # Stage breakdown at the longest input, each kernel beside its plain
    # version on the same inputs.
    n_out, n_comp, n_req = frame_counts(padded.shape[-1], cfg)
    awin = transform.analysis_window(4096, device=device)
    swin = transform.synthesis_window(cfg.transform, device=device)
    k1_args = (padded, awin, n_comp, n_req, cfg.bin_limit, cfg.time_step)
    spec, mag = stft_fused.stft4096(*k1_args)
    masks = model.multi_stem_masks(stacked, mag, STEM_MODE_4,
                                   cfg.compute_dtype, cfg.sigmoid)
    ob = torch.tensor(separate.OUT_BAND_4, device=device)
    k7_args = (spec, masks, ob, swin, n_out)
    stages = {
        "K1 stft4096": cuda_ms(lambda: stft_fused.stft4096(*k1_args), 10),
        "K1 plain": cuda_ms(lambda: stft_fused.stft4096_plain(*k1_args), 10),
    }
    calls, trunk_args = unet_calls(stacked, mag, cfg.compute_dtype)
    for i, (label, _, fn, plain, args, kw) in enumerate(calls):
        if i == 4:  # between enc4 and up4, in dataflow order
            stages["mid trunk (cuDNN, 4 stems)"] = cuda_ms(
                lambda: model.mid_trunk(*trunk_args), 5, 1)
        stages[label] = cuda_ms(lambda: fn(*args, **kw), 5, 1)
        stages[f"{label} plain"] = cuda_ms(lambda: plain(*args, **kw), 3, 1)
    del calls, trunk_args
    stages["K7 masked_istft4096"] = cuda_ms(
        lambda: stft_fused.masked_istft4096(*k7_args), 10)
    stages["K7 plain"] = cuda_ms(
        lambda: stft_fused.masked_istft4096_plain(*k7_args), 10)
    stages["U-Net x4 stems, packed (K2-K6 + mid trunk)"] = cuda_ms(
        lambda: model.multi_stem_masks(stacked, mag, STEM_MODE_4,
                                       cfg.compute_dtype, cfg.sigmoid), 5, 1)
    stages["U-Net x4 stems, canonical (cuDNN, per stem)"] = cuda_ms(
        lambda: model.multi_stem_masks_canonical(
            stacked, mag, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid), 5, 1)
    for name, ms in stages.items():
        log(f"[timing] {BENCH_SECONDS[-1]:.0f} s stage {name}: {ms:.3f} ms")
    small, big = BENCH_SECONDS
    rtf = big / (times[big] / 1e3)
    marginal = (big - small) / ((times[big] - times[small]) / 1e3)
    log(f"[timing] realtime factor {rtf:.2f}x at {big:.0f} s, marginal "
        f"{marginal:.2f}x, peak memory {peak / 2**30:.3f} GiB")
    profile_separation(stacked, padded, cfg)


def profile_separation(stacked, padded, cfg) -> None:
    """Device time by kernel over one separation, and the idle share."""
    separate.separate_4stem(stacked, padded, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        t0 = time.perf_counter()
        separate.separate_4stem(stacked, padded, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:90]] += e.device_time_total / 1e3
    busy = sum(by_name.values())
    log(f"[profile] one separation: kernel time {busy:.3f} ms in {wall_ms:.3f} "
        f"ms wall, idle share {100 * max(0.0, 1 - busy / wall_ms):.1f}%")
    for name, ms in by_name.most_common(14):
        log(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  {name}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons stay
    torch.backends.cudnn.allow_tf32 = False  # fp32; convs default to TF32
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    cfg = vst_config(torch.bfloat16)
    measured = phase_kernels(cfg, device)
    with tempfile.TemporaryDirectory() as workdir:
        cli_stems, launches = phase_main_path(workdir, device)
    phase_quality(cli_stems, device)
    phase_timing(device)
    report = [
        {"name": name, "route": "cuda",
         "source": f"spleeterrt_tpu_torch/csrc/{src}",
         "replaces": f"spleeterrt_tpu/kernels/{tpu}",
         "launches": launches[name], **measured[name]}
        for name, src, tpu in KERNEL_TABLE
    ]
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
