#!/usr/bin/env python3
"""Smoke run of spleeterrt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. The card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels from csrc/ (nvcc, one process per source, first use).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the path that runs it, with the max error beside its bound
   and both times: K1 and K7 in float32 at the 30 s offline shapes
   (bin_limit 1536, time_step 256, 4 stems); K2-K6 (the packed U-Net) in
   float32 and in bfloat16, each on the outputs of the plain chain before
   it, with the CLI's weights but random biases and batch norms (K6 held
   to a per-pixel bound); K8 on the masked spectrum of one streaming block
   of 4 streams and K9 at the 30 s overlap-2 shapes, both in float32 and
   each run twice (bit-identical).
3. The main path through the user's entry point: the CLI separates a 30 s
   synthetic WAV into 4 stems (VST config, bf16, random full-width
   weights); the launch counts must be K1, K2, K4, K5, K6, K7 once and K3
   three times, and a profile of the graph must show no library
   convolution beyond those of the plain-torch mid trunk.
4. Quality on the same weights: per-stem SNR of the CLI's stems (bf16,
   kernels) against the plain fp32 path with the canonical U-Net
   (>= 42 dB), and of the fp32 kernel path against it (>= 80 dB).
5. The streaming path through its entry point: the streaming CLI on the
   30 s WAV (VST config, bf16, --split); four finite stems as long as the
   input, silent for the engine's first two blocks plus one hop; launch
   counts of exactly one block step's set (K1, K2, K3 x3, K4, K5, K6, K8)
   per block step; a profile of one block step shows no library
   convolution beyond the mid trunk's and no library FFT.
6. Streaming quality: stream_scan over 4 blocks of the smoke audio, bf16
   and fp32 on the card, against the same scan in fp32 on CPU tensors
   (every kernel's plain version): per-stem SNR >= 42 dB / >= 80 dB.
7. The overlap-2 graph (TransformConfig(overlap=2), hop 2048):
   separate.separate on the 30 s audio launches K2-K6 and K9 and no K1 or
   K7; fp32 kernels against the plain fp32 graph >= 80 dB per stem.
8. 4-stem separation time at 150 s and 300 s (CUDA events): realtime
   factor, marginal rate, peak device memory, a per-stage breakdown at
   300 s (K1, K2, K3 x3, mid trunk, K4, K5, K6, K7, each kernel beside its
   plain version, and the canonical cuDNN U-Net for comparison), and a
   profile of one 300 s separation (device busy time by kernel).
9. Streams on one card: block_step_streams (VST config, bf16) for K = 1,
   4, 16 and 64 streams, carrying the state: ms per block, the aggregate
   realtime factor, peak memory, the largest K inside the 5.944 s block
   deadline, a stage breakdown at K = 16 and a profile at K = 1 and 16.

The last three lines are the kernel report (all nine kernels, each with
its launches on the path that runs it), the card's nvidia-smi line and
the JSON status line. Without a CUDA device the script exits non-zero and
prints no result.
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

from spleeterrt_tpu_torch import cli, cli_stream, kernels
from spleeterrt_tpu_torch.config import (
    STEM_MODE_4,
    STEMS_4,
    SeparatorConfig,
    TransformConfig,
)
from spleeterrt_tpu_torch.core import model, separate, transform, weights
from spleeterrt_tpu_torch.io import audio as audio_io
from spleeterrt_tpu_torch.kernels import (
    _build,
    encoder,
    pallas_fft,
    stft_fused,
    tail,
)
from spleeterrt_tpu_torch.runtime import stream
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
K7_REL_BOUND = 1e-5  # of max(1, max|audio|); K8 and K9 too
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
# One streaming block step: analysis (K1), the U-Net, synthesis (K8).
STREAM_BLOCK_LAUNCHES = {"stft4096": 1, "enc1": 1, "enc_s2": 3, "up4": 1,
                         "up5": 1, "head": 1, "irfft4096": 1}
# The overlap-2 graph: plain STFT, the U-Net, K9, plain overlap-add.
OVERLAP2_LAUNCHES = {"enc1": 1, "enc_s2": 3, "up4": 1, "up5": 1, "head": 1,
                     "masked_irfft4096": 1}
STREAM_QUALITY_BLOCKS = 4  # 23.8 s of the smoke audio
STREAM_COUNTS = (1, 4, 16, 64)  # concurrent streams timed on one card
BLOCK_LEN = TIME_STEP * 1024  # samples in one streaming block
BLOCK_SECONDS = BLOCK_LEN / SR  # 5.944 s: a block step's deadline
# (kernel, source in csrc/, TPU kernel body it replaces in spleeterrt_tpu/kernels/)
KERNEL_TABLE = (
    ("stft4096", "stft.cu", "stft_fused.py:183"),
    ("enc1", "encoder.cu", "encoder.py:184"),
    ("enc_s2", "encoder.cu", "encoder.py:244"),
    ("up4", "tail.cu", "tail.py:220"),
    ("up5", "tail.cu", "tail.py:251"),
    ("head", "head.cu", "tail.py:378"),
    ("masked_istft4096", "istft.cu", "stft_fused.py:318"),
    ("irfft4096", "irfft.cu", "pallas_fft.py:72"),
    ("masked_irfft4096", "irfft.cu", "pallas_fft.py:186"),
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
    """The 4-stem graph of separate.separate with no hand kernel: the
    canonical per-stem U-Net (cuDNN convolutions) in place of the packed
    one and, at hop 1024, K1 and K7 by their plain versions (torch.fft);
    at any other hop the plain STFT, K9's plain version and the plain
    overlap-add."""
    x = torch.as_tensor(audio, dtype=torch.float32, device=device)
    n = x.shape[-1]
    tcfg = cfg.transform
    preshift, _ = transform.offline_pad_sizes(n, tcfg)
    padded = transform.pad_offline(x, tcfg).contiguous()
    ob = torch.tensor(separate.OUT_BAND_4, dtype=torch.float32, device=device)
    swin = transform.synthesis_window(tcfg, device=device)
    if tcfg.hop == stft_fused.HOP:
        n_out, n_comp, n_req = frame_counts(padded.shape[-1], cfg)
        spec, mag = stft_fused.stft4096_plain(
            padded, transform.analysis_window(4096, device=device), n_comp,
            n_req, cfg.bin_limit, cfg.time_step,
        )
        masks = model.multi_stem_masks_canonical(
            stacked, mag, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
        )
        stems = stft_fused.masked_istft4096_plain(spec, masks, ob, swin, n_out)
    else:
        spec = transform.stft(padded, tcfg, padded.shape[-1])
        n_frames = spec.shape[-2]
        tiles = separate.spec_to_tiles(spec, cfg).permute(0, 3, 1, 2).contiguous()
        masks = model.multi_stem_masks_canonical(
            stacked, tiles, STEM_MODE_4, cfg.compute_dtype, cfg.sigmoid
        )  # (S, n_tiles, 2, T, F)
        masks = masks.transpose(1, 2).flatten(2, 3)[:, :, :n_frames].contiguous()
        frames = pallas_fft.masked_irfft4096_plain(spec, masks, ob,
                                                   cfg.bin_limit, swin)
        stems = transform.overlap_add(frames, tcfg)
    return dict(zip(cfg.stem_names, stems[..., preshift : preshift + n]))


def vst_config(compute_dtype, overlap: int = 4):
    """The 4-stem VST config at BIN_LIMIT / TIME_STEP."""
    return SeparatorConfig(transform=TransformConfig(overlap=overlap),
                           bin_limit=BIN_LIMIT, time_step=TIME_STEP,
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
    k7_err = check_inverse("K7 masked_istft4096", stft_fused.masked_istft4096,
                           stft_fused.masked_istft4096_plain, k7_args)
    k8_args = (stream_block_spectrum(audio), None)
    k8_err = check_inverse("K8 irfft4096", pallas_fft.irfft4096,
                           pallas_fft.irfft4096_plain, k8_args)
    k9_args = overlap2_k9_args(audio, device)
    k9_err = check_inverse("K9 masked_irfft4096", pallas_fft.masked_irfft4096,
                           pallas_fft.masked_irfft4096_plain, k9_args)

    report = {}
    for name, shapes, fn, plain, args, err in (
        ("stft4096", "30 s", stft_fused.stft4096, stft_fused.stft4096_plain,
         k1_args, k1_err),
        ("masked_istft4096", "30 s", stft_fused.masked_istft4096,
         stft_fused.masked_istft4096_plain, k7_args, k7_err),
        ("irfft4096", "4-stream block", pallas_fft.irfft4096,
         pallas_fft.irfft4096_plain, k8_args, k8_err),
        ("masked_irfft4096", "30 s overlap-2", pallas_fft.masked_irfft4096,
         pallas_fft.masked_irfft4096_plain, k9_args, k9_err),
    ):
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        log(f"[{name}] {shapes} shapes: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    del k8_args, k9_args

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


def check_inverse(label: str, fn, plain, args) -> float:
    """An inverse-FFT kernel against its plain version, run twice; returns
    the max error, held to K7_REL_BOUND of max(1, max|plain|)."""
    y = fn(*args)
    y2 = fn(*args)
    py = plain(*args)
    torch.cuda.synchronize()
    err = (y - py).abs().max().item()
    bound = K7_REL_BOUND * max(1.0, py.abs().max().item())
    log(f"[{label}] out {tuple(y.shape)}: max |kernel - plain| = "
        f"{err:.3e}, bound {bound:.3e}; two runs bit-identical: "
        f"{torch.equal(y, y2)}")
    if not err <= bound:
        raise AssertionError(f"{label} disagrees with its plain version")
    if not torch.equal(y, y2):
        raise AssertionError(f"{label} is not deterministic")
    return err


def stream_block_spectrum(audio: torch.Tensor, k: int = 4) -> torch.Tensor:
    """K8's input in one streaming block of k streams: the masked (k, 4, 2,
    T, 2049) spectrum of k consecutive blocks of `audio` (the analysis
    window's hop-1024 frames), under random masks (seed SEED) below
    BIN_LIMIT and the engine's out-of-band weights above it."""
    device = audio.device
    ext = torch.stack([audio[:, i * BLOCK_LEN : (i + 1) * BLOCK_LEN + 3072]
                       for i in range(k)])
    wa, _ = stream.window_tensors(1.0, device)
    spec, _ = stft_fused.stft4096_plain(
        ext.reshape(2 * k, -1), wa, TIME_STEP, TIME_STEP, BIN_LIMIT, TIME_STEP)
    gen = torch.Generator(device=device).manual_seed(SEED)
    masks = torch.rand((4, k, 2, TIME_STEP, BIN_LIMIT), generator=gen,
                       device=device)
    return stream.masked_spectrum(
        spec.view(k, 2, TIME_STEP, -1), masks,
        torch.tensor(stream.RT_OUT_BAND, device=device)).contiguous()


def overlap2_k9_args(audio: torch.Tensor, device) -> tuple:
    """K9's arguments on the 30 s overlap-2 graph: the plain STFT of the
    padded audio, random masks (seed SEED), OUT_BAND_4 and the synthesis
    window."""
    tcfg = TransformConfig(overlap=2)
    padded = transform.pad_offline(audio, tcfg).contiguous()
    spec = transform.stft(padded, tcfg, padded.shape[-1])
    gen = torch.Generator(device=device).manual_seed(SEED)
    masks = torch.rand((4, *spec.shape[:-1], BIN_LIMIT), generator=gen,
                       device=device)
    return (spec, masks, torch.tensor(separate.OUT_BAND_4, device=device),
            BIN_LIMIT, transform.synthesis_window(tcfg, device=device))


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


CONV_KEYS = ("conv", "cudnn", "dgrad", "wgrad", "implicit", "xmma", "gemm")


def library_conv_kernels(fn, keys=CONV_KEYS) -> collections.Counter:
    """Device kernels of fn() that are convolutions from a library (cuDNN,
    CUTLASS through cuDNN), or whose names hold one of `keys`, by name and
    count; the port's own kernels (namespace spleeterrt) are not counted."""
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
    if launches != expected_launches(MAIN_PATH_LAUNCHES):
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
    profile_device("one separation",
                   lambda: separate.separate_4stem(stacked, padded, cfg))


def profile_device(label: str, fn) -> None:
    """Device time by kernel over one fn() after one warm-up call, against
    its wall time (synchronised), and the idle share."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:90]] += e.device_time_total / 1e3
    busy = sum(by_name.values())
    log(f"[profile] {label}: kernel time {busy:.3f} ms in {wall_ms:.3f} "
        f"ms wall, idle share {100 * max(0.0, 1 - busy / wall_ms):.1f}%")
    for name, ms in by_name.most_common(14):
        log(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  {name}")


# ---------------------------------------------------------------------------
# The streaming path and the overlap-2 graph
# ---------------------------------------------------------------------------


def expected_launches(per_run: dict, runs: int = 1) -> dict:
    return {name: runs * per_run.get(name, 0) for name in kernels.KERNELS}


def phase_stream_cli(workdir: str, device) -> dict:
    """The streaming CLI at the VST config on the 30 s WAV; returns the
    launch counts of its run."""
    x = synthetic_audio(SMOKE_SECONDS)
    song = os.path.join(workdir, "stream.wav")
    audio_io.write_wav(song, x)
    out_dir = os.path.join(workdir, "stream_stems")
    kernels.reset_launch_counts()
    rc = cli_stream.main([song, "--time-step", str(TIME_STEP), "--bin-limit",
                          str(BIN_LIMIT), "--random-weights", "--split",
                          "--output", out_dir, "--device", str(device)])
    launches = kernels.launch_counts()
    # The push API plays one block of silence while the first input block
    # fills; each later block of output is one block step.
    n_steps = -(-x.shape[1] // BLOCK_LEN) - 1
    log(f"[stream cli] rc {rc}, {n_steps} block steps, launches {launches}")
    if rc != 0:
        raise AssertionError(f"streaming CLI returned {rc}")
    if launches != expected_launches(STREAM_BLOCK_LAUNCHES, n_steps):
        raise AssertionError(f"streaming launches {launches}, expected "
                             f"{n_steps} x {STREAM_BLOCK_LAUNCHES}")
    silent = (2 * TIME_STEP + 1) * 1024  # the engine's latency
    for stem in STEMS_4:
        y = audio_io.read_wav(os.path.join(out_dir, f"{stem}.wav")).samples
        if y.shape != x.shape or not np.all(np.isfinite(y)):
            raise AssertionError(f"{stem}: shape {y.shape} or non-finite")
        if np.any(y[:, :silent] != 0) or not np.any(y[:, silent:] != 0):
            raise AssertionError(f"{stem}: not silent for exactly the first "
                                 f"{silent} samples")
    log(f"[stream cli] 4 finite stems of shape {x.shape}, the first {silent} "
        f"samples silent")

    # Library convolutions of one block step are the mid trunk's, and no
    # FFT comes from a library.
    cfg = vst_config(torch.bfloat16)
    stacked = random_stacked(device)
    state = stream.init_state_streams(cfg, 4, 1, device)
    block = torch.from_numpy(x[None, :, :BLOCK_LEN]).to(device)
    step = lambda: stream.block_step_streams(stacked, state, block, cfg)
    convs = library_conv_kernels(step)
    ffts = library_conv_kernels(step, keys=("fft",))
    t16, f16 = TIME_STEP // 16, BIN_LIMIT // 16
    act4 = torch.zeros((4, t16, f16, 128), dtype=torch.bfloat16, device=device)
    trunk = library_conv_kernels(
        lambda: model.mid_trunk(stacked, act4, act4, STEM_MODE_4, torch.bfloat16))
    log(f"[stream cli] one block step: library convolution launches "
        f"{sum(convs.values())}, mid trunk alone {sum(trunk.values())}, "
        f"library FFT launches {sum(ffts.values())}")
    if not trunk or convs != trunk or ffts:
        raise AssertionError(f"library kernels outside the mid trunk: "
                             f"{dict(convs)} vs {dict(trunk)}, FFT {dict(ffts)}")
    return launches


def phase_stream_quality(device) -> None:
    """stream_scan over STREAM_QUALITY_BLOCKS blocks, bf16 and fp32 on the
    card, against fp32 on CPU tensors (every kernel's plain version)."""
    x = torch.from_numpy(
        synthetic_audio(SMOKE_SECONDS)[:, : STREAM_QUALITY_BLOCKS * BLOCK_LEN])
    cfg32 = vst_config(torch.float32)
    t0 = time.perf_counter()
    plain = stream.stream_scan(random_stacked("cpu"), x, cfg32).numpy()
    cpu_s = time.perf_counter() - t0
    stacked = random_stacked(device)
    runs = {
        "bf16": stream.stream_scan(stacked, x.to(device), vst_config(torch.bfloat16)),
        "fp32": stream.stream_scan(stacked, x.to(device), cfg32),
    }
    runs = {k: v.cpu().numpy() for k, v in runs.items()}
    log(f"[stream quality] {x.shape[1] / SR:.1f} s in {STREAM_QUALITY_BLOCKS} "
        f"blocks; the plain fp32 scan on the CPU took {cpu_s:.3f} s")
    sound = slice(2 * BLOCK_LEN, None)  # the first two blocks are silence
    for s, stem in enumerate(STEMS_4):
        bf16 = snr_db(runs["bf16"][s, :, sound], plain[s, :, sound])
        fp32 = snr_db(runs["fp32"][s, :, sound], plain[s, :, sound])
        log(f"[stream quality] {stem}: bf16 kernels vs fp32 plain {bf16:.2f} "
            f"dB (>= {SNR_BF16_MIN_DB}), fp32 kernels vs fp32 plain "
            f"{fp32:.2f} dB (>= {SNR_FP32_MIN_DB})")
        if not (bf16 >= SNR_BF16_MIN_DB and fp32 >= SNR_FP32_MIN_DB):
            raise AssertionError(f"streaming {stem}: SNR below its bound")


def phase_overlap2(device) -> dict:
    """separate.separate with TransformConfig(overlap=2) on the 30 s audio:
    launch counts (bf16, the VST config) and fp32 quality against the plain
    graph; returns the launch counts."""
    x = synthetic_audio(SMOKE_SECONDS)
    stacked = random_stacked(device)
    kernels.reset_launch_counts()
    stems = separate.separate(x, stacked_params=stacked,
                              cfg=vst_config(torch.bfloat16, overlap=2),
                              device=device)
    launches = kernels.launch_counts()
    log(f"[overlap 2] launches {launches}")
    if launches != expected_launches(OVERLAP2_LAUNCHES):
        raise AssertionError(f"overlap-2 launches {launches}, expected "
                             f"{OVERLAP2_LAUNCHES}")
    for stem, y in stems.items():
        if tuple(y.shape) != x.shape or not torch.all(torch.isfinite(y)):
            raise AssertionError(f"overlap 2, {stem}: shape or non-finite")
    cfg32 = vst_config(torch.float32, overlap=2)
    kern = separate.separate(x, stacked_params=stacked, cfg=cfg32, device=device)
    plain = plain_separate(stacked, x, cfg32, device)
    for stem in plain:
        fp32 = snr_db(kern[stem].cpu().numpy(), plain[stem].cpu().numpy())
        log(f"[overlap 2] {stem}: fp32 kernels vs fp32 plain {fp32:.2f} dB "
            f"(>= {SNR_FP32_MIN_DB})")
        if not fp32 >= SNR_FP32_MIN_DB:
            raise AssertionError(f"overlap 2, {stem}: SNR below its bound")
    return launches


def phase_stream_timing(device) -> None:
    """block_step_streams at the VST config in bf16 for each of
    STREAM_COUNTS, carrying the state as a serving loop does; a stage
    breakdown at K = 16 and a profile at K = 1 and 16."""
    cfg = vst_config(torch.bfloat16)
    stacked = random_stacked(device)
    rng = np.random.default_rng(SEED)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fits = []
    for k in STREAM_COUNTS:
        block = torch.as_tensor(rng.standard_normal((k, 2, BLOCK_LEN)) * 0.3,
                                dtype=torch.float32, device=device)
        state = stream.init_state_streams(cfg, 4, k, device)
        for _ in range(3):  # warm up; the third step has real spectra
            state, out = stream.block_step_streams(stacked, state, block, cfg)
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        best = float("inf")
        for _ in range(5):
            start.record()
            state, out = stream.block_step_streams(stacked, state, block, cfg)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
            del out
        peak = torch.cuda.max_memory_allocated(device)
        if best / 1e3 <= BLOCK_SECONDS:
            fits.append(k)
        log(f"[streams] K = {k}: {best:.3f} ms per block step, aggregate "
            f"{k * BLOCK_SECONDS / (best / 1e3):.2f}x realtime, peak memory "
            f"{peak / 2**30:.3f} GiB")
        if k == 16:
            stream_stages(stacked, state, block, cfg)
        if k in (1, 16):
            profile_device(f"one block step, K = {k}", lambda: (
                stream.block_step_streams(stacked, state, block, cfg)))
        del state, block
        torch.cuda.empty_cache()
    log(f"[streams] largest measured K inside the {BLOCK_SECONDS:.3f} s block "
        f"deadline: {max(fits, default=0)}")


def stream_stages(stacked, state, block, cfg) -> None:
    """One block step's stages timed alone at the given state, each kernel
    beside its plain version."""
    k = block.shape[0]
    dev = block.device
    wa, ws = stream.window_tensors(1.0, dev)
    uw = torch.tensor(stream.RT_OUT_BAND, device=dev)
    ext = torch.cat([state.in_tail, block], dim=-1).reshape(2 * k, -1)
    k1_args = (ext, wa, TIME_STEP, TIME_STEP, BIN_LIMIT, TIME_STEP)
    masked = stream.masked_spectrum(state.spec2, state.masks2, uw)
    frames = pallas_fft.irfft4096(masked)
    stages = {
        "K1 stft4096": cuda_ms(lambda: stft_fused.stft4096(*k1_args), 10),
        "K1 plain": cuda_ms(lambda: stft_fused.stft4096_plain(*k1_args), 10),
        "U-Net x4 stems, packed (K2-K6 + mid trunk)": cuda_ms(
            lambda: model.multi_stem_masks(stacked, state.mag1, STEM_MODE_4,
                                           cfg.compute_dtype, cfg.sigmoid), 5, 1),
        "mask multiply (torch)": cuda_ms(
            lambda: stream.masked_spectrum(state.spec2, state.masks2, uw), 10),
        "K8 irfft4096": cuda_ms(lambda: pallas_fft.irfft4096(masked), 10),
        "K8 plain": cuda_ms(lambda: pallas_fft.irfft4096_plain(masked), 5, 1),
        "tails + overlap-add (torch)": cuda_ms(
            lambda: stream.synthesize(frames, state.ola_tail, ws), 10),
        "block step": cuda_ms(
            lambda: stream.block_step_streams(stacked, state, block, cfg), 5, 1),
    }
    for name, ms in stages.items():
        log(f"[streams] K = {k} stage {name}: {ms:.3f} ms")
    del masked, frames


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
        stream_launches = phase_stream_cli(workdir, device)
    phase_quality(cli_stems, device)
    phase_stream_quality(device)
    overlap2_launches = phase_overlap2(device)
    phase_timing(device)
    phase_stream_timing(device)
    # Each kernel's launches on the path that runs it: the offline CLI for
    # K1-K7, the streaming CLI for K8, the overlap-2 graph for K9.
    launches.update(irfft4096=stream_launches["irfft4096"],
                    masked_irfft4096=overlap2_launches["masked_irfft4096"])
    report = [
        {"name": name, "route": "cuda",
         "source": f"spleeterrt_tpu_torch/csrc/{src}",
         "replaces": f"spleeterrt_tpu/kernels/{tpu}",
         "launches": launches[name], **measured[name]}
        for name, src, tpu in KERNEL_TABLE
    ]
    if not all(entry["launches"] > 0 for entry in report):
        raise AssertionError(f"a kernel was not launched on its path: {report}")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
