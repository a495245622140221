#!/usr/bin/env python3
"""Smoke run of spleeterrt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. The card's name and power limit (nvidia-smi), and the build of the CUDA
   kernels from csrc/ (nvcc, one process per source, first use).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes of the path that runs it, with the max error beside its bound
   and both times: K1 and K7 in float32 at the 30 s offline shapes
   (bin_limit 1536, time_step 256, 4 stems; each run twice,
   bit-identical); K2-K6 (the packed U-Net) in float32 and in bfloat16,
   each on the outputs of the plain chain before it, with the CLI's
   weights but random biases and batch norms (K6 held to a per-pixel
   bound; K2-K6 also run twice, bit-identical, and each K2, K3, K4 and K5
   layer timed beside its bound, the fp32 FMA floor and cuDNN's bf16
   convolution (K2, K3) or transposed convolution (K4, K5) alone, a
   convolution-only yardstick; K2, K4 and K5 also with the tensor-core
   template's registers, shared memory and occupancy); K8 on the masked
   spectrum of one streaming block of 4 streams and K9 at the 30 s
   overlap-2 shapes, both in float32 and each run twice (bit-identical).
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
   plain version, K1 beside its bound and torch.fft.rfft of the windowed
   frames alone (an FFT-only yardstick), each K2, K3, K4 and K5 layer
   beside its bound, the fp32 FMA floor and cuDNN's (transposed)
   convolution alone, K6 beside its bound and fp32 FMA floor, K7 beside
   its bound and torch.fft.irfft over the pre-masked spectrum alone, K1,
   K2 and K4-K7 with their templates' registers, shared memory and
   occupancy, and the canonical cuDNN U-Net), and a profile of one 300 s
   separation (device busy time by kernel; bf16 enc1 must run
   enc1_mma_kernel and no FMA encoder kernel).
9. Streams on one card: block_step_streams (VST config, bf16) for K = 1,
   4, 16 and 64 streams, carrying the state: ms per block, the aggregate
   realtime factor, peak memory, the largest K inside the 5.944 s block
   deadline, a stage breakdown at K = 16 (with torch.fft.irfft beside K8's
   stage) and a profile at K = 1 and 16.
10. 2, 3 and 5 stems through the CLI on the 30 s WAV (bf16): 2 stems at the
   CLI's defaults (the reference exe's config: bin_limit 1024, time_step
   512) with random weights, 3 stems from a quantized two-subnet file the
   port's writer makes from seeded nets, 5 stems with random weights.
   Launch counts (2 and 5 stems: K1, K2, K4-K7 once and K3 three times; 3
   stems: K1 and K7 once, K2, K4, K5, K6 twice, K3 six times), the 2-stem
   conservation |vocals + accompaniment - input| <= 1e-5, and per-stem SNR
   against the plain fp32 graph (every wrapper's plain version, the
   canonical cuDNN U-Net): >= 42 dB (bf16 CLI) and >= 80 dB (fp32 kernels).
11. The round-3 route (K2, K3 x2, torch enc4..up5, K10): the 2-stem CLI
   with an npz of a narrow-trunk net (save_npz, seeded), then the standard
   net with model.FORCE_PACKED_UNET = False; launches K1, K2, K3 x2, K10,
   K7 and no K4/K5/K6; a profile shows library convolutions only in
   enc4..up5 (trunk_tail); SNR as in 10.
12. 2-stem separation at 300 s at the exe config on the packed and the
   round-3 routes (realtime factors), their U-Net stages beside the
   canonical U-Net, K6 and K10 each beside its plain version, K10 and the
   canonical head at S * B = 64 images (the round-3 gate's limit), and a
   profile of each route.

Phase 2 also holds K10 against its plain version in float32 and bfloat16,
per pixel to tail.head_error_bound on x's two halves, at the 2-stem exe
shapes (3 tiles of 256 x 512 x 32) and on the 4-stem VST batch with its
stems folded (S = 4, x = [skip1 | up5] of the plain chain), where it must
also give K6's masks bit for bit. Phase 2's plain chain runs cuDNN's
deterministic algorithms, so its errors repeat from run to run.

The last three lines are the kernel report (all ten kernels, each with
its launches on the path that runs it, its time beside its plain
version's, the least time the card could take for its work, and a library
call's time where one PyTorch call computes the same function), the
card's nvidia-smi line and the JSON status line. Without a CUDA device
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
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
    STEM_MODE_2,
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
    mask_head,
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
# The CLI's defaults, the reference exe's config: the 2- and 3-stem cells.
EXE_BIN_LIMIT, EXE_TIME_STEP = 1024, 512
# The 3-stem CLI: K1 and K7 once, each U-Net pass K2, K3 x3, K4, K5, K6.
THREE_STEM_LAUNCHES = {"stft4096": 1, "enc1": 2, "enc_s2": 6, "up4": 2,
                       "up5": 2, "head": 2, "masked_istft4096": 1}
# The round-3 route of the 2-stem CLI: K2 and K3 for enc1..enc3, K10.
ROUND3_LAUNCHES = {"stft4096": 1, "enc1": 1, "enc_s2": 2, "mask_head": 1,
                   "masked_istft4096": 1}
CONSERVATION_MAX = 1e-5  # |vocals + accompaniment - input|, 2 stems
# A deep trunk that is not the standard one, the shallow ends standard:
# (Cin, Cout) of the layers it replaces. The CLI's --weights npz takes it.
NARROW_TRUNK = {"down4": (64, 96), "down5": (96, 192), "down6": (192, 384),
                "up1": (384, 192), "up2": (384, 96), "up3": (192, 64)}
HEAD_BATCH_LIMIT = model.PALLAS_HEAD_MAX_BATCH  # K10 vs canonical head here
# The card's published peaks (NVIDIA H100 SXM data sheet, dense rates at
# 700 W): a kernel's bound is the larger of its bytes over the memory rate
# and its operations over the peak rate of its operands' type (float32
# outside the tensor cores; bf16 on them).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
RFFT_OPS = 2.5 * 4096 * 12  # 5 N log2 N / 2 for one real FFT of N = 4096
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
    ("mask_head", "head.cu", "mask_head.py:86"),
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


def exe_config(num_stems: int, compute_dtype, overlap: int = 4):
    """The CLI's default config (the reference exe's) for num_stems."""
    return SeparatorConfig(transform=TransformConfig(overlap=overlap),
                           bin_limit=EXE_BIN_LIMIT, time_step=EXE_TIME_STEP,
                           num_stems=num_stems, compute_dtype=compute_dtype)


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
    spec2, mag2 = stft_fused.stft4096(*k1_args)
    same = torch.equal(spec, spec2) and torch.equal(mag, mag2)
    log(f"[K1 stft4096] two runs bit-identical: {same}")
    if not same:
        raise AssertionError("K1 is not deterministic")
    del spec2, mag2

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
        # irfft4096's function is torch.fft.irfft's (no window here).
        library_ms = (cuda_ms(lambda: torch.fft.irfft(args[0], n=4096))
                      if name == "irfft4096" else None)
        log(f"[{name}] {shapes} shapes: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms" + (f", torch.fft.irfft {library_ms:.4f} ms"
                                    if library_ms is not None else ""))
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **bound_entry([(name, args, {})]),
                        "library_ms": library_ms}
    del k8_args, k9_args

    # cuDNN's transposed convolutions (dgrad) may sum in another order from
    # call to call, which moves the plain chain's outputs and so each
    # error below; its deterministic algorithms make them repeat run to run.
    # They are far slower, so every time is taken with cuDNN's own choice.
    torch.backends.cudnn.deterministic = True
    stacked = with_random_epilogues(random_stacked(device))
    two_stem = two_stem_head_inputs(audio, device)
    timed = collections.defaultdict(list)  # kernel -> its timed calls
    for dtype in (torch.float32, torch.bfloat16):
        calls = unet_calls(stacked, pmag, dtype)[0]
        for label, name, fn, plain, args, kw in calls:
            got, ref = fn(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err, bound, worst = unet_error(got, ref, dtype, name, args, kw)
            where = " (per pixel; at the largest error / bound)" * (name == "head")
            log(f"[{label} {name}] {str(dtype)[6:]}: max |kernel - plain| = "
                f"{err:.3e}, bound {bound:.3e}{where}; largest error / bound "
                f"{worst:.3e}")
            if not worst <= 1:
                raise AssertionError(f"{label} disagrees with its plain version")
            if name in ("enc1", "enc_s2", "up4", "up5", "head"):
                again = fn(*args, **kw)
                pairs = zip(got, again) if name.startswith("enc") else [(got, again)]
                same = all(torch.equal(a, b) for a, b in pairs)
                log(f"[{label} {name}] {str(dtype)[6:]}: two runs bit-identical: "
                    f"{same}")
                if not same:
                    raise AssertionError(f"{label} is not deterministic")
                del again
            if dtype != cfg.compute_dtype:
                continue
            with cudnn_deterministic(False):  # time what the path runs
                ms = cuda_ms(lambda: fn(*args, **kw))
                plain_ms = cuda_ms(lambda: plain(*args, **kw))
                log(f"[{label} {name}] 30 s shapes, {str(dtype)[6:]}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
                if name == "enc1":
                    log_enc1(f"{label}, 30 s", args, kw, ms)
                elif name == "enc_s2":
                    log_k3_layer(f"{label}, 30 s", args, kw, ms)
                elif name in ("up4", "up5"):
                    log_up_layer(f"{label}, 30 s", name, args, kw, ms)
            entry = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                             "plain_ms": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["ms"] += ms  # K3: enc2 + enc3 + enc4, one path's worth
            entry["plain_ms"] += plain_ms
            timed[name].append((name, args, kw))
        # K10 on the head's inputs of the same chain, x = [skip1 | up5]
        # (stems folded, S = 4), and at the 2-stem exe shapes, where the
        # round-3 route runs it.
        head_args = calls[-1][4]
        exe_args = two_stem(dtype)
        entry = report.setdefault("mask_head", {"max_abs_err": 0.0})
        for label, args, kw in (
            ("K10 mask_head, 4-stem VST batch (S = 4)",
             (torch.cat(head_args[:2], -1).contiguous(), *head_args[2:]),
             {"act": "elu"}),
            ("K10 mask_head, 2-stem exe shapes", exe_args, {"act": "relu"}),
        ):
            got = mask_head.mask_head(*args, **kw)
            ref = mask_head.mask_head_plain(*args, **kw)
            torch.cuda.synchronize()
            err, bound, worst = unet_error(got, ref, dtype, "mask_head", args, kw)
            log(f"[{label}] x {tuple(args[0].shape)} {str(dtype)[6:]}: max "
                f"|kernel - plain| = {err:.3e}, bound {bound:.3e} (per pixel; "
                f"at the largest error / bound); largest error / bound "
                f"{worst:.3e}")
            if not worst <= 1:
                raise AssertionError(f"{label} disagrees with its plain version")
            if not torch.equal(got, mask_head.mask_head(*args, **kw)):
                raise AssertionError(f"{label} is not deterministic")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        # One template: K10 on [skip1 | up5] gives K6's masks bit for bit.
        same = torch.equal(
            mask_head.mask_head(torch.cat(head_args[:2], -1).contiguous(),
                                *head_args[2:], act="elu"),
            tail.head(*head_args, act="elu").flatten(0, 1))
        log(f"[K10 mask_head] {str(dtype)[6:]}: two runs bit-identical, and "
            f"bit-identical to K6 on the same 4-stem inputs: {same}")
        if not same:
            raise AssertionError("K10 and K6 disagree on the same inputs")
        del head_args, calls
        if dtype == cfg.compute_dtype:
            kw = {"act": "relu"}
            with cudnn_deterministic(False):
                entry["ms"] = cuda_ms(lambda: mask_head.mask_head(*exe_args, **kw))
                entry["plain_ms"] = cuda_ms(
                    lambda: mask_head.mask_head_plain(*exe_args, **kw))
            log(f"[K10 mask_head] 2-stem exe shapes, {str(dtype)[6:]}: kernel "
                f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms")
            timed["mask_head"].append(("mask_head", exe_args, kw))
    torch.backends.cudnn.deterministic = False
    for name, calls in timed.items():
        report[name].update(bound_entry(calls), library_ms=None)
    return report


def log_stft(label: str, args, ms: float) -> None:
    """K1's time beside its bound, cuFFT's torch.fft.rfft of the windowed
    frames alone (the frames built outside the timing; no magnitude tiles
    or zero frames: an FFT-only yardstick, not a library call for K1's
    function), and its resources."""
    bound = bound_entry([("stft4096", args, {})])
    audio, window, n_comp = args[:3]
    need = (n_comp - 1) * stft_fused.HOP + stft_fused.N
    x = torch.nn.functional.pad(audio, (0, max(0, need - audio.shape[-1])))[:, :need]
    frames = (x.unfold(-1, stft_fused.N, stft_fused.HOP) * window).contiguous()
    fft_ms = cuda_ms(lambda: torch.fft.rfft(frames, n=stft_fused.N), 10)
    del x, frames
    log(f"[{label}] {audio.shape[0]} rows x {args[3]} frames: kernel {ms:.4f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), share "
        f"{100 * bound['bound_ms'] / ms:.1f}%; torch.fft.rfft of the windowed frames "
        f"alone (yardstick) {fft_ms:.4f} ms; {stft_fused.STFT_GROUPS} groups a block, "
        f"{resources(stft_fused.stft_attributes(audio.device))}")


def log_enc1(label: str, args, kw, ms: float) -> None:
    """K2's time beside its bound, the fp32 FMA floor (its multiply-adds on
    CUDA cores at 67 TFLOP/s) and cuDNN's convolution 2 -> 16 S alone on
    the magnitude in the compute dtype (stride 2, padding 2: the same
    output size and multiply-adds, but no bias, batch norm or activation
    and one output; a convolution-only yardstick, not a library call for
    K2's function), and in bf16 the tensor-core template's resources."""
    bound = bound_entry([("enc1", args, kw)])
    floor_ms = kernel_work("enc1", args, kw)[1] / PEAK_OPS_PER_S[torch.float32] * 1e3
    mag, w = args[:2]
    dtype = kw["dtype"]
    x = mag.to(dtype)
    wc = w.reshape(-1, 2, 5, 5).to(dtype)  # every stem's 16 channels
    conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(x, wc, stride=2, padding=2))
    del x
    res = ""
    if encoder._tensor_cores(2, dtype):
        res = (f"; enc1_mma_kernel "
               f"{resources(encoder.enc1_attributes(mag.device, w.shape[0]))}")
    log(f"[{label}] mag {tuple(mag.shape)}, {w.shape[0]} stems, {str(dtype)[6:]}: "
        f"kernel {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
        f"share {100 * bound['bound_ms'] / ms:.1f}%, fp32 FMA floor {floor_ms:.4f} ms; "
        f"cuDNN conv2d 2 -> {16 * w.shape[0]} alone (yardstick) {conv_ms:.4f} ms{res}")


def log_k3_layer(label: str, args, kw, ms: float) -> None:
    """One K3 layer's time beside its bound, the fp32 FMA floor (its
    multiply-adds on CUDA cores at 67 TFLOP/s) and cuDNN's convolution
    alone at the same shape: a convolution-only yardstick (bf16,
    channels_last, stride 2, padding 2: the same output size and
    multiply-adds, but no bias, batch norm or activation and one output),
    not a library call for K3's function."""
    bound = bound_entry([("enc_s2", args, kw)])
    floor_ms = kernel_work("enc_s2", args, kw)[1] / PEAK_OPS_PER_S[torch.float32] * 1e3
    x, w = args[0], args[1]
    xc = x.permute(0, 3, 1, 2)  # NHWC memory: an NCHW view in channels_last
    wc = w[0].to(x.dtype).contiguous(memory_format=torch.channels_last)
    conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(xc, wc, stride=2, padding=2))
    log(f"[{label}] x {tuple(x.shape)} {str(x.dtype)[6:]}: kernel {ms:.4f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), share "
        f"{100 * bound['bound_ms'] / ms:.1f}%, fp32 FMA floor {floor_ms:.4f} ms; "
        f"cuDNN conv2d alone (yardstick) {conv_ms:.4f} ms")


def log_up_layer(label: str, name: str, args, kw, ms: float) -> None:
    """One K4/K5 layer's time beside its bound, the fp32 FMA floor and
    cuDNN's transposed convolution alone on a pre-built concat [skip, prev]
    (bf16, channels_last, stride 2, padding 2, output_padding 1: the same
    output size and multiply-adds, but no bias, batch norm or activation
    and the concat built outside the timing), a convolution-only yardstick,
    not a library call for K4/K5's function; and the tensor-core
    template's resources (registers a thread, shared memory a block,
    resident blocks and warps an SM)."""
    bound = bound_entry([(name, args, kw)])
    floor_ms = kernel_work(name, args, kw)[1] / PEAK_OPS_PER_S[torch.float32] * 1e3
    skip, prev, w = args[:3]
    x = torch.cat([skip, prev], -1).permute(0, 3, 1, 2)  # channels_last NCHW view
    wc = w[0].to(skip.dtype).contiguous(memory_format=torch.channels_last)
    conv_ms = cuda_ms(lambda: torch.nn.functional.conv_transpose2d(
        x, wc, stride=2, padding=2, output_padding=1))
    del x
    res = ""
    if tail._tensor_cores(skip.shape[-1], skip.dtype):
        res = (f"; up_mma_kernel "
               f"{resources(tail.up_mma_attributes(skip.shape[-1], skip.device))}")
    log(f"[{label}] skip {tuple(skip.shape)} {str(skip.dtype)[6:]}: kernel {ms:.4f} "
        f"ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), share "
        f"{100 * bound['bound_ms'] / ms:.1f}%, fp32 FMA floor {floor_ms:.4f} ms; "
        f"cuDNN conv_transpose2d alone (yardstick) {conv_ms:.4f} ms{res}")


def resources(a: dict) -> str:
    """A template's registers, shared memory and resident blocks an SM,
    as the CUDA runtime reports them."""
    warps = a["blocks_per_sm"] * a["threads"] // 32
    return (f"{a['registers']} registers x {a['threads']} threads, "
            f"{a['smem_bytes']} B shared, {a['blocks_per_sm']} blocks an SM "
            f"({warps} warps, {100 * warps / 64:.1f}% occupancy)")


def log_head(label: str, args, kw, ms: float) -> None:
    """K6's time beside its bound and the fp32 FMA floor (its multiply-adds
    on CUDA cores at 67 TFLOP/s), and in bf16 the tensor-core template's
    resources."""
    bound = bound_entry([("head", args, kw)])
    floor_ms = kernel_work("head", args, kw)[1] / PEAK_OPS_PER_S[torch.float32] * 1e3
    src = args[0]
    res = ""
    if tail._head_tensor_cores(src.dtype):
        res = f"; head_mma_kernel {resources(tail.head_mma_attributes(src.device))}"
    log(f"[{label}] skip1 {tuple(src.shape)} {str(src.dtype)[6:]}: kernel {ms:.4f} "
        f"ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), share "
        f"{100 * bound['bound_ms'] / ms:.1f}%, fp32 FMA floor {floor_ms:.4f} ms{res}")


def log_istft(label: str, args, ms: float) -> None:
    """K7's time beside its bound, torch.fft.irfft over the pre-masked
    (S, rows, n_frames, 2049) spectrum alone (cuFFT; an FFT-only yardstick,
    with no mask, window or overlap-add, not a library call for K7's
    function), and its resources."""
    bound = bound_entry([("masked_istft4096", args, {})])
    spec, masks, out_band, _, n_frames = args
    y = stft_fused.masked_bins(spec, masks, out_band, n_frames)
    fft_ms = cuda_ms(lambda: torch.fft.irfft(y, n=4096), 5, 1)
    s, rows = y.shape[:2]
    del y
    log(f"[{label}] {s} stems x {rows} rows x {n_frames} frames: kernel {ms:.4f} ms, "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), share "
        f"{100 * bound['bound_ms'] / ms:.1f}%; torch.fft.irfft of the masked "
        f"spectrum alone (yardstick) {fft_ms:.4f} ms; run {stft_fused.RUN_HOPS} "
        f"hops, {resources(stft_fused.istft_attributes(spec.device))}")


@contextlib.contextmanager
def cudnn_deterministic(on: bool):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def two_stem_head_inputs(audio: torch.Tensor, device):
    """K10's input at the 2-stem exe shapes: dtype -> the head's arguments
    (x, w6, b6, bn_scale6, bn_shift6, w7, b7), x = up6's input from the
    canonical trunk (cuDNN, the plain chain) of the CLI's random 2-stem net
    with random biases and batch norms, over the magnitude of `audio`."""
    cfg = exe_config(2, torch.float32)
    net = with_random_epilogues(model.with_stem_axis(
        cli.load_weights(None, True, SEED, cfg, device)["params"]))
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    _, n_comp, n_req = frame_counts(padded.shape[-1], cfg)
    _, mag = stft_fused.stft4096_plain(
        padded, transform.analysis_window(4096, device=device), n_comp, n_req,
        cfg.bin_limit, cfg.time_step)
    ly6, ly7 = net["up6"], net["up7"]
    weights6 = (ly6["w"], ly6["b"], ly6["bn_scale"], ly6["bn_shift"], ly7["w"],
                ly7["b"])

    def args(dtype):
        x = model.unet_trunk(model.stem_params(net, 0), mag, STEM_MODE_2, dtype)
        return (x.permute(0, 2, 3, 1).contiguous(), *weights6)

    return args


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def kernel_work(name: str, args, kw) -> tuple[float, float, torch.dtype]:
    """(bytes, operations, operand dtype) of one kernel call: each input
    read once, each output written once; operations are multiply-adds x 2
    (a transposed 5 x 5 stride-2 conv: 6.25 taps per output on average),
    plus RFFT_OPS per 4096-point transform."""
    if name == "stft4096":
        audio, window, n_comp, n_req, bin_limit, _ = args
        rows = audio.shape[0]
        out = rows * n_req * (stft_fused.N_BINS * 8 + bin_limit * 4)
        ops = rows * n_comp * (RFFT_OPS + 4096 + 3 * bin_limit)
        return nbytes(audio, window) + out, ops, torch.float32
    if name == "masked_istft4096":
        spec, masks, out_band, window, n_frames = args
        s, rows = masks.shape[0], spec.shape[0]
        read = rows * n_frames * stft_fused.N_BINS * 8 + nbytes(masks, out_band, window)
        out = s * rows * (n_frames * 1024 + 3072) * 4
        ops = s * rows * n_frames * (RFFT_OPS + 2 * stft_fused.N_BINS + 2 * 4096)
        return read + out, ops, torch.float32
    if name in ("irfft4096", "masked_irfft4096"):
        spec = args[0]
        s = args[1].shape[0] if name == "masked_irfft4096" else 1
        frames = spec.numel() // stft_fused.N_BINS
        ops = s * frames * (RFFT_OPS + 2 * stft_fused.N_BINS + 4096)
        return nbytes(*args) + s * frames * 4096 * 4, ops, torch.float32
    if name == "enc1":
        mag, w = args[:2]
        b, _, t, f = mag.shape
        px = w.shape[0] * b * (t // 2) * (f // 2)
        dtype = kw["dtype"]
        out = 2 * px * 16 * torch.finfo(dtype).bits // 8
        return nbytes(*args) + out, px * 16 * 2 * 25 * 2, dtype
    if name == "enc_s2":
        x = args[0]
        sb, h, wd, c = x.shape
        px = sb * (h // 2) * (wd // 2)
        out = 2 * px * 2 * c * x.element_size()
        return nbytes(*args) + out, px * 2 * c * c * 25 * 2, x.dtype
    if name in ("up4", "up5"):
        skip = args[0]
        sb, h, wd, c = skip.shape
        px = sb * 4 * h * wd
        out = px * (c // 2) * skip.element_size()
        return nbytes(*args) + out, px * (c // 2) * 2 * c * 6.25 * 2, skip.dtype
    if name in ("head", "mask_head"):
        src = args[0]
        sb, h, wd, _ = src.shape
        px = sb * 4 * h * wd  # mask pixels; 2 float32 channels each
        return nbytes(*args) + px * 2 * 4, px * (32 * 6.25 + 2 * 16) * 2, src.dtype
    raise ValueError(name)


def bound_entry(calls) -> dict:
    """The least time the card could take for the calls' work (ms), and
    whether bytes or operations set it."""
    bytes_ms = ops_ms = 0.0
    for name, args, kw in calls:
        nb, ops, dtype = kernel_work(name, args, kw)
        bytes_ms += nb / HBM_BYTES_PER_S * 1e3
        ops_ms += ops / PEAK_OPS_PER_S[dtype] * 1e3
    if bytes_ms >= ops_ms:
        return {"bound_ms": bytes_ms, "bound_by": "bytes"}
    return {"bound_ms": ops_ms, "bound_by": "operations"}


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


def unet_calls(stacked, mag, dtype, stem_mode=STEM_MODE_4
               ) -> tuple[list[tuple], tuple]:
    """The packed U-Net's kernel calls at `mag`'s shapes in dataflow order,
    (label, counter, wrapper, plain, args, kwargs), each on the outputs of
    the plain chain before it, and the mid trunk's arguments."""
    def layer(name):
        ly = stacked[name]
        return ly["w"], ly["b"], ly["bn_scale"], ly["bn_shift"]

    calls = []
    kw = {"act": model.encoder_act_name(stem_mode), "dtype": dtype}
    args = (mag, *layer("down1"))
    calls.append(("K2 enc1", "enc1", encoder.enc1, encoder.enc1_plain, args, kw))
    skip, x = encoder.enc1_plain(*args, **kw)
    skips = [skip]
    kw = {"act": model.encoder_act_name(stem_mode)}
    for i in (2, 3, 4):
        args = (x, *layer(f"down{i}"))
        calls.append((f"K3 enc{i}", "enc_s2", encoder.enc_s2,
                      encoder.enc_s2_plain, args, kw))
        skip, x = encoder.enc_s2_plain(*args, **kw)
        skips.append(skip)
    trunk_args = (stacked, x, skips[3], stem_mode, dtype)
    x = model.mid_trunk(*trunk_args)
    kw = {"act": model.decoder_act_name(stem_mode)}
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
    if name in ("head", "mask_head"):
        bound_fn = (tail.head_error_bound if name == "head"
                    else mask_head.mask_head_error_bound)
        diff = (got - ref).abs().flatten()
        bound = bound_fn(*args, **kw).flatten()
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
    count; the port's own kernels (namespace spleeterrt) are not counted.
    A profile that caught no device kernel at all measured nothing and is
    taken again, three times at most."""
    for attempt in range(3):
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
        log(f"[profile] capture {attempt + 1} held no device kernel; again")
    else:
        raise AssertionError("the profiler caught no device kernel in three tries")
    return collections.Counter(
        name for name in names
        if "spleeterrt" not in name and any(k in name.lower() for k in keys)
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
    log_stft(f"K1 stft4096, {BENCH_SECONDS[-1]:.0f} s", k1_args, stages["K1 stft4096"])
    calls, trunk_args = unet_calls(stacked, mag, cfg.compute_dtype)
    for i, (label, name, fn, plain, args, kw) in enumerate(calls):
        if i == 4:  # between enc4 and up4, in dataflow order
            stages["mid trunk (cuDNN, 4 stems)"] = cuda_ms(
                lambda: model.mid_trunk(*trunk_args), 5, 1)
        stages[label] = cuda_ms(lambda: fn(*args, **kw), 5, 1)
        stages[f"{label} plain"] = cuda_ms(lambda: plain(*args, **kw), 3, 1)
        if name == "enc1":
            log_enc1(f"{label}, {BENCH_SECONDS[-1]:.0f} s", args, kw, stages[label])
        elif name == "enc_s2":
            log_k3_layer(f"{label}, {BENCH_SECONDS[-1]:.0f} s", args, kw,
                         stages[label])
        elif name in ("up4", "up5"):
            log_up_layer(f"{label}, {BENCH_SECONDS[-1]:.0f} s", name, args, kw,
                         stages[label])
        elif name == "head":
            log_head(f"{label}, {BENCH_SECONDS[-1]:.0f} s", args, kw, stages[label])
    del calls, trunk_args
    stages["K7 masked_istft4096"] = cuda_ms(
        lambda: stft_fused.masked_istft4096(*k7_args), 10)
    stages["K7 plain"] = cuda_ms(
        lambda: stft_fused.masked_istft4096_plain(*k7_args), 10)
    log_istft(f"K7 masked_istft4096, {BENCH_SECONDS[-1]:.0f} s", k7_args,
              stages["K7 masked_istft4096"])
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
    names = profile_device("one separation",
                           lambda: separate.separate_4stem(stacked, padded, cfg))
    # bf16 enc1 runs the tensor-core template and no FMA encoder kernel.
    fma = [n for n in names if "enc_conv_kernel" in n]
    if not any("enc1_mma_kernel" in n for n in names) or fma:
        raise AssertionError(f"bf16 enc1 did not run enc1_mma_kernel alone: {fma}")
    log("[profile] bf16 enc1 ran enc1_mma_kernel; no FMA encoder kernel ran")


def profile_device(label: str, fn) -> collections.Counter:
    """Device time by kernel over one fn() after one warm-up call, against
    its wall time (synchronised), and the idle share; returns the device
    time (ms) by kernel name."""
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
    return by_name


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
        "torch.fft.irfft (cuFFT alone)": cuda_ms(
            lambda: torch.fft.irfft(masked, n=4096), 10),
        "tails + overlap-add (torch)": cuda_ms(
            lambda: stream.synthesize(frames, state.ola_tail, ws), 10),
        "block step": cuda_ms(
            lambda: stream.block_step_streams(stacked, state, block, cfg), 5, 1),
    }
    for name, ms in stages.items():
        log(f"[streams] K = {k} stage {name}: {ms:.3f} ms")
    del masked, frames


# ---------------------------------------------------------------------------
# 2, 3 and 5 stems, the round-3 route
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_graph():
    """The offline graphs with no hand kernel: every wrapper they call
    replaced by its plain version (torch.fft) and the U-Net sent down its
    canonical route (cuDNN), as phase 4's plain path is for 4 stems."""
    patches = [
        (stft_fused, "stft4096", stft_fused.stft4096_plain),
        (stft_fused, "masked_istft4096", stft_fused.masked_istft4096_plain),
        (pallas_fft, "irfft4096", pallas_fft.irfft4096_plain),
        (pallas_fft, "masked_irfft4096", pallas_fft.masked_irfft4096_plain),
        (model, "FORCE_PACKED_UNET", False),
        (model, "FORCE_PALLAS_HEAD", False),
        (model, "FORCE_PALLAS_ENCODER", False),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    kernels.reset_launch_counts()
    try:
        for mod, name, value in patches:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the plain graph launched {kernels.launch_counts()}")


@contextlib.contextmanager
def packed_unet_off():
    """The standard net sent down the round-3 route."""
    model.FORCE_PACKED_UNET = False
    try:
        yield
    finally:
        model.FORCE_PACKED_UNET = None


def narrow_net(gen: torch.Generator):
    """init_params with NARROW_TRUNK in place of the standard deep trunk:
    he-normal weights, zero biases, unit batch norms."""
    p = model.init_params(gen)
    for name, (cin, cout) in NARROW_TRUNK.items():
        shape = (cout, cin, 5, 5) if name.startswith("down") else (cin, cout, 5, 5)
        p[name] = {"w": torch.randn(shape, generator=gen) * math.sqrt(2 / (25 * cin)),
                   "b": torch.zeros(cout)}
        if name != "down6":
            p[name].update(bn_scale=torch.ones(cout), bn_shift=torch.zeros(cout))
    return p


def write_weight_files(workdir: str) -> dict[str, str]:
    """The quantized two-subnet file (subnet 0 the 4-stem-family net,
    subnet 1 the 2-stem net) and the narrow-trunk npz, from seeded nets
    through the port's writers."""
    gen = torch.Generator().manual_seed(SEED)
    halves = [weights.encode_fp16(np.frombuffer(
        weights.params_to_blob(model.init_params(gen)), "<f4")) for _ in range(2)]
    quantized = os.path.join(workdir, "model_fp16.bin")
    with open(quantized, "wb") as f:
        f.write(np.concatenate(halves).astype("<u2").tobytes())
    narrow = os.path.join(workdir, "narrow.npz")
    weights.save_npz(narrow_net(gen), narrow)
    return {"quantized": quantized, "narrow": narrow}


def run_stems_cli(workdir: str, song: str, tag: str, n_stems: int, wargs: list,
                  device) -> tuple[dict, dict]:
    """The CLI at its defaults (the exe config, bf16) with --stems n_stems;
    returns (its launch counts, {stem: samples read back})."""
    out_dir = os.path.join(workdir, tag)
    kernels.reset_launch_counts()
    rc = cli.main([song, "--stems", str(n_stems), *wargs, "--output-dir",
                   out_dir, "--device", str(device)])
    launches = kernels.launch_counts()
    log(f"[{tag}] cli rc {rc}, launches {launches}")
    if rc != 0:
        raise AssertionError(f"{tag}: CLI returned {rc}")
    base = os.path.splitext(os.path.basename(song))[0]
    stems = {}
    for stem in exe_config(n_stems, torch.float32).stem_names:
        y = audio_io.read_wav(os.path.join(
            out_dir, f"{base}_{cli.STEM_FILENAMES[stem]}.wav")).samples
        if not np.all(np.isfinite(y)):
            raise AssertionError(f"{tag} {stem}: non-finite samples")
        stems[stem] = y
    return launches, stems


def check_stem_quality(tag: str, x: np.ndarray, cli_stems: dict, nets: dict,
                       n_stems: int, device) -> None:
    """Per-stem SNR of the CLI's bf16 stems and of the fp32 kernel graph
    against the plain fp32 graph on the same nets; stems as long as x."""
    cfg32 = exe_config(n_stems, torch.float32)
    kern = separate.separate(x, cfg=cfg32, device=device, **nets)
    with plain_graph():
        plain = separate.separate(x, cfg=cfg32, device=device, **nets)
    for stem, ref in plain.items():
        ref = ref.cpu().numpy()
        if cli_stems[stem].shape != x.shape:
            raise AssertionError(f"{tag} {stem}: shape {cli_stems[stem].shape}")
        bf16 = snr_db(cli_stems[stem], ref)
        fp32 = snr_db(kern[stem].cpu().numpy(), ref)
        log(f"[{tag} quality] {stem}: bf16 CLI vs fp32 plain {bf16:.2f} dB "
            f"(>= {SNR_BF16_MIN_DB}), fp32 kernels vs fp32 plain {fp32:.2f} dB "
            f"(>= {SNR_FP32_MIN_DB})")
        if not (bf16 >= SNR_BF16_MIN_DB and fp32 >= SNR_FP32_MIN_DB):
            raise AssertionError(f"{tag} {stem}: SNR below its bound")


def phase_stems_cli(workdir: str, files: dict, device) -> None:
    """2 stems (defaults, random weights), 3 stems (the quantized file) and
    5 stems (random weights) through the CLI on the 30 s WAV."""
    x = synthetic_audio(SMOKE_SECONDS)
    song = os.path.join(workdir, "stems.wav")
    audio_io.write_wav(song, x)
    for n_stems, wargs, per_run in (
        (2, ["--random-weights", "--seed", str(SEED)], MAIN_PATH_LAUNCHES),
        (3, ["--weights", files["quantized"]], THREE_STEM_LAUNCHES),
        (5, ["--random-weights", "--seed", str(SEED)], MAIN_PATH_LAUNCHES),
    ):
        tag = f"{n_stems} stems"
        launches, stems = run_stems_cli(workdir, song, tag, n_stems, wargs, device)
        if launches != expected_launches(per_run):
            raise AssertionError(f"{tag}: launches {launches}, expected {per_run}")
        if n_stems == 2:
            err = np.abs(stems["vocals"] + stems["accompaniment"] - x).max()
            log(f"[{tag}] conservation max |vocals + accompaniment - input| = "
                f"{err:.3e} (<= {CONSERVATION_MAX})")
            if not err <= CONSERVATION_MAX:
                raise AssertionError("2 stems: vocals + accompaniment != input")
        cfg = exe_config(n_stems, torch.bfloat16)
        src = wargs[1] if wargs[0] == "--weights" else None
        nets = cli.load_weights(src, src is None, SEED, cfg, device)
        check_stem_quality(tag, x, stems, nets, n_stems, device)


def phase_round3(workdir: str, files: dict, device) -> dict:
    """The 2-stem CLI on the round-3 route: the narrow-trunk npz, then the
    standard net with FORCE_PACKED_UNET = False. Returns the first run's
    launch counts."""
    x = synthetic_audio(SMOKE_SECONDS)
    song = os.path.join(workdir, "round3.wav")
    audio_io.write_wav(song, x)
    cfg = exe_config(2, torch.bfloat16)
    first = None
    for tag, wargs, switch in (
        ("round 3, narrow npz", ["--weights", files["narrow"]],
         contextlib.nullcontext),
        ("round 3, FORCE_PACKED_UNET = False",
         ["--random-weights", "--seed", str(SEED)], packed_unet_off),
    ):
        src = wargs[1] if wargs[0] == "--weights" else None
        nets = cli.load_weights(src, src is None, SEED, cfg, device)
        with switch():
            launches, stems = run_stems_cli(workdir, song, tag, 2, wargs, device)
            if launches != expected_launches(ROUND3_LAUNCHES):
                raise AssertionError(f"{tag}: launches {launches}, expected "
                                     f"{ROUND3_LAUNCHES}")
            check_library_convs_round3(tag, x, nets["params"], cfg, device)
            check_stem_quality(tag, x, stems, nets, 2, device)
        first = first or launches
    return first


def check_library_convs_round3(tag, x, params, cfg, device) -> None:
    """The library convolutions of a round-3 2-stem separation are those of
    trunk_tail (enc4..up5) alone, on inputs of the same shapes and layouts
    as the K3 outputs it reads, and no more."""
    padded = transform.pad_offline(torch.from_numpy(x).to(device),
                                   cfg.transform).contiguous()
    graph = library_conv_kernels(lambda: separate.separate_2stem(params, padded, cfg))
    _, _, n_req = frame_counts(padded.shape[-1], cfg)
    nt, t, f = n_req // cfg.time_step, cfg.time_step, cfg.bin_limit
    nchw = lambda c, d: torch.zeros((nt, t // d, f // d, c), dtype=cfg.compute_dtype,
                                    device=device).permute(0, 3, 1, 2)
    skips = [nchw(16, 2), nchw(32, 4), nchw(64, 8)]
    tail_only = library_conv_kernels(lambda: model.trunk_tail(
        params, nchw(64, 8), skips, STEM_MODE_2, cfg.compute_dtype))
    log(f"[{tag}] library convolution launches: graph {sum(graph.values())}, "
        f"trunk_tail (enc4..up5) alone {sum(tail_only.values())}")
    if not tail_only or graph != tail_only:
        raise AssertionError(f"{tag}: library convolutions outside enc4..up5: "
                             f"graph {dict(graph)}, trunk_tail {dict(tail_only)}")


def phase_timing_2stem(device) -> None:
    """separate_2stem at 300 s at the exe config (bf16, the CLI's random
    2-stem net) on the packed and the round-3 routes, their U-Net and head
    stages, and K10 against the canonical head at HEAD_BATCH_LIMIT images."""
    cfg = exe_config(2, torch.bfloat16)
    params = cli.load_weights(None, True, SEED, cfg, device)["params"]
    seconds = BENCH_SECONDS[-1]
    rng = np.random.default_rng(SEED)
    audio = torch.as_tensor(rng.standard_normal((2, int(seconds * SR))) * 0.3,
                            dtype=torch.float32, device=device)
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    run = lambda: separate.separate_2stem(params, padded, cfg)
    routes = {"packed": contextlib.nullcontext, "round 3": packed_unet_off}
    for switch in routes.values():
        with switch():
            run()  # warm up
    times = {name: float("inf") for name in routes}
    for _ in range(3):  # the routes take turns; best of three rounds of three
        for name, switch in routes.items():
            with switch():
                times[name] = min(times[name], cuda_ms(run, iters=3, warmup=0))
    for name, ms in times.items():
        log(f"[2-stem timing] {seconds:.0f} s, {name} route: {ms:.3f} ms per "
            f"separate_2stem, {seconds / (ms / 1e3):.2f}x realtime")

    _, n_comp, n_req = frame_counts(padded.shape[-1], cfg)
    _, mag = stft_fused.stft4096(
        padded, transform.analysis_window(4096, device=device), n_comp, n_req,
        cfg.bin_limit, cfg.time_step)
    one = model.with_stem_axis(params)
    masks = lambda: separate.single_net_masks(params, mag, cfg, STEM_MODE_2)
    stages = {"U-Net, packed (K2-K6 + mid trunk)": cuda_ms(masks, 5, 1)}
    with packed_unet_off():
        stages["U-Net, round 3 (K2, K3 x2, torch enc4..up5, K10)"] = cuda_ms(
            masks, 5, 1)
    stages["U-Net, canonical (cuDNN)"] = cuda_ms(
        lambda: model.multi_stem_masks_canonical(one, mag, STEM_MODE_2,
                                                 cfg.compute_dtype), 5, 1)
    calls, _ = unet_calls(one, mag, cfg.compute_dtype, STEM_MODE_2)
    _, _, _, _, k6_args, kw = calls[-1]
    stages["K6 head"] = cuda_ms(lambda: tail.head(*k6_args, **kw), 10)
    stages["K6 plain"] = cuda_ms(lambda: tail.head_plain(*k6_args, **kw), 5, 1)
    del calls, k6_args
    x = model.multi_stem_trunk(one, mag, STEM_MODE_2, cfg.compute_dtype)
    ly6, ly7 = one["up6"], one["up7"]
    w = (ly6["w"], ly6["b"], ly6["bn_scale"], ly6["bn_shift"], ly7["w"], ly7["b"])
    stages["K10 mask_head"] = cuda_ms(lambda: mask_head.mask_head(x, *w, **kw), 10)
    stages["K10 plain"] = cuda_ms(
        lambda: mask_head.mask_head_plain(x, *w, **kw), 5, 1)
    reps = -(-HEAD_BATCH_LIMIT // x.shape[0])
    x64 = torch.cat([x] * reps)[:HEAD_BATCH_LIMIT].contiguous()
    stages[f"K10 mask_head, {HEAD_BATCH_LIMIT} images"] = cuda_ms(
        lambda: mask_head.mask_head(x64, *w, **kw), 10)
    stages[f"canonical head (cuDNN), {HEAD_BATCH_LIMIT} images"] = cuda_ms(
        lambda: model.canonical_head(params, x64.permute(0, 3, 1, 2),
                                     STEM_MODE_2, cfg.compute_dtype), 10)
    for name, ms in stages.items():
        log(f"[2-stem timing] {seconds:.0f} s stage {name}: {ms:.3f} ms")
    del x, x64
    for name, switch in routes.items():
        with switch():
            profile_device(f"one {seconds:.0f} s 2-stem separation, {name} "
                           f"route", run)


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
        files = write_weight_files(workdir)
        phase_stems_cli(workdir, files, device)
        round3_launches = phase_round3(workdir, files, device)
    phase_quality(cli_stems, device)
    phase_stream_quality(device)
    overlap2_launches = phase_overlap2(device)
    phase_timing(device)
    phase_stream_timing(device)
    phase_timing_2stem(device)
    # Each kernel's launches on the path that runs it: the offline CLI for
    # K1-K7, the streaming CLI for K8, the overlap-2 graph for K9, the
    # 2-stem CLI's round-3 route for K10.
    launches.update(irfft4096=stream_launches["irfft4096"],
                    masked_irfft4096=overlap2_launches["masked_irfft4096"],
                    mask_head=round3_launches["mask_head"])
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
