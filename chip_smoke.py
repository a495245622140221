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
   spectrum of one streaming block of 4 streams, the streaming synthesis
   on the same block (with a carry in) and K9 at the 30 s overlap-2
   shapes, all in float32 and each run twice (bit-identical). BS-RoFormer's
   rotary kernel in bfloat16 at a batch-layer of the benchmark cell
   (bsrof-vocals-track300: its time layer, 992 sequences of 801, and its
   band layer, 12,816 of 62), held to rope.rope_qk_error's bound with at
   least 99.9% of values bit-equal, run twice (bit-identical) and timed
   beside its bytes bound and its plain version; then a 300 s BS-RoFormer
   separation at the published widths, which must launch it 2 x depth
   times a batch of chunks and no other hand kernel.
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
   counts of exactly one block step's set (K1, K2, K3 x3, K4, K5, K6, the
   streaming synthesis) per block step; a profile of one block step shows
   no library convolution beyond the mid trunk's and no library FFT.
6. Streaming quality: stream_scan over 4 blocks of the smoke audio, bf16
   and fp32 on the card, against the same scan in fp32 on CPU tensors
   (every kernel's plain version): per-stem SNR >= 42 dB / >= 80 dB.
7. The overlap-2 graph (TransformConfig(overlap=2), hop 2048):
   separate.separate on the 30 s audio launches K2-K6 and K9 and no K1 or
   K7; fp32 kernels against the plain fp32 graph >= 80 dB per stem; the
   2-stem graph at overlap 2 launches K8 once (transform.istft).
8. Streams on one card: block_step_streams (VST config, bf16) for K = 1,
   4 and 16 streams, carrying the state: ms per block, the aggregate
   realtime factor, peak memory, the largest K inside the 5.944 s block
   deadline, a stage breakdown at K = 16 (with torch.fft.irfft beside K8's
   stage, and the streaming synthesis beside its bound, its plain version
   and the chain it replaced: the mask multiply, K8 and the overlap-add in
   torch) and a profile at K = 1 and 16.
9. 2, 3 and 5 stems through the CLI on the 30 s WAV (bf16): 2 stems at the
   CLI's defaults (the reference exe's config: bin_limit 1024, time_step
   512) with random weights, 3 stems from a quantized two-subnet file the
   port's writer makes from seeded nets, 5 stems with random weights.
   Launch counts (2 and 5 stems: K1, K2, K4-K7 once and K3 three times; 3
   stems: K1 and K7 once, K2, K4, K5, K6 twice, K3 six times), the 2-stem
   conservation |vocals + accompaniment - input| <= 1e-5, and per-stem SNR
   against the plain fp32 graph (every wrapper's plain version, the
   canonical cuDNN U-Net): >= 42 dB (bf16 CLI) and >= 80 dB (fp32 kernels).
10. The round-3 route (K2, K3 x2, torch enc4..up5, K10): the 2-stem CLI
   with an npz of a narrow-trunk net (save_npz, seeded), then the standard
   net with model.FORCE_PACKED_UNET = False; launches K1, K2, K3 x2, K10,
   K7 and no K4/K5/K6; a profile shows library convolutions only in
   enc4..up5 (trunk_tail); SNR as in 9.
11. 2-stem separation at 300 s at the exe config on the round-3 route
   (realtime factor), its U-Net stage beside the canonical U-Net, K10
   beside its plain version, K10 and the canonical head at S * B = 64
   images (the round-3 gate's limit), and a profile of the route.
12. The HTTP server (runtime/server.py) started with make_server on port
   0 in a thread on the card (4 stems, VST config, fp32): /healthz;
   /separate on the 30 s WAV as npz and wav8ch (X-Stem-Order), after one
   eager separate.separate of it: the npz request captures the length's
   graph (core/replay.py; its warm-up launches the main path once, K7 runs
   after the graph) and the wav8ch one replays it (K7 its one wrapper
   launch), each mode read from the replay counter; /separate_batch with
   three tracks of 10, 20 and
   30 s, which launches K1 and K7 once; stems >= 80 dB against
   separate.separate per track; 400 (garbage WAV, a stem count the server
   does not hold, a body that is not an NPZ), 413 and 404.
13. The batch graphs on four tracks of 20, 30, 45 and 60 s padded to the
   longest, as the server pads them: separate_nstem_batch at 4 stems (VST
   config), separate_2stem_batch and separate_3stem_batch (exe config),
   in bf16 and fp32; the launch counts of one single-track run for the
   whole batch (K1 and K7 once), per-stem SNR of every track against the
   plain fp32 batch graph (>= 42 dB bf16, >= 80 dB fp32) and the 2-stem
   conservation.
14. The chunked executor: separate_4stem_chunked on 300 s at 8 tiles a
   chunk within 1e-5 of the monolithic separate.separate (fp32 kernels),
   and each path's wall time to stems on the host and peak device memory,
   in fp32 and bf16.
15. Batch timing: separate_nstem_batch (4 stems, VST config, bf16) over B
   = 1, 4, 16 and 32 tracks of 60 s a dispatch (CUDA events after a warm
   call): ms a dispatch, aggregate realtime factor, peak memory; at B =
   16 the same tracks as 16 single-track calls; the peak's growth a track
   and the batch the card would hold by it (extrapolated).
16. Training on the card, on a musdb-layout corpus written from seed 0
   (4 train and 2 holdout tracks of 20 s, vocals, accompaniment and
   mixture; one train track's stems as FLAC from the port's encoder):
   30 bf16 steps at examples/train.py's defaults (2 stems, batch 8, 256 x
   1024, Adam 3e-4, clip 1.0, EMA 0.999) through dataset.batches ->
   train_step, with finite losses, the mean of the last 5 below that of
   the first 5 and no hand-kernel launch; ms a step (CUDA events after 3
   warm steps), audio seconds trained a second, peak memory, the share of
   the bf16 peak and a profile of one step. fp32 gradients at batch 2 on
   the card against CPU tensors (TF32 off, deterministic cuDNN), each leaf
   within 1e-4 of its max |g|; resume (4 steps straight against 2,
   checkpoint.save, restore into a fresh state, 2 more) bit for bit;
   evaluate_si_sdr of the EMA nets on the holdout through the kernels (K1,
   K2, K4-K7 once and K3 three times a track), fp32 within 0.01 dB of the
   plain versions on CPU tensors, bf16 beside it; and train_and_deploy
   (120 fp32 steps, batch 4): SI-SDR rises, the blob round trip within
   1e-5.
17. The device mesh (parallel/*). At world 1, an NCCL group of one rank in
   this process, each entry point beside the port's unsharded graph on the
   card (VST config, bf16): separate_4stem_sharded at 300 s,
   separate_batch_sharded at B = 16 x 60 s, make_stream_fn at K = 16 (a
   block step with the state carried), stream_scan_sharded over 4 blocks,
   separate_4stem_timesharded_padded at 300 s and make_sharded_train_step
   at examples/train.py's defaults (2 stems, B = 8 x 256 x 1024, bf16,
   deterministic cuDNN; loss, params and EMA): the largest difference (or
   "bit for bit"), the launch counts of each call, which must equal the
   unsharded graph's, and ms a call of each by CUDA events. Then two ranks
   spawned on the one card over gloo (NCCL refuses two ranks on one
   device), each held against its own one-process result on the card: the
   time-sharded 4-stem graph at 300 s with data over both ranks (the halo
   exchange; fp32 within 1e-5 of the signal's peak, bf16 per-stem SNR >=
   42 dB), compute_masks_sharded with stems over both ranks (30 s; fp32
   within 1e-5, bf16 >= 42 dB) and the sharded train step with a stem a
   rank (fp32, B = 2: the loss to rtol 1e-5 and each rank's clipped
   gradients within 1e-4 of each leaf's max |g|). A rank that fails fails
   the run. The two-rank times are wall times of two processes sharing
   one card, not scaling numbers.
18. The host modules and the ranked service. The native runtime
   (native/) must build with g++; a 60 s stereo FLAC from io/flac.py's
   encoder decodes bit for bit the same natively and in Python, both
   times printed. Where libmpg123 loads, a 30 s MP3 made in the phase
   (libmp3lame by ctypes, else hand-built frames of silence) goes through
   the 4-stem CLI (VST config, bf16): one 4-stem run's launch counts and
   four finite stems of the decoded length; else "mp3: libmpg123 absent".
   The 300 s 4-stem bf16 separate.separate, a call that replays its
   captured CUDA graph (core/replay.py; the length's first call ran
   eager, its second captured), under StageTimer(sync=...) beside the
   CUDA events of the same call (the difference within the host's enqueue
   time); a profiler_trace of three more replays must name
   stft4096_kernel, enc1_mma_kernel and masked_istft4096_kernel and no FMA
   encoder kernel (bf16 enc1 runs the tensor-core template alone), hold
   each main-path kernel's events of three calls (K1, K2, K4, K5 and K6
   once a call and K3 three times, from one graph launch a call; K7 once,
   the one wrapper launch, after it; a lead-in call before them takes
   the events a trace drops at its start), and the replay counter must
   count every one of those calls a replay;
   dump_spectrogram_pngs of K1's first magnitude tile must write PNGs
   holding its pixels. Then
   /separate_batch over ranks (runtime/server.py with a mesh): at world 1
   over NCCL, phase 12's three tracks (4 stems, VST config, fp32,
   deterministic cuDNN) bit for bit with the single-process service and
   one 4-stem run's launches; two spawned ranks sharing the card over
   gloo, rank 0 serving on port 0 and the other in serve_rank_loop: fp32
   within 1e-5 of each stem's peak and bf16 >= 60 dB against the
   single-process service, and both ranks exit 0 after the stop op code.
   A rank that fails or misses its deadline fails the run.

Phase 2 also runs K1 and K7 with four 30 s tracks folded into their rows
(tracks = 4): against their plain versions, twice bit-identical, and each
track's spectrum, magnitude and audio bit-identical to a launch on that
track alone. It also holds K10 against its plain version in float32 and bfloat16,
per pixel to tail.head_error_bound on x's two halves, at the 2-stem exe
shapes (3 tiles of 256 x 512 x 32) and on the 4-stem VST batch with its
stems folded (S = 4, x = [skip1 | up5] of the plain chain), where it must
also give K6's masks bit for bit. Phase 2's plain chain runs cuDNN's
deterministic algorithms, so its errors repeat from run to run.

This script checks and portbench/ measures: the cells of BENCHMARK.json
(4 stems at 300 s, 64 streams, the 2-stem packed route at 300 s,
BS-RoFormer at 300 s) are timed by python3 -m portbench.run, not here.
What this script times is each kernel alone and the paths no cell runs.

The last three lines are the kernel report (every hand kernel: the ten
ports, the streaming synthesis and the rotary kernel, each with its
launches on the path that runs it, its time beside its plain
version's, the least time the card could take for its work, and a library
call's time where one PyTorch call computes the same function), the
card's nvidia-smi line and the JSON status line. Without a CUDA device
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import io
import json
import math
import os
import queue
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch
import torch.distributed as dist

from portbench import work
from spleeterrt_tpu_torch import cli, cli_stream, kernels, native
from spleeterrt_tpu_torch.config import (
    STEM_MODE_2,
    STEM_MODE_4,
    STEMS_4,
    RoformerConfig,
    SeparatorConfig,
    TransformConfig,
)
from spleeterrt_tpu_torch.core import (
    checkpoint,
    grouped,
    model,
    replay,
    roformer,
    separate,
    train,
    transform,
    weights,
)
from spleeterrt_tpu_torch.data import dataset as stem_data
from spleeterrt_tpu_torch.examples import train_and_deploy
from spleeterrt_tpu_torch.io import audio as audio_io, flac, mp3_fixtures, mpg123
from spleeterrt_tpu_torch.kernels import (
    _build,
    encoder,
    mask_head,
    pallas_fft,
    rope,
    stft_fused,
    stream_synthesis,
    tail,
)
from spleeterrt_tpu_torch.parallel import distributed, timeshard
from spleeterrt_tpu_torch.parallel import mesh as pmesh
from spleeterrt_tpu_torch.runtime import executor, server, stream
from spleeterrt_tpu_torch.utils import timing
from spleeterrt_tpu_torch.utils.metrics import snr_db

SR = 44100
SEED = 0
SMOKE_SECONDS = 30.0
BIN_LIMIT, TIME_STEP = 1536, 256  # the VST config (bench.py:89-94)
TRACK_SECONDS = 300.0  # the stage timer's 4-stem graph and the round-3 route
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
# One streaming block step: analysis (K1), the U-Net, the synthesis.
STREAM_BLOCK_LAUNCHES = {"stft4096": 1, "enc1": 1, "enc_s2": 3, "up4": 1,
                         "up5": 1, "head": 1, "stream_synthesis4096": 1}
# The overlap-2 graph: plain STFT, the U-Net, K9, plain overlap-add.
OVERLAP2_LAUNCHES = {"enc1": 1, "enc_s2": 3, "up4": 1, "up5": 1, "head": 1,
                     "masked_irfft4096": 1}
STREAM_QUALITY_BLOCKS = 4  # 23.8 s of the smoke audio
STREAM_COUNTS = (1, 4, 16)  # concurrent streams timed on one card
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
# The serving path: tracks folded into the kernels' rows.
TRACKS_K1_K7 = 4  # phase 2: four 30 s tracks through K1 and K7 at once
BATCH_SECONDS = (20.0, 30.0, 45.0, 60.0)  # the batch phase's tracks
BATCH_COUNTS = (1, 4, 16, 32)  # tracks of BATCH_TRACK_SECONDS a dispatch
BATCH_TRACK_SECONDS = 60.0
BATCH_SINGLE_AT = 16  # the batch also run as single-track calls
CHUNKED_SECONDS = 300.0  # the executor's track
CHUNK_TILES = 8
CHUNKED_MAX_ERR = 1e-5  # |chunked - monolithic|, fp32 kernels
SERVER_BATCH_SECONDS = (10.0, 20.0, 30.0)  # /separate_batch's three tracks
# BS-RoFormer's rotary kernel against its plain version, in bf16: each value
# within rope.rope_qk_error's bound, and this share of them bit-equal.
ROPE_MIN_BIT_EQUAL = 0.999
ROFORMER_SECONDS = 300.0  # the separation that counts the rotary kernel's launches
RFFT_OPS = work.rfft_flops(4096)  # one real FFT of N = 4096
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
    ("stream_synthesis4096", "stream_synthesis.cu", None),  # ports no TPU kernel
    ("rope_qk", "rope.cu", None),  # ports no TPU kernel
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


def plain_separate(stacked, audio: np.ndarray, cfg, device) -> dict:
    """The 4-stem graph of separate.separate with no hand kernel: each
    stem's canonical U-Net in turn (per_stem_masks, cuDNN convolutions) in
    place of the packed one and, at hop 1024, K1 and K7 by their plain
    versions (torch.fft); at any other hop the plain STFT, K9's plain
    version and the plain overlap-add."""
    x = torch.as_tensor(audio, dtype=torch.float32, device=device)
    n = x.shape[-1]
    tcfg = cfg.transform
    preshift, _ = transform.offline_pad_sizes(n, tcfg)
    padded = transform.pad_offline(x, tcfg).contiguous()
    ob = torch.tensor(separate.OUT_BAND_4, dtype=torch.float32, device=device)
    swin = transform.synthesis_window(tcfg, device=device)
    if tcfg.hop == stft_fused.HOP:
        n_out, n_comp, n_req = separate.frame_counts(padded.shape[-1], cfg)
        spec, mag = stft_fused.stft4096_plain(
            padded, transform.analysis_window(4096, device=device), n_comp,
            n_req, cfg.bin_limit, cfg.time_step,
        )
        masks = per_stem_masks(stacked, mag, STEM_MODE_4, cfg.compute_dtype,
                               cfg.sigmoid)
        stems = stft_fused.masked_istft4096_plain(spec, masks, ob, swin, n_out)
    else:
        spec = transform.stft(padded, tcfg, padded.shape[-1])
        n_frames = spec.shape[-2]
        tiles = separate.spec_to_tiles(spec, cfg).permute(0, 3, 1, 2).contiguous()
        masks = per_stem_masks(stacked, tiles, STEM_MODE_4, cfg.compute_dtype,
                               cfg.sigmoid)  # (S, n_tiles, 2, T, F)
        masks = masks.transpose(1, 2).flatten(2, 3)[:, :, :n_frames].contiguous()
        frames = pallas_fft.masked_irfft4096_plain(spec, masks, ob,
                                                   cfg.bin_limit, swin)
        stems = transform.overlap_add(frames, tcfg)
    return dict(zip(cfg.stem_names, stems[..., preshift : preshift + n]))


def per_stem_masks(stacked, mag, stem_mode=STEM_MODE_4,
                   compute_dtype=torch.float32, sigmoid="exact"):
    """Each stem's canonical net, model.unet_forward_nchw, one after the
    other -> (S, B, 2, T, F): the per-stem formulation, which shares no
    code with core/grouped.py."""
    return torch.stack([
        model.unet_forward_nchw(model.stem_params(stacked, s), mag, stem_mode,
                                compute_dtype, sigmoid)
        for s in range(model.num_stems(stacked))
    ])


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
    n_out, n_comp, n_req = separate.frame_counts(padded.shape[-1], cfg)
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
    synth_args = stream_synthesis_args(audio)
    synth_err = check_stream_synthesis(synth_args)

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
        ("stream_synthesis4096", "4-stream block",
         stream_synthesis.stream_synthesis4096,
         stream_synthesis.stream_synthesis4096_plain, synth_args, synth_err),
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
    del k8_args, k9_args, synth_args

    # cuDNN's transposed convolutions (dgrad) may sum in another order from
    # call to call, which moves the plain chain's outputs and so each
    # error below; its deterministic algorithms make them repeat run to run.
    # They are far slower, so every time is taken with cuDNN's own choice.
    torch.backends.cudnn.deterministic = True
    stacked = with_random_epilogues(random_stacked(device))
    two_stem = two_stem_head_inputs(audio, device)
    timed = collections.defaultdict(list)  # kernel -> its timed calls
    for dtype in (torch.float32, torch.bfloat16):
        calls = unet_calls(stacked, pmag, dtype)
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


def log_enc1(label: str, args, kw, ms: float) -> None:
    """K2's time beside its bound, the fp32 FMA floor (its multiply-adds on
    CUDA cores at 67 TFLOP/s) and cuDNN's convolution 2 -> 16 S alone on
    the magnitude in the compute dtype (stride 2, padding 2: the same
    output size and multiply-adds, but no bias, batch norm or activation
    and one output; a convolution-only yardstick, not a library call for
    K2's function), and in bf16 the tensor-core template's resources."""
    bound = bound_entry([("enc1", args, kw)])
    floor_ms = kernel_work("enc1", args, kw)[1] / peak_ops_per_s(torch.float32) * 1e3
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
    floor_ms = kernel_work("enc_s2", args, kw)[1] / peak_ops_per_s(torch.float32) * 1e3
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
    floor_ms = kernel_work(name, args, kw)[1] / peak_ops_per_s(torch.float32) * 1e3
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
    _, n_comp, n_req = separate.frame_counts(padded.shape[-1], cfg)
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
    if name == "stream_synthesis4096":
        spec2, masks2, _, _, ola_tail = args
        frames = masks2.shape[0] * spec2.numel() // stream_synthesis.N_BINS
        ops = frames * (RFFT_OPS + 2 * stream_synthesis.N_BINS
                        + 2 * stream_synthesis.SYNTH_LEN)
        out = frames * stream_synthesis.HOP * 4 + nbytes(ola_tail)
        return nbytes(*args) + out, ops, torch.float32
    if name == "rope_qk":
        qkvg, rot, heads = args
        rows = qkvg.shape[0] * qkvg.shape[1]
        cols = 2 * heads * 2 * rot.shape[1]  # q and k, read once and written once
        # 4 multiplies and 2 adds a pair, in float32 on the FMA pipes.
        nb = 2 * rows * cols * qkvg.element_size() + nbytes(rot)
        return nb, rows * cols * 3, torch.float32
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


def peak_ops_per_s(dtype: torch.dtype) -> float:
    """The card's published peak rate (portbench.work's) for operands of
    `dtype`: float32 outside the tensor cores, bf16 on them."""
    return work.PEAK_OPS_PER_S[str(dtype).removeprefix("torch.")]


def bound_entry(calls) -> dict:
    """The least time the card could take for the calls' work (ms): the
    larger of their bytes over the memory rate and their operations over
    the peak rate of their operands' type (portbench.work's peaks: NVIDIA
    H100 SXM data sheet, dense rates at 700 W); and whether bytes or
    operations set it."""
    bytes_ms = ops_ms = 0.0
    for name, args, kw in calls:
        nb, ops, dtype = kernel_work(name, args, kw)
        bytes_ms += nb / work.HBM_BYTES_PER_S * 1e3
        ops_ms += ops / peak_ops_per_s(dtype) * 1e3
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


def stream_synthesis_args(audio: torch.Tensor, k: int = 4) -> tuple:
    """The streaming synthesis' arguments in one block of k streams: the
    (k, 2, T, 2049) spectrum of k consecutive blocks of `audio` (the
    analysis window's hop-1024 frames), random masks (seed SEED) below
    BIN_LIMIT, the engine's out-of-band weights and synthesis window, and
    a random carry (seed SEED + 1)."""
    device = audio.device
    ext = torch.stack([audio[:, i * BLOCK_LEN : (i + 1) * BLOCK_LEN + 3072]
                       for i in range(k)])
    wa, ws = stream.window_tensors(1.0, device)
    spec, _ = stft_fused.stft4096_plain(
        ext.reshape(2 * k, -1), wa, TIME_STEP, TIME_STEP, BIN_LIMIT, TIME_STEP)
    gen = torch.Generator(device=device).manual_seed(SEED)
    masks = torch.rand((4, k, 2, TIME_STEP, BIN_LIMIT), generator=gen,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    tail = 0.1 * torch.randn((k, 4, 2, stream.HOP), generator=gen, device=device)
    return (spec.view(k, 2, TIME_STEP, -1), masks,
            torch.tensor(stream.RT_OUT_BAND, device=device), ws, tail)


def stream_block_spectrum(audio: torch.Tensor, k: int = 4) -> torch.Tensor:
    """K8's input in one streaming block of k streams: the masked (k, 4, 2,
    T, 2049) spectrum of stream_synthesis_args' block, under its masks below
    BIN_LIMIT and the engine's out-of-band weights above it."""
    spec, masks, out_band, _, _ = stream_synthesis_args(audio, k)
    return stream_synthesis.masked_spectrum(spec, masks, out_band).contiguous()


def check_stream_synthesis(args) -> float:
    """The streaming synthesis against its plain version, run twice; returns
    the max error over the block and the carry, held to K7_REL_BOUND of
    max(1, max|plain|)."""
    y, tail = stream_synthesis.stream_synthesis4096(*args)
    y2, tail2 = stream_synthesis.stream_synthesis4096(*args)
    py, ptail = stream_synthesis.stream_synthesis4096_plain(*args)
    torch.cuda.synchronize()
    err = max((y - py).abs().max().item(), (tail - ptail).abs().max().item())
    bound = K7_REL_BOUND * max(1.0, py.abs().max().item(), ptail.abs().max().item())
    same = torch.equal(y, y2) and torch.equal(tail, tail2)
    log(f"[stream_synthesis4096] out {tuple(y.shape)} carry {tuple(tail.shape)}: "
        f"max |kernel - plain| = {err:.3e}, bound {bound:.3e}; two runs "
        f"bit-identical: {same}")
    if not err <= bound:
        raise AssertionError("the streaming synthesis disagrees with its plain version")
    if not same:
        raise AssertionError("the streaming synthesis is not deterministic")
    return err


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


def unet_calls(stacked, mag, dtype) -> list[tuple]:
    """The packed 4-stem U-Net's kernel calls at `mag`'s shapes in dataflow
    order, (label, counter, wrapper, plain, args, kwargs), each on the
    outputs of the plain chain before it."""
    stem_mode = STEM_MODE_4

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
    x = model.mid_trunk(stacked, x, skips[3], stem_mode, dtype)
    kw = {"act": model.decoder_act_name(stem_mode)}
    for i in (4, 5):
        args = (skips[6 - i], x, *layer(f"up{i}"))
        calls.append((f"K{i} up{i}", f"up{i}", tail.up_shallow,
                      tail.up_shallow_plain, args, kw))
        x = tail.up_shallow_plain(*args, **kw)
    args = (skips[0], x, *layer("up6"), stacked["up7"]["w"], stacked["up7"]["b"])
    calls.append(("K6 head", "head", tail.head, tail.head_plain, args, kw))
    return calls


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
    _, _, n_req = separate.frame_counts(padded.shape[-1], cfg)
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


def replay_mode(before: dict) -> str:
    """The mode (core/replay.py) of the one separation run since the
    replay counter read `before`."""
    moved = [m for m, c in replay.counts().items() if c != before[m]]
    if len(moved) != 1 or replay.counts()[moved[0]] != before[moved[0]] + 1:
        raise AssertionError(f"not one separation: {before} -> {replay.counts()}")
    return moved[0]


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
    graph; then the 2-stem graph at overlap 2, whose transform.istft
    launches K8 once. Returns the launch counts of both runs."""
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
    net = {k: {f: v[0] for f, v in ly.items()} for k, ly in stacked.items()}
    kernels.reset_launch_counts()
    separate.separate(x, params=net, cfg=exe_config(2, torch.bfloat16, overlap=2),
                      device=device)
    two_stem = kernels.launch_counts()
    log(f"[overlap 2] 2 stems: launches {two_stem}")
    if two_stem["irfft4096"] != 1 or two_stem["masked_irfft4096"]:
        raise AssertionError(f"2-stem overlap-2 launches {two_stem}, expected "
                             f"K8 once and no K9")
    return {name: launches[name] + two_stem[name] for name in launches}


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
    beside its plain version; the streaming synthesis also beside its bound
    and the chain it replaced (the mask multiply, K8, the overlap-add)."""
    k = block.shape[0]
    dev = block.device
    wa, ws = stream.window_tensors(1.0, dev)
    uw = torch.tensor(stream.RT_OUT_BAND, device=dev)
    ext = torch.cat([state.in_tail, block], dim=-1).reshape(2 * k, -1)
    k1_args = (ext, wa, TIME_STEP, TIME_STEP, BIN_LIMIT, TIME_STEP)
    synth_args = (state.spec2, state.masks2, uw, ws, state.ola_tail)
    masked = stream_synthesis.masked_spectrum(state.spec2, state.masks2, uw)
    frames = pallas_fft.irfft4096(masked)

    def chain():
        frames = pallas_fft.irfft4096(
            stream_synthesis.masked_spectrum(state.spec2, state.masks2, uw))
        return stream_synthesis.synthesize(frames, state.ola_tail, ws)

    synth_ms = cuda_ms(lambda: stream_synthesis.stream_synthesis4096(*synth_args), 10)
    bound = bound_entry([("stream_synthesis4096", synth_args, {})])
    attrs = stream_synthesis.stream_synthesis4096_attrs(dev)
    log(f"[streams] K = {k} stream_synthesis4096: {synth_ms:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
        f"{100 * bound['bound_ms'] / synth_ms:.1f}% of it; run "
        f"{stream_synthesis.SYNTH_RUN_HOPS} hops, {resources(attrs)}")
    stages = {
        "stream_synthesis4096": synth_ms,
        "stream_synthesis4096 plain": cuda_ms(
            lambda: stream_synthesis.stream_synthesis4096_plain(*synth_args), 5, 1),
        "mask multiply + K8 + overlap-add (the chain it replaced)": cuda_ms(chain, 10),
        "K1 stft4096": cuda_ms(lambda: stft_fused.stft4096(*k1_args), 10),
        "K1 plain": cuda_ms(lambda: stft_fused.stft4096_plain(*k1_args), 10),
        "U-Net x4 stems, packed (K2-K6 + mid trunk)": cuda_ms(
            lambda: model.multi_stem_masks(stacked, state.mag1, STEM_MODE_4,
                                           cfg.compute_dtype, cfg.sigmoid), 5, 1),
        "mask multiply (torch)": cuda_ms(
            lambda: stream_synthesis.masked_spectrum(state.spec2, state.masks2, uw), 10),
        "K8 irfft4096": cuda_ms(lambda: pallas_fft.irfft4096(masked), 10),
        "K8 plain": cuda_ms(lambda: pallas_fft.irfft4096_plain(masked), 5, 1),
        "torch.fft.irfft (cuFFT alone)": cuda_ms(
            lambda: torch.fft.irfft(masked, n=4096), 10),
        "tails + overlap-add (torch)": cuda_ms(
            lambda: stream_synthesis.synthesize(frames, state.ola_tail, ws), 10),
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
    canonical route with each stem's net in turn (per_stem_masks, cuDNN),
    as phase 4's plain path is for 4 stems."""
    patches = [
        (stft_fused, "stft4096", stft_fused.stft4096_plain),
        (stft_fused, "masked_istft4096", stft_fused.masked_istft4096_plain),
        (pallas_fft, "irfft4096", pallas_fft.irfft4096_plain),
        (pallas_fft, "masked_irfft4096", pallas_fft.masked_irfft4096_plain),
        (model, "FORCE_PACKED_UNET", False),
        (model, "FORCE_PALLAS_HEAD", False),
        (model, "FORCE_PALLAS_ENCODER", False),
        (model, "multi_stem_masks_canonical", per_stem_masks),
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
    the grouped enc4..up5 (grouped.trunk_tail) alone, on inputs of the same
    shapes and layouts as the K3 outputs it reads, and no more."""
    padded = transform.pad_offline(torch.from_numpy(x).to(device),
                                   cfg.transform).contiguous()
    graph = library_conv_kernels(lambda: separate.separate_2stem(params, padded, cfg))
    _, _, n_req = separate.frame_counts(padded.shape[-1], cfg)
    nt, t, f = n_req // cfg.time_step, cfg.time_step, cfg.bin_limit
    front = lambda c, d: grouped.to_grouped(torch.zeros(
        (nt, t // d, f // d, c), dtype=cfg.compute_dtype, device=device), 1)
    skips = [front(16, 2), front(32, 4), front(64, 8)]
    tail_only = library_conv_kernels(lambda: grouped.trunk_tail(
        model.with_stem_axis(params), front(64, 8), skips, 1, STEM_MODE_2,
        cfg.compute_dtype))
    log(f"[{tag}] library convolution launches: graph {sum(graph.values())}, "
        f"grouped enc4..up5 alone {sum(tail_only.values())}")
    if not tail_only or graph != tail_only:
        raise AssertionError(f"{tag}: library convolutions outside enc4..up5: "
                             f"graph {dict(graph)}, enc4..up5 {dict(tail_only)}")


def phase_timing_2stem(device) -> None:
    """separate_2stem at TRACK_SECONDS at the exe config on the round-3
    route (bf16, the CLI's random 2-stem net), its U-Net stage beside the
    canonical U-Net, K10 beside its plain version, and K10 against the
    canonical head at HEAD_BATCH_LIMIT images. The packed route is the
    benchmark's exe2-track300 cell."""
    cfg = exe_config(2, torch.bfloat16)
    params = cli.load_weights(None, True, SEED, cfg, device)["params"]
    seconds = TRACK_SECONDS
    rng = np.random.default_rng(SEED)
    audio = torch.as_tensor(rng.standard_normal((2, int(seconds * SR))) * 0.3,
                            dtype=torch.float32, device=device)
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    _, n_comp, n_req = separate.frame_counts(padded.shape[-1], cfg)
    _, mag = stft_fused.stft4096(
        padded, transform.analysis_window(4096, device=device), n_comp, n_req,
        cfg.bin_limit, cfg.time_step)
    run = lambda: separate.separate_2stem(params, padded, cfg)
    with packed_unet_off():
        run()  # warm up
        ms = min(cuda_ms(run, iters=3, warmup=0) for _ in range(3))
        log(f"[2-stem timing] {seconds:.0f} s, round 3 route: {ms:.3f} ms per "
            f"separate_2stem, {seconds / (ms / 1e3):.2f}x realtime")
        profile_device(f"one {seconds:.0f} s 2-stem separation, round 3 route", run)
        stages = {"U-Net, round 3 (K2, K3 x2, torch enc4..up5, K10)": cuda_ms(
            lambda: separate.single_net_masks(params, mag, cfg, STEM_MODE_2), 5, 1)}
    one = model.with_stem_axis(params)
    stages["U-Net, canonical (cuDNN)"] = cuda_ms(
        lambda: model.multi_stem_masks_canonical(one, mag, STEM_MODE_2,
                                                 cfg.compute_dtype), 5, 1)
    x = model.multi_stem_trunk(one, mag, STEM_MODE_2, cfg.compute_dtype)
    ly6, ly7 = one["up6"], one["up7"]
    w = (ly6["w"], ly6["b"], ly6["bn_scale"], ly6["bn_shift"], ly7["w"], ly7["b"])
    kw = {"act": model.decoder_act_name(STEM_MODE_2)}
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


# ---------------------------------------------------------------------------
# The serving path: K1/K7 over a batch of tracks, the batch graphs, the
# chunked executor and the HTTP server
# ---------------------------------------------------------------------------


def phase_roformer(device) -> tuple[dict, int]:
    """BS-RoFormer's rotary kernel at the shapes of a batch-layer of the
    benchmark's cell (16 chunks of 801 frames by 62 bands, 794,592 rows of
    the `to_qkvg` product: the time layer's 992 sequences of 801 and the
    band layer's 12,816 of 62), each against its plain version and timed
    beside its bound; then one 300 s separation at the published widths,
    which must launch it 2 x depth times a batch of chunks and nothing
    else. Returns (the time layer's report entry, the separation's
    launches)."""
    t0 = time.perf_counter()
    cfg = RoformerConfig()
    heads, width = cfg.heads, 3 * cfg.heads * cfg.dim_head + cfg.heads
    frames, bands = cfg.chunk // cfg.hop + 1, len(cfg.freqs_per_bands)
    entries = []
    for label, n, length in (("time layer", cfg.batch * bands, frames),
                             ("band layer", cfg.batch * frames, bands)):
        gen = torch.Generator(device=device).manual_seed(SEED + length)
        qkvg = torch.randn((n, length, width), generator=gen, device=device).to(torch.bfloat16)
        args = (qkvg, roformer.rotary(length, cfg, device), heads)
        got, want = rope.rope_qk(*args), rope.rope_qk_plain(*args)
        worst, equal = rope.rope_qk_error(got, want, *args)
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, rope.rope_qk(*args))
        del got, want
        log(f"[rope_qk] {label} ({n}, {length}, {width}) bf16: max |kernel - plain| = "
            f"{err:.3e}, largest error / bound {worst:.3e}, bit-equal {100 * equal:.4f}%; "
            f"two runs bit-identical: {same}")
        if not (worst <= 1 and equal >= ROPE_MIN_BIT_EQUAL):
            raise AssertionError(f"rope_qk ({label}) disagrees with its plain version")
        if not same:
            raise AssertionError("rope_qk is not deterministic")
        ms = cuda_ms(lambda: rope.rope_qk(*args))
        plain_ms = cuda_ms(lambda: rope.rope_qk_plain(*args), 5, 1)
        bound = bound_entry([("rope_qk", args, {})])
        log(f"[rope_qk] {label}: kernel {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}), share {100 * bound['bound_ms'] / ms:.1f}%; plain "
            f"(float32 copy, complex product, cast) {plain_ms:.4f} ms")
        entries.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
                        "library_ms": None})
        del args, qkvg

    params = roformer.init_params(cfg, torch.Generator(device).manual_seed(SEED), device)
    track = torch.from_numpy(synthetic_audio(ROFORMER_SECONDS)).to(device)
    batches = -(-roformer.num_chunks(track.shape[-1], cfg) // cfg.batch)
    want = {**dict.fromkeys(kernels.KERNELS, 0), "rope_qk": 2 * cfg.depth * batches}
    kernels.reset_launch_counts()
    stems = separate.separate(track, params=params, cfg=cfg, device=device)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    finite = all(bool(torch.isfinite(y).all()) for y in stems.values())
    log(f"[rope_qk] BS-RoFormer {ROFORMER_SECONDS:.0f} s, {batches} batches of "
        f"{cfg.batch} chunks: launches {launches['rope_qk']} (want 2 x {cfg.depth} x "
        f"{batches}); stems {sorted(stems)} finite: {finite}")
    if launches != want:
        raise AssertionError(f"BS-RoFormer launched {launches}, want {want}")
    if not finite:
        raise AssertionError("BS-RoFormer's stems are not finite")
    log(f"[rope_qk] phase done in {time.perf_counter() - t0:.3f} s")
    return entries[0], launches["rope_qk"]


def phase_kernels_tracks(cfg, device) -> None:
    """K1 and K7 with TRACKS_K1_K7 30 s tracks folded into their rows (VST
    config) against their plain versions, each run twice (bit-identical),
    and each track's spectrum, magnitude images and audio bit-identical to
    a launch on that track alone."""
    b = TRACKS_K1_K7
    audio = torch.stack([torch.from_numpy(synthetic_audio(SMOKE_SECONDS, SEED + i))
                         for i in range(b)]).to(device)
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    rows = padded.reshape(2 * b, -1)
    n_out, n_comp, n_req = separate.frame_counts(padded.shape[-1], cfg)
    nt = n_req // cfg.time_step
    awin = transform.analysis_window(4096, device=device)
    swin = transform.synthesis_window(cfg.transform, device=device)
    k1_args = (rows, awin, n_comp, n_req, cfg.bin_limit, cfg.time_step, b)
    spec, mag = stft_fused.stft4096(*k1_args)
    again = stft_fused.stft4096(*k1_args)
    pspec, pmag = stft_fused.stft4096_plain(*k1_args)
    torch.cuda.synchronize()
    err = max((spec - pspec).abs().max().item(), (mag - pmag).abs().max().item())
    bound = K1_REL_BOUND * pspec.abs().max().item()
    same = torch.equal(spec, again[0]) and torch.equal(mag, again[1])
    log(f"[K1 stft4096, {b} tracks] spec {tuple(spec.shape)} mag {tuple(mag.shape)}: "
        f"max |kernel - plain| = {err:.3e}, bound {bound:.3e}; two runs "
        f"bit-identical: {same}")
    if not (err <= bound and same):
        raise AssertionError(f"K1 with {b} tracks disagrees or is not deterministic")
    del again, pmag
    gen = torch.Generator(device=device).manual_seed(SEED)
    masks = torch.rand((4, b * nt, 2, cfg.time_step, cfg.bin_limit), generator=gen,
                       device=device)
    ob = torch.tensor(separate.OUT_BAND_4, device=device)
    k7_args = (pspec, masks, ob, swin, n_out, b)
    check_inverse(f"K7 masked_istft4096, {b} tracks", stft_fused.masked_istft4096,
                  stft_fused.masked_istft4096_plain, k7_args)
    y = stft_fused.masked_istft4096(*k7_args)
    for i in range(b):
        r, img = slice(2 * i, 2 * i + 2), slice(i * nt, (i + 1) * nt)
        spec1, mag1 = stft_fused.stft4096(rows[r].contiguous(), *k1_args[1:6])
        y1 = stft_fused.masked_istft4096(pspec[r].contiguous(),
                                         masks[:, img].contiguous(), ob, swin, n_out)
        if not (torch.equal(spec[r], spec1) and torch.equal(mag[img], mag1)
                and torch.equal(y[:, r], y1)):
            raise AssertionError(f"K1/K7 track {i} differs from its lone launch")
    log(f"[K1/K7, {b} tracks] each track's spectrum, magnitude and audio "
        f"bit-identical to its lone launch: True")


def padded_batch(xs: list[np.ndarray], cfg, device) -> tuple[torch.Tensor, int]:
    """(2, n) tracks zero-padded to the longest, as the server pads them,
    then pre-padded (transform.pad_offline) on `device` -> (the (B, 2,
    data_size) batch, preshift)."""
    n_max = max(x.shape[1] for x in xs)
    batch = np.stack([np.pad(x, ((0, 0), (0, n_max - x.shape[1]))) for x in xs])
    padded = transform.pad_offline(torch.from_numpy(batch).to(device), cfg.transform)
    return padded.contiguous(), transform.offline_pad_sizes(n_max, cfg.transform)[0]


def counted_run(tag: str, fn, per_run: dict):
    """fn() with the launch counts set to 0 just before and read just
    after; they must be per_run's."""
    kernels.reset_launch_counts()
    out = fn()
    launches = kernels.launch_counts()
    log(f"[{tag}] launches {launches}")
    if launches != expected_launches(per_run):
        raise AssertionError(f"{tag}: launches {launches}, expected {per_run}")
    return out


def check_batch_snr(tag: str, xs, preshift: int, names, got: dict, plain) -> None:
    """Per-stem SNR of each track's stems ({label: (B, S, 2, L) on the
    card}) against the plain fp32 graph's, cropped to each track."""
    bars = {"bf16": SNR_BF16_MIN_DB, "fp32": SNR_FP32_MIN_DB}
    worst = {k: float("inf") for k in got}
    for i, x in enumerate(xs):
        crop = slice(preshift, preshift + x.shape[1])
        for s, stem in enumerate(names):
            ref = plain[i, s, :, crop].cpu().numpy()
            for label, out in got.items():
                db = snr_db(out[i, s, :, crop].cpu().numpy(), ref)
                worst[label] = min(worst[label], db)
                if not db >= bars[label]:
                    raise AssertionError(f"{tag} track {i} {stem}: {label} SNR "
                                         f"{db:.2f} dB below {bars[label]}")
    log(f"[{tag}] per-stem SNR of {len(xs)} tracks vs the plain fp32 graph: "
        + ", ".join(f"{k} kernels >= {v:.2f} dB (bar {bars[k]})"
                    for k, v in worst.items()))


def batch_segments(seconds) -> list[np.ndarray]:
    """Tracks of the given lengths cut at different offsets out of the
    seed-SEED signal every other phase separates: each its own content,
    and the bf16 bar means what it means there (with random weights, the
    bf16 SNR of a stem depends on the content; PERF.md, Findings)."""
    step = 5 * SR  # track i starts i * 5 s in
    x = synthetic_audio(max(seconds) + 5 * len(seconds))
    return [x[:, i * step : i * step + int(sec * SR)] for i, sec in enumerate(seconds)]


def phase_batch(device) -> None:
    """The batch graphs on tracks of BATCH_SECONDS padded to the longest:
    separate_nstem_batch at 4 stems (VST config), separate_2stem_batch and
    separate_3stem_batch (exe config), bf16 and fp32, each with its launch
    counts for the whole batch and per-stem SNR of every track against the
    plain fp32 batch graph; the 2-stem conservation."""
    xs = batch_segments(BATCH_SECONDS)
    stacked = random_stacked(device)
    nets3 = cli.load_weights(None, True, SEED, exe_config(3, torch.float32), device)
    params2 = cli.load_weights(None, True, SEED, exe_config(2, torch.float32),
                               device)["params"]
    graphs = (
        ("batch 4 stems", vst_config, MAIN_PATH_LAUNCHES, lambda b, cfg: (
            separate.separate_nstem_batch(stacked, b, cfg, separate.OUT_BAND_4))),
        ("batch 2 stems", lambda d: exe_config(2, d), MAIN_PATH_LAUNCHES,
         lambda b, cfg: separate.separate_2stem_batch(params2, b, cfg)),
        ("batch 3 stems", lambda d: exe_config(3, d), THREE_STEM_LAUNCHES,
         lambda b, cfg: separate.separate_3stem_batch(
             nets3["params4"], nets3["params2"], b, cfg)),
    )
    for tag, config, per_run, graph in graphs:
        cfg32 = config(torch.float32)
        batch, preshift = padded_batch(xs, cfg32, device)
        got = {}
        for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            cfg = config(dtype)
            got[label] = counted_run(f"{tag}, {len(xs)} tracks, {label}",
                                     lambda: graph(batch, cfg), per_run)
            if not torch.all(torch.isfinite(got[label])):
                raise AssertionError(f"{tag} {label}: non-finite stems")
        with plain_graph():
            plain = graph(batch, cfg32)
        check_batch_snr(tag, xs, preshift, cfg32.stem_names, got, plain)
        # Each track against its own single-track run on the same padded
        # input: the fold of tracks into rows and images changes nothing
        # but the mid trunk's cuDNN algorithms.
        for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            bar = SNR_BF16_MIN_DB if label == "bf16" else SNR_FP32_MIN_DB
            worst = float("inf")
            for i, x in enumerate(xs):
                one = graph(batch[i : i + 1], config(dtype))[0]
                crop = slice(preshift, preshift + x.shape[1])
                worst = min(worst, min(
                    snr_db(got[label][i, s, :, crop].cpu().numpy(),
                           one[s, :, crop].cpu().numpy())
                    for s in range(one.shape[0])))
            log(f"[{tag}] {label}: every track against its own single-track "
                f"run >= {worst:.2f} dB (bar {bar})")
            if not worst >= bar:
                raise AssertionError(f"{tag} {label}: a track differs from its "
                                     f"single-track run")
        if tag == "batch 2 stems":
            err = max((got["bf16"][i].sum(0)[:, preshift : preshift + x.shape[1]]
                       - torch.from_numpy(x).to(device)).abs().max().item()
                      for i, x in enumerate(xs))
            log(f"[{tag}] conservation max |vocals + accompaniment - input| = "
                f"{err:.3e} (<= {CONSERVATION_MAX})")
            if not err <= CONSERVATION_MAX:
                raise AssertionError("batch 2 stems: vocals + accompaniment != input")
        del got, plain, batch


def phase_batch_timing(device) -> None:
    """separate_nstem_batch at 4 stems (VST config, bf16) over B tracks of
    BATCH_TRACK_SECONDS for each B of BATCH_COUNTS: ms a dispatch (CUDA
    events, best of three after a warm call), the aggregate realtime
    factor and peak device memory; at B = BATCH_SINGLE_AT the same tracks
    as single-track calls."""
    cfg = vst_config(torch.bfloat16)
    stacked = random_stacked(device)
    n = int(BATCH_TRACK_SECONDS * SR)
    gen = torch.Generator(device=device).manual_seed(SEED)
    peaks = {}
    for b in BATCH_COUNTS:
        audio = torch.randn((b, 2, n), generator=gen, device=device) * 0.3
        padded = transform.pad_offline(audio, cfg.transform).contiguous()
        del audio
        run = lambda: separate.separate_nstem_batch(stacked, padded, cfg,
                                                    separate.OUT_BAND_4)
        run()  # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        run()
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated(device)
        ms = min(cuda_ms(run, iters=3, warmup=0) for _ in range(3))
        log(f"[batch timing] B = {b} x {BATCH_TRACK_SECONDS:.0f} s: {ms:.3f} ms a "
            f"dispatch, aggregate {b * BATCH_TRACK_SECONDS / (ms / 1e3):.2f}x "
            f"realtime, peak memory {peaks[b] / 2**30:.3f} GiB")
        if b == BATCH_SINGLE_AT:
            singles = lambda: [separate.separate_4stem(stacked, padded[i], cfg)
                               for i in range(b)]
            one_ms = min(cuda_ms(singles, iters=2, warmup=1) for _ in range(2))
            log(f"[batch timing] the same {b} tracks as {b} single-track calls: "
                f"{one_ms:.3f} ms, aggregate "
                f"{b * BATCH_TRACK_SECONDS / (one_ms / 1e3):.2f}x realtime; "
                f"batch / singles {ms / one_ms:.3f}")
        del padded
        torch.cuda.empty_cache()
    lo, hi = BATCH_COUNTS[-2], BATCH_COUNTS[-1]
    per_track = (peaks[hi] - peaks[lo]) / (hi - lo)
    total = torch.cuda.get_device_properties(device).total_memory
    fits = int(lo + (total - peaks[lo]) // per_track) if per_track > 0 else None
    log(f"[batch timing] peak memory grows {per_track / 2**30:.4f} GiB a "
        f"{BATCH_TRACK_SECONDS:.0f} s track (B = {lo} to {hi}); the "
        f"{total / 2**30:.1f} GiB card would hold B = {fits} by that slope "
        f"(extrapolated, not run)")


def phase_executor(device) -> None:
    """separate_4stem_chunked on CHUNKED_SECONDS at CHUNK_TILES (VST
    config): fp32 kernels within CHUNKED_MAX_ERR of the monolithic
    separate.separate; each path's wall time to stems on the host and its
    peak device memory, in fp32 and bf16."""
    stacked = random_stacked(device)
    rng = np.random.default_rng(SEED)
    x = (rng.standard_normal((2, int(CHUNKED_SECONDS * SR))) * 0.3).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = vst_config(dtype)
        paths = {
            "chunked": lambda: executor.separate_4stem_chunked(
                stacked, x, cfg, chunk_tiles=CHUNK_TILES),
            "monolithic": lambda: np.stack([v.cpu().numpy() for v in separate.separate(
                x, stacked_params=stacked, cfg=cfg, device=device).values()]),
        }
        outs = {}
        for name, fn in paths.items():
            fn()  # warm up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            outs[name] = fn()
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(device)
            log(f"[executor] {CHUNKED_SECONDS:.0f} s, {str(dtype)[6:]}, {name}"
                f"{f' ({CHUNK_TILES} tiles a chunk)' * (name == 'chunked')}: "
                f"{wall:.3f} ms to stems on the host, peak memory "
                f"{peak / 2**30:.3f} GiB")
        err = float(np.abs(outs["chunked"] - outs["monolithic"]).max())
        log(f"[executor] {str(dtype)[6:]}: max |chunked - monolithic| = {err:.3e}"
            + f" (<= {CHUNKED_MAX_ERR})" * (dtype == torch.float32))
        if outs["chunked"].shape != (4, *x.shape) or not np.all(
                np.isfinite(outs["chunked"])):
            raise AssertionError("executor: wrong shape or non-finite stems")
        if dtype == torch.float32 and not err <= CHUNKED_MAX_ERR:
            raise AssertionError("executor: chunked and monolithic disagree")


def http(url: str, data: bytes | None = None) -> tuple[int, dict, bytes]:
    """GET (data None) or POST -> (status, headers, body), HTTP errors too."""
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def phase_server(workdir: str, device) -> None:
    """make_server on port 0 in a thread, on the card (4 stems, VST config,
    fp32 so that its stems are held to SNR_FP32_MIN_DB against
    separate.separate): /healthz; /separate as npz (a capture) and wav8ch
    (a replay) on the 30 s WAV; /separate_batch with three tracks, one K1
    and one K7 launch; 400, 413 and 404."""
    cfg = vst_config(torch.float32)
    stacked = random_stacked(device)
    service = server.SeparationService(cfg, {"stacked_params": stacked},
                                       device=device)
    srv = server.make_server("127.0.0.1", 0, service)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, _, body = http(f"{base}/healthz")
        health = json.loads(body)
        log(f"[server] /healthz {code} {health}")
        if code != 200 or health != {"status": "ok",
                                     "devices": torch.cuda.device_count()}:
            raise AssertionError("server: /healthz")

        x = synthetic_audio(SMOKE_SECONDS)
        song = os.path.join(workdir, "server.wav")
        audio_io.write_wav(song, x)
        with open(song, "rb") as f:
            wav = f.read()
        before = replay.counts()
        solo = {k: v.cpu().numpy() for k, v in separate.separate(
            x, stacked_params=stacked, cfg=cfg, device=device).items()}
        if replay_mode(before) != "eager":
            raise AssertionError(f"server: the length's first call ran {replay_mode(before)}")
        # The length's second call captures its graph: the capture's warm-up
        # launches K1-K6 once through their wrappers, the captured and
        # replayed launches count nothing, and K7 runs after the graph.
        kernels.reset_launch_counts()
        before = replay.counts()
        t0 = time.perf_counter()
        code, _, body = http(f"{base}/separate?format=npz", wav)
        wall = (time.perf_counter() - t0) * 1e3
        launches, mode = kernels.launch_counts(), replay_mode(before)
        if (code != 200 or mode != "capture"
                or launches != expected_launches(MAIN_PATH_LAUNCHES)):
            raise AssertionError(f"server /separate: {code}, {mode}, launches {launches}")
        out = np.load(io.BytesIO(body))
        worst = min(snr_db(out[k], solo[k]) for k in cfg.stem_names)
        log(f"[server] /separate npz {code} in {wall:.3f} ms "
            f"({SMOKE_SECONDS:.0f} s, 4 stems), a {mode} (separate.separate "
            f"ran the length eager before it), launches {launches}; SNR vs "
            f"separate.separate >= {worst:.2f} dB")
        if set(out.files) != set(cfg.stem_names) or not worst >= SNR_FP32_MIN_DB:
            raise AssertionError("server /separate: stems")
        # Another request replays the graph: K7, after it, is its one
        # wrapper launch. cuDNN's transposed convolutions in the mid trunk
        # need not sum in the same order twice, so compare by SNR.
        kernels.reset_launch_counts()
        before = replay.counts()
        code, headers, body = http(f"{base}/separate", wav)
        launches, mode = kernels.launch_counts(), replay_mode(before)
        y = audio_io.read_wav(body).samples
        order = headers.get("X-Stem-Order")
        worst = min(snr_db(y[2 * s : 2 * s + 2], solo[k])
                    for s, k in enumerate(cfg.stem_names))
        log(f"[server] /separate wav8ch {code}, {y.shape[0]} channels, "
            f"X-Stem-Order {order}, a {mode}, launches {launches}; SNR vs "
            f"separate.separate >= {worst:.2f} dB")
        if mode != "replay" or launches != expected_launches({"masked_istft4096": 1}):
            raise AssertionError(f"server /separate wav8ch: {mode}, launches {launches}")
        if (code != 200 or order != ",".join(cfg.stem_names)
                or y.shape != (8, x.shape[1]) or not worst >= SNR_FP32_MIN_DB):
            raise AssertionError("server /separate wav8ch")

        xs = {f"t{i}": synthetic_audio(sec, SEED + 10 + i)
              for i, sec in enumerate(SERVER_BATCH_SECONDS)}
        buf = io.BytesIO()
        np.savez(buf, **xs)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        code, _, body = http(f"{base}/separate_batch", buf.getvalue())
        wall = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        if code != 200 or launches != expected_launches(MAIN_PATH_LAUNCHES):
            raise AssertionError(f"server /separate_batch: {code}, launches {launches}")
        out = np.load(io.BytesIO(body))
        worst = float("inf")
        for name, xt in xs.items():
            one = separate.separate(xt, stacked_params=stacked, cfg=cfg, device=device)
            for stem, ref in one.items():
                got = out[f"{name}/{stem}"]
                if got.shape != xt.shape:
                    raise AssertionError(f"server batch {name}/{stem}: {got.shape}")
                worst = min(worst, snr_db(got, ref.cpu().numpy()))
        log(f"[server] /separate_batch {code}, {len(xs)} tracks of "
            f"{SERVER_BATCH_SECONDS} s in {wall:.3f} ms, launches {launches}; "
            f"SNR vs separate.separate per track >= {worst:.2f} dB")
        if not worst >= SNR_FP32_MIN_DB:
            raise AssertionError("server /separate_batch: stems")

        errors = {
            "garbage WAV": (http(f"{base}/separate", b"not a wav")[0], 400),
            "bad stems": (http(f"{base}/separate?stems=2", wav)[0], 400),
            "stems not a number": (http(f"{base}/separate?stems=x", wav)[0], 400),
            "bad NPZ": (http(f"{base}/separate_batch", b"PK\x03\x04junk")[0], 400),
            "unknown path": (http(f"{base}/nowhere", wav)[0], 404),
        }
        service.max_body_bytes = 1024
        errors["oversized body"] = (http(f"{base}/separate", b"\0" * 2048)[0], 413)
        log(f"[server] error contract: " + ", ".join(
            f"{k} {got} (expected {want})" for k, (got, want) in errors.items()))
        if any(got != want for got, want in errors.values()):
            raise AssertionError("server: error contract")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)


# ---------------------------------------------------------------------------
# Training: the stem dataset, full-width train steps, card gradients against
# the CPU, resume, held-out SI-SDR through the kernels, train and deploy
# ---------------------------------------------------------------------------

TRAIN_STEMS = ("vocals", "accompaniment")
TRAIN_TRACKS, HOLDOUT_TRACKS = 4, 2
TRAIN_TRACK_SECONDS = 20.0
# examples/train.py's defaults: 2 stems, bin_limit 1024, time_step 256,
# batch 8, bf16, Adam 3e-4 after a clip to global norm 1, EMA 0.999.
TRAIN_TIME_STEP = 256
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARM = 8, 30, 3
TRAIN_LR, TRAIN_EMA = 3e-4, 0.999
CHECK_BATCH = 2  # the gradient and resume checks (fp32)
# Card vs CPU gradients in fp32 (TF32 off, deterministic cuDNN): the same
# products summed in another order through twelve layers; the CPU tests
# measure 4.4e-6 of a leaf's max |g| between torch and XLA.
TRAIN_GRAD_REL_BOUND = 1e-4
SI_SDR_MAX_DB = 0.01  # card (kernels) vs CPU (plain versions), fp32
DEPLOY_STEPS, DEPLOY_BATCH = 120, 4  # train_and_deploy's defaults


def train_config(compute_dtype) -> SeparatorConfig:
    return SeparatorConfig(bin_limit=EXE_BIN_LIMIT, time_step=TRAIN_TIME_STEP,
                           num_stems=len(TRAIN_STEMS),
                           compute_dtype=compute_dtype)


def unet_forward_flops(t: int, f: int) -> float:
    """Multiply-adds x 2 of one U-Net forward over a T x F tile: each 5 x 5
    stride-2 conv at its output size, each transposed conv at its input
    size, and the 4 x 4 final conv."""
    macs = 0
    for i, (cin, cout) in enumerate(model.ENCODER_CHANNELS, start=1):
        macs += (t >> i) * (f >> i) * cin * cout * 25
    for i, (cin, cout) in enumerate(model.DECODER_CHANNELS, start=1):
        macs += (t >> (7 - i)) * (f >> (7 - i)) * cin * cout * 25
    cin, cout = model.FINAL_CHANNELS
    return 2.0 * (macs + t * f * cin * cout * 16)


def write_stem_corpus(root: str) -> None:
    """A musdb-layout corpus from seed SEED: train/ and test/ tracks of
    TRAIN_TRACK_SECONDS with a vocal-like stem (a harmonic tone with
    vibrato), an accompaniment (noise and two low tones) and their mixture,
    as WAV; the first train track's stems as FLAC (the port's encoder), so
    its crops come through the decoded cache. The stems hold their level,
    so the loss of a batch moves with the nets more than with its crops."""
    rng = np.random.default_rng(SEED)
    n = int(TRAIN_TRACK_SECONDS * SR)
    t = np.arange(n) / SR
    for split, count in (("train", TRAIN_TRACKS), ("test", HOLDOUT_TRACKS)):
        for k in range(count):
            d = os.path.join(root, split, f"track{k}")
            os.makedirs(d)
            f0 = rng.uniform(150.0, 400.0) * (
                1.0 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t))
            phase = 2 * np.pi * np.cumsum(f0) / SR
            voice = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
            acc = 0.1 * rng.standard_normal((2, n))
            for f1 in rng.uniform(50.0, 220.0, 2):
                acc += 0.05 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 2 * np.pi))
            stems = {"vocals": np.stack([voice, 0.8 * voice]), "accompaniment": acc}
            for name, x in stems.items():
                x = x.astype(np.float32)
                if split == "train" and k == 0:
                    with open(os.path.join(d, f"{name}.flac"), "wb") as fh:
                        fh.write(flac.encode_flac(x))
                else:
                    audio_io.write_wav(os.path.join(d, f"{name}.wav"), x)
            audio_io.write_wav(os.path.join(d, "mixture.wav"),
                               sum(stems.values()).astype(np.float32))


def training_nets(seed: int, device):
    """Random stacked nets for TRAIN_STEMS (seeds seed, seed + 1)."""
    nets = [model.init_params(torch.Generator().manual_seed(seed + i))
            for i in range(len(TRAIN_STEMS))]
    return weights.params_to(weights.stack_params(nets), device)


def loss_and_grads(stacked, batch, cfg):
    p = train.trainable(stacked)
    mix, tgt, active = batch
    loss = train.separation_loss(p, mix, tgt, STEM_MODE_4, cfg.compute_dtype,
                                 active)
    loss.backward()
    return float(loss.detach()), [g.grad for g in train.param_leaves(p)]


def phase_train_steps(train_set, device, smi: str):
    """30 full-width bf16 steps at examples/train.py's defaults through
    dataset.batches -> train_step; returns the state."""
    cfg = train_config(torch.bfloat16)
    state = train.init_train_state(training_nets(SEED, device), TRAIN_LR, ema=True)
    step = train.make_train_step(STEM_MODE_4, cfg.compute_dtype, TRAIN_EMA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    losses, events = [], []
    t0 = time.perf_counter()
    for batch in stem_data.batches(train_set, cfg, TRAIN_BATCH, seed=SEED,
                                   steps=TRAIN_STEPS, device=device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, *batch)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(x) for x in losses]
    ms = np.mean([a.elapsed_time(b) for a, b in events[TRAIN_WARM:]])
    crop_s = stem_data.crop_samples(cfg) / SR
    flops = 3 * unet_forward_flops(cfg.time_step, cfg.bin_limit) * (
        len(TRAIN_STEMS) * TRAIN_BATCH)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"[train] {TRAIN_STEPS} bf16 steps, {len(TRAIN_STEMS)} stems x B = "
        f"{TRAIN_BATCH} x {cfg.time_step} x {cfg.bin_limit}: losses "
        f"{' '.join(f'{x:.5f}' for x in losses)}")
    log(f"[train] step {ms:.3f} ms (CUDA events, steps {TRAIN_WARM + 1}.."
        f"{TRAIN_STEPS}) = {TRAIN_BATCH * crop_s / (ms / 1e3):.1f} audio s "
        f"trained a second; with data loading {1e3 * wall / TRAIN_STEPS:.3f} "
        f"ms a step (wall) = {TRAIN_BATCH * crop_s * TRAIN_STEPS / wall:.1f} "
        f"audio s a second; peak memory {peak / 2**30:.3f} GiB; "
        f"{flops / 1e12:.4f} TFLOP a step (3x forward) = "
        f"{100 * flops / (ms / 1e3) / peak_ops_per_s(torch.bfloat16):.2f}% of "
        f"the bf16 peak ({smi})")
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"train: losses not finite or not falling "
                             f"(first 5 {first}, last 5 {last})")
    if any(launches.values()):
        raise AssertionError(f"train steps launched hand kernels: {launches}")
    log(f"[train] losses finite, mean of the last 5 {last:.5f} < first 5 "
        f"{first:.5f}; no hand-kernel launch in the steps")
    batch = next(stem_data.batches(train_set, cfg, TRAIN_BATCH, seed=SEED + 9,
                                   steps=1, device=device))
    profile_device("one bf16 train step (cuDNN forward and backward)",
                   lambda: step(state, *batch))
    return state


def phase_train_grads(train_set, device) -> None:
    """One fp32 loss and gradient at B = 2 on the card against the same
    call on CPU tensors."""
    cfg = train_config(torch.float32)
    batch = next(stem_data.batches(train_set, cfg, CHECK_BATCH, seed=SEED + 1,
                                   steps=1, device="cpu"))
    nets = training_nets(SEED, "cpu")
    with cudnn_deterministic(True):
        card_loss, card = loss_and_grads(weights.params_to(nets, device),
                                         [x.to(device) for x in batch], cfg)
    cpu_loss, ref = loss_and_grads(nets, batch, cfg)
    worst = max(float((g.cpu() - r).abs().max() / r.abs().max().clamp(min=1e-30))
                for g, r in zip(card, ref))
    log(f"[train] fp32 gradients, card vs CPU at B = {CHECK_BATCH}: loss "
        f"{card_loss:.7f} vs {cpu_loss:.7f}, worst leaf max|dg| / max|g| "
        f"{worst:.3e} (<= {TRAIN_GRAD_REL_BOUND})")
    if not worst <= TRAIN_GRAD_REL_BOUND:
        raise AssertionError("train: card gradients off the CPU's")


def phase_train_resume(train_set, workdir: str, device) -> None:
    """fp32, B = 2: 4 steps straight against 2 steps, checkpoint.save,
    restore into a fresh state, 2 more; params and EMA bit-identical."""
    cfg = train_config(torch.float32)
    data = list(stem_data.batches(train_set, cfg, CHECK_BATCH, seed=SEED + 2,
                                  steps=4, device=device))
    step = train.make_train_step(STEM_MODE_4, cfg.compute_dtype, TRAIN_EMA)

    def run(state, batches):
        for batch in batches:
            state, _ = step(state, *batch)
        return state

    fresh = lambda seed: train.init_train_state(training_nets(seed, device),
                                                TRAIN_LR, ema=True)
    root = os.path.join(workdir, "ckpt")
    with cudnn_deterministic(True):
        straight = run(fresh(SEED), data)
        checkpoint.save(os.path.join(root, "step_2"), run(fresh(SEED), data[:2]))
        resumed = checkpoint.restore(checkpoint.latest_step_dir(root),
                                     fresh(SEED + 10))
        resumed = run(resumed, data[2:])
    diffs = [float((a.detach() - b.detach()).abs().max()) for x, y in (
        (straight.params, resumed.params), (straight.ema_params, resumed.ema_params))
        for a, b in zip(train.param_leaves(x), train.param_leaves(y))]
    log(f"[train] resume: 4 steps straight vs 2 + save + restore + 2 (fp32, "
        f"deterministic cuDNN): step {resumed.step}, max |diff| over params and "
        f"EMA {max(diffs):.3e}")
    if resumed.step != straight.step or max(diffs) != 0.0:
        raise AssertionError("train: the resumed run is not bit-identical")


def phase_train_eval(ema, holdout, device, smi: str) -> None:
    """evaluate_si_sdr of the EMA nets on the holdout through the kernels,
    fp32 and bf16, against fp32 on CPU tensors (the plain versions)."""
    reports = {}
    for dtype in (torch.float32, torch.bfloat16):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        reports[dtype] = train.evaluate_si_sdr(ema, holdout, train_config(dtype))
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        log(f"[train] evaluate_si_sdr {dtype} on the card: "
            f"{json.dumps(reports[dtype])}, {wall:.3f} s wall, launches "
            f"{launches} ({smi})")
        if launches != expected_launches(MAIN_PATH_LAUNCHES, HOLDOUT_TRACKS):
            raise AssertionError(f"eval launches {launches}, expected "
                                 f"{MAIN_PATH_LAUNCHES} per track")
    cpu = train.evaluate_si_sdr(weights.params_to(ema, "cpu"), holdout,
                                train_config(torch.float32))
    worst = max(abs(reports[torch.float32][k] - cpu[k]) for k in cpu)
    log(f"[train] evaluate_si_sdr fp32 on CPU tensors (plain versions): "
        f"{json.dumps(cpu)}; card vs CPU {worst:.3e} dB (<= {SI_SDR_MAX_DB})")
    if not worst <= SI_SDR_MAX_DB:
        raise AssertionError("train: card SI-SDR off the plain versions'")


def phase_train(device, smi: str) -> None:
    """Training on the card: the stem dataset (WAV and FLAC stems), 30
    full-width bf16 steps, card gradients against the CPU, resume,
    held-out SI-SDR through the kernels, and train_and_deploy."""
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        write_stem_corpus(workdir)
        train_set = stem_data.StemDataset(os.path.join(workdir, "train"),
                                          TRAIN_STEMS)
        holdout = stem_data.StemDataset(os.path.join(workdir, "test"),
                                        TRAIN_STEMS)
        streamed = [t.streaming for t in train_set.tracks]
        log(f"[train] corpus of {len(streamed)} train tracks ({sum(streamed)} "
            f"streamed, one with FLAC stems through the decoded cache) and "
            f"{len(holdout.tracks)} holdout tracks of {TRAIN_TRACK_SECONDS:.0f} "
            f"s in {time.perf_counter() - t0:.3f} s")
        if streamed != [False] + [True] * (TRAIN_TRACKS - 1):
            raise AssertionError(f"train: streaming tracks {streamed}")
        state = phase_train_steps(train_set, device, smi)
        phase_train_grads(train_set, device)
        phase_train_resume(train_set, workdir, device)
        phase_train_eval(state.ema_params, holdout, device, smi)
        t0 = time.perf_counter()
        deploy = train_and_deploy.run(DEPLOY_STEPS, DEPLOY_BATCH, workdir, device)
        log(f"[train] train_and_deploy ({DEPLOY_STEPS} fp32 steps, batch "
            f"{DEPLOY_BATCH}, bin_limit 512, time_step 64) in "
            f"{time.perf_counter() - t0:.3f} s: SI-SDR {deploy['si_sdr_init']['mean']:.3f}"
            f" -> {deploy['si_sdr_trained']['mean']:.3f} dB, train "
            f"{deploy['train_seconds']:.3f} s, blob round trip max |diff| "
            f"{deploy['deploy_roundtrip_max_err']:.3e} (<= "
            f"{train_and_deploy.ROUNDTRIP_MAX_ERR}) ({smi})")


# ---------------------------------------------------------------------------
# The device mesh (parallel/*): world 1 over NCCL beside the unsharded
# graphs, then two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

MESH_SECONDS = 300.0  # the offline and time-sharded graphs' track
MESH_BATCH, MESH_BATCH_SECONDS = 16, 60.0  # separate_batch_sharded
MESH_STREAMS = 16  # make_stream_fn
MESH_ITERS = 5  # CUDA-event timing iterations a graph
MESH_REL_BOUND = 1e-5  # fp32 two ranks vs one process, of the signal's peak
MESH_RANKS = 2
MESH_RANK_DEADLINE_S = 400


def _flat(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    return [t for v in x for t in _flat(v)]


def max_diff(a, b) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(_flat(a), _flat(b), strict=True))


def diff_text(d: float) -> str:
    return "bit for bit" if d == 0.0 else f"largest difference {d:.3e}"


def mesh_pair(tag: str, sharded, plain, smi: str) -> float:
    """sharded() beside plain() at world 1: the largest difference, the
    launch counts of each call (which must be equal) and ms a call by CUDA
    events; returns the difference."""
    runs = {}
    for name, fn in (("sharded", sharded), ("unsharded", plain)):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        runs[name] = (out, kernels.launch_counts())
    d = max_diff(runs["sharded"][0], runs["unsharded"][0])
    counts = {k: v for k, v in runs["sharded"][1].items() if v}
    ms = {name: cuda_ms(fn, iters=MESH_ITERS, warmup=1)
          for name, fn in (("sharded", sharded), ("unsharded", plain))}
    log(f"[mesh world 1] {tag}: {diff_text(d)}; launches {counts} (unsharded "
        f"the same: {runs['sharded'][1] == runs['unsharded'][1]}); "
        f"{ms['sharded']:.3f} ms a call sharded, {ms['unsharded']:.3f} ms "
        f"unsharded (CUDA events, {smi})")
    if runs["sharded"][1] != runs["unsharded"][1]:
        raise AssertionError(f"mesh {tag}: launches {runs['sharded'][1]} vs "
                             f"the unsharded graph's {runs['unsharded'][1]}")
    return d


def mesh_train_batch(cfg, batch: int, device, seed: int = SEED):
    """Random magnitudes at examples/train.py's crop: (mix (B, T, F, 2),
    targets (S, B, T, F, 2)) on the card, scaled as training scales them."""
    gen = torch.Generator().manual_seed(seed)
    shape = (batch, cfg.time_step, cfg.bin_limit, 2)
    mix = torch.rand(shape, generator=gen) * 0.05
    tgt = torch.stack([mix * torch.rand(shape, generator=gen)
                       for _ in TRAIN_STEMS])
    return mix.to(device), tgt.to(device)


def phase_mesh_world1(device, smi: str) -> None:
    """Each mesh entry point at world 1 (an NCCL group of one rank) beside
    the port's unsharded graph on the card."""
    mesh = pmesh.make_mesh(1)
    cfg = vst_config(torch.bfloat16)
    stacked = random_stacked(device)
    x = torch.from_numpy(synthetic_audio(MESH_SECONDS)).to(device)
    padded = transform.pad_offline(x, cfg.transform).contiguous()
    mesh_pair(f"separate_4stem_sharded {MESH_SECONDS:.0f} s",
              lambda: pmesh.separate_4stem_sharded(stacked, padded, cfg, mesh),
              lambda: separate.separate_4stem(stacked, padded, cfg), smi)

    tracks = torch.from_numpy(np.stack([
        synthetic_audio(MESH_BATCH_SECONDS, seed=SEED + k)
        for k in range(MESH_BATCH)])).to(device)
    tracks = transform.pad_offline(tracks, cfg.transform).contiguous()
    mesh_pair(f"separate_batch_sharded B = {MESH_BATCH} x "
              f"{MESH_BATCH_SECONDS:.0f} s",
              lambda: pmesh.separate_batch_sharded(stacked, tracks, cfg, mesh),
              lambda: separate.separate_nstem_batch(stacked, tracks, cfg,
                                                    separate.OUT_BAND_4), smi)
    del tracks

    step, n_ranks = pmesh.make_stream_fn(cfg, mesh, 4)
    blocks = torch.from_numpy(np.stack([
        synthetic_audio(BLOCK_SECONDS, seed=SEED + k)[:, :BLOCK_LEN]
        for k in range(MESH_STREAMS)])).to(device)
    carry = {"sharded": stream.init_state_streams(cfg, 4, MESH_STREAMS // n_ranks,
                                                  device),
             "unsharded": stream.init_state_streams(cfg, 4, MESH_STREAMS, device)}

    def stream_step(name):
        fn = step if name == "sharded" else (
            lambda p, st, b: stream.block_step_streams(p, st, b, cfg, 4))
        carry[name], out = fn(stacked, carry[name], blocks)
        return out

    mesh_pair(f"make_stream_fn K = {MESH_STREAMS} (a block step, the state "
              f"carried)", lambda: stream_step("sharded"),
              lambda: stream_step("unsharded"), smi)

    scan_audio = x[:, :STREAM_QUALITY_BLOCKS * BLOCK_LEN]
    mesh_pair(f"stream_scan_sharded {STREAM_QUALITY_BLOCKS} blocks",
              lambda: pmesh.stream_scan_sharded(stacked, scan_audio, cfg, mesh),
              lambda: stream.stream_scan(stacked, scan_audio, cfg), smi)

    mesh_pair(f"separate_4stem_timesharded_padded {MESH_SECONDS:.0f} s",
              lambda: timeshard.separate_4stem_timesharded_padded(
                  stacked, x, cfg, mesh),
              lambda: torch.stack(list(separate.separate(
                  x, stacked_params=stacked, cfg=cfg, device=device).values())),
              smi)
    del x, padded

    tcfg = train_config(torch.bfloat16)
    batch = mesh_train_batch(tcfg, TRAIN_BATCH, device)
    nets = training_nets(SEED, device)
    states = {"sharded": train.shard_train_state(
        train.init_train_state(nets, TRAIN_LR, ema=True), mesh, len(TRAIN_STEMS)),
        "unsharded": train.init_train_state(nets, TRAIN_LR, ema=True)}
    steps = {"sharded": train.make_sharded_train_step(
        mesh, STEM_MODE_4, tcfg.compute_dtype, TRAIN_EMA),
        "unsharded": train.make_train_step(STEM_MODE_4, tcfg.compute_dtype,
                                           TRAIN_EMA)}

    def train_step(name):
        states[name], loss = steps[name](states[name], *batch)
        return [loss, states[name].params, states[name].ema_params]

    with cudnn_deterministic(True):
        mesh_pair(f"make_sharded_train_step ({len(TRAIN_STEMS)} stems, B = "
                  f"{TRAIN_BATCH} x {tcfg.time_step} x {tcfg.bin_limit}, bf16; "
                  f"loss, params and EMA after each step)",
                  lambda: train_step("sharded"), lambda: train_step("unsharded"),
                  smi)


def mesh_rank(rank: int, store: str, out) -> None:
    """One of MESH_RANKS ranks sharing the card over gloo: the time-sharded
    graph's halo exchange, the stem-sharded masks and the sharded train
    step, each against this process's own one-rank result on the card."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = distributed.initialize(
            "cuda", backend="gloo", world_size=MESH_RANKS, rank=rank,
            local_rank=0, store=dist.FileStore(store, MESH_RANKS),
            timeout=datetime.timedelta(seconds=120))
        out.put((rank, None, mesh_rank_checks(dev)))
    except BaseException:  # reported to the parent, which fails the run
        out.put((rank, traceback.format_exc(), None))
    finally:
        distributed.shutdown()


def wall_ms(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def mesh_rank_checks(dev) -> list[str]:
    """The checks of `mesh_rank`; returns its report lines, raising where a
    result leaves its bound."""
    lines = []
    by_data, by_stem = pmesh.make_mesh(1), pmesh.make_mesh(MESH_RANKS)
    stacked = random_stacked(dev)
    x = torch.from_numpy(synthetic_audio(MESH_SECONDS)).to(dev)
    peak = float(x.abs().max())
    for dtype in (torch.float32, torch.bfloat16):
        cfg = vst_config(dtype)
        fn = lambda: timeshard.separate_4stem_timesharded_padded(stacked, x, cfg,
                                                                 by_data)
        fn()  # warm
        got, ms = wall_ms(fn)
        ref, ref_ms = wall_ms(lambda: torch.stack(list(separate.separate(
            x, stacked_params=stacked, cfg=cfg, device=dev).values())))
        line = (f"time-sharded 4 stems {MESH_SECONDS:.0f} s {dtype}, data over "
                f"{MESH_RANKS} ranks (halo exchange): {ms:.3f} ms of wall on two "
                f"ranks sharing the card beside {ref_ms:.3f} ms one process "
                f"(not a scaling number); ")
        if dtype == torch.float32:
            d = max_diff(got, ref)
            lines.append(line + f"{diff_text(d)} = {d / peak:.3e} of the "
                         f"signal's peak (<= {MESH_REL_BOUND})")
            if not d <= MESH_REL_BOUND * peak:
                raise AssertionError(lines[-1])
        else:
            snrs = [snr_db(g.cpu().numpy(), r.cpu().numpy())
                    for g, r in zip(got, ref)]
            lines.append(line + "per-stem SNR vs one process " + " ".join(
                f"{v:.2f}" for v in snrs) + f" dB (>= {SNR_BF16_MIN_DB})")
            if not min(snrs) >= SNR_BF16_MIN_DB:
                raise AssertionError(lines[-1])
        del got, ref

    mix = transform.pad_offline(x[:, :int(SMOKE_SECONDS * SR)],
                                TransformConfig()).contiguous()
    spec = transform.stft(mix, TransformConfig(), mix.shape[-1])
    for dtype in (torch.float32, torch.bfloat16):
        cfg = vst_config(dtype)
        got = pmesh.compute_masks_sharded(stacked, spec, cfg, by_stem)
        ref = separate.compute_masks_multi(stacked, spec, cfg, STEM_MODE_4)
        d = max_diff(got, ref)
        snrs = [snr_db(a.cpu().numpy(), b.cpu().numpy()) for a, b in zip(got, ref)]
        lines.append(f"compute_masks_sharded {SMOKE_SECONDS:.0f} s {dtype}, stems "
                     f"over {MESH_RANKS} ranks: {diff_text(d)}, per-stem SNR vs "
                     f"one process {' '.join(f'{v:.2f}' for v in snrs)} dB ("
                     + (f"<= {MESH_REL_BOUND} of the masks' peak 1)"
                        if dtype == torch.float32 else f">= {SNR_BF16_MIN_DB} dB)"))
        if not (d <= MESH_REL_BOUND if dtype == torch.float32
                else min(snrs) >= SNR_BF16_MIN_DB):
            raise AssertionError(lines[-1])

    tcfg = train_config(torch.float32)
    batch = mesh_train_batch(tcfg, CHECK_BATCH, dev)
    nets = training_nets(SEED, dev)
    with cudnn_deterministic(True):
        one = train.init_train_state(nets, TRAIN_LR)
        one, ref_loss = train.make_train_step(STEM_MODE_4, torch.float32)(one, *batch)
        shard = train.shard_train_state(train.init_train_state(nets, TRAIN_LR),
                                        by_stem, len(TRAIN_STEMS))
        shard, loss = train.make_sharded_train_step(
            by_stem, STEM_MODE_4, torch.float32)(shard, *batch)
    g = dist.get_rank()
    worst = max(
        float((a.grad - b.grad[g:g + 1]).abs().max() / b.grad[g:g + 1].abs().max()
              .clamp(min=1e-30))
        for a, b in zip(train.param_leaves(shard.params),
                        train.param_leaves(one.params)))
    lines.append(f"sharded train step fp32, {len(TRAIN_STEMS)} stems over "
                 f"{MESH_RANKS} ranks, B = {CHECK_BATCH} x {tcfg.time_step} x "
                 f"{tcfg.bin_limit}: loss {float(loss):.7f} vs one process "
                 f"{float(ref_loss):.7f}; this rank's clipped gradients, worst "
                 f"leaf max|dg| / max|g| {worst:.3e} (<= {TRAIN_GRAD_REL_BOUND})")
    if not (worst <= TRAIN_GRAD_REL_BOUND
            and abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))):
        raise AssertionError(lines[-1])
    return lines


def phase_mesh_two_ranks(smi: str) -> None:
    """MESH_RANKS spawned ranks on the one card over gloo (mesh_rank); a
    rank that fails, or gives no result by the deadline, fails the run."""
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=mesh_rank, args=(r, store, out), daemon=True)
                 for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for _ in procs:
                rank, error, lines = out.get(timeout=MESH_RANK_DEADLINE_S)
                if error is not None:
                    raise AssertionError(f"mesh rank {rank} failed:\n{error}")
                for line in lines:
                    log(f"[mesh two ranks] rank {rank}: {line} ({smi})")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    log(f"[mesh two ranks] both ranks done in {time.perf_counter() - t0:.3f} s "
        f"(spawn, kernel library load and the checks)")


def phase_mesh(device, smi: str) -> None:
    """The mesh entry points at world 1 over NCCL, then two ranks sharing
    the card over gloo."""
    t0 = time.perf_counter()
    with distributed.process_group(device.type) as dev:
        log(f"[mesh world 1] process group up: backend "
            f"{dist.get_backend()}, world {dist.get_world_size()}, {dev}")
        phase_mesh_world1(dev, smi)
    phase_mesh_two_ranks(smi)
    log(f"[mesh] phase done in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# Host modules and the ranked service: the native runtime, MP3 input, stage
# timing, the profiler scope and spectrogram dumps, /separate_batch over
# ranks
# ---------------------------------------------------------------------------

FLAC_SECONDS = 60.0  # the native vs Python FLAC decode
MP3_SECONDS = SMOKE_SECONDS
TRACE_KERNELS = ("stft4096_kernel", "enc1_mma_kernel", "masked_istft4096_kernel")
TRACE_RUNS = 3  # separations inside one profiler_trace
# MAIN_PATH_LAUNCHES' kernels as a trace names them (K4 and K5 are both
# up_mma_kernel).
KERNEL_FUNCTIONS = {"stft4096": "stft4096_kernel", "enc1": "enc1_mma_kernel",
                    "enc_s2": "enc_mma_kernel", "up4": "up_mma_kernel",
                    "up5": "up_mma_kernel", "head": "head_mma_kernel",
                    "masked_istft4096": "masked_istft4096_kernel"}
RANKED_BF16_MIN_DB = 60.0  # two ranks vs one process, bf16
RANKED_RANKS = 2
RANKED_DEADLINE_S = 400
RANKED_POSTS = 2  # requests a path; the first carries one-time set-up


def phase_native(smi: str) -> None:
    """The native library builds (g++ is there: nvcc needs it); a FLAC from
    io/flac.py's encoder decodes bit for bit the same natively and in
    Python; both decode times for FLAC_SECONDS of stereo."""
    t0 = time.perf_counter()
    lib = native.get_lib()
    if lib is None:
        raise AssertionError("native.get_lib() is None: the native runtime "
                             "did not build")
    log(f"[native] {native.library_path().name} "
        f"({lib.srt_version().decode()}) in {time.perf_counter() - t0:.3f} s")
    x = synthetic_audio(FLAC_SECONDS)
    data = flac.encode_flac(x)
    t0 = time.perf_counter()
    got, rate = native.decode_flac_native(data)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, ref_rate = flac.decode_flac(data, prefer_native=False)
    python_ms = (time.perf_counter() - t0) * 1e3
    same = (rate == ref_rate and got.dtype == ref.dtype
            and got.shape == ref.shape == x.shape and np.array_equal(got, ref))
    log(f"[native] FLAC {FLAC_SECONDS:.0f} s stereo ({len(data)} bytes): native "
        f"{'bit for bit with' if same else 'DIFFERS from'} the Python decoder; "
        f"decode {native_ms:.3f} ms native, {python_ms:.3f} ms Python "
        f"(host CPU; {smi})")
    if not same:
        raise AssertionError("native FLAC decode differs from the Python decoder")


def phase_mp3(workdir: str, device) -> None:
    """The 4-stem CLI on an MP3 made here (LAME where it loads, else frames
    of digital silence) at the VST config, bf16, random weights: one 4-stem
    run's launches and four stems of the decoded length."""
    if not mpg123.available():
        log("mp3: libmpg123 absent")
        return
    x = synthetic_audio(MP3_SECONDS)
    if mp3_fixtures.lame_available():
        data, made = mp3_fixtures.lame_encode(x), "libmp3lame"
    else:
        n_frames = int(MP3_SECONDS * SR) // mp3_fixtures.SAMPLES_PER_FRAME
        data, made = mp3_fixtures.silent_frames(n_frames), "silent frames"
    song = os.path.join(workdir, "smoke_mp3.mp3")
    with open(song, "wb") as f:
        f.write(data)
    n = mpg123.decode_mp3(song)[0].shape[1]
    out_dir = os.path.join(workdir, "mp3_stems")
    kernels.reset_launch_counts()
    rc = cli.main([song, "--stems", "4", "--time-step", str(TIME_STEP),
                   "--bin-limit", str(BIN_LIMIT), "--random-weights",
                   "--seed", str(SEED), "--output-dir", out_dir,
                   "--device", str(device)])
    launches = kernels.launch_counts()
    log(f"[mp3] {MP3_SECONDS:.0f} s MP3 ({made}, {len(data)} bytes, {n} "
        f"samples decoded by libmpg123): cli rc {rc}, launches {launches}")
    if rc != 0 or launches != expected_launches(MAIN_PATH_LAUNCHES):
        raise AssertionError(f"MP3 CLI: rc {rc}, launches {launches}")
    for fname in ("Drum", "Bass", "Accompaniment", "Vocal"):
        y = audio_io.read_wav(os.path.join(out_dir, f"smoke_mp3_{fname}.wav"))
        if y.samples.shape != (2, n) or not np.all(np.isfinite(y.samples)):
            raise AssertionError(f"MP3 {fname}: shape {y.samples.shape} or "
                                 f"non-finite")
    log(f"[mp3] 4 finite stems of shape (2, {n}) written")


def trace_events(trace_path: str) -> tuple[list[str], int]:
    """(the name of every kernel event, the cudaGraphLaunch calls) of a
    profiler_trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernel_names = [e.get("name", "") for e in events
                    if str(e.get("cat", "")).lower() == "kernel"]
    graph_launches = sum(1 for e in events
                         if str(e.get("cat", "")).lower() == "cuda_runtime"
                         and e.get("name", "").startswith("cudaGraphLaunch"))
    return kernel_names, graph_launches


def count_kernel(function: str, kernel_names: list[str]) -> int:
    """Events of the kernel `function`, named as a whole identifier (K1's
    name lies inside K7's)."""
    pattern = re.compile(rf"(?<![A-Za-z0-9_]){function}(?![A-Za-z0-9_])")
    return sum(1 for n in kernel_names if pattern.search(n))


def phase_stage_timing(workdir: str, device, smi: str) -> None:
    """The 300 s 4-stem bf16 separate.separate, replaying its captured
    graph, under StageTimer(sync=...) beside the CUDA-event time of the
    same call; a profiler_trace of three replays that names K1, bf16 K2
    and K7 and no FMA encoder kernel, counts every main-path kernel's
    events against MAIN_PATH_LAUNCHES, one graph launch a call and K7 as
    the one wrapper launch, with the replay counter's count; K1's
    magnitude tiles through dump_spectrogram_pngs."""
    cfg = vst_config(torch.bfloat16)
    stacked = random_stacked(device)
    seconds = TRACK_SECONDS
    audio = torch.from_numpy(synthetic_audio(seconds)).to(device)
    padded = transform.pad_offline(audio, cfg.transform).contiguous()
    run = lambda: separate.separate(audio, stacked_params=stacked, cfg=cfg,
                                    device=device)
    run()  # the length's first call runs eager
    run()  # the second captures its graph (core/replay.py); the rest replay
    replay.reset_counts()
    timer = timing.StageTimer(verbose=False)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    name = f"separate_4stem {seconds:.0f} s"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.stage(name, sync=padded):
        start.record()
        run()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3  # the host's enqueue
    stage_ms = timer.report()[name] * 1e3
    event_ms = start.elapsed_time(end)
    log(f"[stage timer] {name} bf16: StageTimer {stage_ms:.3f} ms, CUDA events "
        f"{event_ms:.3f} ms of the same call, the host's enqueue {host_ms:.3f} "
        f"ms ({smi})")
    # The event span lies inside the stage's, and what the stage adds (the
    # first launch's enqueue, the wait's wake-up) is host time; 0.05 ms
    # covers the two clocks' rounding.
    if not -0.05 <= stage_ms - event_ms <= host_ms:
        raise AssertionError(f"StageTimer {stage_ms:.3f} ms vs CUDA events "
                             f"{event_ms:.3f} ms: not within the host's share")

    # A capture can come back without some device kernels (PERF.md,
    # Findings, PRs 6 and 12; on torch 2.11 the first kernel of the first
    # replay), so the trace holds a lead-in separation and TRACE_RUNS more
    # and is retaken, at most three times in all, until it names each one
    # and holds each main-path kernel's events of TRACE_RUNS calls at
    # least and of the calls made at most: K1, K2, K4, K5 and K6 once a
    # call and K3 three times inside the graph, K7 once after it.
    per_call = dict.fromkeys(KERNEL_FUNCTIONS.values(), 0)
    for name, n in MAIN_PATH_LAUNCHES.items():
        per_call[KERNEL_FUNCTIONS[name]] += n
    want = {f: n * TRACE_RUNS for f, n in per_call.items()}
    for attempt in range(1, 4):
        trace_dir = os.path.join(workdir, f"trace{attempt}")
        kernels.reset_launch_counts()
        with timing.profiler_trace(trace_dir):
            for _ in range(1 + TRACE_RUNS):
                run()
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        kernel_names, graph_launches = trace_events(
            os.path.join(trace_dir, timing.TRACE_FILE))
        names = set(kernel_names)
        missing = [k for k in TRACE_KERNELS if not any(k in n for n in names)]
        found = {f: count_kernel(f, kernel_names) for f in want}
        log(f"[profiler_trace] capture {attempt}: {len(names)} kernel names in "
            f"{timing.TRACE_FILE}; " + ", ".join(
                f"{k}: {'MISSING' if k in missing else 'yes'}" for k in TRACE_KERNELS))
        log(f"[profiler_trace] kernels of 1 + {TRACE_RUNS} replayed calls: "
            f"events {found} (at least {want}, at most one call more); "
            f"{graph_launches} cudaGraphLaunch; wrapper launches {launches}")
        held = all(want[f] <= found[f] <= want[f] + per_call[f] for f in want)
        if not missing and held:
            break
    else:
        raise AssertionError(f"profiler_trace never named {missing} or held "
                             f"{want}: {found}")
    # K1-K6 ran from the graph, one launch a call; K7 from its wrapper.
    if (graph_launches != 1 + TRACE_RUNS or launches != expected_launches(
            {"masked_istft4096": 1}, 1 + TRACE_RUNS)):
        raise AssertionError(f"replayed calls: {graph_launches} graph launches, "
                             f"wrapper launches {launches}")
    counts = replay.counts()
    log(f"[replay] {counts['replay']} of {sum(counts.values())} separations "
        f"replayed one captured graph ({counts})")
    if counts["replay"] != sum(counts.values()):
        raise AssertionError(f"a separation of a captured length did not replay: {counts}")
    # bf16 enc1 runs the tensor-core template and no FMA encoder kernel.
    fma = sorted(n for n in names if "enc_conv_kernel" in n)
    if fma:
        raise AssertionError(f"bf16 enc1 did not run enc1_mma_kernel alone: {fma}")
    log("[profiler_trace] bf16 enc1 ran enc1_mma_kernel; no FMA encoder kernel ran")

    n_out, n_comp, n_req = separate.frame_counts(padded.shape[-1], cfg)
    _, mag = stft_fused.stft4096(
        padded, transform.analysis_window(4096, device=device), n_comp, n_req,
        cfg.bin_limit, cfg.time_step)
    check_spectrogram_pngs(mag[0], os.path.join(workdir, "pngs"))


def check_spectrogram_pngs(tile: torch.Tensor, folder: str) -> None:
    """dump_spectrogram_pngs of one (2, T, F) magnitude tile: each file a
    PNG whose one IDAT inflates to the tile's clipped 8-bit pixels."""
    paths = timing.dump_spectrogram_pngs(tile, folder)
    want = np.clip(np.abs(tile.float().cpu().numpy()) * 10.0, 0, 255).astype(np.uint8)
    for c, path in enumerate(paths):
        with open(path, "rb") as f:
            png = f.read()
        w, h = struct.unpack(">II", png[16:24])
        idat = png[33 + 8 : -12 - 4]  # after IHDR and the IDAT length + tag
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
        if (png[:8] != b"\x89PNG\r\n\x1a\n" or (h, w) != want.shape[1:]
                or rows[:, 0].any() or not np.array_equal(rows[:, 1:], want[c])):
            raise AssertionError(f"{path}: not the tile's PNG")
    log(f"[pngs] K1's magnitude tile 0 ({tuple(tile.shape)}, {tile.dtype}) as "
        f"{len(paths)} valid {want.shape[2]} x {want.shape[1]} PNGs")


def server_batch_body() -> bytes:
    """phase_server's /separate_batch body: three tracks of
    SERVER_BATCH_SECONDS."""
    buf = io.BytesIO()
    np.savez(buf, **{f"t{i}": synthetic_audio(sec, SEED + 10 + i)
                     for i, sec in enumerate(SERVER_BATCH_SECONDS)})
    return buf.getvalue()


def serve_in_thread(service):
    """(server, thread, base URL): make_server on port 0, `server.serve` in
    a thread (which stops the ranks when it ends)."""
    srv = server.make_server("127.0.0.1", 0, service)
    thread = threading.Thread(target=server.serve, args=(srv, service),
                              daemon=True)
    thread.start()
    return srv, thread, f"http://127.0.0.1:{srv.server_address[1]}"


def stop_serving(srv, thread) -> None:
    srv.shutdown()
    thread.join(timeout=60)
    srv.server_close()
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")


def post_batch(base: str, body: bytes) -> tuple[dict, float]:
    t0 = time.perf_counter()
    code, _, data = http(f"{base}/separate_batch", body)
    wall = (time.perf_counter() - t0) * 1e3
    if code != 200:
        raise AssertionError(f"ranked /separate_batch: {code} {data[:200]!r}")
    out = np.load(io.BytesIO(data))
    return {k: out[k] for k in out.files}, wall


def post_batches(base: str, body: bytes) -> tuple[list[dict], list[float]]:
    """RANKED_POSTS answers to the same body and the wall time of each: the
    first call of a path carries its one-time set-up (NCCL's communicator,
    cuDNN's plans), so the last is the one to compare."""
    outs, walls = [], []
    for _ in range(RANKED_POSTS):
        out, wall = post_batch(base, body)
        outs.append(out)
        walls.append(wall)
    return outs, walls


def single_process_posts(cfg, stacked, body: bytes, device):
    """post_batches against a single-process service (no mesh) on `device`."""
    service = server.SeparationService(cfg, {"stacked_params": stacked},
                                       device=device)
    srv, thread, base = serve_in_thread(service)
    try:
        return post_batches(base, body)
    finally:
        stop_serving(srv, thread)


def walls_text(walls: list[float]) -> str:
    return " / ".join(f"{w:.3f}" for w in walls) + " ms"


def phase_ranked_world1(device, smi: str) -> None:
    """/separate_batch through the ranked path at world 1 (an NCCL group of
    one rank) against a single-process server: bit for bit (fp32,
    deterministic cuDNN in both), one 4-stem run's launches a request."""
    cfg = vst_config(torch.float32)
    body = server_batch_body()
    with distributed.process_group(device.type) as dev, cudnn_deterministic(True):
        backend = dist.get_backend()
        stacked = random_stacked(dev)
        solo, solo_walls = single_process_posts(cfg, stacked, body, dev)
        service = server.SeparationService(cfg, {"stacked_params": stacked},
                                           device=dev, mesh=pmesh.make_mesh(1))
        srv, thread, base = serve_in_thread(service)
        try:
            health = json.loads(http(f"{base}/healthz")[2])
            kernels.reset_launch_counts()
            got, walls = post_batches(base, body)
            launches = kernels.launch_counts()
        finally:
            stop_serving(srv, thread)
    d = max(float(np.abs(g[k] - o[k]).max()) for g, o in zip(got, solo) for k in o)
    log(f"[ranked world 1] /separate_batch {len(SERVER_BATCH_SECONDS)} tracks of "
        f"{SERVER_BATCH_SECONDS} s, 4 stems fp32, backend {backend}, "
        f"{RANKED_POSTS} requests: {diff_text(d)} with the single-process "
        f"server; launches {launches}; /healthz {health}; wall (POST to "
        f"answer) {walls_text(walls)} beside {walls_text(solo_walls)} "
        f"single-process ({smi})")
    if (any(set(g) != set(solo[0]) for g in got) or d != 0.0
            or health["devices"] != 1
            or launches != expected_launches(MAIN_PATH_LAUNCHES, RANKED_POSTS)):
        raise AssertionError("ranked /separate_batch at world 1")


def service_rank(rank: int, kind: str, store: str, out, ctl) -> None:
    """One of RANKED_RANKS ranks sharing the card over gloo: rank 0 serves
    an fp32, then a bf16 4-stem service on port 0 and stops each when the
    parent says so; the other rank runs serve_rank_loop for each."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = distributed.initialize(
            kind, backend="gloo", world_size=RANKED_RANKS, rank=rank,
            local_rank=0, store=dist.FileStore(store, RANKED_RANKS),
            timeout=datetime.timedelta(seconds=120))
        mesh = pmesh.make_mesh(1)
        stacked = random_stacked(dev)
        batches = []
        for dtype in (torch.float32, torch.bfloat16):
            service = server.SeparationService(
                vst_config(dtype), {"stacked_params": stacked}, device=dev,
                mesh=mesh)
            if rank:
                batches.append(server.serve_rank_loop(service))
                continue
            srv, thread, base = serve_in_thread(service)
            out.put(("serving", rank, str(dtype), base))
            try:
                ctl.get(timeout=RANKED_DEADLINE_S)
            finally:
                stop_serving(srv, thread)
        out.put(("done", rank, None, batches))
    except BaseException:  # reported to the parent, which fails the run
        out.put(("done", rank, traceback.format_exc(), None))
    finally:
        distributed.shutdown()


def phase_ranked_two_ranks(device, smi: str) -> None:
    """RANKED_RANKS spawned ranks on the card over gloo (service_rank); the
    parent posts the batch to rank 0: fp32 within 1e-5 of each stem's peak
    of the single-process answer, bf16 >= RANKED_BF16_MIN_DB against it;
    after the stop op code both ranks exit 0. A rank that fails or misses
    the deadline fails the run."""
    body = server_batch_body()
    stacked = random_stacked(device)
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.get_context("spawn")
    out, ctl = ctx.Queue(), ctx.Queue()
    deadline = time.monotonic() + RANKED_DEADLINE_S

    def next_message():
        try:
            msg = out.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            raise AssertionError(f"service ranks: no message within "
                                 f"{RANKED_DEADLINE_S} s") from None
        if msg[0] == "done" and msg[2] is not None:
            raise AssertionError(f"service rank {msg[1]} failed:\n{msg[2]}")
        return msg

    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=service_rank, daemon=True,
                             args=(r, device.type, os.path.join(tmp, "store"),
                                   out, ctl))
                 for r in range(RANKED_RANKS)]
        for p in procs:
            p.start()
        try:
            for dtype in (torch.float32, torch.bfloat16):
                cfg = vst_config(dtype)
                solo, solo_walls = single_process_posts(cfg, stacked, body, device)
                kind, _, label, base = next_message()
                if kind != "serving" or label != str(dtype):
                    raise AssertionError(f"unexpected message {kind} {label}")
                got, walls = post_batches(base, body)
                ctl.put("stop")
                if any(set(g) != set(solo[-1]) for g in got):
                    raise AssertionError(f"ranked {dtype}: keys {sorted(got[0])}")
                if dtype == torch.float32:
                    rel = max(float(np.abs(g[k] - solo[-1][k]).max()
                                    / np.abs(solo[-1][k]).max())
                              for g in got for k in g)
                    verdict = (f"largest difference {rel:.3e} of the stem's peak "
                               f"(<= {MESH_REL_BOUND})")
                    ok = rel <= MESH_REL_BOUND
                else:
                    worst = min(snr_db(g[k], solo[-1][k]) for g in got for k in g)
                    verdict = (f"per-stem SNR >= {worst:.2f} dB "
                               f"(>= {RANKED_BF16_MIN_DB})")
                    ok = worst >= RANKED_BF16_MIN_DB
                log(f"[ranked two ranks] /separate_batch {dtype}, 4 stems, "
                    f"{len(SERVER_BATCH_SECONDS)} tracks over {RANKED_RANKS} ranks "
                    f"sharing the card (gloo), {RANKED_POSTS} requests: {verdict} "
                    f"against the single-process server; wall (POST to answer) "
                    f"{walls_text(walls)} beside {walls_text(solo_walls)} "
                    f"single-process (two processes on one card, not a scaling "
                    f"number; {smi})")
                if not ok:
                    raise AssertionError(f"ranked /separate_batch {dtype}")
            done = dict((msg[1], msg[3]) for msg in
                        (next_message() for _ in procs))
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    codes = [p.exitcode for p in procs]
    log(f"[ranked two ranks] rank 1 ran {done.get(1)} batches (fp32, bf16) and "
        f"left its loops on the stop op code; exit codes {codes}")
    if codes != [0] * RANKED_RANKS or done.get(1) != [RANKED_POSTS] * 2:
        raise AssertionError(f"service ranks: exit codes {codes}, {done}")


def phase_host(workdir: str, device, smi: str) -> None:
    """The host modules and the ranked service."""
    t0 = time.perf_counter()
    phase_native(smi)
    phase_mp3(workdir, device)
    phase_stage_timing(workdir, device, smi)
    phase_ranked_world1(device, smi)
    phase_ranked_two_ranks(device, smi)
    log(f"[host] phase done in {time.perf_counter() - t0:.3f} s")


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
    measured["rope_qk"], rope_launches = phase_roformer(device)
    phase_kernels_tracks(cfg, device)
    with tempfile.TemporaryDirectory() as workdir:
        cli_stems, launches = phase_main_path(workdir, device)
        stream_launches = phase_stream_cli(workdir, device)
        files = write_weight_files(workdir)
        phase_stems_cli(workdir, files, device)
        round3_launches = phase_round3(workdir, files, device)
        phase_server(workdir, device)
    phase_batch(device)
    phase_executor(device)
    phase_quality(cli_stems, device)
    phase_stream_quality(device)
    overlap2_launches = phase_overlap2(device)
    phase_stream_timing(device)
    phase_timing_2stem(device)
    phase_batch_timing(device)
    phase_train(device, smi)
    phase_mesh(device, smi)
    with tempfile.TemporaryDirectory() as workdir:
        phase_host(workdir, device, smi)
    # Each kernel's launches on the path that runs it: the offline CLI for
    # K1-K7, the overlap-2 graphs for K8 (2 stems) and K9 (4 stems), the
    # 2-stem CLI's round-3 route for K10, the streaming CLI for the
    # streaming synthesis, BS-RoFormer's 300 s separation for the rotary
    # kernel.
    launches.update(irfft4096=overlap2_launches["irfft4096"],
                    masked_irfft4096=overlap2_launches["masked_irfft4096"],
                    mask_head=round3_launches["mask_head"],
                    stream_synthesis4096=stream_launches["stream_synthesis4096"],
                    rope_qk=rope_launches)
    report = [
        {"name": name, "route": "cuda",
         "source": f"spleeterrt_tpu_torch/csrc/{src}",
         "replaces": tpu and f"spleeterrt_tpu/kernels/{tpu}",
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
