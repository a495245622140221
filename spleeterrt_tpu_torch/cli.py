"""Command-line offline separation, mirroring the reference CLI surface.

Reference: `SpleeterRT spawnNthreads timeStep analyseBinLimit stems audioFile`
(Executable/main.c:704-748), with arg clamping (timeStep >= 64,
analyseBinLimit in [512, 2048]) and stage timing printfs
(Executable/main.c:772,783,825). The separation runs on one device,
`--device` (default `cuda`); a missing card is an error, never a silent
switch to the CPU.

Stem file naming matches the reference (`<name>_Vocal.wav`,
`<name>_Accompaniment.wav`, `<name>_Drum.wav`, Executable/main.c:812-965)
plus `<name>_Bass.wav` for the 4-stem graph.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

STEM_FILENAMES = {
    "vocals": "Vocal",
    "accompaniment": "Accompaniment",
    "drums": "Drum",
    "bass": "Bass",
    "piano": "Piano",
    "other": "Other",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spleeterrt-tpu-torch",
        description="Spleeter source separation in PyTorch (offline CLI).",
    )
    p.add_argument("audio", help="input audio file (WAV)")
    p.add_argument("--stems", type=int, default=2, choices=(2, 3, 4, 5),
                   help="stem count; only 4 is available so far")
    p.add_argument("--time-step", type=int, default=512,
                   help="spectrogram tile height in frames (default 512)")
    p.add_argument("--bin-limit", type=int, default=1024,
                   help="frequency bins seen by the U-Net (default 1024)")
    p.add_argument("--weights", default=None,
                   help="a directory with the four VST .dat blobs (4 stems)")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights (smoke/benchmark; model.7z is not "
                        "distributable)")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--output-rate", default="44100",
                   help="output sample rate: a number, or 'input' to "
                        "resample stems back to the source rate")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bfloat16 U-Net compute (default)")
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to separate on (default cuda)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace to DIR")
    return p


def _clamp_args(args) -> None:
    if args.time_step < 64:
        print("timeStep clamp to 64")
        args.time_step = 64
    args.time_step = (args.time_step + 63) // 64 * 64
    if args.bin_limit < 512:
        print("analyseBinLimit clamp to 512")
        args.bin_limit = 512
    if args.bin_limit > 2048:
        print("Analysis bin limit reached, clamp value to 2048")
        args.bin_limit = 2048
    args.bin_limit = args.bin_limit // 64 * 64


def open_device(name: str) -> torch.device:
    """The torch device `name`; a CUDA device without a card exits."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA device is available (pass "
            f"--device cpu to run the plain versions on the CPU)"
        )
    return dev


def load_weights(weights_dir, random_weights: bool, seed: int, cfg, device):
    """Stacked (drums, bass, accompaniment, vocals) params on `device`: the
    VST blobs in `weights_dir`, or random ones drawn from `seed`."""
    from spleeterrt_tpu_torch.core import model, weights

    if random_weights or weights_dir is None:
        if not random_weights:
            print("no --weights given; using random weights")
        gen = torch.Generator().manual_seed(seed)
        ps = [model.init_params(gen) for _ in range(cfg.num_stems)]
    elif os.path.isdir(weights_dir):
        ps = [
            weights.load_coeff_file(
                os.path.join(weights_dir, weights.VST_BLOB_FILENAMES[stem])
            )
            for stem in cfg.stem_names
        ]
    else:
        raise SystemExit(
            "--weights for 4 stems is a directory with the four VST .dat blobs"
        )
    return weights.params_to(weights.stack_params(ps), device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _clamp_args(args)

    from spleeterrt_tpu_torch.config import SeparatorConfig
    from spleeterrt_tpu_torch.core import separate
    from spleeterrt_tpu_torch.io import audio as audio_io, resample

    # Fail fast on undecodable input or an unported graph before any
    # device or weight work.
    if not os.path.exists(args.audio):
        raise SystemExit(f"no such file: {args.audio}")
    try:
        audio_io.check_decodable(args.audio)
    except audio_io.UnsupportedFormatError as e:
        raise SystemExit(str(e))
    cfg = SeparatorConfig(
        bin_limit=args.bin_limit,
        time_step=args.time_step,
        num_stems=args.stems,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )
    separate.check_ported(cfg)
    device = open_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"spleeterrt-tpu-torch: device {device} ({name})")

    t0 = time.perf_counter()
    data = audio_io.load_audio(args.audio)
    samples = data.samples
    if data.sample_rate != 44100:
        samples = resample.resample(samples, data.sample_rate, 44100)
    if samples.shape[0] == 1:
        samples = np.repeat(samples, 2, axis=0)
    elif samples.shape[0] > 2:
        samples = samples[:2]
    print(f"Audio load + resample: {time.perf_counter() - t0:.3f} s "
          f"({samples.shape[1] / 44100.0:.1f} s of audio)")

    stacked = load_weights(args.weights, args.random_weights, args.seed,
                           cfg, device)

    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    stems = separate.separate(
        samples, stacked_params=stacked, cfg=cfg, device=device
    )
    stems = {k: v.cpu().numpy() for k, v in stems.items()}
    dt = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    rtf = samples.shape[1] / 44100.0 / dt
    print(f"Separation ({cfg.num_stems} stems): {dt:.3f} s "
          f"({rtf:.1f}x real time, includes the kernel build on first use)")

    if args.output_rate == "input":
        out_rate = data.sample_rate
    else:
        out_rate = int(args.output_rate)

    base = os.path.splitext(os.path.basename(args.audio))[0]
    os.makedirs(args.output_dir, exist_ok=True)
    t0 = time.perf_counter()
    for stem, y in stems.items():
        out = os.path.join(
            args.output_dir, f"{base}_{STEM_FILENAMES[stem]}.wav"
        )
        if out_rate != 44100:
            y = resample.resample(y, 44100, out_rate)
        audio_io.write_wav(out, y, out_rate)
        print(f"Saved {out}")
    print(f"Save: {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
