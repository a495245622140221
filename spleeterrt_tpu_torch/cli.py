"""Command-line offline separation, mirroring the reference CLI surface.

Reference: `SpleeterRT spawnNthreads timeStep analyseBinLimit stems audioFile`
(Executable/main.c:704-748), with arg clamping (timeStep >= 64,
analyseBinLimit in [512, 2048]) and stage timing printfs
(Executable/main.c:772,783,825). The separation runs on one device,
`--device` (default `cuda`); a missing card is an error, never a silent
switch to the CPU.

Stem file naming matches the reference (`<name>_Vocal.wav`,
`<name>_Accompaniment.wav`, `<name>_Drum.wav`, Executable/main.c:812-965)
plus `<name>_Bass.wav`, `<name>_Piano.wav` and `<name>_Other.wav` for the 4-
and 5-stem graphs.
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
    p.add_argument("audio", help="input audio file (WAV, FLAC; MP3 via "
                                 "libmpg123, soundfile or ffmpeg)")
    p.add_argument("--stems", type=int, default=2, choices=(2, 3, 4, 5))
    p.add_argument("--time-step", type=int, default=512,
                   help="spectrogram tile height in frames (default 512)")
    p.add_argument("--bin-limit", type=int, default=1024,
                   help="frequency bins seen by the U-Net (default 1024)")
    p.add_argument("--weights", default=None,
                   help="weights source: quantized 2-subnet model file "
                        "(2/3 stems), a directory with the four VST .dat "
                        "blobs (4 stems), or an npz checkpoint (2 stems)")
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
                   help="write a torch.profiler chrome trace to DIR, with "
                        "the port's spans on a track of their own")
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


def load_weights(src, random_weights: bool, seed: int, cfg, device) -> dict:
    """The nets for cfg.num_stems on `device`, as keyword arguments of
    separate.separate, by the reference CLI's rules (its `_load_weights`):
    random nets drawn from `seed` (one per stem; 3 stems take the first as
    the 4-stem-family net and the second as the 2-stem net), the four VST
    blobs in a directory (4 stems), an npz checkpoint in the reference's
    layout (2 stems), or the exe's quantized two-subnet file (subnet 0 is
    the 4-stem-family net, subnet 1 the 2-stem net; 2 or 3 stems)."""
    from spleeterrt_tpu_torch.core import model, weights

    n = cfg.num_stems
    if random_weights or src is None:
        if not random_weights:
            print("no --weights given; using random weights")
        gen = torch.Generator().manual_seed(seed)
        ps = [model.init_params(gen) for _ in range(n)]
    elif os.path.isdir(src):
        if n != 4:
            raise SystemExit("--weights dir is only for 4-stem (.dat blobs)")
        ps = [
            weights.load_coeff_file(
                os.path.join(src, weights.VST_BLOB_FILENAMES[stem])
            )
            for stem in cfg.stem_names
        ]
    elif src.endswith(".npz"):
        if n != 2:
            raise SystemExit("single npz supports --stems 2 only")
        ps = [weights.load_npz(src)]
    else:  # the exe's quantized model: raw fp16, two subnets
        if n not in (2, 3):
            raise SystemExit("quantized model supports 2/3 stems")
        with open(src, "rb") as f:
            p4, p2 = weights.load_quantized_model(f.read())
        ps = [p2] if n == 2 else [p4, p2]
    ps = [weights.params_to(p, device) for p in ps]
    if n == 2:
        return {"params": ps[0]}
    if n == 3:
        return {"params4": ps[0], "params2": ps[1]}
    return {"stacked_params": weights.stack_params(ps)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _clamp_args(args)

    from spleeterrt_tpu_torch.config import SeparatorConfig
    from spleeterrt_tpu_torch.core import separate
    from spleeterrt_tpu_torch.io import audio as audio_io, resample
    from spleeterrt_tpu_torch.utils.timing import profiler_trace

    # Fail fast on undecodable input before any device or weight work.
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
    device = open_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"spleeterrt-tpu-torch: device {device} ({name})")

    t0 = time.perf_counter()
    try:
        data = audio_io.load_audio(args.audio)
    except audio_io.UnsupportedFormatError as e:
        raise SystemExit(str(e))
    samples = data.samples
    if data.sample_rate != 44100:
        samples = resample.resample(samples, data.sample_rate, 44100)
    if samples.shape[0] == 1:
        samples = np.repeat(samples, 2, axis=0)
    elif samples.shape[0] > 2:
        samples = samples[:2]
    print(f"Audio load + resample: {time.perf_counter() - t0:.3f} s "
          f"({samples.shape[1] / 44100.0:.1f} s of audio)")

    nets = load_weights(args.weights, args.random_weights, args.seed, cfg,
                        device)

    with profiler_trace(args.profile):
        t0 = time.perf_counter()
        stems = separate.separate(samples, cfg=cfg, device=device, **nets)
        stems = {k: v.cpu().numpy() for k, v in stems.items()}
        dt = time.perf_counter() - t0
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
