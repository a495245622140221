"""Real-time streaming CLI: the VST plugin's role as a pipe.

Port of the reference package's `spleeterrt_tpu.cli_stream`, which mirrors
the JUCE shell (VST/Source/PluginProcessor.cpp): four `spleeterCoeff`
blobs, a declared latency, audio processed in chunks through the
double-buffered engine (runtime/stream.py), and the "Channel order"
parameter that picks which stem pair rides the first two of the eight
output channels (VST/Source/PluginProcessor.cpp:10-18,144-170).

Input: a WAV file, or raw float32 stereo PCM at 44.1 kHz on stdin
(`-` or --raw). Output: one 8-channel float32 WAV (stem pairs in order) or
four stereo stem WAVs (--split). The engine runs on one device,
`--device` (default `cuda`); a missing card is an error, never a silent
switch to the CPU.

    python -m spleeterrt_tpu_torch.cli_stream song.wav --random-weights --split
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

STEM_ORDERS = {
    # VST output order drum, bass, accompaniment, vocal; the parameter
    # rotates which pair rides outputs 1-2.
    "drums": (0, 1, 2, 3),
    "bass": (1, 0, 2, 3),
    "accompaniment": (2, 0, 1, 3),
    "vocals": (3, 0, 1, 2),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spleeterrt-tpu-torch-stream")
    p.add_argument("input", nargs="?", default="-",
                   help="audio file (WAV), or '-' for raw f32 stereo on stdin")
    p.add_argument("--raw", action="store_true",
                   help="stdin is raw interleaved float32 stereo at 44.1k")
    p.add_argument("--weights", default=None,
                   help="directory with the four VST .dat blobs")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights, drawn as the offline CLI's --seed 0")
    p.add_argument("--time-step", type=int, default=256,
                   help="block length in hops (VST uses 256)")
    p.add_argument("--bin-limit", type=int, default=1536,
                   help="NN band limit in bins (VST uses 1536)")
    p.add_argument("--chunk", type=int, default=1024,
                   help="processing chunk in samples (<=1024 in the VST)")
    p.add_argument("--channel-order", choices=STEM_ORDERS, default="drums",
                   help="stem pair on outputs 1-2 (VST 'Channel order')")
    p.add_argument("--split", action="store_true",
                   help="write four stereo stem WAVs instead of one 8ch WAV")
    p.add_argument("--output", default="stems_out")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run the engine on (default cuda)")
    return p


def _chunks(args):
    """Yield (2, <= chunk) float32 arrays of the input at 44.1 kHz."""
    from spleeterrt_tpu_torch.io import audio as audio_io, resample

    if args.input == "-" or args.raw:
        src = sys.stdin.buffer
        while True:
            raw = src.read(args.chunk * 2 * 4)
            if not raw:
                return
            x = np.frombuffer(raw, dtype="<f4")
            n = x.size // 2
            yield np.ascontiguousarray(x[: n * 2].reshape(n, 2).T)
    try:
        data = audio_io.load_audio(args.input)
    except audio_io.UnsupportedFormatError as e:
        raise SystemExit(str(e))
    samples = data.samples
    if data.sample_rate != 44100:
        samples = resample.resample(samples, data.sample_rate, 44100)
    if samples.shape[0] == 1:
        samples = np.repeat(samples, 2, axis=0)
    samples = samples[:2]
    for i in range(0, samples.shape[1], args.chunk):
        yield samples[:, i : i + args.chunk]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from spleeterrt_tpu_torch import cli
    from spleeterrt_tpu_torch.config import STEMS_4, SeparatorConfig
    from spleeterrt_tpu_torch.io import audio as audio_io
    from spleeterrt_tpu_torch.runtime import stream

    # Fail fast on undecodable input before any device or weight work.
    if args.input != "-" and not args.raw:
        if not os.path.exists(args.input):
            raise SystemExit(f"no such file: {args.input}")
        try:
            audio_io.check_decodable(args.input)
        except audio_io.UnsupportedFormatError as e:
            raise SystemExit(str(e))
    cfg = SeparatorConfig(
        bin_limit=args.bin_limit // 64 * 64,
        time_step=max(64, args.time_step // 64 * 64),
        num_stems=4,
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
    )
    device = cli.open_device(args.device)
    stacked = cli.load_weights(args.weights, args.random_weights, 0, cfg,
                               device)["stacked_params"]

    latency = (2 * cfg.time_step + 1) * stream.HOP
    print(f"engine latency: {latency} samples "
          f"({latency / 44100.0:.2f} s at 44.1 kHz)", file=sys.stderr)

    sep = stream.StreamingSeparator(stacked, cfg)
    order = STEM_ORDERS[args.channel_order]
    outs = []
    t0 = time.perf_counter()
    n_in = 0
    for chunk in _chunks(args):
        n_in += chunk.shape[1]
        outs.append(sep.process(chunk)[list(order)])
    dt = time.perf_counter() - t0
    result = np.concatenate(outs, axis=-1) if outs else np.zeros((4, 2, 0))
    print(f"processed {n_in} samples in {dt:.3f} s "
          f"({n_in / 44100.0 / max(dt, 1e-9):.1f}x real time, includes the "
          f"kernel build on first use)", file=sys.stderr)

    stem_names = [STEMS_4[i] for i in order]
    if args.split:
        os.makedirs(args.output, exist_ok=True)
        for name, stem in zip(stem_names, result):
            audio_io.write_wav(os.path.join(args.output, f"{name}.wav"), stem)
            print(f"wrote {args.output}/{name}.wav", file=sys.stderr)
    else:
        path = args.output if args.output.endswith(".wav") else args.output + ".wav"
        audio_io.write_wav(path, result.reshape(8, -1))
        print(f"wrote {path} (8 channels, order {', '.join(stem_names)})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
