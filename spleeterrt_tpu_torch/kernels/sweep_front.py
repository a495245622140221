"""Time the two kernels at the U-Net's input end at several shapes on one
CUDA card: K1 (csrc/stft.cu, the fused STFT) over its 128-thread groups a
block, and bf16 K2 (csrc/encoder.cu::enc1_mma_kernel, enc1's tensor-core
template) over its pixel tile, at the 300 s shapes of the 4-stem VST graph
and of the 2-stem exe graph.

    python -m spleeterrt_tpu_torch.kernels.sweep_front [--seconds 300]

K1's groups are an argument of its launch, so every value runs from the
package's library (called directly, with the wrapper's checks done here);
each pixel tile of K2 is built into a library of its own under
build/sweep_front/ (one nvcc per tile, all started together). Every shape
is checked against the plain version (K1 to 1e-5 of max|X|, K2 to 2 bf16
ulps of max|plain|) and bit for bit over two runs; a shape that fails is
reported and not timed. The shapes take turns over three rounds and the
best round is kept. Prints one line per shape with its time and its
registers, shared memory, threads and resident blocks an SM, and the
card's nvidia-smi line. The shapes the package launches
(stft_fused.STFT_GROUPS, ENC1_MMA in csrc/encoder.cu) were chosen from
this table.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from spleeterrt_tpu_torch.config import TransformConfig
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.kernels import (
    ACT_CODES,
    _build,
    encoder,
    epilogue_table,
    irfft_twiddles,
    launch,
    stft_fused,
    stream_of,
)
from spleeterrt_tpu_torch.kernels.sweep_ends import _attrs_line, _time

GROUPS = (1, 2, 3, 4)  # K1: 128-thread groups (frames) a block
# K2: output rows, output columns and warps a block.
# The first is also timed with the other encoder activation and ReLU, which
# shows the share of the ELU in the epilogue.
ENC1_TILES = ((8, 128, 8), (8, 64, 8), (4, 64, 8), (4, 64, 4), (2, 64, 4),
              (8, 32, 4), (16, 32, 8), (2, 128, 8), (4, 128, 8), (16, 64, 8))
# (stems, rows, bin_limit, time_step, encoder activation) of the two graphs.
GRAPHS = {"4 stems, VST": (4, 2, 1536, 256, "elu"),
          "2 stems, exe": (1, 2, 1024, 512, "leaky")}
SR = 44100

_SOURCE = """#include "{enc}"
extern "C" int sweep_launch(const void* mag, const void* wk, const void* epi,
                            int n_stems, int n_tiles, int H, int W, int act,
                            void* skip, void* actv, void* stream) {{
  return spleeterrt::launch_enc1_mma<{th}, {tw}, {warps}>(mag, wk, epi, n_stems,
      n_tiles, H, W, act, skip, actv, static_cast<cudaStream_t>(stream));
}}
extern "C" int sweep_attrs(int n_stems, int* attrs) {{
  return spleeterrt::enc1_mma_attrs<{th}, {tw}, {warps}>(n_stems, attrs);
}}
"""


def _build_tile(tile: tuple[int, int, int]) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR.parent / "sweep_front"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = "enc1_{}_{}_{}".format(*tile)
    src = out_dir / f"{stem}.cu"
    th, tw, warps = tile
    src.write_text(_SOURCE.format(enc=_build.CSRC / "encoder.cu", th=th, tw=tw,
                                  warps=warps))
    lib = out_dir / f"lib{stem}.so"
    _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)])
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.sweep_launch.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
    so.sweep_launch.restype = i
    so.sweep_attrs.argtypes = [i, ctypes.POINTER(i)]
    so.sweep_attrs.restype = i
    return so


def _frames(seconds: float, time_step: int) -> tuple[int, int, int]:
    """(data_size, n_comp, n_req) of a `seconds` track padded as the offline
    graphs pad it (core/transform.py, core/separate.py)."""
    tcfg = TransformConfig()
    data_size = transform.offline_pad_sizes(int(seconds * SR), tcfg)[1]
    n_out = transform.num_output_frames(data_size, tcfg)
    n_req = -(-n_out // time_step) * time_step
    return data_size, transform.num_computed_frames(data_size, tcfg), n_req


def _best(runs: dict, rounds: int = 3) -> None:
    """runs: shape -> [error, ms, fn]; keeps each shape's best round."""
    for _ in range(rounds):
        for r in runs.values():
            r[1] = min(r[1], _time(r[2]))


def sweep_stft(dev, seconds: float) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    window = transform.analysis_window(4096, device=dev)
    for graph, (_, rows, bin_limit, t, _) in GRAPHS.items():
        data_size, n_comp, n_req = _frames(seconds, t)
        audio = torch.randn((rows, data_size), generator=gen, device=dev) * 0.3
        pspec, pmag = stft_fused.stft4096_plain(audio, window, n_comp, n_req, bin_limit, t)
        bound = 1e-5 * pspec.abs().max().item()
        spec, mag = torch.empty_like(pspec), torch.empty_like(pmag)

        def run(groups):
            launch(stft_fused._lib().spleeterrt_stft4096, audio.data_ptr(), rows,
                   data_size, window.data_ptr(), irfft_twiddles(dev).data_ptr(), n_comp,
                   n_req, bin_limit, t, groups, spec.data_ptr(), mag.data_ptr(),
                   stream_of(dev))

        ok = {}
        for groups in GROUPS:
            run(groups)
            first = (spec.clone(), mag.clone())
            run(groups)
            err = max((first[0] - pspec).abs().max().item(),
                      (first[1] - pmag).abs().max().item())
            same = torch.equal(first[0], spec) and torch.equal(first[1], mag)
            if not (err <= bound and same):
                print(f"[sweep] K1 {graph}, {groups} groups: WRONG, max error {err:.3e} "
                      f"(bound {bound:.3e}), bit-identical {same}", flush=True)
                continue
            ok[groups] = [err, float("inf"), lambda g=groups: run(g)]
        del first
        _best(ok)
        for groups, (err, ms, _) in ok.items():
            a = stft_fused.stft_attributes(dev, groups)
            print(f"[sweep] K1 {graph} ({rows} rows x {n_req} frames, bin_limit "
                  f"{bin_limit}), {groups} groups a block: {ms:.4f} ms, max error "
                  f"{err:.3e}; {_attrs_line(list(a.values()))}", flush=True)
        del audio, pspec, pmag, spec, mag


def sweep_enc1(dev, seconds: float, libs: dict) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    for graph, (n_stems, _, bin_limit, t, act) in GRAPHS.items():
        n_tiles = _frames(seconds, t)[2] // t
        mag = torch.rand((n_tiles, 2, t, bin_limit), generator=gen, device=dev) * 5
        w = torch.randn((n_stems, 16, 2, 5, 5), generator=gen, device=dev) * 0.2
        b, scale, shift = (m + v * torch.randn((n_stems, 16), generator=gen, device=dev)
                           for m, v in ((0.0, 0.1), (1.0, 0.3), (0.0, 0.2)))
        ref = encoder.enc1_plain(mag, w, b, scale, shift, act=act, dtype=torch.bfloat16)
        top = max(r.float().abs().max().item() for r in ref)
        bound = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)  # 2 bf16 ulps
        wk = encoder._conv_weights(w, torch.bfloat16)
        epi = epilogue_table(b, scale, shift)
        skip, actv = torch.empty_like(ref[0]), torch.empty_like(ref[1])

        def run(so, code=ACT_CODES[act]):
            launch(so.sweep_launch, mag.data_ptr(), wk.data_ptr(), epi.data_ptr(), n_stems,
                   n_tiles, t, bin_limit, code, skip.data_ptr(), actv.data_ptr(),
                   stream_of(dev))

        ok = {}
        for tile, so in libs.items():
            run(so)
            first = (skip.clone(), actv.clone())
            run(so)
            err = max((f.float() - r.float()).abs().max().item() for f, r in zip(first, ref))
            same = torch.equal(first[0], skip) and torch.equal(first[1], actv)
            if not (err <= bound and same):
                print(f"[sweep] K2 {graph}, tile {tile}: WRONG, max error {err:.3e} "
                      f"(bound {bound:.3e}), bit-identical {same}", flush=True)
                continue
            ok[tile] = [err, float("inf"), lambda so=so: run(so)]
        del first
        _best(ok)
        for tile, (err, ms, _) in ok.items():
            attrs = (ctypes.c_int * 4)()
            launch(libs[tile].sweep_attrs, n_stems, attrs)
            print(f"[sweep] K2 bf16 enc1_mma_kernel {graph} ({n_stems} stems x "
                  f"{n_tiles} tiles of {t} x {bin_limit}), {tile[0]} rows x {tile[1]} "
                  f"columns, {tile[2]} warps: {ms:.4f} ms, max error {err:.3e} (bound "
                  f"{bound:.3e}); {_attrs_line(attrs)}", flush=True)
        tile = ENC1_TILES[0]
        for other in ACT_CODES:
            if other != act:
                ms = min(_time(lambda: run(libs[tile], ACT_CODES[other])) for _ in range(3))
                print(f"[sweep] K2 {graph}, tile {tile}, with {other} in place of {act}: "
                      f"{ms:.4f} ms (not checked)", flush=True)
        del mag, ref, skip, actv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=300.0,
                    help="audio length whose shapes are timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_front: no CUDA device is available")
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(max_workers=len(ENC1_TILES) + 1) as pool:
        main_lib = pool.submit(_build.load)
        libs = dict(zip(ENC1_TILES, pool.map(_build_tile, ENC1_TILES)))
        main_lib.result()
    sweep_stft(dev, args.seconds)
    sweep_enc1(dev, args.seconds, libs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
