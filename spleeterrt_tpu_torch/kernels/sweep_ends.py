"""Time the two kernels at the U-Net's output ends at several shapes on one
CUDA card: K7 (csrc/istft.cu, the fused masked iSTFT) over its run length
and groups a block, and bf16 K6 (csrc/head.cu::head_mma_kernel, the head's
tensor-core template) over its mask tile, at the 300 s shapes of the
4-stem VST graph (K7 also at the 2-stem exe graph's, where it runs with
one stem).

    python -m spleeterrt_tpu_torch.kernels.sweep_ends [--seconds 300]

K7's run length and groups are arguments of its launch, so every pair
runs from the package's library (called directly, with the wrapper's
checks done here); each mask tile of K6 is built into a
library of its own under build/sweep_ends/ (one nvcc per tile, all
started together). Every shape is checked against the plain version (K7
to 1e-5 of max(1, max|plain|), K6 per pixel to tail.head_error_bound)
and bit for bit over two runs; a shape that fails is reported and not
timed. The shapes take turns over three rounds and the best round is
kept. Prints one line per shape with its time and its registers, shared
memory, threads and resident blocks an SM, and the card's nvidia-smi
line. The shapes the package launches (stft_fused.RUN_HOPS and
ISTFT_GROUPS, HEAD_MMA in csrc/head.cu) were chosen from this table.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from spleeterrt_tpu_torch.kernels import (
    _build,
    irfft_twiddles,
    launch,
    stft_fused,
    stream_of,
    tail,
)

RUNS = (16, 32, 64, 128)  # K7: output hops a group walks
GROUPS = (1, 2, 4)  # K7: 128-thread groups a block
HEAD_TILES = ((32, 56), (16, 56), (32, 120), (64, 56), (16, 120))  # K6: TY, TX
# (stems, rows, bin_limit, time_step, out_band) of K7's two graphs.
ISTFT_GRAPHS = {"4 stems, VST": (4, 2, 1536, 256, (1.0, 1.0, 1.0, 1.0)),
                "2 stems, exe": (1, 2, 1024, 512, (0.0,))}
SR = 44100

_SOURCE = """#include "{head}"
extern "C" int sweep_launch(const void* skip1, const void* up5, const void* w6k,
                            const void* w7k, const void* scal, int n_img, int bper,
                            int H2, int W2, int act, void* masks, void* stream) {{
  return spleeterrt::launch_head_mma<16, {ty}, {tx}>(skip1, up5, w6k, w7k, scal,
      n_img, bper, H2, W2, act, masks, static_cast<cudaStream_t>(stream));
}}
extern "C" int sweep_attrs(int* attrs) {{
  return spleeterrt::head_mma_attrs<16, {ty}, {tx}>(attrs);
}}
"""


def _build_tile(tile: tuple[int, int]) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR.parent / "sweep_ends"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = "head_{}_{}".format(*tile)
    src = out_dir / f"{stem}.cu"
    src.write_text(_SOURCE.format(head=_build.CSRC / "head.cu", ty=tile[0], tx=tile[1]))
    lib = out_dir / f"lib{stem}.so"
    _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)])
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.sweep_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p]
    so.sweep_launch.restype = i
    so.sweep_attrs.argtypes = [ctypes.POINTER(i)]
    so.sweep_attrs.restype = i
    return so


def _time(fn, iters: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attrs_line(attrs) -> str:
    return (f"{attrs[0]} registers, {attrs[1]} B shared, {attrs[2]} threads, "
            f"{attrs[3]} blocks an SM")


def sweep_istft(dev, seconds: float) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    n_frames = int(seconds * SR) // 1024 + 4
    for graph, (n_stems, rows, bin_limit, t, ob) in ISTFT_GRAPHS.items():
        nt = -(-n_frames // t)
        spec = torch.complex(*torch.randn((2, rows, nt * t, 2049), generator=gen,
                                          device=dev))
        masks = torch.rand((n_stems, nt, rows, t, bin_limit), generator=gen, device=dev)
        out_band = torch.tensor(ob, device=dev)
        window = torch.hann_window(4096, device=dev)
        ref = stft_fused.masked_istft4096_plain(spec, masks, out_band, window, n_frames)
        bound = 1e-5 * max(1.0, ref.abs().max().item())
        out = torch.empty_like(ref)

        def run(run_hops, groups):
            launch(stft_fused._lib().spleeterrt_masked_istft4096, spec.data_ptr(),
                   masks.data_ptr(), out_band.data_ptr(), window.data_ptr(),
                   irfft_twiddles(dev).data_ptr(), n_stems, rows, n_frames, nt * t, nt,
                   t, bin_limit, run_hops, groups, out.data_ptr(), stream_of(dev))

        ok = {}
        for shape in [(r, g) for r in RUNS for g in GROUPS]:
            run(*shape)
            first = out.clone()
            run(*shape)
            err = (first - ref).abs().max().item()
            same = torch.equal(first, out)
            if not (err <= bound and same):
                print(f"[sweep] K7 {graph}, run {shape[0]}, groups {shape[1]}: WRONG, max "
                      f"error {err:.3e} (bound {bound:.3e}), bit-identical {same}", flush=True)
                continue
            ok[shape] = [err, float("inf")]
        del first
        for _ in range(3):
            for shape, r in ok.items():
                r[1] = min(r[1], _time(lambda: run(*shape)))
        for (run_hops, groups), (err, ms) in ok.items():
            a = stft_fused.istft_attributes(dev, groups)
            print(f"[sweep] K7 {graph} ({n_stems} x {rows} x {n_frames} frames, "
                  f"bin_limit {bin_limit}), run {run_hops} hops, {groups} groups a block: "
                  f"{ms:.4f} ms, max error {err:.3e}; {_attrs_line(list(a.values()))}",
                  flush=True)
        del spec, masks, ref, out


def sweep_head(dev, seconds: float, libs: dict) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    n_img = 4 * -(-(int(seconds * SR) // 1024 + 4) // 256)  # 4 stems x tiles
    h2, w2, n_stems = 128, 768, 4
    skip1, up5 = (torch.randn((n_img, h2, w2, 16), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
    w6 = torch.randn((n_stems, 32, 1, 5, 5), generator=gen, device=dev) * 0.05
    w7 = torch.randn((n_stems, 2, 1, 4, 4), generator=gen, device=dev) * 0.3
    b6, s6, h6 = (m + v * torch.randn((n_stems, 1), generator=gen, device=dev)
                  for v, m in ((0.1, 0.0), (0.3, 1.0), (0.2, 0.0)))
    b7 = 0.1 * torch.randn((n_stems, 2), generator=gen, device=dev)
    args = (skip1, up5, w6, b6, s6, h6, w7, b7)
    ref = tail.head_plain(*args, act="elu")
    bound = tail.head_error_bound(*args, act="elu")
    w6k, w7k, scal = tail.head_operands(w6, b6, s6, h6, w7, b7, torch.bfloat16)
    out = torch.empty_like(ref)

    def run(so):
        launch(so.sweep_launch, skip1.data_ptr(), up5.data_ptr(), w6k.data_ptr(),
               w7k.data_ptr(), scal.data_ptr(), n_img, n_img // n_stems, h2, w2, 0,
               out.data_ptr(), stream_of(dev))

    ok = {}
    for tile, so in libs.items():
        run(so)
        first = out.clone()
        run(so)
        worst = ((first - ref).abs() / bound).max().item()
        same = torch.equal(first, out)
        if not (worst <= 1 and same):
            print(f"[sweep] K6 tile {tile}: WRONG, largest error / bound {worst:.3e}, "
                  f"bit-identical {same}", flush=True)
            continue
        ok[tile] = [worst, float("inf")]
    del first
    for _ in range(3):
        for tile, r in ok.items():
            r[1] = min(r[1], _time(lambda: run(libs[tile])))
    for tile, (worst, ms) in ok.items():
        attrs = (ctypes.c_int * 4)()
        launch(libs[tile].sweep_attrs, attrs)
        print(f"[sweep] K6 bf16 head_mma_kernel, mask tile {tile[0]} x {tile[1]} "
              f"({n_img} images of {2 * h2} x {2 * w2}): {ms:.4f} ms, largest error / "
              f"bound {worst:.3e}; {_attrs_line(attrs)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=300.0,
                    help="audio length whose shapes are timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_ends: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(max_workers=len(HEAD_TILES) + 1) as pool:
        main_lib = pool.submit(_build.load)
        libs = dict(zip(HEAD_TILES, pool.map(_build_tile, HEAD_TILES)))
        main_lib.result()
    sweep_istft(dev, args.seconds)
    sweep_head(dev, args.seconds, libs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
