"""Time bf16 up4/up5's tensor-core template at several tile shapes on one
CUDA card, at the 4-stem VST graph's 300 s shapes.

    python -m spleeterrt_tpu_torch.kernels.sweep_up [--images 204]

Each shape of csrc/tail.cu::up_mma_kernel (CS, COUT, WG, KC, NSTAGE; see
UpMma there) is built into a library of its own under
build/sweep_up/ (one nvcc per shape, all started together), checked
against tail.up_shallow_plain to UNET_BF16_ULPS bf16 ulps of max|plain|
and bit for bit over two runs (a shape that fails is reported and not
timed), and timed with CUDA events; the shapes take turns over three
rounds and the best round is kept. Prints one line per shape with its
registers, shared memory, threads and resident blocks an SM, and the
card's nvidia-smi line. The shapes that csrc/tail.cu launches (UP4_MMA,
UP5_MMA) were chosen from this table.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from spleeterrt_tpu_torch.kernels import _build, epilogue_table, launch, stream_of, tail

UNET_BF16_ULPS = 2
# (WG, KC, NSTAGE) per CS; COUT = CS / 2.
SHAPES = {
    64: ((4, 16, 2), (4, 16, 3), (2, 16, 2), (1, 16, 2), (2, 32, 2)),
    32: ((4, 16, 3), (4, 16, 2), (4, 32, 2), (2, 16, 3), (2, 32, 3)),
}
# Input-resolution sizes of up4 and up5 in the VST graph (time_step 256,
# bin_limit 1536): T/8 x F/8 and T/4 x F/4.
SIZES = {64: (32, 192), 32: (64, 384)}

_SOURCE = """#include "{tail}"
extern "C" int sweep_launch(const void* skip, const void* prev, const void* wk,
                            const void* epi, int n_img, int bper, int H, int W,
                            int act, void* out, void* stream) {{
  return spleeterrt::launch_up_mma<{params}>(skip, prev, wk, epi, n_img, bper,
      H, W, act, out, static_cast<cudaStream_t>(stream));
}}
extern "C" int sweep_attrs(int* attrs) {{
  return spleeterrt::up_mma_attrs<{params}>(attrs);
}}
"""


def _build_shape(cs: int, shape: tuple) -> ctypes.CDLL:
    params = ", ".join(map(str, (cs, cs // 2, *shape)))
    out_dir = _build.BUILD_DIR.parent / "sweep_up"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = "up_" + "_".join(map(str, (cs, *shape)))
    src = out_dir / f"{stem}.cu"
    src.write_text(_SOURCE.format(tail=_build.CSRC / "tail.cu", params=params))
    lib = out_dir / f"lib{stem}.so"
    _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)])
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.sweep_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=204,
                    help="stem x tile images (204: 4 stems x 51 tiles, 300 s)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_up: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    jobs = [(cs, shape) for cs, shapes in SHAPES.items() for shape in shapes]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda job: _build_shape(*job), jobs))
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for cs in SHAPES:
        h, w = SIZES[cs]
        n_img, n_stems = args.images, 4
        skip, prev = (torch.randn((n_img, h, w, cs), generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
        wt = torch.randn((n_stems, 2 * cs, cs // 2, 5, 5), generator=gen,
                         device=dev) * math.sqrt(2.0 / (50 * cs))
        b, scale, shift = (v * torch.randn((n_stems, cs // 2), generator=gen, device=dev)
                           + m for v, m in ((0.1, 0.0), (0.3, 1.0), (0.2, 0.0)))
        ref = tail.up_shallow_plain(skip, prev, wt, b, scale, shift, act="elu").float()
        bound = UNET_BF16_ULPS * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        wk = tail._up_weights(wt, torch.bfloat16)
        epi = epilogue_table(b, scale, shift)
        out = torch.empty((n_img, 2 * h, 2 * w, cs // 2), dtype=torch.bfloat16, device=dev)
        mine = [(shape, so) for (c, shape), so in zip(jobs, libs) if c == cs]

        def run(so):
            launch(so.sweep_launch, skip.data_ptr(), prev.data_ptr(), wk.data_ptr(),
                   epi.data_ptr(), n_img, n_img // n_stems, h, w, 0, out.data_ptr(),
                   stream_of(dev))

        for shape, so in mine:
            run(so)
            first = out.clone()
            run(so)
            err = (first.float() - ref).abs().max().item()
            same = torch.equal(first, out)
            if not (err <= bound and same):
                print(f"[sweep] {tail.UP_WIDTHS[cs]} {shape}: WRONG, max error {err:.3e} "
                      f"(bound {bound:.3e}), bit-identical {same}", flush=True)
                continue
            results[cs, shape] = {"err": err, "ms": float("inf")}
        mine = [(shape, so) for shape, so in mine if (cs, shape) in results]
        for _ in range(3):
            for shape, so in mine:
                ms = _time(lambda: run(so))
                results[cs, shape]["ms"] = min(results[cs, shape]["ms"], ms)
        for shape, so in mine:
            attrs = (ctypes.c_int * 4)()
            launch(so.sweep_attrs, attrs)
            r = results[cs, shape]
            print(f"[sweep] {tail.UP_WIDTHS[cs]} up_mma_kernel(CS, COUT, WG, KC, NSTAGE) "
                  f"= {(cs, cs // 2, *shape)}: {r['ms']:.4f} ms, max error {r['err']:.3e} "
                  f"(bound {bound:.3e}); {attrs[0]} registers, {attrs[1]} B shared, "
                  f"{attrs[2]} threads, {attrs[3]} blocks an SM", flush=True)
        del skip, prev, ref, out
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
