"""The benchmark of `spleeterrt_tpu_torch` on NVIDIA H100s: one run of one
cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run builds the cell's system from the
seed (weights and audio made on the device), warms up every shape its
traffic uses (set-up, `setup_s`), measures for `--seconds`, and with
`--trace 1` then profiles a short window of the same traffic. Once the
windows have closed it reads the peak memory, frees the program's state and
judges a sample of the window's answers against the plain float32
reference (`portbench/reference/`). Its last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
`breakdown` (traced runs) and `checks`, each number compared with its
limit, which are also the last lines on standard error.

It exits with another code than 0 and prints no result where there is no
CUDA device, fewer than the cell asks for, or where a module of JAX or of
the JAX package `spleeterrt_tpu` has been loaded once the windows closed.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names a run may not hold: JAX and the JAX package the
# program was ported from. Compared whole: `spleeterrt_tpu_torch` is not
# `spleeterrt_tpu`.
FORBIDDEN = ("jax", "jaxlib", "flax", "spleeterrt_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout; the
    program's own kernel library goes to build/kernels by itself."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.partition(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric reader (`portbench/metrics/<name>.py::read`) sees."""

    cell: object  # spec.Cell
    setup_s: float
    window: object  # drivers.Window of the measured window
    spans: object  # trace.Spans of the measured window
    shapes: dict | None  # one unit's shape variables (None: no fixed unit)
    stages: dict  # spec.stages()
    trace: object = None  # trace.DeviceTrace of the traced window
    traced: object = None  # drivers.Window of the traced window
    traced_spans: object = None


def breakdown(run: Run) -> dict:
    from portbench.trace import short_name

    ops: dict[str, float] = {}
    for name, s in run.trace.seconds_by_name().items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + s
    gaps = run.trace.idle_by_span(run.traced_spans)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def measure(cell, seed: int, seconds: float, trace: bool, device, start: float,
            prepare=None) -> dict:
    """One run of `cell` (a spec.Cell) on `device` -> the result's fields.
    `prepare`, if given, is called with the driver after set-up (the
    control and the fault tests put something in the program's place
    there)."""
    import torch

    from portbench import spec
    from portbench.trace import DeviceTrace, Spans

    bench = spec.benchmark()
    driver = spec.driver(cell.driver).Driver(cell, seed, device)
    try:
        ready = time.perf_counter()
        driver.setup()
        if prepare is not None:
            prepare(driver)
        setup_s = time.perf_counter() - start
        print(f"set-up: {ready - start:.3f} s to the driver (imports, the device), "
              f"{setup_s - (ready - start):.3f} s in it ({driver.setup_note})",
              file=sys.stderr, flush=True)
        spans = Spans()
        window = driver.window(seconds, spans, keep=True)
        run = Run(cell, setup_s, window, spans, driver.unit_shapes(), spec.stages())
        if trace:
            run.traced_spans = Spans()
            with DeviceTrace() as tr:
                run.traced = driver.window(cell.params["trace_seconds"],
                                           run.traced_spans, keep=False)
            run.trace = tr
        cuda = device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        samples, window.samples = window.samples, None
    finally:
        driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.check(samples)
    del samples
    checks = {name: [readings.get(name), limit] for name, limit in cell.checks.items()}
    checks["failed"] = [window.failed, 0]
    correct = all(v is not None and v <= lim for v, lim in checks.values())
    metrics = {}
    for m in spec.cell_metrics(bench, cell.name, trace):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
    out = {"correct": correct, "attempted": window.attempted,
           "failed": window.failed, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown(run)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()

    import torch

    from portbench import spec

    cell = spec.cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"available. No result.", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                  _START)
    out["device"]["power_limit_w"] = power_limit_w()
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result.",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
