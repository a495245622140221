"""The sweep that fixed the rate of an open-loop cell: one set-up, then a
window at each rate, lowest first.

    python3 -m portbench.sweep --workload vst4-http-clips --seed 1 --seconds 20 --rates 10 15 20

For each rate it prints one JSON line: requests, failed, the median and
95th percentile latency, and the median latency of the last quarter of
the window over that of the first (above 1 where a backlog grows). The
knee is the highest rate with no growing backlog; the upload cell's file
holds a rate above it as a number, so that its `rtf` is the rate the
service answers at. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    from portbench import run, spec

    run.cache_dirs()
    import torch

    from portbench.drivers import http
    from portbench.trace import Spans

    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    driver = http.Driver(cell, args.seed, torch.device("cuda", 0))
    driver.setup()
    try:
        for rate in sorted(args.rates):
            driver.p = {**driver.p, "rate": rate}
            w = driver.window(args.seconds, Spans(), keep=False)
            lat = sorted(w.latencies_s)
            q = max(1, len(w.latencies_s) // 4)
            growth = (statistics.median(w.latencies_s[-q:])
                      / statistics.median(w.latencies_s[:q]))
            print(json.dumps({
                "rate": rate, "requests": w.attempted, "failed": w.failed,
                "answered_per_s": w.units / w.window_s,
                "p50_ms": statistics.median(lat) * 1e3,
                "p95_ms": statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3,
                "last_over_first_quarter": growth,
            }), flush=True)
    finally:
        driver.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
