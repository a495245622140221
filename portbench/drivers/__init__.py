"""Traffic drivers: the code that a traffic mix's `driver` key names, each
a module `drivers/<name>.py` that `spec.driver(name)` loads by its path.

A driver builds the system under test from the cell's configuration and
the seed, warms up the shapes its traffic uses, runs a measured window, and
afterwards judges a sample of the window's answers against the plain
reference. `offline` (any model family: weights, program, reference and
shapes from `families/<family>.py`) and `stream` are closed loops with one
caller; `http` is an open loop of uploads from a child process. `stream`
and `http` run Spleeter's streaming engine and server, and refuse a
configuration of another family at set-up.

A driver module declares `Driver` and `SMALL`, the parameters that cut its
mixes to a size the CPU tests run in seconds. The faults its cells can have
are the family's (`FAULTS[driver]`). Every driver has the same surface,
which run.py calls in this order: `setup()`, `window(seconds, spans, keep)`
(more than once: the measured window, and in a traced run a traced one),
`release()` (frees the program's state), `check(samples)` (the numbers
compared, by name; none where nothing was kept, which the run counts as not
correct), and `unit_shapes()` / `audio_per_unit`, which the metric readers
use. `use_reference(precision)` puts the reference in the program's place
(the control, portbench/control.py).
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from portbench import spec
from portbench.inputs import SAMPLE_RATE


@dataclasses.dataclass
class Window:
    """What one measured window did."""

    window_s: float
    latencies_s: list[float]  # each call, block step or request
    attempted: int
    failed: int
    samples: list  # the kept answers, for check()
    units: int  # calls or block steps completed (requests: answered)
    audio_s: float = 0.0  # audio seconds completed


class Sampler:
    """Reservoir sampling of `k` of the answers offered, every answer as
    likely, with choices drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(call, seconds: float, device, spans, sampler: Sampler | None,
                audio_per_unit: float) -> Window:
    """One caller: `call(i)` enqueues unit i and returns its answer, the
    device is synchronised, the next unit follows. Runs until `seconds`
    have passed; the window ends with the last unit, so every unit counted
    is complete and all of its time is in the window."""
    latencies = []
    start = time.perf_counter()
    i = 0
    while True:
        t0, s0 = time.perf_counter(), time.time_ns()
        answer = call(i)
        s1 = time.time_ns()
        sync(device)
        t1, s2 = time.perf_counter(), time.time_ns()
        spans.add("graph.enqueue", s0, s1)
        spans.add("graph.sync", s1, s2)
        latencies.append(t1 - t0)
        if sampler is not None:
            sampler.offer(answer)
        del answer
        i += 1
        if t1 - start >= seconds:
            break
    return Window(t1 - start, latencies, i, 0,
                  sampler.items if sampler is not None else [], i,
                  i * audio_per_unit)


def warm_up(call, n: int, device) -> str:
    """Units 0..n-1, each synchronised; -> how long the inputs took before
    it, the first unit and the rest (the driver's set-up note)."""
    t0 = time.perf_counter()
    sync(device)
    t1 = time.perf_counter()
    for i in range(n):
        call(i)
        sync(device)
        if i == 0:
            t2 = time.perf_counter()
    t3 = time.perf_counter()
    return (f"inputs synchronised {t1 - t0:.3f} s, first unit {t2 - t1:.3f} s, "
            f"{n - 1} more {t3 - t2:.3f} s")


def require_spleeter(cfg: dict, driver: str) -> None:
    """ValueError where the configuration is not of Spleeter's family."""
    if spec.family_name(cfg) != "spleeter":
        raise ValueError(
            f"the {driver} driver runs Spleeter's program only; configuration "
            f"{cfg.get('name')!r} is of the family {spec.family_name(cfg)!r}")


# A reading that is not a finite number (a NaN or an infinity in the
# answer, or an answer of the wrong shape) reads as this.
NOT_FINITE = 1e30
CHECKS = ("rel_l2_fp8", "peak_fp8")


def stem_errors(y: torch.Tensor, ref: torch.Tensor, ref8: torch.Tensor) -> dict[str, float]:
    """The worst stem of (stems, ..., n) answers `y` against the float32
    reference `ref`, in units of the float8 reference's own error on the
    same nets and input (`ref8`, the control's computation):

    - `rel_l2_fp8` = |y - ref| / |ref8 - ref| (2-norms a stem);
    - `peak_fp8` = max |y - ref| / max |ref8 - ref| (a stem).

    The yardstick moves with the nets drawn from the seed (how many of
    their mask logits sit where the sigmoid is steep), and the program's
    bf16 error moves with it, so the ratio holds steady from seed to seed
    where the error alone moves 4x. The control itself reads about 1."""
    if y.shape != ref.shape:
        return dict.fromkeys(CHECKS, NOT_FINITE)
    y, ref, ref8 = (t.double().flatten(1) for t in (y, ref, ref8))
    d, d8 = y - ref, ref8 - ref
    rel = d.norm(dim=1) / d8.norm(dim=1).clamp_min(1e-30)
    peak = d.abs().amax(dim=1) / d8.abs().amax(dim=1).clamp_min(1e-30)

    def worst(x):
        v = float(x.max())
        return v if torch.isfinite(x).all() and v == v else NOT_FINITE

    return {"rel_l2_fp8": worst(rel), "peak_fp8": worst(peak)}


def merge_worst(acc: dict, new: dict) -> dict:
    return {k: max(acc.get(k, 0.0), v) for k, v in new.items()}
