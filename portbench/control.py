"""The readings that set the limits of `correct`: the control, and the
faults the check has to catch.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 --seconds 3 [--faults]

runs the cell's whole flow (set-up, a short window at the cell's own load,
the check) once a seed with the reference in float8 (e4m3, one scale a
tensor, for the bf16 the configurations state) put in the program's place,
and with `--faults` once a seed and fault with that fault planted in the
program. It prints one JSON line a run: the readings and what the limits
make of them. The benchmark's own runs never run this.

Faults (`FAULTS`), each a context manager that patches the program:
`altered` (one stem of every answer loses one 4096-sample block where the
graph returns it; `altered_step` the same in a streaming block step),
`half_batch` (the masks of the second half of the
U-Net's images, tiles or streams, are dropped), `state_unchanged` (a
streaming block step hands back the state it was given).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _altered(fn):
    def wrapper(*args, **kwargs):
        stems = fn(*args, **kwargs)
        first = next(iter(stems))
        x = stems[first].clone()
        x[..., x.shape[-1] // 2 : x.shape[-1] // 2 + 4096] = 0.0
        return {**stems, first: x}

    return wrapper


def _altered_step(fn):
    def wrapper(*args, **kwargs):
        state, out = fn(*args, **kwargs)
        out = out.clone()
        out[:, 0, :, out.shape[-1] // 2 : out.shape[-1] // 2 + 4096] = 0.0
        return state, out

    return wrapper


def _half_batch(fn):
    def wrapper(*args, **kwargs):
        masks = fn(*args, **kwargs).clone()
        masks[:, masks.shape[1] // 2 :] = 0.0
        return masks

    return wrapper


def _state_unchanged(fn):
    def wrapper(params, state, *args, **kwargs):
        _, out = fn(params, state, *args, **kwargs)
        return state, out

    return wrapper


def fault(name: str):
    """A context manager that plants fault `name` in the program."""
    from spleeterrt_tpu_torch.core import model, separate
    from spleeterrt_tpu_torch.runtime import stream

    if name == "altered":
        return _patched(separate, "separate", _altered)
    if name == "half_batch":
        return _patched(model, "packed_unet_masks", _half_batch)
    if name == "altered_step":
        return _patched(stream, "block_step_streams", _altered_step)
    if name == "state_unchanged":
        return _patched(stream, "block_step_streams", _state_unchanged)
    raise ValueError(f"unknown fault {name!r}")


# The faults each driver's cells can have.
FAULTS = {
    "offline": ("altered", "half_batch"),
    "stream": ("altered_step", "state_unchanged", "half_batch"),
    "http": ("altered", "half_batch"),
}


def control_run(cell, seed: int, seconds: float, device) -> dict:
    from portbench import run

    return run.measure(cell, seed, seconds, False, device, time.perf_counter(),
                       prepare=lambda d: d.use_reference("fp8"))


def fault_run(cell, seed: int, seconds: float, device, name: str) -> dict:
    from portbench import run

    with fault(name):
        return run.measure(cell, seed, seconds, False, device, time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    from portbench import run, spec

    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        kinds = [("control", None)]
        if args.faults:
            kinds += [("fault", f) for f in FAULTS[cell.driver]]
        for kind, name in kinds:
            if name is None:
                out = control_run(cell, seed, args.seconds, device)
            else:
                out = fault_run(cell, seed, args.seconds, device, name)
            print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                              "fault": name, "correct": out["correct"],
                              "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
