"""The readings that set the limits of `correct`: the control, and the
faults the check has to catch.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 --seconds 3 [--faults]

runs the cell's whole flow (set-up, a short window at the cell's own load,
the check) once a seed with the reference in float8 (e4m3, one scale a
tensor, for the bf16 the configurations state) put in the program's place,
and with `--faults` once a seed and fault with that fault planted in the
program. It prints one JSON line a run: the readings and what the limits
make of them. The benchmark's own runs never run this.

The faults are the cell's family's, for the cell's driver
(`families/<family>.py::FAULTS[driver]`), each a context manager that
patches the program. A family that defines none for the driver runs the
control alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def faults(cell) -> dict:
    """{fault: factory of the context manager that plants it}: the faults
    of the cell's family on the cell's driver (none where the family
    defines none)."""
    from portbench import spec

    return spec.family(cell.config).FAULTS.get(cell.driver, {})


def fault(cell, name: str):
    """A context manager that plants fault `name` of the cell's family and
    driver in the program."""
    found = faults(cell)
    if name not in found:
        raise ValueError(f"unknown fault {name!r} for {cell.name!r}: {sorted(found)}")
    return found[name]()


def control_run(cell, seed: int, seconds: float, device) -> dict:
    from portbench import run

    return run.measure(cell, seed, seconds, False, device, time.perf_counter(),
                       prepare=lambda d: d.use_reference("fp8"))


def fault_run(cell, seed: int, seconds: float, device, name: str) -> dict:
    from portbench import run

    with fault(cell, name):
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
    if args.faults and not faults(cell):
        print(f"portbench.control: no fault is defined for the family "
              f"{spec.family_name(cell.config)!r} on the {cell.driver!r} driver; "
              f"the control runs alone", file=sys.stderr, flush=True)
    for seed in args.seeds:
        kinds = [("control", None)]
        if args.faults:
            kinds += [("fault", f) for f in faults(cell)]
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
