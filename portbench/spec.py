"""Finding the benchmark's pieces by name: BENCHMARK.json at the root of the
checkout, and the files of this folder.

- a configuration: `configs/<name>.json`; its `family` key (`spleeter`
  where absent) names the module `families/<family>.py` that makes its
  weights, calls the program, computes the plain reference and plants the
  faults the check has to catch;
- a traffic mix: `traffic/<name>.json`, whose `driver` names the module
  `drivers/<driver>.py` that generates it and whose other keys are that
  driver's parameters;
- a cell: `workloads/<name>.json`, with its config, traffic, chips and why
  as BENCHMARK.json has them, `params` that override the mix's for this
  cell, and `checks`: the limit of each number its correctness check
  compares;
- a per-layer or end-to-end metric: `metrics/<name>.py`, whose `read(run)`
  returns the value or None;
- a stage of the roofline: `stages/<name>.json` (kernels, dtype, bytes and
  ops formulas), or an alias (`alias_of`, `kernels`) that adds kernel
  names to a stage.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return _load(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _load(HERE / "traffic" / f"{name}.json")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    driver: str
    params: dict  # the mix's parameters with the cell's overrides
    chips: int
    checks: dict  # number compared -> its limit


def cell(name: str) -> Cell:
    spec = _load(HERE / "workloads" / f"{name}.json")
    mix = traffic(spec["traffic"])
    params = {k: v for k, v in mix.items() if k not in ("driver", "why")}
    params.update(spec.get("params", {}))
    return Cell(name, config(spec["config"]), mix["driver"], params,
                spec["chips"], spec["checks"])


def stages() -> dict[str, dict]:
    """Every stage with the kernel names of its aliases merged in."""
    found, aliases = {}, []
    for path in sorted((HERE / "stages").glob("*.json")):
        s = _load(path)
        if "alias_of" in s:
            aliases.append(s)
        else:
            found[path.stem] = {**s, "kernels": list(s["kernels"])}
    for a in aliases:
        found[a["alias_of"]]["kernels"].extend(a["kernels"])
    return found


# One module object a file for every load through here, so that a fault
# planted in a family's module is the one its driver calls.
_loaded: dict[Path, object] = {}


def _module(folder: str, name: str):
    """`<folder>/<name>.py` under HERE, loaded by its path."""
    path = HERE / folder / f"{name}.py"
    if path not in _loaded:
        mod_spec = importlib.util.spec_from_file_location(
            f"portbench.{folder}.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def family_name(cfg: dict) -> str:
    return cfg.get("family", "spleeter")


def family(cfg: dict):
    """The module families/<family>.py of a configuration."""
    return _module("families", family_name(cfg))


def driver(name: str):
    """The module drivers/<name>.py: its `Driver` and `SMALL`."""
    return _module("drivers", name)


def metric_reader(name: str):
    """The `read` function of metrics/<name>.py."""
    return _module("metrics", name).read


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace
    on), in BENCHMARK.json's order: those that list the cell, and those
    without a `workloads` key."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]
