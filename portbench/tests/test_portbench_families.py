"""A model family, its configuration and its cell, and a driver, added as
new files only. In a copy of portbench/ (and of BENCHMARK.json, which gains
their entries), a toy family `gain` runs through the offline driver,
`run.measure`, the control and its fault, and a toy driver through
`spec.driver` and the files' checks, while no file that was in the copy
changes."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import time

import pytest
import torch

import test_portbench_spec as spec_tests
from conftest import small
from portbench import control, run, spec

GAIN_FAMILY = '''"""A toy family: stem s is the track times a gain drawn from the seed.
The program computes in bfloat16; the reference in float32, or for the
control with both operands rounded to float8."""

import torch

from portbench.families import patched
from portbench.reference.unet import round_fp8


class Program:
    @staticmethod
    def scale(track, gains):
        return gains.to(torch.bfloat16)[:, None, None] * track.to(torch.bfloat16)[None]


def make_weights(cfg, gen, device):
    return 0.5 + torch.rand(cfg["nets"], generator=gen, device=device)


def program(cfg, weights, device):
    def call(track):
        return dict(zip(cfg["stem_names"], Program.scale(track, weights).float()))

    return call


def reference(track, weights, cfg, precision):
    if precision == "fp8":
        track, weights = round_fp8(track), round_fp8(weights)
    return weights[:, None, None] * track[None]


def unit_shapes(cfg, n_samples):
    return {"S": cfg["nets"], "n": n_samples}


def unit_flops(cfg, shapes):
    return float(shapes["S"] * 2 * shapes["n"])


def small_config(cfg):
    return dict(cfg)


def _half_stems(fn):
    def wrapper(track, gains):
        y = fn(track, gains).clone()
        y[y.shape[0] // 2 :] = 0.0
        return y

    return wrapper


FAULTS = {"offline": {"half_stems": lambda: patched(Program, "scale", _half_stems)}}
'''

TOY_DRIVER = '''"""A toy driver: the offline closed loop under another name."""

from portbench.drivers import offline

SMALL = {"track_seconds": 1, "tracks": 2, "warmup_calls": 1, "check_samples": 2}


class Driver(offline.Driver):
    pass
'''

CONFIG = {
    "name": "toy-gain", "family": "gain", "source": "a test's toy",
    "nets": 2, "stem_names": ["low", "high"],
    "published": {"nets": 4}, "deployment": "two of four stems on each of two chips",
}
CHECKS = {"rel_l2_fp8": 0.4, "peak_fp8": 0.5}
CPU = torch.device("cpu")


def _hashes(root) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """portbench/ and BENCHMARK.json copied, spec pointed at the copy; yields
    a function that adds a new file under the copy, and on the way out
    checks that every file that was in the copy is as it was."""
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    before = _hashes(here)

    def add(rel: str, content) -> None:
        path = here / rel
        assert not path.exists(), rel
        path.write_text(content if isinstance(content, str) else json.dumps(content))

    yield add
    after = _hashes(here)
    assert {p: after.get(p) for p in before} == before


def _add_cell(add, name: str, traffic: str, why: str) -> None:
    """The cell's file and its entry in the copy's BENCHMARK.json."""
    entry = {"name": name, "config": CONFIG["name"], "traffic": traffic, "chips": 1,
             "why": why}
    add(f"workloads/{name}.json", {**{k: v for k, v in entry.items() if k != "name"},
                                   "params": {}, "checks": CHECKS})
    bench = spec.benchmark()
    bench["workloads"].append(entry)
    if not any(c["name"] == CONFIG["name"] for c in bench["configs"]):
        bench["configs"].append({
            "name": CONFIG["name"], "source": "https://example.org/toy-gain",
            "file": f"portbench/configs/{CONFIG['name']}.json", "reduced": ["nets"],
            "why": "a toy family of the benchmark's tests"})
    (spec.ROOT / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def _add_gain_family(add) -> None:
    add("families/gain.py", GAIN_FAMILY)
    add(f"configs/{CONFIG['name']}.json", CONFIG)


def _measure(cell, **kw):
    return run.measure(cell, 2026021, 1.0, False, CPU, time.perf_counter(), **kw)


def test_a_family_added_as_files_runs_the_offline_cell(tree):
    _add_gain_family(tree)
    _add_cell(tree, "toy-gain-track", "track300",
              "the toy family on the offline mix: the harness's own test")
    cell = small("toy-gain-track")
    assert cell.driver == "offline" and cell.params["track_seconds"] == 3

    out = _measure(cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"rtf", "setup_s"}
    assert out["checks"]["rel_l2_fp8"]["value"] < 0.2

    out = _measure(cell, prepare=lambda d: d.use_reference("fp8"))
    assert not out["correct"] and out["checks"]["rel_l2_fp8"]["value"] > 0.9, out["checks"]

    assert list(control.faults(cell)) == ["half_stems"]
    with control.fault(cell, "half_stems"):
        out = _measure(cell)
    assert not out["correct"], out["checks"]

    bench = spec.benchmark()
    spec_tests.test_every_cell_file_agrees_with_benchmark_json(bench)
    spec_tests.test_every_config_is_used_and_states_what_it_cut(bench)
    spec_tests.test_every_metric_has_a_reader_and_its_cells_report_what_it_moves(bench)


def test_a_driver_added_as_files_is_found_by_name(tree):
    _add_gain_family(tree)
    tree("drivers/toy.py", TOY_DRIVER)
    tree("traffic/toy.json", {"driver": "toy", "why": "a test's toy mix",
                              "track_seconds": 300, "tracks": 3, "warmup_calls": 2,
                              "check_samples": 3, "trace_seconds": 2})
    _add_cell(tree, "toy-gain-toy", "toy", "the toy family on the toy driver")
    cell = small("toy-gain-toy")
    assert cell.driver == "toy" and cell.params["track_seconds"] == 1

    bench = spec.benchmark()
    spec_tests.test_top_level_keys(bench)
    spec_tests.test_every_cell_file_agrees_with_benchmark_json(bench)
    spec_tests.test_every_config_is_used_and_states_what_it_cut(bench)
    spec_tests.test_every_metric_has_a_reader_and_its_cells_report_what_it_moves(bench)

    out = _measure(cell)
    assert out["correct"] and out["attempted"] >= 1, out["checks"]
    assert control.faults(cell) == {}
    assert not _measure(cell, prepare=lambda d: d.use_reference("fp8"))["correct"]


def test_a_cut_must_state_what_it_cut(tree):
    _add_gain_family(tree)
    _add_cell(tree, "toy-gain-track", "track300", "the toy family on the offline mix")
    bench = spec.benchmark()
    bench["configs"][-1]["reduced"] = ["nets", "stem_names"]
    with pytest.raises(AssertionError):
        spec_tests.test_every_config_is_used_and_states_what_it_cut(bench)


@pytest.mark.parametrize("name", ["vst4-stream64", "vst4-http-clips"])
def test_spleeter_only_drivers_refuse_another_family(tree, name):
    _add_gain_family(tree)
    cell = small(name)
    cell = dataclasses.replace(cell, config=dict(cell.config, family="gain"))
    d = spec.driver(cell.driver).Driver(cell, 1, CPU)
    with pytest.raises(ValueError, match="'gain'"):
        d.setup()
