"""The benchmark's files: BENCHMARK.json against the contract's shape, and
every piece it names found by name under portbench/."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec, work

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_file_agrees_with_benchmark_json(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell_file = json.loads((spec.HERE / "workloads" / f"{w['name']}.json").read_text())
        for key in ("config", "traffic", "chips", "why"):
            assert cell_file[key] == w[key], (w["name"], key)
        cell = spec.cell(w["name"])
        driver = spec.driver(cell.driver)
        assert hasattr(driver, "Driver") and isinstance(driver.SMALL, dict), cell.driver
        assert cell.checks and all(v > 0 for v in cell.checks.values())
        cfg = configs[w["config"]]
        assert cfg["file"] == f"portbench/configs/{w['config']}.json"
        assert spec.config(w["config"])["name"] == w["config"]


FAMILY_SURFACE = ("make_weights", "program", "reference", "unit_shapes", "unit_flops",
                  "FAULTS", "small_config")


def test_every_config_is_used_and_states_what_it_cut(bench):
    """Each configuration is used by a cell, its family module has the whole
    surface, and each key in `reduced` has its published value in the
    file's `published`, beside the `deployment` the cut stands for."""
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert (spec.ROOT / c["file"]).is_file()
        cfg = spec.config(c["name"])
        family = spec.family(cfg)
        assert all(hasattr(family, a) for a in FAMILY_SURFACE), spec.family_name(cfg)
        assert all(callable(f) for fs in family.FAULTS.values() for f in fs.values())
        if c["reduced"]:
            assert set(c["reduced"]) <= set(cfg.get("published", {})), c["name"]
            assert isinstance(cfg.get("deployment"), str) and cfg["deployment"], c["name"]


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert callable(spec.metric_reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for cell in cells:
        assert "setup_s" in [m["name"] for m in spec.cell_metrics(bench, cell, False)]
        assert len(spec.cell_metrics(bench, cell, False)) >= 2
        assert spec.cell_metrics(bench, cell, True)


def test_shares_are_named_as_shares(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_stages_load_and_aliases_add_kernel_names(tmp_path, monkeypatch):
    stages = spec.stages()
    assert set(stages) >= {"k1_stft", "k2_enc1", "k3_enc", "k4k5_up", "k6_head",
                           "k7_istft", "k8_irfft"}
    for s in stages.values():
        assert s["dtype"] in work.PEAK_OPS_PER_S and s["kernels"]
    here = tmp_path / "portbench"
    (here / "stages").mkdir(parents=True)
    for p in (spec.HERE / "stages").glob("*.json"):
        (here / "stages" / p.name).write_text(p.read_text())
    (here / "stages" / "k3_enc_v2.json").write_text(
        json.dumps({"alias_of": "k3_enc", "kernels": ["enc_wgmma_kernel"]}))
    monkeypatch.setattr(spec, "HERE", here)
    assert spec.stages()["k3_enc"]["kernels"] == ["enc_mma_kernel", "enc_wgmma_kernel"]


def test_metric_readers_leave_out_what_they_cannot_read():
    from portbench.run import Run
    from portbench.drivers import Window
    from portbench.trace import Spans

    w = Window(1.0, [0.1], 1, 0, [], 1)
    run = Run(spec.cell("vst4-http-clips"), 1.0, w, Spans(), None, spec.stages())
    for name in ("rtf", "graph.enqueue_ms.p50", "model.torch_ops_ms",
                 "hand_kernels_roofline", "device.idle_pct", "device.mfu_pct",
                 "service.separate_wav_ms.p50", "latency_p95_ms",
                 "service.latency_p95_ms"):
        assert spec.metric_reader(name)(run) is None, name
