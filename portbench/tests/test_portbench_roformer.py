"""BS-RoFormer's family, configuration, cell, stages and metrics
(`families/bs_roformer.py`) at the family's `small_config` on the CPU: the
offline cell through `run.measure`, the float8 control and each fault
against the cell's limits, the `rof_` shape variables kept apart from
Spleeter's stages, and the new stages' kernels kept apart from the kernels
the existing cells ran."""

from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import small
from portbench import control, run, spec, work
from portbench.drivers import Window
from portbench.trace import Spans, names_kernel

CELL = "bsrof-vocals-track300"
CPU = torch.device("cpu")
ROF_STAGES = ("rof_attention", "rof_gemm")
ROF_METRICS = ("roformer.mfu_pct", "roformer.attention_roofline",
               "roformer.gemm_roofline", "roformer.other_ms")


def _measure(cell, **kw):
    return run.measure(cell, 3000000019, 1.0, False, CPU, time.perf_counter(), **kw)


def test_the_cell_is_correct_at_a_cpu_size():
    cell = small(CELL)
    out = _measure(cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"rtf", "setup_s"}
    assert out["checks"]["rel_l2_fp8"]["value"] < 0.2


@pytest.mark.parametrize("kind", ["control", "altered", "half_batch", "band_rope_off"])
def test_the_control_and_each_fault_fail_the_limits(kind):
    cell = small(CELL)
    assert list(control.faults(cell)) == ["altered", "half_batch", "band_rope_off"]
    if kind == "control":
        out = _measure(cell, prepare=lambda d: d.use_reference("fp8"))
        assert out["checks"]["rel_l2_fp8"]["value"] > 0.9
    else:
        with control.fault(cell, kind):
            out = _measure(cell)
    assert not out["correct"], out["checks"]


def test_the_family_draws_the_programs_weights_and_counts_the_motivations_flops():
    from spleeterrt_tpu_torch.core import roformer

    cfg = spec.cell(CELL).config
    family = spec.family(cfg)
    pcfg = family.program_config(cfg)
    assert dict(family.param_table(cfg)) == roformer.param_shapes(pcfg)
    shapes = family.unit_shapes(cfg, 300 * 44100)
    assert all(k.startswith("rof_") for k in shapes)
    assert shapes["rof_chunks"] == roformer.num_chunks(300 * 44100, pcfg) == 76
    assert shapes["rof_frames"] == 801 and shapes["rof_dim_in"] == 4100
    per_chunk = {k: v for k, v in shapes.items()} | {"rof_chunks": 1}
    assert family.linear_flops(per_chunk) == pytest.approx(7.5e12 + 0.13e12 + 3.4e9, rel=0.01)
    assert family.attention_flops(per_chunk) == pytest.approx(1.06e12, rel=0.01)
    assert family.unit_flops(cfg, shapes) == pytest.approx(76 * 8.7e12, rel=0.01)
    small_cfg = family.small_config(cfg)
    assert sum(small_cfg["freqs_per_bands"]) == small_cfg["n_fft"] // 2 + 1
    gen = torch.Generator().manual_seed(1)
    w = family.make_weights(small_cfg, gen, CPU)
    assert {k: tuple(v.shape) for k, v in w.items()} == roformer.param_shapes(
        family.program_config(small_cfg))


def test_no_spleeter_stage_applies_to_the_rof_unit_and_the_reverse():
    stages = spec.stages()
    rof = spec.family(spec.cell(CELL).config)
    rof_shapes = rof.unit_shapes(spec.cell(CELL).config, 300 * 44100)
    for name in ("vst4-track300", "exe2-track300"):
        cfg = spec.cell(name).config
        shapes = spec.family(cfg).unit_shapes(cfg, 300 * 44100)
        for stage_name in ROF_STAGES:
            assert work.stage_bound_s(stages[stage_name], shapes) is None, stage_name
    for stage_name, stage in stages.items():
        ours = stage_name in ROF_STAGES
        assert (work.stage_bound_s(stage, rof_shapes) is None) != ours, stage_name
    for stage_name in ROF_STAGES:
        stage = stages[stage_name]
        assert stage["dtype"] == "bfloat16" and stage["kernels"]
        assert all(k.startswith("rof_") for f in ("bytes", "ops") for k in _names(stage[f]))


def _names(expr: str) -> set[str]:
    import ast

    return {n.id for n in ast.walk(ast.parse(expr, mode="eval")) if isinstance(n, ast.Name)}


def test_the_new_stages_name_no_kernel_of_the_existing_cells():
    """Every kernel in the ledger's breakdowns of the accepted cells, and the
    kernels their stage files name, stay outside the new stages, so that
    `model.torch_ops_ms` and `hand_kernels_roofline` read there as before."""
    seen = set()
    with open(spec.ROOT / "PERF_LEDGER.jsonl") as f:
        for line in f:
            row = json.loads(line)
            for name, _ in (row.get("breakdown") or {}).get("device_ops", []):
                seen.add(name)
    stages = spec.stages()
    seen |= {k for n, s in stages.items() if n not in ROF_STAGES for k in s["kernels"]}
    assert len(seen) > 10
    for stage_name in ROF_STAGES:
        for pattern in stages[stage_name]["kernels"]:
            assert not any(names_kernel(pattern, name) for name in seen), pattern


def test_the_new_metrics_list_only_the_new_cell_and_read_nothing_elsewhere():
    bench = spec.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ROF_METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "rtf"
    # device.idle_pct lists no cells: every cell reports it, this one too.
    assert "workloads" not in per_layer["device.idle_pct"]
    reported = [m["name"] for m in spec.cell_metrics(bench, CELL, True)]
    assert reported == ["device.idle_pct", *ROF_METRICS]
    assert [m["name"] for m in spec.cell_metrics(bench, CELL, False)] == ["rtf", "setup_s"]
    w = Window(1.0, [0.1], 1, 0, [], 1)
    for cell_name, shapes in ((CELL, None), ("vst4-track300", {"T": 256})):
        r = run.Run(spec.cell(cell_name), 1.0, w, Spans(), shapes, spec.stages())
        for name in ROF_METRICS:
            assert spec.metric_reader(name)(r) is None, (cell_name, name)
