"""The check catches what it is there to catch. At a size the CPU runs, the
whole flow of a run (set-up, a window, the check against the reference)
with the look for a card skipped: a sound run comes out correct; the
control (the reference in float8 in the program's place) and each fault
the cell can have, planted in the program, come out not correct, under the
limits in the cells' files."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import control, run, spec

from conftest import small

CELLS = ["vst4-track300", "exe2-track300", "vst4-stream64", "vst4-http-clips"]
CPU = torch.device("cpu")


def _measure(cell, seconds=2.0, **kw):
    return run.measure(cell, 20260, seconds, False, CPU, time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    # Long enough for two calls on a loaded CPU: a tail needs two latencies.
    out = _measure(small(name), seconds=6.0)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {
        m["name"] for m in spec.cell_metrics(spec.benchmark(), name, False)}
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = _measure(small(name), prepare=lambda d: d.use_reference("fp8"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in control.faults(spec.cell(c))])
def test_fault_is_not_correct(name, fault):
    cell = small(name)
    with control.fault(cell, fault):
        out = _measure(cell)
    assert not out["correct"], (fault, out["checks"])
