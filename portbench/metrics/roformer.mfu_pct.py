"""roformer.mfu_pct: in BS-RoFormer's cell, the useful operations of the
calls completed in the traced window over the window and 989 TFLOP/s (the
H100 SXM's dense bf16 peak), in %: the share of the whole call's peak.
Counted from one call's shapes by `families/bs_roformer.py::unit_flops`
(every linear layer's and both attention products' multiply-adds x 2, 2.5
N log2 N for each FFT). None where the unit has no `rof_` shapes."""

from portbench import spec, work


def read(run):
    if run.trace is None or not run.shapes or "rof_chunks" not in run.shapes \
            or not run.traced.units:
        return None
    cfg = run.cell.config
    flops = run.traced.units * spec.family(cfg).unit_flops(cfg, run.shapes)
    return flops / run.trace.window_s / work.MFU_PEAK_OPS_PER_S * 100.0
