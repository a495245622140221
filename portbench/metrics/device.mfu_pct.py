"""device.mfu_pct: useful operations of the units completed in the traced
window over the window and 989 TFLOP/s (the H100 SXM's dense bf16 peak),
in %: every net over every image (convolutions' multiply-adds x 2) and
2.5 N log2 N for each real FFT, counted from the unit's shapes."""

from portbench import work


def read(run):
    if run.trace is None or run.shapes is None or not run.traced.units:
        return None
    flops = run.traced.units * work.unit_flops(run.cell.config, run.shapes)
    return flops / run.trace.window_s / work.MFU_PEAK_OPS_PER_S * 100.0
