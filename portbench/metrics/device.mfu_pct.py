"""device.mfu_pct: useful operations of the units completed in the traced
window over the window and 989 TFLOP/s (the H100 SXM's dense bf16 peak),
in %, counted from the unit's shapes by the cell's model family
(`families/<family>.py::unit_flops`; Spleeter: every net over every image,
convolutions' multiply-adds x 2, and 2.5 N log2 N for each real FFT)."""

from portbench import spec, work


def read(run):
    if run.trace is None or run.shapes is None or not run.traced.units:
        return None
    cfg = run.cell.config
    flops = run.traced.units * spec.family(cfg).unit_flops(cfg, run.shapes)
    return flops / run.trace.window_s / work.MFU_PEAK_OPS_PER_S * 100.0
