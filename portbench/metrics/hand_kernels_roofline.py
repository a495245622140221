"""hand_kernels_roofline: the hand kernels' share of their roofline, in %:
the sum over the stages of the least time their work could take (each
stage file's bytes over 3.35 TB/s or operations over its dtype's peak,
whichever is larger, counted from the unit's shapes) over the device time
of the kernels the stage files name, in the traced window. A stage whose
formulas the unit's shapes do not cover (its graph runs no such work)
counts neither."""

from portbench import work
from portbench.trace import names_kernel


def read(run):
    if run.trace is None or run.shapes is None or not run.traced.units:
        return None
    by_name = run.trace.seconds_by_name()
    bound = spent = 0.0
    for stage in run.stages.values():
        b = work.stage_bound_s(stage, run.shapes)
        if b is None:
            continue
        bound += b * run.traced.units
        spent += sum(sec for name, sec in by_name.items()
                     if any(names_kernel(k, name) for k in stage["kernels"]))
    return bound / spent * 100.0 if spent else None
