"""roformer.attention_roofline: the share of its roofline that BS-RoFormer's
attention reaches, in %: the least time the calls of the traced window
could spend in it (`stages/rof_attention.json`: q, k, v and the output
moved once over 3.35 TB/s, or both products over the bf16 peak, whichever
is larger) over the device time of the kernels the stage names. None where
the unit has no `rof_` shapes or no such kernel ran."""

from portbench import work
from portbench.trace import names_kernel

STAGE = "rof_attention"


def read(run):
    stage = run.stages.get(STAGE)
    if run.trace is None or stage is None or not run.shapes or not run.traced.units:
        return None
    bound = work.stage_bound_s(stage, run.shapes)
    spent = sum(sec for name, sec in run.trace.seconds_by_name().items()
                if any(names_kernel(k, name) for k in stage["kernels"]))
    if bound is None or not spent:
        return None
    return bound * run.traced.units / spent * 100.0
