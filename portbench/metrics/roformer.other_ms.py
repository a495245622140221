"""roformer.other_ms: in BS-RoFormer's cell, device milliseconds a call of
every device operation that neither `stages/rof_attention.json` nor
`stages/rof_gemm.json` names: the norms, the rotary embedding, GELU, the
gates and residuals, the transposes between time-major and band-major
layouts, the FFTs, the masks, the overlap-add, copies and fills. None
where the unit has no `rof_` shapes."""

from portbench.trace import names_kernel

STAGES = ("rof_attention", "rof_gemm")


def read(run):
    if run.trace is None or not run.shapes or "rof_chunks" not in run.shapes \
            or not run.traced.units:
        return None
    kernels = [k for s in STAGES for k in run.stages.get(s, {}).get("kernels", [])]
    other = sum(sec for name, sec in run.trace.seconds_by_name().items()
                if not any(names_kernel(k, name) for k in kernels))
    return other / run.traced.units * 1e3
