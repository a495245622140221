"""model.torch_ops_ms: device milliseconds a call of every device
operation that no stage file names (the mid trunk's cuDNN convolutions,
torch's elementwise passes, copies and fills), from the traced window."""

from portbench.trace import names_kernel


def read(run):
    if run.trace is None or run.shapes is None or not run.traced.units:
        return None
    kernels = [k for s in run.stages.values() for k in s["kernels"]]
    other = sum(sec for name, sec in run.trace.seconds_by_name().items()
                if not any(names_kernel(k, name) for k in kernels))
    return other / run.traced.units * 1e3
