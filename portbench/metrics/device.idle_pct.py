"""device.idle_pct: the share of the traced window in which no operation
ran on the device, in %, from the union of every device operation's
interval (kernels, copies, fills) in the profiler's trace."""


def read(run):
    if run.trace is None:
        return None
    return (1.0 - run.trace.busy_s() / run.trace.window_s) * 100.0
