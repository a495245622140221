"""graph.enqueue_ms.p50: the median host time of a call into the graph
(`separate.separate`, `stream.block_step_streams`) from the call to its
return, before the synchronisation: the benchmark's own span around the
call, over the measured (untraced) window. Close to the call's whole time
where the host sets the pace."""

import statistics


def read(run):
    d = run.spans.durations_s("graph.enqueue")
    return statistics.median(d) * 1e3 if d else None
