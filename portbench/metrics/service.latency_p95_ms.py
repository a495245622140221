"""service.latency_p95_ms: in the upload cell, which offers more than the
service answers, the 95th percentile of every request of the measured
window, from the moment it was due to its last byte (a failed one at the
time it failed). Above the knee the backlog grows all through the window,
so this tail swings with the service's rate and is read per layer; the
cell's end-to-end metric is `rtf`."""

import statistics


def read(run):
    lat = run.window.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
