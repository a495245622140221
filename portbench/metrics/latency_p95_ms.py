"""latency_p95_ms: the 95th percentile (linear between order statistics)
of every call, block step or request of the measured window, on the host
clock: a call or step from its start to the end of the synchronisation
after it; a request from the moment it was due to its last byte, a failed
one counted at the time it failed."""

import statistics


def read(run):
    lat = run.window.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
