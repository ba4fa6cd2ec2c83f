"""batch_ms_p90: the 90th percentile of every batch latency in the window,
from the call to its transforms on the host, in ms (Python's
`statistics.quantiles`, exclusive method)."""

import statistics


def read(run):
    lat = run.window.latencies
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10)[8] * 1e3
