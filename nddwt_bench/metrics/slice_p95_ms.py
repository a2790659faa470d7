"""The 95th percentile of the latencies of all steps in the window, in ms:
each from the step's start to the synchronise after its last call."""

import statistics


def read(rec):
    if len(rec.latencies_s) < 2:
        return None
    return 1e3 * statistics.quantiles(rec.latencies_s, n=100, method="inclusive")[94]
