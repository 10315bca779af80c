"""request_ms_p90: the 90th percentile of the wall milliseconds of the
requests completed in the window (Python's ``statistics.quantiles``,
inclusive method); the run prints the sample count."""

import statistics


def p90(latencies_ms):
    if len(latencies_ms) < 2:
        return None
    return statistics.quantiles(latencies_ms, n=10, method="inclusive")[8]


def read(ctx):
    return p90([(r.t1 - r.t0) * 1e3 for r in ctx.requests
                if r.error is None and r.t1 <= ctx.deadline])
