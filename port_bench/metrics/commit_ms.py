"""commit_ms: the benchmark's spans around each ``commit`` call, summed a
request and averaged over the requests of the traced window."""

from port_bench.metrics._spans import mean_ms


def read(ctx):
    return mean_ms(ctx.requests, "commit")
