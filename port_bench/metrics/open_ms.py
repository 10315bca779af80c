"""open_ms: the benchmark's spans around ``batch_open`` (with the
transcript's absorbs before it), summed a request and averaged over the
requests of the traced window."""

from port_bench.metrics._spans import mean_ms


def read(ctx):
    return mean_ms(ctx.requests, "open")
