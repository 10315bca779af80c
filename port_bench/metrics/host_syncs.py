"""host_syncs: the times the host waits for the card, as the port counts
them (``host_syncs``: each read from the card, each copy from pageable host
memory to it), summed a request and averaged over the requests of the
traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_count(ctx.requests, P.records(), "host_syncs")
