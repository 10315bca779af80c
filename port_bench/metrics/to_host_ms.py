"""to_host_ms: the self time of the port's ``Serialize::to_host`` spans
(each explicit read from the card: the wait for the card, the copy and the
limbs-to-ints conversion), summed a request and averaged over the requests
of the traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), lambda n: n == "Serialize::to_host")
