"""poly_ms: the self time of the port's ``Poly::*`` spans (divisions,
evaluations, eq tables, linear combinations), summed a request and
averaged over the requests of the traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), lambda n: n.startswith("Poly::"))
