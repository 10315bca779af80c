"""transcript_ms: the self time of the port's ``Transcript::absorb`` and
``Transcript::squeeze`` spans (host Poseidon), summed a request and
averaged over the requests of the traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), lambda n: n.startswith("Transcript::"))
