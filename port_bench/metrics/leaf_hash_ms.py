"""leaf_hash_ms: the self time of the port's ``Merkle::leaves`` spans (the
linear codes' column hashes on the host; the read of the columns from the
card is a child span, left out), summed a request and averaged over the
requests of the traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), lambda n: n == "Merkle::leaves")
