"""merkle_ms: the self time of the port's ``Merkle::tree`` spans (each
SHA-256 tree build and each opening's loop over its paths), summed a
request and averaged over the requests of the traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), lambda n: n == "Merkle::tree")
