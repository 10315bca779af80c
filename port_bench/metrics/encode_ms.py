"""encode_ms: the self time of the port's ``LinearCode::encode`` spans (a
linear code's row encode: for Ligero the Reed-Solomon NTTs enqueued on the
card), summed a request and averaged over the requests of the traced
window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), lambda n: n == "LinearCode::encode")
