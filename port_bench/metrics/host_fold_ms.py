"""host_fold_ms: the self time of the port's ``MSM::fold_host`` spans (an
MSM's windows folded on host ints; the reads of its parts from the card
are child spans, left out), summed a request and averaged over the
requests of the traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), lambda n: n == "MSM::fold_host")
