"""msm_host_ms: the self time of the port's ``MSM::msm``, ``MSM::msm_rows``,
``MSM::fixed_base`` and ``MSM::fold_device`` spans (the host's time
enqueueing MSM work; host folds and reads from the card are child spans,
left out), summed a request and averaged over the requests of the traced
window."""

from port_bench.metrics import _program as P

SPANS = frozenset({"MSM::msm", "MSM::msm_rows", "MSM::fixed_base", "MSM::fold_device"})


def read(ctx):
    return P.mean_self_ms(ctx.requests, P.records(), SPANS.__contains__)
