"""msm_useful_share: the points the work needs (``schemes/<scheme>.py``'s
``msm_points``, what ``msm_roofline`` counts) over the points the port's
MSMs scan after padding (``msm_points_run``, averaged a request over the
requests of the traced window), in percent."""

from port_bench.metrics import _program as P


def share(needed, run):
    if not needed or not run:
        return None
    return 100.0 * needed / run


def read(ctx):
    msm_points = getattr(ctx.scheme, "msm_points", None)
    if msm_points is None:
        return None
    return share(msm_points(ctx.cfg, ctx.plan),
                 P.mean_count(ctx.requests, P.records(), "msm_points_run"))
