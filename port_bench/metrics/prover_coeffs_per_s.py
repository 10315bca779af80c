"""prover_coeffs_per_s: the coefficients (evaluations, for a multilinear
polynomial) of every polynomial of the requests completed in the window,
over the seconds from the window's start to the end of the last of them."""


def rate(window_start, finished):
    """``finished``: (end time, coefficients) of the requests completed in
    the window; None where there is none."""
    if not finished:
        return None
    return sum(c for _, c in finished) / (max(t for t, _ in finished) - window_start)


def read(ctx):
    return rate(ctx.window_start, [(r.t1, r.coeffs) for r in ctx.requests
                                   if r.error is None and r.t1 <= ctx.deadline])
