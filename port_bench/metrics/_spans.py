"""Shared by the span metrics: the mean, over the window's requests, of a
request's summed milliseconds in the benchmark's spans of one name."""


def mean_ms(requests, name):
    per_request = [sum(t1 - t0 for n, t0, t1 in r.spans if n == name) * 1e3
                   for r in requests if r.error is None and any(n == name for n, _, _ in r.spans)]
    if not per_request:
        return None
    return sum(per_request) / len(per_request)
