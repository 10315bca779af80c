"""Shared by the readers of the port's own spans and counters
(``poly_commit_tpu_torch.utils.trace``).

The port keeps a record of each of its scopes while a torch profiler runs,
so only the traced window leaves records. Each record goes to the
completed request whose [t0, t1] holds it (a request that failed, and
whatever ran outside the window's requests, are left out); a request's
values are summed and averaged over the completed requests that hold a
record, as ``_spans.mean_ms`` averages the benchmark's own spans.

A span's self time is its duration less that of its recorded children, so
the self times of one request's records add up to its root spans'
durations, and a family's self time (its spans less the time child spans
of other families cover) is disjoint from every other family's.

A reader returns None where the window holds no record of its family: an
untraced run, a port without these records, a cell that does not run them.
"""

import bisect


def records() -> list:
    """The port's kept records, or [] where the port keeps none."""
    try:
        from poly_commit_tpu_torch.utils import trace
    except ImportError:
        return []
    read = getattr(trace, "records", None)
    return read() if read is not None else []


def by_request(requests, recs) -> list:
    """[(request, [record])] for the completed requests holding a record,
    by start time; a record belongs to the request whose [t0, t1] (the
    harness's ``time.perf_counter`` seconds) holds its whole span."""
    done = sorted((r for r in requests if r.error is None), key=lambda r: r.t0)
    starts = [r.t0 for r in done]
    held: dict = {}
    for rec in recs:
        if rec.end_ns is None:
            continue
        i = bisect.bisect_right(starts, rec.start_ns / 1e9) - 1
        if i >= 0 and rec.end_ns / 1e9 <= done[i].t1:
            held.setdefault(i, []).append(rec)
    return [(done[i], held[i]) for i in sorted(held)]


def self_ns(recs) -> dict:
    """Record id -> its duration less its recorded children's, in ns."""
    own = {r.id: r.end_ns - r.start_ns for r in recs if r.end_ns is not None}
    for r in recs:
        if r.parent in own and r.end_ns is not None:
            own[r.parent] -= r.end_ns - r.start_ns
    return own


def _mean(per_request, found):
    return sum(per_request) / len(per_request) if found and per_request else None


def mean_self_ms(requests, recs, match) -> float | None:
    """The mean over requests of the summed self time, in ms, of the
    records whose name ``match`` accepts."""
    own = self_ns(recs)
    per_request, found = [], False
    for _, rs in by_request(requests, recs):
        mine = [r for r in rs if match(r.name)]
        found = found or bool(mine)
        per_request.append(sum(own[r.id] for r in mine) / 1e6)
    return _mean(per_request, found)


def mean_count(requests, recs, name: str) -> float | None:
    """The mean over requests of counter ``name`` summed over its records."""
    per_request, found = [], False
    for _, rs in by_request(requests, recs):
        found = found or any(name in r.counts for r in rs)
        per_request.append(sum(r.counts.get(name, 0) for r in rs))
    return _mean(per_request, found)
