"""hashed_bytes: the bytes the port gives to its hashes (``hashed_bytes``:
the column bytes given to Blake2s, 64 a SHA-256 compression of a tree
build), summed a request and averaged over the requests of the traced
window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_count(ctx.requests, P.records(), "hashed_bytes")
