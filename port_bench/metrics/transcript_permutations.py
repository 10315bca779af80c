"""transcript_permutations: the Poseidon permutations the port counts
(``poseidon_permutations``), summed a request and averaged over the
requests of the traced window."""

from port_bench.metrics import _program as P


def read(ctx):
    return P.mean_count(ctx.requests, P.records(), "poseidon_permutations")
