"""A traced Hyrax open crosses into the native sponge a few times only.

Hyrax's statement (the key's 2^(nv/2) + 1 points and the row commitments)
goes into the sponge in one ``absorb_bytes_many``; the open then absorbs
the point, its three proof points and squeezes one challenge. At 6
variables that is 2 * 8 + 1 statement points, 33 permutations as the
Python sponge ran them, and a handful of crossings where one a point would
be over 20. The commitment is made on host ints (a Pedersen sum a row), so
no CPU MSM runs; the check then accepts the proof. No JAX: the port alone.
"""

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core import hostec  # noqa: E402
from poly_commit_tpu_torch.pcs import hyrax as H  # noqa: E402
from poly_commit_tpu_torch.pcs.data_structures import (  # noqa: E402
    HostRng, LabeledCommitment, LabeledPolynomial, fresh_sponge)
from poly_commit_tpu_torch.utils import trace  # noqa: E402

NUM_VARS = 6
DIM = 1 << (NUM_VARS // 2)
PERMUTATIONS = 33  # (3 (2 DIM + 1) + NUM_VARS + 9 - 1) // 2 absorbing, one squeezing
CROSSINGS_AT_MOST = 16


def _host_commitment(ck, evals, rand):
    """Row i: sum_c mat[i, c] G_c + rand_i h, with mat[r, c] = evals[c DIM + r]."""
    hg = H.HGROUP
    rows = []
    for i in range(DIM):
        acc = hg.mul_fast(ck.h, rand[i])
        for c, g in enumerate(ck.com_key_host):
            acc = hg.add(acc, hg.mul_fast(g, evals[c * DIM + i]))
        rows.append(hostec.host_to_triple(acc))
    return rows


def test_hyrax_open_crosses_into_the_sponge_a_few_times():
    spec = H.SPEC
    ck, vk = H.HyraxPC.trim(H.HyraxPC.setup(0, num_vars=NUM_VARS, device="cpu"))
    evals, rand = HostRng(5).field_ints(spec, 1 << NUM_VARS), HostRng(6).field_ints(spec, DIM)
    table = F.from_ints(spec, evals, device="cpu")
    comm = LabeledCommitment("h", H.Commitment(_host_commitment(ck, evals, rand)), None)
    state = H.CommitmentState(
        randomness=F.from_ints(spec, rand, device="cpu"),
        mat=table.reshape(DIM, DIM, spec.n_limbs).transpose(0, 1).contiguous())
    poly = LabeledPolynomial("h", table, num_vars=NUM_VARS)
    point = tuple(HostRng(7).field_ints(spec, NUM_VARS))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        proof = H.HyraxPC.open(ck, [poly], [comm], point, fresh_sponge(spec), [state], HostRng(8))
    recs = trace.records()
    trace.reset()
    opening = next(r for r in recs if r.name == "Hyrax::open")
    mine = [r for r in recs if r.root == opening.root]
    assert sum(r.counts.get("poseidon_permutations", 0) for r in mine) == PERMUTATIONS
    crossings = sum(r.counts.get("poseidon_native_calls", 0) for r in mine)
    assert 0 < crossings <= CROSSINGS_AT_MOST
    statement = next(r for r in mine if r.name == "Transcript::absorb")
    assert statement.counts["poseidon_native_calls"] == 2  # the points, then the point
    assert H.HyraxPC.check(vk, [comm], point, None, proof, fresh_sponge(spec))
