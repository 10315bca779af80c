"""The PyTorch port's Hyrax (poly_commit_tpu_torch.pcs.hyrax) against the
JAX package's on the CPU.

Both packages run tests/harness.py's multilinear round trip (setup ->
trim -> commit -> batch_open -> batch_check, hiding) at 4 variables from
one HostRng seed and one Poseidon transcript, so the generators, the row
commitments, every proof field (com_eval, com_d, com_b, z, z_d, z_b), the
opened values and the verdicts must be equal, with tolerance 0. The port
runs its kernels' plain versions (K1, K2a, K3): the row commitments come
from its batched MSM (msm_rows, the window fold on the device). Also: odd
num_vars rejected, a tampered proof rejected by both, and a JAX key
carried across by ``convert.hyrax_params_from_jax``.
"""

import copy
import functools
import types

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
import poly_commit_tpu.pcs.errors as jE  # noqa: E402
import poly_commit_tpu.pcs.hyrax as jH  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.errors as tE  # noqa: E402
import poly_commit_tpu_torch.pcs.hyrax as tH  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(H=jH, F=jF, DS=jDS, T=jT, E=jE, dev={})
PORT = types.SimpleNamespace(H=tH, F=tF, DS=tDS, T=tT, E=tE, dev={"device": "cpu"})
NUM_VARS = 4
CASES = {
    "one_poly": dict(num_polys=1, num_points=1),
    "two_polys_two_points": dict(num_polys=2, num_points=2),
}


def _round_trip(pkg, num_polys, num_points, seed=7, pp=None):
    """harness.run_ml_template's steps with hiding, returning everything
    they produce."""
    PC = pkg.H.HyraxPC
    spec = PC.spec
    rng = pkg.DS.HostRng(seed)
    if pp is None:
        pp = PC.setup(0, num_vars=NUM_VARS, rng=rng, **pkg.dev)
    ck, vk = PC.trim(pp, 0, num_points, None)
    polys = [pkg.DS.LabeledPolynomial(
        label=f"poly_{i}", poly=pkg.F.from_ints(spec, rng.field_ints(spec, 1 << NUM_VARS), **pkg.dev),
        hiding_bound=num_points, num_vars=NUM_VARS) for i in range(num_polys)]
    comms, states = PC.commit(ck, polys, rng)
    query_set = set()
    for pi in range(num_points):
        point = tuple(rng.field_int(spec) for _ in range(NUM_VARS))
        for lp in polys:
            query_set.add((lp.label, (f"pt_{pi}", point)))
    proofs, values = PC.batch_open(ck, polys, comms, query_set, pkg.T.PoseidonSponge(spec),
                                   states, rng)
    ok = PC.batch_check(vk, comms, query_set, values, proofs, pkg.T.PoseidonSponge(spec))
    return types.SimpleNamespace(PC=PC, pkg=pkg, pp=pp, ck=ck, vk=vk, polys=polys, comms=comms,
                                 states=states, query_set=query_set, values=values,
                                 proofs=proofs, ok=bool(ok))


@functools.lru_cache(maxsize=None)
def _both(case):
    return _round_trip(JAX, **CASES[case]), _round_trip(PORT, **CASES[case])


def _row_coms(res):
    return [(c.label, [tuple(int(v) for v in t[:2]) + (bool(t[2]),) for t in c.commitment.row_coms])
            for c in res.comms]


def _proofs(res):
    return [[(p.com_eval, p.com_d, p.com_b, [int(v) for v in p.z], p.z_d, p.z_b) for p in group]
            for group in res.proofs]


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_matches_jax(case):
    j, t = _both(case)
    assert t.ck.com_key_host == j.ck.com_key_host and t.ck.h == j.ck.h
    assert _row_coms(t) == _row_coms(j)
    assert t.values == j.values
    assert _proofs(t) == _proofs(j)
    assert t.ok is True and j.ok is True


def test_sample_generators_match_jax():
    gens = tH.sample_generators(6)
    assert gens == jH.sample_generators(6)
    p, b = tH.BASE.modulus, 3
    assert all(y * y % p == (x ** 3 + b) % p for x, y in gens)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_odd_num_vars_rejected(pkg):
    with pytest.raises(pkg.E.PCError):
        pkg.H.HyraxPC.setup(0, num_vars=3, rng=pkg.DS.HostRng(0), **pkg.dev)


@pytest.mark.parametrize("field", ["z", "com_eval"])
def test_tampered_proof_rejected_by_both(field):
    """z[0] + 1, or com_eval swapped for com_d: both packages reject."""
    for res in _both("one_poly"):
        proofs = copy.deepcopy(res.proofs)
        pf = proofs[0][0]
        if field == "z":
            pf.z[0] = (int(pf.z[0]) + 1) % res.PC.spec.modulus
        else:
            pf.com_eval = pf.com_d
        assert not res.PC.batch_check(res.vk, res.comms, res.query_set, res.values, proofs,
                                      res.pkg.T.PoseidonSponge(res.PC.spec))


def test_jax_params_carry_over():
    """The port on a JAX key (convert.hyrax_params_from_jax) gives the JAX
    round trip's commitments and proofs."""
    j, _ = _both("one_poly")
    pp = convert.hyrax_params_from_jax(j.pp, device="cpu")
    t = _round_trip(PORT, **CASES["one_poly"], pp=pp)
    assert _row_coms(t) == _row_coms(j) and _proofs(t) == _proofs(j) and t.ok
