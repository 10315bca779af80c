"""The PyTorch port's IPA-PC (poly_commit_tpu_torch.pcs.ipa_pc) against the
JAX package's on the CPU.

Both packages run tests/harness.py's round trip (setup -> trim -> commit ->
batch_open -> batch_check) at max_degree 15, supported degree 7, from one
HostRng seed and one Poseidon transcript, so the commitments, every
proof's l_vec, r_vec, final_comm_key and c, the opened values and the
verdicts must be equal, with tolerance 0. The port runs its kernels' plain
versions (K2b, K3, K1); the JAX package its CPU routes. Also: the
generators, a corrupted value, a JAX key carried across by
``convert.ipa_params_from_jax``, and the linear-combination methods
(open_combinations -> check_combinations) on tests/test_ipa_pc.py's
equation cases, with a tampered evaluation rejected.
"""

import copy
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
import poly_commit_tpu.pcs.ipa_pc as jI  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.ipa_pc as tI  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(I=jI, F=jF, DS=jDS, T=jT, dev={})
PORT = types.SimpleNamespace(I=tI, F=tF, DS=tDS, T=tT, dev={"device": "cpu"})
SIZES = dict(max_degree=15, supported_degree=7)
CASES = {
    "single_poly_hiding": dict(num_polys=1, num_points=1, hiding=True),
    "two_polys_two_points": dict(num_polys=2, num_points=2, hiding=True),
    "no_hiding": dict(num_polys=2, num_points=1, hiding=False),
    "degree_bounds": dict(num_polys=2, num_points=1, hiding=True, degree_bounds=[4, 6]),
}


@functools.lru_cache(maxsize=None)
def _setup(pkg_name):
    pkg = JAX if pkg_name == "jax" else PORT
    return pkg.I.InnerProductArgPC.setup(SIZES["max_degree"], rng=pkg.DS.HostRng(7), **pkg.dev)


def _round_trip(pkg, num_polys, num_points, hiding, degree_bounds=None, seed=7, pp=None):
    """harness.run_template's steps, returning everything it produces."""
    PC = pkg.I.InnerProductArgPC
    rng = pkg.DS.HostRng(seed)
    pp = pp or _setup("jax" if pkg is JAX else "port")
    enforced = sorted({b for b in (degree_bounds or []) if b is not None}) or None
    hb = num_points if hiding else 0
    ck, vk = PC.trim(pp, SIZES["supported_degree"], hb, enforced)
    polys = []
    for i, bound in enumerate(degree_bounds or [None] * num_polys):
        degree = SIZES["supported_degree"] if bound is None else bound
        ints = rng.field_ints(PC.spec, degree + 1)
        if ints[-1] == 0:
            ints[-1] = 1
        polys.append(pkg.DS.LabeledPolynomial(
            label=f"poly_{i}", poly=pkg.F.from_ints(PC.spec, ints, **pkg.dev),
            degree_bound=bound, hiding_bound=hb if hiding else None))
    comms, states = PC.commit(ck, polys, rng)
    query_set = set()
    points = [rng.field_int(PC.spec) for _ in range(num_points)]
    for pi, point in enumerate(points):
        for lp in polys:
            query_set.add((lp.label, (f"pt_{pi}", point)))
    proofs, values = PC.batch_open(ck, polys, comms, query_set, pkg.T.PoseidonSponge(PC.spec),
                                   states, rng)
    ok = PC.batch_check(vk, comms, query_set, values, proofs, pkg.T.PoseidonSponge(PC.spec))
    return types.SimpleNamespace(PC=PC, pkg=pkg, vk=vk, comms=comms, query_set=query_set,
                                 values=values, proofs=proofs, ok=bool(ok))


@functools.lru_cache(maxsize=None)
def _both(case):
    return _round_trip(JAX, **CASES[case]), _round_trip(PORT, **CASES[case])


def _comms(res):
    return [(c.label, c.degree_bound, c.commitment.comm, c.commitment.shifted_comm) for c in res.comms]


def _proofs(res):
    return [(p.l_vec, p.r_vec, p.final_comm_key, p.c, p.hiding_comm, p.rand) for p in res.proofs]


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_matches_jax(case):
    j, t = _both(case)
    assert _comms(t) == _comms(j)
    assert t.values == j.values
    assert _proofs(t) == _proofs(j)
    assert t.ok is True and j.ok is True


def test_corrupted_value_rejected_by_both():
    for res in _both("single_poly_hiding"):
        bad = dict(res.values)
        key = sorted(bad)[0]
        bad[key] = (bad[key] + 1) % res.PC.spec.modulus
        assert not res.PC.batch_check(res.vk, res.comms, res.query_set, bad, res.proofs,
                                      res.pkg.T.PoseidonSponge(res.PC.spec))


def test_sample_generators_match_jax():
    gens = tI.sample_generators(8)
    assert gens == jI.sample_generators(8)
    p, d = tI.BASE.modulus, tI.HGROUP.d
    assert all((-x * x + y * y) % p == (1 + d * x * x * y * y) % p for x, y in gens)


def test_setup_key_matches_jax():
    t_pp, j_pp = _setup("port"), _setup("jax")
    assert (t_pp.h, t_pp.s, t_pp.max_degree) == (j_pp.h, j_pp.s, j_pp.max_degree)
    for a, b in zip(t_pp.comm_key, convert.ipa_params_from_jax(j_pp, device="cpu").comm_key):
        assert torch.equal(a, b)


def test_params_from_jax_round_trip():
    """A JAX key carried into the port opens and verifies as the JAX
    package's own round trip does."""
    carried = convert.ipa_params_from_jax(copy.copy(_setup("jax")), device="cpu")
    t = _round_trip(PORT, **CASES["single_poly_hiding"], pp=carried)
    j = _both("single_poly_hiding")[0]
    assert _comms(t) == _comms(j) and _proofs(t) == _proofs(j)
    assert t.ok is True


@pytest.mark.parametrize("n", [1, 2, 4])
def test_inner_product_matches_jax(n):
    """The port's inner product (one K1 product, then ``ff.fsum``) against
    the JAX package's (a product and its halving loop of adds) at the
    lengths the round trips above fold through."""
    spec = tI.SPEC
    rng = np.random.default_rng(90 + n)
    a, b = ([int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(n)]
            for _ in range(2))
    got = tI._inner_product(tF.from_ints(spec, a, device="cpu"), tF.from_ints(spec, b, device="cpu"))
    want = jF.to_ints(jI.SPEC, jI._inner_product(jF.from_ints(jI.SPEC, a), jF.from_ints(jI.SPEC, b)))
    assert got == want == sum(x * y for x, y in zip(a, b)) % spec.modulus


EQUATIONS = {
    "single_equation": dict(num_polys=2, num_equations=1),
    "two_equation_degree_bound": dict(num_polys=2, num_equations=2, degree_bounds=[4, None]),
}


def _equation_round_trip(pkg, num_polys, num_equations, degree_bounds=None, seed=11):
    """harness.run_equation_template's steps (one point, hiding) on the
    cached setup (IPA-PC's setup draws nothing): returns the proofs, the
    verdict, and the verdict on an evaluation less one."""
    PC = pkg.I.InnerProductArgPC
    p = PC.spec.modulus
    rng = pkg.DS.HostRng(seed)
    hb = 2  # num_points + 1
    bounds = degree_bounds or [None] * num_polys
    enforced = sorted({b for b in bounds if b is not None}) or None
    ck, vk = PC.trim(_setup("jax" if pkg is JAX else "port"), SIZES["supported_degree"], hb, enforced)
    polys = []
    for i, bound in enumerate(bounds):
        degree = SIZES["supported_degree"] if bound is None else bound
        ints = rng.field_ints(PC.spec, degree + 1)
        if ints[-1] == 0:
            ints[-1] = 1
        polys.append(pkg.DS.LabeledPolynomial(
            label=f"poly_{i}", poly=pkg.F.from_ints(PC.spec, ints, **pkg.dev),
            degree_bound=bound, hiding_bound=hb))
    comms, states = PC.commit(ck, polys, rng)
    lcs = []
    for e in range(num_equations):
        i = e % num_polys
        if polys[i].degree_bound is not None:
            terms = [(1, polys[i].label)]
        else:
            terms = [(rng.field_int(PC.spec), polys[i].label)]
            j = (e + 1) % num_polys
            if polys[j].degree_bound is None and j != i:
                terms.append((rng.field_int(PC.spec), polys[j].label))
            terms.append((rng.field_int(PC.spec), "one"))
        lcs.append(pkg.DS.LinearCombination(label=f"lc_{e}", terms=terms))
    point = rng.field_int(PC.spec)
    query_set = {(lc.label, ("pt_0", point)) for lc in lcs}
    by_label = {lp.label: lp for lp in polys}
    evals = {}
    for lc in lcs:
        acc = 0
        for coeff, term in lc.terms:
            v = 1 if term == "one" else PC.evaluate_poly(by_label[term], point)
            acc = (acc + coeff * v) % p
        evals[(lc.label, point)] = acc
    proof_and_evals = PC.open_combinations(ck, lcs, polys, comms, query_set,
                                           pkg.T.PoseidonSponge(PC.spec), states, rng)

    def check(values):
        return bool(PC.check_combinations(vk, lcs, comms, query_set, values, proof_and_evals,
                                          pkg.T.PoseidonSponge(PC.spec)))

    first = sorted(evals)[0]
    return proof_and_evals[0], check(evals), check({**evals, first: (evals[first] - 1) % p})


@pytest.mark.parametrize("case", list(EQUATIONS))
def test_combinations_match_jax(case):
    j_proofs, j_ok, j_bad = _equation_round_trip(JAX, **EQUATIONS[case])
    t_proofs, t_ok, t_bad = _equation_round_trip(PORT, **EQUATIONS[case])
    assert _proofs(types.SimpleNamespace(proofs=t_proofs)) == _proofs(
        types.SimpleNamespace(proofs=j_proofs))
    assert t_ok is True and j_ok is True
    assert t_bad is False and j_bad is False
