"""The PyTorch port's MarlinPST13 (poly_commit_tpu_torch.pcs.pst13) against
the JAX package's on the CPU.

Both packages run tests/test_pst13.py's round trip (setup -> trim ->
commit -> batch_open -> batch_check) from one HostRng seed and one Poseidon
transcript at its sizes (2 or 3 variables, degree 2), and the BLS12-377
instantiation at 2 variables, degree 2. The port commits against the JAX
SRS, carried by ``convert.pst13_params_from_jax``, so the commitments,
every proof's ``w`` and ``random_v``, the opened values and the verdicts
(a value plus one included) must be equal, with tolerance 0; the port's
own setup must give JAX's SRS. Also: divide_at_point, the monomial order
and values, and the error classes of both packages. The port runs its
kernels' plain versions (K1, K2a, K2c, K3).
"""

import functools
import types

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
import poly_commit_tpu.pcs.errors as jE  # noqa: E402
import poly_commit_tpu.pcs.pst13 as jPS  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.errors as tE  # noqa: E402
import poly_commit_tpu_torch.pcs.pst13 as tPS  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(name="jax", PS=jPS, DS=jDS, T=jT, E=jE, dev={},
                            PC={"bls12_381": jPS.MarlinPST13, "bls12_377": jPS.MarlinPST13_BLS12_377})
PORT = types.SimpleNamespace(name="port", PS=tPS, DS=tDS, T=tT, E=tE, dev={"device": "cpu"},
                             PC={"bls12_381": tPS.MarlinPST13,
                                 "bls12_377": tPS.MarlinPST13_BLS12_377})
# tests/test_pst13.py's round trips, and the second curve
CASES = {
    "single_poly": dict(curve="bls12_381", nv=2, deg=2, num_polys=1, num_points=1, hiding=True,
                        seed=5),
    "two_polys_two_points_no_hiding": dict(curve="bls12_381", nv=2, deg=2, num_polys=2,
                                           num_points=2, hiding=False, seed=5),
    "three_vars": dict(curve="bls12_381", nv=3, deg=2, num_polys=1, num_points=1, hiding=True,
                       seed=9),
    "bls12_377": dict(curve="bls12_377", nv=2, deg=2, num_polys=1, num_points=1, hiding=True,
                      seed=5),
}


@functools.lru_cache(maxsize=None)
def _jax_setup(curve, nv, deg, seed):
    return JAX.PC[curve].setup(deg, num_vars=nv, rng=jDS.HostRng(seed))


def _round_trip(pkg, curve, nv, deg, num_polys, num_points, hiding, seed, pp=None):
    """test_pst13.py's _run: everything it produces. Given ``pp``, setup is
    skipped and the rng advanced past setup's draws (nv betas, three
    scalars), so the later draws are setup's."""
    PC = pkg.PC[curve]
    spec = PC.spec
    rng = pkg.DS.HostRng(seed)
    if pp is None:
        pp = PC.setup(deg, num_vars=nv, rng=rng, **pkg.dev)
    else:
        rng.field_ints(spec, nv + 3)
    ck, vk = PC.trim(pp, deg, 1)
    polys = [pkg.DS.LabeledPolynomial(f"p{i}", pkg.PS.MVPoly.rand(rng, nv, deg, num_terms=6, spec=spec),
                                      hiding_bound=1 if hiding else None, num_vars=nv)
             for i in range(num_polys)]
    comms, states = PC.commit(ck, polys, rng)
    query_set = set()
    for pi in range(num_points):
        pt = tuple(rng.field_int(spec) for _ in range(nv))
        for lp in polys:
            query_set.add((lp.label, (f"pt{pi}", pt)))
    proofs, values = PC.batch_open(ck, polys, comms, query_set, pkg.T.PoseidonSponge(spec), states,
                                   rng)

    def check(vals):
        return bool(PC.batch_check(vk, comms, query_set, vals, proofs, pkg.T.PoseidonSponge(spec)))

    first = sorted(values)[0]
    bad = {**values, first: (values[first] + 1) % spec.modulus}
    return types.SimpleNamespace(pp=pp, ck=ck, comms=[c.commitment.comm for c in comms],
                                 proofs=[(p.w, p.random_v) for p in proofs], values=values,
                                 ok=check(values), tampered_ok=check(bad))


@functools.lru_cache(maxsize=None)
def _both(case):
    kw = CASES[case]
    jpp = _jax_setup(kw["curve"], kw["nv"], kw["deg"], kw["seed"])
    j = _round_trip(JAX, **kw, pp=jpp)
    t = _round_trip(PORT, **kw, pp=convert.pst13_params_from_jax(jpp, device="cpu"))
    return j, t


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_matches_jax(case):
    j, t = _both(case)
    assert t.comms == j.comms
    assert t.proofs == j.proofs
    assert t.values == j.values
    assert t.ok is True and j.ok is True


@pytest.mark.parametrize("case", ["single_poly", "two_polys_two_points_no_hiding"])
def test_tampered_value_rejected_by_both(case):
    j, t = _both(case)
    assert t.tampered_ok is False and j.tampered_ok is False


def test_setup_matches_jax():
    """The port's own setup (G1 powers over every monomial and gamma powers
    on K2a, beta_h on K2c) gives JAX's SRS, read through convert."""
    kw = CASES["single_poly"]
    jpp = convert.pst13_params_from_jax(_jax_setup(kw["curve"], kw["nv"], kw["deg"], kw["seed"]),
                                        device="cpu")
    pp = tPS.MarlinPST13.setup(kw["deg"], num_vars=kw["nv"], rng=tDS.HostRng(kw["seed"]),
                               device="cpu")
    assert pp.term_index == jpp.term_index
    assert all(torch.equal(a, b) for a, b in zip(pp.powers_of_g, jpp.powers_of_g))
    assert (pp.gamma_g, pp.powers_of_gamma_g, pp.h, pp.beta_h) == (
        jpp.gamma_g, jpp.powers_of_gamma_g, jpp.h, jpp.beta_h)


def test_divide_at_point_matches_jax():
    """p(X) - p(z) = sum_i (X_i - z_i) w_i(X): the port's quotients equal
    JAX's term for term, and the identity holds at random points."""
    rng = tDS.HostRng(3)
    nv, deg = 3, 4
    spec = tPS.SPEC
    poly = tPS.MVPoly.rand(rng, nv, deg, num_terms=10)
    z = [rng.field_int(spec) for _ in range(nv)]
    ws = tPS.divide_at_point(poly, z)
    jws = jPS.divide_at_point(jPS.MVPoly(nv, dict(poly.terms)), z)
    assert [w.terms for w in ws] == [w.terms for w in jws]
    p = spec.modulus
    for _ in range(3):
        x = [rng.field_int(spec) for _ in range(nv)]
        rhs = sum((xi - zi) * w.evaluate(x) for xi, zi, w in zip(x, z, ws)) % p
        assert (poly.evaluate(x) - poly.evaluate(z)) % p == rhs
        assert poly.evaluate(x) == jPS.MVPoly(nv, dict(poly.terms)).evaluate(x)


@pytest.mark.parametrize("nv,deg", [(1, 3), (2, 2), (3, 4), (4, 3)])
def test_monomials_and_values_match_jax(nv, deg):
    """setup's monomial order (the SRS rows follow it) and their values at
    the betas, against JAX's enumeration and per-factor powers."""
    mons = tPS._all_monomials(nv, deg)
    assert mons == jPS._all_monomials(nv, deg)
    p = tPS.SPEC.modulus
    betas = [int(v) for v in np.random.default_rng(nv * 10 + deg).integers(2, 1 << 62, nv)]
    want = [int(np.prod([pow(b, e, p) for b, e in zip(betas, t)], dtype=object)) % p for t in mons]
    assert tPS._monomial_values(betas, deg, p) == want


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_errors_match(pkg):
    """The same error classes in both packages: variables, degree, trim,
    a degree past the key, a hiding bound of zero, past the key, and no
    rng for hiding."""
    PC = pkg.PC["bls12_381"]
    E = pkg.E
    with pytest.raises(E.InvalidNumberOfVariables):
        PC.setup(2, num_vars=0, rng=pkg.DS.HostRng(0), **pkg.dev)
    with pytest.raises(E.DegreeIsZero):
        PC.setup(0, num_vars=2, rng=pkg.DS.HostRng(0), **pkg.dev)
    jpp = _jax_setup("bls12_381", 2, 2, 5)
    pp = jpp if pkg is JAX else convert.pst13_params_from_jax(jpp, device="cpu")
    with pytest.raises(E.TrimmingDegreeTooLarge):
        PC.trim(pp, 3)
    ck, _ = PC.trim(pp, 2)
    rng = pkg.DS.HostRng(7)
    big = pkg.DS.LabeledPolynomial("big", pkg.PS.MVPoly(2, {(3, 0): 5}), num_vars=2)
    with pytest.raises(E.PolynomialDegreeTooLarge):
        PC.commit(ck, [big], rng)
    small = pkg.PS.MVPoly(2, {(1, 0): 5, (0, 1): 3})
    for bound, err, r in ((0, E.HidingBoundIsZero, rng), (3, E.HidingBoundToolarge, rng),
                          (1, E.MissingRng, None)):
        lp = pkg.DS.LabeledPolynomial("p", small, hiding_bound=bound, num_vars=2)
        with pytest.raises(err):
            PC.commit(ck, [lp], r)
