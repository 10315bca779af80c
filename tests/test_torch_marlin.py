"""The PyTorch port's MarlinKZG10 slice as a whole against the JAX package.

Both packages run the tests/harness.py::run_template round trip
(setup -> trim -> commit -> batch_open -> batch_check) from the same HostRng
seed, which both draw bit for bit alike, so commitments, opened values,
proof points and verdicts must be equal, on BLS12-381 and BLS12-377. The
port runs on the CPU (its kernels' plain versions); the JAX package on its
CPU routes. Also here: the SRS carried across with convert.params_from_jax,
the corrupted-value rejection, mixed degree bounds, the equation
templates (tests/harness.py::run_equation_template: open_combinations ->
check_combinations) and kzg10.trim_powers (tests/test_torch_kzg.py has the
rest). tests/test_torch_sonic.py runs SonicKZG10 through the same helpers.
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
import poly_commit_tpu.pcs.errors as jE  # noqa: E402
import poly_commit_tpu.pcs.kzg10 as jK  # noqa: E402
import poly_commit_tpu.pcs.marlin_pc as jM  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.errors as tE  # noqa: E402
import poly_commit_tpu_torch.pcs.marlin_pc as tM  # noqa: E402
from poly_commit_tpu_torch.pcs import convert, kzg10  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(name="jax", F=jF, DS=jDS, T=jT, E=jE, dev={},
                            PC={"bls12_381": jM.MarlinKZG10, "bls12_377": jM.MarlinKZG10_BLS12_377})
PORT = types.SimpleNamespace(name="port", F=tF, DS=tDS, T=tT, E=tE, dev={"device": "cpu"},
                             PC={"bls12_381": tM.MarlinKZG10, "bls12_377": tM.MarlinKZG10_BLS12_377})
SIZES = dict(max_degree=16, supported_degree=8)
CASES = {"single_poly_hiding": dict(num_polys=1, num_points=1),
         "two_polys_two_points": dict(num_polys=2, num_points=2)}
_SETUPS = {}


def _setup(pkg, curve, seed):
    """One setup per package (by name), curve and seed; the rng is returned
    in the state setup left it in, so later draws continue the same stream."""
    key = (pkg.name, curve, seed)
    if key not in _SETUPS:
        rng = pkg.DS.HostRng(seed)
        _SETUPS[key] = (pkg.PC[curve].setup(SIZES["max_degree"], rng=rng, **pkg.dev), rng)
    return _SETUPS[key]


def _fresh_setup(pkg, curve, seed):
    """The cached setup, with a copy of its rng."""
    pp, rng = _setup(pkg, curve, seed)
    return pp, copy.deepcopy(rng)


def _polys(pkg, PC, rng, bounds, hb):
    """harness.rand_poly for each bound (degree supported_degree when None)."""
    polys = []
    for i, bound in enumerate(bounds):
        degree = SIZES["supported_degree"] if bound is None else bound
        ints = rng.field_ints(PC.spec, degree + 1)
        if ints[-1] == 0:
            ints[-1] = 1
        polys.append(pkg.DS.LabeledPolynomial(
            label=f"poly_{i}", poly=pkg.F.from_ints(PC.spec, ints, **pkg.dev),
            degree_bound=bound, hiding_bound=hb))
    return polys


def _round_trip(pkg, curve, num_polys, num_points, seed=7, pp=None, degree_bounds=None,
                hiding=True, rng=None):
    """harness.run_template's steps, returning everything it produces. With
    ``pp`` given, the draws come from ``rng`` (default a fresh
    HostRng(seed)); else from the cached setup's rng."""
    PC = pkg.PC[curve]
    rng = rng or pkg.DS.HostRng(seed)
    if pp is None:
        pp, rng = _fresh_setup(pkg, curve, seed)
    hb = num_points if hiding else 0
    bounds = degree_bounds or [None] * num_polys
    enforced = sorted({b for b in bounds if b is not None}) or None
    ck, vk = PC.trim(pp, SIZES["supported_degree"], hb, enforced)
    polys = _polys(pkg, PC, rng, bounds, hb if hiding else None)
    comms, states = PC.commit(ck, polys, rng)
    query_set = set()
    points = [rng.field_int(PC.spec) for _ in range(num_points)]
    for pi, point in enumerate(points):
        for lp in polys:
            query_set.add((lp.label, (f"pt_{pi}", point)))
    proofs, values = PC.batch_open(ck, polys, comms, query_set, pkg.T.PoseidonSponge(PC.spec),
                                   states, rng)
    ok = PC.batch_check(vk, comms, query_set, values, proofs, pkg.T.PoseidonSponge(PC.spec))
    return types.SimpleNamespace(PC=PC, vk=vk, comms=comms, query_set=query_set, values=values,
                                 proofs=proofs, ok=bool(ok), pp=pp)


def _equation_round_trip(pkg, curve, num_polys, num_equations, degree_bounds=None, seed=7):
    """harness.run_equation_template's steps (one point, hiding), after the
    cached setup of ``seed``: returns (proofs, verdict)."""
    PC = pkg.PC[curve]
    p = PC.spec.modulus
    pp, rng = _fresh_setup(pkg, curve, seed)
    hb = 2  # num_points + 1
    bounds = degree_bounds or [None] * num_polys
    enforced = sorted({b for b in bounds if b is not None}) or None
    ck, vk = PC.trim(pp, SIZES["supported_degree"], hb, enforced)
    polys = _polys(pkg, PC, rng, bounds, hb)
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
    eqn_evals = {}
    for lc in lcs:
        acc = 0
        for coeff, term in lc.terms:
            v = 1 if term == "one" else PC.evaluate_poly(by_label[term], point)
            acc = (acc + coeff * v) % p
        eqn_evals[(lc.label, point)] = acc
    proof_and_evals = PC.open_combinations(ck, lcs, polys, comms, query_set,
                                           pkg.T.PoseidonSponge(PC.spec), states, rng)
    ok = PC.check_combinations(vk, lcs, comms, query_set, eqn_evals, proof_and_evals,
                               pkg.T.PoseidonSponge(PC.spec))
    return proof_and_evals[0], bool(ok)


def _commit_error(pkg, curve, seed, degree, bound):
    """harness's bad-bound tests: trim with bounds [4, 6], then commit a
    polynomial of ``degree`` with ``bound``; the PCError's class name."""
    PC = pkg.PC[curve]
    pp, rng = _fresh_setup(pkg, curve, seed)
    ck, _ = PC.trim(pp, SIZES["supported_degree"], 2, [4, 6])
    lp = _polys(pkg, PC, rng, [degree], 2)[0]
    lp.degree_bound = bound
    with pytest.raises(pkg.E.PCError) as err:
        PC.commit(ck, [lp], rng)
    return type(err.value).__name__


@functools.lru_cache(maxsize=None)
def _both(curve, case):
    return (_round_trip(JAX, curve, **CASES[case]), _round_trip(PORT, curve, **CASES[case]))


def _comm_points(res):
    return [(c.label, c.commitment.comm, c.commitment.shifted_comm) for c in res.comms]


def _proof_points(res):
    return [(p.w, p.random_v) for p in res.proofs]


@pytest.mark.parametrize("curve", ["bls12_381", "bls12_377"])
@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_matches_jax(curve, case):
    j, t = _both(curve, case)
    assert _comm_points(t) == _comm_points(j)
    assert t.values == j.values
    assert _proof_points(t) == _proof_points(j)
    assert t.ok is True and j.ok is True


@pytest.mark.parametrize("curve", ["bls12_381", "bls12_377"])
def test_corrupted_value_rejected_by_both(curve):
    results = _both(curve, "single_poly_hiding")
    for res in results:
        key = sorted(res.values)[0]
        bad = dict(res.values)
        bad[key] = (bad[key] + 1) % res.PC.spec.modulus
        sponge = (JAX if res is results[0] else PORT).T.PoseidonSponge(res.PC.spec)
        assert not res.PC.batch_check(res.vk, res.comms, res.query_set, bad, res.proofs, sponge)


def test_params_from_jax_commits_alike():
    """The JAX SRS carried into the port: the port's keys and commitment
    equal the JAX package's, and the port's proof verifies."""
    j_pp = _both("bls12_381", "single_poly_hiding")[0].pp
    d = {
        "powers_of_g": tuple(np.asarray(a) for a in j_pp.powers_of_g),
        "powers_of_gamma_g": tuple(np.asarray(a) for a in j_pp.powers_of_gamma_g),
        "h": tuple(np.asarray(a) for a in j_pp.h),
        "beta_h": tuple(np.asarray(a) for a in j_pp.beta_h),
        "max_degree": j_pp.max_degree,
    }
    t_pp = convert.params_from_jax(d, device="cpu")
    t_own = _both("bls12_381", "single_poly_hiding")[1].pp
    for name in ("powers_of_g", "powers_of_gamma_g"):
        for a, b in zip(getattr(t_pp, name), getattr(t_own, name)):
            assert torch.equal(a, b)
    assert (t_pp.h, t_pp.beta_h) == (t_own.h, t_own.beta_h)
    j = _round_trip(JAX, "bls12_381", num_polys=1, num_points=1, seed=21, pp=j_pp)
    t = _round_trip(PORT, "bls12_381", num_polys=1, num_points=1, seed=21, pp=t_pp)
    assert _comm_points(t) == _comm_points(j) and _proof_points(t) == _proof_points(j)
    assert t.ok is True


def test_mixed_degree_bounds_match_jax():
    kw = dict(num_polys=3, num_points=1, degree_bounds=[4, None, 6])
    j = _round_trip(JAX, "bls12_381", **kw)
    t = _round_trip(PORT, "bls12_381", **kw)
    assert [c[2] is None for c in _comm_points(t)] == [False, True, False]
    assert _comm_points(t) == _comm_points(j)
    assert t.values == j.values and _proof_points(t) == _proof_points(j)
    assert t.ok is True and j.ok is True


EQUATIONS = {"single_equation": dict(num_polys=2, num_equations=1),
             "two_equations": dict(num_polys=3, num_equations=2),
             "two_equation_degree_bound": dict(num_polys=2, num_equations=2,
                                               degree_bounds=[4, None])}


@pytest.mark.parametrize("case", list(EQUATIONS))
def test_equation_template_matches_jax(case):
    j_proofs, j_ok = _equation_round_trip(JAX, "bls12_381", **EQUATIONS[case])
    t_proofs, t_ok = _equation_round_trip(PORT, "bls12_381", **EQUATIONS[case])
    assert [(p.w, p.random_v) for p in t_proofs] == [(p.w, p.random_v) for p in j_proofs]
    assert t_ok is True and j_ok is True


def test_trim_powers_matches_jax():
    j_pp = _both("bls12_381", "single_poly_hiding")[0].pp
    t_pp = _both("bls12_381", "single_poly_hiding")[1].pp
    j, t = jK.trim_powers(j_pp, 5), kzg10.trim_powers(t_pp, 5)
    for name in ("powers_of_g", "powers_of_gamma_g"):
        for a, b in zip(getattr(j, name), getattr(t, name)):
            assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))
    assert t.size() == j.size() == 6
