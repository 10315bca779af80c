"""The PyTorch port's MarlinKZG10 slice as a whole against the JAX package.

Both packages run the tests/harness.py::run_template round trip
(setup -> trim -> commit -> batch_open -> batch_check) from the same HostRng
seed, which both draw bit for bit alike, so commitments, opened values,
proof points and verdicts must be equal, on BLS12-381 and BLS12-377. The
port runs on the CPU (its kernels' plain versions); the JAX package on its
CPU routes. Also here: the SRS carried across with convert.params_from_jax,
and the corrupted-value rejection (tests/test_torch_kzg.py has the rest).
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
import poly_commit_tpu.pcs.marlin_pc as jM  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.marlin_pc as tM  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(F=jF, DS=jDS, T=jT, dev={},
                            PC={"bls12_381": jM.MarlinKZG10, "bls12_377": jM.MarlinKZG10_BLS12_377})
PORT = types.SimpleNamespace(F=tF, DS=tDS, T=tT, dev={"device": "cpu"},
                             PC={"bls12_381": tM.MarlinKZG10, "bls12_377": tM.MarlinKZG10_BLS12_377})
SIZES = dict(max_degree=16, supported_degree=8)
CASES = {"single_poly_hiding": dict(num_polys=1, num_points=1),
         "two_polys_two_points": dict(num_polys=2, num_points=2)}


@functools.lru_cache(maxsize=None)
def _setup(pkg_name, curve, seed):
    """One setup per package, curve and seed; the rng is returned in the
    state setup left it in, so later draws continue the same stream."""
    pkg = {"jax": JAX, "port": PORT}[pkg_name]
    rng = pkg.DS.HostRng(seed)
    return pkg.PC[curve].setup(SIZES["max_degree"], rng=rng, **pkg.dev), rng


def _round_trip(pkg, curve, num_polys, num_points, seed=7, pp=None, degree_bounds=None):
    """harness.run_template's steps, returning everything it produces."""
    PC = pkg.PC[curve]
    rng = pkg.DS.HostRng(seed)
    if pp is None:
        pp, rng = _setup("jax" if pkg is JAX else "port", curve, seed)
        rng = copy.deepcopy(rng)
    hb = num_points
    bounds = degree_bounds or [None] * num_polys
    enforced = sorted({b for b in bounds if b is not None}) or None
    ck, vk = PC.trim(pp, SIZES["supported_degree"], hb, enforced)
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
