"""The PyTorch port's SonicKZG10 against the JAX package.

Both packages run tests/harness.py's templates (tests/test_sonic_pc.py's
cases) from the same HostRng seed, with max_degree 16 and supported degree
8, through tests/test_torch_marlin.py's helpers: commitments, proofs,
opened values and verdicts must be equal. Also here: setup's G2 powers
neg_powers_of_h against JAX's as canonical affine ints, and a round trip
against JAX's SRS carried across by convert.params_from_jax. The port runs
on the CPU (its kernels' plain versions).
"""

import functools
import types

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import poly_commit_tpu.core.curve as jC  # noqa: E402
import poly_commit_tpu.core.hostec as jH  # noqa: E402
import poly_commit_tpu.pcs.sonic_pc as jS  # noqa: E402
import poly_commit_tpu_torch.core.curve as tC  # noqa: E402
import poly_commit_tpu_torch.core.hostec as tH  # noqa: E402
import poly_commit_tpu_torch.pcs.sonic_pc as tS  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
from tests import test_torch_marlin as TM  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(**{**vars(TM.JAX), "name": "jax_sonic",
                               "PC": {"bls12_381": jS.SonicKZG10,
                                      "bls12_377": jS.SonicKZG10_BLS12_377}})
PORT = types.SimpleNamespace(**{**vars(TM.PORT), "name": "port_sonic",
                                "PC": {"bls12_381": tS.SonicKZG10,
                                       "bls12_377": tS.SonicKZG10_BLS12_377}})
CASES = {"single_poly": dict(num_polys=1, num_points=1),
         "two_polys_two_points": dict(num_polys=2, num_points=2),
         "no_hiding": dict(num_polys=2, num_points=1, hiding=False),
         "degree_bounds": dict(num_polys=2, num_points=2, degree_bounds=[4, 6]),
         "mixed_degree_bounds": dict(num_polys=3, num_points=1, degree_bounds=[4, None, 6])}
EQUATIONS = {"single_equation": dict(num_polys=2, num_equations=1),
             "two_equation_degree_bound": dict(num_polys=2, num_equations=2,
                                               degree_bounds=[4, None])}


@functools.lru_cache(maxsize=None)
def _both(curve, case):
    return (TM._round_trip(JAX, curve, **CASES[case]), TM._round_trip(PORT, curve, **CASES[case]))


def _comm_points(res):
    return [(c.label, c.degree_bound, c.commitment.point) for c in res.comms]


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_matches_jax(case):
    j, t = _both("bls12_381", case)
    assert _comm_points(t) == _comm_points(j)
    assert t.values == j.values
    assert TM._proof_points(t) == TM._proof_points(j)
    assert t.ok is True and j.ok is True


def test_bls12_377_round_trip_matches_jax():
    j, t = _both("bls12_377", "single_poly")
    assert _comm_points(t) == _comm_points(j) and t.values == j.values
    assert TM._proof_points(t) == TM._proof_points(j)
    assert t.ok is True and j.ok is True


def test_wrong_value_rejected_by_both():
    results = _both("bls12_381", "single_poly")
    for pkg, res in zip((JAX, PORT), results):
        key = sorted(res.values)[0]
        bad = dict(res.values)
        bad[key] = (bad[key] + 1) % res.PC.spec.modulus
        assert not res.PC.batch_check(res.vk, res.comms, res.query_set, bad, res.proofs,
                                      pkg.T.PoseidonSponge(res.PC.spec))


@pytest.mark.parametrize("degree,bound,error", [(8, 4, "IncorrectDegreeBound"),
                                                (3, 5, "UnsupportedDegreeBound")],
                         ids=["bad_degree_bound", "unsupported_degree_bound"])
def test_bound_errors_match_jax(degree, bound, error):
    assert TM._commit_error(PORT, "bls12_381", 7, degree, bound) == error
    assert TM._commit_error(JAX, "bls12_381", 7, degree, bound) == error


@pytest.mark.parametrize("case", list(EQUATIONS))
def test_equation_template_matches_jax(case):
    j_proofs, j_ok = TM._equation_round_trip(JAX, "bls12_381", **EQUATIONS[case])
    t_proofs, t_ok = TM._equation_round_trip(PORT, "bls12_381", **EQUATIONS[case])
    assert [(p.w, p.random_v) for p in t_proofs] == [(p.w, p.random_v) for p in j_proofs]
    assert t_ok is True and j_ok is True


def test_neg_powers_of_h_match_jax():
    j_pp, _ = TM._setup(JAX, "bls12_381", 7)
    t_pp, _ = TM._setup(PORT, "bls12_381", 7)
    want = jH.device_affine_to_host(jC.BLS12_381_G2, j_pp.neg_powers_of_h)
    got = tH.device_affine_to_host(tC.BLS12_381_G2, t_pp.neg_powers_of_h)
    assert len(got) == TM.SIZES["max_degree"] + 1 and got == want


def test_params_from_jax_round_trip():
    """JAX's SRS with its G2 powers carried into the port: the same limbs,
    and the port's bounded round trip on it equals JAX's on its own."""
    j_pp, _ = TM._setup(JAX, "bls12_381", 7)
    t_own, rng = TM._fresh_setup(PORT, "bls12_381", 7)
    d = {name: tuple(np.asarray(a) for a in getattr(j_pp, name))
         for name in ("powers_of_g", "powers_of_gamma_g", "h", "beta_h", "neg_powers_of_h")}
    carried = convert.params_from_jax({**d, "max_degree": j_pp.max_degree}, device="cpu")
    for a, b in zip(carried.neg_powers_of_h, t_own.neg_powers_of_h):
        assert torch.equal(a, b)
    t = TM._round_trip(PORT, "bls12_381", **CASES["degree_bounds"], pp=carried, rng=rng)
    j = _both("bls12_381", "degree_bounds")[0]
    assert _comm_points(t) == _comm_points(j) and TM._proof_points(t) == TM._proof_points(j)
    assert t.ok is True
