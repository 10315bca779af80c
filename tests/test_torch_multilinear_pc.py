"""The PyTorch port's MultilinearPC (poly_commit_tpu_torch.pcs.multilinear_pc)
against the JAX package's on the CPU.

Both packages run setup -> trim -> commit -> open -> check from one HostRng
seed (the same ChaCha20 stream), so the SRS, the commitment, every per-round
G2 proof and the verdicts must be equal, with tolerance 0. The port runs its
kernels' plain versions (K2a for G1, K2c for G2); the JAX package its CPU
routes. Also: trimming a setup of 4 variables to 2, a tampered value, a
setup of 0 variables, and a JAX SRS carried across by
``convert.multilinear_params_from_jax``.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
import poly_commit_tpu.pcs.multilinear_pc as jML  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.multilinear_pc as tML  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(ML=jML, DS=jDS, F=jF, dev={})
PORT = types.SimpleNamespace(ML=tML, DS=tDS, F=tF, dev={"device": "cpu"})
SPEC = tML.SPEC


def _mle(ints, point):
    """The host MLE fold (variable 1 in the lowest index bit)."""
    p = SPEC.modulus
    for z in point:
        ints = [(a + z * (b - a)) % p for a, b in zip(ints[0::2], ints[1::2])]
    return ints[0]


@functools.lru_cache(maxsize=None)
def _setup(pkg_name, nv, seed):
    pkg = JAX if pkg_name == "jax" else PORT
    rng = pkg.DS.HostRng(seed)
    return pkg.ML.setup(nv, rng, **pkg.dev), rng


def _round_trip(pkg, nv, setup_nv, seed, pp=None):
    ML = pkg.ML
    if pp is None:
        pp, rng = _setup("jax" if pkg is JAX else "port", setup_nv, seed)
    rng = pkg.DS.HostRng(seed + 100)
    ck, vk = ML.trim(pp, nv)
    ints = rng.field_ints(SPEC, 1 << nv)
    table = pkg.F.from_ints(SPEC, ints, **pkg.dev)
    point = [rng.field_int(SPEC) for _ in range(nv)]
    comm = ML.commit(ck, table)
    proof = ML.open(ck, table, point)
    value = _mle(ints, point)
    return types.SimpleNamespace(
        pp=pp, vk=vk, comm=comm, proof=proof, point=point, value=value,
        ok=bool(ML.check(vk, comm, point, value, proof)),
        bad=bool(ML.check(vk, comm, point, (value + 1) % SPEC.modulus, proof)))


@functools.lru_cache(maxsize=None)
def _both(nv, setup_nv, seed):
    return _round_trip(JAX, nv, setup_nv, seed), _round_trip(PORT, nv, setup_nv, seed)


CASES = {"nv3": (3, 3, 21), "trim_4_to_2": (2, 4, 22)}


@pytest.mark.parametrize("case", list(CASES))
def test_commitment_and_proofs_match_jax(case):
    j, t = _both(*CASES[case])
    assert (t.comm.nv, t.comm.g_product) == (j.comm.nv, j.comm.g_product)
    assert len(t.proof.proofs) == CASES[case][0]
    assert t.proof.proofs == j.proof.proofs


@pytest.mark.parametrize("case", list(CASES))
def test_verdicts_match_jax(case):
    j, t = _both(*CASES[case])
    assert (t.ok, t.bad) == (j.ok, j.bad) == (True, False)


def test_setup_matches_jax():
    j, t = _both(*CASES["nv3"])
    assert (t.pp.g, t.pp.h, t.pp.g_mask) == (j.pp.g, j.pp.h, j.pp.g_mask)
    for tl, jl in zip(t.pp.powers_of_g + t.pp.powers_of_h, j.pp.powers_of_g + j.pp.powers_of_h):
        for a, b in zip(tl, jl):
            assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


def test_setup_of_zero_variables_raises():
    with pytest.raises(tML.errors.InvalidNumberOfVariables):
        tML.setup(0, tDS.HostRng(0), device="cpu")


def test_params_from_jax_open_alike():
    """The JAX SRS carried into the port: the port's keys equal its own,
    and a round trip on them equals the JAX package's."""
    j, t = _both(*CASES["nv3"])
    carried = convert.multilinear_params_from_jax(j.pp, device="cpu")
    assert (carried.g, carried.h, carried.g_mask) == (t.pp.g, t.pp.h, t.pp.g_mask)
    for tl, cl in zip(t.pp.powers_of_h, carried.powers_of_h):
        assert all(torch.equal(a, b) for a, b in zip(tl, cl))
    res = _round_trip(PORT, 3, 3, 21, pp=carried)
    assert res.comm.g_product == j.comm.g_product and res.proof.proofs == j.proof.proofs
    assert res.ok and not res.bad
