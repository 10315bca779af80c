"""The rest of the PyTorch port's KZG slice against the JAX package:
MarlinKZG10 with degree bounds (shifted commitments, the SRS read back as
host points in trim), the polynomial operations of the path, and
kzg10.check on a single opening. The round trip is tests/test_torch_marlin.py's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.poly as jP  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.poly as tP  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.marlin_pc as tM  # noqa: E402
from poly_commit_tpu_torch.pcs import kzg10  # noqa: E402
from tests.test_torch_marlin import JAX, PORT, _comm_points, _proof_points, _round_trip, _setup  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files


def test_degree_bounds_match_jax():
    kw = dict(num_polys=2, num_points=2, degree_bounds=[4, 6])
    j = _round_trip(JAX, "bls12_381", **kw)
    t = _round_trip(PORT, "bls12_381", **kw)
    assert all(c[2] is not None for c in _comm_points(t))  # shifted commitments
    assert _comm_points(t) == _comm_points(j)
    assert t.values == j.values and _proof_points(t) == _proof_points(j)
    assert t.ok is True and j.ok is True


@pytest.mark.parametrize("n", [1, 9, 37])
def test_poly_ops_match_jax(n):
    spec = tM.MarlinKZG10.spec
    rng = np.random.default_rng(n)
    ints = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(n)]
    z = int.from_bytes(rng.bytes(40), "little") % spec.modulus
    jc, tc = jF.from_ints(spec, ints), tF.from_ints(spec, ints, device="cpu")
    jz, tz = jF.from_ints(spec, z), tF.from_ints(spec, z, device="cpu")
    assert tF.to_ints(spec, tP.evaluate(spec, tc, tz)) == jF.to_ints(spec, jP.evaluate(spec, jc, jz))
    jq, jr = jP.divide_by_linear(spec, jc, jz)
    want = (jF.to_ints(spec, jq) if n > 1 else [], jF.to_ints(spec, jr))
    for q, r in (tP.divide_by_linear(spec, tc, tz), tP.divide_by_linear_int(spec, tc, z)):
        assert (tF.to_ints(spec, q) if n > 1 else [], tF.to_ints(spec, r)) == want
    assert tF.to_ints(spec, tP.powers(spec, tz, n)) == [pow(z, k, spec.modulus) for k in range(n)]
    q0, r0 = tP.divide_by_linear_int(spec, tc, 0)
    assert tF.to_ints(spec, r0) == ints[0]


def test_kzg_checks_reject_tampering():
    """kzg10.check (one opening, host pairing) accepts the honest proof and
    rejects a changed value or point."""
    pp, _ = _setup(PORT, "bls12_381", 7)
    ck, vk = tM.MarlinKZG10.trim(pp, 8, 1, None)
    rng = tDS.HostRng(3)
    coeffs = tF.from_ints(tM.MarlinKZG10.spec, rng.field_ints(tM.MarlinKZG10.spec, 9), device="cpu")
    powers = kzg10.Powers(ck.powers, ck.powers_of_gamma_g)
    comm, rand = kzg10.commit(powers, coeffs, hiding_bound=1, rng=rng)
    z = rng.field_int(tM.MarlinKZG10.spec)
    proof = kzg10.open(powers, coeffs, z, rand)
    v = tF.to_ints(tM.MarlinKZG10.spec, tP.evaluate(tM.MarlinKZG10.spec, coeffs,
                                                     tF.from_ints(tM.MarlinKZG10.spec, z, device="cpu")))
    assert kzg10.check(vk.vk, comm, z, v, proof)
    assert not kzg10.check(vk.vk, comm, z, v + 1, proof)
    assert not kzg10.check(vk.vk, comm, z + 1, v, proof)
