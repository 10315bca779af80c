"""The PyTorch port's G1 formulas (poly_commit_tpu_torch.core.ec_lf, K2a)
against the JAX package's ec_lf (its eager pure-JAX fallback on the CPU) and
an independent host model, on the same raw limbs.

Inputs are Jacobian points with random Z (so Z != 1 is exercised), plus the
edge lanes of tests/test_fast_msm.py: P == Q (doubling), P == -Q (negation)
and an accumulator at infinity. Points are compared in affine form, because
Jacobian coordinates and lazy limbs in [0, 2p) may legitimately differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from poly_commit_tpu.core import ec_lf as jec  # noqa: E402
from poly_commit_tpu_torch.core import ec_lf as ec  # noqa: E402
from poly_commit_tpu_torch.core import ff  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from tests.ref_ec import Fp, RefWeierstrass  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

CURVES = {
    "bls12_381": (FP.FQ_BLS12_381, FP.BLS12_381_B, (FP.BLS12_381_G1_X, FP.BLS12_381_G1_Y)),
    "bls12_377": (FP.FQ_BLS12_377, FP.BLS12_377_B, (FP.BLS12_377_G1_X, FP.BLS12_377_G1_Y)),
}
N = 32
EDGE_DOUBLE, EDGE_NEG, EDGE_INF = 3, 4, 5
FORMULAS = ["madd", "madd_distinct", "madd_packed", "madd_distinct_packed", "add", "double"]


def _limbs(spec, ints):
    return ff.ints_to_limbs(spec, ints).astype(np.uint32).T.copy()


def _case(curve, seed):
    """Host points P (Jacobian, random Z; lane EDGE_INF at infinity) and Q
    (affine), as uint32 (L, N) Montgomery limbs, with their host values."""
    spec, b, gen = CURVES[curve]
    q = spec.modulus
    ref = RefWeierstrass(Fp(q), b)
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 1 << 30)) for _ in range(N)]
    pts = [ref.mul(gen, k) for k in ks]
    qts = [ref.mul(gen, k + 7) for k in ks]
    pts[EDGE_DOUBLE] = qts[EDGE_DOUBLE]
    pts[EDGE_NEG] = (qts[EDGE_NEG][0], (q - qts[EDGE_NEG][1]) % q)
    zs = [int.from_bytes(rng.bytes(56), "little") % (q - 1) + 1 for _ in range(N)]
    jx = [p[0] * z * z % q for p, z in zip(pts, zs)]
    jy = [p[1] * z * z * z % q for p, z in zip(pts, zs)]
    zs[EDGE_INF] = 0
    pts[EDGE_INF] = None
    P = tuple(_limbs(spec, v) for v in (jx, jy, zs))
    Q = tuple(_limbs(spec, [t[i] for t in qts]) for i in (0, 1))
    return spec, ref, pts, qts, P, Q


def _affine(spec, coords):
    q = spec.modulus
    xs, ys, zs = (ff.limbs_to_ints(spec, np.asarray(c).astype(np.uint32).T) for c in coords)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, q)
            out.append((x * zi * zi % q, y * zi * zi * zi % q))
    return out


def _run_both(which, spec, P, Q):
    jP = tuple(jnp.asarray(c) for c in P)
    tP = tuple(torch.from_numpy(c.astype(np.int32)) for c in P)
    jx, jy = (jnp.asarray(c) for c in Q)
    tx, ty = (torch.from_numpy(c.astype(np.int32)) for c in Q)
    if which == "double":
        return jec.double(spec, jP), ec.double(spec, tP)
    if which == "add":
        jQ = jec.from_affine(spec, jx, jy)
        tQ = ec.from_affine(spec, tx, ty)
        return jec.add(spec, jP, jQ), ec.add(spec, tP, tQ)
    if which.endswith("packed"):
        jpq = jnp.concatenate([jx[0::2] | (jx[1::2] << 16), jy[0::2] | (jy[1::2] << 16)], 0)
        tpq = ec.pack(tx, ty)
        assert np.array_equal(tpq.numpy().view(np.uint32), np.asarray(jpq))
        fn_j, fn_t = getattr(jec, which), getattr(ec, which)
        return fn_j(spec, jP, jpq), fn_t(spec, tP, tpq)
    return getattr(jec, which)(spec, jP, jx, jy), getattr(ec, which)(spec, tP, tx, ty)


@pytest.mark.parametrize("curve", ["bls12_381", "bls12_377"])
@pytest.mark.parametrize("which", FORMULAS)
def test_formula_matches_jax_and_host(curve, which):
    spec, ref, pts, qts, P, Q = _case(curve, seed=FORMULAS.index(which))
    j_out, t_out = _run_both(which, spec, P, Q)
    assert all(t.dtype == torch.int32 and t.shape == (spec.n_limbs, N) for t in t_out)
    got = _affine(spec, [t.numpy() for t in t_out])
    want = _affine(spec, [np.asarray(c) for c in j_out])
    if which == "double":
        host = [ref.double(p) for p in pts]
    else:
        host = [ref.add(p, q) for p, q in zip(pts, qts)]
    lanes = range(N)
    if which.startswith("madd_distinct"):
        # the branch-free form excludes P == +-Q (its documented precondition)
        lanes = [i for i in lanes if i not in (EDGE_DOUBLE, EDGE_NEG)]
    assert [got[i] for i in lanes] == [want[i] for i in lanes]
    assert [got[i] for i in lanes] == [host[i] for i in lanes]


def test_add_with_infinity_on_either_side():
    spec, ref, pts, qts, P, Q = _case("bls12_381", seed=9)
    tP = tuple(torch.from_numpy(c.astype(np.int32)) for c in P)
    inf = ec.infinity(spec, N, "cpu")
    assert _affine(spec, [t.numpy() for t in ec.add(spec, inf, tP)]) == pts
    assert _affine(spec, [t.numpy() for t in ec.add(spec, tP, inf)]) == pts
    neg = ec.neg(spec, tP)
    assert _affine(spec, [t.numpy() for t in ec.add(spec, tP, neg)]) == [None] * N


def test_pack_unpack_roundtrip():
    spec, _, _, _, _, Q = _case("bls12_377", seed=4)
    tx, ty = (torch.from_numpy(c.astype(np.int32)) for c in Q)
    ux, uy = ec.unpack(ec.pack(tx, ty))
    assert torch.equal(ux, tx.long()) and torch.equal(uy, ty.long())

