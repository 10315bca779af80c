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



SCAN_LANES, SCAN_STEPS = 8, 5


def _scan_case(distinct):
    """A point-major table of BLS12-381 G1 points (row 9 the negation of
    row 0), idx and keep for 8 lanes x 5 steps, and the host sums of every
    prefix. Lane 0 skips its first two steps (its prefixes start at
    infinity), lane 7 skips every step; with the complete madd, lane 1 adds
    row 0 twice (a doubling) and lane 2 adds row 0 then row 9 (back to
    infinity, then onwards)."""
    from poly_commit_tpu_torch.core import curve, hostec

    group = curve.BLS12_381_G1
    spec, hg = group.spec, hostec.host_group(curve.BLS12_381_G1)
    rng = np.random.default_rng(21)
    pts = [hg.mul_fast((group.gen_x, group.gen_y), int(rng.integers(1, 1 << 40))) for _ in range(9)]
    pts.append(hg.neg(pts[0]))
    # distinct rows within a lane, so the distinct madd's precondition holds
    idx = np.stack([rng.permutation(9)[:SCAN_STEPS] for _ in range(SCAN_LANES)], 1)
    keep = rng.random((SCAN_STEPS, SCAN_LANES)) < 0.8
    keep[:2, 0] = False
    keep[:, 7] = False
    if not distinct:
        idx[:2, 1], keep[:2, 1] = 0, True
        idx[:2, 2], keep[:2, 2] = (0, 9), True
    sums, acc = [], [None] * SCAN_LANES
    for s in range(SCAN_STEPS):
        acc = [hg.add(a, pts[idx[s, i]]) if keep[s, i] else a for i, a in enumerate(acc)]
        sums.append(acc)
    x = ff.from_ints(spec, [p[0] for p in pts], device="cpu")
    y = ff.from_ints(spec, [p[1] for p in pts], device="cpu")
    table = ec.pack(x, y).T.contiguous()
    return spec, table, torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(keep), sums


@pytest.mark.parametrize("distinct", [True, False], ids=["distinct", "complete"])
def test_madd_scan_plain_matches_host_sums(distinct):
    """madd_scan on the CPU (its plain version): every step's prefix equals
    the host sum of the lane's kept points, in affine form, and the final
    sums are the last prefix."""
    spec, table, idx, keep, sums = _scan_case(distinct)
    acc, prefixes = ec.madd_scan(spec, table, idx, keep, distinct)
    assert prefixes.shape == (3, spec.n_limbs, SCAN_STEPS, SCAN_LANES)
    for s in range(SCAN_STEPS):
        got = _affine(spec, [prefixes[k, :, s].numpy() for k in range(3)])
        assert got == sums[s]
    assert all(torch.equal(a, prefixes[k, :, -1]) for k, a in enumerate(acc))
    again = ec.madd_scan_plain(spec, table, idx, keep, distinct)
    assert torch.equal(again[1], prefixes)
    assert ec.madd_scan.launches == 0  # the CPU launches nothing


def _bad_scan_args(spec, table, idx, keep):
    return {
        "narrow_table": (table[:, :-1].contiguous(), idx, keep),
        "int64_idx": (table, idx.long(), keep),
        "uint8_keep": (table, idx, keep.to(torch.uint8)),
        "keep_shape": (table, idx, keep[:-1].contiguous()),
        "no_steps": (table, idx[:0], keep[:0]),
        "strided_idx": (table, idx.T, keep.T),
    }


@pytest.mark.parametrize("case", ["narrow_table", "int64_idx", "uint8_keep", "keep_shape",
                                  "no_steps", "strided_idx"])
def test_madd_scan_refuses_what_the_kernel_does_not_take(case):
    spec, table, idx, keep, _ = _scan_case(True)
    args = _bad_scan_args(spec, table, idx, keep)[case]
    with pytest.raises(ValueError):
        ec.madd_scan(spec, *args, True)
    with pytest.raises(ValueError):
        ec.madd_scan_plain(spec, *args, True)
