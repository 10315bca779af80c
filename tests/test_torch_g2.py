"""The PyTorch port's G2 slice against the JAX package on the CPU: Fq2
(poly_commit_tpu_torch.core.extfield against poly_commit_tpu.core.extfield),
the K2c formulas' plain versions (core/ec_lf.py ``g2_*`` against the JAX
eager graph ``ec_lf._ec_fn(spec, "g2_*", n, False)``) and the G2 MSM and
fixed-base multiplication against the JAX package's host group law.

Inputs are made with numpy from a seed and handed to both packages. Field
elements are compared as canonical ints, points in affine form; the
formulas are also compared limb for limb, since both packages run the same
operation sequence. Tolerance 0 throughout.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from poly_commit_tpu.core import curve as jC  # noqa: E402
from poly_commit_tpu.core import ec_lf as jec  # noqa: E402
from poly_commit_tpu.core import hostec as jH  # noqa: E402
from poly_commit_tpu_torch.core import curve as C  # noqa: E402
from poly_commit_tpu_torch.core import ec_lf as ec  # noqa: E402
from poly_commit_tpu_torch.core import extfield as E2  # noqa: E402
from poly_commit_tpu_torch.core import ff, msm  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

GROUPS = {"bls12_381": (C.BLS12_381_G2, jC.BLS12_381_G2),
          "bls12_377": (C.BLS12_377_G2, jC.BLS12_377_G2)}
N = 12
EDGE_INF, EDGE_DOUBLE, EDGE_NEG, EDGE_Q_INF = 0, 3, 4, 5
FORMULAS = ["madd", "madd_distinct", "madd_packed", "madd_distinct_packed", "add", "double"]


def _pairs(spec, rng, n):
    q = spec.modulus
    return [(int.from_bytes(rng.bytes(56), "little") % q, int.from_bytes(rng.bytes(56), "little") % q)
            for _ in range(n)]


@pytest.mark.parametrize("curve", list(GROUPS))
@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "inv", "batch_inv"])
def test_fq2_matches_jax(curve, op):
    tg, jg = GROUPS[curve]
    spec, jops = tg.spec, jg.fops
    rng = np.random.default_rng(["mul", "sqr", "add", "sub", "inv", "batch_inv"].index(op))
    a, b = E2.from_ints(spec, _pairs(spec, rng, N), device="cpu"), E2.from_ints(spec, _pairs(spec, rng, N), device="cpu")
    ja, jb = (jnp.asarray(t.numpy().astype(np.uint32)) for t in (a, b))
    if op == "inv":
        got, want = E2.inv(spec, a[0]), jops.inv(ja[0])
        assert E2.to_int(spec, got) == tuple(int(v) for v in jops.to_int(want))
        return
    t_fn = {"mul": lambda: E2.mul(spec, a, b), "sqr": lambda: E2.sqr(spec, a),
            "add": lambda: E2.add(spec, a, b), "sub": lambda: E2.sub(spec, a, b),
            "batch_inv": lambda: E2.batch_inv(spec, a)}[op]
    j_fn = {"mul": lambda: jops.mul(ja, jb), "sqr": lambda: jops.sqr(ja),
            "add": lambda: jops.add(ja, jb), "sub": lambda: jops.sub(ja, jb),
            "batch_inv": lambda: jops.batch_inv(ja)}[op]
    c0, c1 = jops.to_int(j_fn())
    assert E2.to_int(spec, t_fn()) == list(zip(c0, c1))


def test_fq2_inverse_of_zero_is_zero_and_roundtrip():
    spec = C.BLS12_381_G2.spec
    pairs = [(0, 0), (5, 0), (0, 7), (3, 9)]
    a = E2.from_ints(spec, pairs, device="cpu")
    assert E2.to_int(spec, a) == pairs
    inv = E2.batch_inv(spec, a)
    assert E2.to_int(spec, inv[0]) == (0, 0)
    assert E2.to_int(spec, E2.mul(spec, a[1:], inv[1:])) == [(1, 0)] * 3


def _case(curve, seed):
    """Host G2 points P (Jacobian with random Z; lane EDGE_INF at infinity)
    and Q (affine; lane EDGE_Q_INF at infinity in ``add``), as (2L, N)
    Montgomery limbs, with the edge lanes P == Q and P == -Q."""
    tg, jg = GROUPS[curve]
    spec = tg.spec
    hg = jH.host_group(jg)
    f = hg.f
    rng = np.random.default_rng(seed)
    gen = tg.generator_host()
    pts = [hg.mul_fast(gen, int(rng.integers(1, 1 << 30))) for _ in range(N)]
    qts = [hg.mul_fast(gen, int(rng.integers(1, 1 << 30))) for _ in range(N)]
    pts[EDGE_DOUBLE] = qts[EDGE_DOUBLE]
    pts[EDGE_NEG] = hg.neg(qts[EDGE_NEG])
    zs = _pairs(spec, rng, N)
    jac = [(f.mul(p[0], f.mul(z, z)), f.mul(p[1], f.mul(z, f.mul(z, z))), z) for p, z in zip(pts, zs)]
    jac[EDGE_INF] = ((0, 0), (1, 0), (0, 0))
    pts[EDGE_INF] = None

    def lf(vals):
        return E2.to_lf(E2.from_ints(spec, vals, device="cpu"))

    P = tuple(lf([j[k] for j in jac]) for k in range(3))
    Q = tuple(lf([q[k] for q in qts]) for k in range(2))
    return tg, jg, hg, pts, qts, P, Q


def _affine(hg, spec, coords):
    L = spec.n_limbs
    vals = []
    for c in coords:
        a = np.asarray(c).astype(np.uint32)
        vals.append(list(zip(ff.limbs_to_ints(spec, a[:L].T), ff.limbs_to_ints(spec, a[L:].T))))
    return [hg._jto_affine(t) for t in zip(*vals)]


@functools.lru_cache(maxsize=None)
def _jax_formula(curve, which, seed):
    """The JAX eager graph ``g2_<which>`` on case ``seed``'s inputs, as
    numpy: each call dispatches thousands of small ops (~6 s)."""
    tg, jg, hg, pts, qts, P, Q = _case(curve, seed)
    args = _formula_args(tg.spec, which, Q)[0]
    out = jec._ec_fn(tg.spec, f"g2_{which}", N, False)(
        *(jnp.asarray(t.numpy().astype(np.uint32)) for t in P + args))
    return [np.asarray(j) for j in out]


def _formula_args(spec, which, Q):
    """The second operand of formula ``which`` (and, for ``add``, which
    lane of Q is at infinity)."""
    if which == "add":
        Qj = list(ec.g2_from_affine(spec, *Q))
        Qj[2] = Qj[2].clone()
        Qj[2][:, EDGE_Q_INF] = 0
        return tuple(Qj), EDGE_Q_INF
    if which == "double":
        return (), None
    if which.endswith("packed"):
        return (ec.pack(*Q),), None
    return Q, None


@pytest.mark.parametrize("curve", list(GROUPS))
@pytest.mark.parametrize("which", FORMULAS)
def test_g2_formula_matches_jax_and_host(curve, which):
    """Limb for limb against the JAX eager graph, and in affine form against
    the host. On BLS12-381 each formula meets its own graph; on BLS12-377
    (which changes only the field) a packed form meets the graph of its
    unpacked twin on the same points, since packing changes only how the
    addend is read."""
    twin = which.replace("_packed", "") if curve == "bls12_377" else which
    seed = FORMULAS.index(which.replace("_packed", ""))
    tg, jg, hg, pts, qts, P, Q = _case(curve, seed)
    spec = tg.spec
    args, q_inf = _formula_args(spec, which, Q)
    if q_inf is not None:
        qts = list(qts)
        qts[q_inf] = None
    t_out = ec.plain(f"g2_{which}", spec, *P, *args)
    j_out = _jax_formula(curve, twin, seed)
    for t, j in zip(t_out, j_out):
        assert np.array_equal(t.numpy().view(np.uint32), j)
    got = _affine(hg, spec, [t.numpy() for t in t_out])
    want = [hg.double(p) for p in pts] if which == "double" else [hg.add(p, q) for p, q in zip(pts, qts)]
    lanes = range(N)
    if which.startswith("madd_distinct"):  # the distinct forms exclude P == +-Q
        lanes = [i for i in lanes if i not in (EDGE_DOUBLE, EDGE_NEG)]
    assert [got[i] for i in lanes] == [want[i] for i in lanes]


def test_g2_neg_and_infinity():
    tg, jg, hg, pts, qts, P, Q = _case("bls12_381", 11)
    spec = tg.spec
    out = ec.g2_add(spec, P, ec.g2_neg(spec, P))
    assert _affine(hg, spec, [t.numpy() for t in out]) == [None] * N
    inf = ec.g2_infinity(spec, N, "cpu")
    assert _affine(hg, spec, [t.numpy() for t in ec.g2_add(spec, inf, P)]) == pts


@pytest.mark.parametrize("curve", list(GROUPS))
@pytest.mark.parametrize("distinct", [True, False])
def test_g2_msm_matches_host(curve, distinct):
    tg, jg = GROUPS[curve]
    hg = jH.host_group(jg)
    rng = np.random.default_rng(7)
    n = 20
    pts = [hg.mul_fast(tg.generator_host(), int(rng.integers(1, 1 << 62))) for _ in range(n)]
    if not distinct:
        pts[1] = pts[2]
    scal = [int.from_bytes(rng.bytes(40), "little") % tg.scalar_spec.modulus for _ in range(n)]
    triples = [(p[0], p[1], False) for p in pts]
    triples[6] = ((0, 0), (1, 0), True)
    out = msm.msm(tg, msm.scalars_from_ints(tg.scalar_spec, scal, device="cpu"),
                  C.affine_from_ints(tg, triples, device="cpu"), assume_distinct=distinct)
    assert out[0].shape == (2, tg.spec.n_limbs)
    got = hg._jto_affine(tuple(E2.to_int(tg.spec, c) for c in out))
    keep = [(s, p) for i, (s, p) in enumerate(zip(scal, pts)) if i != 6]
    assert got == hg.msm_fast(*zip(*keep))


def test_g2_fixed_base_and_affine_match_host():
    tg, jg = GROUPS["bls12_381"]
    hg = jH.host_group(jg)
    rng = np.random.default_rng(8)
    base = hg.mul_fast(tg.generator_host(), 12345)
    scal = [0, 1, 2] + [int.from_bytes(rng.bytes(40), "little") % tg.scalar_spec.modulus for _ in range(3)]
    base_dev = tg.from_affine(E2.from_int(tg.spec, base[0], "cpu"), E2.from_int(tg.spec, base[1], "cpu"))
    out = msm.fixed_base_mul(tg, base_dev, msm.scalars_from_ints(tg.scalar_spec, scal, device="cpu"))
    x, y, inf = tg.to_affine(out)
    got = [None if i else (E2.to_int(tg.spec, a), E2.to_int(tg.spec, b)) for a, b, i in zip(x, y, inf)]
    assert got == [hg.mul_fast(base, s) if s else None for s in scal]
