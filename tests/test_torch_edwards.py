"""The PyTorch port's JubJub slice against the JAX package on the CPU: the
K2b formulas' plain versions (core/ec_lf.py ``ed_*`` against the JAX eager
graph ``ec_lf._ec_fn(FR_BLS12_381, "ed_*", n, False)`` and the JAX
package's HostEdwards), ``JUBJUB.scalar_mul`` and the one-launch ladder
``ed_smul`` against the host group law and the JAX package's per-bit scan
(``curve.JUBJUB.scalar_mul``), IPA-PC's key fold against the JAX fold, and
the JubJub MSM against the host group law.

Points are host JubJub points in extended coordinates with a random Z, with
the identity, P + P and P + (-P) among the lanes. The formulas are compared
limb for limb with the JAX graph and as affine points with the host;
tolerance 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from poly_commit_tpu.core import ec_lf as jec  # noqa: E402
from poly_commit_tpu.core import hostec as jH  # noqa: E402
from poly_commit_tpu.core import curve as jC  # noqa: E402
from poly_commit_tpu.core import field as jF  # noqa: E402
from poly_commit_tpu_torch.pcs import ipa_pc as tI  # noqa: E402
from poly_commit_tpu_torch.core import curve as C  # noqa: E402
from poly_commit_tpu_torch.core import ec_lf as ec  # noqa: E402
from poly_commit_tpu_torch.core import ff, hostec, msm  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

G = C.JUBJUB
SPEC = G.spec
HG = jH.host_group(jC.JUBJUB)
N = 12
ID_P, ID_Q, DOUBLE, NEG = 0, 1, 2, 3
# a 252-bit IPA round challenge; the JAX scan walks 256 bits (scalar_bits(ch, 256))
CHALLENGE = int(np.random.default_rng(252).integers(1, 1 << 62)) << 190 | 0x1234567
JAX_BITS = 256


def _points(rng, n):
    gen = (G.gen_x, G.gen_y)
    return [HG.mul_fast(gen, int(rng.integers(1, 1 << 62))) for _ in range(n)]


def _extended(pts, rng):
    p = SPEC.modulus
    zs = [int.from_bytes(rng.bytes(40), "little") % (p - 1) + 1 for _ in pts]
    return [(x * z % p, y * z % p, z, x * y % p * z % p) for (x, y), z in zip(pts, zs)]


def _limbs(vals):
    return ff.from_ints(SPEC, vals, device="cpu")


def _affine(coords):
    p = SPEC.modulus
    xs, ys, zs = (ff.to_ints(SPEC, torch.from_numpy(np.asarray(c))) for c in coords[:3])
    return [(x * pow(z, -1, p) % p, y * pow(z, -1, p) % p) for x, y, z in zip(xs, ys, zs)]


def _case(seed):
    rng = np.random.default_rng(seed)
    pts, qts = _points(rng, N), _points(rng, N)
    pts[ID_P] = (0, 1)
    qts[ID_Q] = (0, 1)
    qts[DOUBLE] = pts[DOUBLE]
    qts[NEG] = HG.neg(pts[NEG])
    Pe, Qe = _extended(pts, rng), _extended(qts, rng)
    P = tuple(_limbs([e[k] for e in Pe]) for k in range(4))
    return pts, qts, P, Qe


@pytest.mark.parametrize("which", ["ed_madd", "ed_madd_packed", "ed_add", "ed_double"])
def test_edwards_formula_matches_jax_and_host(which):
    pts, qts, P, Qe = _case(["ed_madd", "ed_madd_packed", "ed_add", "ed_double"].index(which))
    qx, qy = _limbs([q[0] for q in qts]), _limbs([q[1] for q in qts])
    args = {"ed_madd": (qx, qy), "ed_madd_packed": (ec.pack(qx, qy),),
            "ed_add": tuple(_limbs([e[k] for e in Qe]) for k in range(4)), "ed_double": ()}[which]
    t_out = ec.plain(which, SPEC, *P, *args)
    j_out = jec._ec_fn(SPEC, which, N, False)(*(jnp.asarray(t.numpy().astype(np.uint32)) for t in P + args))
    for t, j in zip(t_out, j_out):
        assert np.array_equal(t.numpy().view(np.uint32), np.asarray(j))
    want = [HG.add(p, p) for p in pts] if which == "ed_double" else [HG.add(p, q) for p, q in zip(pts, qts)]
    assert _affine([t.numpy() for t in t_out]) == want
    assert which == "ed_double" or want[NEG] == (0, 1)


def test_edwards_wrappers_identity_and_neg():
    pts, _, P, _ = _case(9)
    ident = ec.ed_infinity(SPEC, N, "cpu")
    assert _affine([t.numpy() for t in ec.ed_add(SPEC, ident, P)]) == pts
    assert _affine([t.numpy() for t in ec.ed_add(SPEC, P, ec.ed_neg(SPEC, P))]) == [(0, 1)] * N
    x, y = _limbs([p[0] for p in pts]), _limbs([p[1] for p in pts])
    inf = torch.zeros(N, dtype=torch.bool)
    inf[4] = True
    aff = ec.ed_from_affine(SPEC, x, y, inf)
    assert _affine([t.numpy() for t in aff]) == [(0, 1) if i == 4 else p for i, p in enumerate(pts)]


def _canonical_limbs_last(coords):
    return [ff.canonicalize(SPEC, t).numpy().T.astype(np.uint32) for t in coords]


@pytest.mark.parametrize("k", [0, 1, 2, 8, 12345678901234567890123, G.scalar_spec.modulus - 1,
                               CHALLENGE])
def test_scalar_mul_matches_host(k):
    """scalar_mul (one ed_smul) against the host in affine form; ed_smul's
    plain ladder walked over 256 bits limb for limb (canonical) against the
    JAX package's per-bit scan over scalar_bits(k, 256), one JAX graph for
    every k, and ed_smul over k's own bits against the host."""
    rng = np.random.default_rng(5)
    pts = _points(rng, 4)
    pts[2] = (0, 1)
    x = F.from_ints(SPEC, [p[0] for p in pts], device="cpu")
    y = F.from_ints(SPEC, [p[1] for p in pts], device="cpu")
    out = G.scalar_mul(G.from_affine(x, y), k)
    ax, ay, inf = G.to_affine(out)
    got = list(zip(F.to_ints(SPEC, ax), F.to_ints(SPEC, ay)))
    assert got == [HG.mul(p, k) for p in pts]
    assert inf.tolist() == [g == (0, 1) for g in got]

    base = ec.ed_from_affine(SPEC, ff.from_field_last(x), ff.from_field_last(y))
    jp = jC.JUBJUB.from_affine(jF.from_ints(SPEC, [p[0] for p in pts]),
                               jF.from_ints(SPEC, [p[1] for p in pts]))
    want = jC.JUBJUB.scalar_mul(jp, jC.scalar_bits(k, JAX_BITS))
    wide = ec._ed_smul_plain(SPEC, base, k, JAX_BITS)
    for t, j in zip(_canonical_limbs_last(wide), want):
        assert np.array_equal(t, np.asarray(j))
    assert _affine([t.numpy() for t in ec.ed_smul(SPEC, base, k)]) == [HG.mul(p, k) for p in pts]


@pytest.mark.parametrize("k", [-1, 1 << 256, -(1 << 255), 1 << 300])
def test_ed_smul_rejects_bad_scalars(k):
    """k outside [0, 2^256), the kernel's 8 words, is refused by the
    wrapper and its plain version alike."""
    base = ec.ed_infinity(SPEC, 3, "cpu")
    with pytest.raises(ValueError):
        ec.ed_smul(SPEC, base, k)
    with pytest.raises(ValueError):
        ec.ed_smul_plain(SPEC, base, k)


def test_fold_key_matches_jax_fold():
    """One IPA-PC key fold key_l + ch key_r at 2^4 points (halves of 8, an
    identity among key_r) equals the JAX package's fold limb for limb:
    from_affine, scalar_mul over scalar_bits(ch, 256), add, to_affine."""
    rng = np.random.default_rng(16)
    left = [(x, y, False) for x, y in _points(rng, 8)]
    right = [(x, y, False) for x, y in _points(rng, 8)]
    right[3] = (0, 1, True)
    k_l, k_r = (C.affine_from_ints(G, half, device="cpu") for half in (left, right))
    got = tI.fold_key(k_l, k_r, CHALLENGE)
    J = jC.JUBJUB
    jl, jr = (jC.affine_from_ints(J, half) for half in (left, right))
    want = J.to_affine(J.add(J.from_affine(*jl), J.scalar_mul(J.from_affine(*jr),
                                                              jC.scalar_bits(CHALLENGE, JAX_BITS))))
    for t, j in zip(got[:2], want[:2]):
        assert np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))
    assert got[2].tolist() == np.asarray(want[2]).tolist()


@pytest.mark.parametrize("n", [9, 40])
def test_jubjub_msm_matches_host(n):
    rng = np.random.default_rng(n)
    pts = _points(rng, n)
    pts[1] = pts[2]  # a repeated base: the unified addition is complete
    scal = [int.from_bytes(rng.bytes(40), "little") % G.scalar_spec.modulus for _ in range(n)]
    scal[0] = 0
    triples = [(x, y, False) for x, y in pts]
    triples[3] = (0, 1, True)
    out = msm.msm(G, msm.scalars_from_ints(G.scalar_spec, scal, device="cpu"),
                  C.affine_from_ints(G, triples, device="cpu"), assume_distinct=True)
    keep = [(s, p) for i, (s, p) in enumerate(zip(scal, pts)) if i != 3]
    assert hostec.device_proj_to_host(G, out) == HG.msm_fast(*zip(*keep))
    mont = msm.msm_mont(G, F.from_ints(G.scalar_spec, scal, device="cpu"),
                        C.affine_from_ints(G, triples, device="cpu"))
    assert hostec.device_proj_to_host(G, mont) == HG.msm_fast(*zip(*keep))
