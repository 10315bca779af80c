"""The PyTorch port's streaming KZG (poly_commit_tpu_torch.pcs.streaming_kzg)
and the rest of its polynomial layer against the JAX package on the CPU.

Inputs come from one HostRng seed per test; comparisons are exact
(canonical ints, affine points). Polynomial layer: ``mul`` (NTT product),
``long_divide`` (the port's Newton division against JAX's elimination
scan: monic and non-monic divisors, one coefficient, as many as the
numerator), ``vanishing_poly`` and ``lagrange_interpolate``. The scheme,
at tests/test_streaming_kzg.py's sizes (12 and 16 coefficients, chunks 4,
5, 6, 8 and 16), on a JAX key carried by ``convert.streaming_key_from_jax``:
the time prover's and the space prover's group elements, the remainders,
the folds and both verifiers' verdicts; and the port's own key against
JAX's. The port runs its kernels' plain versions.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.poly as jP  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
import poly_commit_tpu.pcs.streaming_kzg as jSK  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.poly as tP  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.streaming_kzg as tSK  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SPEC = tSK.SPEC
P = SPEC.modulus


def _pt(t):
    """A host triple as an affine point, None at infinity."""
    return None if t[2] else (int(t[0]), int(t[1]))


def _both(ints):
    """The same coefficients as a JAX array and a port tensor on the CPU."""
    return jF.from_ints(SPEC, ints), tF.from_ints(SPEC, ints, device="cpu")


def _ints(a):
    return tF.to_ints(SPEC, a) if isinstance(a, torch.Tensor) else jF.to_ints(SPEC, a)


# -- the polynomial layer ------------------------------------------------


@pytest.mark.parametrize("da,db", [(1, 1), (7, 10), (12, 4)])
def test_mul_matches_jax(da, db):
    rng = tDS.HostRng(da * 31 + db)
    (ja, ta), (jb, tb) = _both(rng.field_ints(SPEC, da)), _both(rng.field_ints(SPEC, db))
    assert _ints(tP.mul(SPEC, ta, tb)) == _ints(jP.mul(SPEC, ja, jb))


@pytest.mark.parametrize("dn,dd,monic", [(12, 4, True), (12, 4, False), (9, 1, False), (5, 5, False),
                                         (16, 3, True)])
def test_long_divide_matches_jax(dn, dd, monic):
    """The Newton division's quotient and remainder equal JAX's scan's."""
    rng = tDS.HostRng(dn * 7 + dd)
    den = rng.field_ints(SPEC, dd)
    if monic:
        den[-1] = 1
    (jn, tn), (jd, td) = _both(rng.field_ints(SPEC, dn)), _both(den)
    jq, jr = jP.long_divide(SPEC, jn, jd)
    tq, tr = tP.long_divide(SPEC, tn, td)
    assert _ints(tq) == _ints(jq)
    assert tr.shape[0] == dd - 1 and (dd == 1 or _ints(tr) == _ints(jr))


def test_long_divide_rejects_a_longer_divisor():
    with pytest.raises(ValueError):
        tP.long_divide(SPEC, tF.from_ints(SPEC, [1, 2], device="cpu"),
                       tF.from_ints(SPEC, [1, 2, 3], device="cpu"))


@pytest.mark.parametrize("m", [1, 3])
def test_vanishing_and_lagrange_match_jax(m):
    rng = tDS.HostRng(40 + m)
    (jx, tx), (jy, ty) = _both(rng.field_ints(SPEC, m)), _both(rng.field_ints(SPEC, m))
    assert _ints(tP.vanishing_poly(SPEC, tx)) == _ints(jP.vanishing_poly(SPEC, jx))
    assert _ints(tP.lagrange_interpolate(SPEC, tx, ty)) == _ints(jP.lagrange_interpolate(SPEC, jx, jy))


# -- the scheme ------------------------------------------------------------


KEY = (15, 3, 31)  # max degree, max evaluation points, seed: one key for every test


@functools.lru_cache(maxsize=None)
def _keys(max_degree, points, seed):
    """JAX's committer key and the port's copy of it (convert)."""
    jck = jSK.CommitterKey.new(max_degree, points, jDS.HostRng(seed))
    return jck, convert.streaming_key_from_jax(jck, device="cpu")


def test_key_matches_jax():
    """CommitterKey.new on the port (tau's powers by doubling, fixed-base
    G1 and G2) gives JAX's key."""
    jck, ck = _keys(*KEY)
    own = tSK.CommitterKey.new(*KEY[:2], tDS.HostRng(KEY[2]), device="cpu")
    assert own.powers_of_g2 == ck.powers_of_g2
    assert all(torch.equal(a, b) for a, b in zip(own.powers_of_g, ck.powers_of_g))


@pytest.fixture(scope="module")
def poly12():
    """A 12-coefficient polynomial, its time-prover commitment and openings
    from both packages."""
    jck, ck = _keys(*KEY)
    rng = tDS.HostRng(32)
    jf, tf = _both(rng.field_ints(SPEC, 12))
    z = rng.field_int(SPEC)
    pts = [rng.field_int(SPEC) for _ in range(3)]
    zpoly = jP.vanishing_poly(SPEC, jF.from_ints(SPEC, pts))
    return dict(jck=jck, ck=ck, jf=jf, tf=tf, z=z, pts=pts, comm=ck.commit(tf), jcomm=jck.commit(jf),
                open=ck.open(tf, z), jopen=jck.open(jf, z), jmulti=jck.open_multi_points(jf, pts),
                jrem=jP.long_divide(SPEC, jf, zpoly)[1])


def test_commit_and_open_match_jax(poly12):
    d = poly12
    assert _pt(d["comm"].point) == _pt(d["jcomm"].point)
    (ev, pf), (jev, jpf) = d["open"], d["jopen"]
    assert ev == jev and _pt(pf.point) == _pt(jpf.point)
    assert _pt(d["ck"].open_multi_points(d["tf"], d["pts"]).point) == _pt(d["jmulti"].point)


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_space_commit_and_open_match_time(poly12, chunk):
    """commit_chunked and open_chunked give the time prover's group
    elements and value (space.rs:65-95, tests.rs:40-83)."""
    d = poly12
    assert _pt(d["ck"].commit_chunked(d["tf"], chunk).point) == _pt(d["comm"].point)
    ev, pf = d["ck"].open_chunked(d["tf"], d["z"], chunk)
    assert ev == d["open"][0] and _pt(pf.point) == _pt(d["open"][1].point)


@pytest.mark.parametrize("chunk", [4, 6, 16])
def test_space_multi_point_open_matches_time_and_jax(poly12, chunk):
    """The m-stage Ruffini stream: the proof equals the time prover's
    (JAX's open_multi_points), the remainder f mod Z by JAX's long_divide;
    at chunk 6 both also equal JAX's chunked open."""
    d = poly12
    rem, pf = d["ck"].open_multi_points_chunked(d["tf"], d["pts"], chunk)
    assert _pt(pf.point) == _pt(d["jmulti"].point)
    assert _ints(rem) == _ints(d["jrem"])
    if chunk == 6:
        jrem, jpf = d["jck"].open_multi_points_chunked(d["jf"], d["pts"], chunk)
        assert _pt(jpf.point) == _pt(pf.point) and _ints(jrem) == _ints(rem)


def test_verify_matches_jax(poly12):
    """Both verifiers accept the opening and reject its value plus one."""
    d = poly12
    ev, pf = d["open"]
    vk, jvk = d["ck"].verifier_key(), d["jck"].verifier_key()
    for bump in (0, 1):
        want = bool(jSK.verify(jvk, d["jcomm"], d["z"], (ev + bump) % P, d["jopen"][1]))
        assert tSK.verify(vk, d["comm"], d["z"], (ev + bump) % P, pf) is want is (bump == 0)


def test_batch_multi_point_open_and_verify_match_jax():
    jck, ck = _keys(*KEY)
    rng = tDS.HostRng(33)
    (jf1, tf1), (jf2, tf2) = _both(rng.field_ints(SPEC, 12)), _both(rng.field_ints(SPEC, 10))
    pts = [rng.field_int(SPEC) for _ in range(3)]
    chal = rng.field_int(SPEC)
    pf = ck.batch_open_multi_points([tf1, tf2], pts, chal)
    jpf = jck.batch_open_multi_points([jf1, jf2], pts, chal)
    assert _pt(pf.point) == _pt(jpf.point)
    evals = [[tF.to_ints(SPEC, tP.evaluate(SPEC, f, tF.from_ints(SPEC, z, device="cpu")))
              for z in pts] for f in (tf1, tf2)]
    comms, jcomms = [ck.commit(tf1), ck.commit(tf2)], [jck.commit(jf1), jck.commit(jf2)]
    vk, jvk = ck.verifier_key(), jck.verifier_key()
    bad = [[(evals[0][0] + 1) % P] + evals[0][1:], evals[1]]
    assert jSK.verify_multi_points(jvk, jcomms, pts, evals, jpf, chal)
    assert tSK.verify_multi_points(vk, comms, pts, evals, pf, chal) is True
    assert tSK.verify_multi_points(vk, comms, pts, bad, pf, chal) is False


@pytest.fixture(scope="module")
def poly16():
    """A 16-coefficient polynomial, four folding challenges, two points and
    etas; JAX's folding open at depth 2 (chunk 8), and the time prover's
    f^(j) mod Z and commit(sum_j eta_j (f^(j) div Z)) by long_divide."""
    jck, ck = _keys(*KEY)
    rng = tDS.HostRng(37)
    jf, tf = _both(rng.field_ints(SPEC, 16))
    rhos = [rng.field_int(SPEC) for _ in range(4)]
    pts, etas = [rng.field_int(SPEC) for _ in range(2)], [rng.field_int(SPEC) for _ in range(2)]
    zpoly = tP.vanishing_poly(SPEC, tF.from_ints(SPEC, pts, device="cpu"))
    comb, rems = None, []
    for fj, eta in zip(ck.fold_polynomials(tf, rhos[:2]), etas):
        q, r = tP.long_divide(SPEC, fj, zpoly)
        rems.append(_ints(r))
        scaled = tP.scale(SPEC, q, tF.from_ints(SPEC, eta, device="cpu"))
        comb = scaled if comb is None else tP.add(SPEC, comb, scaled)
    return dict(jck=jck, ck=ck, jf=jf, tf=tf, rhos=rhos, pts=pts, etas=etas,
                jfold=jck.open_folding_chunked(jf, rhos[:2], pts, etas, 8),
                time_rems=rems, time_point=_pt(ck.commit(comb).point))


@pytest.mark.parametrize("chunk", [8, 16])
def test_space_open_folding_matches_jax_and_time(poly16, chunk):
    """open_folding_chunked at depth 2: the remainders equal JAX's and
    f^(j) mod Z, the proof JAX's and commit(sum_j eta_j (f^(j) div Z)); at
    chunk 16 both levels' pieces meet key rows 0..3, so the one MSM adds
    their scalars first."""
    d = poly16
    rems, pf = d["ck"].open_folding_chunked(d["tf"], d["rhos"][:2], d["pts"], d["etas"], chunk)
    jrems, jpf = d["jfold"]
    assert [_ints(r) for r in rems] == [_ints(r) for r in jrems] == d["time_rems"]
    assert _pt(pf.point) == _pt(jpf.point) == d["time_point"]


def test_folded_tree_matches_jax(poly16):
    """fold_polynomials and commit_folding over four levels (8, 4, 2, 1)."""
    d = poly16
    folds = d["ck"].fold_polynomials(d["tf"], d["rhos"])
    jfolds = d["jck"].fold_polynomials(d["jf"], d["rhos"])
    assert [_ints(f) for f in folds] == [_ints(f) for f in jfolds]
    got = [_pt(c.point) for c in d["ck"].commit_folding(d["tf"], d["rhos"])]
    assert got == [_pt(c.point) for c in d["jck"].commit_folding(d["jf"], d["rhos"])]


def test_chunked_opens_reject_what_they_cannot_take(poly16):
    d = poly16
    with pytest.raises(ValueError):  # chunk not a multiple of 2^depth
        d["ck"].open_folding_chunked(d["tf"], d["rhos"][:2], d["pts"], d["etas"], 6)
    with pytest.raises(ValueError):  # Z longer than the polynomial
        d["ck"].open_multi_points_chunked(d["tf"][:2], d["pts"], 4)
    with pytest.raises(ValueError):  # more coefficients than key rows
        d["ck"].commit(torch.cat([d["tf"], d["tf"][:1]], 0))
