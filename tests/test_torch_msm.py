"""The PyTorch port's MSM and fixed-base multiplication
(poly_commit_tpu_torch.core.msm / msm_gpu, which run K1, K2a and K3)
against the JAX package's core/msm.py on the CPU (which routes these sizes
to its host big-int engine) and an independent host model.

The port runs its own Pippenger path at every size, with its CPU window
(c = 4, T = 16 lanes); results are compared as affine points. The batched
MSM over shared bases (msm_rows, BN254 G1, Hyrax's row commitments) is held
against per-row MSMs of the JAX package and the host, and its device window
fold (``ec_lf.window_fold``'s plain version here) against the host fold.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from poly_commit_tpu.core import curve as jcurve  # noqa: E402
from poly_commit_tpu.core import hostec as jhostec  # noqa: E402
from poly_commit_tpu.core import msm as jmsm  # noqa: E402
from poly_commit_tpu_torch.core import curve, ff, hostec, msm, msm_gpu  # noqa: E402
from tests import torch_fold_cases as FC  # noqa: E402
from tests.ref_ec import Fp, RefWeierstrass  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

GROUPS = {
    "bls12_381": (curve.BLS12_381_G1, jcurve.BLS12_381_G1),
    "bls12_377": (curve.BLS12_377_G1, jcurve.BLS12_377_G1),
    "bn254": (curve.BN254_G1, jcurve.BN254_G1),
}


def _case(name, n, seed, repeat=False):
    tg, _ = GROUPS[name]
    q, r = tg.spec.modulus, tg.scalar_spec.modulus
    ref = RefWeierstrass(Fp(q), tg.b_int)
    rng = np.random.default_rng(seed)
    pts = [ref.mul((tg.gen_x, tg.gen_y), int(rng.integers(1, 1 << 62))) for _ in range(n)]
    scal = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
    scal[0] = 0
    inf = [False] * n
    inf[min(5, n - 1)] = True
    if repeat:  # repeated bases: only the complete formulas are exact
        pts[1] = pts[2]
        pts[3] = (pts[4][0], (q - pts[4][1]) % q)
    want = None  # the independent model is slow: small cases only
    for s, p, i in zip(scal, pts, inf) if n <= 64 else ():
        if not i:
            want = ref.add(want, ref.mul(p, s))
    triples = [(0, 1, True) if i else (p[0], p[1], False) for p, i in zip(pts, inf)]
    return triples, scal, want


@pytest.mark.parametrize("n", [17, 256])
@pytest.mark.parametrize("distinct", [True, False])
def test_msm_matches_jax(n, distinct):
    tg, jg = GROUPS["bls12_381"]
    triples, scal, want = _case("bls12_381", n, seed=n, repeat=not distinct)
    t_out = msm.msm(tg, msm.scalars_from_ints(tg.scalar_spec, scal, device="cpu"),
                    curve.affine_from_ints(tg, triples, device="cpu"), assume_distinct=distinct)
    j_out = jmsm.msm(jg, jmsm.scalars_from_ints(jg.scalar_spec, scal),
                     jcurve.affine_from_ints(jg, triples), assume_distinct=distinct)
    got = hostec.device_proj_to_host(tg, t_out)
    assert got == jhostec.device_proj_to_host(jg, j_out)
    if n <= 64:
        assert got == want


def test_msm_window_follows_n():
    cuda = torch.device("cuda")
    assert [msm_gpu.params(cuda, n) for n in (2, 255, 256, 4096, (1 << 16) - 1, 1 << 16, 1 << 20)] == [
        (4, 16), (4, 16), (8, 1024), (8, 1024), (8, 1024), (16, 4096), (16, 4096)]
    assert msm_gpu.params(torch.device("cpu"), 1 << 20) == (4, 16)


@pytest.mark.parametrize("distinct", [True, False])
def test_msm_card_window_matches_jax(monkeypatch, distinct):
    """The card's mid-size window (c = 8) run through the plain versions:
    the same sum as the JAX package at a lane count that takes 4 scan steps."""
    monkeypatch.setattr(msm_gpu, "params", lambda device, n: (8, 64))
    tg, jg = GROUPS["bls12_381"]
    triples, scal, _ = _case("bls12_381", 200, seed=9, repeat=not distinct)
    t_out = msm.msm(tg, msm.scalars_from_ints(tg.scalar_spec, scal, device="cpu"),
                    curve.affine_from_ints(tg, triples, device="cpu"), assume_distinct=distinct)
    j_out = jmsm.msm(jg, jmsm.scalars_from_ints(jg.scalar_spec, scal),
                     jcurve.affine_from_ints(jg, triples), assume_distinct=distinct)
    assert hostec.device_proj_to_host(tg, t_out) == jhostec.device_proj_to_host(jg, j_out)


def test_msm_bls12_377_and_empty_sums():
    tg, jg = GROUPS["bls12_377"]
    triples, scal, want = _case("bls12_377", 40, seed=3)
    sc = msm.scalars_from_ints(tg.scalar_spec, scal, device="cpu")
    pts = curve.affine_from_ints(tg, triples, device="cpu")
    got = hostec.device_proj_to_host(tg, msm.msm(tg, sc, pts, assume_distinct=True))
    j_out = jmsm.msm(jg, jmsm.scalars_from_ints(jg.scalar_spec, scal), jcurve.affine_from_ints(jg, triples))
    assert got == jhostec.device_proj_to_host(jg, j_out) == want
    zero = msm.scalars_from_ints(tg.scalar_spec, [0] * 40, device="cpu")
    assert hostec.device_proj_to_host(tg, msm.msm(tg, zero, pts)) is None


@pytest.mark.parametrize("n", [17, 256])
def test_fixed_base_mul_matches_jax(n):
    tg, jg = GROUPS["bls12_381"]
    rng = np.random.default_rng(100 + n)
    r = tg.scalar_spec.modulus
    scal = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
    scal[1] = 0
    scal[2] = 1
    scal[3] = r - 1
    k = int.from_bytes(rng.bytes(32), "little") % r
    t_base = curve.scalar_mul_int(tg, tg.generator("cpu"), k)
    j_base = jcurve.scalar_mul_int(jg, jg.generator(), k)
    t_out = tg.to_affine(msm.fixed_base_mul(tg, t_base, msm.scalars_from_ints(tg.scalar_spec, scal, device="cpu")))
    j_out = jg.to_affine(jmsm.fixed_base_mul(jg, j_base, jmsm.scalars_from_ints(jg.scalar_spec, scal)))
    got = list(zip(ff.limbs_to_ints(tg.spec, t_out[0].numpy()), ff.limbs_to_ints(tg.spec, t_out[1].numpy()),
                   t_out[2].tolist()))
    want = list(zip(ff.limbs_to_ints(tg.spec, np.asarray(j_out[0])),
                    ff.limbs_to_ints(tg.spec, np.asarray(j_out[1])), np.asarray(j_out[2]).tolist()))
    assert got == want
    assert got[1] == (0, 0, True) and not got[2][2]


def test_batch_inversion_and_normalisation():
    tg, _ = GROUPS["bls12_381"]
    spec = tg.spec
    q = spec.modulus
    rng = np.random.default_rng(8)
    vals = [int.from_bytes(rng.bytes(48), "little") % q for _ in range(13)]
    vals[4] = 0
    inv = ff.batch_inv(spec, ff.from_ints(spec, vals, device="cpu"))
    assert ff.to_ints(spec, inv) == [pow(v, -1, q) if v else 0 for v in vals]
    triples, _, _ = _case("bls12_381", 6, seed=2)
    pts = curve.affine_from_ints(tg, triples, device="cpu")
    jac = tuple(ff.from_field_last(c) for c in tg.from_affine(*pts))
    x, y = msm_gpu.jacobian_to_affine(spec, jac)
    got = [(a, b) for a, b in zip(ff.to_ints(spec, x), ff.to_ints(spec, y))]
    assert [g for g, t in zip(got, triples) if not t[2]] == [(t[0], t[1]) for t in triples if not t[2]]



def _rows_case(n, rows, seed, repeat=False):
    """``rows`` rows of scalars over _case's n BN254 points; row 1 all zero."""
    tg, _ = GROUPS["bn254"]
    triples, _, _ = _case("bn254", n, seed, repeat)
    rng = np.random.default_rng(seed + 1)
    r = tg.scalar_spec.modulus
    scal = [[int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)] for _ in range(rows)]
    scal[1] = [0] * n
    return triples, scal


def _rows_vs_jax(n, rows, seed, distinct):
    tg, jg = GROUPS["bn254"]
    triples, scal = _rows_case(n, rows, seed, repeat=not distinct)
    sc = torch.stack([msm.scalars_from_ints(tg.scalar_spec, row, device="cpu") for row in scal])
    out = msm.msm_rows(tg, sc, curve.affine_from_ints(tg, triples, device="cpu"), assume_distinct=distinct)
    got = [hostec.device_proj_to_host(tg, tuple(c[b] for c in out)) for b in range(rows)]
    jpts = jcurve.affine_from_ints(jg, triples)
    want = [jhostec.device_proj_to_host(jg, jmsm.msm(jg, jmsm.scalars_from_ints(jg.scalar_spec, row), jpts,
                                                     assume_distinct=distinct)) for row in scal]
    return got, want


@pytest.mark.parametrize("distinct", [True, False])
def test_msm_rows_matches_per_row_msms(distinct):
    """Three rows of 140 points (padded to 256: T = 2 lanes of 128 steps),
    one point at infinity, row 1 all zero; with repeated bases for the
    complete formulas: each row equals the JAX package's MSM and the
    host's."""
    got, want = _rows_vs_jax(140, 3, seed=21, distinct=distinct)
    assert got == want and got[1] is None
    tg, _ = GROUPS["bn254"]
    triples, scal = _rows_case(140, 3, seed=21, repeat=not distinct)
    hg = hostec.host_group(tg)
    pts = [None if t[2] else (t[0], t[1]) for t in triples]
    assert got[0] == hg.msm_fast(scal[0], pts)


def test_msm_rows_card_window(monkeypatch):
    """The card's window (c = 8) through the plain versions: two rows of
    64 points in 4 lanes of 16 steps, equal to the JAX package's MSMs."""
    monkeypatch.setattr(msm_gpu, "rows_params", lambda device, n: (8, 4))
    got, want = _rows_vs_jax(64, 2, seed=22, distinct=True)
    assert got == want


def test_rows_params_give_lanes_of_many_steps():
    cuda = torch.device("cuda")
    assert msm_gpu.rows_params(cuda, 1 << 11) == (8, 16)  # Hyrax at 22 variables
    assert msm_gpu.rows_params(cuda, 128) == (4, 1)
    assert msm_gpu.rows_params(torch.device("cpu"), 512) == (4, 4)


def test_fold_device_matches_fold_host():
    """The batched device fold of two rows' window sums equals the host
    fold (_fold_host) of each row's own windows."""
    tg, _ = GROUPS["bn254"]
    spec, ops, c, t_lanes = tg.spec, msm_gpu.JACOBIAN_OPS, 4, 2
    triples, scal = _rows_case(16, 2, seed=23)
    scal[1][3] = 5  # a row with one small term
    pts = curve.affine_from_ints(tg, triples, device="cpu")
    x, y = (ff.from_field_last(a) for a in pts[:2])
    sc = torch.stack([msm.scalars_from_ints(tg.scalar_spec, row, device="cpu") for row in scal])
    digs = msm_gpu._window_digits(sc, pts[2], c).view(-1, 16)
    parts = msm_gpu._msm_body(spec, ops, digs, x, y, True, c, t_lanes)
    folded = msm_gpu.fold_device(spec, parts, c, 2)
    w = msm_gpu.SCALAR_BITS // c
    for b in range(2):
        row_parts = tuple(p[:, b * w : (b + 1) * w] for p in parts)
        host = msm_gpu._fold_host(tg, ops, row_parts, c)
        assert ops.to_host(spec, None, tuple(cc[:, b : b + 1] for cc in folded)) == [host]



@pytest.mark.parametrize("name", ["bls12_381", "bls12_377", "bn254"])
def test_window_fold_edge_rows_match_host(name):
    """ec_lf.window_fold (its plain version on the CPU) at c = 3, four
    windows, four rows of fold_logs' edge cases: each row equals the host
    multiple of the generator by the row's log and _fold_host of the row."""
    from poly_commit_tpu_torch.core import ec_lf

    tg, _ = GROUPS[name]
    spec, ops, c, windows, rows = tg.spec, msm_gpu.JACOBIAN_OPS, 3, 4, 4
    logs, want = FC.fold_logs(tg.scalar_spec.modulus, c, windows, rows, seed=24)
    parts = FC.host_fold_parts(tg, logs, seed=25)
    got = FC.fold_to_host(tg, ec_lf.window_fold(spec, parts, c, rows))
    assert got == FC.want_points(tg, want)
    assert got[1] is None and None not in (got[0], got[2], got[3])
    for b in range(rows):
        row_parts = tuple(p[:, b * windows : (b + 1) * windows] for p in parts)
        assert msm_gpu._fold_host(tg, ops, row_parts, c) == got[b]


@pytest.mark.parametrize("cols,rows,c,n_parts", [(12, 5, 4, 6), (256, 2, 4, 6), (12, 2, 4, 6),
                                                 (8, 2, 0, 6), (8, 2, 4, 3)])
def test_window_fold_refuses_bad_shapes(cols, rows, c, n_parts):
    """Columns that do not split into rows, more than 64 windows a row or
    a count that is not a power of two, c < 1, or other than G_last and
    sum G's six coordinates."""
    from poly_commit_tpu_torch.core import ec_lf

    spec = curve.BN254_G1.spec
    parts = tuple(torch.zeros((spec.n_limbs, cols), dtype=torch.int32) for _ in range(n_parts))
    with pytest.raises(ValueError):
        ec_lf.window_fold(spec, parts, c, rows)


def test_cpu_msm_folds_on_host_ints(monkeypatch):
    """A G1 MSM on the CPU keeps the host fold: _fold_host runs, the
    window_fold wrapper is never entered."""
    from poly_commit_tpu_torch.core import ec_lf

    calls = []
    monkeypatch.setattr(ec_lf, "window_fold", lambda *a: calls.append(a))
    host_fold = msm_gpu._fold_host
    monkeypatch.setattr(msm_gpu, "_fold_host", lambda *a: calls.append("host") or host_fold(*a))
    tg, _ = GROUPS["bn254"]
    triples, scal, want = _case("bn254", 9, seed=26)
    out = msm.msm(tg, msm.scalars_from_ints(tg.scalar_spec, scal, device="cpu"),
                  curve.affine_from_ints(tg, triples, device="cpu"))
    assert hostec.device_proj_to_host(tg, out) == want and calls == ["host"]
