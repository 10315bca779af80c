"""The PyTorch port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import hashlib
import io
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from poly_commit_tpu_torch.core import curve, ec_lf, ff, hostec, msm, ntt_lf, sort_gpu  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from poly_commit_tpu_torch.core import ntt as NTT  # noqa: E402
from tests import torch_mesh_cases as mesh_cases  # noqa: E402

FORMULAS = ["madd", "madd_distinct", "madd_packed", "madd_distinct_packed", "add", "double"]
SENTINEL = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _field(spec, n, seed):
    """Random values in [0, 2p) as (L, n) int32 limbs on the CPU."""
    rnd = random.Random(seed)
    ints = [rnd.randrange(2 * spec.modulus) for _ in range(n)]
    data = b"".join(v.to_bytes(2 * spec.n_limbs, "little") for v in ints)
    limbs = np.frombuffer(data, "<u2").reshape(n, spec.n_limbs).T.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(limbs))


def _points(group, n, seed):
    rnd = random.Random(seed)
    hg = hostec.host_group(group)
    return [hg.mul_fast((group.gen_x, group.gen_y), rnd.randrange(1, 1 << 64)) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FQ_BLS12_381, FP.FQ_BLS12_377, FP.FR_BLS12_381, FP.FQ_BN254],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_ff_kernel_matches_plain(cuda, spec, op):
    a, b = _field(spec, 4099, 1).to(cuda), _field(spec, 4099, 2).to(cuda)
    fn = {"mul": ff.mont_mul, "add": ff.add, "sub": ff.sub}[op]
    got = fn(spec, a, b)
    torch.cuda.synchronize()
    assert ff.to_ints(spec, got) == ff.to_ints(spec, ff.plain(op, spec, a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("group", [curve.BLS12_381_G1, curve.BLS12_377_G1], ids=lambda g: g.name)
@pytest.mark.parametrize("which", FORMULAS)
def test_ec_kernel_matches_plain(cuda, which, group):
    spec = group.spec
    n = 300
    pts, qts = _points(group, n, 3), _points(group, n, 4)
    qts[1] = pts[1]
    qts[2] = (pts[2][0], (spec.modulus - pts[2][1]) % spec.modulus)
    x1, y1 = (ff.from_ints(spec, [p[k] for p in pts], device=cuda) for k in (0, 1))
    x2, y2 = (ff.from_ints(spec, [p[k] for p in qts], device=cuda) for k in (0, 1))
    inf = torch.zeros(n, dtype=torch.bool, device=cuda)
    inf[0] = True
    P = ec_lf.from_affine(spec, x1, y1, inf)
    args = {"double": (), "add": (ec_lf.from_affine(spec, x2, y2),),
            "madd_packed": (ec_lf.pack(x2, y2),), "madd_distinct_packed": (ec_lf.pack(x2, y2),)}
    a = args.get(which, (x2, y2))
    got = getattr(ec_lf, which)(spec, P, *a)
    torch.cuda.synchronize()
    flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
    want = ec_lf.plain(which, spec, *P, *flat)
    lanes = [i for i in range(n) if not which.startswith("madd_distinct") or i not in (1, 2)]
    for g, w in zip(got, want):
        assert torch.equal(ff.canonicalize(spec, g)[:, lanes], ff.canonicalize(spec, w)[:, lanes])


def _to(x, dev):
    """A tensor, or nested tuples of them, on ``dev``."""
    return tuple(_to(t, dev) for t in x) if isinstance(x, (tuple, list)) else x.to(dev)


def _g2_edge_case(spec, n, seed):
    """Random lazy Fq2 coordinates (2L, n) for P (Jacobian) and Q, with edge
    lanes: 0 P at infinity, 1 P == Q, 2 P == -Q (both with z = 1), 3 Q at
    infinity (for add)."""
    L = spec.n_limbs

    def fq2(s):
        return torch.cat([_field(spec, n, s), _field(spec, n, s + 1000)], 0)

    x1, y1, z1, x2, y2 = (fq2(seed + 10 * k) for k in range(5))
    z2 = fq2(seed + 50)
    one = ec_lf.fq2_one(spec, 1, "cpu")[:, 0]
    z1[:, 0] = 0
    z2[:, 3] = 0
    for lane in (1, 2):
        z1[:, lane], z2[:, lane] = one, one
        x2[:, lane] = x1[:, lane]
    y2[:, 1] = y1[:, 1]
    zero = torch.zeros_like(y1[:L, 2:3])
    y2[:, 2:3] = torch.cat([ff.plain("sub", spec, zero, y1[:L, 2:3].contiguous()),
                            ff.plain("sub", spec, zero, y1[L:, 2:3].contiguous())], 0)
    return (x1, y1, z1), (x2, y2, z2)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FQ_BLS12_381, FP.FQ_BLS12_377, FP.FQ_BN254], ids=lambda s: s.name)
@pytest.mark.parametrize("which", FORMULAS)
def test_g2_kernel_matches_plain(cuda, which, spec):
    """K2c against its plain version, bit for bit, edge lanes included."""
    P, Q = _g2_edge_case(spec, 1000, 7)
    args = {"double": (), "add": (Q,), "madd_packed": (ec_lf.pack(Q[0], Q[1]),),
            "madd_distinct_packed": (ec_lf.pack(Q[0], Q[1]),)}
    a = args.get(which, Q[:2])
    flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
    got = getattr(ec_lf, f"g2_{which}")(spec, _to(P, cuda), *_to(a, cuda))
    torch.cuda.synchronize()
    want = ec_lf.plain(f"g2_{which}", spec, *P, *flat)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["ed_madd", "ed_madd_packed", "ed_add", "ed_double"])
def test_edwards_kernel_matches_plain(cuda, which):
    """K2b against its plain version, bit for bit; lane 0 of P and lane 1
    of Q are the identity, lane 2 adds P to -P."""
    spec = FP.JUBJUB_FQ
    n = 1000
    P = [_field(spec, n, 20 + k) for k in range(4)]
    Q = [_field(spec, n, 30 + k) for k in range(4)]
    ident = ec_lf.ed_infinity(spec, 1, "cpu")
    for k in range(4):
        P[k][:, 0] = ident[k][:, 0]
        Q[k][:, 1] = ident[k][:, 0]
    neg = ec_lf.ed_neg(spec, tuple(t[:, 2:3].contiguous() for t in P))
    for k in range(4):
        Q[k][:, 2] = neg[k][:, 0]
    args = {"ed_madd": Q[:2], "ed_madd_packed": [ec_lf.pack(Q[0], Q[1])], "ed_add": [tuple(Q)],
            "ed_double": []}[which]
    got = getattr(ec_lf, which)(spec, _to(tuple(P), cuda), *_to(tuple(args), cuda))
    torch.cuda.synchronize()
    args = [t for x in args for t in (x if isinstance(x, tuple) else (x,))]
    want = ec_lf.plain(which, spec, *P, *args)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _head(coords, n):
    return tuple(t[:, :n].contiguous() for t in coords)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 77])  # a pair of lanes a point: 64 points a block
@pytest.mark.parametrize("which", FORMULAS)
def test_g2_kernel_tail_matches_plain(cuda, which, n):
    """K2c at an odd n that does not fill its last block: the lanes past
    the last point stay in the pair exchanges and store nothing."""
    spec = FP.FQ_BLS12_381
    P, Q = (_head(t, n) for t in _g2_edge_case(spec, max(n, 4), 17))
    args = {"double": (), "add": (Q,), "madd_packed": (ec_lf.pack(Q[0], Q[1]),),
            "madd_distinct_packed": (ec_lf.pack(Q[0], Q[1]),)}
    a = args.get(which, Q[:2])
    flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
    got = getattr(ec_lf, f"g2_{which}")(spec, _to(P, cuda), *_to(a, cuda))
    torch.cuda.synchronize()
    want = ec_lf.plain(f"g2_{which}", spec, *P, *flat)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _ed_points(n, seed):
    """Random lazy JubJub coordinates (4 of (16, n)) with lane 0 the
    identity and lane 2 the negation of lane 1 (where n allows)."""
    spec = FP.JUBJUB_FQ
    P = [_field(spec, n, seed + k) for k in range(4)]
    ident = ec_lf.ed_infinity(spec, 1, "cpu")
    for k in range(4):
        P[k][:, 0] = ident[k][:, 0]
    if n > 2:
        neg = ec_lf.ed_neg(spec, tuple(t[:, 1:2].contiguous() for t in P))
        for k in range(4):
            P[k][:, 2] = neg[k][:, 0]
    return tuple(P)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 45])  # four lanes a point: 32 points a block
@pytest.mark.parametrize("which", ["ed_madd", "ed_madd_packed", "ed_add", "ed_double"])
def test_edwards_kernel_tail_matches_plain(cuda, which, n):
    """K2b at an odd n that does not fill its last block."""
    spec = FP.JUBJUB_FQ
    P, Q = _ed_points(n, 40), _ed_points(n, 50)
    args = {"ed_madd": Q[:2], "ed_madd_packed": (ec_lf.pack(Q[0], Q[1]),), "ed_add": (Q,),
            "ed_double": ()}[which]
    got = getattr(ec_lf, which)(spec, _to(P, cuda), *_to(args, cuda))
    torch.cuda.synchronize()
    flat = [t for x in args for t in (x if isinstance(x, tuple) else (x,))]
    want = ec_lf.plain(which, spec, *P, *flat)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 45, 1001])
@pytest.mark.parametrize("k", [0, 1, (1 << 251) + 1, 0xDEADBEEF << 220 | 12345, (1 << 256) - 1],
                         ids=["k0", "k1", "k2^251+1", "k252bit", "k256ones"])
def test_ed_smul_kernel_matches_plain(cuda, k, n):
    """The one-launch ladder equals its plain version bit for bit, edge
    lanes (the identity, P and -P) included, and equals the chain of
    ed_double / ed_add launches it replaces."""
    spec = FP.JUBJUB_FQ
    P = _ed_points(n, 60)
    got = ec_lf.ed_smul(spec, _to(P, cuda), k)
    torch.cuda.synchronize()
    want = ec_lf.ed_smul_plain(spec, P, k)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if n == 45:
        acc = ec_lf.ed_infinity(spec, n, cuda)
        for bit in bin(k)[2:] if k else "":
            acc = ec_lf.ed_double(spec, acc)
            if bit == "1":
                acc = ec_lf.ed_add(spec, acc, _to(P, cuda))
        for g, w in zip(got, acc):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FQ_BLS12_381, FP.FQ_BLS12_377, FP.FR_BLS12_381, FP.FQ_BN254],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 4099])
def test_mont_pow_kernel_matches_plain(cuda, spec, m):
    """The power kernel equals its plain version limb for limb (the same
    products, so the same lazy limbs), for the Fermat exponent and others."""
    a = _field(spec, m, 8).to(cuda)
    a[:, 0] = 0  # a zero column
    for e in (spec.modulus - 2, 0, 1, 5, (1 << 383) + 12345):
        got = ff.mont_pow(spec, a, e)
        torch.cuda.synchronize()
        assert torch.equal(got, ff.plain_pow(spec, a, e)), e


@pytest.mark.gpu
def test_batch_inv_inverts_the_root_in_one_launch(cuda):
    spec = FP.FQ_BLS12_381
    rnd = random.Random(9)
    vals = [0] + [rnd.randrange(spec.modulus) for _ in range(999)]
    a = ff.from_ints(spec, vals, device=cuda)
    pows, muls, trees = ff.mont_pow.launches, ff.mont_mul.launches, ff.batch_inv.launches
    inv = ff.batch_inv(spec, a)
    torch.cuda.synchronize()
    assert ff.mont_pow.launches - pows == 1
    assert ff.mont_mul.launches - muls == 0
    assert ff.batch_inv.launches - trees == 2  # 1000 columns: one block's tree, up and down
    assert ff.to_ints(spec, inv) == [pow(v, -1, spec.modulus) if v else 0 for v in vals]


INV_SPECS = [FP.FQ_BLS12_381, FP.FR_BLS12_381, FP.FR_BN254, FP.FR_JUBJUB]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", INV_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 2, 3, 1000, 1024, 1025, 5000])
def test_batch_inv_kernel_matches_plain(cuda, spec, m):
    """The inversion tree against its plain version on canonical values,
    lazy values (< 2p) and both encodings of zero; one and two levels of
    blocks (2^10 columns a block)."""
    a = _field(spec, m, 20 + m)
    if m > 2:
        a[:, 1] = 0
        a[:, 2] = ff.consts(spec, "cpu", 0)[:, 0].to(torch.int32)  # p: zero, not reduced
    for x in (ff.canonicalize(spec, a), a):
        got = ff.batch_inv(spec, x.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(ff.canonicalize(spec, got.cpu()),
                           ff.canonicalize(spec, ff.batch_inv_plain(spec, x)))


@pytest.mark.gpu
def test_batch_inv_kernel_three_levels_and_all_zero(cuda):
    """2^20 + 1 columns take three levels of blocks; a batch of zeros
    inverts to zeros."""
    spec = FP.FR_BLS12_381
    m = (1 << 20) + 1
    a = _field(spec, m, 21).to(cuda)
    before = ff.batch_inv.launches
    inv = ff.batch_inv(spec, a)
    torch.cuda.synchronize()
    assert ff.batch_inv.launches - before == 6
    one = ff.canonicalize(spec, ff.mont_mul(spec, a, inv))
    nonzero = ~ff.is_zero(spec, a)
    assert bool((one[:, nonzero] == ff.one_mont(spec, 1, cuda)).all())
    zeros = ff.zeros(spec, 77, cuda)
    assert not bool(ff.canonicalize(spec, ff.batch_inv(spec, zeros)).any())


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FR_JUBJUB, FP.FQ_BLS12_381], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [1, 2, 3, 255, 1023, 1024, 1025, 4099, 1 << 16])
def test_fsum_kernel_matches_plain(cuda, spec, n):
    """The field sum of 1 to 2^16 lazy columns against the halving loop:
    one launch up to 2^10 columns, two past it."""
    a = _field(spec, n, 30 + n)
    before = ff.fsum.launches
    got = ff.fsum(spec, a.to(cuda))
    torch.cuda.synchronize()
    assert ff.fsum.launches - before == (1 if n <= ff.SUM_BLOCK_COLUMNS else 2)
    assert got.shape == (spec.n_limbs, 1)
    assert torch.equal(ff.canonicalize(spec, got.cpu()), ff.canonicalize(spec, ff.fsum_plain(spec, a)))


def _sort_keys(w, n, sentinel, cuda):
    """Random keys with ~10% sentinels; window 1 all sentinel, window 2 a
    few repeated keys."""
    keys = torch.randint(0, sentinel, (w, n), dtype=torch.int32, device=cuda)
    share = torch.rand((w, n), device=cuda) < 0.1
    keys = torch.where(share, torch.full_like(keys, sentinel), keys)
    keys[1] = sentinel
    keys[2] = torch.randint(0, 3, (n,), dtype=torch.int32, device=cuda)
    return keys.contiguous()


@pytest.mark.gpu
def test_digit_sort_kernel_matches_plain(cuda):
    keys = torch.randint(0, SENTINEL + 1, (16, 1 << 16), dtype=torch.int32, device=cuda)
    keys[3, :40000] = SENTINEL
    order, sk, incl = sort_gpu.digit_sort(keys, SENTINEL)
    torch.cuda.synchronize()
    p_order, p_sk, p_incl = sort_gpu.plain(keys, SENTINEL)
    assert torch.equal(sk, p_sk) and torch.equal(incl, p_incl)
    assert torch.equal(order, p_order)  # stable: index for index
    assert torch.equal(torch.gather(keys, 1, order.long()), sk)


@pytest.mark.gpu
@pytest.mark.parametrize("w,n,c", [(16, 1 << 16, 16), (32, 3000, 8), (64, 200, 4)])
def test_digit_sort_matches_stable_plain(cuda, w, n, c):
    """The MSM's three shapes: order, sorted keys and tails equal the
    stable plain version exactly, an all-sentinel window included."""
    sentinel = 1 << c
    keys = _sort_keys(w, n, sentinel, cuda)
    got = sort_gpu.digit_sort(keys, sentinel)
    torch.cuda.synchronize()
    want = sort_gpu.plain(keys, sentinel)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    assert torch.equal(got[0].long(), torch.sort(keys, dim=1, stable=True).indices)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [SENTINEL + 1, -1, 1 << 20])
def test_digit_sort_rejects_out_of_range_keys_on_card(cuda, bad):
    keys = torch.zeros((3, 5000), dtype=torch.int32, device=cuda)
    keys[2, 4321] = bad
    with pytest.raises(ValueError):
        sort_gpu.digit_sort(keys, SENTINEL)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3000])  # windows c = 4 and c = 8
@pytest.mark.parametrize("distinct", [True, False])
def test_msm_on_card_matches_host(cuda, distinct, n):
    group = curve.BLS12_381_G1
    pts = _points(group, n, 5)
    rnd = random.Random(6)
    scal = [rnd.randrange(group.scalar_spec.modulus) for _ in range(n)]
    if not distinct:  # a repeated base: the complete mixed add meets P == Q
        pts[-1] = pts[0]
    out = msm.msm(group, msm.scalars_from_ints(group.scalar_spec, scal, cuda),
                  curve.affine_from_ints(group, [(x, y, False) for x, y in pts], cuda),
                  assume_distinct=distinct)
    assert hostec.device_proj_to_host(group, out) == hostec.host_group(group).msm_fast(scal, pts)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [curve.BLS12_381_G2, curve.BLS12_377_G2, curve.JUBJUB],
                         ids=lambda g: g.name)
@pytest.mark.parametrize("n", [2, 300])  # windows c = 4 and c = 8
@pytest.mark.parametrize("distinct", [True, False])
def test_g2_and_jubjub_msm_on_card_match_host(cuda, group, n, distinct):
    """K2c (G2) and K2b (JubJub) MSMs on the card against the host group
    law; with distinct=False a base repeats, so the complete forms meet P == Q."""
    hg = hostec.host_group(group)
    rnd = random.Random(n)
    gen = (group.gen_x, group.gen_y)
    pts = [hg.mul_fast(gen, rnd.randrange(1, 1 << 64))]
    step = hg.mul_fast(gen, rnd.randrange(1, 1 << 64))
    for _ in range(n - 1):
        pts.append(hg.add(pts[-1], step))
    if not distinct:
        pts[-1] = pts[0]
    scal = [rnd.randrange(group.scalar_spec.modulus) for _ in range(n)]
    out = msm.msm(group, msm.scalars_from_ints(group.scalar_spec, scal, cuda),
                  curve.affine_from_ints(group, [(x, y, False) for x, y in pts], cuda),
                  assume_distinct=distinct and group is not curve.JUBJUB)
    assert hostec.device_proj_to_host(group, out) == hg.msm_fast(scal, pts)


@pytest.mark.gpu
def test_g2_fixed_base_and_jubjub_scalar_mul_on_card(cuda):
    hg2 = hostec.host_group(curve.BLS12_381_G2)
    g2 = curve.BLS12_381_G2
    rnd = random.Random(9)
    scal = [0, 1] + [rnd.randrange(g2.scalar_spec.modulus) for _ in range(300)]
    out = msm.fixed_base_mul(g2, g2.generator(cuda), msm.scalars_from_ints(g2.scalar_spec, scal, cuda))
    x, y, inf = g2.to_affine(out)
    got = [None if i else (tuple(F.to_ints(g2.spec, a)), tuple(F.to_ints(g2.spec, b)))
           for a, b, i in zip(x, y, inf.tolist())]
    assert got == [hg2.mul_fast(g2.generator_host(), s) if s else None for s in scal]
    jj, hj = curve.JUBJUB, hostec.host_group(curve.JUBJUB)
    pts = [hj.mul_fast((jj.gen_x, jj.gen_y), rnd.randrange(1, 1 << 64)) for _ in range(100)]
    k = rnd.randrange(jj.scalar_spec.modulus)
    p = jj.from_affine(F.from_ints(jj.spec, [q[0] for q in pts], device=cuda),
                       F.from_ints(jj.spec, [q[1] for q in pts], device=cuda))
    ax, ay, _ = jj.to_affine(jj.scalar_mul(p, k))
    assert list(zip(F.to_ints(jj.spec, ax), F.to_ints(jj.spec, ay))) == [hj.mul_fast(q, k) for q in pts]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FR_BN254, FP.FR_BLS12_381], ids=lambda s: s.name)
@pytest.mark.parametrize("kernel", ["butterfly", "fused_stages", "stage"])
def test_ntt_kernel_matches_plain(cuda, spec, kernel):
    """K4a on 2^13 pairs; K4b and K4c on 8 rows of 2^13 (2^16 elements),
    K4c at the first stage past the block and at the last; inputs < 2p."""
    tws = NTT.stage_twiddles(spec, 13, False, cuda)
    if kernel == "butterfly":
        args = [_field(spec, 1 << 13, seed).to(cuda) for seed in (7, 8, 9)]
        got, want = ntt_lf.butterfly(spec, *args), ntt_lf.butterfly_plain(spec, *args)
    else:
        a = _field(spec, 1 << 16, 10).to(cuda)
        if kernel == "fused_stages":
            table = ntt_lf.fused_table(tws, 11)
            got = [ntt_lf.fused_stages(spec, a, table, 11, 1 << 11)]
            want = [ntt_lf.fused_stages_plain(spec, a, table, 11, 1 << 11)]
        else:
            got = [ntt_lf.stage(spec, a, tws[s], s) for s in (11, 12)]
            want = [ntt_lf.stage_plain(spec, a, tws[s], s) for s in (11, 12)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(ff.canonicalize(spec, g), ff.canonicalize(spec, w))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FR_BN254, FP.FR_BLS12_381], ids=lambda s: s.name)
@pytest.mark.parametrize("log_n,rows", [(10, 4), (14, 2), (8, 2)],
                         ids=["k4b_all_stages", "k4b_k4c", "k4a"])
def test_ntt_round_trip_on_card(cuda, spec, log_n, rows):
    """ntt_lf on the card equals the portable field-last route, and intt
    brings the input back."""
    a = ff.canonicalize(spec, _field(spec, rows << log_n, 11).to(cuda))
    before = [w.launches for w in ntt_lf.WRAPPERS]
    ev = ntt_lf.ntt(spec, a, rows=rows)
    back = ntt_lf.intt(spec, ev, rows=rows)
    torch.cuda.synchronize()
    ran = [w.launches - b for w, b in zip(ntt_lf.WRAPPERS, before)]  # butterfly, fused, stages, small
    assert ran[0] == 0
    assert ran[3] == (2 if rows << log_n < ntt_lf.FUSED_MIN_TOTAL else 0)  # one launch a transform
    assert (ran[2] > 0) == (log_n > 11)
    assert torch.equal(ff.canonicalize(spec, back), a)
    portable = NTT.ntt(spec, ff.to_field_last(a, (rows, 1 << log_n)))
    assert torch.equal(ff.canonicalize(spec, ev), ff.from_field_last(portable))



def _scan_inputs(spec, n_pts, steps, lanes, seed):
    """A point-major table of random lazy coordinates (the last row the
    negation of row 0), idx and keep (steps, lanes) on the CPU: lane 0
    skips every step; lane 1 adds row 1 twice from infinity (a doubling in
    the complete madd) and lane 2 row 0 then its negation (back to
    infinity), where lanes allow; keep about 80% elsewhere."""
    x, y = _field(spec, n_pts, seed), _field(spec, n_pts, seed + 1)
    x[:, -1] = x[:, 0]
    y[:, -1:] = ff.plain("sub", spec, torch.zeros_like(y[:, :1]), y[:, :1].contiguous())
    table = ec_lf.pack(x, y).T.contiguous()
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n_pts - 1, (steps, lanes), generator=g, dtype=torch.int32)
    keep = torch.rand((steps, lanes), generator=g) < 0.8
    keep[:, 0] = False
    if lanes > 2:
        keep[:2, 1:3] = True
        idx[:2, 1] = 1
        idx[0, 2], idx[1, 2] = 0, n_pts - 1
    return table, idx, keep


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FQ_BLS12_381, FP.FQ_BLS12_377, FP.FQ_BN254], ids=lambda s: s.name)
@pytest.mark.parametrize("lanes", [1, 300])  # 128 lanes a block: 300 leaves a partial block
@pytest.mark.parametrize("distinct", [True, False], ids=["distinct", "complete"])
def test_madd_scan_kernel_matches_plain(cuda, spec, lanes, distinct):
    """K2a's one-launch scan against its plain version bit for bit, every
    prefix and the final sums; skipped steps, a doubling and a return to
    infinity included (where the distinct madd's precondition fails it
    computes the same values as its plain version)."""
    table, idx, keep = _scan_inputs(spec, 40, 7, lanes, 5)
    before = ec_lf.madd_scan.launches
    acc, prefixes = ec_lf.madd_scan(spec, *_to((table, idx, keep), cuda), distinct)
    torch.cuda.synchronize()
    assert ec_lf.madd_scan.launches == before + 1
    want_acc, want = ec_lf.madd_scan_plain(spec, table, idx, keep, distinct)
    assert torch.equal(prefixes.cpu(), want)
    for g, w in zip(acc, want_acc):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FR_BN254, FP.FR_BLS12_381], ids=lambda s: s.name)
@pytest.mark.parametrize("s0,r,rows,log_n", [(11, 4, 2, 15), (12, 2, 4, 14), (5, 6, 1, 11),
                                             (2, 3, 8, 5), (0, 1, 4, 6)],
                         ids=["ligero", "two_stages", "six_stages", "narrow_lo", "stage_0"])
def test_ntt_stages_kernel_matches_plain(cuda, spec, s0, r, rows, log_n):
    """K4c's stages s0 .. s0 + r - 1 in one launch against its plain
    version (the chain of one-stage plain calls), bit for bit; the block's
    lo run is 2^s0 where that is under 32."""
    a = _field(spec, rows << log_n, 12)
    tws = NTT.stage_twiddles(spec, log_n, False, "cpu")[s0 : s0 + r]
    got = ntt_lf.stages(spec, a.to(cuda), _to(tws, cuda), s0)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ntt_lf.stages_plain(spec, a, tws, s0))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP.FR_BN254, FP.FR_BLS12_381], ids=lambda s: s.name)
@pytest.mark.parametrize("log_n", range(1, 10))
def test_ntt_small_kernel_matches_plain(cuda, spec, log_n):
    """K4a's one-launch transform against the chain of one-stage plain
    calls, bit for bit, on one row and on as many rows as stay under 2^10
    elements, inputs < 2p."""
    tws = NTT.stage_twiddles(spec, log_n, False, "cpu")
    for rows in sorted({1, (ntt_lf.FUSED_MIN_TOTAL - 1) >> log_n}):
        a = _field(spec, rows << log_n, 50 + log_n)
        got = ntt_lf.small(spec, a.to(cuda), _to(tws, cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ntt_lf.small_plain(spec, a, tws))


def _lazy_columns(spec, n_rows, n_ext, seed, device):
    """(n_rows, n_ext, 16) int32 limbs of values below 2p (top limb below
    2p's), with 0, p, 2p - 1 and p - 1 planted where there is room."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t = torch.randint(0, 1 << 16, (n_rows, n_ext, spec.n_limbs), generator=gen, device=device,
                      dtype=torch.int32)
    top = (2 * spec.modulus) >> (16 * (spec.n_limbs - 1))
    t[..., -1] = torch.randint(0, top, (n_rows, n_ext), generator=gen, device=device,
                               dtype=torch.int32)
    flat = t.view(-1, spec.n_limbs)
    for i, v in ((0, 0), (1, spec.modulus), (-2, 2 * spec.modulus - 1), (-1, spec.modulus - 1)):
        if -flat.shape[0] <= i < flat.shape[0]:
            flat[i] = torch.tensor([(v >> (16 * k)) & 0xFFFF for k in range(spec.n_limbs)],
                                   dtype=torch.int32)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("n_ext", [1, 33, 1 << 15])
@pytest.mark.parametrize("n_rows", [1, 2, 3, 255, 256, 257])
@pytest.mark.parametrize("spec", [FP.FR_BN254, FP.FR_BLS12_381], ids=lambda s: s.name)
def test_blake2s_columns_kernel_matches_hashlib(cuda, spec, n_rows, n_ext):
    """pc_blake2s_columns' digests, through engine.column_leaves on a CUDA
    tensor, equal hashlib's Blake2s over engine.column_bytes (the CPU
    route's bytes) of the same limbs: half a block, one block and a tail a
    column, lazy values in [p, 2p), 0 and p - 1 among them. One launch; on
    the Merkle::leaves record, hashed_bytes and blake2s_device_columns
    n_ext; its one child the digests' read, one host sync."""
    from torch.profiler import ProfilerActivity, profile

    from poly_commit_tpu_torch.pcs.linear_codes import engine
    from poly_commit_tpu_torch.utils import merkle, trace

    ext = _lazy_columns(spec, n_rows, n_ext, n_rows * 7 + n_ext, cuda)
    want = [hashlib.blake2s(col.tobytes()).digest() for col in engine.column_bytes(spec, ext)]
    before = merkle.blake2s_columns.launches
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = engine.column_leaves(spec, ext)
    assert merkle.blake2s_columns.launches == before + 1
    assert got == want
    recs = trace.records()
    leaves = [r for r in recs if r.name == "Merkle::leaves"]
    assert [r.counts for r in leaves] == [{"hashed_bytes": n_ext * n_rows * 32,
                                           "blake2s_device_columns": n_ext}]
    assert [(r.name, r.counts) for r in recs if r.parent == leaves[0].id] == [
        ("Serialize::to_host", {"host_syncs": 1})]


GOLDENS =["marlin_ark_golden", "marlin_bounded_ark_golden", "sonic_ark_golden"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_vectors_replay_on_card(cuda, name):
    """The committed arkworks transcripts, replayed with commit and open on
    the card (MSMs of 11 points through K1, K2a and K3)."""
    import json
    import os

    from poly_commit_tpu_torch.pcs import ark_interop as AI

    with open(os.path.join(os.path.dirname(__file__), "vectors", f"{name}.json")) as fh:
        want = json.load(fh)
    bounded = {} if name == "marlin_ark_golden" else dict(bound=want["degree_bound"],
                                                          hiding=want["hiding_bound"])
    fn = {"marlin_ark_golden": AI.marlin_ark_golden,
          "marlin_bounded_ark_golden": AI.marlin_ark_golden_bounded,
          "sonic_ark_golden": AI.sonic_ark_golden}[name]
    before = ec_lf.madd_scan.launches
    assert fn(want["degree"], device=cuda, **bounded) == want
    assert ec_lf.madd_scan.launches > before


def _sonic_round_trip(device):
    """SonicKZG10 at max_degree 16: bounds [4, 6] with hiding, two points."""
    from poly_commit_tpu_torch.core.transcript import PoseidonSponge
    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
    from poly_commit_tpu_torch.pcs.sonic_pc import SonicKZG10 as PC

    rng = HostRng(7)
    pp = PC.setup(16, rng=rng, device=device)
    ck, vk = PC.trim(pp, 8, 2, [4, 6])
    polys = [LabeledPolynomial(f"p{b}", F.from_ints(PC.spec, rng.field_ints(PC.spec, b + 1),
                                                    device=device), degree_bound=b, hiding_bound=2)
             for b in (4, 6)]
    comms, states = PC.commit(ck, polys, rng)
    points = [rng.field_int(PC.spec) for _ in range(2)]
    query_set = {(lp.label, (f"z{i}", z)) for lp in polys for i, z in enumerate(points)}
    proofs, values = PC.batch_open(ck, polys, comms, query_set, PoseidonSponge(PC.spec), states, rng)
    ok = PC.batch_check(vk, comms, query_set, values, proofs, PoseidonSponge(PC.spec))
    first = sorted(values)[0]
    bad = {**values, first: (values[first] + 1) % PC.spec.modulus}
    rejected = not PC.batch_check(vk, comms, query_set, bad, proofs, PoseidonSponge(PC.spec))
    return ([c.commitment.point for c in comms], [(p.w, p.random_v) for p in proofs], values, ok,
            rejected)


@pytest.mark.gpu
def test_sonic_round_trip_on_card_matches_cpu(cuda):
    """Sonic's commitments, proofs and values on the card equal the CPU's;
    batch_check accepts them and rejects a value plus one."""
    got, want = _sonic_round_trip(cuda), _sonic_round_trip("cpu")
    assert got == want and got[3] is True and got[4] is True


@pytest.mark.gpu
def test_sonic_neg_powers_of_h_on_card_match_host(cuda):
    """setup's 2^10 G2 powers beta^-i h (fixed-base on K2c) against the host
    chain; beta and h's scalar are the rng's first and fourth draws."""
    from poly_commit_tpu_torch.pcs.data_structures import HostRng
    from poly_commit_tpu_torch.pcs.sonic_pc import SonicKZG10 as PC

    n = 1 << 10
    before = ec_lf.g2_madd.launches
    pp = PC.setup(n - 1, rng=HostRng(3), device=cuda)
    assert ec_lf.g2_madd.launches > before
    draws = HostRng(3).field_ints(PC.spec, 4)
    g2 = curve.BLS12_381_G2
    hg = hostec.host_group(g2)
    h = hg.mul_fast(g2.generator_host(), draws[3])
    binv = pow(draws[0], -1, PC.spec.modulus)
    want, acc = [], h
    for _ in range(n):
        want.append(acc)
        acc = hg.mul_fast(acc, binv)
    assert hostec.device_affine_to_host(g2, pp.neg_powers_of_h) == want


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(8, 2048), (3, 100)])
def test_msm_rows_on_card_matches_host(cuda, rows, n):
    """The batched MSM over shared BN254 bases (K3, madd_scan, the lane and
    Abel trees, the device fold) against the host, row by row; row 1 is all
    zero and one point is at infinity."""
    group = curve.BN254_G1
    pts = _points(group, n, 31)
    rnd = random.Random(32)
    scal = [[rnd.randrange(group.scalar_spec.modulus) for _ in range(n)] for _ in range(rows)]
    scal[1] = [0] * n
    triples = [(x, y, False) for x, y in pts]
    triples[7] = (0, 1, True)
    before = ec_lf.madd_scan.launches
    sc = torch.stack([msm.scalars_from_ints(group.scalar_spec, row, cuda) for row in scal])
    out = msm.msm_rows(group, sc, curve.affine_from_ints(group, triples, cuda), assume_distinct=True)
    assert ec_lf.madd_scan.launches == before + 1
    hg = hostec.host_group(group)
    live = [None if t[2] else p for t, p in zip(triples, pts)]
    for b in range(rows):
        got = hostec.device_proj_to_host(group, tuple(c[b] for c in out))
        assert got == hg.msm_fast(scal[b], live)


# (group, c, rows): Marlin's SRS MSMs (c = 16, W = 16) and hiding MSMs
# (c = 4, W = 64), Hyrax's 2^11 row MSMs at c = 8 (two windows a thread,
# so that every block is resident), PST13's BLS12-377 MSMs; 2^13 rows
# (four windows a thread), a launch shape no path takes
FOLD_CASES = [(curve.BLS12_381_G1, 16, 1), (curve.BLS12_381_G1, 4, 1), (curve.BN254_G1, 8, 2048),
              (curve.BLS12_377_G1, 16, 1), (curve.BN254_G1, 8, 8192)]
FOLD_HOST_ROWS = 4  # rows also held against _fold_host (~40-70 ms a row)


@pytest.mark.gpu
@pytest.mark.parametrize("group,c,rows", FOLD_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_fold_device_on_card_matches_fold_host(cuda, group, c, rows):
    """The window fold on the card, in one window_fold launch and no other
    K2a, against the host: the parts are fixed-base multiples of the
    generator by fold_logs' logs (G_last = +-sum G, G_last at infinity and
    S_w = 0 windows; with more rows a row of zero scalars and a row of one
    non-zero window), so every row is the host's multiple of the generator
    by its log; the first rows also equal _fold_host of their windows."""
    from poly_commit_tpu_torch.core import msm_gpu

    from tests import torch_fold_cases as FC

    spec, ops = group.spec, msm_gpu.JACOBIAN_OPS
    windows = msm_gpu.SCALAR_BITS // c
    logs, want = FC.fold_logs(group.scalar_spec.modulus, c, windows, rows, seed=33)
    parts = FC.card_fold_parts(group, logs, cuda)
    before = {w.__name__: w.launches for w in ec_lf.WRAPPERS}
    folded = msm_gpu.fold_device(spec, parts, c, rows)
    torch.cuda.synchronize()
    launched = {w.__name__: w.launches - before[w.__name__] for w in ec_lf.WRAPPERS
                if w.launches != before[w.__name__]}
    assert launched == {"window_fold": 1}
    got = FC.fold_to_host(group, folded)
    assert got == FC.want_points(group, want)
    for b in range(min(rows, FOLD_HOST_ROWS)):
        row_parts = tuple(p[:, b * windows : (b + 1) * windows] for p in parts)
        assert msm_gpu._fold_host(group, ops, row_parts, c) == got[b]


@pytest.mark.gpu
def test_fold_device_on_card_matches_fold_host_on_msm_parts(cuda):
    """The fold of _msm_body's own parts (4 BN254 rows of 256 points at the
    card's c = 8) against the host fold of each row's windows."""
    from poly_commit_tpu_torch.core import msm_gpu

    group = curve.BN254_G1
    spec, ops = group.spec, msm_gpu.JACOBIAN_OPS
    n, rows = 256, 4
    c, t_lanes = msm_gpu.rows_params(cuda, n)
    pts = _points(group, n, 33)
    rnd = random.Random(34)
    sc = torch.stack([msm.scalars_from_ints(group.scalar_spec, [rnd.randrange(group.scalar_spec.modulus)
                                                                for _ in range(n)], cuda)
                      for _ in range(rows)])
    x, y, inf = curve.affine_from_ints(group, [(px, py, False) for px, py in pts], cuda)
    x, y = ff.from_field_last(x), ff.from_field_last(y)
    digs = msm_gpu._window_digits(sc, inf, c).view(-1, n)
    parts = msm_gpu._msm_body(spec, ops, digs, x, y, True, c, t_lanes)
    folded = msm_gpu.fold_device(spec, parts, c, rows)
    w = msm_gpu.SCALAR_BITS // c
    for b in range(rows):
        host = msm_gpu._fold_host(group, ops, tuple(p[:, b * w : (b + 1) * w] for p in parts), c)
        assert ops.to_host(spec, None, tuple(cc[:, b : b + 1] for cc in folded)) == [host]


@pytest.mark.gpu
def test_g1_msm_on_card_folds_on_card(cuda, monkeypatch):
    """A G1 MSM of 786,432 points (Marlin's padded SRS MSMs) on the card:
    its windows fold in one window_fold launch, _fold_host never runs, and
    the point equals the host's. The bases are fixed-base multiples of the
    generator by known random logs, so the host's MSM is msm_fast of the
    generator by sum_i s_i log_i."""
    from poly_commit_tpu_torch.core import msm_gpu

    group = curve.BLS12_381_G1
    spec, r, n = group.spec, group.scalar_spec.modulus, 786_432
    rnd = random.Random(36)
    logs = [rnd.randrange(1, r) for _ in range(n)]
    scal = [rnd.randrange(r) for _ in range(n)]
    gx = ff.from_ints(spec, [group.gen_x], device=cuda)
    gy = ff.from_ints(spec, [group.gen_y], device=cuda)
    bases = msm_gpu.fixed_base(group, gx, gy, msm.scalars_from_ints(group.scalar_spec, logs, cuda))
    x, y = msm_gpu.jacobian_to_affine(spec, bases)
    del bases
    host_folds = []
    monkeypatch.setattr(msm_gpu, "_fold_host", lambda *a: host_folds.append(a))
    before = ec_lf.window_fold.launches
    out = msm_gpu.msm(group, msm.scalars_from_ints(group.scalar_spec, scal, cuda), x, y,
                      torch.zeros(n, dtype=torch.bool, device=cuda), True)
    torch.cuda.synchronize()
    assert ec_lf.window_fold.launches == before + 1 and host_folds == []
    k = sum(s * lg for s, lg in zip(scal, logs)) % r
    hg = hostec.host_group(group)
    assert msm_gpu.JACOBIAN_OPS.to_host(spec, None, out) == [
        hg.msm_fast([k], [(group.gen_x, group.gen_y)])]


@pytest.mark.gpu
def test_brakedown_encode_on_card_matches_plain(cuda):
    """Brakedown's recursive encode at 12 variables (gathers and K1 on the
    card) against the same encode on the CPU's plain versions, from one
    seed's parameters and matrix."""
    from poly_commit_tpu_torch.pcs.data_structures import HostRng
    from poly_commit_tpu_torch.pcs.linear_codes import brakedown as B

    spec = FP.FR_BN254
    outs = []
    for device in (cuda, "cpu"):
        rng = HostRng(12)
        pp = B.default_params(spec, rng, 1 << 12, True, device=device)
        mat = F.from_ints(spec, rng.field_ints(spec, 1 << 12), device=device).view(pp.n, pp.m, -1)
        outs.append(ff.limbs_to_ints(spec, B.MultilinearBrakedownCode(spec).encode_rows(mat, pp)
                                     .reshape(-1, spec.n_limbs).cpu().numpy()))
    assert pp.a_dims and outs[0] == outs[1]


def _hyrax_round_trip(device, nv=8):
    """Hyrax at nv variables, one hiding polynomial: the row commitments,
    the proof and the verdict."""
    from poly_commit_tpu_torch.core.transcript import PoseidonSponge
    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
    from poly_commit_tpu_torch.pcs.hyrax import HyraxPC as PC

    rng = HostRng(8)
    ck, vk = PC.trim(PC.setup(0, num_vars=nv, rng=rng, device=device))
    lp = LabeledPolynomial("p", F.from_ints(PC.spec, rng.field_ints(PC.spec, 1 << nv), device=device),
                           hiding_bound=1, num_vars=nv)
    comms, states = PC.commit(ck, [lp], rng)
    point = tuple(rng.field_int(PC.spec) for _ in range(nv))
    qs = {("p", ("pt", point))}
    proofs, values = PC.batch_open(ck, [lp], comms, qs, PoseidonSponge(PC.spec), states, rng)
    ok = PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(PC.spec))
    pf = proofs[0][0]
    return (comms[0].commitment.row_coms, (pf.com_eval, pf.com_d, pf.com_b, pf.z, pf.z_d, pf.z_b),
            values, bool(ok))


@pytest.mark.gpu
def test_hyrax_round_trip_on_card_matches_cpu(cuda):
    before = ec_lf.madd_scan.launches
    got = _hyrax_round_trip(cuda)
    assert ec_lf.madd_scan.launches > before
    assert got == _hyrax_round_trip("cpu") and got[3] is True


@pytest.mark.gpu
@pytest.mark.parametrize("dn,dd", [(1 << 14, 4), (3000, 1), (37, 37)])
def test_long_divide_on_card_matches_cpu(cuda, dn, dd):
    """Newton's division (NTT products on K4, K1) on the card equals its CPU
    run: the quotient and the remainder."""
    from poly_commit_tpu_torch.core import poly as P

    spec = FP.FR_BLS12_381
    rnd = random.Random(dn + dd)
    num = F.from_ints(spec, [rnd.randrange(spec.modulus) for _ in range(dn)], device="cpu")
    den = F.from_ints(spec, [rnd.randrange(1, spec.modulus) for _ in range(dd)], device="cpu")
    before = ntt_lf.fused_stages.launches + ntt_lf.small.launches
    q, r = P.long_divide(spec, num.to(cuda), den.to(cuda))
    assert ntt_lf.fused_stages.launches + ntt_lf.small.launches > before
    wq, wr = P.long_divide(spec, num, den)
    assert F.to_ints(spec, q) == F.to_ints(spec, wq)
    assert r.shape[0] == dd - 1 and (dd == 1 or F.to_ints(spec, r) == F.to_ints(spec, wr))


@pytest.mark.gpu
def test_streaming_space_prover_on_card_matches_time_prover(cuda):
    """Streaming KZG at 2^14 coefficients, chunks of 2^10, three points and
    four folds: every chunked group element and remainder on the card
    equals the time prover's."""
    from poly_commit_tpu_torch.core import poly as P
    from poly_commit_tpu_torch.pcs import streaming_kzg as SK
    from poly_commit_tpu_torch.pcs.data_structures import HostRng

    spec, n, chunk = SK.SPEC, 1 << 14, 1 << 10
    rng = HostRng(21)
    ck = SK.CommitterKey.new(n - 1, 3, rng, device=cuda)
    f = F.from_ints(spec, rng.field_ints(spec, n), device=cuda)
    z = rng.field_int(spec)
    pts = [rng.field_int(spec) for _ in range(3)]
    rhos, etas = [rng.field_int(spec) for _ in range(4)], [rng.field_int(spec) for _ in range(4)]
    assert ck.commit_chunked(f, chunk).point == ck.commit(f).point
    assert ck.open_chunked(f, z, chunk) == ck.open(f, z)
    rem, proof = ck.open_multi_points_chunked(f, pts, chunk)
    zpoly = P.vanishing_poly(spec, F.from_ints(spec, pts, device=cuda))
    assert proof.point == ck.open_multi_points(f, pts).point
    assert F.to_ints(spec, rem) == F.to_ints(spec, P.long_divide(spec, f, zpoly)[1])
    rems, fold_proof = ck.open_folding_chunked(f, rhos, pts, etas, chunk)
    comb = None
    for fj, eta, rj in zip(ck.fold_polynomials(f, rhos), etas, rems):
        q, r = P.long_divide(spec, fj, zpoly)
        assert F.to_ints(spec, rj) == F.to_ints(spec, r)
        scaled = P.scale(spec, q, F.from_ints(spec, eta, device=cuda))
        comb = scaled if comb is None else P.add(spec, comb, scaled)
    assert fold_proof.point == ck.commit(comb).point


def _pst13_round_trip(device):
    """MarlinPST13 at 3 variables, degree 4: two hiding polynomials at one
    point; the commitments, the proofs, the values and the verdict."""
    from poly_commit_tpu_torch.core.transcript import PoseidonSponge
    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
    from poly_commit_tpu_torch.pcs.pst13 import MarlinPST13 as PC, MVPoly

    rng = HostRng(22)
    ck, vk = PC.trim(PC.setup(4, num_vars=3, rng=rng, device=device), 4, 1)
    polys = [LabeledPolynomial(f"p{i}", MVPoly.rand(rng, 3, 4, num_terms=12), hiding_bound=1,
                               num_vars=3) for i in range(2)]
    comms, states = PC.commit(ck, polys, rng)
    point = tuple(rng.field_int(PC.spec) for _ in range(3))
    qs = {(lp.label, ("z", point)) for lp in polys}
    proofs, values = PC.batch_open(ck, polys, comms, qs, PoseidonSponge(PC.spec), states, rng)
    ok = PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(PC.spec))
    return ([c.commitment.comm for c in comms], [(p.w, p.random_v) for p in proofs], values,
            bool(ok))


@pytest.mark.gpu
def test_pst13_round_trip_on_card_matches_cpu(cuda):
    before = ec_lf.madd_scan.launches
    got = _pst13_round_trip(cuda)
    assert ec_lf.madd_scan.launches > before
    assert got == _pst13_round_trip("cpu") and got[3] is True


@pytest.mark.gpu
def test_pst13_bls12_377_round_trip_on_card(cuda):
    """MarlinPST13_BLS12_377 at 3 variables, degree 4, on the card (its
    K1 and K2a builds of Fq-377): batch_check accepts two hiding
    polynomials' values and rejects a value plus one; the G1 kernels ran."""
    from poly_commit_tpu_torch.core.transcript import PoseidonSponge
    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
    from poly_commit_tpu_torch.pcs.pst13 import MarlinPST13_BLS12_377 as PC, MVPoly

    spec = PC.spec
    rng = HostRng(13)
    before = {w.__name__: w.launches for w in ec_lf.WRAPPERS}
    ck, vk = PC.trim(PC.setup(4, num_vars=3, rng=rng, device=cuda), 4, 1)
    polys = [LabeledPolynomial(f"q{i}", MVPoly.rand(rng, 3, 4, num_terms=12, spec=spec),
                               hiding_bound=1, num_vars=3) for i in range(2)]
    comms, states = PC.commit(ck, polys, rng)
    point = tuple(rng.field_int(spec) for _ in range(3))
    qs = {(lp.label, ("z", point)) for lp in polys}
    proofs, values = PC.batch_open(ck, polys, comms, qs, PoseidonSponge(spec), states, rng)
    assert PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(spec))
    first = sorted(values)[0]
    bad = {**values, first: (values[first] + 1) % spec.modulus}
    assert not PC.batch_check(vk, comms, qs, bad, proofs, PoseidonSponge(spec))
    launched = {w.__name__ for w in ec_lf.WRAPPERS if w.launches > before[w.__name__]}
    assert {"madd", "madd_distinct", "add", "double", "madd_scan", "window_fold"} <= launched


def _r1cs_circuit():
    """A small R1CS over Fr-381: 3 G on JubJub, one non-native product and a
    263-bit range check (rows from 1 to 265 entries: every bucket kind of
    the device check)."""
    from poly_commit_tpu_torch.pcs import r1cs

    cs = r1cs.ConstraintSystem(FP.FR_BLS12_381)
    g = (FP.JUBJUB_G_X, FP.JUBJUB_G_Y)
    p1 = r1cs.TEPointVar.witness(cs, g)
    p1.enforce_on_curve()
    p3 = p1.double().add(p1)
    x3, y3 = hostec.host_group(curve.JUBJUB).mul(g, 3)
    p3.enforce_equal(r1cs.TEPointVar(r1cs.FpVar.constant(cs, x3), r1cs.FpVar.constant(cs, y3)))
    a = r1cs.NonNativeVar.witness(cs, FP.JUBJUB_R, 12345678901234567890)
    b = r1cs.NonNativeVar.witness(cs, FP.JUBJUB_R, 98765432109876543210)
    exp = 12345678901234567890 * 98765432109876543210 % FP.JUBJUB_R
    a.mul(b).enforce_congruent(r1cs.NonNativeVar.witness(cs, FP.JUBJUB_R, exp))
    r1cs.range_check(cs, r1cs.FpVar.witness(cs, (1 << 262) + 5), 263)
    return cs


@pytest.mark.gpu
@pytest.mark.parametrize("tamper", [False, True], ids=["valid", "tampered"])
def test_r1cs_device_check_on_card_matches_host(cuda, tamper):
    cs = _r1cs_circuit()
    if tamper:
        cs.assignment[2] = (cs.assignment[2] + 1) % cs.p
    before = ff.mont_mul.launches
    got = cs.is_satisfied_device(cuda)
    assert ff.mont_mul.launches == before + 2  # the entries' products (one chunk), then A times B
    assert got is cs.is_satisfied() is (not tamper)


def _pairing_points(seed):
    """A host point of BLS12-381's G1 and one of its G2, random multiples
    of the generators."""
    rnd = random.Random(seed)
    g1, g2 = curve.BLS12_381_G1, curve.BLS12_381_G2
    p = hostec.host_group(g1).mul_fast((g1.gen_x, g1.gen_y), rnd.randrange(1, 1 << 64))
    q = hostec.host_group(g2).mul_fast((g2.gen_x, g2.gen_y), rnd.randrange(1, 1 << 64))
    return p, q


@pytest.mark.gpu
def test_device_pairing_on_card_matches_host_pairing(cuda):
    from poly_commit_tpu_torch.core import host_pairing as HP
    from poly_commit_tpu_torch.core import pairing as PR

    p, q = _pairing_points(1)
    got = PR.pairing(curve.affine_from_ints(curve.BLS12_381_G1, [(p[0], p[1], False)], cuda),
                     curve.affine_from_ints(curve.BLS12_381_G2, [(q[0], q[1], False)], cuda))
    assert PR.f12_to_ints(got[0]) == HP.pairing(p, q)


@pytest.mark.gpu
def test_device_pairing_check_on_card(cuda):
    from poly_commit_tpu_torch.core import pairing as PR

    p, q = _pairing_points(2)
    neg = (p[0], (-p[1]) % FP.BLS12_381_Q, False)
    g2 = curve.affine_from_ints(curve.BLS12_381_G2, [(q[0], q[1], False)] * 3, cuda)
    g1 = curve.affine_from_ints(curve.BLS12_381_G1, [(p[0], p[1], False), neg, (0, 0, True)], cuda)
    assert bool(PR.pairing_check(g1, g2))
    g1 = curve.affine_from_ints(curve.BLS12_381_G1, [(p[0], p[1], False)] * 2 + [(0, 0, True)],
                                cuda)
    assert not bool(PR.pairing_check(g1, g2))
    # an infinite input gives one
    inf = curve.affine_from_ints(curve.BLS12_381_G1, [(0, 0, True)], cuda)
    q1 = curve.affine_from_ints(curve.BLS12_381_G2, [(q[0], q[1], False)], cuda)
    assert bool(PR.f12_is_one(PR.miller_loop(inf, q1)).all())


@pytest.mark.gpu
def test_persisted_key_loads_onto_card(cuda, tmp_path):
    from poly_commit_tpu_torch.pcs import kzg10
    from poly_commit_tpu_torch.pcs.data_structures import HostRng
    from poly_commit_tpu_torch.utils import persist

    pp = kzg10.setup(8, rng=HostRng(4), device="cpu")
    path = str(tmp_path / "srs.npz")
    persist.save(path, pp)
    back = persist.load(path, device=cuda)
    assert all(t.device.type == "cuda" for t in back.powers_of_g + back.powers_of_gamma_g)
    coeffs = F.from_ints(FP.FR_BLS12_381, HostRng(5).field_ints(FP.FR_BLS12_381, 9), device="cpu")

    def commit(params, dev):
        powers = kzg10.Powers(params.powers_of_g, params.powers_of_gamma_g)
        return kzg10.commit(powers, coeffs.to(dev))[0]

    assert commit(back, cuda) == commit(pp, "cpu")


@pytest.mark.gpu
def test_marlin_key_traced_and_persisted_on_card(cuda, tmp_path, monkeypatch):
    """A MarlinKZG10 commit on the card under torch.profiler with
    POLY_COMMIT_TRACE=1 shows its MarlinKZG10::commit and KZG10::commit
    spans on the host; its committer key, saved and loaded onto the card
    (utils/persist), commits to the same point."""
    from torch.profiler import ProfilerActivity, profile

    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
    from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10 as PC
    from poly_commit_tpu_torch.utils import persist

    rng = HostRng(15)
    ck, _ = PC.trim(PC.setup(1023, rng=rng, device=cuda), 1023, 1)
    lp = LabeledPolynomial("p", F.from_ints(PC.spec, rng.field_ints(PC.spec, 1024), device=cuda))
    monkeypatch.setenv("POLY_COMMIT_TRACE", "1")
    scans, sorts = ec_lf.madd_scan.launches, sort_gpu.digit_sort.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        comms, _ = PC.commit(ck, [lp])
        torch.cuda.synchronize()
    assert ec_lf.madd_scan.launches > scans and sort_gpu.digit_sort.launches > sorts
    host = {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.time_range.end > e.time_range.start}
    assert {"MarlinKZG10::commit", "KZG10::commit"} <= host
    path = str(tmp_path / "marlin_ck.npz")
    persist.save(path, ck)
    loaded = persist.load(path, device=cuda)
    assert all(t.device.type == "cuda" for t in loaded.powers + loaded.powers_of_gamma_g
               if isinstance(t, torch.Tensor))
    assert PC.commit(loaded, [lp])[0][0].commitment == comms[0].commitment



def _card_msm_case(cuda, n):
    """tests/torch_mesh_cases.py's n-point MSM on the card, and its
    single-device result as affine ints."""
    from poly_commit_tpu_torch.core.serialize import device_point_to_ints
    from tests import torch_mesh_cases as cases

    sc, pts = cases._msm_tensors(cases.G1, n, n)
    sc, pts = sc.to(cuda), tuple(a.to(cuda) for a in pts)
    return cases, sc, pts, device_point_to_ints(cases.G1, msm.msm(cases.G1, sc, pts))


@pytest.mark.gpu
def test_msm_sharded_nccl_world_1_on_card(cuda):
    """NCCL with one rank, in this process: msm_sharded equals the
    single-device MSM."""
    import torch.distributed as dist

    from poly_commit_tpu_torch.core.serialize import device_point_to_ints
    from poly_commit_tpu_torch.parallel import mesh as PM

    cases, sc, pts, single = _card_msm_case(cuda, 256)
    mesh = PM.make_mesh(1)
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda" and not mesh.staged
        assert device_point_to_ints(cases.G1, PM.msm_sharded(cases.G1, sc, pts, mesh)) == single
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_msm_sharded_two_gloo_ranks_share_card(cuda):
    """Two gloo ranks pinned to cuda:0 (collectives staged through host
    memory): each returns the single-device MSM."""
    from poly_commit_tpu_torch.parallel import launch as PL

    cases, _, _, single = _card_msm_case(cuda, 256)
    got = PL.launch(cases.card_msm, 2, backend="gloo", device="cuda:0", args=(256,), timeout=300)
    assert got == [single, single]


@pytest.mark.gpu
def test_marlin_under_nccl_world_1_on_card(cuda, monkeypatch):
    """MarlinKZG10 at degree 2^10 - 1 under use_mesh(make_mesh(1)), NCCL
    in this process: commit and batch_open equal the single-device run's,
    their SRS MSMs take msm_sharded, and batch_check accepts."""
    import torch.distributed as dist

    from poly_commit_tpu_torch.core.transcript import PoseidonSponge
    from poly_commit_tpu_torch.parallel import mesh as PM
    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
    from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10 as PC

    spec, degree = PC.spec, 1023
    ck, vk = PC.trim(PC.setup(degree, rng=HostRng(16), device=cuda), degree, 1)
    lp = LabeledPolynomial("p", F.from_ints(spec, HostRng(17).field_ints(spec, degree + 1), device=cuda),
                           hiding_bound=1)

    def commit_open():
        rng = HostRng(18)
        comms, states = PC.commit(ck, [lp], rng)
        qs = {("p", ("z", rng.field_int(spec)))}
        proofs, values = PC.batch_open(ck, [lp], comms, qs, PoseidonSponge(spec), states, rng)
        return comms, qs, proofs, values

    want = commit_open()
    calls, sharded = [], PM.msm_sharded
    monkeypatch.setattr(PM, "msm_sharded", lambda *a, **kw: calls.append(1) or sharded(*a, **kw))
    mesh = PM.make_mesh(1)
    try:
        assert mesh.backend == "nccl"
        with PM.use_mesh(mesh):
            got = commit_open()
            comms, qs, proofs, values = got
            assert PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(spec))
    finally:
        dist.destroy_process_group()
    assert got == want and calls


@pytest.fixture(scope="module")
def card_ranks():
    """tests/torch_mesh_cases.py's cases on four gloo ranks that share
    cuda:0, their collectives staged through host memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    from poly_commit_tpu_torch.parallel import launch as PL

    return PL.launch(mesh_cases.run, mesh_cases.WORLD, backend="gloo", device="cuda:0",
                     args=("cuda:0",), timeout=600)


# the mesh layer's entry point each case's sharded branch calls (the
# 8-point NTT gathers instead)
MESH_ROUTES = {"msm_64": "msm_sharded", "msm_50": "msm_sharded", "batch_msm": "batch_msm_sharded",
               "ntt_64_forward": "_transpose_sharded", "ntt_64_inverse": "_transpose_sharded",
               "batch_ntt": "batch_ntt_sharded", "row_mul": "row_mul_sharded",
               "fold_key": "fold_key_sharded", "marlin_golden": "msm_sharded",
               "hyrax_commit": "batch_msm_sharded", "pst13_commit": "msm_sharded",
               "brakedown_encode": "map_rows", "ligero_encode": "batch_ntt_sharded",
               "ipa_open": "fold_key_sharded"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(mesh_cases.CASES))
def test_mesh_case_on_card_matches_single_device(card_ranks, name):
    """Each case under the mesh of four ranks on cuda:0 equals its
    single-device result on the card (the NTTs slice by slice; the Marlin
    golden its committed vector), and ran its sharded branch."""
    import json
    import os

    got = [r["mesh"][name] for r in card_ranks]
    if name.startswith("ntt_"):
        slices = sorted(got)
        assert [i for i, _ in slices] == list(range(mesh_cases.WORLD))
        got = [[v for _, part in slices for v in part]]
    assert all(g == got[0] for g in got[1:])
    if name == "marlin_golden":
        with open(os.path.join(os.path.dirname(__file__), "vectors", "marlin_ark_golden.json")) as fh:
            want = json.load(fh)
    else:
        (want,) = [r["single"][name] for r in card_ranks if name in r["single"]]
    assert got[0] == want
    if name in MESH_ROUTES:
        assert all(MESH_ROUTES[name] in r["routes"][name] for r in card_ranks)


@pytest.mark.gpu
def test_mesh_2d_guard_and_replication_on_card(card_ranks):
    """On cuda:0's four ranks: the 2x2 mesh's MSM over dp and NTT over tp
    equal the single-device results, a rank whose replicated input differs
    makes every rank raise, and replicate and shard_batch keep their
    layouts."""
    (msm_64,) = [r["single"]["msm_64"] for r in card_ranks if "msm_64" in r["single"]]
    (ntt_64,) = [r["single"]["ntt_64_forward"] for r in card_ranks if "ntt_64_forward" in r["single"]]
    assert sorted(r["coords_2d"] for r in card_ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["mesh"]["msm_64_dp"] == msm_64 for r in card_ranks)
    for dp in (0, 1):
        slices = sorted(r["mesh"]["ntt_64_forward_tp"] for r in card_ranks if r["coords_2d"][0] == dp)
        assert [v for _, s in slices for v in s] == ntt_64
    assert all("replicated inputs differ" in (r["mesh"]["digest_guard"] or "") for r in card_ranks)
    assert all(r["mesh"]["replicate"] == [10, 10, 10] for r in card_ranks)
    got = sorted((r["rank"], r["mesh"]["shard_batch"]) for r in card_ranks)
    assert got == [(i, [2 * i, 2 * i + 1]) for i in range(mesh_cases.WORLD)]


@pytest.mark.gpu
def test_demo_drives_every_scheme_on_card(cuda, capsys):
    """The port's entry point (python -m poly_commit_tpu_torch.demo) on the
    card: ten OK lines, each tamper probe rejected, exit code 0."""
    from poly_commit_tpu_torch import demo

    assert demo.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if ln.startswith(("OK ", "FAIL "))] == [f"OK {n}" for n in demo.NAMES]
    assert len(demo.NAMES) == 10


# the drives also run on the CPU (the kernels' plain versions) and are held
# against the card's: the ones with the smallest MSMs (Hyrax's rows of 4,
# IPA's 8 points) and the 16-point Ligero encodes
DEMO_ON_CPU = ("ipa_pc", "univariate_ligero", "multilinear_ligero", "brakedown", "hyrax")
# kernels the drives launch: K1, K2a's MSM scan and fixed-base madd, K2c
# (the G2 setups), K2b (IPA's key fold), K3 and K4a
DEMO_KERNELS = (ff.mont_mul, ec_lf.madd_scan, ec_lf.madd, ec_lf.g2_madd, ec_lf.ed_smul,
                sort_gpu.digit_sort, ntt_lf.small)


@pytest.mark.gpu
def test_demo_drives_on_card_match_cpu(cuda):
    """The entry point's ten drives in this process on the card, every one
    passed (its tamper probe rejected) and every kernel family launched;
    five of them on the CPU give the card's commitments and values."""
    from poly_commit_tpu_torch import demo

    before = [k.launches for k in DEMO_KERNELS]
    results = demo.run(device=cuda, out=io.StringIO())
    assert [r.name for r in results] == list(demo.NAMES)
    assert [r.name for r in results if not r.passed] == []
    assert [k.__name__ for k, b in zip(DEMO_KERNELS, before) if k.launches == b] == []
    card = {r.name: r for r in results}
    for name in DEMO_ON_CPU:
        res = demo.run_scheme(name, "cpu")
        assert res.passed, name
        assert (res.commitments, res.values) == (card[name].commitments, card[name].values), name
