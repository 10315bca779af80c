"""The PyTorch port's field tiers (poly_commit_tpu_torch.core.ff, K1, and
core.field) against the JAX package, exactly, on the same raw limbs.

On the CPU the port's wrappers run their plain versions; the JAX ff runs its
pure-JAX fallback. Values are compared as canonical ints.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from poly_commit_tpu.core import ff as jff  # noqa: E402
from poly_commit_tpu.core import field as jfield  # noqa: E402
from poly_commit_tpu_torch.core import ff, field  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SPECS = {"fq381": FP.FQ_BLS12_381, "fq377": FP.FQ_BLS12_377, "fr381": FP.FR_BLS12_381}


def _raw_limbs(spec, ints):
    """(L, N) uint32 limbs of ints without reduction (values may be >= p)."""
    data = b"".join(int(v).to_bytes(2 * spec.n_limbs, "little") for v in ints)
    return np.frombuffer(data, "<u2").reshape(-1, spec.n_limbs).T.astype(np.uint32).copy()


def _inputs(spec, n, seed):
    """Random values in [0, 2p) (the lazy range of the ff tier)."""
    rng = np.random.default_rng(seed)
    nb = 2 * spec.n_limbs + 8
    a = [int.from_bytes(rng.bytes(nb), "little") % (2 * spec.modulus) for _ in range(n)]
    b = [int.from_bytes(rng.bytes(nb), "little") % (2 * spec.modulus) for _ in range(n)]
    a[0], b[0] = 0, spec.modulus  # both encodings of zero
    a[1], b[1] = spec.modulus - 1, 2 * spec.modulus - 1
    return _raw_limbs(spec, a), _raw_limbs(spec, b)


@pytest.mark.parametrize("spec_name", ["fq381", "fq377"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_ff_op_matches_jax(spec_name, op):
    spec = SPECS[spec_name]
    a, b = _inputs(spec, 64, seed=3 * list(SPECS).index(spec_name) + ["mul", "add", "sub"].index(op))
    jfn = {"mul": jff.mont_mul, "add": jff.add, "sub": jff.sub}[op]
    tfn = {"mul": ff.mont_mul, "add": ff.add, "sub": ff.sub}[op]
    want = jff.to_ints(spec, jfn(spec, jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a.astype(np.int32))
    out = tfn(spec, ta, torch.from_numpy(b.astype(np.int32)))
    assert out.dtype == torch.int32 and out.shape == ta.shape
    # the lazy range holds: every output is below 2p
    vals = ff.limbs_to_ints(spec, out.T.numpy(), mont=False)
    assert max(vals) < 2 * spec.modulus
    assert ff.to_ints(spec, out) == want


def test_ff_chained_ops_match_host():
    spec = FP.FQ_BLS12_381
    rng = np.random.default_rng(5)
    ints_a = [int.from_bytes(rng.bytes(48), "little") % spec.modulus for _ in range(32)]
    ints_b = [int.from_bytes(rng.bytes(48), "little") % spec.modulus for _ in range(32)]
    A = ff.from_ints(spec, ints_a, device="cpu")
    B = ff.from_ints(spec, ints_b, device="cpu")
    x = ff.mont_mul(spec, A, B)
    host = [a * b % spec.modulus for a, b in zip(ints_a, ints_b)]
    for _ in range(3):
        x = ff.mont_mul(spec, ff.add(spec, x, A), ff.sub(spec, x, B))
        host = [((h + a) * (h - b)) % spec.modulus for h, a, b in zip(host, ints_a, ints_b)]
    assert ff.to_ints(spec, x) == host


def test_ff_canonicalize_and_is_zero():
    spec = FP.FQ_BLS12_377
    vals = [0, spec.modulus, 1, spec.modulus + 1, 2 * spec.modulus - 1]
    t = torch.from_numpy(_raw_limbs(spec, vals).astype(np.int32))
    canon = ff.limbs_to_ints(spec, ff.canonicalize(spec, t).T.numpy(), mont=False)
    assert canon == [v % spec.modulus for v in vals]
    assert ff.is_zero(spec, t).tolist() == [True, True, False, False, False]


def test_ff_refuses_bad_operands():
    spec = FP.FQ_BLS12_381
    good = ff.zeros(spec, 4, "cpu")
    with pytest.raises(ValueError):
        ff.mont_mul(spec, good.long(), good.long())
    with pytest.raises(ValueError):
        ff.add(spec, good[:16].contiguous(), good[:16].contiguous())
    with pytest.raises(ValueError):
        ff.sub(spec, good.T.contiguous().T, good)
    # neither CPU nor CUDA: no plain fallback, the wrapper refuses
    meta = torch.empty((spec.n_limbs, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ff.mont_mul(spec, meta, meta)


@pytest.mark.parametrize("spec_name", ["fq381", "fr381"])
def test_mont_pow_and_batch_inv_match_jax_ff_inv(spec_name):
    """ff.mont_pow (the plain version of the one-launch Fermat chain) and
    ff.batch_inv against the JAX package's lax.scan chain
    (msm_tpu._ff_inv) and host inverses; column 0 is zero."""
    from poly_commit_tpu.core import msm_tpu

    spec = SPECS[spec_name]
    p = spec.modulus
    rng = np.random.default_rng(31 + list(SPECS).index(spec_name))
    vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(2 * spec.n_limbs), "little") % p
                            for _ in range(9)]
    limbs = np.ascontiguousarray(ff.ints_to_limbs(spec, vals).T)  # (L, M) Montgomery
    want = [pow(v, -1, p) if v else 0 for v in vals]
    assert jff.to_ints(spec, msm_tpu._ff_inv(spec, jnp.asarray(limbs.astype(np.uint32)))) == want
    a = torch.from_numpy(limbs.astype(np.int32))
    assert ff.to_ints(spec, ff.mont_pow(spec, a, p - 2)) == want
    assert ff.to_ints(spec, ff.plain_pow(spec, a, p - 2)) == want
    assert ff.to_ints(spec, ff.batch_inv(spec, a)) == want
    assert ff.to_ints(spec, ff.mont_pow(spec, a, 0)) == [1] * len(vals)
    assert ff.to_ints(spec, ff.mont_pow(spec, a, 5)) == [pow(v, 5, p) for v in vals]


INV_SPECS = {"fq381": FP.FQ_BLS12_381, "fr381": FP.FR_BLS12_381, "fr_bn254": FP.FR_BN254,
             "fr_jubjub": FP.FR_JUBJUB}


@functools.lru_cache(maxsize=None)
def _jax_inverses(spec_name):
    """Twelve values (0, 1 and p - 1 among them) and their inverses from the
    JAX package's lax.scan chain (msm_tpu._ff_inv), at the (L, 12) shape the
    test above also runs."""
    from poly_commit_tpu.core import msm_tpu

    spec = INV_SPECS[spec_name]
    p = spec.modulus
    rng = np.random.default_rng(61 + list(INV_SPECS).index(spec_name))
    vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(2 * spec.n_limbs), "little") % p
                            for _ in range(9)]
    limbs = np.ascontiguousarray(ff.ints_to_limbs(spec, vals).T)
    return vals, jff.to_ints(spec, msm_tpu._ff_inv(spec, jnp.asarray(limbs.astype(np.uint32))))


@pytest.mark.parametrize("spec_name", list(INV_SPECS))
@pytest.mark.parametrize("m", [1, 3, 64, 1000, "all_zero"])
def test_batch_inv_matches_jax(spec_name, m):
    """ff.batch_inv (on the CPU, its plain version) against the JAX
    package's inverses: M columns drawn from the twelve values, column 0
    zero, on canonical and on lazy operands (each value plus p)."""
    spec = INV_SPECS[spec_name]
    vals, inv = _jax_inverses(spec_name)
    assert inv == [pow(v, -1, spec.modulus) if v else 0 for v in vals]
    if m == "all_zero":
        idx = [0] * 5
    else:
        idx = np.random.default_rng(m).integers(0, len(vals), m).tolist()
        idx[0] = 0
    a = ff.from_ints(spec, [vals[i] for i in idx], device="cpu")
    p_limbs = ff.consts(spec, "cpu", 0).to(torch.int32).expand_as(a).contiguous()
    lazy = ff.plain("add", spec, a, p_limbs)
    assert bool((lazy != a).any(0).all()) and torch.equal(ff.canonicalize(spec, lazy), a)
    for x in (a, lazy):
        got = ff.batch_inv(spec, x)
        assert got.shape == x.shape and got.dtype == torch.int32
        assert ff.to_ints(spec, got) == [inv[i] for i in idx]


@pytest.mark.parametrize("spec_name", ["fq381", "fr_jubjub"])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 64, 1000])
def test_fsum_matches_host(spec_name, n):
    """ff.fsum (on the CPU, its plain version) of N lazy columns (values
    in [0, 2p), both encodings of zero among them) against the host sum."""
    spec = INV_SPECS[spec_name]
    rng = np.random.default_rng(70 + n)
    nb = 2 * spec.n_limbs + 8
    ints = [int.from_bytes(rng.bytes(nb), "little") % (2 * spec.modulus) for _ in range(n)]
    if n > 2:
        ints[1], ints[2] = 0, spec.modulus
    a = torch.from_numpy(_raw_limbs(spec, ints).astype(np.int32)).reshape(spec.n_limbs, n)
    got = ff.fsum(spec, a)
    assert got.shape == (spec.n_limbs, 1) and got.dtype == torch.int32
    assert ff.limbs_to_ints(spec, got.T.numpy(), mont=False) == [sum(ints) % spec.modulus]
    assert ff.limbs_to_ints(spec, ff.fsum_plain(spec, a).T.numpy(), mont=False) == [
        sum(ints) % spec.modulus]


@pytest.mark.parametrize("fn", ["batch_inv", "fsum"])
@pytest.mark.parametrize("case", ["dtype", "limb_rows", "not_contiguous", "device"])
def test_batch_inv_and_fsum_refuse_bad_operands(fn, case):
    spec = FP.FR_BLS12_381
    good = ff.zeros(spec, 4, "cpu")
    bad = {"dtype": good.long(), "limb_rows": good[:8].contiguous(),
           "not_contiguous": good.T.contiguous().T,
           # neither CPU nor CUDA: no plain fallback, the wrapper refuses
           "device": torch.empty((spec.n_limbs, 4), dtype=torch.int32, device="meta")}[case]
    with pytest.raises(ValueError):
        getattr(ff, fn)(spec, bad)


def test_mont_pow_refuses_bad_exponents():
    spec = FP.FR_BLS12_381
    a = ff.one_mont(spec, 3, "cpu")
    for e in (-1, 1 << 384):
        with pytest.raises(ValueError):
            ff.mont_pow(spec, a, e)
    with pytest.raises(ValueError):
        ff.mont_pow(spec, a.long(), 3)
    meta = torch.empty((spec.n_limbs, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ff.mont_pow(spec, meta, 3)


@pytest.mark.parametrize("spec_name", ["fr381", "fq377"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_field_binary_matches_jax(spec_name, op):
    spec = SPECS[spec_name]
    rng = np.random.default_rng(11)
    a = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(3 * 5)]
    b = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(5)]
    ja = jfield.from_ints(spec, np.asarray(a, dtype=object).reshape(3, 5))
    jb = jfield.from_ints(spec, b)
    want = jfield.to_ints(spec, getattr(jfield, op)(spec, ja, jb))  # broadcasts (5,)
    ta = field.from_ints(spec, a, device="cpu").reshape(3, 5, spec.n_limbs)
    tb = field.from_ints(spec, b, device="cpu")
    got = field.to_ints(spec, getattr(field, op)(spec, ta, tb))
    assert got == want


@pytest.mark.parametrize("spec_name", ["fr381", "fq381"])
def test_field_unary_matches_jax(spec_name):
    spec = SPECS[spec_name]
    rng = np.random.default_rng(12)
    xs = [0, 1] + [int.from_bytes(rng.bytes(48), "little") % spec.modulus for _ in range(4)]
    jx = jfield.from_ints(spec, xs)
    tx = field.from_ints(spec, xs, device="cpu")
    for jop, top in ((jfield.neg, field.neg), (jfield.inv, field.inv),
                     (jfield.mont_sqr, field.mont_sqr)):
        assert field.to_ints(spec, top(spec, tx)) == jfield.to_ints(spec, jop(spec, jx))
    # Montgomery conversions agree limb for limb
    assert np.array_equal(field.from_mont(spec, tx).numpy(),
                          np.asarray(jfield.from_mont(spec, jx)).astype(np.int32))
    assert np.array_equal(field.to_mont(spec, field.from_mont(spec, tx)).numpy(), tx.numpy())
    assert np.array_equal(tx.numpy(), np.asarray(jx).astype(np.int32))
    assert field.to_ints(spec, field.pow(spec, tx, 5)) == [pow(v, 5, spec.modulus) for v in xs]


@pytest.mark.parametrize("spec_name", ["fr381", "fq381"])
def test_field_pow_takes_exponents_past_the_kernel_width(spec_name):
    """field.pow reduces an exponent of 384 bits or more before the kernel;
    a multiple of p - 1 still sends zero to zero and the rest to one."""
    spec = SPECS[spec_name]
    p = spec.modulus
    rng = np.random.default_rng(13)
    xs = [0, 1, p - 1] + [int.from_bytes(rng.bytes(48), "little") % p for _ in range(3)]
    tx = field.from_ints(spec, xs, device="cpu")
    for e in ((p - 1) << 300, (1 << 400) + 3, (1 << 384) - 1):
        assert field.to_ints(spec, field.pow(spec, tx, e)) == [pow(v, e, p) for v in xs]
    with pytest.raises(ValueError):
        field.pow(spec, tx, -1)


def test_conversions_roundtrip():
    spec = FP.FR_BLS12_377
    ints = [0, 1, spec.modulus - 1, 12345678901234567890, spec.modulus + 7]
    t = field.from_ints(spec, ints, device="cpu")
    assert field.to_ints(spec, t) == [v % spec.modulus for v in ints]
    plain = field.from_ints(spec, ints, mont=False, device="cpu")
    assert field.to_ints(spec, plain, mont=False) == [v % spec.modulus for v in ints]
    lf = ff.from_ints(spec, ints, device="cpu")
    assert torch.equal(ff.from_field_last(t), lf)
    assert torch.equal(ff.to_field_last(lf, (5,)), t)

