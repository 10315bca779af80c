"""The PyTorch port's BLS12-381 pairing (poly_commit_tpu_torch.core.pairing)
on the CPU, against tests/ref_pairing.py (the exact Python-int model the
JAX package's own pairing test uses) and the JAX module's eager Fq12
product and line.

Inputs are made from a seed; every comparison is exact (tolerance 0). The
JAX module's jitted ``miller_loop`` and ``final_exponentiation`` are not
used. A whole final exponentiation takes ~30 s on this CPU, so the
dispatch tests replace it with the reference model and reuse the one
Miller-loop batch the file computes; the card's tests
(tests/test_torch_gpu.py, and tests/test_torch_gpu_paths.py as Marlin's
and MultilinearPC's verifier) run it whole.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from poly_commit_tpu.core import pairing as jP  # noqa: E402
from poly_commit_tpu_torch.core import curve as C  # noqa: E402
from poly_commit_tpu_torch.core import extfield as E2  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core import hostec  # noqa: E402
from poly_commit_tpu_torch.core import pairing as PR  # noqa: E402
from poly_commit_tpu_torch.pcs import kzg10  # noqa: E402
from poly_commit_tpu_torch.pcs.curve_ctx import CTX_BLS12_377, CTX_BLS12_381  # noqa: E402

from tests import ref_pairing as RP  # noqa: E402

pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SPEC = PR.SPEC
L = SPEC.n_limbs


def _f12_ints(rnd):
    return [(rnd.randrange(RP.P), rnd.randrange(RP.P)) for _ in range(6)]


def _f12(values) -> torch.Tensor:
    """[(c0, c1)] * 6 (or a list of them) -> (..., 6, 2, L) on the CPU."""
    flat = values if isinstance(values[0], tuple) else [c for v in values for c in v]
    t = E2.from_ints(SPEC, flat, device="cpu")
    return t.reshape(6, 2, L) if isinstance(values[0], tuple) else t.reshape(-1, 6, 2, L)


def _points(k1, k2, group1=C.BLS12_381_G1, group2=C.BLS12_381_G2):
    h1, h2 = hostec.host_group(group1), hostec.host_group(group2)
    return h1.mul((group1.gen_x, group1.gen_y), k1), h2.mul((group2.gen_x, group2.gen_y), k2)


@pytest.mark.parametrize("op", ["mul", "sqr", "conj"])
def test_f12_ops_match_reference(op):
    rnd = random.Random(["mul", "sqr", "conj"].index(op))
    a = [_f12_ints(rnd) for _ in range(3)]
    b = [_f12_ints(rnd) for _ in range(3)]
    ta, tb = _f12(a), _f12(b)
    got = {"mul": lambda: PR.f12_mul(ta, tb), "sqr": lambda: PR.f12_sqr(ta),
           "conj": lambda: PR.f12_conj(ta)}[op]()
    want = {"mul": lambda x, y: RP.f12_mul(x, y), "sqr": lambda x, y: RP.f12_mul(x, x),
            "conj": lambda x, y: RP.f12_conj(x)}[op]
    assert got.shape == (3, 6, 2, L)
    for i in range(3):
        assert PR.f12_to_ints(got[i]) == want(a[i], b[i])


def test_f12_mul_matches_jax_eager():
    rnd = random.Random(11)
    a, b = _f12_ints(rnd), _f12_ints(rnd)
    got = PR.f12_mul(_f12(a), _f12(b))
    ja, jb = (jnp.asarray(_f12(v).numpy().astype(np.uint32)) for v in (a, b))
    want = np.asarray(jP.f12_mul(ja, jb)).astype(np.int64)
    assert np.array_equal(got.numpy().astype(np.int64), want)
    assert PR.f12_to_ints(got) == RP.f12_mul(a, b)


@pytest.mark.parametrize("tangent", [True, False])
def test_line_matches_reference_and_jax(tangent):
    (xp, yp), (xq, yq) = _points(5, 7)
    _, (xt, yt) = _points(1, 11)
    p_xy = tuple(F.from_ints(SPEC, v, device="cpu") for v in (xp, yp))
    t = tuple(E2.from_int(SPEC, v, device="cpu") for v in (xt, yt))
    q = None if tangent else tuple(E2.from_int(SPEC, v, device="cpu") for v in (xq, yq))
    line, lam = PR._line(t, q, p_xy, tangent)
    want_line, want_lam = RP._line((xt, yt), None if tangent else (xq, yq), (xp, yp))
    assert PR.f12_to_ints(line) == want_line
    assert E2.to_int(SPEC, lam) == want_lam

    def jx(v):
        return jnp.asarray(v.numpy().astype(np.uint32))

    jline, jlam = jP._line(tuple(jx(v) for v in t), None if q is None else tuple(jx(v) for v in q),
                           tuple(jx(v) for v in p_xy), tangent)
    assert np.array_equal(line.numpy().astype(np.int64), np.asarray(jline).astype(np.int64))
    assert np.array_equal(lam.numpy().astype(np.int64), np.asarray(jlam).astype(np.int64))


@pytest.mark.parametrize("op", ["dbl", "mul_small", "mul_base", "pack", "select"])
def test_fq2_helpers_match_jax(op):
    """The Fq2Ops helpers the JAX pairing uses, on the port's extfield."""
    rnd = random.Random(["dbl", "mul_small", "mul_base", "pack", "select"].index(op))
    pairs = [(rnd.randrange(RP.P), rnd.randrange(RP.P)) for _ in range(4)]
    base = [rnd.randrange(RP.P) for _ in range(4)]
    a = E2.from_ints(SPEC, pairs, device="cpu")
    b = F.from_ints(SPEC, base, device="cpu")
    c = F.from_ints(SPEC, base[::-1], device="cpu")
    mask = torch.tensor([True, False, True, False])
    got = {"dbl": lambda: E2.dbl(SPEC, a), "mul_small": lambda: E2.mul_small(SPEC, a, 3),
           "mul_base": lambda: E2.mul_base(SPEC, a, b), "pack": lambda: E2.pack(b, c),
           "select": lambda: E2.select(mask, a, E2.pack(b, c))}[op]()

    def jx(t):
        return jnp.asarray(t.numpy().astype(np.uint32))

    F2 = jP.F2
    want = {"dbl": lambda: F2.dbl(jx(a)), "mul_small": lambda: F2.mul_small(jx(a), 3),
            "mul_base": lambda: F2.mul_base(jx(a), jx(b)), "pack": lambda: F2.pack(jx(b), jx(c)),
            "select": lambda: F2.select(jnp.asarray(mask.numpy()), jx(a), F2.pack(jx(b), jx(c)))}[op]()
    assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


@pytest.fixture(scope="module")
def miller_batch():
    """One batched Miller loop over (P, Q), (-P, Q) and (infinity, Q): each
    pair's row is its own loop, so row 0 is the one-pair case. The dispatch
    tests reuse these rows, so the file runs one CPU Miller loop (~21 s)."""
    p, q = _points(5, 7)
    neg_p = (p[0], (-p[1]) % RP.P)
    g1 = [(p[0], p[1], False), (neg_p[0], neg_p[1], False), (0, 0, True)]
    g2 = [(q[0], q[1], False)] * 3
    f = PR.miller_loop(C.affine_from_ints(C.BLS12_381_G1, g1, "cpu"),
                       C.affine_from_ints(C.BLS12_381_G2, g2, "cpu"))
    return g1, g2, f, [RP.miller_loop(p, q), RP.miller_loop(neg_p, q), RP.f12_one()]


@pytest.mark.parametrize("row", ["pair", "negated_pair", "infinity"])
def test_miller_loop_matches_reference(miller_batch, row):
    _, _, f, want = miller_batch
    i = ["pair", "negated_pair", "infinity"].index(row)
    assert f.shape == (3, 6, 2, L)
    assert PR.f12_to_ints(f[i]) == want[i]


def test_f12_pow_bits_matches_reference():
    rnd = random.Random(3)
    a = _f12_ints(rnd)
    e = rnd.getrandbits(64) | 1 << 63
    got = PR.f12_pow_bits(_f12(a), [int(b) for b in bin(e)[2:]])
    assert PR.f12_to_ints(got) == RP.f12_pow(a, e)
    assert PR.f12_to_ints(PR.f12_pow_bits(_f12(a), [0, 0])) == RP.f12_one()


def test_exponent_bits_are_the_jax_modules():
    assert list(PR.FE_BITS) == [int(b) for b in np.asarray(jP._FE_BITS)]
    assert list(PR.X_BITS) == [int(b) for b in np.asarray(jP._X_BITS)]
    assert PR.FINAL_EXP == RP.FINAL_EXP


@pytest.mark.parametrize("env,want", [(None, "host"), ("host", "host"), ("device", "device"),
                                      ("tpu", "host")])
def test_pairing_backend_reads_the_environment(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("POLY_COMMIT_PAIRING", raising=False)
    else:
        monkeypatch.setenv("POLY_COMMIT_PAIRING", env)
    assert kzg10.pairing_backend() == want


def _reuse_miller_rows(monkeypatch, miller_batch):
    """Stand the module's Miller loop in by the fixture's rows (the inputs
    must be rows of the fixture's batch) and its final exponentiation by the
    reference model; returns the list of final-exponentiation input shapes."""
    g1, g2, f, _ = miller_batch
    p_all = C.affine_from_ints(C.BLS12_381_G1, g1, "cpu")
    q_all = C.affine_from_ints(C.BLS12_381_G2, g2, "cpu")
    calls = []

    def miller_loop(p_aff, q_aff):
        rows = [next(i for i in range(len(g1))
                     if all(torch.equal(a[i], b[k]) for a, b in zip(p_all + q_all, p_aff + q_aff)))
                for k in range(p_aff[0].shape[0])]
        return f[rows]

    def final_exp(x):
        calls.append(x.shape)
        return _f12(RP.f12_pow(PR.f12_to_ints(x), RP.FINAL_EXP))

    monkeypatch.setattr(PR, "miller_loop", miller_loop)
    monkeypatch.setattr(PR, "final_exponentiation", final_exp)
    return calls


@pytest.mark.parametrize("case", ["valid", "tampered"])
def test_device_backend_sends_bls12_381_to_core_pairing(monkeypatch, miller_batch, case):
    """e(P, Q) e(-P, Q) == 1 (and e(P, Q)^2 != 1) through CurveCtx under
    POLY_COMMIT_PAIRING=device, prepared lines given (the device pairing
    ignores them, as JAX's does): the Miller values are the port's, the
    product tree and the check the module's, the final power the
    reference model's."""
    calls = _reuse_miller_rows(monkeypatch, miller_batch)
    monkeypatch.setenv("POLY_COMMIT_PAIRING", "device")
    g1, g2 = miller_batch[0], miller_batch[1]
    pairs = [g1[0], g1[1] if case == "valid" else g1[0]]
    ctx = CTX_BLS12_381
    got = ctx.pairing_product_is_one(pairs, g2[:2], prepared=[ctx.prepare_g2(g2[0])] * 2,
                                     device="cpu")
    assert got is (case == "valid")
    assert calls == [(6, 2, L)]


def test_pairing_check_padded_takes_device_points(monkeypatch, miller_batch):
    """kzg10.pairing_check_padded (the JAX name) on affine tensors, an
    infinite pair among them giving f = 1."""
    calls = _reuse_miller_rows(monkeypatch, miller_batch)
    g1, g2 = miller_batch[0], miller_batch[1]
    assert kzg10.pairing_check_padded(C.affine_from_ints(C.BLS12_381_G1, g1, "cpu"),
                                      C.affine_from_ints(C.BLS12_381_G2, g2, "cpu"))
    assert calls == [(6, 2, L)]


def test_device_backend_keeps_bls12_377_on_the_host_engine(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("BLS12-377 reached the device pairing")

    monkeypatch.setenv("POLY_COMMIT_PAIRING", "device")
    monkeypatch.setattr(PR, "miller_loop", refuse)
    ctx = CTX_BLS12_377
    p, q = _points(5, 7, ctx.g1, ctx.g2)
    neg_p = (p[0], (-p[1]) % ctx.g1.spec.modulus, False)
    assert ctx.pairing_product_is_one([(p[0], p[1], False), neg_p], [(q[0], q[1], False)] * 2)
    assert not ctx.pairing_product_is_one([(p[0], p[1], False)] * 2, [(q[0], q[1], False)] * 2)
