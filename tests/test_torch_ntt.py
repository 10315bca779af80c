"""The PyTorch port's NTT (core/ntt.py, core/ntt_lf.py) against the JAX package.

The port runs on the CPU, where each of its NTT kernels (K4a butterfly,
K4b fused stages, K4c stage) is its plain PyTorch version; the JAX package
runs its CPU routes (its limbs-first NTT takes its non-Pallas butterfly
graph there). Inputs are canonical ints from a numpy seed, and outputs are
compared as canonical ints, exactly.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import poly_commit_tpu.core.ff as jff  # noqa: E402
import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.ntt as jNTT  # noqa: E402
import poly_commit_tpu.core.ntt_lf as jLF  # noqa: E402
from poly_commit_tpu.core.field_params import FR_BLS12_381 as J381  # noqa: E402
from poly_commit_tpu.core.field_params import FR_BN254 as J254  # noqa: E402
from poly_commit_tpu_torch.core import ff, ntt_lf  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core import ntt as NTT  # noqa: E402
from poly_commit_tpu_torch.core.field_params import FR_BLS12_381, FR_BN254, FQ_BLS12_381  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SPECS = {"fr_bls12_381": (FR_BLS12_381, J381), "fr_bn254": (FR_BN254, J254)}


def _ints(spec, n, seed, bound=None):
    """n ints below ``bound`` (default p) from a numpy seed."""
    rng = np.random.default_rng(seed)
    bound = bound or spec.modulus
    return [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]


def _lf(spec, ints):
    """ints -> port (L, N) Montgomery limbs on the CPU."""
    return ff.from_ints(spec, ints, device="cpu")


def _raw(spec, ints):
    """ints below R, unreduced -> (L, N) uint32 limbs (the JAX layout)."""
    data = b"".join(v.to_bytes(2 * spec.n_limbs, "little") for v in ints)
    return np.ascontiguousarray(np.frombuffer(data, "<u2").reshape(-1, spec.n_limbs).T.astype(np.uint32))


def _port(arr):
    return torch.from_numpy(arr.astype(np.int32))


def _horner(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("log_n", [3, 6])
@pytest.mark.parametrize("batch", [None, 2], ids=["single", "batched"])
def test_field_last_ntt_matches_jax(field, log_n, batch):
    spec, jspec = SPECS[field]
    n = 1 << log_n
    rows = [_ints(spec, n, seed=10 * log_n + r) for r in range(batch or 1)]
    ints = rows if batch else rows[0]
    ev = NTT.ntt(spec, F.from_ints(spec, ints, device="cpu") if not batch
                 else F.from_ints(spec, sum(rows, []), device="cpu").reshape(batch, n, -1))
    j_ev = jNTT.ntt(jspec, jF.from_ints(jspec, ints))
    assert F.to_ints(spec, ev) == jF.to_ints(jspec, j_ev)
    back = NTT.intt(spec, ev)
    assert F.to_ints(spec, back) == jF.to_ints(jspec, jNTT.intt(jspec, j_ev)) == ints
    # forward values are evaluations at w^i
    w = NTT.domain(spec, log_n)["omega"]
    got = F.to_ints(spec, ev)
    first = got[0] if batch else got
    for i in (0, 1, n // 2, n - 1):
        assert first[i] == _horner(rows[0], pow(w, i, spec.modulus), spec.modulus)


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_twiddles_match_jax(field, inverse):
    spec, jspec = SPECS[field]
    log_n = 6
    got = NTT.stage_twiddles(spec, log_n, inverse, "cpu")
    want = jLF._twiddles_lf(jspec, log_n, inverse)
    assert len(got) == len(want) == log_n
    for g, w in zip(got, want):
        assert ff.to_ints(spec, g) == jff.to_ints(jspec, w)


@functools.lru_cache(maxsize=None)
def _seeded(field, log_n, rows):
    """The seeded input of (field, log_n, rows) and the JAX limbs-first
    NTT of it (computed once: each shape is a JAX compile)."""
    spec, jspec = SPECS[field]
    ints = _ints(spec, rows << log_n, seed=100 * log_n + rows)
    return ints, jff.to_ints(jspec, jLF.ntt(jspec, jff.from_ints(jspec, ints), rows=rows))


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("rows", [1, 4])
def test_limbs_first_ntt_matches_jax(field, rows):
    spec, _ = SPECS[field]
    ints, want = _seeded(field, 4, rows)
    got = ntt_lf.ntt(spec, _lf(spec, ints), rows=rows)
    assert ff.to_ints(spec, got) == want
    assert ff.to_ints(spec, ntt_lf.intt(spec, got, rows=rows)) == ints


@pytest.mark.parametrize("field", list(SPECS))
def test_butterfly_plain_matches_jax_kernel_graph(field):
    """K4a's plain version against ntt_lf._butterfly_fn, inputs in [0, 2p)."""
    spec, jspec = SPECS[field]
    n_half = 300
    u, w, t = (_ints(spec, n_half, seed=s, bound=2 * spec.modulus) for s in (1, 2, 3))
    lo, hi = ntt_lf.butterfly(spec, *(_port(_raw(spec, x)) for x in (u, w, t)))
    jlo, jhi = jLF._butterfly_fn(jspec, n_half, False)(*(jnp.asarray(_raw(spec, x)) for x in (u, w, t)))
    assert ff.to_ints(spec, lo, mont=False) == jff.to_ints(jspec, jlo, mont=False)
    assert ff.to_ints(spec, hi, mont=False) == jff.to_ints(jspec, jhi, mont=False)
    for x in (lo, hi):  # lazily reduced, like the JAX kernel
        assert max(ff.limbs_to_ints(spec, x.T.numpy(), mont=False)) < 2 * spec.modulus


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("block", [4, 8, 64], ids=["k4b2_k4c2", "k4b3_k4c1", "k4b_all_stages"])
def test_fused_route_matches_butterfly_route_and_jax(field, block, monkeypatch):
    """The K4b + K4c route (plain versions; the fused route opened to this
    small array, and a small block so that K4c runs) equals the K4a route
    and the JAX package."""
    spec, _ = SPECS[field]
    log_n, rows = 4, 4
    ints, want = _seeded(field, log_n, rows)
    a = _lf(spec, ints)
    monkeypatch.setattr(ntt_lf, "FUSED_MIN_TOTAL", a.shape[1])
    monkeypatch.setattr(ntt_lf, "FUSE_BLOCK", block)
    fused = ntt_lf.transform(spec, a, rows, False)
    monkeypatch.setattr(ntt_lf, "FUSED_MIN_TOTAL", 1 << 30)  # every stage through K4a
    by_butterfly = ntt_lf.transform(spec, a, rows, False)
    assert ff.to_ints(spec, fused) == ff.to_ints(spec, by_butterfly) == want


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("log_n,rows", [(12, 1), (10, 2)], ids=["k4b11_k4c1", "k4b_all_stages"])
def test_default_fused_route_matches_field_last(field, log_n, rows):
    """At the route's own threshold and block (2^11): the limbs-first NTT
    and iNTT equal the portable field-last route, tested against JAX above."""
    spec, _ = SPECS[field]
    ints = _ints(spec, rows << log_n, seed=log_n)
    a = _lf(spec, ints)
    assert a.shape[1] >= ntt_lf.FUSED_MIN_TOTAL
    got = ntt_lf.ntt(spec, a, rows=rows)
    fl = NTT.ntt(spec, F.from_ints(spec, ints, device="cpu").reshape(rows, 1 << log_n, -1))
    assert ff.to_ints(spec, got) == F.to_ints(spec, fl.reshape(-1, spec.n_limbs))
    assert ff.to_ints(spec, ntt_lf.intt(spec, got, rows=rows)) == ints


@pytest.mark.parametrize("field", list(SPECS))
def test_fused_and_stage_plain_split_at_the_block(field):
    """K4b over log2(B) stages then K4c for the rest equals K4c stage by
    stage from the start, on inputs in [0, 2p)."""
    spec, _ = SPECS[field]
    log_n, rows, block = 7, 2, 32
    a = _port(_raw(spec, _ints(spec, rows << log_n, seed=5, bound=2 * spec.modulus)))
    tws = NTT.stage_twiddles(spec, log_n, False, "cpu")
    x = ntt_lf.fused_stages(spec, a, ntt_lf.fused_table(tws, 5), 5, block)
    y = a
    for s in range(log_n):
        if s >= 5:
            x = ntt_lf.stage(spec, x, tws[s], s)
        y = ntt_lf.stage(spec, y, tws[s], s)
    assert torch.equal(ff.canonicalize(spec, x), ff.canonicalize(spec, y))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    spec = FR_BN254
    a = ff.zeros(spec, 64, "cpu")
    tws = NTT.stage_twiddles(spec, 6, False, "cpu")
    with pytest.raises(ValueError):  # 2^3 stages do not fit in a block of 4
        ntt_lf.fused_stages(spec, a, ntt_lf.fused_table(tws, 3), 3, 4)
    with pytest.raises(ValueError):  # the table must hold exactly the stages run
        ntt_lf.fused_stages(spec, a, ntt_lf.fused_table(tws, 3), 2, 8)
    with pytest.raises(ValueError):  # stage twiddles of the wrong stage
        ntt_lf.stage(spec, a, tws[2], 3)
    with pytest.raises(ValueError):  # 12-word fields take no NTT
        ntt_lf.ntt(FQ_BLS12_381, ff.zeros(FQ_BLS12_381, 8, "cpu"))
    with pytest.raises(ValueError):  # rows must split the array
        ntt_lf.ntt(spec, a, rows=3)
    assert [w.launches for w in ntt_lf.WRAPPERS] == [0, 0, 0, 0]  # the CPU launches nothing


def _host_stages(spec, vals, tws, s0):
    """Radix-2 stages s0 .. s0 + len(tws) - 1 on host ints: stage s pairs j
    with j + 2^s in every 2^(s+1)-run, (u + w t, u - w t) mod p with t the
    stage's twiddle at j mod 2^s."""
    p, vals = spec.modulus, list(vals)
    for k, tw in enumerate(tws):
        half = 1 << (s0 + k)
        for start in range(0, len(vals), 2 * half):
            for j in range(half):
                u, w = vals[start + j], vals[start + j + half] * tw[j]
                vals[start + j], vals[start + j + half] = (u + w) % p, (u - w) % p
    return vals


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_stages_plain_matches_host_stages(field, rows, r):
    """K4c's r stages a launch (on the CPU, its plain version) against the
    same stages on host ints, stages s0 .. s0 + r - 1 of rows of 2^6, on
    inputs in [0, 2p); and ``stage``, its one-stage case, against the first
    of them."""
    spec, _ = SPECS[field]
    log_n, s0 = 6, 6 - r
    a = _port(_raw(spec, _ints(spec, rows << log_n, seed=7 + r, bound=2 * spec.modulus)))
    tws = NTT.stage_twiddles(spec, log_n, False, "cpu")
    vals = ff.to_ints(spec, a)
    host_tws = [ff.to_ints(spec, tw) for tw in tws[s0:]]
    want = _host_stages(spec, vals, host_tws, s0)
    assert ff.to_ints(spec, ntt_lf.stages(spec, a, tws[s0:], s0)) == want
    assert ff.to_ints(spec, ntt_lf.stages_plain(spec, a, tws[s0:], s0)) == want
    assert ff.to_ints(spec, ntt_lf.stage(spec, a, tws[s0], s0)) == _host_stages(spec, vals, host_tws[:1], s0)


@pytest.mark.parametrize("case", ["no_stages", "too_many_stages", "past_the_row", "wrong_twiddles",
                                  "negative_s0"])
def test_stages_refuse_bad_stage_ranges(case):
    spec = FR_BN254
    a = ff.zeros(spec, 1 << 8, "cpu")
    tws = NTT.stage_twiddles(spec, 8, False, "cpu")
    s0, stage_tws = {
        "no_stages": (1, ()),
        "too_many_stages": (0, tws[: ntt_lf.MAX_STAGES + 1]),
        "past_the_row": (7, tws[7:] + tws[:1]),  # stages 7 and 8 of 2^8 elements
        "wrong_twiddles": (3, (tws[3], tws[3])),
        "negative_s0": (-1, tws[:1]),
    }[case]
    with pytest.raises(ValueError):
        ntt_lf.stages(spec, a, stage_tws, s0)
    with pytest.raises(ValueError):
        ntt_lf.stages_plain(spec, a, stage_tws, s0)


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("log_n", range(1, 10))
def test_small_plain_matches_host_stages(field, log_n):
    """K4a's one-launch transform (on the CPU, its plain version) against
    all log2 n radix-2 stages on host ints, on one row and on as many rows
    as stay under 2^10 elements, inputs in [0, 2p)."""
    spec, _ = SPECS[field]
    tws = NTT.stage_twiddles(spec, log_n, False, "cpu")
    host_tws = [ff.to_ints(spec, tw) for tw in tws]
    for rows in sorted({1, (ntt_lf.FUSED_MIN_TOTAL - 1) >> log_n}):
        a = _port(_raw(spec, _ints(spec, rows << log_n, seed=20 + log_n, bound=2 * spec.modulus)))
        want = _host_stages(spec, ff.to_ints(spec, a), host_tws, 0)
        assert ff.to_ints(spec, ntt_lf.small(spec, a, tws)) == want
        assert ff.to_ints(spec, ntt_lf.small_plain(spec, a, tws)) == want


@pytest.mark.parametrize("field", list(SPECS))
def test_transform_below_1024_is_one_small_call(field, monkeypatch):
    """A transform under FUSED_MIN_TOTAL elements takes K4a's one call for
    all its stages (no one-stage butterflies) and equals the JAX package's
    limbs-first NTT (the shape test_limbs_first_ntt_matches_jax compiles)."""
    spec, _ = SPECS[field]
    ints, want = _seeded(field, 4, 4)
    calls = []
    small = ntt_lf.small
    monkeypatch.setattr(ntt_lf, "small", lambda *args: calls.append(args[1].shape) or small(*args))
    monkeypatch.setattr(ntt_lf, "butterfly", lambda *args: pytest.fail("one-stage route taken"))
    got = ntt_lf.ntt(spec, _lf(spec, ints), rows=4)
    assert calls == [(spec.n_limbs, 4 << 4)]
    assert ff.to_ints(spec, got) == want


@pytest.mark.parametrize("case", ["no_stages", "too_many_stages", "too_many_elements",
                                  "wrong_twiddles", "rows_do_not_split", "dtype", "device"])
def test_small_refuses_what_the_kernel_does_not_take(case):
    spec = FR_BN254
    tws = NTT.stage_twiddles(spec, 10, False, "cpu")
    a = ff.zeros(spec, 64, "cpu")
    args = {"no_stages": (a, ()),
            "too_many_stages": (ff.zeros(spec, 1024, "cpu"), tws),
            "too_many_elements": (ff.zeros(spec, 2048, "cpu"), tws[:2]),
            "wrong_twiddles": (a, tws[1:3]),
            "rows_do_not_split": (ff.zeros(spec, 96, "cpu"), tws[:6]),
            "dtype": (a.long(), tws[:6]),
            # neither CPU nor CUDA: no plain fallback, the wrapper refuses
            "device": (a.to("meta"), [t.to("meta") for t in tws[:6]])}[case]
    with pytest.raises(ValueError):
        ntt_lf.small(spec, *args)
