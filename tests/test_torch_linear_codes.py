"""The PyTorch port's Ligero slice against the JAX package.

Both packages run the tests/harness.py round trips (setup -> commit ->
batch_open -> batch_check) from the same HostRng seed, so the Merkle roots,
the proofs (v, the queried columns, the Merkle paths, the well-formedness
vector), the opened values and the verdicts must be equal. The port runs
on the CPU, where its NTT kernels (K4a/K4b/K4c) and K1 are their plain
PyTorch versions. Also here: the Reed-Solomon encode against direct
evaluation, the multilinear helpers of core/poly.py, the column bytes taken
from the device and their hashes, the column-hash kernel's message layout
and refusals, a JAX commitment opened by the port (pcs/convert.py) and
Merkle tampering.
"""

import copy
import functools
import hashlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.poly as jP  # noqa: E402
import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
import poly_commit_tpu.pcs.linear_codes as jLC  # noqa: E402
from poly_commit_tpu.pcs.linear_codes import engine as jE  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.poly as tP  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.linear_codes as tLC  # noqa: E402
from poly_commit_tpu_torch.core import ff, serialize  # noqa: E402
from poly_commit_tpu_torch.core import ntt as tNTT  # noqa: E402
from poly_commit_tpu_torch.core.field_params import FQ_BLS12_381, FR_BLS12_381, FR_BN254  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
from poly_commit_tpu_torch.pcs import errors as terrors  # noqa: E402
from poly_commit_tpu_torch.pcs.linear_codes import engine as tE  # noqa: E402
from poly_commit_tpu_torch.pcs.linear_codes.ligero import LigeroPCParams, _rs_encode_rows  # noqa: E402
from poly_commit_tpu_torch.utils.merkle import MerkleTree, blake2s_columns, verify_path  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(F=jF, DS=jDS, T=jT, dev={}, PC={
    "univariate": jLC.UnivariateLigero, "multilinear": jLC.MultilinearLigero,
    "multilinear_bn254": jLC.MultilinearLigeroBN254})
PORT = types.SimpleNamespace(F=tF, DS=tDS, T=tT, dev={"device": "cpu"}, PC={
    "univariate": tLC.UnivariateLigero, "multilinear": tLC.MultilinearLigero,
    "multilinear_bn254": tLC.MultilinearLigeroBN254})
# scheme -> (template kwargs); degree 15 univariate, 4 variables multilinear
CASES = {
    "univariate_1poly_1point": ("univariate", dict(num_polys=1, num_points=1)),
    "univariate_2polys_2points": ("univariate", dict(num_polys=2, num_points=2)),
    "multilinear_1poly_1point": ("multilinear", dict(num_polys=1, num_points=1)),
    "multilinear_bn254_1poly_1point": ("multilinear_bn254", dict(num_polys=1, num_points=1)),
}
DEGREE, NUM_VARS = 15, 4


def _round_trip(pkg, scheme, num_polys, num_points, seed=7):
    """harness.run_template / run_ml_template's steps without hiding,
    returning everything they produce."""
    PC = pkg.PC[scheme]
    spec = PC.spec
    rng = pkg.DS.HostRng(seed)
    ml = scheme.startswith("multilinear")
    if ml:
        pp = PC.setup(0, num_vars=NUM_VARS, rng=rng, **pkg.dev)
    else:
        pp = PC.setup(DEGREE, rng=rng, **pkg.dev)
    ck, vk = PC.trim(pp, 0 if ml else DEGREE, 0, None)
    polys = []
    for i in range(num_polys):
        ints = rng.field_ints(spec, 1 << NUM_VARS if ml else DEGREE + 1)
        if not ml and ints[-1] == 0:
            ints[-1] = 1
        polys.append(pkg.DS.LabeledPolynomial(
            label=f"poly_{i}", poly=pkg.F.from_ints(spec, ints, **pkg.dev),
            num_vars=NUM_VARS if ml else None))
    comms, states = PC.commit(ck, polys, rng)
    query_set = set()
    for pi in range(num_points):
        point = (tuple(rng.field_int(spec) for _ in range(NUM_VARS)) if ml
                 else rng.field_int(spec))
        for lp in polys:
            query_set.add((lp.label, (f"pt_{pi}", point)))
    proofs, values = PC.batch_open(ck, polys, comms, query_set, pkg.T.PoseidonSponge(spec),
                                   states, rng)
    ok = PC.batch_check(vk, comms, query_set, values, proofs, pkg.T.PoseidonSponge(spec))
    return types.SimpleNamespace(PC=PC, ck=ck, vk=vk, polys=polys, comms=comms, states=states,
                                 query_set=query_set, values=values, proofs=proofs, ok=bool(ok),
                                 pkg=pkg)


@functools.lru_cache(maxsize=None)
def _both(case):
    scheme, kw = CASES[case]
    return _round_trip(JAX, scheme, **kw), _round_trip(PORT, scheme, **kw)


def _roots(res):
    return [(c.label, c.commitment.root, c.commitment.metadata.n_rows,
             c.commitment.metadata.n_cols, c.commitment.metadata.n_ext_cols) for c in res.comms]


def _proofs(res):
    """Every field of every proof, as plain ints and bytes."""
    return [[(p.opening.v, p.opening.columns,
              [(path.leaf_index, path.siblings) for path in p.opening.paths],
              p.well_formedness) for p in per_point] for per_point in res.proofs]


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_matches_jax(case):
    j, t = _both(case)
    assert _roots(t) == _roots(j)
    assert [s.leaves for s in t.states] == [list(s.leaves) for s in j.states]
    assert _proofs(t) == _proofs(j)
    assert t.values == j.values
    assert t.ok is True and j.ok is True


@pytest.mark.parametrize("case", ["univariate_1poly_1point", "multilinear_1poly_1point"])
def test_corrupted_value_rejected_by_both(case):
    for res in _both(case):
        key = sorted(res.values)[0]
        bad = dict(res.values)
        bad[key] = (bad[key] + 1) % res.PC.spec.modulus
        sponge = res.pkg.T.PoseidonSponge(res.PC.spec)
        assert not res.PC.batch_check(res.vk, res.comms, res.query_set, bad, res.proofs, sponge)


@pytest.mark.parametrize("case", ["univariate_2polys_2points", "multilinear_1poly_1point"])
def test_port_opens_jax_commitment(case):
    """The JAX commitment state, carried across by convert, is opened by
    the port; the JAX package's check accepts the port's proof, which
    equals the JAX package's own."""
    j, _ = _both(case)
    pp = convert.ligero_params_from_jax(j.ck, device="cpu")
    states = [convert.lincode_state_from_jax(s, device="cpu") for s in j.states]
    PC = PORT.PC[CASES[case][0]]
    polys = [tDS.LabeledPolynomial(lp.label, tF.from_ints(PC.spec, jF.to_ints(j.PC.spec, lp.poly),
                                                          device="cpu"), num_vars=lp.num_vars)
             for lp in j.polys]
    proofs, values = PC.batch_open(pp, polys, j.comms, j.query_set, tT.PoseidonSponge(PC.spec),
                                   states)
    assert values == j.values
    assert _proofs(types.SimpleNamespace(proofs=proofs)) == _proofs(j)
    assert j.PC.batch_check(j.vk, j.comms, j.query_set, values, proofs,
                            jT.PoseidonSponge(j.PC.spec))


@pytest.mark.parametrize("spec", [FR_BLS12_381, FR_BN254], ids=lambda s: s.name)
def test_reed_solomon_matches_direct_eval(spec):
    """RS encode == evaluation on the extended domain (utils.rs:300-326)."""
    rng = tDS.HostRng(1)
    msg_ints = rng.field_ints(spec, 8)
    msg = tF.from_ints(spec, msg_ints, device="cpu")[None]
    enc = _rs_encode_rows(msg, LigeroPCParams(spec=spec, rho_inv=4, device="cpu"))[0]
    w = tNTT.domain(spec, 5)["omega"]  # 8 * 4 = 32 points
    p = spec.modulus
    got = tF.to_ints(spec, enc)
    for i in [0, 1, 7, 31]:
        assert got[i] == sum(c * pow(w, i * k, p) for k, c in enumerate(msg_ints)) % p


def test_multilinear_helpers_match_jax():
    """mle_fold / mle_evaluate / eq_table / tensor_lsb, on K1's plain version."""
    spec = FR_BLS12_381
    rng = np.random.default_rng(3)
    table = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(1 << NUM_VARS)]
    point = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(NUM_VARS)]
    t, z = (tF.from_ints(spec, x, device="cpu") for x in (table, point))
    jt, jz = (jF.from_ints(spec, x) for x in (table, point))
    assert tF.to_ints(spec, tP.mle_fold(spec, t, z[0])) == jF.to_ints(spec, jP.mle_fold(spec, jt, jz[0]))
    assert tF.to_ints(spec, tP.mle_evaluate(spec, t, z)) == jF.to_ints(spec, jP.mle_evaluate(spec, jt, jz))
    assert tF.to_ints(spec, tP.eq_table(spec, z)) == jF.to_ints(spec, jP.eq_table(spec, jz))
    assert tF.to_ints(spec, tP.tensor_lsb(spec, z[:2])) == jF.to_ints(spec, jP.tensor_lsb(spec, jz[:2]))


@pytest.mark.parametrize("spec", [FR_BLS12_381, FR_BN254], ids=lambda s: s.name)
def test_column_bytes_from_the_device_match_field_to_bytes(spec):
    """column_leaves (one pass over the device tensor) hashes the bytes
    that _col_hash builds from Python ints, in both packages."""
    rng = tDS.HostRng(5)
    rows, cols = 3, 5
    ints = rng.field_ints(spec, rows * cols)
    ext = tF.from_ints(spec, ints, device="cpu").reshape(rows, cols, -1)
    raw = serialize.mont_limbs_to_bytes(spec, ff.from_ints(spec, ints, device="cpu"))
    assert [bytes(r) for r in raw] == [serialize.field_to_bytes(spec, v) for v in ints]
    by_col = [[ints[r * cols + c] for r in range(rows)] for c in range(cols)]
    assert tE.column_leaves(spec, ext) == [tE._col_hash(spec, col) for col in by_col]
    assert tE.column_leaves(spec, ext) == [jE._col_hash(spec, col) for col in by_col]
    assert tE._col_hash(spec, by_col[0]) == hashlib.blake2s(
        serialize.fields_to_bytes(spec, by_col[0])).digest()


def _lazy_mont_matrix(spec, ints, rows, cols, seed):
    """(rows, cols, L) int32 Montgomery limbs of ints (row-major), about
    half of them lifted by p into [p, 2p), the lazy form the kernels keep."""
    rnd = np.random.default_rng(seed)
    mont = [v * spec.R_mod_p % spec.modulus for v in ints]
    mont = [m + spec.modulus if lift else m for m, lift in zip(mont, rnd.random(len(mont)) < 0.5)]
    data = b"".join(m.to_bytes(2 * spec.n_limbs, "little") for m in mont)
    limbs = np.frombuffer(data, "<u2").astype(np.int32).reshape(rows, cols, spec.n_limbs)
    return torch.from_numpy(limbs.copy())


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("spec", [FR_BLS12_381, FR_BN254], ids=lambda s: s.name)
def test_column_leaves_on_cpu_match_hashlib(spec, rows):
    """The CPU route of column_leaves (column_bytes, then hashlib) on lazy
    Montgomery limbs, 0 and p - 1 among them: a half block, one block and
    one block and a half a column, each digest hashlib's Blake2s of the
    column's fields_to_bytes."""
    rng = tDS.HostRng(6 + rows)
    cols = 4
    ints = rng.field_ints(spec, rows * cols)
    ints[0], ints[-1] = 0, spec.modulus - 1
    ext = _lazy_mont_matrix(spec, ints, rows, cols, rows)
    by_col = [[ints[r * cols + c] for r in range(rows)] for c in range(cols)]
    want = [hashlib.blake2s(serialize.fields_to_bytes(spec, col)).digest() for col in by_col]
    assert tE.column_leaves(spec, ext) == want


@pytest.mark.parametrize("spec", [FR_BLS12_381, FR_BN254], ids=lambda s: s.name)
def test_packed_limb_words_are_field_to_bytes(spec):
    """The column-hash kernel's message layout: canonical 16-bit limbs
    packed in pairs into little-endian 32-bit words (limb 2k low, 2k + 1
    high, as fe_load_packed packs them) are field_to_bytes of the value."""
    ints = tDS.HostRng(9).field_ints(spec, 6) + [0, 1, spec.modulus - 1]
    limbs = ff.from_ints(spec, ints, mont=False, device="cpu").T.numpy().astype(np.uint32)
    words = limbs[:, 0::2] | (limbs[:, 1::2] << 16)  # (N, 8)
    assert [w.astype("<u4").tobytes() for w in words] == [
        serialize.field_to_bytes(spec, v) for v in ints]


@pytest.mark.parametrize("case", ["fq_bls12_381", "shape", "dtype", "cpu_tensor"])
def test_blake2s_columns_refuses_what_the_kernel_does_not_take(case):
    """The card's column hash takes 16-limb fields of 32 serialized bytes,
    (n_rows, n_ext, 16) int32 limbs, on a CUDA device; anything else
    raises before a launch."""
    spec, shape, dtype = FR_BN254, (3, 5, 16), torch.int32
    if case == "fq_bls12_381":
        spec, shape = FQ_BLS12_381, (3, 5, 24)
    elif case == "shape":
        shape = (15, 16)
    elif case == "dtype":
        dtype = torch.int64
    with pytest.raises(ValueError):
        blake2s_columns(spec, torch.zeros(shape, dtype=dtype))
    assert blake2s_columns.launches == 0


def test_merkle_path_tamper_detected():
    leaves = [bytes([i]) * 8 for i in range(5)]
    tree = MerkleTree(leaves)
    path = tree.generate_proof(3)
    assert verify_path(path, tree.root, leaves[3])
    assert not verify_path(path, tree.root, leaves[2])
    bad = copy.deepcopy(path)
    bad.siblings[0] = b"corrupt"
    assert not verify_path(bad, tree.root, leaves[3])
    bad = copy.deepcopy(path)
    bad.leaf_index = 2
    assert not verify_path(bad, tree.root, leaves[3])


def test_tampered_column_rejected():
    """A queried column changed in the proof fails its Merkle path."""
    _, t = _both("multilinear_1poly_1point")
    proofs = copy.deepcopy(t.proofs)
    col = proofs[0][0].opening.columns[0]
    col[0] = (col[0] + 1) % t.PC.spec.modulus
    with pytest.raises(terrors.InvalidCommitment):
        t.PC.batch_check(t.vk, t.comms, t.query_set, t.values, proofs, tT.PoseidonSponge(t.PC.spec))
