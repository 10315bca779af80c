"""The PyTorch port's schemes on a card, end to end, at the sizes of their
paths.

Each test drives one scheme's setup, commit, open and check on the card at
the size where the port's size-dependent routes all run: MSMs of 2^16
points and more at c = 16 and 2^20-point MSM chunks (Marlin, MultilinearPC,
IPA-PC, PST13, streaming KZG), msm_rows' chunks of rows (Hyrax at 22
variables), K4b with K4c's several stages a launch (a 2^22-point NTT, the
Ligero encodes), the log-depth division (streaming KZG). Each holds the
verifier's verdict, a tampered value or proof rejected, host evaluations
where no cell of the benchmark holds them, and the kernel wrappers'
``launches``: the kernels the path must launch, and the bounds that keep a
loop of launches in one (the G1 MSMs' scan, K4c, IPA's key fold and inner
products, the streaming divisions). The benchmark's cells hold the
commitments, openings and values of MarlinKZG10, Hyrax and multilinear
Ligero at these sizes against port_bench/reference/ (their ``correct``);
the tests here hold the rest.

Every test needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a GPU machine that has only
PyTorch (168 s on one H100):

    python -m pytest --noconftest -q tests/test_torch_gpu_paths.py
"""

import copy
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from poly_commit_tpu_torch.core import curve, ec_lf, ff, hostec, msm_gpu, ntt_lf, sort_gpu  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from poly_commit_tpu_torch.core import ntt as NTT  # noqa: E402
from poly_commit_tpu_torch.core import poly as P  # noqa: E402
from poly_commit_tpu_torch.core.transcript import PoseidonSponge  # noqa: E402
from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial  # noqa: E402
from poly_commit_tpu_torch.utils import merkle  # noqa: E402

LOG_DEGREE = 20  # the KZG paths' degree 2^20 - 1: Marlin's SRS in marlin.d20.proof9
NTT_LOG_N = 22
LIGERO_NUM_VARS = 22  # the top of arkworks' ligero_ml_times.rs
MLPC_NUM_VARS = 20
IPA_LOG_DEGREE = 16  # 2^16 coefficients: the key's MSMs at c = 16
BRAKEDOWN_NUM_VARS = 22  # the top of arkworks' brakedown_ml_times.rs
HYRAX_NUM_VARS = 22  # the top of arkworks' hyrax_times.rs: 2048 rows of 2048
PST13_NUM_VARS, PST13_DEGREE = 10, 12  # C(22, 12) = 646,646 SRS points
STREAM_POINTS, STREAM_CHUNK, STREAM_DEPTH = 3, 1 << 16, 16  # the most folds a chunk admits
MAX_PACKED_MADD_LAUNCHES = 8  # the G1 MSMs scan in madd_scan, not a loop of madds
MAX_K1_PER_COEFFICIENT = 0.1  # the streaming divisions run in log depth
ROW_LANES = (16, 32, 64, 128, 256)  # msm_rows' lanes a window, on one chunk of Hyrax's rows
# the kernels a path launches: fixed-base setup's madds and doublings, the
# MSMs' scan, lane tree and window fold, K3, and K1's products, adds and
# subtractions, powers and batched inversions (normalisation)
G1_KERNELS = ("ec_madd", "ec_madd_distinct", "ec_add", "ec_double", "ec_madd_scan",
              "ec_window_fold", "digit_sort")
G2_SETUP_KERNELS = ("ec_g2_madd", "ec_g2_madd_distinct", "ec_g2_double")
NORMALISE_KERNELS = ("ff_mont_mul", "ff_mont_pow", "ff_batch_inv")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _counts():
    """Every kernel wrapper's launches so far, by name (ff_mont_mul,
    ec_madd_scan, ec_g2_add, ec_ed_smul, digit_sort, ntt_stages,
    blake2s_columns, ...)."""
    wrappers = {**{f"ff_{w.__name__}": w for w in ff.WRAPPERS},
                **{f"ec_{w.__name__}": w
                   for w in ec_lf.WRAPPERS + ec_lf.G2_WRAPPERS + ec_lf.ED_WRAPPERS},
                "digit_sort": sort_gpu.digit_sort,
                **{f"ntt_{w.__name__}": w for w in ntt_lf.WRAPPERS},
                "blake2s_columns": merkle.blake2s_columns}
    return {name: w.launches for name, w in wrappers.items()}


def _since(before, *more):
    """Each wrapper's launches since ``before`` (a _counts()), plus those
    of ``more`` (earlier _since results)."""
    return {k: v - before[k] + sum(m[k] for m in more) for k, v in _counts().items()}


def _missing(launches, kernels):
    """The kernels among ``kernels`` that never launched."""
    return [k for k in kernels if not launches[k]]


def _field(spec, n, seed, device):
    """(n, L) Montgomery limbs of n random field elements, seeded."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t = torch.randint(0, 1 << 16, (n, spec.n_limbs), generator=gen, device=device, dtype=torch.int32)
    top = spec.modulus >> (16 * (spec.n_limbs - 1))
    t[:, -1] = torch.randint(0, top, (n,), generator=gen, device=device, dtype=torch.int32)
    return t


def _horner(ints, x, p):
    acc = 0
    for c in reversed(ints):
        acc = (acc * x + c) % p
    return acc


def _mle(ints, point, p):
    """The multilinear extension of the table ``ints`` at ``point``, folded
    on host ints, lowest variable first."""
    for z in point:
        ints = [(a + z * (b - a)) % p for a, b in zip(ints[0::2], ints[1::2])]
    return ints[0]


def _bump(values, p):
    return {k: (v + 1) % p for k, v in values.items()}


# -- MarlinKZG10 over BLS12-381 at degree 2^20 - 1 ----------------------------


@pytest.fixture(scope="module")
def marlin(cuda):
    """setup(2^20 - 1) -> trim with hiding bound 1 -> commit one hiding
    polynomial of that degree -> batch_open at one point, and the
    launches of the run."""
    from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10 as PC

    spec, degree = PC.spec, (1 << LOG_DEGREE) - 1
    before = _counts()
    rng = HostRng(1)
    pp = PC.setup(degree, rng=rng, device=cuda)
    ck, vk = PC.trim(pp, degree, 1)
    lp = LabeledPolynomial("p", _field(spec, degree + 1, 1, cuda), hiding_bound=1)
    comms, states = PC.commit(ck, [lp], rng)
    qs = {("p", ("z", rng.field_int(spec)))}
    proofs, values = PC.batch_open(ck, [lp], comms, qs, PoseidonSponge(spec), states, rng)
    return dict(PC=PC, pp=pp, vk=vk, comms=comms, qs=qs, proofs=proofs, values=values,
                launches=_since(before))


def _marlin_check(m, values):
    return bool(m["PC"].batch_check(m["vk"], m["comms"], m["qs"], values, m["proofs"],
                                    PoseidonSponge(m["PC"].spec)))


@pytest.mark.gpu
def test_marlin_batch_check_at_full_degree(marlin):
    """batch_check accepts the proof and rejects the value plus one; the
    run launched every kernel of the path, and its G1 MSMs scanned in
    madd_scan."""
    before = _counts()
    assert _marlin_check(marlin, marlin["values"])
    assert not _marlin_check(marlin, _bump(marlin["values"], marlin["PC"].spec.modulus))
    launches = _since(before, marlin["launches"])
    assert _missing(launches, G1_KERNELS + NORMALISE_KERNELS + ("ff_add", "ff_sub")) == []
    assert launches["ec_madd_distinct_packed"] <= MAX_PACKED_MADD_LAUNCHES


@pytest.mark.gpu
def test_marlin_bounded_on_the_full_degree_srs(cuda, marlin):
    """The same SRS trimmed with the degree bound 2^19 - 1: one hiding
    polynomial of that degree gets its shifted commitment, batch_check
    accepts its proof and rejects the value plus one."""
    PC, spec = marlin["PC"], marlin["PC"].spec
    bound = (1 << (LOG_DEGREE - 1)) - 1
    ck, vk = PC.trim(marlin["pp"], (1 << LOG_DEGREE) - 1, 1, [bound])
    lp = LabeledPolynomial("p", _field(spec, bound + 1, 11, cuda), degree_bound=bound,
                           hiding_bound=1)
    rng = HostRng(11)
    before = _counts()
    comms, states = PC.commit(ck, [lp], rng)
    qs = {("p", ("z", rng.field_int(spec)))}
    proofs, values = PC.batch_open(ck, [lp], comms, qs, PoseidonSponge(spec), states, rng)
    assert comms[0].commitment.shifted_comm is not None
    assert PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(spec))
    assert not PC.batch_check(vk, comms, qs, _bump(values, spec.modulus), proofs, PoseidonSponge(spec))
    assert _missing(_since(before), ("ec_madd_scan", "ec_add", "digit_sort", "ff_mont_mul")) == []


@pytest.mark.gpu
def test_marlin_check_on_the_device_pairing(marlin, monkeypatch):
    """POLY_COMMIT_PAIRING=device: batch_check's two pairs on the card's
    BLS12-381 pairing give the host engines' verdicts on the proof and on
    the value plus one."""
    bad = _bump(marlin["values"], marlin["PC"].spec.modulus)
    monkeypatch.setenv("POLY_COMMIT_PAIRING", "device")
    before = _counts()
    device = [_marlin_check(marlin, marlin["values"]), _marlin_check(marlin, bad)]
    launches = _since(before)
    monkeypatch.setenv("POLY_COMMIT_PAIRING", "host")
    host = [_marlin_check(marlin, marlin["values"]), _marlin_check(marlin, bad)]
    assert device == host == [True, False]
    assert _missing(launches, NORMALISE_KERNELS + ("ff_add", "ff_sub")) == []


# -- the NTT ------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("log_n", [NTT_LOG_N, 9], ids=["k4b_k4c", "k4a"])
def test_ntt_round_trip_against_host_horner(cuda, log_n):
    """A 2^22-point NTT over BN254 Fr (K4b, then K4c at up to six stages a
    launch) and a 2^9-point one (one K4a launch), and their inverses: the
    round trip, the portable field-last route and host Horner at four
    points."""
    spec, p, n = FP.FR_BN254, FP.FR_BN254.modulus, 1 << log_n
    a = _field(spec, n, log_n, cuda).T.contiguous()
    before = _counts()
    ev = ntt_lf.ntt(spec, a)
    back = ntt_lf.intt(spec, ev)
    launches = _since(before)
    assert torch.equal(ff.canonicalize(spec, back), ff.canonicalize(spec, a))
    portable = ff.from_field_last(NTT.ntt(spec, ff.to_field_last(a, (n,))))
    assert torch.equal(ff.canonicalize(spec, ev), ff.canonicalize(spec, portable))
    coeffs = ff.to_ints(spec, a)
    w = NTT.domain(spec, log_n)["omega"]
    idx = [0, 1, n // 2, n - 1]
    assert ff.to_ints(spec, ev[:, idx].contiguous()) == [_horner(coeffs, pow(w, i, p), p) for i in idx]
    assert launches["ntt_butterfly"] == 0 and launches["ff_mont_mul"] > 0
    if log_n == 9:
        assert launches["ntt_small"] == 2
    else:
        assert launches["ntt_fused_stages"] == 2
        assert 0 < launches["ntt_stages"] <= 2 * -(-(log_n - 11) // ntt_lf.MAX_STAGES)


# -- Ligero -------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["multilinear", "univariate"])
def test_ligero_round_trip(cuda, which):
    """MultilinearLigeroBN254 at 22 variables and UnivariateLigero over
    BLS12-381 Fr at degree 2^20 - 1: batch_check accepts and rejects the
    value plus one, the encode ran on K4b and K4c and the column hashes in
    one pc_blake2s_columns launch a commit. The univariate scheme's value
    is held against host Horner and its root against the commit's parts
    (encode, column bytes, hashlib's Blake2s, the Merkle tree); the
    multilinear scheme's are held by the cell ligero_ml.bn254.nv22.prove."""
    from poly_commit_tpu_torch.pcs import linear_codes as LC
    from poly_commit_tpu_torch.pcs.linear_codes import engine
    from poly_commit_tpu_torch.utils.merkle import MerkleTree, blake2s_hash

    ml = which == "multilinear"
    PC = LC.MultilinearLigeroBN254 if ml else LC.UnivariateLigero
    spec, p = PC.spec, PC.spec.modulus
    size = 1 << (LIGERO_NUM_VARS if ml else LOG_DEGREE)
    table = _field(spec, size, 3, cuda)
    rng = HostRng(3)
    before = _counts()
    if ml:
        pp = PC.setup(0, num_vars=LIGERO_NUM_VARS, rng=rng, device=cuda)
        lp = LabeledPolynomial("p", table, num_vars=LIGERO_NUM_VARS)
        point = tuple(rng.field_int(spec) for _ in range(LIGERO_NUM_VARS))
    else:
        pp = PC.setup(size - 1, rng=rng, device=cuda)
        lp = LabeledPolynomial("p", table)
        point = rng.field_int(spec)
    ck, vk = PC.trim(pp, 0 if ml else size - 1)
    comms, states = PC.commit(ck, [lp], rng)
    qs = {("p", ("z", point))}
    proofs, values = PC.batch_open(ck, [lp], comms, qs, PoseidonSponge(spec), states, rng)
    assert PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(spec))
    assert not PC.batch_check(vk, comms, qs, _bump(values, p), proofs, PoseidonSponge(spec))
    launches = _since(before)
    if not ml:
        assert values[("p", point)] == _horner(F.to_ints(spec, table), point, p)
        raw = engine.column_bytes(spec, PC.code.encode_rows(states[0].mat, ck))
        leaves = [blake2s_hash(c.tobytes()) for c in raw]
        assert MerkleTree(leaves, ck.merkle_config()).root == comms[0].commitment.root
    assert _missing(launches, ("ntt_fused_stages", "ntt_stages", "ff_mont_mul", "ff_add")
                    + (("ff_sub",) if ml else ())) == []
    assert launches["blake2s_columns"] == 1


# -- MultilinearPC over BLS12-381 at 20 variables -----------------------------


@pytest.mark.gpu
def test_multilinear_pc_round_trip(cuda, monkeypatch):
    """setup -> trim -> commit -> open (G2 MSMs of up to 2^19 points at
    c = 16) -> check at 20 variables: the card's MLE evaluation equals the
    host fold, check accepts the value and rejects the value plus one, on
    the host engine and (POLY_COMMIT_PAIRING=device) on the card's pairing,
    21 pairs."""
    from poly_commit_tpu_torch.pcs import multilinear_pc as ML

    spec, p, nv = ML.SPEC, ML.SPEC.modulus, MLPC_NUM_VARS
    table = _field(spec, 1 << nv, 5, cuda)
    rng = HostRng(5)
    before = _counts()
    ck, vk = ML.trim(ML.setup(nv, rng, device=cuda), nv)
    comm = ML.commit(ck, table)
    point = [rng.field_int(spec) for _ in range(nv)]
    proof = ML.open(ck, table, point)
    value = _mle(F.to_ints(spec, table), point, p)
    assert F.to_ints(spec, P.mle_evaluate(spec, table, F.from_ints(spec, point, device=cuda))) == value
    verdicts = {}
    for backend in ("host", "device"):
        monkeypatch.setenv("POLY_COMMIT_PAIRING", backend)
        verdicts[backend] = [bool(ML.check(vk, comm, point, v, proof)) for v in (value, (value + 1) % p)]
    assert verdicts == {"host": [True, False], "device": [True, False]}
    assert _missing(_since(before), G2_SETUP_KERNELS + NORMALISE_KERNELS + (
        "ec_g2_madd_distinct_packed", "ec_g2_add", "ec_madd_scan", "ec_add", "digit_sort")) == []


# -- InnerProductArgPC over JubJub at degree 2^16 - 1 -------------------------


@pytest.fixture(scope="module")
def ipa(cuda):
    """The key at degree 2^16 - 1 from 2^16 + 2 distinct generators (a walk
    a G + i b G on the host: the scheme's hash-to-curve, which only takes
    longer, is held on the CPU), trimmed with hiding bound 1, and one hiding
    polynomial committed; the launches of the run."""
    from poly_commit_tpu_torch.pcs import ipa_pc

    PC = ipa_pc.InnerProductArgPC
    degree = (1 << IPA_LOG_DEGREE) - 1
    hg = hostec.host_group(curve.JUBJUB)
    rnd = random.Random(6)
    gen = (curve.JUBJUB.gen_x, curve.JUBJUB.gen_y)
    step = hg.mul_fast(gen, rnd.randrange(1, curve.JUBJUB.scalar_spec.modulus))
    gens = [hg.mul_fast(gen, rnd.randrange(1, curve.JUBJUB.scalar_spec.modulus))]
    for _ in range(degree + 2):
        gens.append(hg.add(gens[-1], step))
    before = _counts()
    ck, vk = PC.trim(ipa_pc.params_from_generators(gens, cuda), degree, 1)
    rng = HostRng(6)
    lp = LabeledPolynomial("p", _field(PC.spec, degree + 1, 6, cuda), hiding_bound=1)
    comms, states = PC.commit(ck, [lp], rng)
    return dict(PC=PC, ck=ck, vk=vk, lp=lp, comms=comms, states=states, rng=rng,
                launches=_since(before))


@pytest.mark.gpu
def test_ipa_round_trip(ipa):
    """batch_open at one point -> batch_check: the value equals host
    Horner, the check accepts it and rejects the value plus one; each round's
    key fold is one ed_smul launch, each of its two inner products at most
    two ff_fsum launches."""
    PC, spec, p = ipa["PC"], ipa["PC"].spec, ipa["PC"].spec.modulus
    before = _counts()
    z = ipa["rng"].field_int(spec)
    qs = {("p", ("z", z))}
    proofs, values = PC.batch_open(ipa["ck"], [ipa["lp"]], ipa["comms"], qs, PoseidonSponge(spec),
                                   ipa["states"], ipa["rng"])
    assert PC.batch_check(ipa["vk"], ipa["comms"], qs, values, proofs, PoseidonSponge(spec))
    assert not PC.batch_check(ipa["vk"], ipa["comms"], qs, _bump(values, p), proofs,
                              PoseidonSponge(spec))
    launches = _since(before, ipa["launches"])
    assert values[("p", z)] == _horner(F.to_ints(spec, ipa["lp"].poly), z, p)
    rounds = len(proofs[0].l_vec)
    assert launches["ec_ed_smul"] == rounds
    assert launches["ff_fsum"] <= 2 * 2 * rounds
    assert _missing(launches, NORMALISE_KERNELS + (
        "ec_ed_madd_packed", "ec_ed_add", "digit_sort", "ff_add", "ff_fsum")) == []


@pytest.mark.gpu
def test_ipa_equation(cuda, ipa):
    """One equation a p + b p2 + c on the same key: open_combinations ->
    check_combinations accepts the value from host Horner and rejects it
    plus one."""
    from poly_commit_tpu_torch.pcs.data_structures import LinearCombination

    PC, spec, p = ipa["PC"], ipa["PC"].spec, ipa["PC"].spec.modulus
    lp = ipa["lp"]
    lp2 = LabeledPolynomial("p2", _field(spec, lp.poly.shape[0], 13, cuda), hiding_bound=1)
    rng = HostRng(13)
    comms2, states2 = PC.commit(ipa["ck"], [lp2], rng)
    a, b, c = (rng.field_int(spec) for _ in range(3))
    lc = LinearCombination("lc", [(a, "p"), (b, "p2"), (c, "one")])
    z = rng.field_int(spec)
    qs = {("lc", ("z", z))}
    value = (a * _horner(F.to_ints(spec, lp.poly), z, p)
             + b * _horner(F.to_ints(spec, lp2.poly), z, p) + c) % p
    comms, states = ipa["comms"] + comms2, ipa["states"] + states2
    proof = PC.open_combinations(ipa["ck"], [lc], [lp, lp2], comms, qs, PoseidonSponge(spec),
                                 states, rng)
    for v, want in ((value, True), ((value + 1) % p, False)):
        assert PC.check_combinations(ipa["vk"], [lc], comms, qs, {("lc", z): v}, proof,
                                     PoseidonSponge(spec)) is want


def _ipa_gadget(r1cs, inst, value, degree):
    """IpaSuccinctCheckGadget.succinct_check synthesised over one IPA-PC
    opening (tests/test_r1cs.py's circuit) with the claimed ``value``."""
    cs = r1cs.ConstraintSystem(FP.FR_BLS12_381)
    r = FP.JUBJUB_R
    proof = inst["proof"]
    comm_vars = [r1cs.TEPointVar.witness(cs, inst["comm"])]
    value_vars = [r1cs.NonNativeVar.witness(cs, r, value)]
    point_var = r1cs.NonNativeVar.witness(cs, r, inst["z"])
    h_var = r1cs.TEPointVar.witness(cs, inst["h"])
    frc = r1cs.NonNativeVar.witness(cs, r, inst["first_round"])
    pf = r1cs.IpaProofVar(
        l_vec=[r1cs.TEPointVar.witness(cs, pt) for pt in proof.l_vec],
        r_vec=[r1cs.TEPointVar.witness(cs, pt) for pt in proof.r_vec],
        final_comm_key=r1cs.TEPointVar.witness(cs, proof.final_comm_key),
        c=r1cs.NonNativeVar.witness(cs, r, proof.c))
    rand = r1cs.PCCheckRandomDataVar(
        opening_challenges=[r1cs.NonNativeVar.witness(cs, r, inst["ch"])],
        batching_rands=[r1cs.NonNativeVar.witness(cs, r, u) for u in inst["round_chs"]])
    r1cs.IpaSuccinctCheckGadget.succinct_check(cs, r, comm_vars, value_vars, point_var, h_var,
                                               frc, pf, rand, degree)
    return cs


@pytest.mark.gpu
def test_r1cs_ipa_verifier_gadget_on_the_key(cuda, ipa):
    """On the same key, one non-hiding polynomial committed and opened; the
    host's succinct check accepts, the in-circuit succinct check is
    satisfied on the host and on the card (is_satisfied_device), and with
    the value plus one it is satisfied on neither."""
    from poly_commit_tpu_torch.core.serialize import field_to_bytes
    from poly_commit_tpu_torch.pcs import ipa_pc, r1cs

    PC, ck, vk = ipa["PC"], ipa["ck"], ipa["vk"]
    spec, p = PC.spec, PC.spec.modulus
    degree = ck.supported_degree
    coeffs = _field(spec, degree + 1, 14, cuda)
    lp = LabeledPolynomial("f", coeffs)  # no hiding: the gadget's proof form
    before = _counts()
    comms, states = PC.commit(ck, [lp])
    z = HostRng(14).field_int(spec)
    v = _horner(F.to_ints(spec, coeffs), z, p)
    proof = PC.open(ck, [lp], comms, z, PoseidonSponge(spec), states)
    check_poly = PC.succinct_check(vk, comms, z, [v], proof, PoseidonSponge(spec))
    assert check_poly is not None
    sponge = PoseidonSponge(spec)
    ch = sponge.squeeze_challenge_128()
    sponge.squeeze_challenge_128()  # open squeezes a second one a polynomial
    comm = comms[0].commitment.comm
    data = (ipa_pc._host_pt_bytes(ipa_pc.HGROUP.mul(comm, ch)) + field_to_bytes(spec, z)
            + field_to_bytes(spec, ch * v % p))
    inst = dict(comm=comm, z=z, h=vk.h, proof=proof, ch=ch, first_round=ipa_pc._ro_challenge(data),
                round_chs=list(check_poly.challenges))
    for value, want in ((v, True), ((v + 1) % p, False)):
        cs = _ipa_gadget(r1cs, inst, value, degree)
        assert cs.is_satisfied() is want
        assert cs.is_satisfied_device(cuda) is want
    assert _missing(_since(before), ("ff_mont_mul", "ff_add", "ec_ed_smul")) == []


# -- MultilinearBrakedown over BN254 Fr at 22 variables -----------------------


@pytest.mark.gpu
def test_brakedown_round_trip(cuda):
    """setup -> trim -> commit -> batch_open -> batch_check: the value
    equals the host MLE fold, the check accepts it and rejects it plus one,
    the commit hashed its columns in one pc_blake2s_columns launch, and the
    root equals the commit's parts (encode, column bytes, hashlib's Blake2s,
    the Merkle tree)."""
    from poly_commit_tpu_torch.pcs import linear_codes as LC
    from poly_commit_tpu_torch.pcs.linear_codes import engine
    from poly_commit_tpu_torch.utils.merkle import MerkleTree, blake2s_hash

    PC = LC.MultilinearBrakedown
    spec, p, nv = PC.spec, PC.spec.modulus, BRAKEDOWN_NUM_VARS
    table = _field(spec, 1 << nv, 10, cuda)
    rng = HostRng(10)
    before = _counts()
    ck, vk = PC.trim(PC.setup(0, num_vars=nv, rng=rng, device=cuda), 0)
    lp = LabeledPolynomial("p", table, num_vars=nv)
    comms, states = PC.commit(ck, [lp], rng)
    point = tuple(rng.field_int(spec) for _ in range(nv))
    qs = {("p", ("z", point))}
    proofs, values = PC.batch_open(ck, [lp], comms, qs, PoseidonSponge(spec), states, rng)
    assert PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(spec))
    assert not PC.batch_check(vk, comms, qs, _bump(values, p), proofs, PoseidonSponge(spec))
    launches = _since(before)
    assert values[("p", point)] == _mle(F.to_ints(spec, table), point, p)
    raw = engine.column_bytes(spec, PC.code.encode_rows(states[0].mat, ck))
    leaves = [blake2s_hash(c.tobytes()) for c in raw]
    assert MerkleTree(leaves, ck.merkle_config()).root == comms[0].commitment.root
    assert _missing(launches, ("ff_mont_mul", "ff_add", "ff_sub")) == []
    assert launches["blake2s_columns"] == 1


# -- Hyrax over BN254 at 22 variables -----------------------------------------


@pytest.mark.gpu
def test_hyrax_round_trip(cuda, monkeypatch):
    """One hiding polynomial of 2^22 evaluations: commit folds its 2,048
    row MSMs on the card (no host fold), batch_check accepts the proof and
    rejects it with z[0] + 1 and with com_eval replaced by com_d, and
    msm_rows gives the same rows at 16 to 256 lanes a window. The
    commitment and the opened value are held by the cells hyrax.nv22.commit
    and hyrax.nv22.prove."""
    from poly_commit_tpu_torch.core.serialize import device_points_to_ints
    from poly_commit_tpu_torch.pcs import hyrax

    PC = hyrax.HyraxPC
    spec, p, nv = PC.spec, PC.spec.modulus, HYRAX_NUM_VARS
    table = _field(spec, 1 << nv, 11, cuda)
    rng = HostRng(11)
    before = _counts()
    ck, vk = PC.trim(PC.setup(0, num_vars=nv, rng=rng, device=cuda))
    lp = LabeledPolynomial("p", table, hiding_bound=1, num_vars=nv)
    host_folds, fold_host = [], msm_gpu._fold_host
    monkeypatch.setattr(msm_gpu, "_fold_host", lambda *a: host_folds.append(1) or fold_host(*a))
    comms, states = PC.commit(ck, [lp], rng)
    monkeypatch.setattr(msm_gpu, "_fold_host", fold_host)
    qs = {("p", ("z", tuple(rng.field_int(spec) for _ in range(nv))))}
    proofs, values = PC.batch_open(ck, [lp], comms, qs, PoseidonSponge(spec), states, rng)
    assert PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(spec))
    for field in ("z", "com_eval"):
        bad = copy.deepcopy(proofs)
        if field == "z":
            bad[0][0].z[0] = (bad[0][0].z[0] + 1) % p
        else:
            bad[0][0].com_eval = bad[0][0].com_d
        assert not PC.batch_check(vk, comms, qs, values, bad, PoseidonSponge(spec)), field
    launches = _since(before)
    assert host_folds == []
    assert _missing(launches, G1_KERNELS + NORMALISE_KERNELS + ("ff_add",)) == []
    # msm_rows on the first chunk of rows at each lane count
    dim = ck.dim
    rows = min(dim, msm_gpu.CHUNK // dim)
    sc = F.from_mont(spec, states[0].mat[:rows])
    x, y, inf = ck.com_key
    x, y = ff.from_field_last(x), ff.from_field_last(y)
    c = msm_gpu.rows_params(cuda, dim)[0]
    got = []
    for t in ROW_LANES:
        monkeypatch.setattr(msm_gpu, "rows_params", lambda device, n, t=t: (c, t))
        out = msm_gpu.msm_rows(hyrax.GROUP, sc, x, y, inf, True)
        got.append(device_points_to_ints(hyrax.GROUP, tuple(ff.to_field_last(cc, (rows,)) for cc in out)))
    assert all(g == got[0] for g in got[1:])


# -- MarlinPST13 over BLS12-381 at 10 variables, degree 12 --------------------


@pytest.mark.gpu
def test_pst13_round_trip(cuda):
    """setup (646,646 SRS points) -> trim with hiding bound 1 -> commit two
    dense polynomials over every monomial (the second hiding) ->
    batch_open at one point -> batch_check: the values equal the
    coefficients dotted with the monomial values at the point, the check
    accepts them and rejects a value plus one; the G1 MSMs scanned in
    madd_scan."""
    from poly_commit_tpu_torch.pcs import pst13

    PC = pst13.MarlinPST13
    spec, r = PC.spec, PC.spec.modulus
    nv, degree = PST13_NUM_VARS, PST13_DEGREE
    rng = HostRng(12)
    before = _counts()
    ck, vk = PC.trim(PC.setup(degree, num_vars=nv, rng=rng, device=cuda), degree, 1)
    monomials = pst13._all_monomials(nv, degree)
    gen = np.random.default_rng(12)
    coeffs = []
    for _ in range(2):
        raw = gen.bytes(40 * len(monomials))
        coeffs.append([int.from_bytes(raw[i : i + 40], "little") % r for i in range(0, len(raw), 40)])
    polys = [LabeledPolynomial(f"p{i}", pst13.MVPoly(nv, dict(zip(monomials, c))),
                               hiding_bound=1 if i else None, num_vars=nv)
             for i, c in enumerate(coeffs)]
    comms, states = PC.commit(ck, polys, rng)
    point = tuple(rng.field_int(spec) for _ in range(nv))
    qs = {(lp.label, ("z", point)) for lp in polys}
    proofs, values = PC.batch_open(ck, polys, comms, qs, PoseidonSponge(spec), states, rng)
    assert PC.batch_check(vk, comms, qs, values, proofs, PoseidonSponge(spec))
    first = sorted(values)[0]
    bad = {**values, first: (values[first] + 1) % r}
    assert not PC.batch_check(vk, comms, qs, bad, proofs, PoseidonSponge(spec))
    launches = _since(before)
    at = pst13._monomial_values(list(point), degree, r)
    for lp, c in zip(polys, coeffs):
        assert values[(lp.label, point)] == sum(a * b for a, b in zip(c, at)) % r
    assert _missing(launches, G1_KERNELS + G2_SETUP_KERNELS + NORMALISE_KERNELS) == []
    assert launches["ec_madd_distinct_packed"] <= MAX_PACKED_MADD_LAUNCHES


# -- streaming KZG (Gemini) over BLS12-381 at degree 2^20 - 1 -----------------


@pytest.mark.gpu
def test_streaming_kzg_time_and_space_provers(cuda):
    """Three points (beta, -beta, beta^2), chunks of 2^16 and 16 folds: the
    space prover's commitment, openings and remainders equal the time
    prover's and long_divide's, the folding proof equals the commitment of
    sum_j eta_j (f^(j) div Z), the last fold's commitment equals a host
    fold and host MSM, the value equals host Horner, verify and
    verify_multi_points accept and reject a value plus one; long_divide
    and the chunked opens take under 0.1 K1 launches a coefficient."""
    from poly_commit_tpu_torch.pcs import kzg10
    from poly_commit_tpu_torch.pcs import streaming_kzg as SK

    spec, r = SK.SPEC, SK.SPEC.modulus
    degree = (1 << LOG_DEGREE) - 1
    n, chunk, depth = degree + 1, STREAM_CHUNK, STREAM_DEPTH
    f, f2 = _field(spec, n, 14, cuda), _field(spec, n, 15, cuda)
    rng = HostRng(14)
    k1_per_coefficient = {}

    def k1(name, fn):  # fn(), its K1 launches a coefficient kept under ``name``
        before = _counts()
        out = fn()
        k1_per_coefficient[name] = sum(v for k, v in _since(before).items() if k.startswith("ff_")) / n
        return out

    before = _counts()
    ck = SK.CommitterKey.new(degree, STREAM_POINTS, rng, device=cuda)
    vk = ck.verifier_key()
    beta = rng.field_int(spec)
    pts = [beta, r - beta, beta * beta % r]
    chal = rng.field_int(spec)
    rhos = [rng.field_int(spec) for _ in range(depth)]
    etas = SK._powers_int(rng.field_int(spec), depth)
    comm, comm2 = ck.commit(f), ck.commit(f2)
    value, proof = ck.open(f, beta)
    multi = ck.open_multi_points(f, pts)
    batch = ck.batch_open_multi_points([f, f2], pts, chal)
    folded = ck.commit_folding(f, rhos)
    assert ck.commit_chunked(f, chunk).point == comm.point
    v_chunked, p_chunked = k1("open_chunked", lambda: ck.open_chunked(f, beta, chunk))
    assert v_chunked == value and p_chunked.point == proof.point
    rem_chunked, m_chunked = k1("open_multi_points_chunked",
                                lambda: ck.open_multi_points_chunked(f, pts, chunk))
    assert m_chunked.point == multi.point
    rems_fold, p_fold = k1("open_folding_chunked",
                           lambda: ck.open_folding_chunked(f, rhos, pts, etas, chunk))
    zpoly = P.vanishing_poly(spec, F.from_ints(spec, pts, device=cuda))
    _, rem_time = k1("long_divide", lambda: P.long_divide(spec, f, zpoly))
    assert F.to_ints(spec, rem_chunked) == F.to_ints(spec, rem_time)
    evals = [[int(F.to_ints(spec, P.evaluate(spec, g, F.from_ints(spec, z, device=cuda))))
              for z in pts] for g in (f, f2)]
    assert SK.verify(vk, comm, beta, value, proof)
    assert not SK.verify(vk, comm, beta, (value + 1) % r, proof)
    assert SK.verify_multi_points(vk, [comm, comm2], pts, evals, batch, chal)
    bad_evals = [[(evals[0][0] + 1) % r] + evals[0][1:], evals[1]]
    assert not SK.verify_multi_points(vk, [comm, comm2], pts, bad_evals, batch, chal)
    launches = _since(before)
    ints = F.to_ints(spec, f)
    assert value == _horner(ints, beta, r) == evals[0][0]
    comb = None
    for fj, eta, rem in zip(ck.fold_polynomials(f, rhos), etas, rems_fold):
        q, rj = P.long_divide(spec, fj, zpoly)
        assert F.to_ints(spec, rem) == F.to_ints(spec, rj)
        scaled = P.scale(spec, q, F.from_ints(spec, eta, device=cuda))
        comb = scaled if comb is None else P.add(spec, comb, scaled)
    assert p_fold.point == ck.commit(comb).point
    last = ints
    for rho in rhos:
        last = [(a + rho * b) % r for a, b in zip(last[0::2], last[1::2])]
    bases = [hostec.triple_to_host(t) for t in kzg10.affine_at(SK.G1, ck.powers_of_g, range(len(last)))]
    assert len(folded) == depth
    assert folded[-1].point == hostec.host_to_triple(hostec.host_group(SK.G1).msm_fast(last, bases))
    assert all(v < MAX_K1_PER_COEFFICIENT for v in k1_per_coefficient.values()), k1_per_coefficient
    assert _missing(launches, G1_KERNELS + G2_SETUP_KERNELS + NORMALISE_KERNELS + (
        "ntt_small", "ntt_fused_stages", "ntt_stages", "ff_add", "ff_sub")) == []
    assert launches["ec_madd_distinct_packed"] <= MAX_PACKED_MADD_LAUNCHES
