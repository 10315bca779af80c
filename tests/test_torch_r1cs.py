"""The PyTorch port's R1CS layer (poly_commit_tpu_torch.pcs.r1cs) on the
CPU: the counterpart of tests/test_r1cs.py, with the gadget fed the port's
own InnerProductArgPC proofs.

  * an IPA-PC proof at degree 7 (JubJub, log_d = 3, no hiding) made by the
    port; the verifier transcript replayed on host ints for the opening
    challenge, the first round challenge and the round challenges u_j;
  * IpaSuccinctCheckGadget.succinct_check synthesised: a valid proof
    satisfies the system, a tampered value and a tampered final key do
    not; the port's rows and assignment equal the JAX module's from the
    same inputs (the JAX synthesis is host ints);
  * ``is_satisfied_device`` (three sparse mat-vecs on the plain versions
    of kernel K1) against ``is_satisfied`` and the JAX module's
    ``is_satisfied_device`` on test_r1cs.py's small circuit, valid and with
    a flipped witness, and on a circuit whose rows have 1, 2, 3, 9 and 265
    nonzeros (every bucket kind), with no row padded past its bucket.
Every comparison is exact.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from poly_commit_tpu.pcs import r1cs as jR  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from poly_commit_tpu_torch.core.serialize import field_to_bytes  # noqa: E402
from poly_commit_tpu_torch.core.transcript import PoseidonSponge  # noqa: E402
from poly_commit_tpu_torch.pcs import r1cs  # noqa: E402
from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial  # noqa: E402
from poly_commit_tpu_torch.pcs.ipa_pc import (  # noqa: E402
    HGROUP,
    SPEC,
    InnerProductArgPC,
    _host_pt_bytes,
    _ro_challenge,
)

pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

DEGREE = 7  # 2^3 - 1: three halving rounds


def _horner(ints, x, p):
    acc = 0
    for c in reversed(ints):
        acc = (acc * x + c) % p
    return acc


@pytest.fixture(scope="module")
def ipa_instance():
    """One proof of the port's IPA-PC and the transcript values the gadget
    consumes (tests/test_r1cs.py's replay)."""
    PC = InnerProductArgPC
    rng = HostRng(99)
    pp = PC.setup(DEGREE, rng=rng, device="cpu")
    ck, vk = PC.trim(pp, DEGREE)
    ints = rng.field_ints(SPEC, DEGREE + 1)
    lp = LabeledPolynomial("f", F.from_ints(SPEC, ints, device="cpu"))  # no hiding, no bound
    comms, states = PC.commit(ck, [lp])
    z = rng.field_int(SPEC)
    v = _horner(ints, z, SPEC.modulus)
    proof = PC.open(ck, [lp], comms, z, PoseidonSponge(SPEC), states)
    assert proof.hiding_comm is None
    check_poly = PC.succinct_check(vk, comms, z, [v], proof, PoseidonSponge(SPEC))
    assert check_poly is not None, "host succinct_check must accept"
    sponge = PoseidonSponge(SPEC)
    ch = sponge.squeeze_challenge_128()
    sponge.squeeze_challenge_128()  # ch2: open squeezes it for every polynomial
    combined_comm = HGROUP.mul(comms[0].commitment.comm, ch)
    data = (_host_pt_bytes(combined_comm) + field_to_bytes(SPEC, z)
            + field_to_bytes(SPEC, ch * v % SPEC.modulus))
    return dict(vk=vk, comm=comms[0].commitment.comm, z=z, v=v, proof=proof, ch=ch,
                first_round=_ro_challenge(data), round_chs=list(check_poly.challenges))


def _synthesize(mod, inst, value_override=None):
    """The gadget over ``inst`` with the r1cs module ``mod`` (the port's or
    the JAX package's)."""
    cs = mod.ConstraintSystem(mod.FP.FR_BLS12_381)
    r = FP.JUBJUB_R
    v = inst["v"] if value_override is None else value_override
    proof = inst["proof"]
    comm_vars = [mod.TEPointVar.witness(cs, inst["comm"])]
    value_vars = [mod.NonNativeVar.witness(cs, r, v)]
    point_var = mod.NonNativeVar.witness(cs, r, inst["z"])
    h_var = mod.TEPointVar.witness(cs, inst["vk"].h)
    frc = mod.NonNativeVar.witness(cs, r, inst["first_round"])
    pf = mod.IpaProofVar(
        l_vec=[mod.TEPointVar.witness(cs, p) for p in proof.l_vec],
        r_vec=[mod.TEPointVar.witness(cs, p) for p in proof.r_vec],
        final_comm_key=mod.TEPointVar.witness(cs, proof.final_comm_key),
        c=mod.NonNativeVar.witness(cs, r, proof.c),
    )
    rand = mod.PCCheckRandomDataVar(
        opening_challenges=[mod.NonNativeVar.witness(cs, r, inst["ch"])],
        batching_rands=[mod.NonNativeVar.witness(cs, r, u) for u in inst["round_chs"]],
    )
    mod.IpaSuccinctCheckGadget.succinct_check(cs, r, comm_vars, value_vars, point_var, h_var,
                                              frc, pf, rand, DEGREE)
    return cs


def test_valid_proof_satisfies(ipa_instance):
    cs = _synthesize(r1cs, ipa_instance)
    assert cs.rows, "gadget must emit constraints"
    bad = cs.first_unsatisfied()
    assert bad is None, f"row {bad} unsatisfied on a valid proof"


def test_tampered_value_unsatisfied(ipa_instance):
    cs = _synthesize(r1cs, ipa_instance, value_override=(ipa_instance["v"] + 1) % FP.JUBJUB_R)
    assert cs.first_unsatisfied() is not None


def test_tampered_final_key_unsatisfied(ipa_instance):
    proof = ipa_instance["proof"]
    fx, fy = proof.final_comm_key
    bad = dict(ipa_instance, proof=dataclasses.replace(
        proof, final_comm_key=(fx, (-fy) % FP.FR_BLS12_381.modulus)))
    assert _synthesize(r1cs, bad).first_unsatisfied() is not None


def test_rows_and_assignment_equal_jax(ipa_instance):
    port, jax_cs = _synthesize(r1cs, ipa_instance), _synthesize(jR, ipa_instance)
    assert port.assignment == jax_cs.assignment
    assert port.rows == jax_cs.rows
    assert port.num_instance == jax_cs.num_instance


def _small_circuit(mod):
    """tests/test_r1cs.py's small circuit: 3 G on JubJub and one
    non-native product."""
    cs = mod.ConstraintSystem(mod.FP.FR_BLS12_381)
    g = (FP.JUBJUB_G_X, FP.JUBJUB_G_Y)
    p1 = mod.TEPointVar.witness(cs, g)
    p1.enforce_on_curve()
    p2 = p1.double().add(p1)
    expected = HGROUP.mul(g, 3)
    p2.enforce_equal(mod.TEPointVar(mod.FpVar.constant(cs, expected[0]),
                                    mod.FpVar.constant(cs, expected[1])))
    a = mod.NonNativeVar.witness(cs, FP.JUBJUB_R, 12345678901234567890)
    b = mod.NonNativeVar.witness(cs, FP.JUBJUB_R, 98765432109876543210)
    exp = 12345678901234567890 * 98765432109876543210 % FP.JUBJUB_R
    a.mul(b).enforce_congruent(mod.NonNativeVar.witness(cs, FP.JUBJUB_R, exp))
    return cs


@pytest.mark.parametrize("flip", [False, True], ids=["valid", "flipped_witness"])
def test_device_check_matches_host_and_jax_on_small_circuit(flip):
    port, jax_cs = _small_circuit(r1cs), _small_circuit(jR)
    assert port.rows == jax_cs.rows and port.assignment == jax_cs.assignment
    if flip:
        for cs in (port, jax_cs):
            cs.assignment[2] = (cs.assignment[2] + 1) % cs.p
    want = not flip
    assert port.is_satisfied() is want
    assert port.is_satisfied_device(device="cpu") is want
    assert bool(jax_cs.is_satisfied_device()) is want


def _bucket_circuit():
    """Rows whose A has 1, 2, 3, 9 and 265 entries (a 263-bit range check:
    its bits, its value and the constant term it starts from), every bucket
    kind, with B and C of 1 or 0 entries."""
    cs = r1cs.ConstraintSystem(FP.FR_BLS12_381)
    xs = [r1cs.FpVar.witness(cs, 3 + i) for i in range(8)]
    for n in (1, 2, 3, 9):
        lc = xs[0] if n == 1 else xs[0].add(xs[1]) if n == 2 else None
        if lc is None:
            lc = xs[0]
            for x in xs[1:n - 1]:
                lc = lc.add(x)
            lc = lc.add_const(n)  # the constant w[0] makes the n-th nonzero
        lc.mul(xs[n % 8])
    big = r1cs.FpVar.witness(cs, (1 << 262) + 12345)
    r1cs.range_check(cs, big, 263)
    return cs


def test_device_check_covers_every_bucket():
    cs = _bucket_circuit()
    counts = sorted({len(row[0]) for row in cs.rows})
    assert {1, 2, 3, 9, 265} <= set(counts), counts
    sc = cs.sparse_check()
    assert {1, 2, 4, 16, 512} <= set(sc.widths), sc.widths
    # no row padded past its bucket's power of two
    rows = [row[sel] for sel in range(3) for row in cs.rows]
    for width, vrows in sc.buckets:
        for v in vrows.tolist():
            n = len(rows[v])
            assert n <= width and (width == 1 or 2 * n > width), (n, width)
    assert sum(w * len(v) for w, v in sc.buckets) == len(sc.cols) == len(sc.coeff_index)
    assert sc.values[0] == 0 and sc.nnz == tuple(sum(len(r[s]) for r in cs.rows) for s in range(3))
    assert cs.is_satisfied() and cs.is_satisfied_device(device="cpu")
    cs.assignment[-1] = (cs.assignment[-1] + 1) % cs.p  # the last bit of the range check
    assert not cs.is_satisfied() and not cs.is_satisfied_device(device="cpu")


def test_empty_system_is_satisfied():
    assert r1cs.ConstraintSystem(FP.FR_BLS12_381).is_satisfied_device(device="cpu")


def test_bad_inputs_raise_value_error(ipa_instance):
    cs = r1cs.ConstraintSystem(FP.FR_BLS12_381)
    cs.alloc(5)
    with pytest.raises(ValueError, match="public inputs"):
        cs.alloc_input(1)
    with pytest.raises(ValueError, match="bits"):
        r1cs.range_check(cs, r1cs.FpVar.witness(cs, 1 << 10), 10)
    with pytest.raises(ValueError, match="bit decomposition"):
        r1cs.NonNativeVar.constant(cs, FP.JUBJUB_R, 7).scalar_bits()
    cs.enforce({len(cs.assignment): 1}, {0: 1}, {})  # a variable never allocated
    with pytest.raises(ValueError, match="outside the assignment"):
        cs.is_satisfied_device(device="cpu")
    short = dict(ipa_instance, round_chs=ipa_instance["round_chs"][:-1])
    with pytest.raises(ValueError, match="round challenges"):
        _synthesize(r1cs, short)
