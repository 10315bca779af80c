"""The PyTorch port's Brakedown (poly_commit_tpu_torch.pcs.linear_codes.
brakedown) against the JAX package's on the CPU.

Both packages draw the parameters and the polynomial from one HostRng
seed and run commit -> batch_open -> batch_check with one Poseidon
transcript: the base case at 4 variables (no expander level) and the
recursive case at 6 variables with base_len 4 (two A and two B levels,
one of them a degenerate B level of zero columns). The dimensions, start/end, every sparse matrix
(row indices and value ints), the encoded rows, the Merkle roots, the
proofs, the values and the verdicts must be equal, with tolerance 0. The
port runs K1's plain versions. Also: the degenerate matrices, a tampered
value rejected, and a JAX commitment opened by the port
(``convert.brakedown_params_from_jax``).
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
import poly_commit_tpu.pcs.linear_codes as jLC  # noqa: E402
from poly_commit_tpu.pcs.linear_codes import brakedown as jB  # noqa: E402
import poly_commit_tpu_torch.core.field as tF  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
import poly_commit_tpu_torch.pcs.data_structures as tDS  # noqa: E402
import poly_commit_tpu_torch.pcs.linear_codes as tLC  # noqa: E402
from poly_commit_tpu_torch.core import ff  # noqa: E402
from poly_commit_tpu_torch.pcs import convert  # noqa: E402
from poly_commit_tpu_torch.pcs.linear_codes import brakedown as tB  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

JAX = types.SimpleNamespace(B=jB, LC=jLC, F=jF, DS=jDS, T=jT, dev={})
PORT = types.SimpleNamespace(B=tB, LC=tLC, F=tF, DS=tDS, T=tT, dev={"device": "cpu"})
# case -> (num_vars, base_len): the pure RS base case and a recursion
CASES = {"base_case_nv4": (4, 30), "recursive_nv6": (6, 4)}


def _round_trip(pkg, num_vars, base_len, seed=13, pp=None):
    """test_linear_codes.py's Brakedown steps, returning what they produce."""
    PC = pkg.LC.MultilinearBrakedown
    spec = PC.spec
    rng = pkg.DS.HostRng(seed)
    if pp is None:
        pp = pkg.B.default_params(spec, rng, 1 << num_vars, True, base_len, **pkg.dev)
    lp = pkg.DS.LabeledPolynomial(
        "p", pkg.F.from_ints(spec, rng.field_ints(spec, 1 << num_vars), **pkg.dev), num_vars=num_vars)
    comms, states = PC.commit(pp, [lp], rng)
    point = tuple(rng.field_int(spec) for _ in range(num_vars))
    qs = {("p", ("pt_0", point))}
    proofs, values = PC.batch_open(pp, [lp], comms, qs, pkg.T.PoseidonSponge(spec), states, rng)
    ok = PC.batch_check(pp, comms, qs, values, proofs, pkg.T.PoseidonSponge(spec))
    return types.SimpleNamespace(PC=PC, pkg=pkg, pp=pp, comms=comms, states=states, qs=qs,
                                 values=values, proofs=proofs, ok=bool(ok))


@functools.lru_cache(maxsize=None)
def _both(case):
    return _round_trip(JAX, *CASES[case]), _round_trip(PORT, *CASES[case])


def _ints(spec, a):
    return ff.limbs_to_ints(spec, np.asarray(a).reshape(-1, spec.n_limbs))


def _mats(pp):
    spec = pp.spec
    return [(m.n, m.m, np.asarray(m.row_idx).astype(np.int64).tolist(), _ints(spec, m.val))
            for m in pp.a_mats + pp.b_mats]


def _proof(res):
    pf = res.proofs[0][0]
    return ([int(v) for v in pf.opening.v], [[int(v) for v in c] for c in pf.opening.columns],
            [(p.leaf_index, p.siblings) for p in pf.opening.paths],
            [int(v) for v in pf.well_formedness])


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_matches_jax(case):
    j, t = _both(case)
    for attr in ("n", "m", "m_ext", "a_dims", "b_dims", "start", "end"):
        assert getattr(t.pp, attr) == getattr(j.pp, attr), attr
    assert _mats(t.pp) == _mats(j.pp)
    spec = t.PC.spec
    assert _ints(spec, t.states[0].ext_mat) == _ints(spec, j.states[0].ext_mat)
    assert t.comms[0].commitment.root == j.comms[0].commitment.root
    assert t.values == j.values
    assert _proof(t) == _proof(j)
    assert t.ok is True and j.ok is True


def test_recursion_has_every_level_kind():
    """nv 6 at base_len 4 has expander levels, one of them a degenerate B
    level of zero columns (the case make_mat must accept)."""
    pp = _both("recursive_nv6")[1].pp
    assert pp.a_dims and any(cols == 0 for (_, cols, _) in pp.b_dims)


@pytest.mark.parametrize("shape", [(4, 0, 0), (4, 3, 0)], ids=["zero_columns", "zero_nnz"])
def test_degenerate_mats_match_jax(shape):
    spec = tLC.MultilinearBrakedown.spec
    outs = []
    for pkg in (JAX, PORT):
        rng = pkg.DS.HostRng(7)
        mat = pkg.B.make_mat(spec, *shape, rng, **pkg.dev)
        v = pkg.F.from_ints(spec, rng.field_ints(spec, 4), **pkg.dev)
        out = mat.row_mul(spec, v[None] if pkg is PORT else v)
        outs.append((tuple(out.shape[-2:]), _ints(spec, out), rng.field_int(spec)))
    assert outs[0] == outs[1]
    assert outs[1][0] == (shape[1], spec.n_limbs) and not any(outs[1][1])


def test_tampered_value_rejected_by_both():
    for res in _both("recursive_nv6"):
        key = next(iter(res.values))
        bad = {key: (res.values[key] + 1) % res.PC.spec.modulus}
        assert not res.PC.batch_check(res.pp, res.comms, res.qs, bad, res.proofs,
                                      res.pkg.T.PoseidonSponge(res.PC.spec))


def test_jax_params_carry_over():
    """The port on the JAX parameters (convert.brakedown_params_from_jax)
    opens the JAX commitment (convert.lincode_state_from_jax) with the JAX
    proof, and accepts it."""
    j, _ = _both("recursive_nv6")
    pp = convert.brakedown_params_from_jax(j.pp, device="cpu")
    assert _mats(pp) == _mats(j.pp)
    PC = tLC.MultilinearBrakedown
    state = convert.lincode_state_from_jax(j.states[0], device="cpu")
    rng = tDS.HostRng(13)
    tB.default_params(PC.spec, rng, 1 << 6, True, 4, device="cpu")  # the same draws as JAX's setup
    lp = tDS.LabeledPolynomial("p", tF.from_ints(PC.spec, rng.field_ints(PC.spec, 1 << 6),
                                                 device="cpu"), num_vars=6)
    assert _ints(PC.spec, lp.poly) == _ints(PC.spec, j.states[0].mat)
    proofs, values = PC.batch_open(pp, [lp], j.comms, j.qs, tT.PoseidonSponge(PC.spec), [state])
    port = types.SimpleNamespace(proofs=proofs)
    assert values == j.values and _proof(port) == _proof(j)
    assert PC.batch_check(pp, j.comms, j.qs, values, proofs, tT.PoseidonSponge(PC.spec))
