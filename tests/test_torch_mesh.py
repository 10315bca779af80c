"""The PyTorch port's mesh layer (poly_commit_tpu_torch.parallel) on four
gloo ranks on the CPU, against the port's single-device calls and JAX.

One module-scoped spawn of four ranks (parallel/launch.py) runs every case
of tests/torch_mesh_cases.py, on a 1-D mesh of four ranks and on a 2x2
mesh; each test below asserts its own case. Every replicated result must
be the same on every rank and equal the port's single-device result
(group elements as affine ints, field elements as canonical ints, the
Marlin golden byte for byte), with tolerance 0. The ranks run the kernels'
plain versions. JAX runs only in this process, on the cases' seeded host
ints: its host MSM under 1024 points, its portable NTT (one vector and a
batch of rows, forward and inverse), its single-device IPA key fold and
v^T M, Brakedown's and Ligero's encodes, and its cross-twiddle table
(never its shard_map functions).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from poly_commit_tpu.core import curve as jC  # noqa: E402
from poly_commit_tpu.core import field as jF  # noqa: E402
from poly_commit_tpu.core import hostec as jH  # noqa: E402
from poly_commit_tpu.core import msm as jM  # noqa: E402
from poly_commit_tpu.core import ntt as jNTT  # noqa: E402
from poly_commit_tpu.parallel import mesh as jPM  # noqa: E402
from poly_commit_tpu.pcs import data_structures as jDS  # noqa: E402
from poly_commit_tpu.pcs import linear_codes as jLC  # noqa: E402
from poly_commit_tpu.pcs.linear_codes import brakedown as jB  # noqa: E402
from poly_commit_tpu.pcs.linear_codes import engine as jE  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from poly_commit_tpu_torch.parallel import launch as PL  # noqa: E402
from poly_commit_tpu_torch.parallel import mesh as PM  # noqa: E402
from tests import torch_mesh_cases as cases  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
LAUNCH_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def ranks():
    return PL.launch(cases.run, cases.WORLD, backend="gloo", device="cpu",
                     timeout=LAUNCH_TIMEOUT_S)


def _mesh(ranks, name):
    """The replicated result of a case: the same on every rank."""
    got = [r["mesh"][name] for r in ranks]
    assert all(g == got[0] for g in got[1:])
    return got[0]


def _single(ranks, name):
    (value,) = [r["single"][name] for r in ranks if name in r["single"]]
    return value


@pytest.mark.parametrize("name", ["msm_64", "msm_50", "batch_msm", "batch_ntt", "row_mul",
                                  "fold_key", "hyrax_commit", "pst13_commit", "ipa_open"])
def test_sharded_matches_single_device(ranks, name):
    assert _mesh(ranks, name) == _single(ranks, name)


@pytest.mark.parametrize("code", ["brakedown", "ligero"])
def test_encode_and_row_mul_match_single_device(ranks, code):
    ext, row_mul = _mesh(ranks, f"{code}_encode")
    assert (ext, row_mul) == _single(ranks, f"{code}_encode")
    assert len(ext) == cases.ROWS


@pytest.mark.parametrize("n", cases.NTT_SIZES)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_ntt_sharded_matches_single_device(ranks, n, direction):
    """n = 64 takes the six-step route (three all_to_alls), n = 8 the
    gather route; each rank holds its contiguous slice of the output."""
    name = f"ntt_{n}_{direction}"
    slices = sorted(r["mesh"][name] for r in ranks)
    assert [i for i, _ in slices] == list(range(cases.WORLD))
    assert [v for _, s in slices for v in s] == _single(ranks, name)


def test_msm_and_ntt_match_jax(ranks):
    """msm_sharded at 64 points against JAX's host MSM, and the sharded
    forward NTT at 64 points against JAX's portable NTT."""
    triples, scalars = cases.msm_case(cases.G1, 64, 64)
    j_out = jM.msm(jC.BLS12_381_G1, jM.scalars_from_ints(jC.BLS12_381_G1.scalar_spec, scalars),
                   jC.affine_from_ints(jC.BLS12_381_G1, triples))
    x, y, inf = _mesh(ranks, "msm_64")
    assert jH.device_proj_to_host(jC.BLS12_381_G1, j_out) == (None if inf else (x, y))
    spec = cases.NTT_SPEC
    want = [int(v) for v in jF.to_ints(spec, jNTT.ntt(spec, jF.from_ints(spec, cases.ntt_ints(64))))]
    slices = sorted(r["mesh"]["ntt_64_forward"] for r in ranks)
    assert [v for _, s in slices for v in s] == want


def _jax_mat(spec, rows, cols, seed):
    """The cases' seeded (rows, cols) field matrix, as JAX limbs."""
    return jF.from_ints(spec, cases.field_ints(spec, rows * cols, seed)).reshape(rows, cols, spec.n_limbs)


@pytest.mark.parametrize("n", cases.NTT_SIZES)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_ntt_sharded_matches_jax(ranks, n, direction):
    """Both routes of ntt_sharded, forward and inverse, against JAX's
    portable NTT of the whole vector."""
    spec = cases.NTT_SPEC
    a = jF.from_ints(spec, cases.ntt_ints(n))
    want = jF.to_ints(spec, (jNTT.intt if direction == "inverse" else jNTT.ntt)(spec, a))
    slices = sorted(r["mesh"][f"ntt_{n}_{direction}"] for r in ranks)
    assert [v for _, s in slices for v in s] == want


def test_batch_ntt_matches_jax(ranks):
    spec = cases.NTT_SPEC
    rows = _jax_mat(spec, cases.ROWS, cases.BATCH_NTT_LEN, cases.BATCH_NTT_SEED)
    assert _mesh(ranks, "batch_ntt") == jF.to_ints(spec, jNTT.ntt(spec, rows))


def test_row_mul_matches_jax(ranks):
    """row_mul_sharded against the JAX engine's single-device v^T M."""
    spec = cases.NTT_SPEC
    vec = _jax_mat(spec, cases.ROWS, 1, cases.ROW_MUL_SEEDS[0])[:, 0]
    mat = _jax_mat(spec, cases.ROWS, cases.ROW_MUL_COLS, cases.ROW_MUL_SEEDS[1])
    assert _mesh(ranks, "row_mul") == jF.to_ints(spec, jE._row_mul(spec, vec, mat))


def test_fold_key_matches_jax(ranks):
    """fold_key_sharded against the JAX package's single-device key fold
    (ipa_pc.py: from_affine, scalar_mul over 256 challenge bits, add,
    to_affine)."""
    left, right, ch = cases.key_case_ints()
    J = jC.JUBJUB
    jl, jr = (jC.affine_from_ints(J, half) for half in (left, right))
    x, y, inf = J.to_affine(J.add(J.from_affine(*jl),
                                  J.scalar_mul(J.from_affine(*jr), jC.scalar_bits(ch, 256))))
    want = [(int(a), int(b), bool(i)) for a, b, i in
            zip(jF.to_ints(FP.FR_BLS12_381, x), jF.to_ints(FP.FR_BLS12_381, y), np.asarray(inf))]
    assert _mesh(ranks, "fold_key") == want


@pytest.mark.parametrize("code", ["brakedown", "ligero"])
def test_encode_and_row_mul_match_jax(ranks, code):
    """The sharded encode (and v^T M over its rows) against the JAX
    package's single-device encode on the same message; Brakedown's
    matrices drawn by JAX from the same HostRng seed."""
    if code == "brakedown":
        PC = jLC.MultilinearBrakedown
        seed, poly_len, base_len = cases.BRAKEDOWN_KEY
        pp = jB.default_params(PC.spec, jDS.HostRng(seed), poly_len, True, base_len)
        cols = pp.m
    else:
        PC = jLC.MultilinearLigeroBN254
        pp = PC.code.setup(0, cases.LIGERO_NUM_VARS, None)
        cols = cases.LIGERO_COLS
    spec, (s_mat, s_vec) = PC.spec, cases.CODE_SEEDS[code]
    ext = PC.code.encode_rows(_jax_mat(spec, cases.ROWS, cols, s_mat), pp)
    vec = _jax_mat(spec, cases.ROWS, 1, s_vec)[:, 0]
    assert _mesh(ranks, f"{code}_encode") == (jF.to_ints(spec, ext),
                                              jF.to_ints(spec, jE._row_mul(spec, vec, ext)))


def test_marlin_golden_replays_under_mesh(ranks):
    with open(os.path.join(VECTORS, "marlin_ark_golden.json")) as fh:
        committed = json.load(fh)
    assert _mesh(ranks, "marlin_golden") == committed


def test_mesh_2d_msm_over_dp_and_ntt_over_tp(ranks):
    assert sorted(r["coords_2d"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert _mesh(ranks, "msm_64_dp") == _single(ranks, "msm_64")
    # each tp row of two ranks transforms the whole vector: its two slices
    for dp in (0, 1):
        slices = sorted(r["mesh"]["ntt_64_forward_tp"] for r in ranks if r["coords_2d"][0] == dp)
        assert [v for _, s in slices for v in s] == _single(ranks, "ntt_64_forward")


def test_divergent_replicated_input_raises(ranks):
    """Rank 2's scalars differ by one bit: every rank raises ValueError."""
    messages = [r["mesh"]["digest_guard"] for r in ranks]
    assert all(m is not None and "replicated inputs differ" in m for m in messages)


def test_replicate_and_shard_batch(ranks):
    assert _mesh(ranks, "replicate") == [10, 10, 10]
    got = sorted((r["rank"], r["mesh"]["shard_batch"]) for r in ranks)
    assert got == [(i, [2 * i, 2 * i + 1]) for i in range(cases.WORLD)]


@pytest.mark.parametrize("inverse", [False, True])
def test_cross_twiddles_match_jax(inverse):
    spec = FP.FR_BN254
    got = PM._cross_twiddles(spec, 4, 16, inverse, "cpu").numpy().astype(np.int64)
    want = np.asarray(jPM._cross_twiddles(spec, 4, 16, inverse)).astype(np.int64)
    assert got.shape == want.shape == (16, 4, spec.n_limbs)
    assert (got == want).all()


def test_nccl_refuses_more_ranks_than_gpus():
    """NCCL with more ranks than GPUs raises, naming gloo, before any
    process group or rank starts; it never falls back on its own."""
    world = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(ValueError, match="gloo"):
        PL.launch(cases.run, world, backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        PM.check_backend("nccl", world)
    with pytest.raises(ValueError, match="gloo"):
        PM.make_mesh(world, backend="nccl", init_method="file:///nonexistent/store")
    with pytest.raises(ValueError, match="gloo"):
        PM.make_mesh_2d(1, world, backend="nccl", init_method="file:///nonexistent/store")
    assert not torch.distributed.is_initialized()


def test_use_mesh_nests_and_restores():
    a = PM.Mesh(("shard",), (1,), (0,), (None,), ((0,),), torch.device("cpu"), "gloo")
    b = PM.Mesh(("dp", "tp"), (1, 1), (0, 0), (None, None), ((0,), (0,)), torch.device("cpu"), "gloo")
    assert PM.active_mesh() is None
    with PM.use_mesh(a):
        assert PM.active_mesh() == (a, "shard")
        with PM.use_mesh(b, "tp"):
            assert PM.active_mesh() == (b, "tp") and b.size("tp") == 1
        assert PM.active_mesh() == (a, "shard")
    assert PM.active_mesh() is None
