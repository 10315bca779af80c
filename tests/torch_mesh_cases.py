"""The rank side of tests/test_torch_mesh.py: every case of the PyTorch
port's mesh layer, run by each of four gloo ranks on the CPU (and by
tests/test_torch_gpu.py's four gloo ranks sharing cuda:0).

Each spawned rank imports this module (torch and the port only, no JAX)
and runs ``run``: first the keys and the single-device results, each built
by one rank and the keys broadcast to the others; then every case under the
mesh, on every rank, noting which of the mesh layer's entry points
(ROUTES) each case called. It returns its results as host values; the test
files hold them against each other, the single-device results and JAX.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from poly_commit_tpu_torch.core import curve as C
from poly_commit_tpu_torch.core import field as F
from poly_commit_tpu_torch.core import field_params as FP
from poly_commit_tpu_torch.core import hostec
from poly_commit_tpu_torch.core import msm as M
from poly_commit_tpu_torch.core import ntt as NTT
from poly_commit_tpu_torch.core.serialize import device_point_to_ints, device_points_to_ints
from poly_commit_tpu_torch.core.transcript import PoseidonSponge
from poly_commit_tpu_torch.parallel import mesh as PM
from poly_commit_tpu_torch.pcs import ark_interop, hyrax, ipa_pc, pst13
from poly_commit_tpu_torch.pcs import linear_codes as LC
from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
from poly_commit_tpu_torch.pcs.linear_codes import brakedown, engine

DEVICE = "cpu"  # the ranks' device: run() sets it
WORLD = 4
G1 = C.BLS12_381_G1
NTT_SPEC = FP.FR_BN254
MSM_SIZES = (64, 50)  # 50: padded to 52
NTT_SIZES = (64, 8)  # 64 = 4 D^2: the six-step route; 8: the gather route
ROWS = 8  # rows of the batched field cases: 2 a rank
MSM_ROWS = 4  # rows of the batched MSM: 1 a rank (a CPU MSM costs ~1 s at any size)
GOLDEN_DEGREE = 10  # tests/vectors/marlin_ark_golden.json
IPA_DEGREE = 15  # rounds of half 8 and 4 shard; 2 and 1 run locally
HYRAX_NUM_VARS = 4
PST13_NUM_VARS, PST13_DEGREE = 2, 2
# the seeds of the field cases' host ints: (vector, matrix) of v^T M, the
# rows of the batched NTT, and each code's (message rows, vector)
ROW_MUL_SEEDS = (70, 71)
ROW_MUL_COLS = 5
BATCH_NTT_SEED, BATCH_NTT_LEN = 60, 16
CODE_SEEDS = {"brakedown": (90, 91), "ligero": (95, 96)}
LIGERO_NUM_VARS, LIGERO_COLS = 6, 16
BRAKEDOWN_KEY = (13, 1 << 6, 4)  # HostRng seed, polynomial length, base_len


def field_ints(spec, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % spec.modulus for _ in range(n)]


def msm_case(group, n, seed):
    """(affine int triples, scalar ints): multiples of the generator on host
    ints, one point at infinity and one zero scalar."""
    hg = hostec.host_group(group)
    rng = np.random.default_rng(seed)
    pts = [hg.mul_fast((group.gen_x, group.gen_y), int(rng.integers(1, 1 << 62))) for _ in range(n)]
    triples = [(x, y, False) for x, y in pts]
    triples[min(5, n - 1)] = (0, 1, True)
    scalars = field_ints(group.scalar_spec, n, seed + 1)
    scalars[0] = 0
    return triples, scalars


def _msm_tensors(group, n, seed):
    triples, scalars = msm_case(group, n, seed)
    return M.scalars_from_ints(group.scalar_spec, scalars, DEVICE), C.affine_from_ints(group, triples, DEVICE)


def _rows_case():
    """BN254 rows of scalars over 16 shared bases (Hyrax's layout)."""
    triples, _ = msm_case(C.BN254_G1, 16, 31)
    rows = F.from_ints(FP.FR_BN254, field_ints(FP.FR_BN254, MSM_ROWS * 16, 32), mont=False, device=DEVICE)
    return rows.reshape(MSM_ROWS, 16, -1), C.affine_from_ints(C.BN254_G1, triples, DEVICE)


def key_case_ints():
    """Two halves of an IPA key over JubJub (affine int triples) and a round
    challenge."""
    hg = hostec.host_group(C.JUBJUB)
    rng = np.random.default_rng(41)
    pts = [hg.mul((C.JUBJUB.gen_x, C.JUBJUB.gen_y), int(rng.integers(1, 1 << 62))) for _ in range(2 * ROWS)]
    triples = [(x, y, False) for x, y in pts]
    return triples[:ROWS], triples[ROWS:], field_ints(FP.FR_JUBJUB, 1, 42)[0]


def _key_case():
    left, right, ch = key_case_ints()
    return C.affine_from_ints(C.JUBJUB, left, DEVICE), C.affine_from_ints(C.JUBJUB, right, DEVICE), ch


def _mat(spec, rows, cols, seed):
    return F.from_ints(spec, field_ints(spec, rows * cols, seed), device=DEVICE).reshape(rows, cols, -1)


def _affine(group, key):
    return [(int(F.to_ints(group.spec, x)), int(F.to_ints(group.spec, y)), bool(i))
            for x, y, i in zip(*key)]


# -- keys, each built by one rank ---------------------------------------------


def _pst13_key():
    pp = pst13.MarlinPST13.setup(PST13_DEGREE, num_vars=PST13_NUM_VARS, rng=HostRng(5), device=DEVICE)
    return pst13.MarlinPST13.trim(pp, PST13_DEGREE, 0)[0]


def _ipa_key():
    pp = ipa_pc.InnerProductArgPC.setup(IPA_DEGREE, rng=HostRng(7), device=DEVICE)
    return ipa_pc.InnerProductArgPC.trim(pp, IPA_DEGREE, 0, None)[0]


def _hyrax_key():
    pp = hyrax.HyraxPC.setup(0, num_vars=HYRAX_NUM_VARS, rng=HostRng(7), device=DEVICE)
    return hyrax.HyraxPC.trim(pp, 0, 1, None)[0]


def _brakedown_key():
    seed, poly_len, base_len = BRAKEDOWN_KEY
    return brakedown.default_params(FP.FR_BN254, HostRng(seed), poly_len, True, base_len, device=DEVICE)


KEYS = {"pst13": (0, _pst13_key), "ipa": (1, _ipa_key), "hyrax": (2, _hyrax_key),
        "brakedown": (2, _brakedown_key)}


# -- the cases: each runs the same way alone and under the mesh ---------------


def case_msm(n):
    def fn(keys):
        sc, pts = _msm_tensors(G1, n, n)
        active = PM.active_mesh()
        if active is None:
            return device_point_to_ints(G1, M.msm(G1, sc, pts))
        psc, ppts = PM.pad_msm_inputs(G1, sc, pts, active[0].size(active[1]))
        return device_point_to_ints(G1, PM.msm_sharded(G1, psc, ppts, *active))
    return fn


def case_batch_msm(keys):
    rows, pts = _rows_case()
    active = PM.active_mesh()
    out = M.msm_rows(C.BN254_G1, rows, pts) if active is None else \
        PM.batch_msm_sharded(C.BN254_G1, rows, pts, *active)
    return device_points_to_ints(C.BN254_G1, out)


def ntt_ints(n):
    """The n-point NTT case's input, as ints."""
    return field_ints(NTT_SPEC, n, 50 + n)


def case_ntt(n, inverse):
    """Single: the portable transform of the whole vector. Under the mesh:
    this rank's slice, as (axis index, canonical ints)."""
    def fn(keys):
        a = F.from_ints(NTT_SPEC, ntt_ints(n), device=DEVICE)
        active = PM.active_mesh()
        if active is None:
            return F.to_ints(NTT_SPEC, (NTT.intt if inverse else NTT.ntt)(NTT_SPEC, a))
        mesh, axis = active
        mine = PM.ntt_sharded(NTT_SPEC, PM.shard_batch(a, mesh, axis), mesh, inverse, axis)
        return mesh.index(axis), F.to_ints(NTT_SPEC, mine)
    return fn


def case_batch_ntt(keys):
    rows = _mat(NTT_SPEC, ROWS, BATCH_NTT_LEN, BATCH_NTT_SEED)
    active = PM.active_mesh()
    out = NTT.ntt(NTT_SPEC, rows) if active is None else PM.batch_ntt_sharded(NTT_SPEC, rows, *active)
    return F.to_ints(NTT_SPEC, out)


def case_row_mul(keys):
    vec, mat = _mat(NTT_SPEC, ROWS, 1, ROW_MUL_SEEDS[0])[:, 0], _mat(NTT_SPEC, ROWS, ROW_MUL_COLS,
                                                                      ROW_MUL_SEEDS[1])
    active = PM.active_mesh()
    out = engine._row_mul(NTT_SPEC, vec, mat) if active is None else \
        PM.row_mul_sharded(NTT_SPEC, vec, mat, *active)
    return F.to_ints(NTT_SPEC, out)


def case_fold_key(keys):
    k_l, k_r, ch = _key_case()
    active = PM.active_mesh()
    out = ipa_pc.fold_key(k_l, k_r, ch) if active is None else \
        PM.fold_key_sharded(C.JUBJUB, k_l, k_r, ch, *active)
    return _affine(C.JUBJUB, out)


def case_marlin_golden(keys):
    return ark_interop.marlin_ark_golden(GOLDEN_DEGREE, device=DEVICE)


def case_hyrax(keys):
    PC = hyrax.HyraxPC
    poly = F.from_ints(PC.spec, field_ints(PC.spec, 1 << HYRAX_NUM_VARS, 80), device=DEVICE)
    comms, _ = PC.commit(keys["hyrax"], [LabeledPolynomial("p", poly, num_vars=HYRAX_NUM_VARS)],
                         HostRng(81))
    return [tuple(int(v) for v in t[:2]) + (bool(t[2]),) for t in comms[0].commitment.row_coms]


def case_pst13(keys):
    PC = pst13.MarlinPST13
    poly = pst13.MVPoly.rand(HostRng(9), PST13_NUM_VARS, PST13_DEGREE, num_terms=6, spec=PC.spec)
    comms, _ = PC.commit(keys["pst13"], [LabeledPolynomial("p", poly, num_vars=PST13_NUM_VARS)])
    return comms[0].commitment.comm


def _encode(PC, pp, cols, seeds):
    """A code's encoded rows of a seeded message and v^T M over them, as ints."""
    ext = PC.code.encode_rows(_mat(FP.FR_BN254, ROWS, cols, seeds[0]), pp)
    vec = _mat(FP.FR_BN254, ROWS, 1, seeds[1])[:, 0]
    return F.to_ints(FP.FR_BN254, ext), F.to_ints(FP.FR_BN254, engine._row_mul(FP.FR_BN254, vec, ext))


def case_brakedown_encode(keys):
    pp = keys["brakedown"]
    return _encode(LC.MultilinearBrakedown, pp, pp.m, CODE_SEEDS["brakedown"])


def case_ligero_encode(keys):
    pp = LC.MultilinearLigeroBN254.code.setup(0, LIGERO_NUM_VARS, None, device=DEVICE)
    return _encode(LC.MultilinearLigeroBN254, pp, LIGERO_COLS, CODE_SEEDS["ligero"])


def case_ipa_open(keys):
    PC = ipa_pc.InnerProductArgPC
    rng = HostRng(3)
    lp = LabeledPolynomial("p", F.from_ints(PC.spec, rng.field_ints(PC.spec, IPA_DEGREE + 1), device=DEVICE))
    comms, states = PC.commit(keys["ipa"], [lp], rng)
    qs = {("p", ("z", rng.field_int(PC.spec)))}
    proofs, values = PC.batch_open(keys["ipa"], [lp], comms, qs, PoseidonSponge(PC.spec), states, rng)
    return [(p.l_vec, p.r_vec, p.final_comm_key, p.c, p.hiding_comm, p.rand) for p in proofs], values


# name -> (the rank that computes the single-device result, the case)
CASES = {
    **{f"msm_{n}": (3, case_msm(n)) for n in MSM_SIZES}, "batch_msm": (3, case_batch_msm),
    **{f"ntt_{n}_{'inverse' if inv else 'forward'}": (3, case_ntt(n, inv))
       for n in NTT_SIZES for inv in (False, True)},
    "batch_ntt": (3, case_batch_ntt), "row_mul": (3, case_row_mul),
    "fold_key": (3, case_fold_key), "marlin_golden": (None, case_marlin_golden),
    "hyrax_commit": (2, case_hyrax), "pst13_commit": (0, case_pst13),
    "brakedown_encode": (2, case_brakedown_encode), "ligero_encode": (2, case_ligero_encode),
    "ipa_open": (1, case_ipa_open),
}


def _digest_guard(mesh):
    """One rank's scalars differ: every rank raises ValueError."""
    sc, pts = _msm_tensors(G1, 64, 64)
    if mesh.index() == 2:
        sc = sc.clone()
        sc[1, 0] ^= 1
    try:
        PM.msm_sharded(G1, sc, pts, mesh)
    except ValueError as exc:
        return str(exc)
    return None


# the mesh layer's entry points: a case that calls one ran its sharded branch
ROUTES = ("msm_sharded", "batch_msm_sharded", "map_rows", "batch_ntt_sharded", "row_mul_sharded",
          "fold_key_sharded", "_transpose_sharded")


@contextlib.contextmanager
def _routes():
    """Within the block, the names of ROUTES called (the module's functions
    wrapped, so calls from inside parallel/mesh.py count too)."""
    called = set()
    saved = {name: getattr(PM, name) for name in ROUTES}

    def counted(name, fn):
        def call(*args, **kw):
            called.add(name)
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(PM, name, counted(name, fn))
    try:
        yield called
    finally:
        for name, fn in saved.items():
            setattr(PM, name, fn)


def run(device="cpu"):
    global DEVICE
    DEVICE = device
    torch.set_num_threads(1)
    mesh = PM.make_mesh(device=torch.device(device))
    rank = mesh.index()
    out = {"rank": rank, "single": {}, "mesh": {}, "routes": {}}
    keys = {name: build() for name, (owner, build) in KEYS.items() if owner == rank}
    for name, (owner, case) in CASES.items():
        if owner == rank:
            out["single"][name] = case(keys)
    for name, (owner, _) in KEYS.items():
        box = [keys.get(name)]
        dist.broadcast_object_list(box, src=owner)
        keys[name] = box[0]
    with PM.use_mesh(mesh):
        for name, (_, case) in CASES.items():
            with _routes() as called:
                out["mesh"][name] = case(keys)
            out["routes"][name] = sorted(called)
    out["mesh"]["digest_guard"] = _digest_guard(mesh)
    out["mesh"]["replicate"] = PM.replicate(torch.full((3,), 10 + rank, device=mesh.device), mesh).tolist()
    out["mesh"]["shard_batch"] = PM.shard_batch(torch.arange(ROWS, device=mesh.device), mesh).tolist()
    mesh_2d = PM.make_mesh_2d(2, 2, device=torch.device(device))
    out["coords_2d"] = mesh_2d.coords
    with PM.use_mesh(mesh_2d, "dp"):
        out["mesh"]["msm_64_dp"] = CASES["msm_64"][1](keys)
    with PM.use_mesh(mesh_2d, "tp"):
        out["mesh"]["ntt_64_forward_tp"] = CASES["ntt_64_forward"][1](keys)
    return out


def card_msm(n):
    """A gloo rank sharing cuda:0 with the others: msm_sharded of the n-point
    case, as affine ints."""
    dev = torch.device("cuda:0")
    mesh = PM.make_mesh(device=dev)
    assert mesh.staged
    sc, pts = _msm_tensors(G1, n, n)
    return device_point_to_ints(G1, PM.msm_sharded(G1, sc.to(dev), tuple(a.to(dev) for a in pts), mesh))
