#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (poly_commit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (times in ms):
  1. environment: the card's name and power limit, torch/CUDA/nvcc/triton
     versions, and the build of every kernel from poly_commit_tpu_torch/csrc
     (one nvcc per source, all at once);
  2. every kernel against its plain PyTorch version on the same inputs on
     the card, exactly (K1 ff mul/add/sub on the BLS12-381 base and scalar
     fields, the BN254 scalar and base fields and the BLS12-377 base and
     scalar fields at 2^20 columns, and at 2^10 and 1 (also from a CUDA
     graph, without the wrapper's host work); K1's power, the Fermat chain
     of every batched inversion, on the BLS12-381 base and scalar fields,
     the BN254 base field and the BLS12-377 base field at 1 and 2^12
     columns; K1's batched inversion at 2^20 columns of Fq-381, 2^15 of
     Fr-381, 2^11 of Fq-254 and 2^8 of Fq-377 (its launches: the tree's
     levels and one power) and its field sum at 2^16 of Fr-JubJub, each
     beside the loop of K1 launches it replaced; K2a the six G1 formulas
     on the BLS12-381, BN254 and BLS12-377 base fields and madd_scan, the
     MSM's within-lane scan in one launch, bit for bit at the 2^20 MSM's
     256 steps x 2^16 lanes, at a chunk of Hyrax's batched MSM, 128 steps
     x 2^18 lanes over 2^11 BN254 points, and at 16 steps x 2^10 lanes
     over 64 BLS12-377 points (the complete madd's edge lanes at 16
     steps), timed beside the loop of launches it replaced, and
     window_fold, an MSM's window fold in one launch, as group elements at
     the MSMs' shapes (one BLS12-381 row at c = 16 and at c = 4, 2^11 BN254
     rows at c = 8, one BLS12-377 row at c = 16), timed beside the tree of
     launches it replaced; K3,
     the stable digit sort, index for index at the 2^20 MSM's (16, 2^20)
     keys, the c = 8 MSMs' (32, 2^15) and a chunk of Hyrax's batched MSM
     (2^14, 2^11); K4a/K4b/K4c the NTT stages on the
     BN254 and BLS12-381 scalar fields, K4a's 2^9-point transform and K4c
     four stages in one launch each beside the chain of one-stage
     launches), with the kernel's, the plain
     version's and, where one PyTorch call computes the same function,
     that call's time;
  3. a 2^12-point MSM against the host big-int oracle;
  4. the main path: MarlinKZG10 over BLS12-381 setup(2^20 - 1) -> trim ->
     commit (hiding) -> batch_open -> batch_check, the opened value checked
     against host Horner evaluation, a tampered value rejected, and the
     launch count of every kernel over the run (the G1 MSMs in one
     madd_scan each, so at most 8 madd_distinct_packed launches); commit
     once more under torch.profiler (the device-busy share of its wall time,
     its five largest kernels by device time and host operations by host
     time); then the check stage's two MSMs and its pairing, timed apart on
     the same inputs; then a bounded run on the same SRS (main_path_bounded:
     trim with the bound 2^19 - 1, one hiding polynomial of that degree
     committed with its shifted commitment, batch_open, batch_check, the
     value against host Horner, a tampered value rejected);
  5. ntt: a 2^22-point NTT and iNTT over BN254 Fr (K4b + K4c) and a 2^9 one
     (one K4a launch each), against the portable field-last route, the
     round trip and host Horner at four points;
  6. ligero: MultilinearLigero over BN254 Fr at 22 variables, then
     UnivariateLigero over BLS12-381 Fr at degree 2^20 - 1, setup -> commit
     -> batch_open -> batch_check, the value against a host evaluation, a
     tampered value rejected, the launches; then commit's parts timed apart;
  7. multilinear_pc: MultilinearPC over BLS12-381 at 20 variables, setup ->
     trim -> commit -> open -> check, the value against the host MLE fold, a
     tampered value rejected, check's multi-pairing timed apart;
  8. ipa: InnerProductArgPC over JubJub at degree 2^16 - 1, one hiding
     polynomial, hash-to-curve -> setup -> trim -> commit -> batch_open ->
     batch_check, the value against host Horner, a tampered value rejected;
     then open again with its MSMs, their host window folds, the key
     folds and the inner products timed apart, and the first round's key
     fold once under torch.profiler; then one equation on the same SRS
     (ipa_equation: a p + b p2 + c, open_combinations ->
     check_combinations, a tampered value rejected);
  9. sonic: SonicKZG10 over BLS12-381 at degree 2^20 - 1, setup with the G2
     powers neg_powers_of_h (2^20 + 2 G1 and 2^20 G2 fixed-base
     multiplications; host powers, their conversion to limbs, G1 and G2
     fixed-base timed apart) ->
     trim with the bound 2^19 - 1 -> commit two hiding polynomials (degree
     2^20 - 1 unbounded, 2^19 - 1 bounded) -> batch_open both at two points
     -> batch_check; the four values against host Horner, a tampered value
     rejected, three G2 powers against the host;
  ark_golden: the three arkworks transcripts (MarlinKZG10, bounded and
     hiding MarlinKZG10, SonicKZG10) with commit and open on the card, each
     against its committed vector in tests/vectors/, one line a vector;
 10. brakedown: MultilinearBrakedown over BN254 Fr at 22 variables, setup
     -> trim -> commit -> batch_open -> batch_check, the value against a
     host evaluation, a tampered value rejected, the launches and peak
     memory; then commit's parts timed apart (encode, column bytes,
     Blake2s, Merkle tree);
 11. hyrax: Hyrax over BN254 at 22 variables (2048 rows of 2048), one
     hiding polynomial, setup -> trim -> commit -> open -> check, the value
     against the host MLE fold, a tampered proof rejected (z[0] + 1, and
     com_eval), the host window folds in commit counted (0: the batched
     MSM folds on the card) and commit's launches; then commit again with
     its batched MSM's parts timed apart (sort, scan, trees and gathers,
     device fold, fixed-base, normalisations), once under torch.profiler,
     and msm_rows on one chunk of rows at 16 to 256 lanes a window;
 12. pst13: MarlinPST13 over BLS12-381 at 10 variables and degree 12
     (646,646 SRS points), setup -> trim -> commit two dense polynomials
     over every monomial (one hiding) -> batch_open at one point ->
     batch_check, the values against the coefficients dotted with the
     monomial values at the point, a value plus one rejected, setup's and
     open's host parts timed apart (monomial enumeration, SRS scalar
     values, int-to-limb conversions, divide_at_point, evaluations); then a
     MarlinPST13_BLS12_377 round trip at 3 variables, degree 4;
 13. streaming_kzg: streaming KZG (Gemini) over BLS12-381 at degree
     2^20 - 1, three points (beta, -beta, beta^2), chunks of 2^16 and 16
     folds: the time prover (commit two polynomials, open,
     open_multi_points, batch_open_multi_points, commit_folding), the space
     prover (commit_chunked, open_chunked, open_multi_points_chunked,
     open_folding_chunked) and both verifiers on true and tampered values;
     every chunked group element against the time prover's, every
     remainder against long_divide's, the folding proof against the
     commitment of sum_j eta_j (f^(j) div Z), the last fold's commitment
     against a host fold and host MSM; each stage's K1 and K4 launches, and
     long_divide and the chunked opens under 0.1 K1 launches a
     coefficient;
 14. r1cs: on phase 8's IPA SRS (no second hash-to-curve), one non-hiding
     polynomial of degree 2^16 - 1 committed and opened, the verifier
     transcript replayed and the in-circuit IPA succinct check
     (IpaSuccinctCheckGadget) synthesised; satisfaction on the host and on
     the card (is_satisfied_device: its host build and card work timed
     apart, K1's launches), both True on the valid proof and False with the
     value plus one; rows, variables, nonzeros a matrix and the bucket
     widths;
 15. device_pairing: the BLS12-381 pairing on the card (core/pairing.py):
     e(G1, G2) against host_pairing's Fq12 value, e(P, Q) e(-P, Q) = 1
     with an infinite pair, an infinite input giving 1, and phase 4's
     Marlin batch_check (2 pairs) and phase 7's MultilinearPC check (21
     pairs) under POLY_COMMIT_PAIRING=device with the host engines'
     verdicts, on true and tampered values; the Miller loop, the final
     exponentiation and each check timed beside the host engine, with K1
     launches and host synchronisations counted;
  trace_persist: phase 4's Marlin key committed once under torch.profiler
     with POLY_COMMIT_TRACE=1 (the MarlinKZG10::commit and KZG10::commit
     spans and their times), then saved and loaded onto the card
     (utils/persist, seconds and file bytes) and the same polynomial
     committed with the loaded key, the commitments equal.
  mesh: the mesh layer (poly_commit_tpu_torch.parallel) on phase 4's
     MarlinKZG10 at degree 2^20 - 1: its commit, open and check under
     NCCL with one rank in this process, the bytes equal to phase 4's;
     then MESH_WORLD gloo ranks time-sharing cuda:0 (parallel/launch.py;
     their collectives staged through host memory), the keys handed over
     through utils/persist: phase 4's commitment and proof (a sharded MSM
     of 2^18 points a rank), a 2^22-point NTT over BN254 Fr and its
     inverse (ntt_sharded), Hyrax's row commitments at 22 variables (512
     rows a rank), the Brakedown and Ligero encodes and v^T M at phases 6
     and 10's shapes, an IPA-PC open at degree 2^10 - 1, a PST13 commit on
     phase 12's key, and on a 2x2 mesh the Marlin commit over dp and the
     NTT over tp; each equal to the single-device result of this run, with
     the ranks' and the single-device ms (four ranks on one card: not a
     scaling figure).
  demo: the port's entry point (poly_commit_tpu_torch/demo.py), its ten
     drives (degree <= 16, 4 variables; setup -> trim -> commit -> open ->
     check and a tamper probe) in this process on the card, twice (the
     first run pays each scheme's first calls), every drive OK, the ms by
     scheme and stage and the launches of each run; then five of them on
     the CPU (the plain versions), commitments and values equal to the
     card's.
Phase 1 also prints a build line: each kernel source's nvcc seconds, per
kernel entry the registers and spill bytes ptxas reported, and the
machine instructions (and integer multiply-adds) of the K1, K2a and K4
kernels from cuobjdump. Phase 2
also holds K2c (the six G2 formulas on the BLS12-381 and BLS12-377 Fq2)
and K2b (the four JubJub formulas, and ed_smul, the one-launch scalar
multiplication, at 2^15 points and at 1, also against the chain of
ed_double / ed_add launches it replaced) against their plain versions, and
phase 3 also runs a G2 and a JubJub MSM of 2^10 points against the host.
Phases 4-15, ark_golden, trace_persist, mesh and demo are the paths: each runs
with every launch count set to 0 just before it and read just after (the
mesh phase's ranks count their own and return them); the kernel table sums
them.
Each path's line also splits K1's launches by columns (1, under 2^16,
2^16 and up), and a k1_launches line sums that split over phases 4-8
(without the bounded run, phase 8's equation, phases 9-15, ark_golden and
trace_persist,
so that it stays comparable with earlier runs). K1 and K2a count their
launches by field: their kernel-table entries are per field.
A k4c_launches line sums K4c's launches over phases 4-8 (at most 20 with
several stages a launch). Then the kernel table, the nvidia-smi line, and
{"ok": true, "device": ...}.
Any failure exits non-zero; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
IMAD_PER_SM_PER_CLK = 64  # 32-bit integer multiply-add, compute capability 9.0
LOG_DEGREE = 20  # the main path's degree is 2^20 - 1
LIGERO_NUM_VARS = 22  # the top of the reference's Ligero bench (ligero_ml_times.rs)
NTT_LOG_N = 22
MLPC_NUM_VARS = 20  # MultilinearPC at 2^20 evaluations, the main path's scale
IPA_LOG_DEGREE = 16  # IPA-PC at degree 2^16 - 1: host hash-to-curve bounds setup
SIDE_MSM_LOG_N = 10  # the G2 and JubJub MSMs of phase 3 (host oracle cost)
BRAKEDOWN_NUM_VARS = 22  # the top of the reference's Brakedown bench
HYRAX_NUM_VARS = 22  # the top of the reference's Hyrax bench: 2048 rows of 2048
PST13_NUM_VARS = 10  # the reference's own PST13 tests
PST13_DEGREE = 12  # C(22, 12) = 646,646 SRS points, ~2^19.3: the KZG paths' scale
STREAM_POINTS = 3  # Gemini's beta, -beta, beta^2
STREAM_CHUNK = 1 << 16
STREAM_DEPTH = 16  # the most folds a 2^16 chunk admits
IMAD_PER_PRODUCT = 4 * 8 * 8 + 8  # CIOS on 8 32-bit words
IMAD_PER_FQ_PRODUCT = 4 * 12 * 12 + 12  # CIOS on 12 32-bit words
MESH_WORLD = 4  # the mesh phase's gloo ranks, time-sharing the one card
MESH_IPA_LOG_DEGREE = 10  # its IPA open (a fresh hash-to-curve of 2^10 + 2 generators)
MESH_TIMEOUT_S = 300  # its ranks' join timeout
# the mesh layer's functions that the mesh phase times and counts
# (parallel/mesh.py): the sharded entry points, whose calls show that a
# scheme's mesh branch ran, the six-step NTT's transposes, the digest guard
# and the collectives
MESH_SPANS = ("msm_sharded", "batch_msm_sharded", "map_rows", "batch_ntt_sharded",
              "row_mul_sharded", "fold_key_sharded", "_transpose_sharded", "_digest",
              "_check_replicated", "_all_gather", "_all_to_all")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def horner(ints, x, p):
    """The polynomial with coefficients ``ints`` (lowest first) at x, mod p,
    on host ints."""
    acc = 0
    for c in reversed(ints):
        acc = (acc * x + c) % p
    return acc


def time_ms(fn, reps):
    """Device time of one call, from CUDA events around ``reps`` calls
    (after one call to warm up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_ms(fn):
    """fn()'s result and the device time of that one call, cold, from CUDA
    events (for a plain version too slow to run twice)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
SASS_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(path):
    """Per kernel in a built library, from the toolkit's ``cuobjdump -sass``:
    its machine instructions (every function it calls included, as
    cuobjdump lists them with the kernel) and, of those, the integer
    multiply-adds (IMAD*, without the IMAD.MOV moves). Empty where the
    toolkit has no cuobjdump."""
    from poly_commit_tpu_torch import device as D

    tool = Path(D.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        m = SASS_FUNCTION.match(line)
        if m:
            current = counts.setdefault(m.group(1), {"instructions": 0, "imad": 0})
            continue
        m = SASS_INSTR.match(line)
        if m and current is not None:
            current["instructions"] += 1
            op = m.group(1)
            current["imad"] += op.startswith("IMAD") and not op.startswith("IMAD.MOV")
    return dict(zip(D.kernel_names(list(counts)), counts.values()))


def graph_ms(fn, reps):
    """Device time of one call from a CUDA graph of ``reps`` calls: the
    launches run back to back, without the wrapper's host work between
    them (the time of the kernel where the host would be the slower)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def timed(into, name, fn):
    """fn(), its host wall ms (between two synchronizes) stored at into[name]."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    into[name] = (time.perf_counter() - t0) * 1e3
    return out


@contextlib.contextmanager
def spans(targets, key=None):
    """Within the block, each ``(module, attribute)`` function is wrapped so
    that its calls' host wall ms (between two synchronizes) and count add up
    in the yielded dict under the attribute's name, or under
    ``key(attribute, args)`` where given. A wrapped kernel wrapper keeps
    its count attributes, so it can still count its launches."""
    import functools

    import torch

    out = {}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in targets]

    def wrap(attr, fn):
        @functools.wraps(fn)
        def timed_call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            torch.cuda.synchronize()
            name = attr if key is None else key(attr, args)
            ms, calls = out.get(name, (0.0, 0))
            out[name] = (ms + (time.perf_counter() - t0) * 1e3, calls + 1)
            return res
        return timed_call

    for mod, attr, fn in saved:
        setattr(mod, attr, wrap(attr, fn))
    try:
        yield out
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def env(name, value):
    """os.environ[name] = value within the block (unset for None)."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def count_syncs(fn):
    """fn()'s result and the number of CUDA operations in it that made the
    host wait for the device: torch's sync debug mode warns once for each."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def ipa_gadget(r1cs, inst, value, degree):
    """IpaSuccinctCheckGadget.succinct_check synthesised over one IPA-PC
    opening (tests/test_r1cs.py's circuit) with the claimed ``value``."""
    from poly_commit_tpu_torch.core import field_params as FP

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


class Smoke:
    # K1 builds the main path runs: the base field's mul and pow
    # (normalisation) and sub (point negation), the scalar field's mul and
    # add (from_mont, evaluation, division)
    MAIN_PATH_FF = ("ff_mont_mul[fq_bls12_381]", "ff_pow[fq_bls12_381]", "ff_sub[fq_bls12_381]",
                    "ff_batch_inv[fq_bls12_381]", "ff_mont_mul[fr_bls12_381]", "ff_add[fr_bls12_381]")
    # and those the Ligero paths run: the BN254 scalar field's mul, add and
    # sub (tensors, folds, v = b^T M, column bytes) for MultilinearLigero,
    # BLS12-381's mul and add for UnivariateLigero
    LIGERO_FF = {"ml": ("ff_mont_mul[fr_bn254]", "ff_add[fr_bn254]", "ff_sub[fr_bn254]"),
                 "uni": ("ff_mont_mul[fr_bls12_381]", "ff_add[fr_bls12_381]")}
    NTT_KERNELS = ("ntt_small", "ntt_fused_stages", "ntt_stages")
    # phase 2's K4 shape: Ligero's 256 rows of 2^15 points, and the pairs of
    # K4a's one-stage form
    NTT_KERNEL_SHAPE = (1 << 23, 15, 1 << 21)
    NTT_SMALL_LOG_N = 9  # phase 5's K4a transform
    # the K2a entries the main path runs: fixed-base setup's madd and
    # madd_distinct, the MSMs' scan, the lane tree's and Abel sums' add, and
    # setup's doublings (the packed formulas ran the scan before madd_scan),
    # and the MSMs' window fold
    MAIN_PATH_EC = ("ec_madd", "ec_madd_distinct", "ec_add", "ec_double", "ec_madd_scan",
                    "ec_window_fold")
    MAX_K4C_LAUNCHES = 20  # phases 4-8, with several K4c stages a launch
    MAX_PACKED_MADD_LAUNCHES = 8  # phase 4: the G1 MSMs scan in madd_scan

    def __init__(self):
        import torch

        from poly_commit_tpu_torch.core import ec_lf, ff, ntt_lf, sort_gpu

        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(20261016)
        self.kernels = {}  # name -> JSON entry
        self.totals = {}  # name -> launches summed over the driven paths
        self.size_totals = {}  # K1 wrapper -> launches by columns, summed over phases 4-8
        self.k4c_launches = 0  # K4c's launches summed over phases 4-8
        self.mesh_keys = {}  # keys of phases 10-12 that the mesh phase reuses
        self.ff_ops = {"mul": ff.mont_mul, "add": ff.add, "sub": ff.sub}
        self.ff_wrappers = {**{f"ff_{w.__name__}": w for w in self.ff_ops.values()},
                            "ff_pow": ff.mont_pow, "ff_batch_inv": ff.batch_inv, "ff_sum": ff.fsum}
        # K2a counts its launches by field too: BLS12-381 on phases 4-9, BN254
        # on phase 11
        self.k2a_wrappers = {f"ec_{w.__name__}": w for w in ec_lf.WRAPPERS}
        self.ec_wrappers = ec_lf.WRAPPERS + ec_lf.G2_WRAPPERS + ec_lf.ED_WRAPPERS
        self.wrappers = {
            **self.ff_wrappers,
            **{f"ec_{w.__name__}": w for w in ec_lf.WRAPPERS + ec_lf.G2_WRAPPERS + ec_lf.ED_WRAPPERS},
            "digit_sort": sort_gpu.digit_sort,
            **{f"ntt_{w.__name__}": w for w in ntt_lf.WRAPPERS},
        }
        ntt_src = "poly_commit_tpu_torch/csrc/ntt.cu"
        self.sources = {"ff": "poly_commit_tpu_torch/csrc/ff.cu",
                        "scan": "poly_commit_tpu_torch/csrc/ec_g1.cu",
                        "pow": "poly_commit_tpu_torch/csrc/ff.cu",
                        "inv": "poly_commit_tpu_torch/csrc/ff.cu",
                        "sum": "poly_commit_tpu_torch/csrc/ff.cu",
                        "ec": "poly_commit_tpu_torch/csrc/ec_g1.cu",
                        "fold": "poly_commit_tpu_torch/csrc/ec_g1.cu",
                        "g2": "poly_commit_tpu_torch/csrc/ec_g2.cu",
                        "ed": "poly_commit_tpu_torch/csrc/ec_ed.cu",
                        "digit": "poly_commit_tpu_torch/csrc/digit_sort.cu",
                        "k4a": ntt_src, "k4b": ntt_src, "k4c": ntt_src}
        # the power: _ff_inv's lax.scan (poly_commit_tpu/core/msm_tpu.py:850)
        # runs the TPU's K1 once a product; the inversion tree and the sum
        # replace loops of K1 launches (IPA's _fsum, pcs/ipa_pc.py:212)
        self.replaces = {"ff": "poly_commit_tpu/core/ff.py:293",
                         "pow": "poly_commit_tpu/core/ff.py:293",
                         "inv": "poly_commit_tpu/core/ff.py:293",
                         "sum": "poly_commit_tpu/core/ff.py:293",
                         "ec": "poly_commit_tpu/core/ec_lf.py:455",
                         # madd_scan: msm_tpu.py:506's lax.scan runs K2a once a step
                         "scan": "poly_commit_tpu/core/ec_lf.py:455",
                         # window_fold: _combine_sw_device and _fold_device
                         # run K2a once a doubling or add
                         "fold": "poly_commit_tpu/core/msm_tpu.py:622",
                         "g2": "poly_commit_tpu/core/ec_lf.py:455",
                         "ed": "poly_commit_tpu/core/ec_lf.py:455",
                         "digit": "poly_commit_tpu/core/sort_tpu.py:141",
                         "k4a": "poly_commit_tpu/core/ntt_lf.py:48",
                         "k4b": "poly_commit_tpu/core/ntt_lf.py:93",
                         "k4c": "poly_commit_tpu/core/ntt_lf.py:179"}

    # -- launch counts over a driven path -----------------------------------
    def reset_counts(self):
        for w in self.wrappers.values():
            w.launches = 0
        for w in self.ec_wrappers:
            w.launches_by_field.clear()
        for w in self.ff_wrappers.values():
            w.launches_by_field.clear()
            w.launches_by_size.update(dict.fromkeys(w.launches_by_size, 0))

    def read_counts(self, in_sums=True):
        """(launches per wrapper, launches per K1 and K2a build, K1 launches
        per wrapper by columns: 1, under 2^16, 2^16 and up), added to the totals
        (the kernel table); for phases 4-8 (``in_sums``) also to the sums
        over those phases (the k1_launches and k4c_launches lines)."""
        launches = {name: w.launches for name, w in self.wrappers.items()}
        by_field = {f"{name}[{f}]": count
                    for name, w in {**self.ff_wrappers, **self.k2a_wrappers}.items()
                    for f, count in w.launches_by_field.items()}
        by_size = {name: dict(w.launches_by_size) for name, w in self.ff_wrappers.items()}
        for name, count in {**launches, **by_field}.items():
            self.totals[name] = self.totals.get(name, 0) + count
        if not in_sums:
            return launches, by_field, by_size
        self.k4c_launches += launches["ntt_stages"]
        for name, sizes in by_size.items():
            into = self.size_totals.setdefault(name, dict.fromkeys(sizes, 0))
            for size, count in sizes.items():
                into[size] += count
        return launches, by_field, by_size

    def all_launched(self, launches, by_field, needed):
        """Every kernel in ``needed`` ran in this path, and every K1 and K2a
        build that ran has a phase-2 entry (held against its plain version)."""
        counts = {**launches, **by_field}
        return all(counts.get(k, 0) > 0 for k in needed) and all(k in self.kernels for k in by_field)

    def finish_table(self):
        """Each entry's launches over the paths; K1 builds no path ran are
        dropped. False if any other kernel never ran."""
        for name, entry in self.kernels.items():
            entry["launches"] = self.totals.get(name, 0)
        for name in [k for k, v in self.kernels.items() if not v["launches"] and k.startswith("ff_")]:
            del self.kernels[name]
        return all(v["launches"] > 0 for v in self.kernels.values())

    # -- helpers ----------------------------------------------------------
    def rand_field(self, spec, n):
        """(L, n) int32 canonical limbs: random, top limb below p's."""
        torch = self.torch
        t = torch.randint(0, 1 << 16, (spec.n_limbs, n), generator=self.gen, device=self.dev,
                          dtype=torch.int32)
        top = (spec.modulus >> (16 * (spec.n_limbs - 1)))
        t[-1] = torch.randint(0, top, (n,), generator=self.gen, device=self.dev, dtype=torch.int32)
        return t

    def entry(self, name, kind, max_abs_err, ms, plain_ms, n_bytes, n_imad, library_ms=None,
              limbs=True):
        """A kernel-table entry. ``n_bytes`` counts the int32-per-16-bit-limb
        layout the kernels take; for limb data (``limbs``) the bound moves
        2 bytes a limb, the least a field element needs. Returns the line's
        bound keys: the bound, and the layout's bound beside it."""
        t_layout = n_bytes / HBM_BYTES_PER_S * 1e3
        t_bytes = t_layout / 2 if limbs else t_layout
        t_ops = n_imad / self.imad_per_s * 1e3
        self.kernels[name] = {
            "name": name, "route": "cuda", "source": self.sources[kind],
            "replaces": self.replaces[kind], "launches": None, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms,
        }
        return {"bound_ms": max(t_bytes, t_ops), "layout_bound_ms": max(t_layout, t_ops)}

    def canon_err(self, spec, a, b):
        """max |difference| of the canonical limbs of two (L, N) tensors."""
        from poly_commit_tpu_torch.core import ff

        d = ff.canonicalize(spec, a).long() - ff.canonicalize(spec, b).long()
        return int(d.abs().max()) if d.numel() else 0

    def lazy(self, spec, n):
        """(L, n) random limbs in the lazy range [0, 2p)."""
        from poly_commit_tpu_torch.core import ff

        return ff.plain("add", spec, self.rand_field(spec, n), self.rand_field(spec, n))

    def bound(self, n_bytes, n_imad):
        """entry()'s bound keys, for a kernel without a table entry."""
        t_layout = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_imad / self.imad_per_s * 1e3
        return {"bound_ms": max(t_layout / 2, t_ops), "layout_bound_ms": max(t_layout, t_ops)}

    # -- phase 1 ----------------------------------------------------------
    def environment(self):
        from poly_commit_tpu_torch import device as D

        torch = self.torch
        name_power = nvidia_smi("name,power.limit")
        max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.imad_per_s = sms * IMAD_PER_SM_PER_CLK * max_clock_mhz * 1e6
        tool = D.toolchain()
        build_s = D.build()
        emit({"phase": "environment", "gpu": name_power, "sms": sms, "max_sm_clock_mhz": max_clock_mhz,
              "imad_per_s": self.imad_per_s, "torch": tool["torch"], "cuda": tool["cuda"],
              "nvcc": tool["nvcc"], "triton": tool["triton"], "build_ms": build_s * 1e3})
        ptxas = {name: D.ptxas_report(D.build_log(name)) for name in D.SOURCES}

        def nw12(entries):  # the 12-word (BLS12-381/377) kernels and the calls they make
            return [e for e in entries if "<12" in e["entry"] or "ILi12E" in e["entry"]]

        def spill_bytes(entries):
            return sum(e.get("spill_stores", 0) + e.get("spill_loads", 0) for e in entries)

        g1_12, g2_12 = nw12(ptxas["ec_g1"]), nw12(ptxas["ec_g2"])
        # machine instructions per kernel (the product's body counted in each
        # kernel that calls or inlines it)
        sass = {name: sass_counts(D.library_path(name)) for name in ("ff", "ec_g1", "ntt")}
        emit({"phase": "build", "nvcc_s": D.BUILD_SECONDS, "ptxas": ptxas,
              "g1_nw12_entries": len(g1_12), "g1_nw12_spill_bytes": spill_bytes(g1_12),
              "g2_nw12_entries": len(g2_12), "g2_nw12_spill_bytes": spill_bytes(g2_12),
              "sass": sass})
        return name_power

    # -- phase 2 ----------------------------------------------------------
    def check_ff(self):
        from poly_commit_tpu_torch.core import ff
        from poly_commit_tpu_torch.core import field_params as FP

        ok = True
        # the main path's shape: 2^20 lanes of the scalar field (the prover's
        # polynomial work) and of the base field (the SRS normalisation);
        # BN254's scalar field is Ligero's and Brakedown's, its base field
        # Hyrax's (normalisation, negation), JubJub's IPA-PC's; BLS12-377's
        # fields are MarlinPST13_BLS12_377's (phase 12).
        for spec in (FP.FQ_BLS12_381, FP.FR_BLS12_381, FP.FR_BN254, FP.FR_JUBJUB, FP.FQ_BN254,
                     FP.FQ_BLS12_377, FP.FR_BLS12_377):
            n = 1 << 20
            a, b = self.rand_field(spec, n), self.rand_field(spec, n)
            a = ff.plain("add", spec, a, b)  # values up to 2p: the lazy range
            for op, fn in self.ff_ops.items():
                got = fn(spec, a, b)
                want = ff.plain(op, spec, a, b)
                err = int((got.long() - want.long()).abs().max())  # bit for bit
                ok &= err == 0
                ms = time_ms(lambda: fn(spec, a, b), 20)
                plain_ms = time_ms(lambda: ff.plain(op, spec, a, b), 1)
                name = f"ff_{fn.__name__}[{spec.name}]"
                line = {"phase": "kernels", "kernel": name, "n": n, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms}
                line["device_ms"] = graph_ms(lambda: fn(spec, a, b), 20)
                n_bytes, n_imad = self.ff_work(spec, op, n)
                emit({**line, **self.entry(name, "ff", err, ms, plain_ms, n_bytes, n_imad)})
        return ok and self.check_ff_small()

    @staticmethod
    def ff_work(spec, op, n):
        """Bytes (two operands read, one written, int32 per 16-bit limb) and
        IMADs of one elementwise K1 launch on n columns."""
        nw = spec.n_limbs // 2
        return 3 * spec.n_limbs * 4 * n, (4 * nw * nw + nw) * n if op == "mul" else 0

    # the columns most K1 launches of the paths take (a batch of a few
    # thousand points or fewer, one value)
    FF_SMALL_COLUMNS = (1 << 10, 1)

    def check_ff_small(self):
        """The elementwise K1 ops bit for bit at FF_SMALL_COLUMNS on the
        24- and 16-limb builds, through the wrapper (``ms``) and from a CUDA
        graph (``device_ms``: the launches alone, without the wrapper's host
        work)."""
        from poly_commit_tpu_torch.core import ff
        from poly_commit_tpu_torch.core import field_params as FP

        ok = True
        for spec in (FP.FQ_BLS12_381, FP.FR_BLS12_381):
            for n in self.FF_SMALL_COLUMNS:
                a, b = self.lazy(spec, n), self.lazy(spec, n)
                for op, fn in self.ff_ops.items():
                    err = int((fn(spec, a, b).long() - ff.plain(op, spec, a, b).long()).abs().max())
                    ok &= err == 0
                    emit({"phase": "kernels", "kernel": f"ff_{fn.__name__}[{spec.name}]", "n": n,
                          "max_abs_err": err, "ms": time_ms(lambda: fn(spec, a, b), 200),
                          "device_ms": graph_ms(lambda: fn(spec, a, b), 200),
                          "plain_ms": time_ms(lambda: ff.plain(op, spec, a, b), 5),
                          **self.bound(*self.ff_work(spec, op, n))})
        return ok

    POW_COLUMNS = (1, 1 << 12)  # a product-tree root (the paths' shape), and a batch

    @staticmethod
    def mul_chain(spec, a, e):
        """a^e as the port computed it before ``ff.mont_pow``: square and
        multiply, MSB first, one K1 mul launch a product."""
        from poly_commit_tpu_torch.core import ff

        acc = ff.one_mont(spec, a.shape[1], a.device)
        for bit in bin(e)[2:]:
            acc = ff.mont_mul(spec, acc, acc)
            if bit == "1":
                acc = ff.mont_mul(spec, acc, a)
        return acc

    def check_ff_pow(self):
        """K1's power kernel against its plain version, limb for limb, on
        the Fermat exponent p - 2 of the fields whose inversions the paths
        run (Fq-381: G1 and Fq2 normalisation; Fr-381: JubJub, the streaming
        KZG divisions; Fq-254: Hyrax's BN254 G1; Fq-377: MarlinPST13_BLS12_377's
        G1), at
        the paths' one column (the table entry) and at 2^12, timed beside
        the chain of mul launches it replaced (``chain_ms``, equal limb for
        limb)."""
        from poly_commit_tpu_torch.core import ff
        from poly_commit_tpu_torch.core import field_params as FP

        ok = True
        for spec in (FP.FQ_BLS12_381, FP.FR_BLS12_381, FP.FQ_BN254, FP.FQ_BLS12_377):
            e = spec.modulus - 2
            products = e.bit_length() + bin(e).count("1")
            nw = spec.n_limbs // 2
            for m in self.POW_COLUMNS:
                a = self.lazy(spec, m)
                if m > 1:
                    a[:, 0] = 0  # a zero column
                got = ff.mont_pow(spec, a, e)
                want = ff.plain_pow(spec, a, e)
                err = int((got.long() - want.long()).abs().max())
                chain_err = int((self.mul_chain(spec, a, e).long() - want.long()).abs().max())
                ok &= err == 0 and chain_err == 0
                ms = time_ms(lambda: ff.mont_pow(spec, a, e), 10)
                chain_ms = time_ms(lambda: self.mul_chain(spec, a, e), 5)
                plain_ms = time_ms(lambda: ff.plain_pow(spec, a, e), 1)
                # one column read and written; ~1.5 log2 p dependent products each
                n_bytes = 2 * spec.n_limbs * 4 * m
                n_imad = products * (4 * nw * nw + nw) * m
                name = f"ff_pow[{spec.name}]"
                line = {"phase": "kernels", "kernel": name, "m": m, "products": products,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "chain_max_abs_err": chain_err, "chain_ms": chain_ms}
                if m != 1:
                    emit({**line, **self.bound(n_bytes, n_imad)})
                    continue
                emit({**line, **self.entry(name, "pow", err, ms, plain_ms, n_bytes, n_imad)})
        return ok

    MAX_INV_LAUNCHES = 6  # a batched inversion of 2^20 columns: its tree's levels and one power
    # setup's normalisation (2^20 G1 points), IPA-PC's first key fold
    # (2^15 JubJub points), Hyrax's row commitments (2^11 BN254 points) and
    # MarlinPST13_BLS12_377's setup at nv 3, degree 4 (256 doublings)
    INV_COLUMNS = {"fq_bls12_381": 1 << 20, "fr_bls12_381": 1 << 15, "fq_bn254": 1 << 11,
                   "fq_bls12_377": 1 << 8}

    @staticmethod
    def tree_loop(spec, a):
        """Inverses as the port computed them before ``ff.batch_inv``: a
        product tree of K1 mul launches up, one ``mont_pow`` on its root,
        two mul launches a level down, PyTorch copies between them."""
        import torch

        from poly_commit_tpu_torch.core import ff

        L, m = a.shape
        dev = a.device
        zero = ff.is_zero(spec, a)
        n2 = 1 << max(0, (m - 1).bit_length())
        cur = ff.select(zero, ff.one_mont(spec, m, dev), a)
        if n2 != m:
            cur = torch.cat([cur, ff.one_mont(spec, n2 - m, dev)], 1)
        levels = [cur]
        while cur.shape[1] > 1:
            cur = ff.mont_mul(spec, cur[:, 0::2].contiguous(), cur[:, 1::2].contiguous())
            levels.append(cur)
        inv = ff.mont_pow(spec, cur, spec.modulus - 2)
        for lvl in reversed(levels[:-1]):
            inv_l = ff.mont_mul(spec, inv, lvl[:, 1::2].contiguous())
            inv_r = ff.mont_mul(spec, inv, lvl[:, 0::2].contiguous())
            inv = torch.stack([inv_l, inv_r], dim=2).reshape(L, -1)
        return ff.select(zero, ff.zeros(spec, m, dev), inv[:, :m].contiguous())

    def check_batch_inv(self):
        """K1's inversion tree against its plain version (canonical values)
        at INV_COLUMNS, lazy values with a zero column and an unreduced zero
        (p); timed beside the loop of launches it replaced (``chain_ms``,
        equal in canonical values). One call launches only the tree's levels
        and one ``mont_pow``, at most MAX_INV_LAUNCHES kernels, and
        x * x^-1 = 1 in every nonzero column, zero in the zero ones."""
        from poly_commit_tpu_torch.core import ff
        from poly_commit_tpu_torch.core import field_params as FP

        torch = self.torch
        ok = True
        for spec in (FP.FQ_BLS12_381, FP.FR_BLS12_381, FP.FQ_BN254, FP.FQ_BLS12_377):
            m = self.INV_COLUMNS[spec.name]
            x = self.lazy(spec, m)
            x[:, 0] = 0
            x[:, 1] = ff.consts(spec, self.dev, 0)[:, 0].to(torch.int32)
            before = {k: w.launches for k, w in self.ff_wrappers.items()}
            got = ff.batch_inv(spec, x)
            launches = {k: w.launches - before[k] for k, w in self.ff_wrappers.items()}
            launches = {k: v for k, v in launches.items() if v}
            want, plain_ms = run_ms(lambda: ff.batch_inv_plain(spec, x))
            err = self.canon_err(spec, got, want)
            del want
            chain_err = self.canon_err(spec, self.tree_loop(spec, x), got)
            one = ff.canonicalize(spec, ff.plain("mul", spec, x, got))
            nonzero = ~ff.is_zero(spec, x)
            inverted = (bool((one[:, nonzero] == ff.one_mont(spec, 1, self.dev)).all())
                        and not bool(one[:, ~nonzero].any()))
            tree_only = set(launches) == {"ff_batch_inv", "ff_pow"} and launches["ff_pow"] == 1
            few = sum(launches.values()) <= self.MAX_INV_LAUNCHES
            ok &= err == 0 and chain_err == 0 and inverted and tree_only and few
            ms = time_ms(lambda: ff.batch_inv(spec, x), 10)
            chain_ms = time_ms(lambda: self.tree_loop(spec, x), 3)
            # the columns read once and their inverses written once; three
            # products a column (one up, two down) and the root's power
            e = spec.modulus - 2
            products = 3 * m + e.bit_length() + bin(e).count("1")
            nw = spec.n_limbs // 2
            name = f"ff_batch_inv[{spec.name}]"
            bounds = self.entry(name, "inv", err, ms, plain_ms, 2 * spec.n_limbs * 4 * m,
                                products * (4 * nw * nw + nw))
            emit({"phase": "kernels", "kernel": name, "m": m, "max_abs_err": err,
                  "chain_max_abs_err": chain_err, "launches": launches, "inverted": inverted,
                  "tree_and_one_pow_only": tree_only, f"at_most_{self.MAX_INV_LAUNCHES}": few,
                  "ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms, **bounds})
        return ok

    SUM_COLUMNS = 1 << 16  # an inner product of IPA-PC at degree 2^16 - 1

    @staticmethod
    def halving_loop(spec, a):
        """The sum as IPA-PC's ``_fsum`` computed it before ``ff.fsum``: a
        halving loop of field-last adds (transposes, one K1 add launch and a
        canonicalisation each)."""
        from poly_commit_tpu_torch.core import ff
        from poly_commit_tpu_torch.core import field as F

        fl = ff.to_field_last(a, (a.shape[1],))
        while fl.shape[0] > 1:
            half = fl.shape[0] // 2
            fl = F.add(spec, fl[:half], fl[half : 2 * half])
        return ff.from_field_last(fl)

    def check_fsum(self):
        """K1's field sum against its plain version (canonical values) at
        SUM_COLUMNS of Fr-JubJub, lazy values, in at most two launches;
        timed beside the halving loop it replaced (``chain_ms``)."""
        from poly_commit_tpu_torch.core import ff
        from poly_commit_tpu_torch.core import field_params as FP

        spec, n = FP.FR_JUBJUB, self.SUM_COLUMNS
        a = self.lazy(spec, n)
        before = ff.fsum.launches
        got = ff.fsum(spec, a)
        launches = ff.fsum.launches - before
        err = self.canon_err(spec, got, ff.fsum_plain(spec, a))
        chain_err = self.canon_err(spec, got, self.halving_loop(spec, a))
        ms = time_ms(lambda: ff.fsum(spec, a), 50)
        device_ms = graph_ms(lambda: ff.fsum(spec, a), 50)
        chain_ms = time_ms(lambda: self.halving_loop(spec, a), 5)
        plain_ms = time_ms(lambda: ff.fsum_plain(spec, a), 1)
        # the columns read once, the sum written once; no products
        bounds = self.entry(f"ff_sum[{spec.name}]", "sum", err, ms, plain_ms,
                            spec.n_limbs * 4 * (n + 1), 0)
        emit({"phase": "kernels", "kernel": f"ff_sum[{spec.name}]", "n": n, "max_abs_err": err,
              "chain_max_abs_err": chain_err, "launches": launches, "ms": ms,
              "device_ms": device_ms, "chain_ms": chain_ms, "plain_ms": plain_ms, **bounds})
        return err == 0 and chain_err == 0 and launches <= 2

    def host_points(self, group, n, seed):
        """n distinct affine points a G + i b G (host Jacobian walk, one
        batched host inversion)."""
        import random

        from poly_commit_tpu_torch.core import hostec

        hg = hostec.host_group(group)
        rnd = random.Random(seed)
        q = group.spec.modulus
        a = hg.mul_fast((group.gen_x, group.gen_y), rnd.randrange(1, group.scalar_spec.modulus))
        b = hg.mul_fast((group.gen_x, group.gen_y), rnd.randrange(1, group.scalar_spec.modulus))
        jac = [(a[0], a[1], 1)]
        for _ in range(n - 1):
            jac.append(hg._jmadd(jac[-1], b))
        pref = [1]
        for _, _, z in jac:
            pref.append(pref[-1] * z % q)
        inv = pow(pref[-1], -1, q)
        pts = [None] * n
        for i in range(n - 1, -1, -1):
            x, y, z = jac[i]
            zi = inv * pref[i] % q
            inv = inv * z % q
            pts[i] = (x * zi * zi % q, y * zi * zi * zi % q)
        return pts

    # the within-lane scan at the shapes of the paths, (steps, lanes,
    # points): the 2^20 MSM's 256 steps x 2^16 lanes (BLS12-381), and a
    # chunk of Hyrax's batched MSM at 22 variables, 512 rows x 32 windows x
    # 16 lanes of 128 steps over 2^11 points (BN254)
    SCAN_SHAPES = {"fq_bls12_381": (256, 1 << 16, 1 << 20), "fq_bn254": (128, 1 << 18, 1 << 11),
                   # MarlinPST13_BLS12_377 at nv 3, degree 4: 64 windows x 16 lanes
                   # over at most 35 points
                   "fq_bls12_377": (16, 1 << 10, 1 << 6)}

    def check_ec(self):
        """K2a's formulas on the BLS12-381, BN254 and BLS12-377 base fields,
        and madd_scan at each one's path shape."""
        from poly_commit_tpu_torch.core import curve

        ok = True
        for group in (curve.BLS12_381_G1, curve.BN254_G1, curve.BLS12_377_G1):
            ok &= self.check_ec_formulas(group)
            ok &= self.check_ec_scan(group.spec, *self.SCAN_SHAPES[group.spec.name])
            ok &= self.check_ec_fold(group)
        return ok

    # the window fold at the shapes of the paths, (c, rows): Marlin's SRS
    # MSMs (c = 16) and hiding MSMs (c = 4), one row each; Hyrax's 2^11 row
    # MSMs at c = 8; PST13's BLS12-377 MSMs at c = 16
    FOLD_SHAPES = {"fq_bls12_381": ((16, 1), (4, 1)), "fq_bn254": ((8, 1 << 11),),
                   "fq_bls12_377": ((16, 1),)}

    def check_ec_fold(self, group):
        """K2a's one-launch window fold against its plain version (the
        halving tree of the plain formulas, on the card) and against the
        tree of K2a launches it replaced (``chain_ms``), as group elements
        (affine, canonical: the kernel folds by Horner, the trees by
        halves), at each FOLD_SHAPES shape. The parts are fixed-base
        multiples of the generator (random z); in row 0 window 3 has G_last
        = sum G and window 5 G_last at infinity; with several rows, row 1 is
        all at infinity (a row of zero scalars). A fold is one launch and no
        other K2a."""
        from poly_commit_tpu_torch.core import ec_lf, ff, msm_gpu

        torch = self.torch
        spec = group.spec
        nw = spec.n_limbs // 2
        gx = ff.from_ints(spec, [group.gen_x], device=self.dev)
        gy = ff.from_ints(spec, [group.gen_y], device=self.dev)

        def affine(p):
            return msm_gpu.jacobian_to_affine(spec, p)

        def err(got, want):
            return max(self.canon_err(spec, g, w) for g, w in zip(affine(got), affine(want)))

        ok = True
        for k, (c, rows) in enumerate(self.FOLD_SHAPES[spec.name]):
            windows = msm_gpu.SCALAR_BITS // c
            m = rows * windows
            scal = torch.randint(0, 1 << 16, (2 * m, 16), generator=self.gen, device=self.dev,
                                 dtype=torch.int32)
            pts = msm_gpu.fixed_base(group, gx, gy, scal)
            parts = [cc[:, :m].contiguous() for cc in pts] + [cc[:, m:].contiguous() for cc in pts]
            for j in range(3):
                parts[3 + j][:, 3] = parts[j][:, 3]
            parts[2][:, 5] = 0
            if rows > 1:
                parts[2][:, windows : 2 * windows] = 0
                parts[5][:, windows : 2 * windows] = 0
            parts = tuple(parts)
            before = {name: w.launches for name, w in self.k2a_wrappers.items()}
            got = ec_lf.window_fold(spec, parts, c, rows)
            launches = {name: w.launches - before[name] for name, w in self.k2a_wrappers.items()
                        if w.launches != before[name]}
            one_launch = launches == {"ec_window_fold": 1}
            want, plain_ms = run_ms(lambda: ec_lf.window_fold_plain(spec, parts, c, rows))
            e = err(got, want)

            def chain():  # the tree of K2a launches the kernel replaced
                return ec_lf.fold_tree(spec, parts, c, rows, ec_lf.add, ec_lf.double, ff.sub)

            chain_err = err(got, chain())
            ok &= e == 0 and chain_err == 0 and one_launch
            ms = time_ms(lambda: ec_lf.window_fold(spec, parts, c, rows), 10)
            chain_ms = time_ms(chain, 2)
            # a window's combine: two adds (16 products) and c doublings (7);
            # a row's Horner chain: W - 1 times c doublings and an add. The
            # chain of one row is the latency: its first window's c
            # doublings and add, then the chain
            products = rows * (windows * (32 + 7 * c) + (windows - 1) * (7 * c + 16))
            dependent = windows * (7 * c + 16)
            n_bytes = (6 * m + 3 * rows) * spec.n_limbs * 4
            name = f"ec_window_fold[{spec.name}]"
            if k == 0:
                bounds = self.entry(name, "fold", max(e, chain_err), ms, plain_ms, n_bytes,
                                    products * (4 * nw * nw + nw))
            else:
                bounds = self.bound(n_bytes, products * (4 * nw * nw + nw))
            emit({"phase": "kernels", "kernel": name, "c": c, "windows": windows, "rows": rows,
                  "max_abs_err": e, "chain_max_abs_err": chain_err, "launches": launches,
                  "one_launch": one_launch, "ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms,
                  "products": products, "dependent_products": dependent, **bounds})
        return ok

    def check_ec_formulas(self, group):
        from poly_commit_tpu_torch.core import ec_lf, ff

        torch = self.torch
        spec = group.spec
        n = 1 << 16  # the MSM scan's width: 16 windows x 4096 lanes
        pts = self.host_points(group, n, seed=1)
        q = spec.modulus
        qts = [pts[(i + 12345) % n] for i in range(n)]
        qts[1] = pts[1]  # P == Q: doubling
        qts[2] = (pts[2][0], (q - pts[2][1]) % q)  # P == -Q: infinity
        x1 = ff.from_ints(spec, [p[0] for p in pts], device=self.dev)
        y1 = ff.from_ints(spec, [p[1] for p in pts], device=self.dev)
        x2 = ff.from_ints(spec, [p[0] for p in qts], device=self.dev)
        y2 = ff.from_ints(spec, [p[1] for p in qts], device=self.dev)

        def jacobian(x, y, zero_lane):
            z = self.rand_field(spec, n)
            z2 = ff.plain("mul", spec, z, z)
            xj = ff.plain("mul", spec, x, z2)
            yj = ff.plain("mul", spec, y, ff.plain("mul", spec, z2, z))
            z[:, zero_lane] = 0  # one lane at infinity
            return (xj, yj, z)

        P = jacobian(x1, y1, 0)
        Q = jacobian(x2, y2, 3)
        pq = ec_lf.pack(x2, y2)
        args = {"madd": (x2, y2), "madd_distinct": (x2, y2), "madd_packed": (pq,),
                "madd_distinct_packed": (pq,), "add": (Q,), "double": ()}
        field_muls = {"madd": 11, "madd_distinct": 11, "madd_packed": 11,
                      "madd_distinct_packed": 11, "add": 16, "double": 7}
        in_coords = {"madd": 5, "madd_distinct": 5, "madd_packed": 4,
                     "madd_distinct_packed": 4, "add": 6, "double": 3}
        nw = spec.n_limbs // 2
        keep = torch.ones(n, dtype=torch.bool, device=self.dev)
        keep[1:3] = False  # P == +-Q breaks the distinct forms' precondition
        ok = True
        for fn in ec_lf.WRAPPERS:
            which = fn.__name__
            if which not in args:  # madd_scan: check_ec_scan
                continue
            a = args[which]
            flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
            got = fn(spec, P, *a)
            want = ec_lf.plain(which, spec, *P, *flat)
            lanes = keep if which.startswith("madd_distinct") else torch.ones_like(keep)
            err = max(self.canon_err(spec, g[:, lanes], w[:, lanes]) for g, w in zip(got, want))
            ok &= err == 0
            ms = time_ms(lambda: fn(spec, P, *a), 20)
            plain_ms = time_ms(lambda: ec_lf.plain(which, spec, *P, *flat), 1)
            # work this data needs: the main formula on every lane with a
            # finite accumulator, plus a doubling (7 products) where P == Q
            finite = n - 1
            muls = field_muls[which] * finite + (7 if which in ("madd", "madd_packed", "add") else 0)
            n_bytes = (in_coords[which] + 3) * spec.n_limbs * 4 * n
            n_imad = muls * (4 * nw * nw + nw)
            name = f"ec_{which}[{spec.name}]"
            device_ms = graph_ms(lambda: fn(spec, P, *a), 20)
            if f"ec_{which}" in self.OFF_PATH:
                bounds = self.bound(n_bytes, n_imad)
            else:
                bounds = self.entry(name, "ec", err, ms, plain_ms, n_bytes, n_imad)
            emit({"phase": "kernels", "kernel": name, "n": n, "max_abs_err": err, "ms": ms,
                  "device_ms": device_ms, "plain_ms": plain_ms, **bounds})
        return ok

    SCAN_EDGE_STEPS = 16  # the complete madd's edge lanes

    def check_ec_scan(self, spec, steps, lanes, n_pts):
        """K2a's one-launch within-lane scan against its plain version, bit
        for bit on the raw limbs of every prefix and the final sums. At the
        path's ``steps`` x ``lanes`` over ``n_pts`` points (SCAN_SHAPES)
        with the distinct madd, as the paths run it; the plain run is also
        its timed one. At SCAN_EDGE_STEPS steps with the distinct and the
        complete madd, for the edge lanes. The table holds random lazy
        coordinates, its last row the negation of row 0; lane 0 skips every
        step, lane 1 adds row 5 twice from infinity (a doubling in the
        complete madd), lane 2 adds row 0 then its negation (back to
        infinity). The kernel is also timed beside the loop of
        madd_distinct_packed launches it replaced (``chain_ms``, its
        prefixes held equal too)."""
        from poly_commit_tpu_torch.core import ec_lf, ff

        torch = self.torch
        x, y = self.lazy(spec, n_pts), self.lazy(spec, n_pts)
        y[:, -1] = ff.plain("sub", spec, torch.zeros_like(y[:, :1]), y[:, :1].contiguous())[:, 0]
        x[:, -1] = x[:, 0]
        packed = ec_lf.pack(x, y)  # (L, N) limbs-first words: the loop's gather
        table = packed.T.contiguous()  # (N, L) point-major: the kernel's
        del x, y
        idx = torch.randint(0, n_pts, (steps, lanes), generator=self.gen, device=self.dev,
                            dtype=torch.int32)
        keep = torch.rand((steps, lanes), generator=self.gen, device=self.dev) < 0.9
        keep[:, 0] = False
        keep[:2, 1:3] = True
        idx[:2, 1] = 5
        idx[0, 2], idx[1, 2] = 0, n_pts - 1

        def err(got, want):
            return max(int((g.long() - w.long()).abs().max())
                       for g, w in zip((*got[0], got[1]), (*want[0], want[1])))

        ok = True
        errs = {}
        k = self.SCAN_EDGE_STEPS
        for distinct in (True, False):
            few_idx, few_keep = idx[:k].contiguous(), keep[:k].contiguous()
            e = err(ec_lf.madd_scan(spec, table, few_idx, few_keep, distinct),
                    ec_lf.madd_scan_plain(spec, table, few_idx, few_keep, distinct))
            errs[f"distinct_{k}_steps" if distinct else f"complete_{k}_steps"] = e
            ok &= e == 0
        got = ec_lf.madd_scan(spec, table, idx, keep, True)
        want, plain_ms = run_ms(lambda: ec_lf.madd_scan_plain(spec, table, idx, keep, True))
        errs[f"distinct_{steps}_steps"] = err(got, want)
        del want
        chain = ec_lf.scan_loop(lambda p, g: ec_lf.madd_distinct_packed(spec, p, g),
                                ec_lf.infinity(spec, lanes, self.dev), packed, idx, keep)
        chain_err = err(got, chain)
        ok &= errs[f"distinct_{steps}_steps"] == 0 and chain_err == 0
        del got, chain
        ms = time_ms(lambda: ec_lf.madd_scan(spec, table, idx, keep, True), 5)
        chain_ms = time_ms(lambda: ec_lf.scan_loop(
            lambda p, g: ec_lf.madd_distinct_packed(spec, p, g),
            ec_lf.infinity(spec, lanes, self.dev), packed, idx, keep), 2)
        # least bytes: the table (already 2 bytes a limb), idx and keep read
        # once, the prefixes written once at 2 bytes a limb; operations: 11
        # products at every kept step but a lane's first (from infinity the
        # madd copies the point)
        nw = spec.n_limbs // 2
        kept = int(keep.sum())
        first = int(keep.any(0).sum())
        n_imad = 11 * (kept - first) * (4 * nw * nw + nw)
        n_bytes = n_pts * 2 * nw * 4 + steps * lanes * 5 + 3 * spec.n_limbs * steps * lanes * 2
        name = f"ec_madd_scan[{spec.name}]"
        bounds = self.entry(name, "scan", max(errs.values()), ms, plain_ms, n_bytes, n_imad,
                            limbs=False)
        emit({"phase": "kernels", "kernel": name, "lanes": lanes, "steps": steps, "points": n_pts,
              "max_abs_err": errs, "chain_max_abs_err": chain_err, "ms": ms,
              "chain_ms": chain_ms, "plain_ms": plain_ms, "kept_steps": kept, **bounds})
        return ok

    # the K2a, K2c and K2b formulas that no path launches (G1 MSMs scan in
    # madd_scan; every MSM of the paths assumes distinct bases; no Edwards
    # fixed-base; IPA-PC's key fold runs ed_smul, whose doublings are inside
    # its one launch): held against their plain versions here, without a
    # kernel-table entry
    OFF_PATH = ("ec_madd_packed", "ec_madd_distinct_packed", "ec_g2_madd_packed", "ec_ed_madd",
                "ec_ed_double")
    CURVE_KERNEL_N = 1 << 16  # the MSM scan's width: 16 windows x 4096 lanes
    IN_COORDS = {"madd": 5, "madd_distinct": 5, "madd_packed": 4, "madd_distinct_packed": 4,
                 "add": 6, "double": 3}

    def check_g2(self):
        """K2c: the six G2 formulas against their plain versions, bit for bit
        on the raw limbs, at the MSM scan's width (2^16 points), on the
        BLS12-381 Fq2 (MultilinearPC's: the table's entries) and the
        BLS12-377 Fq2, both timed. Lanes
        0..3 are the edges: P at infinity, P == Q, P == -Q (z = 1), Q at
        infinity (add)."""
        from poly_commit_tpu_torch.core import ec_lf, ff
        from poly_commit_tpu_torch.core import field_params as FP

        torch = self.torch
        n = self.CURVE_KERNEL_N
        errs = {}
        for spec in (FP.FQ_BLS12_381, FP.FQ_BLS12_377):
            L = spec.n_limbs
            x1, y1, z1, x2, y2, z2 = (torch.cat([self.lazy(spec, n), self.lazy(spec, n)], 0)
                                      for _ in range(6))
            one = ec_lf.fq2_one(spec, 1, self.dev)
            z1[:, 0] = 0
            z2[:, 3] = 0
            z1[:, 1:3], z2[:, 1:3] = one, one
            x2[:, 1:3] = x1[:, 1:3]
            y2[:, 1] = y1[:, 1]
            zero = torch.zeros_like(y1[:L, 2:3])
            y2[:, 2:3] = torch.cat([ff.plain("sub", spec, zero, y1[:L, 2:3].contiguous()),
                                    ff.plain("sub", spec, zero, y1[L:, 2:3].contiguous())], 0)
            P, Q = (x1, y1, z1), (x2, y2, z2)
            pq = ec_lf.pack(x2, y2)
            args = {"madd": (x2, y2), "madd_distinct": (x2, y2), "madd_packed": (pq,),
                    "madd_distinct_packed": (pq,), "add": (Q,), "double": ()}
            # base products: an Fq2 product is 3 (Karatsuba), a square 2
            # when nr = -1 ((a0 + a1)(a0 - a1), a0 a1), else 3
            mul, sqr = 3, 2 if ec_lf.QUAD_NR[spec.name] == -1 else 3
            products = {"madd": 7 * mul + 4 * sqr, "add": 11 * mul + 5 * sqr,
                        "double": 2 * mul + 5 * sqr}
            for fn in ec_lf.G2_WRAPPERS:
                which = fn.__name__
                base = which[3:]
                a = args[base]
                flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
                got = fn(spec, P, *a)
                want = ec_lf.plain(which, spec, *P, *flat)
                err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
                name = f"ec_{which}"
                errs[name] = max(errs.get(name, 0), err)
                line = {"phase": "kernels", "kernel": name, "field": spec.name, "n": n,
                        "max_abs_err": err}
                ms = time_ms(lambda: fn(spec, P, *a), 20)
                device_ms = graph_ms(lambda: fn(spec, P, *a), 20)
                plain_ms = time_ms(lambda: ec_lf.plain(which, spec, *P, *flat), 1)
                # the main formula on every lane with a finite P, plus the
                # doubling where P == Q in the complete forms
                complete = base in ("madd", "madd_packed", "add")
                n_prod = (products[base.replace("_distinct", "").replace("_packed", "")] * (n - 1)
                          + (products["double"] if complete else 0))
                n_bytes = (self.IN_COORDS[base] + 3) * 2 * L * 4 * n
                n_imad = n_prod * IMAD_PER_FQ_PRODUCT
                # the table's entries are BLS12-381's; BLS12-377's build is timed beside them
                if name not in self.OFF_PATH and spec is FP.FQ_BLS12_381:
                    self.entry(name, "g2", err, ms, plain_ms, n_bytes, n_imad)
                emit({**line, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                      **self.bound(n_bytes, n_imad)})
            del x1, y1, z1, x2, y2, z2, P, Q, pq, args
        for name, err in errs.items():
            if name in self.kernels:
                self.kernels[name]["max_abs_err"] = err  # over both fields
        return all(e == 0 for e in errs.values())

    def check_ed(self):
        """K2b: the four JubJub formulas against their plain versions, bit
        for bit on the raw limbs, at 2^16 points of Fr-381 (post-reduce).
        Lane 0 of P and lane 1 of Q are the identity; lane 2 adds P to -P."""
        from poly_commit_tpu_torch.core import ec_lf
        from poly_commit_tpu_torch.core import field_params as FP

        spec = FP.JUBJUB_FQ
        n = self.CURVE_KERNEL_N
        P = [self.lazy(spec, n) for _ in range(4)]
        Q = [self.lazy(spec, n) for _ in range(4)]
        ident = ec_lf.ed_infinity(spec, 1, self.dev)
        neg = ec_lf.ed_neg(spec, tuple(t[:, 2:3].contiguous() for t in P))
        for k in range(4):
            P[k][:, 0] = ident[k][:, 0]
            Q[k][:, 1] = ident[k][:, 0]
            Q[k][:, 2] = neg[k][:, 0]
        P, Q = tuple(P), tuple(Q)
        args = {"ed_madd": Q[:2], "ed_madd_packed": (ec_lf.pack(Q[0], Q[1]),), "ed_add": (Q,),
                "ed_double": ()}
        in_coords = {"ed_madd": 6, "ed_madd_packed": 5, "ed_add": 8, "ed_double": 4}
        ok = True
        for fn in ec_lf.ED_WRAPPERS:
            which = fn.__name__
            if which == "ed_smul":
                continue
            a = args[which]
            flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
            got = fn(spec, P, *a)
            want = ec_lf.plain(which, spec, *P, *flat)
            err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            ok &= err == 0
            ms = time_ms(lambda: fn(spec, P, *a), 20)
            device_ms = graph_ms(lambda: fn(spec, P, *a), 20)
            plain_ms = time_ms(lambda: ec_lf.plain(which, spec, *P, *flat), 1)
            # 9 products a point (add-2008-hwcd-3 with the 2d product; the
            # mixed forms compute t2 = x2 y2 instead of z1 z2), no branches
            n_bytes = (in_coords[which] + 4) * spec.n_limbs * 4 * n
            n_imad = 9 * n * IMAD_PER_PRODUCT
            name = f"ec_{which}"
            if name not in self.OFF_PATH:
                self.entry(name, "ed", err, ms, plain_ms, n_bytes, n_imad)
            emit({"phase": "kernels", "kernel": name, "field": spec.name, "n": n, "max_abs_err": err,
                  "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, **self.bound(n_bytes, n_imad)})
        return ok and self.check_ed_smul()

    # IPA-PC's first key fold (2^15 points), and a fold's last (1 point)
    SMUL_POINTS = (1 << 15, 1)

    @staticmethod
    def ed_chain(spec, p, k):
        """k p as the port computed it before ``ec_lf.ed_smul``: one
        ed_double launch a bit and one ed_add launch a set bit, MSB first."""
        from poly_commit_tpu_torch.core import ec_lf

        acc = ec_lf.ed_infinity(spec, p[0].shape[1], p[0].device)
        for bit in bin(k)[2:] if k else "":
            acc = ec_lf.ed_double(spec, acc)
            if bit == "1":
                acc = ec_lf.ed_add(spec, acc, p)
        return acc

    def check_ed_smul(self):
        """K2b's one-launch scalar multiplication against its plain version
        bit for bit, and against the chain of launches it replaced limb for
        limb, at SMUL_POINTS: lane 0 the identity, lane 2 the negation of
        lane 1; k in {0, 1, 2^251 + 1} and a 252-bit IPA round challenge
        (the table entry, at 2^15 points, timed beside the chain)."""
        import random

        from poly_commit_tpu_torch.core import ec_lf
        from poly_commit_tpu_torch.core import field_params as FP

        spec = FP.JUBJUB_FQ
        challenge = random.Random(8).getrandbits(252) | (1 << 251)
        ok = True
        for n in self.SMUL_POINTS:
            P = [self.lazy(spec, n) for _ in range(4)]
            ident = ec_lf.ed_infinity(spec, 1, self.dev)
            for k in range(4):
                P[k][:, 0] = ident[k][:, 0]
            if n > 2:
                neg = ec_lf.ed_neg(spec, tuple(t[:, 1:2].contiguous() for t in P))
                for k in range(4):
                    P[k][:, 2] = neg[k][:, 0]
            P = tuple(P)
            for k in (0, 1, (1 << 251) + 1, challenge):
                got = ec_lf.ed_smul(spec, P, k)
                want = ec_lf.ed_smul_plain(spec, P, k)
                chain = self.ed_chain(spec, P, k)
                err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
                chain_err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, chain))
                ok &= err == 0 and chain_err == 0
                line = {"phase": "kernels", "kernel": "ec_ed_smul", "n": n, "k_bits": k.bit_length(),
                        "k_set_bits": bin(k).count("1"), "max_abs_err": err,
                        "chain_max_abs_err": chain_err}
                if k == challenge:
                    formulas = k.bit_length() + bin(k).count("1")
                    ms = time_ms(lambda: ec_lf.ed_smul(spec, P, k), 5)
                    device_ms = graph_ms(lambda: ec_lf.ed_smul(spec, P, k), 5)
                    chain_ms = time_ms(lambda: self.ed_chain(spec, P, k), 2)
                    plain_ms = time_ms(lambda: ec_lf.ed_smul_plain(spec, P, k), 1)
                    # the point read and k P written once; the chain's unified
                    # formulas of 9 products of 264 IMADs a point
                    n_bytes = 8 * spec.n_limbs * 4 * n
                    n_imad = formulas * 9 * IMAD_PER_PRODUCT * n
                    line.update(formulas=formulas, ms=ms, device_ms=device_ms, chain_ms=chain_ms,
                                plain_ms=plain_ms)
                    if n == self.SMUL_POINTS[0]:
                        line.update(self.entry("ec_ed_smul", "ed", err, ms, plain_ms, n_bytes, n_imad))
                    else:
                        line.update(self.bound(n_bytes, n_imad))
                emit(line)
        return ok

    # (windows, points, c): the 2^20 MSM's keys (the table entry), and the
    # c = 8 MSMs of IPA-PC and MultilinearPC
    # the 2^20 MSM's, the c = 8 MSMs', and a chunk of Hyrax's batched MSM
    # at 22 variables (512 rows x 32 windows of 2^11 points)
    SORT_SHAPES = ((16, 1 << 20, 16), (32, 1 << 15, 8), (1 << 14, 1 << 11, 8))

    def check_sort(self):
        """K3 against its stable plain version, index for index (order,
        sorted keys and tails), with a tenth of the keys the sentinel
        (padding and infinity); timed beside torch.sort. ``launch_ms`` is
        the launches without the wrapper's one read of the range count."""
        from poly_commit_tpu_torch.core import sort_gpu

        torch = self.torch
        ok = True
        for w, n, c in self.SORT_SHAPES:
            sentinel = 1 << c
            keys = torch.randint(0, sentinel, (w, n), generator=self.gen, device=self.dev,
                                 dtype=torch.int32)
            share = torch.rand((w, n), generator=self.gen, device=self.dev) < 0.1
            keys = torch.where(share, torch.full_like(keys, sentinel), keys)
            got = sort_gpu.digit_sort(keys, sentinel)
            want = sort_gpu.plain(keys, sentinel)
            err = max(int((g.long() - p.long()).abs().max()) for g, p in zip(got, want))
            ok &= err == 0
            ms = time_ms(lambda: sort_gpu.digit_sort(keys, sentinel), 20)
            launch_ms = time_ms(lambda: sort_gpu._launch(keys, sentinel), 20)
            plain_ms = time_ms(lambda: sort_gpu.plain(keys, sentinel), 1)
            library_ms = time_ms(lambda: torch.sort(keys, dim=1), 20)
            stable_ms = time_ms(lambda: torch.sort(keys, dim=1, stable=True), 20)
            # keys read, order and sorted keys written, the tails written
            n_bytes = 3 * w * n * 4 + w * (sentinel + 1) * 4
            line = {"phase": "kernels", "kernel": "digit_sort", "shape": [w, n], "c": c,
                    "passes": len(sort_gpu.radix_plan(sentinel)), "max_abs_err": err, "ms": ms,
                    "launch_ms": launch_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "library_stable_ms": stable_ms, "faster_than_library": ms < library_ms}
            if c == 16:
                line.update(self.entry("digit_sort", "digit", err, ms, plain_ms, n_bytes, 0,
                                       library_ms, limbs=False))
            else:
                line["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
            emit(line)
        return ok

    def check_ntt_kernels(self):
        """K4a, K4b and K4c against their plain versions: K4b and K4c at the
        Ligero path's shape (256 rows of 2^15 points: 2^23 elements; K4c
        over the four stages past the block, 11-14, in one launch, as the
        path runs it, bit for bit); K4a (``small``) at phase 5's 2^9-point
        transform, bit for bit, and its one-stage form (``butterfly``, off
        the paths) on 2^21 pairs; both scalar fields, timed on BN254's (one
        8-word build serves both). K4a and K4c are also timed beside the
        chain of one-stage launches of the same stages (``chain_ms``, equal
        limb for limb), K4c also at one stage (``one_stage_ms``)."""
        from poly_commit_tpu_torch.core import ff, ntt_lf
        from poly_commit_tpu_torch.core import field_params as FP
        from poly_commit_tpu_torch.core import ntt as NTT

        torch = self.torch
        total, log_n, pairs = self.NTT_KERNEL_SHAPE
        small_log_n = self.NTT_SMALL_LOG_N
        block = ntt_lf.FUSE_BLOCK
        n_fused = s_big = block.bit_length() - 1
        big = range(s_big, log_n)  # K4c's stages at this shape, one launch
        errs = {"k4a": 0, "k4a_stage": 0, "k4b": 0, "k4c": 0}
        for spec in (FP.FR_BLS12_381, FP.FR_BN254):
            lazy = lambda n: ff.plain("add", spec, self.rand_field(spec, n), self.rand_field(spec, n))  # noqa: E731
            tws = NTT.stage_twiddles(spec, log_n, False, self.dev)
            small_tws = NTT.stage_twiddles(spec, small_log_n, False, self.dev)
            table = ntt_lf.fused_table(tws, n_fused)
            a, x = lazy(total), lazy(1 << small_log_n)
            u, w, tw = lazy(pairs), lazy(pairs), lazy(pairs)
            runs = {
                "k4a": (lambda: ntt_lf.small(spec, x, small_tws),
                        lambda: ntt_lf.small_plain(spec, x, small_tws)),
                "k4a_stage": (lambda: ntt_lf.butterfly(spec, u, w, tw),
                              lambda: ntt_lf.butterfly_plain(spec, u, w, tw)),
                "k4b": (lambda: ntt_lf.fused_stages(spec, a, table, n_fused, block),
                        lambda: ntt_lf.fused_stages_plain(spec, a, table, n_fused, block)),
                "k4c": (lambda: ntt_lf.stages(spec, a, tws[s_big:], s_big),
                        lambda: ntt_lf.stages_plain(spec, a, tws[s_big:], s_big)),
            }

            def chain(kind):  # the stages one launch each, as before the kernel
                if kind == "k4a":  # K4a's one-stage form on split halves
                    out = x
                    for s in range(small_log_n):
                        out = ntt_lf._by_stage(ntt_lf.butterfly, spec, out, small_tws[s], s)
                    return out
                out = a
                for s in big:
                    out = ntt_lf.stage(spec, out, tws[s], s)
                return out

            for kind, (kernel, plain) in runs.items():
                got, want = kernel(), plain()
                if kind == "k4a_stage":  # the (lo, hi) halves side by side
                    got, want = torch.cat(got, 1), torch.cat(want, 1)
                err = self.canon_err(spec, got, want)
                if kind in ("k4a", "k4c"):  # bit for bit, on the raw limbs
                    err = max(err, int((got.long() - want.long()).abs().max()),
                              int((chain(kind).long() - got.long()).abs().max()))
                errs[kind] = max(errs[kind], err)
                line = {"phase": "kernels", "kernel": kind, "field": spec.name, "max_abs_err": err}
                if spec is not FP.FR_BN254:
                    emit(line)
                    continue
                ms, plain_ms = time_ms(kernel, 20), time_ms(plain, 1)
                L4 = spec.n_limbs * 4  # bytes of one element at int32 per 16-bit limb
                if kind == "k4a":  # each element read and written once, the twiddles read once
                    n = 1 << small_log_n
                    name = "ntt_small"
                    n_bytes = 2 * n * L4 + (n - 1) * L4
                    n_imad = small_log_n * (n // 2) * IMAD_PER_PRODUCT
                    shape = {"total": n, "stages": small_log_n, "device_ms": graph_ms(kernel, 20),
                             "chain_ms": time_ms(lambda: chain("k4a"), 20)}
                elif kind == "k4a_stage":  # u, w, tw read; lo, hi written
                    name, n_bytes, n_imad = "ntt_butterfly", 5 * pairs * L4, pairs * IMAD_PER_PRODUCT
                    emit({**line, "kernel": name, "pairs": pairs, "ms": ms, "plain_ms": plain_ms,
                          **self.bound(n_bytes, n_imad)})
                    continue
                elif kind == "k4b":  # each element read and written once, the table read once
                    name = "ntt_fused_stages"
                    n_bytes = 2 * total * L4 + table.shape[1] * L4
                    n_imad = n_fused * (total // 2) * IMAD_PER_PRODUCT
                    shape = {"total": total, "block": block, "stages": n_fused}
                else:  # each element read and written once, the stages' twiddles read once
                    name = "ntt_stages"
                    n_bytes = 2 * total * L4 + sum(1 << s for s in big) * L4
                    n_imad = len(big) * (total // 2) * IMAD_PER_PRODUCT
                    shape = {"total": total, "stages": [big[0], big[-1]],
                             "chain_ms": time_ms(lambda: chain("k4c"), 20),
                             "one_stage_ms": time_ms(lambda: ntt_lf.stage(spec, a, tws[s_big], s_big), 20)}
                bounds = self.entry(name, kind, None, ms, plain_ms, n_bytes, n_imad)
                emit({**line, "kernel": name, **shape, "ms": ms, "plain_ms": plain_ms, **bounds})
            del a, x, u, w, tw, runs
        for kind, name in zip(("k4a", "k4b", "k4c"), self.NTT_KERNELS):
            self.kernels[name]["max_abs_err"] = errs[kind]  # over both fields
        return all(e == 0 for e in errs.values())

    # -- phase 3 ----------------------------------------------------------
    def check_msm(self):
        import random

        from poly_commit_tpu_torch.core import curve, hostec, msm

        group = curve.BLS12_381_G1
        n = 1 << 12
        pts = self.host_points(group, n, seed=2)
        rnd = random.Random(3)
        scal = [rnd.randrange(group.scalar_spec.modulus) for _ in range(n)]
        t0 = time.perf_counter()
        out = msm.msm(group, msm.scalars_from_ints(group.scalar_spec, scal, self.dev),
                      curve.affine_from_ints(group, [(x, y, False) for x, y in pts], self.dev),
                      assume_distinct=True)
        got = hostec.device_proj_to_host(group, out)
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = hostec.host_group(group).msm_fast(scal, pts)
        host_ms = (time.perf_counter() - t0) * 1e3
        emit({"phase": "msm", "n": n, "equal": got == want, "device_ms": ms, "host_oracle_ms": host_ms})
        return got == want

    def check_side_msms(self):
        """A G2 (BLS12-381) and a JubJub MSM of 2^10 points against the host
        oracle, with the complete mixed add (g2_madd_packed, ed_madd_packed)."""
        import random

        from poly_commit_tpu_torch.core import curve, hostec, msm

        n = 1 << SIDE_MSM_LOG_N
        out = {}
        for group in (curve.BLS12_381_G2, curve.JUBJUB):
            hg = hostec.host_group(group)
            rnd = random.Random(4)
            gen = (group.gen_x, group.gen_y)
            pts = [hg.mul_fast(gen, rnd.randrange(1, group.scalar_spec.modulus))]
            step = hg.mul_fast(gen, rnd.randrange(1, group.scalar_spec.modulus))
            for _ in range(n - 1):
                pts.append(hg.add(pts[-1], step))
            scal = [rnd.randrange(group.scalar_spec.modulus) for _ in range(n)]
            t0 = time.perf_counter()
            res = msm.msm(group, msm.scalars_from_ints(group.scalar_spec, scal, self.dev),
                          curve.affine_from_ints(group, [(x, y, False) for x, y in pts], self.dev))
            got = hostec.device_proj_to_host(group, res)
            ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            want = hg.msm_fast(scal, pts)
            out[group.name] = {"equal": got == want, "device_ms": ms,
                               "host_oracle_ms": (time.perf_counter() - t0) * 1e3}
        emit({"phase": "msm_g2_jubjub", "n": n, **out})
        return all(v["equal"] for v in out.values())

    # -- phase 4 ----------------------------------------------------------
    def main_path(self):
        from poly_commit_tpu_torch.core import curve as C
        from poly_commit_tpu_torch.core import ec_lf
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core import msm as M
        from poly_commit_tpu_torch.core.serialize import device_point_to_ints
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import kzg10
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
        from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10

        torch = self.torch
        PC = MarlinKZG10
        spec = PC.spec
        degree = (1 << LOG_DEGREE) - 1
        coeffs = self.rand_field(spec, degree + 1).T.contiguous()  # (D+1, L) Montgomery
        rng = HostRng(1)
        stages = {}

        def stage(name, fn, into=stages):
            return timed(into, name, fn)

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        pp = stage("setup", lambda: PC.setup(degree, rng=rng, device=self.dev))
        ck, vk = stage("trim", lambda: PC.trim(pp, degree, 1))
        lp = LabeledPolynomial("p", coeffs, hiding_bound=1)
        rng_at_commit = copy.deepcopy(rng)  # the mesh phase replays commit and open from here
        comms, states = stage("commit", lambda: PC.commit(ck, [lp], rng))
        z = rng.field_int(spec)
        query_set = {("p", ("z", z))}
        proofs, values = stage("open", lambda: PC.batch_open(
            ck, [lp], comms, query_set, PoseidonSponge(spec), states, rng))
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        bad = {k: (v + 1) % spec.modulus for k, v in values.items()}
        rejected = not stage("check_tampered", lambda: PC.batch_check(
            vk, comms, query_set, bad, proofs, PoseidonSponge(spec)))
        launches, ff_by_field, ff_by_size = self.read_counts()
        profile = self.profile(lambda: PC.commit(ck, [lp], rng))

        # the check stage apart, on this run's commitment and proof: its two
        # MSMs (2 points and 1, complete mixed add) and the pairing of two G1
        # points with the verifier key's prepared G2 points
        g1, ctx = PC.CTX.g1, PC.CTX
        pts = [comms[0].commitment.comm, proofs[0].w]
        split = {}
        total_c = stage("msm_2_points", lambda: M.msm(
            g1, M.scalars_from_ints(spec, [1, z], self.dev), C.affine_from_ints(g1, pts, self.dev)), split)
        total_w = stage("msm_1_point", lambda: M.msm(
            g1, M.scalars_from_ints(spec, [1], self.dev), C.affine_from_ints(g1, pts[1:], self.dev)), split)
        prepared = [kzg10._vk_prepared(vk.vk, "h", ctx), kzg10._vk_prepared(vk.vk, "beta_h", ctx)]
        stage("pairing", lambda: ctx.pairing_product_is_one(
            [device_point_to_ints(g1, total_c), device_point_to_ints(g1, g1.neg(total_w))],
            [vk.vk.h, vk.vk.beta_h], prepared=prepared), split)

        # the opened value against host Horner on the coefficients
        value_ok = values[("p", z)] == horner(F.to_ints(spec, coeffs), z, spec.modulus)
        # every K2a entry of the main path and K3 ran, every K1 build of the
        # main path ran, and no K1 build ran that phase 2 did not hold against
        # its plain version; the G1 MSMs scanned in madd_scan, not the loop
        needed = list(self.MAIN_PATH_EC) + ["digit_sort"] + list(self.MAIN_PATH_FF)
        all_launched = self.all_launched(launches, ff_by_field, needed)
        scanned = launches["ec_madd_distinct_packed"] <= self.MAX_PACKED_MADD_LAUNCHES
        emit({"phase": "main_path", "scheme": "MarlinKZG10/BLS12-381", "degree": degree,
              "hiding_bound": 1, "stage_ms": stages, "check_split_ms": split, "check": bool(ok),
              "tampered_rejected": rejected, "value_matches_host": value_ok, "launches": launches,
              "launches_by_field": ff_by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "msms_scanned_in_one_launch": scanned,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
        emit({"phase": "main_path_profile", "stage": "commit", **profile})
        self.main_pp = pp  # main_path_bounded trims it again
        # phase 15 checks this run's proof with the device pairing,
        # trace_persist commits again with its committer key, and the mesh
        # phase replays commit and open
        self.marlin = dict(PC=PC, ck=ck, vk=vk, coeffs=coeffs, comms=comms, proofs=proofs,
                           values=values, query_set=query_set, rng=rng_at_commit,
                           commit_open_ms=stages["commit"] + stages["open"])
        return bool(ok) and rejected and value_ok and all_launched and scanned

    def main_path_bounded(self):
        """Phase 4's bounded run on phase 4's SRS (no second setup): trim
        with the degree bound 2^(LOG_DEGREE-1) - 1, commit one hiding
        polynomial of that degree (a shifted commitment), batch_open and
        batch_check. Its launches stay out of the phase 4-8 sums."""
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
        from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10

        torch = self.torch
        PC = MarlinKZG10
        spec = PC.spec
        pp, self.main_pp = self.main_pp, None
        degree = (1 << LOG_DEGREE) - 1
        bound = (1 << (LOG_DEGREE - 1)) - 1
        coeffs = self.rand_field(spec, bound + 1).T.contiguous()  # (bound+1, L) Montgomery
        rng = HostRng(11)
        stages = {}

        def stage(name, fn):
            return timed(stages, name, fn)

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        ck, vk = stage("trim", lambda: PC.trim(pp, degree, 1, [bound]))
        lp = LabeledPolynomial("p", coeffs, degree_bound=bound, hiding_bound=1)
        comms, states = stage("commit", lambda: PC.commit(ck, [lp], rng))
        z = rng.field_int(spec)
        query_set = {("p", ("z", z))}
        proofs, values = stage("open", lambda: PC.batch_open(
            ck, [lp], comms, query_set, PoseidonSponge(spec), states, rng))
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        bad = {k: (v + 1) % spec.modulus for k, v in values.items()}
        rejected = not stage("check_tampered", lambda: PC.batch_check(
            vk, comms, query_set, bad, proofs, PoseidonSponge(spec)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, ff_by_field, ff_by_size = self.read_counts(in_sums=False)
        value_ok = values[("p", z)] == horner(F.to_ints(spec, coeffs), z, spec.modulus)
        shifted = comms[0].commitment.shifted_comm is not None
        # the MSMs' kernels (scan, lane tree, digit sort, scalars out of
        # Montgomery form); no setup runs here
        needed = ["ec_madd_scan", "ec_add", "digit_sort", "ff_mont_mul[fr_bls12_381]"]
        all_launched = self.all_launched(launches, ff_by_field, needed)
        emit({"phase": "main_path_bounded", "scheme": "MarlinKZG10/BLS12-381", "degree": degree,
              "degree_bound": bound, "hiding_bound": 1, "stage_ms": stages, "check": bool(ok),
              "tampered_rejected": rejected, "value_matches_host": value_ok,
              "shifted_commitment": shifted, "launches": launches,
              "launches_by_field": ff_by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "peak_mem_gb": peak_gb})
        return bool(ok) and rejected and value_ok and shifted and all_launched

    def profile(self, fn, top=5):
        """fn() once under torch.profiler (CPU and CUDA activities): its host
        wall ms, the device-busy ms (the union of the device activities'
        intervals: kernels, copies, sets) and its share of the wall time, the
        ``top`` kernels by summed device time and the ``top`` host operations
        by their own host time. The profiler's own host overhead is in the
        wall time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in device)
        busy_us, end = 0.0, float("-inf")
        for a, b in spans:  # the union of the intervals
            if b > end:
                busy_us += b - max(a, end)
                end = b
        by_name = {}
        for e in device:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, calls + 1)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
        return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / 1e3 / wall_ms, "device_activities": len(device),
                "top_kernels": [{"name": n[:120], "device_ms": ms, "calls": c}
                                for n, (ms, c) in ranked],
                "top_host_ops": [{"name": e.key[:80], "self_host_ms": e.self_cpu_time_total / 1e3,
                                  "calls": e.count} for e in host]}

    # -- phase 5 ----------------------------------------------------------
    def ntt_path(self):
        """A 2^22-point NTT and iNTT (K4b + K4c) and a 2^9-point pair (K4a)
        over BN254 Fr, then the checks and times outside the counted run."""
        from poly_commit_tpu_torch.core import ff, ntt_lf
        from poly_commit_tpu_torch.core import field_params as FP
        from poly_commit_tpu_torch.core import ntt as NTT

        spec = FP.FR_BN254
        p = spec.modulus
        big, small = self.rand_field(spec, 1 << NTT_LOG_N), self.rand_field(spec, 1 << 9)
        self.reset_counts()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = {}
        for name, a in (("big", big), ("small", small)):
            ev = ntt_lf.ntt(spec, a)
            outs[name] = (ev, ntt_lf.intt(spec, ev))
        self.torch.cuda.synchronize()
        path_ms = (time.perf_counter() - t0) * 1e3
        launches, by_field, ff_by_size = self.read_counts()
        needed = list(self.NTT_KERNELS) + ["ff_mont_mul[fr_bn254]"]
        all_launched = self.all_launched(launches, by_field, needed)
        # the 2^9 transform and its inverse: one K4a launch each
        small_in_one = launches["ntt_small"] == 2 and launches["ntt_butterfly"] == 0

        checks = {}
        for name, a in (("big", big), ("small", small)):
            ev, back = outs[name]
            n = a.shape[1]
            portable = NTT.ntt(spec, ff.to_field_last(a, (n,)))
            checks[f"{name}_round_trip"] = self.canon_err(spec, back, a) == 0
            checks[f"{name}_equals_portable"] = self.canon_err(spec, ev, ff.from_field_last(portable)) == 0
            # four evaluations against host Horner
            coeffs = ff.to_ints(spec, a)
            w = NTT.domain(spec, n.bit_length() - 1)["omega"]
            idx = (0, 1, n // 2, n - 1)
            want = [horner(coeffs, pow(w, i, p), p) for i in idx]
            got = ff.to_ints(spec, ev[:, list(idx)].contiguous())
            checks[f"{name}_horner"] = got == want
        n = 1 << NTT_LOG_N
        ms = time_ms(lambda: ntt_lf.ntt(spec, big), 10)
        intt_ms = time_ms(lambda: ntt_lf.intt(spec, big), 10)
        portable_ms = time_ms(lambda: NTT.ntt(spec, ff.to_field_last(big, (n,))), 1)
        # the transform reads and writes each element once (2 bytes a limb)
        # and does one product per butterfly: log2 n stages of n/2
        bounds = self.bound(2 * n * spec.n_limbs * 4, NTT_LOG_N * (n // 2) * IMAD_PER_PRODUCT)
        emit({"phase": "ntt", "field": spec.name, "log_n": NTT_LOG_N, "path_ms": path_ms,
              "checks": checks, "ms": ms, "intt_ms": intt_ms, "portable_ms": portable_ms,
              **bounds, "launches": launches,
              "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "small_transform_in_one_launch": small_in_one})
        return all(checks.values()) and all_launched and small_in_one

    # -- phase 6 ----------------------------------------------------------
    def ligero_path(self, which):
        """MultilinearLigeroBN254 at 2^22 evaluations ("ml") or
        UnivariateLigero over BLS12-381 Fr at degree 2^20 - 1 ("uni")."""
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import linear_codes as LC
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
        from poly_commit_tpu_torch.pcs.linear_codes import engine
        from poly_commit_tpu_torch.utils.merkle import MerkleTree, blake2s_hash

        torch = self.torch
        ml = which == "ml"
        PC = LC.MultilinearLigeroBN254 if ml else LC.UnivariateLigero
        spec = PC.spec
        p = spec.modulus
        size = 1 << (LIGERO_NUM_VARS if ml else LOG_DEGREE)
        table = self.rand_field(spec, size).T.contiguous()  # (size, L) Montgomery
        rng = HostRng(3)
        stages = {}

        def stage(name, fn, into=stages):
            return timed(into, name, fn)

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        if ml:
            pp = stage("setup", lambda: PC.setup(0, num_vars=LIGERO_NUM_VARS, rng=rng, device=self.dev))
            lp = LabeledPolynomial("p", table, num_vars=LIGERO_NUM_VARS)
            point = tuple(rng.field_int(spec) for _ in range(LIGERO_NUM_VARS))
        else:
            pp = stage("setup", lambda: PC.setup(size - 1, rng=rng, device=self.dev))
            lp = LabeledPolynomial("p", table)
            point = rng.field_int(spec)
        ck, vk = stage("trim", lambda: PC.trim(pp, 0 if ml else size - 1))
        comms, states = stage("commit", lambda: PC.commit(ck, [lp], rng))
        query_set = {("p", ("z", point))}
        proofs, values = stage("open", lambda: PC.batch_open(
            ck, [lp], comms, query_set, PoseidonSponge(spec), states, rng))
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        key = next(iter(values))
        bad = {key: (values[key] + 1) % p}
        rejected = not stage("check_tampered", lambda: PC.batch_check(
            vk, comms, query_set, bad, proofs, PoseidonSponge(spec)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts()
        needed = ["ntt_fused_stages", "ntt_stages"] + list(self.LIGERO_FF[which])
        all_launched = self.all_launched(launches, by_field, needed)

        # commit's parts, timed apart on the same matrix: the encode on the
        # card; the column bytes (transpose, out of Montgomery form, copy to
        # the host); Blake2s of each column; the Merkle tree
        md = comms[0].commitment.metadata
        mat = states[0].mat
        split = {}
        ext = stage("encode", lambda: PC.code.encode_rows(mat, ck), split)
        raw = stage("column_bytes", lambda: engine.column_bytes(spec, ext), split)
        leaves = stage("blake2s", lambda: [blake2s_hash(c.tobytes()) for c in raw], split)
        root = stage("merkle", lambda: MerkleTree(leaves, ck.merkle_config()).root, split)

        # the opened value against a host evaluation of the same ints
        ints = F.to_ints(spec, table)
        if ml:
            for z in point:
                ints = [(a + z * (b - a)) % p for a, b in zip(ints[0::2], ints[1::2])]
            want = ints[0]
        else:
            want = horner(ints, point, p)
        value_ok = values[key] == want
        emit({"phase": "ligero", "scheme": f"{PC.__name__}",
              **({"num_vars": LIGERO_NUM_VARS} if ml else {"degree": size - 1}),
              "rows": md.n_rows, "cols": md.n_cols, "ext_cols": md.n_ext_cols,
              "queried_columns": len(proofs[0][0].opening.columns),
              "stage_ms": stages, "commit_split_ms": split, "root_matches": root == comms[0].commitment.root,
              "check": bool(ok), "tampered_rejected": rejected, "value_matches_host": value_ok,
              "launches": launches, "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "peak_mem_gb": peak_gb})
        return bool(ok) and rejected and value_ok and all_launched and root == comms[0].commitment.root

    # -- phase 7 ----------------------------------------------------------
    def multilinear_path(self):
        """MultilinearPC over BLS12-381 at MLPC_NUM_VARS variables."""
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core import msm as M
        from poly_commit_tpu_torch.core import poly as P
        from poly_commit_tpu_torch.pcs import kzg10
        from poly_commit_tpu_torch.pcs import multilinear_pc as ML
        from poly_commit_tpu_torch.pcs.data_structures import HostRng

        torch = self.torch
        spec, p, nv = ML.SPEC, ML.SPEC.modulus, MLPC_NUM_VARS
        table = self.rand_field(spec, 1 << nv).T.contiguous()  # (2^nv, L) Montgomery
        rng = HostRng(5)
        stages = {}

        def stage(name, fn, into=stages):
            return timed(into, name, fn)

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        pp = stage("setup", lambda: ML.setup(nv, rng, device=self.dev))
        ck, vk = stage("trim", lambda: ML.trim(pp, nv))
        comm = stage("commit", lambda: ML.commit(ck, table))
        point = [rng.field_int(spec) for _ in range(nv)]
        proof = stage("open", lambda: ML.open(ck, table, point))
        # the value: the host MLE fold of the same ints
        ints = F.to_ints(spec, table)
        for z in point:
            ints = [(a + z * (b - a)) % p for a, b in zip(ints[0::2], ints[1::2])]
        value = ints[0]
        ok = stage("check", lambda: ML.check(vk, comm, point, value, proof))
        rejected = not stage("check_tampered", lambda: ML.check(vk, comm, point, (value + 1) % p, proof))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts()

        # check's parts apart: the host algebra, and the product of nv + 1
        # pairings; and open's largest part, its first G2 MSM (2^nv points)
        split = {}
        g1s, g2s = stage("host_algebra", lambda: ML.pairing_inputs(vk, comm, point, value, proof), split)
        stage("multi_pairing", lambda: kzg10.pairing_product_is_one_host(g1s, g2s), split)
        open_split = {}
        stage("first_g2_msm", lambda: M.msm_mont(ML.G2, table, ck.powers_of_h[0], assume_distinct=True),
              open_split)
        device_value = F.to_ints(spec, P.mle_evaluate(spec, table, F.from_ints(spec, point, device=self.dev)))
        needed = [f"ec_{w}" for w in ("g2_madd", "g2_madd_distinct", "g2_madd_distinct_packed",
                                      "g2_add", "g2_double", "madd_scan", "add")]
        needed += ["digit_sort", "ff_mont_mul[fq_bls12_381]", "ff_pow[fq_bls12_381]",
                   "ff_batch_inv[fq_bls12_381]", "ff_mont_mul[fr_bls12_381]"]
        all_launched = self.all_launched(launches, by_field, needed)
        emit({"phase": "multilinear_pc", "scheme": "MultilinearPC/BLS12-381", "num_vars": nv,
              "stage_ms": stages, "check_split_ms": split, "open_split_ms": open_split,
              "check": bool(ok), "tampered_rejected": rejected,
              "value_matches_host": device_value == value,
              "launches": launches, "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "peak_mem_gb": peak_gb})
        self.mlpc = dict(vk=vk, comm=comm, point=point, value=value, proof=proof)  # phase 15
        return bool(ok) and rejected and device_value == value and all_launched

    # -- phase 8 ----------------------------------------------------------
    def ipa_path(self):
        """InnerProductArgPC over JubJub at degree 2^IPA_LOG_DEGREE - 1, one
        hiding polynomial; setup's hash-to-curve is its own stage. After the
        counted run: open again with its parts timed apart, and one key fold
        under torch.profiler."""
        import random

        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core import msm_gpu
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import ipa_pc
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial

        torch = self.torch
        PC = ipa_pc.InnerProductArgPC
        spec, p = PC.spec, PC.spec.modulus
        degree = (1 << IPA_LOG_DEGREE) - 1
        coeffs = self.rand_field(spec, degree + 1).T.contiguous()  # (D+1, L) Montgomery
        rng = HostRng(6)
        stages = {}

        def stage(name, fn, into=stages):
            return timed(into, name, fn)

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        # PC.setup is these two steps: the host hash-to-curve, then the key
        # on the device
        gens = stage("hash_to_curve", lambda: ipa_pc.sample_generators(degree + 3))
        pp = stage("setup", lambda: ipa_pc.params_from_generators(gens, self.dev))
        ck, vk = stage("trim", lambda: PC.trim(pp, degree, 1))
        lp = LabeledPolynomial("p", coeffs, hiding_bound=1)
        comms, states = stage("commit", lambda: PC.commit(ck, [lp], rng))
        z = rng.field_int(spec)
        query_set = {("p", ("z", z))}
        proofs, values = stage("open", lambda: PC.batch_open(
            ck, [lp], comms, query_set, PoseidonSponge(spec), states, rng))
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        bad = {k: (v + 1) % p for k, v in values.items()}
        rejected = not stage("check_tampered", lambda: PC.batch_check(
            vk, comms, query_set, bad, proofs, PoseidonSponge(spec)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts()

        # open again, its parts timed apart: every MSM (the hiding commit and
        # two a round), within them the host window folds, the key folds and
        # the inner products (two a round); the rest is host work
        # (transcript, h' terms, conversions)
        with spans([(ipa_pc.M, "msm_mont"), (msm_gpu, "_fold_host"), (ipa_pc, "fold_key"),
                    (ipa_pc, "_inner_product")]) as parts:
            open_ms = {}
            stage("open", lambda: PC.batch_open(ck, [lp], comms, query_set, PoseidonSponge(spec),
                                                states, HostRng(7)), open_ms)
        open_split = {"total_ms": open_ms["open"],
                      **{f"{k}_ms": ms for k, (ms, _) in parts.items()},
                      **{f"{k}_calls": calls for k, (_, calls) in parts.items()}}
        open_split["rest_ms"] = (open_ms["open"] - open_split["msm_mont_ms"]
                                 - open_split["fold_key_ms"] - open_split["_inner_product_ms"])

        # the first round's key fold (2^15 points) once under torch.profiler
        half = ck.comm_key[0].shape[0] // 2
        k_l, k_r = (tuple(a[cut] for a in ck.comm_key) for cut in (slice(half), slice(half, None)))
        challenge = random.Random(9).getrandbits(252)
        fold_profile = self.profile(lambda: ipa_pc.fold_key(k_l, k_r, challenge))

        value_ok = values[("p", z)] == horner(F.to_ints(spec, coeffs), z, p)
        needed = ["ec_ed_madd_packed", "ec_ed_add", "ec_ed_smul", "digit_sort",
                  "ff_mont_mul[fr_jubjub]", "ff_add[fr_jubjub]", "ff_sum[fr_jubjub]",
                  "ff_mont_mul[fr_bls12_381]", "ff_pow[fr_bls12_381]", "ff_batch_inv[fr_bls12_381]"]
        all_launched = self.all_launched(launches, by_field, needed)
        # each round's key fold is one ed_smul launch; each of its two inner
        # products at most two ff_sum launches
        rounds = len(proofs[0].l_vec)
        one_smul_a_round = launches["ec_ed_smul"] == rounds
        sums_ok = launches["ff_sum"] <= 2 * 2 * rounds
        emit({"phase": "ipa", "scheme": "InnerProductArgPC/JubJub", "degree": degree,
              "hiding_bound": 1, "stage_ms": stages, "open_split_ms": open_split, "check": bool(ok),
              "tampered_rejected": rejected,
              "value_matches_host": value_ok, "rounds": rounds, "launches": launches,
              "one_ed_smul_a_round": one_smul_a_round, "inner_products_in_two_launches": sums_ok,
              "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched,
              "peak_mem_gb": peak_gb})
        emit({"phase": "ipa_fold_profile", "points": half, **fold_profile})
        eq_ok = self.ipa_equation(PC, ck, vk, lp, comms, states)
        self.ipa = dict(PC=PC, ck=ck, vk=vk)  # phase 14 reuses the SRS
        return (bool(ok) and rejected and value_ok and all_launched and one_smul_a_round and sums_ok
                and eq_ok)

    def ipa_equation(self, PC, ck, vk, lp, comms, states):
        """IPA-PC's single-equation case on phase 8's SRS: a second hiding
        polynomial, one equation a p + b p2 + c, open_combinations ->
        check_combinations, the claimed value from host Horner, and the value
        plus one rejected. Its launches stay out of the phase 4-8 sums."""
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs.data_structures import (HostRng, LabeledPolynomial,
                                                               LinearCombination)

        spec, p = PC.spec, PC.spec.modulus
        coeffs2 = self.rand_field(spec, lp.poly.shape[0]).T.contiguous()
        rng = HostRng(13)
        stages = {}

        def stage(name, fn):
            return timed(stages, name, fn)

        self.reset_counts()
        lp2 = LabeledPolynomial("p2", coeffs2, hiding_bound=1)
        comms2, states2 = stage("commit_p2", lambda: PC.commit(ck, [lp2], rng))
        a, b, c = (rng.field_int(spec) for _ in range(3))
        lc = LinearCombination("lc", [(a, "p"), (b, "p2"), (c, "one")])
        z = rng.field_int(spec)
        query_set = {("lc", ("z", z))}
        value = (a * horner(F.to_ints(spec, lp.poly), z, p)
                 + b * horner(F.to_ints(spec, coeffs2), z, p) + c) % p
        proof = stage("open_combinations", lambda: PC.open_combinations(
            ck, [lc], [lp, lp2], comms + comms2, query_set, PoseidonSponge(spec),
            states + states2, rng))
        ok = stage("check_combinations", lambda: PC.check_combinations(
            vk, [lc], comms + comms2, query_set, {("lc", z): value}, proof, PoseidonSponge(spec)))
        rejected = not stage("check_tampered", lambda: PC.check_combinations(
            vk, [lc], comms + comms2, query_set, {("lc", z): (value + 1) % p}, proof,
            PoseidonSponge(spec)))
        launches, _, _ = self.read_counts(in_sums=False)
        emit({"phase": "ipa_equation", "scheme": "InnerProductArgPC/JubJub", "equations": 1,
              "terms": len(lc.terms), "stage_ms": stages, "check": bool(ok),
              "tampered_rejected": rejected, "launches": launches})
        return bool(ok) and rejected

    # -- phase 9 ----------------------------------------------------------
    def sonic_path(self):
        """SonicKZG10 over BLS12-381 at degree 2^LOG_DEGREE - 1: setup with
        the G2 powers (its host powers, their conversion to limbs and its G1
        and G2 fixed-base multiplications timed apart), trim with one degree bound, commit two
        hiding polynomials (one bounded), batch_open both at two points,
        batch_check; then the values against host Horner and three of the
        G2 powers against the host."""
        from poly_commit_tpu_torch.core import curve as C
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core import hostec
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import kzg10
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
        from poly_commit_tpu_torch.pcs.sonic_pc import SonicKZG10

        torch = self.torch
        PC = SonicKZG10
        spec, r = PC.spec, PC.spec.modulus
        degree = (1 << LOG_DEGREE) - 1
        bound = (1 << (LOG_DEGREE - 1)) - 1
        coeffs = [self.rand_field(spec, n + 1).T.contiguous() for n in (degree, bound)]
        seed = 9
        rng = HostRng(seed)
        stages = {}

        def stage(name, fn):
            return timed(stages, name, fn)

        def part(attr, args):  # host_powers, scalars_from_ints, g1_fixed_base, g2_fixed_base
            return f"{args[0].name[-2:]}_fixed_base" if attr == "fixed_base_mul" else attr

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with spans([(kzg10, "host_powers"), (kzg10.M, "scalars_from_ints"),
                    (kzg10.M, "fixed_base_mul")], key=part) as parts:
            pp = stage("setup", lambda: PC.setup(degree, rng=rng, device=self.dev))
        setup_split = {f"{k}_ms": ms for k, (ms, _) in parts.items()}
        setup_split["rest_ms"] = stages["setup"] - sum(setup_split.values())
        ck, vk = stage("trim", lambda: PC.trim(pp, degree, 1, [bound]))
        polys = [LabeledPolynomial("p0", coeffs[0], hiding_bound=1),
                 LabeledPolynomial("p1", coeffs[1], degree_bound=bound, hiding_bound=1)]
        comms, states = stage("commit", lambda: PC.commit(ck, polys, rng))
        zs = [rng.field_int(spec) for _ in range(2)]
        query_set = {(lp.label, (f"z{i}", z)) for lp in polys for i, z in enumerate(zs)}
        proofs, values = stage("open", lambda: PC.batch_open(
            ck, polys, comms, query_set, PoseidonSponge(spec), states, rng))
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        first = sorted(values)[0]
        bad = {**values, first: (values[first] + 1) % r}
        rejected = not stage("check_tampered", lambda: PC.batch_check(
            vk, comms, query_set, bad, proofs, PoseidonSponge(spec)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts(in_sums=False)

        # the four values against host Horner on the coefficients
        values_ok = True
        for lp, c in zip(polys, coeffs):
            ints = F.to_ints(spec, c)
            values_ok = values_ok and all(values[(lp.label, z)] == horner(ints, z, r) for z in zs)
        # neg_powers_of_h[i] = beta^-i h: beta and h's scalar are the
        # seed's first and fourth draws
        g2 = C.BLS12_381_G2
        hg2 = hostec.host_group(g2)
        draws = HostRng(seed).field_ints(spec, 4)
        h = hg2.mul_fast(g2.generator_host(), draws[3])
        at = [1, (1 << LOG_DEGREE) - (1 << (LOG_DEGREE - 1)), (1 << LOG_DEGREE) - 1]
        want = [hostec.host_to_triple(hg2.mul_fast(h, pow(draws[0], -i, r)), fq2=True) for i in at]
        neg_ok = (kzg10.affine_at(g2, pp.neg_powers_of_h, at) == want
                  and pp.h == hostec.host_to_triple(h, fq2=True))
        needed = ["ec_g2_madd", "ec_g2_madd_distinct", "ec_g2_double"] + list(self.MAIN_PATH_EC)
        needed += ["digit_sort", "ff_mont_mul[fq_bls12_381]", "ff_pow[fq_bls12_381]",
                   "ff_batch_inv[fq_bls12_381]", "ff_mont_mul[fr_bls12_381]", "ff_add[fr_bls12_381]"]
        all_launched = self.all_launched(launches, by_field, needed)
        emit({"phase": "sonic", "scheme": "SonicKZG10/BLS12-381", "degree": degree,
              "degree_bound": bound, "hiding_bound": 1, "points": 2, "stage_ms": stages,
              "setup_split_ms": setup_split, "check": bool(ok), "tampered_rejected": rejected,
              "values_match_host": values_ok, "neg_powers_of_h_match_host": neg_ok,
              "launches": launches, "launches_by_field": by_field,
              "ff_launches_by_size": ff_by_size, "all_kernels_launched": all_launched,
              "peak_mem_gb": peak_gb})
        return bool(ok) and rejected and values_ok and neg_ok and all_launched

    # -- ark_golden -------------------------------------------------------
    def ark_golden(self):
        """The port's three arkworks transcripts with commit and open on the
        card, each against its committed vector in tests/vectors/."""
        from poly_commit_tpu_torch.pcs import ark_interop as AI

        runs = {"marlin_ark_golden": lambda v: AI.marlin_ark_golden(v["degree"], device=self.dev),
                "marlin_bounded_ark_golden": lambda v: AI.marlin_ark_golden_bounded(
                    v["degree"], v["degree_bound"], v["hiding_bound"], device=self.dev),
                "sonic_ark_golden": lambda v: AI.sonic_ark_golden(
                    v["degree"], v["degree_bound"], v["hiding_bound"], device=self.dev)}
        all_equal = True
        for name, run in runs.items():
            want = json.loads((Path(__file__).parent / "tests" / "vectors" / f"{name}.json").read_text())
            self.reset_counts()
            ms = {}
            got = timed(ms, "ms", lambda: run(want))
            launches, _, _ = self.read_counts(in_sums=False)
            differ = [k for k in want if got.get(k) != want[k]] + [k for k in got if k not in want]
            equal = got == want and want["check"] is True
            all_equal = all_equal and equal and launches["ec_madd_scan"] > 0
            emit({"phase": "ark_golden", "vector": name, "equal": equal,
                  "first_differing_key": differ[0] if differ else None, "ms": ms["ms"],
                  "msm_scan_launches": launches["ec_madd_scan"],
                  "digit_sort_launches": launches["digit_sort"]})
        return all_equal

    # -- phase 10 ---------------------------------------------------------
    def brakedown_path(self):
        """MultilinearBrakedown over BN254 Fr at BRAKEDOWN_NUM_VARS
        variables: setup -> trim -> commit -> batch_open -> batch_check, the
        value against a host evaluation, a tampered value rejected; then
        commit's parts timed apart on the same matrix (the encode on the
        card, the column bytes, Blake2s, the Merkle tree)."""
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import linear_codes as LC
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
        from poly_commit_tpu_torch.pcs.linear_codes import engine
        from poly_commit_tpu_torch.utils.merkle import MerkleTree, blake2s_hash

        torch = self.torch
        PC = LC.MultilinearBrakedown
        spec, p, nv = PC.spec, PC.spec.modulus, BRAKEDOWN_NUM_VARS
        table = self.rand_field(spec, 1 << nv).T.contiguous()  # (2^nv, L) Montgomery
        rng = HostRng(10)
        stages = {}

        def stage(name, fn, into=stages):
            return timed(into, name, fn)

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        pp = stage("setup", lambda: PC.setup(0, num_vars=nv, rng=rng, device=self.dev))
        ck, vk = stage("trim", lambda: PC.trim(pp, 0))
        lp = LabeledPolynomial("p", table, num_vars=nv)
        comms, states = stage("commit", lambda: PC.commit(ck, [lp], rng))
        point = tuple(rng.field_int(spec) for _ in range(nv))
        query_set = {("p", ("z", point))}
        proofs, values = stage("open", lambda: PC.batch_open(
            ck, [lp], comms, query_set, PoseidonSponge(spec), states, rng))
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        key = next(iter(values))
        bad = {key: (values[key] + 1) % p}
        rejected = not stage("check_tampered", lambda: PC.batch_check(
            vk, comms, query_set, bad, proofs, PoseidonSponge(spec)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts(in_sums=False)
        needed = ["ff_mont_mul[fr_bn254]", "ff_add[fr_bn254]", "ff_sub[fr_bn254]"]
        all_launched = self.all_launched(launches, by_field, needed)

        md = comms[0].commitment.metadata
        mat = states[0].mat
        split = {}
        ext = stage("encode", lambda: PC.code.encode_rows(mat, ck), split)
        raw = stage("column_bytes", lambda: engine.column_bytes(spec, ext), split)
        leaves = stage("blake2s", lambda: [blake2s_hash(c.tobytes()) for c in raw], split)
        root = stage("merkle", lambda: MerkleTree(leaves, ck.merkle_config()).root, split)
        del ext, raw
        self.mesh_keys["brakedown"] = ck

        ints = F.to_ints(spec, table)  # the value: the host MLE fold
        for z in point:
            ints = [(a + z * (b - a)) % p for a, b in zip(ints[0::2], ints[1::2])]
        value_ok = values[key] == ints[0]
        root_ok = root == comms[0].commitment.root
        emit({"phase": "brakedown", "scheme": PC.__name__, "num_vars": nv, "rows": md.n_rows,
              "cols": md.n_cols, "ext_cols": md.n_ext_cols,
              "queried_columns": len(proofs[0][0].opening.columns),
              "a_nonzeros": sum(pp.a_dims[i][0] * pp.a_dims[i][2] for i in range(len(pp.a_dims))),
              "b_nonzeros": sum(pp.b_dims[i][0] * pp.b_dims[i][2] for i in range(len(pp.b_dims))),
              "stage_ms": stages, "commit_split_ms": split, "root_matches": root_ok,
              "check": bool(ok), "tampered_rejected": rejected, "value_matches_host": value_ok,
              "launches": launches, "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "peak_mem_gb": peak_gb})
        return bool(ok) and rejected and value_ok and root_ok and all_launched

    # -- phase 11 ---------------------------------------------------------
    ROW_LANES = (16, 32, 64, 128, 256)  # msm_rows lane counts timed on one chunk

    def hyrax_path(self):
        """Hyrax over BN254 at HYRAX_NUM_VARS variables, one hiding
        polynomial: setup -> trim -> commit -> open -> check, the value
        against the host MLE fold, a tampered proof rejected (z[0] + 1, and
        com_eval replaced by com_d); commit's host window folds counted (0:
        the batched MSM folds on the card) and its launches. Then commit
        again with its parts timed apart, once under torch.profiler, and
        msm_rows on one chunk of rows at each of ROW_LANES."""
        import copy

        from poly_commit_tpu_torch.core import ec_lf, ff, msm_gpu, sort_gpu
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core.serialize import device_points_to_ints
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import hyrax
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial

        torch = self.torch
        PC = hyrax.HyraxPC
        spec, p, nv = PC.spec, PC.spec.modulus, HYRAX_NUM_VARS
        table = self.rand_field(spec, 1 << nv).T.contiguous()  # (2^nv, L) Montgomery
        rng = HostRng(11)
        stages = {}

        def stage(name, fn, into=stages):
            return timed(into, name, fn)

        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        pp = stage("setup", lambda: PC.setup(0, num_vars=nv, rng=rng, device=self.dev))
        ck, vk = stage("trim", lambda: PC.trim(pp))
        self.mesh_keys["hyrax"] = ck
        lp = LabeledPolynomial("p", table, hiding_bound=1, num_vars=nv)
        before = {k: w.launches for k, w in self.wrappers.items()}
        with spans([(msm_gpu, "_fold_host")]) as folds:
            comms, states = stage("commit", lambda: PC.commit(ck, [lp], rng))
        commit_launches = {k: w.launches - before[k] for k, w in self.wrappers.items()
                           if w.launches != before[k]}
        point = tuple(rng.field_int(spec) for _ in range(nv))
        query_set = {("p", ("z", point))}
        proofs, values = stage("open", lambda: PC.batch_open(
            ck, [lp], comms, query_set, PoseidonSponge(spec), states, rng))
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        tampered = {}
        for field in ("z", "com_eval"):
            bad = copy.deepcopy(proofs)
            if field == "z":
                bad[0][0].z[0] = (bad[0][0].z[0] + 1) % p
            else:
                bad[0][0].com_eval = bad[0][0].com_d
            tampered[field] = not stage(f"check_tampered_{field}", lambda: PC.batch_check(
                vk, comms, query_set, values, bad, PoseidonSponge(spec)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts(in_sums=False)
        needed = ["ec_madd_scan[fq_bn254]", "ec_add[fq_bn254]", "ec_double[fq_bn254]",
                  "ec_madd[fq_bn254]", "ec_madd_distinct[fq_bn254]",
                  "ec_window_fold[fq_bn254]", "digit_sort",
                  "ff_batch_inv[fq_bn254]", "ff_pow[fq_bn254]", "ff_mont_mul[fq_bn254]",
                  "ff_mont_mul[fr_bn254]", "ff_add[fr_bn254]"]
        all_launched = self.all_launched(launches, by_field, needed)
        host_folds = folds.get("_fold_host", (0.0, 0))[1]
        dim = ck.dim
        w_count = msm_gpu.SCALAR_BITS // msm_gpu.rows_params(self.dev, dim)[0]
        chunks = -(-dim // max(1, min(msm_gpu.CHUNK // dim, msm_gpu.MAX_ROW_WINDOWS // w_count)))

        # commit's parts apart: within the batched MSM the digit sort, the
        # scan and the rest of the body (gathers, lane and Abel trees), the
        # device fold; the hiding terms' fixed-base multiplication; the
        # normalisations, by columns (the row commitments', and the
        # fixed-base table's)
        def part(attr, args):
            if attr == "jacobian_to_affine":
                return f"normalise_{args[1][0].shape[1]}_columns"
            return attr

        split = {}
        with spans([(sort_gpu, "digit_sort"), (ec_lf, "madd_scan"), (msm_gpu, "_msm_body"),
                    (msm_gpu, "fold_device"), (msm_gpu, "fixed_base"),
                    (msm_gpu, "jacobian_to_affine")], key=part) as parts:
            stage("commit", lambda: PC.commit(ck, [lp], HostRng(12)), split)
        commit_split = {"total_ms": split["commit"],
                        **{f"{k}_ms": ms for k, (ms, _) in parts.items()},
                        **{f"{k}_calls": calls for k, (_, calls) in parts.items()}}
        commit_split["trees_and_gathers_ms"] = (commit_split["_msm_body_ms"]
                                                - commit_split["digit_sort_ms"]
                                                - commit_split["madd_scan_ms"])
        profile = self.profile(lambda: PC.commit(ck, [lp], HostRng(12)))

        # msm_rows on the first chunk of rows at each lane count: the same
        # group elements, and its time
        mat = states[0].mat
        rows = min(dim, msm_gpu.CHUNK // dim)
        sc = F.from_mont(spec, mat[:rows])
        x, y, inf = ck.com_key
        x, y = ff.from_field_last(x), ff.from_field_last(y)
        lanes_ms, lanes_pts = {}, {}
        c, rows_params = msm_gpu.rows_params(self.dev, dim)[0], msm_gpu.rows_params
        try:
            for t in self.ROW_LANES:
                msm_gpu.rows_params = lambda device, n, t=t: (c, t)
                out = stage(str(t), lambda: msm_gpu.msm_rows(hyrax.GROUP, sc, x, y, inf, True),
                            lanes_ms)
                lanes_pts[t] = device_points_to_ints(hyrax.GROUP, tuple(
                    ff.to_field_last(cc, (rows,)) for cc in out))
        finally:
            msm_gpu.rows_params = rows_params
        lanes_equal = all(v == lanes_pts[self.ROW_LANES[0]] for v in lanes_pts.values())
        del sc, lanes_pts

        ints = F.to_ints(spec, table)  # the value: the host MLE fold
        for z in point:
            ints = [(a + z * (b - a)) % p for a, b in zip(ints[0::2], ints[1::2])]
        value_ok = values[("p", point)] == ints[0]
        emit({"phase": "hyrax", "scheme": "Hyrax/BN254", "num_vars": nv, "rows": dim,
              "row_chunks": chunks, "stage_ms": stages, "commit_split_ms": commit_split,
              "commit_host_folds": host_folds, "commit_launches": commit_launches,
              "check": bool(ok), "tampered_rejected": tampered, "value_matches_host": value_ok,
              "launches": launches, "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "peak_mem_gb": peak_gb,
              "msm_rows_lanes_ms": lanes_ms, "msm_rows_lanes_equal": lanes_equal})
        emit({"phase": "hyrax_profile", "stage": "commit", **profile})
        return (bool(ok) and all(tampered.values()) and value_ok and all_launched
                and host_folds == 0 and lanes_equal)

    # -- phase 12 ---------------------------------------------------------
    def pst13_path(self):
        """MarlinPST13 over BLS12-381 at PST13_NUM_VARS variables and degree
        PST13_DEGREE (an SRS of C(nv + d, d) G1 points): setup, trim with
        hiding bound 1, commit two dense polynomials over every monomial
        (the second hiding), batch_open both at one point, batch_check; the
        values against the coefficients dotted with the monomial values at
        the point, a value plus one rejected; setup's and open's host parts
        timed apart. Then a MarlinPST13_BLS12_377 round trip at nv 3, degree
        4, with its own launch counts."""
        import numpy as np

        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import pst13
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial

        torch = self.torch
        PC, M = pst13.MarlinPST13, pst13.M
        spec, r = PC.spec, PC.spec.modulus
        nv, degree = PST13_NUM_VARS, PST13_DEGREE
        rng = HostRng(12)
        stages = {}

        def stage(name, fn):
            return timed(stages, name, fn)

        def host_split(parts, total):
            """Each part's ms, the rest, and the host share: the stage's
            time outside its fixed-base multiplications and MSMs."""
            out = {f"{k}_ms": ms for k, (ms, _) in parts.items()}
            out["rest_ms"] = total - sum(out.values())
            device = sum(out.get(k, 0.0) for k in ("fixed_base_mul_ms", "msm_ms"))
            out["host_share"] = (total - device) / total
            return out

        hosted = [(pst13, "_all_monomials"), (pst13, "_monomial_values"), (M, "scalars_from_ints"),
                  (pst13, "divide_at_point"), (pst13.MVPoly, "evaluate"), (M, "fixed_base_mul"),
                  (M, "msm")]
        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with spans(hosted) as parts:
            pp = stage("setup", lambda: PC.setup(degree, num_vars=nv, rng=rng, device=self.dev))
        setup_split = host_split(parts, stages["setup"])
        ck, vk = stage("trim", lambda: PC.trim(pp, degree, 1))
        monomials = pst13._all_monomials(nv, degree)
        gen = np.random.default_rng(12)
        coeffs = []
        for _ in range(2):
            raw = gen.bytes(40 * len(monomials))
            coeffs.append([int.from_bytes(raw[i : i + 40], "little") % r
                           for i in range(0, len(raw), 40)])
        polys = [LabeledPolynomial(f"p{i}", pst13.MVPoly(nv, dict(zip(monomials, c))),
                                   hiding_bound=1 if i else None, num_vars=nv)
                 for i, c in enumerate(coeffs)]
        comms, states = stage("commit", lambda: PC.commit(ck, polys, rng))
        point = tuple(rng.field_int(spec) for _ in range(nv))
        query_set = {(lp.label, ("z", point)) for lp in polys}
        with spans(hosted) as parts:
            proofs, values = stage("open", lambda: PC.batch_open(
                ck, polys, comms, query_set, PoseidonSponge(spec), states, rng))
        open_split = host_split(parts, stages["open"])
        ok = stage("check", lambda: PC.batch_check(vk, comms, query_set, values, proofs,
                                                   PoseidonSponge(spec)))
        first = sorted(values)[0]
        bad = {**values, first: (values[first] + 1) % r}
        rejected = not stage("check_tampered", lambda: PC.batch_check(
            vk, comms, query_set, bad, proofs, PoseidonSponge(spec)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts(in_sums=False)
        # the values: the coefficients dotted with the monomial values at the
        # point (setup's incremental products), not MVPoly.evaluate's tables
        at = pst13._monomial_values(list(point), degree, r)
        values_ok = all(values[(lp.label, point)] == sum(a * b for a, b in zip(c, at)) % r
                        for lp, c in zip(polys, coeffs))
        needed = list(self.MAIN_PATH_EC) + ["digit_sort", "ec_g2_madd", "ec_g2_madd_distinct",
                                            "ec_g2_double", "ff_mont_mul[fq_bls12_381]",
                                            "ff_pow[fq_bls12_381]", "ff_batch_inv[fq_bls12_381]"]
        all_launched = self.all_launched(launches, by_field, needed)
        scanned = launches["ec_madd_distinct_packed"] <= self.MAX_PACKED_MADD_LAUNCHES
        self.mesh_keys["pst13"] = (ck, polys[0].poly, comms[0].commitment)  # polys[0] is not hiding
        del polys, coeffs, states

        # MarlinPST13_BLS12_377: a small round trip, its launches apart
        PC7 = pst13.MarlinPST13_BLS12_377
        spec7 = PC7.spec
        self.reset_counts()
        rng7 = HostRng(13)
        small = {}
        pp7 = timed(small, "setup", lambda: PC7.setup(4, num_vars=3, rng=rng7, device=self.dev))
        ck7, vk7 = PC7.trim(pp7, 4, 1)
        polys7 = [LabeledPolynomial(f"q{i}", pst13.MVPoly.rand(rng7, 3, 4, num_terms=12, spec=spec7),
                                    hiding_bound=1, num_vars=3) for i in range(2)]
        comms7, states7 = timed(small, "commit", lambda: PC7.commit(ck7, polys7, rng7))
        pt7 = tuple(rng7.field_int(spec7) for _ in range(3))
        qs7 = {(lp.label, ("z", pt7)) for lp in polys7}
        proofs7, values7 = timed(small, "open", lambda: PC7.batch_open(
            ck7, polys7, comms7, qs7, PoseidonSponge(spec7), states7, rng7))
        ok7 = timed(small, "check", lambda: PC7.batch_check(vk7, comms7, qs7, values7, proofs7,
                                                            PoseidonSponge(spec7)))
        k7 = sorted(values7)[0]
        bad7 = {**values7, k7: (values7[k7] + 1) % spec7.modulus}
        rejected7 = not PC7.batch_check(vk7, comms7, qs7, bad7, proofs7, PoseidonSponge(spec7))
        launches7, by_field7, _ = self.read_counts(in_sums=False)
        needed7 = [f"{k}[fq_bls12_377]" for k in self.MAIN_PATH_EC] + ["digit_sort"]
        all_launched7 = self.all_launched(launches7, by_field7, needed7)
        emit({"phase": "pst13", "scheme": "MarlinPST13/BLS12-381", "num_vars": nv,
              "degree": degree, "srs_points": len(monomials), "hiding_bound": 1, "points": 1,
              "stage_ms": stages, "setup_split_ms": setup_split, "open_split_ms": open_split,
              "check": bool(ok), "tampered_rejected": rejected, "values_match_host": values_ok,
              "launches": launches, "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "msms_scanned_in_one_launch": scanned,
              "peak_mem_gb": peak_gb,
              "bls12_377": {"num_vars": 3, "degree": 4, "stage_ms": small, "check": bool(ok7),
                            "tampered_rejected": rejected7, "launches_by_field": by_field7,
                            "all_kernels_launched": all_launched7}})
        return (bool(ok) and rejected and values_ok and all_launched and scanned and bool(ok7)
                and rejected7 and all_launched7)

    # -- phase 13 ---------------------------------------------------------
    MAX_K1_PER_COEFFICIENT = 0.1  # the streaming divisions run in log depth

    def streaming_path(self):
        """Streaming KZG (Gemini) over BLS12-381 at degree 2^LOG_DEGREE - 1
        with STREAM_POINTS points (beta, -beta, beta^2), chunks of
        STREAM_CHUNK and STREAM_DEPTH folds: the key; the time prover's
        commit of two polynomials, open, open_multi_points,
        batch_open_multi_points and commit_folding; the space prover's
        commit_chunked, open_chunked, open_multi_points_chunked and
        open_folding_chunked; verify and verify_multi_points, each also on
        a value plus one. Every chunked group element against the time
        prover's, every remainder against long_divide's, the folding proof
        against the commitment of sum_j eta_j (f^(j) div Z), the single
        value against host Horner. Each stage's K1 and K4 launches apart;
        long_divide and the chunked opens fail at MAX_K1_PER_COEFFICIENT K1
        launches a coefficient or more."""
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core import hostec, ntt_lf
        from poly_commit_tpu_torch.core import poly as P
        from poly_commit_tpu_torch.pcs import kzg10
        from poly_commit_tpu_torch.pcs import streaming_kzg as SK
        from poly_commit_tpu_torch.pcs.data_structures import HostRng

        torch = self.torch
        spec, r = SK.SPEC, SK.SPEC.modulus
        degree = (1 << LOG_DEGREE) - 1
        n, chunk, depth = degree + 1, STREAM_CHUNK, STREAM_DEPTH
        rng = HostRng(14)
        stages, split = {}, {}

        def k_counts():
            return (sum(w.launches for w in self.ff_wrappers.values()),
                    sum(w.launches for w in ntt_lf.WRAPPERS))

        def stage(name, fn):
            k1, k4 = k_counts()
            out = timed(stages, name, fn)
            k1b, k4b = k_counts()
            split[name] = {"k1": k1b - k1, "k4": k4b - k4}
            return out

        f, f2 = (self.rand_field(spec, n).T.contiguous() for _ in range(2))  # (n, L) Montgomery
        self.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        ck = stage("setup", lambda: SK.CommitterKey.new(degree, STREAM_POINTS, rng, device=self.dev))
        vk = ck.verifier_key()
        beta = rng.field_int(spec)
        pts = [beta, r - beta, beta * beta % r]
        chal = rng.field_int(spec)
        rhos = [rng.field_int(spec) for _ in range(depth)]
        etas = SK._powers_int(rng.field_int(spec), depth)
        comm = stage("commit", lambda: ck.commit(f))
        comm2 = stage("commit_2", lambda: ck.commit(f2))
        value, proof = stage("open", lambda: ck.open(f, beta))
        multi = stage("open_multi_points", lambda: ck.open_multi_points(f, pts))
        batch = stage("batch_open_multi_points", lambda: ck.batch_open_multi_points([f, f2], pts, chal))
        folded = stage("commit_folding", lambda: ck.commit_folding(f, rhos))
        c_chunked = stage("commit_chunked", lambda: ck.commit_chunked(f, chunk))
        v_chunked, p_chunked = stage("open_chunked", lambda: ck.open_chunked(f, beta, chunk))
        rem_chunked, m_chunked = stage("open_multi_points_chunked",
                                       lambda: ck.open_multi_points_chunked(f, pts, chunk))
        rems_fold, p_fold = stage("open_folding_chunked",
                                  lambda: ck.open_folding_chunked(f, rhos, pts, etas, chunk))
        zpoly = P.vanishing_poly(spec, F.from_ints(spec, pts, device=self.dev))
        _, rem_time = stage("long_divide", lambda: P.long_divide(spec, f, zpoly))
        # the values at the points: device evaluations of each polynomial
        evals = [[int(F.to_ints(spec, P.evaluate(spec, g, F.from_ints(spec, z, device=self.dev))))
                  for z in pts] for g in (f, f2)]
        ok1 = stage("verify", lambda: SK.verify(vk, comm, beta, value, proof))
        bad1 = not stage("verify_tampered", lambda: SK.verify(vk, comm, beta, (value + 1) % r, proof))
        okm = stage("verify_multi_points", lambda: SK.verify_multi_points(
            vk, [comm, comm2], pts, evals, batch, chal))
        bad_evals = [[(evals[0][0] + 1) % r] + evals[0][1:], evals[1]]
        badm = not stage("verify_multi_points_tampered", lambda: SK.verify_multi_points(
            vk, [comm, comm2], pts, bad_evals, batch, chal))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches, by_field, ff_by_size = self.read_counts(in_sums=False)

        # the reference's time/space contract, and the folding proof
        # against the time prover: commit(sum_j eta_j (f^(j) div Z)); the
        # last fold's commitment against a host fold and a host MSM
        ints = F.to_ints(spec, f)
        last = ints
        for rho in rhos:
            last = [(a + rho * b) % r for a, b in zip(last[0::2], last[1::2])]
        hg1 = hostec.host_group(SK.G1)
        bases = [hostec.triple_to_host(t) for t in kzg10.affine_at(SK.G1, ck.powers_of_g,
                                                                    range(len(last)))]
        last_fold_commit = hostec.host_to_triple(hg1.msm_fast(last, bases))
        value_ok = value == horner(ints, beta, r) and evals[0][0] == value
        comb, fold_rems_ok = None, True
        for fj, eta, rem in zip(ck.fold_polynomials(f, rhos), etas, rems_fold):
            q, rj = P.long_divide(spec, fj, zpoly)
            fold_rems_ok &= F.to_ints(spec, rem) == F.to_ints(spec, rj)
            scaled = P.scale(spec, q, F.from_ints(spec, eta, device=self.dev))
            comb = scaled if comb is None else P.add(spec, comb, scaled)
        contract = {
            "commit_chunked": c_chunked.point == comm.point,
            "open_chunked": v_chunked == value and p_chunked.point == proof.point,
            "open_multi_points_chunked": m_chunked.point == multi.point,
            "remainder": F.to_ints(spec, rem_chunked) == F.to_ints(spec, rem_time),
            "open_folding_chunked": p_fold.point == ck.commit(comb).point,
            "folding_remainders": fold_rems_ok,
            "commit_folding": len(folded) == depth and folded[-1].point == last_fold_commit,
        }
        per_coefficient = {k: split[k]["k1"] / n for k in
                           ("long_divide", "open_chunked", "open_multi_points_chunked",
                            "open_folding_chunked")}
        log_depth = all(v < self.MAX_K1_PER_COEFFICIENT for v in per_coefficient.values())
        needed = list(self.MAIN_PATH_EC) + list(self.NTT_KERNELS) + [
            "digit_sort", "ec_g2_madd", "ec_g2_madd_distinct", "ec_g2_double",
            "ff_mont_mul[fq_bls12_381]", "ff_pow[fq_bls12_381]", "ff_batch_inv[fq_bls12_381]",
            "ff_mont_mul[fr_bls12_381]", "ff_add[fr_bls12_381]", "ff_sub[fr_bls12_381]",
            "ff_pow[fr_bls12_381]"]
        all_launched = self.all_launched(launches, by_field, needed)
        scanned = launches["ec_madd_distinct_packed"] <= self.MAX_PACKED_MADD_LAUNCHES
        emit({"phase": "streaming_kzg", "scheme": "StreamingKZG/BLS12-381", "degree": degree,
              "points": STREAM_POINTS, "chunk": chunk, "depth": depth, "stage_ms": stages,
              "stage_launches": split, "k1_launches_per_coefficient": per_coefficient,
              "log_depth": log_depth, "verify": bool(ok1), "verify_tampered_rejected": bad1,
              "verify_multi_points": bool(okm), "verify_multi_points_tampered_rejected": badm,
              "value_matches_host": value_ok, "time_space_contract": contract,
              "launches": launches, "launches_by_field": by_field, "ff_launches_by_size": ff_by_size,
              "all_kernels_launched": all_launched, "msms_scanned_in_one_launch": scanned,
              "peak_mem_gb": peak_gb})
        return (bool(ok1) and bad1 and bool(okm) and badm and value_ok and all(contract.values())
                and log_depth and all_launched and scanned)


    # -- phase 14 ---------------------------------------------------------
    def r1cs_path(self):
        """R1CS on phase 8's IPA SRS (no second hash-to-curve): commit and
        open one non-hiding polynomial of degree 2^IPA_LOG_DEGREE - 1,
        replay the verifier transcript (tests/test_r1cs.py), synthesise the
        in-circuit succinct check, and check satisfaction on the host and
        on the card (its host build and its card work timed apart), for the
        valid proof and for the value plus one."""
        from poly_commit_tpu_torch.core import field as F
        from poly_commit_tpu_torch.core.serialize import field_to_bytes
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import ipa_pc, r1cs
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial

        PC, ck, vk = self.ipa["PC"], self.ipa["ck"], self.ipa["vk"]
        self.ipa = None
        spec, p = PC.spec, PC.spec.modulus
        degree = ck.supported_degree
        coeffs = self.rand_field(spec, degree + 1).T.contiguous()
        lp = LabeledPolynomial("f", coeffs)  # no hiding: the gadget's proof form
        stages = {}

        def stage(name, fn):
            return timed(stages, name, fn)

        self.reset_counts()
        comms, states = stage("commit", lambda: PC.commit(ck, [lp]))
        z = HostRng(14).field_int(spec)
        v = horner(F.to_ints(spec, coeffs), z, p)
        proof = stage("open", lambda: PC.open(ck, [lp], comms, z, PoseidonSponge(spec), states))
        check_poly = stage("succinct_check", lambda: PC.succinct_check(
            vk, comms, z, [v], proof, PoseidonSponge(spec)))
        sponge = PoseidonSponge(spec)
        ch = sponge.squeeze_challenge_128()
        sponge.squeeze_challenge_128()  # open squeezes a second one a polynomial
        comm = comms[0].commitment.comm
        data = (ipa_pc._host_pt_bytes(ipa_pc.HGROUP.mul(comm, ch)) + field_to_bytes(spec, z)
                + field_to_bytes(spec, ch * v % p))
        inst = dict(comm=comm, z=z, h=vk.h, proof=proof, ch=ch,
                    first_round=ipa_pc._ro_challenge(data),
                    round_chs=[] if check_poly is None else list(check_poly.challenges))
        k1 = (self.ff_wrappers["ff_mont_mul"], self.ff_wrappers["ff_add"])
        runs = {}
        for name, value in (("valid", v), ("tampered", (v + 1) % p)):
            cs = stage(f"synthesis_{name}", lambda: ipa_gadget(r1cs, inst, value, degree))
            host_ok = stage(f"host_check_{name}", cs.is_satisfied)
            sc = stage(f"device_build_{name}", cs.sparse_check)
            before = [w.launches for w in k1]
            dev_ok = stage(f"device_run_{name}", lambda: sc.run(cs.assignment, self.dev))
            runs[name] = {"rows": len(cs.rows), "variables": len(cs.assignment), "nnz": list(sc.nnz),
                          "bucket_rows": {str(w): n for w, n in sc.widths.items()},
                          "distinct_coefficients": len(sc.values), "padded_entries": len(sc.cols),
                          "host_check": host_ok, "device_check": dev_ok,
                          "k1_mul_launches": k1[0].launches - before[0],
                          "k1_add_launches": k1[1].launches - before[1]}
            del cs, sc
        launches, by_field, _ = self.read_counts(in_sums=False)
        needed = ["ff_mont_mul[fr_bls12_381]", "ff_add[fr_bls12_381]", "ec_ed_smul"]
        all_launched = self.all_launched(launches, by_field, needed)
        emit({"phase": "r1cs", "gadget": "IpaSuccinctCheckGadget/JubJub over Fr-381",
              "degree": degree, "rounds": len(inst["round_chs"]), "stage_ms": stages, **runs,
              "host_verifier_accepts": check_poly is not None,
              "launches_by_field": by_field, "all_kernels_launched": all_launched})
        valid, bad = runs["valid"], runs["tampered"]
        return (check_poly is not None and valid["host_check"] and valid["device_check"]
                and not bad["host_check"] and not bad["device_check"] and all_launched)

    # -- phase 15 ---------------------------------------------------------
    def device_pairing_path(self):
        """The BLS12-381 pairing on the card (core/pairing.py): e(G1, G2)
        against the host engine's Fq12 value, e(P, Q) e(-P, Q) = 1 with an
        infinite pair, and phase 4's Marlin batch_check (2 pairs) and phase
        7's MultilinearPC check (21 pairs) under POLY_COMMIT_PAIRING=device
        against the host engines, on true and tampered values; the Miller
        loop, the final exponentiation and each check timed beside the host
        engine on the same inputs, with K1 launches and host
        synchronisations counted."""
        from poly_commit_tpu_torch.core import curve as C
        from poly_commit_tpu_torch.core import hostec
        from poly_commit_tpu_torch.core import host_pairing as HP
        from poly_commit_tpu_torch.core import pairing as PR
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.pcs import multilinear_pc as ML

        g1, g2 = C.BLS12_381_G1, C.BLS12_381_G2
        gen1, gen2 = (g1.gen_x, g1.gen_y), (g2.gen_x, g2.gen_y)
        k1_wrappers = list(self.ff_wrappers.values())
        stages, k1, syncs = {}, {}, {}

        def stage(name, fn):
            before = sum(w.launches for w in k1_wrappers)
            out = timed(stages, name, fn)
            k1[name] = sum(w.launches for w in k1_wrappers) - before
            return out

        def aff(group, pts):
            return C.affine_from_ints(group, pts, self.dev)

        self.reset_counts()
        p_gen, q_gen = aff(g1, [(*gen1, False)]), aff(g2, [(*gen2, False)])
        m = stage("miller_loop", lambda: PR.miller_loop(p_gen, q_gen))
        e = stage("final_exponentiation", lambda: PR.final_exponentiation(m))
        host_e = stage("host_pairing", lambda: HP.pairing(gen1, gen2))
        _, syncs["pairing"] = count_syncs(lambda: PR.pairing(p_gen, q_gen))
        generator_equal = PR.f12_to_ints(e[0]) == host_e

        pt = hostec.host_group(g1).mul_fast(gen1, 0x5EED)
        qt = hostec.host_group(g2).mul_fast(gen2, 0xC0FFEE)
        neg = (pt[0], (-pt[1]) % g1.spec.modulus, False)
        q3 = aff(g2, [(*qt, False)] * 3)
        inverse_ok = stage("check_p_neg_p_inf", lambda: bool(PR.pairing_check(
            aff(g1, [(*pt, False), neg, (0, 0, True)]), q3)))
        inf_one = bool(PR.f12_is_one(PR.miller_loop(aff(g1, [(0, 0, True)]),
                                                    aff(g2, [(*qt, False)]))).all())

        mk, mp = self.marlin, self.mlpc
        PC, spec = mk["PC"], mk["PC"].spec
        bad_values = {k: (v + 1) % spec.modulus for k, v in mk["values"].items()}

        def marlin(values):
            return lambda: PC.batch_check(mk["vk"], mk["comms"], mk["query_set"], values,
                                          mk["proofs"], PoseidonSponge(spec))

        def mlpc(value):
            return lambda: ML.check(mp["vk"], mp["comm"], mp["point"], value, mp["proof"])

        checks = {"marlin": (marlin(mk["values"]), marlin(bad_values)),
                  "mlpc": (mlpc(mp["value"]), mlpc((mp["value"] + 1) % ML.SPEC.modulus))}
        verdicts = {}
        for name, (true_fn, bad_fn) in checks.items():
            for backend in ("device", "host"):
                with env("POLY_COMMIT_PAIRING", backend):
                    verdicts[f"{name}_{backend}"] = [bool(stage(f"{name}_{backend}", true_fn)),
                                                     bool(stage(f"{name}_tampered_{backend}", bad_fn))]
            with env("POLY_COMMIT_PAIRING", "device"):
                _, syncs[name] = count_syncs(true_fn)
        launches, by_field, _ = self.read_counts(in_sums=False)
        needed = ["ff_mont_mul[fq_bls12_381]", "ff_add[fq_bls12_381]", "ff_sub[fq_bls12_381]",
                  "ff_pow[fq_bls12_381]", "ff_batch_inv[fq_bls12_381]"]
        all_launched = self.all_launched(launches, by_field, needed)
        agree = all(verdicts[f"{n}_device"] == verdicts[f"{n}_host"] == [True, False]
                    for n in checks)
        emit({"phase": "device_pairing", "curve": "BLS12-381", "stage_ms": stages,
              "k1_launches": k1, "host_syncs": syncs, "generator_pairing_equals_host": generator_equal,
              "p_neg_p_inf_is_one": inverse_ok, "infinite_input_gives_one": inf_one,
              "verdicts": verdicts, "pairs": {"marlin": 2, "mlpc": len(mp["point"]) + 1},
              "launches_by_field": by_field, "all_kernels_launched": all_launched})
        self.mlpc = None
        return generator_equal and inverse_ok and inf_one and agree and all_launched

    def trace_persist(self):
        """Phase 4's Marlin committer key: one commit under torch.profiler
        with POLY_COMMIT_TRACE=1 (its MarlinKZG10::commit and KZG10::commit
        spans), then the key saved and loaded onto the card (utils/persist)
        and the same polynomial committed with the loaded key."""
        from torch.profiler import ProfilerActivity, profile

        from poly_commit_tpu_torch.pcs.data_structures import LabeledPolynomial
        from poly_commit_tpu_torch.utils import persist

        torch = self.torch
        mk = self.marlin
        PC, ck = mk["PC"], mk["ck"]
        lp = LabeledPolynomial("p", mk["coeffs"])
        self.reset_counts()
        torch.cuda.synchronize()
        with env("POLY_COMMIT_TRACE", "1"), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            comms, _ = PC.commit(ck, [lp])
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        # each span's host range (the CPU event) and its device range (the
        # annotation the profiler puts around the span's kernels on the card)
        labels = ("MarlinKZG10::commit", "KZG10::commit")
        spans = {}
        for e in prof.events():
            if e.name in labels:
                side = "device_ms" if e.device_type == torch.autograd.DeviceType.CUDA else "host_ms"
                span = spans.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0})
                span[side] += (e.time_range.end - e.time_range.start) / 1e3
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "marlin_ck.npz")
            t0 = time.perf_counter()
            persist.save(path, ck)
            save_s = time.perf_counter() - t0
            file_bytes = os.path.getsize(path)
            t0 = time.perf_counter()
            loaded = persist.load(path, device=self.dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        on_card = all(t.device.type == "cuda" for t in loaded.powers + loaded.powers_of_gamma_g
                      if isinstance(t, torch.Tensor))
        comms2, _ = PC.commit(loaded, [lp])
        equal = comms2[0].commitment == comms[0].commitment
        launches, by_field, _ = self.read_counts(in_sums=False)
        all_launched = self.all_launched(launches, by_field, ["ec_madd_scan", "digit_sort"])
        emit({"phase": "trace", "stage": "MarlinKZG10::commit", "degree": ck.supported_degree,
              "wall_ms": traced_ms, "spans": spans})
        emit({"phase": "persist", "object": "MarlinKZG10 CommitterKey", "degree": ck.supported_degree,
              "save_s": save_s, "load_s": load_s, "file_bytes": file_bytes,
              "loaded_on_card": on_card, "commitment_equal": equal,
              "all_kernels_launched": all_launched})
        return (set(spans) == set(labels) and all(v["host_ms"] > 0 for v in spans.values())
                and on_card and equal and all_launched)

    # -- demo -------------------------------------------------------------
    # the drives also run on the CPU (the kernels' plain versions), their
    # commitments and values held against the card's: the cheap ones, with
    # the smallest MSMs (Hyrax's rows of 4, IPA's 8 points) and the 16-point
    # Ligero encodes
    DEMO_ON_CPU = ("ipa_pc", "univariate_ligero", "multilinear_ligero", "brakedown", "hyrax")
    # kernels every demo run must launch: K1, K2a's MSM scan and fixed-base
    # formulas, K2c (the G2 setups), K2b (IPA's key fold), K3 and K4a
    DEMO_KERNELS = ("ff_mont_mul", "ec_madd_scan", "ec_madd", "ec_g2_madd", "ec_ed_smul",
                    "digit_sort", "ntt_small")

    def demo_path(self):
        """The port's entry point (poly_commit_tpu_torch/demo.py): its ten
        drives in this process on the card, twice (the first run pays each
        scheme's first calls: tables and caches; the kernels were built in
        phase 1); each drive OK with its tamper probe rejected, each run's
        ms by scheme and stage and its launches. Then the DEMO_ON_CPU drives
        on the CPU, their commitments and values equal to the first run's."""
        import io

        from poly_commit_tpu_torch import demo

        ok = True
        first = {}
        for run in ("first", "second"):
            out = io.StringIO()
            self.reset_counts()
            t0 = time.perf_counter()
            results = demo.run(device=self.dev, out=out)
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches, by_field, _ = self.read_counts(in_sums=False)
            verdicts = [ln for ln in out.getvalue().splitlines() if ln.startswith(("OK ", "FAIL "))]
            all_launched = self.all_launched(launches, by_field, self.DEMO_KERNELS)
            passed = [r.name for r in results] == list(demo.NAMES) and all(r.passed for r in results)
            emit({"phase": "demo", "run": run, "wall_ms": wall_ms, "verdicts": verdicts,
                  "scheme_ms": {r.name: r.ms for r in results},
                  "errors": {r.name: r.error.strip().splitlines()[-1] for r in results if r.error},
                  "launches": {k: v for k, v in launches.items() if v},
                  "launches_by_field": by_field, "all_kernels_launched": all_launched})
            ok = ok and passed and all_launched
            if run == "first":
                first = {r.name: r for r in results}
        cpu_ms, equal = {}, {}
        for name in self.DEMO_ON_CPU:
            t0 = time.perf_counter()
            res = demo.run_scheme(name, "cpu")
            cpu_ms[name] = (time.perf_counter() - t0) * 1e3
            card = first[name]
            equal[name] = (res.passed and res.commitments == card.commitments
                           and res.values == card.values)
        emit({"phase": "demo", "held_against_cpu": equal, "cpu_ms": cpu_ms})
        return ok and all(equal.values())

    # -- mesh -------------------------------------------------------------
    def mesh_path(self):
        """The mesh layer (poly_commit_tpu_torch.parallel). First NCCL with
        one rank in this process: phase 4's commit, open and check under
        use_mesh(make_mesh(1)), equal to phase 4's. Then MESH_WORLD gloo ranks
        time-sharing cuda:0 (parallel/launch.py; their collectives staged
        through host memory), each check held against the single-device
        result of this run (mesh_rank)."""
        import torch.distributed as dist

        from poly_commit_tpu_torch.core import ff, ntt_lf
        from poly_commit_tpu_torch.core import field_params as FP
        from poly_commit_tpu_torch.core.transcript import PoseidonSponge
        from poly_commit_tpu_torch.parallel import launch as PL
        from poly_commit_tpu_torch.parallel import mesh as PM
        from poly_commit_tpu_torch.pcs import hyrax, ipa_pc
        from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
        from poly_commit_tpu_torch.pcs.linear_codes import engine
        from poly_commit_tpu_torch.utils import persist

        torch = self.torch
        t_phase = time.perf_counter()
        mk, self.marlin = self.marlin, None
        PC, spec = mk["PC"], mk["PC"].spec
        lp = LabeledPolynomial("p", mk["coeffs"], hiding_bound=1)
        want_marlin = (mk["comms"], mk["query_set"], mk["proofs"], mk["values"])

        # NCCL, one rank, in this process: commit + open cold (NCCL builds its
        # communicator at the first collective), check, commit + open warm;
        # the digest guard and the collectives timed apart
        self.reset_counts()
        nccl_ms = {}
        t0 = time.perf_counter()
        mesh = PM.make_mesh(1)
        try:
            nccl = {"backend": mesh.backend, "world": 1, "device": str(mesh.device),
                    "staged": mesh.staged, "make_mesh_ms": (time.perf_counter() - t0) * 1e3}
            with PM.use_mesh(mesh), spans([(PM, a) for a in MESH_SPANS]) as parts:
                got = timed(nccl_ms, "commit_open", lambda: marlin_commit_open(
                    PC, mk["ck"], lp, copy.deepcopy(mk["rng"])))
                cold = dict(parts)
                parts.clear()
                ok = timed(nccl_ms, "check", lambda: PC.batch_check(
                    mk["vk"], got[0], got[1], got[3], got[2], PoseidonSponge(spec)))
                again = timed(nccl_ms, "commit_open_warm", lambda: marlin_commit_open(
                    PC, mk["ck"], lp, copy.deepcopy(mk["rng"])))
                warm = dict(parts)
        finally:
            dist.destroy_process_group()
        launches, by_field, _ = self.read_counts(in_sums=False)
        nccl_launched = self.all_launched(launches, by_field, ["ec_madd_scan", "digit_sort"])
        single_nccl = {}
        mine = timed(single_nccl, "commit_open", lambda: marlin_commit_open(
            PC, mk["ck"], lp, copy.deepcopy(mk["rng"])))
        timed(single_nccl, "check", lambda: PC.batch_check(
            mk["vk"], mine[0], mine[1], mine[3], mine[2], PoseidonSponge(spec)))
        nccl.update(ms=nccl_ms, parts_cold=cold, parts_warm=warm, single_ms=single_nccl,
                    sharded=cold.get("msm_sharded", (0, 0))[1] > 0,
                    equal=got == want_marlin and again == want_marlin and mine == want_marlin,
                    check=bool(ok))

        # the gloo ranks' inputs: keys through utils/persist, the rest seeded
        # or pickled; and the single-device results on the same inputs
        single_ms = {"marlin_commit_open": mk["commit_open_ms"]}

        def single(name, fn):
            return timed(single_ms, name, fn)

        tmp = tempfile.mkdtemp(prefix="mesh_smoke_")
        save_s = {}
        t0 = time.perf_counter()
        persist.save(os.path.join(tmp, "marlin.npz"), mk["ck"])
        save_s["marlin_ck"] = time.perf_counter() - t0
        keys = {"hyrax": self.mesh_keys.pop("hyrax"), "brakedown": self.mesh_keys.pop("brakedown")}
        pst_ck, pst_poly, pst_comm = self.mesh_keys.pop("pst13")
        keys["pst13"] = pst_ck
        IPA = ipa_pc.InnerProductArgPC
        ipa_degree = (1 << MESH_IPA_LOG_DEGREE) - 1
        keys["ipa"] = IPA.trim(IPA.setup(ipa_degree, rng=HostRng(23), device=self.dev),
                               ipa_degree, 0, None)[0]
        for name, key in keys.items():
            t0 = time.perf_counter()
            persist.save(os.path.join(tmp, f"{name}.npz"), key)
            save_s[f"{name}_ck"] = time.perf_counter() - t0
        dev = self.dev
        ntt_spec, n = FP.FR_BN254, 1 << NTT_LOG_N
        a = seeded_field(ntt_spec, n, 1, dev)

        def ntt():
            return ff.to_field_last(ff.canonicalize(ntt_spec, ntt_lf.ntt(ntt_spec, ff.from_field_last(a))),
                                    (n,))

        fwd = single("ntt", ntt)
        single("ntt_again", ntt)
        want = {"marlin": want_marlin, "marlin_commit": mk["comms"],
                "ntt": [sha(c) for c in fwd.chunk(MESH_WORLD)],
                "ntt_tp": [sha(c) for c in fwd.chunk(2)], "pst13_poly": pst_poly}
        htable = seeded_field(hyrax.HyraxPC.spec, 1 << HYRAX_NUM_VARS, 2, dev)
        hcomms, _ = single("hyrax_commit", lambda: hyrax.HyraxPC.commit(keys["hyrax"], [LabeledPolynomial(
            "p", htable, hiding_bound=1, num_vars=HYRAX_NUM_VARS)], HostRng(21)))
        want["hyrax_commit"] = hcomms[0].commitment
        want["pst13_commit"] = single("pst13_commit", lambda: pst13_commit(pst_ck, pst_poly))
        want["pst13_matches_phase_12"] = want["pst13_commit"] == pst_comm
        for name, (PCL, ck, log_len) in mesh_codes(keys, dev).items():
            rows, cols = ck.compute_dimensions(1 << log_len)
            mat, vec = code_inputs(PCL.spec, rows, cols, dev)
            want[f"{name}_encode"] = sha(single(f"{name}_encode", lambda: PCL.code.encode_rows(mat, ck)))
            want[f"{name}_row_mul"] = sha(single(f"{name}_row_mul",
                                                 lambda: engine._row_mul(PCL.spec, vec, mat)))
            want[f"{name}_shape"] = (rows, cols)
        want["ipa_open"] = single("ipa_open", lambda: ipa_open(keys["ipa"], dev))
        del fwd, htable
        torch.save({"marlin_coeffs": mk["coeffs"].cpu(), "marlin_rng": mk["rng"], "want": want,
                    "ntt_n": n, "hyrax_nv": HYRAX_NUM_VARS}, os.path.join(tmp, "inputs.pt"))
        prep_s = time.perf_counter() - t_phase
        del mk, keys
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the ranks share the card with this process

        t0 = time.perf_counter()
        try:
            ranks = PL.launch(mesh_rank, MESH_WORLD, backend="gloo", device="cuda:0",
                              args=(tmp,), timeout=MESH_TIMEOUT_S)
        finally:
            for f in os.listdir(tmp):
                os.remove(os.path.join(tmp, f))
            os.rmdir(tmp)
        launch_s = time.perf_counter() - t0
        checks = {}
        for name in ranks[0]["checks"]:
            got = [r["checks"][name] for r in ranks]
            checks[name] = {"equal": all(g["equal"] for g in got), "rank_ms": [g["ms"] for g in got],
                            "single_ms": single_ms.get(name),
                            "sharded": all(g["sharded"] for g in got), "calls": got[0]["calls"],
                            **{k: [g[k] for g in got] for k in ("digest_ms", "guard_ms", "collective_ms")}}
        launches, by_field = {}, {}
        for r in ranks:
            for into, counts in ((launches, r["launches"]), (by_field, r["by_field"])):
                for k, c in counts.items():
                    into[k] = into.get(k, 0) + c
        for name, count in {**launches, **by_field}.items():
            self.totals[name] = self.totals.get(name, 0) + count
        needed = ["ec_madd_scan", "digit_sort", "ntt_fused_stages", "ntt_stages", "ec_ed_smul",
                  "ff_mont_mul[fr_bn254]", "ff_add[fr_bn254]"]
        gloo_launched = self.all_launched(launches, by_field, needed)
        seconds = time.perf_counter() - t_phase
        emit({"phase": "mesh", "gpu": nvidia_smi("name,power.limit"),
              "note": f"{MESH_WORLD} ranks time-sharing one card: equality, not a scaling figure",
              "nccl": nccl, "gloo": {k: ranks[0][k] for k in ("backend", "world", "device", "staged")},
              "coords_2d": [r["coords_2d"] for r in ranks], "checks": checks,
              "pst13_single_matches_phase_12": want["pst13_matches_phase_12"],
              "code_shapes": {k: v for k, v in want.items() if k.endswith("_shape")},
              "persist_save_s": save_s, "prep_s": prep_s, "launch_s": launch_s,
              "rank_setup_s": [r["setup_s"] for r in ranks], "seconds": seconds,
              "launches": launches, "launches_by_field": by_field,
              "all_kernels_launched": nccl_launched and gloo_launched})
        return (nccl["equal"] and nccl["check"] and nccl["sharded"] and want["pst13_matches_phase_12"]
                and all(c["equal"] and c["sharded"] for c in checks.values())
                and nccl_launched and gloo_launched)


def sha(t) -> str:
    """sha256 of a tensor's bytes (of canonical limbs: equal values, equal
    hashes)."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def seeded_field(spec, n, seed, device):
    """(n, L) canonical Montgomery limbs drawn by a torch generator seeded
    with ``seed``: the same tensor in every process on the same card."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t = torch.randint(0, 1 << 16, (n, spec.n_limbs), generator=gen, device=device, dtype=torch.int32)
    top = spec.modulus >> (16 * (spec.n_limbs - 1))
    t[:, -1] = torch.randint(0, top, (n,), generator=gen, device=device, dtype=torch.int32)
    return t


def marlin_commit_open(PC, ck, lp, rng):
    """Phase 4's commit and batch_open from its rng state after trim:
    (commitments, query set, proofs, values)."""
    from poly_commit_tpu_torch.core.transcript import PoseidonSponge

    comms, states = PC.commit(ck, [lp], rng)
    query_set = {("p", ("z", rng.field_int(PC.spec)))}
    proofs, values = PC.batch_open(ck, [lp], comms, query_set, PoseidonSponge(PC.spec), states, rng)
    return comms, query_set, proofs, values


def pst13_commit(ck, poly):
    """Phase 12's first polynomial (not hiding), committed: its commitment."""
    from poly_commit_tpu_torch.pcs import pst13
    from poly_commit_tpu_torch.pcs.data_structures import LabeledPolynomial

    comms, _ = pst13.MarlinPST13.commit(ck, [LabeledPolynomial("p0", poly, num_vars=poly.num_vars)])
    return comms[0].commitment


def mesh_codes(keys, device):
    """The linear codes of the mesh phase: name -> (scheme, committer key,
    the log2 of phases 6 and 10's polynomial lengths)."""
    from poly_commit_tpu_torch.pcs import linear_codes as LC

    ml, uni = LC.MultilinearLigeroBN254, LC.UnivariateLigero
    return {"brakedown": (LC.MultilinearBrakedown, keys["brakedown"], BRAKEDOWN_NUM_VARS),
            "ligero_ml": (ml, ml.code.setup(0, LIGERO_NUM_VARS, None, device), LIGERO_NUM_VARS),
            "ligero_uni": (uni, uni.code.setup(0, None, None, device), LOG_DEGREE)}


def code_inputs(spec, rows, cols, device):
    """A (rows, cols) coefficient matrix and a row vector, seeded."""
    return (seeded_field(spec, rows * cols, 3, device).reshape(rows, cols, -1),
            seeded_field(spec, rows, 4, device))


def ipa_open(ck, device):
    """An IPA-PC commit and open at the key's degree (no hiding): the
    proof's fields."""
    from poly_commit_tpu_torch.core.transcript import PoseidonSponge
    from poly_commit_tpu_torch.pcs import ipa_pc
    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial

    PC = ipa_pc.InnerProductArgPC
    rng = HostRng(24)
    lp = LabeledPolynomial("p", seeded_field(PC.spec, ck.supported_degree + 1, 5, device))
    comms, states = PC.commit(ck, [lp], rng)
    query_set = {("p", ("z", rng.field_int(PC.spec)))}
    proofs, _ = PC.batch_open(ck, [lp], comms, query_set, PoseidonSponge(PC.spec), states, rng)
    return [(p.l_vec, p.r_vec, p.final_comm_key, p.c, p.hiding_comm, p.rand) for p in proofs]


def mesh_rank(tmp):
    """One of the mesh phase's gloo ranks, on cuda:0 (shared with the other
    ranks): loads the keys (utils/persist) and inputs from ``tmp``, runs
    each check under the mesh and holds it against the single-device
    result; returns the equalities, each check's ms, its calls of the mesh
    layer (``sharded``: the branch's entry point ran), the ms of its digests
    and collectives, and the launches."""
    import torch

    from poly_commit_tpu_torch.core import field_params as FP
    from poly_commit_tpu_torch.parallel import mesh as PM
    from poly_commit_tpu_torch.pcs import hyrax
    from poly_commit_tpu_torch.pcs.data_structures import HostRng, LabeledPolynomial
    from poly_commit_tpu_torch.pcs.linear_codes import engine
    from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10
    from poly_commit_tpu_torch.utils import persist

    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    mesh = PM.make_mesh(device=dev)
    d, i = mesh.size(), mesh.index()
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    want, hyrax_nv = inp["want"], inp["hyrax_nv"]
    keys = {k: persist.load(os.path.join(tmp, f"{k}.npz"), device=dev)
            for k in ("marlin", "hyrax", "brakedown", "pst13", "ipa")}
    lp = LabeledPolynomial("p", inp["marlin_coeffs"].to(dev), hiding_bound=1)
    ntt_spec = FP.FR_BN254
    a = seeded_field(ntt_spec, inp["ntt_n"], 1, dev)
    codes = {}
    for name, (PCL, ck, _) in mesh_codes(keys, dev).items():
        rows, cols = want[f"{name}_shape"]
        codes[name] = (PCL, ck) + code_inputs(PCL.spec, rows, cols, dev)
    htable = seeded_field(hyrax.HyraxPC.spec, 1 << hyrax_nv, 2, dev)
    smoke = Smoke()  # its launch counters
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    checks = {}

    def check(name, fn, expect, *routes):
        """fn() under spans of the mesh layer; sharded when every one of
        ``routes`` (mesh-layer functions) ran."""
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with spans([(PM, attr) for attr in MESH_SPANS]) as parts:
            got = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        calls = {k: c for k, (_, c) in parts.items()}
        checks[name] = {"equal": got == expect, "ms": ms, "calls": calls,
                        "sharded": all(calls.get(r, 0) > 0 for r in routes),
                        # the digests' sums; the guard (sums and their gather); every
                        # collective, the guard's gathers included
                        "digest_ms": parts.get("_digest", (0.0, 0))[0],
                        "guard_ms": parts.get("_check_replicated", (0.0, 0))[0],
                        "collective_ms": sum(parts.get(k, (0.0, 0))[0]
                                             for k in ("_all_gather", "_all_to_all"))}

    smoke.reset_counts()
    with PM.use_mesh(mesh):
        check("marlin_commit_open", lambda: marlin_commit_open(
            MarlinKZG10, keys["marlin"], lp, copy.deepcopy(inp["marlin_rng"])), want["marlin"],
            "msm_sharded")
        mine = PM.shard_batch(a, mesh)
        check("ntt", lambda: sha(PM.ntt_sharded(ntt_spec, mine, mesh)), want["ntt"][i],
              "_transpose_sharded")
        # again, with the twiddle and cross-twiddle tables built: the staging's share
        check("ntt_again", lambda: sha(PM.ntt_sharded(ntt_spec, mine, mesh)), want["ntt"][i],
              "_transpose_sharded")
        check("intt", lambda: bool(torch.equal(PM.ntt_sharded(
            ntt_spec, PM.ntt_sharded(ntt_spec, mine, mesh), mesh, inverse=True), mine)), True,
            "_transpose_sharded")
        check("hyrax_commit", lambda: hyrax.HyraxPC.commit(keys["hyrax"], [LabeledPolynomial(
            "p", htable, hiding_bound=1, num_vars=hyrax_nv)], HostRng(21))[0][0].commitment,
            want["hyrax_commit"], "batch_msm_sharded")
        for name, (PCL, ck, mat, vec) in codes.items():
            check(f"{name}_encode", lambda: sha(PCL.code.encode_rows(mat, ck)),
                  want[f"{name}_encode"], "map_rows" if name == "brakedown" else "batch_ntt_sharded")
            check(f"{name}_row_mul", lambda: sha(engine._row_mul(PCL.spec, vec, mat)),
                  want[f"{name}_row_mul"], "row_mul_sharded")
        check("ipa_open", lambda: ipa_open(keys["ipa"], dev), want["ipa_open"],
              "msm_sharded", "fold_key_sharded")
        check("pst13_commit", lambda: pst13_commit(keys["pst13"], want["pst13_poly"]),
              want["pst13_commit"], "msm_sharded")
    mesh_2d = PM.make_mesh_2d(2, d // 2, device=dev)
    with PM.use_mesh(mesh_2d, "dp"):
        check("marlin_commit_dp", lambda: MarlinKZG10.commit(
            keys["marlin"], [lp], copy.deepcopy(inp["marlin_rng"]))[0], want["marlin_commit"],
            "msm_sharded")
    with PM.use_mesh(mesh_2d, "tp"):
        check("ntt_tp", lambda: sha(PM.ntt_sharded(ntt_spec, PM.shard_batch(a, mesh_2d, "tp"), mesh_2d,
                                                   axis="tp")), want["ntt_tp"][mesh_2d.index("tp")],
              "_transpose_sharded")
    launches, by_field, _ = smoke.read_counts(in_sums=False)
    return {"rank": i, "backend": mesh.backend, "world": d, "device": str(mesh.device),
            "staged": mesh.staged, "coords_2d": mesh_2d.coords, "checks": checks,
            "setup_s": setup_s, "launches": {k: c for k, c in launches.items() if c},
            "by_field": by_field}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    try:
        import poly_commit_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 3
    smoke = Smoke()
    try:
        name_power = smoke.environment()
        results = {"ff": smoke.check_ff(), "ff_pow": smoke.check_ff_pow(),
                   "ff_batch_inv": smoke.check_batch_inv(), "ff_sum": smoke.check_fsum(),
                   "ec": smoke.check_ec(), "g2": smoke.check_g2(),
                   "ed": smoke.check_ed(), "sort": smoke.check_sort(),
                   "ntt_kernels": smoke.check_ntt_kernels(), "msm": smoke.check_msm(),
                   "msm_g2_jubjub": smoke.check_side_msms(),
                   "main_path": smoke.main_path(), "main_path_bounded": smoke.main_path_bounded(),
                   "ntt": smoke.ntt_path(),
                   "ligero_ml": smoke.ligero_path("ml"), "ligero_uni": smoke.ligero_path("uni"),
                   "multilinear_pc": smoke.multilinear_path(), "ipa": smoke.ipa_path(),
                   "sonic": smoke.sonic_path(), "ark_golden": smoke.ark_golden(),
                   "brakedown": smoke.brakedown_path(), "hyrax": smoke.hyrax_path(),
                   "pst13": smoke.pst13_path(), "streaming_kzg": smoke.streaming_path(),
                   "r1cs": smoke.r1cs_path(), "device_pairing": smoke.device_pairing_path(),
                   "trace_persist": smoke.trace_persist(), "mesh": smoke.mesh_path(),
                   "demo": smoke.demo_path()}
        results["kernel_table"] = smoke.finish_table()
        emit({"phase": "k1_launches", "over": "phases 4-8", "by_columns": smoke.size_totals})
        k4c = smoke.k4c_launches
        results["k4c_passes"] = 0 < k4c <= smoke.MAX_K4C_LAUNCHES
        emit({"phase": "k4c_launches", "over": "phases 4-8", "launches": k4c,
              "at_most": smoke.MAX_K4C_LAUNCHES})
    except Exception:  # a failing phase: report it and exit non-zero
        traceback.print_exc()
        return 1
    failed = [k for k, v in results.items() if not v]
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"kernels": list(smoke.kernels.values())})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
