#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels (poly_commit_tpu_torch) on one
NVIDIA GPU, hold each against its plain version, and time both.

    python3 chip_smoke.py

Three phases, one JSON line a check (times in ms):
  1. environment and build: the card's name, power limit, SMs and highest
     SM clock (port_bench/yardstick.py's card), the torch, CUDA, nvcc and
     triton versions, and the build of every kernel from
     poly_commit_tpu_torch/csrc (one nvcc per source, all at once); then a
     build line: each source's nvcc seconds, per kernel entry the registers
     and spill bytes ptxas reported, and the machine instructions (and
     integer multiply-adds) of the K1, K2a and K4 kernels from cuobjdump;
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
     launches it replaced; K2c the six G2 formulas on the BLS12-381 and
     BLS12-377 Fq2; K2b the four JubJub formulas, and ed_smul, the
     one-launch scalar multiplication, at 2^15 points and at 1, also
     against the chain of ed_double / ed_add launches it replaced; K3, the
     stable digit sort, index for index at the 2^20 MSM's (16, 2^20) keys,
     the c = 8 MSMs' (32, 2^15) and a chunk of Hyrax's batched MSM
     (2^14, 2^11); K4a/K4b/K4c the NTT stages on the BN254 and BLS12-381
     scalar fields, K4a's 2^9-point transform and K4c four stages in one
     launch each beside the chain of one-stage launches; blake2s_columns,
     the linear codes' column hash, digest for digest against hashlib over
     the plain route's column bytes at Ligero's 256 x 32,768 BN254 Fr
     matrix, beside that route's time), with the kernel's time, the plain
     version's and, where one PyTorch call computes the same function,
     that call's, and the kernel's bound: the larger of its least bytes
     over the HBM rate and its integer multiply-adds over the card's IMAD
     peak;
  3. a 2^12-point BLS12-381 G1 MSM, and a G2 (BLS12-381) and a JubJub MSM
     of 2^10 points, against the host big-int oracle.
Then the kernel table (an entry a kernel: its source, the TPU function it
replaces, its error, times and bound), the card's name and power limit,
and {"ok": true, "device": ...}. Any failure exits non-zero; so does a
machine without a CUDA device. The schemes are checked on the card by
tests/test_torch_gpu*.py and timed by port_bench/run.py.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

from port_bench import yardstick

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
IMAD_PER_PRODUCT = yardstick.imad_per_product(8)  # CIOS on 8 32-bit words
IMAD_PER_FQ_PRODUCT = yardstick.imad_per_product(12)  # CIOS on 12 32-bit words
# one Blake2s compression: 10 rounds x 8 G x (two three-input adds, two
# adds, four xors, four rotates)
BLAKE2S_OPS_PER_COMPRESSION = 10 * 8 * 12
SIDE_MSM_LOG_N = 10  # the G2 and JubJub MSMs of phase 3 (host oracle cost)


def emit(obj):
    print(json.dumps(obj), flush=True)


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


class Smoke:
    NTT_KERNELS = ("ntt_small", "ntt_fused_stages", "ntt_stages")
    # phase 2's K4 shape: Ligero's 256 rows of 2^15 points, and the pairs of
    # K4a's one-stage form
    NTT_KERNEL_SHAPE = (1 << 23, 15, 1 << 21)
    NTT_SMALL_LOG_N = 9  # K4a's one-launch transform
    BLAKE2S_SHAPE = (256, 1 << 15)  # Ligero's encoded matrix: rows, columns

    def __init__(self):
        import torch

        from poly_commit_tpu_torch.core import ec_lf, ff

        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(20261016)
        self.kernels = {}  # name -> JSON entry
        self.ff_ops = {"mul": ff.mont_mul, "add": ff.add, "sub": ff.sub}
        self.ff_wrappers = {**{f"ff_{w.__name__}": w for w in self.ff_ops.values()},
                            "ff_pow": ff.mont_pow, "ff_batch_inv": ff.batch_inv, "ff_sum": ff.fsum}
        self.k2a_wrappers = {f"ec_{w.__name__}": w for w in ec_lf.WRAPPERS}
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
                        "k4a": ntt_src, "k4b": ntt_src, "k4c": ntt_src,
                        "blake2s": "poly_commit_tpu_torch/csrc/blake2s.cu"}
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
                         "k4c": "poly_commit_tpu/core/ntt_lf.py:179",
                         # no TPU kernel: the JAX package hashes columns with hashlib
                         "blake2s": "none (hashlib: poly_commit_tpu/pcs/linear_codes/engine.py:71)"}

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
            "replaces": self.replaces[kind], "max_abs_err": max_abs_err,
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

        card = yardstick.card(self.torch)
        name_power = f"{card['name']}, {card['power_limit_w']:.2f} W"
        self.imad_per_s = card["imad_per_s"]
        tool = D.toolchain()
        build_s = D.build()
        emit({"phase": "environment", "gpu": name_power, "sms": card["sms"],
              "max_sm_clock_mhz": card["max_sm_clock_mhz"], "imad_per_s": self.imad_per_s,
              "torch": tool["torch"], "cuda": tool["cuda"],
              "nvcc": tool["nvcc"], "triton": tool["triton"], "build_ms": build_s * 1e3})
        ptxas = {name: D.ptxas_report(D.build_log(name)) for name in D.SOURCES}

        def nw12(entries):  # the 12-word (BLS12-381/377) kernels and the calls they make
            return [e for e in entries if "<12" in e["entry"] or "ILi12E" in e["entry"]]

        def spill_bytes(entries):
            return sum(e.get("spill_stores", 0) + e.get("spill_loads", 0) for e in entries)

        g1_12, g2_12 = nw12(ptxas["ec_g1"]), nw12(ptxas["ec_g2"])
        # machine instructions per kernel (the product's body counted in each
        # kernel that calls or inlines it)
        sass = {name: sass_counts(D.library_path(name))
                for name in ("ff", "ec_g1", "ntt", "blake2s")}
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
        # fields are MarlinPST13_BLS12_377's.
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
        path runs it, bit for bit); K4a (``small``) at a 2^9-point
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

    def check_blake2s(self):
        """blake2s_columns at Ligero's commit shape (256 rows x 32,768
        columns of BN254 Fr, lazy values below 2p) against hashlib over the
        plain route's column bytes (engine.column_bytes: a transpose, K1 out
        of Montgomery form, one pageable copy), digest for digest, in one
        launch. ``ms`` is the kernel (CUDA events), ``call_ms`` the wrapper
        with the digests' read and split, ``plain_ms`` the plain route with
        its 32,768 hashlib calls (host clock); ``max_abs_err`` counts the
        digests that differ."""
        import hashlib

        from poly_commit_tpu_torch.core import field_params as FP
        from poly_commit_tpu_torch.pcs.linear_codes import engine
        from poly_commit_tpu_torch.utils import merkle

        torch = self.torch
        spec = FP.FR_BN254
        n_rows, n_ext = self.BLAKE2S_SHAPE
        ext = self.lazy(spec, n_rows * n_ext).T.reshape(n_rows, n_ext, spec.n_limbs).contiguous()

        def host_ms(fn, reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            return out, (time.perf_counter() - t0) * 1e3 / reps

        want, plain_ms = host_ms(lambda: [hashlib.blake2s(col.tobytes()).digest()
                                          for col in engine.column_bytes(spec, ext)], 1)
        before = merkle.blake2s_columns.launches
        got = merkle.blake2s_columns(spec, ext)
        one_launch = merkle.blake2s_columns.launches - before == 1
        wrong = sum(g != w for g, w in zip(got, want)) + abs(len(got) - len(want))
        ms = time_ms(lambda: merkle._digest_words(spec, ext), 20)
        _, call_ms = host_ms(lambda: merkle.blake2s_columns(spec, ext), 5)
        # the limbs read once, the digests written once; a compression a
        # block of two rows, a product by 1 an element
        n_bytes = n_rows * n_ext * spec.n_limbs * 4 + n_ext * merkle.DIGEST_BYTES
        n_ops = (n_ext * ((n_rows + 1) // 2) * BLAKE2S_OPS_PER_COMPRESSION
                 + n_rows * n_ext * IMAD_PER_PRODUCT)
        bounds = self.entry("blake2s_columns", "blake2s", wrong, ms, plain_ms, n_bytes, n_ops)
        emit({"phase": "kernels", "kernel": "blake2s_columns", "field": spec.name, "rows": n_rows,
              "columns": n_ext, "max_abs_err": wrong, "one_launch": one_launch, "ms": ms,
              "call_ms": call_ms, "plain_ms": plain_ms, **bounds})
        return wrong == 0 and one_launch

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
                   "ntt_kernels": smoke.check_ntt_kernels(), "blake2s": smoke.check_blake2s(),
                   "msm": smoke.check_msm(),
                   "msm_g2_jubjub": smoke.check_side_msms()}
    except Exception:  # a failing phase: report it and exit non-zero
        traceback.print_exc()
        return 1
    failed = [k for k, v in results.items() if not v]
    if failed:
        print(f"chip_smoke: failed checks {failed}", file=sys.stderr)
        return 1
    emit({"kernels": list(smoke.kernels.values())})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
