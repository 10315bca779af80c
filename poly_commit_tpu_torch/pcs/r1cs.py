"""A working R1CS constraint system, its gadget library, and an in-circuit
IPA-PC succinct verifier.

Counterpart of poly_commit_tpu/pcs/r1cs.py. The reference's gadget layer
(src/constraints.rs) is interface-only: trait `PCCheckVar`
(constraints.rs:119-190) and allocated containers, with no in-crate scheme
implementation (pcs/constraints.py holds that interface). This module
provides the substrate that interface assumes (ark-relations,
ark-r1cs-std), plus one concrete scheme gadget:

  * ConstraintSystem: R1CS rows <A,w>*<B,w> = <C,w> over any prime field;
    witnesses are host ints; satisfaction checked row by row on the host
    (``is_satisfied``) or as three sparse mat-vecs on the device
    (``is_satisfied_device``, see ``SparseCheck``).
  * FpVar / BooleanVar: native field variables (ark-r1cs-std FpVar).
  * NonNativeVar: emulated arithmetic for a foreign modulus r inside the
    native field (ark-r1cs-std nonnative): 3x88-bit limbs, multiplication
    enforced as the integer identity a*b = q*r + rem through a positive
    carry chain (PAD offset + range-checked carries), all values lazily
    non-canonical mod r (sound: every use is either a congruence or a
    scalar multiple where +k*r acts trivially on the prime-order subgroup).
  * TEPointVar: in-circuit twisted-Edwards (a = -1) group ops over JubJub,
    whose base field IS Fr(BLS12-381), the native-field recursion pairing
    the reference's IPA bench instantiates (benches/ipa_times.rs uses
    ark-ed-on-bls12-381 for exactly this reason). Complete addition, no
    branches.
  * IpaSuccinctCheckGadget: a `batch_check_evaluations`-shaped circuit
    (constraints.rs:154-162) verifying InnerProductArgPC openings, with
    the opening and round challenges supplied as allocated variables,
    exactly the `PCCheckRandomDataVar` design (constraints.rs:104-115:
    challenges and their decompositions are INPUTS to the gadget, not
    recomputed).

The host layer is the JAX module's, over this package's field_params; where
the JAX module asserts on its input, this one raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

import numpy as np
import torch

from .. import device as D
from ..core import ff
from ..core import field_params as FP
from ..core.field_params import FieldSpec

# JubJub Edwards parameters (a = -1, d) over Fr(BLS12-381)
_JJ_SPEC = FP.FR_BLS12_381
_JJ_D = FP.JUBJUB_D

LIMB_BITS = 88
N_LIMBS = 3  # 264 bits >= any 253-bit scalar field


class ConstraintSystem:
    """R1CS over a prime field: rows of sparse (A_i, B_i, C_i) with
    <A_i, w> * <B_i, w> = <C_i, w>; w[0] = 1."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus
        self.assignment: List[int] = [1]  # w[0] = ONE
        self.rows: List[tuple] = []  # (a: dict, b: dict, c: dict)
        self.num_instance = 0

    # -- allocation ------------------------------------------------------
    def alloc(self, value: int) -> int:
        self.assignment.append(int(value) % self.p)
        return len(self.assignment) - 1

    def alloc_input(self, value: int) -> int:
        if len(self.assignment) != 1 + self.num_instance:
            raise ValueError("allocate all public inputs before witnesses")
        self.assignment.append(int(value) % self.p)
        self.num_instance += 1
        return len(self.assignment) - 1

    # -- constraints -------------------------------------------------------
    def enforce(self, a: dict, b: dict, c: dict):
        self.rows.append((dict(a), dict(b), dict(c)))

    def lc_value(self, lc: dict) -> int:
        return sum(coeff * self.assignment[i] for i, coeff in lc.items()) % self.p

    def is_satisfied(self) -> bool:
        return self.first_unsatisfied() is None

    def first_unsatisfied(self) -> Optional[int]:
        for i, (a, b, c) in enumerate(self.rows):
            if self.lc_value(a) * self.lc_value(b) % self.p != self.lc_value(c):
                return i
        return None

    def sparse_check(self) -> "SparseCheck":
        """The host half of ``is_satisfied_device``: the three matrices as
        flat nonzeros, their rows bucketed for the device's row sums."""
        return SparseCheck.build(self)

    def is_satisfied_device(self, device=None) -> bool:
        """Satisfaction as three sparse matrix-vector products, one
        Montgomery product and one compare on ``device`` (cuda unless the
        caller asks otherwise): the gathers are ``index_select``, the
        products and sums kernel K1 on a CUDA tensor. Equals
        ``is_satisfied()``."""
        if not self.rows:
            return True
        return self.sparse_check().run(self.assignment, device)


@dataclasses.dataclass
class SparseCheck:
    """A constraint system's A, B and C as flat nonzeros, set up for the
    device's satisfaction check.

    The three matrices are stacked as 3R virtual rows (A's R rows, then
    B's, then C's), each row a run of (column, coefficient) nonzeros in
    ``cols`` / ``coeff_index``. The coefficients are indices into
    ``values``, the distinct coefficient ints (0 first), which become limbs
    in one bulk call. Rows are bucketed by their nonzero count rounded up
    to a power of two (a row with none counts one); within a bucket of
    width W every row is padded to W entries that point at w[0] with
    coefficient 0, as the JAX module pads, so a bucket's row sums are
    log2 W levels of one K1 add each: none for rows with one nonzero, one
    for two, nine for the 265-wide range checks. No row is padded beyond
    its bucket. The products of all entries take one K1 launch for each
    CHUNK of them. ``buckets`` holds (W, virtual row ids) in the order of
    the entries.
    """

    spec: FieldSpec
    n_rows: int
    nnz: tuple  # nonzeros of A, B, C
    values: list  # distinct coefficient ints, values[0] == 0
    cols: np.ndarray  # (entries,) int64 columns, bucket after bucket
    coeff_index: np.ndarray  # (entries,) int64 indices into values
    buckets: list  # [(width, np.ndarray of virtual row ids)]

    @staticmethod
    def _flat(rows, sel: int, p: int, index: dict):
        """Matrix ``sel`` as CSR: nonzeros a row, their columns and their
        coefficients' indices in ``index`` (extended as new values come)."""
        counts = np.fromiter((len(r[sel]) for r in rows), np.int64, len(rows))
        total = int(counts.sum())
        cols = np.fromiter(itertools.chain.from_iterable(r[sel] for r in rows), np.int64, total)
        coeffs = itertools.chain.from_iterable(r[sel].values() for r in rows)
        cidx = np.fromiter((index.setdefault(int(v) % p, len(index)) for v in coeffs), np.int64,
                           total)
        return counts, cols, cidx

    @classmethod
    def build(cls, cs: ConstraintSystem) -> "SparseCheck":
        index = {0: 0}
        flats = [cls._flat(cs.rows, sel, cs.p, index) for sel in range(3)]
        counts = np.concatenate([f[0] for f in flats])
        pad = sum(len(f[1]) for f in flats)  # one past the last nonzero: the padding entry
        cols = np.concatenate([f[1] for f in flats] + [np.zeros(1, np.int64)])
        cidx = np.concatenate([f[2] for f in flats] + [np.zeros(1, np.int64)])
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        width = np.ones_like(counts)
        while True:
            short = width < counts
            if not short.any():
                break
            width[short] *= 2
        out_cols, out_cidx, buckets = [], [], []
        for w in np.unique(width).tolist():
            vrows = np.nonzero(width == w)[0]
            j = np.arange(w)
            src = starts[vrows, None] + j
            src = np.where(j < counts[vrows, None], src, pad).reshape(-1)
            out_cols.append(cols[src])
            out_cidx.append(cidx[src])
            buckets.append((w, vrows))
        return cls(spec=cs.spec, n_rows=len(cs.rows), nnz=tuple(len(f[1]) for f in flats),
                   values=list(index), cols=np.concatenate(out_cols),
                   coeff_index=np.concatenate(out_cidx), buckets=buckets)

    @property
    def widths(self) -> dict:
        """Bucket width -> its virtual rows (A's, B's and C's together)."""
        return {w: len(v) for w, v in self.buckets}

    CHUNK = 1 << 19  # entries a K1 product: bounds the plain version's int64 temporaries

    def run(self, assignment, device=None) -> bool:
        """<A_i, w> <B_i, w> == <C_i, w> for every row, on ``device``: K1
        products over the padded entries (CHUNK a launch), each bucket's
        adds, one K1 product of the A and B sums, one compare."""
        spec, dev, L, R = self.spec, D.resolve(device), self.spec.n_limbs, self.n_rows
        if self.cols.min() < 0 or self.cols.max() >= len(assignment):
            raise ValueError("a constraint names a variable outside the assignment")
        w = ff.from_ints(spec, assignment, device=dev)  # (L, V)
        coeffs = ff.from_ints(spec, self.values, device=dev)  # (L, U)
        cols = torch.from_numpy(self.cols).to(dev)
        cidx = torch.from_numpy(self.coeff_index).to(dev)
        prod = torch.cat([ff.mont_mul(spec, w.index_select(1, cols[i:i + self.CHUNK]),
                                      coeffs.index_select(1, cidx[i:i + self.CHUNK]))
                          for i in range(0, len(cols), self.CHUNK)], 1)
        sums = torch.empty((L, 3 * R), dtype=torch.int32, device=dev)
        off = 0
        for width, vrows in self.buckets:
            m = len(vrows)
            x = prod[:, off:off + m * width].reshape(L, m, width)
            off += m * width
            while width > 1:
                width //= 2
                x = ff.add(spec, x[:, :, :width].reshape(L, -1).contiguous(),
                           x[:, :, width:].reshape(L, -1).contiguous())
                x = x.reshape(L, m, width)
            sums.index_copy_(1, torch.from_numpy(vrows).to(dev), x.reshape(L, m))
        a, b, c = (sums[:, k * R:(k + 1) * R].contiguous() for k in range(3))
        lhs = ff.canonicalize(spec, ff.mont_mul(spec, a, b))
        return bool((lhs == ff.canonicalize(spec, c)).all())


@dataclasses.dataclass
class FpVar:
    """Allocated native-field element: a linear combination over witness
    vars with a tracked concrete value (ark-r1cs-std FpVar analogue)."""

    cs: ConstraintSystem
    lc: dict
    value: int

    @classmethod
    def constant(cls, cs: ConstraintSystem, v: int) -> "FpVar":
        return cls(cs, {0: int(v) % cs.p}, int(v) % cs.p)

    @classmethod
    def witness(cls, cs: ConstraintSystem, v: int) -> "FpVar":
        idx = cs.alloc(v)
        return cls(cs, {idx: 1}, int(v) % cs.p)

    @classmethod
    def input(cls, cs: ConstraintSystem, v: int) -> "FpVar":
        idx = cs.alloc_input(v)
        return cls(cs, {idx: 1}, int(v) % cs.p)

    # -- linear ops (free) -------------------------------------------------
    def _lin(self, other: "FpVar", sign: int) -> "FpVar":
        lc = dict(self.lc)
        for i, c in other.lc.items():
            lc[i] = (lc.get(i, 0) + sign * c) % self.cs.p
        return FpVar(self.cs, lc, (self.value + sign * other.value) % self.cs.p)

    def add(self, other: "FpVar") -> "FpVar":
        return self._lin(other, 1)

    def sub(self, other: "FpVar") -> "FpVar":
        return self._lin(other, -1)

    def scale(self, k: int) -> "FpVar":
        k = int(k) % self.cs.p
        return FpVar(
            self.cs,
            {i: c * k % self.cs.p for i, c in self.lc.items()},
            self.value * k % self.cs.p,
        )

    def add_const(self, k: int) -> "FpVar":
        return self.add(FpVar.constant(self.cs, k))

    # -- multiplicative ops (one constraint each) ---------------------------
    def mul(self, other: "FpVar") -> "FpVar":
        out = FpVar.witness(self.cs, self.value * other.value % self.cs.p)
        self.cs.enforce(self.lc, other.lc, out.lc)
        return out

    def square(self) -> "FpVar":
        return self.mul(self)

    def enforce_equal(self, other: "FpVar"):
        diff = self._lin(other, -1)
        self.cs.enforce(diff.lc, {0: 1}, {})


@dataclasses.dataclass
class BooleanVar:
    var: FpVar

    @classmethod
    def witness(cls, cs: ConstraintSystem, bit: int) -> "BooleanVar":
        v = FpVar.witness(cs, bit & 1)
        one_minus = FpVar.constant(cs, 1)._lin(v, -1)
        cs.enforce(v.lc, one_minus.lc, {})  # b (1 - b) = 0
        return cls(v)

    def select(self, t: FpVar, f: FpVar) -> FpVar:
        """b ? t : f = f + b*(t - f): one constraint."""
        return f.add(self.var.mul(t._lin(f, -1)))


def range_check(cs: ConstraintSystem, var: FpVar, n_bits: int) -> List[BooleanVar]:
    """Decompose var into n LE bits; enforce recomposition == var."""
    v = var.value
    if not 0 <= v < (1 << n_bits):
        raise ValueError(f"value of {v.bit_length()} bits does not fit {n_bits} bits")
    bits = [BooleanVar.witness(cs, (v >> i) & 1) for i in range(n_bits)]
    acc = FpVar.constant(cs, 0)
    for i, b in enumerate(bits):
        acc = acc.add(b.var.scale(1 << i))
    acc.enforce_equal(var)
    return bits


# ---------------------------------------------------------------------------
# non-native (emulated) field arithmetic mod r inside the native field
# ---------------------------------------------------------------------------


class NonNativeVar:
    """Residue mod a foreign modulus ``r``, as N_LIMBS x LIMB_BITS limbs of
    native-field vars, each range-checked. Values are LAZY residues: any
    representative < 2^264 is allowed (x and x+r are interchangeable — every
    consumer is a congruence or a prime-order-subgroup scalar). The
    ark-r1cs-std NonNativeFieldVar analogue.
    """

    def __init__(self, cs: ConstraintSystem, r: int, limbs: List[FpVar],
                 bits: List[List[BooleanVar]], value: int):
        self.cs = cs
        self.r = r
        self.limbs = limbs  # LE
        self.bits = bits  # per-limb LE bits (the range checks)
        self.value = value  # integer representative (< 2^264)

    # -- constructors -----------------------------------------------------
    @classmethod
    def witness(cls, cs: ConstraintSystem, r: int, value: int) -> "NonNativeVar":
        value = int(value) % r
        limbs, bits = [], []
        for i in range(N_LIMBS):
            lv = (value >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
            var = FpVar.witness(cs, lv)
            bits.append(range_check(cs, var, LIMB_BITS))
            limbs.append(var)
        return cls(cs, r, limbs, bits, value)

    @classmethod
    def constant(cls, cs: ConstraintSystem, r: int, value: int) -> "NonNativeVar":
        value = int(value) % r
        limbs = [
            FpVar.constant(cs, (value >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1))
            for i in range(N_LIMBS)
        ]
        return cls(cs, r, limbs, [], value)

    def scalar_bits(self) -> List[BooleanVar]:
        """All 264 LE bits (for in-circuit scalar multiplication: the
        representative may exceed r by a multiple, which acts trivially on
        a prime-order subgroup point)."""
        if not self.bits:
            raise ValueError("constant/unreduced var has no bit decomposition")
        return [b for limb in self.bits for b in limb]

    # -- the core congruence enforcer ---------------------------------------
    def _enforce_identity(self, t_terms, rhs_terms, const_lhs: int,
                          t_max_bits: int):
        """Enforce   sum_k t_k 2^(88k) + const_lhs == q*r + sum_k rhs_k 2^(88k)
        as INTEGERS, with q >= 0 witnessed and range-checked.

        t_k / rhs_k are native FpVars whose TRUE integer values are
        non-negative and < 2^t_max_bits / < 2^88 (so .value == integer: no
        native-field wraparound). Soundness: every variable entering the
        carry chain is range-checked, all bounds stay ~2^190 << p, so the
        per-limb congruences mod p imply integer equality.
        """
        cs, r = self.cs, self.r
        K = len(t_terms)
        lhs_int = const_lhs + sum(
            t.value << (LIMB_BITS * k) for k, t in enumerate(t_terms)
        )
        rhs_int = sum(v.value << (LIMB_BITS * k) for k, v in enumerate(rhs_terms))
        if (lhs_int - rhs_int) % r:
            raise ValueError("witness violates the congruence")
        q_int = (lhs_int - rhs_int) // r
        if q_int < 0:
            raise ValueError("negative quotient: raise const_lhs")
        # q limbs (sized by the worst case from the bounds, not the witness)
        lhs_max = const_lhs + sum(
            1 << (t_max_bits + LIMB_BITS * k) for k in range(K)
        )
        n_q_limbs = max(1, -(-(lhs_max // r).bit_length() // LIMB_BITS))
        q_limbs = []
        for i in range(n_q_limbs):
            lv = (q_int >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
            var = FpVar.witness(cs, lv)
            range_check(cs, var, LIMB_BITS)
            q_limbs.append(var)
        # rhs digit linears: s_k = sum_{i+j=k} q_i * m_j (m = digits of r,
        # constant -> linear in q) + rhs_terms
        m = [
            (r >> (LIMB_BITS * j)) & ((1 << LIMB_BITS) - 1)
            for j in range(N_LIMBS)
        ]
        K_out = max(K, n_q_limbs + N_LIMBS, len(rhs_terms)) + 1
        if const_lhs >= 1 << (LIMB_BITS * K_out):
            raise ValueError("const_lhs exceeds the carry chain's width")
        s = [FpVar.constant(cs, 0) for _ in range(K_out)]
        for i, ql in enumerate(q_limbs):
            for j, mj in enumerate(m):
                if mj:
                    s[i + j] = s[i + j].add(ql.scale(mj))
        for k, v in enumerate(rhs_terms):
            s[k] = s[k].add(v)
        # positive carry chain:
        #   e_k = t_k + C_k + PAD - s_k + carry_{k-1}
        #   sum_k e_k 2^(88k) telescopes to PAD * S  (S = sum_k 2^(88k))
        s_max_bits = 2 * LIMB_BITS + 4  # <= N_LIMBS products + rhs + slack
        PAD_BITS = max(t_max_bits, s_max_bits) + 2
        PAD = 1 << PAD_BITS
        target = sum(PAD << (LIMB_BITS * k) for k in range(K_out))
        carry = FpVar.constant(cs, 0)
        for k in range(K_out):
            c_k = (const_lhs >> (LIMB_BITS * k)) & ((1 << LIMB_BITS) - 1)
            t_k = t_terms[k] if k < K else FpVar.constant(cs, 0)
            e_k = t_k.add_const(PAD + c_k).sub(s[k]).add(carry)
            tgt_k = (target >> (LIMB_BITS * k)) & ((1 << LIMB_BITS) - 1)
            new_carry_val = (e_k.value - tgt_k) >> LIMB_BITS
            if (e_k.value - tgt_k) != new_carry_val << LIMB_BITS:
                raise RuntimeError("carry chain misaligned (internal witness bug)")
            new_carry = FpVar.witness(cs, new_carry_val)
            range_check(cs, new_carry, PAD_BITS - LIMB_BITS + 2)
            # e_k - tgt_k - 2^88 * new_carry == 0
            e_k.add_const(-tgt_k).sub(
                new_carry.scale(1 << LIMB_BITS)
            ).enforce_equal(FpVar.constant(cs, 0))
            carry = new_carry
        carry.enforce_equal(FpVar.constant(cs, target >> (LIMB_BITS * K_out)))

    # -- arithmetic ---------------------------------------------------------
    def mul(self, other: "NonNativeVar") -> "NonNativeVar":
        """rem = a * b mod r, via  a*b + r = q*r + rem  over the integers."""
        cs, r = self.cs, self.r
        out = NonNativeVar.witness(cs, r, self.value * other.value % r)
        K = 2 * N_LIMBS - 1
        t = [FpVar.constant(cs, 0) for _ in range(K)]
        for i, ai in enumerate(self.limbs):
            for j, bj in enumerate(other.limbs):
                t[i + j] = t[i + j].add(ai.mul(bj))
        t_max_bits = 2 * LIMB_BITS + 2  # <= 3 88x88 products per digit
        self._enforce_identity(t, out.limbs, r, t_max_bits)
        return out

    def add(self, other: "NonNativeVar") -> "NonNativeVar":
        """rem = a + b mod r via the same identity machinery."""
        cs, r = self.cs, self.r
        out = NonNativeVar.witness(cs, r, (self.value + other.value) % r)
        t = [self.limbs[k].add(other.limbs[k]) for k in range(N_LIMBS)]
        self._enforce_identity(t, out.limbs, r, LIMB_BITS + 2)
        return out

    def enforce_congruent(self, other: "NonNativeVar"):
        """a == b (mod r):  a + r*2^14 == q*r + b."""
        self._enforce_identity(
            list(self.limbs), list(other.limbs), self.r << 14, LIMB_BITS + 1
        )

    def inverse(self) -> "NonNativeVar":
        """witness a^-1 mod r; enforce a * ainv == 1 (mod r)."""
        cs, r = self.cs, self.r
        inv = NonNativeVar.witness(cs, r, pow(self.value % r, -1, r))
        prod = self.mul(inv)
        prod.enforce_congruent(NonNativeVar.constant_one(cs, r))
        return inv

    @classmethod
    def constant_one(cls, cs: ConstraintSystem, r: int) -> "NonNativeVar":
        one = cls.witness(cs, r, 1)
        # bind the witness to the constant 1
        one.limbs[0].enforce_equal(FpVar.constant(cs, 1))
        for limb in one.limbs[1:]:
            limb.enforce_equal(FpVar.constant(cs, 0))
        return one


# ---------------------------------------------------------------------------
# in-circuit twisted Edwards (JubJub over Fr-381)
# ---------------------------------------------------------------------------


class TEPointVar:
    """In-circuit twisted Edwards point, a = -1 (JubJub over Fr-381).

    Complete addition (no branches, identity-safe):
      x3 = (x1 y2 + y1 x2) / (1 + d x1 x2 y1 y2)
      y3 = (y1 y2 + x1 x2) / (1 - d x1 x2 y1 y2)
    """

    def __init__(self, x: FpVar, y: FpVar):
        self.x = x
        self.y = y

    @classmethod
    def witness(cls, cs: ConstraintSystem, pt) -> "TEPointVar":
        if pt is None:
            pt = (0, 1)
        return cls(FpVar.witness(cs, pt[0]), FpVar.witness(cs, pt[1]))

    @classmethod
    def identity(cls, cs: ConstraintSystem) -> "TEPointVar":
        return cls(FpVar.constant(cs, 0), FpVar.constant(cs, 1))

    def enforce_on_curve(self):
        """-x^2 + y^2 = 1 + d x^2 y^2."""
        cs = self.x.cs
        x2 = self.x.square()
        y2 = self.y.square()
        x2y2 = x2.mul(y2)
        y2.sub(x2).enforce_equal(
            FpVar.constant(cs, 1).add(x2y2.scale(_JJ_D))
        )

    def add(self, other: "TEPointVar") -> "TEPointVar":
        cs = self.x.cs
        p = cs.p
        x1, y1, x2, y2 = self.x, self.y, other.x, other.y
        t1 = x1.mul(y2)
        t2 = y1.mul(x2)
        t3 = y1.mul(y2)
        t4 = x1.mul(x2)
        t5 = t1.mul(t2)  # x1 x2 y1 y2
        dt = t5.scale(_JJ_D)
        num_x = t1.add(t2)
        num_y = t3.add(t4)
        den_x = dt.add_const(1)
        den_y = dt.scale(p - 1).add_const(1)
        x3 = FpVar.witness(cs, num_x.value * pow(den_x.value, -1, p) % p)
        y3 = FpVar.witness(cs, num_y.value * pow(den_y.value, -1, p) % p)
        cs.enforce(x3.lc, den_x.lc, num_x.lc)
        cs.enforce(y3.lc, den_y.lc, num_y.lc)
        return TEPointVar(x3, y3)

    def double(self) -> "TEPointVar":
        return self.add(self)

    def select(self, b: BooleanVar, other: "TEPointVar") -> "TEPointVar":
        """b ? self : other."""
        return TEPointVar(b.select(self.x, other.x), b.select(self.y, other.y))

    def scalar_mul_bits(self, bits: List[BooleanVar]) -> "TEPointVar":
        cs = self.x.cs
        acc = TEPointVar.identity(cs)
        base = self
        for i, b in enumerate(bits):
            acc = acc.add(base).select(b, acc)
            if i + 1 < len(bits):
                base = base.double()
        return acc

    def enforce_equal(self, other: "TEPointVar"):
        self.x.enforce_equal(other.x)
        self.y.enforce_equal(other.y)


# ---------------------------------------------------------------------------
# the scheme gadget: in-circuit IPA-PC succinct check
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PCCheckRandomDataVar:
    """constraints.rs:104-115 — the opening/round challenges, allocated
    (the gadget consumes them; it never recomputes transcript hashes)."""

    opening_challenges: List[NonNativeVar]
    batching_rands: List[NonNativeVar]  # the per-round u_j


@dataclasses.dataclass
class IpaProofVar:
    """Allocated InnerProductArgPC proof (ipa_pc/data_structures.rs:175-195,
    non-hiding form)."""

    l_vec: List[TEPointVar]
    r_vec: List[TEPointVar]
    final_comm_key: TEPointVar
    c: NonNativeVar


class IpaSuccinctCheckGadget:
    """`batch_check_evaluations`-shaped circuit (constraints.rs:154-162) for
    InnerProductArgPC over JubJub: enforces the folded-commitment equation
    of ipa_pc/mod.rs:91-203. All scalar-field algebra runs through
    NonNativeVar (sound congruences); all group algebra is native-field.
    The final-key MSM (the non-succinct half) stays outside the circuit,
    exactly as recursive SNARKs defer it (BCMS20 accumulation).
    """

    @staticmethod
    def succinct_check(
        cs: ConstraintSystem,
        r_scalar: int,
        comm_vars: List[TEPointVar],
        value_vars: List[NonNativeVar],
        point_var: NonNativeVar,
        h_var: TEPointVar,
        first_round_challenge: NonNativeVar,
        proof: IpaProofVar,
        rand_data: PCCheckRandomDataVar,
        supported_degree: int,
    ):
        """Enforces:
          C* = sum_i xi_i . C_i ;  v* = sum_i xi_i . v_i
          R  = C* + v* . h' + sum_j (u_j^-1 L_j + u_j R_j),  h' = u_0 . h
          R == c . final_key + (c . h(z)) . h'
        with h(z) = prod_j (1 + u_j z^(2^(k-1-j)))
        (ipa_pc/data_structures.rs:200-237)."""
        # combined commitment and value
        combined_c = TEPointVar.identity(cs)
        combined_v = None
        for cm, v, ch in zip(comm_vars, value_vars, rand_data.opening_challenges):
            combined_c = combined_c.add(cm.scalar_mul_bits(ch.scalar_bits()))
            term = v.mul(ch)
            combined_v = term if combined_v is None else combined_v.add(term)
        h_prime = h_var.scalar_mul_bits(first_round_challenge.scalar_bits())
        round_comm = combined_c.add(h_prime.scalar_mul_bits(combined_v.scalar_bits()))

        log_d = (supported_degree + 1).bit_length() - 1
        if not len(proof.l_vec) == len(proof.r_vec) == len(rand_data.batching_rands) == log_d:
            raise ValueError(f"expected {log_d} L, R and round challenges")
        for l_pt, r_pt, u in zip(proof.l_vec, proof.r_vec, rand_data.batching_rands):
            u_inv = u.inverse()
            round_comm = round_comm.add(l_pt.scalar_mul_bits(u_inv.scalar_bits()))
            round_comm = round_comm.add(r_pt.scalar_mul_bits(u.scalar_bits()))

        # h(z) = prod_j (1 + u_j z^(2^(k-1-j)))
        z_pows = []
        zp = point_var
        for _ in range(log_d):
            z_pows.append(zp)
            zp = zp.mul(zp)
        one = NonNativeVar.constant_one(cs, r_scalar)
        hz = one
        for j, u in enumerate(rand_data.batching_rands):
            hz = hz.mul(u.mul(z_pows[log_d - 1 - j]).add(one))

        v_prime = proof.c.mul(hz)
        expected = proof.final_comm_key.scalar_mul_bits(proof.c.scalar_bits()).add(
            h_prime.scalar_mul_bits(v_prime.scalar_bits())
        )
        expected.enforce_equal(round_comm)
