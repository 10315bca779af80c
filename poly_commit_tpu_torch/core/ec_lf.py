"""Limbs-first group operations: kernels K2a (G1), K2c (G2) and K2b (JubJub).

Counterpart of poly_commit_tpu/core/ec_lf.py. G1 points (BLS12-381,
BLS12-377, BN254; a = 0) are (x, y, z) tuples of (L, N) int32 limb tensors
in Montgomery form, values < 2p; z == 0 mod p is infinity, and ``infinity``
writes it as (0, R mod p, 0). G2 points are the same over Fq2, each
coordinate a (2L, N) stack of c0's limb rows over c1's. JubJub points are
extended twisted Edwards (x, y, z, t) over Fr-381, identity (0, 1, 1, 0).

K2a replaces the G1 entries of ``_ec_fn`` (poly_commit_tpu/core/ec_lf.py:455):
``madd`` / ``madd_distinct`` (madd-2007-bl, 7M+4S; the distinct form has no
doubling branch), their ``_packed`` forms (the affine point arrives as 32-bit
limb pairs, unpacked in registers), ``add`` (add-2007-bl, 11M+5S, complete)
and ``double`` (dbl-2009-l, 2M+5S). In csrc/ec_g1.cu one thread computes one
point with all temporaries in registers, so device memory sees only the
input and output coordinates. Edge cases (infinity, P+P, P-P) branch per
thread instead of computing every branch and selecting, as the TPU must.
What bounds it on the card: a madd reads 4 and writes 3 coordinates
(~0.7 KB at L = 24) and issues ~11 x 600 IMADs, ~9 IMAD per byte, above the
card's IMAD-to-bandwidth ratio: it is bound by integer multiplies, and the
design spends nothing on memory beyond one read and one write per point.
Each product is one call of the carry-chain product (csrc/ff.cuh), so a
formula holds one copy of it. ``madd_scan`` is the MSM's within-lane scan
(poly_commit_tpu/core/msm_tpu.py:506 runs the K2a madd once a step in a
lax.scan) in one launch: a lane's sum stays in a thread's registers over
every step, its points come from a point-major table, and each step's sum
is stored once as that step's prefix. ``window_fold`` is the MSM's window
fold (msm_tpu.py's ``_combine_sw_device`` and ``_fold_device`` run K2a
once an operation) in one launch: a row's threads combine its windows
side by side (a thread a window, or two or four where the rows' blocks
would not all be resident at once), then one thread's Horner chain a row;
its plain version is the halving tree ``fold_tree`` on the plain formulas.

K2c (csrc/ec_g2.cu) replaces the ``g2_*`` entries: the same formulas
(csrc/ec_jac.cuh is shared with K2a) over Fq2 = Fq[u]/(u^2 - nr), Karatsuba
products and the non-residue nr = -k as an addition chain, as ``_fx_quad``
does, with a pair of lanes a point (one per Fq2 component, trading values
by warp shuffles) and the base product one function call. K2b
(csrc/ec_ed.cu) replaces the ``ed_*`` entries: add-2008-hwcd-3 with a = -1,
complete and branch-free, over Fr-381 (4p > R: every product takes the
post-reduce); ``ed_double`` is ``ed_add(p, p)``, as in the JAX package, so
both give the same coordinates. ``ed_smul`` is k p for one scalar shared by
every lane in one K2b launch: the MSB-first chain of ``ed_double`` and
``ed_add`` that the JAX package scans per bit
(poly_commit_tpu/core/curve.py::scalar_mul), limb for limb.

The plain versions below follow ec_lf.py's formulas on ff's plain field ops
and run only for CPU tensors; each wrapper counts its kernel launches
(``launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import device as D
from . import ff
from . import field_params as FP
from ..utils import trace
from .field_params import FieldSpec

_WHICH = {"madd": 0, "madd_distinct": 1, "madd_packed": 2,
          "madd_distinct_packed": 3, "add": 4, "double": 5}
_ED_WHICH = {"ed_madd": 0, "ed_madd_packed": 1, "ed_add": 2, "ed_double": 3}
# Fq2 = Fq[u]/(u^2 - nr) per base field (ark-ff Fp2Config NONRESIDUE)
QUAD_NR = {"fq_bls12_381": -1, "fq_bls12_377": -5, "fq_bn254": -1}


# ---------------------------------------------------------------------------
# plain versions (int64 limb tensors)
# ---------------------------------------------------------------------------


class _Fx:
    """ff's plain field ops bound to one spec, on int64 (L, N) tensors."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def mul(self, a, b):
        return ff._mont_mul_plain(self.spec, a, b)

    def sqr(self, a):
        return ff._mont_mul_plain(self.spec, a, a)

    def add(self, a, b):
        return ff._add_plain(self.spec, a, b)

    def sub(self, a, b):
        return ff._sub_plain(self.spec, a, b)

    def is_zero(self, a):
        p = ff.consts(self.spec, a.device, 0)
        return (a == 0).all(0) | (a == p).all(0)

    def one(self, like):
        return ff.consts(self.spec, like.device, 3).expand_as(like)


def times_small(add, t, k: int):
    """k t for a small static k > 0 by the addition chain of
    ec_lf.py::_fx_quad's ``small`` (csrc/ec_g2.cu's too)."""
    res, cur = None, t
    while k:
        if k & 1:
            res = cur if res is None else add(res, cur)
        k >>= 1
        if k:
            cur = add(cur, cur)
    return res


class _Fx2:
    """Fq2 row ops on int64 (2L, N) tensors, c0 over c1: ec_lf.py::_fx_quad's
    operation sequence, which csrc/ec_g2.cu follows too. Karatsuba products;
    nr = -k enters as an addition chain; carries stay within a component."""

    def __init__(self, spec: FieldSpec):
        self.b = _Fx(spec)
        self.L = spec.n_limbs
        self.k = -QUAD_NR[spec.name]

    def _small(self, t):
        return times_small(self.b.add, t, self.k)

    def mul(self, a, c):
        b, L = self.b, self.L
        a0, a1, c0, c1 = a[:L], a[L:], c[:L], c[L:]
        t0 = b.mul(a0, c0)
        t1 = b.mul(a1, c1)
        s = b.mul(b.add(a0, a1), b.add(c0, c1))
        return torch.cat([b.sub(t0, self._small(t1)), b.sub(b.sub(s, t0), t1)], 0)

    def sqr(self, a):
        b, L = self.b, self.L
        a0, a1 = a[:L], a[L:]
        if self.k == 1:
            r0 = b.mul(b.add(a0, a1), b.sub(a0, a1))
        else:
            r0 = b.sub(b.sqr(a0), self._small(b.sqr(a1)))
        t = b.mul(a0, a1)
        return torch.cat([r0, b.add(t, t)], 0)

    def add(self, a, c):
        L = self.L
        return torch.cat([self.b.add(a[:L], c[:L]), self.b.add(a[L:], c[L:])], 0)

    def sub(self, a, c):
        L = self.L
        return torch.cat([self.b.sub(a[:L], c[:L]), self.b.sub(a[L:], c[L:])], 0)

    def is_zero(self, a):
        return self.b.is_zero(a[: self.L]) & self.b.is_zero(a[self.L :])

    def one(self, like):
        return torch.cat([self.b.one(like[: self.L]), torch.zeros_like(like[self.L :])], 0)


def _where(mask, a, b):
    return tuple(torch.where(mask.unsqueeze(0), u, v) for u, v in zip(a, b))


def _double_plain(f: _Fx, x1, y1, z1):
    a = f.sqr(x1)
    b = f.sqr(y1)
    c = f.sqr(b)
    d0 = f.sub(f.sub(f.sqr(f.add(x1, b)), a), c)
    d = f.add(d0, d0)
    e = f.add(f.add(a, a), a)
    dx = f.sub(f.sqr(e), f.add(d, d))
    c2 = f.add(c, c)
    c8 = f.add(f.add(c2, c2), f.add(c2, c2))
    dy = f.sub(f.mul(e, f.sub(d, dx)), c8)
    dz0 = f.mul(y1, z1)
    return dx, dy, f.add(dz0, dz0)


def _edge_cases(f: _Fx, out, h, r0, x1, y1, z1):
    """Where h == 0: P + P doubles (computed only if some lane needs it),
    P - P is infinity."""
    h_zero = f.is_zero(h)
    r_zero = f.is_zero(r0)
    both = h_zero & r_zero
    trace.count("host_syncs")
    if bool(both.any()):
        out = _where(both, _double_plain(f, x1, y1, z1), out)
    zero = torch.zeros_like(x1)
    return _where(h_zero & ~r_zero, (zero, f.one(x1), zero), out)


def _madd_plain(f: _Fx, x1, y1, z1, x2, y2, complete: bool):
    z1z1 = f.sqr(z1)
    u2 = f.mul(x2, z1z1)
    s2 = f.mul(f.mul(y2, z1), z1z1)
    h = f.sub(u2, x1)
    hh = f.sqr(h)
    i = f.add(f.add(hh, hh), f.add(hh, hh))
    j = f.mul(h, i)
    r0 = f.sub(s2, y1)
    r = f.add(r0, r0)
    v = f.mul(x1, i)
    x3 = f.sub(f.sub(f.sqr(r), j), f.add(v, v))
    y1j = f.mul(y1, j)
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(y1j, y1j))
    z3 = f.sub(f.sub(f.sqr(f.add(z1, h)), z1z1), hh)
    out = (x3, y3, z3)
    one = f.one(x1)
    if complete:
        out = _edge_cases(f, out, h, r0, x1, y1, z1)
    return _where(f.is_zero(z1), (x2, y2, one), out)


def _add_plain(f: _Fx, x1, y1, z1, x2, y2, z2):
    z1z1 = f.sqr(z1)
    z2z2 = f.sqr(z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(f.mul(y1, z2), z2z2)
    s2 = f.mul(f.mul(y2, z1), z1z1)
    h = f.sub(u2, u1)
    i = f.sqr(f.add(h, h))
    j = f.mul(h, i)
    r0 = f.sub(s2, s1)
    r = f.add(r0, r0)
    v = f.mul(u1, i)
    x3 = f.sub(f.sub(f.sqr(r), j), f.add(v, v))
    s1j = f.mul(s1, j)
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(s1j, s1j))
    z3 = f.mul(f.sub(f.sub(f.sqr(f.add(z1, z2)), z1z1), z2z2), h)
    out = _edge_cases(f, (x3, y3, z3), h, r0, x1, y1, z1)
    out = _where(f.is_zero(z2), (x1, y1, z1), out)
    return _where(f.is_zero(z1), (x2, y2, z2), out)


def unpack(pq: torch.Tensor):
    """(L, N) rows of 32-bit limb pairs -> x, y as (L, N) 16-bit limbs."""
    w = pq.long() & 0xFFFFFFFF
    h = pq.shape[0] // 2
    pairs = torch.stack([w & ff.MASK, w >> 16], 1).reshape(2 * pq.shape[0], -1)
    return pairs[: 2 * h], pairs[2 * h :]


def pack(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inverse of ``unpack``: rows 0..L/2-1 pack x's limb pairs, then y's."""
    return torch.cat([x[0::2] | (x[1::2] << 16), y[0::2] | (y[1::2] << 16)], 0).contiguous()


@functools.lru_cache(maxsize=4)
def _k2d(spec: FieldSpec):
    """JubJub's 2d in Montgomery form: (L,) int64 limbs and the kernel's 8
    32-bit words (ec_lf.py::_ed_k2d_rows)."""
    v = (2 * FP.JUBJUB_D) % spec.modulus * spec.R % spec.modulus
    limbs = torch.tensor([(v >> (16 * i)) & ff.MASK for i in range(spec.n_limbs)], dtype=torch.int64)
    words = (ctypes.c_uint32 * 8)(*[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
    return limbs, words


def _ed_add_plain(f: _Fx, x1, y1, z1, t1, x2, y2, z2, t2):
    """add-2008-hwcd-3, a = -1; z2 None is the mixed add (z2 = 1)."""
    a = f.mul(f.sub(y1, x1), f.sub(y2, x2))
    b = f.mul(f.add(y1, x1), f.add(y2, x2))
    k2d = _k2d(f.spec)[0].to(x1.device).view(-1, 1).expand_as(t1)
    c = f.mul(f.mul(t1, k2d), t2)
    if z2 is None:
        d = f.add(z1, z1)
    else:
        zz = f.mul(z1, z2)
        d = f.add(zz, zz)
    e = f.sub(b, a)
    ff_ = f.sub(d, c)
    g = f.add(d, c)
    h = f.add(b, a)
    return f.mul(e, ff_), f.mul(g, h), f.mul(ff_, g), f.mul(e, h)


def _ed_smul_plain(spec: FieldSpec, coords, k: int, bits: int):
    """k p over the low ``bits`` bits of k, MSB first: ed_add(acc, acc),
    then ed_add(acc, p) where the bit is set, from the identity."""
    f = _Fx(spec)
    base = [t.long() for t in coords]
    acc = [t.long() for t in ed_infinity(spec, base[0].shape[1], base[0].device)]
    for i in reversed(range(bits)):
        acc = _ed_add_plain(f, *acc, *acc)
        if k >> i & 1:
            acc = _ed_add_plain(f, *acc, *base)
    return tuple(t.to(torch.int32).contiguous() for t in acc)


def _plain(which: str, spec: FieldSpec, coords):
    c = [t.long() for t in coords]
    f = _Fx(spec)
    if which.startswith("ed_"):
        if which == "ed_double":
            out = _ed_add_plain(f, *c, *c)
        elif which == "ed_add":
            out = _ed_add_plain(f, *c)
        else:
            x2, y2 = unpack(coords[4]) if which == "ed_madd_packed" else c[4:]
            out = _ed_add_plain(f, *c[:4], x2, y2, None, f.mul(x2, y2))
        return tuple(t.to(torch.int32).contiguous() for t in out)
    if which.startswith("g2_"):
        f, which = _Fx2(spec), which[3:]
    if which == "double":
        out = _double_plain(f, *c)
    elif which == "add":
        out = _add_plain(f, *c)
    else:
        if which.endswith("packed"):
            c = c[:3] + list(unpack(coords[3]))
        out = _madd_plain(f, *c, complete=not which.startswith("madd_distinct"))
    return tuple(t.to(torch.int32).contiguous() for t in out)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib(name: str):
    lib = D.library(name)
    if name == "ec_g1":
        lib.pc_ec_op.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32),
                                 ctypes.c_void_p]
        lib.pc_ec_op.restype = ctypes.c_int
        lib.pc_ec_scan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
        lib.pc_ec_scan.restype = ctypes.c_int
        lib.pc_ec_fold.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
        lib.pc_ec_fold.restype = ctypes.c_int
    elif name == "ec_g2":
        lib.pc_ec_g2_op.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
        lib.pc_ec_g2_op.restype = ctypes.c_int
    else:
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.pc_ec_ed_op.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, u32p, u32p, ctypes.c_void_p]
        lib.pc_ec_ed_op.restype = ctypes.c_int
        lib.pc_ec_ed_smul.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, u32p,
                                      u32p, u32p, ctypes.c_int, ctypes.c_void_p]
        lib.pc_ec_ed_smul.restype = ctypes.c_int
    return lib


def _check(which: str, spec: FieldSpec, coords):
    """ff.check_limbs, with 2L rows for the G2 formulas."""
    ff.check_limbs(spec, *coords, rows=2 * spec.n_limbs if which.startswith("g2_") else 0)


def _run(wrapper, which: str, spec: FieldSpec, coords):
    _check(which, spec, coords)
    if coords[0].device.type == "cpu":
        return _plain(which, spec, coords)
    D.require_cuda(coords[0])
    ed = which.startswith("ed_")
    n_out = 4 if ed else 3
    outs = tuple(torch.empty_like(coords[0]) for _ in range(n_out))
    n = coords[0].shape[1]
    if n == 0:
        return outs
    n_in = 8 if ed else 6
    ins = (ctypes.c_void_p * n_in)(*[t.data_ptr() for t in coords],
                                   *([0] * (n_in - len(coords))))
    optrs = (ctypes.c_void_p * n_out)(*[t.data_ptr() for t in outs])
    consts, stream = ff.kernel_consts(spec), D.stream_of(coords[0])
    if ed:
        if spec is not FP.JUBJUB_FQ:
            raise ValueError(f"{spec.name}: the Edwards kernel is JubJub's (over Fr-381)")
        rc = _lib("ec_ed").pc_ec_ed_op(_ED_WHICH[which], ins, optrs, n, consts, _k2d(spec)[1],
                                       stream)
    elif which.startswith("g2_"):
        rc = _lib("ec_g2").pc_ec_g2_op(_WHICH[which[3:]], ff.n_words(spec), -QUAD_NR[spec.name],
                                       ins, optrs, n, consts, stream)
    else:
        rc = _lib("ec_g1").pc_ec_op(_WHICH[which], ff.n_words(spec), ins, optrs, n, consts,
                                    stream)
    if rc != 0:
        raise RuntimeError(f"ec {which} kernel launch failed: CUDA error {rc}")
    _count(wrapper)
    return outs


def _count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel."""
    wrapper.launches += 1


def plain(which: str, spec: FieldSpec, *coords):
    """The plain PyTorch version of formula ``which`` on any device."""
    _check(which, spec, coords)
    return _plain(which, spec, coords)


def madd(spec, p, xq, yq):
    """Jacobian p + affine (xq, yq); complete (infinity, doubling, negation)."""
    return _run(madd, "madd", spec, (p[0], p[1], p[2], xq, yq))


def madd_distinct(spec, p, xq, yq):
    """Jacobian p + affine (xq, yq), assuming q != +-p (pairwise
    DL-independent bases, as in every SRS). Handles p at infinity only."""
    return _run(madd_distinct, "madd_distinct", spec, (p[0], p[1], p[2], xq, yq))


def madd_packed(spec, p, pq):
    """Jacobian p + affine point packed as (L, N) 32-bit limb pairs (rows
    0..L/2-1: x limbs 2i | 2i+1 << 16; rows L/2..: y). Complete."""
    return _run(madd_packed, "madd_packed", spec, (p[0], p[1], p[2], pq))


def madd_distinct_packed(spec, p, pq):
    """Packed-input ``madd_distinct`` (same precondition)."""
    return _run(madd_distinct_packed, "madd_distinct_packed", spec, (p[0], p[1], p[2], pq))


def add(spec, p, q):
    """Jacobian p + Jacobian q, complete."""
    return _run(add, "add", spec, (p[0], p[1], p[2], q[0], q[1], q[2]))


def double(spec, p):
    return _run(double, "double", spec, (p[0], p[1], p[2]))


def select(mask, p, q):
    """where(mask, p, q) per point; mask (N,) bool."""
    return tuple(ff.select(mask, a, b) for a, b in zip(p, q))


def scan_loop(madd_packed, acc, packed, idx, keep):
    """The MSM's within-lane scan as a loop of launches, one step a
    launch: acc <- keep[s] ? madd_packed(acc, packed[:, idx[s]]) : acc, and
    prefix s <- acc. ``packed`` is (rows, N) limbs-first pairs of words
    (``pack``), idx and keep (steps, lanes). Returns (acc, prefixes), the
    prefixes (n_coords, rows, steps, lanes)."""
    steps, lanes = idx.shape
    prefixes = torch.empty((len(acc), acc[0].shape[0], steps, lanes), dtype=torch.int32,
                           device=acc[0].device)
    for s in range(steps):
        g = packed.index_select(1, idx[s]).contiguous()
        acc = select(keep[s], madd_packed(acc, g), acc)
        for k, cc in enumerate(acc):
            prefixes[k, :, s] = cc
    return acc, prefixes


def _scan_args(spec: FieldSpec, table, idx, keep):
    L = spec.n_limbs
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != L:
        raise ValueError(f"expected an (N, {L}) int32 point table, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if idx.dtype != torch.int32 or keep.dtype != torch.bool or idx.dim() != 2 or idx.shape != keep.shape:
        raise ValueError(f"expected (steps, lanes) int32 idx and bool keep, got {tuple(idx.shape)} "
                         f"{idx.dtype} and {tuple(keep.shape)} {keep.dtype}")
    if 0 in idx.shape:
        raise ValueError(f"the scan takes at least one step and one lane, got {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous() and keep.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if not table.device == idx.device == keep.device:
        raise ValueError("operands lie on different devices")


def _scan_plain(spec: FieldSpec, table, idx, keep, distinct: bool):
    which = "madd_distinct_packed" if distinct else "madd_packed"
    acc = infinity(spec, idx.shape[1], table.device)
    return scan_loop(lambda p, g: _plain(which, spec, (*p, g)), acc, table.T, idx, keep)


def madd_scan_plain(spec, table, idx, keep, distinct: bool):
    """The plain PyTorch version of ``madd_scan`` on any device: the loop
    of ``scan_loop`` on the plain mixed add."""
    _scan_args(spec, table, idx, keep)
    return _scan_plain(spec, table, idx, keep, distinct)


def madd_scan(spec, table, idx, keep, distinct: bool):
    """The MSM's within-lane scan in one K2a launch (``pc_ec_scan``): from
    infinity, lane i adds the affine point at row idx[s, i] of ``table``
    where keep[s, i], step by step, and keeps every step's sum. ``table`` is
    (N, L) int32, row j the point's x words then y words (``pack(x, y).T``),
    idx int32 and keep bool (steps, lanes); idx must be rows of the table.
    ``distinct`` takes madd_distinct (no point added equals +-the sum; every
    SRS), else the complete madd. Returns (acc, prefixes): the final sums
    and every step's, (3, L, steps, lanes), limb for limb ``scan_loop`` over
    ``madd_distinct_packed`` / ``madd_packed``."""
    _scan_args(spec, table, idx, keep)
    if table.device.type == "cpu":
        return _scan_plain(spec, table, idx, keep, distinct)
    D.require_cuda(table)
    steps, lanes = idx.shape
    prefixes = torch.empty((3, spec.n_limbs, steps, lanes), dtype=torch.int32, device=table.device)
    rc = _lib("ec_g1").pc_ec_scan(ff.n_words(spec), int(not distinct), table.data_ptr(),
                                  idx.data_ptr(), keep.data_ptr(), prefixes.data_ptr(), lanes,
                                  steps, ff.kernel_consts(spec), D.stream_of(table))
    if rc != 0:
        raise RuntimeError(f"ec madd_scan kernel launch failed: CUDA error {rc}")
    _count(madd_scan)
    return tuple(prefixes[k, :, steps - 1].contiguous() for k in range(3)), prefixes


FOLD_MAX_WINDOWS = 64  # the fold kernel's block: a thread a window


def _fold_args(spec: FieldSpec, parts, c: int, rows: int) -> int:
    """Checks window_fold's operands; returns the windows a row."""
    if len(parts) != 6:
        raise ValueError(f"expected G_last and sum G as 6 coordinates, got {len(parts)}")
    ff.check_limbs(spec, *parts)
    cols = parts[0].shape[1]
    if rows < 1 or cols % rows:
        raise ValueError(f"{cols} window columns do not split into {rows} rows")
    windows = cols // rows
    if windows > FOLD_MAX_WINDOWS or windows & (windows - 1) or c < 1:
        raise ValueError(f"the fold takes a power of two up to {FOLD_MAX_WINDOWS} windows of "
                         f"c >= 1 bits, got {windows} of c = {c}")
    return windows


def fold_tree(spec: FieldSpec, parts, c: int, rows: int, add, double, sub):
    """The window fold by a halving tree, by the group operations given
    (``add(spec, p, q)``, ``double(spec, p)``, ``sub(spec, a, b)``): S_w =
    2^c G_last - (G_last + sum G) on every column, then each row's upper
    half of windows doubled c half times and added to its lower half,
    every row at once. On the plain formulas it is ``window_fold``'s plain
    version; on the K2a wrappers, the loop of launches the kernel replaced."""
    L = spec.n_limbs
    g_last, sum_g = parts[:3], parts[3:]
    t = add(spec, g_last, sum_g)
    t = (t[0], sub(spec, torch.zeros_like(t[1]), t[1]), t[2])
    acc = g_last
    for _ in range(c):
        acc = double(spec, acc)
    cur = add(spec, acc, t)
    width = cur[0].shape[1] // rows
    while width > 1:
        half = width // 2
        view = tuple(cc.view(L, rows, width) for cc in cur)
        hi = tuple(cc[:, :, half:].reshape(L, rows * half).contiguous() for cc in view)
        lo = tuple(cc[:, :, :half].reshape(L, rows * half).contiguous() for cc in view)
        for _ in range(c * half):
            hi = double(spec, hi)
        cur = add(spec, lo, hi)
        width = half
    return cur


def _fold_plain(spec: FieldSpec, parts, c: int, rows: int):
    return fold_tree(spec, parts, c, rows, lambda sp, p, q: _plain("add", sp, (*p, *q)),
                     lambda sp, p: _plain("double", sp, p),
                     lambda sp, a, b: ff.plain("sub", sp, a, b))


def window_fold_plain(spec: FieldSpec, parts, c: int, rows: int):
    """The plain PyTorch version of ``window_fold`` on any device: the same
    group elements by a halving tree of the plain formulas."""
    _fold_args(spec, parts, c, rows)
    return _fold_plain(spec, parts, c, rows)


def window_fold(spec: FieldSpec, parts, c: int, rows: int):
    """The MSM's window fold of ``rows`` MSMs in one K2a launch
    (``pc_ec_fold``): ``parts`` are G_last and sum G of each window
    (msm_gpu._msm_body), 6 coordinates of (L, rows W), a row's W windows
    side by side; row b of the result is sum_w 2^(c w) S_w with S_w =
    (2^c - 1) G_last - sum G, Jacobian coordinates (L, rows). The windows'
    S_w are formed side by side, then each row folds by Horner from its top
    window. W is a power of two up to FOLD_MAX_WINDOWS."""
    windows = _fold_args(spec, parts, c, rows)
    if parts[0].device.type == "cpu":
        return _fold_plain(spec, parts, c, rows)
    D.require_cuda(*parts)
    outs = tuple(torch.empty((spec.n_limbs, rows), dtype=torch.int32, device=parts[0].device)
                 for _ in range(3))
    ins = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in parts])
    optrs = (ctypes.c_void_p * 3)(*[t.data_ptr() for t in outs])
    rc = _lib("ec_g1").pc_ec_fold(ff.n_words(spec), ins, optrs, rows, windows, c,
                                  ff.kernel_consts(spec), D.stream_of(parts[0]))
    if rc != 0:
        raise RuntimeError(f"ec window_fold kernel launch failed: CUDA error {rc}")
    _count(window_fold)
    return outs


WRAPPERS = (madd, madd_distinct, madd_packed, madd_distinct_packed, add, double, madd_scan,
            window_fold)
for _w in WRAPPERS:
    _w.launches = 0


def infinity(spec: FieldSpec, n: int, device):
    return (ff.zeros(spec, n, device), ff.one_mont(spec, n, device), ff.zeros(spec, n, device))


def from_affine(spec: FieldSpec, x, y, inf_mask=None):
    n = x.shape[1]
    z = ff.one_mont(spec, n, x.device)
    if inf_mask is not None:
        z = ff.select(inf_mask, ff.zeros(spec, n, x.device), z)
    return (x, y, z)


def neg(spec: FieldSpec, p):
    """-(x, y, z): y -> 0 - y (K1 subtraction)."""
    x, y, z = p
    return (x, ff.sub(spec, torch.zeros_like(y), y), z)


# -- G2 (K2c): Weierstrass over Fq2; coordinates are (2L, N) c0||c1 stacks ----


def g2_madd(spec, p, xq, yq):
    """G2 Jacobian p + affine (xq, yq); complete."""
    return _run(g2_madd, "g2_madd", spec, (p[0], p[1], p[2], xq, yq))


def g2_madd_distinct(spec, p, xq, yq):
    """G2 ``madd_distinct`` (q != +-p; p at infinity handled)."""
    return _run(g2_madd_distinct, "g2_madd_distinct", spec, (p[0], p[1], p[2], xq, yq))


def g2_madd_packed(spec, p, pq):
    """G2 ``madd`` with the affine point packed by ``pack`` as (2L, N)
    32-bit words: x's c0 and c1 words, then y's."""
    return _run(g2_madd_packed, "g2_madd_packed", spec, (p[0], p[1], p[2], pq))


def g2_madd_distinct_packed(spec, p, pq):
    return _run(g2_madd_distinct_packed, "g2_madd_distinct_packed", spec, (p[0], p[1], p[2], pq))


def g2_add(spec, p, q):
    return _run(g2_add, "g2_add", spec, (p[0], p[1], p[2], q[0], q[1], q[2]))


def g2_double(spec, p):
    return _run(g2_double, "g2_double", spec, (p[0], p[1], p[2]))


G2_WRAPPERS = (g2_madd, g2_madd_distinct, g2_madd_packed, g2_madd_distinct_packed, g2_add,
               g2_double)


def fq2_one(spec: FieldSpec, n: int, device) -> torch.Tensor:
    """(R mod p, 0) as a (2L, n) stack."""
    return torch.cat([ff.one_mont(spec, n, device), ff.zeros(spec, n, device)], 0)


def g2_infinity(spec: FieldSpec, n: int, device):
    zero = torch.zeros((2 * spec.n_limbs, n), dtype=torch.int32, device=device)
    return (zero, fq2_one(spec, n, device), zero.clone())


def g2_from_affine(spec: FieldSpec, x, y, inf_mask=None):
    n = x.shape[1]
    z = fq2_one(spec, n, x.device)
    if inf_mask is not None:
        z = ff.select(inf_mask, torch.zeros_like(z), z)
    return (x, y, z)


def g2_neg(spec: FieldSpec, p):
    """-(x, y, z): each component of y -> 0 - y (K1 subtraction)."""
    x, y, z = p
    L = spec.n_limbs
    zero = torch.zeros_like(y[:L])
    return (x, torch.cat([ff.sub(spec, zero, y[:L].contiguous()),
                          ff.sub(spec, zero, y[L:].contiguous())], 0), z)


# -- JubJub (K2b): extended twisted Edwards a = -1 over Fr-381 ---------------


def ed_madd(spec, p, xq, yq):
    """Extended p + affine (xq, yq) (t2 = xq yq in the kernel); complete."""
    return _run(ed_madd, "ed_madd", spec, (p[0], p[1], p[2], p[3], xq, yq))


def ed_madd_packed(spec, p, pq):
    """``ed_madd`` with the affine point packed by ``pack`` (16 rows)."""
    return _run(ed_madd_packed, "ed_madd_packed", spec, (p[0], p[1], p[2], p[3], pq))


def ed_add(spec, p, q):
    return _run(ed_add, "ed_add", spec, (*p, *q))


def ed_double(spec, p):
    """The unified formula on (p, p): the same coordinates as ed_add(p, p)."""
    return _run(ed_double, "ed_double", spec, tuple(p))


SMUL_BITS = 256  # the kernel's scalar width: 8 32-bit words


def _smul_args(spec, p, k):
    """(coords, k) checked: 0 <= k < 2^SMUL_BITS, JubJub limbs."""
    k = int(k)
    if not 0 <= k < 1 << SMUL_BITS:
        raise ValueError(f"ed_smul takes 0 <= k < 2^{SMUL_BITS}: k={k}")
    coords = tuple(p)
    _check("ed_smul", spec, coords)
    if spec is not FP.JUBJUB_FQ:
        raise ValueError(f"{spec.name}: the Edwards kernel is JubJub's (over Fr-381)")
    return coords, k


def ed_smul(spec, p, k: int):
    """k p for one Python-int scalar 0 <= k < 2^SMUL_BITS shared by every
    lane: MSB first over k's bits, ed_add(acc, acc) then ed_add(acc, p)
    where the bit is set, from the identity; limb for limb the chain of
    ``ed_double`` and ``ed_add`` launches, in one K2b launch
    (``pc_ec_ed_smul``)."""
    coords, k = _smul_args(spec, p, k)
    if coords[0].device.type == "cpu":
        return _ed_smul_plain(spec, coords, k, k.bit_length())
    D.require_cuda(*coords)
    outs = tuple(torch.empty_like(coords[0]) for _ in range(4))
    n = coords[0].shape[1]
    if n == 0:
        return outs
    ins = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in coords])
    optrs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in outs])
    words = (ctypes.c_uint32 * 8)(*[(k >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
    rc = _lib("ec_ed").pc_ec_ed_smul(ins, optrs, n, ff.kernel_consts(spec), _k2d(spec)[1], words,
                                     k.bit_length(), D.stream_of(coords[0]))
    if rc != 0:
        raise RuntimeError(f"ec ed_smul kernel launch failed: CUDA error {rc}")
    _count(ed_smul)
    return outs


def ed_smul_plain(spec, p, k: int):
    """The plain PyTorch version of ``ed_smul`` on any device."""
    coords, k = _smul_args(spec, p, k)
    return _ed_smul_plain(spec, coords, k, k.bit_length())


ED_WRAPPERS = (ed_madd, ed_madd_packed, ed_add, ed_double, ed_smul)
for _w in G2_WRAPPERS + ED_WRAPPERS:
    _w.launches = 0


def ed_infinity(spec: FieldSpec, n: int, device):
    one = ff.one_mont(spec, n, device)
    return (ff.zeros(spec, n, device), one, one.clone(), ff.zeros(spec, n, device))


def ed_from_affine(spec: FieldSpec, x, y, inf_mask=None):
    """(x, y, 1, x y); lanes in inf_mask become the identity."""
    n = x.shape[1]
    t = ff.mont_mul(spec, x, y)
    one = ff.one_mont(spec, n, x.device)
    if inf_mask is not None:
        zero = ff.zeros(spec, n, x.device)
        x = ff.select(inf_mask, zero, x)
        y = ff.select(inf_mask, one, y)
        t = ff.select(inf_mask, zero, t)
    return (x, y, one, t)


def ed_neg(spec: FieldSpec, p):
    """-(x, y, z, t) = (-x, y, z, -t)."""
    x, y, z, t = p
    zero = torch.zeros_like(x)
    return (ff.sub(spec, zero, x), y, z, ff.sub(spec, zero, t))
