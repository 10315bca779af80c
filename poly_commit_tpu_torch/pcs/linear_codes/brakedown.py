"""Brakedown (multilinear): the linear-time expander code in the engine.

Counterpart of poly_commit_tpu/pcs/linear_codes/brakedown.py, itself a
re-design of the reference's linear_codes/brakedown.rs (parameters and the
Fig. 2 constants :103-143, cn/dn :226-259, mat_size :260-288,
codeword_len :292-299, Fisher-Yates sparse matrices :305-333) and
multilinear_brakedown/mod.rs (recursive encode :56-84, naive base-case RS
:111-122).

Each sparse matrix is stored column-padded, as in the JAX package: (m, K)
row indices and (m, K, L) values, K the most non-zeros of a column, so
v^T A is a gather, one K1 product with the values and a log-depth K1 sum
over K, batched over the matrix rows (in chunks of rows, so that one
gather stays near GATHER_WORDS words). The base-case naive RS is a product
with its Vandermonde matrix and a sum. Every step runs on the device of the
parameters (``device``); there is no kernel of Brakedown's own, only K1.

Setup draws every non-zero from the caller's HostRng in the JAX package's
order (a u64 for the Fisher-Yates swap, then a non-zero field element),
reading the draws from bulk draws of the same ChaCha stream: the same
values, without a Python call per draw. Under an active mesh of more than
one rank whose axis size divides the row count, ``encode_rows`` splits the
rows over the ranks and all-gathers their codewords
(``parallel.mesh.map_rows``), as the JAX package's branch does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ... import device as D
from ...core import ff
from ...core import field as F
from ...core import poly as P
from ...parallel import mesh as PM
from ...utils.merkle import MerkleConfig
from .. import errors
from .engine import LinearCodePCS
from .utils import calculate_t, ceil_div, ceil_mul, ent, tensor_vec

GATHER_WORDS = 1 << 28  # int32 words of one row_mul gather (1 GiB)


# ---------------------------------------------------------------------------
# sparse matrices (column-padded gather format)
# ---------------------------------------------------------------------------


def _sum_axis(spec, a: torch.Tensor, axis: int) -> torch.Tensor:
    """Field sum over ``axis`` (counted from the limb axis, -2 or -3) by a
    halving loop of K1 additions; an odd length keeps its last entry."""
    k = a.shape[axis]
    while k > 1:
        half = k // 2
        head = F.add(spec, a.narrow(axis, 0, half), a.narrow(axis, half, half))
        a = head if k % 2 == 0 else torch.cat([head, a.narrow(axis, k - 1, 1)], axis)
        k = (k + 1) // 2
    return a.select(axis, 0)


@dataclasses.dataclass
class SparseMat:
    """v^T M for an n x m sparse matrix with a fixed number of non-zeros a
    row."""

    n: int
    m: int
    row_idx: torch.Tensor  # (m, K) int64, padded with 0
    val: torch.Tensor  # (m, K, L) Montgomery, padded with 0

    def row_mul(self, spec, v: torch.Tensor) -> torch.Tensor:
        """v: (R, n, L) -> (R, m, L)."""
        m, k = self.row_idx.shape
        rows = v.shape[0]
        if m == 0:
            return v.new_zeros((rows, 0, spec.n_limbs))
        step = max(1, GATHER_WORDS // (m * k * spec.n_limbs))
        flat = self.row_idx.reshape(-1)
        out = []
        for s in range(0, rows, step):
            g = v[s : s + step].index_select(1, flat).view(-1, m, k, spec.n_limbs)
            out.append(_sum_axis(spec, F.mont_mul(spec, g, self.val), -2))
        return torch.cat(out, 0)


class _Draws:
    """HostRng's ``u64()`` and ``field_int(spec)`` draws read from bulk
    draws of its stream: the same values in the same order. ``expect`` is
    the bytes the caller will take if no draw repeats; a repeated draw
    takes more from the stream."""

    def __init__(self, rng, spec, expect: int):
        self.rng, self.spec = rng, spec
        bits = spec.num_bits + 64
        self.nb = (bits + 7) // 8
        self.shift = 8 * self.nb - bits
        self.buf, self.pos = rng.bytes(expect), 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            self.buf = self.buf[self.pos :] + self.rng.bytes(self.pos + n - len(self.buf))
            self.pos = 0
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def field_int(self) -> int:
        return (int.from_bytes(self._take(self.nb), "little") >> self.shift) % self.spec.modulus


def make_mat(spec, n: int, m: int, d: int, rng, device=None) -> SparseMat:
    """Fisher-Yates: d distinct non-zero entries a row (brakedown.rs:305-333).

    Degenerate shapes (m == 0 columns or d == 0 non-zeros a row) are valid:
    the dims recursion can emit them (the reference's
    SprsMat::new_from_columns accepts them, utils.rs:24-107), and row_mul
    then yields an empty or all-zero segment.
    """
    dev = D.resolve(device)
    if m == 0 or d == 0:
        return SparseMat(n=n, m=m, row_idx=torch.zeros((m, 1), dtype=torch.int64, device=dev),
                         val=torch.zeros((m, 1, spec.n_limbs), dtype=torch.int32, device=dev))
    draws = _Draws(rng, spec, n * d * (8 + (spec.num_bits + 64 + 7) // 8))
    cols = np.empty(n * d, np.int64)
    vals = []
    tmp = list(range(m))
    e = 0
    for _ in range(n):
        for j in range(d):
            r = draws.u64() % (m - j)
            tmp[r], tmp[m - 1 - j] = tmp[m - 1 - j], tmp[r]
            cols[e] = tmp[m - 1 - j]
            v = 0
            while v == 0:
                v = draws.field_int()
            vals.append(v)
            e += 1
    rows = np.repeat(np.arange(n, dtype=np.int64), d)
    # column j's entries in draw order, as the JAX package appends them
    order = np.argsort(cols, kind="stable")
    counts = np.bincount(cols, minlength=m)
    k = max(1, int(counts.max()))
    starts = np.cumsum(counts) - counts
    col_s = cols[order]
    rank = np.arange(n * d) - starts[col_s]
    row_idx = np.zeros((m, k), np.int64)
    row_idx[col_s, rank] = rows[order]
    limbs = ff.ints_to_limbs(spec, vals).astype(np.int32)
    val = np.zeros((m, k, spec.n_limbs), np.int32)
    val[col_s, rank] = limbs[order]
    return SparseMat(n=n, m=m, row_idx=torch.from_numpy(row_idx).to(dev),
                     val=torch.from_numpy(val).to(dev))


# ---------------------------------------------------------------------------
# parameters (brakedown.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BrakedownPCParams:
    """brakedown.rs's parameters; doubles as CommitterKey/VerifierKey.
    ``device`` is where ``check`` re-encodes (None: the default device)."""

    spec: object
    sec_param: int
    alpha: tuple
    beta: tuple
    rho_inv: tuple
    base_len: int
    n: int
    m: int
    m_ext: int
    a_dims: list  # [(rows, cols, d)]
    b_dims: list
    start: list
    end: list
    a_mats: list  # [SparseMat]
    b_mats: list
    check_well_formedness: bool = True
    device: Optional[str] = None

    def distance(self):
        """(beta rho_inv) as a fraction (brakedown.rs:69-71)."""
        return (self.rho_inv[1] * self.beta[0], self.rho_inv[0] * self.beta[1])

    def max_degree_supported(self):
        return 1 << 62

    def compute_dimensions(self, _poly_len):
        return (self.n, self.m)

    def merkle_config(self):
        return MerkleConfig()


def _div(a):
    return a[0] / a[1]


def _mu(a, r):
    return (r[0] * (a[1] - a[0]) - r[1] * a[1]) / (r[1] * a[1])


def _nu(a, b):
    c = (3, 100)
    return (b[0] * (a[1] + a[0]) * c[1] + c[0] * b[1] * a[1]) / (b[1] * a[1] * c[1])


def _cn_const(a, b):
    af, bf = _div(a), _div(b)
    arg = 1.28 * bf / af
    return (ent(bf) + af * ent(arg), -bf * math.log2(arg))


def _dn_const(a, b, r):
    m = _mu(a, r)
    n = _nu(a, b)
    af, bf, rf = _div(a), _div(b), _div(r)
    nm = n / m
    return (rf * af * ent(bf / rf) + m * ent(nm), -af * bf * math.log2(nm))


def _cn(n, a, b, c):
    return min(max(ceil_mul(n, (32 * b[0], 25 * b[1])), 4 + ceil_mul(n, b)),
               math.ceil((110.0 / n + c[0]) / c[1]))


def _dn(spec, n, b, r, d):
    return min(ceil_mul(n, (2 * b[0], b[1])) + math.ceil((ceil_mul(n, r) - n + 110) / spec.num_bits),
               math.ceil((110.0 / n + d[0]) / d[1]))


def _mat_size(spec, m, base_len, a, b, r):
    c = _cn_const(a, b)
    d = _dn_const(a, b, r)
    a_dims = []
    n = m
    while n >= base_len:
        cols = ceil_mul(n, a)
        cn = min(_cn(n, a, b, c), cols)
        a_dims.append((n, cols, cn))
        n = cols
    b_dims = []
    for (an, am, _) in a_dims:
        rows = ceil_mul(am, r)
        cols = max(0, ceil_mul(an, r) - an - rows)
        dn = min(_dn(spec, rows, b, r, d), cols)
        b_dims.append((rows, cols, dn))
    return a_dims, b_dims


def _codeword_len(a_dims, b_dims):
    return sum(col for (_, col, _) in b_dims) + sum(row for (row, _, _) in a_dims) + b_dims[-1][0]


def default_params(spec, rng, poly_len: int, check_well_formedness: bool = True,
                   base_len: int = 30, device=None) -> BrakedownPCParams:
    """Fig. 2 defaults (brakedown.rs:103-143); the matrices on ``device``."""
    sec_param = 128
    a = (178, 1000)
    b = (61, 1000)
    r = (1521, 1000)
    t = calculate_t(spec, sec_param, (b[0] * r[1], b[1] * r[0]), poly_len)
    base = math.ceil(math.sqrt(ceil_div(2 * poly_len, t)))
    n = 1 << max(0, (base - 1).bit_length())
    m = ceil_div(poly_len, n)
    a_dims, b_dims = _mat_size(spec, m, base_len, a, b, r)
    a_mats = [make_mat(spec, rn, rm, rd, rng, device) for (rn, rm, rd) in a_dims]
    b_mats = [make_mat(spec, rn, rm, rd, rng, device) for (rn, rm, rd) in b_dims]
    m_ext = ceil_mul(m, r) if not a_dims else _codeword_len(a_dims, b_dims)
    start, acc = [], 0
    for (row, _, _) in a_dims:
        acc += row
        start.append(acc)
    end, acc = [], m_ext
    for (_, col, _) in b_dims:
        acc -= col
        end.append(acc)
    return BrakedownPCParams(spec=spec, sec_param=sec_param, alpha=a, beta=b, rho_inv=r,
                             base_len=base_len, n=n, m=m, m_ext=m_ext, a_dims=a_dims,
                             b_dims=b_dims, start=start, end=end, a_mats=a_mats, b_mats=b_mats,
                             check_well_formedness=check_well_formedness,
                             device=None if device is None else str(device))


# ---------------------------------------------------------------------------
# the code (multilinear_brakedown/mod.rs)
# ---------------------------------------------------------------------------

_VANDER_CACHE: dict = {}


def _vandermonde(spec, npoints: int, ncoeffs: int, device) -> torch.Tensor:
    """(npoints, ncoeffs, L) Montgomery matrix V[p, k] = (p + 1)^k."""
    key = (spec.name, npoints, ncoeffs, str(device))
    if key not in _VANDER_CACHE:
        pmod = spec.modulus
        rows = []
        for pt in range(1, npoints + 1):
            x = 1
            for _ in range(ncoeffs):
                rows.append(x)
                x = x * pt % pmod
        _VANDER_CACHE[key] = F.from_ints(spec, rows, device=device).view(npoints, ncoeffs, -1)
    return _VANDER_CACHE[key]


def _naive_rs(spec, coeffs: torch.Tensor, npoints: int) -> torch.Tensor:
    """Each row of coeffs (R, D, L) evaluated at the points 1..npoints
    (multilinear_brakedown/mod.rs:111-122): one product with the
    Vandermonde matrix and a sum over D -> (R, npoints, L)."""
    v = _vandermonde(spec, npoints, coeffs.shape[-2], coeffs.device)  # (P, D, L)
    return _sum_axis(spec, F.mont_mul(spec, coeffs[:, None, :, :], v), -2)


class MultilinearBrakedownCode:
    def __init__(self, spec):
        self.spec = spec

    def setup(self, max_degree, num_vars, rng, device=None, base_len: int = 30):
        if num_vars is None:
            raise errors.InvalidNumberOfVariables()
        return default_params(self.spec, rng, 1 << num_vars, True, base_len, device)

    def poly_to_vec(self, lp):
        return lp.poly

    def point_to_vec(self, point):
        return [int(z) % self.spec.modulus for z in point]

    def tensor(self, point, n_cols, n_rows, device):
        split = (n_cols - 1).bit_length()
        pt = F.from_ints(self.spec, self.point_to_vec(point), device=device)
        return tensor_vec(self.spec, pt[:split]), tensor_vec(self.spec, pt[split:])

    def evaluate_poly(self, lp, point):
        pt = F.from_ints(self.spec, self.point_to_vec(point), device=lp.poly.device)
        return int(F.to_ints(self.spec, P.mle_evaluate(self.spec, lp.poly, pt)))

    def encode_rows(self, mat: torch.Tensor, pp: BrakedownPCParams) -> torch.Tensor:
        """The recursive expander encode of every row of mat (R, m, L)
        (multilinear_brakedown/mod.rs:56-84) -> (R, m_ext, L). Under an
        active mesh of more than one rank whose axis size divides R, each
        rank encodes its rows (every row's encode is independent)."""
        if mat.shape[-2] != pp.m:
            raise errors.PCError("encoding input has wrong length")
        active = PM.active_mesh()
        if active is not None and mat.ndim == 3:
            mesh, axis = active
            if mesh.size(axis) > 1 and mat.shape[0] % mesh.size(axis) == 0:
                return PM.map_rows(lambda m: self._encode_body(m, pp), mat, mesh, axis,
                                   what="Brakedown encode_rows")
        return self._encode_body(mat, pp)

    def _encode_body(self, mat: torch.Tensor, pp: BrakedownPCParams) -> torch.Tensor:
        spec = self.spec
        rows, L = mat.shape[0], spec.n_limbs
        cw = mat.new_zeros((rows, pp.m_ext, L))
        cw[:, : pp.m] = mat
        # forward A-multiplications: A_i reads [start_i - rows_i, start_i)
        # and writes the next cols_i entries
        for i, s in enumerate(pp.start):
            seg = pp.a_mats[i].row_mul(spec, cw[:, s - pp.a_dims[i][0] : s])
            cw[:, s : s + seg.shape[1]] = seg
        # base-case naive RS over [rss, rsie) -> [rss, rsoe); past rsoe the
        # codeword stays zero until the B steps (the reference resizes
        # before the RS step, mod.rs:72)
        rss = pp.start[-1] if pp.start else 0
        rsie = rss + (pp.a_dims[-1][1] if pp.a_dims else pp.m)
        rsoe = pp.end[-1] if pp.end else pp.m_ext
        cw[:, rss:rsoe] = _naive_rs(spec, cw[:, rss:rsie].contiguous(), rsoe - rss)
        # B-multiplications: B_i reads [start_i, end_i), writes [end_i, end_i + cols_i)
        for i in range(len(pp.b_dims)):
            s, e = pp.start[i], pp.end[i]
            seg = pp.b_mats[i].row_mul(spec, cw[:, s:e])
            cw[:, e : e + seg.shape[1]] = seg
        return cw


def make_multilinear_brakedown(spec):
    cls = type(f"MultilinearBrakedown_{spec.name}", (LinearCodePCS,), {})
    cls.spec = spec
    cls.code = MultilinearBrakedownCode(spec)
    return cls
