"""Dense univariate and multilinear polynomial operations.

Counterpart of poly_commit_tpu/core/poly.py. Coefficient arrays are (D, L)
int32 Montgomery limbs, ascending degree; multilinear evaluation tables are
(2^nv, L) with variable 1 in the least significant index bit (arkworks
order). The sequential scans of the JAX version (Horner ``evaluate``, the
Ruffini loop, ``long_divide``'s elimination loop) would be D eager steps
here, so they run in log depth and give the same field values:
``evaluate`` and ``divide_by_linear_int`` on power tables by doubling, one
product and a tree or suffix sum; ``long_divide`` on Newton's iteration for
the inverse of the reversed divisor, over ``mul``'s NTT products (K4 and
K1). ``vanishing_poly`` and ``lagrange_interpolate`` loop over their few
points, as the JAX scans do. The divisions, evaluations and eq tables are
the spans ``Poly::divide``, ``Poly::evaluate`` and ``Poly::tensor``
(utils/trace.py).
"""

from __future__ import annotations

import torch

from . import ff
from . import field as F
from ..utils import trace
from . import ntt_lf as NL
from .field_params import FieldSpec


def powers(spec: FieldSpec, x: torch.Tensor, n: int) -> torch.Tensor:
    """(1, x, ..., x^{n-1}) as (n, L) by doubling: log2 n products."""
    out = F.one_mont(spec, (1,), x.device)
    cur = x  # x^(2^k)
    k = 1
    while k < n:
        take = min(k, n - k)
        out = torch.cat([out, F.mont_mul(spec, out[:take], cur)], 0)
        cur = F.mont_sqr(spec, cur)
        k *= 2
    return out[:n]


def mle_fold(spec: FieldSpec, table: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Fix the lowest-index variable to z: out[b] = (1 - z) t[2b] + z t[2b+1]."""
    t = table.reshape(table.shape[:-2] + (table.shape[-2] // 2, 2, table.shape[-1]))
    even, odd = t[..., 0, :], t[..., 1, :]
    return F.add(spec, even, F.mont_mul(spec, F.sub(spec, odd, even), z))


@trace.traced("Poly::evaluate", log=False)
def mle_evaluate(spec: FieldSpec, table: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """The multilinear extension of table (2^nv, L) at point (nv, L)."""
    for i in range(point.shape[0]):
        table = mle_fold(spec, table, point[i])
    return table[..., 0, :]


@trace.traced("Poly::tensor", log=False)
def eq_table(spec: FieldSpec, point: torch.Tensor) -> torch.Tensor:
    """eq(point, b) over the boolean hypercube, (nv, L) -> (2^nv, L):
    out[b] = prod_i ((1 - z_i)(1 - b_i) + z_i b_i), variable i at index
    bit i (LSB first, arkworks order)."""
    one = F.one_mont(spec, (), point.device)
    t = one.unsqueeze(0)
    for i in range(point.shape[0]):
        z = point[i]
        # variable i's bit is the most significant index bit built so far
        t = torch.cat([F.mont_mul(spec, t, F.sub(spec, one, z)), F.mont_mul(spec, t, z)], 0)
    return t


@trace.traced("Poly::tensor", log=False)
def tensor_lsb(spec: FieldSpec, point: torch.Tensor) -> torch.Tensor:
    """(1 - z_i, z_i) tensor with variable i at index bit i (= eq_table)."""
    return eq_table(spec, point)


def _tree_sum(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """Sum of the rows of (n, ...) along the leading axis in log2 n
    additions."""
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])], 0)
        t = F.add(spec, t[0::2], t[1::2])
    return t[0]


@trace.traced("Poly::combine", log=False)
def row_combination(spec: FieldSpec, vec: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """v^T M for vec (n, L) and mat (n, m, L) -> (m, L): one product and a
    log-depth sum of the rows (the linear codes' v = b^T M)."""
    return _tree_sum(spec, F.mont_mul(spec, vec[:, None, :], mat))


@trace.traced("Poly::evaluate", log=False)
def evaluate(spec: FieldSpec, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """p(x) for coeffs (D, L) and one point x (L,): sum_k c_k x^k."""
    if coeffs.shape[0] == 0:
        return F.zeros(spec, (), x.device)
    return _tree_sum(spec, F.mont_mul(spec, coeffs, powers(spec, x, coeffs.shape[0])))


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Add coefficient arrays (pads the shorter one)."""
    da, db = a.shape[0], b.shape[0]
    if da < db:
        a = torch.cat([a, torch.zeros_like(b[: db - da])], 0)
    elif db < da:
        b = torch.cat([b, torch.zeros_like(a[: da - db])], 0)
    return F.add(spec, a, b)


def scale(spec: FieldSpec, a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k * a with k one field element (L,)."""
    return F.mont_mul(spec, a, k)


def shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by X^k (prepend k zero coefficients)."""
    return torch.cat([a.new_zeros((k,) + a.shape[1:]), a], 0)


@trace.traced("Poly::divide", log=False)
def divide_by_linear(spec: FieldSpec, coeffs: torch.Tensor, z: torch.Tensor):
    """Synthetic (Ruffini) division by (X - z) for short inputs:
    coeffs (D, L) -> (quotient (D-1, L), remainder (L,))."""
    n = coeffs.shape[0]
    acc = coeffs[n - 1]
    qs = []
    for i in range(n - 2, -1, -1):
        qs.append(acc)
        acc = F.add(spec, F.mont_mul(spec, acc, z), coeffs[i])
    q = torch.stack(qs[::-1], 0) if qs else coeffs[:0]
    return q, acc


def _suffix_sum(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """S_i = sum_{k >= i} t_k (Hillis-Steele: log2 n additions)."""
    d = 1
    while d < t.shape[0]:
        t = torch.cat([F.add(spec, t[:-d], t[d:]), t[-d:]], 0)
        d *= 2
    return t


def linear_tables(spec: FieldSpec, z_int: int, n: int, device):
    """(z^k, z^-k) for k < n as two (n, L) tables: what
    ``divide_by_linear_int`` builds for a point, built once for many
    divisions by the same X - z (z != 0)."""
    p = spec.modulus
    z_int = int(z_int) % p
    z = F.from_ints(spec, z_int, device=device)
    zinv = F.from_ints(spec, pow(z_int, -1, p), device=device)
    return powers(spec, z, n), powers(spec, zinv, n)


@trace.traced("Poly::divide", log=False)
def divide_by_linear_int(spec: FieldSpec, coeffs: torch.Tensor, z_int: int, tables=None):
    """divide_by_linear for a host-int point z, in log depth:
        w_i = z^{-(i+1)} S_{i+1},  S_i = sum_{k >= i} c_k z^k,  rem = S_0.
    z = 0 is a coefficient shift. ``tables``: z's ``linear_tables`` of at
    least len(coeffs) rows, where the caller divides by X - z many times."""
    n = coeffs.shape[0]
    z_int = int(z_int) % spec.modulus
    if n <= 1:
        return coeffs[:0], (coeffs[0] if n else F.zeros(spec, (), coeffs.device))
    if z_int == 0:
        return coeffs[1:], coeffs[0]
    zpows, zipows = tables if tables is not None else linear_tables(spec, z_int, n, coeffs.device)
    if zpows.shape[0] < n:
        raise ValueError(f"power tables of {zpows.shape[0]} rows for {n} coefficients")
    suffix = _suffix_sum(spec, F.mont_mul(spec, coeffs, zpows[:n]))
    w = F.mont_mul(spec, suffix[1:], zipows[1:n])
    return w, suffix[0]


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of (da, L) and (db, L) coefficients, (da + db - 1, L), by
    the JAX route: both padded to the power of two n >= da + db - 1 (at
    least 2), transformed (``ntt_lf``: K4a, or K4b and K4c), multiplied
    pointwise (K1), transformed back and canonicalised."""
    da, db = a.shape[0], b.shape[0]
    if da == 0 or db == 0:
        return a[:0]
    out_len = da + db - 1
    n = 1 << max(1, (out_len - 1).bit_length())

    def padded(c):
        out = torch.zeros((spec.n_limbs, n), dtype=torch.int32, device=c.device)
        out[:, : c.shape[0]] = c.T
        return NL.ntt(spec, out)

    prod = NL.intt(spec, ff.mont_mul(spec, padded(a), padded(b)))
    return ff.to_field_last(ff.canonicalize(spec, prod[:, :out_len].contiguous()), (out_len,))


def _mul_low(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """a b mod X^n, exactly n rows (zero-padded)."""
    a, b = a[:n], b[:n]
    out = mul(spec, a, b)[:n]
    if out.shape[0] < n:
        out = torch.cat([out, out.new_zeros((n - out.shape[0], spec.n_limbs))], 0)
    return out


def _inverse_series(spec: FieldSpec, g: torch.Tensor, k: int) -> torch.Tensor:
    """h (k, L) with g h = 1 mod X^k, for g[0] != 0, by Newton's iteration:
    from h = g[0]^-1, each round doubles the precision, h <- h - h (g h - 1),
    with two ``mul`` products; log2 k rounds."""
    h = F.inv(spec, g[:1])
    prec = 1
    while prec < k:
        nxt = min(2 * prec, k)
        # g h = 1 + X^prec e mod X^nxt; the new rows are -(h e) mod X^(nxt - prec)
        e = _mul_low(spec, g, h, nxt)[prec:]
        h = torch.cat([h, F.neg(spec, _mul_low(spec, h, e, nxt - prec))], 0)
        prec = nxt
    return h


def long_divide(spec: FieldSpec, num: torch.Tensor, den: torch.Tensor):
    """Dense long division num = q den + r, deg r < deg den: num (dn, L),
    den (dd, L) with a nonzero top coefficient, dn >= dd -> (q (dn - dd + 1,
    L), r (dd - 1, L)). Where the JAX version eliminates one quotient
    coefficient a step, here rev(q) = rev(num) rev(den)^-1 mod X^(dn-dd+1)
    (``_inverse_series``) and r = num - q den mod X^(dd-1). The quotient and
    remainder are unique, so they equal the JAX version's."""
    dn, dd = num.shape[0], den.shape[0]
    if dd < 1 or dn < dd:
        raise ValueError(f"long_divide: {dn} coefficients by {dd}")
    k = dn - dd + 1
    h = _inverse_series(spec, den.flip(0), k)
    q = _mul_low(spec, num.flip(0), h, k).flip(0)
    t = dd - 1
    if t == 0:
        return q, num[:0]
    return q, F.sub(spec, num[:t], _mul_low(spec, q, den, t))


def vanishing_poly(spec: FieldSpec, points: torch.Tensor) -> torch.Tensor:
    """prod_i (X - z_i): points (m, L) -> monic coefficients (m + 1, L), one
    step a point (the JAX scan)."""
    coeffs = F.one_mont(spec, (1,), points.device)
    zero = coeffs.new_zeros((1, spec.n_limbs))
    for z in points:
        coeffs = F.sub(spec, torch.cat([zero, coeffs], 0),
                       torch.cat([F.mont_mul(spec, coeffs, z), zero], 0))
    return coeffs


def lagrange_interpolate(spec: FieldSpec, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """The polynomial (m, L) through (xs[i], ys[i]), xs and ys (m, L):
    sum_i y_i l_i with l_i = Z / (X - x_i) / (Z / (X - x_i))(x_i), one step
    a point (O(m^2): streaming KZG's verifier interpolates a few)."""
    van = vanishing_poly(spec, xs)
    out = F.zeros(spec, (xs.shape[0],), xs.device)
    for x, y in zip(xs, ys):
        q, _ = divide_by_linear(spec, van, x)  # prod_{j != i} (X - x_j)
        w = F.mont_mul(spec, y, F.inv(spec, evaluate(spec, q, x)))
        out = F.add(spec, out, F.mont_mul(spec, q, w))
    return out
