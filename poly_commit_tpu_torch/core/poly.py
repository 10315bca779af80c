"""Dense univariate and multilinear polynomial operations.

Counterpart of the parts of poly_commit_tpu/core/poly.py that MarlinKZG10
and Ligero use. Coefficient arrays are (D, L) int32 Montgomery limbs,
ascending degree; multilinear evaluation tables are (2^nv, L) with
variable 1 in the least significant index bit (arkworks order).
The two sequential scans of the JAX version (Horner ``evaluate`` and the
Ruffini loop) would be D eager steps here, so ``evaluate`` and
``divide_by_linear_int`` are log-depth: power tables by doubling, one
product, a tree sum or a suffix sum. They give the same field values.
"""

from __future__ import annotations

import torch

from . import field as F
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


def mle_evaluate(spec: FieldSpec, table: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """The multilinear extension of table (2^nv, L) at point (nv, L)."""
    for i in range(point.shape[0]):
        table = mle_fold(spec, table, point[i])
    return table[..., 0, :]


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


def tensor_lsb(spec: FieldSpec, point: torch.Tensor) -> torch.Tensor:
    """(1 - z_i, z_i) tensor with variable i at index bit i (= eq_table)."""
    return eq_table(spec, point)


def _tree_sum(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """Sum of the rows of (n, L) in log2 n additions."""
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros_like(t[:1])], 0)
        t = F.add(spec, t[0::2], t[1::2])
    return t[0]


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


def divide_by_linear_int(spec: FieldSpec, coeffs: torch.Tensor, z_int: int):
    """divide_by_linear for a host-int point z, in log depth:
        w_i = z^{-(i+1)} S_{i+1},  S_i = sum_{k >= i} c_k z^k,  rem = S_0.
    z = 0 is a coefficient shift."""
    n = coeffs.shape[0]
    p = spec.modulus
    z_int = int(z_int) % p
    dev = coeffs.device
    if n <= 1:
        return coeffs[:0], (coeffs[0] if n else F.zeros(spec, (), dev))
    if z_int == 0:
        return coeffs[1:], coeffs[0]
    z = F.from_ints(spec, z_int, device=dev)
    zinv = F.from_ints(spec, pow(z_int, -1, p), device=dev)
    suffix = _suffix_sum(spec, F.mont_mul(spec, coeffs, powers(spec, z, n)))
    w = F.mont_mul(spec, suffix[1:], powers(spec, zinv, n)[1:])
    return w, suffix[0]
