"""The BLS12-381 pairing on the port's tensors (verifier side).

Counterpart of poly_commit_tpu/core/pairing.py, which replaces arkworks'
``E::pairing`` / ``E::multi_pairing`` (every pairing scheme's verifier,
e.g. kzg10/mod.rs:326-329). Same layout and algorithm as the JAX module:
Fq12 flattened as Fq2[w]/(w^6 - xi), xi = u + 1, elements (..., 6, 2, L)
limbs-last and canonical; the affine Miller loop with lines scaled by xi
(an Fq2 constant the final exponentiation kills), G2 untwisted by
(x, y) -> (x w^-2, y w^-3), batched over pairs, an infinite input giving 1;
the final exponentiation is the plain bit scan of (q^12 - 1)/r.

The arithmetic is core/extfield.py's limbs-first Fq2 (kernel K1 on a CUDA
tensor, its plain version on a CPU one), and between the public functions
an Fq12 batch stays limbs-first and lazy, (2L, N, 6) with each component
in [0, 2p): it is canonicalized only where a public function returns, so
a Miller loop or a final exponentiation makes no host synchronisation
until its end. Port choices that give the JAX module's values:

* ``f12_mul`` forms all 36 Fq2 products a_i b_j in one ``extfield.mul_lf``
  on broadcast operands, multiplies the 15 with i + j >= 6 by xi (one sub
  and one add: xi (x0 + x1 u) = (x0 - x1) + (x0 + x1) u), gathers the six
  terms of each output coefficient c_k = sum_{i+j=k} + xi sum_{i+j=k+6}
  and sums them by a tree of three adds: 16 K1 launches a product.
* The exponent's and the Miller loop's bits are host constants, so the
  loops branch on the host and multiply only on set bits, where the JAX
  module computes every step's product and selects.
* ``multi_pairing`` multiplies the Miller values by a product tree.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from . import extfield as E2
from . import ff
from . import field as F
from . import field_params as FP

SPEC = FP.FQ_BLS12_381
L = SPEC.n_limbs
FINAL_EXP = (FP.BLS12_381_Q ** 12 - 1) // FP.BLS12_381_R
X_BITS = tuple(int(b) for b in bin(abs(FP.BLS12_381_X_PARAM))[3:])  # after the leading 1
FE_BITS = tuple(int(b) for b in bin(FINAL_EXP)[2:])  # most significant first

# the 15 products a_i b_j with i + j >= 6 (index 6 i + j), and for each
# output coefficient k its six terms in [36 products, 15 xi-products, zero]
_HI = [6 * i + j for i in range(6) for j in range(6) if i + j >= 6]
_TERMS = [[6 * i + j for i in range(6) for j in range(6) if i + j == k]
          + [36 + _HI.index(6 * i + j) for i in range(6) for j in range(6) if i + j == k + 6]
          for k in range(6)]
_ZERO_SLOT = 36 + len(_HI)
_GATHER = [t for terms in _TERMS for t in terms + [_ZERO_SLOT] * (8 - len(terms))]


@functools.lru_cache(maxsize=8)
def _index(which: str, device: str) -> torch.Tensor:
    return torch.tensor(_HI if which == "hi" else _GATHER, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# limbs-first lazy Fq12, (2L, N, 6)
# ---------------------------------------------------------------------------


def _to_lf(a: torch.Tensor) -> torch.Tensor:
    """(..., 6, 2, L) -> (2L, N, 6)."""
    return a.reshape(-1, 6, 2, L).permute(2, 3, 0, 1).reshape(2 * L, -1, 6).contiguous()


def _from_lf(x: torch.Tensor, batch_shape) -> torch.Tensor:
    """(2L, N, 6), lazy -> canonical (..., 6, 2, L)."""
    x = E2.canonicalize_lf(SPEC, x.reshape(2 * L, -1))
    return x.reshape(2, L, -1, 6).permute(2, 3, 0, 1).reshape(
        tuple(batch_shape) + (6, 2, L)).contiguous()


def _one_lf(n: int, device) -> torch.Tensor:
    one = torch.zeros((2 * L, n, 6), dtype=torch.int32, device=device)
    one[:L, :, 0] = ff.one_mont(SPEC, 1, device)
    return one


def _mul_xi_lf(x: torch.Tensor) -> torch.Tensor:
    """xi x for (2L, M): (x0 - x1, x0 + x1)."""
    x0, x1 = x[:L], x[L:]
    return torch.cat([ff.sub(SPEC, x0, x1), ff.add(SPEC, x0, x1)], 0)


def _mul_lf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b for (2L, N, 6) operands (N or 1 columns each)."""
    n = max(a.shape[1], b.shape[1])
    lhs = a.unsqueeze(3).expand(-1, n, 6, 6).reshape(2 * L, -1)  # a_i at (i, j)
    rhs = b.unsqueeze(2).expand(-1, n, 6, 6).reshape(2 * L, -1)  # b_j at (i, j)
    prod = E2.mul_lf(SPEC, lhs, rhs).reshape(2 * L, n, 36)
    dev = str(prod.device)
    hi = prod.index_select(2, _index("hi", dev)).reshape(2 * L, -1)
    pool = torch.cat([prod, _mul_xi_lf(hi).reshape(2 * L, n, -1),
                      prod.new_zeros((2 * L, n, 1))], 2)
    x = pool.index_select(2, _index("gather", dev)).reshape(2 * L, n, 6, 8)
    for w in (4, 2, 1):
        x = E2.add_lf(SPEC, x[..., :w].reshape(2 * L, -1).contiguous(),
                      x[..., w:].reshape(2 * L, -1).contiguous()).reshape(2 * L, n, 6, w)
    return x.reshape(2 * L, n, 6)


def _conj_lf(x: torch.Tensor) -> torch.Tensor:
    """w -> -w: the odd coefficients negated."""
    odd = x[:, :, 1::2].reshape(2 * L, -1).contiguous()
    neg = E2.sub_lf(SPEC, torch.zeros_like(odd), odd).reshape(2 * L, -1, 3)
    out = x.clone()
    out[:, :, 1::2] = neg
    return out


def _pow_lf(x: torch.Tensor, bits: Sequence[int]) -> torch.Tensor:
    """x^e for e's bits, most significant first: one squaring a bit after
    the first set one, and one product a set bit."""
    out = None
    for bit in bits:
        if out is not None:
            out = _mul_lf(out, out)
        if bit:
            out = x if out is None else _mul_lf(out, x)
    return _one_lf(x.shape[1], x.device) if out is None else out


# ---------------------------------------------------------------------------
# Fq12, limbs-last and canonical: (..., 6, 2, L)
# ---------------------------------------------------------------------------


def f12_zero(shape=(), device=None) -> torch.Tensor:
    return F.zeros(SPEC, tuple(shape) + (6, 2), device)


def f12_one(shape=(), device=None) -> torch.Tensor:
    z = f12_zero(shape, device)
    z[..., 0, :, :] = E2.one(SPEC, shape, z.device)
    return z


def _binary_lf(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = fn(_to_lf(a.expand(shape)), _to_lf(b.expand(shape)))
    return _from_lf(out, shape[:-3])


def f12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary_lf(_mul_lf, a, b)


def f12_sqr(a: torch.Tensor) -> torch.Tensor:
    return f12_mul(a, a)


def f12_conj(a: torch.Tensor) -> torch.Tensor:
    """w -> -w (the q^6 Frobenius): negate odd coefficients."""
    return _from_lf(_conj_lf(_to_lf(a)), a.shape[:-3])


def f12_select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None, None, None], a, b)


def f12_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1).all(-1).all(-1)


def f12_is_one(a: torch.Tensor) -> torch.Tensor:
    return f12_eq(a, f12_one(a.shape[:-3], a.device))


def f12_pow_bits(a: torch.Tensor, bits: Sequence[int]) -> torch.Tensor:
    """a^e for e's bits (host ints, most significant first)."""
    return _from_lf(_pow_lf(_to_lf(a), [int(b) for b in bits]), a.shape[:-3])


# ---------------------------------------------------------------------------
# Miller loop (affine, batched)
# ---------------------------------------------------------------------------


def _line_lf(t, q, p, tangent: bool):
    """The line through T (tangent, or the chord to Q) at P, times xi, as a
    sparse (2L, N, 6) Fq12, and its slope. t, q: Fq2 (2L, N) pairs; p: Fq
    (L, N) pair."""
    xt, yt = t
    if tangent:
        sq = E2.mul_lf(SPEC, xt, xt)
        num = E2.add_lf(SPEC, sq, E2.add_lf(SPEC, sq, sq))  # 3 xt^2
        den = E2.add_lf(SPEC, yt, yt)
    else:
        xq, yq = q
        num = E2.sub_lf(SPEC, yq, yt)
        den = E2.sub_lf(SPEC, xq, xt)
    lam = E2.mul_lf(SPEC, num, E2.batch_inv_lf(SPEC, den))
    xp, yp = p
    c0 = torch.cat([yp, yp], 0)  # xi (yp + 0 u)
    c3 = E2.sub_lf(SPEC, E2.mul_lf(SPEC, lam, xt), yt)
    lam_xp = torch.cat([ff.mont_mul(SPEC, lam[:L], xp), ff.mont_mul(SPEC, lam[L:], xp)], 0)
    c5 = E2.sub_lf(SPEC, torch.zeros_like(lam_xp), lam_xp)
    z = torch.zeros_like(c0)
    return torch.stack([c0, z, z, c3, z, c5], 2), lam


def _g2_dbl_lf(t, lam):
    xt, yt = t
    x3 = E2.sub_lf(SPEC, E2.mul_lf(SPEC, lam, lam), E2.add_lf(SPEC, xt, xt))
    y3 = E2.sub_lf(SPEC, E2.mul_lf(SPEC, lam, E2.sub_lf(SPEC, xt, x3)), yt)
    return (x3, y3)


def _g2_add_lf(t, q, lam):
    xt, yt = t
    x3 = E2.sub_lf(SPEC, E2.sub_lf(SPEC, E2.mul_lf(SPEC, lam, lam), xt), q[0])
    y3 = E2.sub_lf(SPEC, E2.mul_lf(SPEC, lam, E2.sub_lf(SPEC, xt, x3)), yt)
    return (x3, y3)


def _line(t, q, p_xy, tangent: bool):
    """The JAX module's ``_line`` on limbs-last canonical operands: t, q
    pairs of Fq2 (..., 2, L), p_xy a pair of Fq (..., L); returns the
    sparse line (..., 6, 2, L) and its slope (..., 2, L)."""
    shape = p_xy[0].shape[:-1]
    line, lam = _line_lf(tuple(E2.to_lf(c) for c in t),
                         None if q is None else tuple(E2.to_lf(c) for c in q),
                         tuple(ff.from_field_last(c) for c in p_xy), tangent)
    return _from_lf(line, shape), E2.from_lf(E2.canonicalize_lf(SPEC, lam), shape)


def _miller_lf(p_aff, q_aff) -> torch.Tensor:
    """f_{|x|,Q}(P), conjugated for x < 0, as (2L, N, 6) lazy limbs; the
    rows of infinite inputs are garbage (``miller_loop`` replaces them)."""
    xp, yp, _ = p_aff
    xq, yq, _ = q_aff
    p = (ff.from_field_last(xp), ff.from_field_last(yp))
    q = (E2.to_lf(xq), E2.to_lf(yq))
    f = _one_lf(p[0].shape[1], xp.device)
    t = q
    for bit in X_BITS:
        line, lam = _line_lf(t, None, p, tangent=True)
        f = _mul_lf(_mul_lf(f, f), line)
        t = _g2_dbl_lf(t, lam)
        if bit:
            line, lam = _line_lf(t, q, p, tangent=False)
            f = _mul_lf(f, line)
            t = _g2_add_lf(t, q, lam)
    return _conj_lf(f) if FP.BLS12_381_X_PARAM < 0 else f


def miller_loop(p_aff, q_aff) -> torch.Tensor:
    """Batched Miller loop f_{|x|,Q}(P) (conjugated for x < 0).

    p_aff: (x, y, inf) G1 affine, x / y (..., L); q_aff the same over Fq2,
    (..., 2, L). Infinite inputs give f = 1."""
    shape = p_aff[0].shape[:-1]
    f = _from_lf(_miller_lf(p_aff, q_aff), shape)
    return f12_select(p_aff[2] | q_aff[2], f12_one(shape, f.device), f)


def final_exponentiation(f: torch.Tensor) -> torch.Tensor:
    return f12_pow_bits(f, FE_BITS)


def pairing(p_aff, q_aff) -> torch.Tensor:
    """e(P, Q) for single or batched affine inputs."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


def multi_pairing(p_aff, q_aff) -> torch.Tensor:
    """prod_i e(P_i, Q_i): a batched Miller loop, a product tree, one final
    exponentiation. Inputs batched along axis 0 (arkworks E::multi_pairing)."""
    x = _to_lf(miller_loop(p_aff, q_aff))
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, _one_lf(1, x.device)], 1)
        half = x.shape[1] // 2
        x = _mul_lf(x[:, :half], x[:, half:])
    if x.shape[1] == 0:
        x = _one_lf(1, x.device)
    return final_exponentiation(_from_lf(x, ()))


def pairing_check(p_aff, q_aff) -> torch.Tensor:
    """prod e(P_i, Q_i) == 1 (the shape of every KZG-style verification)."""
    return f12_is_one(multi_pairing(p_aff, q_aff))


def f12_to_ints(elem: torch.Tensor):
    """-> [(c0, c1)] * 6 Python ints (flattened w-basis), for tests."""
    return [E2.to_int(SPEC, elem[..., i, :, :]) for i in range(6)]
