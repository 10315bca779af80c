"""The quadratic extension Fq2 = Fq[u]/(u^2 - nr) on the port's tensors.

Counterpart of poly_commit_tpu/core/extfield.py (``Fq2Ops``). An element is
a pair (c0, c1) of base-field elements. Two layouts, as for the base field:

* limbs-last, the scheme layer's: (..., 2, L) int32, canonical (< p) between
  operations, as the JAX package keeps it;
* limbs-first, the kernels': (2L, N), c0's L limb rows over c1's, lazy in
  [0, 2p) per component (the ``*_lf`` functions, used by the G2 MSM and
  fixed-base normalisation).

The arithmetic is core/ff.py's (kernel K1 on a CUDA tensor) per component:
Karatsuba products, and the non-residue nr = -k (k = 1 for BLS12-381 and
BN254, 5 for BLS12-377) as an addition chain; ``dbl``, ``mul_small``,
``mul_base``, ``pack`` and ``select`` complete the JAX ``Fq2Ops`` surface
for parity with that package (core/pairing.py works limbs-first through
``mul_lf``/``add_lf``/``sub_lf`` and does not call them). Inverses go
through the norm a0^2 - nr a1^2 and one base-field inversion
(``batch_inv`` shares one Fermat inversion over the whole batch).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as D
from . import ff
from . import field as F
from .ec_lf import QUAD_NR, times_small
from .field_params import FieldSpec


def _small(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """k t (limbs-first) by an addition chain."""
    return times_small(lambda a, b: ff.add(spec, a, b), t, -QUAD_NR[spec.name])


# ---------------------------------------------------------------------------
# limbs-first (2L, N), lazy
# ---------------------------------------------------------------------------


def _halves(spec: FieldSpec, a: torch.Tensor):
    L = spec.n_limbs
    return a[:L], a[L:]


def mul_lf(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1 = _halves(spec, a)
    b0, b1 = _halves(spec, b)
    t0 = ff.mont_mul(spec, a0, b0)
    t1 = ff.mont_mul(spec, a1, b1)
    s = ff.mont_mul(spec, ff.add(spec, a0, a1), ff.add(spec, b0, b1))
    c1 = ff.sub(spec, ff.sub(spec, s, t0), t1)
    return torch.cat([ff.sub(spec, t0, _small(spec, t1)), c1], 0)


def add_lf(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (a0, a1), (b0, b1) = _halves(spec, a), _halves(spec, b)
    return torch.cat([ff.add(spec, a0, b0), ff.add(spec, a1, b1)], 0)


def sub_lf(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (a0, a1), (b0, b1) = _halves(spec, a), _halves(spec, b)
    return torch.cat([ff.sub(spec, a0, b0), ff.sub(spec, a1, b1)], 0)


def batch_inv_lf(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Inverses of the columns of a (2L, M) (zero maps to zero):
    1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 - nr a1^2), the norms inverted
    together by ``ff.batch_inv`` (one Fermat inversion)."""
    a0, a1 = _halves(spec, a)
    norm = ff.add(spec, ff.mont_mul(spec, a0, a0), _small(spec, ff.mont_mul(spec, a1, a1)))
    ninv = ff.batch_inv(spec, norm)
    zero = torch.zeros_like(a1)
    return torch.cat([ff.mont_mul(spec, a0, ninv),
                      ff.sub(spec, zero, ff.mont_mul(spec, a1, ninv))], 0)


def canonicalize_lf(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    a0, a1 = _halves(spec, a)
    return torch.cat([ff.canonicalize(spec, a0), ff.canonicalize(spec, a1)], 0)


def to_lf(a: torch.Tensor) -> torch.Tensor:
    """(..., 2, L) -> (2L, N) contiguous."""
    L = a.shape[-1]
    return a.reshape(-1, 2, L).permute(1, 2, 0).reshape(2 * L, -1).contiguous()


def from_lf(a: torch.Tensor, batch_shape) -> torch.Tensor:
    """(2L, N) -> (batch..., 2, L)."""
    L = a.shape[0] // 2
    return a.reshape(2, L, -1).permute(2, 0, 1).reshape(tuple(batch_shape) + (2, L)).contiguous()


# ---------------------------------------------------------------------------
# limbs-last (..., 2, L), canonical: the Fq2Ops surface
# ---------------------------------------------------------------------------


def _lf_op(fn, spec: FieldSpec, *xs):
    shape = np.broadcast_shapes(*(tuple(x.shape) for x in xs))  # torch's imports sympy
    out = fn(spec, *(to_lf(x.expand(shape)) for x in xs))
    return from_lf(canonicalize_lf(spec, out), shape[:-2])


def mul(spec: FieldSpec, a, b):
    return _lf_op(mul_lf, spec, a, b)


def sqr(spec: FieldSpec, a):
    return mul(spec, a, a)


def add(spec: FieldSpec, a, b):
    return _lf_op(add_lf, spec, a, b)


def sub(spec: FieldSpec, a, b):
    return _lf_op(sub_lf, spec, a, b)


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def dbl(spec: FieldSpec, a):
    return add(spec, a, a)


def mul_small(spec: FieldSpec, a, k: int):
    """k a for a small static k >= 0, by an addition chain."""
    if k == 0:
        return torch.zeros_like(a)
    return times_small(lambda x, y: add(spec, x, y), a, k)


def mul_base(spec: FieldSpec, a, b):
    """(a0 b, a1 b): an Fq2 element (..., 2, L) times a base-field element
    (..., L), broadcast over the batch axes."""
    return F.mont_mul(spec, a, b.unsqueeze(-2))


def pack(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """Two base-field elements (..., L) -> c0 + c1 u, (..., 2, L)."""
    return torch.stack([c0, c1], -2)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) for a mask over the batch axes of (..., 2, L)."""
    return torch.where(mask[..., None, None], a, b)


def batch_inv(spec: FieldSpec, a):
    """Inverses over the batch axes of (..., 2, L); zero maps to zero."""
    return _lf_op(batch_inv_lf, spec, a)


def inv(spec: FieldSpec, a):
    return batch_inv(spec, a)


def zeros(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    return F.zeros(spec, tuple(shape) + (2,), device)


def one(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    dev = D.resolve(device)
    return torch.stack([F.one_mont(spec, shape, dev), F.zeros(spec, shape, dev)], -2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1).all(-1)


def from_int(spec: FieldSpec, x, device=None) -> torch.Tensor:
    """A (c0, c1) int pair (or an int, c1 = 0) -> (2, L) Montgomery limbs."""
    c0, c1 = x if isinstance(x, (tuple, list)) else (x, 0)
    return F.from_ints(spec, [c0, c1], device=device)


def from_ints(spec: FieldSpec, pairs, device=None) -> torch.Tensor:
    """[(c0, c1)] -> (N, 2, L)."""
    flat = [int(v) for pr in pairs for v in pr]
    return F.from_ints(spec, flat, device=device).reshape(-1, 2, spec.n_limbs)


def to_int(spec: FieldSpec, a: torch.Tensor):
    """(2, L) -> (c0, c1); (..., 2, L) -> nested lists of pairs."""
    vals = F.to_ints(spec, a)
    if a.dim() == 2:
        return tuple(vals)

    def pairs(v):
        return tuple(v) if not isinstance(v[0], list) else [pairs(u) for u in v]

    return pairs(vals)
