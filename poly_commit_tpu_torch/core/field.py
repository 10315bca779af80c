"""Limbs-last prime-field arithmetic: the (..., L) tier the scheme code uses.

Counterpart of poly_commit_tpu/core/field.py. A field element is the last
axis of an int32 tensor of L little-endian 16-bit limbs, in Montgomery form
(R = 2^(16 L)) and canonical (< p) between operations; coefficient arrays
are (D+1, L). The arithmetic itself is core/ff.py's: each operation moves
the limb axis first, runs the ff wrapper (kernel K1 on a CUDA tensor, its
plain version on a CPU one) and canonicalizes, so the values equal the JAX
package's exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as D
from ..utils import trace
from . import ff
from .field_params import FieldSpec


def _flat(a: torch.Tensor, shape) -> torch.Tensor:
    return a.expand(shape).reshape(-1, shape[-1]).T.contiguous()


def _binary(op, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = np.broadcast_shapes(tuple(a.shape), tuple(b.shape))  # torch's imports sympy (~3 s)
    out = op(spec, _flat(a, shape), _flat(b, shape))
    return ff.canonicalize(spec, out).T.reshape(shape)


def mont_mul(spec: FieldSpec, a, b):
    """(a * b * R^-1) mod p: the product in Montgomery form."""
    return _binary(ff.mont_mul, spec, a, b)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def add(spec: FieldSpec, a, b):
    return _binary(ff.add, spec, a, b)


def sub(spec: FieldSpec, a, b):
    return _binary(ff.sub, spec, a, b)


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def _const(spec: FieldSpec, value: int, device) -> torch.Tensor:
    limbs = ff.ints_to_limbs(spec, [value], mont=False)[0].astype(np.int32)
    trace.count("host_syncs")
    return torch.from_numpy(limbs.copy()).to(device)


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, _const(spec, spec.R2_mod_p, a.device))


def from_mont(spec: FieldSpec, a):
    """Montgomery -> plain limbs: a * 1 * R^-1."""
    return mont_mul(spec, a, _const(spec, 1, a.device))


def zeros(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (spec.n_limbs,), dtype=torch.int32,
                       device=D.resolve(device))


def one_mont(spec: FieldSpec, shape=(), device=None) -> torch.Tensor:
    one = _const(spec, spec.R_mod_p, D.resolve(device))
    return one.expand(tuple(shape) + (spec.n_limbs,)).contiguous()


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def pow(spec: FieldSpec, a, e: int):
    """a^e for a non-negative Python-int exponent (square and multiply, MSB
    first: one ``ff.mont_pow`` launch on a CUDA tensor). An exponent past
    the kernel's 384 bits becomes (e - 1) mod (p - 1) + 1, which leaves
    a^e unchanged for every a, zero included."""
    e = int(e)
    if e >= 1 << (32 * ff.EXP_WORDS):
        e = (e - 1) % (spec.modulus - 1) + 1
    out = ff.mont_pow(spec, a.reshape(-1, spec.n_limbs).T.contiguous(), e)
    return ff.canonicalize(spec, out).T.reshape(a.shape)


def inv(spec: FieldSpec, a):
    """Fermat inverse a^(p-2); inv(0) = 0."""
    return pow(spec, a, spec.modulus - 2)


def from_ints(spec: FieldSpec, xs, mont: bool = True, device=None) -> torch.Tensor:
    """Python int(s) -> limb tensor (L,) or (N, L), Montgomery by default."""
    dev = D.resolve(device)
    trace.count("host_syncs")
    if isinstance(xs, (int, np.integer)):
        return torch.from_numpy(ff.ints_to_limbs(spec, [xs], mont)[0].astype(np.int32)).to(dev)
    arr = ff.ints_to_limbs(spec, list(xs), mont).astype(np.int32)
    return torch.from_numpy(arr).to(dev)


@trace.traced("Serialize::to_host", log=False)
def to_ints(spec: FieldSpec, a: torch.Tensor, mont: bool = True):
    """Limb tensor -> canonical Python ints (an int for (L,), else lists)."""
    trace.count("host_syncs")
    vals = ff.limbs_to_ints(spec, a.reshape(-1, spec.n_limbs).cpu().numpy(), mont)
    if a.dim() == 1:
        return vals[0]
    out = np.empty(a.shape[:-1], dtype=object)
    out.reshape(-1)[:] = vals
    return out.tolist()
