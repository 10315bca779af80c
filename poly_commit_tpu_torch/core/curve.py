"""The device groups: G1 and G2 of the pairing curves, BN254's G1, and JubJub.

Counterpart of poly_commit_tpu/core/curve.py. Points are tuples of
limbs-last int32 tensors: Jacobian (X, Y, Z) with Z == 0 at infinity for
the Weierstrass groups (coordinates (..., L) in G1, (..., 2, L) Fq2 pairs in
G2), extended (X, Y, Z, T) with identity (0, 1, 1, 0) for JubJub; affine
points are (x, y, inf). Group operations flatten the batch to the
limbs-first layout and run core/ec_lf.py: kernel K2a for G1, K2c for G2,
K2b for JubJub (its scalar multiplication one ``ed_smul`` launch) on CUDA
tensors. Normalisation runs a batched inversion
(kernel K1). Every coordinate these methods return is canonical (< p).
Each group keeps its generator as host ints too; Marlin's verifier key
keeps its G2 points h and beta_h as host triples.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ec_lf as EC
from . import extfield as E2
from . import ff
from . import field as F
from . import field_params as FP
from . import hostec
from .field_params import FieldSpec
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class WeierstrassGroup:
    """y^2 = x^3 + b over the base field ``spec`` (a = 0)."""

    name: str
    spec: FieldSpec  # base field Fq
    scalar_spec: FieldSpec
    b_int: int
    gen_x: int
    gen_y: int

    def infinity(self, shape=(), device=None):
        return (F.zeros(self.spec, shape, device), F.one_mont(self.spec, shape, device),
                F.zeros(self.spec, shape, device))

    def is_infinity(self, p):
        return F.is_zero(p[2])

    def from_affine(self, x, y, inf=None):
        z = F.one_mont(self.spec, x.shape[:-1], x.device)
        if inf is not None:
            z = torch.where(inf.unsqueeze(-1), torch.zeros_like(z), z)
        return (x, y, z)

    def generator(self, device=None):
        return self.from_affine(F.from_ints(self.spec, self.gen_x, device=device),
                                F.from_ints(self.spec, self.gen_y, device=device))

    def select(self, mask, p, q):
        return tuple(torch.where(mask.unsqueeze(-1), a, b) for a, b in zip(p, q))

    def neg(self, p):
        return (p[0], F.neg(self.spec, p[1]), p[2])

    def _lf(self, p, shape):
        return tuple(ff.from_field_last(c.expand(shape + (self.spec.n_limbs,))) for c in p)

    def _fl(self, coords, shape):
        return tuple(ff.to_field_last(ff.canonicalize(self.spec, c), shape) for c in coords)

    def add(self, p, q):
        """Complete Jacobian addition (kernel K2a ``add``)."""
        shape = np.broadcast_shapes(tuple(p[0].shape[:-1]), tuple(q[0].shape[:-1]))
        out = EC.add(self.spec, self._lf(p, shape), self._lf(q, shape))
        return self._fl(out, shape)

    def to_affine(self, p):
        """(x, y, inf) by one batched inversion of Z on the device."""
        from .msm_gpu import jacobian_to_affine

        shape = tuple(p[0].shape[:-1])
        x, y = jacobian_to_affine(self.spec, self._lf(p, shape))
        return (*self._fl((x, y), shape), self.is_infinity(p))


@dataclasses.dataclass(frozen=True)
class G2Group:
    """y^2 = x^3 + b' over Fq2 = Fq[u]/(u^2 - nr) (the twist; a = 0).
    Coordinates are (..., 2, L) (c0, c1) pairs; the host generator and b'
    are (c0, c1) int pairs."""

    name: str
    spec: FieldSpec  # base field Fq
    scalar_spec: FieldSpec
    b: tuple
    gen_x: tuple
    gen_y: tuple

    def generator_host(self):
        return (self.gen_x, self.gen_y)

    def infinity(self, shape=(), device=None):
        return (E2.zeros(self.spec, shape, device), E2.one(self.spec, shape, device),
                E2.zeros(self.spec, shape, device))

    def is_infinity(self, p):
        return E2.is_zero(p[2])

    def from_affine(self, x, y, inf=None):
        z = E2.one(self.spec, x.shape[:-2], x.device)
        if inf is not None:
            z = torch.where(inf[..., None, None], torch.zeros_like(z), z)
        return (x, y, z)

    def generator(self, device=None):
        return self.from_affine(E2.from_int(self.spec, self.gen_x, device),
                                E2.from_int(self.spec, self.gen_y, device))

    def select(self, mask, p, q):
        return tuple(torch.where(mask[..., None, None], a, b) for a, b in zip(p, q))

    def neg(self, p):
        return (p[0], E2.neg(self.spec, p[1]), p[2])

    def add(self, p, q):
        """Complete Jacobian addition (kernel K2c ``g2_add``)."""
        shape = np.broadcast_shapes(tuple(p[0].shape[:-2]), tuple(q[0].shape[:-2]))
        full = shape + (2, self.spec.n_limbs)
        out = EC.g2_add(self.spec, tuple(E2.to_lf(c.expand(full)) for c in p),
                        tuple(E2.to_lf(c.expand(full)) for c in q))
        return tuple(E2.from_lf(E2.canonicalize_lf(self.spec, c), shape) for c in out)

    def to_affine(self, p):
        """(x, y, inf) by one batched inversion of Z on the device."""
        from .msm_gpu import jacobian_to_affine_fq2

        shape = tuple(p[0].shape[:-2])
        x, y = jacobian_to_affine_fq2(self.spec, tuple(E2.to_lf(c) for c in p))
        return (E2.from_lf(E2.canonicalize_lf(self.spec, x), shape),
                E2.from_lf(E2.canonicalize_lf(self.spec, y), shape), self.is_infinity(p))


@dataclasses.dataclass(frozen=True)
class EdwardsGroup:
    """a x^2 + y^2 = 1 + d x^2 y^2 with a = -1 (JubJub), extended
    coordinates; the unified addition is complete, so no masks are needed."""

    name: str
    spec: FieldSpec  # base field (Fr-381 for JubJub)
    scalar_spec: FieldSpec
    d_int: int
    gen_x: int
    gen_y: int

    def infinity(self, shape=(), device=None):  # the identity
        one = F.one_mont(self.spec, shape, device)
        return (F.zeros(self.spec, shape, device), one, one.clone(),
                F.zeros(self.spec, shape, device))

    def is_infinity(self, p):
        return F.is_zero(p[0]) & (p[1] == p[2]).all(-1)

    def from_affine(self, x, y, inf=None):
        shape = tuple(x.shape[:-1])
        xl, yl = ff.from_field_last(x), ff.from_field_last(y)
        mask = None if inf is None else inf.reshape(-1)
        out = EC.ed_from_affine(self.spec, xl, yl, mask)
        return self._fl(out, shape)

    def generator(self, device=None):
        return self.from_affine(F.from_ints(self.spec, self.gen_x, device=device),
                                F.from_ints(self.spec, self.gen_y, device=device))

    def select(self, mask, p, q):
        return tuple(torch.where(mask.unsqueeze(-1), a, b) for a, b in zip(p, q))

    def neg(self, p):
        return (F.neg(self.spec, p[0]), p[1], p[2], F.neg(self.spec, p[3]))

    def _lf(self, p, shape):
        return tuple(ff.from_field_last(c.expand(shape + (self.spec.n_limbs,))) for c in p)

    def _fl(self, coords, shape):
        return tuple(ff.to_field_last(ff.canonicalize(self.spec, c), shape) for c in coords)

    def add(self, p, q):
        """Unified addition (kernel K2b ``ed_add``)."""
        shape = np.broadcast_shapes(tuple(p[0].shape[:-1]), tuple(q[0].shape[:-1]))
        return self._fl(EC.ed_add(self.spec, self._lf(p, shape), self._lf(q, shape)), shape)

    def scalar_mul(self, p, k: int):
        """k p for one Python-int scalar 0 <= k < 2^256 shared by every
        lane: one K2b ``ed_smul`` launch, MSB first over k's bits, a unified
        doubling per bit and an addition per set bit, on the limbs-first
        layout (the same group element as the JAX package's per-bit select,
        which also adds where the bit is 0)."""
        shape = tuple(p[0].shape[:-1])
        return self._fl(EC.ed_smul(self.spec, self._lf(p, shape), int(k)), shape)

    def to_affine(self, p):
        """(x, y, inf): x/z, y/z by one batched inversion on the device."""
        shape = tuple(p[0].shape[:-1])
        x, y, z, _ = self._lf(p, shape)
        zi = ff.batch_inv(self.spec, z)
        ax, ay = ff.mont_mul(self.spec, x, zi), ff.mont_mul(self.spec, y, zi)
        return (*self._fl((ax, ay), shape), self.is_infinity(p))


def affine_from_ints(group, triples, device=None):
    """[(x, y, inf)] Python-int affine points -> device (x, y, inf) tensors
    (x, y (N, L); in G2 (N, 2, L) from (c0, c1) pairs)."""
    xs = [t[0] for t in triples]
    ys = [t[1] for t in triples]
    inf = torch.from_numpy(np.asarray([bool(t[2]) for t in triples], dtype=bool))
    conv = E2.from_ints if isinstance(group, G2Group) else F.from_ints
    x = conv(group.spec, xs, device=device)
    trace.count("host_syncs")
    return (x, conv(group.spec, ys, device=device), inf.to(x.device))


def scalar_mul_int(group: WeierstrassGroup, p, k: int):
    """p * k for one point and a Python-int scalar, on host big ints (a
    single point: setup's g, the verifier's O(1) algebra)."""
    k = int(k) % group.scalar_spec.modulus
    hp = hostec.device_proj_to_host(group, p)
    res = None if hp is None else hostec.host_group(group).mul_fast(hp, k)
    return hostec.host_point_to_device(group, res, p[0].device)


BLS12_381_G1 = WeierstrassGroup(
    name="bls12_381_g1",
    spec=FP.FQ_BLS12_381,
    scalar_spec=FP.FR_BLS12_381,
    b_int=FP.BLS12_381_B,
    gen_x=FP.BLS12_381_G1_X,
    gen_y=FP.BLS12_381_G1_Y,
)

BLS12_377_G1 = WeierstrassGroup(
    name="bls12_377_g1",
    spec=FP.FQ_BLS12_377,
    scalar_spec=FP.FR_BLS12_377,
    b_int=FP.BLS12_377_B,
    gen_x=FP.BLS12_377_G1_X,
    gen_y=FP.BLS12_377_G1_Y,
)

BN254_G1 = WeierstrassGroup(
    name="bn254_g1",
    spec=FP.FQ_BN254,
    scalar_spec=FP.FR_BN254,
    b_int=FP.BN254_B,
    gen_x=FP.BN254_G1_X,
    gen_y=FP.BN254_G1_Y,
)

BLS12_381_G2 = G2Group(
    name="bls12_381_g2",
    spec=FP.FQ_BLS12_381,
    scalar_spec=FP.FR_BLS12_381,
    b=(4, 4),  # b' = 4 (1 + u)
    gen_x=FP.BLS12_381_G2_X,
    gen_y=FP.BLS12_381_G2_Y,
)

BLS12_377_G2 = G2Group(
    name="bls12_377_g2",
    spec=FP.FQ_BLS12_377,
    scalar_spec=FP.FR_BLS12_377,
    b=FP.BLS12_377_G2_B,  # D-twist: b' = b / xi
    gen_x=FP.BLS12_377_G2_X,
    gen_y=FP.BLS12_377_G2_Y,
)

JUBJUB = EdwardsGroup(
    name="jubjub",
    spec=FP.JUBJUB_FQ,
    scalar_spec=FP.FR_JUBJUB,
    d_int=FP.JUBJUB_D,
    gen_x=FP.JUBJUB_G_X,
    gen_y=FP.JUBJUB_G_Y,
)
