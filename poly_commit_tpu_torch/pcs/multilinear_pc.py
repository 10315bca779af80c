"""MultilinearPC (XZZPD19): a standalone pairing-based multilinear commitment.

Counterpart of poly_commit_tpu/pcs/multilinear_pc.py (the reference's
multilinear_pc/mod.rs):
  setup  mod.rs:28-86   per-level eq-hypercube SRS in G1 and G2
  trim   mod.rs:91-111
  commit mod.rs:114-128 one G1 MSM of the evaluation table (kernel K2a)
  open   mod.rs:131-168 nv fold rounds, one G2 quotient MSM each (K2c)
  check  mod.rs:172-200 one host multi-pairing against g_mask

The level-i SRS scalars are eq-tables of the suffix t[i:]
(core/poly.eq_table); all levels come from one fixed-base batch in G1 and
one in G2 over the concatenated scalars, both on the device (the G2 one on
K2c; the JAX package runs its G2 batch through a portable scan). The
verifier's algebra and the pairing run on host ints. Like the reference,
this scheme is standalone (not a PolynomialCommitment).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import device as D
from ..core import curve as C
from ..core import field as F
from ..core import hostec
from ..core import msm as M
from ..core import poly as P
from ..core.curve import BLS12_381_G1, BLS12_381_G2
from ..core.field_params import FR_BLS12_381
from ..core.serialize import device_point_to_ints, device_points_to_ints
from ..utils.trace import traced
from . import errors, kzg10
from .data_structures import HostRng

G1 = BLS12_381_G1
G2 = BLS12_381_G2
SPEC = FR_BLS12_381
HG1 = hostec.host_group(G1)


@dataclasses.dataclass
class UniversalParams:
    """multilinear_pc/data_structures.rs:10-28."""

    num_vars: int
    g: tuple  # host (x, y, inf)
    h: tuple  # host G2 triple
    g_mask: list  # [g^{t_i}] host triples
    powers_of_g: list  # per level: device G1 affine batch (2^{nv-i},)
    powers_of_h: list  # per level: device G2 affine batch


@dataclasses.dataclass
class CommitterKey:
    nv: int
    g: tuple
    h: tuple
    powers_of_g: list
    powers_of_h: list


@dataclasses.dataclass
class VerifierKey:
    nv: int
    g: tuple
    h: tuple
    g_mask_random: list


@dataclasses.dataclass
class Commitment:
    nv: int
    g_product: tuple  # host triple


@dataclasses.dataclass
class Proof:
    proofs: list  # [host G2 triple] * nv


@traced("MultilinearPC::setup")
def setup(num_vars: int, rng: HostRng | None = None, device=None) -> UniversalParams:
    if num_vars <= 0:
        raise errors.InvalidNumberOfVariables("constant polynomial not supported")
    dev = D.resolve(device)
    rng = rng or HostRng(0)
    g_k = rng.field_int(SPEC)
    h_k = rng.field_int(SPEC)
    t = [rng.field_int(SPEC) for _ in range(num_vars)]

    g = C.scalar_mul_int(G1, G1.generator(dev), g_k)
    h = C.scalar_mul_int(G2, G2.generator(dev), h_k)

    # level-i scalars: eq-table of the suffix t[i:] over 2^{nv-i} points
    td = F.from_ints(SPEC, t, device=dev)
    tables = [P.eq_table(SPEC, td[i:]) for i in range(num_vars)]
    all_scalars = F.from_mont(SPEC, torch.cat(tables, 0))
    del tables

    pp_g = G1.to_affine(M.fixed_base_mul(G1, g, all_scalars))
    pp_h = G2.to_affine(M.fixed_base_mul(G2, h, all_scalars))

    powers_of_g, powers_of_h = [], []
    start = 0
    for i in range(num_vars):
        size = 1 << (num_vars - i)
        powers_of_g.append(tuple(a[start : start + size] for a in pp_g))
        powers_of_h.append(tuple(a[start : start + size] for a in pp_h))
        start += size

    g_mask_pts = G1.to_affine(M.fixed_base_mul(G1, g, M.scalars_from_ints(SPEC, t, dev)))
    return UniversalParams(
        num_vars=num_vars,
        g=device_point_to_ints(G1, g),
        h=device_point_to_ints(G2, h),
        g_mask=device_points_to_ints(G1, G1.from_affine(*g_mask_pts)),
        powers_of_g=powers_of_g,
        powers_of_h=powers_of_h,
    )


def trim(params: UniversalParams, supported_num_vars: int):
    """mod.rs:91-111."""
    assert supported_num_vars <= params.num_vars
    to_reduce = params.num_vars - supported_num_vars
    ck = CommitterKey(nv=supported_num_vars, g=params.g, h=params.h,
                      powers_of_g=params.powers_of_g[to_reduce:],
                      powers_of_h=params.powers_of_h[to_reduce:])
    vk = VerifierKey(nv=supported_num_vars, g=params.g, h=params.h,
                     g_mask_random=params.g_mask[to_reduce:])
    return ck, vk


@traced("MultilinearPC::commit")
def commit(ck: CommitterKey, table: torch.Tensor) -> Commitment:
    """table: (2^nv, L) Montgomery evaluation table (mod.rs:114-128)."""
    nv = int(table.shape[0]).bit_length() - 1
    assert table.shape[0] == 1 << nv
    pt = M.msm_mont(G1, table, ck.powers_of_g[0], assume_distinct=True)
    return Commitment(nv=nv, g_product=device_point_to_ints(G1, pt))


@traced("MultilinearPC::open")
def open(ck: CommitterKey, table: torch.Tensor, point) -> Proof:
    """mod.rs:131-168: nv fold rounds, each with one G2 quotient MSM."""
    nv = ck.nv
    assert table.shape[0] == 1 << nv, "invalid size of polynomial"
    proofs = []
    r = table
    for i in range(nv):
        z = F.from_ints(SPEC, int(point[i]) % SPEC.modulus, device=table.device)
        half = 1 << (nv - i - 1)
        rr = r.reshape(half, 2, SPEC.n_limbs)
        q = F.sub(SPEC, rr[:, 1, :], rr[:, 0, :])  # odd - even
        r = P.mle_fold(SPEC, r, z)
        # scalars[x] = q[x >> 1]: each quotient entry twice
        dup = torch.repeat_interleave(q, 2, dim=0)
        pi_h = M.msm_mont(G2, dup, ck.powers_of_h[i], assume_distinct=True)
        proofs.append(device_point_to_ints(G2, pi_h))
    return Proof(proofs=proofs)


def pairing_inputs(vk: VerifierKey, commitment: Commitment, point, value: int, proof: Proof):
    """The host G1 and G2 triples of check's multi-pairing: (C - v g, h)
    and (z_i g - g_mask_i, pi_i) for each variable."""
    v = int(value) % SPEC.modulus
    g_host = hostec.triple_to_host(vk.g)
    c_minus_v = HG1.sub(hostec.triple_to_host(commitment.g_product), HG1.mul_fast(g_host, v))
    g1s = [hostec.host_to_triple(c_minus_v)]
    g2s = [vk.h]
    for i in range(vk.nv):
        z = int(point[i]) % SPEC.modulus
        lhs = HG1.sub(HG1.mul_fast(g_host, z), hostec.triple_to_host(vk.g_mask_random[i]))
        g1s.append(hostec.host_to_triple(lhs))  # -(g_mask - z g)
        g2s.append(proof.proofs[i])
    return g1s, g2s


@traced("MultilinearPC::check")
def check(vk: VerifierKey, commitment: Commitment, point, value: int, proof: Proof) -> bool:
    """e(C - v g, h) == prod_i e(g_mask_i - z_i g, pi_i) (mod.rs:172-200),
    as one product of nv + 1 pairings == 1 with the right side negated."""
    return kzg10.pairing_product_is_one_host(*pairing_inputs(vk, commitment, point, value, proof))
