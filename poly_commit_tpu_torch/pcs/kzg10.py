"""KZG10 polynomial commitments (the building block of MarlinKZG10).

Counterpart of poly_commit_tpu/pcs/kzg10.py (the reference's
kzg10/mod.rs):
  setup        mod.rs:53-124   fixed-base powers of beta on the device
  commit       mod.rs:157-210  one SRS MSM (+ the hiding MSM)
  open         mod.rs:243-310  witness division + one SRS MSM
  check        mod.rs:314-333  host point algebra + the pairing
  batch_check  mod.rs:337-391  RLC of the openings: two device MSMs

The verifier key's G2 points h and beta_h are host int triples: their only
consumer is the pairing, which runs on the host engines, or on the device
(core/pairing.py, from the triples) under POLY_COMMIT_PAIRING=device
(``pairing_backend``); single-point multiplications in setup and the
verifier's O(1) algebra run on host ints.
Every batched operation runs on the device of the key's tensors, among
them SonicKZG10's G2 powers neg_powers_of_h (setup's fixed-base
multiplication on K2c).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import device as D
from ..core import curve as C
from ..core import field as F
from ..core import msm as M
from ..core import poly as P
from ..core import hostec
from ..core import pairing as PR
from ..core.serialize import device_point_to_ints
from ..parallel import mesh as PM
from ..utils import trace
from ..utils.trace import traced
from . import errors
from .curve_ctx import CTX_BLS12_381, CurveCtx, pairing_backend  # noqa: F401  (JAX's name)
from .data_structures import HostRng


@dataclasses.dataclass
class UniversalParams:
    """kzg10/data_structures.rs:22-39."""

    powers_of_g: tuple  # device affine (x, y, inf), batch (D+1,)
    powers_of_gamma_g: tuple  # batch (D+2,)
    h: tuple  # host G2 triple ((x0, x1), (y0, y1), inf)
    beta_h: tuple
    neg_powers_of_h: Optional[tuple] = None  # device G2 affine, batch (D+1,), for Sonic
    max_degree: int = 0


@dataclasses.dataclass
class Powers:
    """Committer key slice (kzg10/data_structures.rs:124-136)."""

    powers_of_g: tuple
    powers_of_gamma_g: tuple

    def size(self):
        return int(self.powers_of_g[0].shape[0])


@dataclasses.dataclass
class VerifierKey:
    """kzg10/data_structures.rs:187-202."""

    g: tuple  # device G1 affine, batch ()
    gamma_g: tuple
    h: tuple  # host G2 triples
    beta_h: tuple


@dataclasses.dataclass
class Commitment:
    """A single G1 point (kzg10/data_structures.rs:325-328) as host ints."""

    point: tuple  # (x_int, y_int, inf_bool)


@dataclasses.dataclass
class Randomness:
    """Hiding blinding polynomial (kzg10/data_structures.rs:400-436)."""

    blinding_polynomial: Optional[torch.Tensor] = None  # (hb+2, L) or None

    def is_hiding(self):
        return self.blinding_polynomial is not None


@dataclasses.dataclass
class Proof:
    w: tuple  # (x_int, y_int, inf_bool)
    random_v: Optional[int] = None


def _srs_msm(coeffs_mont: torch.Tensor, key, ctx: CurveCtx = CTX_BLS12_381) -> tuple:
    """SRS-sized MSM (kzg10/mod.rs:175,199,255,270); the bases are an SRS,
    so the branch-free mixed add is exact. Under an active mesh
    (``parallel.mesh.use_mesh``, one rank included) the bases and scalars
    are padded and sharded over the mesh axis (``msm_sharded``)."""
    active = PM.active_mesh()
    if active is None:
        return M.msm_mont(ctx.g1, coeffs_mont, key, assume_distinct=True)
    mesh, axis = active
    sc, pts = PM.pad_msm_inputs(ctx.g1, F.from_mont(ctx.spec, coeffs_mont), key, mesh.size(axis))
    return PM.msm_sharded(ctx.g1, sc, pts, mesh, axis=axis, assume_distinct=True)


def host_powers(x: int, n: int, modulus: int) -> list:
    """[1, x, ..., x^(n-1)] mod ``modulus`` on host ints (serial, like
    kzg10/mod.rs:68-73)."""
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * x % modulus
    return out


@traced("KZG10::setup")
def setup(max_degree: int, produce_g2_powers: bool = False, rng: HostRng | None = None,
          ctx: CurveCtx = CTX_BLS12_381, device=None) -> UniversalParams:
    """Sample beta, g, gamma_g, h and build the power tables
    (kzg10/mod.rs:53-124); with ``produce_g2_powers`` also
    neg_powers_of_h[i] = beta^-i h for i <= max_degree (mod.rs:90-104),
    which draws nothing more from ``rng``."""
    g1, spec = ctx.g1, ctx.spec
    dev = D.resolve(device)
    if max_degree < 1:
        raise errors.DegreeIsZero()
    rng = rng or HostRng(0)
    beta = rng.field_int(spec)
    g_k = rng.field_int(spec)
    gamma = rng.field_int(spec)
    h_k = rng.field_int(spec)

    g = C.scalar_mul_int(g1, g1.generator(dev), g_k)
    hg2 = ctx.hg2
    h = hg2.mul_fast(ctx.g2.generator_host(), h_k)

    pows = host_powers(beta, max_degree + 2, spec.modulus)
    sc_g = M.scalars_from_ints(spec, pows[: max_degree + 1], dev)
    sc_gg = M.scalars_from_ints(spec, [x * gamma % spec.modulus for x in pows], dev)
    powers_of_g = g1.to_affine(M.fixed_base_mul(g1, g, sc_g))
    powers_of_gamma_g = g1.to_affine(M.fixed_base_mul(g1, g, sc_gg))
    beta_h = hg2.mul_fast(h, beta)
    neg_powers_of_h = None
    if produce_g2_powers:
        npows = host_powers(pow(beta, -1, spec.modulus), max_degree + 1, spec.modulus)
        h_dev = hostec.host_point_to_device(ctx.g2, h, dev)
        neg_powers_of_h = ctx.g2.to_affine(
            M.fixed_base_mul(ctx.g2, h_dev, M.scalars_from_ints(spec, npows, dev)))
    return UniversalParams(
        powers_of_g=powers_of_g,
        powers_of_gamma_g=powers_of_gamma_g,
        h=hostec.host_to_triple(h, fq2=True),
        beta_h=hostec.host_to_triple(beta_h, fq2=True),
        neg_powers_of_h=neg_powers_of_h,
        max_degree=max_degree,
    )


def trim_powers(pp: UniversalParams, supported_degree: int) -> Powers:
    """Plain slice of the SRS (the test-only helper at kzg10/mod.rs:488-517)."""
    return Powers(
        powers_of_g=tuple(a[: supported_degree + 1] for a in pp.powers_of_g),
        powers_of_gamma_g=tuple(a[: supported_degree + 2] for a in pp.powers_of_gamma_g),
    )


def affine_at(group, points, indices) -> list:
    """Host int triples of a device affine batch's points at ``indices``,
    gathered on the device first, so only those points reach the host
    (trim's shift powers out of a full-size SRS)."""
    trace.count("host_syncs")
    idx = torch.tensor(list(indices), dtype=torch.long, device=points[0].device)
    pts = hostec.device_affine_to_host(group, tuple(a[idx] for a in points))
    return [hostec.host_to_triple(P, fq2=hostec._is_g2(group)) for P in pts]


def vk_from_params(pp: UniversalParams) -> VerifierKey:
    def first(t):
        x, y, inf = t
        return (x[0], y[0], inf[0])

    return VerifierKey(g=first(pp.powers_of_g), gamma_g=first(pp.powers_of_gamma_g),
                       h=pp.h, beta_h=pp.beta_h)


def check_degree_is_too_large(degree: int, num_powers: int):
    """kzg10/mod.rs:424-449 guard."""
    if degree + 1 > num_powers:
        raise errors.TooManyCoefficients(degree + 1, num_powers)


DIVIDE_LOG_DEPTH_MIN = 1024  # below this the Ruffini loop is cheaper


def _divide_auto(spec, coeffs, z_dev, z_int):
    """Witness division: the log-depth form from DIVIDE_LOG_DEPTH_MIN
    coefficients up (core/poly.py::divide_by_linear_int), the Ruffini loop
    below it. Both give the same quotient and remainder."""
    if coeffs.shape[0] >= DIVIDE_LOG_DEPTH_MIN:
        return P.divide_by_linear_int(spec, coeffs, z_int)
    return P.divide_by_linear(spec, coeffs, z_dev)


def _pad_to(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad coefficients to length n (the key's MSM size)."""
    if coeffs.shape[0] < n:
        coeffs = torch.cat([coeffs, coeffs.new_zeros((n - coeffs.shape[0],) + coeffs.shape[1:])], 0)
    return coeffs


@traced("KZG10::commit")
def commit(powers: Powers, coeffs: torch.Tensor, hiding_bound: Optional[int] = None,
           rng: HostRng | None = None, ctx: CurveCtx = CTX_BLS12_381):
    """Commit to a Montgomery coefficient array (D+1, L) (kzg10/mod.rs:157-210).

    Returns (Commitment, Randomness)."""
    spec = ctx.spec
    check_degree_is_too_large(coeffs.shape[0] - 1, powers.size())
    pt = _srs_msm(_pad_to(coeffs, powers.size()), powers.powers_of_g, ctx)
    rand = Randomness()
    if hiding_bound is not None:
        if rng is None:
            raise errors.MissingRng()
        if hiding_bound == 0:
            raise errors.HidingBoundIsZero()
        # blinding poly of degree hiding_bound + 1 (mod.rs:181-206)
        n_blind = hiding_bound + 2
        ng = int(powers.powers_of_gamma_g[0].shape[0])
        if n_blind > ng:
            raise errors.HidingBoundToolarge(hiding_bound + 1, ng)
        ints = rng.field_ints(spec, n_blind)
        if ints[-1] % spec.modulus == 0:
            ints[-1] = 1  # keep the blinding degree exact
        blind = F.from_ints(spec, ints, device=coeffs.device)
        rand = Randomness(blinding_polynomial=blind)
        hpt = _srs_msm(_pad_to(blind, ng), powers.powers_of_gamma_g, ctx)
        pt = ctx.g1.add(pt, hpt)
    return Commitment(point=device_point_to_ints(ctx.g1, pt)), rand


@traced("KZG10::open")
def open(powers: Powers, coeffs: torch.Tensor, point_int: int, rand: Randomness,
         ctx: CurveCtx = CTX_BLS12_381) -> Proof:
    """Single-poly opening proof at a point (kzg10/mod.rs:243-310)."""
    spec = ctx.spec
    check_degree_is_too_large(coeffs.shape[0] - 1, powers.size())
    z = F.from_ints(spec, point_int, device=coeffs.device)
    witness, _ = _divide_auto(spec, coeffs, z, point_int)
    if witness.shape[0] == 0:
        w_pt = ctx.g1.infinity((), coeffs.device)
    else:
        w_pt = _srs_msm(_pad_to(witness, powers.size()), powers.powers_of_g, ctx)
    random_v = None
    if rand.is_hiding():
        bw, brem = P.divide_by_linear(spec, rand.blinding_polynomial, z)
        random_v = F.to_ints(spec, brem)
        if bw.shape[0] > 0:
            ng = int(powers.powers_of_gamma_g[0].shape[0])
            hw = _srs_msm(_pad_to(bw, ng), powers.powers_of_gamma_g, ctx)
            w_pt = ctx.g1.add(w_pt, hw)
    return Proof(w=device_point_to_ints(ctx.g1, w_pt), random_v=random_v)


@traced("KZG10::check")
def check(vk: VerifierKey, comm: Commitment, point_int: int, value_int: int,
          proof: Proof, ctx: CurveCtx = CTX_BLS12_381) -> bool:
    """e(C - v g - rv gamma_g + z w, h) * e(-w, beta_h) == 1
    (kzg10/mod.rs:314-333, arranged so both G2 points are fixed vk
    elements with precomputed Miller lines). Host ints throughout."""
    hg1 = ctx.hg1
    c_h = hostec.triple_to_host(comm.point)
    adj = hg1.sub(c_h, hg1.mul(hostec.triple_to_host(_vk_host(vk, "g", ctx)), value_int))
    if proof.random_v is not None:
        adj = hg1.sub(adj, hg1.mul(hostec.triple_to_host(_vk_host(vk, "gamma_g", ctx)),
                                   proof.random_v))
    w = hostec.triple_to_host(proof.w)
    adj = hg1.add(adj, hg1.mul(w, point_int) if w else None)
    return ctx.pairing_product_is_one(
        [hostec.host_to_triple(adj), hostec.host_to_triple(hg1.neg(w) if w else None)],
        [vk.h, vk.beta_h],
        prepared=[_vk_prepared(vk, "h", ctx), _vk_prepared(vk, "beta_h", ctx)],
    )


@traced("KZG10::batch_check")
def batch_check(vk: VerifierKey, comms, points, values, proofs, rng: HostRng,
                ctx: CurveCtx = CTX_BLS12_381) -> bool:
    """RLC of n openings into one 2-pairing check (kzg10/mod.rs:337-391).
    The two combinations are device MSMs over arbitrary points, so they
    take the complete mixed add."""
    g1, spec = ctx.g1, ctx.spec
    dev = vk.g[0].device
    n = len(comms)
    rs = [1] + [rng.u128() for _ in range(n - 1)]
    # total_c = sum r_i (c_i + z_i w_i - v_i g - rv_i gamma_g); total_w = sum r_i w_i
    g_mult = 0
    gg_mult = 0
    c_pts, c_sc, w_pts, w_sc = [], [], [], []
    for r, cm, z, v, pf in zip(rs, comms, points, values, proofs):
        c_pts.append(cm.point)
        c_sc.append(r)
        w_pts.append(pf.w)
        c_pts.append(pf.w)
        c_sc.append(r * z % spec.modulus)
        w_sc.append(r)
        g_mult = (g_mult + r * v) % spec.modulus
        if pf.random_v is not None:
            gg_mult = (gg_mult + r * pf.random_v) % spec.modulus
    total_c = M.msm(g1, M.scalars_from_ints(spec, c_sc, dev), C.affine_from_ints(g1, c_pts, dev))
    total_c = g1.add(total_c, g1.neg(C.scalar_mul_int(g1, g1.from_affine(*vk.g[:2]), g_mult)))
    total_c = g1.add(total_c, g1.neg(C.scalar_mul_int(g1, g1.from_affine(*vk.gamma_g[:2]), gg_mult)))
    total_w = M.msm(g1, M.scalars_from_ints(spec, w_sc, dev), C.affine_from_ints(g1, w_pts, dev))
    return ctx.pairing_product_is_one(
        [device_point_to_ints(g1, total_c), device_point_to_ints(g1, g1.neg(total_w))],
        [vk.h, vk.beta_h],
        prepared=[_vk_prepared(vk, "h", ctx), _vk_prepared(vk, "beta_h", ctx)],
    )


def _vk_prepared(vk, name: str, ctx: CurveCtx = CTX_BLS12_381):
    """Cached G2 line coefficients of a vk element (PreparedVerifierKey,
    kzg10/data_structures.rs:285-312); derived, never persisted."""
    cache = vk.__dict__.setdefault("_prep_cache", {})
    if name not in cache:
        cache[name] = ctx.prepare_g2(getattr(vk, name))
    return cache[name]


def _vk_host(vk, name: str, ctx: CurveCtx = CTX_BLS12_381):
    """A G1 vk element as a host int triple (cached on the vk)."""
    cache = vk.__dict__.setdefault("_host_cache", {})
    if name not in cache:
        x, y, inf = getattr(vk, name)
        cache[name] = device_point_to_ints(ctx.g1, ctx.g1.from_affine(x, y, inf))
    return cache[name]


def pairing_product_is_one_host(g1_triples, g2_triples, ctx: CurveCtx = CTX_BLS12_381) -> bool:
    """prod e(P_i, Q_i) == 1 from host int triples, on the backend
    ``pairing_backend`` names (``CurveCtx.pairing_product_is_one``)."""
    return ctx.pairing_product_is_one(g1_triples, g2_triples)


def pairing_check_padded(p_aff, q_aff) -> bool:
    """core/pairing.py's pairing_check under the JAX package's name; infinite
    pairs give f = 1. The JAX package pads the pair axis to a multiple of 4
    so that its schemes share compiled programs; nothing is compiled here."""
    return bool(PR.pairing_check(p_aff, q_aff))
