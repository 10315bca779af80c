"""Streaming KZG (Gemini): the time prover, the bounded-memory (space)
prover over coefficient chunks, multi-point openings through vanishing
polynomials, and the folded-polynomial tree.

Counterpart of poly_commit_tpu/pcs/streaming_kzg.py (the reference's
streaming_kzg/):
  CommitterKey::new / commit / open / open_multi_points /
  batch_open_multi_points         time.rs:44-152
  VerifierKey::verify             mod.rs:172-189
  VerifierKey::verify_multi_points  mod.rs:197-261
  vanishing_polynomial / linear_combination / powers  mod.rs:279-311
  space prover (streams + ChunkedPippenger)           space.rs:29-136
  FoldedPolynomialTree            data_structures.rs:12-138

The G1 SRS is a device affine batch, the G2 powers host triples, as in the
JAX package. Every division runs in log depth:

  - by X - z (``open``, ``open_chunked``): ``poly.divide_by_linear_int``,
    the point being a host int, its power tables built once a call;
  - by the vanishing polynomial Z = prod_i (X - z_i), in one piece
    (``open_multi_points``): ``poly.long_divide`` (Newton's iteration);
  - by Z over a stream of chunks (``open_multi_points_chunked``,
    ``open_folding_chunked``): each chunk, highest first, goes through m
    Ruffini divisions in a row, one a factor X - z_i, each with its stage's
    carried remainder as the chunk's top coefficient (as ``open_chunked``
    carries its one). Stage i's quotient chunk feeds stage i + 1, the last
    stage's is the chunk of f div Z, and the m carries are the state between
    chunks. At the end f mod Z = r_1 + (X - z_1)(r_2 + (X - z_2)(... r_m))
    from the final carries r_i. The JAX package carries an m-deep window of
    adjusted coefficients instead (``_stream_long_div_chunk``, one scan step
    a coefficient); quotient and remainder are unique, so the proofs and
    remainders are the same.

A chunked prover runs one MSM a chunk: the scalars against the key rows
they meet (the JAX package pads each chunk to the key); where the folding
open's levels meet the same rows, their scalars are added first, so every
base of the MSM is distinct. Chunked and time provers give identical group
elements (the reference's time/space consistency contract, tests.rs:40-83).
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
from .data_structures import HostRng
from .kzg10 import affine_at, pairing_product_is_one_host

G1 = BLS12_381_G1
G2 = BLS12_381_G2
SPEC = FR_BLS12_381
HG1 = hostec.host_group(G1)


@dataclasses.dataclass
class Commitment:
    point: tuple  # host (x, y, inf)


@dataclasses.dataclass
class EvaluationProof:
    point: tuple


@dataclasses.dataclass
class VerifierKey:
    """mod.rs:160-166: G1 powers up to max_eval_points, G2 powers."""

    powers_of_g: tuple  # device affine (max_eval_points,)
    powers_of_g2: list  # host G2 triples (max_eval_points+1)


def _key_msm(coeffs: torch.Tensor, key, lo: int = 0) -> tuple:
    """sum_k coeffs[k] key[lo + k] for Montgomery coeffs (n, L): one G1 MSM
    over the key rows the coefficients meet (SRS rows: distinct bases)."""
    n = coeffs.shape[0]
    if lo + n > key[0].shape[0]:
        raise ValueError(f"{n} coefficients from row {lo} past a key of {key[0].shape[0]}")
    if n == 0:
        return G1.infinity((), key[0].device)
    return M.msm_mont(G1, coeffs, tuple(a[lo : lo + n] for a in key), assume_distinct=True)


def _stream_divide(coeffs: torch.Tensor, points, tables, carries):
    """One chunk (c, L) of a polynomial through the m Ruffini stages by X -
    z_i: returns (the last stage's quotient chunk (c, L), the stages' new
    carries). ``tables``: each point's ``poly.linear_tables``."""
    out = []
    for z, tab, carry in zip(points, tables, carries):
        coeffs, rem = P.divide_by_linear_int(SPEC, torch.cat([coeffs, carry[None]], 0), z, tab)
        out.append(rem)
    return coeffs, out


def _stream_setup(eval_points, n: int, chunk: int, device):
    """Host points, their power tables (chunks of up to ``chunk``
    coefficients and a carry) and zero carries for the m-stage stream of a
    polynomial of n coefficients, which must outdegree Z."""
    pts = [int(v) % SPEC.modulus for v in eval_points]
    if n <= len(pts):
        raise ValueError(f"{n} coefficients do not outdegree {len(pts)} points")
    tables = [P.linear_tables(SPEC, z, chunk + 1, device) if z else None for z in pts]
    return pts, tables, [F.zeros(SPEC, (), device) for _ in pts]


def _stream_remainder(points, carries, device) -> torch.Tensor:
    """f mod Z from the stages' final carries: r_1 + (X - z_1)(r_2 + (X -
    z_2)(... + (X - z_(m-1)) r_m)), (m, L) ascending, on host ints."""
    p = SPEC.modulus
    rs = F.to_ints(SPEC, torch.stack(carries))
    acc = [rs[-1]]
    for z, r in zip(reversed(points[:-1]), reversed(rs[:-1])):
        shifted = [0] + acc  # X acc
        acc = [(s - z * a) % p for s, a in zip(shifted, acc + [0])]
        acc[0] = (acc[0] + r) % p
    return F.from_ints(SPEC, acc, device=device)


@dataclasses.dataclass
class CommitterKey:
    """time.rs:19-63."""

    powers_of_g: tuple  # device affine (max_degree+1,)
    powers_of_g2: list  # host G2 triples (max_eval_points+1)

    @classmethod
    def new(cls, max_degree: int, max_eval_points: int, rng: HostRng | None = None, device=None):
        """Powers of a secret tau in G1 (fixed-base on K2a, tau's powers
        built on the device by doubling) and its first max_eval_points + 1
        powers in G2 (fixed-base on K2c)."""
        dev = D.resolve(device)
        rng = rng or HostRng(0)
        tau = rng.field_int(SPEC)
        g_k = rng.field_int(SPEC)
        g2_k = rng.field_int(SPEC)
        g = C.scalar_mul_int(G1, G1.generator(dev), g_k)
        g2 = hostec.host_point_to_device(G2, hostec.host_group(G2).mul_fast(G2.generator_host(), g2_k),
                                         dev)
        pows = F.from_mont(SPEC, P.powers(SPEC, F.from_ints(SPEC, tau, device=dev), max_degree + 1))
        powers_of_g = G1.to_affine(M.fixed_base_mul(G1, g, pows))
        powers_of_g2 = device_points_to_ints(G2, M.fixed_base_mul(G2, g2, pows[: max_eval_points + 1]))
        return cls(powers_of_g=powers_of_g, powers_of_g2=powers_of_g2)

    def max_eval_points(self) -> int:
        return len(self.powers_of_g2) - 1

    def verifier_key(self) -> VerifierKey:
        n = self.max_eval_points()
        return VerifierKey(powers_of_g=tuple(a[:n] for a in self.powers_of_g),
                           powers_of_g2=self.powers_of_g2)

    # -- commitments -----------------------------------------------------
    @traced("StreamingKZG::commit")
    def commit(self, coeffs: torch.Tensor) -> Commitment:
        """coeffs (D+1, L) Montgomery (time.rs:72-74)."""
        return Commitment(device_point_to_ints(G1, _key_msm(coeffs, self.powers_of_g)))

    def batch_commit(self, polys) -> list:
        return [self.commit(p) for p in polys]

    def commit_chunked(self, coeffs: torch.Tensor, chunk: int) -> Commitment:
        """Bounded-memory commit: one MSM partial a chunk, accumulated on the
        device (the ChunkedPippenger analogue, space.rs:65-95)."""
        acc = G1.infinity((), coeffs.device)
        for s in range(0, coeffs.shape[0], chunk):
            acc = G1.add(acc, _key_msm(coeffs[s : s + chunk], self.powers_of_g, s))
        return Commitment(device_point_to_ints(G1, acc))

    # -- openings ----------------------------------------------------------
    @traced("StreamingKZG::open")
    def open(self, coeffs: torch.Tensor, point: int):
        """Division by X - z (time.rs:104-123). Returns (eval, proof)."""
        quotient, rem = P.divide_by_linear_int(SPEC, coeffs, point)
        w = _key_msm(quotient, self.powers_of_g)
        return int(F.to_ints(SPEC, rem)), EvaluationProof(device_point_to_ints(G1, w))

    @traced("StreamingKZG::open_multi_points")
    def open_multi_points(self, coeffs: torch.Tensor, eval_points) -> EvaluationProof:
        """Divide by the vanishing polynomial (time.rs:126-137)."""
        pts = F.from_ints(SPEC, [int(z) % SPEC.modulus for z in eval_points], device=coeffs.device)
        q, _ = P.long_divide(SPEC, coeffs, P.vanishing_poly(SPEC, pts))
        return EvaluationProof(self.commit(q).point)

    def batch_open_multi_points(self, polys, eval_points, eval_chal: int):
        """RLC by eta powers, then one multi-point open (time.rs:141-152)."""
        if len(eval_points) >= len(self.powers_of_g2):
            raise ValueError(f"{len(eval_points)} points for a key of {self.max_eval_points()}")
        comb = None
        for p, eta in zip(polys, _powers_int(eval_chal, len(polys))):
            scaled = P.scale(SPEC, p, F.from_ints(SPEC, eta, device=p.device))
            comb = scaled if comb is None else P.add(SPEC, comb, scaled)
        return self.open_multi_points(comb, eval_points)

    # -- bounded-memory (space) opens ------------------------------------
    # streaming_kzg/space.rs:65-262: the coefficient stream is a sequence of
    # device chunks from the highest degree down; the carried state is one
    # field element a division stage and one projective accumulator.

    def open_chunked(self, coeffs: torch.Tensor, point: int, chunk: int):
        """Bounded-memory single-point open (space.rs:65-95): each chunk's
        division takes the carried remainder as its top coefficient.
        Returns (evaluation, proof)."""
        z = int(point) % SPEC.modulus
        n, dev = coeffs.shape[0], coeffs.device
        tables = P.linear_tables(SPEC, z, chunk + 1, dev) if z else None
        acc = G1.infinity((), dev)
        carry = F.zeros(SPEC, (), dev)
        for s in reversed(range(0, n, chunk)):
            # w[k] is the quotient coefficient q_(s+k); the top chunk's last
            # one is the zero carry's: q_(n-1) = 0
            w, carry = P.divide_by_linear_int(
                SPEC, torch.cat([coeffs[s : s + chunk], carry[None]], 0), z, tables)
            acc = G1.add(acc, _key_msm(w[: n - 1 - s], self.powers_of_g, s))
        return int(F.to_ints(SPEC, carry)), EvaluationProof(device_point_to_ints(G1, acc))

    def open_multi_points_chunked(self, coeffs: torch.Tensor, eval_points, chunk: int):
        """Bounded-memory multi-point open (space.rs:98-136): division by Z
        through the m-stage Ruffini stream. Returns (remainder (m, L)
        ascending, proof); the proof equals ``open_multi_points``'s."""
        n, dev = coeffs.shape[0], coeffs.device
        pts, tables, carries = _stream_setup(eval_points, n, chunk, dev)
        q_len = n - len(pts)
        acc = G1.infinity((), dev)
        for s in reversed(range(0, n, chunk)):
            q, carries = _stream_divide(coeffs[s : s + chunk], pts, tables, carries)
            acc = G1.add(acc, _key_msm(q[: max(0, q_len - s)], self.powers_of_g, s))
        return _stream_remainder(pts, carries, dev), EvaluationProof(device_point_to_ints(G1, acc))

    def open_folding_chunked(self, coeffs: torch.Tensor, challenges, eval_points, etas,
                             chunk: int):
        """Bounded-memory fold-and-open (space.rs:209-262): one pass over the
        chunks folds each into its pieces of every f^(j) (chunk boundaries
        are multiples of 2^depth, so each level's piece is contiguous),
        divides each piece by Z through level j's m-stage stream, and
        accumulates ONE eta-combined proof, one MSM a chunk.

        Returns ([remainder_j (m, L)], proof) with remainder_j = f^(j) mod Z."""
        p_mod = SPEC.modulus
        depth = len(challenges)
        n, dev = coeffs.shape[0], coeffs.device
        if chunk % (1 << depth) or n % (1 << depth):
            raise ValueError(f"chunk {chunk} and {n} coefficients must be multiples of 2^{depth}")
        pts, tables, zero = _stream_setup(eval_points, n >> depth, chunk // 2, dev)
        m = len(pts)
        rhos = [F.from_ints(SPEC, int(r) % p_mod, device=dev) for r in challenges]
        eta_f = [F.from_ints(SPEC, int(t) % p_mod, device=dev) for t in etas]
        carries = [list(zero) for _ in range(depth)]
        acc = G1.infinity((), dev)
        for s in reversed(range(0, n, chunk)):
            seg = coeffs[s : s + chunk]
            parts = []  # (first key row, eta-scaled quotient chunk)
            for j in range(1, depth + 1):
                seg = F.add(SPEC, seg[0::2], F.mont_mul(SPEC, seg[1::2], rhos[j - 1]))
                q, carries[j - 1] = _stream_divide(seg, pts, tables, carries[j - 1])
                ls = s >> j
                q = q[: max(0, (n >> j) - m - ls)]
                if q.shape[0]:
                    parts.append((ls, F.mont_mul(SPEC, q, eta_f[j - 1])))
            acc = G1.add(acc, self._parts_msm(parts, dev))
        remainders = [_stream_remainder(pts, c, dev) for c in carries]
        return remainders, EvaluationProof(device_point_to_ints(G1, acc))

    def _parts_msm(self, parts, device) -> tuple:
        """sum over (lo, scalars) of the scalars against key rows lo.. as one
        MSM: parts whose rows overlap are added into one buffer first (every
        base of the MSM distinct), the rest concatenated."""
        groups = []  # [lo, hi, members]
        for lo, sc in sorted(parts, key=lambda t: t[0]):
            hi = lo + sc.shape[0]
            if groups and lo < groups[-1][1]:
                groups[-1][1] = max(groups[-1][1], hi)
                groups[-1][2].append((lo, sc))
            else:
                groups.append([lo, hi, [(lo, sc)]])
        if not groups:
            return G1.infinity((), device)
        scalars, rows = [], []
        for lo, hi, members in groups:
            buf = members[0][1]
            if len(members) > 1:
                buf = F.zeros(SPEC, (hi - lo,), device)
                for m_lo, sc in members:
                    o = m_lo - lo
                    buf[o : o + sc.shape[0]] = F.add(SPEC, buf[o : o + sc.shape[0]], sc)
            scalars.append(buf)
            rows.append(torch.arange(lo, hi, device=device))
        if len(groups) == 1:
            return _key_msm(scalars[0], self.powers_of_g, groups[0][0])
        idx = torch.cat(rows)
        key = tuple(a.index_select(0, idx) for a in self.powers_of_g)
        return M.msm_mont(G1, torch.cat(scalars), key, assume_distinct=True)

    # -- Gemini folded tree (data_structures.rs:12-138, space.rs:165-262) --
    def fold_polynomials(self, coeffs: torch.Tensor, challenges) -> list:
        """All log-n foldings f^(j+1) = f^(j)_even + rho_j f^(j)_odd."""
        out = []
        cur = coeffs
        for rho in challenges:
            if cur.shape[0] % 2:
                cur = torch.cat([cur, cur.new_zeros((1, SPEC.n_limbs))], 0)
            rf = F.from_ints(SPEC, int(rho) % SPEC.modulus, device=cur.device)
            cur = F.add(SPEC, cur[0::2], F.mont_mul(SPEC, cur[1::2], rf))
            out.append(cur)
        return out

    def commit_folding(self, coeffs: torch.Tensor, challenges) -> list:
        """Commitments to every folded polynomial (space.rs:165-207)."""
        return [self.commit(f) for f in self.fold_polynomials(coeffs, challenges)]


def _powers_int(x: int, n: int) -> list:
    p = SPEC.modulus
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * x % p
    return out


# ---------------------------------------------------------------------------
# verification (mod.rs:172-261)
# ---------------------------------------------------------------------------


def verify(vk: VerifierKey, commitment: Commitment, alpha: int, evaluation: int,
           proof: EvaluationProof) -> bool:
    """e(C - v g, g2) == e(W, g2^(tau - alpha)). The host multiplications
    run in Jacobian coordinates (the JAX package's affine ``mul``: the same
    points)."""
    p_mod = SPEC.modulus
    hg2 = hostec.host_group(G2)
    g2_0, g2_1 = vk.powers_of_g2[0], vk.powers_of_g2[1]
    ep = hg2.sub(hostec.triple_to_host(g2_1),
                 hg2.mul_fast(hostec.triple_to_host(g2_0), int(alpha) % p_mod))
    lhs = HG1.sub(hostec.triple_to_host(commitment.point),
                  HG1.mul_fast(_g_host(vk), int(evaluation) % p_mod))
    g1s = [hostec.host_to_triple(lhs),
           hostec.host_to_triple(HG1.neg(hostec.triple_to_host(proof.point)))]
    g2s = [g2_0, hostec.host_to_triple(ep, fq2=True)]
    return pairing_product_is_one_host(g1s, g2s)


def verify_multi_points(vk: VerifierKey, commitments, eval_points, evaluations,
                        proof: EvaluationProof, open_chal: int) -> bool:
    """mod.rs:197-261: interpolate the claimed values, pair against the
    vanishing polynomial in G2. The host MSMs run in Jacobian coordinates
    (the same points as the JAX package's affine sums)."""
    p_mod = SPEC.modulus
    dev = vk.powers_of_g[0].device
    pts_dev = F.from_ints(SPEC, [int(z) % p_mod for z in eval_points], device=dev)
    z_poly = P.vanishing_poly(SPEC, pts_dev)  # (m+1, L)
    # MSM(powers_of_g2, z_poly) on the host (m+1 points)
    zeros = hostec.host_group(G2).msm_fast(
        F.to_ints(SPEC, z_poly), [hostec.triple_to_host(t) for t in vk.powers_of_g2])
    etas = _powers_int(int(open_chal) % p_mod, len(evaluations))
    comb = None
    for evals, eta in zip(evaluations, etas):
        ys = F.from_ints(SPEC, [int(v) % p_mod for v in evals], device=dev)
        scaled = P.scale(SPEC, P.lagrange_interpolate(SPEC, pts_dev, ys),
                         F.from_ints(SPEC, eta, device=dev))
        comb = scaled if comb is None else P.add(SPEC, comb, scaled)
    i_host = hostec.triple_to_host(device_point_to_ints(G1, _key_msm(comb, vk.powers_of_g)))
    f_comm = HG1.msm_fast(etas, [hostec.triple_to_host(cm.point) for cm in commitments])
    lhs = HG1.sub(f_comm, i_host)
    g1s = [hostec.host_to_triple(lhs),
           hostec.host_to_triple(HG1.neg(hostec.triple_to_host(proof.point)))]
    g2s = [vk.powers_of_g2[0], hostec.host_to_triple(zeros, fq2=True)]
    return pairing_product_is_one_host(g1s, g2s)


def _g_host(vk: VerifierKey):
    return hostec.triple_to_host(affine_at(G1, vk.powers_of_g, [0])[0])
