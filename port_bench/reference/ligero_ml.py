"""The reference for multilinear Ligero requests over BN254 Fr: the
commitment (its dimensions, the encoded matrix, the Merkle root), every
field of each opening proof, and the opened values.

The dimensions follow arkworks' ``ligero.rs:118-128`` and
``utils.rs:156-184``: t opened columns for 2^-sec_param soundness at the
distance (rho_inv - 1) / rho_inv, a matrix of 2^k rows (the power of two
at or above sqrt(2 n / t)) and n / rows columns, each row Reed-Solomon
encoded to the power of two at or above rho_inv x columns points. The
evaluations e[row x columns + column] form M, regenerated from the seed.

The encoded matrix E that the request returned (Montgomery forms, undone
here by a word-by-word Montgomery reduction) is checked by a random row
combination with 128-bit weights w drawn by the reference: w^T E must
equal the radix-2 NTT of w^T M, zero-padded, over the reference's own root
of unity (5^((r - 1) / 2^28) of ark-bn254, raised to the domain's size), so
a wrong E passes with probability at most 2^-128. Each leaf is Blake2s of
its column's canonical 32-byte little-endian ints, the tree two-to-one
SHA-256; root and paths come from the reference's own tree. The opening is
replayed on the reference's Poseidon sponge: the root, the row challenges
r, the well-formedness row r^T M, the point, v = b^T M, the column indices;
the value is checked as <v, a> and as the multilinear extension at the
point, summed rows first. Every comparison is exact.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .. import inputs, seeds
from . import limbs
from .curves import CURVES
from .poseidon import FULL_ROUNDS, PARTIAL_ROUNDS, Sponge

GENERATOR = 5  # ark-bn254 Fr's multiplicative generator
LIMB_MASK = (1 << limbs.LIMB_BITS) - 1
REDC_CHUNK = 1 << 20  # elements a step of the Montgomery reduction


class FastSponge(Sponge):
    """``Sponge`` with its permutation written out on locals: the same
    states, about twice as fast, for an opening's ~17,000 permutations."""

    def _permute(self):
        p = self.p
        (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = self.mds
        full_lo, full_hi = FULL_ROUNDS // 2, FULL_ROUNDS // 2 + PARTIAL_ROUNDS
        a, b, c = self.state
        for r, (k0, k1, k2) in enumerate(self.ark):
            a = pow(a + k0, 17, p)
            if r < full_lo or r >= full_hi:
                b, c = pow(b + k1, 17, p), pow(c + k2, 17, p)
            else:
                b, c = b + k1, c + k2
            a, b, c = ((m00 * a + m01 * b + m02 * c) % p, (m10 * a + m11 * b + m12 * c) % p,
                       (m20 * a + m21 * b + m22 * c) % p)
        self.state = [a, b, c]

    def squeeze_bytes(self, n: int) -> bytes:
        """n bytes from the low num_bits - 1 bits of each squeezed element,
        least significant first."""
        per = self.p.bit_length() - 1
        elems = self.squeeze_field(-(-8 * n // per))
        value = sum(e % (1 << per) << (i * per) for i, e in enumerate(elems))
        return (value % (1 << (8 * n))).to_bytes(n, "little")


def calculate_t(sec_param: int, rho_inv: int, codeword_len: int, field_bits: int) -> int:
    """utils.rs:156-184: the least t with (1 - delta/2)^t below
    2^-sec_param less the residual, delta = (rho_inv - 1) / rho_inv, at most
    the codeword's length."""
    nom = math.log2(2.0 ** -sec_param - codeword_len / 2.0 ** field_bits) - 1.0
    denom = math.log2(1.0 - 0.5 * (rho_inv - 1) / rho_inv)
    return min(math.ceil(nom / denom), codeword_len)


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def dimensions(cfg: dict, poly_len: int) -> tuple:
    """(rows, columns, encoded columns, t) of a polynomial of ``poly_len``
    evaluations (ligero.rs:118-128)."""
    bits = CURVES[cfg["curve"]].r.bit_length()
    t_rows = calculate_t(cfg["sec_param"], cfg["rho_inv"], poly_len, bits)
    rows = next_pow2(math.ceil(math.sqrt(-(-2 * poly_len // t_rows))))
    cols = -(-poly_len // rows)
    ext = max(2, next_pow2(cols * cfg["rho_inv"]))
    return rows, cols, ext, calculate_t(cfg["sec_param"], cfg["rho_inv"], ext, bits)


def root_of_unity(r: int, n: int) -> int:
    """The 2^k-th root of unity of ark-bn254's radix-2 domain of n = 2^k
    points: the two-adic root 5^((r - 1) / 2^s), squared s - k times."""
    s = ((r - 1) & -(r - 1)).bit_length() - 1
    return pow(pow(GENERATOR, (r - 1) >> s, r), 1 << (s - (n.bit_length() - 1)), r)


def ntt(values: list, r: int) -> list:
    """The evaluations of sum_j values[j] X^j at w^0 .. w^(n-1), n =
    len(values) a power of two: radix-2 decimation in time."""
    n = len(values)
    bits = n.bit_length() - 1
    a = [values[int(format(i, f"0{bits}b")[::-1], 2) if bits else 0] for i in range(n)]
    w_n = root_of_unity(r, n)
    half = 1
    while half < n:
        w = pow(w_n, n // (2 * half), r)
        ws = [1] * half
        for k in range(1, half):
            ws[k] = ws[k - 1] * w % r
        for start in range(0, n, 2 * half):
            for k in range(half):
                u, v = a[start + k], a[start + k + half] * ws[k] % r
                a[start + k], a[start + k + half] = (u + v) % r, (u - v) % r
        half *= 2
    return a


def from_montgomery(a: torch.Tensor, modulus: int) -> torch.Tensor:
    """(N, L) 16-bit limbs of x R mod p (any value below R = 2^(16 L)) ->
    (N, L) int64 limbs of the canonical x: word-by-word Montgomery
    reduction, then one conditional subtraction of p."""
    n_limbs = a.shape[1]
    p_limbs = torch.tensor([(modulus >> (16 * k)) & LIMB_MASK for k in range(n_limbs)],
                           dtype=torch.int64, device=a.device)
    p_inv = -pow(modulus, -1, 1 << 16) % (1 << 16)
    out = []
    for chunk in a.split(REDC_CHUNK):
        t = torch.zeros((chunk.shape[0], 2 * n_limbs + 1), dtype=torch.int64, device=a.device)
        t[:, :n_limbs] = chunk.to(torch.int64)
        for i in range(n_limbs):  # t += m p with t's limb i then 0 mod 2^16; its carry moves up
            m = (t[:, i] * p_inv) & LIMB_MASK
            t[:, i:i + n_limbs] += m[:, None] * p_limbs
            t[:, i + 1] += t[:, i] >> 16
        v = t[:, n_limbs:]
        for k in range(n_limbs):
            v[:, k + 1] += v[:, k] >> 16
            v[:, k] &= LIMB_MASK
        d = v.clone()
        d[:, :n_limbs] -= p_limbs
        for k in range(n_limbs):
            borrow = (d[:, k] < 0).to(torch.int64)
            d[:, k] += borrow << 16
            d[:, k + 1] -= borrow
        out.append(torch.where((d[:, n_limbs] >= 0)[:, None], d, v)[:, :n_limbs])
    return torch.cat(out)


def limb_bytes(a: torch.Tensor) -> np.ndarray:
    """(..., L) canonical 16-bit limbs -> (..., 2 L) uint8: each element's
    little-endian bytes."""
    return a.to(torch.int32).cpu().numpy().astype("<u2").view(np.uint8)


def to_ints(a: torch.Tensor) -> list:
    """(n, L) canonical limbs -> n ints."""
    raw = limb_bytes(a).tobytes()
    size = 2 * a.shape[-1]
    return [int.from_bytes(raw[i:i + size], "little") for i in range(0, len(raw), size)]


def merkle_levels(leaves: list) -> list:
    """The levels of a two-to-one SHA-256 tree over a power of two of
    leaves, the leaves first."""
    if len(leaves) & (len(leaves) - 1):
        raise ValueError(f"{len(leaves)} leaves: not a power of two")
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        level = levels[-1]
        levels.append([hashlib.sha256(level[i] + level[i + 1]).digest()
                       for i in range(0, len(level), 2)])
    return levels


def siblings(levels: list, index: int) -> list:
    return [level[(index >> d) ^ 1] for d, level in enumerate(levels[:-1])]


def eq_tensor(point: list, r: int) -> list:
    """eq(point, b) over b in {0,1}^n, variable i at bit i of the index."""
    t = [1]
    for z in point:
        t = [v * (1 - z) % r for v in t] + [v * z % r for v in t]
    return t


def _encoded(m_mat, ext_mat, weights, rinv, r):
    """(E's canonical limbs (rows, ext, L), or None where E has the wrong
    shape or limbs; whether w^T E equals the NTT of w^T M)."""
    rows, _, n_limbs = m_mat.shape
    if (not isinstance(ext_mat, torch.Tensor) or ext_mat.dim() != 3
            or ext_mat.shape[0] != rows or ext_mat.shape[2] != n_limbs):
        return None, False
    ext_mat = ext_mat.to(m_mat.device)
    if bool(((ext_mat < 0) | (ext_mat > LIMB_MASK)).any()):
        return None, False
    ext = ext_mat.shape[1]
    canon = from_montgomery(ext_mat.reshape(-1, n_limbs), r).reshape(rows, ext, n_limbs)
    wm = [u * rinv % r for u in limbs.weighted_sums(m_mat.transpose(0, 1), weights, r)]
    want = ntt(wm + [0] * (ext - len(wm)), r)
    return canon, limbs.weighted_sums(canon.transpose(0, 1), weights, r) == want


def check(cfg: dict, traffic: dict, seed: int, plan, outputs: dict, device) -> tuple:
    """(wrong, checked) over request ``plan``'s outputs."""
    curve = CURVES[cfg["curve"]]
    r, n_limbs = curve.r, curve.limbs
    rinv = pow(1 << (16 * n_limbs), -1, r)
    weights_rng = seeds.HostRng(seeds.derive(seed, "reference", "column weights", plan.index))
    wanted, got, state = {}, {}, {}
    for poly in plan.polys():
        label = poly.label
        rows, cols, ext, t = dimensions(cfg, poly.size)
        evals = inputs.field_limbs(r, poly.size, inputs.poly_seed(seed, plan.index, label), device)
        evals = torch.cat([evals, evals.new_zeros((rows * cols - poly.size, n_limbs))])
        m_mat = evals.reshape(rows, cols, n_limbs)
        weights = [weights_rng.u128() for _ in range(rows)]
        canon, combination = _encoded(m_mat, outputs["encoded"].get(label), weights, rinv, r)
        wanted[("encoded", label)] = True
        got[("encoded", label)] = combination
        wanted[("metadata", label)] = (rows, cols, ext)
        got[("metadata", label)] = tuple(outputs["commitments"][label]["metadata"])
        levels = None
        if canon is not None and canon.shape[1] == ext:
            by_col = limb_bytes(canon.transpose(0, 1)).reshape(ext, -1)
            levels = merkle_levels([hashlib.blake2s(col.tobytes()).digest() for col in by_col])
        wanted[("root", label)] = levels[-1][0] if levels else "no tree"
        got[("root", label)] = outputs["commitments"][label]["root"]
        state[label] = (m_mat, canon, levels, ext, t)

    if plan.points is not None:
        sponge = FastSponge(r)  # batch_open hands one transcript to every group
        for gi, (_, point, labels) in enumerate(plan.groups()):
            point = [int(z) % r for z in point]
            for j, label in enumerate(labels):
                m_mat, canon, levels, ext, t = state[label]
                rows, cols = m_mat.shape[:2]
                split = cols.bit_length() - 1
                a, b = eq_tensor(point[:split], r), eq_tensor(point[split:], r)
                row_values = [u * rinv % r for u in limbs.weighted_sums(m_mat, a, r)]
                value = sum(x * y for x, y in zip(b, row_values)) % r
                wanted[("value", label)] = value
                sponge.absorb_bytes(levels[-1][0] if levels else b"")
                proof = {}
                if cfg["check_well_formedness"]:
                    challenges = sponge.squeeze_field(rows)
                    proof["well_formedness"] = [u * rinv % r for u in limbs.weighted_sums(
                        m_mat.transpose(0, 1), challenges, r)]
                    sponge.absorb_field(proof["well_formedness"])
                sponge.absorb_field(point)
                proof["v"] = [u * rinv % r
                              for u in limbs.weighted_sums(m_mat.transpose(0, 1), b, r)]
                sponge.absorb_field(proof["v"])
                nbytes = -(-ext.bit_length() // 8)
                indices = []
                for _ in range(t):
                    raw = sponge.squeeze_bytes(nbytes)
                    sponge.absorb_bytes(raw)
                    indices.append(int.from_bytes(raw, "big") % ext)
                if levels:
                    picked = to_ints(canon[:, torch.tensor(indices, device=canon.device)]
                                     .transpose(0, 1).reshape(-1, n_limbs))
                    proof["columns"] = [picked[k:k + rows] for k in range(0, len(picked), rows)]
                    proof["paths"] = [(i, siblings(levels, i)) for i in indices]
                else:
                    proof["columns"] = proof["paths"] = "no tree"
                for name, v in proof.items():
                    wanted[(name, gi, j)] = v
                pf = outputs["proofs"][gi][j]
                got[("v", gi, j)] = [int(x) % r for x in pf["v"]]
                got[("well_formedness", gi, j)] = (None if pf["well_formedness"] is None
                                                   else [int(x) % r for x in pf["well_formedness"]])
                got[("columns", gi, j)] = [[int(x) for x in col] for col in pf["columns"]]
                got[("paths", gi, j)] = [(int(i), list(s)) for i, s in pf["paths"]]
                wanted[("value as <v, a>", label)] = value
                got[("value as <v, a>", label)] = sum(int(x) * y for x, y in zip(pf["v"], a)) % r
        for label, v in outputs["values"].items():
            got[("value", label)] = int(v) % r
    wrong = sum(1 for key, value in wanted.items() if got.get(key, "missing") != value)
    return wrong, len(wanted)
