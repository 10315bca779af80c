"""The reference for Hyrax requests over BN254 G1: the row commitments and
every field of each opening proof, with the opened values.

The generators G_0..G_{dim-1} and H are hashed to the curve again (Blake2s
of "Hyrax protocol" and the index, y the root of x^3 + 3 chosen by the
hash's low bit). The evaluations e[c dim + r] form M[r, c]; row r commits
to sum_c M[r, c] G_c + t_r H with t_r replayed from the commit rng. All
2^(nv/2) row commitments are checked at once against a random combination
with 128-bit weights w_r drawn by the reference: sum_r w_r C_r must equal
sum_c (sum_r w_r M[r, c]) G_c + (sum_r w_r t_r) H, which a wrong row
commitment fails but with probability 2^-128. An opening at
x = (x_row, x_col) is replayed in full: lt = l^T M with l, rr the eq tensors
of the two halves, the masks d, r_eval, r_d, r_b from the open rng, the
challenge from the Poseidon transcript over the key, the row commitments,
the point and the three commitments; z, z_d, z_b, com_eval, com_d, com_b
and the value <lt, rr> are compared exactly.
"""

from __future__ import annotations

import functools
import hashlib

from .. import inputs, seeds
from . import ec, limbs
from .curves import CURVES
from .poseidon import Sponge

PROTOCOL_NAME = b"Hyrax protocol"


def _hash_to_curve(curve, seed: bytes):
    p = curve.q
    j = 0
    while True:
        h = hashlib.blake2s(seed + j.to_bytes(8, "little")).digest()
        x = int.from_bytes(h, "little") % p
        rhs = (x * x * x + curve.b) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            if h[0] & 1:
                y = (p - y) % p
            return x, y
        j += 1


@functools.lru_cache(maxsize=2)
def generators(curve_name: str, dim: int):
    """(G_0..G_{dim-1}, H)."""
    curve = CURVES[curve_name]
    pts = [_hash_to_curve(curve, PROTOCOL_NAME + i.to_bytes(8, "little")) for i in range(dim + 1)]
    return pts[:dim], pts[dim]


def point_bytes(curve, a) -> bytes:
    """Compressed: x little-endian, then a flag byte (1 at infinity, 2 when
    y is the larger root)."""
    size = (curve.q.bit_length() + 7) // 8
    if a is None:
        return bytes(size) + b"\x01"
    x, y = a
    return x.to_bytes(size, "little") + bytes([2 if y > curve.q - y else 0])


def eq_tensor(point: list, r: int) -> list:
    """eq(point, b) over b in {0,1}^n, variable i at bit i of the index."""
    t = [1]
    for z in point:
        t = [v * (1 - z) % r for v in t] + [v * z % r for v in t]
    return t


def _point(triple):
    x, y, inf = triple
    return None if inf else (int(x), int(y))


def check(cfg: dict, traffic: dict, seed: int, plan, outputs: dict, device) -> tuple:
    """(wrong, checked) over request ``plan``'s outputs."""
    curve = CURVES[cfg["curve"]]
    r, q = curve.r, curve.q
    nv = cfg["num_vars"]
    dim = 1 << (nv // 2)
    rinv = pow(1 << (16 * curve.limbs), -1, r)
    gens, h = generators(curve.name, dim)
    fr = seeds.Field(r)
    commit_rng = seeds.HostRng(seeds.derive(seed, "commit", plan.index))
    weights_rng = seeds.HostRng(seeds.derive(seed, "reference", "row weights", plan.index))

    wanted, got, mats, rands = {}, {}, {}, {}
    for label in plan.labels():
        evals = inputs.field_limbs(r, dim * dim, inputs.poly_seed(seed, plan.index, label), device)
        mat_t = evals.reshape(dim, dim, curve.limbs)  # [c, r] = M[r, c]
        mats[label] = mat_t
        rand = commit_rng.field_ints(fr, dim)
        rands[label] = rand
        weights = [weights_rng.u128() for _ in range(dim)]
        cols = [u * rinv % r for u in limbs.weighted_sums(mat_t, weights, r)]
        row_coms = [_point(t) for t in outputs["commitments"][label]]
        lhs = ec.msm(q, row_coms, weights) if len(row_coms) == dim else "missing"
        rhs = ec.add_affine(q, ec.msm(q, gens, cols),
                            ec.mul(q, h, sum(w * t for w, t in zip(weights, rand)) % r))
        wanted[("commitment", label)] = rhs
        got[("commitment", label)] = lhs

    if plan.points is not None:
        open_rng = seeds.HostRng(seeds.derive(seed, "open", plan.index))
        sponge = Sponge(r)  # batch_open hands one transcript to every group
        for gi, (_, point, labels) in enumerate(plan.groups()):
            point = [int(v) % r for v in point]
            el = eq_tensor(point[:nv // 2], r)
            er = eq_tensor(point[nv // 2:], r)
            for j, label in enumerate(labels):
                lt = [v * rinv % r for v in limbs.weighted_sums(mats[label], el, r)]
                r_lt = sum(a * b for a, b in zip(el, rands[label])) % r
                value = sum(a * b for a, b in zip(lt, er)) % r
                wanted[("value", label)] = value
                r_eval = open_rng.field_int(fr)
                d = open_rng.field_ints(fr, dim)
                r_d = open_rng.field_int(fr)
                r_b = open_rng.field_int(fr)
                b = sum(a * c for a, c in zip(er, d)) % r
                com_eval = ec.add_affine(q, ec.mul(q, gens[0], value), ec.mul(q, h, r_eval))
                com_d = ec.add_affine(q, ec.msm(q, gens, d), ec.mul(q, h, r_d))
                com_b = ec.add_affine(q, ec.mul(q, gens[0], b), ec.mul(q, h, r_b))
                for g in gens + [h]:
                    sponge.absorb_bytes(point_bytes(curve, g))
                for t in outputs["commitments"][label]:
                    sponge.absorb_bytes(point_bytes(curve, _point(t)))
                sponge.absorb_field(point)
                for a in (com_eval, com_d, com_b):
                    sponge.absorb_bytes(point_bytes(curve, a))
                c = sponge.squeeze_field(1)[0]
                proof = {"com_eval": com_eval, "com_d": com_d, "com_b": com_b,
                         "z": [(dc + c * v) % r for dc, v in zip(d, lt)],
                         "z_d": (c * r_lt + r_d) % r, "z_b": (c * r_eval + r_b) % r}
                for name, v in proof.items():
                    wanted[(name, gi, j)] = v
        for label, v in outputs["values"].items():
            got[("value", label)] = int(v) % r
        for gi, group in enumerate(outputs["proofs"]):
            for j, pf in enumerate(group):
                for name in ("com_eval", "com_d", "com_b"):
                    got[(name, gi, j)] = _point(pf[name])
                got[("z", gi, j)] = [int(v) % r for v in pf["z"]]
                got[("z_d", gi, j)] = int(pf["z_d"]) % r
                got[("z_b", gi, j)] = int(pf["z_b"]) % r
    wrong = sum(1 for key, value in wanted.items() if got.get(key, "missing") != value)
    return wrong, len(wanted)
