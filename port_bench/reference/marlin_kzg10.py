"""The reference for MarlinKZG10 requests (KZG10 with hiding and enforced
degree bounds): every commitment, shifted ones included, every opened value
and every proof, worked out from the SRS trapdoor.

The SRS of degree D is g, beta g, ..., beta^D g and gamma g, gamma beta g,
... with g = g_k G1. The reference draws beta, g_k and gamma as the port's
setup draws them from the rng the harness handed it, so a commitment to p
with blinding polynomial b is (p(beta) + gamma b(beta)) g, and the shifted
commitment of p under degree bound d, with its own blinding b', is
(beta^(D - d) p(beta) + gamma b'(beta)) g. The proof at z of the polynomials
p_j queried there, with challenges c_j (and c'_j for each bounded one), is
W / (beta - z) g with

  W = sum_j c_j ((p_j(beta) - p_j(z)) + gamma (b_j(beta) - b_j(z)))
    + sum_bounded c'_j (beta^(D - d_j) (p_j(beta) - p_j(z)) + gamma (b'_j(beta) - b'_j(z)))

and random_v = sum c_j b_j(z) + sum c'_j b'_j(z), or none where nothing
hides. Each polynomial is evaluated exactly from its limbs
(``limbs.evaluate``); the challenges come from the same Poseidon transcript,
and the proofs are compared in the order of the points' labels, the order
in which ``batch_open`` groups its queries.
"""

from __future__ import annotations

from .. import inputs, seeds
from . import ec, limbs
from .curves import CURVES
from .poseidon import Sponge

_TRAPDOORS: dict = {}


def trapdoor(curve, seed: int):
    """(beta, gamma, g) as the port's setup draws them: beta, g_k, gamma,
    h_k from the setup rng; g = g_k G1."""
    key = (curve.name, seed)
    if key not in _TRAPDOORS:
        rng = seeds.HostRng(seeds.derive(seed, "setup"))
        fr = seeds.Field(curve.r)
        beta, g_k, gamma = rng.field_int(fr), rng.field_int(fr), rng.field_int(fr)
        _TRAPDOORS[key] = (beta, gamma, ec.mul(curve.q, curve.g1, g_k))
    return _TRAPDOORS[key]


def _point(triple):
    if triple is None:
        return None
    x, y, inf = triple
    return None if inf else (int(x), int(y))


def check(cfg: dict, traffic: dict, seed: int, plan, outputs: dict, device) -> tuple:
    """(wrong, checked): the outputs of request ``plan`` that differ from the
    reference, of how many compared."""
    curve = CURVES[cfg["curve"]]
    r, q = curve.r, curve.q
    rinv = pow(1 << (16 * curve.limbs), -1, r)
    beta, gamma, g = trapdoor(curve, seed)
    hb, big_d = cfg["hiding_bound"], cfg["srs_degree"]
    rng = seeds.HostRng(seeds.derive(seed, "commit", plan.index))
    fr = seeds.Field(r)

    def blinding():
        blind = rng.field_ints(fr, hb + 2)
        if blind[-1] == 0:
            blind[-1] = 1
        return blind

    def at(coeffs, x):
        return sum(c * pow(x, i, r) for i, c in enumerate(coeffs)) % r

    polys, shape, p_beta, blinds, wanted = {}, {}, {}, {}, {}
    for p in plan.polys():
        coeffs = inputs.field_limbs(r, p.size, inputs.poly_seed(seed, plan.index, p.label), device)
        polys[p.label], shape[p.label] = coeffs, p
        p_beta[p.label] = limbs.evaluate(coeffs, beta, r) * rinv % r
        blinds[p.label] = [blinding() if p.hiding else [] for _ in range(1 + (p.degree_bound is not None))]
        b = blinds[p.label]
        wanted[("commitment", p.label)] = ec.mul(q, g, (p_beta[p.label] + gamma * at(b[0], beta)) % r)
        if p.degree_bound is not None:
            shifted = pow(beta, big_d - p.degree_bound, r) * p_beta[p.label] + gamma * at(b[1], beta)
            wanted[("shifted", p.label)] = ec.mul(q, g, shifted % r)

    got = {}
    for label, (comm, shifted) in outputs["commitments"].items():
        got[("commitment", label)] = _point(comm)
        if shape[label].degree_bound is not None:
            got[("shifted", label)] = _point(shifted)
    if plan.points is not None:
        sponge = Sponge(r)
        for label in plan.labels():
            for point in outputs["commitments"][label]:
                if point is not None:
                    sponge.absorb_field([int(point[0]) % r, int(point[1]) % r])
        for i, (_, z, labels) in enumerate(plan.groups()):
            num, random_v = 0, None
            for label in labels:
                b = blinds[label]
                pz = limbs.evaluate(polys[label], z, r) * rinv % r
                wanted[("value", label)] = pz
                terms = [(1, b[0])]
                if shape[label].degree_bound is not None:
                    terms.append((pow(beta, big_d - shape[label].degree_bound, r), b[1]))
                for shift, blind in terms:
                    c = sponge.squeeze_challenge_128()
                    num += c * (shift * (p_beta[label] - pz) + gamma * (at(blind, beta) - at(blind, z)))
                    if blind:
                        random_v = ((random_v or 0) + c * at(blind, z)) % r
            wanted[("w", i)] = ec.mul(q, g, num * pow((beta - z) % r, -1, r) % r)
            wanted[("random_v", i)] = random_v
        for label, v in outputs["values"].items():
            got[("value", label)] = int(v) % r
        for i, (w, random_v) in enumerate(outputs["proofs"]):
            got[("w", i)] = _point(w)
            got[("random_v", i)] = None if random_v is None else int(random_v) % r
    wrong = sum(1 for key, value in wanted.items() if got.get(key, "missing") != value)
    return wrong, len(wanted)
