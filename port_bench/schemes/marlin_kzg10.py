"""MarlinKZG10 through the port's public API (``pcs.marlin_pc``).

A request commits each round's polynomials in one ``commit`` call, each
with its degree bound and, where the mix says it hides, the
configuration's hiding bound; then (when the mix opens) it absorbs every
commitment, shifted ones included, into a fresh Poseidon transcript and
opens the polynomials in one ``batch_open``, each at its query label's
point. The control commits without hiding, the port's own path with the
guarantee off.
"""

from __future__ import annotations

from poly_commit_tpu_torch.pcs.data_structures import LabeledPolynomial, fresh_sponge
from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10, MarlinKZG10_BLS12_377

from .. import inputs, seeds

CLASSES = {"bls12_381": MarlinKZG10, "bls12_377": MarlinKZG10_BLS12_377}


def _pc(cfg):
    return CLASSES[cfg["curve"]]


def poly_len(cfg) -> int:
    """A polynomial at the SRS's full degree."""
    return cfg["srs_degree"] + 1


def point(cfg, rng):
    return rng.field_int(_pc(cfg).spec)


def setup(cfg, plan, seed, device):
    """The committer key: ``setup`` at the SRS degree from the seeded rng,
    trimmed as a Marlin index trims it: to the highest degree of the
    request's polynomials, the hiding bound, and the degree bounds that its
    polynomials enforce."""
    pc = _pc(cfg)
    pp = pc.setup(cfg["srs_degree"], rng=seeds.HostRng(seeds.derive(seed, "setup")), device=device)
    bounds = sorted({p.degree_bound for p in plan.polys() if p.degree_bound is not None})
    ck, _ = pc.trim(pp, max(p.size for p in plan.polys()) - 1, cfg["hiding_bound"], bounds or None)
    return ck


def request(ck, cfg, plan, seed, device, span, control=False) -> dict:
    pc = _pc(cfg)
    spec = pc.spec
    commit_rng = seeds.HostRng(seeds.derive(seed, "commit", plan.index))
    polys, comms, states = [], [], []
    for round_polys in plan.rounds:
        with span("inputs"):
            lps = [LabeledPolynomial(p.label, inputs.field_limbs(
                spec.modulus, p.size, inputs.poly_seed(seed, plan.index, p.label), device),
                degree_bound=p.degree_bound,
                hiding_bound=cfg["hiding_bound"] if p.hiding and not control else None)
                for p in round_polys]
        with span("commit"):
            c, s = pc.commit(ck, lps, commit_rng)
        polys += lps
        comms += c
        states += s
    out = {"commitments": {c.label: (c.commitment.comm, c.commitment.shifted_comm)
                           for c in comms}}
    if plan.points is not None:
        queries = {(p.label, (p.query, plan.points[p.query])) for p in plan.polys() if p.query}
        with span("open"):
            sponge = fresh_sponge(spec)
            for c in comms:
                for point in (c.commitment.comm, c.commitment.shifted_comm):
                    if point is not None:
                        sponge.absorb_field([int(point[0]) % spec.modulus,
                                             int(point[1]) % spec.modulus])
            proofs, values = pc.batch_open(ck, polys, comms, queries, sponge, states,
                                           seeds.HostRng(seeds.derive(seed, "open", plan.index)))
        out["values"] = {label: v for (label, _), v in values.items()}
        out["proofs"] = [(p.w, p.random_v) for p in proofs]
    return out


def msm_points(cfg, plan) -> int:
    """Bases of every MSM of one request, at the sizes the work needs: a
    commitment's SRS MSM of as many points as the polynomial has
    coefficients, and a hiding one of hiding bound + 2, each twice where a
    degree bound is enforced (the shifted commitment); an opening's witness
    MSM of one point fewer than its longest polynomial and blinding witness
    MSM of hiding bound + 1, again for its longest bounded polynomial."""
    hb = cfg["hiding_bound"]
    n = sum((1 + (p.degree_bound is not None)) * (p.size + (hb + 2) * p.hiding)
            for p in plan.polys())
    by_label = {p.label: p for p in plan.polys()}
    for _, _, labels in plan.groups():
        group = [by_label[label] for label in labels]
        for part in (group, [p for p in group if p.degree_bound is not None]):
            if part:
                n += max(p.size for p in part) - 1 + (hb + 1) * any(p.hiding for p in part)
    return n
