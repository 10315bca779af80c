"""Hyrax through the port's public API (``pcs.hyrax``).

A request commits each round's multilinear polynomials (2^nv evaluations)
in one ``commit`` call, every row hidden, then (when the mix opens) opens
them in one ``batch_open`` with a fresh transcript, each at its query
label's point of nv coordinates. The control commits with every row's
hiding mask 0.
"""

from __future__ import annotations

import dataclasses

from poly_commit_tpu_torch.pcs.data_structures import LabeledPolynomial, fresh_sponge
from poly_commit_tpu_torch.pcs.hyrax import HyraxPC

from .. import inputs, seeds


class NoMask:
    """An rng whose every draw is 0: rows committed without hiding."""

    def field_int(self, spec):
        return 0

    def field_ints(self, spec, n):
        return [0] * n


def poly_len(cfg) -> int:
    return 1 << cfg["num_vars"]


def point(cfg, rng):
    return tuple(rng.field_ints(HyraxPC.spec, cfg["num_vars"]))


def setup(cfg, plan, seed, device):
    """The key: 2^(nv/2) + 1 generators hashed to the curve (no seed)."""
    ck, _ = HyraxPC.trim(HyraxPC.setup(0, num_vars=cfg["num_vars"], device=device))
    return ck


def request(ck, cfg, plan, seed, device, span, control=False) -> dict:
    spec = HyraxPC.spec
    commit_rng = NoMask() if control else seeds.HostRng(seeds.derive(seed, "commit", plan.index))
    polys, comms, states = [], [], []
    for round_polys in plan.rounds:
        with span("inputs"):
            lps = [LabeledPolynomial(p.label, inputs.field_limbs(
                spec.modulus, p.size, inputs.poly_seed(seed, plan.index, p.label), device),
                num_vars=cfg["num_vars"]) for p in round_polys]
        with span("commit"):
            c, s = HyraxPC.commit(ck, lps, commit_rng)
        polys += lps
        comms += c
        states += s
    out = {"commitments": {c.label: c.commitment.row_coms for c in comms}}
    if plan.points is not None:
        queries = {(p.label, (p.query, plan.points[p.query])) for p in plan.polys() if p.query}
        with span("open"):
            proofs, values = HyraxPC.batch_open(ck, polys, comms, queries, fresh_sponge(spec), states,
                                                seeds.HostRng(seeds.derive(seed, "open", plan.index)))
        out["values"] = {label: v for (label, _), v in values.items()}
        out["proofs"] = [[dataclasses.asdict(p) for p in group] for group in proofs]
    return out


def msm_points(cfg, plan) -> int:
    """Bases of every MSM of one request: a commitment's 2^(nv/2) row MSMs
    of 2^(nv/2) points each; an opening's MSM of 2^(nv/2) points (com_d)."""
    dim = 1 << (cfg["num_vars"] // 2)
    return sum(dim * dim + (dim if p.query else 0) for p in plan.polys())
