"""The one traffic generator: a request's polynomials and points from the
seed, whatever the mix (``traffic/<mix>.json``) and the scheme.

A mix's parameters:

``rounds``  the polynomials of each ``commit`` call, in order (a prover
            waits for each round's commitments before the next round). A
            polynomial is an object:
            ``label``         its name;
            ``degree``        a linear form over the configuration's sizes,
                              ``{"h_size": 3, "const": -1}`` for 3|H| - 1;
                              left out, the scheme's full size
                              (``scheme.poly_len``: a multilinear polynomial's
                              2^nv evaluations);
            ``degree_bound``  a linear form as ``degree``: the bound the
                              commitment enforces (left out: none);
            ``hiding``        true: committed with the configuration's
                              hiding bound (a scheme that always hides, as
                              Hyrax, ignores it);
            ``query``         the label of the point it is opened at (left
                              out: not opened).
``check_requests``  how many requests of a run the reference checks, drawn
            from the seed among those the window ran.

Every polynomial queried at one label is opened at the same point, and all
of a request's openings are one ``batch_open``. A polynomial's entries come
from a ``torch.Generator`` on the run's device seeded by
``seeds.derive(seed, "poly", request, label)``, so the reference regenerates
any one of them alone. Points come from ``seeds.HostRng``, one a query
label, in the order the labels first appear.
"""

from __future__ import annotations

import dataclasses

import torch

from . import seeds

LIMB_BITS = 16


@dataclasses.dataclass(frozen=True)
class Poly:
    label: str
    size: int  # coefficients, or evaluations of a multilinear polynomial
    degree_bound: int | None
    hiding: bool
    query: str | None


@dataclasses.dataclass
class Plan:
    """One request: the polynomials of each round and, if any is opened,
    the point of each query label."""

    index: int
    rounds: list  # [[Poly]]
    points: dict | None  # query label -> point

    def polys(self):
        return [p for polys in self.rounds for p in polys]

    def labels(self):
        return [p.label for p in self.polys()]

    def groups(self):
        """[(query label, point, sorted labels)] in the order ``batch_open``
        opens them: by query label."""
        if self.points is None:
            return []
        return [(q, self.points[q], sorted(p.label for p in self.polys() if p.query == q))
                for q in sorted(self.points)]


def linear(form: dict, cfg: dict) -> int:
    """sum of coefficient x ``cfg[key]``, plus ``form["const"]``."""
    return sum(c if k == "const" else c * cfg[k] for k, c in form.items())


def n_limbs(modulus: int) -> int:
    return -(-modulus.bit_length() // LIMB_BITS)


def field_limbs(modulus: int, n: int, seed: int, device) -> torch.Tensor:
    """(n, L) int32 16-bit limbs of n field elements below ``modulus``: the
    low limbs uniform, the top limb uniform below the modulus's top limb.
    The port reads them as Montgomery forms, which are as uniform as the
    elements they stand for."""
    limbs = n_limbs(modulus)
    top = modulus >> (LIMB_BITS * (limbs - 1))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    low = torch.randint(0, 1 << LIMB_BITS, (n, limbs - 1), generator=g, device=device,
                        dtype=torch.int32)
    high = torch.randint(0, top, (n, 1), generator=g, device=device, dtype=torch.int32)
    return torch.cat([low, high], 1)


def poly_seed(seed: int, index: int, label: str) -> int:
    return seeds.derive(seed, "poly", index, label)


def shapes(traffic: dict, cfg: dict, scheme) -> list:
    """The mix's polynomials, [[Poly]] a round: the same in every request."""
    def poly(spec):
        size = linear(spec["degree"], cfg) + 1 if "degree" in spec else scheme.poly_len(cfg)
        bound = linear(spec["degree_bound"], cfg) if "degree_bound" in spec else None
        return Poly(spec["label"], size, bound, bool(spec.get("hiding")), spec.get("query"))

    return [[poly(spec) for spec in specs] for specs in traffic["rounds"]]


def plan(traffic: dict, cfg: dict, scheme, seed: int, index: int) -> Plan:
    """Request ``index`` of a run (the warm-up is -1)."""
    rounds = shapes(traffic, cfg, scheme)
    queries = list(dict.fromkeys(p.query for polys in rounds for p in polys if p.query))
    points = None
    if queries:
        rng = seeds.HostRng(seeds.derive(seed, "points", index))
        points = {q: scheme.point(cfg, rng) for q in queries}
    return Plan(index, rounds, points)


def coefficients(plan: Plan) -> int:
    """Coefficients (evaluations) of every polynomial of a request."""
    return sum(p.size for p in plan.polys())
