"""Multilinear Ligero over BN254 Fr through the port's public API
(``pcs.linear_codes.MultilinearLigeroBN254``).

A request commits each round's multilinear polynomials (2^nv evaluations)
in one ``commit`` call (the rows' Reed-Solomon encode on the card, the
column hashes and the Merkle tree on the host), then (when the mix opens)
opens them in one ``batch_open`` with a fresh transcript, each at its query
label's point of nv coordinates. Beside the root, the metadata, the proofs
and the values, it returns each commitment state's encoded matrix (the
tensor itself, not a copy), so that the reference checks what the timed
path produced. The control flips one limb of each encoded matrix after the
request.
"""

from __future__ import annotations

import dataclasses

from poly_commit_tpu_torch.pcs.data_structures import LabeledPolynomial, fresh_sponge
from poly_commit_tpu_torch.pcs.linear_codes import MultilinearLigeroBN254 as PC

from .. import inputs
from ..reference.ligero_ml import dimensions

PARAMS = ("rho_inv", "sec_param", "check_well_formedness")


def poly_len(cfg) -> int:
    return 1 << cfg["num_vars"]


def point(cfg, rng):
    return tuple(rng.field_ints(PC.spec, cfg["num_vars"]))


def setup(cfg, plan, seed, device):
    """The key: the code's parameters (no seed, no SRS); raises unless they
    are the configuration's."""
    ck, _ = PC.trim(PC.setup(0, num_vars=cfg["num_vars"], device=device))
    if any(getattr(ck, k) != cfg[k] for k in PARAMS):
        raise ValueError(f"the port's parameters {[getattr(ck, k) for k in PARAMS]} are not "
                         f"the configuration's {[cfg[k] for k in PARAMS]}")
    return ck


def _proof(p) -> dict:
    return {"v": p.opening.v, "well_formedness": p.well_formedness,
            "columns": p.opening.columns,
            "paths": [(path.leaf_index, path.siblings) for path in p.opening.paths]}


def request(ck, cfg, plan, seed, device, span, control=False) -> dict:
    polys, comms, states = [], [], []
    for round_polys in plan.rounds:
        with span("inputs"):
            lps = [LabeledPolynomial(p.label, inputs.field_limbs(
                PC.spec.modulus, p.size, inputs.poly_seed(seed, plan.index, p.label), device),
                num_vars=cfg["num_vars"]) for p in round_polys]
        with span("commit"):
            c, s = PC.commit(ck, lps)
        polys += lps
        comms += c
        states += s
    out = {"commitments": {c.label: {"root": c.commitment.root,
                                     "metadata": dataclasses.astuple(c.commitment.metadata)}
                           for c in comms},
           "encoded": {lp.label: st.ext_mat for lp, st in zip(polys, states)}}
    if plan.points is not None:
        queries = {(p.label, (p.query, plan.points[p.query])) for p in plan.polys() if p.query}
        with span("open"):
            proofs, values = PC.batch_open(ck, polys, comms, queries, fresh_sponge(PC.spec),
                                           states)
        out["values"] = {label: v for (label, _), v in values.items()}
        out["proofs"] = [[_proof(p) for p in group] for group in proofs]
    if control:
        for ext_mat in out["encoded"].values():
            ext_mat[0, 0, 0] ^= 1
    return out


def ntt_shapes(cfg, plan) -> list:
    """The (rows, log2 points) batches of transforms one request runs: each
    polynomial's rows, Reed-Solomon encoded."""
    shapes = []
    for p in plan.polys():
        rows, _, ext, _ = dimensions(cfg, p.size)
        shapes.append((rows, ext.bit_length() - 1))
    return shapes
