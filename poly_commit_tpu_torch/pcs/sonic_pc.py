"""SonicKZG10: KZG with degree bounds enforced by negative G2 powers (the
AuroraLight variant), one commitment per polynomial.

Counterpart of poly_commit_tpu/pcs/sonic_pc.py (the reference's
sonic_pc/mod.rs):
  setup                   mod.rs:151-157  KZG10 setup with neg powers of h
  trim                    mod.rs:159-271  shifted G1 powers, shifted gamma
                                          powers and neg G2 powers per bound
  commit                  mod.rs:273-339  shifted or plain powers per poly
  open                    mod.rs:341-384  challenge-combined poly, plain powers
  check                   mod.rs:39-133   accumulate_elems / check_elems:
                                          per-bound commitment groups -> one
                                          multi-pairing with neg shift powers
  batch_check             mod.rs:386-459  128-bit randomizer RLC across points
  open/check_combinations mod.rs:461-639

Prover math (MSMs, polynomial combinations) runs on the device of the key's
tensors; the verifier's combining and its multi-pairing run on host ints
(``CurveCtx.pairing_product_is_one``), as the JAX package's CTX call does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import field as F
from ..core import hostec
from ..core import poly as P
from ..core.field_params import FR_BLS12_381
from ..core.serialize import device_point_to_ints
from ..utils.trace import traced
from . import errors, kzg10
from .curve_ctx import CTX_BLS12_377, CTX_BLS12_381
from .data_structures import (
    LabeledCommitment,
    LabeledPolynomial,
    PolynomialCommitment,
    _group_queries,
    _pt_key,
    derive_batch_rng,
)
from .marlin_pc import _add_rand, _check_degrees_and_bounds, _scale_poly

SPEC = FR_BLS12_381


@dataclasses.dataclass
class CommitterKey:
    """sonic_pc/data_structures.rs:20-66."""

    powers_of_g: tuple  # device affine (supported_degree+1,)
    powers_of_gamma_g: tuple  # (supported_hiding_bound+2,)
    shifted_powers_of_g: Optional[tuple]  # from index max_degree - max_bound
    shifted_powers_of_gamma_g: Optional[dict]  # bound -> device affine slice
    enforced_degree_bounds: Optional[list]
    max_degree: int

    @property
    def supported_degree(self):
        return int(self.powers_of_g[0].shape[0]) - 1

    def powers(self) -> kzg10.Powers:
        return kzg10.Powers(self.powers_of_g, self.powers_of_gamma_g)

    def shifted_powers(self, degree_bound: int) -> kzg10.Powers:
        """The slice from SRS index max_degree - degree_bound
        (sonic_pc/data_structures.rs:81-112)."""
        max_bound = self.enforced_degree_bounds[-1]
        start = max_bound - degree_bound
        return kzg10.Powers(
            tuple(a[start:] for a in self.shifted_powers_of_g),
            self.shifted_powers_of_gamma_g[degree_bound],
        )


@dataclasses.dataclass
class VerifierKey:
    """sonic_pc/data_structures.rs:118-172. Host int triples; G2 points are
    ((c0, c1), (c0, c1), inf)."""

    g: tuple
    gamma_g: tuple
    h: tuple
    beta_h: tuple
    degree_bounds_and_neg_powers_of_h: Optional[list]  # [(bound, g2 triple)]
    supported_degree: int
    max_degree: int

    def get_shift_power(self, bound: Optional[int]):
        if bound is None:
            return self.h
        if self.degree_bounds_and_neg_powers_of_h is None:
            return None
        for b, pt in self.degree_bounds_and_neg_powers_of_h:
            if b == bound:
                return pt
        return None


class SonicKZG10(PolynomialCommitment):
    """BLS12-381 instantiation; SonicKZG10_BLS12_377 overrides CTX (the
    reference's two-curve test matrix, sonic_pc/mod.rs tests)."""

    CTX = CTX_BLS12_381
    spec = SPEC

    @classmethod
    @traced("SonicKZG10::setup")
    def setup(cls, max_degree, num_vars=None, rng=None, device=None):
        return kzg10.setup(max_degree, produce_g2_powers=True, rng=rng, ctx=cls.CTX,
                           device=device)

    @classmethod
    @traced("SonicKZG10::trim")
    def trim(cls, pp, supported_degree, supported_hiding_bound=0, enforced_degree_bounds=None):
        if supported_degree > pp.max_degree:
            raise errors.TrimmingDegreeTooLarge()
        max_degree = pp.max_degree

        def take(t, sl):
            return tuple(a[sl] for a in t)

        shifted_g = None
        shifted_gamma = None
        bounds_and_neg_h = None
        bounds = None
        if enforced_degree_bounds:
            bounds = sorted(set(enforced_degree_bounds))
            highest = bounds[-1]
            if highest > supported_degree:
                raise errors.UnsupportedDegreeBound(highest)
            shifted_g = take(pp.powers_of_g, slice(max_degree - highest, None))
            shifted_gamma = {}
            for b in bounds:
                shift = max_degree - b
                end = min(shift + supported_hiding_bound + 2, max_degree + 2)
                shifted_gamma[b] = take(pp.powers_of_gamma_g, slice(shift, end))
            neg_pts = kzg10.affine_at(cls.CTX.g2, pp.neg_powers_of_h,
                                      [max_degree - b for b in bounds])
            bounds_and_neg_h = list(zip(bounds, neg_pts))

        ck = CommitterKey(
            powers_of_g=take(pp.powers_of_g, slice(0, supported_degree + 1)),
            powers_of_gamma_g=take(pp.powers_of_gamma_g, slice(0, supported_hiding_bound + 2)),
            shifted_powers_of_g=shifted_g,
            shifted_powers_of_gamma_g=shifted_gamma,
            enforced_degree_bounds=bounds,
            max_degree=max_degree,
        )
        g1 = cls.CTX.g1

        def host1(t):
            x, y, inf = t
            return device_point_to_ints(g1, g1.from_affine(x[0], y[0], inf[0]))

        vk = VerifierKey(
            g=host1(pp.powers_of_g),
            gamma_g=host1(pp.powers_of_gamma_g),
            h=pp.h,
            beta_h=pp.beta_h,
            degree_bounds_and_neg_powers_of_h=bounds_and_neg_h,
            supported_degree=supported_degree,
            max_degree=max_degree,
        )
        return ck, vk

    @classmethod
    @traced("SonicKZG10::commit")
    def commit(cls, ck, polynomials, rng=None):
        comms, states = [], []
        for lp in polynomials:
            _check_degrees_and_bounds(
                ck.supported_degree, ck.max_degree, ck.enforced_degree_bounds, lp
            )
            if lp.degree_bound is not None:
                powers = ck.shifted_powers(lp.degree_bound)
            else:
                powers = ck.powers()
            c, r = kzg10.commit(powers, lp.poly, lp.hiding_bound, rng, ctx=cls.CTX)
            comms.append(LabeledCommitment(lp.label, c, lp.degree_bound))
            states.append(r)
        return comms, states

    @classmethod
    @traced("SonicKZG10::open")
    def open(cls, ck, polynomials, commitments, point, sponge, states, rng=None):
        """mod.rs:341-384: one combined poly opened with the plain powers."""
        spec = cls.CTX.spec
        z_int = int(point) % spec.modulus
        p_comb = None
        r_comb = None
        for lp, st in zip(polynomials, states):
            _check_degrees_and_bounds(
                ck.supported_degree, ck.max_degree, ck.enforced_degree_bounds, lp
            )
            c_j = sponge.squeeze_challenge_128()
            scaled = _scale_poly(lp.poly, c_j, spec)
            p_comb = scaled if p_comb is None else P.add(spec, p_comb, scaled)
            r_comb = _add_rand(r_comb, st.blinding_polynomial, c_j, spec)
        return kzg10.open(ck.powers(), p_comb, z_int, kzg10.Randomness(r_comb), ctx=cls.CTX)

    # -- verifier accumulation (mod.rs:39-133) ---------------------------
    @classmethod
    def _accumulate_elems(cls, acc, vk, commitments, point, values, proof, sponge, randomizer):
        hg1 = cls.CTX.hg1
        spec = cls.CTX.spec
        z = int(point) % spec.modulus
        combined_values = 0
        for lc, v in zip(commitments, values):
            challenge = sponge.squeeze_challenge_128()
            combined_values = (combined_values + int(v) * challenge) % spec.modulus
            mult = challenge if randomizer is None else challenge * randomizer
            cm = hostec.triple_to_host(lc.commitment.point)
            acc["comms"][lc.degree_bound] = hg1.add(
                acc["comms"].get(lc.degree_bound), hg1.mul(cm, mult)
            )
        w = hostec.triple_to_host(proof.w)
        adjusted = hg1.sub(
            hg1.mul(hostec.triple_to_host(vk.g), combined_values), hg1.mul(w, z)
        )
        if proof.random_v is not None:
            adjusted = hg1.add(
                adjusted, hg1.mul(hostec.triple_to_host(vk.gamma_g), proof.random_v)
            )
        if randomizer is not None:
            w = hg1.mul(w, randomizer)
            adjusted = hg1.mul(adjusted, randomizer)
        acc["witness"] = hg1.add(acc["witness"], w)
        acc["adjusted"] = hg1.add(acc["adjusted"], adjusted)

    @classmethod
    def _vk_prepared(cls, vk, key, triple):
        """Per-vk cached G2 line precomputation: the reference prepares
        exactly these elements (sonic data_structures.rs:164 get_shift_power
        -> G2Prepared; kzg10/data_structures.rs:285-312)."""
        cache = vk.__dict__.setdefault("_prep_cache", {})
        if key not in cache:
            cache[key] = cls.CTX.prepare_g2(triple)
        return cache[key]

    @classmethod
    def _check_elems(cls, acc, vk) -> bool:
        g1s, g2s, prepared = [], [], []
        for bound in sorted(acc["comms"], key=lambda b: (b is not None, b)):
            shift_power = vk.get_shift_power(bound)
            if shift_power is None:
                raise errors.UnsupportedDegreeBound(bound)
            g1s.append(hostec.host_to_triple(acc["comms"][bound]))
            g2s.append(shift_power)
            prepared.append(cls._vk_prepared(vk, ("shift", bound), shift_power))
        hg1 = cls.CTX.hg1
        g1s.append(hostec.host_to_triple(hg1.neg(acc["adjusted"])))
        g2s.append(vk.h)
        prepared.append(cls._vk_prepared(vk, "h", vk.h))
        g1s.append(hostec.host_to_triple(hg1.neg(acc["witness"])))
        g2s.append(vk.beta_h)
        prepared.append(cls._vk_prepared(vk, "beta_h", vk.beta_h))
        return cls.CTX.pairing_product_is_one(g1s, g2s, prepared=prepared)

    @classmethod
    @traced("SonicKZG10::check")
    def check(cls, vk, commitments, point, values, proof, sponge):
        acc = {"comms": {}, "witness": None, "adjusted": None}
        cls._accumulate_elems(acc, vk, commitments, point, values, proof, sponge, None)
        return cls._check_elems(acc, vk)

    @classmethod
    @traced("SonicKZG10::batch_check")
    def batch_check(cls, vk, commitments, query_set, evaluations, proofs, sponge, rng=None):
        comms = {c.label: c for c in commitments}
        grouped = _group_queries(query_set)
        assert len(grouped) == len(proofs)
        rng = rng or derive_batch_rng(
            sponge, [c.label for c in commitments],
            [lc.commitment for lc in commitments], grouped,
            {str(k): int(v) for k, v in evaluations.items()}, proofs,
        )
        acc = {"comms": {}, "witness": None, "adjusted": None}
        randomizer = 1
        for ((point_label, point), labels), proof in zip(grouped, proofs):
            cs, vs = [], []
            for label in labels:
                if label not in comms:
                    raise errors.MissingPolynomial(label)
                key = (label, _pt_key(point))
                if key not in evaluations:
                    raise errors.MissingEvaluation(str(key))
                cs.append(comms[label])
                vs.append(int(evaluations[key]) % cls.CTX.spec.modulus)
            cls._accumulate_elems(acc, vk, cs, point, vs, proof, sponge, randomizer)
            randomizer = rng.u128()
        return cls._check_elems(acc, vk)

    # -- LC overrides (mod.rs:461-639) -----------------------------------
    @classmethod
    def open_combinations(cls, ck, linear_combinations, polynomials, commitments,
                          eqn_query_set, sponge, states, rng=None):
        spec = cls.CTX.spec
        hg1 = cls.CTX.hg1
        label_map = {
            p.label: (p, s, c) for p, s, c in zip(polynomials, states, commitments)
        }
        lc_polys, lc_states, lc_comms = [], [], []
        for lc in linear_combinations:
            poly = None
            degree_bound = None
            hiding_bound = None
            rand_acc = None
            comb = None
            num = len(lc.terms)
            for coeff, term in lc.terms:
                if term == "one":
                    continue
                if term not in label_map:
                    raise errors.MissingPolynomial(term)
                cp, cs, cc = label_map[term]
                if num == 1 and cp.degree_bound is not None:
                    assert coeff % spec.modulus == 1
                    degree_bound = cp.degree_bound
                elif cp.degree_bound is not None:
                    raise errors.EquationHasDegreeBounds(lc.label)
                hiding_bound = max(hiding_bound or 0, cp.hiding_bound or 0) or None
                scaled = _scale_poly(cp.poly, coeff, spec)
                poly = scaled if poly is None else P.add(spec, poly, scaled)
                rand_acc = _add_rand(rand_acc, cs.blinding_polynomial, coeff, spec)
                comb = hg1.add(
                    comb, hg1.mul(hostec.triple_to_host(cc.commitment.point), coeff)
                )
            if poly is None:
                poly = F.zeros(spec, (1,), ck.powers_of_g[0].device)
            lc_polys.append(LabeledPolynomial(lc.label, poly, degree_bound, hiding_bound))
            lc_states.append(kzg10.Randomness(rand_acc))
            lc_comms.append(
                LabeledCommitment(
                    lc.label, kzg10.Commitment(hostec.host_to_triple(comb)), degree_bound
                )
            )
        proofs, _ = cls.batch_open(
            ck, lc_polys, lc_comms, eqn_query_set, sponge, lc_states, rng
        )
        return (proofs, None)

    @classmethod
    def check_combinations(cls, vk, linear_combinations, commitments, eqn_query_set,
                           eqn_evaluations, proof_and_evals, sponge):
        proofs, _ = proof_and_evals
        spec = cls.CTX.spec
        hg1 = cls.CTX.hg1
        comm_map = {c.label: c for c in commitments}
        evals = {k: int(v) % spec.modulus for k, v in eqn_evaluations.items()}
        lc_comms = []
        for lc in linear_combinations:
            degree_bound = None
            comb = None
            num = len(lc.terms)
            for coeff, term in lc.terms:
                if term == "one":
                    for key in list(evals):
                        if key[0] == lc.label:
                            evals[key] = (evals[key] - coeff) % spec.modulus
                else:
                    if term not in comm_map:
                        raise errors.MissingPolynomial(term)
                    cc = comm_map[term]
                    if num == 1 and cc.degree_bound is not None:
                        assert coeff % spec.modulus == 1
                        degree_bound = cc.degree_bound
                    elif cc.degree_bound is not None:
                        raise errors.EquationHasDegreeBounds(lc.label)
                    comb = hg1.add(
                        comb, hg1.mul(hostec.triple_to_host(cc.commitment.point), coeff)
                    )
            lc_comms.append(
                LabeledCommitment(
                    lc.label, kzg10.Commitment(hostec.host_to_triple(comb)), degree_bound
                )
            )
        return cls.batch_check(vk, lc_comms, eqn_query_set, evals, proofs, sponge)


class SonicKZG10_BLS12_377(SonicKZG10):
    """BLS12-377 instantiation (the reference's second test curve)."""

    CTX = CTX_BLS12_377
    spec = CTX_BLS12_377.spec
