"""MarlinKZG10: KZG with degree bounds (shifted G1 commitments), batching
and optional hiding -- the reference's workhorse scheme.

Counterpart of poly_commit_tpu/pcs/marlin_pc.py (the reference's
marlin/marlin_pc/mod.rs and marlin/mod.rs):
  trim                    marlin_pc/mod.rs:80-169
  commit (+shifted)       marlin_pc/mod.rs:172-241
  open (challenge-combined poly + shifted witness)   marlin_pc/mod.rs:245-336
  check (accumulate_commitments_and_values)          marlin/mod.rs:109-148
  batch_check (combine_and_normalize -> kzg10 RLC)   marlin/mod.rs:151-219
  open/check_combinations (LC-combined polynomials)  marlin/mod.rs:224-408

Prover math (MSMs, witness division, polynomial combinations) runs on the
device of the key's tensors; verifier-side point combining on host ints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import field as F
from ..core import hostec
from ..core import poly as P
from ..core.field_params import FR_BLS12_381
from ..utils.trace import traced
from . import errors, kzg10
from .curve_ctx import CTX_BLS12_377, CTX_BLS12_381
from .data_structures import (
    derive_batch_rng,
    LabeledCommitment,
    LabeledPolynomial,
    PolynomialCommitment,
    _group_queries,
    _pt_key,
)

SPEC = FR_BLS12_381


@dataclasses.dataclass
class CommitterKey:
    """marlin_pc/data_structures.rs:26-44."""

    powers: tuple  # device affine, (supported_degree+1,)
    shifted_powers: Optional[tuple]  # device affine from lowest shifted power
    powers_of_gamma_g: tuple  # (supported_hiding_bound+2,)
    enforced_degree_bounds: Optional[list]
    max_degree: int

    @property
    def supported_degree(self):
        return int(self.powers[0].shape[0]) - 1

    def shifted_powers_for(self, bound: Optional[int]):
        if self.shifted_powers is None:
            return None
        if bound is None:
            return self.shifted_powers
        largest = self.enforced_degree_bounds[-1]
        start = largest - bound
        return tuple(a[start:] for a in self.shifted_powers)


@dataclasses.dataclass
class VerifierKey:
    """marlin_pc/data_structures.rs:99-124."""

    vk: kzg10.VerifierKey
    degree_bounds_and_shift_powers: Optional[list]  # [(bound, host int triple)]
    supported_degree: int
    max_degree: int

    def get_shift_power(self, bound: int):
        if self.degree_bounds_and_shift_powers is None:
            return None
        for b, pt in self.degree_bounds_and_shift_powers:
            if b == bound:
                return pt
        return None


@dataclasses.dataclass
class Commitment:
    """comm + optional shifted_comm (marlin_pc/data_structures.rs:227-235).
    Host int triples."""

    comm: tuple
    shifted_comm: Optional[tuple] = None

    def absorb_ints(self, spec=SPEC):
        out = list(self.comm[:2]) + [int(self.comm[2])]
        if self.shifted_comm is not None:
            out += list(self.shifted_comm[:2]) + [int(self.shifted_comm[2])]
        return [v % spec.modulus if not isinstance(v, bool) else int(v) for v in out]


@dataclasses.dataclass
class Randomness:
    rand: kzg10.Randomness
    shifted_rand: Optional[kzg10.Randomness] = None


def _check_degrees_and_bounds(supported_degree, max_degree, enforced_bounds, lp):
    """kzg10/mod.rs:424-449."""
    if lp.degree() > supported_degree:
        raise errors.PolynomialDegreeTooLarge(lp.degree(), supported_degree, lp.label)
    if lp.degree_bound is not None:
        bound = lp.degree_bound
        if bound < lp.degree() or bound > max_degree:
            raise errors.IncorrectDegreeBound(
                lp.degree(), bound, supported_degree, lp.label
            )
        if enforced_bounds is None or bound not in enforced_bounds:
            raise errors.UnsupportedDegreeBound(bound)


@traced("Poly::combine", log=False)
def _scale_poly(coeffs, k_int, spec=SPEC):
    return P.scale(spec, coeffs, F.from_ints(spec, k_int, device=coeffs.device))


@traced("Poly::combine", log=False)
def _combine(acc: Optional[torch.Tensor], coeffs: torch.Tensor, k_int, spec=SPEC):
    """acc + k * coeffs (acc None: k * coeffs)."""
    scaled = _scale_poly(coeffs, k_int, spec)
    return scaled if acc is None else P.add(spec, acc, scaled)


def _add_rand(acc: Optional[torch.Tensor], blind: Optional[torch.Tensor], k_int,
              spec=SPEC):
    """acc += k * blind on blinding polynomials (None = zero)."""
    return acc if blind is None else _combine(acc, blind, k_int, spec)


class MarlinKZG10(PolynomialCommitment):
    """BLS12-381 instantiation; MarlinKZG10_BLS12_377 overrides CTX -- the
    reference's two-curve test matrix (marlin_pc/mod.rs:531-815)."""

    CTX = CTX_BLS12_381
    spec = SPEC

    @classmethod
    @traced("MarlinKZG10::setup")
    def setup(cls, max_degree, num_vars=None, rng=None, device=None):
        return kzg10.setup(max_degree, rng=rng, ctx=cls.CTX, device=device)

    @classmethod
    @traced("MarlinKZG10::trim")
    def trim(cls, pp, supported_degree, supported_hiding_bound=0, enforced_degree_bounds=None):
        max_degree = pp.max_degree
        if supported_degree > max_degree:
            raise errors.TrimmingDegreeTooLarge()
        take = lambda t, sl: tuple(a[sl] for a in t)
        powers = take(pp.powers_of_g, slice(0, supported_degree + 1))
        gamma = take(pp.powers_of_gamma_g, slice(0, supported_hiding_bound + 2))

        shifted_powers = None
        bounds_and_powers = None
        if enforced_degree_bounds:
            bounds = sorted(set(enforced_degree_bounds))
            lowest = max_degree - bounds[-1]
            shifted_powers = take(pp.powers_of_g, slice(lowest, None))
            shift_pts = kzg10.affine_at(cls.CTX.g1, pp.powers_of_g, [max_degree - b for b in bounds])
            bounds_and_powers = list(zip(bounds, shift_pts))
            enforced_degree_bounds = bounds

        ck = CommitterKey(
            powers=powers,
            shifted_powers=shifted_powers,
            powers_of_gamma_g=gamma,
            enforced_degree_bounds=enforced_degree_bounds if enforced_degree_bounds else None,
            max_degree=max_degree,
        )
        vk = VerifierKey(
            vk=kzg10.vk_from_params(pp),
            degree_bounds_and_shift_powers=bounds_and_powers,
            supported_degree=supported_degree,
            max_degree=max_degree,
        )
        return ck, vk

    @classmethod
    @traced("MarlinKZG10::commit")
    def commit(cls, ck, polynomials, rng=None):
        comms, states = [], []
        for lp in polynomials:
            _check_degrees_and_bounds(
                ck.supported_degree, ck.max_degree, ck.enforced_degree_bounds, lp
            )
            kp = kzg10.Powers(ck.powers, ck.powers_of_gamma_g)
            c, r = kzg10.commit(kp, lp.poly, lp.hiding_bound, rng, ctx=cls.CTX)
            shifted_c, shifted_r = None, None
            if lp.degree_bound is not None:
                sp = ck.shifted_powers_for(None)
                if sp is None:
                    raise errors.UnsupportedDegreeBound(lp.degree_bound)
                # commit x^(largest-bound) * p against the full shifted slice:
                # same group element as the reference's per-bound slice
                # (marlin_pc/mod.rs:219-228) but a single MSM shape per key.
                largest = ck.enforced_degree_bounds[-1]
                shifted_poly = P.shift(lp.poly, largest - lp.degree_bound)
                ksp = kzg10.Powers(sp, ck.powers_of_gamma_g)
                sc, sr = kzg10.commit(ksp, shifted_poly, lp.hiding_bound, rng,
                                      ctx=cls.CTX)
                shifted_c, shifted_r = sc, sr
            comms.append(
                LabeledCommitment(
                    lp.label,
                    Commitment(
                        comm=c.point,
                        shifted_comm=shifted_c.point if shifted_c else None,
                    ),
                    lp.degree_bound,
                )
            )
            states.append(Randomness(rand=r, shifted_rand=shifted_r))
        return comms, states

    @classmethod
    @traced("MarlinKZG10::open")
    def open(cls, ck, polynomials, commitments, point, sponge, states, rng=None):
        """marlin_pc/mod.rs:245-336."""
        spec = cls.CTX.spec
        z_int = int(point) % spec.modulus
        z = F.from_ints(spec, z_int, device=ck.powers[0].device)

        p_comb = None
        r_comb = None  # combined blinding polynomial
        shifted_w = None
        shifted_r = None
        shifted_r_witness = None
        enforce = False

        for lp, st in zip(polynomials, states):
            _check_degrees_and_bounds(
                ck.supported_degree, ck.max_degree, ck.enforced_degree_bounds, lp
            )
            c_j = sponge.squeeze_challenge_128()
            p_comb = _combine(p_comb, lp.poly, c_j, spec)
            r_comb = _add_rand(r_comb, st.rand.blinding_polynomial, c_j, spec)

            if lp.degree_bound is not None:
                enforce = True
                c_j1 = sponge.squeeze_challenge_128()
                witness, _ = kzg10._divide_auto(spec, lp.poly, z, z_int)
                largest = ck.enforced_degree_bounds[-1]
                shifted_witness = P.shift(witness, largest - lp.degree_bound)
                shifted_w = _combine(shifted_w, shifted_witness, c_j1, spec)
                sr = st.shifted_rand
                shifted_r = _add_rand(shifted_r, sr.blinding_polynomial, c_j1, spec)
                if sr.blinding_polynomial is not None:
                    bw, _ = P.divide_by_linear(spec, sr.blinding_polynomial, z)
                    shifted_r_witness = _add_rand(shifted_r_witness, bw, c_j1, spec)

        kp = kzg10.Powers(ck.powers, ck.powers_of_gamma_g)
        proof = kzg10.open(kp, p_comb, z_int, kzg10.Randomness(r_comb),
                           ctx=cls.CTX)
        w_host = hostec.triple_to_host(proof.w)
        random_v = proof.random_v

        if enforce:
            g1 = cls.CTX.g1
            sp_all = ck.shifted_powers_for(None)
            # padded to the key size so the MSM shape is key-stable
            sp_size = int(sp_all[0].shape[0])
            w_pt = kzg10._srs_msm(
                kzg10._pad_to(shifted_w, sp_size), sp_all, ctx=cls.CTX
            )
            if shifted_r_witness is not None:
                ng = int(ck.powers_of_gamma_g[0].shape[0])
                hw = kzg10._srs_msm(
                    kzg10._pad_to(shifted_r_witness, ng),
                    ck.powers_of_gamma_g,
                    ctx=cls.CTX,
                )
                w_pt = g1.add(w_pt, hw)
            from ..core.serialize import device_point_to_ints

            sw_host = hostec.triple_to_host(device_point_to_ints(g1, w_pt))
            w_host = cls.CTX.hg1.add(w_host, sw_host)
            if shifted_r is not None:
                srv = F.to_ints(spec, P.evaluate(spec, shifted_r, z))
                random_v = ((random_v or 0) + srv) % spec.modulus

        return kzg10.Proof(w=hostec.host_to_triple(w_host), random_v=random_v)

    @classmethod
    def _accumulate(cls, vk, commitments, values, sponge):
        """marlin/mod.rs:109-148 on host ints."""
        hg1 = cls.CTX.hg1
        spec = cls.CTX.spec
        combined = None
        combined_value = 0
        for lc, v in zip(commitments, values):
            cm = lc.commitment
            c_i = sponge.squeeze_challenge_128()
            combined = hg1.add(combined, hg1.mul(hostec.triple_to_host(cm.comm), c_i))
            combined_value = (combined_value + v * c_i) % spec.modulus
            if lc.degree_bound is not None:
                c_i1 = sponge.squeeze_challenge_128()
                shift_power = vk.get_shift_power(lc.degree_bound)
                if shift_power is None:
                    raise errors.UnsupportedDegreeBound(lc.degree_bound)
                adjusted = hg1.sub(
                    hostec.triple_to_host(cm.shifted_comm),
                    hg1.mul(hostec.triple_to_host(shift_power), v),
                )
                combined = hg1.add(combined, hg1.mul(adjusted, c_i1))
        return combined, combined_value

    @classmethod
    @traced("MarlinKZG10::check")
    def check(cls, vk, commitments, point, values, proof, sponge):
        spec = cls.CTX.spec
        z_int = int(point) % spec.modulus
        values = [int(v) % spec.modulus for v in values]
        combined, combined_value = cls._accumulate(vk, commitments, values, sponge)
        return kzg10.check(
            vk.vk,
            kzg10.Commitment(hostec.host_to_triple(combined)),
            z_int,
            combined_value,
            proof,
            ctx=cls.CTX,
        )

    @classmethod
    @traced("MarlinKZG10::batch_check")
    def batch_check(cls, vk, commitments, query_set, evaluations, proofs, sponge, rng=None):
        """marlin/mod.rs:151-219 + kzg10 batch_check RLC."""
        spec = cls.CTX.spec
        comms = {c.label: c for c in commitments}
        grouped = _group_queries(query_set)
        assert len(grouped) == len(proofs)
        combined_comms, points, evals = [], [], []
        for ((point_label, point), labels) in grouped:
            cs, vs = [], []
            for label in labels:
                if label not in comms:
                    raise errors.MissingPolynomial(label)
                key = (label, _pt_key(point))
                if key not in evaluations:
                    raise errors.MissingEvaluation(str(key))
                cs.append(comms[label])
                vs.append(int(evaluations[key]) % spec.modulus)
            c, v = cls._accumulate(vk, cs, vs, sponge)
            combined_comms.append(kzg10.Commitment(hostec.host_to_triple(c)))
            points.append(int(point) % spec.modulus)
            evals.append(v)
        # sponge-derived randomizers when the caller brings no rng: the
        # 128-bit RLC coefficients must be unpredictable to the prover
        # (the reference requires the rng argument, kzg10/mod.rs:337-391)
        rng = rng or derive_batch_rng(sponge, combined_comms, points, evals, proofs)
        return kzg10.batch_check(vk.vk, combined_comms, points, evals, proofs, rng,
                                 ctx=cls.CTX)

    # -- LC overrides (marlin/mod.rs:224-408) ---------------------------
    @classmethod
    @traced("MarlinKZG10::open_combinations")
    def open_combinations(cls, ck, linear_combinations, polynomials, commitments,
                          eqn_query_set, sponge, states, rng=None):
        spec = cls.CTX.spec
        hg1 = cls.CTX.hg1
        label_map = {
            p.label: (p, s, c)
            for p, s, c in zip(polynomials, states, commitments)
        }
        lc_polys, lc_states, lc_comms = [], [], []
        for lc in linear_combinations:
            poly = None
            degree_bound = None
            hiding_bound = None
            rand_acc = None
            srand_acc = None
            comb = None
            scomb = None
            has_shift = False
            num = len(lc.terms)
            for coeff, term in lc.terms:
                if term == "one":
                    continue
                if term not in label_map:
                    raise errors.MissingPolynomial(term)
                cp, cs, cc = label_map[term]
                if num == 1 and cp.degree_bound is not None:
                    assert coeff % spec.modulus == 1, "degree-bounded equations need coeff 1"
                    degree_bound = cp.degree_bound
                elif cp.degree_bound is not None:
                    raise errors.EquationHasDegreeBounds(lc.label)
                hiding_bound = max(hiding_bound or 0, cp.hiding_bound or 0) or None
                scaled = _scale_poly(cp.poly, coeff, spec)
                poly = scaled if poly is None else P.add(spec, poly, scaled)
                rand_acc = _add_rand(rand_acc, cs.rand.blinding_polynomial, coeff, spec)
                if cs.shifted_rand is not None:
                    srand_acc = _add_rand(
                        srand_acc, cs.shifted_rand.blinding_polynomial, coeff, spec
                    )
                comb = hg1.add(
                    comb, hg1.mul(hostec.triple_to_host(cc.commitment.comm), coeff)
                )
                if cc.commitment.shifted_comm is not None:
                    has_shift = True
                    scomb = hg1.add(
                        scomb,
                        hg1.mul(hostec.triple_to_host(cc.commitment.shifted_comm), coeff),
                    )
            if poly is None:
                poly = F.zeros(spec, (1,), ck.powers[0].device)
            lc_polys.append(
                LabeledPolynomial(lc.label, poly, degree_bound, hiding_bound)
            )
            lc_states.append(
                Randomness(
                    rand=kzg10.Randomness(rand_acc),
                    shifted_rand=kzg10.Randomness(srand_acc) if has_shift else None,
                )
            )
            lc_comms.append(
                LabeledCommitment(
                    lc.label,
                    Commitment(
                        comm=hostec.host_to_triple(comb),
                        shifted_comm=hostec.host_to_triple(scomb) if has_shift else None,
                    ),
                    degree_bound,
                )
            )
        proofs, _ = cls.batch_open(
            ck, lc_polys, lc_comms, eqn_query_set, sponge, lc_states, rng
        )
        return (proofs, None)  # BatchLCProof{proof, evals: None}

    @classmethod
    @traced("MarlinKZG10::check_combinations")
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
            scomb = None
            has_shift = False
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
                        comb, hg1.mul(hostec.triple_to_host(cc.commitment.comm), coeff)
                    )
                    if cc.commitment.shifted_comm is not None:
                        has_shift = True
                        scomb = hg1.add(
                            scomb,
                            hg1.mul(
                                hostec.triple_to_host(cc.commitment.shifted_comm), coeff
                            ),
                        )
            lc_comms.append(
                LabeledCommitment(
                    lc.label,
                    Commitment(
                        comm=hostec.host_to_triple(comb),
                        shifted_comm=hostec.host_to_triple(scomb) if has_shift else None,
                    ),
                    degree_bound,
                )
            )
        return cls.batch_check(vk, lc_comms, eqn_query_set, evals, proofs, sponge)


class MarlinKZG10_BLS12_377(MarlinKZG10):
    """The second reference curve (marlin_pc tests over Bls12_377,
    marlin_pc/mod.rs:538-568 etc.). Same scheme, different CurveCtx."""

    CTX = CTX_BLS12_377
    spec = CTX_BLS12_377.spec
