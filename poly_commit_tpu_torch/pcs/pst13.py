"""MarlinPST13: sparse multivariate polynomial commitments (PST13 with
Marlin's batching and hiding).

Counterpart of poly_commit_tpu/pcs/pst13.py (the reference's
marlin/marlin_pst13_pc/):
  monomial enumeration (Combinations)  combinations.rs:6-103, mod.rs:156-260
  divide_at_point                      mod.rs:44-92
  commit (term-indexed MSM + hiding)   mod.rs:320-416
  open (per-variable witness MSMs)     mod.rs:419-512
  check ((nv+1)-way pairing product)   mod.rs:516-558
  batch_check (128-bit randomizer RLC) mod.rs:560-636
  Randomness                           data_structures.rs:326-408

Sparse term bookkeeping (a dict of exponent tuple -> int) runs on the host,
as in the JAX package; every MSM gathers the term-indexed SRS rows on the
device (``index_select``) and runs one G1 MSM (K3, K2a). Setup's G1 powers
over every monomial and the gamma powers are fixed-base multiplications on
K2a, beta_h one on K2c. Under an active mesh of more than one rank,
``_term_msm`` pads and shards its MSM (``parallel.mesh.msm_sharded``), as
the JAX package's branch does. The blinding polynomial is restricted
to univariate monomials per variable (constant + sum_i sum_j c_ij x_i^j),
the gamma-power lookup the reference assumes at mod.rs:380-385.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch

from .. import device as D
from ..core import curve as C
from ..core import hostec
from ..core import msm as M
from ..core.field_params import FR_BLS12_381
from ..core.serialize import device_point_to_ints, device_points_to_ints
from ..parallel import mesh as PM
from ..utils.trace import traced
from . import errors, kzg10
from .curve_ctx import CTX_BLS12_377, CTX_BLS12_381
from .data_structures import (
    HostRng,
    LabeledCommitment,
    PolynomialCommitment,
    _group_queries,
    _pt_key,
    derive_batch_rng,
)

SPEC = FR_BLS12_381


# ---------------------------------------------------------------------------
# sparse multivariate polynomials (host ints, term = exponent tuple)
# ---------------------------------------------------------------------------


class MVPoly:
    """terms: dict[tuple[int, ...]] -> int coefficient (canonical, mod p)."""

    def __init__(self, num_vars: int, terms: Optional[dict] = None, spec=SPEC):
        self.num_vars = num_vars
        self.spec = spec
        self.terms = {}
        for t, c in (terms or {}).items():
            c %= spec.modulus
            if c:
                self.terms[tuple(t)] = c

    def degree(self) -> int:
        return max((sum(t) for t in self.terms), default=0)

    def is_zero(self) -> bool:
        return not self.terms

    def evaluate(self, point) -> int:
        """sum_t c_t prod_i z_i^(t_i), the powers of each z_i from one table
        (the JAX version calls ``pow`` a factor; the same value)."""
        p = self.spec.modulus
        top = self.degree()
        tables = []
        for v in point[: self.num_vars]:
            z, row = int(v) % p, [1]
            for _ in range(top):
                row.append(row[-1] * z % p)
            tables.append(row)
        acc = 0
        for t, c in self.terms.items():
            for row, e in zip(tables, t):
                if e:
                    c = c * row[e] % p
            acc += c
        return acc % p

    def scaled_add(self, other: "MVPoly", k: int) -> "MVPoly":
        p = self.spec.modulus
        out = dict(self.terms)
        for t, c in other.terms.items():
            out[t] = (out.get(t, 0) + k * c) % p
        return MVPoly(self.num_vars, out, spec=self.spec)

    @classmethod
    def rand(cls, rng: HostRng, num_vars: int, degree: int, num_terms: int = 8, spec=SPEC):
        terms = {}
        for _ in range(num_terms):
            d = rng.randint(0, degree)
            t = [0] * num_vars
            for _ in range(d):
                t[rng.randint(0, num_vars - 1)] += 1
            terms[tuple(t)] = rng.field_int(spec)
        return cls(num_vars, terms, spec=spec)


def divide_at_point(poly: MVPoly, point) -> list:
    """p(X) - p(z) = sum_i (X_i - z_i) w_i(X) (mod.rs:44-92)."""
    p = poly.spec.modulus
    nv = poly.num_vars
    quotients = []
    cur = poly.terms
    for i in range(nv):
        zi = int(point[i]) % p
        q: dict = {}
        rem: dict = {}

        def addto(d, t, c):
            d[t] = (d.get(t, 0) + c) % p

        for term, coeff in cur.items():
            if not any(term):
                continue  # constants cancel in the final remainder
            e = term[i]
            if e == 0:
                addto(rem, term, coeff)
                continue
            c = coeff
            tl = list(term)
            while tl[i] > 1:
                tl[i] -= 1
                addto(q, tuple(tl), c)
                c = c * zi % p
            tl[i] = 0
            addto(q, tuple(tl), c)
            addto(rem, tuple(tl), zi * c % p)
        quotients.append(MVPoly(nv, q, spec=poly.spec))
        cur = {t: c for t, c in rem.items() if c}
    return quotients


def _all_monomials(num_vars: int, max_degree: int):
    """All exponent tuples with 1 <= total degree <= max_degree, plus the
    constant term appended last (mirrors setup order, mod.rs:185-212)."""
    out = []
    for d in range(1, max_degree + 1):
        for combo in itertools.combinations_with_replacement(range(num_vars), d):
            t = [0] * num_vars
            for v in combo:
                t[v] += 1
            out.append(tuple(t))
    out.append(tuple([0] * num_vars))
    return out


def _monomial_values(betas, max_degree: int, p: int) -> list:
    """prod_i beta_i^(t_i) for each monomial t of ``_all_monomials``, in its
    order: degree d's combinations (lexicographic) are degree d-1's, each
    followed by every variable from its last one on, so each value is its
    parent's times one beta (the JAX setup raises each factor with ``pow``;
    the same values)."""
    nv = len(betas)
    level = [(v, betas[v]) for v in range(nv)]  # (last variable, value)
    out = [val for _, val in level]
    for _ in range(2, max_degree + 1):
        level = [(v, val * betas[v] % p) for last, val in level for v in range(last, nv)]
        out.extend(val for _, val in level)
    out.append(1)
    return out


# ---------------------------------------------------------------------------
# data structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UniversalParams:
    num_vars: int
    max_degree: int
    term_index: dict  # exponent tuple -> row in powers_of_g
    powers_of_g: tuple  # device affine (T,)
    gamma_g: tuple  # host triple
    powers_of_gamma_g: list  # per var: host triples (beta_i^j gamma_g, j = 1..max+1)
    h: tuple  # host G2 triple
    beta_h: list  # host G2 triples


@dataclasses.dataclass
class CommitterKey:
    num_vars: int
    supported_degree: int
    max_degree: int
    term_index: dict
    powers_of_g: tuple
    gamma_g: tuple
    powers_of_gamma_g: list


@dataclasses.dataclass
class VerifierKey:
    num_vars: int
    supported_degree: int
    max_degree: int
    g: tuple
    gamma_g: tuple
    h: tuple
    beta_h: list


@dataclasses.dataclass
class Commitment:
    comm: tuple  # host triple
    shifted_comm: Optional[tuple] = None


@dataclasses.dataclass
class Randomness:
    blinding_polynomial: MVPoly

    def is_hiding(self):
        return not self.blinding_polynomial.is_zero()


@dataclasses.dataclass
class Proof:
    """data_structures.rs:459-465."""

    w: list  # nv host triples
    random_v: Optional[int] = None


# ---------------------------------------------------------------------------
# the scheme
# ---------------------------------------------------------------------------


class MarlinPST13(PolynomialCommitment):
    """BLS12-381 instantiation; MarlinPST13_BLS12_377 overrides CTX (the
    reference's two-curve test matrix, marlin_pst13_pc tests)."""

    CTX = CTX_BLS12_381
    spec = SPEC

    @classmethod
    @traced("MarlinPST13::setup")
    def setup(cls, max_degree, num_vars=None, rng=None, device=None):
        if num_vars is None or num_vars < 1:
            raise errors.InvalidNumberOfVariables()
        if max_degree < 1:
            raise errors.DegreeIsZero()
        dev = D.resolve(device)
        rng = rng or HostRng(0)
        ctx = cls.CTX
        g1, g2, spec = ctx.g1, ctx.g2, ctx.spec
        p = spec.modulus
        betas = [rng.field_int(spec) for _ in range(num_vars)]
        g_k = rng.field_int(spec)
        gg_k = rng.field_int(spec)
        h_k = rng.field_int(spec)
        g = C.scalar_mul_int(g1, g1.generator(dev), g_k)
        gamma_g = C.scalar_mul_int(g1, g1.generator(dev), gg_k)
        h = ctx.hg2.mul_fast(g2.generator_host(), h_k)

        monomials = _all_monomials(num_vars, max_degree)
        vals = _monomial_values(betas, max_degree, p)
        powers_of_g = g1.to_affine(M.fixed_base_mul(g1, g, M.scalars_from_ints(spec, vals, dev)))
        term_index = {t: i for i, t in enumerate(monomials)}

        # beta_i^j gamma_g for every variable i and j = 1..max_degree+1: one
        # fixed-base multiplication (the JAX package runs one a variable)
        bpows = []
        for b in betas:
            cur = 1
            for _ in range(max_degree + 1):
                cur = cur * b % p
                bpows.append(cur)
        gpts = device_points_to_ints(g1, M.fixed_base_mul(
            g1, gamma_g, M.scalars_from_ints(spec, bpows, dev)))
        powers_of_gamma_g = [gpts[i * (max_degree + 1) : (i + 1) * (max_degree + 1)]
                             for i in range(num_vars)]

        h_dev = hostec.host_point_to_device(g2, h, dev)
        beta_h = device_points_to_ints(g2, M.fixed_base_mul(
            g2, h_dev, M.scalars_from_ints(spec, betas, dev)))

        return UniversalParams(
            num_vars=num_vars,
            max_degree=max_degree,
            term_index=term_index,
            powers_of_g=powers_of_g,
            gamma_g=device_point_to_ints(g1, gamma_g),
            powers_of_gamma_g=powers_of_gamma_g,
            h=hostec.host_to_triple(h, fq2=True),
            beta_h=beta_h,
        )

    @classmethod
    @traced("MarlinPST13::trim")
    def trim(cls, pp, supported_degree, supported_hiding_bound=0, enforced_degree_bounds=None):
        if supported_degree > pp.max_degree:
            raise errors.TrimmingDegreeTooLarge()
        keep = {t: i for t, i in pp.term_index.items() if sum(t) <= supported_degree}
        ck = CommitterKey(
            num_vars=pp.num_vars,
            supported_degree=supported_degree,
            max_degree=pp.max_degree,
            term_index=keep,
            powers_of_g=pp.powers_of_g,
            gamma_g=pp.gamma_g,
            powers_of_gamma_g=[v[: supported_degree + 1] for v in pp.powers_of_gamma_g],
        )
        g_row = pp.term_index[tuple([0] * pp.num_vars)]
        vk = VerifierKey(
            num_vars=pp.num_vars,
            supported_degree=supported_degree,
            max_degree=pp.max_degree,
            g=kzg10.affine_at(cls.CTX.g1, pp.powers_of_g, [g_row])[0],
            gamma_g=pp.gamma_g,
            h=pp.h,
            beta_h=pp.beta_h,
        )
        return ck, vk

    @classmethod
    def _check_degrees(cls, supported_degree, lp):
        if lp.poly.degree() > supported_degree:
            raise errors.PolynomialDegreeTooLarge(lp.poly.degree(), supported_degree, lp.label)
        if lp.degree_bound is not None:
            raise errors.UnsupportedDegreeBound(lp.degree_bound)

    @classmethod
    def _term_msm(cls, ck, poly: MVPoly):
        """Gather the term-indexed SRS rows on the device; one G1 MSM
        (mod.rs:352-364), sharded over an active mesh of more than one
        rank."""
        g1, spec = cls.CTX.g1, cls.CTX.spec
        dev = ck.powers_of_g[0].device
        if poly.is_zero():
            return g1.infinity((), dev)
        rows = []
        for t in poly.terms:
            if t not in ck.term_index:
                raise errors.PolynomialDegreeTooLarge(sum(t), ck.supported_degree)
            rows.append(ck.term_index[t])
        idx = torch.tensor(rows, dtype=torch.long, device=dev)
        key = tuple(a.index_select(0, idx) for a in ck.powers_of_g)
        sc = M.scalars_from_ints(spec, poly.terms.values(), dev)
        active = PM.active_mesh()
        if active is not None and active[0].size(active[1]) > 1:
            mesh, axis = active
            psc, pkey = PM.pad_msm_inputs(g1, sc, key, mesh.size(axis))
            return PM.msm_sharded(g1, psc, pkey, mesh, axis=axis, assume_distinct=True)
        return M.msm(g1, sc, key, assume_distinct=True)

    @classmethod
    def _gamma_msm(cls, ck, blind: MVPoly):
        """Blinding commitment on the host (few univariate monomials)."""
        hg1 = cls.CTX.hg1
        acc = None
        for t, c in blind.terms.items():
            nz = [v for v, e in enumerate(t) if e]
            if not nz:
                base = hostec.triple_to_host(ck.gamma_g)
            else:
                if len(nz) != 1:
                    raise ValueError("blinding monomials must be univariate")
                var = nz[0]
                base = hostec.triple_to_host(ck.powers_of_gamma_g[var][t[var] - 1])
            acc = hg1.add(acc, hg1.mul(base, c))
        return acc

    @classmethod
    def _rand_blinding(cls, rng, num_vars, hiding_degree):
        spec = cls.CTX.spec
        terms = {tuple([0] * num_vars): rng.field_int(spec)}
        for var in range(num_vars):
            for j in range(1, hiding_degree + 1):
                t = [0] * num_vars
                t[var] = j
                terms[tuple(t)] = rng.field_int(spec)
        return MVPoly(num_vars, terms, spec=spec)

    @classmethod
    def evaluate_poly(cls, labeled_poly, point):
        return labeled_poly.poly.evaluate(point)

    @classmethod
    @traced("MarlinPST13::commit")
    def commit(cls, ck, polynomials, rng=None):
        comms, states = [], []
        for lp in polynomials:
            cls._check_degrees(ck.supported_degree, lp)
            pt = cls._term_msm(ck, lp.poly)
            host = hostec.triple_to_host(device_point_to_ints(cls.CTX.g1, pt))
            blind = MVPoly(ck.num_vars, spec=cls.CTX.spec)
            if lp.hiding_bound is not None:
                if rng is None:
                    raise errors.MissingRng()
                if lp.hiding_bound == 0:
                    raise errors.HidingBoundIsZero()
                if lp.hiding_bound >= ck.supported_degree + 1:
                    raise errors.HidingBoundToolarge(lp.hiding_bound, ck.supported_degree + 1)
                blind = cls._rand_blinding(rng, ck.num_vars, lp.hiding_bound)
                host = cls.CTX.hg1.add(host, cls._gamma_msm(ck, blind))
            comms.append(LabeledCommitment(lp.label, Commitment(hostec.host_to_triple(host)), None))
            states.append(Randomness(blind))
        return comms, states

    @classmethod
    @traced("MarlinPST13::open")
    def open(cls, ck, polynomials, commitments, point, sponge, states, rng=None):
        """mod.rs:419-512."""
        p_comb = MVPoly(ck.num_vars, spec=cls.CTX.spec)
        r_comb = MVPoly(ck.num_vars, spec=cls.CTX.spec)
        for lp, st in zip(polynomials, states):
            cls._check_degrees(ck.supported_degree, lp)
            ch = sponge.squeeze_challenge_128()
            p_comb = p_comb.scaled_add(lp.poly, ch)
            r_comb = r_comb.scaled_add(st.blinding_polynomial, ch)

        witnesses = divide_at_point(p_comb, point)
        w_hosts = [hostec.triple_to_host(device_point_to_ints(cls.CTX.g1, cls._term_msm(ck, w)))
                   for w in witnesses]
        random_v = None
        if not r_comb.is_zero():
            hiding_witnesses = divide_at_point(r_comb, point)
            w_hosts = [cls.CTX.hg1.add(w, cls._gamma_msm(ck, hw))
                       for w, hw in zip(w_hosts, hiding_witnesses)]
            random_v = r_comb.evaluate(point)
        return Proof(w=[hostec.host_to_triple(w) for w in w_hosts], random_v=random_v)

    @classmethod
    def _accumulate(cls, vk, commitments, values, sponge):
        """Marlin::accumulate_commitments_and_values (marlin/mod.rs:109-148);
        no degree bounds in PST13 commitments."""
        hg1 = cls.CTX.hg1
        p = cls.CTX.spec.modulus
        combined = None
        combined_value = 0
        for lc, v in zip(commitments, values):
            ch = sponge.squeeze_challenge_128()
            combined = hg1.add(combined, hg1.mul(hostec.triple_to_host(lc.commitment.comm), ch))
            combined_value = (combined_value + int(v) * ch) % p
        return combined, combined_value

    @classmethod
    def _vk_prepared(cls, vk, key, triple):
        """Per-vk cached G2 line precomputation (the reference's prepared_h /
        prepared_beta_h, marlin_pst13_pc/data_structures.rs)."""
        cache = vk.__dict__.setdefault("_prep_cache", {})
        if key not in cache:
            cache[key] = cls.CTX.prepare_g2(triple)
        return cache[key]

    @classmethod
    @traced("MarlinPST13::check")
    def check(cls, vk, commitments, point, values, proof, sponge):
        """e(C - v g - rv gamma_g + sum_j z_j w_j, h) prod_j e(-w_j, beta_j h)
        == 1 (mod.rs:516-558, arranged so every G2 point is a fixed vk
        element with precomputed Miller lines)."""
        hg1 = cls.CTX.hg1
        p = cls.CTX.spec.modulus
        combined, combined_value = cls._accumulate(vk, commitments, values, sponge)
        inner = hg1.sub(combined, hg1.mul(hostec.triple_to_host(vk.g), combined_value))
        if proof.random_v is not None:
            inner = hg1.sub(inner, hg1.mul(hostec.triple_to_host(vk.gamma_g), proof.random_v))
        for j in range(vk.num_vars):
            inner = hg1.add(inner, hg1.mul(hostec.triple_to_host(proof.w[j]), int(point[j]) % p))
        g1s = [hostec.host_to_triple(inner)]
        g2s = [vk.h]
        prepared = [cls._vk_prepared(vk, "h", vk.h)]
        for j in range(vk.num_vars):
            g1s.append(hostec.host_to_triple(hg1.neg(hostec.triple_to_host(proof.w[j]))))
            g2s.append(vk.beta_h[j])
            prepared.append(cls._vk_prepared(vk, ("beta_h", j), vk.beta_h[j]))
        return cls.CTX.pairing_product_is_one(g1s, g2s, prepared=prepared)

    @classmethod
    @traced("MarlinPST13::batch_check")
    def batch_check(cls, vk, commitments, query_set, evaluations, proofs, sponge, rng=None):
        """mod.rs:560-636."""
        hg1 = cls.CTX.hg1
        p = cls.CTX.spec.modulus
        comms = {c.label: c for c in commitments}
        grouped = _group_queries(query_set)
        if len(grouped) != len(proofs):
            raise ValueError(f"{len(proofs)} proofs for {len(grouped)} points")
        rng = rng or derive_batch_rng(
            sponge, [c.label for c in commitments], [lc.commitment for lc in commitments],
            grouped, {str(k): int(v) for k, v in evaluations.items()}, proofs,
        )
        randomizer = 1
        total_c = None
        total_w = [None] * vk.num_vars
        g_mult = 0
        gg_mult = 0
        for ((point_label, point), labels), proof in zip(grouped, proofs):
            cs, vs = [], []
            for label in labels:
                if label not in comms:
                    raise errors.MissingPolynomial(label)
                key = (label, _pt_key(point))
                if key not in evaluations:
                    raise errors.MissingEvaluation(str(key))
                cs.append(comms[label])
                vs.append(int(evaluations[key]) % p)
            combined, combined_value = cls._accumulate(vk, cs, vs, sponge)
            temp = combined
            for j in range(vk.num_vars):
                wj = hostec.triple_to_host(proof.w[j])
                temp = hg1.add(temp, hg1.mul(wj, int(point[j]) % p))
                total_w[j] = hg1.add(total_w[j], hg1.mul(wj, randomizer))
            g_mult = (g_mult + randomizer * combined_value) % p
            if proof.random_v is not None:
                gg_mult = (gg_mult + randomizer * proof.random_v) % p
            total_c = hg1.add(total_c, hg1.mul(temp, randomizer))
            randomizer = rng.u128()
        total_c = hg1.sub(total_c, hg1.mul(hostec.triple_to_host(vk.g), g_mult))
        total_c = hg1.sub(total_c, hg1.mul(hostec.triple_to_host(vk.gamma_g), gg_mult))
        g1s, g2s, prepared = [], [], []
        for j in range(vk.num_vars):
            g1s.append(hostec.host_to_triple(hg1.neg(total_w[j])))
            g2s.append(vk.beta_h[j])
            prepared.append(cls._vk_prepared(vk, ("beta_h", j), vk.beta_h[j]))
        g1s.append(hostec.host_to_triple(total_c))
        g2s.append(vk.h)
        prepared.append(cls._vk_prepared(vk, "h", vk.h))
        return cls.CTX.pairing_product_is_one(g1s, g2s, prepared=prepared)


class MarlinPST13_BLS12_377(MarlinPST13):
    """BLS12-377 instantiation (the reference's second test curve)."""

    CTX = CTX_BLS12_377
    spec = CTX_BLS12_377.spec
