"""Inner-product-argument PC (BCMS20, pairing-free) over JubJub.

Counterpart of poly_commit_tpu/pcs/ipa_pc.py (the reference's ipa_pc/mod.rs):
  sample_generators (hash-to-curve)   mod.rs:302-326
  cm_commit (Pedersen MSM)            mod.rs:54-72
  compute_random_oracle_challenge     mod.rs:74-87   (Blake2s digest)
  setup/trim (degree -> 2^k - 1)      mod.rs:337-401
  commit (+ shifted key slice)        mod.rs:403-472
  open (combine + log-d halving loop) mod.rs:475-723
  succinct_check                      mod.rs:91-203
  check / batch_check                 mod.rs:725-853
  SuccinctCheckPolynomial             data_structures.rs:200-237

The vector work runs on the device of the key: every Pedersen MSM (kernels
K3 and K2b), the inner products and folds of the coefficients and the
powers of z (K1 on the JubJub scalar field, each inner product one
product and one ``ff.fsum``), and the key fold
key_l + ch key_r of each round, whose scalar multiplication is one K2b
``ed_smul`` launch through ``JUBJUB.scalar_mul`` (the JAX package runs that
fold through its portable scan). Hash-to-curve, the transcript and the verifier's O(log d)
accumulation run on host ints, as do the h' terms of each round's L and R
(one point each). The shifted-key commitment is a shifted polynomial
against the full key (the same group element). The LC methods
(open_combinations / check_combinations) combine the commitments on host
ints and the polynomials on the device. Under an active mesh of more than
one rank, each round whose half divides by the axis size shards its two
MSMs and its key fold over the ranks (``parallel.mesh.msm_sharded``,
``fold_key_sharded``); the other rounds run locally, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Optional

import torch

from .. import device as D
from ..core import curve as C
from ..core import ff
from ..core import field as F
from ..core import field_params as FP
from ..core import hostec
from ..core import msm as M
from ..core import poly as P
from ..core.serialize import field_to_bytes, point_to_bytes_uncompressed
from ..parallel import mesh as PM
from ..utils.trace import traced
from . import errors
from .data_structures import (
    LabeledCommitment,
    LabeledPolynomial,
    PolynomialCommitment,
    _group_queries,
    _pt_key,
    derive_batch_rng,
)

GROUP = C.JUBJUB
SPEC = FP.FR_JUBJUB
BASE = FP.FR_BLS12_381  # JubJub's base field
HGROUP = hostec.host_group(GROUP)
PROTOCOL_NAME = b"PC-DL-2020"
COFACTOR = 8


# ---------------------------------------------------------------------------
# deterministic generators (mod.rs:302-326)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _ts_consts(p: int):
    """p - 1 = q 2^s and c = z^q for the least non-residue z: fixed per
    modulus, so computed once."""
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return q, s, pow(z, q, p)


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """Tonelli-Shanks square root (BLS12-381 Fr has 2-adicity 32)."""
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, m, c = _ts_consts(p)
    t, r = pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tmp = 0, t
        while tmp != 1:
            tmp = tmp * tmp % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def _hash_to_curve_ts(seed: bytes):
    """Hash-to-curve by Tonelli-Shanks (Fr of BLS12-381 is 1 mod 2^32)."""
    p = BASE.modulus
    d = FP.JUBJUB_D
    j = 0
    while True:
        h = hashlib.blake2s(seed + j.to_bytes(8, "little")).digest()
        y = int.from_bytes(h, "little") % p
        num = (y * y - 1) % p
        den = (1 + d * y * y) % p
        if den != 0:
            x = _sqrt_mod(num * pow(den, -1, p) % p, p)
            if x is not None:
                if h[0] & 1:
                    x = (p - x) % p
                pt = HGROUP.mul((x, y), COFACTOR)
                if pt != (0, 1):
                    return pt
        j += 1


def sample_generators(num: int):
    """Deterministic Pedersen key: hash-derived points with unknown dlogs."""
    return [_hash_to_curve_ts(PROTOCOL_NAME + i.to_bytes(8, "little")) for i in range(num)]


def _ro_challenge(data: bytes) -> int:
    """Blake2s random-oracle challenge (mod.rs:74-87); masked below modulus."""
    i = 0
    while True:
        h = hashlib.blake2s(data + i.to_bytes(8, "little")).digest()
        v = int.from_bytes(h, "little") & ((1 << (SPEC.num_bits - 1)) - 1)
        if v != 0:
            return v
        i += 1


# ---------------------------------------------------------------------------
# data structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UniversalParams:
    comm_key: tuple  # device affine (max_degree+1,)
    h: tuple  # host (x, y)
    s: tuple
    max_degree: int


@dataclasses.dataclass
class CommitterKey:
    comm_key: tuple  # device affine (supported+1,)
    h: tuple
    s: tuple
    max_degree: int

    @property
    def supported_degree(self):
        return int(self.comm_key[0].shape[0]) - 1


VerifierKey = CommitterKey


@dataclasses.dataclass
class Commitment:
    comm: tuple  # host (x, y)
    shifted_comm: Optional[tuple] = None


@dataclasses.dataclass
class Randomness:
    rand: int = 0
    shifted_rand: Optional[int] = None


@dataclasses.dataclass
class Proof:
    """data_structures.rs:175-195."""

    l_vec: list  # host points
    r_vec: list
    final_comm_key: tuple
    c: int
    hiding_comm: Optional[tuple] = None
    rand: Optional[int] = None


class SuccinctCheckPolynomial:
    """h(X) = prod_i (1 + xi_i X^{2^{log_d - i}}) (data_structures.rs:200-237)."""

    def __init__(self, challenges: list):
        self.challenges = challenges

    def evaluate(self, point: int) -> int:
        p = SPEC.modulus
        k = len(self.challenges)
        out = 1
        for i, ch in enumerate(self.challenges, start=1):
            out = out * (1 + ch * pow(point, 1 << (k - i), p)) % p
        return out

    def compute_coeffs_device(self, device=None) -> torch.Tensor:
        """(2^k, L) Montgomery coefficients by k doubling concatenations: the
        last challenge governs the lowest index bit (data_structures.rs:206-222)."""
        t = F.one_mont(SPEC, (1,), device)
        for ch in reversed(self.challenges):
            t = torch.cat([t, F.mont_mul(SPEC, t, F.from_ints(SPEC, ch, device=t.device))], 0)
        return t


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _inner_product(a: torch.Tensor, b: torch.Tensor) -> int:
    """<a, b> of two field-last (n, L) vectors: one K1 product of the
    limbs-first operands, then ``ff.fsum`` (at most two launches)."""
    prod = ff.mont_mul(SPEC, ff.from_field_last(a), ff.from_field_last(b))
    return ff.to_ints(SPEC, ff.fsum(SPEC, prod))[0]


def _to_host(pt_proj):
    """A device point (batch ()) -> host (x, y), normalised on host ints."""
    return hostec.device_proj_to_host(GROUP, pt_proj)


def _cm_commit(key_aff, coeffs_mont, s_host=None, randomizer=None):
    """Pedersen MSM (mod.rs:54-72) on the device; the hiding term on host."""
    n = int(key_aff[0].shape[0])
    c = coeffs_mont
    if c.shape[0] < n:
        c = torch.cat([c, c.new_zeros((n - c.shape[0], c.shape[1]))], 0)
    host = _to_host(M.msm_mont(GROUP, c, key_aff, assume_distinct=True))
    if randomizer is not None:
        host = HGROUP.add(host, HGROUP.mul_fast(s_host, randomizer))
    return host


def fold_key(k_l, k_r, ch: int):
    """key_l + ch key_r over two device affine halves of the key: one K2b
    ``ed_smul`` launch, one add, one batched normalisation."""
    kr_mul = GROUP.scalar_mul(GROUP.from_affine(*k_r), ch)
    return GROUP.to_affine(GROUP.add(GROUP.from_affine(*k_l), kr_mul))


def _mesh_for(half: int):
    """The active (mesh, axis) where it has more than one rank and its axis
    size divides ``half``, else None (that round runs locally)."""
    active = PM.active_mesh()
    if active is None:
        return None
    n_dev = active[0].size(active[1])
    return active if n_dev > 1 and half % n_dev == 0 else None


def _host_pt_bytes(pt) -> bytes:
    return point_to_bytes_uncompressed(GROUP, (pt[0], pt[1], False))


def params_from_generators(gens, device=None) -> UniversalParams:
    """Setup's second half: max_degree + 3 generators (sample_generators)
    -> the key on the device, with the last two as s and h."""
    *key, s, h = gens
    comm_key = C.affine_from_ints(GROUP, [(x, y, False) for x, y in key], D.resolve(device))
    return UniversalParams(comm_key=comm_key, h=h, s=s, max_degree=len(key) - 1)


def _next_pow2_minus_1(d: int) -> int:
    return (1 << (d + 1).bit_length() if (d + 1) & d else d + 1) - 1


# ---------------------------------------------------------------------------
# the scheme
# ---------------------------------------------------------------------------


class InnerProductArgPC(PolynomialCommitment):
    spec = SPEC

    @classmethod
    @traced("IPA_PC::setup")
    def setup(cls, max_degree, num_vars=None, rng=None, device=None):
        """The key for degree next_power_of_two(max_degree + 1) - 1: that
        many generators plus h and s, hashed to the curve on the host."""
        max_degree = _next_pow2_minus_1(max_degree)
        return params_from_generators(sample_generators(max_degree + 3), device)

    @classmethod
    @traced("IPA_PC::trim")
    def trim(cls, pp, supported_degree, supported_hiding_bound=0, enforced_degree_bounds=None):
        supported_degree = _next_pow2_minus_1(supported_degree)
        if supported_degree > pp.max_degree:
            raise errors.TrimmingDegreeTooLarge()
        key = tuple(a[: supported_degree + 1] for a in pp.comm_key)
        ck = CommitterKey(comm_key=key, h=pp.h, s=pp.s, max_degree=pp.max_degree)
        return ck, ck

    @classmethod
    def _check_degrees_and_bounds(cls, supported_degree, lp):
        if lp.degree() > supported_degree:
            raise errors.TooManyCoefficients(lp.degree() + 1, supported_degree + 1)
        if lp.degree_bound is not None:
            if lp.degree_bound < lp.degree() or lp.degree_bound > supported_degree:
                raise errors.IncorrectDegreeBound(lp.degree(), lp.degree_bound, supported_degree,
                                                  lp.label)

    @classmethod
    @traced("IPA_PC::commit")
    def commit(cls, ck, polynomials, rng=None):
        comms, states = [], []
        d = ck.supported_degree
        for lp in polynomials:
            cls._check_degrees_and_bounds(d, lp)
            if lp.hiding_bound is not None:
                if rng is None:
                    raise errors.MissingRng()
                state = Randomness(
                    rand=rng.field_int(SPEC),
                    shifted_rand=rng.field_int(SPEC) if lp.degree_bound is not None else None,
                )
            else:
                state = Randomness(rand=0, shifted_rand=None)
            rand = state.rand if lp.hiding_bound is not None else None
            comm = _cm_commit(ck.comm_key, lp.poly, ck.s, rand)
            shifted = None
            if lp.degree_bound is not None:
                # key slice [(d - bound)..] == shifted poly against the full key
                sh = P.shift(lp.poly, d - lp.degree_bound)
                shifted = _cm_commit(ck.comm_key, sh, ck.s, state.shifted_rand)
            comms.append(LabeledCommitment(lp.label, Commitment(comm, shifted), lp.degree_bound))
            states.append(state)
        return comms, states

    @classmethod
    @traced("IPA_PC::open")
    def open(cls, ck, polynomials, commitments, point, sponge, states, rng=None):
        """mod.rs:475-723."""
        d = ck.supported_degree
        dev = ck.comm_key[0].device
        z_int = int(point) % SPEC.modulus
        p_mod = SPEC.modulus

        combined = None
        combined_rand = 0
        combined_comm = None
        has_hiding = False
        for lp, lcm, st in zip(polynomials, commitments, states):
            cls._check_degrees_and_bounds(d, lp)
            ch = sponge.squeeze_challenge_128()
            scaled = P.scale(SPEC, lp.poly, F.from_ints(SPEC, ch, device=dev))
            combined = scaled if combined is None else P.add(SPEC, combined, scaled)
            combined_comm = HGROUP.add(combined_comm or (0, 1),
                                       HGROUP.mul_fast(lcm.commitment.comm, ch))
            if lp.hiding_bound is not None:
                has_hiding = True
                combined_rand = (combined_rand + ch * st.rand) % p_mod
            ch2 = sponge.squeeze_challenge_128()
            if lp.degree_bound is not None:
                sh = P.shift(lp.poly, d - lp.degree_bound)
                combined = P.add(SPEC, combined, P.scale(SPEC, sh, F.from_ints(SPEC, ch2, device=dev)))
                combined_comm = HGROUP.add(combined_comm,
                                           HGROUP.mul_fast(lcm.commitment.shifted_comm, ch2))
                if lp.hiding_bound is not None:
                    combined_rand = (combined_rand + ch2 * st.shifted_rand) % p_mod

        zf = F.from_ints(SPEC, z_int, device=dev)
        combined_v = F.to_ints(SPEC, P.evaluate(SPEC, combined, zf))

        hiding_comm = None
        if has_hiding:
            if rng is None:
                # hiding randomness must come from the caller (the
                # reference's OptionalRng panics here, optional_rng.rs:10-50)
                raise errors.MissingRng()
            hp_ints = rng.field_ints(SPEC, d + 1)
            hp = F.from_ints(SPEC, hp_ints, device=dev)
            # subtract its value at the point so it opens to zero
            hv = F.to_ints(SPEC, P.evaluate(SPEC, hp, zf))
            hp_ints[0] = (hp_ints[0] - hv) % p_mod
            hp = F.from_ints(SPEC, hp_ints, device=dev)
            hiding_rand = rng.field_int(SPEC)
            hiding_comm = _cm_commit(ck.comm_key, hp, ck.s, hiding_rand)
            data = (_host_pt_bytes(combined_comm) + field_to_bytes(SPEC, z_int)
                    + field_to_bytes(SPEC, combined_v) + _host_pt_bytes(hiding_comm))
            hch = _ro_challenge(data)
            combined = P.add(SPEC, combined, P.scale(SPEC, hp, F.from_ints(SPEC, hch, device=dev)))
            combined_rand = (combined_rand + hch * hiding_rand) % p_mod
            combined_comm = HGROUP.sub(
                HGROUP.add(combined_comm, HGROUP.mul_fast(hiding_comm, hch)),
                HGROUP.mul_fast(ck.s, combined_rand),
            )

        # first round challenge (hash of C, z, v)
        data = _host_pt_bytes(combined_comm) + field_to_bytes(SPEC, z_int) + field_to_bytes(SPEC, combined_v)
        round_ch = _ro_challenge(data)
        h_prime = HGROUP.mul_fast(ck.h, round_ch)

        coeffs = combined
        if coeffs.shape[0] < d + 1:
            coeffs = torch.cat([coeffs, coeffs.new_zeros((d + 1 - coeffs.shape[0], coeffs.shape[1]))], 0)
        zpow = P.powers(SPEC, zf, d + 1)

        key = ck.comm_key
        l_vec, r_vec = [], []
        n = d + 1
        while n > 1:
            half = n // 2
            c_l, c_r = coeffs[:half], coeffs[half:n]
            z_l, z_r = zpow[:half], zpow[half:n]
            k_l = tuple(a[:half] for a in key)
            k_r = tuple(a[half:n] for a in key)

            # L = <c_r, G_l> + <c_r, z_l> h', R = <c_l, G_r> + <c_l, z_r> h'
            mk = _mesh_for(half)
            if mk is not None:
                l_msm = PM.msm_sharded(GROUP, F.from_mont(SPEC, c_r), k_l, mk[0], axis=mk[1],
                                       assume_distinct=True)
                r_msm = PM.msm_sharded(GROUP, F.from_mont(SPEC, c_l), k_r, mk[0], axis=mk[1],
                                       assume_distinct=True)
            else:
                l_msm = M.msm_mont(GROUP, c_r, k_l, assume_distinct=True)
                r_msm = M.msm_mont(GROUP, c_l, k_r, assume_distinct=True)
            l_host = HGROUP.add(_to_host(l_msm), HGROUP.mul_fast(h_prime, _inner_product(c_r, z_l)))
            r_host = HGROUP.add(_to_host(r_msm), HGROUP.mul_fast(h_prime, _inner_product(c_l, z_r)))
            l_vec.append(l_host)
            r_vec.append(r_host)

            data = field_to_bytes(SPEC, round_ch) + _host_pt_bytes(l_host) + _host_pt_bytes(r_host)
            round_ch = _ro_challenge(data)
            chf = F.from_ints(SPEC, round_ch, device=dev)
            chf_inv = F.from_ints(SPEC, pow(round_ch, -1, p_mod), device=dev)

            coeffs = F.add(SPEC, c_l, F.mont_mul(SPEC, c_r, chf_inv))
            zpow = F.add(SPEC, z_l, F.mont_mul(SPEC, z_r, chf))
            if mk is not None:
                key = PM.fold_key_sharded(GROUP, k_l, k_r, round_ch, mk[0], axis=mk[1])
            else:
                key = fold_key(k_l, k_r, round_ch)
            n = half

        x, y, inf = (a[0] for a in key)
        final_key = (0, 1) if bool(inf) else (F.to_ints(BASE, x), F.to_ints(BASE, y))
        return Proof(
            l_vec=l_vec,
            r_vec=r_vec,
            final_comm_key=final_key,
            c=F.to_ints(SPEC, coeffs[0]),
            hiding_comm=hiding_comm,
            rand=combined_rand if has_hiding else None,
        )

    # -- verifier ---------------------------------------------------------
    @classmethod
    def succinct_check(cls, vk, commitments, point, values, proof, sponge):
        """mod.rs:91-203. Returns SuccinctCheckPolynomial or None."""
        d = vk.supported_degree
        p_mod = SPEC.modulus
        z_int = int(point) % p_mod

        combined_comm = None
        combined_v = 0
        for lcm, v in zip(commitments, values):
            v = int(v) % p_mod
            ch = sponge.squeeze_challenge_128()
            combined_v = (combined_v + ch * v) % p_mod
            combined_comm = HGROUP.add(combined_comm or (0, 1),
                                       HGROUP.mul_fast(lcm.commitment.comm, ch))
            ch2 = sponge.squeeze_challenge_128()
            if lcm.degree_bound is not None:
                if lcm.commitment.shifted_comm is None:
                    return None
                shift = pow(z_int, d - lcm.degree_bound, p_mod)
                combined_v = (combined_v + ch2 * v * shift) % p_mod
                combined_comm = HGROUP.add(combined_comm,
                                           HGROUP.mul_fast(lcm.commitment.shifted_comm, ch2))

        if proof.hiding_comm is not None:
            if proof.rand is None:
                return None
            data = (_host_pt_bytes(combined_comm) + field_to_bytes(SPEC, z_int)
                    + field_to_bytes(SPEC, combined_v) + _host_pt_bytes(proof.hiding_comm))
            hch = _ro_challenge(data)
            combined_comm = HGROUP.sub(
                HGROUP.add(combined_comm, HGROUP.mul_fast(proof.hiding_comm, hch)),
                HGROUP.mul_fast(vk.s, proof.rand),
            )

        data = _host_pt_bytes(combined_comm) + field_to_bytes(SPEC, z_int) + field_to_bytes(SPEC, combined_v)
        round_ch = _ro_challenge(data)
        h_prime = HGROUP.mul_fast(vk.h, round_ch)
        round_comm = HGROUP.add(combined_comm, HGROUP.mul_fast(h_prime, combined_v))

        challenges = []
        for l_pt, r_pt in zip(proof.l_vec, proof.r_vec):
            data = field_to_bytes(SPEC, round_ch) + _host_pt_bytes(l_pt) + _host_pt_bytes(r_pt)
            round_ch = _ro_challenge(data)
            challenges.append(round_ch)
            round_comm = HGROUP.add(round_comm, HGROUP.add(
                HGROUP.mul_fast(l_pt, pow(round_ch, -1, p_mod)), HGROUP.mul_fast(r_pt, round_ch)))

        check_poly = SuccinctCheckPolynomial(challenges)
        v_prime = check_poly.evaluate(z_int) * proof.c % p_mod
        expected = HGROUP.add(HGROUP.mul_fast(proof.final_comm_key, proof.c),
                              HGROUP.mul_fast(h_prime, v_prime))
        if expected != round_comm:
            return None
        return check_poly

    @classmethod
    @traced("IPA_PC::check")
    def check(cls, vk, commitments, point, values, proof, sponge):
        d = vk.supported_degree
        log_d = (d + 1).bit_length() - 1
        if len(proof.l_vec) != len(proof.r_vec) or len(proof.l_vec) != log_d:
            raise errors.IncorrectInputLength(f"expected proof vectors of length {log_d}")
        check_poly = cls.succinct_check(vk, commitments, point, values, proof, sponge)
        if check_poly is None:
            return False
        coeffs = check_poly.compute_coeffs_device(vk.comm_key[0].device)
        return _cm_commit(vk.comm_key, coeffs) == proof.final_comm_key

    @classmethod
    @traced("IPA_PC::batch_check")
    def batch_check(cls, vk, commitments, query_set, evaluations, proofs, sponge, rng=None):
        """mod.rs:775-853: a random combination of the check polynomials,
        one MSM."""
        comms = {c.label: c for c in commitments}
        grouped = _group_queries(query_set)
        assert len(grouped) == len(proofs)
        rng = rng or derive_batch_rng(
            sponge, [c.label for c in commitments], [lc.commitment for lc in commitments],
            grouped, {str(k): int(v) for k, v in evaluations.items()}, proofs,
        )
        dev = vk.comm_key[0].device
        randomizer = 1
        combined_check_poly = None
        combined_final_key = None
        for ((point_label, point), labels), proof in zip(grouped, proofs):
            cs, vs = [], []
            for label in labels:
                if label not in comms:
                    raise errors.MissingPolynomial(label)
                key = (label, _pt_key(point))
                if key not in evaluations:
                    raise errors.MissingEvaluation(str(key))
                cs.append(comms[label])
                vs.append(evaluations[key])
            check_poly = cls.succinct_check(vk, cs, point, vs, proof, sponge)
            if check_poly is None:
                return False
            scaled = F.mont_mul(SPEC, check_poly.compute_coeffs_device(dev),
                                F.from_ints(SPEC, randomizer, device=dev))
            combined_check_poly = (scaled if combined_check_poly is None
                                   else F.add(SPEC, combined_check_poly, scaled))
            combined_final_key = HGROUP.add(combined_final_key or (0, 1),
                                            HGROUP.mul_fast(proof.final_comm_key, randomizer))
            randomizer = rng.u128()
        return _cm_commit(vk.comm_key, combined_check_poly) == combined_final_key

    # -- LC overrides (mod.rs:855-1050) -------------------------------------
    @classmethod
    def _lc_commitment(cls, lc, label_map):
        """The combined commitment of one linear combination (host points)
        and its degree bound: a bounded term stands alone with coefficient
        one."""
        p_mod = SPEC.modulus
        degree_bound, comb, scomb = None, None, None
        for coeff, term in lc.terms:
            if term == "one":
                continue
            if term not in label_map:
                raise errors.MissingPolynomial(term)
            cc = label_map[term]
            if cc.degree_bound is not None:
                if len(lc.terms) != 1:
                    raise errors.EquationHasDegreeBounds(lc.label)
                if coeff % p_mod != 1:
                    raise ValueError(f"{lc.label}: a degree-bounded term takes the coefficient 1")
                degree_bound = cc.degree_bound
            comb = HGROUP.add(comb or (0, 1), HGROUP.mul_fast(cc.commitment.comm, coeff))
            if cc.commitment.shifted_comm is not None:
                scomb = HGROUP.add(scomb or (0, 1),
                                   HGROUP.mul_fast(cc.commitment.shifted_comm, coeff))
        return LabeledCommitment(lc.label, Commitment(comb, scomb), degree_bound)

    @classmethod
    def open_combinations(cls, ck, linear_combinations, polynomials, commitments,
                          eqn_query_set, sponge, states, rng=None):
        """Open each linear combination as one polynomial: its coefficients,
        randomness and commitment combined (mod.rs:855-953); the constant
        terms stay out of the polynomial, and check_combinations takes them
        off the claimed values."""
        p_mod = SPEC.modulus
        dev = ck.comm_key[0].device
        polys = {p.label: (p, s) for p, s in zip(polynomials, states)}
        comms = {c.label: c for c in commitments}
        lc_polys, lc_states, lc_comms = [], [], []
        for lc in linear_combinations:
            lc_comm = cls._lc_commitment(lc, comms)
            poly, hiding_bound, rand_acc, srand_acc = None, None, 0, None
            for coeff, term in lc.terms:
                if term == "one":
                    continue
                if term not in polys:
                    raise errors.MissingPolynomial(term)
                cp, cs = polys[term]
                hiding_bound = max(hiding_bound or 0, cp.hiding_bound or 0) or None
                scaled = P.scale(SPEC, cp.poly, F.from_ints(SPEC, coeff, device=dev))
                poly = scaled if poly is None else P.add(SPEC, poly, scaled)
                rand_acc = (rand_acc + coeff * cs.rand) % p_mod
                if cs.shifted_rand is not None:
                    srand_acc = ((srand_acc or 0) + coeff * cs.shifted_rand) % p_mod
            if poly is None:
                poly = F.zeros(SPEC, (1,), dev)
            lc_polys.append(LabeledPolynomial(lc.label, poly, lc_comm.degree_bound, hiding_bound))
            lc_states.append(Randomness(rand=rand_acc, shifted_rand=srand_acc))
            lc_comms.append(lc_comm)
        proofs, _ = cls.batch_open(ck, lc_polys, lc_comms, eqn_query_set, sponge, lc_states, rng)
        return (proofs, None)

    @classmethod
    def check_combinations(cls, vk, linear_combinations, commitments, eqn_query_set,
                           eqn_evaluations, proof_and_evals, sponge):
        """mod.rs:955-1050: each combination's commitment, and its claimed
        values less the constant terms, through batch_check."""
        proofs, _ = proof_and_evals
        comms = {c.label: c for c in commitments}
        p_mod = SPEC.modulus
        evals = {k: int(v) % p_mod for k, v in eqn_evaluations.items()}
        lc_comms = []
        for lc in linear_combinations:
            for coeff, term in lc.terms:
                if term == "one":
                    for key in [k for k in evals if k[0] == lc.label]:
                        evals[key] = (evals[key] - coeff) % p_mod
            lc_comms.append(cls._lc_commitment(lc, comms))
        return cls.batch_check(vk, lc_comms, eqn_query_set, evals, proofs, sponge)
