"""Labeled data types and the PolynomialCommitment protocol.

A copy of poly_commit_tpu/pcs/data_structures.py for the PyTorch port.
Mirrors the reference's L1 abstraction (poly-commit/src/lib.rs:164-577 and
data_structures.rs): labeled polynomials/commitments, query sets, linear
combinations, and a scheme-generic base class whose ``batch_open`` /
``batch_check`` / ``open_combinations`` / ``check_combinations`` defaults
group queries by point and reduce to per-point ``open``/``check`` (the
default impls at lib.rs:269-576). ``HostRng`` is the same ChaCha20 stream,
so both packages draw the same randomness from the same seed.

Polynomials are (D+1, L) int32 Montgomery limb tensors plus host metadata.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

import numpy as np
import torch

from ..core import field as F
from ..core.field_params import FieldSpec
from ..core.transcript import PoseidonSponge
from ..utils.trace import traced
from . import errors

# ---------------------------------------------------------------------------
# randomness (replaces OptionalRng, optional_rng.rs:10-50; the reference
# uses ChaCha20Rng for all secret randomness — lib.rs:681, SURVEY §2.3)
# ---------------------------------------------------------------------------


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _chacha_blocks(key_words: np.ndarray, counter: int, nblocks: int,
                   nonce_words: Optional[np.ndarray] = None) -> bytes:
    """ChaCha20 keystream (RFC 8439 layout; 96-bit nonce, default zero),
    vectorized over `nblocks` consecutive counter values with numpy uint32
    lanes. Validated against the RFC 8439 §2.3.2 block vector
    (tests/test_arkworks_vectors.py)."""
    x = np.empty((16, nblocks), np.uint32)
    x[0:4] = np.array(
        [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32
    )[:, None]
    x[4:12] = key_words[:, None]
    x[12] = (np.arange(counter, counter + nblocks, dtype=np.uint64)
             & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    x[13:16] = 0 if nonce_words is None else np.asarray(
        nonce_words, np.uint32
    )[:, None]
    s = x.copy()

    def qr(a, b, c, d):
        s[a] += s[b]
        s[d] = _rotl(s[d] ^ s[a], 16)
        s[c] += s[d]
        s[b] = _rotl(s[b] ^ s[c], 12)
        s[a] += s[b]
        s[d] = _rotl(s[d] ^ s[a], 8)
        s[c] += s[d]
        s[b] = _rotl(s[b] ^ s[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    s += x
    # serialize: per block, 16 LE words
    return s.T.astype("<u4").tobytes()


class HostRng:
    """Deterministic seeded host CSPRNG (ChaCha20 keystream) producing field
    elements. Used for SRS trapdoors, hiding randomness, and batch-check
    randomizers — the places the reference uses ChaCha20Rng."""

    def __init__(self, seed: int = 0, *, key: Optional[bytes] = None):
        if key is None:
            key = hashlib.sha256(
                b"poly-commit-tpu:chacha20:"
                + int(seed).to_bytes(32, "little", signed=False)
            ).digest()
        self._key = np.frombuffer(key[:32], "<u4").copy()
        self._counter = 0
        self._buf = b""
        self._pos = 0

    @classmethod
    def from_bytes(cls, seed_bytes: bytes) -> "HostRng":
        return cls(key=hashlib.sha256(b"poly-commit-tpu:derived:" + seed_bytes).digest())

    def bytes(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._pos >= len(self._buf):
                nblocks = max(64, (n + 63) // 64)  # refill >= 4 KiB at a time
                self._buf = _chacha_blocks(self._key, self._counter, nblocks)
                self._counter += nblocks
                self._pos = 0
            take = min(n, len(self._buf) - self._pos)
            out += self._buf[self._pos : self._pos + take]
            self._pos += take
            n -= take
        return bytes(out)

    def getrandbits(self, k: int) -> int:
        nb = (k + 7) // 8
        return int.from_bytes(self.bytes(nb), "little") >> (nb * 8 - k)

    def field_int(self, spec: FieldSpec) -> int:
        return self.getrandbits(spec.num_bits + 64) % spec.modulus

    def field_ints(self, spec: FieldSpec, n: int):
        return [self.field_int(spec) for _ in range(n)]

    def field_elems(self, spec: FieldSpec, n: int, device=None) -> torch.Tensor:
        return F.from_ints(spec, self.field_ints(spec, n), device=device)

    def u128(self) -> int:
        return self.getrandbits(128)

    def u64(self) -> int:
        return self.getrandbits(64)

    def randint(self, lo: int, hi: int) -> int:
        # inclusive range, unbiased enough (128-bit draw mod span)
        span = hi - lo + 1
        return lo + self.getrandbits(128) % span


def _hash_host_obj(h, obj):
    """Canonical type-tagged encoding of host data (ints, strs, tuples,
    dicts, dataclasses of those) into a hash state."""
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, bool):
        h.update(b"B1" if obj else b"B0")
    elif isinstance(obj, int):
        nb = (obj.bit_length() + 8) // 8 + 1  # signed-safe
        h.update(b"I" + nb.to_bytes(4, "little") + obj.to_bytes(nb, "little", signed=True))
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(b"S" + len(b).to_bytes(4, "little") + b)
    elif isinstance(obj, bytes):
        h.update(b"Y" + len(obj).to_bytes(4, "little") + obj)
    elif isinstance(obj, (list, tuple)):
        h.update(b"L" + len(obj).to_bytes(4, "little"))
        for it in obj:
            _hash_host_obj(h, it)
    elif isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: str(kv[0]))
        h.update(b"D" + len(items).to_bytes(4, "little"))
        for k, v in items:
            _hash_host_obj(h, k)
            _hash_host_obj(h, v)
    elif dataclasses.is_dataclass(obj):
        h.update(b"C" + type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            _hash_host_obj(h, getattr(obj, f.name))
    else:
        # last resort (e.g. numpy scalar): canonical int/str coercion
        try:
            _hash_host_obj(h, int(obj))
        except (TypeError, ValueError):
            _hash_host_obj(h, str(obj))


def derive_batch_rng(sponge, *objs) -> HostRng:
    """Fiat-Shamir fallback for batch-check randomizers when the caller
    supplies no rng: seed a ChaCha20 stream from a squeeze of the verifier
    sponge after absorbing a hash of the proof/commitment/query data.
    Unpredictable to the prover (it depends on everything absorbed), unlike
    a fixed seed — the reference instead makes the rng a required argument
    (kzg10/mod.rs:337-391). ``objs`` are host-side structures (ints, tuples,
    dicts, proof/commitment dataclasses)."""
    s = sponge.clone() if hasattr(sponge, "clone") else sponge
    h = hashlib.sha256()
    for obj in objs:
        _hash_host_obj(h, obj)
    s.absorb_bytes(h.digest())
    return HostRng.from_bytes(bytes(s.squeeze_bytes(32)))


# ---------------------------------------------------------------------------
# labeled types (data_structures.rs:109-222, 226-383)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LabeledPolynomial:
    """A polynomial with label, optional degree bound and hiding bound.

    ``poly`` is scheme-family dependent: (D+1, L) Montgomery coefficients for
    univariate schemes; (2^nv, L) evaluation tables (or scheme structs) for
    multilinear/multivariate ones.
    """

    label: str
    poly: Any
    degree_bound: Optional[int] = None
    hiding_bound: Optional[int] = None
    num_vars: Optional[int] = None

    def degree(self) -> int:
        return int(self.poly.shape[0]) - 1


@dataclasses.dataclass
class LabeledCommitment:
    label: str
    commitment: Any
    degree_bound: Optional[int] = None


@dataclasses.dataclass
class LinearCombination:
    """label + [(coeff_int, term)] with term 'one' or a polynomial label,
    with the reference's operator algebra (data_structures.rs:289-383):
    consumers (e.g. a Marlin SNARK) build LCs with +, -, * instead of
    hand-assembling term lists.

        lc = LinearCombination.empty("row_check")
        lc += (2, "w")            # coeff * label
        lc += "z"                 # unit coeff
        lc -= (5, LCTerm.ONE)     # constant term
        lc2 = 3 * lc              # scalar scaling
        lc3 = lc - lc2            # merge two LCs (keeps lhs label)
    """

    label: str
    terms: list  # [(int, str)] where str == "one" or a poly label

    def poly_labels(self):
        return [t for _, t in self.terms if t != "one"]

    # -- construction (data_structures.rs:296-320) -----------------------
    @classmethod
    def empty(cls, label: str) -> "LinearCombination":
        return cls(label, [])

    @classmethod
    def new(cls, label: str, terms) -> "LinearCombination":
        return cls(label, [_as_term(t) for t in terms])

    # -- operators (data_structures.rs:322-383) ---------------------------
    def _merged(self, other, sign: int) -> list:
        if isinstance(other, LinearCombination):
            extra = [(sign * c, t) for c, t in other.terms]
        else:
            c, t = _as_term(other)
            extra = [(sign * c, t)]
        return list(self.terms) + extra

    def __add__(self, other) -> "LinearCombination":
        return LinearCombination(self.label, self._merged(other, 1))

    def __iadd__(self, other) -> "LinearCombination":
        self.terms = self._merged(other, 1)
        return self

    def __sub__(self, other) -> "LinearCombination":
        return LinearCombination(self.label, self._merged(other, -1))

    def __isub__(self, other) -> "LinearCombination":
        self.terms = self._merged(other, -1)
        return self

    def __mul__(self, k: int) -> "LinearCombination":
        return LinearCombination(
            self.label, [(c * int(k), t) for c, t in self.terms]
        )

    __rmul__ = __mul__

    def __neg__(self) -> "LinearCombination":
        return self * -1


class LCTerm:
    """data_structures.rs:226-285: One | PolyLabel — here the string 'one'
    or any other string as a polynomial label."""

    ONE = "one"


def _as_term(t):
    """Coerce 'label' | (coeff, 'label') | (coeff, LCTerm.ONE) to a pair."""
    if isinstance(t, str):
        return (1, t)
    c, lbl = t
    return (int(c), lbl)


class PCPreparedVerifierKey:
    """data_structures.rs:53-56 — `prepare(vk)`; here preparation is the
    cached G2 Miller-line precomputation the pairing schemes attach to
    their verifier keys (kzg10._vk_prepared, sonic/pst13 _vk_prepared;
    pairing_generic.prepare_g2). Derived data: rebuilt after load, never
    persisted (utils/persist.py keeps only the raw key material)."""

    @staticmethod
    def prepare(vk):
        return vk  # preparation is lazy + cached on the key itself


class PCPreparedCommitment:
    """data_structures.rs:70-73 — commitments carry no pairing-side
    precomputation in any of the nine schemes (they sit on the G1 side),
    so preparation is the identity, matching the reference's default
    instantiations."""

    @staticmethod
    def prepare(comm):
        return comm


@dataclasses.dataclass
class BatchLCProof:
    """data_structures.rs:98-103: the proof of a batch of LC openings plus
    (for schemes whose check needs them) the constituent poly evaluations.
    Iterable for backward compatibility with the older (proofs, evals)
    tuple convention."""

    proof: Any
    evals: Optional[dict] = None

    def __iter__(self):
        return iter((self.proof, self.evals))


# QuerySet: {(poly_label, (point_label, point_int_or_tuple))} (lib.rs:152)
# Evaluations: {(poly_label, point_key): value_int} (lib.rs:158)


def evaluate_query_set(spec: FieldSpec, polys, query_set, eval_fn):
    """lib.rs:583-602 — evaluate each queried polynomial at its points."""
    by_label = {p.label: p for p in polys}
    out = {}
    for (label, (_, point)) in sorted(query_set, key=_qs_key):
        p = by_label[label]
        out[(label, _pt_key(point))] = eval_fn(p, point)
    return out


def lc_query_set_to_poly_query_set(linear_combinations, query_set):
    """lib.rs:623-640 — expand LC queries into per-polynomial queries."""
    lcs = {lc.label: lc for lc in linear_combinations}
    poly_qs = set()
    for (lc_label, (point_label, point)) in query_set:
        lc = lcs.get(lc_label)
        if lc is not None:
            for (_, term) in lc.terms:
                if term != "one":
                    poly_qs.add((term, (point_label, _pt_key(point))))
    return poly_qs


def _pt_key(point):
    return tuple(point) if isinstance(point, (list, tuple)) else point


def _qs_key(entry):
    """Total order over query-set entries: (label, point_label, point).

    The point VALUE participates so two distinct points sharing a label
    cannot tie — the sponge replay order must be deterministic across
    processes, like the reference's BTreeMap keyed on the full
    (label, point) pair (lib.rs:152). repr() gives a stable string for
    both int (univariate) and tuple (multivariate) points.
    """
    label, (point_label, point) = entry
    return (label, point_label, repr(_pt_key(point)))


# ---------------------------------------------------------------------------
# the protocol (lib.rs:164-577)
# ---------------------------------------------------------------------------


class PolynomialCommitment:
    """Scheme base class. Subclasses define scalar ``spec`` and implement
    setup/trim/commit/open/check; the batch and LC defaults below mirror
    lib.rs:269-358 (batch_open), :373-441 (batch_check), :445-485
    (open_combinations), :489-576 (check_combinations).
    """

    spec: FieldSpec  # scalar field

    # -- required scheme interface -------------------------------------
    @classmethod
    def setup(cls, max_degree, num_vars=None, rng=None):
        raise NotImplementedError

    @classmethod
    def trim(cls, pp, supported_degree, supported_hiding_bound=0, enforced_degree_bounds=None):
        raise NotImplementedError

    @classmethod
    def commit(cls, ck, polynomials, rng=None):
        raise NotImplementedError

    @classmethod
    def open(cls, ck, polynomials, commitments, point, sponge, states, rng=None):
        raise NotImplementedError

    @classmethod
    def check(cls, vk, commitments, point, values, proof, sponge):
        raise NotImplementedError

    # -- evaluation hook (scheme family dependent) ----------------------
    @classmethod
    def evaluate_poly(cls, labeled_poly, point):
        from ..core import poly as P

        poly = labeled_poly.poly
        return F.to_ints(
            cls.spec,
            P.evaluate(cls.spec, poly, F.from_ints(cls.spec, point, device=poly.device)),
        )

    # -- defaults --------------------------------------------------------
    @classmethod
    @traced("PC::batch_open", log=False)
    def batch_open(cls, ck, polynomials, commitments, query_set, sponge, states, rng=None):
        """Group the query set by point; one ``open`` per point (lib.rs:269)."""
        polys = {p.label: p for p in polynomials}
        comms = {c.label: c for c in commitments}
        sts = {p.label: s for p, s in zip(polynomials, states)}
        grouped = _group_queries(query_set)

        values = {}
        proofs = []
        for (point_label, point), labels in grouped:
            q_polys, q_comms, q_states = [], [], []
            for label in labels:
                if label not in polys:
                    raise errors.MissingPolynomial(label)
                q_polys.append(polys[label])
                q_comms.append(comms[label])
                q_states.append(sts[label])
                values[(label, _pt_key(point))] = cls.evaluate_poly(polys[label], point)
            proof = cls.open(ck, q_polys, q_comms, point, sponge, q_states, rng)
            proofs.append(proof)
        return proofs, values

    @classmethod
    def batch_check(cls, vk, commitments, query_set, evaluations, proofs, sponge):
        """lib.rs:373-441: replay the same grouping; one ``check`` per point."""
        comms = {c.label: c for c in commitments}
        grouped = _group_queries(query_set)
        assert len(grouped) == len(proofs)
        ok = True
        for ((point_label, point), labels), proof in zip(grouped, proofs):
            q_comms, q_values = [], []
            for label in labels:
                if label not in comms:
                    raise errors.MissingPolynomial(label)
                key = (label, _pt_key(point))
                if key not in evaluations:
                    raise errors.MissingEvaluation(str(key))
                q_comms.append(comms[label])
                q_values.append(evaluations[key])
            ok = ok and bool(cls.check(vk, q_comms, point, q_values, proof, sponge))
        return ok

    @classmethod
    def open_combinations(cls, ck, linear_combinations, polynomials, commitments,
                          eqn_query_set, sponge, states, rng=None):
        """lib.rs:445-485 default: open the constituent polynomials."""
        poly_query_set = lc_query_set_to_poly_query_set(linear_combinations, eqn_query_set)
        poly_evals = evaluate_query_set(
            cls.spec, polynomials, poly_query_set, cls.evaluate_poly
        )
        proofs, _ = cls.batch_open(
            ck, polynomials, commitments, poly_query_set, sponge, states, rng
        )
        return BatchLCProof(proof=proofs, evals=poly_evals)

    @classmethod
    def check_combinations(cls, vk, linear_combinations, commitments, eqn_query_set,
                           eqn_evaluations, proof_and_evals, sponge):
        """lib.rs:489-576 default: check LC values then verify constituents.

        ``proof_and_evals``: a BatchLCProof (or legacy (proofs, evals) pair).
        """
        proofs, poly_evals = proof_and_evals
        lcs = {lc.label: lc for lc in linear_combinations}
        p = cls.spec.modulus
        # verify each claimed LC evaluation against constituent evaluations
        for (lc_label, (point_label, point)) in sorted(eqn_query_set, key=_qs_key):
            lc = lcs.get(lc_label)
            if lc is None:
                raise errors.MissingPolynomial(lc_label)
            key = (lc_label, _pt_key(point))
            if key not in eqn_evaluations:
                raise errors.MissingLHSEval(str(key))
            claimed = eqn_evaluations[key] % p
            actual = 0
            for coeff, term in lc.terms:
                if term == "one":
                    actual = (actual + coeff) % p
                else:
                    pk = (term, _pt_key(point))
                    if pk not in poly_evals:
                        raise errors.MissingEvaluation(str(pk))
                    actual = (actual + coeff * poly_evals[pk]) % p
            if actual != claimed:
                return False
        poly_query_set = lc_query_set_to_poly_query_set(linear_combinations, eqn_query_set)
        return cls.batch_check(vk, commitments, poly_query_set, poly_evals, proofs, sponge)


def _group_queries(query_set):
    """Group a query set by (point_label, point); deterministic order
    (BTree semantics of lib.rs:152)."""
    grouped = {}
    for (label, (point_label, point)) in query_set:
        grouped.setdefault((point_label, _pt_key(point)), []).append(label)
    out = []
    # order by the FULL (point_label, point) key — two distinct points that
    # share a label must not tie (the reference's BTreeMap key, lib.rs:152)
    for key in sorted(grouped, key=lambda k: (str(k[0]), str(k[1]))):
        out.append(((key[0], key[1]), sorted(grouped[key])))
    return out


def fresh_sponge(spec: FieldSpec) -> PoseidonSponge:
    return PoseidonSponge(spec)
