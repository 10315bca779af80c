"""Fiat-Shamir transcripts: Poseidon sponge over any FieldSpec (host-side).

A copy of poly_commit_tpu/core/transcript.py for the PyTorch port: the
sponge is tiny and sequential, so it runs on host Python ints; only
``absorb_device_field`` touches tensors. Parameters are derived from the
field modulus with SHAKE-256 (alpha = 17, 8 full + 31 partial rounds, rate 2,
capacity 1, a Cauchy MDS), bit for bit as in the JAX package, so both
packages squeeze the same challenges from the same absorbs. The public
absorbs and squeezes are the spans ``Transcript::absorb`` and
``Transcript::squeeze``, and each permutation counts one
``poseidon_permutations`` (utils/trace.py).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from ..utils import trace
from . import field as F
from .field_params import FieldSpec

ABSORB = "Transcript::absorb"
SQUEEZE = "Transcript::squeeze"

ALPHA = 17
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 31
RATE = 2
CAPACITY = 1
WIDTH = RATE + CAPACITY
CHALLENGE_BITS = 128  # lib.rs:580 Truncated(128)


@functools.lru_cache(maxsize=16)
def poseidon_params(spec: FieldSpec):
    """Deterministic (modulus-seeded) ARK and MDS constants as python ints."""
    p = spec.modulus
    seed = b"tpu-poly-commit poseidon v1|" + p.to_bytes(64, "little")
    shake = hashlib.shake_256(seed)
    nbytes = (spec.num_bits + 15) // 8  # oversample to debias
    stream = shake.digest((FULL_ROUNDS + PARTIAL_ROUNDS) * WIDTH * nbytes + 64 * nbytes)
    pos = 0

    def draw():
        nonlocal pos
        v = int.from_bytes(stream[pos : pos + nbytes], "little") % p
        pos += nbytes
        return v

    ark = [[draw() for _ in range(WIDTH)] for _ in range(FULL_ROUNDS + PARTIAL_ROUNDS)]
    # Cauchy MDS: m[i][j] = 1/(x_i + y_j) with distinct x, y — invertible
    xs = [draw() for _ in range(WIDTH)]
    ys = [draw() for _ in range(WIDTH)]
    mds = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(WIDTH)] for i in range(WIDTH)]
    return ark, mds


class PoseidonSponge:
    """Duplex sponge; state layout [capacity || rate] (arkworks convention)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus
        self.ark, self.mds = poseidon_params(spec)
        self.state = [0] * WIDTH
        self.mode = "absorb"
        self.pos = 0  # next rate slot

    def clone(self) -> "PoseidonSponge":
        """Independent copy (for deriving side-channel randomness without
        perturbing the protocol transcript)."""
        c = PoseidonSponge.__new__(PoseidonSponge)
        c.spec, c.p, c.ark, c.mds = self.spec, self.p, self.ark, self.mds
        c.state = list(self.state)
        c.mode, c.pos = self.mode, self.pos
        return c

    # -- permutation --
    def _permute(self):
        """The permutation on the width-3 state, unrolled: x^17 as four
        squarings and a product, each round constant added unreduced and
        reduced by the product that follows: the same state as the JAX
        package's round-by-round form, with fewer Python operations."""
        trace.count("poseidon_permutations")
        p = self.p
        (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = self.mds
        s0, s1, s2 = self.state
        first_partial, last_partial = FULL_ROUNDS // 2, FULL_ROUNDS // 2 + PARTIAL_ROUNDS

        def sbox(x):  # x^ALPHA, ALPHA = 17
            x2 = x * x % p
            x4 = x2 * x2 % p
            x8 = x4 * x4 % p
            return x8 * x8 % p * x % p

        for r, (a0, a1, a2) in enumerate(self.ark):
            s0, s1, s2 = s0 + a0, s1 + a1, s2 + a2
            s0 = sbox(s0)
            if r < first_partial or r >= last_partial:
                s1, s2 = sbox(s1), sbox(s2)
            s0, s1, s2 = ((m00 * s0 + m01 * s1 + m02 * s2) % p,
                          (m10 * s0 + m11 * s1 + m12 * s2) % p,
                          (m20 * s0 + m21 * s1 + m22 * s2) % p)
        self.state = [s0, s1, s2]

    # -- absorbing --
    @trace.traced(ABSORB, log=False)
    def absorb_field(self, elems):
        """Absorb an iterable of python-int field elements."""
        self._absorb(elems)

    def _absorb(self, elems):
        if self.mode != "absorb":
            self.mode = "absorb"
            self.pos = 0
        for e in elems:
            if self.pos == RATE:
                self._permute()
                self.pos = 0
            self.state[CAPACITY + self.pos] = (
                self.state[CAPACITY + self.pos] + int(e) % self.p
            ) % self.p
            self.pos += 1

    @trace.traced(ABSORB, log=False)
    def absorb_bytes(self, data: bytes):
        """Pack bytes into field elements ((num_bits-1)//8 bytes each, LE)."""
        chunk = max(1, (self.spec.num_bits - 1) // 8)
        elems = [
            int.from_bytes(data[i : i + chunk], "little")
            for i in range(0, len(data), chunk)
        ]
        # length domain-separation so absorb(b"ab")+absorb(b"c") != absorb(b"abc")
        self._absorb([len(data)])
        self._absorb(elems)

    @trace.traced(ABSORB, log=False)
    def absorb_device_field(self, spec: FieldSpec, arr):
        """Absorb field elements held in a (..., L) Montgomery limb tensor."""
        vals = F.to_ints(spec, arr)
        if isinstance(vals, int):
            vals = [vals]
        flat = np.asarray(vals, dtype=object).ravel().tolist()
        self._absorb(flat)

    # -- squeezing --
    def _squeeze_elems(self, n):
        if self.mode != "squeeze":
            self._permute()
            self.mode = "squeeze"
            self.pos = 0
        out = []
        for _ in range(n):
            if self.pos == RATE:
                self._permute()
                self.pos = 0
            out.append(self.state[CAPACITY + self.pos])
            self.pos += 1
        return out

    @trace.traced(SQUEEZE, log=False)
    def squeeze_field(self, n=1):
        """n full field elements (python ints)."""
        return self._squeeze_elems(n)

    @trace.traced(SQUEEZE, log=False)
    def squeeze_bits(self, nbits):
        per = self.spec.num_bits - 1
        n = -(-nbits // per)
        elems = self._squeeze_elems(n)
        bits = []
        for e in elems:
            bits.extend((e >> i) & 1 for i in range(per))
        return bits[:nbits]

    @trace.traced(SQUEEZE, log=False)
    def squeeze_bytes(self, nbytes):
        bits = self.squeeze_bits(8 * nbytes)
        return bytes(
            sum(bits[8 * i + j] << j for j in range(8)) for i in range(nbytes)
        )

    @trace.traced(SQUEEZE, log=False)
    def squeeze_challenge_128(self):
        """The reference's Truncated(128) opening challenge (lib.rs:580)."""
        bits = self.squeeze_bits(CHALLENGE_BITS)
        return sum(b << i for i, b in enumerate(bits))

    @trace.traced(SQUEEZE, log=False)
    def squeeze_challenges_128(self, n):
        return [self.squeeze_challenge_128() for _ in range(n)]
