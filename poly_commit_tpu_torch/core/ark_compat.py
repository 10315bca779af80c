"""arkworks compatibility: the test RNG, field and group sampling, and the
Poseidon test sponge, on host ints.

A copy of poly_commit_tpu/core/ark_compat.py for the PyTorch port (it
imports only numpy and the port's field_params, hostec and serialize). The
reference derives all test randomness from ``ark_std::test_rng()`` (a
rand 0.8 ``StdRng`` = ChaCha12 with a fixed 32-byte seed) and builds its
Fiat-Shamir sponge from ``poseidon_parameters_for_test``: 8 full / 31
partial rounds, alpha=17, a fixed 0/1 MDS, and ark round constants sampled
from that RNG (poly-commit/src/lib.rs:1385-1416, utils.rs:183-210).
Bit-exact interop therefore needs:

  1. ChaCha12 keystream in rand_chacha's layout (64-bit counter in words
     12-13, 64-bit stream in words 14-15; blocks serialized as 16 LE words).
     The quarter-round core is shared with RFC 8439 ChaCha20 and validated
     against its public block vector (tests/test_torch_ark.py).
  2. ``StdRng::from_seed`` with ark_std's fixed test seed, and
     ``SeedableRng::seed_from_u64`` (splitmix64 expansion, validated
     against the public splitmix64(0) outputs).
  3. ``Fp::rand``: rejection-sample N 64-bit limbs (next_u64 each), mask
     the top limb to MODULUS_BITS, retry while >= p; the accepted bigint is
     the MONTGOMERY representation (ark-ff UniformRand).
  4. The duplex Poseidon sponge state machine of ark-crypto-primitives
     (capacity-first state layout, lazy permutes on absorb/squeeze
     transitions, (MODULUS_BIT_SIZE-1)-bit usable squeezes).

Groups are the port's (core/curve.py): a group's base field is
``group.spec``, its b coefficient ``group.b_int`` (G1) or the Fq2 pair
``group.b`` (G2), and the Fq2 non-residue that of its host group.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from . import field_params as FP
from . import hostec
from .field_params import FieldSpec
from .serialize import _sqrt_fp, _sqrt_fp2

MASK64 = (1 << 64) - 1


def splitmix64_stream(seed: int):
    """rand_core::SeedableRng::seed_from_u64's expansion PRNG.
    splitmix64(0) starts 0xE220A8397B1DCDAF, 0x6E789E6AA1B965F4, ..."""
    state = seed & MASK64
    while True:
        state = (state + 0x9E3779B97F4A7C15) & MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        yield z ^ (z >> 31)


def seed_from_u64(seed: int) -> bytes:
    """rand 0.8 SeedableRng::seed_from_u64: fill the 32-byte seed with
    successive splitmix64 outputs, little-endian."""
    g = splitmix64_stream(seed)
    return b"".join(next(g).to_bytes(8, "little") for _ in range(4))


ARK_STD_TEST_SEED = bytes(
    [1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0]
    + [0] * 16
)


def _chacha_block(key_words, counter: int, stream: int, rounds: int) -> bytes:
    """One ChaCha block, DJB layout (64-bit counter / 64-bit stream) as used
    by rand_chacha; rounds=12 for StdRng, 20 for the RFC-vector test."""
    x = np.empty(16, np.uint64)
    x[0:4] = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
    x[4:12] = key_words
    x[12] = counter & 0xFFFFFFFF
    x[13] = (counter >> 32) & 0xFFFFFFFF
    x[14] = stream & 0xFFFFFFFF
    x[15] = (stream >> 32) & 0xFFFFFFFF
    s = [int(v) for v in x]
    orig = list(s)

    def rotl(v, n):
        v &= 0xFFFFFFFF
        return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF

    def qr(a, b, c, d):
        s[a] = (s[a] + s[b]) & 0xFFFFFFFF
        s[d] = rotl(s[d] ^ s[a], 16)
        s[c] = (s[c] + s[d]) & 0xFFFFFFFF
        s[b] = rotl(s[b] ^ s[c], 12)
        s[a] = (s[a] + s[b]) & 0xFFFFFFFF
        s[d] = rotl(s[d] ^ s[a], 8)
        s[c] = (s[c] + s[d]) & 0xFFFFFFFF
        s[b] = rotl(s[b] ^ s[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    out = [(a + b) & 0xFFFFFFFF for a, b in zip(s, orig)]
    return b"".join(v.to_bytes(4, "little") for v in out)


class StdRng:
    """rand 0.8 StdRng (= ChaCha12Rng) keystream emulation: next_u32 pulls
    consecutive LE words; next_u64 = lo | hi << 32."""

    ROUNDS = 12

    def __init__(self, seed: bytes = ARK_STD_TEST_SEED):
        assert len(seed) == 32
        self._key = np.frombuffer(seed, "<u4").astype(np.uint64)
        self._counter = 0
        self._buf = b""
        self._pos = 0

    @classmethod
    def seed_from_u64(cls, seed: int) -> "StdRng":
        return cls(seed_from_u64(seed))

    def _refill(self):
        self._buf = _chacha_block(self._key, self._counter, 0, self.ROUNDS)
        self._counter += 1
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        v = int.from_bytes(self._buf[self._pos : self._pos + 4], "little")
        self._pos += 4
        return v

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def next_bool(self) -> bool:
        """rand 0.8 Standard Distribution<bool>: the next_u32 sign bit."""
        return (self.next_u32() >> 31) == 1

    def fill_bytes(self, n: int) -> bytes:
        """rand_core BlockRng::fill_bytes — whole-word consumption (exact
        for the 32-byte SeedableRng::from_rng reads used here)."""
        assert n % 4 == 0, "word-aligned reads only"
        return b"".join(
            self.next_u32().to_bytes(4, "little") for _ in range(n // 4)
        )


class ChaCha20Rng(StdRng):
    """rand_chacha ChaCha20Rng (same layout as StdRng, 20 rounds) — the
    reference's test RNG: ``ChaCha20Rng::from_rng(test_rng())``
    (poly-commit/src/lib.rs:681)."""

    ROUNDS = 20

    @classmethod
    def from_rng(cls, parent: "StdRng") -> "ChaCha20Rng":
        return cls(parent.fill_bytes(32))


def ark_test_rng() -> StdRng:
    """ark_std::test_rng() — fixed seed [1,0,0,0,23,0,0,0,200,1,0,0,210,30,...]."""
    return StdRng(ARK_STD_TEST_SEED)


def ark_fp_rand(rng: StdRng, spec: FieldSpec) -> int:
    """ark-ff ``Fp::rand``: the accepted masked bigint is the MONTGOMERY
    repr; returns the canonical integer value (repr * R^{-1} mod p)."""
    n64 = (spec.num_bits + 63) // 64
    # arkworks N is the limb count of the modulus type (64-bit limbs)
    shave = 64 * n64 - spec.num_bits
    mask = MASK64 >> shave if shave < 64 else 0
    while True:
        limbs = [rng.next_u64() for _ in range(n64)]
        limbs[-1] &= mask
        v = 0
        for limb in reversed(limbs):
            v = (v << 64) | limb
        if v < spec.modulus:
            rinv = pow(spec.R, -1, spec.modulus)
            return v * rinv % spec.modulus


@functools.lru_cache(maxsize=8)
def poseidon_test_ark(spec: FieldSpec) -> tuple:
    """The 39x3 ark round constants of poseidon_parameters_for_test
    (lib.rs:1393-1416): F::rand over ark_std::test_rng, row-major."""
    rng = ark_test_rng()
    return tuple(
        tuple(ark_fp_rand(rng, spec) for _ in range(3)) for _ in range(39)
    )


POSEIDON_TEST_MDS = ((1, 0, 1), (1, 1, 0), (0, 1, 1))
POSEIDON_TEST_FULL_ROUNDS = 8
POSEIDON_TEST_PARTIAL_ROUNDS = 31
POSEIDON_TEST_ALPHA = 17
POSEIDON_TEST_RATE = 2
POSEIDON_TEST_CAPACITY = 1


class ArkPoseidonSponge:
    """ark-crypto-primitives PoseidonSponge duplex state machine with the
    reference's test parameters (state = [capacity | rate], lazy permutes).

    Methods mirror CryptographicSponge: absorb field elements (canonical
    ints), squeeze_native_field_elements, squeeze_bytes, squeeze_bits, and
    the 128-bit truncated challenge (lib.rs:580).
    """

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus
        self.ark = poseidon_test_ark(spec)
        self.mds = POSEIDON_TEST_MDS
        self.rate = POSEIDON_TEST_RATE
        self.capacity = POSEIDON_TEST_CAPACITY
        self.state = [0] * (self.rate + self.capacity)
        # mode: ("absorbing", next_index) | ("squeezing", next_index)
        self.mode = ("absorbing", 0)

    # -- permutation ----------------------------------------------------
    def _sbox_full(self):
        p = self.p
        self.state = [pow(s, POSEIDON_TEST_ALPHA, p) for s in self.state]

    def _sbox_partial(self):
        self.state[0] = pow(self.state[0], POSEIDON_TEST_ALPHA, self.p)

    def _apply_ark(self, rnd: int):
        row = self.ark[rnd]
        self.state = [(s + c) % self.p for s, c in zip(self.state, row)]

    def _apply_mds(self):
        p = self.p
        st = self.state
        self.state = [
            sum(st[j] * self.mds[i][j] for j in range(len(st))) % p
            for i in range(len(st))
        ]

    def _permute(self):
        half = POSEIDON_TEST_FULL_ROUNDS // 2
        total = POSEIDON_TEST_FULL_ROUNDS + POSEIDON_TEST_PARTIAL_ROUNDS
        for r in range(half):
            self._apply_ark(r)
            self._sbox_full()
            self._apply_mds()
        for r in range(half, half + POSEIDON_TEST_PARTIAL_ROUNDS):
            self._apply_ark(r)
            self._sbox_partial()
            self._apply_mds()
        for r in range(half + POSEIDON_TEST_PARTIAL_ROUNDS, total):
            self._apply_ark(r)
            self._sbox_full()
            self._apply_mds()

    # -- duplex rules (ark-crypto-primitives sponge/poseidon/mod.rs) ----
    def _absorb_internal(self, start: int, elems: List[int]):
        remaining = [int(e) % self.p for e in elems]
        while True:
            if start + len(remaining) <= self.rate:
                for i, e in enumerate(remaining):
                    self.state[self.capacity + start + i] = (
                        self.state[self.capacity + start + i] + e
                    ) % self.p
                self.mode = ("absorbing", start + len(remaining))
                return
            num = self.rate - start
            for i in range(num):
                self.state[self.capacity + start + i] = (
                    self.state[self.capacity + start + i] + remaining[i]
                ) % self.p
            self._permute()
            remaining = remaining[num:]
            start = 0

    def absorb(self, elems):
        elems = list(elems)
        if not elems:
            return
        kind, idx = self.mode
        if kind == "absorbing":
            if idx == self.rate:
                self._permute()
                idx = 0
            self._absorb_internal(idx, elems)
        else:
            self._permute()
            self._absorb_internal(0, elems)

    def _squeeze_internal(self, start: int, n: int) -> List[int]:
        out = []
        while True:
            if start + n <= self.rate:
                out.extend(
                    self.state[self.capacity + start + i] for i in range(n)
                )
                self.mode = ("squeezing", start + n)
                return out
            num = self.rate - start
            out.extend(self.state[self.capacity + start + i] for i in range(num))
            self._permute()
            n -= num
            start = 0

    def squeeze_native_field_elements(self, n: int) -> List[int]:
        if n == 0:
            return []
        kind, idx = self.mode
        if kind == "absorbing":
            self._permute()
            return self._squeeze_internal(0, n)
        if idx == self.rate:
            self._permute()
            idx = 0
        return self._squeeze_internal(idx, n)

    def squeeze_bytes(self, num_bytes: int) -> bytes:
        usable = (self.spec.num_bits - 1) // 8
        n = -(-num_bytes // usable)
        elems = self.squeeze_native_field_elements(n)
        out = bytearray()
        for e in elems:
            out += int(e).to_bytes((self.spec.num_bits + 7) // 8, "little")[:usable]
        return bytes(out[:num_bytes])

    def squeeze_bits(self, num_bits: int) -> List[int]:
        usable = self.spec.num_bits - 1
        n = -(-num_bits // usable)
        elems = self.squeeze_native_field_elements(n)
        bits = []
        for e in elems:
            bits.extend((int(e) >> i) & 1 for i in range(usable))
        return bits[:num_bits]

    def squeeze_challenge_128(self) -> int:
        """FieldElementSize::Truncated(128) (lib.rs:580): the field element
        assembled from the first 128 squeezed LE bits."""
        bits = self.squeeze_bits(128)
        return sum(b << i for i, b in enumerate(bits)) % self.p


# ---------------------------------------------------------------------------
# ark-ec UniformRand emulation: random group elements exactly as arkworks
# samples them in setup (kzg10/mod.rs:62-65) — loop {x = F::rand, greatest =
# bool::rand, get_point_from_x_unchecked, mul_by_cofactor}.
# ---------------------------------------------------------------------------


def _cofactor(group) -> int:
    return {
        "bls12_381_g1": FP.BLS12_381_COFACTOR_G1,
        "bls12_381_g2": FP.BLS12_381_COFACTOR_G2,
    }[group.name]


def _is_square_fp(a: int, p: int) -> bool:
    return a % p == 0 or pow(a, (p - 1) // 2, p) == 1


def _is_square_fp2(a, p: int, nr: int) -> bool:
    norm = (a[0] * a[0] - nr * a[1] * a[1]) % p
    return _is_square_fp(norm, p)


def ark_g1_rand(rng: StdRng, group) -> tuple:
    """G1Projective::rand over a short-Weierstrass host group; returns the
    cofactor-cleared AFFINE host point (x, y)."""
    spec = group.spec
    p = spec.modulus
    b = group.b_int
    hg = hostec.host_group(group)
    cof = _cofactor(group)
    while True:
        x = ark_fp_rand(rng, spec)
        greatest = rng.next_bool()
        rhs = (pow(x, 3, p) + b) % p
        if not _is_square_fp(rhs, p):
            continue
        y = _sqrt_fp(rhs, p)
        y_hi, y_lo = max(y, (p - y) % p), min(y, (p - y) % p)
        y = y_hi if greatest else y_lo
        return _host_cofactor_mul(hg, (x, y), cof)


def ark_g2_rand(rng: StdRng, group) -> tuple:
    """G2Projective::rand (Fq2 coordinates; greatest = lexicographic with
    c1 dominant, matching ark's QuadExtField Ord)."""
    spec = group.spec
    p = spec.modulus
    hg = hostec.host_group(group)
    nr = hg.f.nr
    b = group.b  # (b0, b1)
    cof = _cofactor(group)

    def mul2(u, v):
        return (
            (u[0] * v[0] + nr * u[1] * v[1]) % p,
            (u[0] * v[1] + u[1] * v[0]) % p,
        )

    while True:
        c0 = ark_fp_rand(rng, spec)
        c1 = ark_fp_rand(rng, spec)
        greatest = rng.next_bool()
        x = (c0, c1)
        x3 = mul2(mul2(x, x), x)
        rhs = ((x3[0] + b[0]) % p, (x3[1] + b[1]) % p)
        if not _is_square_fp2(rhs, p, nr):
            continue
        y = _sqrt_fp2(rhs, p, nr)
        yneg = ((p - y[0]) % p, (p - y[1]) % p)
        y_hi = max(y[::-1], yneg[::-1])[::-1]
        y_lo = min(y[::-1], yneg[::-1])[::-1]
        y = tuple(y_hi if greatest else y_lo)
        return _host_cofactor_mul(hg, (x, y), cof)


def _host_cofactor_mul(hg, pt, cofactor: int):
    """k*P WITHOUT reducing k mod the subgroup order (P is not yet in the
    r-order subgroup — hg.mul/mul_fast would reduce and be wrong)."""
    acc = None
    for bit in reversed(range(cofactor.bit_length())):
        acc = hg._jdouble(acc)
        if (cofactor >> bit) & 1:
            acc = hg._jmadd(acc, pt)
    return hg._jto_affine(acc)
