"""Fiat-Shamir transcripts: Poseidon sponge over any FieldSpec (host-side).

The sponge of poly_commit_tpu/core/transcript.py for the PyTorch port. It
is tiny and sequential, so it runs on the host: its state is python ints,
and its permutation and absorb loop are native host code
(csrc/poseidon.cpp, built by ``device.library``); only
``absorb_device_field`` touches tensors. Parameters are derived from the
field modulus with SHAKE-256 (alpha = 17, 8 full + 31 partial rounds, rate 2,
capacity 1, a Cauchy MDS), bit for bit as in the JAX package, so both
packages squeeze the same challenges from the same absorbs. The public
absorbs and squeezes are the spans ``Transcript::absorb`` and
``Transcript::squeeze``; each permutation counts one
``poseidon_permutations`` and each crossing into the native code one
``poseidon_native_calls`` (utils/trace.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np

from .. import device as D
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


_WORDS = 4  # 64-bit words an element crosses into csrc/poseidon.cpp as
_ELEM_BYTES = 8 * _WORDS


@functools.lru_cache(maxsize=16)
def native_params(spec: FieldSpec) -> ctypes.Array:
    """The constants of csrc/poseidon.cpp for ``spec``, packed as its
    ``Params``: p, -p^-1 mod 2^64, R^2 mod p (R = 2^256), then the round
    constants and the MDS matrix in Montgomery form, 4 little-endian words
    an element."""
    p = spec.modulus
    # four words with the top word below 2^63 - 1: the native product's bound
    if p % 2 == 0 or p >> 192 >= (1 << 63) - 1:
        raise ValueError(f"{spec.name}: the native sponge needs an odd modulus with its top word "
                         "below 2^63 - 1")
    R = 1 << (64 * _WORDS)
    ark, mds = poseidon_params(spec)
    words = [*_words(p), (-pow(p, -1, 1 << 64)) % (1 << 64), *_words(R * R % p)]
    for v in [a for row in ark for a in row] + [m for row in mds for m in row]:
        words.extend(_words(v * R % p))
    return (ctypes.c_uint64 * len(words))(*words)


def _words(v: int) -> list:
    return [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(_WORDS)]


@functools.lru_cache(maxsize=1)
def _lib():
    lib = D.library("poseidon")
    lib.pc_poseidon_absorb.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
                                       ctypes.c_int64]
    lib.pc_poseidon_absorb.restype = ctypes.c_int64
    lib.pc_poseidon_permute.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.pc_poseidon_permute.restype = ctypes.c_int64
    return lib


class PoseidonSponge:
    """Duplex sponge; state layout [capacity || rate] (arkworks convention).

    The state is three python ints; the permutation and the absorb loop run
    in csrc/poseidon.cpp, which an absorb crosses into once for all its
    elements and a squeeze once a refill. Each crossing counts one
    ``poseidon_native_calls``."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus
        self.params = native_params(spec)
        self.state = [0] * WIDTH
        self.mode = "absorb"
        self.pos = 0  # next rate slot

    def clone(self) -> "PoseidonSponge":
        """Independent copy (for deriving side-channel randomness without
        perturbing the protocol transcript)."""
        c = PoseidonSponge.__new__(PoseidonSponge)
        c.spec, c.p, c.params = self.spec, self.p, self.params
        c.state = list(self.state)
        c.mode, c.pos = self.mode, self.pos
        return c

    # -- the native calls --
    def _state_buffer(self):
        return ctypes.create_string_buffer(
            b"".join(s.to_bytes(_ELEM_BYTES, "little") for s in self.state), WIDTH * _ELEM_BYTES)

    def _load_state(self, buf) -> None:
        raw = buf.raw
        self.state = [int.from_bytes(raw[i : i + _ELEM_BYTES], "little")
                      for i in range(0, WIDTH * _ELEM_BYTES, _ELEM_BYTES)]

    def _count(self, perms: int) -> None:
        trace.count("poseidon_native_calls")
        if perms:
            trace.count("poseidon_permutations", perms)

    def _permute(self) -> None:
        buf = self._state_buffer()
        self._count(_lib().pc_poseidon_permute(self.params, buf, 1))
        self._load_state(buf)

    def _absorb_packed(self, packed: bytes) -> None:
        """Absorbs canonical elements, each ``_ELEM_BYTES`` little-endian
        bytes, in one crossing."""
        if self.mode != "absorb":
            self.mode = "absorb"
            self.pos = 0
        n = len(packed) // _ELEM_BYTES
        if n == 0:
            return
        buf = self._state_buffer()
        pos = ctypes.c_int64(self.pos)
        self._count(_lib().pc_poseidon_absorb(self.params, buf, ctypes.byref(pos), packed, n))
        self._load_state(buf)
        self.pos = pos.value

    def _pack_field(self, elems) -> bytes:
        p = self.p
        return b"".join((int(e) % p).to_bytes(_ELEM_BYTES, "little") for e in elems)

    def _pack_bytes(self, data: bytes) -> bytes:
        """Its length, then data in ((num_bits-1)//8)-byte little-endian
        chunks: each chunk is below 2^(num_bits-1) < p, so zero-padding it to
        an element is its canonical form."""
        chunk = (self.spec.num_bits - 1) // 8
        data = bytes(data)
        return len(data).to_bytes(_ELEM_BYTES, "little") + b"".join(
            data[i : i + chunk].ljust(_ELEM_BYTES, b"\0") for i in range(0, len(data), chunk))

    # -- absorbing --
    @trace.traced(ABSORB, log=False)
    def absorb_field(self, elems):
        """Absorb an iterable of python-int field elements."""
        self._absorb_packed(self._pack_field(elems))

    @trace.traced(ABSORB, log=False)
    def absorb_bytes(self, data: bytes):
        """Pack bytes into field elements ((num_bits-1)//8 bytes each, LE)."""
        # length domain-separation so absorb(b"ab")+absorb(b"c") != absorb(b"abc")
        self._absorb_packed(self._pack_bytes(data))

    @trace.traced(ABSORB, log=False)
    def absorb_bytes_many(self, chunks):
        """``absorb_bytes`` of each byte string in turn, in one crossing (of
        none, nothing: the mode stays)."""
        packed = b"".join(self._pack_bytes(data) for data in chunks)
        if packed:
            self._absorb_packed(packed)

    @trace.traced(ABSORB, log=False)
    def absorb_device_field(self, spec: FieldSpec, arr):
        """Absorb field elements held in a (..., L) Montgomery limb tensor."""
        vals = F.to_ints(spec, arr)
        if isinstance(vals, int):
            vals = [vals]
        flat = np.asarray(vals, dtype=object).ravel().tolist()
        self._absorb_packed(self._pack_field(flat))

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
