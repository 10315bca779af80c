"""Seeded generators of the benchmark, shared by the harness and the reference.

``derive`` turns ``--seed`` and a purpose into a 63-bit seed. ``HostRng`` is
a frozen copy of the port's ChaCha20 field-element stream
(``pcs/data_structures.py``): the harness hands it to the port wherever the
public API takes an ``rng`` (the SRS trapdoor, hiding randomness, Hyrax's
proof masks), and the reference replays the same draws from the same seed.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

Field = collections.namedtuple("Field", "modulus")  # what HostRng needs of a field


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose of one run: the same arguments give the
    same seed, any whole ``seed`` is accepted."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _chacha_blocks(key_words: np.ndarray, counter: int, nblocks: int) -> bytes:
    """ChaCha20 keystream (RFC 8439 layout, zero nonce) over ``nblocks``
    consecutive counter values."""
    x = np.empty((16, nblocks), np.uint32)
    x[0:4] = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)[:, None]
    x[4:12] = key_words[:, None]
    x[12] = (np.arange(counter, counter + nblocks, dtype=np.uint64)
             & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    x[13:16] = 0
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
    return s.T.astype("<u4").tobytes()


class HostRng:
    """Field elements from a ChaCha20 keystream keyed by a seed. Duck-types
    the port's ``HostRng`` for the methods its schemes call."""

    def __init__(self, seed: int):
        key = hashlib.sha256(b"poly-commit-tpu:chacha20:"
                             + int(seed).to_bytes(32, "little", signed=False)).digest()
        self._key = np.frombuffer(key, "<u4").copy()
        self._counter = 0
        self._buf = b""
        self._pos = 0

    def bytes(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._pos >= len(self._buf):
                nblocks = max(64, (n + 63) // 64)
                self._buf = _chacha_blocks(self._key, self._counter, nblocks)
                self._counter += nblocks
                self._pos = 0
            take = min(n, len(self._buf) - self._pos)
            out += self._buf[self._pos:self._pos + take]
            self._pos += take
            n -= take
        return bytes(out)

    def getrandbits(self, k: int) -> int:
        nb = (k + 7) // 8
        return int.from_bytes(self.bytes(nb), "little") >> (nb * 8 - k)

    def field_int(self, spec) -> int:
        """A field element: ``num_bits + 64`` random bits reduced mod p
        (``spec`` needs ``modulus``; ``num_bits`` is its bit length)."""
        return self.getrandbits(spec.modulus.bit_length() + 64) % spec.modulus

    def field_ints(self, spec, n: int) -> list:
        return [self.field_int(spec) for _ in range(n)]

    def u128(self) -> int:
        return self.getrandbits(128)
