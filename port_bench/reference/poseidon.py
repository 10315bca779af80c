"""The Poseidon duplex sponge of the port's transcripts, written out from
its parameters: alpha = 17, 8 full and 31 partial rounds, rate 2, capacity
1, round constants and a Cauchy MDS drawn from SHAKE-256 of the modulus,
state [capacity || rate], bytes packed (num_bits - 1) // 8 to an element
after their length, 128-bit challenges as the low bits of one element."""

from __future__ import annotations

import functools
import hashlib

ALPHA = 17
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 31
RATE = 2
CAPACITY = 1
WIDTH = RATE + CAPACITY


@functools.lru_cache(maxsize=4)
def params(p: int):
    bits = p.bit_length()
    seed = b"tpu-poly-commit poseidon v1|" + p.to_bytes(64, "little")
    nbytes = (bits + 15) // 8
    stream = hashlib.shake_256(seed).digest((FULL_ROUNDS + PARTIAL_ROUNDS) * WIDTH * nbytes
                                            + 64 * nbytes)
    draws = iter(int.from_bytes(stream[i:i + nbytes], "little") % p
                 for i in range(0, len(stream), nbytes))
    ark = [[next(draws) for _ in range(WIDTH)] for _ in range(FULL_ROUNDS + PARTIAL_ROUNDS)]
    xs = [next(draws) for _ in range(WIDTH)]
    ys = [next(draws) for _ in range(WIDTH)]
    mds = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(WIDTH)] for i in range(WIDTH)]
    return ark, mds


class Sponge:
    def __init__(self, p: int):
        self.p = p
        self.ark, self.mds = params(p)
        self.state = [0] * WIDTH
        self.absorbing = True
        self.pos = 0

    def _permute(self):
        p = self.p
        half = FULL_ROUNDS // 2
        for r, consts in enumerate(self.ark):
            s = [(v + c) % p for v, c in zip(self.state, consts)]
            full = r < half or r >= half + PARTIAL_ROUNDS
            s = [pow(v, ALPHA, p) if (i == 0 or full) else v for i, v in enumerate(s)]
            self.state = [sum(m * v for m, v in zip(row, s)) % p for row in self.mds]

    def absorb_field(self, elems):
        if not self.absorbing:
            self.absorbing, self.pos = True, 0
        for e in elems:
            if self.pos == RATE:
                self._permute()
                self.pos = 0
            self.state[CAPACITY + self.pos] = (self.state[CAPACITY + self.pos] + int(e)) % self.p
            self.pos += 1

    def absorb_bytes(self, data: bytes):
        chunk = max(1, (self.p.bit_length() - 1) // 8)
        self.absorb_field([len(data)])
        self.absorb_field([int.from_bytes(data[i:i + chunk], "little")
                           for i in range(0, len(data), chunk)])

    def squeeze_field(self, n: int) -> list:
        if self.absorbing:
            self._permute()
            self.absorbing, self.pos = False, 0
        out = []
        for _ in range(n):
            if self.pos == RATE:
                self._permute()
                self.pos = 0
            out.append(self.state[CAPACITY + self.pos])
            self.pos += 1
        return out

    def squeeze_challenge_128(self) -> int:
        per = self.p.bit_length() - 1
        elems = self.squeeze_field(-(-128 // per))
        value = sum(e % (1 << per) << (i * per) for i, e in enumerate(elems))
        return value % (1 << 128)
