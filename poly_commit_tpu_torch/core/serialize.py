"""Field elements and points to bytes, and device points to host ints.

The parts of poly_commit_tpu/core/serialize.py that the ported schemes
use: a field element is ceil(num_bits / 8) little-endian bytes of its
canonical integer. ``mont_limbs_to_bytes`` gives the same bytes for a whole
(L, N) Montgomery tensor in one pass on its device, since 16-bit
little-endian limbs are the value's little-endian bytes. An uncompressed
point is x || y || a flag byte (what IPA-PC's transcript hashes), a
compressed one x || a flag byte. The arkworks codec (ark-serialize's
CanonicalSerialize with SWFlags) and the zcash BLS12-381 encodings, with the
square roots that recover y, are host code on Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ff
from . import field as F
from . import hostec
from ..utils import trace
from .field_params import FieldSpec


def field_to_bytes(spec: FieldSpec, value: int) -> bytes:
    return (int(value) % spec.modulus).to_bytes(spec.serialized_size(), "little")


def field_from_bytes(spec: FieldSpec, data: bytes) -> int:
    v = int.from_bytes(data, "little")
    if v >= spec.modulus:
        raise ValueError(f"{spec.name}: {len(data)} bytes encode a value >= p")
    return v


def fields_to_bytes(spec: FieldSpec, values) -> bytes:
    return b"".join(field_to_bytes(spec, v) for v in values)


def _width(group) -> int:
    """Base-field ints in a coordinate: 2 in G2 (c0, c1), else 1."""
    return 2 if hostec._is_g2(group) else 1


def _coords(group, v) -> list:
    """A coordinate as its list of base-field ints (c0, c1 in G2)."""
    return list(v) if hostec._is_g2(group) else [v]


def _y_is_larger(spec, ys) -> bool:
    # lexicographic from the last coordinate (matches negation flipping)
    neg = [(spec.modulus - y) % spec.modulus for y in ys]
    return ys[::-1] > neg[::-1]


def point_to_bytes(group, affine_int_point) -> bytes:
    """(x, y, inf) host ints -> x || flag (bit 0: infinity, bit 1: y is the
    lexicographically larger root)."""
    spec = group.spec
    x, y, inf = affine_int_point
    if inf:
        return bytes(spec.serialized_size() * _width(group)) + b"\x01"
    flag = 2 if _y_is_larger(spec, _coords(group, y)) else 0
    return fields_to_bytes(spec, _coords(group, x)) + bytes([flag])


def point_to_bytes_uncompressed(group, affine_int_point) -> bytes:
    """(x, y, inf) host ints -> x || y || flag (1 at infinity, with zero
    coordinates)."""
    spec = group.spec
    x, y, inf = affine_int_point
    if inf:
        return bytes(2 * spec.serialized_size() * _width(group)) + b"\x01"
    return fields_to_bytes(spec, _coords(group, x)) + fields_to_bytes(spec, _coords(group, y)) + b"\x00"


def point_size(group, compressed=True) -> int:
    per = group.spec.serialized_size() * _width(group)
    return (per if compressed else 2 * per) + 1


# ---------------------------------------------------------------------------
# arkworks-compatible CanonicalSerialize format
# (ark-serialize SWFlags + LE field bytes; the reference's on-disk/transcript
# codec, e.g. kzg10/data_structures.rs:57-112)
# ---------------------------------------------------------------------------
#
# Short-Weierstrass point, compressed: serialize x as LE bytes of the
# canonical integer, then OR flag bits into the TOP bits of the LAST byte:
#   bit 7 (0x80): y is "negative"  (y > p - y, i.e. the larger root)
#   bit 6 (0x40): point at infinity (x serialized as 0)
# Fq2 coordinates serialize as c0 || c1 with the flags on c1's last byte.
# Uncompressed: x || y with the infinity flag on the last byte of y.

ARK_SW_Y_IS_NEGATIVE = 0x80
ARK_SW_INFINITY = 0x40


def _ark_y_is_negative(spec, ys) -> bool:
    """arkworks Fp/Fp2 ordering: compare against -y, most significant
    coordinate (c1) first, by canonical integer value."""
    neg = [(spec.modulus - y) % spec.modulus for y in ys]
    return ys[::-1] > neg[::-1]


def ark_point_to_bytes(group, affine_int_point, compressed: bool = True) -> bytes:
    """(x, y, inf) host ints -> arkworks CanonicalSerialize bytes."""
    spec = group.spec
    x, y, inf = affine_int_point
    per = spec.serialized_size() * _width(group)
    if inf:
        out = bytearray(per if compressed else 2 * per)
        out[-1] |= ARK_SW_INFINITY
        return bytes(out)
    xs, ys = _coords(group, x), _coords(group, y)
    if compressed:
        out = bytearray(fields_to_bytes(spec, xs))
        if _ark_y_is_negative(spec, ys):
            out[-1] |= ARK_SW_Y_IS_NEGATIVE
        return bytes(out)
    return fields_to_bytes(spec, xs) + fields_to_bytes(spec, ys)


def ark_point_from_bytes(group, data: bytes, compressed: bool = True):
    """arkworks bytes -> (x, y, inf) host ints (a compressed point is checked
    to lie on the curve by the square root that recovers y)."""
    spec = group.spec
    nd = _width(group)
    per = spec.serialized_size()
    buf = bytearray(data)
    flags = buf[-1] & 0xC0
    buf[-1] &= 0x3F
    if flags & ARK_SW_INFINITY:
        return (0, 0, True) if nd == 1 else ((0, 0), (0, 0), True)
    xs = [field_from_bytes(spec, bytes(buf[i * per : (i + 1) * per])) for i in range(nd)]
    if compressed:
        ys = _recover_y(group, xs)
        if _ark_y_is_negative(spec, ys) != bool(flags & ARK_SW_Y_IS_NEGATIVE):
            ys = [(spec.modulus - y) % spec.modulus for y in ys]
    else:
        ys = [field_from_bytes(spec, bytes(buf[(nd + i) * per : (nd + i + 1) * per]))
              for i in range(nd)]
    if nd == 1:
        return (xs[0], ys[0], False)
    return (tuple(xs), tuple(ys), False)


def _recover_y(group, xs):
    """y with y^2 = x^3 + b (Fq or Fq2; a = 0); returns the smaller root."""
    p = group.spec.modulus
    if not hostec._is_g2(group):
        x = xs[0]
        y = _sqrt_fp((pow(x, 3, p) + group.b_int) % p, p)
        return [min(y, p - y)]
    f = hostec.host_group(group).f  # Fq2 = Fq[u]/(u^2 - nr)
    x = tuple(xs)
    x3 = f.mul(f.mul(x, x), x)
    y = _sqrt_fp2(f.add(x3, group.b), p, f.nr)
    yneg = f.neg(y)
    return list(min(y[::-1], yneg[::-1])[::-1])


def _sqrt_fp(a, p):
    """Tonelli-Shanks (any odd p)."""
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        raise ValueError("not a quadratic residue")
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def _sqrt_fp2(a, p, nr):
    """Square root in Fq2 = Fq[u]/(u^2 - nr) by the norm/trace
    decomposition."""
    a0, a1 = a
    if a1 == 0:
        if pow(a0, (p - 1) // 2, p) == 1:
            return (_sqrt_fp(a0, p), 0)
        # the root lies along u: (0, y1) with nr y1^2 = a0
        return (0, _sqrt_fp(a0 * pow(nr, -1, p) % p, p))
    # the norm a0^2 - nr a1^2 must be a square in Fq
    n = _sqrt_fp((a0 * a0 - nr * a1 * a1) % p, p)
    inv2 = pow(2, -1, p)
    for sign in (1, -1):
        alpha = (a0 + sign * n) % p * inv2 % p
        if pow(alpha, (p - 1) // 2, p) == 1:
            y0 = _sqrt_fp(alpha, p)
            if y0 == 0:
                continue
            y1 = a1 * pow(2 * y0, -1, p) % p
            if ((y0 * y0 + nr * y1 * y1) % p, (2 * y0 * y1) % p) == (a0 % p, a1 % p):
                return (y0, y1)
    raise ValueError("no square root in Fq2")


# ---------------------------------------------------------------------------
# zcash/IETF-format BLS12-381 serialization (big-endian, flag bits in the
# FIRST byte: 0x80 compressed, 0x40 infinity, 0x20 larger y): the
# ecosystem's interchange format, whose generator encodings are public test
# vectors for the curve constants and the sign logic.
# ---------------------------------------------------------------------------


def zcash_g1_to_bytes(point, q: int) -> bytes:
    """(x, y, inf) ints -> 48-byte zcash-compressed BLS12-381 G1."""
    x, y, inf = point
    if inf:
        return bytes([0x80 | 0x40]) + bytes(47)
    out = bytearray(int(x).to_bytes(48, "big"))
    out[0] |= 0x80
    if y > q - y:
        out[0] |= 0x20
    return bytes(out)


def zcash_g2_to_bytes(point, q: int) -> bytes:
    """((x0, x1), (y0, y1), inf) -> 96-byte zcash-compressed G2 (c1 || c0)."""
    x, y, inf = point
    if inf:
        return bytes([0x80 | 0x40]) + bytes(95)
    out = bytearray(int(x[1]).to_bytes(48, "big") + int(x[0]).to_bytes(48, "big"))
    out[0] |= 0x80
    if list(y[::-1]) > [(q - c) % q for c in y[::-1]]:
        out[0] |= 0x20
    return bytes(out)


@trace.traced("Serialize::to_host", log=False)
def mont_limbs_to_bytes(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """(L, N) Montgomery limbs (< 2p) -> (N, serialized_size) uint8: row i
    is field_to_bytes of element i. Out of Montgomery form by one K1
    product with 1, canonicalized, and narrowed to 16 bits on the device,
    then one copy to the host."""
    one = ff.from_ints(spec, [1], mont=False, device=a.device)
    v = ff.canonicalize(spec, ff.mont_mul(spec, a, one.expand_as(a).contiguous()))
    v16 = torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16).T.contiguous()
    trace.count("host_syncs")
    raw = v16.cpu().numpy().view(np.uint8)  # (N, 2L): LE limbs are LE bytes
    return raw[:, : spec.serialized_size()]


@trace.traced("Serialize::to_host", log=False)
def device_point_to_ints(group, pt_proj):
    """Projective device point (coords (L,)) -> (x, y, inf) Python ints.

    One point: normalised on host ints, like the JAX package off the TPU
    (infinity gives zero coordinates, as its device inversion of 0 does;
    in G2 (0, 0) pairs)."""
    P = hostec.device_proj_to_host(group, pt_proj)
    zero = (0, 0) if hostec._is_g2(group) else 0
    return (zero, zero, True) if P is None else (P[0], P[1], False)


@trace.traced("Serialize::to_host", log=False)
def device_points_to_ints(group, pts_proj):
    """Batched projective points -> list of (x, y, inf) int triples, with
    one batched inversion on the device (G2 coordinates as (c0, c1))."""
    x, y, inf = group.to_affine(pts_proj)
    if hostec._is_g2(group):
        L = group.spec.n_limbs
        trace.count("host_syncs", 2)
        xs, ys = (ff.limbs_to_ints(group.spec, a.reshape(-1, L).cpu().numpy()) for a in (x, y))
        xs, ys = list(zip(xs[0::2], xs[1::2])), list(zip(ys[0::2], ys[1::2]))
    else:
        xs = F.to_ints(group.spec, x)
        ys = F.to_ints(group.spec, y)
    trace.count("host_syncs")
    return list(zip(xs, ys, inf.cpu().tolist()))
