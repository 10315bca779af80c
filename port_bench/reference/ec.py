"""Short-Weierstrass G1 arithmetic (y^2 = x^3 + b) on Python integers.

Affine points are (x, y) tuples, infinity is None; sums run in Jacobian
coordinates (X, Y, Z), Z = 0 at infinity: dbl-2009-l, madd-2007-bl and
add-2007-bl with their edge cases. ``msm`` is Pippenger's bucket method.
"""

from __future__ import annotations

INF = (1, 1, 0)


def double(q, P):
    X, Y, Z = P
    if Z == 0 or Y == 0:
        return INF
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    D = 2 * ((X + B) * (X + B) - A - C) % q
    E = 3 * A % q
    X3 = (E * E - 2 * D) % q
    return X3, (E * (D - X3) - 8 * C) % q, 2 * Y * Z % q


def madd(q, P, a):
    """Jacobian P plus affine a (not None)."""
    X1, Y1, Z1 = P
    x2, y2 = a
    if Z1 == 0:
        return x2, y2, 1
    Z1Z1 = Z1 * Z1 % q
    H = (x2 * Z1Z1 - X1) % q
    r = (y2 * Z1 * Z1Z1 - Y1) % q
    if H == 0:
        return double(q, P) if r == 0 else INF
    HH = H * H % q
    I = 4 * HH % q
    J = H * I % q
    r = 2 * r % q
    V = X1 * I % q
    X3 = (r * r - J - 2 * V) % q
    return X3, (r * (V - X3) - 2 * Y1 * J) % q, 2 * Z1 * H % q


def add(q, P, Q):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if Z1 == 0:
        return Q
    if Z2 == 0:
        return P
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    S1 = Y1 * Z2 * Z2Z2 % q
    H = (X2 * Z1Z1 - U1) % q
    r = (Y2 * Z1 * Z1Z1 - S1) % q
    if H == 0:
        return double(q, P) if r == 0 else INF
    I = 4 * H * H % q
    J = H * I % q
    r = 2 * r % q
    V = U1 * I % q
    X3 = (r * r - J - 2 * V) % q
    return X3, (r * (V - X3) - 2 * S1 * J) % q, 2 * Z1 * Z2 * H % q


def to_affine(q, P):
    X, Y, Z = P
    if Z == 0:
        return None
    zi = pow(Z, -1, q)
    zi2 = zi * zi % q
    return X * zi2 % q, Y * zi2 * zi % q


def mul(q, a, k: int):
    """k a for an affine a (left to right, a mixed addition a set bit)."""
    acc = INF
    if a is None or k == 0:
        return None
    for bit in bin(k)[2:]:
        acc = double(q, acc)
        if bit == "1":
            acc = madd(q, acc, a)
    return to_affine(q, acc)


def add_affine(q, *points):
    acc = INF
    for a in points:
        if a is not None:
            acc = madd(q, acc, a)
    return to_affine(q, acc)


def msm(q, points, scalars):
    """sum k_i a_i over affine points (None skipped) by Pippenger's buckets,
    with the window that makes the fewest additions."""
    pairs = [(a, k) for a, k in zip(points, scalars) if a is not None and k]
    if not pairs:
        return None
    n = len(pairs)
    bits = max(k.bit_length() for _, k in pairs)
    c = min(range(1, 17), key=lambda w: -(-bits // w) * (n + 2 ** (w + 1)))
    mask = (1 << c) - 1
    total = INF
    for w in reversed(range(-(-bits // c))):
        for _ in range(c):
            total = double(q, total)
        buckets = [INF] * (mask + 1)
        shift = w * c
        for a, k in pairs:
            d = (k >> shift) & mask
            if d:
                buckets[d] = madd(q, buckets[d], a)
        running, acc = INF, INF
        for d in range(mask, 0, -1):
            running = add(q, running, buckets[d])
            acc = add(q, acc, running)
        total = add(q, total, acc)
    return to_affine(q, total)
