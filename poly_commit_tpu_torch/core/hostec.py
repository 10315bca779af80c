"""Host-side (Python-int) group laws for verifier-scale math.

A copy of poly_commit_tpu/core/hostec.py (Weierstrass G1/G2 and the JubJub
Edwards group) for the PyTorch port, with converters to and from the port's
tensors. Verifier-side
combining touches a handful of points with big-int scalars, so it runs on
host ints (like the reference's CPU-serial verifier); so do single-point
multiplications in setup and the G2 points h and beta_h. Bulk prover work
(MSMs, fixed-base tables, normalisation) stays on the device.

Points are (x, y) tuples (ints, or int pairs for Fq2) with None = infinity
(Weierstrass) or (0, 1) the identity (Edwards).
"""

from __future__ import annotations

from . import field_params as FP
from ..utils import trace


class _Fp:
    def __init__(self, p):
        self.p = p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def neg(self, a):
        return (-a) % self.p

    def is_zero(self, a):
        return a == 0


class _Fp2:
    def __init__(self, p, nr):
        self.p = p
        self.nr = nr % p

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def mul(self, a, b):
        return (
            (a[0] * b[0] + self.nr * a[1] * b[1]) % self.p,
            (a[0] * b[1] + a[1] * b[0]) % self.p,
        )

    def inv(self, a):
        norm = (a[0] * a[0] - self.nr * a[1] * a[1]) % self.p
        ni = pow(norm, -1, self.p)
        return ((a[0] * ni) % self.p, (-a[1] * ni) % self.p)

    def neg(self, a):
        return ((-a[0]) % self.p, (-a[1]) % self.p)

    def is_zero(self, a):
        return a[0] == 0 and a[1] == 0


class HostWeierstrass:
    """y^2 = x^3 + b (a = 0); affine python-int points, None = infinity."""

    def __init__(self, field, order):
        self.f = field
        self.order = order

    def add(self, P, Q):
        f = self.f
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if y1 == f.neg(y2):
                return None
            return self.double(P)
        lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
        x3 = f.sub(f.sub(f.mul(lam, lam), x1), x2)
        return (x3, f.sub(f.mul(lam, f.sub(x1, x3)), y1))

    def double(self, P):
        f = self.f
        if P is None:
            return None
        x, y = P
        if f.is_zero(y):
            return None
        x2 = f.mul(x, x)
        lam = f.mul(f.add(f.add(x2, x2), x2), f.inv(f.add(y, y)))
        x3 = f.sub(f.mul(lam, lam), f.add(x, x))
        return (x3, f.sub(f.mul(lam, f.sub(x, x3)), y))

    def neg(self, P):
        if P is None:
            return None
        return (P[0], self.f.neg(P[1]))

    def sub(self, P, Q):
        return self.add(P, self.neg(Q))

    def mul(self, P, k):
        k = int(k) % self.order
        acc, a = None, P
        while k:
            if k & 1:
                acc = self.add(acc, a)
            a = self.double(a)
            k >>= 1
        return acc

    def msm(self, scalars, points):
        acc = None
        for s, P in zip(scalars, points):
            acc = self.add(acc, self.mul(P, s))
        return acc

    # -- Jacobian fast path (no per-op inversion) -------------------------
    # Verifier-scale MSMs on CPU hosts: shared-doubling MSB-first over all
    # points with Jacobian adds (~8 big-int mults each) instead of affine
    # adds (one modular inversion each) — ~10x on python ints. Exact same
    # group law; one inversion at the very end.

    def _jdouble(self, P):
        if P is None:
            return None
        f = self.f
        X, Y, Z = P
        if f.is_zero(Y):
            return None
        A = f.mul(X, X)
        B = f.mul(Y, Y)
        C = f.mul(B, B)
        t = f.add(X, B)
        D = f.sub(f.sub(f.mul(t, t), A), C)
        D = f.add(D, D)
        E = f.add(f.add(A, A), A)
        X3 = f.sub(f.mul(E, E), f.add(D, D))
        C8 = f.add(C, C)
        C8 = f.add(C8, C8)
        C8 = f.add(C8, C8)
        Y3 = f.sub(f.mul(E, f.sub(D, X3)), C8)
        Z3 = f.mul(f.add(Y, Y), Z)
        return (X3, Y3, Z3)

    def _jmadd(self, P, A):
        """Jacobian P + affine A (A != None)."""
        f = self.f
        if P is None:
            x, y = A
            return (x, y, _one(f))
        X1, Y1, Z1 = P
        x2, y2 = A
        Z1Z1 = f.mul(Z1, Z1)
        U2 = f.mul(x2, Z1Z1)
        S2 = f.mul(f.mul(y2, Z1), Z1Z1)
        if U2 == X1:
            if S2 == Y1:
                return self._jdouble(P)
            return None
        H = f.sub(U2, X1)
        HH = f.mul(H, H)
        I = f.add(f.add(HH, HH), f.add(HH, HH))
        J = f.mul(H, I)
        r = f.sub(S2, Y1)
        r = f.add(r, r)
        V = f.mul(X1, I)
        X3 = f.sub(f.sub(f.mul(r, r), J), f.add(V, V))
        Y3 = f.sub(f.mul(r, f.sub(V, X3)), f.add(f.mul(Y1, J), f.mul(Y1, J)))
        t = f.add(Z1, H)
        Z3 = f.sub(f.sub(f.mul(t, t), Z1Z1), HH)
        return (X3, Y3, Z3)

    def _jto_affine(self, P):
        if P is None:
            return None
        f = self.f
        X, Y, Z = P
        if f.is_zero(Z):
            return None
        zi = f.inv(Z)
        zi2 = f.mul(zi, zi)
        return (f.mul(X, zi2), f.mul(Y, f.mul(zi2, zi)))

    def mul_fast(self, P, k):
        if P is None:
            return None
        k = int(k) % self.order
        acc = None
        for bit in reversed(range(k.bit_length())):
            acc = self._jdouble(acc)
            if (k >> bit) & 1:
                acc = self._jmadd(acc, P)
        return self._jto_affine(acc)

    def msm_fast(self, scalars, points):
        """sum_i s_i * P_i: shared MSB-first doubling, Jacobian adds."""
        pairs = [
            (int(s) % self.order, P)
            for s, P in zip(scalars, points)
            if P is not None and int(s) % self.order != 0
        ]
        if not pairs:
            return None
        nbits = max(s.bit_length() for s, _ in pairs)
        acc = None
        for bit in reversed(range(nbits)):
            acc = self._jdouble(acc)
            for s, P in pairs:
                if (s >> bit) & 1:
                    acc = self._jmadd(acc, P)
        return self._jto_affine(acc)


def _one(f):
    return (1, 0) if isinstance(f, _Fp2) else 1


class HostEdwards:
    """a = -1 twisted Edwards; identity (0, 1)."""

    def __init__(self, p, d, order):
        self.p = p
        self.d = d % p
        self.order = order

    def add(self, P, Q):
        p, d = self.p, self.d
        x1, y1 = P
        x2, y2 = Q
        dd = d * x1 * x2 * y1 * y2 % p
        x3 = (x1 * y2 + y1 * x2) * pow(1 + dd, -1, p) % p
        y3 = (y1 * y2 + x1 * x2) * pow(1 - dd, -1, p) % p
        return (x3, y3)

    def double(self, P):
        return self.add(P, P)

    def neg(self, P):
        return ((-P[0]) % self.p, P[1])

    def sub(self, P, Q):
        return self.add(P, self.neg(Q))

    def mul(self, P, k):
        k = int(k) % self.order
        acc, a = (0, 1), P
        while k:
            if k & 1:
                acc = self.add(acc, a)
            a = self.add(a, a)
            k >>= 1
        return acc

    def msm(self, scalars, points):
        acc = (0, 1)
        for s, P in zip(scalars, points):
            acc = self.add(acc, self.mul(P, s))
        return acc

    def identity(self):
        return (0, 1)

    # -- extended-coordinate fast path (a = -1; no per-op inversion) -------
    # (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z; add-2008-hwcd-3.

    def _eadd(self, P, Q):
        p, d = self.p, self.d
        X1, Y1, Z1, T1 = P
        X2, Y2, Z2, T2 = Q
        A = (Y1 - X1) * (Y2 - X2) % p
        B = (Y1 + X1) * (Y2 + X2) % p
        C = 2 * d * T1 % p * T2 % p
        D = 2 * Z1 * Z2 % p
        E = B - A
        F = D - C
        G = D + C
        H = B + A
        return (E * F % p, G * H % p, F * G % p, E * H % p)

    def _eto_ext(self, P):
        x, y = P
        return (x % self.p, y % self.p, 1, x * y % self.p)

    def _eto_affine(self, P):
        X, Y, Z, _ = P
        zi = pow(Z, -1, self.p)
        return (X * zi % self.p, Y * zi % self.p)

    def mul_fast(self, P, k):
        k = int(k) % self.order
        acc = (0, 1, 1, 0)
        base = self._eto_ext(P)
        for bit in reversed(range(max(1, k.bit_length()))):
            acc = self._eadd(acc, acc)
            if (k >> bit) & 1:
                acc = self._eadd(acc, base)
        return self._eto_affine(acc)

    def msm_fast(self, scalars, points):
        pairs = [
            (int(s) % self.order, self._eto_ext(P))
            for s, P in zip(scalars, points)
            if int(s) % self.order != 0 and tuple(P) != (0, 1)
        ]
        if not pairs:
            return (0, 1)
        nbits = max(s.bit_length() for s, _ in pairs)
        acc = (0, 1, 1, 0)
        for bit in reversed(range(nbits)):
            acc = self._eadd(acc, acc)
            for s, P in pairs:
                if (s >> bit) & 1:
                    acc = self._eadd(acc, P)
        return self._eto_affine(acc)


def _is_edwards(group) -> bool:
    return group.name == "jubjub"


def _is_g2(group) -> bool:
    return group.name.endswith("_g2")


def host_group(group):
    """The host mirror of a group, by name (G1 or G2 of either BLS curve,
    BN254's G1, or JubJub)."""
    n = group.name
    if n == "bls12_381_g1":
        return HostWeierstrass(_Fp(FP.BLS12_381_Q), FP.BLS12_381_R)
    if n == "bls12_381_g2":
        return HostWeierstrass(_Fp2(FP.BLS12_381_Q, -1), FP.BLS12_381_R)
    if n == "bn254_g1":
        return HostWeierstrass(_Fp(FP.BN254_Q), FP.BN254_R)
    if n == "bls12_377_g1":
        return HostWeierstrass(_Fp(FP.BLS12_377_Q), FP.BLS12_377_R)
    if n == "bls12_377_g2":
        return HostWeierstrass(_Fp2(FP.BLS12_377_Q, -5), FP.BLS12_377_R)
    if n == "jubjub":
        return HostEdwards(FP.BLS12_381_R, FP.JUBJUB_D, FP.JUBJUB_R)
    raise ValueError(n)


def device_proj_to_host(group, p):
    """Device projective point (batch ()) -> host affine point, normalised
    on host ints (G2 coordinates become (c0, c1) pairs)."""
    from . import field as F

    coords = [F.to_ints(group.spec, c) for c in p]
    hg = host_group(group)
    if _is_edwards(group):
        X, Y, Z, _ = coords
        zi = pow(Z, -1, hg.p)
        return (X * zi % hg.p, Y * zi % hg.p)
    if _is_g2(group):
        coords = [tuple(c) for c in coords]
    return hg._jto_affine(tuple(coords))


def host_point_to_device(group, P, device):
    """One host affine point -> device projective point, batch ()."""
    from . import extfield as E2
    from . import field as F

    if _is_edwards(group) and P is None:
        P = (0, 1)
    if P is None:
        return group.infinity((), device)
    conv = E2.from_int if _is_g2(group) else (lambda s, v, d: F.from_ints(s, v, device=d))
    return group.from_affine(conv(group.spec, P[0], device), conv(group.spec, P[1], device))


@trace.traced("Serialize::to_host", log=False)
def device_affine_to_host(group, points) -> list:
    """Device affine (x, y, inf), batch (N,) or () -> list of host points.

    Weierstrass infinity -> None; the Edwards identity -> (0, 1); G2
    coordinates become (c0, c1) int pairs (the _Fp2 convention)."""
    from . import ff

    x, y, inf = points
    L = group.spec.n_limbs
    trace.count("host_syncs", 3)  # x, y and inf
    xs, ys = (ff.limbs_to_ints(group.spec, a.reshape(-1, L).cpu().numpy()) for a in (x, y))
    if _is_g2(group):
        xs, ys = list(zip(xs[0::2], xs[1::2])), list(zip(ys[0::2], ys[1::2]))
    ident = (0, 1) if _is_edwards(group) else None
    return [ident if i else (a, b) for a, b, i in zip(xs, ys, inf.reshape(-1).cpu().tolist())]


def host_points_to_device_affine(group, pts, device=None):
    """List of host affine points -> device affine (x, y, inf), batch (N,),
    in curve.affine_from_ints's layout."""
    from .curve import affine_from_ints

    fq2, ed = _is_g2(group), _is_edwards(group)
    triples = [host_to_triple(None, fq2) if P is None or (ed and tuple(P) == (0, 1))
               else (P[0], P[1], False) for P in pts]
    return affine_from_ints(group, triples, device)


def triple_to_host(t):
    """(x, y, inf) -> host point (None for infinity)."""
    x, y, inf = t
    return None if inf else (x, y)


def host_to_triple(P, fq2=False):
    if P is None:
        zero = (0, 0) if fq2 else 0
        one = (1, 0) if fq2 else 1
        return (zero, one, True)
    return (P[0], P[1], False)
