"""Host (python-int) BLS12-381 pairing backend of the PyTorch port.

A copy of poly_commit_tpu/core/host_pairing.py. The pairing is O(1) per
verification and latency-bound, so the verifier runs it on exact big ints:
Fq2 = Fq[u]/(u^2+1), Fq12 = Fq2[w]/(w^6 - (u+1)), affine Miller loop with
xi-scaled lines, full (q^12-1)/r final power. Replaces arkworks
E::multi_pairing for host-side verification (kzg10/mod.rs:326-329 etc.).
"""

from __future__ import annotations

from . import field_params as FP

P = FP.BLS12_381_Q
R = FP.BLS12_381_R
X_PARAM = FP.BLS12_381_X_PARAM
FINAL_EXP = (P**12 - 1) // R
XI = (1, 1)
F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def _f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def _f2_inv(a):
    n = (a[0] * a[0] + a[1] * a[1]) % P
    ni = pow(n, -1, P)
    return ((a[0] * ni) % P, (-a[1] * ni) % P)


def _f12_one():
    return [F2_ONE] + [F2_ZERO] * 5


def _f12_mul(a, b):
    tmp = [F2_ZERO] * 11
    for i in range(6):
        if a[i] == F2_ZERO:
            continue
        for j in range(6):
            if b[j] == F2_ZERO:
                continue
            tmp[i + j] = _f2_add(tmp[i + j], _f2_mul(a[i], b[j]))
    out = tmp[:6]
    for k in range(6, 11):
        out[k - 6] = _f2_add(out[k - 6], _f2_mul(tmp[k], XI))
    return out


def _f12_conj(a):
    return [a[i] if i % 2 == 0 else _f2_neg(a[i]) for i in range(6)]


def _f12_pow(a, e):
    out = _f12_one()
    base = a
    while e:
        if e & 1:
            out = _f12_mul(out, base)
        base = _f12_mul(base, base)
        e >>= 1
    return out


def _line(t, q_or_none, p_aff):
    xt, yt = t
    if q_or_none is None:
        lam = _f2_mul(_f2_mul((3, 0), _f2_mul(xt, xt)), _f2_inv(_f2_add(yt, yt)))
    else:
        xq, yq = q_or_none
        lam = _f2_mul(_f2_sub(yq, yt), _f2_inv(_f2_sub(xq, xt)))
    xp, yp = p_aff
    out = [F2_ZERO] * 6
    out[0] = _f2_mul((yp % P, 0), XI)
    out[3] = _f2_sub(_f2_mul(lam, xt), yt)
    out[5] = _f2_neg(_f2_mul(lam, (xp % P, 0)))
    return out, lam


def _g2_dbl(t, lam):
    xt, yt = t
    x3 = _f2_sub(_f2_mul(lam, lam), _f2_add(xt, xt))
    y3 = _f2_sub(_f2_mul(lam, _f2_sub(xt, x3)), yt)
    return (x3, y3)


def _g2_add(t, q, lam):
    xt, yt = t
    xq, _ = q
    x3 = _f2_sub(_f2_sub(_f2_mul(lam, lam), xt), xq)
    y3 = _f2_sub(_f2_mul(lam, _f2_sub(xt, x3)), yt)
    return (x3, y3)


def miller_loop(p_aff, q_aff):
    """f_{|x|,Q}(P) with affine (x, y) inputs (python ints / int pairs)."""
    bits = bin(abs(X_PARAM))[2:]
    f = _f12_one()
    t = q_aff
    for bit in bits[1:]:
        l, lam = _line(t, None, p_aff)
        f = _f12_mul(_f12_mul(f, f), l)
        t = _g2_dbl(t, lam)
        if bit == "1":
            l, lam = _line(t, q_aff, p_aff)
            f = _f12_mul(f, l)
            t = _g2_add(t, q_aff, lam)
    if X_PARAM < 0:
        f = _f12_conj(f)
    return f


def pairing(p_aff, q_aff):
    """e(P, Q) as the Fq12 value [(c0, c1)] * 6 (flattened w-basis), from
    affine (x, y) inputs: the Miller loop, then the full final power."""
    return _f12_pow(miller_loop(p_aff, q_aff), FINAL_EXP)


def pairing_product_is_one(g1_triples, g2_triples) -> bool:
    """prod e(P_i, Q_i) == 1 over host int triples (x, y, inf).

    Infinite entries contribute the identity. One shared final exponent.
    """
    acc = _f12_one()
    for (px, py, pinf), (qx, qy, qinf) in zip(g1_triples, g2_triples):
        if pinf or qinf:
            continue
        acc = _f12_mul(acc, miller_loop((px, py), (qx, qy)))
    out = _f12_pow(acc, FINAL_EXP)
    return out == _f12_one()
