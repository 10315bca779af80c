"""Radix-2 NTT / iNTT and evaluation domains over 2-adic prime fields.

Counterpart of poly_commit_tpu/core/ntt.py (ark-poly's
``GeneralEvaluationDomain::fft``, the reference's Reed-Solomon encoder).
``ntt``/``intt`` here are the portable field-last route: (..., n, L)
Montgomery coefficients, a bit-reversal gather, then one vectorised stage
per level on core/field.py (K1 on a CUDA tensor). It is the plain reference
of the whole transform; the fast route is core/ntt_lf.py (K4a/K4b/K4c).

Twiddles: stage s of the DIT transform on bit-reversed input uses the 2^s
distinct roots w_{2^(s+1)}^j = pows[j n / 2^(s+1)], with pows the n/2
powers of w. Both routes share them: the powers are built once on the
device by doubling (log2 n products) and each stage's prefix is a strided
slice, cached per (field, log n, direction, device). The JAX package
materialises a (log n, n/2) table of Python ints instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import poly as P
from .field_params import FieldSpec


@functools.lru_cache(maxsize=64)
def domain(spec: FieldSpec, log_n: int) -> dict:
    """The 2^log_n evaluation domain: n, its root w, w^-1 and n^-1 as ints.

    The JAX domain also lists every power of w as a Python int; here they
    live on the device (``stage_twiddles``)."""
    if not 0 <= log_n <= spec.two_adicity:
        raise ValueError(f"{spec.name}: no domain of size 2^{log_n}")
    n = 1 << log_n
    p = spec.modulus
    w = pow(spec.two_adic_root, 1 << (spec.two_adicity - log_n), p)
    return {"n": n, "log_n": log_n, "omega": w, "omega_inv": pow(w, -1, p),
            "n_inv": pow(n, -1, p)}


@functools.lru_cache(maxsize=64)  # both directions of each size to 2^21 (long_divide)
def _stage_twiddles(spec: FieldSpec, log_n: int, inverse: bool, device: str) -> tuple:
    d = domain(spec, log_n)
    half_n = max(1, d["n"] // 2)
    root = F.from_ints(spec, d["omega_inv" if inverse else "omega"], device=device)
    pows = P.powers(spec, root, half_n).T.contiguous()  # (L, n/2): w^j
    return tuple(pows[:, :: half_n >> s].contiguous() for s in range(log_n))


def stage_twiddles(spec: FieldSpec, log_n: int, inverse: bool, device) -> tuple:
    """Per stage s < log_n, its 2^s distinct twiddles as (L, 2^s) canonical
    Montgomery limbs on ``device`` (of w^-1 for the inverse transform)."""
    return _stage_twiddles(spec, log_n, inverse, str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _bitrev_np(log_n: int) -> np.ndarray:
    idx = np.arange(1 << log_n)
    rev = np.zeros(1 << log_n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=64)
def _bitrev_on(log_n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_bitrev_np(log_n)).to(device)


def bitrev_perm(log_n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of 2^log_n indices (int64 on device)."""
    return _bitrev_on(log_n, str(torch.device(device)))


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"transform length {n} is not a power of two")
    return log_n


def _ntt_impl(spec: FieldSpec, a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """In-order -> in-order NTT of a (..., n, L): each stage a reshape, one
    product, one add and one subtract over the whole batch."""
    n, L = a.shape[-2], a.shape[-1]
    log_n = _log2(n)
    tws = stage_twiddles(spec, log_n, inverse, a.device)
    a = a.index_select(a.dim() - 2, bitrev_perm(log_n, a.device))
    batch = tuple(a.shape[:-2])
    for s in range(log_n):
        half = 1 << s
        x = a.reshape(batch + (n // (2 * half), 2, half, L))
        u, w = x[..., 0, :, :], x[..., 1, :, :]
        v = F.mont_mul(spec, w, tws[s].T)
        a = torch.stack([F.add(spec, u, v), F.sub(spec, u, v)], dim=-3).reshape(batch + (n, L))
    if inverse:
        a = F.mont_mul(spec, a, F.from_ints(spec, domain(spec, log_n)["n_inv"], device=a.device))
    return a


def ntt(spec: FieldSpec, coeffs: torch.Tensor) -> torch.Tensor:
    """Forward NTT: coefficients (..., n, L) -> evaluations at w^i."""
    return _ntt_impl(spec, coeffs, False)


def intt(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations (..., n, L) -> coefficients."""
    return _ntt_impl(spec, evals, True)
