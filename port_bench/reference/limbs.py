"""Exact sums of field elements held as 16-bit limbs, on any torch device.

A value is sum_k a_k 2^(16k) with limbs a_k < 2^16, so sum_i a_i w_i over n
terms is sum_{k,j} 2^(16(k+j)) sum_i a_{i,k} w_{i,j}: an integer matrix
product of limbs. Each product of two limbs is below 2^32 and a column of
n < 2^21 of them sums below 2^53, so float64 holds every partial sum of the
product exactly, whatever order the matrix product adds in. The 256 limb
pairs are gathered into 31 diagonals on the device and the rest is done in
Python integers.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16
EXACT_TERMS = 1 << 21  # n (2^16 - 1)^2 < 2^53 below this
BLOCK = 1024  # a polynomial's coefficients are evaluated a block at a time


def to_limbs(values, n_limbs: int, device) -> torch.Tensor:
    """Python ints (each below 2^(16 n_limbs)) as (len, n_limbs) float64."""
    raw = b"".join(int(v).to_bytes(2 * n_limbs, "little") for v in values)
    arr = np.frombuffer(raw, dtype="<u2").reshape(len(values), n_limbs).astype(np.float64)
    return torch.from_numpy(arr).to(device)


def weighted_sums(a: torch.Tensor, weights: list, modulus: int) -> list:
    """For limbs a (m, n, L) and n weights below 2^(16 L'): the m values
    sum_i value(a[m, i]) * weights[i] mod modulus."""
    m, n, n_limbs = a.shape
    if n >= EXACT_TERMS:
        raise ValueError(f"{n} terms: float64 sums are exact below {EXACT_TERMS}")
    w_limbs = -(-max(1, max(int(w) for w in weights).bit_length()) // LIMB_BITS)
    w = to_limbs(weights, w_limbs, a.device)
    q = torch.matmul(a.to(torch.float64).transpose(1, 2), w)  # (m, L, L')
    k = torch.arange(n_limbs, device=a.device)[:, None]
    j = torch.arange(w_limbs, device=a.device)[None, :]
    diag = (k + j).reshape(-1)
    sums = torch.zeros((m, n_limbs + w_limbs - 1), dtype=torch.float64, device=a.device)
    sums.index_add_(1, diag, q.reshape(m, -1))
    rows = sums.cpu().numpy().astype(np.int64).tolist()
    out = []
    for row in rows:
        v = 0
        for d in reversed(row):
            v = (v << LIMB_BITS) + d
        out.append(v % modulus)
    return out


def evaluate(coeffs: torch.Tensor, x: int, modulus: int) -> int:
    """sum_i value(coeffs[i]) x^i mod modulus for limbs (n, L): a block of
    BLOCK coefficients at a time against x^0..x^(BLOCK-1), the blocks then
    combined by Horner's rule in x^BLOCK."""
    n, n_limbs = coeffs.shape
    pad = (-n) % BLOCK
    if pad:
        coeffs = torch.cat([coeffs, coeffs.new_zeros((pad, n_limbs))], 0)
    blocks = coeffs.reshape(-1, BLOCK, n_limbs)
    pows = [1] * BLOCK
    for i in range(1, BLOCK):
        pows[i] = pows[i - 1] * x % modulus
    sums = weighted_sums(blocks, pows, modulus)
    step = pows[-1] * x % modulus
    acc = 0
    for s in reversed(sums):
        acc = (acc * step + s) % modulus
    return acc
