"""Shared linear-code utilities (a copy of
poly_commit_tpu/pcs/linear_codes/utils.py).

Re-designs of the reference's linear_codes/utils.rs:
  calculate_t              utils.rs:156-184
  get_indices_from_sponge  utils.rs:136-153
  get_num_bytes            utils.rs:129-132
  tensor_vec               utils.rs:240-258  (== core/poly.eq_table here)
and of the entropy/ceil helpers at src/utils.rs:26-45.
"""

from __future__ import annotations

import math

from ...core import poly as P
from .. import errors


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ceil_mul(n: int, frac: tuple) -> int:
    """ceil(n * num/den) (utils.rs:37-40)."""
    num, den = frac
    return ceil_div(n * num, den)


def ent(x: float) -> float:
    """Binary entropy (utils.rs:26-33)."""
    if not 0.0 <= x <= 1.0:
        raise ValueError(f"entropy of {x}: not a probability")
    if x in (0.0, 1.0):
        return 0.0
    return -x * math.log2(x) - (1.0 - x) * math.log2(1.0 - x)


def calculate_t(spec, sec_param: int, distance: tuple, codeword_len: int) -> int:
    """Smallest t with (1-delta)^t + (rho+delta)^t + n/|F| < 2^-lambda
    (utils.rs:156-184; delta = distance.0/distance.1 halved in the bound)."""
    residual = codeword_len / (2.0 ** spec.num_bits)
    arg = 2.0 ** (-sec_param) - residual
    if arg <= 0 or not math.isfinite(arg):
        raise errors.InvalidParameters(
            "field too small for the codeword length / security level")
    nom = math.log2(arg) - 1.0
    denom = math.log2(1.0 - 0.5 * distance[0] / distance[1])
    if denom == 0 or not math.isfinite(denom):
        raise errors.InvalidParameters("the distance is wrong")
    t = math.ceil(nom / denom)
    return t if t < codeword_len else codeword_len


def get_num_bytes(n: int) -> int:
    return ceil_div(n.bit_length(), 8)


def get_indices_from_sponge(n: int, t: int, sponge) -> list:
    """t sponge-driven column indices in [0, n) (utils.rs:136-153)."""
    nbytes = get_num_bytes(n)
    out = []
    for _ in range(t):
        bts = sponge.squeeze_bytes(nbytes)
        sponge.absorb_bytes(bts)
        ind = 0
        for b in bts:
            ind = (ind << 8) + b
        out.append(ind % n)
    return out


def tensor_vec(spec, point):
    """eq-tensor with variable i at index bit i (utils.rs:240-258)."""
    return P.eq_table(spec, point)
