"""Field elements and points to bytes, and device points to host ints.

The parts of poly_commit_tpu/core/serialize.py that the ported schemes
use: a field element is ceil(num_bits / 8) little-endian bytes of its
canonical integer. ``mont_limbs_to_bytes`` gives the same bytes for a whole
(L, N) Montgomery tensor in one pass on its device, since 16-bit
little-endian limbs are the value's little-endian bytes. An uncompressed
point is x || y || a flag byte (what IPA-PC's transcript hashes); the
compressed and arkworks codecs come with the golden-vector replay.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ff
from . import field as F
from . import hostec
from .field_params import FieldSpec


def field_to_bytes(spec: FieldSpec, value: int) -> bytes:
    return (int(value) % spec.modulus).to_bytes(spec.serialized_size(), "little")


def fields_to_bytes(spec: FieldSpec, values) -> bytes:
    return b"".join(field_to_bytes(spec, v) for v in values)


def _coords(group, v) -> list:
    """A coordinate as its list of base-field ints (c0, c1 in G2)."""
    return list(v) if hostec._is_g2(group) else [v]


def point_to_bytes_uncompressed(group, affine_int_point) -> bytes:
    """(x, y, inf) host ints -> x || y || flag (1 at infinity, with zero
    coordinates)."""
    spec = group.spec
    x, y, inf = affine_int_point
    width = 2 if hostec._is_g2(group) else 1
    if inf:
        return bytes(2 * spec.serialized_size() * width) + b"\x01"
    return fields_to_bytes(spec, _coords(group, x)) + fields_to_bytes(spec, _coords(group, y)) + b"\x00"


def mont_limbs_to_bytes(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """(L, N) Montgomery limbs (< 2p) -> (N, serialized_size) uint8: row i
    is field_to_bytes of element i. Out of Montgomery form by one K1
    product with 1, canonicalized, and narrowed to 16 bits on the device,
    then one copy to the host."""
    one = ff.from_ints(spec, [1], mont=False, device=a.device)
    v = ff.canonicalize(spec, ff.mont_mul(spec, a, one.expand_as(a).contiguous()))
    v16 = torch.where(v >= 1 << 15, v - (1 << 16), v).to(torch.int16).T.contiguous()
    raw = v16.cpu().numpy().view(np.uint8)  # (N, 2L): LE limbs are LE bytes
    return raw[:, : spec.serialized_size()]


def device_point_to_ints(group, pt_proj):
    """Projective device point (coords (L,)) -> (x, y, inf) Python ints.

    One point: normalised on host ints, like the JAX package off the TPU
    (infinity gives zero coordinates, as its device inversion of 0 does;
    in G2 (0, 0) pairs)."""
    P = hostec.device_proj_to_host(group, pt_proj)
    zero = (0, 0) if hostec._is_g2(group) else 0
    return (zero, zero, True) if P is None else (P[0], P[1], False)


def device_points_to_ints(group, pts_proj):
    """Batched projective points -> list of (x, y, inf) int triples, with
    one batched inversion on the device (G2 coordinates as (c0, c1))."""
    x, y, inf = group.to_affine(pts_proj)
    if hostec._is_g2(group):
        L = group.spec.n_limbs
        xs, ys = (ff.limbs_to_ints(group.spec, a.reshape(-1, L).cpu().numpy()) for a in (x, y))
        xs, ys = list(zip(xs[0::2], xs[1::2])), list(zip(ys[0::2], ys[1::2]))
    else:
        xs = F.to_ints(group.spec, x)
        ys = F.to_ints(group.spec, y)
    return list(zip(xs, ys, inf.cpu().tolist()))
