"""Field elements to bytes, and device points to host ints.

The parts of poly_commit_tpu/core/serialize.py that the ported schemes
use: a field element is ceil(num_bits / 8) little-endian bytes of its
canonical integer. ``mont_limbs_to_bytes`` gives the same bytes for a whole
(L, N) Montgomery tensor in one pass on its device, since 16-bit
little-endian limbs are the value's little-endian bytes. The point codecs
come with the golden-vector replay.
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
    (infinity gives (0, 0, True), as its device inversion of 0 does)."""
    P = hostec.device_proj_to_host(group, pt_proj)
    return (0, 0, True) if P is None else (P[0], P[1], False)


def device_points_to_ints(group, pts_proj):
    """Batched projective points -> list of (x, y, inf) int triples, with
    one batched inversion on the device."""
    x, y, inf = group.to_affine(pts_proj)
    xs = F.to_ints(group.spec, x)
    ys = F.to_ints(group.spec, y)
    return list(zip(xs, ys, inf.cpu().tolist()))
