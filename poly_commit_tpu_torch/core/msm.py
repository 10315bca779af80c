"""MSM and fixed-base multiplication entry points on limbs-last points.

Counterpart of poly_commit_tpu/core/msm.py. Points are the scheme layer's
tensors: affine (x, y, inf) with x, y (N, L) in G1 and JubJub, (N, 2, L)
(c0, c1) pairs in G2; projective points have coords (L,), or (2, L) in G2.
Every call runs core/msm_gpu.py on the tensors' device, whatever N is, with
the group's ops (msm_gpu.ops_for): there is no host big-int route and no
small-N route, so on a CUDA tensor every MSM goes through the kernels K1,
K3 and K2a (G1), K2c (G2) or K2b (JubJub).
"""

from __future__ import annotations

import torch

from . import field as F
from . import msm_gpu
from .field_params import FieldSpec
from ..utils import trace


def _ops(group):
    """The group's msm_gpu ops, after checking that its kernels apply."""
    ops = msm_gpu.ops_for(group)
    if ops is not msm_gpu.EDWARDS_OPS and 4 * group.spec.modulus > group.spec.R:
        raise ValueError(f"{group.name}: the Weierstrass MSM kernels need R >= 4p")
    return ops


def msm(group, scalars: torch.Tensor, points, assume_distinct: bool = False):
    """sum_i scalars[i] * points[i].

    scalars: (N, 16) int32 plain (non-Montgomery) 16-bit limbs.
    points:  affine (x, y, inf) with leading batch axis N.
    Returns a projective point, batch (), canonical.

    assume_distinct: the bases are pairwise DL-independent (true for every
    SRS), which lets the Weierstrass scans use the branch-free mixed add;
    NOT safe for repeated or adversarial points (P + P would silently give
    infinity).
    """
    ops = _ops(group)
    x, y, inf = points
    out = msm_gpu.msm(group, scalars, ops.to_lf(x), ops.to_lf(y), inf, assume_distinct)
    return tuple(ops.from_lf(group.spec, cc, ()) for cc in out)


def msm_rows(group, scalars: torch.Tensor, points, assume_distinct: bool = False):
    """B MSMs over the same N bases, one a row of ``scalars`` (B, N, 16)
    int32 plain limbs; points affine (x, y, inf) with batch (N,). Returns a
    projective point with batch (B,), canonical: row b is
    msm(scalars[b], points). G1 groups only; the windows fold on the
    device (msm_gpu.msm_rows)."""
    ops = _ops(group)
    x, y, inf = points
    out = msm_gpu.msm_rows(group, scalars, ops.to_lf(x), ops.to_lf(y), inf, assume_distinct)
    return tuple(ops.from_lf(group.spec, cc, (scalars.shape[0],)) for cc in out)


def msm_mont(group, scalars_mont: torch.Tensor, points, **kw):
    """MSM with scalars given in Montgomery form of ``group.scalar_spec``."""
    return msm(group, F.from_mont(group.scalar_spec, scalars_mont), points, **kw)


def fixed_base_mul(group, base, scalars: torch.Tensor):
    """[s_i * base] for a projective base in G1 or G2: projective points
    with batch (N,), canonical. A base at infinity gives infinity."""
    ops = _ops(group)
    bx, by, binf = group.to_affine(base)
    n = scalars.shape[0]
    trace.count("host_syncs")
    if bool(binf):
        return group.infinity((n,), bx.device)
    out = msm_gpu.fixed_base(group, ops.to_lf(bx[None]), ops.to_lf(by[None]), scalars)
    return tuple(ops.from_lf(group.spec, cc, (n,)) for cc in out)


def scalars_from_ints(spec: FieldSpec, ints, device=None) -> torch.Tensor:
    """Python ints -> plain (N, L) limbs for msm()."""
    return F.from_ints(spec, list(ints), mont=False, device=device)
