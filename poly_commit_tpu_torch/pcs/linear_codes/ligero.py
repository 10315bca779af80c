"""Ligero (univariate and multilinear): Reed-Solomon rows by the NTT kernels.

Counterpart of poly_commit_tpu/pcs/linear_codes/ligero.py, itself a
re-design of the reference's linear_codes/ligero.rs (parameters, dimension
selection :118-128, maximum degree from the 2-adicity :48-56) and
univariate_ligero/mod.rs and multilinear_ligero/mod.rs (encode =
Reed-Solomon; rho_inv = 4 univariate, 2 multilinear; sec_param 128;
well-formedness on). The RS encode (linear_codes/utils.rs:112-127) of all
rows is one batched limbs-first NTT (core/ntt_lf.py: K4b and K4c, or K4a
for small matrices) on every device; the JAX package takes that route on
the TPU only. Under an active mesh (one rank included) whose axis size
divides the rows of a matrix, each rank transforms its rows
(``parallel.mesh.batch_ntt_sharded``), as the JAX package's branch does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ...core import ff, ntt_lf
from ...core import field as F
from ...core import poly as P
from ...parallel import mesh as PM
from ...utils.merkle import MerkleConfig
from .engine import LinearCodePCS
from .utils import calculate_t, ceil_div, tensor_vec


@dataclasses.dataclass(frozen=True)
class LigeroPCParams:
    """ligero.rs:22-39; doubles as UniversalParams/CommitterKey/VerifierKey.
    ``device`` is where ``check`` re-encodes (None: the default device)."""

    spec: object
    sec_param: int = 128
    rho_inv: int = 4
    check_well_formedness: bool = True
    device: Optional[str] = None

    def distance(self):
        return (self.rho_inv - 1, self.rho_inv)

    def max_degree_supported(self):
        """ligero.rs:48-56: bounded by the field's 2-adicity."""
        ta = self.spec.two_adicity
        if ta < int(math.log2(self.rho_inv)):
            return 0
        ex = (ta - int(math.log2(self.rho_inv))) * 2
        return 1 << min(ex, 62)

    def compute_dimensions(self, poly_len: int):
        """ligero.rs:118-128: (rows, columns)."""
        t = calculate_t(self.spec, self.sec_param, self.distance(), poly_len)
        base = math.ceil(math.sqrt(ceil_div(2 * poly_len, t)))
        n = 1 << max(0, (base - 1).bit_length())  # next power of two
        return (n, ceil_div(poly_len, n))

    def merkle_config(self):
        return MerkleConfig()


def _rs_encode_rows(mat: torch.Tensor, ck: LigeroPCParams) -> torch.Tensor:
    """Every row of (..., m, L) evaluated over the smallest 2^k >= m rho_inv
    points (linear_codes/utils.rs:112-127): zero-pad, one batched NTT,
    canonical -> (..., 2^k, L); the rows of an (R, m, L) matrix sharded
    over an active mesh whose axis size divides R."""
    m, L = mat.shape[-2], mat.shape[-1]
    ext = 1 << max(1, (m * ck.rho_inv - 1).bit_length())
    padded = torch.cat([mat, mat.new_zeros(mat.shape[:-2] + (ext - m, L))], -2)
    active = PM.active_mesh()
    if active is not None and padded.ndim == 3 and padded.shape[0] % active[0].size(active[1]) == 0:
        return PM.batch_ntt_sharded(ck.spec, padded, active[0], active[1])
    rows = padded.numel() // (ext * L)
    out = ntt_lf.ntt(ck.spec, ff.from_field_last(padded), rows=rows)
    return ff.to_field_last(ff.canonicalize(ck.spec, out), padded.shape[:-1])


class UnivariateLigeroCode:
    """univariate_ligero/mod.rs:27-87."""

    def __init__(self, spec):
        self.spec = spec

    def setup(self, max_degree, num_vars, rng, device=None):
        return LigeroPCParams(spec=self.spec, sec_param=128, rho_inv=4,
                              check_well_formedness=True, device=device)

    def poly_to_vec(self, lp):
        return lp.poly

    def point_to_vec(self, point):
        return [int(point) % self.spec.modulus]

    def tensor(self, point, n_cols, n_rows, device):
        """a = (1, z, ..., z^{m-1}); b = (1, z^m, ..., z^{m(n-1)})."""
        p = self.spec.modulus
        z = int(point) % p
        a = P.powers(self.spec, F.from_ints(self.spec, z, device=device), n_cols)
        b = P.powers(self.spec, F.from_ints(self.spec, pow(z, n_cols, p), device=device), n_rows)
        return a, b

    def evaluate_poly(self, lp, point):
        z = F.from_ints(self.spec, int(point) % self.spec.modulus, device=lp.poly.device)
        return int(F.to_ints(self.spec, P.evaluate(self.spec, lp.poly, z)))

    def encode_rows(self, mat, ck):
        return _rs_encode_rows(mat, ck)


class MultilinearLigeroCode:
    """multilinear_ligero/mod.rs:30-84 (rho_inv = 2)."""

    def __init__(self, spec):
        self.spec = spec

    def setup(self, max_degree, num_vars, rng, device=None):
        return LigeroPCParams(spec=self.spec, sec_param=128, rho_inv=2,
                              check_well_formedness=True, device=device)

    def poly_to_vec(self, lp):
        return lp.poly  # (2^nv, L) evaluation table

    def point_to_vec(self, point):
        return [int(z) % self.spec.modulus for z in point]

    def tensor(self, point, n_cols, n_rows, device):
        split = (n_cols - 1).bit_length()
        pt = F.from_ints(self.spec, self.point_to_vec(point), device=device)
        return tensor_vec(self.spec, pt[:split]), tensor_vec(self.spec, pt[split:])

    def evaluate_poly(self, lp, point):
        pt = F.from_ints(self.spec, self.point_to_vec(point), device=lp.poly.device)
        return int(F.to_ints(self.spec, P.mle_evaluate(self.spec, lp.poly, pt)))

    def encode_rows(self, mat, ck):
        return _rs_encode_rows(mat, ck)


def _scheme(name, code):
    cls = type(f"{name}_{code.spec.name}", (LinearCodePCS,), {})
    cls.spec = code.spec
    cls.code = code
    return cls


def make_univariate_ligero(spec):
    return _scheme("UnivariateLigero", UnivariateLigeroCode(spec))


def make_multilinear_ligero(spec):
    return _scheme("MultilinearLigero", MultilinearLigeroCode(spec))
