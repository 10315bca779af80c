"""Hyrax multilinear PC (WTsTW17, Fiat-Shamired) over BN254 G1.

Counterpart of poly_commit_tpu/pcs/hyrax.py (the reference's hyrax/mod.rs):
  setup (hash-derived Pedersen key)      mod.rs:119-168
  commit (per-row Pedersen multi-commit) mod.rs:193-255
  open (Sigma dot-product argument)      mod.rs:273-406
  check (eqs (13)/(14) of the paper)     mod.rs:418-511
  flat_to_matrix_column_major/tensors    utils.rs:13-39

The coefficient matrix stays on the device as (dim, dim, L) Montgomery
limbs. Commit takes every row commitment from one batched MSM over the
shared key (``msm.msm_rows``: one digit sort, one ``madd_scan`` and the
window fold on the device per chunk of rows, kernels K3, K2a and K1),
adds the hiding terms h r_i (``fixed_base_mul``, one K2a ``add``) and
normalises all rows in one batched inversion. Open's lt = l^T M is one K1
product and log2(dim) K1 additions; inner products are a product and a
halving sum. Hash-to-curve and the verifier's O(1) algebra run on host
ints, the Poseidon transcript in the native host sponge (the statement's
points in one crossing). Under an active mesh whose axis size
divides the row count, the row commitments shard their rows over the ranks
(``parallel.mesh.batch_msm_sharded``), as the JAX package's branch does.

As in the JAX package: the per-row hiding randomness comes from the
caller's seeded HostRng, and ``check`` does not read the claimed values
(the evaluation is bound by com_eval inside the proof, mod.rs:447).
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from .. import device as D
from ..core import curve as C
from ..core import field as F
from ..core import field_params as FP
from ..core import hostec
from ..core import msm as M
from ..core import poly as P
from ..core.serialize import device_point_to_ints, device_points_to_ints, point_to_bytes
from ..parallel import mesh as PM
from ..utils.trace import scope, traced
from . import errors
from .data_structures import LabeledCommitment, PolynomialCommitment

GROUP = C.BN254_G1
SPEC = FP.FR_BN254
BASE = FP.FQ_BN254
HGROUP = hostec.host_group(GROUP)
PROTOCOL_NAME = b"Hyrax protocol"


def _hash_to_curve(seed: bytes):
    """Candidate x from Blake2s; y = sqrt(x^3 + b) (BN254: p = 3 mod 4)."""
    p = BASE.modulus
    b = FP.BN254_B
    j = 0
    while True:
        h = hashlib.blake2s(seed + j.to_bytes(8, "little")).digest()
        x = int.from_bytes(h, "little") % p
        rhs = (x * x * x + b) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            if h[0] & 1:
                y = (p - y) % p
            return (x, y)  # cofactor 1 for BN254 G1
        j += 1


def sample_generators(num: int):
    return [_hash_to_curve(PROTOCOL_NAME + i.to_bytes(8, "little")) for i in range(num)]


@dataclasses.dataclass
class UniversalParams:
    """com_key (device affine (x, y, inf), batch (dim,)), the hiding
    generator h and the key's host points for the transcript
    (data_structures.rs:14-41)."""

    com_key: tuple
    h: tuple  # host (x, y)
    com_key_host: list  # [(x, y)]

    @property
    def dim(self):
        return int(self.com_key[0].shape[0])


CommitterKey = UniversalParams
VerifierKey = UniversalParams


@dataclasses.dataclass
class Commitment:
    row_coms: list  # host [(x, y, inf)]


@dataclasses.dataclass
class CommitmentState:
    """Per-row hiding randomness and the coefficient matrix (device)."""

    randomness: torch.Tensor  # (dim, L) Montgomery
    mat: torch.Tensor  # (dim, dim, L) Montgomery, mat[r, c]


@dataclasses.dataclass
class HyraxProof:
    com_eval: tuple  # host (x, y, inf)
    com_d: tuple
    com_b: tuple
    z: list  # dim ints
    z_d: int
    z_b: int


def _fsum0(a: torch.Tensor) -> torch.Tensor:
    """Field sum over axis 0 (any length): a halving loop of K1 additions."""
    n = a.shape[0]
    while n > 1:
        half = n // 2
        head = F.add(SPEC, a[:half], a[half : 2 * half])
        a = head if n % 2 == 0 else torch.cat([head, a[n - 1 :]], 0)
        n = (n + 1) // 2
    return a[0]


@traced("Poly::combine", log=False)
def _ip(a: torch.Tensor, b: torch.Tensor) -> int:
    return F.to_ints(SPEC, _fsum0(F.mont_mul(SPEC, a, b)))


def _pedersen(key_aff, scalars_mont, h_host, rand_int: int):
    """MSM over the key (K3, K2a) plus the hiding term h rand on host ints;
    returns a host (x, y, inf) triple."""
    pt = M.msm_mont(GROUP, scalars_mont, key_aff, assume_distinct=True)
    host = hostec.triple_to_host(device_point_to_ints(GROUP, pt))
    return hostec.host_to_triple(HGROUP.add(host, HGROUP.mul_fast(h_host, rand_int)))


def _absorb_point(sponge, triple):
    sponge.absorb_bytes(point_to_bytes(GROUP, triple))


def _absorb_statement(sponge, key, row_coms, point):
    """The key, the row commitments and the point (mod.rs:330-341): one
    ``Transcript::absorb`` span, the points in one crossing into the sponge."""
    with scope("Transcript::absorb", log=False):
        points = [(x, y, False) for (x, y) in key.com_key_host]
        points.append((key.h[0], key.h[1], False))
        points.extend(row_coms)
        sponge.absorb_bytes_many([point_to_bytes(GROUP, pt) for pt in points])
        sponge.absorb_field([int(v) % SPEC.modulus for v in point])


def _tensors(point, device):
    """(l, r): the eq tensors of the row variables (the first half) and of
    the column variables."""
    n = len(point)
    if n % 2 == 1:
        raise errors.InvalidNumberOfVariables()
    pt = F.from_ints(SPEC, [int(v) % SPEC.modulus for v in point], device=device)
    return P.tensor_lsb(SPEC, pt[: n // 2]), P.tensor_lsb(SPEC, pt[n // 2 :])


def _commit_rows(ck, mat: torch.Tensor, rand_mont: torch.Tensor):
    """All row commitments: msm_rows over the key (its rows sharded over an
    active mesh whose axis size divides them), plus h r_i by batched
    fixed-base multiplication and one addition, normalised together."""
    dev = mat.device
    plain_rows = F.from_mont(SPEC, mat)
    active = PM.active_mesh()
    if active is not None and mat.shape[0] % active[0].size(active[1]) == 0:
        mesh, axis = active
        row_pts = PM.batch_msm_sharded(GROUP, plain_rows, ck.com_key, mesh, axis, assume_distinct=True)
    else:
        row_pts = M.msm_rows(GROUP, plain_rows, ck.com_key, assume_distinct=True)
    h_dev = GROUP.from_affine(F.from_ints(BASE, ck.h[0], device=dev),
                              F.from_ints(BASE, ck.h[1], device=dev))
    h_terms = M.fixed_base_mul(GROUP, h_dev, F.from_mont(SPEC, rand_mont))
    return device_points_to_ints(GROUP, GROUP.add(row_pts, h_terms))


class HyraxPC(PolynomialCommitment):
    spec = SPEC

    @classmethod
    @traced("Hyrax::setup")
    def setup(cls, max_degree=0, num_vars=None, rng=None, device=None):
        if num_vars is None or num_vars % 2 == 1:
            raise errors.InvalidNumberOfVariables()
        dim = 1 << (num_vars // 2)
        pts = sample_generators(dim + 1)
        h = pts.pop()
        com_key = C.affine_from_ints(GROUP, [(x, y, False) for (x, y) in pts], D.resolve(device))
        return UniversalParams(com_key=com_key, h=h, com_key_host=pts)

    @classmethod
    @traced("Hyrax::trim")
    def trim(cls, pp, supported_degree=0, supported_hiding_bound=0, enforced_degree_bounds=None):
        return pp, pp

    @classmethod
    def evaluate_poly(cls, labeled_poly, point):
        table = labeled_poly.poly
        pt = F.from_ints(SPEC, [int(v) % SPEC.modulus for v in point], device=table.device)
        return F.to_ints(SPEC, P.mle_evaluate(SPEC, table, pt))

    @classmethod
    @traced("Hyrax::commit")
    def commit(cls, ck, polynomials, rng=None):
        if rng is None:
            raise errors.MissingRng()
        dim = ck.dim
        comms, states = [], []
        for lp in polynomials:
            n = lp.num_vars if lp.num_vars is not None else int(lp.poly.shape[0]).bit_length() - 1
            if n % 2 == 1 or (1 << (n // 2)) != dim:
                raise errors.InvalidNumberOfVariables()
            # column-major matrix: mat[r, c] = evals[c dim + r] (utils.rs:13-21)
            mat = lp.poly.reshape(dim, dim, SPEC.n_limbs).transpose(0, 1).contiguous()
            rand = F.from_ints(SPEC, rng.field_ints(SPEC, dim), device=mat.device)
            row_coms = _commit_rows(ck, mat, rand)
            comms.append(LabeledCommitment(lp.label, Commitment(row_coms), None))
            states.append(CommitmentState(randomness=rand, mat=mat))
        return comms, states

    @classmethod
    @traced("Hyrax::open")
    def open(cls, ck, polynomials, commitments, point, sponge, states, rng=None):
        """mod.rs:273-406. point: a tuple of nv ints."""
        if rng is None:
            raise errors.MissingRng()
        dev = ck.com_key[0].device
        l, r = _tensors(point, dev)
        p_mod = SPEC.modulus
        proofs = []
        for lp, lcm, st in zip(polynomials, commitments, states):
            if lp.label != lcm.label:
                raise errors.PCError("mismatched labels")
            _absorb_statement(sponge, ck, lcm.commitment.row_coms, point)

            # lt = l^T M; r_lt = <l, randomness>; eval = <lt, r>
            with scope("Poly::combine", log=False):
                lt = _fsum0(F.mont_mul(SPEC, l[:, None, :], st.mat))  # (dim, L)
                r_lt = _ip(l, st.randomness)
                eval_int = _ip(lt, r)

            r_eval = rng.field_int(SPEC)
            g0 = ck.com_key_host[0]
            com_eval = hostec.host_to_triple(HGROUP.add(HGROUP.mul_fast(g0, eval_int),
                                                        HGROUP.mul_fast(ck.h, r_eval)))
            d = F.from_ints(SPEC, rng.field_ints(SPEC, ck.dim), device=dev)
            b_int = _ip(r, d)
            r_d = rng.field_int(SPEC)
            com_d = _pedersen(ck.com_key, d, ck.h, r_d)
            r_b = rng.field_int(SPEC)
            com_b = hostec.host_to_triple(HGROUP.add(HGROUP.mul_fast(g0, b_int),
                                                     HGROUP.mul_fast(ck.h, r_b)))

            _absorb_point(sponge, com_eval)
            _absorb_point(sponge, com_d)
            _absorb_point(sponge, com_b)
            c = sponge.squeeze_field(1)[0]

            z = F.add(SPEC, d, F.mont_mul(SPEC, lt, F.from_ints(SPEC, c, device=dev)))
            proofs.append(HyraxProof(com_eval=com_eval, com_d=com_d, com_b=com_b,
                                     z=F.to_ints(SPEC, z), z_d=(c * r_lt + r_d) % p_mod,
                                     z_b=(c * r_eval + r_b) % p_mod))
        return proofs

    @classmethod
    @traced("Hyrax::check")
    def check(cls, vk, commitments, point, values, proof, sponge):
        """mod.rs:418-511 (values are not read: see the module docstring)."""
        dev = vk.com_key[0].device
        l, r = _tensors(point, dev)
        p_mod = SPEC.modulus
        for lcm, hp in zip(commitments, proof):
            row_coms = lcm.commitment.row_coms
            if len(row_coms) != vk.dim:
                raise errors.InvalidCommitment()
            _absorb_statement(sponge, vk, row_coms, point)
            _absorb_point(sponge, hp.com_eval)
            _absorb_point(sponge, hp.com_d)
            _absorb_point(sponge, hp.com_b)
            c = sponge.squeeze_field(1)[0]

            z = F.from_ints(SPEC, [int(v) % p_mod for v in hp.z], device=dev)
            rz = _ip(r, z)

            # eq (14): com_key[0] <r, z> + h z_b == c com_eval + com_b
            g0 = vk.com_key_host[0]
            lhs = HGROUP.add(HGROUP.mul_fast(g0, rz), HGROUP.mul_fast(vk.h, hp.z_b))
            rhs = HGROUP.add(HGROUP.mul_fast(hostec.triple_to_host(hp.com_eval), c),
                             hostec.triple_to_host(hp.com_b))
            if lhs != rhs:
                return False

            # T' = MSM(row_coms, l) with the complete formulas
            t_prime = M.msm_mont(GROUP, l, C.affine_from_ints(GROUP, row_coms, dev))
            t_host = hostec.triple_to_host(device_point_to_ints(GROUP, t_prime))

            # eq (13): Pedersen(z) + h z_d == c T' + com_d
            lhs2 = hostec.triple_to_host(_pedersen(vk.com_key, z, vk.h, hp.z_d))
            rhs2 = HGROUP.add(HGROUP.mul_fast(t_host, c), hostec.triple_to_host(hp.com_d))
            if lhs2 != rhs2:
                return False
        return True
