"""Generic linear-code PCS engine: commit / open / check once for all codes.

Counterpart of poly_commit_tpu/pcs/linear_codes/engine.py, itself a
re-design of the reference's linear_codes/mod.rs:150-566:
  commit   mod.rs:228-298  matrix -> row encode -> column hashes -> Merkle root
  open     mod.rs:300-373 + generate_proof mod.rs:523-566
  check    mod.rs:375-502  paths, re-encode w = E(v), per-column inner
                           products, <v, a> = value
The code (Ligero here) supplies the dimensions, the batched row encode on
the device, the tensors and the point's field elements.

The coefficient matrix and its encoding stay on the device; v = b^T M is
one K1 product and a log-depth sum of rows. ``commit`` hashes the columns
where the matrix lies (``column_leaves``): on the card in one kernel
launch that reads only the digests back, on the CPU through one pass of
column bytes and hashlib, never through Python ints; the leaves are the
digests the JAX package computes. The Merkle tree runs on the host.
``open`` and ``check`` touch t columns and stay on Python ints. Under an
active mesh of more than one rank whose axis size divides the rows,
v = b^T M shards its rows (``parallel.mesh.row_mul_sharded``), as the JAX
package's branch does.

Quiet spans (utils/trace.py): ``LinearCode::encode`` around the row encode,
``Merkle::leaves`` around the column hashes (its read from the card, of
the digests, is a ``Serialize::to_host`` child), ``Merkle::tree`` around
each tree build (utils/merkle.py) and around an opening's loop over its
paths. The counter ``hashed_bytes`` counts the bytes given to Blake2s and
SHA-256.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ... import device as D
from ...core import field as F
from ...core import poly as P
from ...core.serialize import fields_to_bytes, mont_limbs_to_bytes
from ...parallel import mesh as PM
from ...utils import trace
from ...utils.merkle import MerklePath, MerkleTree, blake2s_columns, blake2s_hash, verify_path
from ...utils.trace import traced
from .. import errors
from ..data_structures import LabeledCommitment, PolynomialCommitment
from .utils import calculate_t, get_indices_from_sponge


@dataclasses.dataclass
class Metadata:
    n_rows: int
    n_cols: int
    n_ext_cols: int


@dataclasses.dataclass
class LinCodePCCommitment:
    metadata: Metadata
    root: bytes


@dataclasses.dataclass
class LinCodePCCommitmentState:
    mat: torch.Tensor  # (n_rows, n_cols, L) Montgomery, on the device
    ext_mat: torch.Tensor  # (n_rows, n_ext_cols, L)
    leaves: List[bytes]  # column hashes


@dataclasses.dataclass
class LinCodePCProofSingle:
    paths: List[MerklePath]
    v: List[int]  # b^T M (n_cols ints)
    columns: List[List[int]]  # t queried ext-matrix columns (n_rows each)


@dataclasses.dataclass
class LinCodePCProof:
    opening: LinCodePCProofSingle
    well_formedness: Optional[List[int]] = None


def _col_hash(spec, col_ints) -> bytes:
    return blake2s_hash(fields_to_bytes(spec, col_ints))


def column_bytes(spec, ext_mat: torch.Tensor):
    """(n_rows, n_ext, L) Montgomery -> (n_ext, n_rows size) uint8 on the
    host: row c is ``fields_to_bytes`` of column c's canonical ints, from
    one transpose on the device and one copy."""
    n_rows, n_ext, L = ext_mat.shape
    by_col = ext_mat.transpose(0, 1).reshape(-1, L).T.contiguous()  # (L, n_ext n_rows)
    return mont_limbs_to_bytes(spec, by_col).reshape(n_ext, -1)


@trace.traced("Merkle::leaves", log=False)
def column_leaves(spec, ext_mat: torch.Tensor) -> List[bytes]:
    """Blake2s of each column of (n_rows, n_ext, L): ``_col_hash`` of its
    canonical ints. On the CPU, hashlib over ``column_bytes``; on any other
    device, ``blake2s_columns``' one kernel launch (CUDA only)."""
    n_rows, n_ext = ext_mat.shape[0], ext_mat.shape[1]
    trace.count("hashed_bytes", n_ext * n_rows * spec.serialized_size())
    if ext_mat.device.type != "cpu":
        return blake2s_columns(spec, ext_mat)
    return [blake2s_hash(col.tobytes()) for col in column_bytes(spec, ext_mat)]


def _row_mul(spec, vec: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """v^T M: vec (n, L), mat (n, m, L) -> (m, L); log-depth row sum, the
    rows sharded over an active mesh of more than one rank whose axis size
    divides n."""
    active = PM.active_mesh()
    if active is not None:
        mesh, axis = active
        if mesh.size(axis) > 1 and vec.shape[0] % mesh.size(axis) == 0:
            return PM.row_mul_sharded(spec, vec, mat, mesh, axis)
    return P.row_combination(spec, vec, mat)


def _ip_ints(spec, a_ints, b_ints) -> int:
    p = spec.modulus
    return sum(int(a) * int(b) % p for a, b in zip(a_ints, b_ints)) % p


class LinearCodePCS(PolynomialCommitment):
    """Subclass with class attributes ``code`` and ``spec = code.spec``."""

    code = None  # injected by the concrete schemes

    @classmethod
    @traced("LinearCodePCS::setup")
    def setup(cls, max_degree, num_vars=None, rng=None, device=None):
        pp = cls.code.setup(max_degree, num_vars, rng, device)
        if pp.max_degree_supported() == 0 or (
            max_degree and max_degree > pp.max_degree_supported()
        ):
            raise errors.InvalidParameters("field too small for this degree")
        return pp

    @classmethod
    def trim(cls, pp, supported_degree=0, supported_hiding_bound=0,
             enforced_degree_bounds=None):
        return pp, pp

    @classmethod
    def evaluate_poly(cls, labeled_poly, point):
        return cls.code.evaluate_poly(labeled_poly, point)

    @classmethod
    @traced("LinearCodePCS::commit")
    def commit(cls, ck, polynomials, rng=None):
        spec = cls.spec
        comms, states = [], []
        for lp in polynomials:
            coeffs = cls.code.poly_to_vec(lp)  # (len, L) on the device
            n_rows, n_cols = ck.compute_dimensions(int(coeffs.shape[0]))
            total = n_rows * n_cols
            if coeffs.shape[0] < total:
                coeffs = torch.cat([coeffs, coeffs.new_zeros((total - coeffs.shape[0], spec.n_limbs))])
            mat = coeffs.reshape(n_rows, n_cols, spec.n_limbs)  # row-major
            with trace.scope("LinearCode::encode", log=False):
                ext_mat = cls.code.encode_rows(mat, ck)  # (n_rows, ext, L)
            leaves = column_leaves(spec, ext_mat)
            tree = MerkleTree(leaves, ck.merkle_config())
            md = Metadata(n_rows, n_cols, int(ext_mat.shape[1]))
            comms.append(LabeledCommitment(lp.label, LinCodePCCommitment(md, tree.root), None))
            states.append(LinCodePCCommitmentState(mat=mat, ext_mat=ext_mat, leaves=leaves))
        return comms, states

    @classmethod
    @traced("LinearCodePCS::open")
    def open(cls, ck, polynomials, commitments, point, sponge, states, rng=None):
        spec = cls.spec
        proof_array = []
        for lcm, st in zip(commitments, states):
            md = lcm.commitment.metadata
            dev = st.mat.device
            tree = MerkleTree(st.leaves, ck.merkle_config())
            _, b = cls.code.tensor(point, md.n_cols, md.n_rows, dev)
            sponge.absorb_bytes(lcm.commitment.root)

            well_formedness = None
            if ck.check_well_formedness:
                r = F.from_ints(spec, sponge.squeeze_field(md.n_rows), device=dev)
                well_formedness = F.to_ints(spec, _row_mul(spec, r, st.mat))
                sponge.absorb_field(well_formedness)

            sponge.absorb_field(cls.code.point_to_vec(point))

            # generate_proof (mod.rs:523-566)
            t = calculate_t(spec, ck.sec_param, ck.distance(), md.n_ext_cols)
            v = F.to_ints(spec, _row_mul(spec, b, st.mat))
            sponge.absorb_field(v)
            indices = get_indices_from_sponge(md.n_ext_cols, t, sponge)
            picked = st.ext_mat[:, torch.tensor(indices, device=dev)]  # (n_rows, t, L)
            columns = F.to_ints(spec, picked.transpose(0, 1))
            with trace.scope("Merkle::tree", log=False):
                paths = [tree.generate_proof(i) for i in indices]
            proof_array.append(LinCodePCProof(
                opening=LinCodePCProofSingle(paths=paths, v=v, columns=columns),
                well_formedness=well_formedness))
        return proof_array

    @classmethod
    @traced("LinearCodePCS::check")
    def check(cls, vk, commitments, point, values, proof_array, sponge):
        spec = cls.spec
        p_mod = spec.modulus
        cfg = vk.merkle_config()
        dev = D.resolve(vk.device)
        for i, (lcm, value) in enumerate(zip(commitments, values)):
            proof = proof_array[i]
            md = lcm.commitment.metadata
            root = lcm.commitment.root
            t = calculate_t(spec, vk.sec_param, vk.distance(), md.n_ext_cols)

            sponge.absorb_bytes(root)

            r_ints = None
            if vk.check_well_formedness:
                if proof.well_formedness is None:
                    raise errors.InvalidCommitment()
                r_ints = sponge.squeeze_field(md.n_rows)
                sponge.absorb_field(proof.well_formedness)

            sponge.absorb_field(cls.code.point_to_vec(point))
            sponge.absorb_field(proof.opening.v)
            indices = get_indices_from_sponge(md.n_ext_cols, t, sponge)

            # Merkle paths
            for j, (col, q_j) in enumerate(zip(proof.opening.columns, indices)):
                path = proof.opening.paths[j]
                if path.leaf_index != q_j:
                    raise errors.InvalidCommitment()
                if not verify_path(path, root, _col_hash(spec, col), cfg):
                    raise errors.InvalidCommitment()

            # re-encode w = E(v), and E(well-formedness) when asked
            def encoded(ints):
                vec = F.from_ints(spec, [int(x) % p_mod for x in ints], device=dev)
                return F.to_ints(spec, cls.code.encode_rows(vec[None], vk)[0])

            w = encoded(proof.opening.v)
            a, b_dev = cls.code.tensor(point, md.n_cols, md.n_rows, dev)
            b_ints = F.to_ints(spec, b_dev)
            a_ints = F.to_ints(spec, a)
            checks = [(b_ints, w)]
            if r_ints is not None:
                checks.insert(0, (r_ints, encoded(proof.well_formedness)))
            for ti, mi in enumerate(indices):
                col = proof.opening.columns[ti]
                for coeffs, enc in checks:
                    if _ip_ints(spec, coeffs, col) != int(enc[mi]) % p_mod:
                        raise errors.InvalidCommitment()

            if _ip_ints(spec, proof.opening.v, a_ints) != int(value) % p_mod:
                return False
        return True
