"""Merkle tree over byte leaves, on hashlib.

A copy of poly_commit_tpu/utils/merkle.py (ark-crypto-primitives'
MerkleTree/Path as the linear-code schemes use them,
linear_codes/mod.rs:506-521 and :443-451) without its native C++ batch
hasher: identity leaf hash, SHA-256 two-to-one compression and a Blake2s
column hash by default, the reference's test configuration. The roots are
the JAX package's, which hashes the same bytes with the same functions.
A tree build is the quiet span ``Merkle::tree`` and counts 64 bytes a
compression in ``hashed_bytes`` (utils/trace.py).

``blake2s_columns`` is the column hash on the card: one launch of
``pc_blake2s_columns`` (csrc/blake2s.cu) gives every column's digest of a
linear code's encoded matrix, the same bytes as ``blake2s_hash`` over the
column's serialized field elements, and one copy of n_ext x 32 bytes
brings them to the host. It counts its launches in
``blake2s_columns.launches`` and its columns in the counter
``blake2s_device_columns``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
from typing import Callable, List

import torch

from .. import device as D
from ..core import ff
from . import trace

DIGEST_BYTES = 32  # Blake2s-256


def sha256_compress(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(left + right).digest()


def identity_leaf(data: bytes) -> bytes:
    return data


def sha256_leaf(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def blake2s_hash(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = D.library("blake2s")
    lib.pc_blake2s_columns.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32),
                                       ctypes.c_void_p]
    lib.pc_blake2s_columns.restype = ctypes.c_int
    return lib


@trace.traced("Serialize::to_host", log=False)
def _digests_to_host(words: torch.Tensor) -> bytes:
    trace.count("host_syncs")
    return words.cpu().numpy().tobytes()


def _digest_words(spec, ext_mat: torch.Tensor) -> torch.Tensor:
    """``blake2s_columns``' checks and launch: (n_ext, 8) int32 digest
    words, little endian, on the device."""
    if spec.n_limbs != 16 or spec.serialized_size() != DIGEST_BYTES:
        raise ValueError(f"{spec.name}: the column hash takes 16-limb fields of 32-byte encoding")
    if ext_mat.dtype != torch.int32 or ext_mat.dim() != 3 or ext_mat.shape[2] != spec.n_limbs:
        raise ValueError(f"expected (n_rows, n_ext, 16) int32, got {tuple(ext_mat.shape)} "
                         f"{ext_mat.dtype}")
    D.require_cuda(ext_mat)
    mat = ext_mat.contiguous()
    if mat.data_ptr() % 16:
        raise ValueError("the column hash reads 16-byte aligned limbs")
    n_rows, n_ext = mat.shape[0], mat.shape[1]
    words = torch.empty((n_ext, DIGEST_BYTES // 4), dtype=torch.int32, device=mat.device)
    if n_ext == 0:
        return words
    rc = _lib().pc_blake2s_columns(mat.data_ptr(), words.data_ptr(), n_rows, n_ext,
                                   ff.kernel_consts(spec), D.stream_of(mat))
    if rc != 0:
        raise RuntimeError(f"blake2s columns kernel launch failed: CUDA error {rc}")
    blake2s_columns.launches += 1
    trace.count("blake2s_device_columns", n_ext)
    return words


def blake2s_columns(spec, ext_mat: torch.Tensor) -> List[bytes]:
    """The Blake2s-256 digest of each column of ``ext_mat``, (n_rows, n_ext,
    16) int32 Montgomery limbs below 2p on a CUDA device, in one kernel
    launch: digest c is ``blake2s_hash`` of the serialized canonical values
    of column c (``core.serialize.fields_to_bytes``). Takes fields of 16
    limbs that serialize to 32 bytes (BN254 Fr, BLS12-381 Fr); raises on any
    other spec, shape or device."""
    words = _digest_words(spec, ext_mat)
    if words.shape[0] == 0:
        return []
    raw = _digests_to_host(words)  # little-endian words: the digests' bytes
    return [raw[i:i + DIGEST_BYTES] for i in range(0, len(raw), DIGEST_BYTES)]


blake2s_columns.launches = 0


@dataclasses.dataclass(frozen=True)
class MerkleConfig:
    """leaf_hash: leaf bytes -> digest; compress: (l, r) -> parent digest."""

    leaf_hash: Callable[[bytes], bytes] = identity_leaf
    compress: Callable[[bytes, bytes], bytes] = sha256_compress


@dataclasses.dataclass
class MerklePath:
    leaf_index: int
    siblings: List[bytes]  # bottom-up sibling digests


class MerkleTree:
    """Perfect binary tree; leaves padded to a power of two with b''."""

    def __init__(self, leaves: List[bytes], config: MerkleConfig | None = None):
        self.config = config or MerkleConfig()
        n = max(1, len(leaves))
        size = 1 << (n - 1).bit_length()
        padded = list(leaves) + [b""] * (size - len(leaves))
        with trace.scope("Merkle::tree", log=False):
            level = [self.config.leaf_hash(leaf) for leaf in padded]
            self.levels = [level]
            while len(level) > 1:
                level = [self.config.compress(level[i], level[i + 1])
                         for i in range(0, len(level), 2)]
                self.levels.append(level)
            trace.count("hashed_bytes", 64 * (size - 1))

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def generate_proof(self, index: int) -> MerklePath:
        siblings = []
        i = index
        for level in self.levels[:-1]:
            siblings.append(level[i ^ 1])
            i >>= 1
        return MerklePath(leaf_index=index, siblings=siblings)


def verify_path(path: MerklePath, root: bytes, leaf: bytes,
                config: MerkleConfig | None = None) -> bool:
    config = config or MerkleConfig()
    node = config.leaf_hash(leaf)
    i = path.leaf_index
    for sib in path.siblings:
        node = config.compress(sib, node) if i & 1 else config.compress(node, sib)
        i >>= 1
    return node == root
