"""Merkle tree over byte leaves, on hashlib.

A copy of poly_commit_tpu/utils/merkle.py (ark-crypto-primitives'
MerkleTree/Path as the linear-code schemes use them,
linear_codes/mod.rs:506-521 and :443-451) without its native C++ batch
hasher: identity leaf hash, SHA-256 two-to-one compression and a Blake2s
column hash by default, the reference's test configuration. The roots are
the JAX package's, which hashes the same bytes with the same functions.
A tree build is the quiet span ``Merkle::tree`` and counts 64 bytes a
compression in ``hashed_bytes`` (utils/trace.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, List

from . import trace


def sha256_compress(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(left + right).digest()


def identity_leaf(data: bytes) -> bytes:
    return data


def sha256_leaf(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def blake2s_hash(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


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
