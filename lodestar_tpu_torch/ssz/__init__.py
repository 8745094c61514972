"""SSZ of the port (the JAX package's `lodestar_tpu/ssz/` names, from the
port's modules):

  core            the type objects (serialize, deserialize,
                  hash_tree_root), the zero hashes, merkleize_chunks, the
                  length mix-in
  hasher          hash_pairs: one tree level on the host (hashlib)
  merkle_tree     ChunkTree: the dirty-tracked per-level node planes
  device_backend  DeviceMerkleBackend: the tree's levels, dirty sweeps and
                  validator roots on the card's SHA-256 kernels
                  (kernels/sha256.py), behind the breaker
"""

from .core import (  # noqa: F401
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    SszType,
    UintN,
    Vector,
    hash_tree_root,
    is_valid_merkle_branch,
    merkleize_chunks,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from .merkle_tree import ChunkTree, hash_pairs_plane  # noqa: F401
