"""Merkleization of the port (the JAX package's `lodestar_tpu/ssz/`
names, from the port's modules):

  core            the zero hashes, merkleize_chunks, the length mix-in
  hasher          hash_pairs: one tree level on the host (hashlib)
  merkle_tree     ChunkTree: the dirty-tracked per-level node planes
  device_backend  DeviceMerkleBackend: the tree's levels, dirty sweeps and
                  validator roots on the card's SHA-256 kernels
                  (kernels/sha256.py), behind the breaker
"""

from .core import merkleize_chunks  # noqa: F401
from .merkle_tree import ChunkTree, hash_pairs_plane  # noqa: F401
