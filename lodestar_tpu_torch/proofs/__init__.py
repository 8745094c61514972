"""Proof-serving data plane of the port: the read surface over the
state-root engine.

  - `plane_reader`: single- and multi-leaf Merkle proofs as O(log n)
    plane reads with zero re-hashing, returning None when planes are
    not resident (callers fall through to the `container_branch` host
    path — a cold or evicted plane can never produce a wrong or
    missing proof).

The JAX package's proof bundle cache and proof service
(`lodestar_tpu/proofs/bundle_cache.py`, `service.py`) are not ported
yet: ROADMAP Queue A item 4.
"""

from .plane_reader import (
    pack_multiproof,
    state_multiproof,
    state_proof,
    verify_multiproof,
)

__all__ = [
    "pack_multiproof",
    "state_multiproof",
    "state_proof",
    "verify_multiproof",
]
