"""Batched SHA-256 for merkleization on the host, a copy of
`lodestar_tpu/ssz/hasher.py` without its native library (which this
repository does not build): `hash_pairs` hashes one whole tree level of
64-byte sibling pairs in one call, with hashlib.

It is the ground truth of the device kernels (`kernels/sha256.py`) and
the path every level takes that the device backend declines or that
falls back while its breaker is open.
"""

from __future__ import annotations

import hashlib


def hash_pairs(data: bytes) -> bytes:
    """Hash consecutive 64-byte blocks: one tree level in one call.

    data: concatenation of n sibling pairs (64 bytes each).
    Returns the n concatenated 32-byte parent nodes.
    """
    n = len(data) // 64
    assert len(data) == 64 * n
    sha = hashlib.sha256
    mv = memoryview(data)  # slices borrow the buffer, no copy per pair
    return b"".join(sha(mv[i * 64 : i * 64 + 64]).digest() for i in range(n))


def digest(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
