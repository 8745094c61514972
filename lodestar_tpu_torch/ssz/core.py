"""The merkleization helpers of SSZ that the port's tree needs, copied
from `lodestar_tpu/ssz/core.py`: the zero-subtree hashes, the padded
binary merkle root of a chunk list and the length mix-in.

The SSZ type system itself is not ported: the state-root engine hashes
its non-columnar fields through the field types the state hands it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .hasher import digest, hash_pairs

BYTES_PER_CHUNK = 32
ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK

# _ZERO_HASHES[d]: root of a depth-d subtree of zero chunks
_ZERO_HASHES: List[bytes] = [ZERO_CHUNK]
for _ in range(64):
    _ZERO_HASHES.append(digest(_ZERO_HASHES[-1] * 2))


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize_chunks(chunks: Sequence[bytes], limit: Optional[int] = None) -> bytes:
    """Binary merkle root of 32-byte chunks, zero-padded to limit leaves."""
    count = len(chunks)
    leaves = _next_pow2(limit if limit is not None else count)
    if limit is not None and count > limit:
        raise ValueError(f"chunk count {count} exceeds limit {limit}")
    if count == 0:
        return _ZERO_HASHES[leaves.bit_length() - 1]
    depth = leaves.bit_length() - 1
    level = b"".join(chunks)
    n = count
    for d in range(depth):
        if n % 2 == 1:
            level += _ZERO_HASHES[d]
            n += 1
        level = hash_pairs(level)
        n //= 2
        # the rest of this tree level is implicit zeros; parents of two
        # zeros come from the zero-hash table on the way up
    return level[:32] if n >= 1 else _ZERO_HASHES[depth]


def _mix_in_length(root: bytes, length: int) -> bytes:
    return digest(root + length.to_bytes(32, "little"))
