"""Slot/epoch math + the swap-or-not shuffle, vectorized.

The port's copy of `lodestar_tpu/state_transition/util.py`; it imports nothing of the
JAX package.

Reference: packages/state-transition/src/util/{epoch,shuffle}.ts.  The
reference shuffles the whole index list in one pass per round (the
"unshuffle list" optimization); here the same algorithm is expressed as
numpy array ops — one sha256 per 256-position block per round plus
vectorized bit selection, so a 1M-validator registry shuffles in
~SHUFFLE_ROUND_COUNT * (N/256) hashes instead of N * rounds of hashes.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import params


def compute_epoch_at_slot(slot: int) -> int:
    return slot // params.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(epoch: int) -> int:
    return epoch * params.SLOTS_PER_EPOCH


def compute_activation_exit_epoch(epoch: int) -> int:
    return epoch + 1 + params.ACTIVE_PRESET.MAX_SEED_LOOKAHEAD


def compute_committee_count_per_slot(active_validator_count: int) -> int:
    p = params.ACTIVE_PRESET
    return max(
        1,
        min(
            p.MAX_COMMITTEES_PER_SLOT,
            active_validator_count
            // p.SLOTS_PER_EPOCH
            // p.TARGET_COMMITTEE_SIZE,
        ),
    )


def compute_shuffled_index(index: int, index_count: int, seed: bytes) -> int:
    """Spec compute_shuffled_index — scalar reference used by tests; the
    list-at-once `shuffled_positions` below must agree with it."""
    assert 0 <= index < index_count
    for r in range(params.SHUFFLE_ROUND_COUNT):
        pivot = (
            int.from_bytes(hashlib.sha256(seed + bytes([r])).digest()[:8], "little")
            % index_count
        )
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = hashlib.sha256(
            seed + bytes([r]) + (position // 256).to_bytes(4, "little")
        ).digest()
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def _round_hashes(seed: bytes, round_idx: int, n_blocks: int) -> np.ndarray:
    """Source bytes for every 256-position block of one shuffle round."""
    base = seed + bytes([round_idx])
    out = np.empty((n_blocks, 32), np.uint8)
    for b in range(n_blocks):
        out[b] = np.frombuffer(
            hashlib.sha256(base + b.to_bytes(4, "little")).digest(), np.uint8
        )
    return out


def shuffled_positions(n: int, seed: bytes) -> np.ndarray:
    """Vectorized compute_shuffled_index for every position 0..n-1."""
    pos = np.arange(n, dtype=np.int64)
    if n <= 1:
        return pos
    n_blocks = (n + 255) // 256 + 1
    for r in range(params.SHUFFLE_ROUND_COUNT):
        pivot = (
            int.from_bytes(hashlib.sha256(seed + bytes([r])).digest()[:8], "little")
            % n
        )
        flip = (pivot - pos) % n
        max_pos = np.maximum(pos, flip)
        hashes = _round_hashes(seed, r, n_blocks)
        byte = hashes[max_pos // 256, (max_pos % 256) // 8]
        bit = (byte >> (max_pos % 8).astype(np.uint8)) & 1
        pos = np.where(bit == 1, flip, pos)
    return pos


def shuffle_list(indices: np.ndarray, seed: bytes) -> np.ndarray:
    """The spec's shuffled committee order:
    out[j] == indices[compute_shuffled_index(j, n, seed)]."""
    idx = np.asarray(indices)
    if len(idx) <= 1:
        return idx.copy()
    return idx[shuffled_positions(len(idx), seed)]


def unshuffle_list(shuffled: np.ndarray, seed: bytes) -> np.ndarray:
    """Inverse of shuffle_list (scatter through the same permutation)."""
    s = np.asarray(shuffled)
    if len(s) <= 1:
        return s.copy()
    pos = shuffled_positions(len(s), seed)
    out = np.empty_like(s)
    out[pos] = s
    return out
