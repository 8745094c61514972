"""Incremental chunked merkle tree, a copy of
`lodestar_tpu/ssz/merkle_tree.py` on the port's merkleization backend.

`ChunkTree` keeps one contiguous (nodes, 32) uint8 plane per level of the
spec's padded binary tree over 32-byte chunks, finds dirty chunks by
diffing the leaf plane, and re-hashes only the dirty paths, one batched
`hash_pairs_plane` call per level, so a slot that touches k of n chunks
costs O(k log n) hashes.  `limit_chunks` fixes the depth (next_pow2);
chunks beyond `count` are implicit zeros, folded in through the zero-hash
table, so roots are bit-identical to `merkleize_chunks`.

With the device backend (ssz/device_backend.py) a dirty batch of at most
`HTR_SWEEP_LANES` chunks hashes all its levels in one `forest_sweep`
launch (`_apply_device_sweep`), and every level of at least the backend's
`min_level_rows` pairs in one `hash_pairs` launch; the rest, and every
level while the backend's breaker is open, hash on the host.

`clone()` is O(levels): both trees share their planes copy-on-write.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .core import _ZERO_HASHES, _next_pow2, merkleize_chunks
from .hasher import hash_pairs

_U8 = np.uint8


def _ceil_div2(n: int) -> int:
    return (n + 1) >> 1


def _device():
    """The process merkleization backend (None: the host path).  Resolved
    per call: tests install and clear it explicitly."""
    from . import device_backend

    return device_backend.maybe_backend()


def hash_pairs_plane(pairs: np.ndarray) -> np.ndarray:
    """Batched sibling hashing over a (n, 64) uint8 plane -> (n, 32).

    The level-hash seam: with the device backend installed, levels at or
    above its row cutoff run the card's `hash_pairs` kernel; everything
    else, and every device fault, takes the host hash_pairs path, which
    is bit-identical by construction."""
    if pairs.size == 0:
        return np.zeros((0, 32), _U8)
    backend = _device()
    if backend is not None:
        rows = backend.hash_level(pairs)
        if rows is not None:
            return rows
    out = hash_pairs(pairs.tobytes())
    return np.frombuffer(out, _U8).reshape(-1, 32)


class ChunkTree:
    """Dirty-tracked merkle tree over a leaf plane of 32-byte chunks.

    `update(leaves)` takes the CURRENT full leaf plane, diffs it against
    the stored one to find dirty chunks (vectorized — the conservative
    dirty tracker: a chunk re-hashes iff its bytes changed), and
    re-hashes only the dirty paths.  `apply(idx, rows, count)` is the
    lower-level entry for callers that computed the dirty set
    themselves (the validators cell, whose leaves are themselves
    hashes).
    """

    def __init__(self, limit_chunks: int):
        if limit_chunks < 1:
            raise ValueError("limit_chunks must be >= 1")
        self.limit_chunks = limit_chunks
        self.depth = _next_pow2(limit_chunks).bit_length() - 1
        self.count = 0
        # levels[0] is the leaf plane; levels[k] has ceil(count / 2^k)
        # live rows (arrays are allocated with slack and never shrink)
        self._levels: List[np.ndarray] = [
            np.zeros((0, 32), _U8) for _ in range(self.depth + 1)
        ]
        self._shared = False

    # -- sharing -----------------------------------------------------------

    def clone(self) -> "ChunkTree":
        """O(levels) copy-on-write share of every node plane."""
        out = ChunkTree.__new__(ChunkTree)
        out.limit_chunks = self.limit_chunks
        out.depth = self.depth
        out.count = self.count
        out._levels = list(self._levels)
        out._shared = True
        self._shared = True
        return out

    def _own(self) -> None:
        if self._shared:
            self._levels = [lvl.copy() for lvl in self._levels]
            self._shared = False

    def plane_bytes(self, seen: Optional[set] = None) -> int:
        """Allocated node-plane bytes.  With `seen` (a set of array
        id()s threaded across trees), COW-shared planes are counted
        once — the regen-LRU-wide live-bytes metric."""
        total = 0
        for lvl in self._levels:
            if seen is not None:
                if id(lvl) in seen:
                    continue
                seen.add(id(lvl))
            total += lvl.nbytes
        return total

    def planes(self) -> List[np.ndarray]:
        """The live per-level node-plane arrays, leaf plane first.  The
        residency ledger (chain/memory_governor.py) enumerates these by
        id() for COW-aware byte accounting — the same identity space
        plane_bytes() dedupes on."""
        return list(self._levels)

    def release(self) -> None:
        """Free every node plane (tier-1 demotion).  The tree forgets
        its leaves, so the next update()/apply() rebuilds cold — one
        full merkleization, bit-identical roots (the same cold path a
        fresh tree pays)."""
        self.count = 0
        self._levels = [np.zeros((0, 32), _U8) for _ in range(self.depth + 1)]
        self._shared = False

    # -- geometry ----------------------------------------------------------

    def _rows_at(self, level: int) -> int:
        """Live node count at `level` for the current leaf count."""
        return (self.count + (1 << level) - 1) >> level

    def _ensure_capacity(self, level: int, rows: int) -> None:
        plane = self._levels[level]
        if plane.shape[0] >= rows:
            return
        cap = max(rows, plane.shape[0] * 2, 8)
        grown = np.zeros((cap, 32), _U8)
        if plane.shape[0]:
            grown[: plane.shape[0]] = plane
        self._levels[level] = grown

    # -- mutation ----------------------------------------------------------

    def update(self, leaves: np.ndarray) -> None:
        """Diff `leaves` ((n, 32) uint8) against the stored plane and
        re-hash dirty paths.  Handles growth (appended chunks dirty) and
        shrink (conservative: full rebuild — shrinks are rare: no state
        list on the hot path ever shrinks)."""
        n = leaves.shape[0]
        if n > self.limit_chunks:
            raise ValueError(f"chunk count {n} exceeds limit {self.limit_chunks}")
        old_n = self.count
        if n < old_n:
            self.reset(leaves)
            return
        m = old_n
        stored = self._levels[0]
        if m:
            diff = (leaves[:m] != stored[:m]).any(axis=1)
            dirty = np.nonzero(diff)[0]
        else:
            dirty = np.zeros(0, np.intp)
        if n > old_n:
            dirty = np.concatenate([dirty, np.arange(old_n, n, dtype=np.intp)])
        if dirty.size == 0 and n == old_n:
            return
        self.apply(dirty, leaves[dirty], n)

    def reset(self, leaves: np.ndarray) -> None:
        """Full rebuild from a fresh leaf plane."""
        self._shared = False  # planes are reallocated below; never copy
        self.count = 0
        self._levels = [np.zeros((0, 32), _U8) for _ in range(self.depth + 1)]
        if leaves.shape[0]:
            self.apply(
                np.arange(leaves.shape[0], dtype=np.intp), leaves, leaves.shape[0]
            )

    def apply(
        self, dirty_idx: np.ndarray, rows: np.ndarray, count: int
    ) -> None:
        """Scatter `rows` into the leaf plane at `dirty_idx`, set the
        live count, and re-hash every dirty path bottom-up, one batched
        `hash_pairs` call per level."""
        if count > self.limit_chunks:
            raise ValueError(
                f"chunk count {count} exceeds limit {self.limit_chunks}"
            )
        if count < self.count:
            # shrink invalidates parents over the vacated range too;
            # delegate to reset-from-scratch via the caller's full plane
            raise ValueError("apply() cannot shrink; use reset()/update()")
        self._own()
        self.count = count
        self._ensure_capacity(0, count)
        # rows align 1:1 with dirty_idx (any order); sort both together
        # and let the LAST write win on duplicates
        idx = np.asarray(dirty_idx, np.intp)
        if rows.shape[0] != idx.shape[0]:
            raise ValueError("rows must align with dirty_idx")
        if idx.size:
            order = np.argsort(idx, kind="stable")
            idx = idx[order]
            rows = rows[order]
            keep = np.ones(idx.shape[0], bool)
            keep[:-1] = idx[1:] != idx[:-1]
            idx = idx[keep]
            rows = rows[keep]
            self._levels[0][idx] = rows
        if idx.size and self._apply_device_sweep(idx):
            return
        for level in range(self.depth):
            if idx.size == 0:
                break
            live = self._rows_at(level)
            parents = np.unique(idx >> 1)
            li = parents << 1
            ri = li + 1
            pairs = np.empty((parents.shape[0], 64), _U8)
            plane = self._levels[level]
            pairs[:, :32] = plane[li]
            in_range = ri < live
            if in_range.any():
                pairs[in_range, 32:] = plane[ri[in_range]]
            if (~in_range).any():
                pairs[~in_range, 32:] = np.frombuffer(
                    _ZERO_HASHES[level], _U8
                )
            parent_rows = hash_pairs_plane(pairs)
            self._ensure_capacity(level + 1, _ceil_div2(live))
            self._levels[level + 1][parents] = parent_rows
            idx = parents

    def _apply_device_sweep(self, idx: np.ndarray) -> bool:
        """Hash every dirty path in ONE device dispatch (the forest
        sweep kernel).  Only taken when the dirty batch fits the sweep
        lane bucket — the per-slot shape; cold builds and bulk updates
        go through the per-level loop (whose hash_pairs_plane seam
        still uses the device at the big buckets).  Returns False for
        any reason the host loop should run instead; planes are only
        written on a fully successful sweep, so a mid-sweep device
        fault leaves the tree untouched for the host path."""
        backend = _device()
        if backend is None or self.depth == 0:
            return False
        from ..kernels.sha256 import HTR_SWEEP_LANES, pairs_to_blocks

        lanes = HTR_SWEEP_LANES
        if idx.size > lanes:
            return False
        k = self.depth
        pairs = np.zeros((k, lanes, 16), np.uint32)
        dst_lane = np.full((k, lanes), lanes, np.int32)
        dst_half = np.zeros((k, lanes), np.int32)
        level_parents: List[np.ndarray] = []
        cur = idx
        for level in range(k):
            live = self._rows_at(level)
            # growth: the stored plane may not cover freshly appended
            # nodes yet — grow it with zero rows.  Every never-computed
            # row a pair lane reads is, by construction, a dirty parent
            # of the previous level, so the kernel's on-device scatter
            # overwrites it before hashing.
            self._ensure_capacity(level, live)
            parents = np.unique(cur >> 1)
            if parents.size > lanes:
                return False
            li = parents << 1
            ri = li + 1
            plane = self._levels[level]
            pp = np.zeros((parents.size, 64), _U8)
            pp[:, :32] = plane[li]
            in_range = ri < live
            if in_range.any():
                pp[in_range, 32:] = plane[ri[in_range]]
            if (~in_range).any():
                pp[~in_range, 32:] = np.frombuffer(_ZERO_HASHES[level], _U8)
            pairs[level, : parents.size] = pairs_to_blocks(pp)
            level_parents.append(parents)
            cur = parents
        # level l's output digests (nodes at level l+1) overwrite the
        # stale halves in level l+1's pair plane ON DEVICE: lane =
        # position of the node's parent among that level's parents,
        # half = the node's sibling side
        for level in range(k - 1):
            src = level_parents[level]
            nxt = level_parents[level + 1]
            dst_lane[level, : src.size] = np.searchsorted(
                nxt, src >> 1
            ).astype(np.int32)
            dst_half[level, : src.size] = (src & 1).astype(np.int32)
        sizes = [p.size for p in level_parents]
        out = backend.sweep(pairs, dst_lane, dst_half, sizes)
        if out is None:
            return False
        for level, parents in enumerate(level_parents):
            self._ensure_capacity(
                level + 1, _ceil_div2(self._rows_at(level))
            )
            self._levels[level + 1][parents] = out[level]
        return True

    # -- root --------------------------------------------------------------

    @property
    def root(self) -> bytes:
        if self.count == 0:
            return _ZERO_HASHES[self.depth]
        return bytes(self._levels[self.depth][0])

    def leaf(self, index: int) -> bytes:
        if index >= self.count:
            return bytes(32)
        return bytes(self._levels[0][index])

    def branch(self, index: int) -> List[bytes]:
        """Sibling path for leaf `index`, bottom-up — O(depth) plane
        READS, zero hashing (the proof-serving read path,
        the JAX package's proofs/plane_reader.py).  Valid for any index inside the padded
        leaf space: siblings beyond the live count come from the
        zero-hash table, the same padding rule update() hashes under,
        so the path verifies against `self.root` even in the padding
        region."""
        if not (0 <= index < _next_pow2(self.limit_chunks)):
            raise IndexError(
                f"leaf index {index} outside padded leaf space "
                f"{_next_pow2(self.limit_chunks)}"
            )
        out: List[bytes] = []
        pos = index
        for level in range(self.depth):
            sib = pos ^ 1
            plane = self._levels[level]
            if sib < self._rows_at(level):
                out.append(bytes(plane[sib]))
            else:
                out.append(_ZERO_HASHES[level])
            pos >>= 1
        return out

    # -- reference check ---------------------------------------------------

    def full_root_reference(self, chunks: Optional[Sequence[bytes]] = None) -> bytes:
        """Recompute through merkleize_chunks — test oracle only."""
        if chunks is None:
            chunks = [bytes(self._levels[0][i]) for i in range(self.count)]
        return merkleize_chunks(chunks, self.limit_chunks)
