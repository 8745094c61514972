"""State caches — by state root and by checkpoint.

The port's copy of `lodestar_tpu/chain/state_cache.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/stateCache/stateContextCache.ts
(root-keyed LRU, MAX_STATES = 3 * 32) and
stateContextCheckpointsCache.ts (checkpoint-keyed, epoch-pruned,
MAX_EPOCHS = 10).  States here are the columnar BeaconState
(state_transition/state.py); entries are the live objects — callers
clone before mutating, which is what stateTransition() does anyway.

With a StateMemoryGovernor attached (chain/memory_governor.py,
default-on), the count-based bounds are REPLACED by its byte budget:
adds and drops update the governor's residency ledger incrementally,
over-budget adds trigger eviction waves, and a `get` of a
tier-1-demoted entry (a SpilledState marker holding the serialized SSZ
bytes) lazily rehydrates the live state.  Without a governor
(`LODESTAR_TPU_STATE_BUDGET=0`) behavior is byte-identical to the
pre-governor LRU/epoch bounds.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .memory_governor import SpilledState


class StateContextCache:
    """stateRoot(hex) -> BeaconState, LRU-bounded (or byte-governed)."""

    MAX_STATES = 3 * 32  # reference: stateContextCache.ts

    def __init__(self, max_states: int = MAX_STATES, governor=None):
        self.max_states = max_states
        self.governor = governor
        self._map: "OrderedDict[str, object]" = OrderedDict()

    def get(self, state_root: str) -> Optional[object]:
        st = self._map.get(state_root)
        if st is None:
            return None
        if self.governor is not None:
            # a spilled entry rehydrates on touch (tier-1 demotion's
            # lazy half); live entries pass through untouched.  The
            # rehydration path re-enforces the budget, which may evict
            # THIS entry again under extreme budgets — the caller still
            # gets the live object, but the LRU touch must not assume
            # the key survived.
            st = self.governor.on_state_get(state_root, st)
            if state_root in self._map:
                self._map.move_to_end(state_root)
            return st
        self._map.move_to_end(state_root)
        return st

    def add(self, state) -> None:
        self.add_with_root(state.hash_tree_root().hex(), state)

    def add_with_root(self, state_root: str, state) -> None:
        """Add under a known root (skips re-hashing the state)."""
        if state_root in self._map:
            existing = self._map[state_root]
            if isinstance(existing, SpilledState):
                # a re-import of a demoted state promotes it back live
                self._map[state_root] = state
                if self.governor is not None:
                    self.governor.on_state_add(state_root, state)
            self._map.move_to_end(state_root)
            return
        self._map[state_root] = state
        if self.governor is not None:
            # the byte budget replaces the count bound
            self.governor.on_state_add(state_root, state)
            return
        while len(self._map) > self.max_states:
            self._map.popitem(last=False)

    def delete(self, state_root: str) -> None:
        entry = self._map.pop(state_root, None)
        if entry is not None and self.governor is not None:
            self.governor.on_state_drop(state_root, entry)

    def batch_delete(self, roots: List[str]) -> None:
        for r in roots:
            self.delete(r)

    def prune(self, head_state_root: str) -> None:
        """Drop everything but the head state (reference prune keeps the
        head entry hot after a finalization sweep)."""
        keep = self._map.get(head_state_root)
        if self.governor is not None:
            for root in list(self._map.keys()):
                if root != head_state_root:
                    self.governor.on_state_drop(root, self._map[root])
        self._map.clear()
        if keep is not None:
            self._map[head_state_root] = keep

    def clear(self) -> None:
        if self.governor is not None:
            for root, entry in self._map.items():
                self.governor.on_state_drop(root, entry)
        self._map.clear()

    def states(self):
        """Live cached states (no LRU touch; spilled markers included —
        they carry no engine, so byte walks see them as zero)."""
        return self._map.values()

    def __len__(self) -> int:
        return len(self._map)

    @property
    def size(self) -> int:
        return len(self._map)


class CheckpointStateCache:
    """(epoch, blockRoot hex) -> BeaconState at the epoch boundary.

    Serves attestation/justification target states (reference:
    stateContextCheckpointsCache.ts)."""

    MAX_EPOCHS = 10

    def __init__(self, max_epochs: int = MAX_EPOCHS, governor=None):
        self.max_epochs = max_epochs
        self.governor = governor
        self._map: Dict[Tuple[int, str], object] = {}
        self._epochs: List[int] = []

    @staticmethod
    def _key(checkpoint: dict) -> Tuple[int, str]:
        root = checkpoint["root"]
        root_hex = root.hex() if isinstance(root, bytes) else str(root)
        return (int(checkpoint["epoch"]), root_hex)

    def get(self, checkpoint: dict) -> Optional[object]:
        key = self._key(checkpoint)
        entry = self._map.get(key)
        if entry is None:
            return None
        if self.governor is not None:
            entry = self.governor.on_checkpoint_get(key, entry)
        return entry

    def add(self, checkpoint: dict, state) -> None:
        key = self._key(checkpoint)
        if key in self._map:
            if isinstance(self._map[key], SpilledState):
                self._map[key] = state
                if self.governor is not None:
                    self.governor.on_checkpoint_add(key, state)
            return
        self._map[key] = state
        if key[0] not in self._epochs:
            self._epochs.append(key[0])
            self._epochs.sort()
        if self.governor is not None:
            self.governor.on_checkpoint_add(key, state)
            # oldest-first, stepping OVER epochs whose pinned entries
            # survive (a pinned epoch occupies a window slot but must
            # never block pruning the unpinned epochs behind it)
            for epoch in sorted(self._epochs):
                if len(self._epochs) <= self.max_epochs:
                    break
                self.prune_epoch(epoch)
            return
        while len(self._epochs) > self.max_epochs:
            self.prune_epoch(self._epochs[0])

    def get_latest(self, block_root_hex: str, max_epoch: int):
        """Most recent cached state for this root at epoch <= max_epoch."""
        best_key = None
        best_epoch = -1
        for (epoch, root) in self._map:
            if root == block_root_hex and best_epoch < epoch <= max_epoch:
                best_key, best_epoch = (epoch, root), epoch
        if best_key is None:
            return None
        entry = self._map[best_key]
        if self.governor is not None:
            entry = self.governor.on_checkpoint_get(best_key, entry)
        return entry

    def prune_epoch(self, epoch: int) -> int:
        """Drop the epoch's entries; with a governor attached, PINNED
        entries (justified/finalized/head checkpoints) survive — the
        count-based window must not bypass the pinned-set guarantee.
        Returns the number of survivors (0 = the epoch is gone)."""
        survivors = 0
        cp_pinned = (
            self.governor.checkpoint_pin_predicate()
            if self.governor is not None
            else None
        )
        for key in [k for k in self._map if k[0] == epoch]:
            if cp_pinned is not None and cp_pinned(key[0], key[1]):
                survivors += 1
                continue
            entry = self._map.pop(key)
            if self.governor is not None:
                self.governor.on_checkpoint_drop(key, entry)
        if survivors == 0 and epoch in self._epochs:
            self._epochs.remove(epoch)
        return survivors

    def prune_finalized(self, finalized_epoch: int) -> None:
        for e in [e for e in self._epochs if e < finalized_epoch]:
            self.prune_epoch(e)

    def states(self):
        """Live cached states."""
        return self._map.values()

    def __len__(self) -> int:
        return len(self._map)
