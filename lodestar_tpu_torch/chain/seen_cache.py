"""Seen caches — first-seen dedup + attestation-data reuse.

The port's copy of `lodestar_tpu/chain/seen_cache.py`; it imports nothing of the
JAX package.

Mirror of the reference's chain/seenCache family (reference:
packages/beacon-node/src/chain/seenCache/{seenAttesters,
seenAttestationData}.ts):

  - SeenAttesters / SeenAggregators: per-epoch "validator already
    attested" dedup keyed by (epoch, validator index),
  - SeenAttestationDatas: per-slot cache keyed by the serialized
    AttestationData bytes, storing the expensive derived values so the
    hot loop computes them once per distinct data — committee indices,
    the 32-byte signing root, and (TPU-specific) the hashed-to-curve G2
    message point, which prices at ~ms on the host and must be amortized
    across the ~committee-size attestations sharing the same data.
"""

from __future__ import annotations

from typing import Dict, Generic, Optional, Tuple, TypeVar

V = TypeVar("V")


class SeenAttesters:
    """(epoch, validator) dedup with pruning (reference: seenAttesters)."""

    def __init__(self, max_epochs: int = 2):
        self.max_epochs = max_epochs
        self._by_epoch: Dict[int, set] = {}

    def is_known(self, epoch: int, index: int) -> bool:
        return index in self._by_epoch.get(epoch, ())

    def add(self, epoch: int, index: int) -> None:
        self._by_epoch.setdefault(epoch, set()).add(index)

    def prune(self, current_epoch: int) -> None:
        for e in list(self._by_epoch):
            if e < current_epoch - self.max_epochs:
                del self._by_epoch[e]


SeenAggregators = SeenAttesters  # same structure, keyed per (epoch, aggregator)


class SlotWindowedSeen:
    """Generic slot-windowed first-seen dedup: (slot, *key) membership
    with per-slot pruning.  One structure serves block proposers, sync
    messages, and contributions (reference: the seenCache family's
    shared shape)."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self._by_slot: Dict[int, set] = {}

    def is_known(self, slot: int, *key) -> bool:
        return key in self._by_slot.get(slot, ())

    def add(self, slot: int, *key) -> None:
        self._by_slot.setdefault(slot, set()).add(key)

    def prune(self, current_slot: int) -> None:
        for s in list(self._by_slot):
            if s < current_slot - self.max_slots:
                del self._by_slot[s]


class SeenBlockProposers(SlotWindowedSeen):
    """(slot, proposer) — a proposer publishes once per slot
    (reference: seenCache/seenBlockProposers.ts)."""

    def __init__(self, max_slots: int = 64):
        super().__init__(max_slots)


class SeenSyncCommitteeMessages(SlotWindowedSeen):
    """(slot, subnet, validator) — one message per member per slot per
    subnet (reference: seenCache/seenCommittee.ts)."""

    def __init__(self, max_slots: int = 3):
        super().__init__(max_slots)


class SeenContributionAndProof(SlotWindowedSeen):
    """(slot, subnet, aggregator) (reference:
    seenCache/seenCommitteeContribution.ts)."""

    def __init__(self, max_slots: int = 3):
        super().__init__(max_slots)


class SeenAttestationDatas(Generic[V]):
    """Per-slot LRU-ish cache: serialized AttestationData -> derived V.

    The reference caps entries per slot and tracks hit/miss metrics
    (seenAttestationData.ts); on the TPU build V carries
    {signing_root, committee indices, hashed G2 message}.
    """

    def __init__(self, max_per_slot: int = 200, max_slots: int = 3):
        self.max_per_slot = max_per_slot
        self.max_slots = max_slots
        self._by_slot: Dict[int, Dict[bytes, V]] = {}
        self.hits = 0
        self.misses = 0
        self.rejected = 0

    def get(self, slot: int, data_key: bytes) -> Optional[V]:
        v = self._by_slot.get(slot, {}).get(data_key)
        if v is not None:
            self.hits += 1
        else:
            self.misses += 1
        return v

    def put(self, slot: int, data_key: bytes, value: V) -> bool:
        per_slot = self._by_slot.setdefault(slot, {})
        if len(per_slot) >= self.max_per_slot:
            self.rejected += 1
            return False
        per_slot[data_key] = value
        return True

    def prune(self, current_slot: int) -> None:
        for s in list(self._by_slot):
            if s < current_slot - self.max_slots:
                del self._by_slot[s]
