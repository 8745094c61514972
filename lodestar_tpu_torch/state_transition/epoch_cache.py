"""EpochCache — committee assignments + pubkey index maps for one epoch.

The port's copy of `lodestar_tpu/state_transition/epoch_cache.py`; it imports nothing of the
JAX package.

The TPU-era analog of the reference's EpochContext/EpochCache
(reference: packages/state-transition/src/cache/epochContext.ts; pubkey
maps at cache/pubkeyCache.ts:29-47): the O(V) structures that scale with
validator count.  Differences by design:

  - index2pubkey IS the device-resident PubkeyTable (bls/pubkey_table.py)
    — the cache holds wire pubkeys + the index map, the curve points
    live in HBM,
  - committee shufflings are whole-registry numpy permutations
    (state_transition/util.py shuffle_list), sliced per (slot, index)
    — one vectorized shuffle per epoch instead of per-index loops,
  - seeds are injected (tests/replay synthesize them; a full state
    implementation derives them from randao mixes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import params
from .util import (
    compute_committee_count_per_slot,
    compute_epoch_at_slot,
    shuffle_list,
)


class EpochCache:
    """Committees + pubkey maps for the epoch containing `epoch`."""

    def __init__(
        self,
        pubkeys: Sequence[bytes],
        epoch: int,
        seed: bytes,
        active_indices: Optional[np.ndarray] = None,
        sync_committee_indices: Optional[Sequence[int]] = None,
        shuffling: Optional[np.ndarray] = None,
    ):
        self.epoch = epoch
        self.seed = seed
        self.pubkeys: List[bytes] = [bytes(pk) for pk in pubkeys]
        self.pubkey2index: Dict[bytes, int] = {
            pk: i for i, pk in enumerate(self.pubkeys)
        }
        n = len(self.pubkeys)
        self.active_indices = (
            np.arange(n, dtype=np.int64)
            if active_indices is None
            else np.asarray(active_indices, np.int64)
        )
        self.committees_per_slot = compute_committee_count_per_slot(
            len(self.active_indices)
        )
        # One whole-registry shuffle for the epoch; committees are slices.
        # `shuffling` passes one already made (shuffle_list of these active
        # indices by this seed, e.g. a state's accessors.get_shuffling)
        self._shuffling = (
            shuffle_list(self.active_indices, seed)
            if shuffling is None
            else np.asarray(shuffling, np.int64)
        )
        # Sync committee membership (reference: epochCtx.currentSyncCommitteeIndexed)
        self.sync_committee_indices = (
            list(sync_committee_indices)
            if sync_committee_indices is not None
            else list(
                np.resize(self.active_indices, params.SYNC_COMMITTEE_SIZE)
            )
        )

    # -- committees (reference: epochContext getBeaconCommittee) -----------

    def get_beacon_committee(self, slot: int, index: int) -> np.ndarray:
        """Validator indices of committee `index` at `slot`."""
        assert compute_epoch_at_slot(slot) == self.epoch, "slot outside epoch"
        assert 0 <= index < self.committees_per_slot, "committee index OOB"
        slots_per_epoch = params.SLOTS_PER_EPOCH
        committees_per_epoch = self.committees_per_slot * slots_per_epoch
        committee_global = (
            (slot % slots_per_epoch) * self.committees_per_slot + index
        )
        n = len(self._shuffling)
        start = n * committee_global // committees_per_epoch
        end = n * (committee_global + 1) // committees_per_epoch
        return self._shuffling[start:end]

    def get_attesting_indices(
        self, slot: int, index: int, aggregation_bits: Sequence[bool]
    ) -> List[int]:
        committee = self.get_beacon_committee(slot, index)
        if len(aggregation_bits) != len(committee):
            raise ValueError("aggregation bits length != committee size")
        return [int(v) for v, b in zip(committee, aggregation_bits) if b]

    def get_indexed_attestation(self, attestation: dict) -> dict:
        """phase0.Attestation value -> IndexedAttestation value (sorted
        indices, spec get_indexed_attestation)."""
        data = attestation["data"]
        indices = self.get_attesting_indices(
            data["slot"], data["index"], attestation["aggregation_bits"]
        )
        return {
            "attesting_indices": sorted(indices),
            "data": data,
            "signature": attestation["signature"],
        }

    def get_sync_committee_participant_indices(
        self, sync_committee_bits: Sequence[bool]
    ) -> List[int]:
        return [
            int(self.sync_committee_indices[i])
            for i, b in enumerate(sync_committee_bits)
            if b
        ]
