"""PrepareNextSlotScheduler + BeaconProposerCache.

The port's copy of `lodestar_tpu/chain/prepare_next_slot.py`; it imports nothing of the
JAX package.

Mirror of the reference's next-slot preparation (reference:
packages/beacon-node/src/chain/prepareNextSlot.ts and
beaconProposerCache.ts): late in each slot the node

  1. precomputes the NEXT slot's state when it crosses an epoch
     boundary — the expensive epoch transition runs once here and lands
     in the checkpoint cache, so attestation validation and block
     production at slot 0 of the new epoch are cache hits, and
  2. if a LOCAL proposer (registered via prepare_beacon_proposer) owns
     the next slot on a post-merge chain, fires
     engine_forkchoiceUpdated WITH payload attributes so the EL starts
     building the payload a slot early.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .. import params
from ..utils.logger import get_logger

P = params.ACTIVE_PRESET

# registrations expire after this many epochs without renewal
# (reference: beaconProposerCache.ts MAX_CACHED_EPOCHS)
PROPOSER_PRESERVE_EPOCHS = 2


class BeaconProposerCache:
    """validator index -> (fee recipient, last-registered epoch)."""

    def __init__(self):
        self._entries: Dict[int, tuple] = {}

    def add(self, epoch: int, proposer_index: int, fee_recipient: bytes):
        self._entries[int(proposer_index)] = (bytes(fee_recipient), epoch)

    def get(self, proposer_index: int) -> Optional[bytes]:
        entry = self._entries.get(int(proposer_index))
        return entry[0] if entry else None

    def prune(self, epoch: int) -> None:
        for idx in [
            i
            for i, (_fr, ep) in self._entries.items()
            if ep < epoch - PROPOSER_PRESERVE_EPOCHS
        ]:
            del self._entries[idx]

    def __len__(self) -> int:
        return len(self._entries)


class PrepareNextSlotScheduler:
    """Preparation fires on HEAD updates (the slot's block just landed —
    the moment the reference's 2/3-slot timer targets) with a slot-tick
    fallback for empty slots.  Wire `on_head` to the chain emitter's
    head event and `on_slot` to the node clock."""

    def __init__(self, chain, proposer_cache: Optional[BeaconProposerCache] = None):
        self.chain = chain
        # `or` would discard an injected EMPTY cache (len 0 is falsy)
        self.proposer_cache = (
            proposer_cache if proposer_cache is not None else BeaconProposerCache()
        )
        self.log = get_logger("chain/prepare_next_slot")
        self.prepared_epochs = 0
        self.payloads_prepared = 0
        self.precomputes_skipped = 0
        self._last_prepared_slot = -1

    def on_head(self, _head_root: bytes, block_slot: int) -> None:
        """The slot's block imported: prepare for the NEXT slot on the
        now-current head (the common case, perfectly timed)."""
        self._prepare(int(block_slot) + 1)

    def on_slot(self, clock_slot: int) -> None:
        """Fallback for slots on_head never prepared: empty previous
        slot, or the first tick after a (re)start.  The at-most-once
        ledger (_last_prepared_slot) prevents double work on the normal
        path where on_head already prepared this slot."""
        if self._last_prepared_slot < clock_slot:
            self._prepare(clock_slot)
        self.proposer_cache.prune(clock_slot // P.SLOTS_PER_EPOCH)

    def _prepare(self, next_slot: int) -> None:
        # records but never dedups here: a same-slot re-fire means the
        # head CHANGED (reorg) and the prep must re-run on the new head
        self._last_prepared_slot = max(self._last_prepared_slot, next_slot)
        # degradation-ladder rung 2: the precompute is
        # ADVISORY latency work that adds a full state to the caches —
        # under sustained memory pressure the governor says skip it
        # (the epoch transition then runs on demand, which is slower
        # but does not fight the eviction waves)
        governor = getattr(self.chain, "memory_governor", None)
        if governor is not None and governor.skip_precompute():
            self.precomputes_skipped += 1
            self.log.warn(
                "next-slot precompute skipped (memory pressure)",
                slot=next_slot,
            )
            return
        try:
            advanced = self._advanced_state(next_slot)
            self._prepare_payload(next_slot, advanced)
        except Exception as e:  # noqa: BLE001 — preparation is advisory
            self.log.debug("next-slot prep skipped", error=str(e))

    # -- 1. head state advanced to next_slot (cached at boundaries) --------

    def _advanced_state(self, next_slot: int):
        regen = self.chain.regen
        head_root = self.chain.get_head_root()
        boundary = next_slot % P.SLOTS_PER_EPOCH == 0
        if boundary:
            # the expensive path the scheduler exists for: run the epoch
            # transition once, land it in the checkpoint cache
            checkpoint = {
                "epoch": next_slot // P.SLOTS_PER_EPOCH,
                "root": head_root,
            }
            cached = regen.checkpoint_cache.get(checkpoint)
            if cached is not None:
                return cached
            state = regen.get_block_slot_state(head_root.hex(), next_slot)
            regen.checkpoint_cache.add(checkpoint, state)
            self.prepared_epochs += 1
            self.log.debug(
                "precomputed epoch state", epoch=checkpoint["epoch"]
            )
            return state
        return regen.get_block_slot_state(head_root.hex(), next_slot)

    # -- 2. payload preparation (reference: prepareNextSlot.ts fcU leg) ----

    def _prepare_payload(self, next_slot: int, advanced) -> None:
        """Attributes come from the ADVANCED state — produce_block
        computes prev_randao/withdrawals the same way, so the EL's
        pre-built payload matches the eventual proposal."""
        chain = self.chain
        if chain.execution is None:
            return
        head_hash, fin_hash = chain.execution_head_hashes()
        if head_hash is None:
            return  # pre-merge head: nothing to build on
        epoch = next_slot // P.SLOTS_PER_EPOCH
        duties = chain.get_proposer_duties(epoch)
        start = epoch * P.SLOTS_PER_EPOCH
        proposer = int(duties[next_slot - start]["validator_index"])
        fee_recipient = self.proposer_cache.get(proposer)
        if fee_recipient is None:
            return  # not one of ours
        from .produce_block import build_payload_attributes

        chain.execution.notify_forkchoice_update(
            head_hash,
            head_hash,
            fin_hash,
            # the ONE shared builder — proposal-time _fetch_payload uses
            # it too, so the EL recognizes and serves the pre-built
            # payload instead of starting over
            build_payload_attributes(advanced, next_slot, fee_recipient),
        )
        self.payloads_prepared += 1
        self.log.debug(
            "payload preparation fired", slot=next_slot, proposer=proposer
        )
