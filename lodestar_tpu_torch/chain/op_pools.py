"""Operation pools — attestations, slashings, exits, sync contributions.

The port's copy of `lodestar_tpu/chain/op_pools.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/opPools/
  - attestationPool.ts          (unaggregated gossip atts, per data-root
                                 naive aggregation, 2-slot retention)
  - aggregatedAttestationPool.ts (aggregates for block inclusion,
                                  participation-ranked selection)
  - opPool.ts                   (proposer/attester slashings, exits —
                                 keyed to dedupe per offender)
  - syncCommitteeMessagePool.ts / syncContributionAndProofPool.ts
                                 (per-subnet aggregation → block
                                  SyncAggregate)

Aggregation here is real BLS point addition over the CPU oracle curve
ops (crypto/curves.py) — the pools hold compressed wire bytes and
aggregate incrementally on insert, the reference's "naive aggregation
by data root" strategy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import params
from ..crypto import bls as B
from ..crypto import curves as C
from ..types import AttestationData
from ..state_transition.accessors import get_block_root_at_slot
from ..state_transition.util import compute_epoch_at_slot

P = params.ACTIVE_PRESET

SLOTS_RETAINED = 2  # attestationPool.ts retention
MAX_AGGREGATES_PER_DATA = 8


def _or_bits(a: List[bool], b: List[bool]) -> List[bool]:
    return [x or y for x, y in zip(a, b)]


def _bits_overlap(a: List[bool], b: List[bool]) -> bool:
    return any(x and y for x, y in zip(a, b))


def _agg_sigs(sig_a: bytes, sig_b: bytes) -> bytes:
    pa, pb = C.g2_decompress(sig_a), C.g2_decompress(sig_b)
    return C.g2_compress(B.aggregate_signatures([pa, pb]))


def attester_slashing_intersection(slashing: dict) -> List[int]:
    """THE offender set of an AttesterSlashing (spec: indices attesting
    in both conflicting attestations) — shared by pool keying, fork-
    choice equivocation zeroing, and the slasher's emission path."""
    return sorted(
        set(int(i) for i in slashing["attestation_1"]["attesting_indices"])
        & set(int(i) for i in slashing["attestation_2"]["attesting_indices"])
    )


class AttestationPool:
    """Unaggregated single-bit attestations, aggregated per data root
    (the aggregator duty's source — reference attestationPool.ts)."""

    def __init__(self):
        # slot -> data_root -> aggregate attestation value
        self._by_slot: Dict[int, Dict[bytes, dict]] = {}

    def add(self, attestation: dict) -> str:
        slot = attestation["data"]["slot"]
        data_root = AttestationData.hash_tree_root(attestation["data"])
        by_root = self._by_slot.setdefault(slot, {})
        agg = by_root.get(data_root)
        if agg is None:
            by_root[data_root] = {
                "aggregation_bits": list(attestation["aggregation_bits"]),
                "data": dict(attestation["data"]),
                "signature": attestation["signature"],
            }
            return "added"
        if _bits_overlap(agg["aggregation_bits"], attestation["aggregation_bits"]):
            return "already_known"
        agg["aggregation_bits"] = _or_bits(
            agg["aggregation_bits"], attestation["aggregation_bits"]
        )
        agg["signature"] = _agg_sigs(
            agg["signature"], attestation["signature"]
        )
        return "aggregated"

    def get_aggregate(self, slot: int, data_root: bytes) -> Optional[dict]:
        return self._by_slot.get(slot, {}).get(data_root)

    def prune(self, clock_slot: int) -> None:
        for slot in [s for s in self._by_slot if s < clock_slot - SLOTS_RETAINED]:
            del self._by_slot[slot]

    def size(self) -> int:
        return sum(len(v) for v in self._by_slot.values())


class AggregatedAttestationPool:
    """Aggregates awaiting block inclusion, ranked by new participation
    (reference aggregatedAttestationPool.ts getAttestationsForBlock)."""

    def __init__(self):
        # slot -> data_root -> list of non-overlapping aggregates
        self._by_slot: Dict[int, Dict[bytes, List[dict]]] = {}

    def add(self, attestation: dict) -> str:
        slot = attestation["data"]["slot"]
        data_root = AttestationData.hash_tree_root(attestation["data"])
        lst = self._by_slot.setdefault(slot, {}).setdefault(data_root, [])
        bits = list(attestation["aggregation_bits"])
        for existing in lst:
            eb = existing["aggregation_bits"]
            if all(not b or e for b, e in zip(bits, eb)):
                return "already_known"  # subset of an existing aggregate
            if not _bits_overlap(eb, bits):
                existing["aggregation_bits"] = _or_bits(eb, bits)
                existing["signature"] = _agg_sigs(
                    existing["signature"], attestation["signature"]
                )
                return "aggregated"
        if len(lst) >= MAX_AGGREGATES_PER_DATA:
            lst.sort(key=lambda a: sum(a["aggregation_bits"]), reverse=True)
            lst.pop()
        lst.append(
            {
                "aggregation_bits": bits,
                "data": dict(attestation["data"]),
                "signature": attestation["signature"],
            }
        )
        return "added"

    def get_attestations_for_block(self, state) -> List[dict]:
        """Valid-for-inclusion aggregates, best participation first."""
        current_epoch = compute_epoch_at_slot(state.slot)
        previous_epoch = max(current_epoch - 1, 0)
        out: List[Tuple[int, dict]] = []
        for slot, by_root in self._by_slot.items():
            if slot + P.MIN_ATTESTATION_INCLUSION_DELAY > state.slot:
                continue
            if state.slot > slot + P.SLOTS_PER_EPOCH:
                continue
            for aggs in by_root.values():
                for att in aggs:
                    epoch = att["data"]["target"]["epoch"]
                    if epoch not in (previous_epoch, current_epoch):
                        continue
                    # source must match the justified checkpoint the
                    # state will check at inclusion
                    jc = (
                        state.current_justified_checkpoint
                        if epoch == current_epoch
                        else state.previous_justified_checkpoint
                    )
                    if (
                        att["data"]["source"]["epoch"] != jc["epoch"]
                        or att["data"]["source"]["root"] != jc["root"]
                    ):
                        continue
                    out.append((sum(att["aggregation_bits"]), att))
        out.sort(key=lambda t: t[0], reverse=True)
        return [att for _, att in out[: P.MAX_ATTESTATIONS]]

    def prune(self, clock_slot: int) -> None:
        # aggregates stay includable for a full epoch
        for slot in [
            s for s in self._by_slot if s + P.SLOTS_PER_EPOCH < clock_slot
        ]:
            del self._by_slot[slot]

    def size(self) -> int:
        return sum(
            len(aggs)
            for by_root in self._by_slot.values()
            for aggs in by_root.values()
        )


class OpPool:
    """Slashings + exits, deduped per offender (reference opPool.ts)."""

    def __init__(self):
        self._proposer_slashings: Dict[int, dict] = {}
        self._attester_slashings: Dict[Tuple[int, ...], dict] = {}
        self._voluntary_exits: Dict[int, dict] = {}
        self._bls_to_execution_changes: Dict[int, dict] = {}

    def insert_bls_to_execution_change(self, signed_change: dict) -> None:
        self._bls_to_execution_changes.setdefault(
            signed_change["message"]["validator_index"], signed_change
        )

    def get_bls_to_execution_changes(self, state):
        """Changes still applicable: the validator's credentials must
        still carry the 0x00 BLS prefix."""
        return [
            c
            for idx, c in self._bls_to_execution_changes.items()
            if idx < state.num_validators
            and bytes(state.withdrawal_credentials[idx][:1])
            == params.BLS_WITHDRAWAL_PREFIX
        ][: P.MAX_BLS_TO_EXECUTION_CHANGES]

    def insert_proposer_slashing(self, slashing: dict) -> bool:
        index = slashing["signed_header_1"]["message"]["proposer_index"]
        if index in self._proposer_slashings:
            return False
        self._proposer_slashings[index] = slashing
        return True

    def insert_attester_slashing(self, slashing: dict) -> bool:
        """Keyed by offender intersection, deduped PER OFFENDER
        (reference opPool.ts keys per intersecting index): a slashing
        whose offenders are all already covered by pooled entries is a
        no-op, so the slasher can re-submit detections freely without
        growing the pool."""
        key = tuple(attester_slashing_intersection(slashing))
        if not key:
            return False
        if set(key) <= self.covered_attester_offenders():
            return False  # every offender already has a pooled slashing
        self._attester_slashings[key] = slashing
        return True

    def covered_attester_offenders(self) -> set:
        """Offenders with a pooled attester slashing (the dedupe set —
        also read by the slasher's emission path)."""
        covered: set = set()
        for k in self._attester_slashings:
            covered.update(k)
        return covered

    def num_attester_slashings(self) -> int:
        return len(self._attester_slashings)

    def num_proposer_slashings(self) -> int:
        return len(self._proposer_slashings)

    def insert_voluntary_exit(self, signed_exit: dict) -> None:
        self._voluntary_exits.setdefault(
            signed_exit["message"]["validator_index"], signed_exit
        )

    def get_slashings_and_exits(self, state):
        """Ops still applicable against `state`, respecting per-block caps
        (reference opPool.ts getSlashingsAndExits)."""
        import numpy as np

        epoch = compute_epoch_at_slot(state.slot)
        slashable = (
            (~state.slashed)
            & (state.activation_epoch <= epoch)
            & (epoch < state.withdrawable_epoch)
        )
        proposer = [
            s
            for idx, s in self._proposer_slashings.items()
            if idx < state.num_validators and bool(slashable[idx])
        ][: P.MAX_PROPOSER_SLASHINGS]
        attester = [
            s
            for key, s in self._attester_slashings.items()
            if any(
                i < state.num_validators and bool(slashable[i]) for i in key
            )
        ][: P.MAX_ATTESTER_SLASHINGS]
        exits = [
            e
            for idx, e in self._voluntary_exits.items()
            if idx < state.num_validators
            and int(state.exit_epoch[idx]) == params.FAR_FUTURE_EPOCH
            and bool(slashable[idx])
            # the remaining process_voluntary_exit preconditions: a
            # selected-but-inapplicable exit would fail the whole block
            and epoch >= e["message"]["epoch"]
            and epoch
            >= int(state.activation_epoch[idx])
            + state.config.SHARD_COMMITTEE_PERIOD
        ][: P.MAX_VOLUNTARY_EXITS]
        return proposer, attester, exits

    def prune_all(self, finalized_state) -> None:
        """Drop ops no longer applicable after finalization."""
        import numpy as np

        for idx in [
            i
            for i in self._proposer_slashings
            if i < finalized_state.num_validators
            and bool(finalized_state.slashed[i])
        ]:
            del self._proposer_slashings[idx]
        for key in [
            k
            for k in self._attester_slashings
            if all(
                i < finalized_state.num_validators
                and bool(finalized_state.slashed[i])
                for i in k
            )
        ]:
            del self._attester_slashings[key]
        for idx in [
            i
            for i in self._voluntary_exits
            if i < finalized_state.num_validators
            and int(finalized_state.exit_epoch[i]) != params.FAR_FUTURE_EPOCH
        ]:
            del self._voluntary_exits[idx]
        for idx in [
            i
            for i in self._bls_to_execution_changes
            if i < finalized_state.num_validators
            and bytes(finalized_state.withdrawal_credentials[i][:1])
            != params.BLS_WITHDRAWAL_PREFIX
        ]:
            del self._bls_to_execution_changes[idx]


class SyncCommitteeMessagePool:
    """Per-subnet sync messages → contributions (reference
    syncCommitteeMessagePool.ts)."""

    def __init__(self):
        # (slot, root, subnet) -> {bits, signature}
        self._map: Dict[Tuple[int, bytes, int], dict] = {}
        self.subnet_size = P.SYNC_COMMITTEE_SIZE // params.SYNC_COMMITTEE_SUBNET_COUNT

    def add(self, subnet: int, message: dict, index_in_subnet: int) -> str:
        key = (message["slot"], message["beacon_block_root"], subnet)
        entry = self._map.get(key)
        if entry is None:
            bits = [False] * self.subnet_size
            bits[index_in_subnet] = True
            self._map[key] = {
                "bits": bits,
                "signature": message["signature"],
            }
            return "added"
        if entry["bits"][index_in_subnet]:
            return "already_known"
        entry["bits"][index_in_subnet] = True
        entry["signature"] = _agg_sigs(
            entry["signature"], message["signature"]
        )
        return "aggregated"

    def get_contribution(
        self, slot: int, beacon_block_root: bytes, subnet: int
    ) -> Optional[dict]:
        entry = self._map.get((slot, beacon_block_root, subnet))
        if entry is None:
            return None
        return {
            "slot": slot,
            "beacon_block_root": beacon_block_root,
            "subcommittee_index": subnet,
            "aggregation_bits": list(entry["bits"]),
            "signature": entry["signature"],
        }

    def prune(self, clock_slot: int) -> None:
        for key in [k for k in self._map if k[0] < clock_slot - SLOTS_RETAINED]:
            del self._map[key]


class SyncContributionAndProofPool:
    """Best contribution per (slot, root, subnet); produces the block
    SyncAggregate (reference syncContributionAndProofPool.ts)."""

    def __init__(self):
        self._map: Dict[Tuple[int, bytes, int], dict] = {}
        self.subnet_size = P.SYNC_COMMITTEE_SIZE // params.SYNC_COMMITTEE_SUBNET_COUNT

    def add(self, contribution: dict) -> str:
        key = (
            contribution["slot"],
            contribution["beacon_block_root"],
            contribution["subcommittee_index"],
        )
        cur = self._map.get(key)
        if cur is not None and sum(cur["aggregation_bits"]) >= sum(
            contribution["aggregation_bits"]
        ):
            return "already_known"
        self._map[key] = dict(contribution)
        return "added"

    def produce_sync_aggregate(self, slot: int, beacon_block_root: bytes) -> dict:
        """Merge per-subnet contributions into the block's SyncAggregate."""
        bits = [False] * P.SYNC_COMMITTEE_SIZE
        sigs = []
        for subnet in range(params.SYNC_COMMITTEE_SUBNET_COUNT):
            contrib = self._map.get((slot, beacon_block_root, subnet))
            if contrib is None:
                continue
            base = subnet * self.subnet_size
            for i, b in enumerate(contrib["aggregation_bits"]):
                if b:
                    bits[base + i] = True
            sigs.append(C.g2_decompress(contrib["signature"]))
        if not sigs:
            return {
                "sync_committee_bits": bits,
                "sync_committee_signature": bytes([0xC0]) + b"\x00" * 95,
            }
        agg = B.aggregate_signatures(sigs)
        return {
            "sync_committee_bits": bits,
            "sync_committee_signature": C.g2_compress(agg),
        }

    def prune(self, clock_slot: int) -> None:
        for key in [k for k in self._map if k[0] < clock_slot - SLOTS_RETAINED]:
            del self._map[key]
