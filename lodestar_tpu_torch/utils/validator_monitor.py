"""ValidatorMonitor — per-tracked-validator performance from imported data.

The port's copy of `lodestar_tpu/utils/validator_monitor.py`; it imports nothing of the
JAX package.

Mirror of the reference (reference:
packages/beacon-node/src/metrics/validatorMonitor.ts:1-558): operators
register their local validator indices; the monitor watches every
IMPORTED block (not the validator client's own submissions — the chain
is the ground truth) and accounts, per epoch:

  - attestation inclusion: included-in-block, inclusion distance,
    correct-head vote,
  - block proposals by tracked validators,
  - sync-committee participation (signals included in sync aggregates),
  - missed duties at epoch close (registered but never included).

Summaries are windowed (HISTORIC_EPOCHS) and exposed both as metrics
gauges and as dicts for the REST introspection namespace.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .. import params
from .logger import get_logger
from .metrics import Registry

HISTORIC_EPOCHS = 4  # reference: validatorMonitor.ts HISTORIC_EPOCHS


@dataclass
class EpochSummary:
    """reference: validatorMonitor.ts EpochSummary (the subset observable
    without the full per-epoch balance diffing)."""

    attestations: int = 0
    attestation_min_delay_slots: Optional[int] = None
    attestation_correct_head: int = 0
    blocks_proposed: int = 0
    sync_signals: int = 0


@dataclass
class _Tracked:
    index: int
    summaries: Dict[int, EpochSummary] = field(default_factory=dict)
    in_sync_committee_until_epoch: int = -1


class ValidatorMonitor:
    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        self.log = get_logger("validator-monitor")
        self._validators: Dict[int, _Tracked] = {}
        self._last_closed_epoch = -1
        p = "validator_monitor_"
        self.m_validators = r.gauge(
            p + "validators_total", "Count of tracked validators"
        )
        self.m_attestations = r.counter(
            p + "attestation_in_block_total",
            "Tracked validators' attestations observed in imported blocks",
        )
        self.m_inclusion_distance = r.histogram(
            p + "attestation_in_block_delay_slots",
            "Inclusion distance of tracked validators' attestations",
            [1, 2, 3, 5, 10, 32],
        )
        self.m_correct_head = r.counter(
            p + "attestation_correct_head_total",
            "Tracked attestations voting the correct head",
        )
        self.m_blocks = r.counter(
            p + "beacon_block_in_block_total",
            "Blocks proposed by tracked validators and imported",
        )
        self.m_sync_signals = r.counter(
            p + "sync_committee_in_block_total",
            "Tracked validators' sync signals included in aggregates",
        )
        self.m_missed = r.counter(
            p + "prev_epoch_attestation_missed_total",
            "Tracked validators with no attestation included for an epoch",
        )
        self.m_sync_missed = r.counter(
            p + "prev_epoch_sync_signal_missed_total",
            "Sync-duty validators with no sync signal included for an epoch",
        )

    # -- registration (reference: registerLocalValidator) ------------------

    def register_local_validator(self, index: int) -> None:
        if index not in self._validators:
            self._validators[index] = _Tracked(index)
            self.m_validators.set(len(self._validators))

    def register_local_validator_in_sync_committee(
        self, index: int, until_epoch: int
    ) -> None:
        self.register_local_validator(index)
        self._validators[index].in_sync_committee_until_epoch = max(
            self._validators[index].in_sync_committee_until_epoch, until_epoch
        )

    @property
    def tracked_indices(self) -> Set[int]:
        return set(self._validators)

    def _summary(self, index: int, epoch: int) -> Optional[EpochSummary]:
        v = self._validators.get(index)
        if v is None:
            return None
        s = v.summaries.get(epoch)
        if s is None:
            s = EpochSummary()
            v.summaries[epoch] = s
            # prune the historic window
            for e in sorted(v.summaries):
                if len(v.summaries) <= HISTORIC_EPOCHS:
                    break
                if e != epoch:
                    del v.summaries[e]
        return s

    # -- imported-data hooks (the chain calls these on block import) -------

    def register_attestation_in_block(
        self, indexed: dict, parent_slot: int, correct_head: bool
    ) -> None:
        """reference: registerAttestationInBlock (validatorMonitor.ts:405)."""
        data = indexed["data"]
        epoch = int(data["slot"]) // params.SLOTS_PER_EPOCH
        # the reference uses parentSlot + 1 - data.slot as the best
        # possible inclusion (empty slots don't count against the duty)
        delay = max(1, int(parent_slot) + 1 - int(data["slot"]))
        for v in indexed["attesting_indices"]:
            s = self._summary(int(v), epoch)
            if s is None:
                continue
            s.attestations += 1
            if (
                s.attestation_min_delay_slots is None
                or delay < s.attestation_min_delay_slots
            ):
                s.attestation_min_delay_slots = delay
            self.m_attestations.inc()
            self.m_inclusion_distance.observe(delay)
            if correct_head:
                s.attestation_correct_head += 1
                self.m_correct_head.inc()

    def register_beacon_block(self, proposer_index: int, slot: int) -> None:
        s = self._summary(int(proposer_index), slot // params.SLOTS_PER_EPOCH)
        if s is None:
            return
        s.blocks_proposed += 1
        self.m_blocks.inc()

    def register_sync_aggregate_in_block(
        self, epoch: int, participant_indices: List[int]
    ) -> None:
        for v in participant_indices:
            s = self._summary(int(v), epoch)
            if s is None:
                continue
            s.sync_signals += 1
            self.m_sync_signals.inc()

    # -- epoch close (reference: onceEveryEndOfEpoch summaries scrape) -----

    def on_epoch_close(self, closed_epoch: int) -> List[dict]:
        """Account missed attestation duties for `closed_epoch` and
        return the per-validator summaries (the REST surface).
        Idempotent per epoch: competing imported branches both crossing
        the same boundary must not double-count misses."""
        if closed_epoch <= self._last_closed_epoch:
            return [
                self.summary_dict(i, closed_epoch)
                for i in sorted(self._validators)
            ]
        self._last_closed_epoch = closed_epoch
        out = []
        for v in self._validators.values():
            s = v.summaries.get(closed_epoch)
            if s is None or s.attestations == 0:
                self.m_missed.inc()
                self.log.warn(
                    "tracked validator missed attestation inclusion",
                    validator=v.index,
                    epoch=closed_epoch,
                )
            if (
                closed_epoch <= v.in_sync_committee_until_epoch
                and (s is None or s.sync_signals == 0)
            ):
                # registered for sync duty in this epoch but no signal
                # of theirs made an included aggregate
                self.m_sync_missed.inc()
                self.log.warn(
                    "sync-duty validator missed inclusion",
                    validator=v.index,
                    epoch=closed_epoch,
                )
            out.append(self.summary_dict(v.index, closed_epoch))
        return out

    def summary_dict(self, index: int, epoch: int) -> dict:
        v = self._validators.get(index)
        s = (v.summaries.get(epoch) if v else None) or EpochSummary()
        return {
            "index": index,
            "epoch": epoch,
            "attestations_included": s.attestations,
            "attestation_min_delay_slots": s.attestation_min_delay_slots,
            "attestation_correct_head": s.attestation_correct_head,
            "blocks_proposed": s.blocks_proposed,
            "sync_signals_included": s.sync_signals,
        }
