"""NetworkProcessor — gossip scheduling + backpressure, the hot loop that

The port's copy of `lodestar_tpu/network/processor.py`; it imports nothing of the
JAX package.

feeds the BLS verifier.

Reproduces the reference's scheduling contract (reference:
packages/beacon-node/src/network/processor/index.ts):

  - per-topic GossipQueues (gossip_queues.py) buffer pending messages,
  - `execute_work()` drains them in a fixed priority order
    (executeGossipWorkOrderObj, index.ts:44-57), submitting at most
    MAX_JOBS_SUBMITTED_PER_TICK jobs per tick (index.ts:61),
  - before every job the processor re-checks downstream backpressure —
    the BLS service's `can_accept_work()` (the reference's
    blsThreadPoolCanAcceptWork, index.ts:357-371; the pipeline's
    high-water mark counts buffered + queued + in-flight SETS) and an
    optional regen gate — and stops pulling except for bypass topics
    (beacon_block),
  - when a stalled processor's queues overflow, the shed messages charge
    their publisher through the peer scorer's backpressure penalty
    (scoring.py on_backpressure_drop, gossipsub P7): peers flooding a
    saturated node pay for it while the drop lands on the per-topic
    `lodestar_gossip_queue_dropped_total` series (gossip_queues.py),
  - messages whose block root is unknown are parked for reprocessing and
    re-enqueued when the block arrives (capped at 16,384; index.ts:64-67),
    pruned per clock slot,
  - drops/priorities/queue lengths are observable for the replay harness.

The processor is host-side scheduling only; batching for the device
happens downstream in the BlsVerifierService's coalescing buffer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .gossip_queues import GossipQueue, GossipType, create_gossip_queues

# Priority order; bypass topics are processed even under backpressure
# (reference: index.ts:44-57).
EXECUTE_GOSSIP_WORK_ORDER: Tuple[Tuple[GossipType, bool], ...] = (
    (GossipType.beacon_block, True),
    (GossipType.beacon_aggregate_and_proof, False),
    (GossipType.voluntary_exit, False),
    (GossipType.bls_to_execution_change, False),
    (GossipType.beacon_attestation, False),
    (GossipType.proposer_slashing, False),
    (GossipType.attester_slashing, False),
    (GossipType.sync_committee_contribution_and_proof, False),
    (GossipType.sync_committee, False),
    (GossipType.light_client_finality_update, False),
    (GossipType.light_client_optimistic_update, False),
)

MAX_JOBS_SUBMITTED_PER_TICK = 128  # reference: index.ts:61
MAX_QUEUED_UNKNOWN_BLOCK_GOSSIP_OBJECTS = 16_384  # reference: index.ts:64
EARLIEST_PERMISSABLE_SLOT_DISTANCE = 32  # reference: index.ts:34


class PendingGossipMessage:
    """A received-but-unvalidated gossip message (the reference's
    PendingGossipsubMessage, processor/types.ts).  `peer_id` names the
    propagation source (reference: propagationSource) so overflow drops
    can be charged to the publisher."""

    __slots__ = ("topic", "data", "slot", "block_root", "seen_at", "peer_id")

    def __init__(
        self, topic, data, slot=None, block_root=None, seen_at=0.0,
        peer_id=None,
    ):
        self.topic = topic
        self.data = data
        self.slot = slot
        self.block_root = block_root
        self.seen_at = seen_at
        self.peer_id = peer_id


class ProcessorStats:
    __slots__ = (
        "submitted", "dropped", "past_slot", "reprocess_parked",
        "reprocess_rejected", "reprocess_expired", "cannot_accept_ticks",
    )

    def __init__(self):
        self.submitted = 0
        self.dropped = 0
        self.past_slot = 0
        self.reprocess_parked = 0
        self.reprocess_rejected = 0
        self.reprocess_expired = 0
        self.cannot_accept_ticks = 0


class NetworkProcessor:
    """Schedules gossip validation work against downstream backpressure.

    `worker(message)` performs the per-message validation (ultimately an
    async submit into the BlsVerifierService) and must not block on device
    results; `can_accept_work_fns` are polled before each job pull.
    """

    def __init__(
        self,
        worker: Callable[[PendingGossipMessage], None],
        can_accept_work_fns: List[Callable[[], bool]],
        has_block_root: Optional[Callable[[str], bool]] = None,
        max_jobs_per_tick: int = MAX_JOBS_SUBMITTED_PER_TICK,
        registry=None,
        scorer=None,
    ):
        # backpressure->scoring coupling: an object with
        # `on_backpressure_drop(peer_id, topic)` (GossipPeerScorer);
        # every SHED message charges its own publisher (a LIFO ratio
        # drop evicts the oldest backlog — the flooder's — so the peer
        # whose honest publish happened to overflow is not the one
        # penalized)
        self.scorer = scorer
        # registry: where queue latency/depth series land (node passes
        # its own; None = the process-global observability registry)
        self.queues: Dict[GossipType, GossipQueue] = create_gossip_queues(
            registry,
            on_drop=self._on_queue_drop if scorer is not None else None,
        )
        self.worker = worker
        self.can_accept_work_fns = can_accept_work_fns
        self.has_block_root = has_block_root
        self.max_jobs_per_tick = max_jobs_per_tick
        self.stats = ProcessorStats()
        self.current_slot = 0
        # anomaly hook: called ONCE per slot, the first time
        # a tick stalls on downstream backpressure — the flight
        # recorder's "backpressure trip" trigger.  Edge-triggered (the
        # per-tick stall count lives in stats.cannot_accept_ticks) and
        # re-armed by the slot clock, so a saturated slot costs one
        # callback, not one per stalled pull.
        self.on_backpressure_trip: Optional[Callable[[int], None]] = None
        self._backpressure_reported = False
        # slot -> root -> [messages awaiting that block]
        self._awaiting: Dict[int, Dict[str, List[PendingGossipMessage]]] = {}
        self._awaiting_count = 0

    # -- ingress (reference: onPendingGossipsubMessage, index.ts:194-241) --

    def on_gossip_message(self, message: PendingGossipMessage) -> None:
        if message.slot is not None:
            if message.slot < self.current_slot - EARLIEST_PERMISSABLE_SLOT_DISTANCE:
                self.stats.past_slot += 1
                return
            root = message.block_root
            if (
                root is not None
                and self.has_block_root is not None
                and not self.has_block_root(root)
            ):
                if self._awaiting_count > MAX_QUEUED_UNKNOWN_BLOCK_GOSSIP_OBJECTS:
                    self.stats.reprocess_rejected += 1
                    return
                self._awaiting.setdefault(message.slot, {}).setdefault(
                    root, []
                ).append(message)
                self._awaiting_count += 1
                self.stats.reprocess_parked += 1
                return
        self._push(message)

    def _on_queue_drop(self, message: PendingGossipMessage) -> None:
        """Per-item overflow observer (gossip_queues.on_drop): the queue
        only overflows when downstream (the verification pipeline)
        cannot keep up — each shed message costs ITS publisher one
        behaviour-penalty unit (the drop count itself already landed on
        lodestar_gossip_queue_dropped_total)."""
        peer = getattr(message, "peer_id", None)
        if peer is not None:
            topic = getattr(message, "topic", None)
            self.scorer.on_backpressure_drop(
                peer, topic.value if topic is not None else None
            )

    def _push(self, message: PendingGossipMessage) -> None:
        dropped = self.queues[message.topic].add(message)
        self.stats.dropped += dropped
        self.execute_work()

    # -- block arrival / clock (reference: onBlockProcessed, onClockSlot) --

    def on_block_processed(self, slot: int, root: str) -> None:
        by_root = self._awaiting.get(slot)
        if not by_root:
            return
        waiting = by_root.pop(root, [])
        if not by_root:
            self._awaiting.pop(slot, None)
        self._awaiting_count -= len(waiting)
        for msg in waiting:
            self._push(msg)

    def on_clock_slot(self, slot: int) -> None:
        self.current_slot = slot
        self._backpressure_reported = False  # re-arm the trip hook
        # awaiting messages are pruned every slot (reference: index.ts:281-299)
        for s in list(self._awaiting):
            if s < slot:
                for msgs in self._awaiting[s].values():
                    self.stats.reprocess_expired += len(msgs)
                    self._awaiting_count -= len(msgs)
                del self._awaiting[s]
        self.execute_work()

    # -- the scheduling loop (reference: executeWork, index.ts:306-352) ----

    def _check_accept_work(self) -> bool:
        return all(fn() for fn in self.can_accept_work_fns)

    def execute_work(self) -> int:
        submitted = 0
        while submitted < self.max_jobs_per_tick:
            accept = self._check_accept_work()
            pulled = False
            for topic, bypass in EXECUTE_GOSSIP_WORK_ORDER:
                if not accept and not bypass:
                    self.stats.cannot_accept_ticks += 1
                    self.stats.submitted += submitted
                    self._notify_backpressure_trip()
                    return submitted
                item = self.queues[topic].next()
                if item is not None:
                    self.worker(item)
                    submitted += 1
                    pulled = True
                    break  # restart priority scan + backpressure check
            if not pulled:
                break
        self.stats.submitted += submitted
        return submitted

    def _notify_backpressure_trip(self) -> None:
        if self._backpressure_reported or self.on_backpressure_trip is None:
            return
        self._backpressure_reported = True
        try:
            self.on_backpressure_trip(self.current_slot)
        except Exception:  # noqa: BLE001 — an observer fault must not
            pass  # break the scheduling loop

    # -- introspection (reference: dumpGossipQueue) ------------------------

    def queue_lengths(self) -> Dict[str, int]:
        return {t.value: len(q) for t, q in self.queues.items()}

    @property
    def awaiting_count(self) -> int:
        """Messages parked until their block root is processed."""
        return self._awaiting_count
