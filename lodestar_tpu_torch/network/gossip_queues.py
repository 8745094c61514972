"""Per-topic gossip queues with overload shedding.

The port's copy of `lodestar_tpu/network/gossip_queues.py`; it imports nothing of the
JAX package.

Mirrors the reference's queue discipline (reference:
packages/beacon-node/src/network/processor/gossipQueues.ts):

  - each topic gets FIFO or LIFO ordering and a max length,
  - on overflow, drop either a fixed COUNT of items or an escalating
    RATIO of the queue (attestations: start 1%, +1% per overflow, cap
    95%, reset once the queue fully drains and stays drained for a full
    queue-length of processed items),
  - drops evict from the *stale* end (LIFO drops oldest, FIFO drops
    newest) so the work kept is the work most likely to still matter.

The queue is plain host code — it feeds fixed-shape device batches but
never touches the device itself.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")

MAX_DROP_RATIO = 0.95

_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30)


class GossipQueueMetrics:
    """Per-topic queue observability: enqueue->dequeue latency, live
    depth, drop counts (the series that size the verification
    pipeline's flush deadlines).  One instance per Registry; shared across topics via
    the `topic` label."""

    def __init__(self, registry=None):
        if registry is None:
            from ..utils.metrics import global_registry

            registry = global_registry()
        self.latency = registry.labeled_histogram(
            "lodestar_gossip_queue_latency_seconds",
            "Enqueue-to-dequeue wait per gossip message",
            "topic",
            _LATENCY_BUCKETS,
        )
        self.depth = registry.labeled_gauge(
            "lodestar_gossip_queue_length",
            "Live gossip queue depth per topic",
            "topic",
        )
        self.dropped = registry.labeled_counter(
            "lodestar_gossip_queue_dropped_total",
            "Messages shed by overflow policy per topic",
            "topic",
        )


class QueueType(enum.Enum):
    FIFO = "FIFO"
    LIFO = "LIFO"


@dataclass(frozen=True)
class DropByCount:
    count: int = 1


@dataclass(frozen=True)
class DropByRatio:
    start: float = 0.01
    step: float = 0.01


@dataclass(frozen=True)
class GossipQueueOpts:
    type: QueueType
    max_length: int
    drop: object  # DropByCount | DropByRatio


class GossipType(enum.Enum):
    beacon_block = "beacon_block"
    beacon_aggregate_and_proof = "beacon_aggregate_and_proof"
    voluntary_exit = "voluntary_exit"
    bls_to_execution_change = "bls_to_execution_change"
    beacon_attestation = "beacon_attestation"
    proposer_slashing = "proposer_slashing"
    attester_slashing = "attester_slashing"
    sync_committee_contribution_and_proof = "sync_committee_contribution_and_proof"
    sync_committee = "sync_committee"
    light_client_finality_update = "light_client_finality_update"
    light_client_optimistic_update = "light_client_optimistic_update"


# Queue shapes per topic (reference: gossipQueues.ts gossipQueueOpts; the
# numbers trace to lighthouse's beacon_processor).
GOSSIP_QUEUE_OPTS: Dict[GossipType, GossipQueueOpts] = {
    GossipType.beacon_block: GossipQueueOpts(QueueType.FIFO, 1024, DropByCount(1)),
    GossipType.beacon_aggregate_and_proof: GossipQueueOpts(
        QueueType.LIFO, 5120, DropByCount(1)
    ),
    GossipType.beacon_attestation: GossipQueueOpts(
        QueueType.LIFO, 24576, DropByRatio(0.01, 0.01)
    ),
    GossipType.voluntary_exit: GossipQueueOpts(QueueType.FIFO, 4096, DropByCount(1)),
    GossipType.proposer_slashing: GossipQueueOpts(
        QueueType.FIFO, 4096, DropByCount(1)
    ),
    GossipType.attester_slashing: GossipQueueOpts(
        QueueType.FIFO, 4096, DropByCount(1)
    ),
    GossipType.sync_committee_contribution_and_proof: GossipQueueOpts(
        QueueType.LIFO, 4096, DropByCount(1)
    ),
    GossipType.sync_committee: GossipQueueOpts(QueueType.LIFO, 4096, DropByCount(1)),
    GossipType.light_client_finality_update: GossipQueueOpts(
        QueueType.FIFO, 1024, DropByCount(1)
    ),
    GossipType.light_client_optimistic_update: GossipQueueOpts(
        QueueType.FIFO, 1024, DropByCount(1)
    ),
    GossipType.bls_to_execution_change: GossipQueueOpts(
        QueueType.FIFO, 16384, DropByCount(1)
    ),
}


class GossipQueue(Generic[T]):
    """One topic's queue.  `add` returns the number of items dropped.

    When constructed with a `topic` + `metrics`, every add/next pair
    feeds the enqueue->dequeue latency histogram and the depth gauge —
    `_t` mirrors `_q`'s order exactly (same ends pushed/popped), so the
    timestamp popped with an item is always that item's."""

    def __init__(
        self,
        opts: GossipQueueOpts,
        topic: Optional[str] = None,
        metrics: Optional[GossipQueueMetrics] = None,
        on_drop=None,
    ):
        self.opts = opts
        self.topic = topic
        self.metrics = metrics if topic is not None else None
        # per-ITEM drop observer fn(item) — the backpressure->scoring
        # coupling charges each shed message's OWN publisher (a LIFO
        # ratio drop sheds the oldest backlog, which belongs to whoever
        # flooded it there, not to the peer whose publish overflowed)
        self.on_drop = on_drop
        self._q: Deque[T] = deque()
        self._t: Deque[float] = deque()  # per-item enqueue perf_counter
        self._drop_ratio = 0.0
        if isinstance(opts.drop, DropByRatio):
            if not (0.0 < opts.drop.start <= 1.0):
                raise ValueError(f"invalid drop ratio start {opts.drop.start}")
            self._drop_ratio = opts.drop.start
        # After a ratio-drop, the queue draining to empty is not by itself
        # evidence of good health (we may have just shed 90% of it); only
        # reset the ratio after a full max_length of items processed
        # without another overflow.
        self._recent_drop = False
        self._processed_since_drop = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def drop_ratio(self) -> float:
        return self._drop_ratio

    def clear(self) -> None:
        self._q.clear()
        self._t.clear()
        self._set_depth()

    def _set_depth(self) -> None:
        if self.metrics is not None:
            self.metrics.depth.set(self.topic, float(len(self._q)))

    def add(self, item: T) -> int:
        drop = self.opts.drop
        if isinstance(drop, DropByRatio) and not self._recent_drop and not self._q:
            self._drop_ratio = drop.start  # node looks healthy: retest start
        self._q.append(item)
        self._t.append(time.perf_counter())
        if len(self._q) <= self.opts.max_length:
            self._set_depth()
            return 0
        if isinstance(drop, DropByCount):
            dropped = self._drop_by_count(drop.count)
        else:
            self._recent_drop = True
            dropped = self._drop_by_count(int(len(self._q) * self._drop_ratio))
            self._drop_ratio = min(MAX_DROP_RATIO, self._drop_ratio + drop.step)
        if dropped and self.metrics is not None:
            self.metrics.dropped.inc(self.topic, float(dropped))
        self._set_depth()
        return dropped

    def next(self) -> Optional[T]:
        if not self._q:
            return None
        if self.opts.type is QueueType.LIFO:
            item, t_in = self._q.pop(), self._t.pop()
        else:
            item, t_in = self._q.popleft(), self._t.popleft()
        if self.metrics is not None:
            self.metrics.latency.observe(
                self.topic, time.perf_counter() - t_in
            )
            self._set_depth()
        if isinstance(self.opts.drop, DropByRatio) and self._recent_drop:
            self._processed_since_drop += 1
            if self._processed_since_drop >= self.opts.max_length:
                self._recent_drop = False
                self._processed_since_drop = 0
        return item

    def get_all(self) -> List[T]:
        return list(self._q)

    def _drop_by_count(self, count: int) -> int:
        if count <= 0:
            return 0
        if count >= len(self._q):
            n = len(self._q)
            if self.on_drop is not None:
                for item in self._q:
                    self._observe_drop(item)
            self._q.clear()
            self._t.clear()
            return n
        # LIFO keeps the newest (drop from the left/oldest); FIFO keeps
        # the oldest (drop from the right/newest).
        for _ in range(count):
            if self.opts.type is QueueType.LIFO:
                item = self._q.popleft()
                self._t.popleft()
            else:
                item = self._q.pop()
                self._t.pop()
            self._observe_drop(item)
        return count

    def _observe_drop(self, item: T) -> None:
        if self.on_drop is None:
            return
        try:
            self.on_drop(item)
        except Exception:  # noqa: BLE001 — a scoring fault must never
            pass  # break the queue discipline


def create_gossip_queues(
    registry=None, on_drop=None
) -> Dict[GossipType, GossipQueue]:
    metrics = GossipQueueMetrics(registry)
    return {
        t: GossipQueue(o, topic=t.value, metrics=metrics, on_drop=on_drop)
        for t, o in GOSSIP_QUEUE_OPTS.items()
    }
