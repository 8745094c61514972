"""Slasher metrics — the lodestar_slasher_* family over the port's
registry (utils/metrics.py), a copy of `lodestar_tpu/slasher/metrics.py`
with the JAX package's metric names."""

from __future__ import annotations

from typing import Optional

from ..utils.metrics import Registry

_BATCH_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)


class SlasherMetrics:
    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r
        p = "lodestar_slasher_"
        self.attestations_ingested = r.counter(
            p + "attestations_ingested_total",
            "Verified indexed attestations fed to the slasher",
        )
        self.blocks_ingested = r.counter(
            p + "blocks_ingested_total",
            "Verified block headers fed to the slasher",
        )
        self.detections = r.labeled_counter(
            p + "detections_total",
            "Slashings detected, by kind",
            "kind",
        )
        self.rejected_detections = r.counter(
            p + "rejected_detections_total",
            "Detected slashings the STF dry-run refused (dropped)",
        )
        self.queue_length = r.gauge(
            p + "queue_length", "Attestations awaiting the next batch flush"
        )
        self.validators_tracked = r.gauge(
            p + "validators_tracked", "Validators with live span rows"
        )
        self.batch_time = r.histogram(
            p + "batch_seconds", "Span batch flush wall time", _BATCH_BUCKETS
        )
        self.batch_attestations = r.histogram(
            p + "batch_attestations_count",
            "Attestations per batch flush",
            (1, 8, 64, 256, 1024, 4096),
        )
