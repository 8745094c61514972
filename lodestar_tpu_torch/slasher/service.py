"""SlasherService — lifecycle, batching, and the emission path (the
port's copy of `lodestar_tpu/slasher/service.py`: the same interface,
duck-typed chain and DoS bounds; the span planes on the card by default).

Wiring (mirrors how the reference composes chain-side services):

  gossip handlers  --ingest_attestation/ingest_block-->  queues
  clock slot tick  --on_clock_slot-->  flush() (or earlier at max_batch)
  flush            --> AttesterSlasher.process_batch (vectorized spans)
  detection        --> STF dry-run (chain.validate_*_slashing, WITH
                       signatures: a forged equivocation must never
                       poison block production) --> op_pool insert +
                       fork-choice equivocator zeroing --> persisted
  finalization     --> chain calls on_finalized(epoch): window prune

Every verified gossip Attestation/aggregate is ingested post-validation;
block headers arrive from the chain's import pipeline (covering gossip,
range sync, and API publishes) plus the gossip duplicate-proposer branch
— the one place an equivocating second block surfaces without being
imported.
"""

from __future__ import annotations

import time
from typing import List

from .. import params
from ..utils.logger import get_logger
from .attester import AttesterSlasher
from .batch import DEFAULT_CHUNK_SIZE, DEFAULT_HISTORY_LENGTH
from .metrics import SlasherMetrics
from .proposer import ProposerSlasher
from .store import SlasherStore

DEFAULT_MAX_BATCH = 512  # attestations buffered before a forced flush

# Per-(slot, proposer) cap on REJECTED double-propose candidates: the
# duplicate-proposer gossip branch feeds unverified headers, so an
# attacker can manufacture candidates with garbage signatures; each one
# costs a head-state clone + BLS dry-run.  After this many failures the
# key is written off for UNTRUSTED sources (a real equivocating fork
# block still enters via the chain's verified import path).
MAX_PROPOSER_REJECTIONS = 5

# Bounds on the suppressed-double-vote probe bookkeeping (pruned on
# finalization): total remembered keys, and failed verifications per
# (validator, target, root) before that key is written off.  Keys are
# consumed on OUTCOME, never on the probe itself — a forged copy of a
# vote must not burn the key the real vote needs.
MAX_EQUIVOCATION_ATTEMPTS = 4096
MAX_EQUIVOCATION_PROBE_FAILURES = 3


class SlasherService:
    def __init__(
        self,
        chain=None,
        *,
        registry=None,
        db=None,
        history_length: int = DEFAULT_HISTORY_LENGTH,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_batch: int = DEFAULT_MAX_BATCH,
        span_backend: str = "torch",
        device=None,
    ):
        self.chain = chain
        self.log = get_logger("slasher")
        self.metrics = SlasherMetrics(registry) if registry is not None else None
        self.store = SlasherStore(db)
        # "torch" (the card unless device="cpu") or "numpy"; never a fallback
        self.span_backend = span_backend
        self.attester = AttesterSlasher(
            history_length=history_length,
            chunk_size=chunk_size,
            span_backend=span_backend,
            device=device,
        )
        self.proposer = ProposerSlasher()
        self._att_queue: List[dict] = []
        self.max_batch = max_batch
        self.running = False
        # offender pairs already emitted to the pool (per slot/proposer)
        self._proposer_emitted: set = set()
        # (slot, proposer) -> rejected-candidate count (DoS bound)
        self._proposer_rejections: dict = {}
        # (validator, target, root) probes: verified-and-ingested keys,
        # and per-key failed-verification counts
        self._equivocation_done: set = set()
        self._equivocation_failures: dict = {}
        self.detections = {"double_vote": 0, "surround": 0, "surrounded": 0,
                           "double_propose": 0}
        self.rejected = 0
        self.attestations_ingested = 0
        self.blocks_ingested = 0
        self.last_flush_seconds = 0.0
        self.min_epoch = 0  # pruned-below floor
        # wall-clock epoch (clock wiring); bounds ingestible targets so
        # a rogue far-future target cannot advance the span window past
        # the live epochs (gossip validation REJECTs these too — this
        # is the service-level backstop for other callers)
        self.clock_epoch = None
        self.skipped_future = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Restore persisted state and begin accepting work.

        Restore REPLAYS the persisted evidence through detection rather
        than trusting the span snapshot: spans are a pure function of
        the recorded (validator, source, target) set, so replay is
        always crash-consistent with the evidence — and any detection
        whose slashing had not yet landed in a block RE-EMITS into the
        op pool (a restart between detection and inclusion must not
        lose a provable offence)."""
        if self.running:
            return
        snapshot = self.store.load_spans()
        if snapshot is not None and (
            snapshot.history_length == self.attester.spans.history_length
            and snapshot.chunk_size == self.attester.spans.chunk_size
        ):
            # warm-start from the shutdown snapshot; the evidence replay
            # below re-applies on top (span updates are idempotent).
            # Planes are copied INTO the live SpanState so a device-backed
            # window keeps its device apply path across restarts.
            spans = self.attester.spans
            spans.min_spans = snapshot.min_spans
            spans.max_spans = snapshot.max_spans
            spans.base_epoch = snapshot.base_epoch
        atts = list(self.store.iter_attestations())
        if atts:
            for kind, slashing in self.attester.process_batch(atts):
                self._emit_attester(kind, slashing)
        n_headers = 0
        for _slot, _proposer, signed in self.store.iter_headers():
            n_headers += 1
            slashing = self.proposer.process(signed)
            if slashing is not None:
                self._emit_proposer(slashing)
        if atts or n_headers:
            self.log.info(
                "slasher state restored",
                records=self.attester.record_count(),
                headers=self.proposer.record_count(),
            )
        self.running = True

    def stop(self) -> None:
        if not self.running:
            return
        self.flush()
        if self.store.persistent:
            # device-resident planes persist through a numpy copy; a
            # memory-only store saves nothing, so no plane leaves the card
            spans = self.attester.spans
            snapshot = getattr(spans, "snapshot", None)
            self.store.save_spans(snapshot() if snapshot is not None else spans)
        self.running = False

    # -- ingestion (gossip pipeline + chain import) ------------------------

    def ingest_attestation(self, indexed: dict) -> None:
        """Queue one VERIFIED IndexedAttestation (gossip single or
        aggregate) for the next batch flush."""
        self._att_queue.append(indexed)
        self.attestations_ingested += 1
        if self.metrics is not None:
            self.metrics.attestations_ingested.inc()
            self.metrics.queue_length.set(len(self._att_queue))
        if len(self._att_queue) >= self.max_batch:
            self.flush()

    def should_check_equivocation(self, v: int, target: int, root: bytes) -> bool:
        """Gate for the gossip layer's suppressed-double-vote recovery:
        only a validator with a CONFLICTING root at `target` — recorded
        OR still sitting in the pending queue — is worth a signature
        verification.  The key is NOT consumed here: the handler
        reports the verification outcome via record_equivocation_probe,
        so a forged copy cannot burn the key the real vote needs, while
        per-key and global failure bounds still cap the cost."""
        key = (int(v), int(target), bytes(root))
        if key in self._equivocation_done:
            return False
        if (
            self._equivocation_failures.get(key, 0)
            >= MAX_EQUIVOCATION_PROBE_FAILURES
        ):
            return False
        if len(self._equivocation_failures) >= MAX_EQUIVOCATION_ATTEMPTS:
            return False  # fail closed until the window prunes
        if self.attester.has_conflicting_target(v, target, root):
            return True
        return self._queue_has_conflicting_target(
            int(v), int(target), bytes(root)
        )

    def _queue_has_conflicting_target(
        self, v: int, target: int, root: bytes
    ) -> bool:
        """Both halves of a double vote often arrive inside one flush
        window — the second must not be dropped just because the first
        has not been batch-processed yet."""
        from ..types import AttestationData

        for att in self._att_queue:
            data = att["data"]
            if int(data["target"]["epoch"]) != target:
                continue
            if all(int(i) != v for i in att["attesting_indices"]):
                continue
            if bytes(AttestationData.hash_tree_root(data)) != root:
                return True
        return False

    def record_equivocation_probe(
        self, indices, target: int, root: bytes, ok: bool
    ) -> None:
        """Outcome of a recovery probe's signature verification."""
        for v in indices:
            key = (int(v), int(target), bytes(root))
            if ok:
                self._equivocation_done.add(key)
                self._equivocation_failures.pop(key, None)
            else:
                self._equivocation_failures[key] = (
                    self._equivocation_failures.get(key, 0) + 1
                )

    def ingest_block(
        self,
        signed_block: dict,
        body_root: bytes = None,
        trusted: bool = False,
    ) -> None:
        """Index one verified signed block's header; double proposals
        emit immediately (no batching — the header index is O(1)).

        `body_root` lets the chain pass the root the STF already
        computed (post.latest_block_header) so the import hot path does
        not re-merkleize the body.  `trusted` marks headers whose
        proposer signature HAS been verified (the chain's import path):
        they bypass the rejection write-off, so a real equivocating
        fork block that imports is always processed even after forged
        gossip duplicates exhausted the key's cap.  Untrusted keys
        already emitted or written off return before ANY hashing — the
        bound on what a duplicate-proposer gossip flood can cost."""
        block = signed_block["message"]
        slot = int(block["slot"])
        proposer = int(block["proposer_index"])
        key = (slot, proposer)
        if key in self._proposer_emitted or (
            not trusted
            and self._proposer_rejections.get(key, 0) >= MAX_PROPOSER_REJECTIONS
        ):
            return
        signed_header = self._header_of(signed_block, body_root)
        self.blocks_ingested += 1
        if self.metrics is not None:
            self.metrics.blocks_ingested.inc()
        slashing = self.proposer.process(signed_header)
        if trusted:
            # ONLY signature-verified headers persist at ingest: a
            # forged gossip duplicate in the db would be replayed on
            # restart and could seat itself as the (slot, proposer)
            # index entry, masking the real equivocation forever.
            # Untrusted headers persist below, after their slashing
            # pair survives the full STF dry-run.
            self._persist_header(signed_header)
        if slashing is not None and self._emit_proposer(slashing):
            self._persist_header(slashing["signed_header_1"])
            self._persist_header(slashing["signed_header_2"])

    def _persist_header(self, signed_header: dict) -> None:
        from ..types import BeaconBlockHeader

        header = signed_header["message"]
        self.store.put_header(
            int(header["slot"]),
            int(header["proposer_index"]),
            bytes(BeaconBlockHeader.hash_tree_root(header)),
            signed_header,
        )

    def _header_of(self, signed_block: dict, body_root: bytes = None) -> dict:
        block = signed_block["message"]
        slot = int(block["slot"])
        if body_root is None:
            if self.chain is not None:
                body_type = self.chain.config.get_fork_types(slot)[2]
            else:
                from .. import types as T

                body_type = T.BeaconBlockBodyAltair
            body_root = body_type.hash_tree_root(block["body"])
        return {
            "message": {
                "slot": slot,
                "proposer_index": int(block["proposer_index"]),
                "parent_root": bytes(block["parent_root"]),
                "state_root": bytes(block["state_root"]),
                "body_root": bytes(body_root),
            },
            "signature": bytes(signed_block["signature"]),
        }

    # -- batch flush -------------------------------------------------------

    def on_clock_slot(self, slot: int) -> None:
        self.clock_epoch = int(slot) // params.SLOTS_PER_EPOCH
        self.flush()

    def flush(self) -> int:
        """Run the vectorized span batch over everything queued; emit
        validated detections.  Returns the number of detections."""
        if not self._att_queue:
            return 0
        batch, self._att_queue = self._att_queue, []
        if self.clock_epoch is not None:
            horizon = self.clock_epoch + 1
            sane = [
                a for a in batch
                if int(a["data"]["target"]["epoch"]) <= horizon
            ]
            self.skipped_future += len(batch) - len(sane)
            batch = sane
            if not batch:
                return 0
        # evidence persists BEFORE detection runs: if the span batch
        # throws, the verified attestations are already durable and the
        # restart replay re-derives everything ("the evidence records
        # are the durable truth" must hold across a mid-flush crash).
        # Span snapshots are NOT written here — that would be
        # O(validators x history) db churn per slot; stop() snapshots.
        if self.store.persistent:
            from ..types import IndexedAttestation

            for att in batch:
                s = int(att["data"]["source"]["epoch"])
                t = int(att["data"]["target"]["epoch"])
                if t < s:
                    continue  # protocol-invalid: never persisted/replayed
                self.store.put_attestation(
                    t, bytes(IndexedAttestation.hash_tree_root(att)), att
                )
        t0 = time.perf_counter()
        detections = self.attester.process_batch(batch)
        dt = time.perf_counter() - t0
        self.last_flush_seconds = dt
        if self.metrics is not None:
            self.metrics.queue_length.set(0)
            self.metrics.batch_time.observe(dt)
            self.metrics.batch_attestations.observe(len(batch))
            self.metrics.validators_tracked.set(
                self.attester.spans.num_validators
            )
        emitted = 0
        for kind, slashing in detections:
            if self._emit_attester(kind, slashing):
                emitted += 1
        return emitted

    # -- emission ----------------------------------------------------------

    def _emit_attester(self, kind: str, slashing: dict) -> bool:
        from ..chain.op_pools import attester_slashing_intersection

        offenders = attester_slashing_intersection(slashing)
        if self.chain is not None:
            # coverage first, dry-run second: evidence is already
            # signature-verified at ingestion, so a detection whose
            # offenders all have pooled slashings counts without paying
            # another head-state clone + BLS pass
            covered = self.chain.op_pool.covered_attester_offenders()
            if offenders and set(offenders) <= covered:
                self.detections[kind] += 1
                if self.metrics is not None:
                    self.metrics.detections.inc(kind, 1.0)
                return True
            try:
                # full STF dry-run INCLUDING signatures — candidates that
                # cannot land in a block must not enter the pool
                self.chain.validate_attester_slashing(slashing)
            except Exception as e:  # noqa: BLE001 — candidate refused
                self.rejected += 1
                if self.metrics is not None:
                    self.metrics.rejected_detections.inc()
                self.log.warn(
                    "detected attester slashing failed validation",
                    kind=kind, error=str(e),
                )
                return False
            self.chain.op_pool.insert_attester_slashing(slashing)
            self.chain.on_attester_slashing(slashing)
        self.detections[kind] += 1
        if self.metrics is not None:
            self.metrics.detections.inc(kind, 1.0)
        self.log.info(
            "attester slashing detected", kind=kind, offenders=offenders
        )
        return True

    def _emit_proposer(self, slashing: dict) -> bool:
        header = slashing["signed_header_1"]["message"]
        key = (int(header["slot"]), int(header["proposer_index"]))
        if key in self._proposer_emitted:
            return False
        if self.chain is not None:
            try:
                self.chain.validate_proposer_slashing(slashing)
            except Exception as e:  # noqa: BLE001
                self.rejected += 1
                self._proposer_rejections[key] = (
                    self._proposer_rejections.get(key, 0) + 1
                )
                if self.metrics is not None:
                    self.metrics.rejected_detections.inc()
                self.log.warn(
                    "detected proposer slashing failed validation",
                    error=str(e),
                )
                return False
            self.chain.op_pool.insert_proposer_slashing(slashing)
        self._proposer_emitted.add(key)
        self.detections["double_propose"] += 1
        if self.metrics is not None:
            self.metrics.detections.inc("double_propose", 1.0)
        self.log.info(
            "double proposal detected", slot=key[0], proposer=key[1]
        )
        return True

    # -- pruning (finalization) --------------------------------------------

    def on_finalized(self, finalized_epoch: int) -> None:
        """Epoch-windowed pruning: history at or below the finalized
        epoch can no longer matter (those validators are either already
        slashed in the finalized state or their old votes finalized)."""
        if finalized_epoch <= self.min_epoch:
            return
        self.min_epoch = finalized_epoch
        min_slot = finalized_epoch * params.SLOTS_PER_EPOCH
        self.attester.prune(finalized_epoch)
        self.proposer.prune(min_slot)
        self._proposer_emitted = {
            k for k in self._proposer_emitted if k[0] >= min_slot
        }
        self._proposer_rejections = {
            k: n for k, n in self._proposer_rejections.items()
            if k[0] >= min_slot
        }
        self._equivocation_done = {
            k for k in self._equivocation_done if k[1] >= finalized_epoch
        }
        self._equivocation_failures = {
            k: n
            for k, n in self._equivocation_failures.items()
            if k[1] >= finalized_epoch
        }
        self.store.prune(finalized_epoch, min_slot)
        # NOTE: no span snapshot here — rewriting O(validators x
        # history) bytes per finalized epoch is pure churn; the snapshot
        # is a clean-shutdown fast-restore artifact (stop()), and the
        # evidence records remain the durable truth

    # -- introspection (the API's slasher route) ---------------------------

    def status(self) -> dict:
        return {
            "running": self.running,
            "attestations_ingested": self.attestations_ingested,
            "blocks_ingested": self.blocks_ingested,
            "queue_length": len(self._att_queue),
            "detections": dict(self.detections),
            "rejected_detections": self.rejected,
            "attestation_records": self.attester.record_count(),
            "proposer_records": self.proposer.record_count(),
            "span_base_epoch": self.attester.spans.base_epoch,
            "span_history_length": self.attester.spans.history_length,
            "span_chunk_size": self.attester.spans.chunk_size,
            "validators_tracked": self.attester.spans.num_validators,
            "last_flush_seconds": self.last_flush_seconds,
            "skipped_invalid": self.attester.skipped_invalid,
        }
