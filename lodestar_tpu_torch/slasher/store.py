"""Slasher persistence over the db's bucketed repositories (the port's
copy of `lodestar_tpu/slasher/store.py`; the db is duck-typed).

Reference: lighthouse/slasher's database schema (indexed attestations,
min/max span chunks, proposer records) reduced to this framework's
repository layer (db/repository.py column families, wired as typed
repositories in db/beacon_db.py):

  - slasher_min_span / slasher_max_span: the span arrays, stored as one
    raw blob each plus a JSON metadata record (base epoch, shape);
  - slasher_attestation: SSZ IndexedAttestation keyed by
    target_epoch(8B)||hash_tree_root — evidence records, replayed into
    the detector on load; the epoch prefix makes pruning a key scan;
  - slasher_header: SSZ SignedBeaconBlockHeader keyed by
    slot(8B)||proposer(8B)||header_root — the double-propose index.
    The ROOT rides in the key so BOTH halves of an equivocation
    persist; a restart replays them and re-detects.

A SlasherStore with db=None is a no-op shell, so the service runs
memory-only in light compositions/tests.  The evidence records are the
durable source of truth — the service's restore path REPLAYS them
through detection — while the span blobs are a clean-shutdown snapshot
(written at stop(), loaded as a warm-start before the replay; span
updates are idempotent so re-applying evidence on top is safe).
"""

from __future__ import annotations

import json
from typing import Iterator, Optional, Tuple

import numpy as np

from .batch import SpanState

_META_KEY = b"meta"
_DATA_KEY = b"data"


def _header_key(slot: int, proposer: int, root: bytes) -> bytes:
    return slot.to_bytes(8, "big") + proposer.to_bytes(8, "big") + root


class SlasherStore:
    def __init__(self, db=None):
        """`db` is a BeaconDb exposing the slasher_* repositories (older
        test doubles without them degrade to memory-only)."""
        self._min = getattr(db, "slasher_min_span", None)
        self._max = getattr(db, "slasher_max_span", None)
        self._atts = getattr(db, "slasher_attestation", None)
        self._headers = getattr(db, "slasher_header", None)

    @property
    def persistent(self) -> bool:
        return self._min is not None

    # -- spans -------------------------------------------------------------

    def save_spans(self, spans: SpanState) -> None:
        if self._min is None:
            return
        meta = json.dumps(
            {
                "base_epoch": spans.base_epoch,
                "num_validators": spans.num_validators,
                "history_length": spans.history_length,
                "chunk_size": spans.chunk_size,
            }
        ).encode()
        self._min.put(_META_KEY, meta)
        self._min.put(_DATA_KEY, spans.min_spans.tobytes())
        self._max.put(_DATA_KEY, spans.max_spans.tobytes())

    def load_spans(self) -> Optional[SpanState]:
        if self._min is None:
            return None
        meta = self._min.get(_META_KEY)
        if meta is None:
            return None
        m = json.loads(meta.decode())
        spans = SpanState(
            num_validators=m["num_validators"],
            history_length=m["history_length"],
            chunk_size=m["chunk_size"],
            base_epoch=m["base_epoch"],
        )
        shape = (m["num_validators"], spans.history_length)
        spans.min_spans = np.frombuffer(
            self._min.get(_DATA_KEY), dtype=np.int32
        ).reshape(shape).copy()
        spans.max_spans = np.frombuffer(
            self._max.get(_DATA_KEY), dtype=np.int32
        ).reshape(shape).copy()
        return spans

    # -- evidence records --------------------------------------------------

    def put_attestation(self, target_epoch: int, root: bytes, indexed: dict) -> None:
        """Keyed target_epoch(8B big-endian)||root: epoch-ordered keys
        make pruning a key scan with NO value deserialization."""
        if self._atts is not None:
            key = target_epoch.to_bytes(8, "big") + root
            if not self._atts.has(key):
                self._atts.put(key, indexed)

    def iter_attestations(self) -> Iterator[dict]:
        if self._atts is not None:
            for _key, att in self._atts.entries():
                yield att

    def put_header(
        self, slot: int, proposer: int, root: bytes, signed_header: dict
    ) -> None:
        if self._headers is not None:
            key = _header_key(slot, proposer, root)
            if not self._headers.has(key):
                self._headers.put(key, signed_header)

    def iter_headers(self) -> Iterator[Tuple[int, int, dict]]:
        if self._headers is not None:
            for key, signed in self._headers.entries():
                yield (
                    int.from_bytes(key[:8], "big"),
                    int.from_bytes(key[8:16], "big"),
                    signed,
                )

    # -- pruning -----------------------------------------------------------

    def prune(self, min_epoch: int, min_slot: int) -> None:
        """Key-prefix scans only — both families encode their epoch/slot
        in the key, so pruning never deserializes a value."""
        if self._atts is not None:
            for key in [
                k
                for k in self._atts.keys()
                if int.from_bytes(k[:8], "big") < min_epoch
            ]:
                self._atts.delete(key)
        if self._headers is not None:
            for key in [
                k
                for k in self._headers.keys()
                if int.from_bytes(k[:8], "big") < min_slot
            ]:
                self._headers.delete(key)

