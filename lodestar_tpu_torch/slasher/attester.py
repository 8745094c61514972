"""Attester slashing detection: per-target double-vote index + min-max
surround spans, with a naive O(n²) reference for cross-checking.  The
port's copy of `lodestar_tpu/slasher/attester.py`; its span planes live
on the card (`slasher/device.py TorchSpanState`) unless the caller asks
for the CPU or for the numpy ground truth.

Detection semantics (spec is_slashable_attestation_data):
  - double vote: same target epoch, different AttestationData root;
  - surround:   att_1 surrounds att_2 iff s1 < s2 and t2 < t1 (strict
    on both sides — equal sources or equal targets are NOT surrounds;
    a source==target attestation can be surrounded but never surround).

The emitted AttesterSlashing always places the SURROUNDING attestation
first (process_attester_slashing checks s1 < s2 and t2 < t1 in that
order); double votes are order-insensitive.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..types import AttestationData
from .batch import DEFAULT_CHUNK_SIZE, DEFAULT_HISTORY_LENGTH, SpanState
from .device import TorchSpanState


def is_double_vote(data_1: dict, data_2: dict) -> bool:
    return (
        int(data_1["target"]["epoch"]) == int(data_2["target"]["epoch"])
        and AttestationData.hash_tree_root(data_1)
        != AttestationData.hash_tree_root(data_2)
    )


def is_surround_vote(data_1: dict, data_2: dict) -> bool:
    """True iff attestation 1 surrounds attestation 2."""
    return int(data_1["source"]["epoch"]) < int(
        data_2["source"]["epoch"]
    ) and int(data_2["target"]["epoch"]) < int(data_1["target"]["epoch"])


class AttesterSlasher:
    """Span-backed batch detector.

    `process_batch` takes verified IndexedAttestations (gossip singles
    and aggregates alike), groups them by AttestationData root, and for
    each distinct data runs the two vectorized span probes across every
    attesting validator before applying the (also vectorized, chunked)
    span update.  Groups are applied sequentially, so conflicting
    attestations arriving in the SAME batch still detect each other —
    whichever of the pair is processed second sees the first in the
    spans (both probe directions are covered either way).  A vote whose
    source lies below the window base has no span column: its rows'
    records are probed on the host instead (the JAX package's detector
    skips the probe there and misses such surrounds).
    """

    def __init__(
        self,
        history_length: int = DEFAULT_HISTORY_LENGTH,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        num_validators: int = 0,
        span_backend: str = "torch",
        device=None,
    ):
        # "torch": the planes on `device` (default the card; raises
        # without one) and the span-update kernel; "numpy": the ground
        # truth on the host.  Either is the caller's explicit choice:
        # there is no fallback from one to the other.
        if span_backend == "torch":
            self.spans = TorchSpanState(
                num_validators=num_validators,
                history_length=history_length,
                chunk_size=chunk_size,
                device=device,
            )
        elif span_backend == "numpy":
            if device is not None:
                raise ValueError("the numpy span backend takes no device")
            self.spans = SpanState(
                num_validators=num_validators,
                history_length=history_length,
                chunk_size=chunk_size,
            )
        else:
            raise ValueError(f"span_backend {span_backend!r}: 'torch' or 'numpy'")
        # validator -> {(source, target): (data_root, indexed_att)}
        self._records: Dict[int, Dict[Tuple[int, int], Tuple[bytes, dict]]] = {}
        # (validator, target) -> (data_root, indexed_att) — double votes
        self._by_target: Dict[Tuple[int, int], Tuple[bytes, dict]] = {}
        self.skipped_invalid = 0  # target < source: protocol-invalid
        self.evidence_missing = 0  # span hit whose record was pruned

    # -- record bookkeeping ------------------------------------------------

    def _record(self, v: int, s: int, t: int, root: bytes, att: dict) -> None:
        self._records.setdefault(v, {}).setdefault((s, t), (root, att))
        self._by_target.setdefault((v, t), (root, att))

    def _find_record(self, v: int, pred) -> Optional[dict]:
        for (s, t), (_root, att) in self._records.get(v, {}).items():
            if pred(s, t):
                return att
        return None

    def has_conflicting_target(self, v: int, target: int, root: bytes) -> bool:
        """True when `v` has a recorded attestation at `target` with a
        DIFFERENT data root — a double-vote candidate worth the cost of
        verifying a seen-cache-suppressed gossip duplicate."""
        prior = self._by_target.get((int(v), int(target)))
        return prior is not None and prior[0] != bytes(root)

    # -- batch processing --------------------------------------------------

    def process_batch(self, indexed_atts: List[dict]) -> List[Tuple[str, dict]]:
        """Returns [(kind, AttesterSlashing)] with kind in
        {"double_vote", "surround", "surrounded"}."""
        groups: Dict[bytes, Tuple[dict, List[dict]]] = {}
        for att in indexed_atts:
            root = bytes(AttestationData.hash_tree_root(att["data"]))
            groups.setdefault(root, (att["data"], []))[1].append(att)

        detections: List[Tuple[str, dict]] = []
        emitted: set = set()

        def emit(kind: str, att_1: dict, att_2: dict) -> None:
            # keyed on evidence OBJECT identity, not data roots: two
            # offenders sharing both evidence attestations collapse into
            # one slashing (its index intersection covers both), while
            # offenders with distinct evidence each get their own pair
            key = (kind, id(att_1), id(att_2))
            if key in emitted:
                return
            emitted.add(key)
            detections.append(
                (kind, {"attestation_1": att_1, "attestation_2": att_2})
            )

        for root, (data, atts) in groups.items():
            s = int(data["source"]["epoch"])
            t = int(data["target"]["epoch"])
            if t < s:
                self.skipped_invalid += len(atts)
                continue
            # validator -> a group attestation containing it (evidence)
            att_of: Dict[int, dict] = {}
            for att in atts:
                for v in att["attesting_indices"]:
                    att_of.setdefault(int(v), att)
            rows_all = sorted(att_of)
            # pure duplicates (same validator, same data) are no-ops
            rows = [
                v
                for v in rows_all
                if self._records.get(v, {}).get((s, t), (None,))[0] != root
            ]
            if not rows:
                continue

            # double votes via the per-target index
            for v in rows:
                prior = self._by_target.get((v, t))
                if prior is not None and prior[0] != root:
                    emit("double_vote", prior[1], att_of[v])

            # surround probes: two vectorized lookups at column s
            self.spans.ensure_epoch(t)
            self.spans.ensure_validators(max(rows) + 1)
            ra = np.asarray(rows, dtype=np.intp)
            if s >= self.spans.base_epoch:
                min_vals, max_vals = self.spans.lookup(ra, s)
                d = t - s
                for v, mn, mx in zip(rows, min_vals, max_vals):
                    if mx > d:  # an existing attestation surrounds (s, t)
                        prior = self._find_record(
                            v, lambda ps, pt: ps < s and pt > t
                        )
                        if prior is None:
                            self.evidence_missing += 1
                        else:
                            emit("surrounded", prior, att_of[v])
                    if mn < d:  # (s, t) surrounds an existing attestation
                        prior = self._find_record(
                            v, lambda ps, pt: ps > s and pt < t
                        )
                        if prior is None:
                            self.evidence_missing += 1
                        else:
                            emit("surround", att_of[v], prior)
            else:
                # the source lies below the window: the spans hold no
                # column for it, so the rows' records are probed on the
                # host, every record the vote surrounds or that surrounds
                # it (few votes have such a source)
                for v in rows:
                    for (ps, pt), (_root, prior) in self._records.get(v, {}).items():
                        if ps < s and pt > t:
                            emit("surrounded", prior, att_of[v])
                        if ps > s and pt < t:
                            emit("surround", att_of[v], prior)
            # apply UNCONDITIONALLY: a below-window source has no span
            # column to probe, but its max-span updates over (s, t) still land
            # inside the window (the kernel clamps), so an INNER vote
            # arriving later is still caught — the classic old-source
            # surround attack must not slip through the window base
            self.spans.apply(ra, s, t)

            for v in rows:
                self._record(v, s, t, root, att_of[v])

        return detections

    # -- pruning -----------------------------------------------------------

    def prune(self, min_epoch: int) -> None:
        """Drop history with target epoch below `min_epoch` (finalized
        attestations can no longer pair into an includable slashing that
        matters) and advance the span window."""
        self.spans.advance_base(max(self.spans.base_epoch, min_epoch))
        for v in list(self._records):
            recs = self._records[v]
            for key in [k for k in recs if k[1] < min_epoch]:
                del recs[key]
            if not recs:
                del self._records[v]
        for key in [k for k in self._by_target if k[1] < min_epoch]:
            del self._by_target[key]

    def record_count(self) -> int:
        return sum(len(r) for r in self._records.values())


class NaiveAttesterSlasher:
    """O(n²) reference: scans every recorded attestation per validator.
    Same interface and detection semantics as AttesterSlasher — the
    randomized cross-check in tests/test_slasher.py holds them equal."""

    def __init__(self):
        self._history: Dict[int, List[Tuple[int, int, bytes, dict]]] = {}

    def process_batch(self, indexed_atts: List[dict]) -> List[Tuple[str, dict]]:
        detections: List[Tuple[str, dict]] = []
        emitted: set = set()

        def emit(kind, att_1, att_2):
            key = (kind, id(att_1), id(att_2))
            if key not in emitted:
                emitted.add(key)
                detections.append(
                    (kind, {"attestation_1": att_1, "attestation_2": att_2})
                )

        for att in indexed_atts:
            data = att["data"]
            s = int(data["source"]["epoch"])
            t = int(data["target"]["epoch"])
            if t < s:
                continue
            root = bytes(AttestationData.hash_tree_root(data))
            for v in (int(i) for i in att["attesting_indices"]):
                hist = self._history.setdefault(v, [])
                if any(ps == s and pt == t and pr == root for ps, pt, pr, _ in hist):
                    continue
                for ps, pt, pr, prior in hist:
                    if pt == t and pr != root:
                        emit("double_vote", prior, att)
                    if ps < s and t < pt:
                        emit("surrounded", prior, att)
                    if s < ps and pt < t:
                        emit("surround", att, prior)
                hist.append((s, t, root, att))
        return detections

    def prune(self, min_epoch: int) -> None:
        for v in list(self._history):
            self._history[v] = [
                r for r in self._history[v] if r[1] >= min_epoch
            ]
            if not self._history[v]:
                del self._history[v]
