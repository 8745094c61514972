"""Proposer slashing detection: slot → proposer → header-root index (the
port's copy of `lodestar_tpu/slasher/proposer.py`).

Reference: lighthouse/slasher block ingestion — every verified
SignedBeaconBlockHeader is recorded under (slot, proposer_index); a
second header for the same key with a DIFFERENT header root is a double
proposal, emitted as a ProposerSlashing (headers ordered by arrival:
signed_header_1 is the recorded one).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..types import BeaconBlockHeader


class ProposerSlasher:
    def __init__(self):
        # (slot, proposer) -> (header_root, signed_header)
        self._index: Dict[Tuple[int, int], Tuple[bytes, dict]] = {}

    def process(self, signed_header: dict) -> Optional[dict]:
        """Record one verified header; returns a ProposerSlashing when it
        equivocates with a recorded header, else None."""
        header = signed_header["message"]
        slot = int(header["slot"])
        proposer = int(header["proposer_index"])
        root = bytes(BeaconBlockHeader.hash_tree_root(header))
        key = (slot, proposer)
        existing = self._index.get(key)
        if existing is None:
            self._index[key] = (root, signed_header)
            return None
        if existing[0] == root:
            return None  # same block, re-observed
        return {
            "signed_header_1": existing[1],
            "signed_header_2": signed_header,
        }

    def prune(self, min_slot: int) -> None:
        for key in [k for k in self._index if k[0] < min_slot]:
            del self._index[key]

    def record_count(self) -> int:
        return len(self._index)
