"""Eth1MergeBlockTracker — terminal-PoW-block discovery by TTD.

The port's copy of `lodestar_tpu/eth1/merge_block_tracker.py`; it imports nothing of the
JAX package.

Mirror of the reference's Eth1MergeBlockTracker (reference:
packages/beacon-node/src/eth1/eth1MergeBlockTracker.ts:1-336): follow
the eth1 chain for the first block whose total difficulty crosses
TERMINAL_TOTAL_DIFFICULTY (walking parents until parent.td < TTD), with
the TERMINAL_BLOCK_HASH override taking precedence, a bounded
by-hash block cache, and the STOPPED/SEARCHING/FOUND status machine.

Clock-driven instead of timer-driven: the node wires `on_tick` to its
slot clock (the reference's setInterval at SECONDS_PER_ETH1_BLOCK);
each tick runs at most one search, and FOUND latches permanently.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Protocol

from ..utils.logger import get_logger

ZERO_HASH_HEX = "00" * 32
# bounds blocks_by_hash (reference: MAX_CACHE_POW_BLOCKS = 1024)
MAX_CACHE_POW_BLOCKS = 1024


@dataclass(frozen=True)
class PowMergeBlock:
    number: int
    block_hash: str  # plain hex
    parent_hash: str
    total_difficulty: int


class PowBlockProvider(Protocol):
    def get_pow_block_by_hash(
        self, block_hash: str
    ) -> Optional[PowMergeBlock]: ...

    def get_pow_block_latest(self) -> Optional[PowMergeBlock]: ...


class StatusCode(str, enum.Enum):
    STOPPED = "STOPPED"
    SEARCHING = "SEARCHING"
    FOUND = "FOUND"


class Eth1MergeBlockTracker:
    def __init__(
        self,
        provider: PowBlockProvider,
        terminal_total_difficulty: int,
        terminal_block_hash: bytes = b"\x00" * 32,
    ):
        self.provider = provider
        self.ttd = int(terminal_total_difficulty)
        self.terminal_block_hash = bytes(terminal_block_hash)
        self.log = get_logger("eth1/merge-tracker")
        self.status = StatusCode.STOPPED
        self.merge_block: Optional[PowMergeBlock] = None
        self.latest_eth1_block: Optional[PowMergeBlock] = None
        self._cache: Dict[str, PowMergeBlock] = {}

    # -- public surface (reference: getTerminalPowBlock semantics) ---------

    def get_terminal_pow_block(self) -> Optional[PowMergeBlock]:
        """STOPPED: search on demand.  SEARCHING: the poller would have
        found it — None.  FOUND: the latched block
        (eth1MergeBlockTracker.ts:99-112)."""
        if self.status == StatusCode.FOUND:
            return self.merge_block
        if self.status == StatusCode.SEARCHING:
            return None
        return self._search()

    def get_td_progress(self) -> Optional[dict]:
        """Distance to TTD for observability (getTDProgress)."""
        if self.latest_eth1_block is None:
            return None
        diff = self.ttd - self.latest_eth1_block.total_difficulty
        if diff > 0:
            return {
                "ttd_hit": False,
                "ttd": self.ttd,
                "td": self.latest_eth1_block.total_difficulty,
                "td_diff": diff,
            }
        return {"ttd_hit": True}

    def start_polling_merge_block(self) -> None:
        """Arm the search.  Callers gate on: after BELLATRIX_FORK_EPOCH,
        synced, and head not merge-complete (ts:160-166)."""
        if self.status == StatusCode.STOPPED:
            self.status = StatusCode.SEARCHING
            self.log.info(
                "starting terminal PoW block search", ttd=self.ttd
            )

    def on_tick(self) -> Optional[PowMergeBlock]:
        """One poll step (the reference's interval body)."""
        if self.status != StatusCode.SEARCHING:
            return self.merge_block
        try:
            return self._search()
        except Exception as e:  # noqa: BLE001 — EL flakes must not kill polling
            self.log.warn("merge block search failed", error=str(e))
            return None

    def get_pow_block(self, block_hash: str) -> Optional[PowMergeBlock]:
        cached = self._cache.get(block_hash)
        if cached is not None:
            return cached
        block = self.provider.get_pow_block_by_hash(block_hash)
        if block is not None:
            self._cache_block(block)
        return block

    # -- the search (reference: internalGetTerminalPowBlockFromEth1) -------

    def _search(self) -> Optional[PowMergeBlock]:
        found = self._find_merge_block()
        if found is not None and self.status != StatusCode.FOUND:
            self.log.info(
                "terminal PoW block found",
                hash=found.block_hash,
                number=found.number,
                td=found.total_difficulty,
            )
            self.status = StatusCode.FOUND
            self.merge_block = found
        return found

    def _find_merge_block(self) -> Optional[PowMergeBlock]:
        # terminal block hash override takes precedence over TTD
        # (ts:241-251)
        if self.terminal_block_hash != b"\x00" * 32:
            return self.get_pow_block(self.terminal_block_hash.hex())

        latest = self.provider.get_pow_block_latest()
        if latest is None:
            raise LookupError("eth1 provider returned no latest block")
        self.latest_eth1_block = latest
        self._cache_block(latest)

        block = latest
        while True:
            if block.total_difficulty < self.ttd:
                return None  # TTD not reached yet
            # genesis may itself reach TTD (consensus-specs #2719)
            if block.parent_hash == ZERO_HASH_HEX:
                return block
            parent = self.get_pow_block(block.parent_hash)
            if parent is None:
                raise LookupError(
                    f"unknown parent of TD>TTD block {block.parent_hash}"
                )
            # block.td >= TTD and parent.td < TTD -> the merge block
            if parent.total_difficulty < self.ttd:
                return block
            block = parent

    def _cache_block(self, block: PowMergeBlock) -> None:
        self._cache[block.block_hash] = block
        while len(self._cache) > MAX_CACHE_POW_BLOCKS:
            self._cache.pop(next(iter(self._cache)))
