"""ExecutionEngineMock — a fake execution client for tests and dev mode.

The port's copy of `lodestar_tpu/execution/engine_mock.py`; it imports nothing of the
JAX package.

Mirror of the reference's mock EL (reference:
packages/beacon-node/src/execution/engine/mock.ts, 440 LoC): keeps an
in-memory tree of execution blocks, validates incoming payloads
(parent known -> VALID, unknown -> SYNCING, corrupt hash ->
INVALID_BLOCK_HASH), prepares payloads on forkchoiceUpdated with
attributes, and serves them via get_payload.  Block hashes are
sha256 of the payload's header fields (the mock defines its own hash
scheme, like the reference's — consensus only needs consistency, not
EVM semantics).

Payload dicts carry BYTES for all hash/byte fields (the SSZ-value
shape); hex strings appear only at the JSON-RPC boundary
(engine_http.py converts).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

from .engine import (
    ExecutePayloadStatus,
    ExecutionPayloadStatus,
    ForkchoiceUpdateResult,
    PayloadAttributes,
)

ZERO_HASH = b"\x00" * 32


def compute_block_hash(payload: dict) -> bytes:
    """The mock's block-hash function: sha256 over the header-equivalent
    fields."""
    h = hashlib.sha256()
    for key in (
        "parent_hash",
        "fee_recipient",
        "state_root",
        "receipts_root",
        "prev_randao",
    ):
        h.update(bytes(payload[key]))
    for key in ("block_number", "gas_limit", "gas_used", "timestamp"):
        h.update(int(payload[key]).to_bytes(8, "little"))
    for tx in payload.get("transactions", []):
        h.update(hashlib.sha256(bytes(tx)).digest())
    return h.digest()


class ExecutionEngineMock:
    """In-process IExecutionEngine."""

    def __init__(self, genesis_block_hash: bytes = ZERO_HASH):
        # known valid execution blocks: hash -> parent hash
        self.valid_blocks: Dict[bytes, bytes] = {
            bytes(genesis_block_hash): ZERO_HASH
        }
        # payloads being built: payload_id -> payload dict
        self.preparing: Dict[str, dict] = {}
        self._payload_seq = 0
        self.head: bytes = bytes(genesis_block_hash)
        self.finalized: bytes = ZERO_HASH
        # test fault injection (reference mock error modes)
        self.fail_with: Optional[ExecutePayloadStatus] = None
        # block hashes the EL rules INVALID (optimistic-sync tests);
        # responses carry the nearest known-valid ancestor as the LVH,
        # or the zero hash when the ancestry is unknown
        self.invalid_hashes: set = set()

    # -- engine_newPayload -------------------------------------------------

    def notify_new_payload(
        self,
        payload: dict,
        versioned_hashes=None,
        parent_beacon_block_root=None,
    ) -> ExecutionPayloadStatus:
        if self.fail_with is not None:
            return ExecutionPayloadStatus(self.fail_with)
        declared = bytes(payload["block_hash"])
        if declared in self.invalid_hashes:
            return ExecutionPayloadStatus(
                ExecutePayloadStatus.INVALID,
                latest_valid_hash="0x"
                + self._latest_valid_ancestor(
                    bytes(payload["parent_hash"])
                ).hex(),
                validation_error="mock: hash ruled invalid",
            )
        actual = compute_block_hash(payload)
        if declared != actual:
            return ExecutionPayloadStatus(
                ExecutePayloadStatus.INVALID_BLOCK_HASH,
                validation_error=(
                    f"declared 0x{declared.hex()} != computed 0x{actual.hex()}"
                ),
            )
        parent = bytes(payload["parent_hash"])
        if parent not in self.valid_blocks:
            # unknown ancestry: optimistic import territory
            return ExecutionPayloadStatus(ExecutePayloadStatus.SYNCING)
        self.valid_blocks[declared] = parent
        return ExecutionPayloadStatus(
            ExecutePayloadStatus.VALID,
            latest_valid_hash="0x" + declared.hex(),
        )

    # -- engine_forkchoiceUpdated ------------------------------------------

    def notify_forkchoice_update(
        self,
        head_block_hash: bytes,
        safe_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: Optional[PayloadAttributes] = None,
    ) -> ForkchoiceUpdateResult:
        if self.fail_with is not None:
            return ForkchoiceUpdateResult(self.fail_with)
        head_block_hash = bytes(head_block_hash)
        if head_block_hash in self.invalid_hashes:
            return ForkchoiceUpdateResult(
                ExecutePayloadStatus.INVALID,
                latest_valid_hash="0x"
                + self._latest_valid_ancestor(
                    self.valid_blocks.get(head_block_hash, ZERO_HASH)
                ).hex(),
            )
        if head_block_hash not in self.valid_blocks:
            return ForkchoiceUpdateResult(ExecutePayloadStatus.SYNCING)
        self.head = head_block_hash
        if bytes(finalized_block_hash) != ZERO_HASH:
            self.finalized = bytes(finalized_block_hash)
        payload_id = None
        if payload_attributes is not None:
            self._payload_seq += 1
            payload_id = f"0x{self._payload_seq:016x}"
            number = self._block_number(head_block_hash) + 1
            payload = {
                "parent_hash": head_block_hash,
                "fee_recipient": bytes(
                    payload_attributes.suggested_fee_recipient
                ),
                "state_root": hashlib.sha256(b"el-state-%d" % number).digest(),
                "receipts_root": hashlib.sha256(
                    b"el-receipts-%d" % number
                ).digest(),
                "logs_bloom": b"\x00" * 256,
                "prev_randao": bytes(payload_attributes.prev_randao),
                "block_number": number,
                "gas_limit": 30_000_000,
                "gas_used": 0,
                "timestamp": payload_attributes.timestamp,
                "extra_data": b"lodestar-tpu-mock",
                "base_fee_per_gas": 7,
                "transactions": [],
            }
            if payload_attributes.withdrawals is not None:
                # engine API v2 (capella): the built payload includes the
                # protocol-computed withdrawal list verbatim
                payload["withdrawals"] = [
                    dict(w) for w in payload_attributes.withdrawals
                ]
            payload["block_hash"] = compute_block_hash(payload)
            self.preparing[payload_id] = payload
        return ForkchoiceUpdateResult(
            ExecutePayloadStatus.VALID,
            latest_valid_hash="0x" + head_block_hash.hex(),
            payload_id=payload_id,
        )

    def _latest_valid_ancestor(self, start: bytes) -> bytes:
        """Nearest ancestor that is known-valid and not ruled invalid;
        zero hash when the ancestry is unknown (optimistic peer)."""
        cur = bytes(start)
        seen = 0
        while cur != ZERO_HASH and seen < 10_000:
            if cur in self.valid_blocks and cur not in self.invalid_hashes:
                return cur
            cur = self.valid_blocks.get(cur, ZERO_HASH)
            seen += 1
        return ZERO_HASH

    def _block_number(self, block_hash: bytes) -> int:
        n = 0
        cur = block_hash
        while cur != ZERO_HASH and n < 10_000:
            cur = self.valid_blocks.get(cur, ZERO_HASH)
            n += 1
        return n

    # -- engine_getPayload -------------------------------------------------

    def get_payload(self, payload_id: str, version: int = 2) -> dict:
        payload = self.preparing.pop(payload_id, None)
        if payload is None:
            raise ValueError(f"unknown payload id {payload_id}")
        return payload
