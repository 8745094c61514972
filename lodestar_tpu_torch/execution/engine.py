"""Engine API interface types.

The port's copy of `lodestar_tpu/execution/engine.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/execution/engine/interface.ts —
ExecutePayloadStatus and the IExecutionEngine verbs.  Payloads travel
as plain dicts shaped like the bellatrix ExecutionPayload SSZ container
(types are defined alongside so serialization is available when the
bellatrix state transition lands).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Protocol


class ExecutionEngineUnavailable(Exception):
    """The EL could not answer (outage / transport failure) — a
    RETRYABLE condition, never evidence the block is invalid."""


class ExecutePayloadStatus(str, enum.Enum):
    """interface.ts:11-31."""

    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"
    INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"
    ELERROR = "ELERROR"
    UNAVAILABLE = "UNAVAILABLE"


@dataclass
class ExecutionPayloadStatus:
    status: ExecutePayloadStatus
    latest_valid_hash: Optional[str] = None  # 0x-hex
    validation_error: Optional[str] = None


@dataclass
class ForkchoiceUpdateResult:
    status: ExecutePayloadStatus
    latest_valid_hash: Optional[str] = None
    payload_id: Optional[str] = None  # set when attributes were provided


@dataclass
class PayloadAttributes:
    """engine_forkchoiceUpdated payload-build request (interface.ts).

    `withdrawals` (engine API v2 / capella) carries the protocol-computed
    expected withdrawals the built payload must include; None = v1.
    `parent_beacon_block_root` (v3 / deneb) is required by post-Cancun
    ELs — forkchoiceUpdatedV3 rejects attributes without it."""

    timestamp: int
    prev_randao: bytes
    suggested_fee_recipient: bytes
    withdrawals: Optional[list] = None
    parent_beacon_block_root: Optional[bytes] = None


class IExecutionEngine(Protocol):
    def notify_new_payload(
        self,
        payload: dict,
        versioned_hashes: Optional[list] = None,
        parent_beacon_block_root: Optional[bytes] = None,
    ) -> ExecutionPayloadStatus: ...

    def notify_forkchoice_update(
        self,
        head_block_hash: bytes,
        safe_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: Optional[PayloadAttributes] = None,
    ) -> ForkchoiceUpdateResult: ...

    def get_payload(self, payload_id: str, version: int = 2) -> dict: ...
