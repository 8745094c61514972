"""Execution layer — engine API interface, in-process mock, HTTP client.

The port's copy of `lodestar_tpu/execution/__init__.py`; it imports
nothing of the JAX package.

Mirror of the reference's execution package (reference:
packages/beacon-node/src/execution/engine/{interface.ts,http.ts,
mock.ts}): the beacon node drives the execution client through three
verbs — notify_new_payload, notify_forkchoice_update, get_payload —
carried over authenticated JSON-RPC.  Block verification runs the
payload check as a parallel leg next to the state transition and
signature batch (reference: chain/blocks/verifyBlock.ts:87-104).
"""

from .engine import (
    ExecutePayloadStatus,
    ExecutionEngineUnavailable,
    ExecutionPayloadStatus,
    ForkchoiceUpdateResult,
    IExecutionEngine,
    PayloadAttributes,
)
from .engine_mock import ExecutionEngineMock
from .engine_http import ExecutionEngineHttp, EngineApiServer
from .builder import (
    BuilderBidResult,
    BuilderError,
    ExecutionBuilderHttp,
    ExecutionBuilderMock,
    unblind_signed_block,
    verify_revealed_payload,
)

__all__ = [
    "BuilderBidResult",
    "BuilderError",
    "ExecutionBuilderHttp",
    "ExecutionBuilderMock",
    "unblind_signed_block",
    "verify_revealed_payload",
    "ExecutePayloadStatus",
    "ExecutionEngineUnavailable",
    "ExecutionPayloadStatus",
    "ForkchoiceUpdateResult",
    "IExecutionEngine",
    "PayloadAttributes",
    "ExecutionEngineMock",
    "ExecutionEngineHttp",
    "EngineApiServer",
]
