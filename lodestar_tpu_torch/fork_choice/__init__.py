"""Fork choice: proto-array LMD-GHOST + Casper FFG filtering.

The port's copy of `lodestar_tpu/fork_choice/__init__.py`; it imports nothing of the
JAX package.

Mirror of the reference's `@lodestar/fork-choice` (reference:
packages/fork-choice/src/protoArray/protoArray.ts, computeDeltas.ts,
forkChoice/forkChoice.ts): an append-only node array with cached
best-child/best-descendant links, batched score changes from validator
latest-messages, and viability filtering by justified/finalized
checkpoints.
"""

from .proto_array import (  # noqa: F401
    ExecutionStatus,
    LVHConsensusError,
    ProtoArray,
    ProtoArrayError,
    ProtoNode,
)
from .fork_choice import ForkChoice, LatestMessage  # noqa: F401
from .compute_deltas import compute_deltas  # noqa: F401
