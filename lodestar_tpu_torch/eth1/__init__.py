"""Eth1 of the port: the terminal-PoW-block tracker that block production
reads for the merge-transition block (a copy of the JAX package's
`lodestar_tpu/eth1/merge_block_tracker.py`).  Deposit tracking and the
eth1Data vote (`deposit_tracker.py`) are not ported yet.
"""

from .merge_block_tracker import (  # noqa: F401
    Eth1MergeBlockTracker,
    PowBlockProvider,
    PowMergeBlock,
    StatusCode as MergeTrackerStatus,
)
