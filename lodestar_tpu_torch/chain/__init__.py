"""The chain of the port (copies of the JAX package's `lodestar_tpu/chain/`):
the slot clock, the seen caches, the operation pools, the state caches,
the memory governor, regen, block production, the block processor and
`BeaconChain` (chain.py), which imports blocks through the port's state
transition, verifier service and state-root engine, with its execution
payload leg, deneb data availability (`blobs.py`) and blinded production
through a builder, the archiver, the light-client server, next-slot
preparation with the proposer cache (`prepare_next_slot.py`) and the
anchor-state selection (`init_state.py`).  The gossip validation family
(`validation.py`) is not ported yet.
"""

from .block_processor import BlockError, BlockProcessor  # noqa: F401
from .clock import Clock  # noqa: F401
from .seen_cache import (  # noqa: F401
    SeenAggregators,
    SeenAttestationDatas,
    SeenAttesters,
)
