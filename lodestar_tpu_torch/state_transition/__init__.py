"""The state-root engine of the port (the JAX package's
`lodestar_tpu/state_transition/state_root.py`, on the port's merkle tree
and device backend).  The state transition itself is not ported."""

from .state_root import StateRootEngine, state_root_engine_bytes  # noqa: F401
