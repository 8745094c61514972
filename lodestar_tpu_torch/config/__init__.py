"""Chain config: fork schedule, domains, fork digests.

The port's copy of `lodestar_tpu/config/__init__.py`; it imports nothing of the
JAX package.

Mirror of the reference's `@lodestar/config` (reference:
packages/config/src/beaconConfig.ts, config/src/forkConfig/index.ts,
config/src/chainConfig/): a runtime ChainConfig (fork versions/epochs,
genesis validators root) layered on the compile-time preset, exposing

    get_fork_name(slot)   — active fork at a slot
    get_domain(...)       — 32-byte signature domain (fork version mixed
                            with the genesis validators root)
    fork_digest(...)      — 4-byte gossip topic digest

Domain/digest math follows the consensus spec compute_domain /
compute_fork_data_root (the reference delegates to @lodestar/state-
transition util/domain.ts for the same).
"""

from .chain_config import (  # noqa: F401
    ChainConfig,
    MAINNET_CHAIN_CONFIG,
    MINIMAL_CHAIN_CONFIG,
    create_chain_config,
)
