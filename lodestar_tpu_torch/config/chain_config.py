"""ChainConfig — runtime fork schedule + domain computation.

The port's copy of `lodestar_tpu/config/chain_config.py`; it imports nothing of the
JAX package.

Reference: packages/config/src/chainConfig/ (fork versions/epochs per
network), config/src/forkConfig/index.ts (getForkInfo/getForkName),
config/src/genesisConfig/ (cached domains per fork).  Domain bytes follow
the consensus spec: compute_fork_data_root(version, genesis_validators_
root)[:28] appended to the 4-byte domain type.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .. import params
from ..params import ForkName
from ..ssz import Bytes4, Bytes32, Container

# ForkData (consensus spec) for fork-data-root computation
ForkDataType = Container(
    (
        ("current_version", Bytes4),
        ("genesis_validators_root", Bytes32),
    ),
    name="ForkData",
)

SigningDataType = Container(
    (
        ("object_root", Bytes32),
        ("domain", Bytes32),
    ),
    name="SigningData",
)


@dataclass
class ChainConfig:
    """Fork schedule + genesis info for one chain."""

    config_name: str
    genesis_validators_root: bytes = b"\x00" * 32
    genesis_time: int = 0
    # version/epoch per fork, in FORK_ORDER
    fork_versions: Dict[ForkName, bytes] = field(default_factory=dict)
    fork_epochs: Dict[ForkName, int] = field(default_factory=dict)
    # Runtime (non-preset) spec values — reference keeps these in
    # chainConfig/presets/{mainnet,minimal}.ts rather than the preset.
    MIN_VALIDATOR_WITHDRAWABILITY_DELAY: int = 256
    SHARD_COMMITTEE_PERIOD: int = 256
    INACTIVITY_SCORE_BIAS: int = 4
    INACTIVITY_SCORE_RECOVERY_RATE: int = 16
    MIN_PER_EPOCH_CHURN_LIMIT: int = 4
    CHURN_LIMIT_QUOTIENT: int = 65536
    # the eth1 deposit contract (reference: chainConfig DEPOSIT_CHAIN_ID
    # / DEPOSIT_CONTRACT_ADDRESS; served by /eth/v1/config/
    # deposit_contract).  Mainnet values by default.
    DEPOSIT_CHAIN_ID: int = 1
    DEPOSIT_CONTRACT_ADDRESS: str = (
        "0x00000000219ab540356cbb839cbe05303d7705fa"
    )

    def __post_init__(self):
        self._domain_cache: Dict[Tuple[bytes, bytes], bytes] = {}

    # -- fork schedule (reference: forkConfig/index.ts) --------------------

    def fork_schedule(self) -> List[ForkName]:
        return [
            f
            for f in params.FORK_ORDER
            if self.fork_epochs.get(f, params.FAR_FUTURE_EPOCH)
            != params.FAR_FUTURE_EPOCH
        ]

    def get_fork_name(self, slot: int) -> ForkName:
        epoch = max(slot, 0) // params.SLOTS_PER_EPOCH
        active = ForkName.phase0
        for f in params.FORK_ORDER:
            if self.fork_epochs.get(f, params.FAR_FUTURE_EPOCH) <= epoch:
                active = f
        return active

    def get_fork_types(self, slot: int):
        """(block, signed_block, body) SSZ containers for the fork at
        `slot` (reference: config.getForkTypes — the ONE fork->type
        dispatch every serializer/signer/hasher must use)."""
        from .. import types as T

        name = self.get_fork_name(slot)
        if name == ForkName.phase0:
            return T.BeaconBlock, T.SignedBeaconBlock, T.BeaconBlockBody
        if name == ForkName.altair:
            return (
                T.BeaconBlockAltair,
                T.SignedBeaconBlockAltair,
                T.BeaconBlockBodyAltair,
            )
        if name == ForkName.bellatrix:
            return (
                T.BeaconBlockBellatrix,
                T.SignedBeaconBlockBellatrix,
                T.BeaconBlockBodyBellatrix,
            )
        if name == ForkName.capella:
            return (
                T.BeaconBlockCapella,
                T.SignedBeaconBlockCapella,
                T.BeaconBlockBodyCapella,
            )
        return (
            T.BeaconBlockDeneb,
            T.SignedBeaconBlockDeneb,
            T.BeaconBlockBodyDeneb,
        )

    def get_blinded_fork_types(self, slot: int):
        """(blinded_block, signed_blinded_block, blinded_body) for the
        fork at `slot` (reference: config.getBlindedForkTypes).  Blinded
        containers exist from bellatrix on."""
        from .. import types as T

        name = self.get_fork_name(slot)
        if name in (ForkName.phase0, ForkName.altair):
            raise ValueError(f"no blinded containers before bellatrix ({name})")
        if name == ForkName.bellatrix:
            return (
                T.BlindedBeaconBlockBellatrix,
                T.SignedBlindedBeaconBlockBellatrix,
                T.BlindedBeaconBlockBodyBellatrix,
            )
        if name == ForkName.capella:
            return (
                T.BlindedBeaconBlockCapella,
                T.SignedBlindedBeaconBlockCapella,
                T.BlindedBeaconBlockBodyCapella,
            )
        return (
            T.BlindedBeaconBlockDeneb,
            T.SignedBlindedBeaconBlockDeneb,
            T.BlindedBeaconBlockBodyDeneb,
        )

    def get_fork_seq(self, slot: int) -> int:
        return params.FORK_SEQ[self.get_fork_name(slot)]

    def get_fork_version(self, slot: int) -> bytes:
        return self.fork_versions[self.get_fork_name(slot)]

    # -- domains (consensus spec compute_domain) ---------------------------

    def fork_data_root(self, version: bytes, genesis_validators_root=None) -> bytes:
        gvr = (
            self.genesis_validators_root
            if genesis_validators_root is None
            else genesis_validators_root
        )
        return ForkDataType.hash_tree_root(
            {"current_version": version, "genesis_validators_root": gvr}
        )

    def fork_digest(self, slot: int) -> bytes:
        """4-byte gossip fork digest (reference: forkConfig getForkDigest)."""
        return self.fork_data_root(self.get_fork_version(slot))[:4]

    def get_domain(
        self, state_slot: int, domain_type: bytes, message_slot: int = None
    ) -> bytes:
        """Domain at the fork active at `message_slot` (defaults to
        state_slot) — signature domains use the message's fork, matching
        the reference's config.getDomain(stateSlot, domainType, slot)."""
        slot = state_slot if message_slot is None else message_slot
        version = self.get_fork_version(slot)
        key = (domain_type, version)
        d = self._domain_cache.get(key)
        if d is None:
            d = domain_type + self.fork_data_root(version)[:28]
            self._domain_cache[key] = d
        return d

    def compute_domain(
        self,
        domain_type: bytes,
        fork_version: bytes,
        genesis_validators_root: bytes = None,
    ) -> bytes:
        """Domain pinned to an explicit fork version (spec compute_domain;
        used by fork-agnostic signatures: deposits, BLS-to-execution
        changes, and post-EIP-7044 voluntary exits)."""
        return (
            domain_type
            + self.fork_data_root(fork_version, genesis_validators_root)[:28]
        )

    def compute_signing_root(self, object_root: bytes, domain: bytes) -> bytes:
        """hash_tree_root(SigningData(object_root, domain)) — the 32-byte
        message every BLS signature in the protocol actually signs."""
        return SigningDataType.hash_tree_root(
            {"object_root": object_root, "domain": domain}
        )


MAINNET_CHAIN_CONFIG = ChainConfig(
    config_name="mainnet",
    genesis_validators_root=bytes.fromhex(
        "4b363db94e286120d76eb905340fdd4e54bfe9f06bf33ff6cf5ad27f511bfe95"
    ),
    genesis_time=1606824023,
    fork_versions={
        ForkName.phase0: bytes.fromhex("00000000"),
        ForkName.altair: bytes.fromhex("01000000"),
        ForkName.bellatrix: bytes.fromhex("02000000"),
        ForkName.capella: bytes.fromhex("03000000"),
        ForkName.deneb: bytes.fromhex("04000000"),
    },
    fork_epochs={
        ForkName.phase0: 0,
        ForkName.altair: 74240,
        ForkName.bellatrix: 144896,
        ForkName.capella: 194048,
        ForkName.deneb: params.FAR_FUTURE_EPOCH,
    },
)

MINIMAL_CHAIN_CONFIG = ChainConfig(
    config_name="minimal",
    SHARD_COMMITTEE_PERIOD=64,
    CHURN_LIMIT_QUOTIENT=32,
    fork_versions={
        ForkName.phase0: bytes.fromhex("00000001"),
        ForkName.altair: bytes.fromhex("01000001"),
        ForkName.bellatrix: bytes.fromhex("02000001"),
        ForkName.capella: bytes.fromhex("03000001"),
        ForkName.deneb: bytes.fromhex("04000001"),
    },
    fork_epochs={
        ForkName.phase0: 0,
        ForkName.altair: 0,
        ForkName.bellatrix: params.FAR_FUTURE_EPOCH,
        ForkName.capella: params.FAR_FUTURE_EPOCH,
        ForkName.deneb: params.FAR_FUTURE_EPOCH,
    },
)


def create_chain_config(
    base: ChainConfig,
    genesis_validators_root: bytes = None,
    genesis_time: int = None,
    fork_epochs: Dict[ForkName, int] = None,
) -> ChainConfig:
    """Derive a config (the reference's createBeaconConfig: chain config +
    genesis validators root -> cached domains)."""
    import dataclasses

    return dataclasses.replace(
        base,
        genesis_validators_root=(
            base.genesis_validators_root
            if genesis_validators_root is None
            else genesis_validators_root
        ),
        genesis_time=base.genesis_time if genesis_time is None else genesis_time,
        fork_versions=dict(base.fork_versions),
        fork_epochs={**base.fork_epochs, **(fork_epochs or {})},
    )
