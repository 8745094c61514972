"""Per-fork SSZ type definitions — the types layer of the port, a copy of
`lodestar_tpu/types/__init__.py`'s phase0 and altair containers (through
`SignedBLSToExecutionChange`) over the port's own `ssz` types; the later
forks' containers are not ported yet.

Mirror of the reference's `@lodestar/types` (reference:
packages/types/src/phase0/sszTypes.ts, types/src/altair/sszTypes.ts,
types/src/sszTypes.ts for the per-fork `ssz.*` namespaces).  The subset
defined here is everything on the signature path: attestations, blocks
(phase0 + altair), slashings, exits, sync aggregates — enough to extract
and verify every block/gossip signature the reference's
getBlockSignatureSets covers (state-transition/src/signatureSets/).
"""

from .. import params
from ..ssz import (
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    Bytes4,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Vector,
    uint64,
)

P = params.ACTIVE_PRESET

# -- primitives (reference: types/src/primitive/sszTypes.ts) ----------------

Slot = uint64
Epoch = uint64
ValidatorIndex = uint64
CommitteeIndex = uint64
Gwei = uint64
Root = Bytes32
BLSPubkey = Bytes48
BLSSignature = Bytes96
Version = Bytes4

# -- phase0 (reference: types/src/phase0/sszTypes.ts) -----------------------

Checkpoint = Container(
    (("epoch", Epoch), ("root", Root)),
    name="Checkpoint",
)

Fork = Container(
    (
        ("previous_version", Version),
        ("current_version", Version),
        ("epoch", Epoch),
    ),
    name="Fork",
)

Validator = Container(
    (
        ("pubkey", BLSPubkey),
        ("withdrawal_credentials", Bytes32),
        ("effective_balance", Gwei),
        ("slashed", Boolean),
        ("activation_eligibility_epoch", Epoch),
        ("activation_epoch", Epoch),
        ("exit_epoch", Epoch),
        ("withdrawable_epoch", Epoch),
    ),
    name="Validator",
)

AttestationData = Container(
    (
        ("slot", Slot),
        ("index", CommitteeIndex),
        ("beacon_block_root", Root),
        ("source", Checkpoint),
        ("target", Checkpoint),
    ),
    name="AttestationData",
)

Attestation = Container(
    (
        ("aggregation_bits", Bitlist(P.MAX_VALIDATORS_PER_COMMITTEE)),
        ("data", AttestationData),
        ("signature", BLSSignature),
    ),
    name="Attestation",
)

IndexedAttestation = Container(
    (
        ("attesting_indices", List(ValidatorIndex, P.MAX_VALIDATORS_PER_COMMITTEE)),
        ("data", AttestationData),
        ("signature", BLSSignature),
    ),
    name="IndexedAttestation",
)

PendingAttestation = Container(
    (
        ("aggregation_bits", Bitlist(P.MAX_VALIDATORS_PER_COMMITTEE)),
        ("data", AttestationData),
        ("inclusion_delay", Slot),
        ("proposer_index", ValidatorIndex),
    ),
    name="PendingAttestation",
)

AggregateAndProof = Container(
    (
        ("aggregator_index", ValidatorIndex),
        ("aggregate", Attestation),
        ("selection_proof", BLSSignature),
    ),
    name="AggregateAndProof",
)

SignedAggregateAndProof = Container(
    (
        ("message", AggregateAndProof),
        ("signature", BLSSignature),
    ),
    name="SignedAggregateAndProof",
)

BeaconBlockHeader = Container(
    (
        ("slot", Slot),
        ("proposer_index", ValidatorIndex),
        ("parent_root", Root),
        ("state_root", Root),
        ("body_root", Root),
    ),
    name="BeaconBlockHeader",
)

SignedBeaconBlockHeader = Container(
    (
        ("message", BeaconBlockHeader),
        ("signature", BLSSignature),
    ),
    name="SignedBeaconBlockHeader",
)

ProposerSlashing = Container(
    (
        ("signed_header_1", SignedBeaconBlockHeader),
        ("signed_header_2", SignedBeaconBlockHeader),
    ),
    name="ProposerSlashing",
)

AttesterSlashing = Container(
    (
        ("attestation_1", IndexedAttestation),
        ("attestation_2", IndexedAttestation),
    ),
    name="AttesterSlashing",
)

DepositDataType = Container(
    (
        ("pubkey", BLSPubkey),
        ("withdrawal_credentials", Bytes32),
        ("amount", Gwei),
        ("signature", BLSSignature),
    ),
    name="DepositData",
)

DepositMessage = Container(
    (
        ("pubkey", BLSPubkey),
        ("withdrawal_credentials", Bytes32),
        ("amount", Gwei),
    ),
    name="DepositMessage",
)

Deposit = Container(
    (
        ("proof", Vector(Bytes32, params.DEPOSIT_CONTRACT_TREE_DEPTH + 1)),
        ("data", DepositDataType),
    ),
    name="Deposit",
)

VoluntaryExit = Container(
    (("epoch", Epoch), ("validator_index", ValidatorIndex)),
    name="VoluntaryExit",
)

SignedVoluntaryExit = Container(
    (("message", VoluntaryExit), ("signature", BLSSignature)),
    name="SignedVoluntaryExit",
)

HistoricalBatch = Container(
    (
        ("block_roots", Vector(Root, P.SLOTS_PER_HISTORICAL_ROOT)),
        ("state_roots", Vector(Root, P.SLOTS_PER_HISTORICAL_ROOT)),
    ),
    name="HistoricalBatch",
)

Eth1Data = Container(
    (
        ("deposit_root", Root),
        ("deposit_count", uint64),
        ("block_hash", Bytes32),
    ),
    name="Eth1Data",
)

_phase0_body_fields = (
    ("randao_reveal", BLSSignature),
    ("eth1_data", Eth1Data),
    ("graffiti", Bytes32),
    ("proposer_slashings", List(ProposerSlashing, P.MAX_PROPOSER_SLASHINGS)),
    ("attester_slashings", List(AttesterSlashing, P.MAX_ATTESTER_SLASHINGS)),
    ("attestations", List(Attestation, P.MAX_ATTESTATIONS)),
    ("deposits", List(Deposit, P.MAX_DEPOSITS)),
    ("voluntary_exits", List(SignedVoluntaryExit, P.MAX_VOLUNTARY_EXITS)),
)

BeaconBlockBody = Container(_phase0_body_fields, name="BeaconBlockBody")


def _block_types(body_type, suffix=""):
    block = Container(
        (
            ("slot", Slot),
            ("proposer_index", ValidatorIndex),
            ("parent_root", Root),
            ("state_root", Root),
            ("body", body_type),
        ),
        name=f"BeaconBlock{suffix}",
    )
    signed = Container(
        (("message", block), ("signature", BLSSignature)),
        name=f"SignedBeaconBlock{suffix}",
    )
    return block, signed


BeaconBlock, SignedBeaconBlock = _block_types(BeaconBlockBody)

# -- altair (reference: types/src/altair/sszTypes.ts) -----------------------

SyncAggregate = Container(
    (
        ("sync_committee_bits", Bitvector(P.SYNC_COMMITTEE_SIZE)),
        ("sync_committee_signature", BLSSignature),
    ),
    name="SyncAggregate",
)

SyncCommittee = Container(
    (
        ("pubkeys", Vector(BLSPubkey, P.SYNC_COMMITTEE_SIZE)),
        ("aggregate_pubkey", BLSPubkey),
    ),
    name="SyncCommittee",
)

SyncCommitteeMessage = Container(
    (
        ("slot", Slot),
        ("beacon_block_root", Root),
        ("validator_index", ValidatorIndex),
        ("signature", BLSSignature),
    ),
    name="SyncCommitteeMessage",
)

SyncCommitteeContribution = Container(
    (
        ("slot", Slot),
        ("beacon_block_root", Root),
        ("subcommittee_index", uint64),
        (
            "aggregation_bits",
            Bitvector(P.SYNC_COMMITTEE_SIZE // params.SYNC_COMMITTEE_SUBNET_COUNT),
        ),
        ("signature", BLSSignature),
    ),
    name="SyncCommitteeContribution",
)

SyncAggregatorSelectionData = Container(
    (
        ("slot", Slot),
        ("subcommittee_index", uint64),
    ),
    name="SyncAggregatorSelectionData",
)

ContributionAndProof = Container(
    (
        ("aggregator_index", ValidatorIndex),
        ("contribution", SyncCommitteeContribution),
        ("selection_proof", BLSSignature),
    ),
    name="ContributionAndProof",
)

SignedContributionAndProof = Container(
    (
        ("message", ContributionAndProof),
        ("signature", BLSSignature),
    ),
    name="SignedContributionAndProof",
)

BeaconBlockBodyAltair = Container(
    _phase0_body_fields + (("sync_aggregate", SyncAggregate),),
    name="BeaconBlockBodyAltair",
)

BeaconBlockAltair, SignedBeaconBlockAltair = _block_types(
    BeaconBlockBodyAltair, "Altair"
)

# BLSToExecutionChange (capella)
BLSToExecutionChange = Container(
    (
        ("validator_index", ValidatorIndex),
        ("from_bls_pubkey", BLSPubkey),
        ("to_execution_address", ByteList(20)),
    ),
    name="BLSToExecutionChange",
)

SignedBLSToExecutionChange = Container(
    (
        ("message", BLSToExecutionChange),
        ("signature", BLSSignature),
    ),
    name="SignedBLSToExecutionChange",
)
