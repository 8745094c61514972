"""Per-fork SSZ type definitions — the types layer of the port, a copy of
`lodestar_tpu/types/__init__.py` (phase0 to deneb, the blinded and the
builder containers) over the port's own `ssz` types.

Mirror of the reference's `@lodestar/types` (reference:
packages/types/src/phase0/sszTypes.ts, types/src/altair/sszTypes.ts,
types/src/sszTypes.ts for the per-fork `ssz.*` namespaces).  The subset
defined here is everything on the signature path: attestations, blocks
(phase0 + altair), slashings, exits, sync aggregates — enough to extract
and verify every block/gossip signature the reference's
getBlockSignatureSets covers (state-transition/src/signatureSets/).
"""

from types import SimpleNamespace

from .. import params
from ..ssz import (
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Vector,
    uint64,
    uint256,
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

# Per-fork namespaces (the reference's `ssz.phase0`, `ssz.altair`)
ssz = SimpleNamespace(
    phase0=SimpleNamespace(
        Checkpoint=Checkpoint,
        AttestationData=AttestationData,
        Attestation=Attestation,
        IndexedAttestation=IndexedAttestation,
        AggregateAndProof=AggregateAndProof,
        SignedAggregateAndProof=SignedAggregateAndProof,
        BeaconBlockHeader=BeaconBlockHeader,
        SignedBeaconBlockHeader=SignedBeaconBlockHeader,
        ProposerSlashing=ProposerSlashing,
        AttesterSlashing=AttesterSlashing,
        VoluntaryExit=VoluntaryExit,
        SignedVoluntaryExit=SignedVoluntaryExit,
        BeaconBlock=BeaconBlock,
        SignedBeaconBlock=SignedBeaconBlock,
        BeaconBlockBody=BeaconBlockBody,
        Eth1Data=Eth1Data,
    ),
    altair=SimpleNamespace(
        SyncAggregate=SyncAggregate,
        SyncCommittee=SyncCommittee,
        SyncCommitteeMessage=SyncCommitteeMessage,
        SyncCommitteeContribution=SyncCommitteeContribution,
        ContributionAndProof=ContributionAndProof,
        SignedContributionAndProof=SignedContributionAndProof,
        BeaconBlock=BeaconBlockAltair,
        SignedBeaconBlock=SignedBeaconBlockAltair,
        BeaconBlockBody=BeaconBlockBodyAltair,
    ),
    Epoch=Epoch,
    Slot=Slot,
    Root=Root,
)


# -- bellatrix execution payload (reference: types/src/bellatrix/
# sszTypes.ts; consumed by the execution engine layer — the bellatrix
# state transition lands on top of these) -----------------------------------

Transaction = ByteList(1_073_741_824)  # MAX_BYTES_PER_TRANSACTION
_payload_header_fields = (
    ("parent_hash", Bytes32),
    ("fee_recipient", ByteVector(20)),
    ("state_root", Bytes32),
    ("receipts_root", Bytes32),
    ("logs_bloom", ByteVector(256)),
    ("prev_randao", Bytes32),
    ("block_number", uint64),
    ("gas_limit", uint64),
    ("gas_used", uint64),
    ("timestamp", uint64),
    ("extra_data", ByteList(32)),
    ("base_fee_per_gas", uint256),
)

ExecutionPayload = Container(
    _payload_header_fields
    + (
        ("block_hash", Bytes32),
        ("transactions", List(Transaction, 1_048_576)),
    ),
    name="ExecutionPayload",
)

ExecutionPayloadHeader = Container(
    _payload_header_fields
    + (
        ("block_hash", Bytes32),
        ("transactions_root", Bytes32),
    ),
    name="ExecutionPayloadHeader",
)


BeaconBlockBodyBellatrix = Container(
    _phase0_body_fields
    + (
        ("sync_aggregate", SyncAggregate),
        ("execution_payload", ExecutionPayload),
    ),
    name="BeaconBlockBodyBellatrix",
)

BeaconBlockBellatrix, SignedBeaconBlockBellatrix = _block_types(
    BeaconBlockBodyBellatrix, "Bellatrix"
)


# -- capella / deneb type layer (reference: types/src/{capella,deneb}/
# sszTypes.ts) — the containers the later forks add; their STF variants
# are future work (withdrawals + blobs are off the BLS path, BASELINE) --

Withdrawal = Container(
    (
        ("index", uint64),
        ("validator_index", ValidatorIndex),
        ("address", ByteVector(20)),
        ("amount", Gwei),
    ),
    name="Withdrawal",
)

MAX_WITHDRAWALS_PER_PAYLOAD = P.MAX_WITHDRAWALS_PER_PAYLOAD

ExecutionPayloadCapella = Container(
    _payload_header_fields
    + (
        ("block_hash", Bytes32),
        ("transactions", List(Transaction, 1_048_576)),
        ("withdrawals", List(Withdrawal, MAX_WITHDRAWALS_PER_PAYLOAD)),
    ),
    name="ExecutionPayloadCapella",
)

ExecutionPayloadHeaderCapella = Container(
    _payload_header_fields
    + (
        ("block_hash", Bytes32),
        ("transactions_root", Bytes32),
        ("withdrawals_root", Bytes32),
    ),
    name="ExecutionPayloadHeaderCapella",
)

BeaconBlockBodyCapella = Container(
    _phase0_body_fields
    + (
        ("sync_aggregate", SyncAggregate),
        ("execution_payload", ExecutionPayloadCapella),
        (
            "bls_to_execution_changes",
            List(SignedBLSToExecutionChange, 16),
        ),
    ),
    name="BeaconBlockBodyCapella",
)

BeaconBlockCapella, SignedBeaconBlockCapella = _block_types(
    BeaconBlockBodyCapella, "Capella"
)

# capella replaces the historical-roots accumulator entries
# (reference: types/src/capella/sszTypes.ts HistoricalSummary)
HistoricalSummary = Container(
    (
        ("block_summary_root", Bytes32),
        ("state_summary_root", Bytes32),
    ),
    name="HistoricalSummary",
)

# deneb: blob KZG commitments ride the block body (KZG verification is
# out of scope per BASELINE; the type layer carries the commitments).
# Spec field order appends blob_gas_used/excess_blob_gas AFTER the
# capella fields (consensus-specs deneb/beacon-chain.md ExecutionPayload).
KZGCommitment = Bytes48
MAX_BLOB_COMMITMENTS_PER_BLOCK = 4096

ExecutionPayloadDeneb = Container(
    _payload_header_fields
    + (
        ("block_hash", Bytes32),
        ("transactions", List(Transaction, 1_048_576)),
        ("withdrawals", List(Withdrawal, MAX_WITHDRAWALS_PER_PAYLOAD)),
        ("blob_gas_used", uint64),
        ("excess_blob_gas", uint64),
    ),
    name="ExecutionPayloadDeneb",
)

ExecutionPayloadHeaderDeneb = Container(
    _payload_header_fields
    + (
        ("block_hash", Bytes32),
        ("transactions_root", Bytes32),
        ("withdrawals_root", Bytes32),
        ("blob_gas_used", uint64),
        ("excess_blob_gas", uint64),
    ),
    name="ExecutionPayloadHeaderDeneb",
)

BeaconBlockBodyDeneb = Container(
    _phase0_body_fields
    + (
        ("sync_aggregate", SyncAggregate),
        ("execution_payload", ExecutionPayloadDeneb),
        (
            "bls_to_execution_changes",
            List(SignedBLSToExecutionChange, 16),
        ),
        (
            "blob_kzg_commitments",
            List(KZGCommitment, MAX_BLOB_COMMITMENTS_PER_BLOCK),
        ),
    ),
    name="BeaconBlockBodyDeneb",
)

BeaconBlockDeneb, SignedBeaconBlockDeneb = _block_types(
    BeaconBlockBodyDeneb, "Deneb"
)

# -- blinded blocks + builder wire types (MEV flow) -------------------------
# reference: types/src/{bellatrix,capella,deneb}/sszTypes.ts
# BlindedBeaconBlockBody (execution_payload -> executionPayloadHeader;
# hash_tree_root is IDENTICAL to the full block's because the payload
# header's root equals the payload's root) and builder/registration
# containers (bellatrix/sszTypes.ts ValidatorRegistrationV1, BuilderBid).

BlindedBeaconBlockBodyBellatrix = Container(
    _phase0_body_fields
    + (
        ("sync_aggregate", SyncAggregate),
        ("execution_payload_header", ExecutionPayloadHeader),
    ),
    name="BlindedBeaconBlockBodyBellatrix",
)
BlindedBeaconBlockBellatrix, SignedBlindedBeaconBlockBellatrix = (
    _block_types(BlindedBeaconBlockBodyBellatrix, "BlindedBellatrix")
)

BlindedBeaconBlockBodyCapella = Container(
    _phase0_body_fields
    + (
        ("sync_aggregate", SyncAggregate),
        ("execution_payload_header", ExecutionPayloadHeaderCapella),
        (
            "bls_to_execution_changes",
            List(SignedBLSToExecutionChange, 16),
        ),
    ),
    name="BlindedBeaconBlockBodyCapella",
)
BlindedBeaconBlockCapella, SignedBlindedBeaconBlockCapella = _block_types(
    BlindedBeaconBlockBodyCapella, "BlindedCapella"
)

BlindedBeaconBlockBodyDeneb = Container(
    _phase0_body_fields
    + (
        ("sync_aggregate", SyncAggregate),
        ("execution_payload_header", ExecutionPayloadHeaderDeneb),
        (
            "bls_to_execution_changes",
            List(SignedBLSToExecutionChange, 16),
        ),
        (
            "blob_kzg_commitments",
            List(KZGCommitment, MAX_BLOB_COMMITMENTS_PER_BLOCK),
        ),
    ),
    name="BlindedBeaconBlockBodyDeneb",
)
BlindedBeaconBlockDeneb, SignedBlindedBeaconBlockDeneb = _block_types(
    BlindedBeaconBlockBodyDeneb, "BlindedDeneb"
)

ValidatorRegistrationV1 = Container(
    (
        ("fee_recipient", ByteVector(20)),
        ("gas_limit", uint64),
        ("timestamp", uint64),
        ("pubkey", BLSPubkey),
    ),
    name="ValidatorRegistrationV1",
)

SignedValidatorRegistrationV1 = Container(
    (
        ("message", ValidatorRegistrationV1),
        ("signature", BLSSignature),
    ),
    name="SignedValidatorRegistrationV1",
)


def builder_bid_types(header_type):
    """BuilderBid/SignedBuilderBid over a fork's payload-header type
    (reference: builder bids are fork-parameterized)."""
    bid = Container(
        (
            ("header", header_type),
            ("value", uint256),
            ("pubkey", BLSPubkey),
        ),
        name="BuilderBid",
    )
    signed = Container(
        (("message", bid), ("signature", BLSSignature)),
        name="SignedBuilderBid",
    )
    return bid, signed


BuilderBidBellatrix, SignedBuilderBidBellatrix = builder_bid_types(
    ExecutionPayloadHeader
)
BuilderBidCapella, SignedBuilderBidCapella = builder_bid_types(
    ExecutionPayloadHeaderCapella
)
BuilderBidDeneb, SignedBuilderBidDeneb = builder_bid_types(
    ExecutionPayloadHeaderDeneb
)


# Per-fork namespaces for the later forks (reference: types/src/sszTypes.ts
# `ssz.bellatrix` / `ssz.capella` / `ssz.deneb`)
ssz.bellatrix = SimpleNamespace(
    ExecutionPayload=ExecutionPayload,
    ExecutionPayloadHeader=ExecutionPayloadHeader,
    BeaconBlock=BeaconBlockBellatrix,
    SignedBeaconBlock=SignedBeaconBlockBellatrix,
    BeaconBlockBody=BeaconBlockBodyBellatrix,
    BlindedBeaconBlock=BlindedBeaconBlockBellatrix,
    SignedBlindedBeaconBlock=SignedBlindedBeaconBlockBellatrix,
    ValidatorRegistrationV1=ValidatorRegistrationV1,
    SignedValidatorRegistrationV1=SignedValidatorRegistrationV1,
    BuilderBid=BuilderBidBellatrix,
    SignedBuilderBid=SignedBuilderBidBellatrix,
)
ssz.capella = SimpleNamespace(
    Withdrawal=Withdrawal,
    HistoricalSummary=HistoricalSummary,
    BLSToExecutionChange=BLSToExecutionChange,
    SignedBLSToExecutionChange=SignedBLSToExecutionChange,
    ExecutionPayload=ExecutionPayloadCapella,
    ExecutionPayloadHeader=ExecutionPayloadHeaderCapella,
    BeaconBlock=BeaconBlockCapella,
    SignedBeaconBlock=SignedBeaconBlockCapella,
    BeaconBlockBody=BeaconBlockBodyCapella,
    BlindedBeaconBlock=BlindedBeaconBlockCapella,
    SignedBlindedBeaconBlock=SignedBlindedBeaconBlockCapella,
    BuilderBid=BuilderBidCapella,
    SignedBuilderBid=SignedBuilderBidCapella,
)
ssz.deneb = SimpleNamespace(
    KZGCommitment=KZGCommitment,
    ExecutionPayload=ExecutionPayloadDeneb,
    ExecutionPayloadHeader=ExecutionPayloadHeaderDeneb,
    BeaconBlock=BeaconBlockDeneb,
    SignedBeaconBlock=SignedBeaconBlockDeneb,
    BeaconBlockBody=BeaconBlockBodyDeneb,
    BlindedBeaconBlock=BlindedBeaconBlockDeneb,
    SignedBlindedBeaconBlock=SignedBlindedBeaconBlockDeneb,
    BuilderBid=BuilderBidDeneb,
    SignedBuilderBid=SignedBuilderBidDeneb,
)

# deneb blob sidecars (reference carried the earlier
# BeaconBlockAndBlobsSidecar shape, types/src/deneb/sszTypes.ts; this is
# the per-blob sidecar that shipped on mainnet deneb)
Blob = ByteVector(32 * P.FIELD_ELEMENTS_PER_BLOB)
KZGProof = Bytes48
KZG_COMMITMENT_INCLUSION_PROOF_DEPTH = 17

BlobSidecar = Container(
    (
        ("index", uint64),
        ("blob", Blob),
        ("kzg_commitment", KZGCommitment),
        ("kzg_proof", KZGProof),
        ("signed_block_header", SignedBeaconBlockHeader),
        (
            "kzg_commitment_inclusion_proof",
            Vector(Bytes32, KZG_COMMITMENT_INCLUSION_PROOF_DEPTH),
        ),
    ),
    name="BlobSidecar",
)
ssz.deneb.Blob = Blob
ssz.deneb.BlobSidecar = BlobSidecar
