"""Lightclient — update validation + header tracking.

The port's copy of `lodestar_tpu/light_client/lightclient.py`; it imports nothing of the
JAX package.

Reference: packages/light-client/src/index.ts (processOptimisticUpdate /
processFinalizedUpdate flow) and light-client/src/validation.ts
(assertValidLightClientUpdate: participation, signature, next-committee
handling).  Signature verification runs through the framework's BLS
stack (CPU oracle here; the same sets route to the TPU verifier when a
device is attached).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .. import params
from ..config.chain_config import ChainConfig
from ..crypto import bls as B
from ..crypto import curves as C
from ..crypto import pairing as P
from ..crypto.hash_to_curve import hash_to_g2
from ..ssz import is_valid_merkle_branch
from ..types import BeaconBlockHeader, SyncCommittee


class ValidationError(Exception):
    pass


# Generalized index of next_sync_committee in the altair BeaconState:
# gindex 55 = 2**5 + 23 (spec NEXT_SYNC_COMMITTEE_INDEX)
NEXT_SYNC_COMMITTEE_DEPTH = 5
NEXT_SYNC_COMMITTEE_INDEX = 23
# Generalized index of finalized_checkpoint.root: gindex 105 = 2**6 + 41
FINALIZED_ROOT_DEPTH = 6
FINALIZED_ROOT_INDEX = 41


@dataclass
class LightClientUpdate:
    """The subset of the spec's LightClientUpdate the client consumes.

    `next_sync_committee` is a full SyncCommittee value ({pubkeys,
    aggregate_pubkey}) accompanied by its merkle branch against the
    attested header's state root — installing a committee requires the
    cryptographic binding, not just a signed header.
    """

    attested_header: dict  # BeaconBlockHeader value
    sync_committee_bits: List[bool]
    sync_committee_signature: bytes  # 96B compressed
    signature_slot: int
    finalized_header: Optional[dict] = None
    finality_branch: Optional[List[bytes]] = None
    next_sync_committee: Optional[dict] = None  # SyncCommittee value
    next_sync_committee_branch: Optional[List[bytes]] = None


def sync_period(slot: int) -> int:
    return slot // (
        params.SLOTS_PER_EPOCH * params.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
    )


class Lightclient:
    """Tracks optimistic + finalized headers from a trusted bootstrap."""

    MIN_PARTICIPATION = 2 / 3  # spec MIN_SYNC_COMMITTEE_PARTICIPANTS bound

    def __init__(
        self,
        config: ChainConfig,
        bootstrap_header: dict,
        current_sync_committee: Sequence[bytes],
    ):
        self.config = config
        self.optimistic_header = dict(bootstrap_header)
        self.finalized_header = dict(bootstrap_header)
        self.committees = {
            sync_period(bootstrap_header["slot"]): [
                C.g1_decompress(pk) for pk in current_sync_committee
            ]
        }

    # -- validation (reference: validation.ts assertValidLightClientUpdate)

    def validate_update(self, update: LightClientUpdate) -> None:
        bits = update.sync_committee_bits
        n_participants = sum(bits)
        if n_participants < len(bits) * self.MIN_PARTICIPATION:
            raise ValidationError(
                f"insufficient participation {n_participants}/{len(bits)}"
            )
        period = sync_period(update.signature_slot)
        committee = self.committees.get(period)
        if committee is None:
            raise ValidationError(f"no sync committee for period {period}")
        if len(bits) != len(committee):
            raise ValidationError("bits length != committee size")
        participants = [pk for pk, b in zip(committee, bits) if b]

        root = self.config.compute_signing_root(
            BeaconBlockHeader.hash_tree_root(update.attested_header),
            self.config.get_domain(
                update.signature_slot,
                params.DOMAIN_SYNC_COMMITTEE,
                max(update.signature_slot, 1) - 1,
            ),
        )
        try:
            sig = C.g2_decompress(update.sync_committee_signature)
        except ValueError:
            raise ValidationError("undecodable sync committee signature")
        if sig is None or not C.g2_subgroup_check(sig):
            raise ValidationError("invalid sync committee signature point")
        agg = B.aggregate_pubkeys(participants)
        if not P.multi_pairing_is_one(
            [(agg, hash_to_g2(root)), (B.NEG_G1_GEN, sig)]
        ):
            raise ValidationError("sync committee signature does not verify")

    # -- processing (reference: index.ts processOptimistic/FinalizedUpdate)

    def process_update(self, update: LightClientUpdate) -> None:
        self.validate_update(update)
        if update.next_sync_committee is not None:
            # a committee rotation MUST be merkle-bound to the signed
            # attested header's state root (reference:
            # validation.ts assertValidSyncCommitteeProof) — otherwise a
            # relayer could swap in an attacker committee
            if update.next_sync_committee_branch is None:
                raise ValidationError("next sync committee without branch")
            leaf = SyncCommittee.hash_tree_root(update.next_sync_committee)
            if not is_valid_merkle_branch(
                leaf,
                update.next_sync_committee_branch,
                NEXT_SYNC_COMMITTEE_DEPTH,
                NEXT_SYNC_COMMITTEE_INDEX,
                update.attested_header["state_root"],
            ):
                raise ValidationError("invalid next sync committee proof")
        if update.finalized_header is not None:
            # finality must be merkle-bound to the signed attested state
            # root too (reference: validation.ts finality_branch check)
            if update.finality_branch is None:
                raise ValidationError("finalized header without branch")
            leaf = BeaconBlockHeader.hash_tree_root(update.finalized_header)
            if not is_valid_merkle_branch(
                leaf,
                update.finality_branch,
                FINALIZED_ROOT_DEPTH,
                FINALIZED_ROOT_INDEX,
                update.attested_header["state_root"],
            ):
                raise ValidationError("invalid finality proof")
        if update.attested_header["slot"] > self.optimistic_header["slot"]:
            self.optimistic_header = dict(update.attested_header)
        if (
            update.finalized_header is not None
            and update.finalized_header["slot"] > self.finalized_header["slot"]
        ):
            self.finalized_header = dict(update.finalized_header)
        if update.next_sync_committee is not None:
            next_period = sync_period(update.attested_header["slot"]) + 1
            self.committees.setdefault(
                next_period,
                [
                    C.g1_decompress(pk)
                    for pk in update.next_sync_committee["pubkeys"]
                ],
            )
