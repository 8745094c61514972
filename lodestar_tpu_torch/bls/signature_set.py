"""The signature-set model, a copy of `lodestar_tpu/bls/signature_set.py`
(`SignatureSet` with its `single` and `aggregate` constructors).

A set carries validator indices into the device pubkey table, the
hashed-to-G2 message and the decompressed signature as affine points of
the host ground truth (`crypto/`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

Affine = Optional[Tuple]  # ground-truth affine point or None (infinity)


class SignatureSetType(enum.Enum):
    single = "single"
    aggregate = "aggregate"


@dataclass(frozen=True)
class SignatureSet:
    """One verifiable (pubkey(s), message, signature) statement.

    type=single:    one validator index, one signing root.
    type=aggregate: several validator indices whose keys are added before
                    the pairing.
    `signature` is None for an undecodable or infinity signature, which
    never verifies."""

    type: SignatureSetType
    indices: Tuple[int, ...]
    message: Tuple  # affine G2: hash_to_g2(signing_root)
    signature: Affine

    @staticmethod
    def single(index: int, message, signature) -> "SignatureSet":
        return SignatureSet(SignatureSetType.single, (index,), message, signature)

    @staticmethod
    def aggregate(indices: Sequence[int], message, signature) -> "SignatureSet":
        return SignatureSet(SignatureSetType.aggregate, tuple(indices), message, signature)
