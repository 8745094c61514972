"""The signature-set model, a copy of `lodestar_tpu/bls/signature_set.py`.

`SignatureSet` carries validator indices into the device pubkey table,
the hashed-to-G2 message and the decompressed signature as affine points
of the host ground truth (`crypto/`).  `WireSignatureSet` is what crosses
the host boundary: indices, the 32-byte signing root and the 96-byte
compressed signature; the verifier hashes and decompresses it on the
device, and `decode()` does both on the host.
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
    never verifies.  `external_pubkeys` holds affine G1 keys of signers
    outside the validator registry (BLSToExecutionChange withdrawal
    keys); such sets verify on the host, which KeyValidates them."""

    type: SignatureSetType
    indices: Tuple[int, ...]
    message: Tuple  # affine G2: hash_to_g2(signing_root)
    signature: Affine
    external_pubkeys: Optional[Tuple] = None

    @staticmethod
    def single(index: int, message, signature) -> "SignatureSet":
        return SignatureSet(SignatureSetType.single, (index,), message, signature)

    @staticmethod
    def aggregate(indices: Sequence[int], message, signature) -> "SignatureSet":
        return SignatureSet(SignatureSetType.aggregate, tuple(indices), message, signature)


@dataclass(frozen=True)
class WireSignatureSet:
    """A signature set as it arrives: validator indices (or, for signers
    outside the registry, 48-byte compressed `pubkeys`), the 32-byte
    signing root and the 96-byte compressed signature."""

    type: SignatureSetType
    indices: Tuple[int, ...]
    signing_root: bytes
    signature: bytes
    pubkeys: Optional[Tuple[bytes, ...]] = None

    @staticmethod
    def single(index: int, signing_root: bytes, signature: bytes) -> "WireSignatureSet":
        return WireSignatureSet(SignatureSetType.single, (index,), bytes(signing_root), bytes(signature))

    @staticmethod
    def aggregate(indices: Sequence[int], signing_root: bytes, signature: bytes) -> "WireSignatureSet":
        return WireSignatureSet(
            SignatureSetType.aggregate, tuple(indices), bytes(signing_root), bytes(signature)
        )

    @staticmethod
    def external(pubkeys: Sequence[bytes], signing_root: bytes, signature: bytes) -> "WireSignatureSet":
        """A set whose keys are not validator-registry members."""
        return WireSignatureSet(
            SignatureSetType.aggregate,
            (),
            bytes(signing_root),
            bytes(signature),
            tuple(bytes(p) for p in pubkeys),
        )

    def dedupe_key(self) -> Tuple[bytes, Tuple[int, ...], bytes]:
        """The exact identity of the statement: (signing root, indices,
        signature bytes).  Signing is deterministic, so two wire sets with
        equal keys are the same message and one verdict serves both."""
        return (self.signing_root, self.indices, self.signature)

    def decode(self) -> SignatureSet:
        """Host ingest: hash-to-G2 and signature (and external pubkey)
        decompression.  Undecodable bytes give a set that verifies False
        (signature None)."""
        from ..crypto.curves import g1_decompress, g2_decompress
        from ..crypto.hash_to_curve import hash_to_g2

        try:
            sig = g2_decompress(self.signature)
        except ValueError:
            sig = None
        ext = None
        if self.pubkeys is not None:
            try:
                ext = tuple(g1_decompress(p) for p in self.pubkeys)
                if any(p is None for p in ext):  # an infinity pubkey
                    ext, sig = None, None
            except ValueError:
                ext, sig = None, None
        return SignatureSet(self.type, self.indices, hash_to_g2(self.signing_root), sig, ext)
