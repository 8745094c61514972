"""KZG polynomial commitments for deneb blobs (EIP-4844).

The port's copy of `lodestar_tpu/crypto/kzg.py`; it imports nothing of the
JAX package.

Replaces the reference's `c-kzg` native dependency (reference:
packages/beacon-node/src/util/kzg.ts loads the c-kzg-4844 trusted setup
and exposes verifyBlobKzgProofBatch / blobToKzgCommitment).  The
algorithms follow the deneb polynomial-commitments spec: blobs are
polynomials in EVALUATION form over the bit-reversed roots-of-unity
domain; commitments/proofs are G1 MSMs over a Lagrange-form trusted
setup; verification is two pairings.

The production ceremony file cannot be fetched in this sealed
environment, so the module ships `insecure_dev_setup(n)` — a setup with
a KNOWN tau derived from a fixed seed.  It is cryptographically
USELESS for production (anyone knowing tau can forge proofs) but
byte-compatible in shape, which is exactly what dev networks and tests
need; dropping in the real `trusted_setup.json` points works unchanged
via `TrustedSetup.from_points`.

The MSM here runs on the CPU oracle (correctness path), as in the JAX
package; at mainnet blob scale it is the gather + randomizer +
jacobian-sum work the port's BLS kernels (`agg_pk`, `seg_sum_g1`) do on
the card, which is where blobs would go once their throughput matters.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from . import bls as B
from . import curves as C
from . import fields as F
from . import pairing as P

R = F.R  # the BLS12-381 scalar field modulus (Fr)

BYTES_PER_FIELD_ELEMENT = 32
# The full mainnet blob width is 4096; tests/dev nets use small widths
# (the consensus minimal preset also shrinks it).
FIELD_ELEMENTS_PER_BLOB = 4096

# 7 is a primitive root mod r; r - 1 = 2^32 * odd, so 2^i-th roots of
# unity exist for i <= 32
_PRIMITIVE_ROOT = 7
_TWO_ADICITY = 32

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_DOMAIN = b"RCKZGBATCH___V1_"


class KzgError(ValueError):
    pass


def _inv(a: int) -> int:
    return pow(a, R - 2, R)


def compute_roots_of_unity(n: int) -> List[int]:
    """The n-th roots of unity in Fr, n a power of two <= 2^32."""
    assert n & (n - 1) == 0 and n <= (1 << _TWO_ADICITY)
    w = pow(_PRIMITIVE_ROOT, (R - 1) // n, R)
    out = [1]
    for _ in range(n - 1):
        out.append(out[-1] * w % R)
    return out


def bit_reversal_permutation(values: Sequence) -> List:
    n = len(values)
    assert n & (n - 1) == 0
    bits = n.bit_length() - 1
    return [
        values[int(format(i, f"0{bits}b")[::-1], 2) if bits else 0]
        for i in range(n)
    ]


@dataclass
class TrustedSetup:
    """Lagrange-form G1 points over the bit-reversed domain + the two
    monomial G2 points the pairing check needs."""

    g1_lagrange: List  # affine G1 points, one per field element
    g2_monomial: Tuple  # ([1]G2, [tau]G2)
    roots_brp: List[int]  # bit-reversed evaluation domain

    @property
    def width(self) -> int:
        return len(self.g1_lagrange)

    @classmethod
    def from_points(cls, g1_lagrange, g2_monomial):
        roots = bit_reversal_permutation(
            compute_roots_of_unity(len(g1_lagrange))
        )
        return cls(list(g1_lagrange), tuple(g2_monomial), roots)


def insecure_dev_setup(n: int = 16, seed: bytes = b"lodestar-tpu-dev-kzg") -> TrustedSetup:
    """A KNOWN-tau setup for dev/tests — see module docstring.  O(n)
    G1 scalar multiplications on the CPU oracle, so keep n small in
    tests (the math is width-independent)."""
    assert n & (n - 1) == 0
    tau = int.from_bytes(hashlib.sha256(seed).digest(), "big") % R
    roots = compute_roots_of_unity(n)
    # Lagrange basis at tau over the (natural-order) domain:
    #   L_i(tau) = w_i (tau^n - 1) / (n (tau - w_i))
    zn = (pow(tau, n, R) - 1) % R
    lagrange_nat = [
        C.scalar_mul(
            C.FP_OPS,
            C.G1_GEN,
            w * zn % R * _inv(n * (tau - w) % R) % R,
        )
        for w in roots
    ]
    g1_lagrange = bit_reversal_permutation(lagrange_nat)
    g2 = (C.G2_GEN, C.scalar_mul(C.FP2_OPS, C.G2_GEN, tau))
    return TrustedSetup.from_points(g1_lagrange, g2)


# -- blob <-> polynomial ----------------------------------------------------


def blob_to_polynomial(blob: bytes, width: int) -> List[int]:
    if len(blob) != width * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(
            f"blob length {len(blob)} != {width * BYTES_PER_FIELD_ELEMENT}"
        )
    out = []
    for i in range(width):
        v = int.from_bytes(
            blob[i * 32 : (i + 1) * 32], "big"
        )
        if v >= R:
            raise KzgError(f"blob element {i} not canonical")
        out.append(v)
    return out


def polynomial_to_blob(evals: Sequence[int]) -> bytes:
    return b"".join(int(v).to_bytes(32, "big") for v in evals)


def _msm(points, scalars) -> Optional[tuple]:
    """sum_i scalars_i * points_i on the oracle (None = infinity)."""
    terms = []
    for pt, k in zip(points, scalars):
        k = k % R
        if k == 0 or pt is None:
            continue
        terms.append(C.scalar_mul(C.FP_OPS, pt, k))
    return C.multi_add(C.FP_OPS, [t for t in terms if t is not None])


def evaluate_polynomial_in_evaluation_form(
    evals: Sequence[int], z: int, setup: TrustedSetup
) -> int:
    """Barycentric evaluation at z over the bit-reversed domain."""
    n = setup.width
    roots = setup.roots_brp
    z %= R
    for i, w in enumerate(roots):
        if z == w:
            return evals[i] % R
    # p(z) = (z^n - 1)/n * sum_i e_i w_i / (z - w_i)
    total = 0
    for e, w in zip(evals, roots):
        total = (total + e * w % R * _inv((z - w) % R)) % R
    return total * (pow(z, n, R) - 1) % R * _inv(n) % R


# -- commitments + proofs ---------------------------------------------------


def blob_to_kzg_commitment(blob: bytes, setup: TrustedSetup) -> bytes:
    evals = blob_to_polynomial(blob, setup.width)
    return C.g1_compress(_msm(setup.g1_lagrange, evals))


def compute_kzg_proof(
    blob: bytes, z_bytes: bytes, setup: TrustedSetup
) -> Tuple[bytes, bytes]:
    """(proof, y): the quotient commitment for p(z) = y."""
    evals = blob_to_polynomial(blob, setup.width)
    z = int.from_bytes(z_bytes, "big")
    if z >= R:
        raise KzgError("z not canonical")
    y = evaluate_polynomial_in_evaluation_form(evals, z, setup)
    roots = setup.roots_brp
    # quotient in evaluation form: q_i = (e_i - y)/(w_i - z); at a
    # domain point use the spec's L'Hopital-style branch
    q = [0] * setup.width
    z_on_domain = None
    for i, w in enumerate(roots):
        if w == z:
            z_on_domain = i
            continue
        q[i] = (evals[i] - y) * _inv((w - z) % R) % R
    if z_on_domain is not None:
        i = z_on_domain
        acc = 0
        for j, w in enumerate(roots):
            if j == i:
                continue
            # q_i = sum_j (e_j - y) w_j / (z (z - w_j))
            acc = (
                acc
                + (evals[j] - y)
                * w
                % R
                * _inv(z * ((z - w) % R) % R)
            ) % R
        q[i] = acc
    proof_pt = _msm(setup.g1_lagrange, q)
    # infinity encodes as the compressed identity
    proof = (
        C.g1_compress(proof_pt)
        if proof_pt is not None
        else bytes([0xC0]) + b"\x00" * 47
    )
    return proof, int(y).to_bytes(32, "big")


def verify_kzg_proof(
    commitment: bytes, z_bytes: bytes, y_bytes: bytes, proof: bytes,
    setup: TrustedSetup,
) -> bool:
    """e(C - [y]G1, [1]G2) == e(pi, [tau - z]G2)."""
    try:
        c_pt = C.g1_decompress(commitment)
        pi = None if proof == bytes([0xC0]) + b"\x00" * 47 else C.g1_decompress(proof)
    except Exception:
        return False
    z = int.from_bytes(z_bytes, "big")
    y = int.from_bytes(y_bytes, "big")
    if z >= R or y >= R:
        return False
    g2_1, g2_tau = setup.g2_monomial
    # X2 = [tau]G2 - [z]G2
    x2 = C.multi_add(
        C.FP2_OPS,
        [g2_tau, C.affine_neg(C.FP2_OPS, C.scalar_mul(C.FP2_OPS, C.G2_GEN, z))],
    )
    p_minus_y = C.multi_add(
        C.FP_OPS,
        [c_pt, C.affine_neg(C.FP_OPS, C.scalar_mul(C.FP_OPS, C.G1_GEN, y))],
    )
    if p_minus_y is None and pi is None:
        return True
    if p_minus_y is None or pi is None or x2 is None:
        # degenerate inputs: fall back to the full identity via pairing
        # with explicit infinity handling (e(O, Q) = 1)
        lhs_one = p_minus_y is None
        rhs_one = pi is None or x2 is None
        return lhs_one and rhs_one
    return P.multi_pairing_is_one(
        [(p_minus_y, C.G2_GEN), (C.affine_neg(C.FP_OPS, pi), x2)]
    )


# -- blob-level API (what the beacon node consumes) -------------------------


def _compute_challenge(blob: bytes, commitment: bytes, setup: TrustedSetup) -> int:
    """Spec compute_challenge: hash(DOMAIN + degree_poly(16B) + blob +
    commitment) — byte-compatible with c-kzg so proofs interop once the
    real setup points are loaded."""
    h = hashlib.sha256()
    h.update(FIAT_SHAMIR_PROTOCOL_DOMAIN)
    h.update((setup.width).to_bytes(16, "big"))
    h.update(blob)
    h.update(commitment)
    return int.from_bytes(h.digest(), "big") % R


def compute_blob_kzg_proof(
    blob: bytes, commitment: bytes, setup: TrustedSetup
) -> bytes:
    z = _compute_challenge(blob, commitment, setup)
    proof, _y = compute_kzg_proof(blob, z.to_bytes(32, "big"), setup)
    return proof


def verify_blob_kzg_proof(
    blob: bytes, commitment: bytes, proof: bytes, setup: TrustedSetup
) -> bool:
    try:
        evals = blob_to_polynomial(blob, setup.width)
    except KzgError:
        return False
    z = _compute_challenge(blob, commitment, setup)
    y = evaluate_polynomial_in_evaluation_form(evals, z, setup)
    return verify_kzg_proof(
        commitment,
        z.to_bytes(32, "big"),
        int(y).to_bytes(32, "big"),
        proof,
        setup,
    )


def verify_blob_kzg_proof_batch(
    blobs: Sequence[bytes],
    commitments: Sequence[bytes],
    proofs: Sequence[bytes],
    setup: TrustedSetup,
) -> bool:
    """Per-blob verification (the RLC-batched pairing path on the card
    is the wiring noted in the module docstring; the reference's c-kzg batch
    is also sequential pairings under the hood for small counts)."""
    if not (len(blobs) == len(commitments) == len(proofs)):
        return False
    return all(
        verify_blob_kzg_proof(b, c, p, setup)
        for b, c, p in zip(blobs, commitments, proofs)
    )
