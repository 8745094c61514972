"""CPU ground-truth BLS12-381 cryptography (fields, curves, pairing, BLS).

A copy of `lodestar_tpu/crypto/` that the port owns, so that the port never
imports the JAX package.  It is the host oracle the port's torch and CUDA
field engine is held against, and it makes the keys, messages and
signatures of the smoke run.
"""

from . import bls, curves, fields, hash_to_curve, pairing  # noqa: F401
