"""RLC batch randomizers: odd 128-bit scalars from the OS CSPRNG.

Counterpart of `lodestar_tpu/ops/bls_kernels.py` `_rand_scalars128`
(`:295`) and `make_rand_words` (`:313`): the same draws, so a seeded
generator gives both packages the same words.  128-bit scalars bound
the probability that a batch with an invalid set passes at about 2^-127
(odd scalars halve the space).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..kernels.verify import RAND_WORDS


def _rand_scalars128(n: int, rng: Optional[np.random.Generator]) -> np.ndarray:
    """Odd 128-bit scalars as uint32 [4, n] big-endian words.  rng None
    (production) draws from the OS CSPRNG; a seeded Generator is for
    tests only."""
    if rng is None:
        raw = np.frombuffer(os.urandom(4 * RAND_WORDS * n), np.uint32)
        words = raw.reshape(RAND_WORDS, n).copy()
    else:
        words = rng.integers(0, 1 << 32, size=(RAND_WORDS, n), dtype=np.uint64).astype(np.uint32)
    words[-1] |= np.uint32(1)  # odd => nonzero, a unit mod 2^128
    return words


def make_rand_words(n: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random odd 128-bit scalars packed as int32 [4, n] big-endian words
    (row 0 the most significant 32 bits): the layout the scalar
    multiplication kernels read (`kernels/verify.py _word_digit`)."""
    return _rand_scalars128(n, rng).view(np.int32)
