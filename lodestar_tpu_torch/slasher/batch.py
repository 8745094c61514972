"""Vectorized min-max span arrays — the slasher's dense math, a copy of
`lodestar_tpu/slasher/batch.py` (numpy; the ground truth the card's span
state, `slasher/device.py TorchSpanState`, is held to).

The min-max surround algorithm (Lighthouse slasher / "Detecting
slashing conditions" writeup) keeps, per validator and per epoch `e`
inside a sliding window:

  min_span[e] = min(target - e  :  recorded attestations with source > e)
  max_span[e] = max(target - e  :  recorded attestations with source < e)

A new attestation (s, t) then answers both surround questions with two
O(1) lookups at column `s`:

  min_span[s] < t - s   =>  the NEW attestation SURROUNDS a recorded one
                            (exists source > s with target < t)
  max_span[s] > t - s   =>  the new attestation IS SURROUNDED by one
                            (exists source < s with target > t)

Inserting (s, t) updates whole rows at once:

  min_span[e] = min(min_span[e], t - e)   for e in [window_start, s)
  max_span[e] = max(max_span[e], t - e)   for e in (s, t)

`span_update_rows` is the pure update: shape-stable over an
(n_validators, chunk) block, masks built from an iota instead of data-
dependent slices.  Epochs are chunked
along the window axis (Lighthouse's chunked span arrays) and whole
gossip batches apply one distinct AttestationData at a time, vectorized
across every attesting validator and every epoch column.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# "no recorded attestation" sentinels.  MIN sentinel is large (any real
# distance is smaller); MAX sentinel is 0 (real distances are >= 1, and
# the strict `> t - s` comparison can never fire on 0 since t >= s).
MIN_SPAN_SENTINEL = np.int32(1 << 30)
MAX_SPAN_SENTINEL = np.int32(0)

DEFAULT_HISTORY_LENGTH = 4096  # epochs of surround history retained
DEFAULT_CHUNK_SIZE = 16  # epoch columns per kernel invocation


def span_update_rows(
    min_rows: np.ndarray,
    max_rows: np.ndarray,
    source_col,
    target_col,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure span-update kernel over one (n_validators, width) block.

    `source_col`/`target_col` are window-relative scalars (may lie
    outside [0, width) — the masks handle chunk translation).  Shape-
    stable, branch-free, iota-masked: jnp-compatible as-is.
    """
    cols = np.arange(min_rows.shape[-1], dtype=np.int32)
    dist = np.int32(target_col) - cols  # t - e per column
    min_mask = cols < source_col
    max_mask = (cols > source_col) & (cols < target_col)
    new_min = np.where(min_mask, np.minimum(min_rows, dist), min_rows)
    new_max = np.where(max_mask, np.maximum(max_rows, dist), max_rows)
    return new_min, new_max


class SpanState:
    """The mutable (n_validators, history) span arrays + window base.

    Columns are absolute-epoch indexed: column j = epoch base_epoch + j.
    The window advances by whole chunks (prune on finalization, or when
    a target epoch outgrows the window); vacated columns reset to the
    sentinels.
    """

    def __init__(
        self,
        num_validators: int = 0,
        history_length: int = DEFAULT_HISTORY_LENGTH,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        base_epoch: int = 0,
    ):
        if history_length % chunk_size:
            history_length += chunk_size - history_length % chunk_size
        self.history_length = history_length
        self.chunk_size = chunk_size
        self.base_epoch = base_epoch
        self.min_spans = np.full(
            (num_validators, history_length), MIN_SPAN_SENTINEL, np.int32
        )
        self.max_spans = np.full(
            (num_validators, history_length), MAX_SPAN_SENTINEL, np.int32
        )

    @property
    def num_validators(self) -> int:
        return self.min_spans.shape[0]

    def ensure_validators(self, n: int) -> None:
        cur = self.num_validators
        if n <= cur:
            return
        # geometric over-allocation: registrations trickle in (a few new
        # indices per epoch), and exact-fit growth would re-copy the
        # full planes on every one of them
        n = max(n, cur + cur // 2 + 64)
        grow = n - cur
        self.min_spans = np.concatenate(
            [
                self.min_spans,
                np.full((grow, self.history_length), MIN_SPAN_SENTINEL, np.int32),
            ]
        )
        self.max_spans = np.concatenate(
            [
                self.max_spans,
                np.full((grow, self.history_length), MAX_SPAN_SENTINEL, np.int32),
            ]
        )

    def ensure_epoch(self, epoch: int) -> None:
        """Advance the window (chunk-aligned) so `epoch` has a column."""
        top = self.base_epoch + self.history_length
        if epoch < top:
            return
        shift = epoch - top + 1
        shift += (-shift) % self.chunk_size  # whole chunks only
        self.advance_base(self.base_epoch + shift)

    def advance_base(self, new_base: int) -> None:
        k = new_base - self.base_epoch
        if k <= 0:
            return
        h = self.history_length
        if k >= h:
            self.min_spans[:] = MIN_SPAN_SENTINEL
            self.max_spans[:] = MAX_SPAN_SENTINEL
        else:
            self.min_spans[:, : h - k] = self.min_spans[:, k:]
            self.min_spans[:, h - k :] = MIN_SPAN_SENTINEL
            self.max_spans[:, : h - k] = self.max_spans[:, k:]
            self.max_spans[:, h - k :] = MAX_SPAN_SENTINEL
        self.base_epoch = new_base

    # -- batch application -------------------------------------------------

    def lookup(self, rows: np.ndarray, source_epoch: int):
        """(min_span[s], max_span[s]) per row — the two O(1) surround
        probes.  Caller guarantees source_epoch is inside the window."""
        col = source_epoch - self.base_epoch
        return self.min_spans[rows, col], self.max_spans[rows, col]

    def apply(self, rows: np.ndarray, source_epoch: int, target_epoch: int) -> None:
        """Record one attestation data for `rows` validators: chunked,
        vectorized span update across the whole window."""
        if len(rows) == 0:
            return
        s_col = source_epoch - self.base_epoch
        t_col = target_epoch - self.base_epoch
        c = self.chunk_size
        # min updates touch cols < s_col, max updates cols < t_col;
        # s_col <= t_col, so chunks past t_col are untouched.
        last = min(self.history_length, max(t_col, 0))
        for off in range(0, last + (-last) % c, c):
            hi = off + c
            new_min, new_max = span_update_rows(
                self.min_spans[rows, off:hi],
                self.max_spans[rows, off:hi],
                s_col - off,
                t_col - off,
            )
            self.min_spans[rows, off:hi] = new_min
            self.max_spans[rows, off:hi] = new_max
