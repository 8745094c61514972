"""Device-resident span planes — the slasher's card path.

`TorchSpanState` is the port's counterpart of
`lodestar_tpu/slasher/device.py` `JaxSpanState` (`:113`): the
(n_validators, history) min and max span planes live as int32 tensors on
one device, the card unless `device="cpu"` is passed, and every operation
of `SpanState` runs there with the numpy ground truth's results exactly:

  apply               defers: appends (rows, source column, target column)
                      to a pending batch and marks the rows in a host bool
                      mask of length V; an apply that can change no cell
                      is dropped
  drain               the pending batch in one `kernels/spans.py
                      span_update_many` launch (one host-to-device copy of
                      the concatenated rows); no host mask, no
                      whole-window pass
  lookup              gathers planes[rows, col] on the device and returns
                      numpy int32, as `SpanState.lookup`
  ensure_validators   geometric growth, one allocation a plane
  advance_base        the window shift, through a bounded row-chunk
                      temporary (the source and destination columns
                      overlap)
  snapshot            a numpy `SpanState` (the store's format)

The batch drains before a lookup or an apply whose rows meet a pending
row (so a launch's datas have disjoint rows), before growth, a window
shift and a snapshot, before any read or assignment of `min_spans` or
`max_spans`, and before it would pass `BATCH_ROWS` rows.  That is exact
for any caller: an apply changes only min[r, c < s] and max[r, s < c < t]
of its own rows, a lookup reads column s of its own rows, so an apply
deferred past a lookup of disjoint rows changes nothing the lookup reads,
and min and max commute.  `drains` counts the drains by reason.

Planes assigned from numpy (the service's warm start puts the store's
snapshot into the live span state) are copied onto the device.  At 1M
validators x 4,096 epochs the planes are 16 GiB each: no operation but
`snapshot` copies a plane to the host.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..bls.verifier import resolve_device
from ..kernels import build as B
from ..kernels import spans as SP
from .batch import (
    DEFAULT_CHUNK_SIZE,
    DEFAULT_HISTORY_LENGTH,
    MAX_SPAN_SENTINEL,
    MIN_SPAN_SENTINEL,
    SpanState,
)

# rows a window shift copies through one temporary (256 MiB a plane at
# 4,096 columns)
ADVANCE_ROWS = 16384
# rows a drain carries at most: one flush of 512 committees of 512 at 1M
# validators (2 MiB of int64 rows to copy)
BATCH_ROWS = 1 << 18
DRAIN_REASONS = ("lookup", "apply", "cap", "ensure_validators", "advance_base", "snapshot", "planes")


class TorchSpanState(SpanState):
    """SpanState with its planes on a torch device and the span-update
    kernel behind its deferred apply.  On the card the kernels are built
    (or loaded) at construction, so a missing compiler raises here and not
    inside the first flush."""

    def __init__(
        self,
        num_validators: int = 0,
        history_length: int = DEFAULT_HISTORY_LENGTH,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        base_epoch: int = 0,
        device=None,
    ):
        # no SpanState.__init__: its numpy planes are the host copy this
        # class exists to avoid
        if history_length % chunk_size:
            history_length += chunk_size - history_length % chunk_size
        self.history_length = history_length
        self.chunk_size = chunk_size
        self.base_epoch = base_epoch
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            B.load("spans")
        self._pending: List[Tuple[np.ndarray, int, int]] = []
        self._pending_rows = 0
        self._mask = np.zeros(0, dtype=bool)  # the pending rows, sized to V at the first apply
        self.drains: Dict[str, int] = dict.fromkeys(DRAIN_REASONS, 0)
        self._min = self._full(num_validators, MIN_SPAN_SENTINEL)
        self._max = self._full(num_validators, MAX_SPAN_SENTINEL)

    def _full(self, n: int, fill) -> torch.Tensor:
        return torch.full((n, self.history_length), int(fill), dtype=torch.int32, device=self.device)

    # -- the planes: every read or assignment drains ------------------------

    def _plane(self, plane) -> torch.Tensor:
        """A plane assigned from numpy is copied onto the device (the
        caller's array is never updated in place)."""
        if isinstance(plane, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.int32))
            return t.to(self.device) if self.device.type == "cuda" else t.clone()
        return plane

    @property
    def min_spans(self) -> torch.Tensor:
        self.drain("planes")
        return self._min

    @min_spans.setter
    def min_spans(self, plane) -> None:
        self.drain("planes")
        self._min = self._plane(plane)

    @property
    def max_spans(self) -> torch.Tensor:
        self.drain("planes")
        return self._max

    @max_spans.setter
    def max_spans(self, plane) -> None:
        self.drain("planes")
        self._max = self._plane(plane)

    @property
    def num_validators(self) -> int:
        return self._min.shape[0]

    def _rows(self, rows) -> np.ndarray:
        """Row indices as int64, each inside [0, V) (an index outside
        would fault the card's gather)."""
        ra = np.asarray(rows, dtype=np.int64).reshape(-1)
        if ra.size and (int(ra.min()) < 0 or int(ra.max()) >= self.num_validators):
            raise IndexError(f"span rows outside [0, {self.num_validators})")
        return ra

    @staticmethod
    def _host(plane: torch.Tensor) -> np.ndarray:
        return plane.cpu().numpy() if plane.is_cuda else plane.numpy().copy()

    # -- the pending batch ----------------------------------------------------

    def _meets_pending(self, ra: np.ndarray) -> bool:
        return bool(self._pending) and bool(self._mask[ra].any())

    def drain(self, reason: str) -> None:
        """Apply the pending batch in one launch (see the module)."""
        if not self._pending:
            return
        rows = np.concatenate([r for r, _, _ in self._pending])
        seg = np.zeros(len(self._pending) + 1, dtype=np.int64)
        np.cumsum([r.size for r, _, _ in self._pending], out=seg[1:])
        idx = SP.to_card(rows, self.device) if self.device.type == "cuda" else torch.from_numpy(rows)
        SP.span_update_many(self._min, self._max, idx, seg, [s for _, s, _ in self._pending],
                            [t for _, _, t in self._pending])
        self._mask[rows] = False
        self._pending, self._pending_rows = [], 0
        self.drains[reason] += 1

    # -- structural ops (finalization, registration) -----------------------

    def ensure_validators(self, n: int) -> None:
        cur = self.num_validators
        if n <= cur:
            return
        self.drain("ensure_validators")
        n = max(n, cur + cur // 2 + 64)  # SpanState's geometric over-allocation
        for name, fill in (("_min", MIN_SPAN_SENTINEL), ("_max", MAX_SPAN_SENTINEL)):
            old = getattr(self, name)
            new = torch.empty((n, self.history_length), dtype=torch.int32, device=self.device)
            new[:cur].copy_(old)
            new[cur:].fill_(int(fill))
            setattr(self, name, new)

    def advance_base(self, new_base: int) -> None:
        k = new_base - self.base_epoch
        if k <= 0:
            return
        self.drain("advance_base")
        h = self.history_length
        for plane, fill in ((self._min, MIN_SPAN_SENTINEL), (self._max, MAX_SPAN_SENTINEL)):
            if k >= h:
                plane.fill_(int(fill))
                continue
            for r in range(0, plane.shape[0], ADVANCE_ROWS):
                block = plane[r : r + ADVANCE_ROWS]
                block[:, : h - k] = block[:, k:].clone()
                block[:, h - k :] = int(fill)
        self.base_epoch = new_base

    # -- hot path ----------------------------------------------------------

    def lookup(self, rows: np.ndarray, source_epoch: int):
        ra = self._rows(rows)
        if self._meets_pending(ra):
            self.drain("lookup")
        col = source_epoch - self.base_epoch
        idx = torch.from_numpy(ra).to(self.device)
        return self._min[idx, col].cpu().numpy(), self._max[idx, col].cpu().numpy()

    def apply(self, rows: np.ndarray, source_epoch: int, target_epoch: int) -> None:
        if len(rows) == 0:
            return
        ra = self._rows(rows)
        s_col, t_col = SP.int32_columns(source_epoch - self.base_epoch, target_epoch - self.base_epoch)
        if SP.touched_columns(self.history_length, s_col, t_col) == 0:
            return  # changes no cell
        if self._mask.size != self.num_validators:  # V moved: only after a drain
            self._mask = np.zeros(self.num_validators, dtype=bool)
        if self._meets_pending(ra):
            self.drain("apply")
        elif self._pending and self._pending_rows + ra.size > BATCH_ROWS:
            self.drain("cap")
        self._pending.append((ra.copy(), s_col, t_col))  # the caller may reuse its array
        self._pending_rows += ra.size
        self._mask[ra] = True

    def snapshot(self) -> SpanState:
        """Numpy SpanState copy (persistence format compatibility)."""
        self.drain("snapshot")
        out = SpanState(
            num_validators=0,
            history_length=self.history_length,
            chunk_size=self.chunk_size,
            base_epoch=self.base_epoch,
        )
        out.min_spans = self._host(self._min)
        out.max_spans = self._host(self._max)
        return out


__all__ = [
    "TorchSpanState",
    "MIN_SPAN_SENTINEL",
    "MAX_SPAN_SENTINEL",
]
