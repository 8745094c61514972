"""Device-resident span planes — the slasher's card path.

`TorchSpanState` is the port's counterpart of
`lodestar_tpu/slasher/device.py` `JaxSpanState` (`:113`): the
(n_validators, history) min and max span planes live as int32 tensors on
one device, the card unless `device="cpu"` is passed, and every operation
of `SpanState` runs there with the numpy ground truth's results exactly:

  apply               uploads the listed rows (a small int64 tensor) and
                      runs the span-update kernel on them in place
                      (`kernels/spans.py span_update`); no host mask, no
                      whole-window pass
  lookup              gathers planes[rows, col] on the device and returns
                      numpy int32, as `SpanState.lookup`
  ensure_validators   geometric growth, one allocation a plane
  advance_base        the window shift, through a bounded row-chunk
                      temporary (the source and destination columns
                      overlap)
  snapshot            a numpy `SpanState` (the store's format)

Planes assigned from numpy (the service's warm start puts the store's
snapshot into the live span state) move to the device at the next
operation.  At 1M validators x 4,096 epochs the planes are 16 GiB each:
no operation but `snapshot` copies a plane to the host.
"""

from __future__ import annotations

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


class TorchSpanState(SpanState):
    """SpanState with its planes on a torch device and the span-update
    kernel as its apply.  On the card the kernels are built (or loaded)
    at construction, so a missing compiler raises here and not inside the
    first flush."""

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
        self.min_spans = self._full(num_validators, MIN_SPAN_SENTINEL)
        self.max_spans = self._full(num_validators, MAX_SPAN_SENTINEL)

    def _full(self, n: int, fill) -> torch.Tensor:
        return torch.full((n, self.history_length), int(fill), dtype=torch.int32, device=self.device)

    # -- host <-> device ---------------------------------------------------

    def _to_device(self) -> None:
        """Planes assigned from numpy move onto the device (copied: the
        caller's arrays are never updated in place)."""
        for name in ("min_spans", "max_spans"):
            plane = getattr(self, name)
            if isinstance(plane, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.int32))
                setattr(self, name, t.to(self.device) if self.device.type == "cuda" else t.clone())

    def _rows(self, rows) -> np.ndarray:
        """Row indices as int64, each inside [0, V) (an index outside
        would fault the card's gather)."""
        ra = np.asarray(rows, dtype=np.int64).reshape(-1)
        if ra.size and (int(ra.min()) < 0 or int(ra.max()) >= self.num_validators):
            raise IndexError(f"span rows outside [0, {self.num_validators})")
        return ra

    @staticmethod
    def _host(plane) -> np.ndarray:
        if isinstance(plane, np.ndarray):
            return np.array(plane, dtype=np.int32)
        return plane.cpu().numpy() if plane.is_cuda else plane.numpy().copy()

    # -- structural ops (finalization, registration) -----------------------

    def ensure_validators(self, n: int) -> None:
        cur = self.num_validators
        if n <= cur:
            return
        self._to_device()
        n = max(n, cur + cur // 2 + 64)  # SpanState's geometric over-allocation
        for name, fill in (("min_spans", MIN_SPAN_SENTINEL), ("max_spans", MAX_SPAN_SENTINEL)):
            old = getattr(self, name)
            new = torch.empty((n, self.history_length), dtype=torch.int32, device=self.device)
            new[:cur].copy_(old)
            new[cur:].fill_(int(fill))
            setattr(self, name, new)

    def advance_base(self, new_base: int) -> None:
        k = new_base - self.base_epoch
        if k <= 0:
            return
        self._to_device()
        h = self.history_length
        for plane, fill in ((self.min_spans, MIN_SPAN_SENTINEL), (self.max_spans, MAX_SPAN_SENTINEL)):
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
        self._to_device()
        col = source_epoch - self.base_epoch
        idx = torch.from_numpy(self._rows(rows)).to(self.device)
        return self.min_spans[idx, col].cpu().numpy(), self.max_spans[idx, col].cpu().numpy()

    def apply(self, rows: np.ndarray, source_epoch: int, target_epoch: int) -> None:
        if len(rows) == 0:
            return
        self._to_device()
        idx = torch.from_numpy(self._rows(rows)).to(self.device, non_blocking=True)
        SP.span_update(
            self.min_spans,
            self.max_spans,
            idx,
            source_epoch - self.base_epoch,
            target_epoch - self.base_epoch,
        )

    def snapshot(self) -> SpanState:
        """Numpy SpanState copy (persistence format compatibility)."""
        out = SpanState(
            num_validators=0,
            history_length=self.history_length,
            chunk_size=self.chunk_size,
            base_epoch=self.base_epoch,
        )
        out.min_spans = self._host(self.min_spans)
        out.max_spans = self._host(self.max_spans)
        return out


__all__ = [
    "TorchSpanState",
    "MIN_SPAN_SENTINEL",
    "MAX_SPAN_SENTINEL",
]
