"""The slasher's span update on the device.

Counterpart of `lodestar_tpu/slasher/device.py` `span_update_planes`
(`:39`), the jitted whole-window masked update of the min-max surround
spans.  One kernel, `csrc/spans.cu`, behind two wrappers:

  span_update       the listed rows of the int32 (V, H) min and max planes,
                    in place, for one attestation data's window-relative
                    source and target columns: min = min(min, t - c) for
                    c < s, max = max(max, t - c) for s < c < t
  span_update_many  D datas in one launch: rows[seg[d]:seg[d + 1]] with
                    columns s_cols[d], t_cols[d]; equal to the D updates
                    one after another.  On the card, rows of different
                    datas must be disjoint (the kernel does not order the
                    datas); TorchSpanState keeps them so

`span_update_planes_plain` is the literal torch mirror of the JAX
function (iota, row mask, `torch.where`; whole planes in, new planes
out); the CPU tests hold it to JAX and the kernel to it.  The wrappers
check their operands, then launch the kernel for CUDA tensors or run the
plain version (data after data) for CPU tensors and write its result
back; any other device raises, and there is no fallback from one to the
other.  No launch is made when no listed data can change a cell
(`touched_columns` is 0 or it lists no row).  `LAUNCHES["span_update"]`
counts the kernel's launches, `APPLIES["span_update"]` the datas those
launches carried.  `span_plan` packs a launch's plan (row offsets,
columns, work-item prefix) and knows its layout; the wrapper and every
direct caller of `lt_span_update_many` go through it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import build as B

LAUNCHES: Dict[str, int] = {"span_update": 0}
APPLIES: Dict[str, int] = {"span_update": 0}

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def reset_launches() -> None:
    for counts in (LAUNCHES, APPLIES):
        for k in counts:
            counts[k] = 0


def cells_updated(h: int, s_col: int, t_col: int) -> Tuple[int, int]:
    """(min columns, max columns) an update reads and may write in each
    listed row: c < s, and s < c < t, inside [0, h)."""
    n_min = min(max(s_col, 0), h)
    n_max = max(0, min(t_col, h) - max(s_col + 1, 0))
    return n_min, n_max


def touched_columns(h: int, s_col: int, t_col: int) -> int:
    """The columns an update can change are [0, touched_columns(...)): the
    min update's [0, s) and the max update's (s, t) inside [0, h); 0 when
    both are empty (no launch), as `span_last` in csrc/spans.cu."""
    n_min, n_max = cells_updated(h, s_col, t_col)
    return max(n_min, min(t_col, h) if n_max else 0)


def span_width(min_sp: torch.Tensor, max_sp: torch.Tensor) -> int:
    """Columns a work item of the kernel covers on these planes: 4 (one
    16-byte vector) where every row's base is 16-byte aligned, else 1; as
    `span_width` in csrc/spans.cu."""
    h = min_sp.shape[-1]
    return 4 if h % 4 == 0 and min_sp.data_ptr() % 16 == 0 and max_sp.data_ptr() % 16 == 0 else 1


def work_items(h: int, width: int, seg: np.ndarray, s_cols: np.ndarray, t_cols: np.ndarray) -> np.ndarray:
    """The prefix of the datas' work items (int64 [D + 1]): data d has its
    rows x ceil(touched_columns / width) items (`touched_columns` over
    arrays)."""
    s, t = np.asarray(s_cols, np.int64), np.asarray(t_cols, np.int64)
    n_min = np.clip(s, 0, h)
    n_max = np.maximum(0, np.minimum(t, h) - np.maximum(s + 1, 0))
    last = np.maximum(n_min, np.where(n_max > 0, np.minimum(t, h), 0))
    out = np.zeros(s.size + 1, dtype=np.int64)
    np.cumsum(np.diff(seg) * (-(-last // width)), out=out[1:])
    return out


def to_card(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array onto the card through pinned memory, without waiting
    for the stream (the pinned block is kept until the copy is done)."""
    return torch.from_numpy(arr).pin_memory().to(device, non_blocking=True)


class SpanPlan(NamedTuple):
    """The plan of one `lt_span_update_many` launch: `tensor` the packed
    int64 seg [D + 1], s_cols [D], t_cols [D] and work-item prefix
    [D + 1] on the planes' device (kept alive until the launch has run),
    `pointers` those four arrays' addresses, `width` the columns a work
    item covers, `n_items` the work items."""

    tensor: torch.Tensor
    pointers: Tuple[int, int, int, int]
    width: int
    n_items: int
    n_data: int

    def args(self, min_sp: torch.Tensor, max_sp: torch.Tensor, rows: torch.Tensor) -> tuple:
        """`lt_span_update_many`'s arguments on these planes and rows, all
        but the stream."""
        v, h = min_sp.shape[0], min_sp.shape[-1]
        return (min_sp.data_ptr(), max_sp.data_ptr(), rows.data_ptr(), *self.pointers, self.n_data, v, h,
                self.width, self.n_items)


def span_plan(min_sp: torch.Tensor, max_sp: torch.Tensor, seg: np.ndarray, s_cols: np.ndarray,
              t_cols: np.ndarray) -> SpanPlan:
    """The launch plan of D datas (int64 seg, s_cols, t_cols) on these
    planes: on the card through pinned memory, without waiting for the
    stream; on the host (the host build) in place."""
    width = span_width(min_sp, max_sp)
    items = work_items(min_sp.shape[-1], width, seg, s_cols, t_cols)
    packed = np.concatenate([seg, s_cols, t_cols, items]).astype(np.int64)
    tensor = torch.from_numpy(packed) if min_sp.device.type == "cpu" else to_card(packed, min_sp.device)
    d, at = s_cols.size, tensor.data_ptr()
    return SpanPlan(tensor, (at, at + 8 * (d + 1), at + 8 * (2 * d + 1), at + 8 * (3 * d + 1)), width,
                    int(items[-1]), d)


def span_update_planes_plain(min_sp: torch.Tensor, max_sp: torch.Tensor, row_mask: torch.Tensor, s_col: int,
                             t_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-window span update, the torch mirror of JAX's
    `span_update_planes`: int32 (V, H) planes, bool (V,) row mask, int
    columns -> the new (min, max) planes."""
    cols = torch.arange(min_sp.shape[1], dtype=torch.int32, device=min_sp.device)[None, :]
    dist = t_col - cols
    upd = row_mask[:, None]
    new_min = torch.where(upd & (cols < s_col), torch.minimum(min_sp, dist), min_sp)
    new_max = torch.where(upd & (cols > s_col) & (cols < t_col), torch.maximum(max_sp, dist), max_sp)
    return new_min, new_max


def _on_cpu(min_sp: torch.Tensor, max_sp: torch.Tensor, rows: torch.Tensor) -> bool:
    """Check the operands; True for CPU tensors (the plain version), False
    for CUDA tensors on the current device (the kernel); raise otherwise."""
    dev = min_sp.device
    for t, dtype, what in ((min_sp, torch.int32, "min plane"), (max_sp, torch.int32, "max plane"),
                           (rows, torch.int64, "rows")):
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.dtype != dtype:
            raise TypeError(f"span_update {what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if min_sp.dim() != 2 or max_sp.shape != min_sp.shape:
        raise ValueError(f"span_update: planes of shapes {tuple(min_sp.shape)} and {tuple(max_sp.shape)}")
    if rows.dim() != 1:
        raise ValueError(f"span_update rows: expected one dimension, got {tuple(rows.shape)}")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"operands on {dev}, current CUDA device is {torch.cuda.current_device()}")
        return False
    raise ValueError(f"unsupported device {dev}")


def int32_columns(s_col: int, t_col: int) -> Tuple[int, int]:
    s_col, t_col = int(s_col), int(t_col)
    if not (_I32_MIN <= s_col <= _I32_MAX and _I32_MIN <= t_col <= _I32_MAX):
        raise ValueError(f"span_update: columns {s_col}, {t_col} outside int32")
    return s_col, t_col


def _plain(min_sp: torch.Tensor, max_sp: torch.Tensor, rows: torch.Tensor, s_col: int, t_col: int) -> None:
    v = min_sp.shape[0]
    mask = torch.zeros(v, dtype=torch.bool)
    mask[rows[(rows >= 0) & (rows < v)]] = True
    new_min, new_max = span_update_planes_plain(min_sp, max_sp, mask, s_col, t_col)
    min_sp.copy_(new_min)
    max_sp.copy_(new_max)


def span_update(min_sp: torch.Tensor, max_sp: torch.Tensor, rows: torch.Tensor, s_col: int, t_col: int) -> None:
    """Update the listed rows of the planes in place (see the module);
    rows outside [0, V) are skipped, repeated rows are harmless."""
    s_col, t_col = int32_columns(s_col, t_col)
    v, h = min_sp.shape[0], min_sp.shape[-1]
    on_cpu = _on_cpu(min_sp, max_sp, rows)
    if rows.numel() == 0 or touched_columns(h, s_col, t_col) == 0:
        return
    if on_cpu:
        _plain(min_sp, max_sp, rows, s_col, t_col)
        return
    fn = B.load("spans").lt_span_update
    err = fn(min_sp.data_ptr(), max_sp.data_ptr(), rows.data_ptr(), rows.numel(), v, h, s_col, t_col,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise B.LaunchRefused(f"lt_span_update launch failed: cudaError {err}")
    LAUNCHES["span_update"] += 1
    APPLIES["span_update"] += 1


def span_update_many(min_sp: torch.Tensor, max_sp: torch.Tensor, rows: torch.Tensor, seg: Sequence[int],
                     s_cols: Sequence[int], t_cols: Sequence[int]) -> int:
    """D datas in one launch (see the module): rows int64 [seg[-1]] on the
    planes' device, seg D + 1 row offsets (seg[0] = 0), s_cols and t_cols
    D columns, all three host integers.  Returns the datas the launch
    carried (those that can change a cell); no launch when there is none."""
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    s_cols = np.asarray(s_cols, dtype=np.int64).reshape(-1)
    t_cols = np.asarray(t_cols, dtype=np.int64).reshape(-1)
    d = s_cols.size
    if t_cols.size != d or seg.size != d + 1:
        raise ValueError(f"span_update_many: {seg.size} offsets, {s_cols.size} sources, {t_cols.size} targets")
    cols = np.concatenate([s_cols, t_cols])
    if cols.size and (int(cols.min()) < _I32_MIN or int(cols.max()) > _I32_MAX):
        raise ValueError("span_update_many: columns outside int32")
    on_cpu = _on_cpu(min_sp, max_sp, rows)
    if seg[0] != 0 or seg[-1] != rows.numel() or (np.diff(seg) < 0).any():
        raise ValueError(f"span_update_many: row offsets {seg.tolist()} for {rows.numel()} rows")
    changes = np.nonzero(np.diff(work_items(min_sp.shape[-1], 1, seg, s_cols, t_cols)))[0]
    carried = int(changes.size)
    if not carried:
        return 0
    if on_cpu:
        for i in changes.tolist():
            _plain(min_sp, max_sp, rows[seg[i] : seg[i + 1]], int(s_cols[i]), int(t_cols[i]))
        return carried
    plan = span_plan(min_sp, max_sp, seg, s_cols, t_cols)
    fn = B.load("spans").lt_span_update_many
    err = fn(*plan.args(min_sp, max_sp, rows), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise B.LaunchRefused(f"lt_span_update_many launch failed: cudaError {err}")
    LAUNCHES["span_update"] += 1
    APPLIES["span_update"] += carried
    return carried
