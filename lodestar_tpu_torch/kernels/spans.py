"""The slasher's span update on the device.

Counterpart of `lodestar_tpu/slasher/device.py` `span_update_planes`
(`:39`), the jitted whole-window masked update of the min-max surround
spans.  One device function, the kernel of `csrc/spans.cu`:

  span_update  the listed rows of the int32 (V, H) min and max planes,
               in place, for one attestation data's window-relative
               source and target columns: min = min(min, t - c) for
               c < s, max = max(max, t - c) for s < c < t

`span_update_planes_plain` is the literal torch mirror of the JAX
function (iota, row mask, `torch.where`; whole planes in, new planes
out); the CPU tests hold it to JAX and the kernel to it.  The wrapper
checks its operands, then launches the kernel for CUDA tensors or runs
the plain version for CPU tensors and writes its result back; any other
device raises, and there is no fallback from one to the other.  It makes
no launch when no row is listed or no cell can change
(`touched_columns` is 0).
`LAUNCHES["span_update"]` counts the wrapper's kernel launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import build as B

LAUNCHES: Dict[str, int] = {"span_update": 0}

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def span_update(min_sp: torch.Tensor, max_sp: torch.Tensor, rows: torch.Tensor, s_col: int, t_col: int) -> None:
    """Update the listed rows of the planes in place (see the module);
    rows outside [0, V) are skipped, repeated rows are harmless."""
    s_col, t_col = int(s_col), int(t_col)
    if not (_I32_MIN <= s_col <= _I32_MAX and _I32_MIN <= t_col <= _I32_MAX):
        raise ValueError(f"span_update: columns {s_col}, {t_col} outside int32")
    v, h = min_sp.shape[0], min_sp.shape[-1]
    on_cpu = _on_cpu(min_sp, max_sp, rows)
    if rows.numel() == 0 or touched_columns(h, s_col, t_col) == 0:
        return
    if on_cpu:
        mask = torch.zeros(v, dtype=torch.bool)
        mask[rows[(rows >= 0) & (rows < v)]] = True
        new_min, new_max = span_update_planes_plain(min_sp, max_sp, mask, s_col, t_col)
        min_sp.copy_(new_min)
        max_sp.copy_(new_max)
        return
    fn = B.load("spans").lt_span_update
    err = fn(min_sp.data_ptr(), max_sp.data_ptr(), rows.data_ptr(), rows.numel(), v, h, s_col, t_col,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lt_span_update launch failed: cudaError {err}")
    LAUNCHES["span_update"] += 1
