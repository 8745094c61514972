"""Device-resident validator pubkey table.

Counterpart of `lodestar_tpu/bls/pubkey_table.py`: affine G1 pubkeys as
two int32 [12, V] Montgomery planes (`kernels/layout.py`), kept on the
host and mirrored to a device on demand, indexable by validator index
along the lane axis.  1M validators = 2 x 48 B x 2^20 = 100 MB.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto import curves as C
from ..kernels import layout as LY
from ..kernels import verify as KV
from .ingest import encode_pubkey_planes

KEY_TILE = 128  # registration chunks pad up to a multiple of these lanes


class PubkeyTable:
    """Append-only affine G1 table with per-device mirrors."""

    def __init__(self, capacity: int = 1024):
        self._cap = max(capacity, 1)
        self._n = 0
        self._host_x = np.zeros((LY.NL, self._cap), np.int32)
        self._host_y = np.zeros((LY.NL, self._cap), np.int32)
        self._device: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __len__(self) -> int:
        return self._n

    @property
    def nbytes(self) -> int:
        return self._host_x.nbytes + self._host_y.nbytes

    def register(self, pubkeys: Sequence) -> List[int]:
        """KeyValidate and append ground-truth affine pubkeys; returns
        their indices.  Raises ValueError on infinity, off-curve or
        out-of-subgroup keys (blst KeyValidate semantics)."""
        for pk in pubkeys:
            if pk is None:
                raise ValueError("pubkey is the point at infinity")
            if not C.is_on_curve(C.FP_OPS, pk):
                raise ValueError("pubkey not on curve")
            if not C.g1_subgroup_check(pk):
                raise ValueError("pubkey not in G1 subgroup")
        xs = LY.encode_batch([pk[0] for pk in pubkeys])
        return self._append_planes(xs, LY.encode_batch([pk[1] for pk in pubkeys]))

    def register_compressed(self, keys: Sequence[bytes], device_batch: int = 65536, device=None) -> List[int]:
        """Register 48-byte compressed pubkeys with KeyValidate on the
        device (`kernels/verify.py g1_keyvalidate`: decompression, the
        on-curve check and the subgroup check, one lane per key: sigma(P)
        = [-z^2] P in the CUDA kernel, [r]P = O in its plain version);
        returns their indices.  `device` None means the CUDA device; on the
        CPU the kernel's plain version runs.

        Two phases, as the JAX package's: every chunk of `device_batch`
        keys (padded to a multiple of KEY_TILE lanes with its last key) is
        validated first, then all are committed, so an invalid key raises
        ValueError naming its position and leaves the table unchanged.
        The validated (x, y) planes go to the host planes; the device
        mirrors are dropped."""
        dev = torch.device("cuda" if device is None else device)
        validated = []
        for start in range(0, len(keys), device_batch):
            chunk = list(keys[start : start + device_batch])
            n = len(chunk)
            planes, flags, host_bad = encode_pubkey_planes(chunk + [chunk[-1]] * ((-n) % KEY_TILE))
            xy, ok = KV.g1_keyvalidate(torch.from_numpy(planes).to(dev), torch.from_numpy(flags).to(dev))
            ok = (ok[0, :n].cpu().numpy() != 0) & ~host_bad[:n]
            if not ok.all():
                bad = int(np.argmin(ok))
                raise ValueError(
                    f"pubkey {start + bad} failed KeyValidate (malformed, off-curve, infinity, or out of subgroup)"
                )
            validated.append(xy[..., :n].cpu().numpy())
        return [i for xy in validated for i in self._append_planes(xy[0], xy[1])]

    def _append_planes(self, x_planes: np.ndarray, y_planes: np.ndarray) -> List[int]:
        """Append Montgomery planes [12, k]; drops the device mirrors."""
        k = x_planes.shape[-1]
        while self._n + k > self._cap:
            self._grow()
        self._host_x[:, self._n : self._n + k] = x_planes
        self._host_y[:, self._n : self._n + k] = y_planes
        idxs = list(range(self._n, self._n + k))
        self._n += k
        self._device = {}
        return idxs

    def register_points_unchecked(
        self, pubkeys: Sequence, tile_to: Optional[int] = None
    ) -> List[int]:
        """Bulk-load affine points KNOWN to satisfy KeyValidate into an
        empty table.  With `tile_to`, the keys repeat cyclically up to that
        many rows: a full-size table from a few keypairs."""
        n_in = len(pubkeys)
        if n_in == 0:
            raise ValueError("register_points_unchecked needs >= 1 pubkey")
        total = tile_to if tile_to is not None else n_in
        if total < n_in:
            raise ValueError(f"tile_to {total} < {n_in} input keys")
        if self._n != 0:
            raise ValueError("bulk load only into an empty table")
        if self._cap < total:
            self._cap = total
            self._host_x = np.zeros((LY.NL, total), np.int32)
            self._host_y = np.zeros((LY.NL, total), np.int32)
        reps = -(-total // n_in)
        base_x = LY.encode_batch([pk[0] for pk in pubkeys])
        base_y = LY.encode_batch([pk[1] for pk in pubkeys])
        self._host_x[:, :total] = np.tile(base_x, (1, reps))[:, :total]
        self._host_y[:, :total] = np.tile(base_y, (1, reps))[:, :total]
        self._n = total
        self._device = {}
        return list(range(total))

    @classmethod
    def from_jax_planes(cls, host_x, host_y, n: int) -> "PubkeyTable":
        """The table holding the same points as a JAX-package PubkeyTable,
        from its `_host_x` / `_host_y` int32 [33, cap] Montgomery planes
        (R = 2^396): an exact integer map per row (`layout.from_jax_planes`)."""
        t = cls(capacity=n)
        t._host_x[:, :n] = LY.from_jax_planes(host_x, n)
        t._host_y[:, :n] = LY.from_jax_planes(host_y, n)
        t._n = n
        return t

    def _grow(self) -> None:
        self._cap *= 2
        for name in ("_host_x", "_host_y"):
            old = getattr(self, name)
            new = np.zeros((LY.NL, self._cap), np.int32)
            new[:, : self._n] = old[:, : self._n]
            setattr(self, name, new)

    def device_planes(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (x, y) planes on `device`, padded to capacity.  Padding rows
        are zeros; callers gather registered rows only."""
        key = str(torch.device(device))
        planes = self._device.get(key)
        if planes is None:
            planes = (
                torch.from_numpy(self._host_x).to(device),
                torch.from_numpy(self._host_y).to(device),
            )
            self._device[key] = planes
        return planes

    def host_affine(self, index: int):
        """Ground-truth affine point of a registered row."""
        if not 0 <= index < self._n:
            raise IndexError(f"row {index} is not registered")
        return (
            LY.from_limbs(self._host_x[:, index]) * LY.R_INV % LY.P,
            LY.from_limbs(self._host_y[:, index]) * LY.R_INV % LY.P,
        )
