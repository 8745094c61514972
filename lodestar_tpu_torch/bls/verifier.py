"""TorchBlsVerifier: per-set BLS verification on the port's CUDA kernels.

Counterpart of the per-set subset of `lodestar_tpu/bls/verifier.py`
`TpuBlsVerifier`: the path it takes under `LODESTAR_TPU_BLS_RLC=0`, for
non-batchable jobs, for `verify_signature_sets_individually` and for the
breaker canary (`kernels/verify.py verify_each_device`).  Semantics kept:

  - `verify_signature_sets(sets, opts)` is True iff EVERY set verifies;
    jobs are chunked to `max_job_sets` (MAX_JOB_SETS = 512) and padded to
    the N buckets; all chunks are dispatched before any is synced.
  - `verify_on_main_thread` verifies on the host CPU ground truth.
  - `can_accept_work()` is the 512-pending-job backpressure bound.

Not in this slice: the RLC batch and its bisection, message grouping,
wire (compressed) sets, the export cache and the DeviceSupervisor
breaker; a device fault propagates as an exception.  Aggregate sets
(K > 1) raise ValueError: they need the `_k_agg_pk` kernel of a later
slice, and are not quietly sent to the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..crypto import bls as CB
from ..crypto import curves as C
from ..crypto import pairing as CP
from ..kernels import layout as LY
from ..kernels import verify as KV
from .pubkey_table import PubkeyTable
from .signature_set import SignatureSet

MAX_JOB_SETS = 512
MAX_PENDING_JOBS = 512
# job sizes pad up to these lane counts (multiples of the JAX package's
# 128-lane tile, kept so both packages run the same shapes)
N_BUCKETS = (128, 256, 512, 1024, 2048)


class VerifyOptions:
    """`verify_on_main_thread`: verify on the host CPU ground truth (the
    latency path for block proposer signatures).  RLC batching, which the
    JAX package's `batchable` selects, comes with a later slice."""

    def __init__(self, verify_on_main_thread: bool = False):
        self.verify_on_main_thread = verify_on_main_thread


def resolve_device(device=None) -> torch.device:
    """None means the CUDA device; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TorchBlsVerifier: CUDA requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _bucket(n: int) -> int:
    for b in N_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {N_BUCKETS[-1]}")


class TorchBlsVerifier:
    """The device-backed verifier over one pubkey table."""

    def __init__(self, table: PubkeyTable, device=None, max_job_sets: int = MAX_JOB_SETS):
        self.table = table
        self.device = resolve_device(device)
        self.max_job_sets = min(max_job_sets, N_BUCKETS[-1])
        self._pending_jobs = 0

    def can_accept_work(self) -> bool:
        return self._pending_jobs < MAX_PENDING_JOBS

    # -- entry points -------------------------------------------------------

    def verify_signature_sets(
        self, sets: Sequence[SignatureSet], opts: Optional[VerifyOptions] = None
    ) -> bool:
        if not sets:
            return True
        opts = opts or VerifyOptions()
        self._pending_jobs += 1
        try:
            if opts.verify_on_main_thread:
                return all(self._verify_set_cpu(s) for s in sets)
            step = self.max_job_sets
            pending = [self._dispatch(list(sets[i : i + step])) for i in range(0, len(sets), step)]
            return all(bool(v.all()) for v in (self._collect(*p) for p in pending))
        finally:
            self._pending_jobs -= 1

    def verify_signature_sets_individually(self, sets: Sequence[SignatureSet]) -> List[bool]:
        """Per-set verdicts, in submission order."""
        pending = [
            self._dispatch(list(sets[i : i + MAX_JOB_SETS]))
            for i in range(0, len(sets), MAX_JOB_SETS)
        ]
        out: List[bool] = []
        for p in pending:
            out.extend(bool(v) for v in self._collect(*p))
        return out

    # -- job execution --------------------------------------------------------

    def _prepare(self, sets: List[SignatureSet]):
        """Pad sets into an N bucket and encode the device operands: plain
        limb planes [8, 12, n] (H(m) x0 x1 y0 y1, sig x0 x1 y0 y1), table
        rows [n, 1], signature-infinity and valid flags [n]."""
        for s in sets:
            if len(s.indices) != 1:
                raise ValueError(
                    "aggregate sets (K > 1) need the pubkey-aggregation kernel "
                    "(_k_agg_pk), which a later slice of the port adds"
                )
            if not 0 <= s.indices[0] < len(self.table):
                raise IndexError(f"validator index {s.indices[0]} is not in the pubkey table")
        n = _bucket(len(sets))
        g2 = C.G2_GEN
        msgs = [s.message for s in sets] + [g2] * (n - len(sets))
        sigs = [g2 if s.signature is None else s.signature for s in sets]
        sigs += [g2] * (n - len(sets))
        coords = [
            [pt[c][k] for pt in pts] for pts in (msgs, sigs) for c in range(2) for k in range(2)
        ]
        planes = np.stack([LY.encode_plain_batch(v) for v in coords])
        idx = np.zeros((n, 1), np.int32)
        idx[: len(sets), 0] = [s.indices[0] for s in sets]
        sig_inf = np.zeros(n, np.int32)
        sig_inf[: len(sets)] = [s.signature is None for s in sets]
        valid = np.zeros(n, np.int32)
        valid[: len(sets)] = 1
        dev = self.device
        return (
            torch.from_numpy(planes).to(dev),
            torch.from_numpy(idx).to(dev),
            torch.from_numpy(sig_inf).to(dev),
            torch.from_numpy(valid).to(dev),
        )

    def _dispatch(self, sets: List[SignatureSet]):
        """Launch one job without syncing; returns what `_collect` needs."""
        planes, idx, sig_inf, valid = self._prepare(sets)
        tx, ty = self.table.device_planes(self.device)
        per_set = KV.verify_each_device(tx, ty, idx, planes, sig_inf, valid)
        decodable = np.array([s.signature is not None for s in sets])
        return per_set, decodable

    @staticmethod
    def _collect(per_set: torch.Tensor, decodable: np.ndarray) -> np.ndarray:
        v = per_set.cpu().numpy()
        if v.shape != (per_set.shape[0],) or v.dtype != np.bool_:
            raise RuntimeError(f"malformed verdict plane {v.dtype} {v.shape}")
        return v[: len(decodable)] & decodable

    def _verify_set_cpu(self, s: SignatureSet) -> bool:
        """Ground-truth verification of one set on the host CPU (pubkeys
        were KeyValidated at registration; messages are in G2 by
        construction)."""
        if s.signature is None:
            return False
        if not C.is_on_curve(C.FP2_OPS, s.signature):
            return False
        if not C.g2_subgroup_check(s.signature):
            return False
        agg = C.multi_add(C.FP_OPS, [self.table.host_affine(i) for i in s.indices])
        if agg is None:
            return False
        return CP.multi_pairing_is_one([(agg, s.message), (CB.NEG_G1_GEN, s.signature)])

    def _device_canary(self) -> bool:
        """One minimal device job (a signature at infinity in the smallest
        bucket); passes iff the verdict plane is well formed and False."""
        per_set, decodable = self._dispatch([SignatureSet.single(0, C.G2_GEN, None)])
        return not bool(self._collect(per_set, decodable)[0])
