"""TorchBlsVerifier: BLS signature-set verification on the port's CUDA
kernels.

Counterpart of `lodestar_tpu/bls/verifier.py` `TpuBlsVerifier` for
decoded single-pubkey sets.  Semantics kept:

  - `verify_signature_sets(sets, opts)` is True iff EVERY set verifies;
    jobs are chunked to `max_job_sets` (MAX_JOB_SETS = 512) and padded to
    the N buckets; every chunk is dispatched (`begin_job`) before any is
    synced (`finish_job`).
  - A job is verified as ONE random-linear-combination batch
    (`kernels/verify.py verify_batch_device`) iff it is batchable, has at
    least 2 sets, every signature is decodable and `LODESTAR_TPU_BLS_RLC`
    is not 0 (the escape hatch); otherwise it gets per-set verdicts
    (`verify_each_device`).  A batchable job that holds an undecodable
    signature counts one batch retry.
  - A failed batch bisects: both halves are dispatched as smaller RLC
    batches before either is synced, a passing half clears its sets, a
    failing one recurses, and a half of at most `bisect_leaf` sets
    (default one 128-lane tile) gets per-set verdicts.  A job at or under
    the leaf retries per set on its own planes.  `_DeviceJob` counts
    `batch_retries` and `batch_sigs_success` as the JAX job does.
  - Randomizers are odd 128-bit scalars from the OS CSPRNG
    (`bls/rand.py`); a seeded `rng` is for tests.
  - `verify_on_main_thread` verifies on the host CPU ground truth;
    `can_accept_work()` is the 512-pending-job backpressure bound.

Not in this slice: the metrics registry and trace spans, the
DeviceSupervisor breaker (a device fault propagates as an exception),
the export cache, wire (compressed) sets, message grouping and
aggregate sets: K > 1 raises ValueError, since it needs the `_k_agg_pk`
kernel of a later slice, and is not quietly sent to the host.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..crypto import bls as CB
from ..crypto import curves as C
from ..crypto import pairing as CP
from ..kernels import layout as LY
from ..kernels import verify as KV
from .pubkey_table import PubkeyTable
from .rand import make_rand_words
from .signature_set import SignatureSet

MAX_JOB_SETS = 512
MAX_PENDING_JOBS = 512
# job sizes pad up to these lane counts (multiples of the JAX package's
# 128-lane tile, kept so both packages run the same shapes)
N_BUCKETS = (128, 256, 512, 1024, 2048)


class VerifyOptions:
    """`batchable`: the job may be verified as one RLC batch (>= 2 sets).
    `verify_on_main_thread`: verify on the host CPU ground truth (the
    latency path for block proposer signatures)."""

    def __init__(self, batchable: bool = False, verify_on_main_thread: bool = False):
        self.batchable = batchable
        self.verify_on_main_thread = verify_on_main_thread


class _DeviceJob:
    """An in-flight job: lazy device results and the host context."""

    __slots__ = (
        "sets", "args", "decodable", "batch_ok", "per_set", "verdicts",
        "batch_retries", "batch_sigs_success", "bisect_depth",
    )

    def __init__(self, sets):
        self.sets = sets
        self.args = None  # prepared device operands (planes, idx, sig_inf, valid)
        self.decodable = None
        self.batch_ok = None  # lazy device scalar: the RLC batch verdict
        self.per_set = None  # lazy device vector: per-set verdicts
        self.verdicts = None  # host per-set bools after a per-set or bisected resolve
        self.batch_retries = 0
        self.batch_sigs_success = 0
        self.bisect_depth = 0  # 0: no bisection ran


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

    def __init__(
        self,
        table: PubkeyTable,
        device=None,
        max_job_sets: int = MAX_JOB_SETS,
        rng: Optional[np.random.Generator] = None,
        bisect_leaf: Optional[int] = None,
    ):
        self.table = table
        self.device = resolve_device(device)
        self.max_job_sets = min(max_job_sets, N_BUCKETS[-1])
        self._pending_jobs = 0
        # None: OS CSPRNG randomizers; a seeded generator for tests
        self.rng = rng
        # LODESTAR_TPU_BLS_RLC=0 forces per-set verdicts for every job:
        # the batch's soundness rests on the randomizers, so operators get
        # a switch.  Default on.
        rlc = os.environ.get("LODESTAR_TPU_BLS_RLC", "1").strip().lower()
        self._use_rlc = rlc not in ("0", "false", "no", "off")
        # below one 128-lane tile every sub-job pads to the same bucket,
        # so bisection stops there and the leaf runs per-set verdicts
        self.bisect_leaf = KV.BT if bisect_leaf is None else bisect_leaf

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
            jobs = [
                self.begin_job(list(sets[i : i + step]), opts.batchable)
                for i in range(0, len(sets), step)
            ]
            ok = True
            for job in jobs:
                ok &= self.finish_job(job)
            return ok
        finally:
            self._pending_jobs -= 1

    def verify_signature_sets_individually(self, sets: Sequence[SignatureSet]) -> List[bool]:
        """Per-set verdicts, in submission order."""
        jobs = [
            self.begin_job(list(sets[i : i + MAX_JOB_SETS]), batchable=False)
            for i in range(0, len(sets), MAX_JOB_SETS)
        ]
        out: List[bool] = []
        for job in jobs:
            self.finish_job(job)
            out.extend(bool(v) for v in job.verdicts)
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

    def _each(self, args) -> torch.Tensor:
        """Launch the per-set path on prepared operands (no sync)."""
        planes, idx, sig_inf, valid = args
        tx, ty = self.table.device_planes(self.device)
        return KV.verify_each_device(tx, ty, idx, planes, sig_inf, valid)

    def begin_job(self, sets: List[SignatureSet], batchable: bool) -> _DeviceJob:
        """Dispatch one job (<= max_job_sets sets) without syncing;
        `finish_job` syncs it.  Routing as `_begin_job` of the JAX package
        (`lodestar_tpu/bls/verifier.py:643`)."""
        job = _DeviceJob(sets)
        if not sets:
            return job
        job.args = self._prepare(sets)
        job.decodable = np.array([s.signature is not None for s in sets])
        batchable_job = batchable and len(sets) >= 2
        if batchable_job and self._use_rlc and job.decodable.all():
            job.batch_ok = self._dispatch_rlc_batch(job.args)
        else:
            if batchable_job and self._use_rlc:
                # an undecodable signature voids the batch: count a retry
                # and go straight to per-set verdicts
                job.batch_retries += 1
            job.per_set = self._each(job.args)
        return job

    def finish_job(self, job: _DeviceJob) -> bool:
        """Sync a begun job; True iff every set verified.  Per-set verdicts
        land in `job.verdicts` unless the batch accepted every set."""
        sets = job.sets
        if not sets:
            return True
        if job.batch_ok is not None:
            per_set = self._resolve_rlc_batch(job)
            if per_set is None:
                return True
        else:
            per_set = self._collect(job.per_set, job.decodable)
        job.verdicts = per_set
        return bool(per_set.all())

    @staticmethod
    def _collect(per_set: torch.Tensor, decodable: np.ndarray) -> np.ndarray:
        v = per_set.cpu().numpy()
        if v.shape != (per_set.shape[0],) or v.dtype != np.bool_:
            raise RuntimeError(f"malformed verdict plane {v.dtype} {v.shape}")
        return v[: len(decodable)] & decodable

    # -- RLC batch resolution and bisection -----------------------------------

    def _resolve_rlc_batch(self, job: _DeviceJob):
        """Sync a dispatched batch verdict: None when the batch accepted
        every set, else the per-set verdicts (job.sets order) by bisection,
        or by a per-set retry when the job is at or under the leaf."""
        sets = job.sets
        if self._batch_verdict(job.batch_ok):
            job.batch_sigs_success += len(sets)
            return None
        job.batch_retries += 1
        if len(sets) > self.bisect_leaf:
            per_set, job.bisect_depth = self._bisect(sets, 1, job)
            return per_set
        job.per_set = self._each(job.args)
        return self._collect(job.per_set, job.decodable)

    def _bisect(self, sets, depth: int, job: Optional[_DeviceJob] = None):
        """Verdicts of a failed batch by recursive halving ->
        (bool ndarray in `sets` order, deepest recursion level)."""
        if len(sets) <= self.bisect_leaf or len(sets) < 2:
            return self._per_set_verdicts(sets), depth
        mid = (len(sets) + 1) // 2
        halves = [sets[:mid], sets[mid:]]
        handles = [self._dispatch_batch(h) for h in halves]
        parts: List[np.ndarray] = []
        max_depth = depth
        for half, handle in zip(halves, handles):
            if self._batch_verdict(handle):
                if job is not None:
                    job.batch_sigs_success += len(half)
                parts.append(np.ones(len(half), bool))
            else:
                v, d = self._bisect(half, depth + 1, job)
                parts.append(v)
                max_depth = max(max_depth, d)
        return np.concatenate(parts), max_depth

    def _dispatch_rlc_batch(self, args) -> torch.Tensor:
        """ONE RLC multi-pairing dispatch with fresh randomizers (no sync);
        shared by the job path and the bisection."""
        planes, idx, sig_inf, valid = args
        rwords = torch.from_numpy(make_rand_words(valid.shape[0], self.rng)).to(self.device)
        tx, ty = self.table.device_planes(self.device)
        batch_ok, _sub_ok = KV.verify_batch_device(tx, ty, idx, planes, sig_inf, rwords, valid)
        return batch_ok

    def _dispatch_batch(self, sets) -> torch.Tensor:
        """Dispatch one sub-batch of the bisection (no sync)."""
        return self._dispatch_rlc_batch(self._prepare(sets))

    def _batch_verdict(self, handle) -> bool:
        """Sync one batch handle to a host bool."""
        return bool(handle)

    def _per_set_verdicts(self, sets) -> np.ndarray:
        """Independent per-set verdicts (the bisection leaf)."""
        decodable = np.array([s.signature is not None for s in sets])
        return self._collect(self._each(self._prepare(sets)), decodable)

    # -- host paths -------------------------------------------------------------

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
        job = self.begin_job([SignatureSet.single(0, C.G2_GEN, None)], batchable=False)
        return not self.finish_job(job)
