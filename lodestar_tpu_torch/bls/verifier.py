"""TorchBlsVerifier: BLS signature-set verification on the port's CUDA
kernels.

Counterpart of `lodestar_tpu/bls/verifier.py` `TpuBlsVerifier`.
Semantics kept:

  - `verify_signature_sets(sets, opts)` is True iff EVERY set verifies;
    jobs are chunked to `max_job_sets` (MAX_JOB_SETS = 512) and padded to
    the N buckets, and each set's pubkey rows to a K bucket (K_BUCKETS;
    K > 1 sets are summed on the device by `agg_pk`); every chunk is
    dispatched (`begin_job`) before any is synced (`finish_job`).
  - A job holds decoded `SignatureSet`s or `WireSignatureSet`s, not both.
    Wire sets are hashed to G2 through `MessageCache` (the `hash_g2`
    kernel) and decompressed on the device (`g2_decompress`); a malformed
    encoding is `host_bad` and fails its set.  A wire job is sorted by
    signing root, as the JAX package sorts it for message grouping, so
    its bisection halves are the JAX plan's; the verdicts come back in
    submission order.
  - Message grouping (`_grouping`): a sorted wire batch, or a bisection
    half of one, with at most 128 distinct signing roots and at least one
    repeated root takes `verify_batch_device_wire_grouped`, whose Miller
    side runs once per distinct root on one 128-lane tile; any other wire
    batch takes `verify_batch_device_wire`.
  - Sets with more than MAX_AGG_INDICES = 2048 indices, and sets with
    external pubkeys, are verified on the host ground truth, as the JAX
    package routes them (a property of the set, not a fallback on a
    device failure); `job.host_sets` counts them.
  - A job is verified as ONE random-linear-combination batch
    (`kernels/verify.py verify_batch_device[_wire]`) iff it is batchable,
    has at least 2 sets, every signature is decodable on the host and
    `LODESTAR_TPU_BLS_RLC` is not 0 (the escape hatch); otherwise it gets
    per-set verdicts (`verify_each_device[_wire]`).  A batchable job that
    holds an undecodable signature counts one batch retry.  A wire x off
    the curve is not host-bad: its batch fails and bisects.
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
  - `aggregate_wire_signatures(groups)` point-adds each group of
    compressed signatures into one compressed aggregate (None where a
    member is undecodable), the seam of `bls/pipeline.py`'s pre-verify
    aggregation: on the verifier's device by `aggregate_g2_sum_device` (the
    CUDA kernels, or their plain versions on the CPU), or on the host when
    `LODESTAR_TPU_AGG_DEVICE=0`.

Supervised seams (`bls/supervisor.py DeviceSupervisor`, the JAX
verifier's, at the same places; `supervisor=` injects one, the default
registers on `metrics.registry` and arms its 60 s watchdog on a CUDA
device only):

  - `begin_job`: with the breaker open the job is a host-mode job (no
    dispatch); a dispatch fault records a classified failure and gives a
    host-mode job (re-raised with supervision disabled).  A caller's input
    error (a job mixing wire and decoded sets, an index outside the table)
    raises and is no device fault.
  - `finish_job`: a host-mode job resolves on the host ground truth
    (`note_host_fallback` counts its sets); otherwise the sync runs under
    the watchdog (`_guarded`), a fault resolves the job on the host, and
    every verdict plane passes `check_verdict_plane`.
  - `verify_signature_sets_individually`: breaker open -> host; a fault ->
    host.
  - `aggregate_wire_signatures`: a device fault falls back to the host sum
    and counts as a breaker failure (re-raised with supervision disabled).
  - `_device_canary`, the breaker's half-open probe (`supervisor.canary`
    unless one is set): one decoded per-set job through the unsupervised
    path, under the watchdog, its verdict plane checked.

The watchdog (`_guarded`): on a CUDA device the guarded call runs on the
caller's thread, and every wait for the card in it (`_host`, through
which each of its syncs first goes) polls a CUDA event
against the call's deadline and raises `DeviceTimeout` past it; the kernel
runs on (it cannot be cancelled), but no service thread blocks on a hung
stream, and no thread is started per call.  Elsewhere (the CPU, whose
plain versions do not hang, or a supervisor's generic call) it is
`supervisor.run_guarded`, the JAX package's thread per call, and
`finish_job` then runs against a shallow clone of the job, so that a late,
abandoned thread writes only to its clone.

Metrics (`metrics=`, a `utils/metrics.py BlsPoolMetrics` or any object
with its fields; the node passes its own): what the JAX verifier
observes, where it observes it (job_time, time_per_sig_set, batch_size,
verify_seconds{total,host,device}, success_jobs, invalid_sets,
batchable_sigs, batch_retries, rlc_fallback, rlc_bisect_depth,
batch_sigs_success), and the spans `bls.verify`, `bls.begin_job`,
`bls.finish_job` and `bls.rlc_batch` (`observability/tracer.py`).

Kernels are built at construction: on a CUDA device `__init__` builds and
loads every kernel library (`kernels/build.py load_all`) before any
supervised call, outside the supervisor, so a build failure raises there
and never becomes a breaker trip with host verdicts.  Every kernel
launches on the calling thread's current stream; the service begins jobs
on its dispatcher thread and syncs them on its resolver thread, which is
safe while every thread keeps the default stream.  `begin_job` does not
wait for the card: its operands are copied with `non_blocking` (a
blocking copy waits for the stream, and so for every kernel queued
before it), so the only waits are the verdict copies in `finish_job` and
a `MessageCache` miss.

Not in this slice: the export cache (the CUDA-graph dispatch cache).
"""

from __future__ import annotations

import copy
import logging
import os
import threading
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..crypto import bls as CB
from ..crypto import curves as C
from ..crypto import pairing as CP
from ..kernels import build as B
from ..kernels import layout as LY
from ..kernels import verify as KV
from ..observability import enabled as _trace_enabled
from ..observability import trace_span as _trace_span
from ..utils.metrics import BlsPoolMetrics
from .ingest import MessageCache, encode_wire_planes
from .pubkey_table import PubkeyTable
from .rand import make_rand_words
from .signature_set import SignatureSet, WireSignatureSet
from .supervisor import BadDeviceOutput, DeviceSupervisor, DeviceTimeout, check_verdict_plane, classify_failure

MAX_JOB_SETS = 512
MAX_PENDING_JOBS = 512
# job sizes pad up to these lane counts (multiples of the JAX package's
# 128-lane tile, kept so both packages run the same shapes)
N_BUCKETS = (128, 256, 512, 1024, 2048)
# pubkeys per set pad up to these counts; a larger aggregate (beyond a
# full 2048-validator committee) is verified on the host
K_BUCKETS = (1, 4, 16, 64, 512, 2048)
MAX_AGG_INDICES = K_BUCKETS[-1]
# the watchdog's pause between polls while a guarded call waits for the
# card: sleep(0) releases the GIL and yields the core, and returns in
# ~0.03 ms on the H100's host, where a sleep of 50 us took ~0.9 ms
# (tools/watchdog_cost.py)
WATCH_POLL_S = 0.0


class VerifyOptions:
    """`batchable`: the job may be verified as one RLC batch (>= 2 sets).
    `verify_on_main_thread`: verify on the host CPU ground truth (the
    latency path for block proposer signatures).  `priority`: a
    block-critical set, which the pipeline routes onto its short-deadline
    lane.  `peer_id` / `topic`: the publisher the pre-verify aggregation
    charges through the gossip scorer when bisection isolates this
    submission's signature as invalid."""

    def __init__(
        self,
        batchable: bool = False,
        verify_on_main_thread: bool = False,
        priority: bool = False,
        peer_id: Optional[str] = None,
        topic: Optional[str] = None,
    ):
        self.batchable = batchable
        self.verify_on_main_thread = verify_on_main_thread
        self.priority = priority
        self.peer_id = peer_id
        self.topic = topic


class UnknownIndex(IndexError):
    """A set names a validator index outside the pubkey table: the
    caller's error, never a device fault."""


class DecodedArgs(NamedTuple):
    """Device operands of a decoded job, in the order of
    `verify_each_device` after the table."""

    idx: torch.Tensor  # [n, K] table rows
    kmask: torch.Tensor  # [n, K]
    planes: torch.Tensor  # [8, 12, n] plain limbs of H(m) and the signature
    sig_inf: torch.Tensor  # [n]
    valid: torch.Tensor  # [n]


class WireArgs(NamedTuple):
    """Device operands of a wire job, in the order of
    `verify_each_device_wire` after the table."""

    idx: torch.Tensor
    kmask: torch.Tensor
    msg: torch.Tensor  # [4, 12, n] plain limbs of H(m)
    sig_x: torch.Tensor  # [2, 12, n] plain limbs of the compressed x
    sig_flags: torch.Tensor  # [2, n] (sign, infinity)
    valid: torch.Tensor


class _DeviceJob:
    """An in-flight job: lazy device results and the host context."""

    __slots__ = (
        "sets", "wire", "args", "decodable", "batch_ok", "per_set", "verdicts",
        "batch_retries", "batch_sigs_success", "bisect_depth", "order", "host",
        "n_submitted", "host_mode", "n_bucket",
    )

    def __init__(self, sets, wire: bool = False):
        self.sets = sets  # the device sets, in lane order
        self.wire = wire
        # breaker open or dispatch failed: no device operands; finish_job
        # resolves every set on the host ground truth
        self.host_mode = False
        self.n_bucket = 0  # padded N of the dispatched job
        self.args = None  # DecodedArgs or WireArgs
        self.decodable = None
        self.batch_ok = None  # lazy device scalar: the RLC batch verdict
        self.per_set = None  # lazy device vector: per-set verdicts
        self.verdicts = None  # host per-set bools (submission order) after a per-set or bisected resolve
        self.batch_retries = 0
        self.batch_sigs_success = 0
        self.bisect_depth = 0  # 0: no bisection ran
        # order[j]: submission position of device lane j (None: identity);
        # it restores the caller's order after the sort by signing root
        # (JAX `unsort`) and around the host-routed sets
        self.order = None
        self.host = {}  # submission position -> host verdict
        self.n_submitted = len(sets)

    @property
    def ok_big(self) -> bool:
        """Every host-routed set verified (the JAX job's field, which the
        service reads to slice a failed merged job's verdicts)."""
        return all(self.host.values())

    @property
    def host_sets(self) -> int:
        """Sets of the job verified on the host (routed there by a property
        of the set: more than MAX_AGG_INDICES indices, or external keys)."""
        return len(self.host)


def resolve_device(device=None) -> torch.device:
    """None means the CUDA device; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _bucket(n: int, buckets=None) -> int:
    buckets = N_BUCKETS if buckets is None else buckets
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


def _is_wire(s) -> bool:
    """A wire set carries its signing root (and the signature as bytes), a
    decoded one the hashed message.  Told apart by these fields, not by
    class: the node hands over the JAX package's set classes, which the
    port does not import."""
    return hasattr(s, "signing_root")


def _host_routed(s) -> bool:
    """Sets the JAX package verifies on the host: an aggregate beyond the
    largest K bucket, or keys outside the registry."""
    if len(s.indices) > MAX_AGG_INDICES:
        return True
    return getattr(s, "pubkeys", None) is not None or getattr(s, "external_pubkeys", None) is not None


class TorchBlsVerifier:
    """The device-backed verifier over one pubkey table."""

    def __init__(
        self,
        table: PubkeyTable,
        device=None,
        max_job_sets: int = MAX_JOB_SETS,
        rng: Optional[np.random.Generator] = None,
        bisect_leaf: Optional[int] = None,
        metrics=None,
        supervisor=None,
    ):
        self.table = table
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every kernel library built and loaded now, outside the
            # supervisor: a build failure raises here, and no supervised
            # call ever waits on nvcc
            B.load_all()
        self.metrics = metrics or BlsPoolMetrics()
        self.max_job_sets = min(max_job_sets, N_BUCKETS[-1])
        # signing root -> hashed G2 message, hashed on this device
        self.messages = MessageCache(device=self.device)
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
        # every device seam runs under this breaker (LODESTAR_TPU_BLS_BREAKER=0
        # disables supervision)
        self.supervisor = supervisor or DeviceSupervisor(registry=self.metrics.registry, device=self.device)
        if self.supervisor.canary is None:
            self.supervisor.canary = self._device_canary
        # the deadline and seam of the guarded call running on this thread
        self._watch = threading.local()

    def can_accept_work(self) -> bool:
        return self._pending_jobs < MAX_PENDING_JOBS

    def close(self) -> None:
        self.supervisor.close()

    # -- entry points -------------------------------------------------------

    def verify_signature_sets(self, sets: Sequence, opts: Optional[VerifyOptions] = None) -> bool:
        if not sets:
            return True
        opts = opts or VerifyOptions()
        t_start = time.perf_counter()
        self._pending_jobs += 1
        try:
            with _trace_span(
                "bls.verify",
                batch_size=len(sets),
                batchable=opts.batchable,
                main_thread=opts.verify_on_main_thread,
            ):
                if opts.verify_on_main_thread:
                    verdicts = [self._verify_set_host(s) for s in sets]
                    self._count_verdicts(verdicts)
                    return all(verdicts)
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
            dt = time.perf_counter() - t_start
            self.metrics.job_time.observe(dt)
            self.metrics.time_per_sig_set.observe(dt / len(sets))
            self.metrics.batch_size.observe(len(sets))
            self.metrics.verify_seconds.observe("total", dt)

    def verify_signature_sets_individually(self, sets: Sequence) -> List[bool]:
        """Per-set verdicts, in submission order; wire and decoded sets may
        be mixed (each kind runs in its own jobs).  Supervised like the job
        paths: breaker open -> host ground truth; a device fault trips and
        falls back, so the caller always gets verdicts."""
        sup = self.supervisor
        if not sup.device_allowed():
            sup.note_host_fallback(len(sets))
            return [self._verify_set_host(s) for s in sets]
        try:
            out = self._guarded(lambda: self._verify_individually_device(sets), "individually")
            sup.record_success()
            return out
        except UnknownIndex:
            raise
        except Exception as e:  # noqa: BLE001 — verdicts keep flowing through the host path
            if not sup.active:
                raise
            sup.record_failure(classify_failure(e), "individually", str(e))
            sup.note_host_fallback(len(sets))
            return [self._verify_set_host(s) for s in sets]

    def _verify_individually_device(self, sets: Sequence) -> List[bool]:
        out: List[Optional[bool]] = [None] * len(sets)
        for wire in (False, True):
            pos = [i for i, s in enumerate(sets) if _is_wire(s) == wire]
            jobs = [
                (pos[i : i + MAX_JOB_SETS], self._begin_job([sets[j] for j in pos[i : i + MAX_JOB_SETS]], False))
                for i in range(0, len(pos), MAX_JOB_SETS)
            ]
            for chunk, job in jobs:
                self._finish_job(job)
                for j, v in zip(chunk, job.verdicts):
                    out[j] = bool(v)
        return out

    def _count_verdicts(self, verdicts) -> None:
        good = int(np.sum(verdicts))
        self.metrics.success_jobs.inc(good)
        self.metrics.invalid_sets.inc(len(verdicts) - good)

    # -- job execution --------------------------------------------------------

    def _kslots(self, sets, n: int):
        """Table rows [n, K] and their mask, K the sets' K bucket; every
        index must be a registered row."""
        k = _bucket(max(len(s.indices) for s in sets), K_BUCKETS)
        idx = np.zeros((n, k), np.int32)
        kmask = np.zeros((n, k), np.int32)
        for i, s in enumerate(sets):
            for j in s.indices:
                if not 0 <= j < len(self.table):
                    raise UnknownIndex(f"validator index {j} is not in the pubkey table")
            idx[i, : len(s.indices)] = s.indices
            kmask[i, : len(s.indices)] = 1
        return idx, kmask

    def _to_device(self, *arrays):
        """Host arrays -> tensors on the verifier's device, queued on the
        current stream without waiting for the card (`non_blocking`: the
        CUDA runtime stages pageable memory before the call returns; a
        blocking copy waits for every kernel queued before it, and pinning
        each array made the main path slower)."""
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True) for a in arrays]

    def _guarded(self, fn, name: str):
        """`fn()` under the supervisor's watchdog.  On a CUDA device with a
        deadline armed it runs on this thread, and `_host` polls each wait
        for the card against the deadline; otherwise `run_guarded`."""
        sup = self.supervisor
        if self.device.type != "cuda" or not sup.active or not sup.job_deadline_s:
            return sup.run_guarded(fn, name)
        outer = getattr(self._watch, "deadline", None), getattr(self._watch, "name", None)
        self._watch.deadline, self._watch.name = time.monotonic() + sup.job_deadline_s, name
        try:
            return fn()
        finally:
            self._watch.deadline, self._watch.name = outer

    def _host(self, t):
        """A device tensor on the host (anything else as it is).  Inside
        `_guarded` on the card the wait polls a CUDA event recorded behind
        the queued kernels, and raises DeviceTimeout once the guarded
        call's deadline has passed."""
        if not isinstance(t, torch.Tensor):
            return t
        deadline = getattr(self._watch, "deadline", None)
        if deadline is not None and t.is_cuda:
            done = getattr(self._watch, "event", None)
            if done is None:  # one event a thread, recorded again at each wait
                done = self._watch.event = torch.cuda.Event()
            done.record()
            while not done.query():
                if time.monotonic() > deadline:
                    raise DeviceTimeout(
                        f"{self._watch.name} exceeded the {self.supervisor.job_deadline_s:.1f}s job deadline"
                    )
                time.sleep(WATCH_POLL_S)
        return t.cpu()

    def _prepare(self, sets: List[SignatureSet]) -> DecodedArgs:
        """Pad decoded sets into an (N, K) bucket and encode the device
        operands: plain limb planes [8, 12, n] (H(m) x0 x1 y0 y1, sig x0 x1
        y0 y1), table rows and mask [n, K], signature-infinity and valid
        flags [n]."""
        n = _bucket(len(sets))
        idx, kmask = self._kslots(sets, n)
        g2 = C.G2_GEN
        msgs = [s.message for s in sets] + [g2] * (n - len(sets))
        sigs = [g2 if s.signature is None else s.signature for s in sets]
        sigs += [g2] * (n - len(sets))
        coords = [
            [pt[c][k] for pt in pts] for pts in (msgs, sigs) for c in range(2) for k in range(2)
        ]
        planes = np.stack([LY.encode_plain_batch(v) for v in coords])
        sig_inf = np.zeros(n, np.int32)
        sig_inf[: len(sets)] = [s.signature is None for s in sets]
        valid = np.zeros(n, np.int32)
        valid[: len(sets)] = 1
        return DecodedArgs(*self._to_device(idx, kmask, planes, sig_inf, valid))

    def _prepare_wire(self, sets: List[WireSignatureSet]):
        """Wire sets -> (WireArgs, host_bad [n]): messages hashed through
        the MessageCache, signatures as compressed-x limbs and flag bits."""
        n = _bucket(len(sets))
        idx, kmask = self._kslots(sets, n)
        valid = np.zeros(n, np.int32)
        valid[: len(sets)] = 1
        msgs = self.messages.get_many([s.signing_root for s in sets])
        msgs = msgs + [C.G2_GEN] * (n - len(sets))
        msg = np.stack([LY.encode_plain_batch([m[c][k] for m in msgs]) for c in range(2) for k in range(2)])
        x0, x1, flags, host_bad = encode_wire_planes([s.signature for s in sets], n)
        args = WireArgs(*self._to_device(idx, kmask, msg, np.stack([x0, x1]), flags, valid))
        return args, host_bad

    def _each(self, args) -> torch.Tensor:
        """Launch the per-set path on prepared operands (no sync)."""
        tx, ty = self.table.device_planes(self.device)
        if isinstance(args, WireArgs):
            return KV.verify_each_device_wire(tx, ty, *args)
        return KV.verify_each_device(tx, ty, *args)

    def begin_job(self, sets: List, batchable: bool) -> _DeviceJob:
        """Dispatch one job (<= max_job_sets sets) without syncing;
        `finish_job` syncs it.  Routing as `_begin_job` of the JAX package
        (`lodestar_tpu/bls/verifier.py:577-663`), supervised as its
        `begin_job`.  Everything here is host work (encoding, padding,
        dispatch): it feeds `verify_seconds{phase="host"}`."""
        t0 = time.perf_counter()
        wire = bool(sets) and _is_wire(sets[0])
        if any(_is_wire(s) != wire for s in sets):
            raise ValueError("begin_job needs a job of only wire or only decoded sets")
        with _trace_span("bls.begin_job", sets=len(sets), batchable=batchable) as span:
            sup = self.supervisor
            if not sup.device_allowed():
                # breaker open: no dispatch; the job resolves on the host
                # at finish time, so submitters never block
                job = self._begin_job_host(sets, wire)
            else:
                try:
                    job = self._begin_job(sets, batchable, span)
                except UnknownIndex:
                    raise
                except Exception as e:  # noqa: BLE001 — a dispatch fault trips the breaker
                    if not sup.active:
                        raise
                    sup.record_failure(classify_failure(e), "begin_job", str(e))
                    job = self._begin_job_host(sets, wire)
        self.metrics.verify_seconds.observe("host", time.perf_counter() - t0)
        return job

    @staticmethod
    def _begin_job_host(sets: List, wire: bool) -> _DeviceJob:
        """A host-mode job: no device operands, no dispatch; `finish_job`
        verifies every set through `_verify_set_host`."""
        job = _DeviceJob(list(sets), wire)
        job.host_mode = True
        return job

    def _begin_job(self, sets: List, batchable: bool, span=None) -> _DeviceJob:
        """The unsupervised dispatch of `begin_job` (the canary's and
        `verify_signature_sets_individually`'s path too)."""
        wire = bool(sets) and _is_wire(sets[0])
        host = {i: self._verify_set_host(s) for i, s in enumerate(sets) if _host_routed(s)}
        if host:
            self._count_verdicts(list(host.values()))
        pos = [i for i in range(len(sets)) if i not in host]
        job = _DeviceJob([sets[i] for i in pos], wire)
        job.host, job.n_submitted = host, len(sets)
        if host:
            job.order = np.asarray(pos, np.int64)
        if not job.sets:
            return job
        if wire:
            # sorted by signing root, as the JAX package sorts for message
            # grouping: the bisection halves are then its halves
            perm = sorted(range(len(job.sets)), key=lambda i: job.sets[i].signing_root)
            if perm != list(range(len(job.sets))):
                job.sets = [job.sets[i] for i in perm]
                job.order = np.asarray(pos, np.int64)[perm]
        job.args, job.decodable = self._prepare_any(job.sets)
        job.n_bucket = _bucket(len(job.sets))
        if span is not None and _trace_enabled():
            span.set(wire=wire, n_bucket=job.n_bucket,
                     k_bucket=_bucket(max(len(s.indices) for s in job.sets), K_BUCKETS))
        batchable_job = batchable and len(job.sets) >= 2
        if batchable_job:
            self.metrics.batchable_sigs.inc(len(job.sets))
        if batchable_job and self._use_rlc and job.decodable.all():
            job.batch_ok = self._dispatch_rlc_batch(job.args, job.sets)
        else:
            if batchable_job and self._use_rlc:
                # an undecodable signature voids the batch: count a retry
                # and go straight to per-set verdicts
                self.metrics.batch_retries.inc()
                job.batch_retries += 1
            job.per_set = self._each(job.args)
        return job

    def finish_job(self, job: _DeviceJob) -> bool:
        """Sync a begun job; True iff every set verified.  Per-set verdicts
        (submission order, host-routed sets included) land in
        `job.verdicts` unless the batch accepted every set.  Supervised as
        the JAX package's `finish_job`; it feeds
        `verify_seconds{phase="device"}`."""
        t0 = time.perf_counter()
        with _trace_span("bls.finish_job", sets=len(job.sets)):
            sup = self.supervisor
            if job.host_mode:
                ok = self._finish_job_host(job)
            elif not sup.active:
                ok = self._finish_job(job)
            else:
                # with the watchdog on a thread of its own the sync runs
                # against a shallow clone: a timeout abandons (cannot
                # cancel) that thread, and a late orphan must write only
                # to its clone, never to the job whose verdicts the caller
                # reads (on a CUDA device the watchdog starts no thread)
                threaded = sup.job_deadline_s and self.device.type != "cuda"
                target = copy.copy(job) if threaded else job
                try:
                    ok = self._guarded(lambda: self._finish_job(target), "finish_job")
                    if target is not job:
                        job.verdicts = target.verdicts
                        job.batch_retries = target.batch_retries
                        job.batch_sigs_success = target.batch_sigs_success
                        job.bisect_depth = target.bisect_depth
                    sup.record_success()
                except Exception as e:  # noqa: BLE001 — a sync fault resolves this job on the host
                    sup.record_failure(classify_failure(e), "finish_job", str(e))
                    ok = self._finish_job_host(job)
        self.metrics.verify_seconds.observe("device", time.perf_counter() - t0)
        return ok

    def _finish_job(self, job: _DeviceJob) -> bool:
        if not job.sets:
            if job.host:
                job.verdicts = np.array([job.host[i] for i in range(job.n_submitted)])
            return job.ok_big
        if job.batch_ok is not None:
            per_set = self._resolve_rlc_batch(job)
            if per_set is None:
                return job.ok_big  # the batch accepted every set
        else:
            per_set = self._collect(job.per_set, job.decodable, "each")
        self._count_verdicts(per_set)
        job.verdicts = self._in_submission_order(job, per_set)
        return bool(job.verdicts.all())

    def _finish_job_host(self, job: _DeviceJob) -> bool:
        """Resolve a job on the host ground truth: a host-mode job (never
        dispatched) or one whose device sync failed (its sets may be
        sorted; the verdicts come back in submission order)."""
        if not job.sets:
            return self._finish_job(job)
        per_set = np.array([self._verify_set_host(s) for s in job.sets], bool)
        self._count_verdicts(per_set)
        self.supervisor.note_host_fallback(len(job.sets))
        job.verdicts = self._in_submission_order(job, per_set)
        return bool(job.verdicts.all())

    @staticmethod
    def _in_submission_order(job: _DeviceJob, per_set: np.ndarray) -> np.ndarray:
        """Per-set verdicts of the job's device sets (lane order) -> every
        submitted set's verdict in submission order."""
        if job.order is None:
            return per_set
        out = np.zeros(job.n_submitted, bool)
        out[job.order] = per_set
        for i, v in job.host.items():
            out[i] = v
        return out

    def _collect(self, per_set: torch.Tensor, decodable: np.ndarray, name: str) -> np.ndarray:
        """Sync a verdict plane; a malformed one raises BadDeviceOutput."""
        v = check_verdict_plane(self._host(per_set).numpy(), len(decodable), name)
        if v.ndim != 1 or v.dtype != np.bool_:
            raise BadDeviceOutput(f"{name}: malformed verdict plane {v.dtype} {v.shape}")
        return v[: len(decodable)] & decodable

    # -- RLC batch resolution and bisection -----------------------------------

    def _resolve_rlc_batch(self, job: _DeviceJob):
        """Sync a dispatched batch verdict: None when the batch accepted
        every set, else the per-set verdicts (job.sets order) by bisection,
        or by a per-set retry when the job is at or under the leaf."""
        sets = job.sets
        with _trace_span("bls.rlc_batch", sets=len(sets), n_bucket=job.n_bucket) as span:
            if self._batch_verdict(job.batch_ok):
                if _trace_enabled():
                    span.set(accepted=True, bisect_depth=0)
                self.metrics.batch_sigs_success.inc(len(sets))
                job.batch_sigs_success += len(sets)
                self.metrics.success_jobs.inc(len(sets))
                return None
            self.metrics.batch_retries.inc()
            job.batch_retries += 1
            self.metrics.rlc_fallback.inc()
            if len(sets) > self.bisect_leaf:
                per_set, job.bisect_depth = self._bisect(sets, 1, job)
                self.metrics.rlc_bisect_depth.observe(job.bisect_depth)
            else:
                job.per_set = self._each(job.args)
                per_set = self._collect(job.per_set, job.decodable, "each")
            if _trace_enabled():
                span.set(accepted=False, bisect_depth=job.bisect_depth)
        return per_set

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
                self.metrics.batch_sigs_success.inc(len(half))
                parts.append(np.ones(len(half), bool))
            else:
                v, d = self._bisect(half, depth + 1, job)
                parts.append(v)
                max_depth = max(max_depth, d)
        return np.concatenate(parts), max_depth

    def _dispatch_rlc_batch(self, args, sets) -> torch.Tensor:
        """ONE RLC multi-pairing dispatch with fresh randomizers (no sync);
        shared by the job path and the bisection, so both choose the entry
        alike: a wire job (sorted by signing root) takes the grouped entry
        whenever `_grouping` applies."""
        n = args.valid.shape[0]
        rwords, = self._to_device(make_rand_words(n, self.rng))
        tx, ty = self.table.device_planes(self.device)
        if not isinstance(args, WireArgs):
            batch_ok, _sub_ok = KV.verify_batch_device(tx, ty, *args[:-1], rwords, args.valid)
            return batch_ok
        grouping = self._grouping(sets, n)
        if grouping is not None:
            batch_ok, _sub_ok = KV.verify_batch_device_wire_grouped(
                tx, ty, *args[:-1], *self._to_device(*grouping), rwords, args.valid
            )
            return batch_ok
        batch_ok, _sub_ok = KV.verify_batch_device_wire(tx, ty, *args[:-1], rwords, args.valid)
        return batch_ok

    @staticmethod
    def _grouping(sets, n: int):
        """Distinct-message group arrays (group [n], head_lanes [BT],
        glive [BT]) for `verify_batch_device_wire_grouped`, or None where
        grouping does not apply: more distinct roots than one 128-lane
        tile, or no repeated root (nothing to collapse).  `sets` must be
        sorted by signing root, as `begin_job` sorts them (JAX `_grouping`,
        `lodestar_tpu/bls/verifier.py:668-702`)."""
        roots = [s.signing_root for s in sets]
        group = np.zeros(n, np.int32)
        heads = []
        g = 0
        for i in range(1, len(sets)):
            if roots[i] != roots[i - 1]:
                heads.append(i - 1)
                g += 1
            group[i] = g
        heads.append(len(sets) - 1)
        n_groups = g + 1
        if n_groups > KV.BT or n_groups == len(sets):
            return None
        # padding lanes get fresh ids, so none merges into the last group
        group[len(sets) :] = np.arange(n_groups, n_groups + n - len(sets), dtype=np.int32)
        head_lanes = np.zeros(KV.BT, np.int32)
        head_lanes[:n_groups] = heads
        glive = np.zeros(KV.BT, np.int32)
        glive[:n_groups] = 1
        return group, head_lanes, glive

    def _prepare_any(self, sets):
        """(operands, host-decodable mask) of a homogeneous sub-job."""
        if _is_wire(sets[0]):
            args, host_bad = self._prepare_wire(sets)
            return args, ~host_bad[: len(sets)]
        return self._prepare(sets), np.array([s.signature is not None for s in sets])

    def _dispatch_batch(self, sets) -> torch.Tensor:
        """Dispatch one sub-batch of the bisection (no sync)."""
        return self._dispatch_rlc_batch(self._prepare_any(sets)[0], sets)

    def _batch_verdict(self, handle) -> bool:
        """Sync one batch handle to a host bool."""
        return bool(self._host(handle))

    def _per_set_verdicts(self, sets) -> np.ndarray:
        """Independent per-set verdicts (the bisection leaf)."""
        args, decodable = self._prepare_any(sets)
        return self._collect(self._each(args), decodable, "each")

    # -- pre-verify signature aggregation -----------------------------------------

    def aggregate_wire_signatures(self, groups: Sequence[Sequence[bytes]]) -> List[Optional[bytes]]:
        """Point-add each group's compressed G2 signatures -> one compressed
        aggregate per group, None where a member is undecodable (the
        caller then verifies the members unaggregated).  The sum seam of
        the pre-verify aggregation (`bls/pipeline.py`, `bls/aggregator.py`):
        on the verifier's device, one `aggregate_g2_sum_device` dispatch per
        chunk of at most 128 groups, unless LODESTAR_TPU_AGG_DEVICE=0
        selects the host path.  A device fault falls back to the host sum
        and counts as a breaker failure."""
        groups = [list(g) for g in groups]
        if not groups:
            return []
        sup = self.supervisor
        if self._use_agg_device() and sup.device_allowed():
            try:
                out = self._guarded(lambda: self._aggregate_wire_device(groups), "agg_g2_sum")
                sup.record_success()
                return out
            except Exception as e:  # noqa: BLE001 — aggregation never takes verification down
                if not sup.active:
                    raise
                sup.record_failure(classify_failure(e), "agg_g2_sum", str(e))
                logging.getLogger("lodestar_tpu_torch").warning("device signature aggregation failed (%s); host path", e)
        return [self._aggregate_wire_host(g) for g in groups]

    @staticmethod
    def _use_agg_device() -> bool:
        env = os.environ.get("LODESTAR_TPU_AGG_DEVICE", "1")
        return env.strip().lower() not in ("0", "false", "no", "off", "")

    @staticmethod
    def _aggregate_wire_host(sigs: List[bytes]) -> Optional[bytes]:
        """The host ground truth: decompress every member, add, compress."""
        pts = []
        for s in sigs:
            try:
                pts.append(C.g2_decompress(s))
            except ValueError:
                return None
        return C.g2_compress(C.multi_add(C.FP2_OPS, pts))

    def _aggregate_wire_device(self, groups: List[List[bytes]]) -> List[Optional[bytes]]:
        """The non-empty groups in chunks of at most BT groups and
        N_BUCKETS[-1] signatures (a group larger than that alone in its
        chunk), one dispatch each; an empty group sums to infinity, as on
        the host path."""
        sums = iter(self._aggregate_nonempty_device([g for g in groups if g]))
        return [next(sums) if g else C.g2_compress(None) for g in groups]

    def _aggregate_nonempty_device(self, groups: List[List[bytes]]) -> List[Optional[bytes]]:
        out: List[Optional[bytes]] = []
        start = 0
        while start < len(groups):
            chunk: List[List[bytes]] = []
            total = 0
            while (
                start + len(chunk) < len(groups)
                and len(chunk) < KV.BT
                and (not chunk or total + len(groups[start + len(chunk)]) <= N_BUCKETS[-1])
            ):
                total += len(groups[start + len(chunk)])
                chunk.append(groups[start + len(chunk)])
            out.extend(self._aggregate_chunk_device(chunk, total))
            start += len(chunk)
        return out

    def _aggregate_chunk_device(self, chunk: List[List[bytes]], total: int) -> List[Optional[bytes]]:
        """One dispatch: the segmented G2 sum of the decompressed
        signatures, the group totals to affine on the device, compressed on
        the host (y is known: no square root)."""
        n = _bucket(total)
        x0, x1, flags, host_bad = encode_wire_planes([s for g in chunk for s in g], n)
        group = np.zeros(n, np.int32)
        head_lanes = np.zeros(KV.BT, np.int32)
        glive = np.zeros(KV.BT, np.int32)
        pos = 0
        for gi, g in enumerate(chunk):
            group[pos : pos + len(g)] = gi
            pos += len(g)
            head_lanes[gi] = pos - 1
            glive[gi] = 1
        # padding lanes get fresh ids, so none merges into the last group
        group[total:] = np.arange(len(chunk), len(chunk) + n - total, dtype=np.int32)
        a, g_inf, ok = KV.aggregate_g2_sum_device(
            *self._to_device(np.stack([x0, x1]), flags, group, head_lanes, glive)
        )
        ok = (self._host(ok[0, :total]).numpy() != 0) & ~host_bad[:total]
        g_inf = g_inf[0].cpu().numpy() != 0
        coords = [LY.decode_batch(p) for p in a.cpu().numpy().reshape(4, LY.NL, KV.BT)]
        out: List[Optional[bytes]] = []
        pos = 0
        for gi, g in enumerate(chunk):
            members_ok = bool(ok[pos : pos + len(g)].all())
            pos += len(g)
            if not members_ok:
                # an undecodable member was left out of the sum: the total
                # is not the group's aggregate
                out.append(None)
            elif g_inf[gi]:
                out.append(C.g2_compress(None))
            else:
                x0g, x1g, y0g, y1g = (c[gi] for c in coords)
                out.append(C.g2_compress(((x0g, x1g), (y0g, y1g))))
        return out

    # -- host paths -------------------------------------------------------------

    def _verify_set_host(self, s) -> bool:
        """Ground-truth verdict of one set, wire or decoded."""
        return self._verify_set_cpu(s.decode() if _is_wire(s) else s)

    def _verify_set_cpu(self, s: SignatureSet) -> bool:
        """Ground-truth verification of one decoded set on the host CPU.
        Registry pubkeys were KeyValidated at registration; external keys
        are KeyValidated here; messages are in G2 by construction."""
        if s.signature is None:
            return False
        if not C.is_on_curve(C.FP2_OPS, s.signature):
            return False
        if not C.g2_subgroup_check(s.signature):
            return False
        if s.external_pubkeys is not None:
            for pk in s.external_pubkeys:
                if pk is None or not C.is_on_curve(C.FP_OPS, pk) or not C.g1_subgroup_check(pk):
                    return False
            keys = list(s.external_pubkeys)
        else:
            keys = [self.table.host_affine(i) for i in s.indices]
        agg = C.multi_add(C.FP_OPS, keys)
        if agg is None:  # an aggregate pubkey at infinity never verifies
            return False
        return CP.multi_pairing_is_one([(agg, s.message), (CB.NEG_G1_GEN, s.signature)])

    def _device_canary(self) -> bool:
        """The breaker's half-open probe: one minimal decoded per-set job (a
        signature at infinity in the smallest bucket) through the
        unsupervised path, under the watchdog; passes iff the verdict plane
        is well formed and its verdict False."""

        def _probe() -> bool:
            args = self._prepare([SignatureSet.single(0, C.G2_GEN, None)])
            n = args.valid.shape[0]
            v = check_verdict_plane(self._host(self._each(args)).numpy(), n, "canary")
            return not bool(v[0])

        return bool(self._guarded(_probe, "canary"))
