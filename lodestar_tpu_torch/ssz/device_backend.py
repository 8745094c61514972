"""Supervised device merkleization backend, the counterpart of
`lodestar_tpu/ssz/device_backend.py` on the port's SHA-256 kernels
(`kernels/sha256.py`, `csrc/sha256.cu`).

Three dispatch seams, one kernel each, with the JAX package's return
conventions (numpy in, numpy out, None when the caller is to hash on
the host):

  ``hash_level``       one tree level (`hash_pairs`), launched on exactly
                       its n rows; levels below ``min_level_rows`` stay on
                       the host;
  ``sweep``            K levels of a dirty batch in one launch
                       (`forest_sweep`; ChunkTree builds the plan);
  ``validator_roots``  the validator leaves packed and hashed to their
                       container roots (`validator_roots`).

The host ``hash_pairs`` (ssz/hasher.py) stays the bit-identical ground
truth and the degraded path: the port's ``DeviceSupervisor`` breaker
supervises every dispatch, a classified fault trips it, an open breaker
sends every level to the host (no root is lost), and a canary (one hash
on the card against hashlib) closes it again.

``device=None`` means the CUDA device, and the kernels are built at
construction, outside the supervisor, so a failed build raises there and
never shows up later as host levels under the breaker; ``device="cpu"``
runs the kernels' plain versions.  The object is duck-typed to the JAX
package's seams, so `lodestar_tpu.ssz.device_backend.set_backend` takes
it as well.

The process backend (``maybe_backend``) is the card's unless the process
opts out, by ``set_backend(None)`` or ``LODESTAR_TPU_HTR_BACKEND=host``
(the host path, the JAX package's default).  Without a card and without
an opt-out it raises: it never takes the host path quietly.

Metrics (the JAX package's names): ``lodestar_htr_device_levels_total``
and ``lodestar_htr_device_dispatches_total`` per entry,
``lodestar_htr_device_seconds``, ``lodestar_htr_host_fallback_levels_total``;
every dispatch runs in an ``htr.device_dispatch`` span.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..bls.supervisor import BadDeviceOutput, DeviceSupervisor, DeviceTimeout, classify_failure
from ..bls.verifier import WATCH_POLL_S, resolve_device
from ..kernels import build as B
from ..kernels import sha256 as SK
from ..observability.tracer import trace_span
from ..utils.metrics import Registry

_U8 = np.uint8

# below this many pairs a dispatch costs more than the host hashes it
# saves (the JAX package's cutoff); the sweep path is exempt
DEFAULT_MIN_LEVEL_ROWS = 1024

class DeviceMerkleBackend:
    """Breaker-supervised dispatcher over the SHA-256 kernels.

    ``fault`` is the chaos seam: set it to "error", "backend" or
    "bad_output" to make every dispatch fail that way until ``heal()``.
    """

    def __init__(
        self,
        device=None,
        supervisor: Optional[DeviceSupervisor] = None,
        registry: Optional[Registry] = None,
        min_level_rows: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            B.load("sha256")  # builds every kernel library, before any supervised call
        if min_level_rows is None:
            env = os.environ.get("LODESTAR_TPU_HTR_MIN_ROWS")
            min_level_rows = int(env) if env else DEFAULT_MIN_LEVEL_ROWS
        self.min_level_rows = max(1, int(min_level_rows))
        r = registry or Registry()
        if supervisor is None:
            supervisor = DeviceSupervisor(registry=r, canary=self._canary, device=self.device)
        elif supervisor.canary is None:
            supervisor.canary = self._canary
        self.supervisor = supervisor
        self.fault: Optional[str] = None
        self._event = None  # the watchdog's CUDA event
        # dispatch-plane accounting (chain/memory_governor.py's snapshot):
        # operand and result bytes of the last and largest dispatch
        self.dispatches = 0
        self.last_dispatch_bytes = 0
        self.peak_dispatch_bytes = 0

        self.m_levels = r.labeled_counter(
            "lodestar_htr_device_levels_total", "Merkle tree levels hashed on the device, per kernel entry", "entry"
        )
        self.m_seconds = r.counter(
            "lodestar_htr_device_seconds", "Cumulative wall seconds spent in device merkleization dispatches"
        )
        self.m_dispatches = r.labeled_counter(
            "lodestar_htr_device_dispatches_total", "Device merkleization dispatches, per kernel entry", "entry"
        )
        self.m_host_levels = r.counter(
            "lodestar_htr_host_fallback_levels_total",
            "Tree levels that fell back to the host hash path while the device seam was degraded or faulted",
        )

    # -- plumbing ------------------------------------------------------------

    def heal(self) -> None:
        self.fault = None

    def _maybe_fault(self) -> None:
        f = self.fault
        if f is None:
            return
        if f == "bad_output":
            raise BadDeviceOutput("injected: malformed digest plane")
        if f == "backend":
            raise RuntimeError("injected: CUDA backend initialization failed")
        raise RuntimeError(f"injected device fault: {f}")

    def _canary(self) -> bool:
        """One hash on the device, checked against hashlib (unsupervised)."""
        self._maybe_fault()
        probe = np.arange(64, dtype=_U8).reshape(1, 64)
        out = self._host(SK.hash_pairs(SK.to_tensor(SK.pairs_to_blocks(probe), self.device)))
        return SK.digests_to_bytes(out).tobytes() == hashlib.sha256(probe.tobytes()).digest()

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """A result on the host as uint32 words.  On the card with the
        watchdog armed, the wait polls a CUDA event recorded behind the
        launch and raises DeviceTimeout past the deadline."""
        deadline = self.supervisor.job_deadline_s if self.supervisor.active else None
        if t.is_cuda and deadline:
            if self._event is None:
                self._event = torch.cuda.Event()
            self._event.record()
            until = time.monotonic() + deadline
            while not self._event.query():
                if time.monotonic() > until:
                    raise DeviceTimeout(f"htr dispatch exceeded the {deadline:.1f}s job deadline")
                time.sleep(WATCH_POLL_S)
        return SK.to_words(t)

    def _account(self, nbytes: int) -> None:
        self.dispatches += 1
        self.last_dispatch_bytes = nbytes
        if nbytes > self.peak_dispatch_bytes:
            self.peak_dispatch_bytes = nbytes

    def _dispatch(self, entry: str, kernel, args: Sequence[np.ndarray], n_out: int, levels: int) -> np.ndarray:
        """One supervised device call of `kernel` on `args` (numpy words);
        returns its uint32 digest words, raising on any fault."""
        self._maybe_fault()
        t0 = time.perf_counter()
        with trace_span("htr.device_dispatch", entry=entry):
            if self.device.type == "cuda":  # the watchdog polls in _host
                out = self._host(kernel(*(SK.to_tensor(a, self.device) for a in args)))
            else:
                out = self.supervisor.run_guarded(
                    lambda: self._host(kernel(*(SK.to_tensor(a, self.device) for a in args))), f"htr:{entry}"
                )
        self.m_seconds.inc(time.perf_counter() - t0)
        if out.dtype != np.uint32 or out.shape[-1] != 8 or out.shape[0] < n_out:
            raise BadDeviceOutput(f"{entry}: digest plane {out.dtype}{out.shape} (expected >= {n_out} uint32[...,8] rows)")
        self._account(sum(int(a.nbytes) for a in args) + int(out.nbytes))
        self.m_dispatches.inc(entry, 1.0)
        self.m_levels.inc(entry, float(levels))
        self.supervisor.record_success()
        return out

    def _failed(self, exc: BaseException, seam: str, levels: int) -> None:
        self.supervisor.record_failure(classify_failure(exc), seam, str(exc))
        self.supervisor.note_host_fallback(levels)
        self.m_host_levels.inc(levels)

    def _degraded(self, levels: int) -> bool:
        """True (and the levels counted to the host) while the breaker is open."""
        if self.supervisor.device_allowed():
            return False
        self.supervisor.note_host_fallback(levels)
        self.m_host_levels.inc(levels)
        return True

    def device_allowed(self) -> bool:
        return self.supervisor.device_allowed()

    # -- seam: one tree level ------------------------------------------------

    def hash_level(self, pairs: np.ndarray) -> Optional[np.ndarray]:
        """(n, 64) uint8 sibling pairs -> (n, 32) uint8 parents, or None
        (the caller hashes on the host)."""
        n = pairs.shape[0]
        if n < self.min_level_rows or self._degraded(1):
            return None
        try:
            digests = self._dispatch("htr_hash_pairs", SK.hash_pairs, (SK.pairs_to_blocks(pairs),), n, 1)
            return SK.digests_to_bytes(digests[:n])
        except Exception as e:  # noqa: BLE001 — every device fault degrades to the host
            self._failed(e, "htr_hash_level", 1)
            return None

    # -- seam: multi-level forest sweep --------------------------------------

    def sweep(
        self, pairs: np.ndarray, dst_lane: np.ndarray, dst_half: np.ndarray, sizes: Sequence[int]
    ) -> Optional[List[np.ndarray]]:
        """K levels of dirty-path hashing in one launch: uint32 [K, B, 16]
        pair planes, int32 [K, B] scatter maps, sizes[l] the live lanes of
        level l -> the per-level (sizes[l], 32) uint8 parents, or None."""
        k = pairs.shape[0]
        if self._degraded(k):
            return None
        try:
            out = self._dispatch("htr_forest_sweep", SK.forest_sweep, (pairs, dst_lane, dst_half), k, k)
            return [SK.digests_to_bytes(out[level, : sizes[level]]) for level in range(k)]
        except Exception as e:  # noqa: BLE001 — degrade, never propagate
            self._failed(e, "htr_forest_sweep", k)
            return None

    # -- seam: validator container roots -------------------------------------

    def validator_roots(
        self,
        pk_root_rows: np.ndarray,
        cred_rows: np.ndarray,
        u64_cols: Sequence[np.ndarray],
        slashed: np.ndarray,
    ) -> Optional[np.ndarray]:
        """(d, 32) pubkey-root and credential rows, the five uint64 columns
        (effective_balance, activation_eligibility_epoch, activation_epoch,
        exit_epoch, withdrawable_epoch) and the slashed flags -> (d, 32)
        uint8 container roots, or None."""
        d = pk_root_rows.shape[0]
        if d == 0:
            return np.zeros((0, 32), _U8)
        if self._degraded(3):
            return None
        try:
            cols = [np.ascontiguousarray(c, "<u8").view("<u4").reshape(d, 2) for c in u64_cols]
            args = (SK.rows_to_words(pk_root_rows), SK.rows_to_words(cred_rows), *cols, slashed.astype(np.uint32))
            digests = self._dispatch("htr_validator_roots", SK.validator_roots, args, d, 3)
            return SK.digests_to_bytes(digests[:d])
        except Exception as e:  # noqa: BLE001 — degrade, never propagate
            self._failed(e, "htr_validator_roots", 3)
            return None


# -- the process backend -------------------------------------------------------

_BACKEND: Optional[DeviceMerkleBackend] = None
_BACKEND_RESOLVED = False
_BACKEND_LOCK = threading.Lock()


def host_requested() -> bool:
    """True when ``LODESTAR_TPU_HTR_BACKEND=host`` keeps the process on the
    host hash path."""
    return os.environ.get("LODESTAR_TPU_HTR_BACKEND", "").strip().lower() == "host"


def maybe_backend() -> Optional[DeviceMerkleBackend]:
    """The process backend: one on the card, or None where the process
    opted out (``set_backend(None)``, ``LODESTAR_TPU_HTR_BACKEND=host``).
    Resolved once; without a card and without an opt-out it raises."""
    global _BACKEND, _BACKEND_RESOLVED
    if _BACKEND_RESOLVED:
        return _BACKEND
    with _BACKEND_LOCK:
        if not _BACKEND_RESOLVED:
            _BACKEND = None if host_requested() else DeviceMerkleBackend()
            _BACKEND_RESOLVED = True
    return _BACKEND


def set_backend(backend: Optional[DeviceMerkleBackend]) -> None:
    """Install the process backend, or with None keep the host path."""
    global _BACKEND, _BACKEND_RESOLVED
    with _BACKEND_LOCK:
        _BACKEND = backend
        _BACKEND_RESOLVED = True


def reset_backend() -> None:
    """Forget the resolved backend: the next maybe_backend() resolves anew."""
    global _BACKEND, _BACKEND_RESOLVED
    with _BACKEND_LOCK:
        _BACKEND = None
        _BACKEND_RESOLVED = False


def device_memory_snapshot() -> dict:
    """Dispatch-plane residency of the installed backend."""
    b = _BACKEND
    if b is None:
        return {"active": False, "dispatches": 0, "last_dispatch_bytes": 0, "peak_dispatch_bytes": 0}
    return {
        "active": True,
        "dispatches": b.dispatches,
        "last_dispatch_bytes": b.last_dispatch_bytes,
        "peak_dispatch_bytes": b.peak_dispatch_bytes,
    }


__all__ = [
    "DeviceMerkleBackend",
    "DEFAULT_MIN_LEVEL_ROWS",
    "device_memory_snapshot",
    "host_requested",
    "maybe_backend",
    "reset_backend",
    "set_backend",
]
