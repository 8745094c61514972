"""Host side of ingest: wire bytes -> device planes, and the message cache.

A copy of `lodestar_tpu/bls/ingest.py` for the port:

  - `MessageCache` hashes signing roots to G2 in one batch per lookup on
    the verifier's device (`kernels/verify.py hash_g2`: the CUDA kernel
    on the card, its plain torch version on the CPU) and memoizes the
    affine points.  The host runs expand_message_xmd / hash_to_field and
    the sgn0 bits, as the JAX package does; there is no host hash_to_g2
    path, and a lane the kernel flags not ok raises;
  - `parse_signature_bytes` splits a 96-byte compressed signature into its
    x coordinate and (sign, infinity) bits, with the host's wire checks
    (length, compression bit, infinity padding, x < p); the y recovery
    runs on the device (`kernels/verify.py g2_decompress`);
  - `encode_wire_planes` lays out a job's signatures as device planes;
  - `parse_pubkey_bytes` and `encode_pubkey_planes` do the same for
    48-byte compressed pubkeys at registration, whose y recovery and
    KeyValidate run on the device (`kernels/verify.py g1_keyvalidate`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..crypto import fields as GT
from ..crypto import hash_to_curve as HC
from ..kernels import layout as LY
from ..kernels import verify as KV

P = GT.P
BT = 128  # lanes of one hash batch: misses pad up to a multiple of it

_COMP = 0x80
_INF = 0x40
_SIGN = 0x20


class MessageCache:
    """signing_root -> affine G2 message point (ground-truth ints).

    Misses are hashed in one padded device batch per `get_many` call; an
    LRU bound keeps the cache to a few slots of distinct attestation and
    sync-committee data.  `device` None means the CUDA device."""

    def __init__(self, max_entries: int = 4096, device=None):
        self.max_entries = max_entries
        self.device = torch.device("cuda" if device is None else device)
        self._cache: "OrderedDict[bytes, Tuple]" = OrderedDict()
        # a verifier's job and retry paths may reach the cache from two
        # threads; all OrderedDict mutation happens under this lock
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_many(self, roots: Sequence[bytes]) -> List[Tuple]:
        with self._lock:
            resolved = {}
            missing = []
            for r in roots:
                if r in self._cache:
                    # snapshot hits now: storing a large miss set below
                    # may evict them before the answer is built
                    resolved[r] = self._cache[r]
                    self._cache.move_to_end(r)
                    self.hits += 1
                elif r not in missing:
                    missing.append(r)
            if missing:
                self.misses += len(missing)
                fetched = self._hash_batch_device(missing)
                for r, pt in fetched.items():
                    while len(self._cache) >= self.max_entries:
                        self._cache.popitem(last=False)
                    self._cache[r] = pt
                resolved.update(fetched)
            return [resolved[r] for r in roots]

    def _hash_batch_device(self, roots: List[bytes]):
        n = len(roots)
        roots_p = list(roots) + [roots[-1]] * ((-n) % BT)
        us = [HC.hash_to_field_fp2(r, 2, HC.DST_G2) for r in roots_p]
        sgn = np.array([[HC._sgn0_fp2(u[i]) for u in us] for i in range(2)], np.int32)
        u = np.stack(
            [np.stack([LY.encode_plain_batch([u[i][k] for u in us]) for k in range(2)]) for i in range(2)]
        )
        planes, ok = KV.hash_g2(
            torch.from_numpy(u).to(self.device), torch.from_numpy(sgn).to(self.device)
        )
        if not bool(ok.all()):
            raise RuntimeError("hash_g2 flagged a lane not ok (an iso3 denominator vanished)")
        X0, X1, Y0, Y1, Z0, Z1 = (LY.decode_batch(p) for p in planes.cpu().numpy().reshape(6, LY.NL, -1))
        fetched = {}
        for i, r in enumerate(roots):
            zi = GT.fp2_inv((Z0[i], Z1[i]))
            zi2 = GT.fp2_sqr(zi)
            x = GT.fp2_mul((X0[i], X1[i]), zi2)
            y = GT.fp2_mul((Y0[i], Y1[i]), GT.fp2_mul(zi2, zi))
            fetched[r] = (x, y)
        return fetched


def parse_signature_bytes(sig: bytes) -> Tuple[int, int, int, int, bool]:
    """96-byte compressed G2 -> (x0, x1, sign, inf, wire_ok).

    wire_ok False marks a malformed encoding (wrong length, no compression
    bit, x not below p, bad infinity padding): the set then fails without
    the device square root.  The checks of `crypto/curves.py
    g2_decompress`."""
    if len(sig) != 96:
        return 0, 0, 0, 0, False
    flags = sig[0]
    if not flags & _COMP:
        return 0, 0, 0, 0, False
    if flags & _INF:
        if flags & (_SIGN | 0x1F) or any(sig[1:]):
            return 0, 0, 0, 0, False
        return 0, 0, 0, 1, True
    x1 = int.from_bytes(bytes([flags & 0x1F]) + sig[1:48], "big")
    x0 = int.from_bytes(sig[48:], "big")
    if x0 >= P or x1 >= P:
        return 0, 0, 0, 0, False
    return x0, x1, 1 if flags & _SIGN else 0, 0, True


def encode_wire_planes(
    sigs: Sequence[bytes], n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Signatures -> (x0 planes [12, n], x1 planes [12, n], flag bits
    [2, n] (sign, infinity), host_bad [n]).

    A malformed encoding gets the infinity flag, so the device marks its
    lane bad; host_bad tells it from an honest infinity.  Padding lanes
    are flagged infinity too."""
    x0s, x1s = [], []
    flags = np.zeros((2, n), np.int32)
    host_bad = np.zeros((n,), bool)
    for i, sig in enumerate(sigs):
        x0, x1, sign, inf, ok = parse_signature_bytes(sig)
        x0s.append(x0)
        x1s.append(x1)
        flags[0, i] = sign
        flags[1, i] = inf if ok else 1
        host_bad[i] = not ok
    pad = n - len(sigs)
    x0s.extend([0] * pad)
    x1s.extend([0] * pad)
    flags[1, len(sigs):] = 1
    return LY.encode_plain_batch(x0s), LY.encode_plain_batch(x1s), flags, host_bad


def parse_pubkey_bytes(pk: bytes) -> Tuple[int, int, int, bool]:
    """48-byte compressed G1 -> (x, sign, inf, wire_ok), with the host's
    wire checks of `crypto/curves.py g1_decompress` (length, compression
    bit, infinity padding, x < p)."""
    if len(pk) != 48:
        return 0, 0, 0, False
    flags = pk[0]
    if not flags & _COMP:
        return 0, 0, 0, False
    if flags & _INF:
        if flags & (_SIGN | 0x1F) or any(pk[1:]):
            return 0, 0, 0, False
        return 0, 0, 1, True
    x = int.from_bytes(bytes([flags & 0x1F]) + pk[1:], "big")
    if x >= P:
        return 0, 0, 0, False
    return x, 1 if flags & _SIGN else 0, 0, True


_P_WORDS = np.frombuffer(P.to_bytes(48, "big"), ">u4").astype(np.uint32)


def encode_pubkey_planes(keys: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pubkeys -> (x planes [12, n] plain limbs, flag bits [2, n] (sign,
    infinity), host_bad [n]) for `kernels/verify.py g1_keyvalidate`: the
    outputs of `parse_pubkey_bytes` key by key, computed with numpy over
    the concatenated keys.  A malformed key (not 48 bytes, no compression
    bit, bad infinity padding, x >= p) is host_bad and gets x = 0 and the
    infinity flag, so the device refuses it too; an honest infinity
    encoding gets the infinity flag alone."""
    n = len(keys)
    sized = np.fromiter(map(len, keys), np.int64, n) == 48
    raw = b"".join(keys if sized.all() else (k if ok else bytes(48) for k, ok in zip(keys, sized)))
    a = np.frombuffer(raw, np.uint8).reshape(n, 48)
    flag = a[:, 0]
    comp = (flag & _COMP) != 0
    inf = (flag & _INF) != 0
    body = a.copy()
    body[:, 0] &= 0x1F
    words = body.view(">u4").astype(np.uint32)  # [n, 12], most significant first
    differ = words != _P_WORDS
    first = differ.argmax(axis=1)
    below_p = differ.any(axis=1) & (words[np.arange(n), first] < _P_WORDS[first])
    inf_padding_ok = ((flag & (_SIGN | 0x1F)) == 0) & ~a[:, 1:].any(axis=1)
    ok = sized & comp & np.where(inf, inf_padding_ok, below_p)
    point = ok & ~inf
    planes = np.where(point[None, :], words[:, ::-1].T, 0).astype(np.uint32).view(np.int32)
    flags = np.stack([point & ((flag & _SIGN) != 0), inf | ~ok]).astype(np.int32)
    return np.ascontiguousarray(planes), flags, ~ok
