"""The hash forest on the device: SHA-256 merkleization kernels.

Counterpart of `lodestar_tpu/kernels/sha256.py`.  Every input the
state-root engine hashes is exactly one 64-byte block (two sibling
chunks), so the second compression's block is the constant padding block
and its message schedule, `_PAD_SCHEDULE`, is computed once.  Three
device functions, each a kernel of `csrc/sha256.cu`:

  hash_pairs       one tree level: int32 [N, 16] big-endian message
                   words -> int32 [N, 8] parent digests
                   (replaces `hash_pairs_device`, `:166`)
  forest_sweep     K levels of a dirty batch in one launch; level l's
                   digests are written into level l + 1's pair plane on
                   the device; with `live`, each level's live lanes only
                   (replaces `forest_sweep_device`, `:184`)
  validator_roots  the 8-chunk validator leaves packed from the columns
                   and hashed 8 -> 4 -> 2 -> 1 per validator (replaces
                   `validator_roots_device`, `:293`, and, as its first
                   phase, `pack_validator_blocks_device`, `:250`)

Words are uint32 bit patterns held in int32 tensors (the port's planes
are int32 throughout); the host side views its numpy uint32 arrays as
int32.  Each wrapper checks its operands, then launches the kernel for
CUDA tensors or runs its plain torch version for CPU tensors; any other
device raises, and there is no fallback from one to the other.
`LAUNCHES[name]` counts the wrapper's kernel launches.

The plain versions compute in int64 with every sum masked to 32 bits,
in chunks of `PLAIN_CHUNK` lanes so that a 1M-validator registry fits
on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import build as B

# SHA-256 round constants and initial state (FIPS 180-4)
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_M32 = 0xFFFFFFFF


def _py_schedule(block16: Tuple[int, ...]) -> Tuple[int, ...]:
    """The 64-word message schedule of one block, in Python integers."""
    w = list(block16)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = ((x >> 7) | (x << 25)) ^ ((x >> 18) | (x << 14)) ^ (x >> 3)
        s1 = ((y >> 17) | (y << 15)) ^ ((y >> 19) | (y << 13)) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    return tuple(w)


# the constant second block of every 64-byte message: 0x80, zeros, and
# the bit length 512
_PAD_SCHEDULE = _py_schedule((0x80000000,) + (0,) * 14 + (512,))

# the forest sweep's lanes: the per-slot dirty batch (256 touched
# validators -> at most 256 dirty parents a level), as the JAX package
HTR_SWEEP_LANES = 512
SWEEP_MAX_LANES = 1024  # a cluster of 8 blocks of 128 threads

LAUNCHES: Dict[str, int] = {"hash_pairs": 0, "forest_sweep": 0, "validator_roots": 0}

PLAIN_CHUNK = 1 << 20  # lanes a plain version computes at once


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host byte conversion (numpy; no hashing)
# ---------------------------------------------------------------------------


def pairs_to_blocks(pairs: np.ndarray) -> np.ndarray:
    """(n, 64) uint8 sibling-pair plane -> (n, 16) uint32 big-endian
    message words."""
    if pairs.size == 0:
        return np.zeros((0, 16), np.uint32)
    return np.ascontiguousarray(pairs).view(">u4").astype(np.uint32)


def digests_to_bytes(digests: np.ndarray) -> np.ndarray:
    """(n, 8) uint32 digests -> (n, 32) uint8 big-endian node rows."""
    if digests.size == 0:
        return np.zeros((0, 32), np.uint8)
    return np.ascontiguousarray(digests, np.uint32).astype(">u4").view(np.uint8).reshape(-1, 32)


def rows_to_words(rows: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 node rows -> (n, 8) uint32 big-endian words."""
    if rows.size == 0:
        return np.zeros((0, 8), np.uint32)
    return np.ascontiguousarray(rows).view(">u4").astype(np.uint32)


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 (or int32) words -> a contiguous int32 tensor of the
    same bits on `device`."""
    arr = np.ascontiguousarray(words)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


def to_words(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor -> numpy uint32 words of the same bits (host)."""
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# plain versions: uint32 arithmetic in int64, masked
# ---------------------------------------------------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & _M32


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 of the same bits."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def _rotr3(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) of values in [0, 2^32): the
    rotations read from x doubled into 64 bits (an arithmetic shift of the
    doubled value brings its sign only into bits the mask drops)."""
    y = x | (x << 32)
    return ((y >> r1) ^ (y >> r2) ^ (y >> r3)) & _M32


def _sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s): a schedule word's sigma."""
    y = x | (x << 32)
    return (((y >> r1) ^ (y >> r2)) & _M32) ^ (x >> s)


def _rounds(state, words):
    """64 rounds from `state` (8 int64 lane vectors) over the round
    constants plus schedule words: `words(t)` gives K[t] + W[t] (a tensor
    or an int); returns the state after the rounds, before the feed-forward."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = h + _rotr3(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + words(t)
        maj = (a & b) | (c & (a | b))
        h, g, f, e, d, c, b = g, f, e, (d + t1) & _M32, c, b, a
        a = (t1 + _rotr3(a, 2, 13, 22) + maj) & _M32
    return a, b, c, d, e, f, g, h


def _hash_chunk(w16: torch.Tensor) -> torch.Tensor:
    """int64 [n, 16] words -> int64 [n, 8] digests: the data block with its
    schedule in a rolling 16-word window, then the constant pad block."""
    w = [w16[:, i] for i in range(16)]
    iv = tuple(torch.full_like(w[0], v) for v in _IV)

    def data_words(t):
        if t >= 16:
            s0, s1 = _sigma(w[(t - 15) & 15], 7, 18, 3), _sigma(w[(t - 2) & 15], 17, 19, 10)
            w[t & 15] = (w[t & 15] + s0 + w[(t - 7) & 15] + s1) & _M32
        return w[t & 15] + _K[t]

    mid = tuple((s + v) & _M32 for s, v in zip(iv, _rounds(iv, data_words)))
    out = _rounds(mid, lambda t: (_K[t] + _PAD_SCHEDULE[t]) & _M32)
    return torch.stack([(s + v) & _M32 for s, v in zip(mid, out)], dim=1)


def hash_pairs_plain(blocks: torch.Tensor) -> torch.Tensor:
    """int32 [N, 16] big-endian message words -> int32 [N, 8] digests."""
    n = blocks.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    for s in range(0, n, PLAIN_CHUNK):
        out[s : s + PLAIN_CHUNK] = _i32(_hash_chunk(_u32(blocks[s : s + PLAIN_CHUNK])))
    return out


def forest_sweep_plain(pairs: torch.Tensor, dst_lane: torch.Tensor, dst_half: torch.Tensor,
                       live: torch.Tensor = None) -> torch.Tensor:
    """int32 [K, B, 16] pair planes, int32 [K, B] scatter maps, int32 [K]
    live lanes (None: every lane) -> int32 [K, B, 8]: at level l > 0 each
    live lane i of level l - 1 overwrites half dst_half[l - 1, i] of row
    dst_lane[l - 1, i] of level l's plane (dropped where that row is not
    live at level l or the half is not 0 or 1), then the plane's live rows
    [0, live[l]) are hashed; the other rows of the output are zeros."""
    k, b = pairs.shape[:2]
    lv = [b] * k if live is None else [min(max(int(n), 0), b) for n in live.tolist()]
    out = torch.zeros((k, b, 8), dtype=torch.int32, device=pairs.device)
    word = torch.arange(8, device=pairs.device)
    for level in range(k):
        n = lv[level]
        plane = pairs[level].clone()
        if level > 0:
            m = lv[level - 1]
            lane, half = dst_lane[level - 1, :m].to(torch.int64), dst_half[level - 1, :m].to(torch.int64)
            keep = (lane >= 0) & (lane < n) & ((half == 0) | (half == 1))
            rows, cols = lane[keep], half[keep] * 8
            plane[rows[:, None], cols[:, None] + word] = out[level - 1, :m][keep]
        out[level, :n] = hash_pairs_plain(plane[:n])
    return out


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte-swapped int64 values in [0, 2^32)."""
    return ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF)


def pack_validator_blocks_plain(pk_root, creds, eb, aee, ae, ee, we, slashed) -> torch.Tensor:
    """The level-0 pair plane of every validator's 8-chunk subtree.

    pk_root, creds: int32 [D, 8] big-endian words; eb, aee, ae, ee, we:
    int32 [D, 2], each uint64 column's (lo, hi) words in host order (the
    chunk's big-endian words are their byte swaps); slashed: int32 [D]
    (chunk byte 0: the word slashed << 24).  Returns int32 [4 D, 16], in
    (validator, pair) order."""
    d = pk_root.shape[0]
    chunks = torch.zeros((d, 8, 8), dtype=torch.int64, device=pk_root.device)
    chunks[:, 0] = _u32(pk_root)
    chunks[:, 1] = _u32(creds)
    for slot, col in ((2, eb), (4, aee), (5, ae), (6, ee), (7, we)):
        chunks[:, slot, :2] = _bswap32(_u32(col))
    chunks[:, 3, 0] = (_u32(slashed) << 24) & _M32
    return _i32(chunks.reshape(d * 4, 16))


def validator_roots_plain(pk_root, creds, eb, aee, ae, ee, we, slashed) -> torch.Tensor:
    """Leaf packing and the 3-level subtree: int32 [D, 8] container roots."""
    d = pk_root.shape[0]
    out = torch.empty((d, 8), dtype=torch.int32, device=pk_root.device)
    step = PLAIN_CHUNK // 4
    for s in range(0, d, step):
        cols = [t[s : s + step] for t in (pk_root, creds, eb, aee, ae, ee, we, slashed)]
        m = cols[0].shape[0]
        lvl = hash_pairs_plain(pack_validator_blocks_plain(*cols))
        lvl = hash_pairs_plain(lvl.reshape(m * 2, 16))
        out[s : s + m] = hash_pairs_plain(lvl.reshape(m, 16))
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*ts: torch.Tensor) -> bool:
    """Check the operands; True for CPU tensors (the plain version), False
    for CUDA tensors on the current device (the kernel); raise otherwise.
    The kernels read rows with 16-byte loads, so every operand is 16-byte
    aligned."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 words, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"operands on {dev}, current CUDA device is {torch.cuda.current_device()}")
        for t in ts:
            if t.numel() and t.data_ptr() % 16:
                raise ValueError("operands must be 16-byte aligned")
        return False
    raise ValueError(f"unsupported device {dev}")


def _shape(t: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(name: str, symbol: str, *args) -> None:
    """Call a kernel's C entry point on the current stream; raise
    LaunchRefused on the CUDA error it returns."""
    fn = getattr(B.load("sha256"), symbol)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise B.LaunchRefused(f"{symbol} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def hash_pairs(blocks: torch.Tensor) -> torch.Tensor:
    """One tree level: int32 [N, 16] message words -> int32 [N, 8]."""
    n = blocks.shape[0]
    _shape(blocks, (n, 16), "hash_pairs blocks")
    if _on_cpu(blocks):
        return hash_pairs_plain(blocks)
    out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    if n:
        _launch("hash_pairs", "lt_sha256_pairs", blocks.data_ptr(), out.data_ptr(), n)
    return out


def forest_sweep(pairs: torch.Tensor, dst_lane: torch.Tensor, dst_half: torch.Tensor,
                 live: torch.Tensor = None) -> torch.Tensor:
    """K levels of a dirty batch in one launch (see `forest_sweep_plain`):
    B lanes, at most SWEEP_MAX_LANES; `live` the int32 [K] live lanes of
    each level (None: every lane, JAX's semantics)."""
    k, b = pairs.shape[:2]
    _shape(pairs, (k, b, 16), "forest_sweep pairs")
    _shape(dst_lane, (k, b), "forest_sweep dst_lane")
    _shape(dst_half, (k, b), "forest_sweep dst_half")
    ops = (pairs, dst_lane, dst_half)
    if live is not None:
        _shape(live, (k,), "forest_sweep live")
        ops += (live,)
    if b > SWEEP_MAX_LANES:
        raise ValueError(f"forest_sweep: {b} lanes, at most {SWEEP_MAX_LANES}")
    if _on_cpu(*ops):
        return forest_sweep_plain(pairs, dst_lane, dst_half, live)
    out = torch.empty((k, b, 8), dtype=torch.int32, device=pairs.device)
    if k and b:
        _launch("forest_sweep", "lt_sha256_sweep", pairs.data_ptr(), dst_lane.data_ptr(), dst_half.data_ptr(),
                None if live is None else live.data_ptr(), out.data_ptr(), k, b)
    return out


def validator_roots(pk_root, creds, eb, aee, ae, ee, we, slashed) -> torch.Tensor:
    """Validator container roots from the columns (see
    `pack_validator_blocks_plain`): int32 [D, 8]."""
    d = pk_root.shape[0]
    _shape(pk_root, (d, 8), "validator_roots pk_root")
    _shape(creds, (d, 8), "validator_roots creds")
    for col in (eb, aee, ae, ee, we):
        _shape(col, (d, 2), "validator_roots u64 column")
    _shape(slashed, (d,), "validator_roots slashed")
    cols = (pk_root, creds, eb, aee, ae, ee, we, slashed)
    if _on_cpu(*cols):
        return validator_roots_plain(*cols)
    out = torch.empty((d, 8), dtype=torch.int32, device=pk_root.device)
    if d:
        _launch("validator_roots", "lt_sha256_validators", *(t.data_ptr() for t in cols), out.data_ptr(), d)
    return out
