"""The port's SHA-256 merkleization functions (`lodestar_tpu_torch/kernels/sha256.py`)
against the JAX package's (`lodestar_tpu/kernels/sha256.py`, under plain
`jax.jit` on the CPU) and hashlib, exactly, on every lane; and the host
build of `csrc/sha256.cu` (the kernels' own code, compiled with the host
C++ compiler) against the plain versions.

Inputs are made with numpy from fixed seeds.  The sweep's plans are the
ones the JAX package's `ChunkTree` builds for a dirty batch in a 2^40-leaf
tree (K = 40 levels, B = 512 lanes), recorded through its backend seam,
with their live lanes a level: the live lanes of the sweep with live counts
equal JAX's `forest_sweep_device`, its dead lanes are zeros, and without
live counts every lane equals JAX's.  The host build runs the sweep's
cluster block by block and thread by thread, both forwards and both
reversed.
"""

import hashlib

import numpy as np
import pytest
import torch

from lodestar_tpu.kernels import sha256 as JSK
from lodestar_tpu.ssz import device_backend as JDB
from lodestar_tpu.ssz.merkle_tree import ChunkTree as JChunkTree
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import sha256 as SK

jax = pytest.importorskip("jax")


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return SK.to_tensor(words, "cpu")


def _hashlib(pairs: np.ndarray) -> np.ndarray:
    return np.frombuffer(b"".join(hashlib.sha256(r.tobytes()).digest() for r in pairs), np.uint8).reshape(-1, 32)


@pytest.fixture(scope="module")
def host_lib():
    return B.load_host("sha256")


# -- the byte helpers ----------------------------------------------------------


def test_byte_helpers_match_jax():
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 256, (9, 64), dtype=np.uint8)
    rows = rng.integers(0, 256, (9, 32), dtype=np.uint8)
    digests = _words(rng, (9, 8))
    for ours, theirs, arg in ((SK.pairs_to_blocks, JSK.pairs_to_blocks, pairs),
                              (SK.digests_to_bytes, JSK.digests_to_bytes, digests),
                              (SK.rows_to_words, JSK.rows_to_words, rows)):
        got, exp = ours(arg), theirs(arg)
        assert got.dtype == exp.dtype and got.shape == exp.shape
        np.testing.assert_array_equal(got, exp)
        empty = np.zeros((0,) + arg.shape[1:], arg.dtype)
        assert ours(empty).shape == theirs(empty).shape
    assert int(SK.pairs_to_blocks(pairs)[0, 0]) == int.from_bytes(pairs[0, :4].tobytes(), "big")
    np.testing.assert_array_equal(SK.digests_to_bytes(SK.rows_to_words(rows)), rows)
    # int32 tensors carry the words' bits both ways
    np.testing.assert_array_equal(SK.to_words(_t(digests)), digests)
    assert SK._PAD_SCHEDULE == JSK._PAD_SCHEDULE and SK._K == JSK._K and SK._IV == JSK._IV
    assert SK.HTR_SWEEP_LANES == JSK.HTR_SWEEP_LANES


# -- one tree level -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 64, 1025])
def test_hash_pairs_plain_matches_jax_and_hashlib(n):
    rng = np.random.default_rng(n)
    pairs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    blocks = SK.pairs_to_blocks(pairs)
    got = SK.to_words(SK.hash_pairs_plain(_t(blocks)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(JSK.hash_pairs_device)(blocks)))
    np.testing.assert_array_equal(SK.digests_to_bytes(got), _hashlib(pairs))
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(SK.to_words(SK.hash_pairs(_t(blocks))), got)


# -- the forest sweep -------------------------------------------------------------


class _PlanRecorder:
    """A stand-in for the JAX package's backend that records the sweep plan
    its ChunkTree builds and declines every dispatch (the tree then hashes
    on the host)."""

    def __init__(self):
        self.plans = []

    def hash_level(self, pairs):
        return None

    def sweep(self, pairs, dst_lane, dst_half, sizes):
        self.plans.append((pairs.copy(), dst_lane.copy(), dst_half.copy(), list(sizes)))
        return None


@pytest.fixture(scope="module")
def tree_plan():
    """The plan of 300 dirty leaves of a 5,000-leaf tree of 2^40 leaves,
    and the tree's nodes it must reproduce."""
    rng = np.random.default_rng(40)
    leaves = rng.integers(0, 256, (5000, 32), dtype=np.uint8)
    tree = JChunkTree(1 << 40)
    rec = _PlanRecorder()
    JDB.set_backend(rec)
    try:
        tree.update(leaves)  # cold: 5,000 dirty, past the sweep's lanes
        assert not rec.plans
        idx = rng.choice(5000, 300, replace=False)
        leaves[idx] = rng.integers(0, 256, (300, 32), dtype=np.uint8)
        tree.update(leaves)
    finally:
        JDB.reset_backend()
    (plan,) = rec.plans
    assert plan[0].shape == (40, 512, 16) and plan[3][0] <= 300
    return plan, tree


def test_forest_sweep_plain_matches_jax_on_a_tree_plan(tree_plan):
    (pairs, lane, half, sizes), tree = tree_plan
    got = SK.to_words(SK.forest_sweep_plain(_t(pairs), _t(lane), _t(half)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(JSK.forest_sweep_device)(pairs, lane, half)))
    # the live lanes are the tree's dirty parents, level by level (the
    # tree's planes were hashed on the host)
    assert SK.digests_to_bytes(got[39, :1]).tobytes() == tree.root
    assert sizes[-1] == 1


@pytest.fixture(scope="module")
def one_leaf_plan():
    """The plan of one dirty leaf of the same kind of tree: one live lane a
    level."""
    rng = np.random.default_rng(41)
    leaves = rng.integers(0, 256, (700, 32), dtype=np.uint8)
    tree = JChunkTree(1 << 40)
    rec = _PlanRecorder()
    JDB.set_backend(rec)
    try:
        tree.update(leaves)
        leaves[333] = rng.integers(0, 256, 32, dtype=np.uint8)
        tree.update(leaves)
    finally:
        JDB.reset_backend()
    (plan,) = rec.plans
    assert plan[3] == [1] * 40
    return plan


def _plans(tree_plan, one_leaf_plan):
    return {"dirty_300": tree_plan[0], "dirty_1": one_leaf_plan}


@pytest.mark.parametrize("which", ["dirty_300", "dirty_1"])
def test_forest_sweep_live_lanes_match_jax(tree_plan, one_leaf_plan, which):
    """With each level's live lanes (the plan's sizes): the live lanes equal
    JAX's forest_sweep_device, the rest are zeros; the wrapper on CPU
    tensors is the plain version."""
    pairs, lane, half, sizes = _plans(tree_plan, one_leaf_plan)[which]
    live = np.asarray(sizes, np.int32)
    got = SK.to_words(SK.forest_sweep_plain(_t(pairs), _t(lane), _t(half), _t(live)))
    want = np.asarray(jax.jit(JSK.forest_sweep_device)(pairs, lane, half))
    for level, n in enumerate(sizes):
        np.testing.assert_array_equal(got[level, :n], want[level, :n])
        assert not got[level, n:].any()
    np.testing.assert_array_equal(SK.to_words(SK.forest_sweep(_t(pairs), _t(lane), _t(half), _t(live))), got)
    if which == "dirty_300":
        assert SK.digests_to_bytes(got[39, :1]).tobytes() == tree_plan[1].root


def _small_plan(rng, k, b):
    """Random pair planes; each level's lanes scattered to a random
    permutation of [0, b + 4), so some land at or past b (dropped)."""
    pairs = _words(rng, (k, b, 16))
    lane = np.stack([rng.permutation(b + 4)[:b] for _ in range(k)]).astype(np.int32)
    half = rng.integers(0, 2, (k, b)).astype(np.int32)
    return pairs, lane, half


def test_forest_sweep_plain_matches_jax_with_dead_lanes():
    rng = np.random.default_rng(7)
    pairs, lane, half = _small_plan(rng, 5, 12)
    lane[1, :4] = 12  # dead lanes: dropped by the scatter, hashed all the same
    got = SK.to_words(SK.forest_sweep_plain(_t(pairs), _t(lane), _t(half)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(JSK.forest_sweep_device)(pairs, lane, half)))
    np.testing.assert_array_equal(SK.to_words(SK.forest_sweep(_t(pairs), _t(lane), _t(half))), got)


# -- the validator roots ------------------------------------------------------------


def _validator_columns(rng, d):
    """pk_root, creds [d, 8]; five uint64 columns as [d, 2] (lo, hi) words,
    values past 2^32 among them; slashed [d] with slashed rows."""
    pk, cr = _words(rng, (d, 8)), _words(rng, (d, 8))
    u64 = [rng.integers(0, 2**63, d, dtype=np.uint64) for _ in range(5)]
    u64[0][0] = 2**64 - 1
    u64[3][:] = np.uint64(2**64 - 1)  # FAR_FUTURE_EPOCH exits
    if d > 1:
        u64[1][1] = 2**32 + 5
    cols = [np.ascontiguousarray(c, "<u8").view("<u4").reshape(d, 2) for c in u64]
    slashed = (rng.integers(0, 2, d) | (np.arange(d) == 0)).astype(np.uint32)
    return [pk, cr, *cols, slashed]


@pytest.mark.parametrize("d", [1, 5, 64])
def test_validator_roots_plain_match_jax(d):
    cols = _validator_columns(np.random.default_rng(d), d)
    packed = SK.to_words(SK.pack_validator_blocks_plain(*map(_t, cols)))
    np.testing.assert_array_equal(packed, np.asarray(jax.jit(JSK.pack_validator_blocks_device)(*cols)))
    roots = SK.to_words(SK.validator_roots_plain(*map(_t, cols)))
    np.testing.assert_array_equal(roots, np.asarray(jax.jit(JSK.validator_roots_device)(*cols)))
    np.testing.assert_array_equal(SK.to_words(SK.validator_roots(*map(_t, cols))), roots)


# -- the wrappers' operand checks ------------------------------------------------------


def test_wrappers_refuse_bad_operands():
    x = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        SK.hash_pairs(x.to(torch.int64))
    with pytest.raises(ValueError):
        SK.hash_pairs(torch.zeros((16, 4), dtype=torch.int32).t())  # not contiguous
    with pytest.raises(ValueError):
        SK.hash_pairs(torch.zeros((4, 15), dtype=torch.int32))
    with pytest.raises(ValueError):
        SK.forest_sweep(torch.zeros((2, 1025, 16), dtype=torch.int32), torch.zeros((2, 1025), dtype=torch.int32),
                        torch.zeros((2, 1025), dtype=torch.int32))
    with pytest.raises(ValueError):
        SK.forest_sweep(torch.zeros((2, 8, 16), dtype=torch.int32), torch.zeros((2, 8), dtype=torch.int32),
                        torch.zeros((2, 8), dtype=torch.int32), torch.ones(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        SK.forest_sweep(torch.zeros((2, 8, 16), dtype=torch.int32), torch.zeros((2, 8), dtype=torch.int32),
                        torch.zeros((2, 8), dtype=torch.int32), torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        SK.validator_roots(*[torch.zeros((3, 8), dtype=torch.int32)] * 2,
                           *[torch.zeros((3, 2), dtype=torch.int32)] * 5, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        SK.hash_pairs(torch.zeros((4, 16), dtype=torch.int32, device="meta"))
    assert SK.hash_pairs(torch.zeros((0, 16), dtype=torch.int32)).shape == (0, 8)


# -- the host build of csrc/sha256.cu ---------------------------------------------------


@pytest.mark.parametrize("n", [1, 33, 300])
def test_host_build_hash_pairs(host_lib, n):
    blocks = _t(_words(np.random.default_rng(100 + n), (n, 16)))
    out = torch.empty((n, 8), dtype=torch.int32)
    assert host_lib.lt_sha256_pairs(blocks.data_ptr(), out.data_ptr(), n, None) == 0
    assert torch.equal(out, SK.hash_pairs_plain(blocks))


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("k,b", [(1, 1), (6, 33), (40, 512)])
def test_host_build_forest_sweep(host_lib, tree_plan, k, b, reverse):
    """The block's threads run each phase forwards and reversed: a phase
    that read what another thread of the same phase writes would differ."""
    if (k, b) == (40, 512):
        pairs, lane, half = tree_plan[0][:3]
    else:
        pairs, lane, half = _small_plan(np.random.default_rng(k * b), k, b)
    pairs, lane, half = _t(pairs), _t(lane), _t(half)
    out = torch.empty((k, b, 8), dtype=torch.int32)
    host_lib.lt_host_warp_order(reverse)
    try:
        assert host_lib.lt_sha256_sweep(pairs.data_ptr(), lane.data_ptr(), half.data_ptr(), None, out.data_ptr(), k,
                                        b, None) == 0
    finally:
        host_lib.lt_host_warp_order(0)
    assert torch.equal(out, SK.forest_sweep_plain(pairs, lane, half))


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("which", ["dirty_300", "dirty_1", "clamped", "small"])
def test_host_build_forest_sweep_live(host_lib, tree_plan, one_leaf_plan, which, reverse):
    """The cluster's blocks (8 of 64 threads at B = 512, 2 of 17 at B = 33)
    and their threads run each phase forwards and reversed, with live
    counts: equal to the plain version with the same counts, and on the
    live lanes to JAX; counts past B or below 0 are clamped."""
    if which in ("dirty_300", "dirty_1"):
        pairs, lane, half, sizes = _plans(tree_plan, one_leaf_plan)[which]
        live = np.asarray(sizes, np.int32)
    elif which == "clamped":
        pairs, lane, half = tree_plan[0][:3]
        live = np.asarray(tree_plan[0][3], np.int32)
        live[0], live[5] = 9999, -3
    else:  # random scatter maps, each level's live lanes shrinking
        pairs, lane, half = _small_plan(np.random.default_rng(33), 9, 33)
        live = np.array([33, 30, 30, 17, 16, 9, 2, 1, 1], np.int32)
    k, b = pairs.shape[:2]
    pt, lt, ht, vt = _t(pairs), _t(lane), _t(half), _t(live)
    out = torch.empty((k, b, 8), dtype=torch.int32)
    host_lib.lt_host_warp_order(reverse)
    try:
        assert host_lib.lt_sha256_sweep(pt.data_ptr(), lt.data_ptr(), ht.data_ptr(), vt.data_ptr(), out.data_ptr(), k,
                                        b, None) == 0
    finally:
        host_lib.lt_host_warp_order(0)
    assert torch.equal(out, SK.forest_sweep_plain(pt, lt, ht, vt))
    if which in ("dirty_300", "dirty_1"):
        want = np.asarray(jax.jit(JSK.forest_sweep_device)(pairs, lane, half))
        got = SK.to_words(out)
        for level, n in enumerate(live.tolist()):
            np.testing.assert_array_equal(got[level, :n], want[level, :n])
            assert not got[level, n:].any()


@pytest.mark.parametrize("d", [1, 5, 257])
def test_host_build_validator_roots(host_lib, d):
    cols = [_t(c) for c in _validator_columns(np.random.default_rng(200 + d), d)]
    out = torch.empty((d, 8), dtype=torch.int32)
    assert host_lib.lt_sha256_validators(*(c.data_ptr() for c in cols), out.data_ptr(), d, None) == 0
    assert torch.equal(out, SK.validator_roots_plain(*cols))
