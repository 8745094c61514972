"""The port's merkleization path on the CPU: `DeviceMerkleBackend`
(device="cpu": the kernels' plain versions) in the port's `ChunkTree` and
`StateRootEngine`, and the same backend installed in the JAX package
through its own `set_backend`, under the JAX `ChunkTree`,
`StateRootEngine` and memory governor.

Every root is held bit for bit against `merkleize_chunks`, the host path
and, for states, the full recompute of the JAX package's `BeaconState`
(built and mutated as tests/test_state_root.py builds them).  Faults
injected at the backend trip its breaker, the roots survive on the host
path, and the host levels are counted.
"""

import random

import numpy as np
import pytest
import torch

from lodestar_tpu import params
from lodestar_tpu.chain import memory_governor as JMG
from lodestar_tpu.ssz import ChunkTree as JChunkTree
from lodestar_tpu.ssz import device_backend as JDB
from lodestar_tpu.state_transition.slot import process_slots
from lodestar_tpu_torch.bls.supervisor import DeviceSupervisor
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import sha256 as SK
from lodestar_tpu_torch.ssz import ChunkTree, merkleize_chunks
from lodestar_tpu_torch.ssz import device_backend as DB
from lodestar_tpu_torch.ssz.core import _ZERO_HASHES
from lodestar_tpu_torch.ssz.hasher import hash_pairs
from lodestar_tpu_torch.ssz.merkle_tree import hash_pairs_plane
from lodestar_tpu_torch.state_transition import StateRootEngine
from lodestar_tpu_torch.utils.metrics import Registry

from test_state_root import _full_root, _mutate_once, _synthetic_state

SLOTS_PER_EPOCH = params.ACTIVE_PRESET.SLOTS_PER_EPOCH


def _backend(min_level_rows: int = 1024) -> DB.DeviceMerkleBackend:
    reg = Registry()
    sup = DeviceSupervisor(registry=reg, auto_probe=False, enabled=True)
    return DB.DeviceMerkleBackend(device="cpu", supervisor=sup, registry=reg, min_level_rows=min_level_rows)


@pytest.fixture
def port_backend():
    b = _backend()
    DB.set_backend(b)
    yield b
    DB.reset_backend()


def _chunks(leaves: np.ndarray):
    return [bytes(r) for r in leaves]


def _closed(b: DB.DeviceMerkleBackend) -> None:
    st = b.supervisor.status()
    assert st["state"] == "closed" and st["last_failure"] is None, st
    assert b.m_host_levels.value == 0


def test_zero_hashes_and_host_hasher_match_the_jax_package():
    from lodestar_tpu.ssz.core import _ZERO_HASHES as J_ZERO
    from lodestar_tpu.ssz.core import merkleize_chunks as j_merkleize
    from lodestar_tpu.ssz.hasher import hash_pairs as j_hash_pairs

    assert _ZERO_HASHES == J_ZERO
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (7, 64), dtype=np.uint8).tobytes()
    assert hash_pairs(data) == j_hash_pairs(data)
    for n, limit in ((0, 4), (1, None), (5, 8), (13, 1 << 20)):
        chunks = _chunks(rng.integers(0, 256, (n, 32), dtype=np.uint8))
        assert merkleize_chunks(chunks, limit) == j_merkleize(chunks, limit)


# -- the port's ChunkTree on the port's backend ------------------------------------


def test_cold_build_is_one_sweep(port_backend):
    leaves = np.random.default_rng(1).integers(0, 256, (50, 32), dtype=np.uint8)
    tree = ChunkTree(64)
    tree.update(leaves)
    assert port_backend.dispatches == 1
    assert port_backend.m_dispatches.get("htr_forest_sweep") == 1
    assert tree.root == merkleize_chunks(_chunks(leaves), 64) == tree.full_root_reference()
    _closed(port_backend)


def test_dirty_sweeps_and_growth(port_backend):
    rng = np.random.default_rng(2)
    leaves = rng.integers(0, 256, (200, 32), dtype=np.uint8)
    tree = ChunkTree(1 << 10)
    tree.update(leaves)
    for _ in range(3):
        idx = rng.integers(0, 200, 7)
        leaves[idx] = rng.integers(0, 256, (7, 32), dtype=np.uint8)
        before = port_backend.dispatches
        tree.update(leaves)
        assert port_backend.dispatches == before + 1
        assert tree.root == merkleize_chunks(_chunks(leaves), 1 << 10)
    leaves = np.concatenate([leaves, rng.integers(0, 256, (30, 32), dtype=np.uint8)])
    tree.update(leaves)  # appended chunks ride the same sweep
    assert tree.root == merkleize_chunks(_chunks(leaves), 1 << 10)
    # a branch verifies against the root
    node = tree.leaf(57)
    for level, sib in enumerate(tree.branch(57)):
        node = hash_pairs(sib + node if (57 >> level) & 1 else node + sib)
    assert node == tree.root
    _closed(port_backend)


def test_bulk_update_takes_the_level_loop():
    """Past the sweep's 512 lanes the tree hashes level by level: levels of
    at least min_level_rows pairs on the device, the rest on the host."""
    b = _backend(min_level_rows=256)
    DB.set_backend(b)
    try:
        rng = np.random.default_rng(3)
        leaves = rng.integers(0, 256, (1200, 32), dtype=np.uint8)
        tree = ChunkTree(1 << 11)
        tree.update(leaves)  # levels of 600 and 300 pairs on the device
        assert b.m_dispatches.get("htr_hash_pairs") == 2 and b.m_dispatches.get("htr_forest_sweep") == 0
        assert tree.root == merkleize_chunks(_chunks(leaves), 1 << 11)
        b.min_level_rows = 10**9
        leaves[:600] = rng.integers(0, 256, (600, 32), dtype=np.uint8)
        tree.update(leaves)
        assert b.dispatches == 2  # every level below the gate: the host
        assert tree.root == merkleize_chunks(_chunks(leaves), 1 << 11)
        _closed(b)
    finally:
        DB.reset_backend()


@pytest.mark.parametrize("device_first", [True, False])
def test_backend_switches_mid_stream(device_first):
    b = _backend()
    rng = np.random.default_rng(17 if device_first else 71)
    leaves = rng.integers(0, 256, (120, 32), dtype=np.uint8)
    tree, twin = ChunkTree(1 << 9), ChunkTree(1 << 9)
    clone = None
    try:
        for step in range(6):
            on_device = (step % 2 == 0) == device_first
            k = int(rng.integers(1, 12))
            idx = rng.integers(0, leaves.shape[0], k)
            leaves[idx] = rng.integers(0, 256, (k, 32), dtype=np.uint8)
            if step == 3:
                leaves = np.concatenate([leaves, rng.integers(0, 256, (13, 32), dtype=np.uint8)])
                clone = tree.clone()  # copy-on-write: the clone keeps the old root
                old_root = tree.root
            DB.set_backend(b if on_device else None)
            tree.update(leaves)
            DB.set_backend(None)
            twin.update(leaves)
            assert tree.root == twin.root == merkleize_chunks(_chunks(leaves), 1 << 9), (step, on_device)
        assert clone.root == old_root
        assert b.dispatches > 0
        _closed(b)
    finally:
        DB.reset_backend()


# -- the port's backend in the JAX package ----------------------------------------------


def test_jax_chunk_tree_on_the_port_backend():
    b = _backend()
    JDB.set_backend(b)
    try:
        rng = np.random.default_rng(5)
        leaves = rng.integers(0, 256, (300, 32), dtype=np.uint8)
        tree = JChunkTree(1 << 12)
        tree.update(leaves)
        for _ in range(3):
            leaves[rng.integers(0, 300, 9)] = rng.integers(0, 256, (9, 32), dtype=np.uint8)
            tree.update(leaves)
            assert tree.root == tree.full_root_reference() == merkleize_chunks(_chunks(leaves), 1 << 12)
        assert b.m_dispatches.get("htr_forest_sweep") == 4
        snap = JMG.memory_snapshot()["htr_device"]
        assert snap == {"active": True, "dispatches": 4, "last_dispatch_bytes": b.last_dispatch_bytes,
                        "peak_dispatch_bytes": b.peak_dispatch_bytes}
        assert b.last_dispatch_bytes == 12 * 512 * (16 + 1 + 1 + 8) * 4 + 12 * 4  # pairs, two maps, digests, live lanes
        _closed(b)
    finally:
        JDB.reset_backend()


def test_jax_state_engine_on_the_port_backend(monkeypatch):
    """The JAX package's BeaconState roots with the port's backend under its
    engine: every root equal to the full recompute (LODESTAR_TPU_HTR=check
    raises on an engine fault instead of recomputing), the backend carrying
    validator roots and sweeps, its breaker closed."""
    monkeypatch.setenv("LODESTAR_TPU_HTR", "check")
    b = _backend()
    JDB.set_backend(b)
    try:
        rng, nprng = random.Random(16), np.random.default_rng(16)
        st = _synthetic_state(24, 16)
        assert st.hash_tree_root() == _full_root(st)
        clone = None
        for step in range(3):
            _mutate_once(st, rng, nprng)
            if step == 0:
                clone = st.clone()
            if step == 1:
                process_slots(st, st.slot + 1)
            assert st.hash_tree_root() == _full_root(st)
        _mutate_once(clone, rng, nprng)
        assert clone.hash_tree_root() == _full_root(clone)
        assert b.m_dispatches.get("htr_validator_roots") >= 1 and b.m_dispatches.get("htr_forest_sweep") > 0
        assert JMG.memory_snapshot()["htr_device"]["dispatches"] == b.dispatches
        _closed(b)
    finally:
        JDB.reset_backend()


# -- the port's StateRootEngine against the JAX package's -----------------------------------


def _engine_sequence(n_validators, steps, seed, epochs=False):
    """(state, port engine) pairs through a randomized mutation sequence
    with clones and slot advances; each step's roots from the port's
    engine, the JAX package's engine and the full recompute."""
    rng, nprng = random.Random(seed), np.random.default_rng(seed)
    st = _synthetic_state(n_validators, seed)
    pairs = [(st, StateRootEngine())]
    assert pairs[0][1].hash_tree_root(st) == st.hash_tree_root() == _full_root(st)
    for step in range(steps):
        i = rng.randrange(len(pairs))
        target, engine = pairs[i]
        _mutate_once(target, rng, nprng)
        if rng.random() < 0.25 and len(pairs) < 3:
            pairs.append((target.clone(), engine.clone()))
        if epochs and step % 3 == 2:  # to the next epoch's first slot
            process_slots(target, (target.slot // SLOTS_PER_EPOCH + 1) * SLOTS_PER_EPOCH)
            engine.note_participation_rotation()
        for s, e in pairs:
            assert e.hash_tree_root(s) == s.hash_tree_root() == _full_root(s), step
    return pairs


def test_port_state_engine_matches_the_jax_engine_on_the_host_path():
    DB.set_backend(None)
    try:
        _engine_sequence(24, 12, 3)
        _engine_sequence(16, 9, 11, epochs=True)
    finally:
        DB.reset_backend()


def test_port_state_engine_on_the_port_backend(port_backend):
    pairs = _engine_sequence(20, 2, 7)
    assert port_backend.m_dispatches.get("htr_validator_roots") >= 1
    assert port_backend.m_dispatches.get("htr_forest_sweep") > 0
    _closed(port_backend)
    # engine accounting: clones share planes, released planes rebuild cold
    from lodestar_tpu_torch.state_transition import state_root_engine_bytes

    st, engine = pairs[0]
    assert engine.engine_bytes() > 0
    assert engine.release_planes() > 0 and engine.engine_bytes() == 0
    DB.set_backend(None)
    assert engine.hash_tree_root(st) == _full_root(st)

    class _S:
        _root_engine = engine

    assert state_root_engine_bytes([_S, _S]) == engine.engine_bytes()


# -- faults --------------------------------------------------------------------------------


@pytest.mark.parametrize("fault,outcome", [("error", "error"), ("bad_output", "bad_output")])
def test_fault_trips_the_breaker_and_roots_survive(port_backend, fault, outcome):
    rng = np.random.default_rng(9)
    leaves = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    tree = ChunkTree(128)
    tree.update(leaves)
    port_backend.fault = fault
    leaves[3] = rng.integers(0, 256, 32, dtype=np.uint8)
    tree.update(leaves)  # the sweep fails, the breaker trips, the host loop runs
    assert tree.root == merkleize_chunks(_chunks(leaves), 128)
    st = port_backend.supervisor.status()
    assert st["state"] == "open" and st["last_failure"]["outcome"] == outcome
    assert port_backend.m_host_levels.value == 7  # the sweep's levels
    # with the breaker open every seam declines and counts its levels
    pairs = rng.integers(0, 256, (2048, 64), dtype=np.uint8)
    assert port_backend.hash_level(pairs) is None
    cols = [np.zeros(1, np.uint64)] * 5
    assert port_backend.validator_roots(np.zeros((1, 32), np.uint8), np.zeros((1, 32), np.uint8), cols,
                                        np.zeros(1, bool)) is None
    assert port_backend.m_host_levels.value == 7 + 1 + 3
    np.testing.assert_array_equal(hash_pairs_plane(pairs[:4]), np.frombuffer(hash_pairs(pairs[:4].tobytes()),
                                                                             np.uint8).reshape(-1, 32))
    # the canary fails while the fault lasts and passes once healed
    with pytest.raises(Exception):
        port_backend._canary()
    port_backend.heal()
    assert port_backend._canary()


@pytest.mark.parametrize("kernel", ["forest_sweep", "validator_roots", "hash_pairs"])
def test_a_refused_launch_raises_from_the_state_root_path(monkeypatch, kernel):
    """A launch the card refuses (LaunchRefused, as the wrappers raise on a
    CUDA error such as a cluster the card cannot place) propagates out of
    the port's StateRootEngine from each seam: no host level, the breaker
    untouched."""
    b = _backend(min_level_rows=1)
    DB.set_backend(b)
    try:
        rng, nprng = random.Random(21), np.random.default_rng(21)
        st = _synthetic_state(20, 21)
        engine = StateRootEngine()
        if kernel == "forest_sweep":  # a dirty batch after the cold build
            assert engine.hash_tree_root(st) == _full_root(st)
            _mutate_once(st, rng, nprng)

        def refused(*args):
            raise B.LaunchRefused(f"{kernel} launch failed: cudaError 1")

        monkeypatch.setattr(SK, kernel, refused)
        with pytest.raises(B.LaunchRefused):
            engine.hash_tree_root(st)
        _closed(b)
    finally:
        DB.reset_backend()


def test_hash_level_and_validator_roots_seams(port_backend):
    port_backend.min_level_rows = 4
    rng = np.random.default_rng(12)
    pairs = rng.integers(0, 256, (5, 64), dtype=np.uint8)
    assert port_backend.hash_level(pairs[:3]) is None  # under the gate: not dispatched
    rows = port_backend.hash_level(pairs)
    np.testing.assert_array_equal(rows, np.frombuffer(hash_pairs(pairs.tobytes()), np.uint8).reshape(-1, 32))
    assert port_backend.last_dispatch_bytes == 5 * (16 + 8) * 4  # exactly n rows: no padding
    d = 3
    pk, cr = (rng.integers(0, 256, (d, 32), dtype=np.uint8) for _ in range(2))
    cols = [rng.integers(0, 2**63, d, dtype=np.uint64) for _ in range(5)]
    slashed = np.array([True, False, True])
    out = port_backend.validator_roots(pk, cr, cols, slashed)
    for i in range(d):
        chunks = [bytes(pk[i]), bytes(cr[i]), int(cols[0][i]).to_bytes(32, "little"),
                  bytes([int(slashed[i])]) + bytes(31)] + [int(c[i]).to_bytes(32, "little") for c in cols[1:]]
        assert bytes(out[i]) == merkleize_chunks(chunks, 8)
    empty = port_backend.validator_roots(np.zeros((0, 32), np.uint8), np.zeros((0, 32), np.uint8),
                                         [np.zeros(0, np.uint64)] * 5, np.zeros(0, bool))
    assert empty.shape == (0, 32) and port_backend.dispatches == 2
    _closed(port_backend)


# -- resolving the process backend ------------------------------------------------------


def test_maybe_backend_never_quietly_takes_the_host(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card resolves the backend on it")
    monkeypatch.delenv("LODESTAR_TPU_HTR_BACKEND", raising=False)
    DB.reset_backend()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            DB.maybe_backend()
        with pytest.raises(RuntimeError, match="CUDA"):
            DB.DeviceMerkleBackend()
        with pytest.raises(RuntimeError, match="CUDA"):
            ChunkTree(8).update(np.zeros((3, 32), np.uint8))
        monkeypatch.setenv("LODESTAR_TPU_HTR_BACKEND", "host")
        DB.reset_backend()
        assert DB.maybe_backend() is None
        assert DB.device_memory_snapshot()["active"] is False
        tree = ChunkTree(8)
        tree.update(np.ones((3, 32), np.uint8))
        assert tree.root == merkleize_chunks([bytes([1] * 32)] * 3, 8)
        monkeypatch.delenv("LODESTAR_TPU_HTR_BACKEND")
        DB.reset_backend()
        DB.set_backend(None)
        assert DB.maybe_backend() is None
    finally:
        DB.reset_backend()
