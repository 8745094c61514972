"""The port's shuffling and EpochCache (`lodestar_tpu_torch/state_transition/
util.py`, `epoch_cache.py`) against the JAX package's on the same plain
inputs (pubkeys, seed, epoch, active indices from numpy): the slot and
epoch arithmetic, the committee counts, the swap-or-not permutation,
every committee of an epoch and indexed attestations, compared exactly.
"""

import numpy as np
import pytest

from lodestar_tpu.state_transition import epoch_cache as JE
from lodestar_tpu.state_transition import util as JU
from lodestar_tpu_torch import params as TP
from lodestar_tpu_torch.state_transition import epoch_cache as TE
from lodestar_tpu_torch.state_transition import util as TU


def test_slot_and_epoch_arithmetic_equal_jax():
    for x in (0, 1, 31, 32, 33, 6_209_543, 2**40 + 5):
        assert TU.compute_epoch_at_slot(x) == JU.compute_epoch_at_slot(x)
        assert TU.compute_start_slot_at_epoch(x) == JU.compute_start_slot_at_epoch(x)
        assert TU.compute_activation_exit_epoch(x) == JU.compute_activation_exit_epoch(x)
    for n in (0, 1, 4095, 4096, 131_071, 131_072, 262_144, 1 << 20, 1 << 22):
        assert TU.compute_committee_count_per_slot(n) == JU.compute_committee_count_per_slot(n)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 2048, 16384])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shuffle_equals_jax(n, seed):
    s = np.random.default_rng(seed + 100 * n).bytes(32)
    pos = TU.shuffled_positions(n, s)
    assert np.array_equal(pos, JU.shuffled_positions(n, s))
    idx = np.random.default_rng(seed).permutation(4 * n)[:n]
    shuffled = TU.shuffle_list(idx, s)
    assert np.array_equal(shuffled, JU.shuffle_list(idx, s))
    assert np.array_equal(TU.unshuffle_list(shuffled, s), idx)
    assert np.array_equal(TU.unshuffle_list(shuffled, s), JU.unshuffle_list(shuffled, s))
    for j in sorted({0, n // 2, n - 1}):  # the spec's scalar form at a few positions
        assert TU.compute_shuffled_index(j, n, s) == JU.compute_shuffled_index(j, n, s) == pos[j]


def _caches(n, seed, active_share):
    rng = np.random.default_rng(seed)
    pubkeys = [rng.bytes(48) for _ in range(n)]
    active = np.sort(rng.choice(n, int(n * active_share), replace=False))
    epoch, s = int(rng.integers(0, 2**20)), rng.bytes(32)
    sync = rng.choice(n, TP.SYNC_COMMITTEE_SIZE).tolist()
    return (TE.EpochCache(pubkeys, epoch, s, active_indices=active, sync_committee_indices=sync),
            JE.EpochCache(pubkeys, epoch, s, active_indices=active, sync_committee_indices=sync), rng)


@pytest.mark.parametrize("n", [2048, 16384])
@pytest.mark.parametrize("seed", [3, 4])
def test_epoch_cache_equals_jax(n, seed):
    ours, theirs, rng = _caches(n, seed, 0.9 if seed % 2 else 1.0)
    assert ours.committees_per_slot == theirs.committees_per_slot
    assert np.array_equal(ours.active_indices, theirs.active_indices)
    assert ours.pubkey2index == theirs.pubkey2index
    assert [int(v) for v in ours.sync_committee_indices] == [int(v) for v in theirs.sync_committee_indices]
    first = ours.epoch * TP.SLOTS_PER_EPOCH
    seen = []
    for slot in range(first, first + TP.SLOTS_PER_EPOCH):
        for index in range(ours.committees_per_slot):
            com = ours.get_beacon_committee(slot, index)
            assert np.array_equal(com, theirs.get_beacon_committee(slot, index))
            seen.extend(com.tolist())
    # every active validator sits in exactly one committee of the epoch
    assert sorted(seen) == ours.active_indices.tolist()
    for _ in range(4):
        slot = first + int(rng.integers(TP.SLOTS_PER_EPOCH))
        index = int(rng.integers(ours.committees_per_slot))
        bits = [bool(b) for b in rng.integers(0, 2, len(ours.get_beacon_committee(slot, index)))]
        att = {"aggregation_bits": bits, "data": {"slot": slot, "index": index}, "signature": rng.bytes(96)}
        assert ours.get_indexed_attestation(att) == theirs.get_indexed_attestation(att)
        assert ours.get_attesting_indices(slot, index, bits) == theirs.get_attesting_indices(slot, index, bits)
    sync_bits = [bool(b) for b in rng.integers(0, 2, TP.SYNC_COMMITTEE_SIZE)]
    assert ours.get_sync_committee_participant_indices(sync_bits) == \
        theirs.get_sync_committee_participant_indices(sync_bits)
    with pytest.raises(ValueError):
        ours.get_attesting_indices(first, 0, [True])
    with pytest.raises(AssertionError):
        ours.get_beacon_committee(first + TP.SLOTS_PER_EPOCH, 0)
