"""The port's next-slot preparation, proposer cache and merge tracker
against the JAX package's.

tests/test_prepare_next_slot.py's and tests/test_merge_tracker.py's
scenarios run on both packages on the same inputs: the proposer cache's
expiry; the scheduler's epoch precompute landing in the checkpoint cache
(and the duties reading it from there), its payload preparation for a
registered proposer with the advanced state's attributes, and the
governor's skip rung; the tracker's backward TTD walk, its status
machine, the terminal-hash override and a genesis at TTD, over one PoW
chain handed to both as a list of `PowMergeBlock`s; the transition block
whose payload extends the discovered terminal block.  The port runs on
its host merkle path.
"""

import importlib

import pytest

from lodestar_tpu_torch.ssz import device_backend as DB

from test_torch_beacon_state import J, P, keys
from test_torch_builder import cfg_of, proposer_at, randao, sign_block

SPE = P.params.ACTIVE_PRESET.SLOTS_PER_EPOCH
N = 8


def pns(M):
    return importlib.import_module(f"{M.pkg}.chain.prepare_next_slot")


def eth1(M):
    return importlib.import_module(f"{M.pkg}.eth1")


@pytest.fixture(autouse=True)
def host():
    DB.set_backend(None)
    yield
    DB.reset_backend()


def test_proposer_cache_expiry():
    seen = []
    for M in (J, P):
        cache = pns(M).BeaconProposerCache()
        cache.add(epoch=5, proposer_index=1, fee_recipient=b"\x01" * 20)
        cache.add(epoch=7, proposer_index=2, fee_recipient=b"\x02" * 20)
        got = [cache.get(1), cache.get(2), len(cache)]
        cache.prune(epoch=8)  # preserve window = 2 epochs
        got += [cache.get(1), cache.get(2), len(cache)]
        seen.append(got)
    assert seen[1] == seen[0] == [b"\x01" * 20, b"\x02" * 20, 2, None, b"\x02" * 20, 1]


def _bellatrix_chain(M, sks, pks):
    cfg = cfg_of(M, altair=0, bellatrix=0)
    genesis = M.gen.create_genesis_state(cfg, pks, genesis_time=2)
    M.slot.upgrade_to_bellatrix(genesis)
    el = M.execution.ExecutionEngineMock()
    return cfg, M.chain.BeaconChain(cfg, genesis, execution=el), el


def _propose(M, cfg, chain, sks, slot):
    p = proposer_at(M, chain, slot)
    block = chain.produce_block(slot, randao(M, cfg, sks[p], slot))
    return chain.process_block(sign_block(M, cfg, block, sks[p]))


def test_epoch_precompute_lands_in_checkpoint_cache():
    sks, pks = keys(N)
    seen = []
    for M in (J, P):
        cfg, chain, _el = _bellatrix_chain(M, sks, pks)
        sched = pns(M).PrepareNextSlotScheduler(chain)
        head_root = chain.get_head_root()
        got = []
        sched.on_head(head_root, 3)  # mid-epoch: nothing epoch-wise
        got.append(sched.prepared_epochs)
        sched.on_head(head_root, SPE - 1)  # the epoch's last slot precomputes the boundary
        got.append(sched.prepared_epochs)
        cached = chain.regen.checkpoint_cache.get({"epoch": 1, "root": head_root})
        got += [cached is not None and cached.slot, cached.serialize()]
        sched.on_head(head_root, SPE - 1)  # a repeat is a cache hit
        sched.on_slot(SPE)  # the empty-slot fallback: the same boundary, still cached
        got.append(sched.prepared_epochs)
        # the duties of epoch 1 read the precomputed state from the checkpoint cache
        got.append(chain.get_proposer_duties(1))
        assert chain.regen.get_checkpoint_state({"epoch": 1, "root": head_root}) is cached
        seen.append(got)
    assert seen[1] == seen[0]
    assert seen[1][:3] == [0, 1, SPE] and seen[1][4] == 1


def test_payload_preparation_for_registered_proposer():
    sks, pks = keys(N)
    seen = []
    for M in (J, P):
        cfg, chain, el = _bellatrix_chain(M, sks, pks)
        root1 = _propose(M, cfg, chain, sks, 1)
        assert chain.head_root_hex in chain._execution_block_hash
        sched = pns(M).PrepareNextSlotScheduler(chain)
        nxt = int(chain.get_proposer_duties(0)[2]["validator_index"])
        before = len(el.preparing)
        sched.on_head(root1, 1)  # unregistered: no payload prepared
        got = [sched.payloads_prepared, len(el.preparing) - before]
        sched.proposer_cache.add(0, nxt, b"\xfe" * 20)
        sched.on_head(root1, 1)
        got += [sched.payloads_prepared, len(el.preparing) - before]
        payload = list(el.preparing.values())[-1]
        adv = chain.regen.get_block_slot_state(bytes(root1).hex(), 2)
        assert bytes(payload["prev_randao"]) == bytes(M.acc.get_randao_mix(adv, 0))
        assert bytes(payload["fee_recipient"]) == b"\xfe" * 20
        # production reads the same cache: the proposal's payload is the prepared one
        chain.proposer_cache = sched.proposer_cache
        block = chain.produce_block(2, randao(M, cfg, sks[nxt], 2))
        got.append(block["body"]["execution_payload"])
        got.append(payload)
        seen.append(got)
    assert seen[1] == seen[0]
    assert seen[1][:4] == [0, 0, 1, 1]
    assert bytes(seen[1][4]["fee_recipient"]) == b"\xfe" * 20
    assert seen[1][4]["block_hash"] == seen[1][5]["block_hash"]


def test_governor_skip_rung_skips_precompute():
    sks, pks = keys(N)
    seen = []
    for M in (J, P):
        _cfg, chain, _el = _bellatrix_chain(M, sks, pks)
        chain.memory_governor.skip_precompute = lambda: True
        sched = pns(M).PrepareNextSlotScheduler(chain)
        sched.on_head(chain.get_head_root(), SPE - 1)
        seen.append((sched.precomputes_skipped, sched.prepared_epochs,
                     len(list(chain.regen.checkpoint_cache.states()))))
    assert seen[1] == seen[0] and seen[1][:2] == (1, 0)


class PowChain:
    """A fake eth1 provider over a linear PoW chain of `PowMergeBlock`s
    (block i has hash ii*32), made the same for either package."""

    def __init__(self, M, tds):
        self.M = M
        self.blocks = {}
        prev = "00" * 32
        for i, td in enumerate(tds, start=1):
            h = ("%02x" % i) * 32
            self.blocks[h] = eth1(M).PowMergeBlock(number=i, block_hash=h, parent_hash=prev, total_difficulty=td)
            prev = h
        self.head = prev
        self.calls = 0

    def get_pow_block_by_hash(self, block_hash):
        self.calls += 1
        return self.blocks.get(block_hash)

    def get_pow_block_latest(self):
        return self.blocks[self.head]


def _as_tuple(b):
    return None if b is None else (b.number, b.block_hash, b.parent_hash, b.total_difficulty)


@pytest.mark.parametrize("tds,ttd,override", [
    ([4, 9, 15, 22], 10, None),  # the first block at or over TTD: 3
    ([4, 9], 100, None),  # TTD not reached
    ([4, 9, 15], 10, "02" * 32),  # the override wins whatever the TTD
    ([50], 10, None),  # a genesis at TTD
    ([10, 11, 12], 10, None),  # every block over TTD: the walk ends at genesis
])
def test_ttd_walk_equals_jax(tds, ttd, override):
    seen = []
    for M in (J, P):
        pow_chain = PowChain(M, tds)
        kw = {"terminal_block_hash": bytes.fromhex(override)} if override else {}
        tr = eth1(M).Eth1MergeBlockTracker(pow_chain, terminal_total_difficulty=ttd, **kw)
        found = tr.get_terminal_pow_block()
        calls = pow_chain.calls
        again = tr.get_terminal_pow_block()  # latched when found: no new walk
        seen.append((_as_tuple(found), tr.status.value, _as_tuple(again), pow_chain.calls - calls,
                     tr.get_td_progress()))
    assert seen[1] == seen[0]


def test_polling_status_machine():
    seen = []
    for M in (J, P):
        pow_chain = PowChain(M, [4, 9])
        tr = eth1(M).Eth1MergeBlockTracker(pow_chain, terminal_total_difficulty=10)
        got = [tr.status.value]
        tr.start_polling_merge_block()
        got += [tr.status.value, _as_tuple(tr.get_terminal_pow_block()), _as_tuple(tr.on_tick())]
        pow_chain.blocks["03" * 32] = eth1(M).PowMergeBlock(3, "03" * 32, "02" * 32, 12)
        pow_chain.head = "03" * 32
        got += [_as_tuple(tr.on_tick()), tr.status.value, _as_tuple(tr.get_terminal_pow_block())]
        pow_chain.head = "ff" * 32  # an EL flake while FOUND changes nothing
        got.append(_as_tuple(tr.on_tick()))
        seen.append(got)
    assert seen[1] == seen[0]
    assert seen[1][:2] == ["STOPPED", "SEARCHING"] and seen[1][4][0] == 3 and seen[1][5] == "FOUND"


def test_transition_block_uses_discovered_terminal_block():
    """The merge-transition proposal's payload parent is discovered by the
    tracker; the block imports and completes the merge, equal on both."""
    sks, pks = keys(N)
    seen = []
    for M in (J, P):
        cfg = cfg_of(M, altair=0, bellatrix=1)
        genesis = M.gen.create_genesis_state(cfg, pks, genesis_time=2)
        el = M.execution.ExecutionEngineMock()
        chain = M.chain.BeaconChain(cfg, genesis, execution=el)
        pow_chain = PowChain(M, [5, 11, 20])
        for h, blk in pow_chain.blocks.items():
            el.valid_blocks[bytes.fromhex(h)] = bytes.fromhex(blk.parent_hash)
        tracker = eth1(M).Eth1MergeBlockTracker(pow_chain, terminal_total_difficulty=10)
        chain.merge_block_tracker = tracker
        slot = SPE + 1
        p = proposer_at(M, chain, slot)
        block = chain.produce_block(slot, randao(M, cfg, sks[p], slot))
        payload = block["body"]["execution_payload"]
        root = chain.process_block(sign_block(M, cfg, block, sks[p]))
        assert M.blk.is_merge_transition_complete(chain.head_state)
        seen.append((bytes(payload["parent_hash"]).hex(), tracker.status.value, root,
                     chain.head_state.serialize()))
    assert seen[1] == seen[0]
    assert seen[1][0] == "02" * 32 and seen[1][1] == "FOUND"


def test_tracker_fault_falls_back_to_a_zero_parent():
    """An eth1 flake in the tracker does not kill the proposal: the
    payload's parent stays the zero hash, as in the JAX package."""
    sks, pks = keys(N)
    seen = []

    class Broken:
        def get_terminal_pow_block(self):
            raise LookupError("eth1 down")

    for M in (J, P):
        cfg = cfg_of(M, altair=0, bellatrix=1)
        chain = M.chain.BeaconChain(cfg, M.gen.create_genesis_state(cfg, pks, genesis_time=2),
                                    execution=M.execution.ExecutionEngineMock())
        chain.merge_block_tracker = Broken()
        slot = SPE + 1
        p = proposer_at(M, chain, slot)
        block = chain.produce_block(slot, randao(M, cfg, sks[p], slot))
        seen.append(bytes(block["body"]["execution_payload"]["parent_hash"]))
    assert seen[1] == seen[0] == b"\x00" * 32
