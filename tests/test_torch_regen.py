"""The port's regen, state caches and memory governor against the JAX
package's on the same imported chain.

Each package imports the same four blocks (no signatures checked: the
regen path replays the state transition from the db) into a
`StateRegenerator` over its own fork choice and db; states regenerated
from the caches and by replay after eviction are held byte for byte, and
a governor under a small budget evicts, demotes and replays as the JAX
package's does.  The port's roots run on `DeviceMerkleBackend("cpu")`.
"""

import hashlib

import pytest

from test_torch_beacon_state import (  # noqa: F401  (fixtures)
    J,
    P,
    cold_root,
    config,
    host_path,
    installed,
    world,
)

N_BLOCKS = 4


def _imported(M, w, tmp_path, governor=None, pins=None):
    genesis = M.gen.create_genesis_state(config(M), w.pks, genesis_time=7)
    if pins is not None:
        pins.add(genesis.hash_tree_root().hex())  # the regen anchor
    groot = M.T.BeaconBlockHeader.hash_tree_root(
        dict(genesis.latest_block_header, state_root=genesis.hash_tree_root())).hex()
    fc = M.fc.ForkChoice(M.fc.ProtoArray(finalized_root=groot), justified_root=groot)
    db = M.db.BeaconDb(str(tmp_path / M.pkg))
    regen = M.regen.StateRegenerator(fc, db, governor=governor)
    regen.on_imported_block(bytes.fromhex(groot), genesis)
    state, roots, posts = genesis, [groot], [genesis]
    for slot in range(1, N_BLOCKS + 1):
        block, post = M.pb.produce_block(state, slot, hashlib.sha256(b"rv%d" % slot).digest() * 3)
        root = M.T.BeaconBlockAltair.hash_tree_root(block)
        fc.on_block(slot, root.hex(), block["parent_root"].hex())
        db.put_block(root, {"message": block, "signature": b"\x00" * 96})
        regen.on_imported_block(root, post)
        state = post
        roots.append(root.hex())
        posts.append(post)
    return regen, roots, posts, db


def _scenario(M, w, tmp_path):
    regen, roots, posts, db = _imported(M, w, tmp_path)
    out = [regen.get_block_slot_state(roots[-1], N_BLOCKS + 2).serialize()]
    for post in posts[1:]:
        regen.state_cache.delete(post.hash_tree_root().hex())
    before = regen.replayed_blocks
    out.append(regen.get_block_slot_state(roots[-1], N_BLOCKS).serialize())
    out.append(regen.replayed_blocks - before)
    out.append(regen.get_pre_state({"parent_root": bytes.fromhex(roots[2]), "slot": 3}).serialize())
    cp = regen.get_checkpoint_state({"epoch": 1, "root": bytes.fromhex(roots[-1])})
    out.append(cp.serialize())
    with pytest.raises(M.regen.RegenError):
        regen.get_state("ab" * 32)
    q = M.regen.QueuedStateRegenerator(regen)
    try:
        out.append(q.get_block_slot_state(roots[1], 1).result(timeout=60).serialize())
        with pytest.raises(M.regen.RegenError):
            q.get_state("ee" * 32).result(timeout=60)
    finally:
        q.close()
    db.close()
    return out


def test_regen_replays_after_eviction_as_jax(host_path, tmp_path):
    """On the port's host merkle path (the checkpoint state advances 28
    empty slots); the replayed head's root is then held on the CPU
    backend."""
    theirs = _scenario(J, host_path, tmp_path)
    ours = _scenario(P, host_path, tmp_path)
    assert ours == theirs
    assert ours[2] == N_BLOCKS
    replayed = P.state.BeaconState.deserialize(ours[1], config(P))
    assert cold_root(replayed, host_path.backend) == J.state.BeaconState.deserialize(
        theirs[1], config(J)).hash_tree_root()


def test_governor_under_a_small_budget_as_jax(host_path, tmp_path):
    """A budget far below one state's planes: the governor evicts and
    demotes unpinned states as the JAX package's does, and every state
    regenerates bit for bit (spilled ones rehydrate, evicted ones
    replay).  On the port's host merkle path: each rehydrated state
    rebuilds its planes cold."""
    installed = host_path
    results = []
    for M in (J, P):
        gov = M.gov.StateMemoryGovernor(1 << 16, config=config(M))
        pins = set()
        gov.pinned_fn = lambda: (pins, lambda epoch, root: False)
        regen, roots, posts, db = _imported(M, installed, tmp_path, governor=gov, pins=pins)
        gov.on_slot(N_BLOCKS)
        st = gov.status()
        again = [regen._get_post_state(r).serialize() for r in roots]
        results.append((st["evictions"], st["entries"], st["pressure_events"], again,
                        [p.serialize() for p in posts]))
        assert M.gov.memory_snapshot()["governors"] >= 1
        db.close()
    assert results[1] == results[0]
    assert sum(results[1][0].values()) > 0
    assert results[1][3] == results[1][4]


def test_budget_from_env_as_jax(monkeypatch):
    for raw in (None, "0", "512m", "3g", "junk", "-4"):
        if raw is None:
            monkeypatch.delenv("LODESTAR_TPU_STATE_BUDGET", raising=False)
        else:
            monkeypatch.setenv("LODESTAR_TPU_STATE_BUDGET", raw)
        assert P.gov.budget_from_env() == J.gov.budget_from_env()


def test_state_caches_as_jax():
    class FakeState:
        def __init__(self, n):
            self.n = n

        def hash_tree_root(self):
            return bytes([self.n]) * 32

    seen = []
    for M in (J, P):
        cache = M.state_cache.StateContextCache(max_states=3)
        for i in range(5):
            cache.add(FakeState(i))
        got = [len(cache), cache.get((b"\x00" * 32).hex()) is None, cache.get((b"\x04" * 32).hex()).n]
        cp = M.state_cache.CheckpointStateCache(max_epochs=2)
        for epoch in range(4):
            cp.add({"epoch": epoch, "root": b"\xaa" * 32}, FakeState(epoch))
        got += [len(cp), cp.get({"epoch": 0, "root": b"\xaa" * 32}) is None,
                cp.get_latest((b"\xaa" * 32).hex(), max_epoch=10).n]
        cp.prune_finalized(4)
        got.append(len(cp))
        seen.append(got)
    assert seen[0] == seen[1]
