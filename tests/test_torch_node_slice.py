"""The node slice of the port end to end on the CPU: the port's EpochCache
over a small registry, AttestationData signing roots from the port's
extractors on a BeaconStateView of the port's MAINNET_CHAIN_CONFIG at a
capella slot, the committees' gossip (one malformed signature, one exact
re-publish, one slot voting for a block the fork choice does not know
yet) through the port's BeaconNode, the block imported and the parked
attestations released; the JAX BeaconNode, over the port's verifier,
gets the same gossip.  The accepted validators are the construction's on
both nodes, and the port's fork choice puts the head where the votes
point.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu import config as JC
from lodestar_tpu.crypto import bls as B
from lodestar_tpu.crypto import curves as C
from lodestar_tpu.node import BeaconNode as JBeaconNode
from lodestar_tpu.node import NodeOptions as JNodeOptions
from lodestar_tpu.state_transition import epoch_cache as JE
from lodestar_tpu.state_transition import signature_sets as JS
from lodestar_tpu_torch import config as TC
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.bls import pubkey_table as PT
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.node import BeaconNode, NodeOptions
from lodestar_tpu_torch.params import SLOTS_PER_EPOCH
from lodestar_tpu_torch.state_transition import epoch_cache as TE
from lodestar_tpu_torch.state_transition import signature_sets as TS

N_KEYS = 4
N_VALIDATORS = 64  # one committee of 2 a slot
EPOCH = 194_048 + 3  # capella on mainnet
N_SLOTS = 4  # the slots of the epoch whose committees attest; the last one's block arrives late


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_shapes(monkeypatch):
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))
    monkeypatch.setattr(IN, "BT", 4)


def _slice():
    """Keys, table, epoch caches, the slot's data, roots and the gossip."""
    rng = np.random.default_rng(16)
    sks = [B.keygen(rng.bytes(32)) for _ in range(N_KEYS)]
    pks = [B.sk_to_pk(sk) for sk in sks]
    comp = [C.g1_compress(pk) for pk in pks]
    keys = [comp[r % N_KEYS] for r in range(N_VALIDATORS)]
    table = PT.PubkeyTable()
    table.register_points_unchecked(pks, tile_to=N_VALIDATORS)
    seed = rng.bytes(32)
    cache, jcache = TE.EpochCache(keys, EPOCH, seed), JE.EpochCache(keys, EPOCH, seed)
    first = EPOCH * SLOTS_PER_EPOCH
    view = TS.BeaconStateView(config=TC.MAINNET_CHAIN_CONFIG, slot=first + N_SLOTS, epoch_cache=cache)
    jview = JS.BeaconStateView(config=JC.MAINNET_CHAIN_CONFIG, slot=first + N_SLOTS, epoch_cache=jcache)
    head, late, parent, genesis = (rng.bytes(32).hex() for _ in range(4))
    source = {"epoch": EPOCH - 1, "root": bytes.fromhex(parent)}
    target = {"epoch": EPOCH, "root": rng.bytes(32)}
    gossip, want = [], set()
    for k in range(N_SLOTS):
        slot = first + k
        block = late if k == N_SLOTS - 1 else head
        data = {"slot": slot, "index": 0, "beacon_block_root": bytes.fromhex(block), "source": source,
                "target": target}
        root = TS.get_attestation_data_signing_root(view, data)
        assert root == JS.get_attestation_data_signing_root(jview, data)
        committee = cache.get_beacon_committee(slot, 0).tolist()
        assert committee == jcache.get_beacon_committee(slot, 0).tolist() and len(committee) == 2
        for j, v in enumerate(committee):
            sig = C.g2_compress(B.sign(sks[v % N_KEYS], root))
            if k == 1 and j == 0:
                sig = bytes([sig[0] & 0x7F]) + sig[1:]  # no compression bit: refused before any device work
            else:
                want.add(v)
            gossip.append((v, slot, root, sig, block))
    gossip.append(gossip[2])  # an exact re-publish
    return table, gossip, want, (genesis, parent, head, late), first


def _run(node, gossip, blocks, first):
    genesis, parent, head, late = blocks
    node.fork_choice.on_block(first - 2, parent, genesis)
    node.fork_choice.on_block(first - 1, head, parent)
    for v, slot, root, sig, block in gossip:
        node.on_gossip_attestation(v, slot, b"data", root, sig, block_root=block)
    parked = node.processor._awaiting_count
    accepted = node.drain_verdicts(timeout=600)
    node.fork_choice.on_block(first - 1, late, parent)
    node.processor.on_block_processed(first + N_SLOTS - 1, late)
    accepted += node.drain_verdicts(timeout=600)
    seen = {v for v, *_ in gossip if node.seen_attesters.is_known(EPOCH, v)}
    return parked, accepted, seen, node.processor.stats.submitted


def test_node_slice_equals_jax():
    table, gossip, want, blocks, first = _slice()
    cache = IN.MessageCache(device="cpu")
    v = VR.TorchBlsVerifier(table, device="cpu")
    v.messages = cache
    jnode = JBeaconNode(JC.MAINNET_CHAIN_CONFIG, None, genesis_root=blocks[0],
                        opts=JNodeOptions(verifier=v, serve_api=False))
    try:
        theirs = _run(jnode, gossip, blocks, first)
    finally:
        jnode.close()
    node = BeaconNode(TC.MAINNET_CHAIN_CONFIG, table, genesis_root=blocks[0], opts=NodeOptions(device="cpu"))
    try:
        node.bls.verifier.messages = cache
        ours = _run(node, gossip, blocks, first)
        fc = node.fork_choice
        for val in sorted(ours[2]):
            fc.on_attestation(val, EPOCH, next(b for w, *_, b in gossip if w == val))
        fc.set_balances(np.full(N_VALIDATORS, 32 * 10**9, np.int64))
        head = fc.update_head()
        host_sets = node.bls.verifier.supervisor.m_host_fallback_sets.value
    finally:
        node.close()
    assert ours == theirs
    parked, accepted, seen, submitted = ours
    assert parked == 2 and seen == want and accepted == len(want) and submitted == len(gossip)
    assert head == blocks[2] and host_sets == 0
