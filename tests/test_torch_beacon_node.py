"""The port's BeaconNode (`lodestar_tpu_torch/node.py`) against the JAX
package's `BeaconNode`, both over the port's `TorchBlsVerifier` on the CPU
(the kernels' plain versions, 8-lane jobs as in tests/test_torch_node.py):
tests/test_node.py's gossip flow (four valid attestations, a duplicate
with a bad signature, a re-attestation in the same epoch), its dedupe
case, and backpressure (the service refusing work holds the gossip
queue until it accepts again) give the same verdict counts, queue
lengths and seen attesters on both nodes.  The port's node builds its own
verifier over the port's table when none is injected, and refuses the
REST API it does not have.
"""

import time

import pytest
import torch

from lodestar_tpu.config import MAINNET_CHAIN_CONFIG as J_MAINNET
from lodestar_tpu.crypto import bls as B
from lodestar_tpu.crypto import curves as C
from lodestar_tpu.node import BeaconNode as JBeaconNode
from lodestar_tpu.node import NodeOptions as JNodeOptions
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.bls import pubkey_table as PT
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.config import MAINNET_CHAIN_CONFIG
from lodestar_tpu_torch.node import BeaconNode, NodeOptions

N_KEYS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_shapes(monkeypatch):
    """8-lane jobs, 4-lane hash batches (the plain engine's cost is per
    call, not per lane)."""
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))
    monkeypatch.setattr(IN, "BT", 4)


@pytest.fixture(scope="module")
def world():
    """test_node.py's keys, the port's table of them, and one message
    cache every verifier of the module shares (a root hashes once)."""
    sks = [B.keygen(b"node-%d" % i) for i in range(N_KEYS)]
    table = PT.PubkeyTable(capacity=N_KEYS)
    table.register_points_unchecked([B.sk_to_pk(sk) for sk in sks])
    return sks, table, IN.MessageCache(device="cpu")


def _flow(node, sks):
    """test_node.py's gossip flow, its dedupe case and a backpressure
    hold; -> every count the node shows."""
    root = b"node root".ljust(32, b"\x00")
    sig = [C.g2_compress(B.sign(sk, root)) for sk in sks]
    bad = C.g2_compress(B.sign(sks[0], b"other".ljust(32, b"\x00")))
    out = []
    for i in range(N_KEYS):
        node.on_gossip_attestation(i, 0, b"data-0", root, sig[i])
    node.on_gossip_attestation(1, 0, b"data-0", root, bad)  # seen: dropped
    out.append(node.drain_verdicts(timeout=600))
    node.on_gossip_attestation(3, 1, b"data-1", root, bad)  # validator 3 already attested in epoch 0
    out.append(node.drain_verdicts(timeout=600))
    # epoch 1: validator 0 twice (one verdict), and 1, 2 while the service refuses work
    node.on_gossip_attestation(0, 32, b"d", root, sig[0])
    node.on_gossip_attestation(0, 32, b"d", root, sig[0])
    accept = node.processor.can_accept_work_fns[0]
    node.processor.can_accept_work_fns[0] = lambda: False
    node.on_gossip_attestation(1, 33, b"d", root, sig[1])
    node.on_gossip_attestation(2, 33, b"d", root, sig[2])
    out.append((node.processor.queue_lengths()["beacon_attestation"], len(node._futures),
                node.processor.stats.cannot_accept_ticks > 0))
    node.processor.can_accept_work_fns[0] = accept
    node.processor.execute_work()
    out.append(node.drain_verdicts(timeout=600))
    out.append([[node.seen_attesters.is_known(e, v) for v in range(N_KEYS)] for e in (0, 1)])
    out.append((node.processor.stats.submitted, node.processor.stats.dropped, node.processor.queue_lengths()))
    return out


def test_port_node_gives_the_jax_nodes_verdicts(world):
    sks, table, cache = world
    got = []
    v = VR.TorchBlsVerifier(table, device="cpu")
    v.messages = cache
    jnode = JBeaconNode(J_MAINNET, pubkey_table=None, opts=JNodeOptions(verifier=v, serve_api=False))
    try:
        got.append(_flow(jnode, sks))
    finally:
        jnode.close()
    # the port's node builds its own verifier over the port's table
    node = BeaconNode(MAINNET_CHAIN_CONFIG, table, opts=NodeOptions(device="cpu"))
    try:
        assert isinstance(node.bls.verifier, VR.TorchBlsVerifier) and node.bls.verifier.table is table
        assert node.bls.verifier.device.type == "cpu" and node.bls.verifier.metrics is node.metrics
        node.bls.verifier.messages = cache
        got.append(_flow(node, sks))
        host_sets = node.bls.verifier.supervisor.m_host_fallback_sets.value
    finally:
        node.close()
    assert got[0] == got[1]
    assert got[1][:4] == [N_KEYS, 0, (2, 1, True), 3]
    assert host_sets == 0


def test_the_port_node_has_no_rest_api_yet(world):
    _sks, table, _cache = world
    assert NodeOptions().serve_api is False and JNodeOptions().serve_api is True
    with pytest.raises(NotImplementedError, match="REST API"):
        BeaconNode(MAINNET_CHAIN_CONFIG, table, opts=NodeOptions(serve_api=True, device="cpu"))


def test_the_port_node_runs_on_the_card_by_default(world):
    """With no device the node's verifier goes to the CUDA device: on a
    host without one that raises, and only device="cpu" takes the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _sks, table, _cache = world
    with pytest.raises(RuntimeError, match="CUDA"):
        BeaconNode(MAINNET_CHAIN_CONFIG, table)


def test_the_port_node_reports_each_verdict_and_its_parked_count(world):
    """`on_verdict` sees every submission once, with its seen_at and its
    verdict; `processor.awaiting_count` counts a message parked for an
    unknown block until the block is processed."""
    sks, table, cache = world
    root = b"observed root".ljust(32, b"\x00")
    sig = [C.g2_compress(B.sign(sk, root)) for sk in sks[:3]]
    bad = C.g2_compress(B.sign(sks[2], b"other".ljust(32, b"\x00")))
    node = BeaconNode(MAINNET_CHAIN_CONFIG, table, opts=NodeOptions(device="cpu"))
    try:
        node.bls.verifier.messages = cache
        seen = []
        node.on_verdict = lambda v, seen_at, fut: seen.append((v, seen_at, fut.result()))
        node.on_gossip_attestation(0, 5, b"d", root, sig[0])
        node.on_gossip_attestation(0, 5, b"d", root, sig[0])  # pending: no second submission
        node.on_gossip_attestation(2, 5, b"d", root, bad)
        node.on_gossip_attestation(1, 5, b"d", root, sig[1], block_root="b")
        assert node.processor.awaiting_count == 1
        assert node.drain_verdicts(timeout=600) == 1
        node.fork_choice.on_block(4, "b", "genesis")
        node.processor.on_block_processed(5, "b")
        assert node.processor.awaiting_count == 0
        assert node.drain_verdicts(timeout=600) == 1
    finally:
        node.close()
    assert sorted((v, ok) for v, _, ok in seen) == [(0, True), (1, True), (2, False)]
    assert all(0 < seen_at <= time.time() for _, seen_at, _ in seen)
