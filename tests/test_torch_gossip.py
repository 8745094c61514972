"""The port's gossip queues, network processor, slot clock and seen caches
(`lodestar_tpu_torch/network/`, `chain/clock.py`, `chain/seen_cache.py`)
against the JAX package's, on the same message script made with numpy
from a seed: LIFO and FIFO drops by count and by an escalating ratio,
parking of unknown block roots and their release, expiry per slot, the
per-tick cap and backpressure and the drop observer; every processed
message, drop and counter compared exactly.
"""

import dataclasses

import numpy as np
import pytest

from lodestar_tpu.chain import clock as JCL
from lodestar_tpu.chain import seen_cache as JSC
from lodestar_tpu.network import gossip_queues as JQ
from lodestar_tpu.network import processor as JPR
from lodestar_tpu.utils.metrics import Registry as JRegistry
from lodestar_tpu_torch.chain import clock as TCL
from lodestar_tpu_torch.chain import seen_cache as TSC
from lodestar_tpu_torch.network import gossip_queues as TQ
from lodestar_tpu_torch.network import processor as TPR
from lodestar_tpu_torch.utils.metrics import Registry as TRegistry

SIDES = ((TQ, TPR, TRegistry), (JQ, JPR, JRegistry))


def test_queue_shapes_equal_jax():
    assert [t.value for t in TQ.GossipType] == [t.value for t in JQ.GossipType]
    for t, o in TQ.GOSSIP_QUEUE_OPTS.items():
        j = JQ.GOSSIP_QUEUE_OPTS[JQ.GossipType(t.value)]
        assert (o.type.value, o.max_length, type(o.drop).__name__, vars(o.drop)) == (
            j.type.value, j.max_length, type(j.drop).__name__, vars(j.drop))
    assert [(t.value, b) for t, b in TPR.EXECUTE_GOSSIP_WORK_ORDER] == \
        [(t.value, b) for t, b in JPR.EXECUTE_GOSSIP_WORK_ORDER]
    assert (TPR.MAX_JOBS_SUBMITTED_PER_TICK, TPR.MAX_QUEUED_UNKNOWN_BLOCK_GOSSIP_OBJECTS,
            TPR.EARLIEST_PERMISSABLE_SLOT_DISTANCE) == (JPR.MAX_JOBS_SUBMITTED_PER_TICK,
                                                        JPR.MAX_QUEUED_UNKNOWN_BLOCK_GOSSIP_OBJECTS,
                                                        JPR.EARLIEST_PERMISSABLE_SLOT_DISTANCE)


@pytest.mark.parametrize("kind", ["LIFO-count", "FIFO-count", "LIFO-ratio", "FIFO-ratio"])
def test_queue_drops_equal_jax(kind):
    qtype, drop = kind.split("-")
    out = []
    for Q, _, Reg in SIDES:
        d = Q.DropByCount(3) if drop == "count" else Q.DropByRatio(0.1, 0.05)
        dropped_items = []
        q = Q.GossipQueue(Q.GossipQueueOpts(Q.QueueType[qtype], 50, d), topic="t",
                          metrics=Q.GossipQueueMetrics(Reg()), on_drop=dropped_items.append)
        r = np.random.default_rng(7)
        log = []
        for i in range(600):
            if r.random() < 0.7:
                log.append(("add", q.add(i)))
            else:
                log.append(("next", q.next()))
            log.append(("state", len(q), round(q.drop_ratio, 12)))
        log.append(("rest", q.get_all(), dropped_items, q.metrics.dropped.get("t")))
        out.append(log)
    assert out[0] == out[1]


def _run_processor(Q, P, Reg, seed):
    """One processor through a random script of gossip, blocks, clock
    slots and backpressure flips; -> everything it observably did."""
    rng = np.random.default_rng(seed)
    done, charged = [], []
    accept = [True]
    known = {"r0"}

    class Scorer:
        def on_backpressure_drop(self, peer, topic):
            charged.append((peer, topic))

    proc = P.NetworkProcessor(lambda m: done.append((m.topic.value, m.data)), [lambda: accept[0]],
                              has_block_root=known.__contains__, max_jobs_per_tick=16, registry=Reg(),
                              scorer=Scorer())
    for q in proc.queues.values():  # short queues, so both drop rules fire within the script
        q.opts = dataclasses.replace(q.opts, max_length=min(q.opts.max_length, 24))
    topics = list(Q.GossipType)
    trips = []
    proc.on_backpressure_trip = trips.append
    slot = 40
    proc.on_clock_slot(slot)
    log = []
    for i in range(3000):
        r = rng.random()
        if r < 0.8:
            topic = topics[int(rng.choice(len(topics), p=[0.02, 0.05, 0.02, 0.02, 0.8, 0.01, 0.01, 0.02, 0.03,
                                                          0.01, 0.01]))]
            root = f"r{int(rng.integers(0, 6))}" if rng.random() < 0.3 else None
            msg_slot = slot - int(rng.integers(0, 40))
            proc.on_gossip_message(P.PendingGossipMessage(topic, i, slot=msg_slot, block_root=root,
                                                          peer_id=f"p{i % 7}"))
        elif r < 0.86:
            accept[0] = not accept[0]
            proc.execute_work()
        elif r < 0.93:
            root = f"r{int(rng.integers(0, 6))}"
            known.add(root)
            proc.on_block_processed(slot - int(rng.integers(0, 3)), root)
        else:
            slot += 1
            proc.on_clock_slot(slot)
        if i % 100 == 0:
            log.append(proc.queue_lengths())
    s = proc.stats
    return (done, charged, trips, log, proc.queue_lengths(), proc._awaiting_count,
            [getattr(s, k) for k in type(s).__slots__], proc.queues[Q.GossipType.beacon_attestation].drop_ratio)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_processor_script_equals_jax(seed):
    ours, theirs = (_run_processor(*side, seed) for side in SIDES)
    assert ours == theirs
    done, charged, trips, _, _, _, stats, _ = ours
    submitted, dropped, past_slot, parked = stats[:4]
    assert done and dropped and past_slot and parked and charged and trips  # every rule was exercised


def test_clock_and_seen_caches_equal_jax():
    out = []
    for CL, SC in ((TCL, TSC), (JCL, JSC)):
        got = []
        c = CL.Clock(genesis_time=100.0)
        c.on_slot(got.append)
        c.on_slot(lambda s: 1 / 0 if s == 2 else None)  # a failing listener is isolated
        c.on_slot(lambda s: got.append(-s))
        for t in (99.0, 100.0, 111.9, 112.0, 150.0, 500.0):
            c.set_time(t)
            got.append((c.current_slot, c.current_epoch, c.slot_start(c.current_slot), c.now))
        seen = SC.SeenAttesters(max_epochs=2)
        for e, v in ((0, 1), (0, 2), (1, 1), (3, 5), (4, 6)):
            seen.add(e, v)
        seen.prune(4)
        got.append([seen.is_known(e, v) for e in range(5) for v in range(7)])
        win = SC.SeenSyncCommitteeMessages()
        for s in range(8):
            win.add(s, s % 3, s)
        win.prune(7)
        got.append([win.is_known(s, s % 3, s) for s in range(8)])
        data = SC.SeenAttestationDatas(max_per_slot=2, max_slots=1)
        got.append([data.put(1, b"a", 1), data.put(1, b"b", 2), data.put(1, b"c", 3), data.get(1, b"a"),
                    data.get(1, b"c"), data.get(2, b"a")])
        data.prune(3)
        got.append((data.get(1, b"a"), data.hits, data.misses, data.rejected))
        out.append(got)
    assert out[0] == out[1]


def test_shed_audit_holds_the_ports_attestation_queue():
    """chip_smoke.shed_audit (the node phase's gate on the attestation
    queue's sheds) over the port's processor: a stalled service, a LIFO
    ratio-shedding queue and messages parked for a block pass it; a shed
    missing, a shed from the fresh end or a pull of a message older than a
    shed fail it."""
    import itertools

    import chip_smoke as CS

    opts = TQ.GossipQueueOpts(TQ.QueueType.LIFO, 400, TQ.DropByRatio(0.01, 0.01))
    stamp, budget, pulls, sheds, publishing = itertools.count(), [0], [], [], [None]

    def worker(msg):
        budget[0] -= 1
        pulls.append((next(stamp), msg.peer_id))

    proc = TPR.NetworkProcessor(worker, [lambda: budget[0] > 0], has_block_root=lambda root: root != "b",
                                registry=TRegistry())
    q = proc.queues[TQ.GossipType.beacon_attestation] = TQ.GossipQueue(opts)
    q.on_drop = lambda msg: sheds.append((next(stamp), msg.peer_id, publishing[0]))
    rng = np.random.default_rng(5)
    parked = {i for i in range(3000) if rng.random() < 0.05}
    for i in range(3000):
        budget[0] += int(i % 7 == 0)
        publishing[0] = i
        proc.on_gossip_message(TPR.PendingGossipMessage(TQ.GossipType.beacon_attestation, i, slot=3,
                                                        block_root="b" if i in parked else "a", peer_id=i))
    publishing[0] = None
    budget[0] = 10**9
    proc.execute_work()
    proc.on_block_processed(3, "b")
    sizes = CS.shed_audit(sheds, pulls, 3000, parked, opts, TQ.MAX_DROP_RATIO)
    assert len(sizes) > 3 and sum(sizes) == proc.stats.dropped and proc.awaiting_count == 0
    # the first shed message trades places with one pulled after it: the
    # counts still add up, but an older message was pulled after a newer shed
    (st, i, at), k = sheds[0], next(k for k, (pst, j) in enumerate(pulls) if pst > sheds[0][0] and j not in parked)
    swapped = pulls[:k] + [(pulls[k][0], i)] + pulls[k + 1:]
    assert pulls[k][1] > i
    for bad_sheds, bad_pulls in ((sheds[1:], pulls), ([(st, pulls[k][1], at)] + sheds[1:], swapped)):
        with pytest.raises(AssertionError, match="sheds"):
            CS.shed_audit(bad_sheds, bad_pulls, 3000, parked, opts, TQ.MAX_DROP_RATIO)
