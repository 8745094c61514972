"""The port's phase0 epoch and `upgrade_to_altair` against the JAX package's.

The same 16 keys make a phase0 genesis in each package (altair at epoch
3); blocks of full-participation attestations (PendingAttestations,
signatures unchecked) carry both states through two epochs, then through
empty epochs into an inactivity leak, and across the altair upgrade.  At
each step the states are held byte for byte (SSZ) and root for root, and
each step of `phase0.py` runs alone on the same state in both packages:
the attester masks, the justification, the base rewards and
`get_attestation_deltas` (in and out of the leak), the rewards, the
slashings, the record rotation, `process_epoch_phase0`,
`translate_participation` and `upgrade_to_altair`.  The port runs on its
host merkle path; the end states are held on the CPU device backend.
"""

import numpy as np
import pytest

from test_torch_beacon_state import J, P, cold_root, cpu_backend, keys, same
from lodestar_tpu_torch.ssz import device_backend as DB

PRESET = P.params.ACTIVE_PRESET
SPE = PRESET.SLOTS_PER_EPOCH
N = 16
ALTAIR = 3


def cfg(M, altair=ALTAIR):
    return M.config.create_chain_config(M.config.MAINNET_CHAIN_CONFIG,
                                        fork_epochs={M.params.ForkName.altair: altair})


def _attestations(M, state, att_slot):
    """Full-participation attestations of `att_slot`'s committees on a
    state advanced past it (the JAX package's tests/test_phase0.py)."""
    out = []
    epoch = att_slot // SPE
    current = state.slot // SPE
    source = state.current_justified_checkpoint if epoch == current else state.previous_justified_checkpoint
    target_root = (M.acc.get_block_root(state, epoch) if state.slot > epoch * SPE
                   else M.acc.get_block_root_at_slot(state, att_slot))
    for ci in range(M.acc.get_committee_count_per_slot(state, epoch)):
        committee = M.acc.get_beacon_committee(state, att_slot, ci)
        if not len(committee):
            continue
        out.append({"aggregation_bits": [True] * len(committee),
                    "data": {"slot": att_slot, "index": ci,
                             "beacon_block_root": M.acc.get_block_root_at_slot(state, att_slot),
                             "source": dict(source), "target": {"epoch": epoch, "root": target_root}},
                    "signature": b"\x00" * 96})
    return out


def _advance(M, state, to_slot, every=1):
    """One block every `every` slots up to `to_slot`, each carrying full
    attestations of the slots since the last block."""
    st = state
    while st.slot < to_slot:
        slot = min(st.slot + every, to_slot)
        pre = st.clone()
        M.slot.process_slots(pre, slot)
        atts = []
        for s in range(max(st.slot, slot - every), slot):
            if s + PRESET.MIN_ATTESTATION_INCLUSION_DELAY <= slot and s >= 1:
                atts += _attestations(M, pre, s)
        block, _post = M.pb.produce_block(st, slot, b"\x00" * 96, attestations=atts)
        st = M.tr.state_transition(st, {"message": block, "signature": b"\x00" * 96}, verify_state_root=True,
                                   verify_proposer=False, verify_signatures=False)
    return st


@pytest.fixture(scope="module")
def phase0():
    """Both packages' states: genesis, and slot 2·SPE - 1 after blocks
    every other slot (epoch 0's records now the previous epoch's)."""
    _sks, pks = keys(N)
    DB.set_backend(None)
    try:
        out = {}
        for M in (J, P):
            g = M.gen.create_genesis_state(cfg(M), pks, genesis_time=7)
            out[M.pkg] = (g, _advance(M, g, 2 * SPE - 1, every=2))
        yield out[J.pkg], out[P.pkg]
    finally:
        DB.reset_backend()


@pytest.fixture
def host():
    DB.set_backend(None)
    yield
    DB.reset_backend()


def test_phase0_genesis_and_blocks_equal_jax(phase0, host):
    (gj, sj), (gp, sp) = phase0
    assert gp.fork_name == P.params.ForkName.phase0 and gp.previous_epoch_attestations == []
    same(gj, gp)
    same(sj, sp)
    assert len(sp.current_epoch_attestations) > 0 and len(sp.previous_epoch_attestations) > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_phase0_state_carries_across(phase0, host, direction):
    (_gj, sj), (_gp, sp) = phase0
    src, Mdst = (sj, P) if direction == "jax_to_port" else (sp, J)
    data = src.serialize()
    moved = Mdst.state.BeaconState.deserialize(data, cfg(Mdst))
    assert moved.serialize() == data
    assert moved.previous_epoch_attestations == src.previous_epoch_attestations
    assert moved.hash_tree_root() == sj.hash_tree_root()


def test_pending_attestation_and_source_check_equal_jax(phase0, host):
    (gj, _), (gp, _) = phase0
    got = []
    for M, g in ((J, gj), (P, gp)):
        st = g.clone()
        M.slot.process_slots(st, 2)
        att = _attestations(M, st, 1)[0]
        M.blk.process_attestation_phase0(st, att, verify_signatures=False)
        bad = dict(att, data=dict(att["data"], source={"epoch": 0, "root": b"\x13" * 32}))
        with pytest.raises(M.blk.BlockProcessError, match="source") as e:
            M.blk.process_attestation_phase0(st, bad, verify_signatures=False)
        got.append((st.current_epoch_attestations, str(e.value)))
    assert got[0] == got[1]


def _steps(M, state):
    """Each step of the phase0 epoch alone on clones of `state`."""
    ph = M.ph0
    out = {}
    cur = state.current_epoch_attestations
    out["mask"] = ph.attesting_mask(state, cur).tolist()
    out["mask_prev"] = ph.attesting_mask(state, state.previous_epoch_attestations).tolist()
    total = int(M.acc.get_total_active_balance(state))
    out["base"] = ph.get_base_rewards_phase0(state, total).tolist()
    r, p = ph.get_attestation_deltas(state)
    out["deltas"] = (r.tolist(), p.tolist())
    st = state.clone()
    ph.process_justification_and_finalization_phase0(st)
    out["justified"] = (st.current_justified_checkpoint, st.previous_justified_checkpoint,
                        st.finalized_checkpoint, list(st.justification_bits))
    st = state.clone()
    ph.process_rewards_and_penalties_phase0(st)
    out["balances"] = st.balances.tolist()
    st = state.clone()
    ph.process_participation_record_updates(st)
    out["rotated"] = (st.previous_epoch_attestations, st.current_epoch_attestations)
    st = state.clone()
    ph.process_epoch_phase0(st)
    out["epoch"] = st.serialize()
    return out


def test_epoch_steps_equal_jax(phase0, host):
    (_gj, sj), (_gp, sp) = phase0
    theirs, ours = _steps(J, sj), _steps(P, sp)
    for key in theirs:
        assert ours[key] == theirs[key], key
    assert any(ours["deltas"][0]) and any(ours["mask_prev"])


def test_leak_deltas_and_slashings_equal_jax(phase0, host):
    """Empty epochs past MIN_EPOCHS_TO_INACTIVITY_PENALTY (the leak's
    penalties), with validators slashed so the slashings step bites."""
    (gj, _), (gp, _) = phase0
    got = []
    for M, g in ((J, gj), (P, gp)):
        st = g.clone()
        st.config = cfg(M, altair=20)
        M.slot.process_slots(st, 7 * SPE - 1)
        assert st.fork_name == M.params.ForkName.phase0
        half = PRESET.EPOCHS_PER_SLASHINGS_VECTOR // 2
        for v in (2, 5):
            st.slashed[v] = True
            st.withdrawable_epoch[v] = 6 + half
            st.slashings[6 % PRESET.EPOCHS_PER_SLASHINGS_VECTOR] += st.effective_balance[v]
        r, p = M.ph0.get_attestation_deltas(st)
        s2 = st.clone()
        M.ph0.process_slashings_phase0(s2)
        s3 = st.clone()
        M.ph0.process_epoch_phase0(s3)
        got.append((r.tolist(), p.tolist(), s2.balances.tolist(), s3.serialize()))
    assert got[0] == got[1]
    assert any(got[1][1]) and got[1][2] != gp.balances.tolist()


def test_upgrade_to_altair_equals_jax(phase0, host):
    """The upgrade alone (translate_participation of the previous epoch's
    records, the sync committees) and then through slot processing at the
    altair epoch."""
    (_gj, sj), (_gp, sp) = phase0
    got = []
    for M, s in ((J, sj), (P, sp)):
        st = s.clone()
        pending = list(st.previous_epoch_attestations)
        M.ph0.upgrade_to_altair(st)
        flags = st.previous_epoch_participation.copy()
        fresh = st.clone()
        fresh.previous_epoch_participation = np.zeros(N, np.uint8)
        M.ph0.translate_participation(fresh, pending)
        assert np.array_equal(fresh.previous_epoch_participation, flags)
        got.append((flags.tolist(), st.current_sync_committee, st.fork, st.serialize()))
    assert got[0] == got[1]
    assert any(got[1][0])


def test_chain_crosses_to_altair_equals_jax(phase0, host):
    """Blocks on through the altair epoch: the phase0 epoch runs, the
    state upgrades, altair blocks import on top and the translated
    participation feeds altair's justification."""
    (_gj, sj), (_gp, sp) = phase0
    ends = []
    for M, s in ((J, sj), (P, sp)):
        st = _advance(M, s, ALTAIR * SPE + 2, every=4)
        assert st.fork_name == M.params.ForkName.altair and st.previous_epoch_attestations is None
        ends.append(st)
    same(*ends)
    assert int(ends[1].current_justified_checkpoint["epoch"]) >= 1
    assert cold_root(ends[1], cpu_backend()) == ends[0].hash_tree_root()
