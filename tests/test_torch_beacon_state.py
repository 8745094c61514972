"""The port's BeaconState, genesis and state root against the JAX package's.

The same keys (numpy seed) make a genesis in each package; the states are
held byte for byte (SSZ) and root for root, and a state carries across by
`BeaconState.deserialize` of the other package's `serialize()` bytes.  The
port's roots run through `DeviceMerkleBackend(device="cpu")`, the SHA-256
kernels' plain versions.  The helpers here (`ns`, `keys`, `port_backend`)
serve the other `test_torch_*` files of the state and chain slice.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from lodestar_tpu_torch.bls.supervisor import DeviceSupervisor
from lodestar_tpu_torch.crypto import bls as B
from lodestar_tpu_torch.crypto import curves as C
from lodestar_tpu_torch.params import ForkName
from lodestar_tpu_torch.ssz import device_backend as DB
from lodestar_tpu_torch.utils.metrics import Registry

SEED = 0x5EED18
N_VALIDATORS = 32


def ns(pkg: str) -> SimpleNamespace:
    """The modules of one package (`lodestar_tpu` or `lodestar_tpu_torch`)
    under the same short names, so one scenario runs on either."""

    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        params=imp("params"),
        T=imp("types"),
        config=imp("config"),
        ssz=imp("ssz"),
        st=imp("state_transition"),
        state=imp("state_transition.state"),
        acc=imp("state_transition.accessors"),
        blk=imp("state_transition.block"),
        ep=imp("state_transition.epoch"),
        slot=imp("state_transition.slot"),
        tr=imp("state_transition.transition"),
        gen=imp("state_transition.genesis"),
        sigsets=imp("state_transition.signature_sets"),
        pb=imp("chain.produce_block"),
        pools=imp("chain.op_pools"),
        emitter=imp("chain.emitter"),
        state_cache=imp("chain.state_cache"),
        gov=imp("chain.memory_governor"),
        regen=imp("chain.regen"),
        bp=imp("chain.block_processor"),
        chain=imp("chain.chain"),
        fc=imp("fork_choice"),
        db=imp("db"),
        queue=imp("utils.queue"),
    )


def config(M, **forks):
    epochs = {ForkName.altair: 0}
    epochs.update({getattr(M.params.ForkName, k): v for k, v in forks.items()})
    return M.config.create_chain_config(M.config.MAINNET_CHAIN_CONFIG, fork_epochs=epochs)


def keys(n: int = N_VALIDATORS, seed: int = SEED):
    """n secret keys from a numpy seed and their compressed pubkeys."""
    rng = np.random.default_rng(seed)
    sks = [B.keygen(rng.bytes(32)) for _ in range(n)]
    return sks, [C.g1_compress(B.sk_to_pk(sk)) for sk in sks]


def cpu_backend() -> DB.DeviceMerkleBackend:
    reg = Registry()
    sup = DeviceSupervisor(registry=reg, auto_probe=False, enabled=True)
    return DB.DeviceMerkleBackend(device="cpu", supervisor=sup, registry=reg)


@pytest.fixture
def port_backend():
    """The port's merkle backend on the CPU for the test; its host-level
    fallbacks must stay at 0."""
    b = cpu_backend()
    DB.set_backend(b)
    yield b
    DB.reset_backend()
    assert b.m_host_levels.value == 0
    assert b.supervisor.status()["state"] == "closed"


J = ns("lodestar_tpu")
P = ns("lodestar_tpu_torch")


@pytest.fixture(scope="module")
def world():
    sks, pks = keys()
    b = cpu_backend()
    DB.set_backend(b)
    try:
        gj = J.gen.create_genesis_state(config(J), pks, genesis_time=1234)
        gp = P.gen.create_genesis_state(config(P), pks, genesis_time=1234)
        yield SimpleNamespace(sks=sks, pks=pks, gj=gj, gp=gp, backend=b)
    finally:
        DB.reset_backend()


@pytest.fixture
def installed(world):
    DB.set_backend(world.backend)
    yield world
    DB.reset_backend()


@pytest.fixture
def host_path(world):
    """The port on its host merkle path (an explicit opt-out) for runs of
    many slots: the plain SHA-256 versions cost ~0.7 s a slot on a CPU.
    `cold_root` then holds the end state on the CPU backend."""
    DB.set_backend(None)
    yield world
    DB.reset_backend()


def cold_root(state, backend) -> bytes:
    """The state's root from a cold engine on `backend`."""
    c = state.clone()
    c._root_engine = None
    DB.set_backend(backend)
    try:
        return c.hash_tree_root()
    finally:
        DB.set_backend(None)


def same(sj, sp) -> None:
    """Two states equal byte for byte and root for root."""
    assert sp.serialize() == sj.serialize()
    assert sp.hash_tree_root() == sj.hash_tree_root()


def test_genesis_equals_jax(installed):
    w = installed
    same(w.gj, w.gp)
    assert w.gp.genesis_validators_root == w.gj.genesis_validators_root
    # the registry root through the validators cell equals the host SSZ
    # list type's over validators_value()
    limit = P.params.ACTIVE_PRESET.VALIDATOR_REGISTRY_LIMIT
    host = P.ssz.List(P.T.Validator, limit).hash_tree_root(w.gp.validators_value())
    assert w.gp.genesis_validators_root == host
    assert w.gp.current_sync_committee == w.gj.current_sync_committee
    assert w.backend.m_dispatches.get("htr_validator_roots") >= 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carries_across_byte_for_byte(installed, direction):
    w = installed
    sj, sp = w.gj.clone(), w.gp.clone()
    P.slot.process_slots(sp, 3)
    J.slot.process_slots(sj, 3)
    if direction == "jax_to_port":
        data = sj.serialize()
        moved = P.state.BeaconState.deserialize(data, config(P))
    else:
        data = sp.serialize()
        moved = J.state.BeaconState.deserialize(data, config(J))
    assert moved.serialize() == data
    assert moved.hash_tree_root() == sj.hash_tree_root() == sp.hash_tree_root()
    assert P.state.BeaconState.from_value(sp.to_value(), config(P)).serialize() == data


@pytest.mark.parametrize("forks,container", [
    ({"bellatrix": 1}, "BeaconStateBellatrix"),
    ({"bellatrix": 1, "capella": 1}, "BeaconStateCapella"),
    ({"bellatrix": 1, "capella": 1, "deneb": 1}, "BeaconStateDeneb"),
])
def test_upgraded_states_carry_across(host_path, forks, container):
    """The bellatrix, capella and deneb upgrades of slot.py run in both
    packages at epoch 1, and the upgraded state round-trips."""
    w = host_path
    sj = J.gen.create_genesis_state(config(J, **forks), w.pks, genesis_time=1234)
    sp = P.gen.create_genesis_state(config(P, **forks), w.pks, genesis_time=1234)
    J.slot.process_slots(sj, 33)
    P.slot.process_slots(sp, 33)
    same(sj, sp)
    assert sp._container() is getattr(P.state, container)
    moved = P.state.BeaconState.deserialize(sj.serialize(), config(P, **forks))
    assert moved.serialize() == sj.serialize()
    assert cold_root(moved, w.backend) == sj.hash_tree_root()


def test_clone_is_independent_and_shares_the_engine(installed):
    w = installed
    sp = w.gp.clone()
    root = sp.hash_tree_root()
    c = sp.clone()
    c.balances[0] += 1
    c.slashed[3] = True
    assert sp.hash_tree_root() == root
    assert c.hash_tree_root() != root
    assert c._root_engine is not sp._root_engine


def test_hash_tree_root_never_falls_back_in_silence(installed, monkeypatch):
    from lodestar_tpu_torch.state_transition import state_root as SR

    sp = installed.gp.clone()

    def boom(self, state):
        raise RuntimeError("engine fault")

    monkeypatch.setattr(SR.StateRootEngine, "hash_tree_root", boom)
    with pytest.raises(RuntimeError, match="engine fault"):
        sp.hash_tree_root()
    assert sp._root_engine is None
    monkeypatch.undo()
    assert sp.hash_tree_root() == installed.gj.hash_tree_root()


@pytest.mark.parametrize("mode", ["full", "check"])
def test_htr_modes(installed, monkeypatch, mode):
    monkeypatch.setenv("LODESTAR_TPU_HTR", mode)
    sp = installed.gp.clone()
    sp.balances[1] += 7
    sj = installed.gj.clone()
    sj.balances[1] += 7
    assert sp.hash_tree_root() == sj.hash_tree_root()


def test_phase0_states_raise_in_slot_processing(host_path):
    w = host_path
    cfg = P.config.create_chain_config(
        P.config.MAINNET_CHAIN_CONFIG, fork_epochs={ForkName.altair: 1}
    )
    sp = P.gen.create_genesis_state(cfg, w.pks, genesis_time=1234)
    assert sp.previous_epoch_attestations == []
    with pytest.raises(NotImplementedError, match="7.1a"):
        P.slot.process_slots(sp, P.params.ACTIVE_PRESET.SLOTS_PER_EPOCH + 1)


def test_pubkey_index_with_repeated_keys(installed):
    """A registry that repeats its keys (row r holds key r % 4) answers
    as the JAX package does, and builds its map once."""
    w = installed
    pks = [w.pks[i % 4] for i in range(12)]
    sp = P.gen.create_genesis_state(config(P), pks, genesis_time=5)
    sj = J.gen.create_genesis_state(config(J), pks, genesis_time=5)
    same(sj, sp)
    for pk in w.pks[:5]:
        assert sp.pubkey_index(pk) == sj.pubkey_index(pk)
    m = sp._pubkey_map
    sp.pubkey_index(w.pks[0])
    assert sp._pubkey_map is m
    assert sp.add_validator(w.pks[7], b"\x00" * 32, 32 * 10**9) == 12
    assert sp.pubkey_index(w.pks[7]) == 12 and sp._pubkey_map is m


def test_accessors_equal_jax(host_path):
    w = host_path
    sj, sp = w.gj.clone(), w.gp.clone()
    J.slot.process_slots(sj, 40)
    P.slot.process_slots(sp, 40)
    assert cold_root(sp, w.backend) == sj.hash_tree_root()
    for ep in (0, 1, 2):
        assert P.acc.get_seed(sp, ep, P.params.DOMAIN_BEACON_ATTESTER) == J.acc.get_seed(
            sj, ep, J.params.DOMAIN_BEACON_ATTESTER
        )
        assert list(P.acc.get_active_validator_indices(sp, ep)) == list(
            J.acc.get_active_validator_indices(sj, ep)
        )
    for slot in (33, 40):
        assert list(P.acc.get_beacon_committee(sp, slot, 0)) == list(J.acc.get_beacon_committee(sj, slot, 0))
    assert P.acc.get_beacon_proposer_index(sp) == J.acc.get_beacon_proposer_index(sj)
    assert P.acc.get_proposer_indices_for_epoch(sp, 1) == J.acc.get_proposer_indices_for_epoch(sj, 1)
    assert P.acc.get_validator_churn_limit(sp) == J.acc.get_validator_churn_limit(sj)
    assert P.acc.get_next_sync_committee_indices(sp) == J.acc.get_next_sync_committee_indices(sj)
    assert P.acc.get_block_root_at_slot(sp, 20) == J.acc.get_block_root_at_slot(sj, 20)
    assert P.acc.get_randao_mix(sp, 1) == J.acc.get_randao_mix(sj, 1)
