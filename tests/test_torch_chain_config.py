"""The port's chain config (`lodestar_tpu_torch/config/`) against the JAX
package's (`lodestar_tpu/config/`): fork schedule, fork digests, domains
and signing roots for every fork, on configs built from the same plain
fields (bytes and ints), compared exactly.
"""

import numpy as np
import pytest

from lodestar_tpu import config as JC
from lodestar_tpu import params as JP
from lodestar_tpu_torch import config as TC
from lodestar_tpu_torch import params as TP

FORKS = [f.value for f in TP.FORK_ORDER]
DOMAINS = [name for name in dir(JP) if name.startswith("DOMAIN_")]


def _configs(name, seed):
    """The same derived config in both packages: a random genesis
    validators root and time, and every fork scheduled (epochs 0, 5, 10,
    ...), so each fork has slots."""
    rng = np.random.default_rng(seed)
    gvr, gtime = rng.bytes(32), int(rng.integers(1, 2**31))
    out = []
    for C, P in ((TC, TP), (JC, JP)):
        base = getattr(C, f"{name.upper()}_CHAIN_CONFIG")
        epochs = {f: 5 * i for i, f in enumerate(P.FORK_ORDER)}
        out.append(C.create_chain_config(base, genesis_validators_root=gvr, genesis_time=gtime, fork_epochs=epochs))
    return out


def test_the_port_has_every_domain_and_fork():
    assert DOMAINS and all(getattr(TP, d) == getattr(JP, d) for d in DOMAINS)
    assert [f.value for f in TP.FORK_ORDER] == [f.value for f in JP.FORK_ORDER]
    assert {f.value: s for f, s in TP.FORK_SEQ.items()} == {f.value: s for f, s in JP.FORK_SEQ.items()}
    for name in ("MAINNET", "MINIMAL"):
        t, j = getattr(TC, f"{name}_CHAIN_CONFIG"), getattr(JC, f"{name}_CHAIN_CONFIG")
        assert {f.value: v for f, v in t.fork_versions.items()} == {f.value: v for f, v in j.fork_versions.items()}
        assert {f.value: v for f, v in t.fork_epochs.items()} == {f.value: v for f, v in j.fork_epochs.items()}
        assert (t.genesis_validators_root, t.genesis_time, t.config_name) == (
            j.genesis_validators_root, j.genesis_time, j.config_name)


@pytest.mark.parametrize("name", ["mainnet", "minimal"])
@pytest.mark.parametrize("fork", FORKS)
def test_fork_digest_domains_and_signing_roots_equal_jax(name, fork):
    ours, theirs = _configs(name, FORKS.index(fork) + 7 * (name == "minimal"))
    k = FORKS.index(fork)
    slot = (5 * k + 1) * TP.SLOTS_PER_EPOCH + 3  # inside the fork's first epochs
    assert ours.get_fork_name(slot).value == theirs.get_fork_name(slot).value == fork
    assert ours.get_fork_seq(slot) == theirs.get_fork_seq(slot) == k
    assert ours.get_fork_version(slot) == theirs.get_fork_version(slot)
    assert ours.fork_digest(slot) == theirs.fork_digest(slot)
    assert [f.value for f in ours.fork_schedule()] == [f.value for f in theirs.fork_schedule()]
    rng = np.random.default_rng(k)
    for d in DOMAINS:
        dt = getattr(TP, d)
        # the message's fork decides: one slot of each fork against this state slot
        for msg_slot in (None, 0, slot, (5 * len(FORKS)) * TP.SLOTS_PER_EPOCH):
            dom = ours.get_domain(slot, dt, msg_slot)
            assert dom == theirs.get_domain(slot, dt, msg_slot)
            obj = rng.bytes(32)
            assert ours.compute_signing_root(obj, dom) == theirs.compute_signing_root(obj, dom)
        version = ours.fork_versions[TP.FORK_ORDER[k]]
        other_gvr = rng.bytes(32)
        assert ours.compute_domain(dt, version) == theirs.compute_domain(dt, version)
        assert ours.compute_domain(dt, version, other_gvr) == theirs.compute_domain(dt, version, other_gvr)
    assert ours.fork_data_root(version) == theirs.fork_data_root(version)
    # the fork's containers: the same structure in both packages
    for got, want in zip(ours.get_fork_types(slot), theirs.get_fork_types(slot)):
        assert got.name == want.name and [n for n, _ in got.fields] == [n for n, _ in want.fields]
    if k >= TP.FORK_SEQ[TP.ForkName.bellatrix]:
        for got, want in zip(ours.get_blinded_fork_types(slot), theirs.get_blinded_fork_types(slot)):
            assert got.name == want.name
    else:
        with pytest.raises(ValueError):
            ours.get_blinded_fork_types(slot)
