"""The port's store (`lodestar_tpu_torch/db/`) against the JAX package's
(`lodestar_tpu/db/`): the same op script (puts, overwrites, deletes,
batch puts) on both controllers gives the same point reads and range
scans, in memory and on the native engine; repositories keep to their
buckets; BeaconDb's fork-aware block codec round-trips a block of each
fork to the same bytes.  The port's engine is its own build of its copy
of `kvstore.cpp`, never the JAX package's library.
"""

from pathlib import Path

import numpy as np
import pytest

from lodestar_tpu import config as JC
from lodestar_tpu import db as JD
from lodestar_tpu import params as JP
from lodestar_tpu.db import controller as JCTL
from lodestar_tpu_torch import config as TC
from lodestar_tpu_torch import db as TD
from lodestar_tpu_torch import params as TP
from lodestar_tpu_torch.db import controller as TCTL
from lodestar_tpu_torch.kernels import build as B

ROOT = Path(__file__).resolve().parents[1]


def _script(seed, n=300):
    """(op, key, value) with a small key space, so overwrites and deletes hit."""
    rng = np.random.default_rng(seed)
    keys = [bytes([int(rng.integers(0, 4))]) + rng.bytes(int(rng.integers(0, 5))) for _ in range(40)]
    ops = []
    for _ in range(n):
        k = keys[int(rng.integers(len(keys)))]
        r = rng.random()
        if r < 0.6:
            ops.append(("put", k, rng.bytes(int(rng.choice([0, 1, 31, 300, 70_000])))))
        elif r < 0.8:
            ops.append(("delete", k, None))
        else:
            ops.append(("batch", [(keys[int(i)], rng.bytes(8)) for i in rng.integers(0, len(keys), 3)], None))
    return ops, keys


def _apply(c, ops):
    for op, k, v in ops:
        if op == "put":
            c.put(k, v)
        elif op == "delete":
            c.delete(k)
        else:
            c.batch_put(k)


def _reads(c, keys):
    bounds = [(b"", b""), (b"\x01", b"\x02"), (b"\x00\x80", b"\x03"), (b"\x02", b"")]
    return ([c.get(k) for k in keys], len(c), [list(c.entries(g, l)) for g, l in bounds],
            [list(c.keys(g, l)) for g, l in bounds], list(c.values()))


@pytest.mark.parametrize("durable", [False, True], ids=["memory", "native"])
@pytest.mark.parametrize("seed", [0, 1])
def test_controller_script_equals_jax(tmp_path, durable, seed):
    if durable and not JCTL.native_available():
        pytest.skip("the JAX package's native store is not built here")
    ops, keys = _script(seed)
    ours = TD.KvController(str(tmp_path / "port.db") if durable else None)
    theirs = JD.KvController(str(tmp_path / "jax.db") if durable else None)
    _apply(ours, ops)
    _apply(theirs, ops)
    assert _reads(ours, keys) == _reads(theirs, keys)
    if durable:  # reopened from the log, then compacted and reopened
        ours.close()
        theirs.close()
        ours, theirs = TD.KvController(str(tmp_path / "port.db")), JD.KvController(str(tmp_path / "jax.db"))
        assert _reads(ours, keys) == _reads(theirs, keys)
        ours.compact()
        ours.flush()
        ours.close()
        ours = TD.KvController(str(tmp_path / "port.db"))
        assert _reads(ours, keys) == _reads(theirs, keys)
    ours.close()
    theirs.close()


def test_the_engine_is_the_ports_own_build(tmp_path):
    assert TCTL.native_available()
    TD.KvController(str(tmp_path / "kv.db")).close()
    lib = Path(TCTL._lib._name).resolve()
    assert lib.parent == B.BUILD_DIR.resolve() and lib.name.startswith("native-kvstore-")
    assert (ROOT / "lodestar_tpu_torch" / "native" / "kvstore.cpp").read_bytes() == \
        (ROOT / "lodestar_tpu" / "native" / "kvstore.cpp").read_bytes().replace(
            b"// Build: make -C lodestar_tpu/native", b"// The port's copy of lodestar_tpu/native/kvstore.cpp; built "
            b"with the host\n// C++ compiler at first use by lodestar_tpu_torch/kernels/build.py\n// build_native() "
            b"into lodestar_tpu_torch/_build/.")
    for path in (ROOT / "lodestar_tpu_torch").rglob("*.py"):
        assert "libkvstore" not in path.read_text(), path


def test_a_durable_path_without_a_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(TCTL, "_lib", None)
    monkeypatch.setattr(B, "host_cxx", lambda: (_ for _ in ()).throw(RuntimeError("no host C++ compiler")))
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path / "empty")
    with pytest.raises(OSError):
        TD.KvController(str(tmp_path / "kv.db"))
    assert not TCTL.native_available()
    c = TD.KvController(None)  # the explicit in-memory store needs no build
    c.put(b"k", b"v")
    assert c.get(b"k") == b"v"


def test_repositories_equal_jax():
    """Values put through two buckets' repositories read back per bucket,
    in key order, alike in both packages."""
    reads = []
    for D in (TD, JD):
        c = D.KvController(None)
        a, b = D.Repository(c, D.Bucket.block), D.Repository(c, D.Bucket.block_archive)
        rng = np.random.default_rng(6)
        for _ in range(20):
            (a if rng.random() < 0.5 else b).put(rng.bytes(4), rng.bytes(10))
        a.delete(next(iter(a.keys())))
        reads.append([list(a.entries()), list(b.entries()), a.first_key(), a.last_key(), b.has(b"none")])
    assert reads[0] == reads[1]
    assert [(x.name, int(x)) for x in TD.Bucket] == [(x.name, int(x)) for x in JD.Bucket]


@pytest.mark.parametrize("fork", [f.value for f in TP.FORK_ORDER])
def test_fork_aware_block_codec_round_trips_each_fork(fork):
    k = [f.value for f in TP.FORK_ORDER].index(fork)
    rng = np.random.default_rng(k)
    cfgs = [C.create_chain_config(C.MAINNET_CHAIN_CONFIG, fork_epochs={f: 2 * i for i, f in enumerate(P.FORK_ORDER)})
            for C, P in ((TC, TP), (JC, JP))]
    slot = (2 * k + 1) * TP.SLOTS_PER_EPOCH + 5
    assert cfgs[0].get_fork_name(slot).value == fork
    ours, theirs = TD.BeaconDb(None, config=cfgs[0]), JD.BeaconDb(None, config=cfgs[1])
    block = cfgs[0].get_fork_types(slot)[1].default()
    block["message"]["slot"], block["message"]["proposer_index"] = slot, 3
    block["signature"] = rng.bytes(96)
    root = rng.bytes(32)
    for db in (ours, theirs):
        db.put_block(root, block)
        db.archive_block(slot, block, root=rng.bytes(32))
    data = ours.block.db.get(bytes([int(TD.Bucket.block)]) + root)
    assert data == theirs.block.db.get(bytes([int(JD.Bucket.block)]) + root)
    assert ours.get_block_anywhere(root) == theirs.get_block_anywhere(root) == block
    assert list(ours.block_archive.entries()) == list(theirs.block_archive.entries())
    ours.close()
    theirs.close()
