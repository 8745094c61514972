"""The port's pubkey registration: host encoding of compressed keys, G1
KeyValidate (`kernels/verify.py g1_keyvalidate`) and
`PubkeyTable.register_compressed`.

The plain torch version (what the wrapper runs on the CPU) and the
host-built CUDA source (`kernels/build.py load_host`: the same device
functions compiled with g++) are held against the crypto oracle
`lodestar_tpu/crypto/curves.py` (`g1_decompress` + `g1_subgroup_check`)
and each other, exactly.  The card runs the CUDA build in
tests/test_torch_cuda.py and chip_smoke.py.  A plain KeyValidate costs
seconds per call whatever its width, so registration here pads chunks to
4 lanes.  JAX's `g1_keyvalidate` takes minutes to compile on a CPU host,
so the comparison with it is `slow`.
"""

import shutil

import numpy as np
import pytest
import torch

from lodestar_tpu.bls import ingest as JIN
from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.bls import pubkey_table as PT
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x_key(x: int, sign: int) -> bytes:
    """A well-formed compressed encoding of x with the given sort flag."""
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if sign else 0)
    return bytes(out)


def _first_x(on_curve: bool) -> int:
    x = 1
    while (GT.fp_sqrt((x * x * x + 4) % P) is not None) != on_curve:
        x += 1
    return x


@pytest.fixture(scope="module")
def keys():
    """Valid keys (both signs of each point are valid keys), the order-3
    key x = 0 with both signs, an on-curve key outside G1, an x off the
    curve and the infinity encoding."""
    pks = [GB.sk_to_pk(GB.keygen(b"torch-keyvalidate-%d" % i)) for i in range(3)]
    outside = _first_x(True)
    assert not GC.g1_subgroup_check(GC.g1_decompress(_x_key(outside, 0)))
    valid = [GC.g1_compress(pk) for pk in pks]
    flipped = bytes([valid[0][0] ^ 0x20]) + valid[0][1:]  # -pk: in G1 too
    cases = valid + [
        flipped,
        _x_key(0, 0),  # (0, 2): order 3
        _x_key(0, 1),  # (0, -2)
        _x_key(outside, 1),
        _x_key(_first_x(False), 0),
        GC.g1_compress(None),
    ]
    return dict(pks=pks, valid=valid + [flipped], cases=cases)


def oracle(key: bytes):
    """(point or None, KeyValidate verdict) by the crypto oracle."""
    try:
        pt = GC.g1_decompress(key)
    except ValueError:
        return None, False
    return pt, pt is not None and GC.g1_subgroup_check(pt)


def _malformed():
    good = GC.g1_compress(GB.sk_to_pk(GB.keygen(b"torch-keyvalidate-malformed")))
    inf = GC.g1_compress(None)
    return [
        good,
        inf,
        good[:47],  # 47 bytes
        good + b"\x00",  # 49 bytes
        bytes([good[0] & 0x7F]) + good[1:],  # no compression bit
        bytes([inf[0] | 0x20]) + inf[1:],  # infinity with the sign bit
        inf[:20] + b"\x01" + inf[21:],  # infinity with a payload
        bytes([inf[0] | 0x01]) + inf[1:],  # infinity with x bits in the flag byte
        bytes([0x80 | (P >> 376)]) + (P % (1 << 376)).to_bytes(47, "big"),  # x = p
        bytes([0x9F]) + b"\xff" * 47,  # x = 2^381 - 1
        bytes([0x80 | (P >> 376)]) + ((P - 1) % (1 << 376)).to_bytes(47, "big"),  # x = p - 1
        _x_key(0, 1),
        b"",
    ]


def test_parse_and_encode_pubkeys_equal_jax():
    keys = _malformed()
    assert [IN.parse_pubkey_bytes(k) for k in keys] == [JIN.parse_pubkey_bytes(k) for k in keys]
    got = IN.encode_pubkey_planes(keys)
    want = JIN.encode_pubkey_planes(keys)
    # flags and host_bad are equal array for array; the x planes spell the
    # same integers in each package's limbs (32-bit here, 12-bit in JAX)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w) and g.dtype == w.dtype and g.shape == w.shape
    assert got[0].shape == (LY.NL, len(keys)) and got[0].dtype == np.int32
    assert LY.decode_plain_batch(got[0]) == [JL.from_limbs(want[0][:, j]) for j in range(len(keys))]
    assert got[2].tolist() == [False, False] + [True] * 8 + [False, False, True]


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return B.load_host("keyvalidate")


def test_g1_keyvalidate_plain_and_host_equal_oracle(keys, libs):
    cases = keys["cases"]
    planes, flags, host_bad = IN.encode_pubkey_planes(cases)
    assert not host_bad.any()
    x, fl = torch.from_numpy(planes), torch.from_numpy(flags)
    xy, ok = KV.g1_keyvalidate_plain(x, fl)
    n = len(cases)
    hxy, hok = torch.empty((2, LY.NL, n), dtype=torch.int32), torch.empty((1, n), dtype=torch.int32)
    assert libs.lt_g1_keyvalidate(x.data_ptr(), fl.data_ptr(), hxy.data_ptr(), hok.data_ptr(), n, None) == 0
    libs.lt_host_fp_muls()
    assert torch.equal(hxy, xy) and torch.equal(hok, ok)
    want = [oracle(k) for k in cases]
    assert ok[0].tolist() == [int(v) for _, v in want]
    assert ok[0].tolist() == [1, 1, 1, 1, 0, 0, 0, 0, 0]
    xs, ys = LY.decode_batch(xy[0].numpy()), LY.decode_batch(xy[1].numpy())
    for i, (pt, _) in enumerate(want):
        if pt is not None:  # decompressed: the oracle's point, sign included
            assert (xs[i], ys[i]) == pt
    assert (xs[5], ys[5]) == (0, P - 2) and (xs[4], ys[4]) == (0, 2)


def test_register_compressed_indices_and_points(keys, monkeypatch):
    """Keys registered after existing rows get the next indices, and the
    table holds the decompressed points; the device mirror is dropped."""
    monkeypatch.setattr(PT, "KEY_TILE", 4)
    table = PT.PubkeyTable(capacity=2)
    assert table.register(keys["pks"][:1]) == [0]
    table.device_planes("cpu")
    idx = table.register_compressed(keys["valid"], device="cpu")
    assert idx == [1, 2, 3, 4] and len(table) == 5 and table._device == {}
    pts = [GC.g1_decompress(k) for k in keys["valid"]]
    assert [table.host_affine(i) for i in idx] == pts
    assert table.host_affine(0) == table.host_affine(1) == keys["pks"][0]
    assert table.register_compressed([], device="cpu") == []


def test_register_compressed_names_the_first_bad_key_and_commits_nothing(keys, monkeypatch):
    """Two chunks: the first all valid, the second with the order-3 key at
    position 5 and a 47-byte key at 6.  The error names 5, and no row of
    either chunk is committed."""
    monkeypatch.setattr(PT, "KEY_TILE", 4)
    table = PT.PubkeyTable(capacity=8)
    table.register(keys["pks"][:2])
    before = (table._host_x.copy(), table._host_y.copy())
    batch = keys["valid"] + [keys["valid"][1], _x_key(0, 0), keys["valid"][2][:47]]
    with pytest.raises(ValueError, match=r"pubkey 5 failed KeyValidate"):
        table.register_compressed(batch, device_batch=4, device="cpu")
    assert len(table) == 2
    assert np.array_equal(table._host_x, before[0]) and np.array_equal(table._host_y, before[1])
    with pytest.raises(IndexError):
        table.host_affine(2)


@pytest.mark.slow
def test_g1_keyvalidate_equals_jax(keys):
    """The plain version against JAX's `g1_keyvalidate` (value-level, under
    jax.jit on the CPU): the same x, y and verdict on every case."""
    import jax
    import jax.numpy as jnp

    from lodestar_tpu.kernels import ingest as JIG

    cases = keys["cases"]
    parsed = [JIN.parse_pubkey_bytes(k) for k in cases]
    jx = jnp.asarray(JL.encode_batch([p[0] for p in parsed]))
    jsign = jnp.asarray(np.array([p[1] for p in parsed], np.int32))
    (jxo, jyo), jok = jax.jit(JIG.g1_keyvalidate)(jx, jsign)
    planes, flags, _ = IN.encode_pubkey_planes(cases)
    xy, ok = KV.g1_keyvalidate_plain(torch.from_numpy(planes), torch.from_numpy(flags))
    inf = np.array([p[2] for p in parsed], bool)
    assert ok[0].numpy().astype(bool).tolist() == (np.asarray(jok) & ~inf).tolist()
    assert LY.decode_batch(xy[0].numpy()) == JL.decode_batch(np.asarray(jxo))
    assert LY.decode_batch(xy[1].numpy()) == JL.decode_batch(np.asarray(jyo))
