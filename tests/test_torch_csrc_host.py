"""The CUDA kernels' arithmetic, checked on the host.

`kernels/build.py build_host` compiles each `csrc/<name>.cu` with the
host C++ compiler: the same device functions, with every PTX carry
instruction emulated (csrc/common.cuh), driven lane by lane through the
same C entry points the CUDA build exports.  Each kernel's host build is
held bit for bit against its plain torch version, on edge cases, and its
count of Fp products per lane against `verify.FP_MULS_PER_LANE`, the
cost model behind the kernels' bounds.  The CUDA build itself is held
against the plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import shutil

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
RNG = np.random.default_rng(0xC5C)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return {name: B.load_host(name) for name in B.SOURCES}


def i32(*shape):
    return torch.empty(shape, dtype=torch.int32)


def g2_planes(pts):
    return torch.from_numpy(
        np.stack([np.stack([LY.encode_batch([q[c][k] for q in pts]) for k in range(2)]) for c in range(2)])
    ).contiguous()


def g1_planes(pts, zs):
    """Jacobian planes [3, 12, n] of affine points scaled by Z."""
    cols = [(x * z * z % P, y * z * z * z % P, z) for (x, y), z in zip(pts, zs)]
    return torch.from_numpy(np.stack([LY.encode_batch([c[i] for c in cols]) for i in range(3)])).contiguous()


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def test_mont_convert_host_build_equals_plain(libs):
    vals = [0, 1, P - 1, P, P + 1, 2 * P, 9 * P, (1 << 384) - 1] + [
        int.from_bytes(RNG.bytes(48), "little") for _ in range(16)
    ]
    x = torch.from_numpy(LY.encode_plain_batch(vals)).reshape(3, LY.NL, 8).contiguous()
    out = i32(3, LY.NL, 8)
    assert libs["mont"].lt_mont_convert(x.data_ptr(), out.data_ptr(), 3, 8, None) == 0
    assert torch.equal(out, KV.mont_convert_plain(x))
    assert libs["mont"].lt_host_fp_muls() == 24 * KV.FP_MULS_PER_LANE["mont_convert"]


def test_subgroup_host_build_equals_plain(libs):
    outside = []
    for j in range(2):
        u = GH.hash_to_field_fp2(b"host-%d" % j, 1, b"csrc-host")[0]
        outside.append(GH.map_to_curve_svdw(GC.FP2_OPS, u))
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(2)] + outside
    q = g2_planes(pts)
    q_inf = torch.tensor([[0, 0, 0, 1]], dtype=torch.int32)  # an outside point flagged infinity
    out = i32(1, 4)
    assert libs["subgroup"].lt_g2_subgroup_check(q.data_ptr(), q_inf.data_ptr(), out.data_ptr(), 4, None) == 0
    assert out.tolist() == [[1, 1, 0, 1]]
    assert torch.equal(out, KV.g2_subgroup_check_plain(q, q_inf))
    assert libs["subgroup"].lt_host_fp_muls() == 4 * KV.FP_MULS_PER_LANE["g2_subgroup_check"]


def test_miller_and_each_final_host_build_equal_plain(libs):
    """Lanes: a valid signature relation (pk, H) x (-G1, sig), the same
    pair with a wrong signature, and a dead lane."""
    sk = scalar()
    h = GH.hash_to_g2(b"csrc-host-message")
    sig = GC.scalar_mul(GC.FP2_OPS, h, sk)
    pk = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk)
    bad = GC.scalar_mul(GC.FP2_OPS, h, sk + 1)
    neg_g1 = GC.affine_neg(GC.FP_OPS, GC.G1_GEN)
    zs = [int.from_bytes(RNG.bytes(48), "little") % P for _ in range(3)]
    p1, q1 = g1_planes([pk] * 3, zs), g2_planes([h] * 3)
    p2, q2 = g1_planes([neg_g1] * 3, [1, 1, 1]), g2_planes([sig, bad, sig])
    f1, f2 = i32(12, LY.NL, 3), i32(12, LY.NL, 3)
    mil = libs["miller"]
    assert mil.lt_miller_loop(p1.data_ptr(), q1.data_ptr(), f1.data_ptr(), 3, None) == 0
    assert mil.lt_miller_loop(p2.data_ptr(), q2.data_ptr(), f2.data_ptr(), 3, None) == 0
    assert mil.lt_host_fp_muls() == 6 * KV.FP_MULS_PER_LANE["miller_loop"]
    assert torch.equal(f1, KV.miller_loop_plain(p1, q1))
    assert torch.equal(f2, KV.miller_loop_plain(p2, q2))
    live = torch.tensor([[1, 1, 0]], dtype=torch.int32)
    ok = i32(1, 3)
    fin = libs["final"]
    assert fin.lt_each_final(live.data_ptr(), f1.data_ptr(), f2.data_ptr(), ok.data_ptr(), 3, None) == 0
    assert ok.tolist() == [[1, 0, 1]]
    assert torch.equal(ok, KV.each_final_plain(live, f1, f2))
    assert fin.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["each_final"]
    assert GB.verify(pk, b"csrc-host-message", sig)
