"""The segmented scans of message grouping and pre-verify aggregation,
and the grouping itself, in the port.

- `seg_sum_g1` (plain version and host build) equals JAX's
  `_j_seg_sum_g1` lane by lane as Jacobian integers, on the grouping and
  dead-lane pattern of tests/test_kernels_grouping.py with a doubling and
  a P + (-P) inside a group (JAX's trace costs ~50 s of this file);
  `seg_sum_g2` equals the crypto oracle at the group heads, and JAX's
  `_j_seg_sum_g2` in the slow tier (its trace takes minutes on a CPU host).
- `TorchBlsVerifier._grouping` equals the JAX verifier's arrays on the
  same sorted sets, the None cases included.

The grouped batch and the aggregation through the verifier are in
tests/test_torch_grouped_batch.py.  The host-built CUDA sources are held
against the plain versions here and in tests/test_torch_csrc_host.py,
the CUDA build on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lodestar_tpu.bls import TpuBlsVerifier
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu.kernels import verify as JKV
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
RNG = np.random.default_rng(0x6A0)
# tests/test_kernels_grouping.py's pattern: lane 4 dead, group 1 then one lane
GROUP = [0, 0, 0, 1, 1, 2, 3, 3]
DEAD = [0, 0, 0, 0, 1, 0, 0, 0]


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
    return B.load_host("segsum")


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def _jac_cols(pts, zs):
    return [(x * z * z % P, y * z * z * z % P, z) for (x, y), z in zip(pts, zs)]


def _host_seg(lib, symbol, pts, dead, group, shape):
    n = group.shape[0]
    out, scr = torch.empty(shape, dtype=torch.int32), torch.empty(shape, dtype=torch.int32)
    out_inf, scr_inf = torch.empty((1, n), dtype=torch.int32), torch.empty((1, n), dtype=torch.int32)
    assert getattr(lib, symbol)(pts.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(),
                                out_inf.data_ptr(), scr.data_ptr(), scr_inf.data_ptr(), n, None) == 0
    return out, out_inf


def test_seg_sum_g1_plain_and_host_equal_jax(libs):
    """Every lane's Jacobian integers and infinity flag equal JAX's scan:
    group 0 adds a point to itself (the doubling dispatch), group 3 adds
    a point to its negation (infinity), lane 4 is dead; then every lane
    dead."""
    a, b, c, d, e = (GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(5))
    pts = [a, a, b, c, d, e, c, GC.affine_neg(GC.FP_OPS, c)]
    cols = _jac_cols(pts, [scalar() for _ in pts])
    group = torch.tensor(GROUP, dtype=torch.int32)
    jplanes = [jnp.asarray(JL.encode_batch([col[i] for col in cols])) for i in range(3)]
    planes = torch.from_numpy(np.stack([LY.encode_batch([col[i] for col in cols]) for i in range(3)]))
    for dead_bits in (DEAD, [1] * 8):
        dead = torch.tensor([dead_bits], dtype=torch.int32)
        (jx, jy, jz), jinf = JKV._j_seg_sum_g1(*jplanes, jnp.asarray(np.array(dead_bits, bool)),
                                               jnp.asarray(np.array(GROUP, np.int32)))
        want = [JL.decode_batch(np.asarray(v)) for v in (jx, jy, jz)]
        got, got_inf = KV.seg_sum_g1_plain(planes, dead, group)
        assert [LY.decode_batch(got[i].numpy()) for i in range(3)] == want
        assert got_inf[0].tolist() == np.asarray(jinf).astype(int).tolist()
        host = _host_seg(libs, "lt_seg_sum_g1", planes, dead, group, (3, LY.NL, 8))
        assert torch.equal(host[0], got) and torch.equal(host[1], got_inf)
    assert got_inf[0].tolist() == [1] * 8
    # the first pattern: totals at the heads equal the oracle
    got, got_inf = KV.seg_sum_g1_plain(planes, torch.tensor([DEAD], dtype=torch.int32), group)
    heads = {2: [0, 1, 2], 4: [3], 5: [5], 7: [6, 7]}
    for head, members in heads.items():
        want = GC.multi_add(GC.FP_OPS, [pts[i] for i in members])
        x, y, z = (LY.decode_batch(got[i, :, head:head + 1].numpy())[0] for i in range(3))
        if want is None:
            assert got_inf[0, head] == 1
        else:
            zi = GT.fp_inv(z)
            assert got_inf[0, head] == 0 and (x * zi * zi % P, y * zi * zi * zi % P) == want


def _g2_planes(pts):
    return torch.from_numpy(
        np.stack([np.stack([LY.encode_batch([q[c][k] for q in pts]) for k in range(2)]) for c in range(2)])
    ).contiguous()


def _g2_affine(planes, lane):
    (x0, x1), (y0, y1), (z0, z1) = (
        tuple(LY.decode_batch(planes[c, k, :, lane:lane + 1].numpy())[0] for k in range(2)) for c in range(3)
    )
    zi = GT.fp2_inv((z0, z1))
    zi2 = GT.fp2_sqr(zi)
    return GT.fp2_mul((x0, x1), zi2), GT.fp2_mul((y0, y1), GT.fp2_mul(zi2, zi))


def test_seg_sum_g2_plain_and_host_equal_oracle(libs):
    """Group totals at the heads equal the oracle's sums (a doubling in
    group 0, P + (-P) at infinity in group 3, lane 4 dead); the host
    build equals the plain version bit for bit; all dead is all infinity."""
    a, b, c, d, e = (GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(5))
    pts = [a, a, b, c, d, e, c, GC.affine_neg(GC.FP2_OPS, c)]
    xy = _g2_planes(pts)
    group = torch.tensor(GROUP, dtype=torch.int32)
    dead = torch.tensor([DEAD], dtype=torch.int32)
    got, got_inf = KV.seg_sum_g2_plain(xy, dead, group)
    host = _host_seg(libs, "lt_seg_sum_g2", xy, dead, group, (3, 2, LY.NL, 8))
    assert torch.equal(host[0], got) and torch.equal(host[1], got_inf)
    for head, members in {2: [0, 1, 2], 4: [3], 5: [5]}.items():
        assert got_inf[0, head] == 0
        assert _g2_affine(got, head) == GC.multi_add(GC.FP2_OPS, [pts[i] for i in members])
    assert got_inf[0, 7] == 1
    all_dead = torch.ones((1, 8), dtype=torch.int32)
    assert KV.seg_sum_g2_plain(xy, all_dead, group)[1].tolist() == [[1] * 8]


@pytest.mark.slow
def test_seg_sum_g2_equals_jax():
    """Every lane's Jacobian integers and infinity flag equal JAX's G2 scan."""
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(8)]
    pts[1] = pts[0]
    xy = _g2_planes(pts)
    jin = [jnp.asarray(JL.encode_batch([q[c][k] for q in pts])) for c in range(2) for k in range(2)]
    out = JKV._j_seg_sum_g2(*jin, jnp.asarray(np.array(DEAD, bool)), jnp.asarray(np.array(GROUP, np.int32)))
    got, got_inf = KV.seg_sum_g2_plain(xy, torch.tensor([DEAD], dtype=torch.int32),
                                       torch.tensor(GROUP, dtype=torch.int32))
    assert [LY.decode_batch(got.reshape(6, LY.NL, 8)[i].numpy()) for i in range(6)] == [
        JL.decode_batch(np.asarray(v)) for v in out[:6]
    ]
    assert got_inf[0].tolist() == np.asarray(out[6]).astype(int).tolist()


@pytest.mark.parametrize(
    "roots, n",
    [
        ([b"a", b"a", b"a", b"b", b"c", b"c"], 8),  # groups of 3, 1, 2 and padding
        ([b"a", b"a"], 8),  # one group
        ([b"a", b"b", b"c"], 8),  # no repeated root: None
        ([b"%03d" % (i // 2) for i in range(256)], 256),  # 128 groups: the tile's limit
        ([b"%03d" % (i // 2) for i in range(258)], 512),  # 129 groups: None
        ([b"x"] * 128, 128),  # one group, no padding
    ],
)
def test_grouping_equals_jax(roots, n):
    sets = [SimpleNamespace(signing_root=r) for r in roots]
    got = VR.TorchBlsVerifier._grouping(sets, n)
    want = TpuBlsVerifier._grouping(None, sets, n)
    if want is None:
        assert got is None
        return
    assert len(got) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == np.int32 and np.array_equal(g, w)
