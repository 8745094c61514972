"""The block-per-set pubkey aggregation (`csrc/aggpk.cu lt_agg_pk`), on
the host.

A block's threads take a tree level's independent pairs at once, in the
order of the JAX kernel `_k_agg_pk` (a `sum_points_axis0` tree per chunk
of min(K, 32) rows, the chunk sums added in order by `jac_add_full`),
and the addition of an entirely masked chunk to a finite accumulator is
skipped.  The host build (`kernels/build.py build_host`) runs a block's
threads as virtual threads, forwards or reversed (`lt_host_warp_order`):
a level in which one thread read a point another one writes would differ
between the two orders.  Each is held bit for bit against the plain
version `kernels/verify.py agg_pk_plain`, placeholder coordinates of an
infinity result included, and at K = 64 against JAX's value functions.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.kernels import curve as JCV
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
RNG = np.random.default_rng(0xA66)
N_KEYS = 6  # table rows 0..5 hold keys, rows 6..8 the negations of keys 0..2
V = N_KEYS + 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return B.load_host("aggpk")


@pytest.fixture(scope="module")
def table():
    keys = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, int(s)) for s in RNG.integers(2, 1 << 40, N_KEYS)]
    keys += [GC.affine_neg(GC.FP_OPS, keys[i]) for i in range(3)]
    tx = torch.from_numpy(LY.encode_batch([p[0] for p in keys]))
    ty = torch.from_numpy(LY.encode_batch([p[1] for p in keys]))
    return keys, tx, ty


def lanes(k):
    """Rows and masks of six sets, and the chunk accumulations the kernel
    makes for each (the others are skipped):
      0  every row live, row i of a chunk equal to row i + kc / 2 (P == Q
         in the tree) and every chunk the same (P == Q in the accumulation);
      1  every row live, row i + kc / 2 the negation of row i: every chunk
         sums to infinity (P == -Q), the accumulator stays infinity;
      2  a packed live prefix of 40 % of the rows, the rest masked;
      3  a first chunk that sums to infinity, every later chunk masked:
         the accumulator is infinity, so those chunks are added;
      4  every row masked: infinity with the tree's placeholder coordinates;
      5  random live rows, one live row outside the table (the set is
         flagged) and masked rows outside it."""
    kc = min(k, KV.AGG_CHUNK)
    nch, half = k // kc, kc // 2
    idx = np.zeros((6, k), np.int32)
    kmask = np.ones((6, k), np.int32)
    chunk = RNG.integers(0, N_KEYS, size=kc).astype(np.int32)
    chunk[half : 2 * half] = chunk[:half]
    idx[0] = np.tile(chunk, nch)
    pm = RNG.integers(0, 3, size=(nch, half))
    idx[1] = np.concatenate([np.concatenate([c, c + N_KEYS]) for c in pm])
    idx[2] = RNG.integers(0, V, size=k)
    live = max(1, (4 * k) // 10)
    kmask[2, live:] = 0
    idx[3] = idx[1]
    kmask[3, kc:] = 0
    idx[4] = RNG.integers(0, V, size=k)
    kmask[4] = 0
    idx[5] = RNG.integers(0, V, size=k)
    idx[5, min(3, k - 1)] = V + 7
    idx[5, 1] = -1
    kmask[5, 1] = 0
    made = [nch - 1, nch - 1, -(-live // kc) - 1, nch - 1, nch - 1, nch - 1]
    return torch.from_numpy(idx), torch.from_numpy(kmask), made


@pytest.mark.parametrize("k", [4, 64, 512])
def test_agg_tree_host_build_equals_plain(lib, table, k):
    """Both thread orders give the plain version's planes and flags; the
    host build makes every tree addition and the accumulations `lanes`
    names, 23 Fp products each; its launch shape is the design's."""
    keys, tx, ty = table
    idx, kmask, made = lanes(k)
    n = idx.shape[0]
    want = KV.agg_pk_plain(tx, ty, idx, kmask)
    assert want[1].tolist() == [[0, 1, 0, 1, 1, 1]]
    kc = min(k, KV.AGG_CHUNK)
    lib.lt_host_fp_muls()  # the counter is the library's: drain another test's
    for order in (0, 1):
        out, out_inf = torch.empty((3, LY.NL, n), dtype=torch.int32), torch.empty((1, n), dtype=torch.int32)
        lib.lt_host_warp_order(order)
        assert lib.lt_agg_pk(tx.data_ptr(), ty.data_ptr(), V, idx.data_ptr(), kmask.data_ptr(), k, out.data_ptr(),
                             out_inf.data_ptr(), n, None) == 0
        lib.lt_host_warp_order(0)
        assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1]), order
        adds = n * (k // kc) * (kc - 1) + sum(made)
        assert lib.lt_host_fp_muls() == adds * KV.FP_MULS_PER_LANE["agg_pk"]
        shape = (ctypes.c_int * 4)()
        assert lib.lt_agg_last_launch(shape) == 0
        assert list(shape) == KV.agg_launch_shape(n, k)
    for lane in (0, 2):  # and the finite sums are the oracle's
        x, y, z = (LY.decode_batch(want[0][c].numpy())[lane] for c in range(3))
        pts = [keys[int(i)] for i, m in zip(idx[lane], kmask[lane]) if m]
        assert (x * pow(z, -2, P) % P, y * pow(z, -3, P) % P) == GC.multi_add(GC.FP_OPS, pts)


def test_agg_tree_launch_shape_caps_the_block():
    """K = 2048 (64 chunks, four batches of 16 trees) keeps 256 threads
    per block, where one thread per first-level pair would ask 1,024."""
    assert KV.agg_launch_shape(3, 2048)[1] == 256 and KV.agg_launch_shape(3, 4)[1] == 32


@pytest.fixture()
def jax_add(monkeypatch):
    """JAX's jac_add_full jitted once at one width: every call's leading
    rows are folded into the lane axis (the addition is lane-wise) and
    padded to 32 x 4 lanes, so the eager tree of sum_points_axis0 below
    compiles one addition instead of one per tree level."""
    real = JCV.jac_add_full
    width = 32 * 4
    add = jax.jit(lambda p, p_inf, q, q_inf: real(JCV.FP_OPS, p, p_inf, q, q_inf))

    def flat(a):  # [..., NL, N] -> [NL, width]
        a = jnp.moveaxis(a, -2, 0).reshape(a.shape[-2], -1)
        return jnp.pad(a, ((0, 0), (0, width - a.shape[1])))

    def pad(m):
        return jnp.pad(m.reshape(-1), (0, width - m.size))

    def folded(fo, p, p_inf, q, q_inf):
        assert fo is JCV.FP_OPS
        s, s_inf = add(tuple(map(flat, p)), pad(p_inf), tuple(map(flat, q)), pad(q_inf))
        shape = p[0].shape
        back = [jnp.moveaxis(c[:, : p_inf.size].reshape(shape[-2], *p_inf.shape), 0, -2) for c in s]
        return tuple(back), s_inf[: p_inf.size].reshape(p_inf.shape)

    monkeypatch.setattr(JCV, "jac_add_full", folded)


def test_agg_tree_host_build_equals_jax_at_k64(lib, table, jax_add):
    """K = 64, the five sets with every row in the table: the host build's
    Jacobian integers and flags equal JAX's order of `_k_agg_pk`, a
    `sum_points_axis0` tree per chunk of 32 rows and the chunk sums added
    in order by `jac_add_full`, as the JAX value functions compute it."""
    keys, tx, ty = table
    idx, kmask, _ = lanes(64)
    idx, kmask = idx[:5].contiguous(), kmask[:5].contiguous()
    n, k = idx.shape
    out, out_inf = torch.empty((3, LY.NL, n), dtype=torch.int32), torch.empty((1, n), dtype=torch.int32)
    assert lib.lt_agg_pk(tx.data_ptr(), ty.data_ptr(), V, idx.data_ptr(), kmask.data_ptr(), k, out.data_ptr(),
                         out_inf.data_ptr(), n, None) == 0
    lib.lt_host_fp_muls()
    gx = jnp.asarray(np.stack([JL.encode_batch([keys[i][0] for i in idx[:, j].tolist()]) for j in range(k)]))
    gy = jnp.asarray(np.stack([JL.encode_batch([keys[i][1] for i in idx[:, j].tolist()]) for j in range(k)]))
    one = jnp.asarray(JL.encode_batch([1] * n))
    m = jnp.asarray(kmask.numpy().T)
    acc = acc_inf = None
    for c in range(0, k, 32):
        x, y = gx[c : c + 32], gy[c : c + 32]
        s, s_inf = JCV.sum_points_axis0(JCV.FP_OPS, (x, y, jnp.broadcast_to(one, x.shape)), m[c : c + 32] == 0)
        if acc is None:
            acc, acc_inf = s, s_inf
        else:
            acc, acc_inf = JCV.jac_add_full(JCV.FP_OPS, acc, acc_inf, s, s_inf)
    for c in range(3):
        assert LY.decode_batch(out[c].numpy()) == JL.decode_batch(np.asarray(acc[c])), c
    assert out_inf[0].tolist() == np.asarray(acc_inf).astype(int).tolist() == [0, 1, 0, 1, 1]
