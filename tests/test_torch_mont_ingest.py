"""The Montgomery ingest fused into the kernels that head each path, on the
host.

The JAX package converts a job's plain limb planes in kernels of their
own: `_k_mont8` (`lodestar_tpu/kernels/verify.py:116`, the decoded paths'
message and signature) and `_k_mont4` (`:454`, the wire paths' message).
The port makes that conversion in the first phase of the kernel that
heads each path: `g2_subgroup_check` (decoded per set) and `g2_rsig_sub`
(decoded batch) convert the signature and the message in their programs'
ingest segment, `g2_decompress` (every wire path) the message in its first
round beside the wire x.  Here the host builds (`kernels/build.py
build_host`, a warp's 32 virtual threads forwards or reversed) and the
plain versions are held bit for bit

  * against JAX's conversion (`redc` of `mul_cols_shared` with
    `JL.MONT_R2`), on plain values in [p, 2^384), below p and all-zero
    padding lanes;
  * against PR 11's composition: `mont_convert_plain`, then the kernel on
    Montgomery points, as the paths ran it with a conversion launch of
    their own;

and every entry point of `kernels/verify.py`, its kernels run by the host
builds, gives the verdicts of that composition and of the oracle on jobs
with dead lanes (padding, a signature at infinity, which take the plain
generator before the ingest) and plain coordinates plus multiples of p.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lodestar_tpu.kernels import core as JC
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu_torch.bls.ingest import encode_wire_planes
from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
from lodestar_tpu_torch.bls.rand import make_rand_words
from lodestar_tpu_torch.crypto import bls as GB
from lodestar_tpu_torch.crypto import curves as GC
from lodestar_tpu_torch.crypto import fields as GT
from lodestar_tpu_torch.crypto import hash_to_curve as GH
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
NL = LY.NL
RNG = np.random.default_rng(0x1A6E57)
ORDERS = [0, 1]  # virtual threads forwards, reversed
SOURCES = {"g2_subgroup_check": "subgroup", "g2_rsig_sub": "randmul", "g2_decompress": "ingest"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
    return torch.full(shape, -1, dtype=torch.int32)


def g2_plain_planes(vals, n):
    """Plain limb planes [2, 2, 12, n] of 4 n integers below 2^384: value
    4 j + 2 c + k at lane j, coordinate (c, k)."""
    return torch.from_numpy(LY.encode_plain_batch(vals)).reshape(NL, n, 2, 2).permute(2, 3, 0, 1).contiguous()


def edge_values(n):
    """4 n plain values: every edge of [0, 2^384) the ingest admits, random
    ones above and below p, and lanes 1 and n - 1 all zero (padding)."""
    edges = [P, P + 1, 2 * P, 9 * P, (1 << 384) - 1, P - 1, 1, 0, 3 * P - 1, (1 << 384) - P]
    rand = [int.from_bytes(RNG.bytes(48), "little") for _ in range(4 * n)]
    vals = (edges + rand)[:4 * n]
    for j in (1, n - 1):
        vals[4 * j:4 * j + 4] = [0] * 4
    return vals


def jax_conversion(vals):
    """JAX's Montgomery ingest of plain values (what `_k_mont4` and
    `_k_mont8` compute) -> the Fp values."""
    planes = jnp.asarray(JL.encode_plain_batch(vals))
    return JL.decode_batch(np.asarray(JC.redc(JC.mul_cols_shared(planes, [int(v) for v in JL.MONT_R2], JL.NC))))


def coords(planes):
    """Montgomery planes [2, 2, 12, n] -> the Fp values, lane-major as the
    plain values were given (4 j + 2 c + k), and whether every limb
    pattern is canonical (below p: equal values are then equal bits)."""
    n = planes.shape[-1]
    vals = [LY.decode_batch(planes[c, k].numpy()) for c in range(2) for k in range(2)]
    raw = [LY.decode_plain_batch(planes[c, k].numpy()) for c in range(2) for k in range(2)]
    return [vals[i][j] for j in range(n) for i in range(4)], all(v < P for r in raw for v in r)


def run_heading(libs, name, sig, msg, order=0):
    """The host build of kernel `name` with the ingest (plain sig where it
    takes one, plain msg) -> (all outputs, the Montgomery planes it wrote:
    the signature's where it writes them, then the message's)."""
    n = msg.shape[-1]
    lib = libs[SOURCES[name]]
    inf = torch.zeros((1, n), dtype=torch.int32)
    lib.lt_host_warp_order(order)
    try:
        if name == "g2_subgroup_check":
            out, conv = i32(1, n), i32(2, 2, 2, NL, n)
            assert lib.lt_g2_subgroup_check(sig.data_ptr(), inf.data_ptr(), msg.data_ptr(), out.data_ptr(),
                                            conv.data_ptr(), n, None) == 0
            return (out, conv[0], conv[1]), (conv[0], conv[1])
        if name == "g2_rsig_sub":
            rw = torch.from_numpy(make_rand_words(n, np.random.default_rng(n)))
            out, out_inf, sub, msg_out = i32(3, 2, NL, n), i32(1, n), i32(1, n), i32(2, 2, NL, n)
            assert lib.lt_g2_rsig_sub(sig.data_ptr(), inf.data_ptr(), msg.data_ptr(), rw.data_ptr(), out.data_ptr(),
                                      out_inf.data_ptr(), sub.data_ptr(), msg_out.data_ptr(), n, None) == 0
            return (out, out_inf, sub, msg_out), (msg_out,)
        x, flags = torch.zeros((2, NL, n), dtype=torch.int32), torch.zeros((2, n), dtype=torch.int32)
        xy, ok, msg_out = i32(2, 2, NL, n), i32(1, n), i32(2, 2, NL, n)
        assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), msg.data_ptr(), xy.data_ptr(), msg_out.data_ptr(),
                                    ok.data_ptr(), n, None) == 0
        return (xy, ok, msg_out), (msg_out,)
    finally:
        lib.lt_host_warp_order(0)
        lib.lt_host_rounds(), lib.lt_host_fp_muls()


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_ingest_equals_jax_conversion(libs, name, order):
    """The Montgomery planes each heading kernel writes, on values in [p,
    2^384), below p and zero padding lanes, equal JAX's conversion and
    mont_convert_plain's bit for bit (canonical limbs of the same values),
    in either thread order; so do its plain version's."""
    n = 7
    msg_vals, sig_vals = edge_values(n), edge_values(n)[::-1]
    msg, sig = g2_plain_planes(msg_vals, n), g2_plain_planes(sig_vals, n)
    _, conv = run_heading(libs, name, sig, msg, order)
    plain = {"g2_subgroup_check": lambda: KV.g2_subgroup_check_plain(sig, torch.zeros((1, n), dtype=torch.int32), msg),
             "g2_rsig_sub": lambda: KV.g2_rsig_sub_plain(sig, torch.zeros((1, n), dtype=torch.int32),
                                                         torch.zeros((4, n), dtype=torch.int32), msg),
             "g2_decompress": lambda: KV.g2_decompress_plain(torch.zeros((2, NL, n), dtype=torch.int32),
                                                             torch.zeros((2, n), dtype=torch.int32), msg)}[name]()
    plain_conv = plain[1:] if name == "g2_subgroup_check" else plain[-1:]
    wants = ((sig_vals, KV.mont_convert_plain(sig)), (msg_vals, KV.mont_convert_plain(msg)))[-len(conv):]
    for got, p_got, (vals, ref) in zip(conv, plain_conv, wants):
        assert torch.equal(got, ref) and torch.equal(p_got, ref)
        values, canonical = coords(got)
        assert canonical and values == jax_conversion(vals) == [v % P for v in vals]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_heading_kernel_equals_todays_composition(libs, name):
    """The host build with the ingest equals PR 11's composition on the
    same inputs: mont_convert_plain of the planes, then the kernel on
    Montgomery points (g2_decompress without messages), every output bit
    for bit.  The lanes hold points of G2 (plain coordinates plus
    multiples of p), an outside point and the plain generator of a dead
    lane."""
    n = 5
    u = GH.hash_to_field_fp2(b"ingest-outside", 1, b"torch-ingest")[0]
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 77 + j) for j in range(n - 2)]
    pts += [GH.map_to_curve_svdw(GC.FP2_OPS, u), GC.G2_GEN]
    sig = g2_plain_planes([v + (j % 5) * P for j, pt in enumerate(pts) for c in pt for v in c], n)
    msg = g2_plain_planes(edge_values(n), n)
    outs, _ = run_heading(libs, name, sig, msg)
    lib = libs[SOURCES[name]]
    inf = torch.zeros((1, n), dtype=torch.int32)
    sig_m, msg_m = KV.mont_convert_plain(sig), KV.mont_convert_plain(msg)
    if name == "g2_subgroup_check":
        out = i32(1, n)
        assert lib.lt_g2_subgroup_check(sig_m.data_ptr(), inf.data_ptr(), None, out.data_ptr(), None, n, None) == 0
        today = (out, sig_m, msg_m)
        assert out[0].tolist() == [1] * (n - 2) + [0, 1]
    elif name == "g2_rsig_sub":
        rw = torch.from_numpy(make_rand_words(n, np.random.default_rng(n)))
        out, out_inf, sub = i32(3, 2, NL, n), i32(1, n), i32(1, n)
        assert lib.lt_g2_rsig_sub(sig_m.data_ptr(), inf.data_ptr(), None, rw.data_ptr(), out.data_ptr(),
                                  out_inf.data_ptr(), sub.data_ptr(), None, n, None) == 0
        today = (out, out_inf, sub, msg_m)
        assert sub[0].tolist() == [1] * (n - 2) + [0, 1]
    else:
        x = torch.from_numpy(np.stack([LY.encode_plain_batch([pt[0][k] for pt in pts]) for k in range(2)]))
        flags = torch.tensor([[GT.fp2_sgn(pt[1]) for pt in pts], [0] * n], dtype=torch.int32)
        xy, ok = i32(2, 2, NL, n), i32(1, n)
        assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), None, xy.data_ptr(), None, ok.data_ptr(), n,
                                    None) == 0
        xy2, ok2, msg_out = i32(2, 2, NL, n), i32(1, n), i32(2, 2, NL, n)
        assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), msg.data_ptr(), xy2.data_ptr(),
                                    msg_out.data_ptr(), ok2.data_ptr(), n, None) == 0
        outs, today = (xy2, ok2, msg_out), (xy, ok, msg_m)
        assert ok[0].tolist() == [1] * n
    lib.lt_host_rounds(), lib.lt_host_fp_muls()
    assert all(torch.equal(a, b) for a, b in zip(outs, today))


# ---------------------------------------------------------------------------
# the entry points, their kernels run by the host builds
# ---------------------------------------------------------------------------


@pytest.fixture()
def host_kernels(libs, monkeypatch):
    """Every kernel wrapper of kernels/verify.py launches its host build on
    CPU tensors (the C entry points the CUDA build exports), counted as a
    launch, instead of taking its plain version."""
    on_cpu = KV._on_cpu

    def launch(name, source, symbol, *args, launches=1):
        assert getattr(libs[source], symbol)(*args, None) == 0
        KV.LAUNCHES[name] += launches if isinstance(launches, int) else launches.value

    monkeypatch.setattr(KV, "_on_cpu", lambda *ts: on_cpu(*ts) and False)
    monkeypatch.setattr(KV, "_launch", launch)
    monkeypatch.setattr(KV.B, "load", lambda name: libs[name])
    KV.reset_launches()
    yield
    for lib in libs.values():
        if hasattr(lib, "lt_host_rounds"):
            lib.lt_host_rounds(), lib.lt_host_gcd_steps()
        lib.lt_host_fp_muls()


@functools.lru_cache(maxsize=None)
def world():
    """4 keys, 2 roots; lanes: valid, valid, wrong message, swapped
    signature, signature at infinity, outside G2, valid, padding."""
    sks = [GB.keygen(b"torch-ingest-%d" % i) for i in range(4)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    roots = [b"ingest-root-a", b"ingest-root-b"]
    hs = [GH.hash_to_g2(r) for r in roots]
    sig = {(k, r): GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k]) for k in range(4) for r in range(2)}
    u = GH.hash_to_field_fp2(b"outside", 1, b"torch-ingest")[0]
    outside = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    # (key, root, signature); sorted by root for the grouped entry
    lanes = [(0, 0, sig[0, 0]), (1, 0, sig[1, 0]), (2, 0, sig[2, 1]), (3, 0, sig[1, 0]), (1, 0, None),
             (2, 1, outside), (3, 1, sig[3, 1])]
    truth = [True, True, False, False, False, False, True]
    return pks, roots, hs, sig, lanes, truth


N = 8


def decoded_operands(lanes, hs):
    """The decoded path's operands (bls/verifier.py `_prepare`'s layout),
    with multiples of p added to plain coordinates of lanes 1 and 6."""
    g2 = GC.G2_GEN
    msgs = [hs[r] for _, r, _ in lanes] + [g2] * (N - len(lanes))
    sigs = [g2 if s is None else s for _, _, s in lanes] + [g2] * (N - len(lanes))
    cols = [[pt[c][k] for pt in pts] for pts in (msgs, sigs) for c in range(2) for k in range(2)]
    cols[0][1] += P  # msg x0, lane 1
    cols[7][6] += 4 * P  # sig y1, lane 6
    cols[4][1] += 2 * P  # sig x0, lane 1
    planes = torch.from_numpy(np.stack([LY.encode_plain_batch(v) for v in cols]))
    idx = torch.tensor([[k] for k, _, _ in lanes] + [[0]] * (N - len(lanes)), dtype=torch.int32)
    sig_inf = torch.tensor([int(s is None) for _, _, s in lanes] + [0] * (N - len(lanes)), dtype=torch.int32)
    valid = torch.tensor([1] * len(lanes) + [0] * (N - len(lanes)), dtype=torch.int32)
    return idx, torch.ones_like(idx), planes, sig_inf, valid


def wire_operands(lanes, hs):
    """The wire paths' operands (`_prepare_wire`'s layout), multiples of p
    added to the message planes of lanes 0 and 3."""
    g2 = GC.G2_GEN
    msgs = [hs[r] for _, r, _ in lanes] + [g2] * (N - len(lanes))
    cols = [[m[c][k] for m in msgs] for c in range(2) for k in range(2)]
    cols[1][0] += P
    cols[3][3] += 5 * P
    msg = torch.from_numpy(np.stack([LY.encode_plain_batch(v) for v in cols]))
    x0, x1, flags, host_bad = encode_wire_planes([GC.g2_compress(s) for _, _, s in lanes], N)
    assert not host_bad.any()
    idx = torch.tensor([[k] for k, _, _ in lanes] + [[0]] * (N - len(lanes)), dtype=torch.int32)
    valid = torch.tensor([1] * len(lanes) + [0] * (N - len(lanes)), dtype=torch.int32)
    return idx, torch.ones_like(idx), msg, torch.from_numpy(np.stack([x0, x1])), torch.from_numpy(flags), valid


def todays_decoded(idx, planes, n):
    m = KV.mont_convert_plain(planes)
    return m[:4].reshape(2, 2, NL, n), m[4:].reshape(2, 2, NL, n)


def todays_wire(msg_planes, sig_x, sig_flags, n):
    msg = KV.mont_convert_plain(msg_planes).reshape(2, 2, NL, n)
    sig, dec_ok = KV.g2_decompress(sig_x, sig_flags)
    return msg, sig, (sig_flags[1] != 0) | (dec_ok[0] == 0)


@pytest.mark.parametrize("entry", ["verify_each_device", "verify_batch_device", "verify_each_device_wire",
                                   "verify_batch_device_wire", "verify_batch_device_wire_grouped"])
def test_entry_points_equal_todays_composition(host_kernels, entry):
    """Each entry point, its kernels the host builds, gives PR 11's
    verdicts (mont_convert_plain, then the Montgomery path) and the
    oracle's on the mixed job, and the batch entries accept the job of its
    valid lanes; the decoded paths launch no kernel beyond their heading
    kernel's, the wire paths' g2_decompress takes the messages."""
    pks, roots, hs, _, lanes, truth = world()
    table = PubkeyTable()
    table.register(pks)
    tx, ty = table.device_planes("cpu")
    wire = "wire" in entry
    batch = "batch" in entry
    jobs = [lanes] + ([[ln for ln, t in zip(lanes, truth) if t]] if batch else [])
    for job in jobs:
        ops = wire_operands(job, hs) if wire else decoded_operands(job, hs)
        idx, kmask, valid = ops[0], ops[1], ops[-1]
        rwords = torch.from_numpy(make_rand_words(N, np.random.default_rng(7)))
        extra = ()
        if entry.endswith("grouped"):
            rts = [roots[r] for _, r, _ in job]
            group = np.zeros(N, np.int32)
            for i in range(1, len(job)):
                group[i] = group[i - 1] + (rts[i] != rts[i - 1])
            heads = [i for i in range(len(job)) if i == len(job) - 1 or rts[i + 1] != rts[i]]
            ng = len(heads)
            group[len(job):] = np.arange(ng, ng + N - len(job))
            head_lanes = np.zeros(KV.BT, np.int32)
            head_lanes[:ng] = heads
            glive = np.zeros(KV.BT, np.int32)
            glive[:ng] = 1
            extra = (torch.from_numpy(group), torch.from_numpy(head_lanes), torch.from_numpy(glive))
        KV.reset_launches()
        if batch:
            got = getattr(KV, entry)(tx, ty, *ops[:-1], *extra, rwords, valid)
        else:
            got = getattr(KV, entry)(tx, ty, *ops)
        counts = dict(KV.LAUNCHES)
        if wire:
            msg, sig, sig_bad = todays_wire(*ops[2:5], N)
        else:
            (msg, sig), sig_bad = todays_decoded(idx, ops[2], N), ops[3] != 0
        if batch:
            want = KV._batch_core(tx, ty, idx, kmask, msg, sig, sig_bad, rwords, valid, False, extra or None)
            assert bool(got[0]) == bool(want[0]) == (job is not lanes)  # the mixed job fails, its valid lanes pass
            assert torch.equal(got[1], want[1])
        else:
            want = KV._each_core(tx, ty, idx, kmask, msg, sig, sig_bad, valid, False)
            assert got.tolist() == want.tolist() == truth + [True] * (N - len(lanes))
        assert counts["g2_decompress"] == int(wire)
        head = "g2_rsig_sub" if batch else "g2_subgroup_check"
        assert counts[head] == 1
