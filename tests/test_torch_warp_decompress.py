"""The G2 decompression on the warp engine (`csrc/ingest.cu
lt_g2_decompress`), on the host.

`kernels/warp_schedule.py decompress_program` packs the wire signature's
square root (the norm method of JAX `kernels/sqrt.py fp2_sqrt`, each
exponentiation a fixed sliding-window chain) into four segments; the
kernel's segment loop makes the method's per-lane selects between them.  Here
the program, run on Python integers through the same segment loop steps
(`drive`), and the host build (`kernels/build.py build_host`: a warp's 32
virtual threads forwards or reversed, `lt_host_warp_order`) are held bit
for bit against the plain version `kernels/verify.py g2_decompress_plain`
and, at three lanes, against JAX `kernels/ingest.py g2_decompress_y` run
eagerly.  The square-root segments are also fed field values directly
(0, squares, non-squares, a1 = 0), the chains and the inverse they give
are held against `pow`, and the round and product counts are pinned to
`verify.ROUNDS_PER_LANE` and `FP_MULS_PER_LANE`, the launch's shape to
the program's.  Segment A also converts the wire paths' message planes
(plain limbs of any integers below 2^384, the work of a launch of its own
before): with and without messages, the kernel's other outputs are the
same, its Montgomery message planes `mont_convert_plain`'s, and its rounds
the same 899.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.kernels import core as JC
from lodestar_tpu.kernels import ingest as JIG
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu.kernels import tower as JTW
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import sqrt as SQ
from lodestar_tpu_torch.kernels import verify as KV
from lodestar_tpu_torch.kernels import warp_schedule as W

P = GT.P
RNG = np.random.default_rng(0xDEC0)
ORDERS = [0, 1]  # virtual threads forwards, reversed
B2 = GC.FP2_OPS.b_coeff  # 4 (1 + i)


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
    return B.load_host("ingest")


@pytest.fixture(scope="module")
def prog():
    return W.decompress_program()


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def rhs_of(x):
    return GT.fp2_add(GT.fp2_mul(GT.fp2_sqr(x), x), B2)


def a1_zero_x(square: bool):
    """An x whose rhs = x^3 + 4(1 + i) is real (rhs1 == 0), its real part
    a square of Fp or not: x = a + b i with 3 a^2 b - b^3 + 4 = 0."""
    while True:
        b = rand_fp() or 1
        a = GT.fp_sqrt((b * b * b - 4) * pow(3 * b, P - 2, P) % P)
        for s in (a, (P - a) % P) if a is not None else ():
            rhs = rhs_of((s, b))
            assert rhs[1] == 0
            if (GT.fp_sqrt(rhs[0]) is not None) == square:
                return (s, b)


@functools.lru_cache(maxsize=None)
def base_cases():
    """(x, sign bit, infinity bit, kind): a point with its own sign and the
    same x with the other sign (both roots), an x off the curve, the
    infinity encoding (x = 0), the two a1 == 0 branches (rhs0 a square:
    a real root; not: an imaginary one), and a second point."""
    pt = GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 0xDEC0)
    pt2 = GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 0x5EED)
    off = next((k, k + 3) for k in range(1, 100) if GT.fp2_sqrt(rhs_of((k, k + 3))) is None)
    s = GT.fp2_sgn(pt[1])
    return (
        (pt[0], s, 0, "point"),
        (pt[0], 1 - s, 0, "point, other root"),
        (off, 0, 0, "off the curve"),
        ((0, 0), 0, 1, "infinity"),
        (a1_zero_x(True), 0, 0, "rhs1 == 0, rhs0 a square"),
        (a1_zero_x(False), 1, 0, "rhs1 == 0, rhs0 not a square"),
        (pt2[0], GT.fp2_sgn(pt2[1]), 0, "point"),
    )


def cases(n):
    """n lanes cycling through `base_cases()`: plain x planes [2, 12, n]
    and flags [2, n] (sign, infinity)."""
    base = base_cases()
    pick = [base[i % len(base)] for i in range(n)]
    x = torch.from_numpy(np.stack([LY.encode_plain_batch([c[0][k] for c in pick]) for k in range(2)])).contiguous()
    flags = torch.tensor([[c[1] for c in pick], [c[2] for c in pick]], dtype=torch.int32)
    return pick, x, flags


N_MAX = 9


@pytest.fixture(scope="module")
def plain():
    """The plain version on `cases(N_MAX)`: lanes are independent, so a
    slice of it is the plain version of the slice."""
    _, x, flags = cases(N_MAX)
    return KV.g2_decompress_plain(x, flags)


def mont_ints(planes):
    """Planes [..., 12, n] -> per lane the Montgomery integers of the leading entries."""
    flat = planes.reshape(-1, LY.NL, planes.shape[-1])
    cols = [LY.decode_plain_batch(flat[i].numpy()) for i in range(flat.shape[0])]
    return [[c[j] for c in cols] for j in range(planes.shape[-1])]


def sqrt_segments(prog, st, reverse=False):
    """Segments B, C and D of the program and the segment loop's selects
    between them (csrc/ingest.cu g2_decompress_warp), from the state
    segment A leaves; -> (the state, the root's two Montgomery integers,
    r^2 == rhs)."""
    io = prog.io

    def segment(i):
        nonlocal st
        st = W.simulate(prog.segs, [prog.order[i]], prog.nslots, prog.consts, st, reverse)

    sp_ok = st[io["SP2"]] == st[io["RHS"]]
    a1z = st[io["RHS"] + 1] == 0
    segment(1)
    p_ok = st[io["RP2"]] == st[io["XP"]]
    st[io["Y"]] = st[io["RP"] if p_ok else io["RM"]]
    st[io["IX0"]] = st[io["IP"] if p_ok else io["IM"]]
    segment(2)
    if a1z:
        st[io["Y"]], st[io["Y1"]] = (st[io["SP"]], 0) if sp_ok else (0, st[io["SM"]])
    segment(3)
    on_curve = [st[io["S"] + k] for k in range(2)] == [st[io["RHS"] + k] for k in range(2)]
    return st, [st[io["Y"] + k] for k in range(2)], on_curve


def drive(prog, x_plain, sign, inf, reverse=False, msg_plain=(0, 0, 0, 0), msg_out=None):
    """The whole program through the segment loop's steps: -> (x and y as four
    Montgomery integers, ok); the message's four Montgomery integers, read
    after segment A as the kernel stores them, appended to msg_out."""
    io = prog.io
    st = W.simulate(prog.segs, [prog.order[0]], prog.nslots, prog.consts,
                    {**{io["XIN"] + k: v for k, v in enumerate(x_plain)},
                     **{io["MSGIN"] + k: v for k, v in enumerate(msg_plain)}}, reverse)
    if msg_out is not None:
        msg_out.append([st[io["MSG"] + k] for k in range(4)])
    st, _, on_curve = sqrt_segments(prog, st, reverse)
    raw = [st[io["RAW"] + k] for k in range(2)]
    if GT.fp2_sgn((raw[0], raw[1])) != sign:
        st[io["Y"]], st[io["Y1"]] = st[io["NY"]], st[io["NY"] + 1]
    return [st[io["X"] + k] for k in range(4)], on_curve or bool(inf)


def messages(n):
    """Plain message planes [2, 2, 12, n] of values in [p, 2^384) and below
    p, lane 1 all zero (padding)."""
    vals = [P, 2 * P + 3, (1 << 384) - 1, P - 1] + [int.from_bytes(RNG.bytes(48), "little") for _ in range(4 * n - 4)]
    vals[4:8] = [0] * 4
    return torch.from_numpy(LY.encode_plain_batch(vals[:4 * n])).reshape(LY.NL, n, 2, 2).permute(2, 3, 0, 1).contiguous()


@pytest.mark.parametrize("reverse", [False, True])
def test_program_simulation_equals_plain(prog, plain, reverse):
    """The program on Python integers, thread by thread in either order,
    through the segment loop's selects, equals the plain version lane by lane;
    the cases take every branch they name; the message planes segment A
    converts are mont_convert_plain's."""
    pick, _, _ = cases(N_MAX)
    xy, ok = plain
    want = mont_ints(xy)
    msg = messages(N_MAX)
    got_msg = []
    for j, (x, sign, inf, kind) in enumerate(pick):
        got, good = drive(prog, x, sign, inf, reverse, mont_ints(msg)[j], got_msg)
        assert got == want[j], (j, kind)
        assert int(good) == ok[0, j].item(), (j, kind)
    assert got_msg == mont_ints(KV.mont_convert_plain(msg))
    assert [int(v) for v in ok[0, :7]] == [1, 1, 0, 1, 1, 1, 1]
    ys = [tuple(LY.decode_batch(xy[1, k, :7].numpy())) for k in range(2)]
    assert ys[1][4] == 0 and ys[0][5] == 0  # the real and the imaginary root


def assert_last_launch(lib, prog, n):
    """The last launch of the library's g2_decompress: n lanes, 4 per
    block of 128 threads, the program's slots, constants, phases and
    rounds."""
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"g2_decompress", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]


@pytest.mark.parametrize("with_msg", [False, True])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 4, N_MAX])
def test_host_build_equals_plain(lib, prog, plain, n, order, with_msg):
    """The host build, its warps' threads forwards or reversed, at 1, 4 and
    9 lanes (9: the third block's lanes 1..3 idle) equals the plain version
    bit for bit, with the wire paths' messages or without (the pre-verify
    aggregation's); its points are crypto/curves.py's decompression, its
    Montgomery message planes mont_convert_plain's, and its rounds and
    products the same either way."""
    pick, x, flags = cases(n)
    xy, ok = torch.empty((2, 2, LY.NL, n), dtype=torch.int32), torch.empty((1, n), dtype=torch.int32)
    msg = messages(n) if with_msg else None
    msg_out = torch.full((2, 2, LY.NL, n), -1, dtype=torch.int32) if with_msg else None
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    lib.lt_host_warp_order(order)
    assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), None if msg is None else msg.data_ptr(),
                                xy.data_ptr(), None if msg_out is None else msg_out.data_ptr(), ok.data_ptr(), n,
                                None) == 0
    lib.lt_host_warp_order(0)
    if with_msg:
        assert torch.equal(msg_out, KV.g2_decompress_plain(x, flags, msg)[2])
        assert torch.equal(msg_out, KV.mont_convert_plain(msg))
    assert lib.lt_host_rounds() == n * KV.ROUNDS_PER_LANE["g2_decompress"]
    assert lib.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE["g2_decompress"]
    assert_last_launch(lib, prog, n)
    assert torch.equal(xy, plain[0][..., :n]) and torch.equal(ok, plain[1][..., :n])
    pts = list(zip(*(LY.decode_batch(xy[c, k].numpy()) for c in range(2) for k in range(2))))
    for (x0, x1, y0, y1), (xv, sign, inf, kind) in zip(pts, pick):
        if kind.startswith("point"):
            assert GC.is_on_curve(GC.FP2_OPS, ((x0, x1), (y0, y1))) and GT.fp2_sgn((y0, y1)) == sign, kind


@pytest.fixture()
def jax_eager_pow(monkeypatch):
    """JAX's value functions as written, with the exponentiations' loops
    (`fori_loop`) run as Python loops and the Montgomery product and
    square each jitted alone: jitting the square root whole takes minutes
    on a CPU, running it op by op seconds."""

    def fori_loop(lo, hi, body, init):
        v = init
        for i in range(lo, hi):
            v = body(i, v)
        return v

    monkeypatch.setattr(JTW.lax, "fori_loop", fori_loop)
    monkeypatch.setattr(JC, "mont_mul", jax.jit(JC.mont_mul))
    monkeypatch.setattr(JC, "mont_sqr", jax.jit(JC.mont_sqr))


def test_host_build_equals_jax_value_function(lib, jax_eager_pow):
    """Three lanes (a point given the other root's sign, the a1 == 0 lane
    with an imaginary root, an x off the curve): the host build's y and
    on-curve bit equal JAX `g2_decompress_y`'s."""
    base = base_cases()
    lanes = [base[1], base[5], base[2]]
    x = torch.from_numpy(np.stack([LY.encode_plain_batch([c[0][k] for c in lanes]) for k in range(2)])).contiguous()
    flags = torch.tensor([[c[1] for c in lanes], [0] * 3], dtype=torch.int32)
    xy, ok = torch.empty((2, 2, LY.NL, 3), dtype=torch.int32), torch.empty((1, 3), dtype=torch.int32)
    assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), None, xy.data_ptr(), None, ok.data_ptr(), 3,
                                None) == 0
    lib.lt_host_rounds(), lib.lt_host_fp_muls()
    jx = tuple(jnp.asarray(JL.encode_batch([c[0][k] for c in lanes])) for k in range(2))
    jy, jok = JIG.g2_decompress_y(jx, jnp.asarray([bool(c[1]) for c in lanes]))
    for k in range(2):
        assert LY.decode_batch(xy[1, k].numpy()) == JL.decode_batch(np.asarray(jy[k])), k
        assert LY.decode_batch(xy[0, k].numpy()) == JL.decode_batch(np.asarray(jx[k])), k
    assert ok[0].tolist() == np.asarray(jok).astype(int).tolist() == [1, 1, 0]


def after_a(prog, a):
    """The state segment A leaves for rhs = a (Fp2 ints), computed from
    the norm method's definitions: the square-root segments fed a
    directly."""
    io, m, e = prog.io, W.mont, W.SQRT_EXP
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, e, P)
    sp = pow(a[0], e, P)
    half = pow(2, P - 2, P)
    vals = {"RHS": a[0], "SP": sp, "SP2": sp * sp, "SM": -sp, "XP": (a[0] + d) * half, "XM": (a[0] - d) * half,
            "H1": a[1] * half}
    st = {io[r]: m(v) for r, v in vals.items()}
    st[io["RHS"] + 1] = m(a[1])
    return st


def test_sqrt_segments_equal_plain_fp2_sqrt(prog):
    """Segments B-D and the segment loop's selects, fed rhs values directly (0,
    whose xp = xm = 0 give a zero root; squares; non-squares; the a1 == 0
    cases both ways), give the plain `sqrt.fp2_sqrt`'s root and ok, and
    the oracle's root where one exists."""
    squares = [GT.fp2_sqr((rand_fp(), rand_fp())) for _ in range(3)]
    non = [a for a in ((rand_fp(), rand_fp()) for _ in range(12)) if GT.fp2_sqrt(a) is None][:3]
    res0 = pow(rand_fp(), 2, P)
    non0 = next(v for v in range(2, 100) if GT.fp_sqrt(v) is None)
    vals = [(0, 0)] + squares + non + [(res0, 0), (non0, 0), (0, 1), (P - 1, 0)]
    planes = torch.from_numpy(np.stack([LY.encode_batch([v[k] for v in vals]) for k in range(2)])).contiguous()
    root, ok = SQ.fp2_sqrt(LY.planes_to_digits(planes))
    want = mont_ints(LY.digits_to_planes(root))
    for j, a in enumerate(vals):
        st = after_a(prog, a)
        if a == (0, 0):
            assert st[prog.io["XP"]] == st[prog.io["XM"]] == 0
        for reverse in (False, True):
            _, got, good = sqrt_segments(prog, dict(st), reverse)
            assert got == want[j] and good == bool(ok[j]), (j, a, reverse)
        oracle = GT.fp2_sqrt(a)
        assert good == (oracle is not None)
        if oracle is not None:
            assert tuple(v * W.R_INV % P for v in got) == oracle
    assert want[0] == [0, 0] and bool(ok[0])


def eval_trace(t, inputs):
    """A trace's values on Python integers, in the order it was built."""
    vals, it = {}, iter(inputs)
    for v, kind in enumerate(t.kind):
        if kind < 0:
            vals[v] = next(it)
        else:
            a, b = (t.const_vals[-1 - x] if x < 0 else vals[x] for x in t.args[v])
            vals[v] = W.apply(kind, a, b)
    return vals


@pytest.mark.parametrize("width", [1, 3, 4, W.POW_WIDTH, 6])
def test_sliding_window_chain_equals_pow(width):
    """pow_window's chain gives a^e (0 for a = 0) for the square root's
    exponents, p - 2 and random ones, in fewer products than the binary
    chain's at the program's width."""
    exps = [W.SQRT_EXP, (P - 3) // 4, P - 2, 1, 2, 0b1011, int.from_bytes(RNG.bytes(48), "big") | 1 << 380]
    bases = [rand_fp(), rand_fp(), 0, 1, P - 1]
    for e in exps:
        t = W.Trace({"zero": 0})
        a = t.input()
        r = W.pow_window(t, a, e, width)
        for base in bases:
            assert eval_trace(t, [W.mont(base)])[r] == W.mont(pow(base, e, P)), (e, base)
        if width == W.POW_WIDTH and e > 1 << 300:
            assert sum(k == W.MUL for k in t.kind) < e.bit_length() - 1 + bin(e).count("1") - 1


def test_chain_inverse_equals_fermat(prog):
    """Segment B alone: rp = xp^((p + 1) / 4) and ip = t^3 xp with t =
    xp^((p - 3) / 4) is 1 / rp (0 for 0), so ip / 2 is pow(2 x0, p - 2, p),
    on squares, non-squares and 0 (xp and xm alike)."""
    io = prog.io
    non = next(v for v in range(2, 100) if GT.fp_sqrt(v) is None)
    vals = [pow(rand_fp(), 2, P), non * pow(rand_fp(), 2, P) % P, 0, 1, P - 1]
    half = pow(2, P - 2, P)
    for v, w in zip(vals, vals[::-1]):
        st = W.simulate(prog.segs, [prog.order[1]], prog.nslots, prog.consts,
                        {io["XP"]: W.mont(v), io["XM"]: W.mont(w)})
        for xv, root, inv in ((v, "RP", "IP"), (w, "RM", "IM")):
            x0 = pow(xv, W.SQRT_EXP, P)
            assert st[io[root]] == W.mont(x0)
            assert st[io[inv]] * half % P == W.mont(pow(2 * x0, P - 2, P)), (xv, root)
        assert st[io["RP2"]] == W.mont(pow(v, (P + 1) // 2, P))


def test_decompress_counts_are_the_program(prog):
    """ROUNDS_PER_LANE and FP_MULS_PER_LANE of g2_decompress are the
    generated program's (four segments, in order), the bound counts the
    same products, every segment passes check_hazards, and the generated
    header gives the segment loop each segment's first phase.  Segment A's
    first round holds the wire x's two products by R^2 and the message's
    four, R^2 the first operand of each; the message's registers lie on
    slots that segment A does not otherwise touch, so the program keeps the
    slot count of the decompression alone."""
    assert (prog.rounds, prog.fp_muls) == (KV.ROUNDS_PER_LANE["g2_decompress"],
                                           KV.FP_MULS_PER_LANE["g2_decompress"])
    assert KV.FP_MULS_NEEDED["g2_decompress"] == prog.fp_muls
    assert len(prog.order) == 4 == len(prog.segs)
    for seg in prog.segs:
        W.check_hazards(seg)
    starts = [0]
    for i in prog.order:
        starts.append(starts[-1] + len(prog.segs[i].phases))
    assert f"LT_DECOMP_SEG[5] = {W._words(starts)};" in W.cuda_programs()
    assert prog.nslots + len(prog.consts) < W.MAX_SLOTS
    io = prog.io
    assert (io["Y"], io["Y1"]) == (io["X"] + 2, io["X"] + 3)  # x and y stored as one run of four slots
    seg_a = prog.segs[prog.order[0]]
    r2 = W.CONST + prog.consts.index(W.R * W.R % P)
    first = [op for q in seg_a.phases[0] for op in q]
    assert sorted(op[2] for op in first) == [r2] * (2 + 4) and all(op[0] == W.MUL for op in first)  # x's, msg's
    assert not any(op[2] == r2 or op[3] == r2 for ph in seg_a.phases[1:] for q in ph for op in q)
    msg_slots = set(range(io["MSGIN"], io["MSGIN"] + 4)) | set(range(io["MSG"], io["MSG"] + 4))
    written = {op[1] for ph in seg_a.phases for q in ph for op in q}
    assert written & msg_slots == set(range(io["MSG"], io["MSG"] + 4))
    assert prog.nslots == 61
