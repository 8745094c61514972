"""G1 KeyValidate's block size, and an earlier design of the kernel, compared on the card.

    python3 tools/keyvalidate_blocks.py [--other PATH/TO/keyvalidate.cu]

A diagnostic beside the package, not part of it.  Builds
`csrc/keyvalidate.cu` as the package builds it and with LT_KV_BLOCK set to
each of 32, 64 and 128 threads (a copy of the source with the define
changed), and, with --other, another version of the source (an earlier
commit's, compiled against the headers beside it).  Prints each build's
`ptxas -v` figures and, for the package's source, the launch shape and the
blocks an SM holds (`lt_kv_launch_shape`: the occupancy API), then holds
every build's (x, y) and ok against each other and the plain version bit
for bit on 64 keys of G1 and on keys outside G1 (the order-3 x = 0,
points of each prime order dividing the cofactor and their sums with a
key of G1, curve points; both signs of each) and an x off the curve, and
prints each build's CUDA-event time at 65,536, 32,768, 16,384 and 256
lanes of the 64 keys of G1 repeated, as chip_smoke.py registers them
(median of 10 calls after a warm-up, the builds in turns): whether the
time follows the lanes (the card's throughput) or stays (one lane's
latency).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import random
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's root

from lodestar_tpu_torch.bls.ingest import encode_pubkey_planes  # noqa: E402
from lodestar_tpu_torch.crypto import curves as GC  # noqa: E402
from lodestar_tpu_torch.crypto import fields as GT  # noqa: E402
from lodestar_tpu_torch.kernels import build as B  # noqa: E402
from lodestar_tpu_torch.kernels import verify as KV  # noqa: E402

BLOCKS = (32, 64, 128)
LANES = (65536, 32768, 16384, 256)  # registration's chunk, a half and a quarter of it (fewer warps an SM), one lane's latency
RUNS = 10
DEFINE = re.compile(r"^#define LT_KV_BLOCK \d+", re.M)


def build(src: Path, tag: str, block=None, includes=()):
    """(library, ptxas log) of src, LT_KV_BLOCK replaced where block is given."""
    tmp = Path(tempfile.mkdtemp())
    includes = (src.parent, *includes)
    if block is not None:
        text = src.read_text()
        assert DEFINE.search(text), "no LT_KV_BLOCK define to replace"
        (tmp / src.name).write_text(DEFINE.sub(f"#define LT_KV_BLOCK {block}", text))
        src = tmp / src.name
    out = tmp / f"kv_{tag}.so"
    inc = [a for d in includes for a in ("-I", str(d))]
    log = subprocess.run([B.nvcc(), *B.NVCC_FLAGS, *inc, "-o", str(out), str(src)], check=True,
                         capture_output=True, text=True)
    return B._bind(ctypes.CDLL(str(out))), log.stdout + log.stderr


def ptxas_line(log: str) -> str:
    regs = re.search(r"Used (\d+) registers", log)
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log)
    stack = re.search(r"(\d+) bytes cumulative stack size", log)
    return (f"{regs.group(1) if regs else '?'} registers, stack frames {frames}, "
            f"cumulative stack {stack.group(1) if stack else 0} B")


def keys(rng: random.Random):
    """64 keys of G1, then keys outside it (both signs of each)."""
    g1 = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, rng.randrange(1, GT.R)) for _ in range(64)]
    n_e = GT.H1_COFACTOR * GT.R

    def on_curve():
        while True:
            x = rng.randrange(GT.P)
            y = GT.fp_sqrt((x * x * x + 4) % GT.P)
            if y is not None:
                return x, y

    bad = [(0, 2)]
    for ell, k in ((3, 1), (11, 2), (10177, 2), (859267, 2), (52437899, 2)):  # E(Fp)'s ell-part: ell^k
        t = None
        while t is None:
            t = GC.scalar_mul(GC.FP_OPS, on_curve(), n_e // ell**k)
        bad += [t, GC.affine_add(GC.FP_OPS, g1[0], t)]
    bad += [on_curve() for _ in range(4)]
    comp = [GC.g1_compress(p) for p in g1]
    for p in bad:
        c = GC.g1_compress(p)
        comp += [c, bytes([c[0] ^ 0x20]) + c[1:]]
    x = 1
    while GT.fp_sqrt((x ** 3 + 4) % GT.P) is not None:
        x += 1
    off = bytearray(x.to_bytes(48, "big"))
    off[0] |= 0x80
    comp.append(bytes(off))
    return comp, len(g1)


def run(lib, x, flags):
    n = x.shape[-1]
    xy = torch.empty((2, 12, n), dtype=torch.int32, device="cuda")
    ok = torch.empty((1, n), dtype=torch.int32, device="cuda")
    assert lib.lt_g1_keyvalidate(x.data_ptr(), flags.data_ptr(), xy.data_ptr(), ok.data_ptr(), n,
                                 torch.cuda.current_stream().cuda_stream) == 0
    return xy, ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, help="another keyvalidate.cu to build and time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("keyvalidate_blocks: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    src = B.CSRC / "keyvalidate.cu"
    libs = {}
    for block in BLOCKS:
        lib, log = build(src, str(block), block, (B.include_dir(),))
        shape = torch.zeros(4, dtype=torch.int32)
        assert lib.lt_kv_launch_shape(shape.data_ptr()) == 0
        threads, smem, per_sm, slots = shape.tolist()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        blocks = -(-LANES[0] // threads)
        print(f"keyvalidate.cu at {threads} threads a block: ptxas {ptxas_line(log)}; {slots} slots, {smem} B "
              f"dynamic shared memory a block; {per_sm} blocks ({per_sm * threads // 32} warps) an SM at once; "
              f"{LANES[0]} lanes = {blocks} blocks, {blocks / sms:.2f} a SM ({blocks * threads / 32 / sms:.2f} warps), "
              f"{blocks / (per_sm * sms):.2f} waves")
        libs[f"block {block}"] = lib
    if args.other is not None:
        lib, log = build(args.other.resolve(), "other")
        print(f"{args.other}: ptxas {ptxas_line(log)}")
        libs["other"] = lib

    comp, n_g1 = keys(random.Random(11))
    x, flags, bad = encode_pubkey_planes(comp)
    assert not bad.any()
    x, flags = torch.from_numpy(x).cuda(), torch.from_numpy(flags).cuda()
    outs = {k: run(lib, x, flags) for k, lib in libs.items()}
    ref = next(iter(outs.values()))
    assert all(torch.equal(a, b) for o in outs.values() for a, b in zip(o, ref)), "builds differ"
    plain = KV.g1_keyvalidate_plain(x, flags)
    assert all(torch.equal(a, b) for a, b in zip(plain, ref)), "the kernel differs from the plain version"
    ok = ref[1][0].tolist()
    assert ok == [1] * n_g1 + [0] * (len(comp) - n_g1), ok
    print(f"{len(comp)} keys ({n_g1} of G1, {len(comp) - n_g1} outside it or off the curve): every build equal to "
          f"the others and to the plain version bit for bit")

    for n in LANES:
        idx = torch.arange(n, device="cuda") % n_g1
        xn, fn = x[:, idx].contiguous(), flags[:, idx].contiguous()
        assert all(bool(run(lib, xn, fn)[1].all()) for lib in libs.values())
        times = {k: [] for k in libs}
        for _ in range(RUNS):
            for k, lib in libs.items():  # in turns
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run(lib, xn, fn)
                b.record()
                b.synchronize()
                times[k].append(a.elapsed_time(b))
        print(f"g1_keyvalidate N={n}: " + ", ".join(f"{k} {statistics.median(t):.4f} ms" for k, t in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
