"""The segmented scans' lanes per block, compared on the card.

    python3 tools/segsum_blocks.py

A diagnostic beside the package, not part of it.  Builds
`csrc/segsum.cu` as the kernels run it (lanes per block by
`seg_warps(n)`: 4 up to 512 lanes, 8 up to 1024, 16 past it) and with a
fixed 16, 8 and 4 lanes (warps) per block (LT_SEG_FIXED_WARPS), checks
that every build gives the same outputs bit for bit (and the plain
version's at N = 512), and prints each build's CUDA-event time of
`lt_seg_sum_g1` and `lt_seg_sum_g2` at N = 128, 512, 1024 and 2048
(median of 20 calls after a warm-up, in turns) on random field elements
in groups of 1..64 lanes with every sixth lane dead.  Needs one CUDA
card.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's root

from lodestar_tpu_torch.kernels import build as B  # noqa: E402
from lodestar_tpu_torch.kernels import layout as LY  # noqa: E402
from lodestar_tpu_torch.kernels import verify as KV  # noqa: E402

WARPS = (0, 16, 8, 4)  # 0: the kernels' own choice
LANES = (128, 512, 1024, 2048)
RUNS = 20


def build(warps: int) -> ctypes.CDLL:
    out = Path(tempfile.mkdtemp()) / f"segsum{warps}.so"
    fixed = [f"-DLT_SEG_FIXED_WARPS={warps}"] if warps else []
    subprocess.run([B.nvcc(), *B.NVCC_FLAGS, *fixed, "-I", str(B.include_dir()), "-o", str(out),
                    str(B.CSRC / "segsum.cu")], check=True, capture_output=True)
    return B._bind(ctypes.CDLL(str(out)))


def operands(g2: bool, n: int, rng):
    coords = 4 if g2 else 3
    vals = rng.integers(0, 2**32, size=(coords, LY.NL, n), dtype=np.uint64)
    vals[:, LY.NL - 1] %= 0x1A0111EA  # below p: the top limb under p's
    pts = torch.from_numpy(vals.astype(np.uint32).view(np.int32)).reshape(
        (2, 2, LY.NL, n) if g2 else (3, LY.NL, n)).contiguous().cuda()
    group = torch.from_numpy(np.repeat(np.arange(n), rng.integers(1, 65, size=n))[:n].astype(np.int32)).cuda()
    dead = (torch.arange(n, device="cuda") % 6 == 5).to(torch.int32)[None].contiguous()
    return pts, dead, group


def run(lib, g2, pts, dead, group):
    n = group.shape[0]
    shape = (3, 2, LY.NL, n) if g2 else (3, LY.NL, n)
    out, scr = (torch.empty(shape, dtype=torch.int32, device="cuda") for _ in range(2))
    out_inf, scr_inf = (torch.empty((1, n), dtype=torch.int32, device="cuda") for _ in range(2))
    made = ctypes.c_int(0)
    fn = lib.lt_seg_sum_g2 if g2 else lib.lt_seg_sum_g1
    err = fn(pts.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(), out_inf.data_ptr(), scr.data_ptr(),
             scr_inf.data_ptr(), n, ctypes.addressof(made), torch.cuda.current_stream().cuda_stream)
    assert err == 0 and made.value == KV.seg_rounds(n)
    return out, out_inf


def main() -> int:
    if not torch.cuda.is_available():
        print("segsum_blocks: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    libs = {w: build(w) for w in WARPS}
    rng = np.random.default_rng(7)
    for g2 in (False, True):
        name = "seg_sum_g2" if g2 else "seg_sum_g1"
        for n in LANES:
            args = operands(g2, n, rng)
            outs = {w: run(libs[w], g2, *args) for w in WARPS}
            assert all(torch.equal(a, b) for w in WARPS for a, b in zip(outs[w], outs[WARPS[0]]))
            if n == 512:
                plain = (KV.seg_sum_g2_plain if g2 else KV.seg_sum_g1_plain)(*args)
                assert all(torch.equal(a, b) for a, b in zip(outs[WARPS[0]], plain))
            times = {w: [] for w in WARPS}
            for w in WARPS:
                run(libs[w], g2, *args)
            for _ in range(RUNS):
                for w in WARPS:  # in turns
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    run(libs[w], g2, *args)
                    b.record()
                    b.synchronize()
                    times[w].append(a.elapsed_time(b))
            print(f"{name} N={n} ({KV.seg_rounds(n)} launches): " + ", ".join(
                f"{w or f'seg_warps ({KV.seg_warps(n)})'} lanes per block {statistics.median(times[w]):.4f} ms"
                for w in WARPS)
                + "; outputs equal across builds" + (" and to the plain version" if n == 512 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
