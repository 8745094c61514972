"""Where a warp-per-lane lane spends its cycles, on the card.

    python3 tools/warp_profile.py

A diagnostic beside the package, not part of it.  Builds `warp_profile.cu`
against the kernels' headers (`lodestar_tpu_torch/kernels/csrc` and the
generated ones), then prints
  * the latency in cycles of one Fp operation on a thread (256 dependent
    ones on each thread of a warp): the Montgomery product, fp_add, fp_sub,
    and the interpreter's add and product with operands in shared memory;
  * one lane of the Miller loop, of the final exponentiation and of r sig
    with the subgroup check (its segments back to back, without the
    window loop's copies between windows) with clock64() around every phase,
    summed by kind of phase (products, linear only, the inversion) and by
    rows (the longest queue of operations on one thread).
Values are random field elements: the programs' cost does not depend on
them, except the inversion's few percent.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import random
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's root

from lodestar_tpu_torch.kernels import build as B  # noqa: E402
from lodestar_tpu_torch.kernels import warp_schedule as W  # noqa: E402

OPS = ("Montgomery product", "fp_add", "fp_sub", "interpreter add (shared memory)",
       "interpreter product (shared memory)")


def _values(n: int, rng: random.Random) -> torch.Tensor:
    vals = [rng.randrange(1, W.P) for _ in range(n)]
    words = np.frombuffer(b"".join(v.to_bytes(48, "little") for v in vals), np.int32).copy()
    return torch.from_numpy(words).cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("warp_profile: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    mhz = float(card.split(",")[-1].split()[0])
    print(card)
    lib_path = Path(tempfile.mkdtemp()) / "warp_profile.so"
    src = Path(__file__).with_name("warp_profile.cu")
    subprocess.run([B.nvcc(), *B.NVCC_FLAGS, "-I", str(B.CSRC), "-I", str(B.include_dir()), "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.lt_prof_program.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.lt_prof_op.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    rng = random.Random(5)
    for which, name in enumerate(OPS):
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        out = torch.zeros(W.WARP * 12, dtype=torch.int32, device="cuda")
        init = _values(2, rng)
        for _ in range(2):  # the second run is timed warm
            assert lib.lt_prof_op(which, init.data_ptr(), out.data_ptr(), cyc.data_ptr()) == 0
        print(f"op {name}: {int(cyc[0]) / 256:.1f} cycles")
    for which, prog in enumerate(W.programs()):
        phases = [ph for i in prog.order for ph in prog.segs[i].phases]
        cyc = torch.zeros(len(phases), dtype=torch.int64, device="cuda")
        init = _values(prog.nfix if prog.name == "RSIG" else (7, 24)[which], rng)
        for _ in range(2):
            assert lib.lt_prof_program(which, cyc.data_ptr(), init.data_ptr()) == 0
        c = cyc.cpu().numpy()
        total = int(c.sum())
        print(f"{prog.name}: {total} cycles = {total / mhz:.1f} us at {mhz:.0f} MHz, {len(phases)} phases, "
              f"{prog.rounds} rounds, one lane")
        classes = {}
        for k, ph in enumerate(phases):
            ops = [op for q in ph for op in q]
            kinds = {op[0] for op in ops}
            kind = "inversion" if W.INV in kinds else ("products" if W.MUL in kinds else "linear")
            rows = max(len(q) for q in ph)
            entry = classes.setdefault((kind, rows), [0, 0, 0])
            entry[0] += 1
            entry[1] += int(c[k])
            entry[2] += len(ops)
        for (kind, rows), (n, cycles, ops) in sorted(classes.items()):
            print(f"  {kind}, {rows} rows: {n} phases, {cycles} cycles ({100 * cycles / total:.1f} %), "
                  f"{cycles / n:.0f} per phase, {ops / n:.1f} operations per phase")
    return 0


if __name__ == "__main__":
    sys.exit(main())
