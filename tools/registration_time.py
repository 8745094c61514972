"""Pubkey registration on the card, split into host encoding, kernel and the rest.

    python3 tools/registration_time.py [--root CHECKOUT] [--runs 3]

A diagnostic beside the package, not part of it.  Imports
`lodestar_tpu_torch` from --root (this checkout by default; another one,
such as an earlier commit's `git archive` unpacked under `_checkout/`, to
compare two versions in one call), makes chip_smoke.py's 64 keys from its
seed and registers 1,048,576 compressed keys (row r holds key r % 64) with
`PubkeyTable.register_compressed` in chunks of 65,536, as chip_smoke.py
does: one warm-up run (the kernels' build and first launches), then
--runs timed runs into fresh tables.  Each run prints one JSON line: the
total (host clock, the card drained before and after), host encoding
(host clock around `encode_pubkey_planes`, summed over the chunks), the
kernel (CUDA events around each `g1_keyvalidate` launch) and the rest.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0x10DE57A8  # chip_smoke.py's
N_KEYS, ROWS, CHUNK = 64, 1 << 20, 65536


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("registration_time: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from lodestar_tpu_torch.bls import pubkey_table as PT
    from lodestar_tpu_torch.crypto import bls as GB
    from lodestar_tpu_torch.crypto import curves as GC
    from lodestar_tpu_torch.kernels import verify as KV

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(SEED)
    comp = [GC.g1_compress(GB.sk_to_pk(GB.keygen(rng.bytes(32)))) for _ in range(N_KEYS)]
    keys = [comp[r % N_KEYS] for r in range(ROWS)]
    encode, keyvalidate = PT.encode_pubkey_planes, KV.g1_keyvalidate
    parts = {}

    def timed_encode(chunk):
        t0 = time.perf_counter()
        out = encode(chunk)
        parts["encode_s"] += time.perf_counter() - t0
        return out

    def timed_keyvalidate(x, flags):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = keyvalidate(x, flags)
        b.record()
        parts["events"].append((a, b))
        return out

    PT.encode_pubkey_planes, KV.g1_keyvalidate = timed_encode, timed_keyvalidate
    totals = []
    for run in range(args.runs + 1):
        parts.update(encode_s=0.0, events=[])
        table = PT.PubkeyTable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = table.register_compressed(keys, device_batch=CHUNK)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        assert idx == list(range(ROWS))
        kernel = sum(a.elapsed_time(b) for a, b in parts["events"])
        rec = {"root": str(args.root), "run": "warm-up" if run == 0 else run, "total_ms": total,
               "host_encoding_ms": parts["encode_s"] * 1e3, "kernel_ms": kernel,
               "rest_ms": total - parts["encode_s"] * 1e3 - kernel, "launches": len(parts["events"]),
               "keys_per_s": ROWS / total * 1e3, "card": card}
        print(json.dumps(rec), flush=True)
        if run:
            totals.append(total)
    print(f"{args.root}: registration of {ROWS} keys, median of {args.runs} runs {statistics.median(totals):.1f} ms "
          f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
