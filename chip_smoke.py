#!/usr/bin/env python3
"""Smoke run of lodestar_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero without one.  In order:

  1. setup: the card's name and power limit; build every CUDA kernel from
     the sources in this checkout (one nvcc per source, all at once); make
     64 keypairs, 8 signing roots hashed to G2 and 512 signatures from a
     fixed seed with the port's own crypto/ copy; a 1,048,576-row pubkey
     table on the device; a 512-set job mixing valid sets, wrong messages,
     swapped signatures, signatures at infinity and on-curve signatures
     outside G2; the host ground truth (crypto/bls.py verify) of every set;
  2. kernel phases: each of the four kernels against its plain torch
     version on the same device inputs, the operands of the per-set path
     at N = 128 and N = 512, bit for bit; CUDA-event times (median of 5
     after a warm-up) of kernel and plain version;
  3. main path: TorchBlsVerifier.verify_signature_sets_individually and
     verify_signature_sets on the 128- and 512-set jobs, every verdict
     against the ground truth, sets/s, and the launch count of each kernel
     in that run (every count must be > 0);
  4. one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

Any mismatch or error raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0x10DE57A8
N_KEYS = 64
N_ROOTS = 8
TABLE_ROWS = 1 << 20
JOBS = (128, 512)
TIMED_RUNS = 5

# NVIDIA H100 SXM (data sheet): HBM3 rate; 32-bit IMAD issue rate per SM
# (CUDA programming guide, compute capability 9.0 throughput table)
PEAK_BYTES_PER_S = 3.35e12
IMAD_PER_CLK_PER_SM = 64
N_SM = 132

# TPU kernel each CUDA kernel replaces, and its source in this checkout
KERNELS = {
    "mont_convert": ("lodestar_tpu_torch/kernels/csrc/mont.cu", "lodestar_tpu/kernels/verify.py:116"),
    "g2_subgroup_check": ("lodestar_tpu_torch/kernels/csrc/subgroup.cu", "lodestar_tpu/kernels/verify.py:190"),
    "miller_loop": ("lodestar_tpu_torch/kernels/csrc/miller.cu", "lodestar_tpu/kernels/verify.py:269"),
    "each_final": ("lodestar_tpu_torch/kernels/csrc/final.cu", "lodestar_tpu/kernels/verify.py:328"),
}
# bytes each kernel must move per lane: inputs read once, outputs written once
BYTES_PER_LANE = {
    "mont_convert": 8 * 48 * 2,
    "g2_subgroup_check": 4 * 48 + 4 + 4,
    "miller_loop": 7 * 48 + 12 * 48,
    "each_final": 4 + 24 * 48 + 4,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


# -- host data (pure Python, run in worker processes) -------------------------


def _sign(args):
    from lodestar_tpu_torch.crypto import curves as GC

    sk, h = args
    return GC.scalar_mul(GC.FP2_OPS, h, sk)


def _ground_truth(args):
    from lodestar_tpu_torch.crypto import bls as GB

    pk, root, sig = args
    return GB.verify(pk, root, sig)


def make_job(pool):
    """Keys, roots, signatures, a 512-set job and its ground truth."""
    from lodestar_tpu_torch.bls.signature_set import SignatureSet
    from lodestar_tpu_torch.crypto import bls as GB
    from lodestar_tpu_torch.crypto import curves as GC
    from lodestar_tpu_torch.crypto import hash_to_curve as GH

    rng = np.random.default_rng(SEED)
    sks = [GB.keygen(rng.bytes(32)) for _ in range(N_KEYS)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    roots = [rng.bytes(32) for _ in range(N_ROOTS)]
    hs = [GH.hash_to_g2(r) for r in roots]
    n = JOBS[-1]
    # set i: key i % 64 signs root i // 64 (512 distinct signatures)
    sigs = pool.map(_sign, [(sks[i % N_KEYS], hs[i // N_KEYS]) for i in range(n)])
    outside = []
    for j in range(4):
        u = GH.hash_to_field_fp2(b"outside-G2-%d" % j, 1, b"chip-smoke")[0]
        pt = GH.map_to_curve_svdw(GC.FP2_OPS, u)
        assert GC.is_on_curve(GC.FP2_OPS, pt) and not GC.g2_subgroup_check(pt)
        outside.append(pt)
    rows = rng.integers(0, TABLE_ROWS // N_KEYS, size=n) * N_KEYS
    sets, kinds, gt_args = [], [], []
    for i in range(n):
        k, r = i % N_KEYS, i // N_KEYS
        msg_r, sig = r, sigs[i]
        kind = {3: "wrong_message", 7: "swapped_signature", 11: "infinity", 15: "outside_G2"}.get(
            i % 16, "valid"
        )
        if kind == "wrong_message":
            msg_r = (r + 1) % N_ROOTS
        elif kind == "swapped_signature":
            sig = sigs[i + 1]
        elif kind == "infinity":
            sig = None
        elif kind == "outside_G2":
            sig = outside[(i // 16) % 4]
        sets.append(SignatureSet.single(int(rows[i] + k), hs[msg_r], sig))
        kinds.append(kind)
        gt_args.append((pks[k], roots[msg_r], sig))
    truth = pool.map(_ground_truth, gt_args)
    return pks, sets, kinds, truth


# -- timing -------------------------------------------------------------------


def cuda_ms(fn, runs: int = TIMED_RUNS):
    """Median CUDA-event time of fn() over `runs` runs after one warm-up;
    returns (ms, warm-up result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def ptxas_summary(report: str) -> str:
    """Registers of each kernel entry and the largest stack frame and
    spill of any function, from a ptxas -v log."""
    regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", report, re.S)
    frames = [tuple(map(int, m)) for m in re.findall(
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", report)]
    parts = [f"{name}: {r} registers" for name, r in regs]
    if frames:
        parts.append(
            f"largest stack frame {max(f[0] for f in frames)} B, largest spill "
            f"{max(f[1] for f in frames)} B stores / {max(f[2] for f in frames)} B loads "
            f"over {len(frames)} functions"
        )
    return "; ".join(parts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2

    from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
    from lodestar_tpu_torch.bls.verifier import TorchBlsVerifier
    from lodestar_tpu_torch.kernels import build as B
    from lodestar_tpu_torch.kernels import layout as LY
    from lodestar_tpu_torch.kernels import verify as KV

    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    log(card)
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"setup: python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"max SM clock {sm_mhz:.0f} MHz")

    # -- 1. setup --------------------------------------------------------------
    t = time.perf_counter()
    with ThreadPoolExecutor(1) as builder, mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        build = builder.submit(B.build_all)  # nvcc processes run while the pool signs
        pks, sets, kinds, truth = make_job(pool)
        build.result()
    log(f"setup: kernels built and data made in {time.perf_counter() - t:.1f} s "
        f"({sum(1 for k in kinds if k == 'valid')} valid of {len(sets)}; "
        f"ground truth {sum(truth)} True)")
    for name, report in B.ptxas_report().items():
        log(f"ptxas {name}.cu: {ptxas_summary(report)}")
    for kind, ok in zip(kinds, truth):
        if ok != (kind == "valid"):
            raise AssertionError(f"ground truth disagrees with construction for a {kind} set")

    dev = torch.device("cuda")
    table = PubkeyTable()
    table.register_points_unchecked(pks, tile_to=TABLE_ROWS)
    tx, ty = table.device_planes(dev)
    torch.cuda.synchronize()
    log(f"setup: pubkey table {len(table)} rows, {table.nbytes} bytes on {torch.cuda.get_device_name(0)}")
    verifier = TorchBlsVerifier(table)  # device None -> the CUDA device

    # -- 2. kernel phases --------------------------------------------------------
    results = {}
    for n in JOBS:
        planes, idx, sig_inf, valid = verifier._prepare(sets[:n])
        checks = {}

        def plain_and_kernel(name, kernel, plain, *args):
            k_ms, k_out = cuda_ms(lambda: kernel(*args))
            p_ms, p_out = cuda_ms(lambda: plain(*args))
            err = int((k_out.to(torch.int64) - p_out.to(torch.int64)).abs().max())
            if err != 0 or not torch.equal(k_out, p_out):
                raise AssertionError(f"{name} at N={n}: kernel differs from plain version (max {err})")
            checks[name] = (k_ms, p_ms, err)
            log(f"kernel {name} N={n}: equal to plain bit for bit; kernel {k_ms:.3f} ms, "
                f"plain {p_ms:.3f} ms (CUDA events, median of {TIMED_RUNS})")
            return k_out

        m = plain_and_kernel("mont_convert", KV.mont_convert, KV.mont_convert_plain, planes)
        msg, sig = m[:4].reshape(2, 2, LY.NL, n), m[4:].reshape(2, 2, LY.NL, n)
        ops = KV.each_operands(tx, ty, idx, msg, sig, sig_inf != 0, valid)
        sub = plain_and_kernel("g2_subgroup_check", KV.g2_subgroup_check, KV.g2_subgroup_check_plain, *ops["sub"])
        f1 = plain_and_kernel("miller_loop", KV.miller_loop, KV.miller_loop_plain, *ops["miller_pk"])
        f2 = KV.miller_loop(*ops["miller_sig"])
        if not torch.equal(f2, KV.miller_loop_plain(*ops["miller_sig"])):
            raise AssertionError(f"miller_loop (-G1, sig) at N={n}: kernel differs from plain version")
        ok = plain_and_kernel("each_final", KV.each_final, KV.each_final_plain, ops["live_row"], f1, f2)
        n_sub = int(sub.sum())
        log(f"kernel outputs N={n}: {n_sub} lanes in G2, {int(ok.sum())} final exps equal to one")
        results[n] = checks

    # -- 3. main path ------------------------------------------------------------
    for n in JOBS:
        job, want = sets[:n], truth[:n]
        verifier.verify_signature_sets_individually(job)  # warm-up
        torch.cuda.synchronize()
        KV.reset_launches()
        got = verifier.verify_signature_sets_individually(job)
        counts = dict(KV.LAUNCHES)
        if got != want:
            bad = [(i, kinds[i], g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"N={n}: {len(bad)} verdicts differ from the ground truth: {bad[:8]}")
        if min(counts.values()) == 0:
            raise AssertionError(f"N={n}: a kernel of the path was never launched: {counts}")
        all_ok = verifier.verify_signature_sets(job)
        if all_ok != all(want):
            raise AssertionError(f"N={n}: verify_signature_sets gave {all_ok}, want {all(want)}")
        valid_only = [s for s, w in zip(job, want) if w]
        if not verifier.verify_signature_sets(valid_only):
            raise AssertionError(f"N={n}: verify_signature_sets rejected the valid sets")
        times = []
        for _ in range(3):
            t = time.perf_counter()
            verifier.verify_signature_sets_individually(job)
            times.append(time.perf_counter() - t)
        dt = statistics.median(times)
        log(f"main path N={n}: {sum(got)} of {n} True, every verdict equals the ground truth; "
            f"launches {json.dumps(counts)}; verify_signature_sets_individually {dt * 1e3:.1f} ms = "
            f"{n / dt:.1f} sets/s (host clock, median of 3 after a warm-up)")
        prep = []
        for _ in range(3):
            t = time.perf_counter()
            verifier._prepare(job)
            torch.cuda.synchronize()
            prep.append(time.perf_counter() - t)
        kern = sum(results[n][k][0] * counts[k] for k in KERNELS)
        log(f"breakdown N={n}: job {dt * 1e3:.3f} ms = host preparation (encode + copy to the card) "
            f"{statistics.median(prep) * 1e3:.3f} ms + kernels {kern:.3f} ms (kernel-phase medians x "
            f"launches) + the rest {dt * 1e3 - statistics.median(prep) * 1e3 - kern:.3f} ms")
        results[n]["launches"] = counts
        results[n]["sets_per_s"] = n / dt

    if not verifier._device_canary():
        raise AssertionError("device canary failed")

    # -- 4. result lines -----------------------------------------------------------
    n = JOBS[-1]
    imad_per_ms = N_SM * IMAD_PER_CLK_PER_SM * sm_mhz * 1e3
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        k_ms, p_ms, err = results[n][name]
        elems = 8 * n if name == "mont_convert" else n
        ops_ms = KV.FP_MULS_PER_LANE[name] * KV.IMAD_PER_FP_MUL * elems / imad_per_ms
        bytes_ms = BYTES_PER_LANE[name] * n / PEAK_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": results[n]["launches"][name], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "n": n, "ms_n128": results[JOBS[0]][name][0], "plain_ms_n128": results[JOBS[0]][name][1],
        })
    log(f"main path sets/s: " + ", ".join(f"N={j}: {results[j]['sets_per_s']:.1f}" for j in JOBS)
        + f" ({card}); total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
