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
     outside G2, and the all-valid job of the same 512 untampered
     signatures; the host ground truth (crypto/bls.py verify) of every set;
  2. kernel phases: each of the ten kernels against its plain torch
     version on the same device inputs, bit for bit: the per-set path's
     four on the mixed job's operands and the RLC batch path's six (and
     the one-lane Miller loop of its tail) on the all-valid job's, at
     N = 128 and N = 512; CUDA-event times of kernel (median of 5 after a
     warm-up) and plain version (median of 3: the plain versions take
     seconds per call);
  3. main paths, each driven with the launch counts set to 0 just before
     and read just after: the per-set path
     (verify_signature_sets_individually on the mixed jobs, every verdict
     against the ground truth, every per-set kernel launched); the RLC
     batch (verify_signature_sets(batchable=True) on the all-valid jobs:
     True, two Miller launches, one final_one, no each_final, every batch
     kernel launched); the bisection (the all-valid 512-set job with one
     wrong message: False, bisected to the 128-set leaf, every verdict
     against the ground truth); and the mixed job sent batchable, which
     holds infinity signatures and must go per set; sets/s and a
     breakdown for both paths;
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
PLAIN_RUNS = 3
BAD_SET = 323  # a wrong-message set of the mixed job (323 % 16 == 3)

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
    "g1_rpk": ("lodestar_tpu_torch/kernels/csrc/randmul.cu", "lodestar_tpu/kernels/verify.py:155"),
    "g2_rsig_sub": ("lodestar_tpu_torch/kernels/csrc/randmul.cu", "lodestar_tpu/kernels/verify.py:169"),
    "sum_g2": ("lodestar_tpu_torch/kernels/csrc/reduce.cu", "lodestar_tpu/kernels/verify.py:196"),
    "prod12": ("lodestar_tpu_torch/kernels/csrc/reduce.cu", "lodestar_tpu/kernels/verify.py:285"),
    "affine_g2": ("lodestar_tpu_torch/kernels/csrc/tail.cu", "lodestar_tpu/kernels/verify.py:231"),
    "final_one": ("lodestar_tpu_torch/kernels/csrc/tail.cu", "lodestar_tpu/kernels/verify.py:312"),
}
PER_SET = ("mont_convert", "g2_subgroup_check", "miller_loop", "each_final")
BATCH = ("mont_convert", "g1_rpk", "g2_rsig_sub", "sum_g2", "miller_loop", "prod12", "affine_g2", "final_one")
TAIL = ("affine_g2", "final_one")  # one lane per launch on the batch path
# bytes each kernel must move per lane (per launch for the reductions'
# one output and the tail): inputs read once, outputs written once
BYTES_PER_LANE = {
    "mont_convert": 8 * 48 * 2,
    "g2_subgroup_check": 4 * 48 + 4 + 4,
    "miller_loop": 7 * 48 + 12 * 48,
    "each_final": 4 + 24 * 48 + 4,
    "g1_rpk": (3 * 48 + 4 + 16) + (3 * 48 + 4),
    "g2_rsig_sub": (4 * 48 + 4 + 16) + (6 * 48 + 4 + 4),
    "sum_g2": 6 * 48 + 4,
    "prod12": 4 + 12 * 48,
    "affine_g2": (6 * 48 + 4) + (4 * 48 + 4),
    "final_one": 4 + 24 * 48 + 4,
}
BYTES_PER_LAUNCH = {"sum_g2": 6 * 48 + 4, "prod12": 12 * 48}


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
    """Keys, roots, signatures, the mixed 512-set job and its ground truth,
    and the all-valid job of the 512 untampered signatures."""
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
    sets, kinds, gt_args, valid_sets, extra = [], [], [], [], []
    for i in range(n):
        k, r = i % N_KEYS, i // N_KEYS
        valid_sets.append(SignatureSet.single(int(rows[i] + k), hs[r], sigs[i]))
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
        if kind != "valid":  # the untampered set is not in the mixed job
            extra.append((pks[k], roots[r], sigs[i]))
    truth = pool.map(_ground_truth, gt_args + extra)
    if not all(truth[n:]):
        raise AssertionError("an untampered signature fails the ground truth")
    return pks, sets, kinds, truth[:n], valid_sets


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
    """Registers and cumulative stack of each kernel entry and the largest
    stack frame and spill of any function, from a ptxas -v log."""
    regs = re.findall(
        r"Compiling entry function '(\w+)'.*?Used (\d+) registers.*?(\d+) bytes cumulative stack size", report, re.S)
    frames = [tuple(map(int, m)) for m in re.findall(
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", report)]
    parts = [f"{name}: {r} registers, {st} B cumulative stack" for name, r, st in regs]
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
    from lodestar_tpu_torch.bls.rand import make_rand_words
    from lodestar_tpu_torch.bls.verifier import TorchBlsVerifier, VerifyOptions
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
        pks, sets, kinds, truth, valid_sets = make_job(pool)
        build.result()
    log(f"setup: kernels built and data made in {time.perf_counter() - t:.1f} s "
        f"({sum(1 for k in kinds if k == 'valid')} valid of {len(sets)}; "
        f"ground truth {sum(truth)} True; {len(valid_sets)} untampered sets all True)")
    for name, report in B.ptxas_report().items():
        log(f"ptxas {name}.cu: {ptxas_summary(report)}")
    for kind, ok in zip(kinds, truth):
        if ok != (kind == "valid"):
            raise AssertionError(f"ground truth disagrees with construction for a {kind} set")
    if kinds[BAD_SET] != "wrong_message" or truth[BAD_SET]:
        raise AssertionError("the bisection job's bad set is not a failing wrong-message set")

    dev = torch.device("cuda")
    table = PubkeyTable()
    table.register_points_unchecked(pks, tile_to=TABLE_ROWS)
    tx, ty = table.device_planes(dev)
    torch.cuda.synchronize()
    log(f"setup: pubkey table {len(table)} rows, {table.nbytes} bytes on {torch.cuda.get_device_name(0)}")
    verifier = TorchBlsVerifier(table, rng=np.random.default_rng(SEED))  # device None -> the CUDA device

    # -- 2. kernel phases --------------------------------------------------------
    results = {}  # (name, n) -> (kernel ms, plain ms, max abs err)

    def plain_and_kernel(name, n, kernel, plain, *args):
        k_ms, k_out = cuda_ms(lambda: kernel(*args))
        p_ms, p_out = cuda_ms(lambda: plain(*args), PLAIN_RUNS)
        k_outs = k_out if isinstance(k_out, tuple) else (k_out,)
        p_outs = p_out if isinstance(p_out, tuple) else (p_out,)
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(k_outs, p_outs))
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(k_outs, p_outs)):
            raise AssertionError(f"{name} at N={n}: kernel differs from plain version (max {err})")
        results[name, n] = (k_ms, p_ms, err)
        log(f"kernel {name} N={n}: equal to plain bit for bit; kernel {k_ms:.3f} ms (median of {TIMED_RUNS}), "
            f"plain {p_ms:.3f} ms (median of {PLAIN_RUNS}) (CUDA events)")
        return k_out

    for n in JOBS:
        # the per-set path's kernels on the mixed job
        planes, idx, sig_inf, valid = verifier._prepare(sets[:n])
        m = plain_and_kernel("mont_convert", n, KV.mont_convert, KV.mont_convert_plain, planes)
        msg, sig = m[:4].reshape(2, 2, LY.NL, n), m[4:].reshape(2, 2, LY.NL, n)
        ops = KV.each_operands(tx, ty, idx, msg, sig, sig_inf != 0, valid)
        sub = plain_and_kernel("g2_subgroup_check", n, KV.g2_subgroup_check, KV.g2_subgroup_check_plain,
                               *ops["sub"])
        f1 = plain_and_kernel("miller_loop", n, KV.miller_loop, KV.miller_loop_plain, *ops["miller_pk"])
        f2 = KV.miller_loop(*ops["miller_sig"])
        if not torch.equal(f2, KV.miller_loop_plain(*ops["miller_sig"])):
            raise AssertionError(f"miller_loop (-G1, sig) at N={n}: kernel differs from plain version")
        ok = plain_and_kernel("each_final", n, KV.each_final, KV.each_final_plain, ops["live_row"], f1, f2)
        log(f"kernel outputs N={n}: {int(sub.sum())} lanes in G2, {int(ok.sum())} final exps equal to one")

        # the RLC batch path's kernels on the all-valid job
        planes, idx, sig_inf, valid = verifier._prepare(valid_sets[:n])
        m = KV.mont_convert(planes)
        msg, sig = m[:4].reshape(2, 2, LY.NL, n), m[4:].reshape(2, 2, LY.NL, n)
        rwords = torch.from_numpy(make_rand_words(n, np.random.default_rng(SEED + n))).to(dev)
        ops = KV.batch_operands(tx, ty, idx, msg, sig, sig_inf != 0, valid, rwords)
        rpk, _ = plain_and_kernel("g1_rpk", n, KV.g1_rpk, KV.g1_rpk_plain, *ops["g1_rpk"])
        rsig, rsig_inf, sub = plain_and_kernel("g2_rsig_sub", n, KV.g2_rsig_sub, KV.g2_rsig_sub_plain,
                                               *ops["g2_rsig_sub"])
        excl = (~ops["live"])[None, :].to(torch.int32) | rsig_inf
        jsum, jsum_inf = plain_and_kernel("sum_g2", n, KV.sum_g2, KV.sum_g2_plain, rsig, excl)
        fprod = plain_and_kernel("prod12", n, KV.prod12, KV.prod12_plain, ops["live_row"],
                                 KV.miller_loop(rpk, ops["msg"]))
        a, a_inf = plain_and_kernel("affine_g2", n, KV.affine_g2, KV.affine_g2_plain, jsum, jsum_inf)
        fa = plain_and_kernel("miller_loop_1", n, KV.miller_loop, KV.miller_loop_plain, KV._neg_g1(dev, 1), a)
        ok = plain_and_kernel("final_one", n, KV.final_one, KV.final_one_plain, a_inf, fprod, fa)
        if int(ok[0, 0]) != 1 or int(a_inf[0, 0]) != 0 or not bool(sub.all()):
            raise AssertionError(f"batch kernels at N={n}: the all-valid job does not verify")
        log(f"kernel outputs N={n}: all-valid batch: {int(sub.sum())} lanes in G2, aggregate finite, "
            f"final exp of the product equal to one")

    # -- 3. main paths -------------------------------------------------------------
    def counted(fn):
        """fn() with every launch count set to 0 just before; (result, counts)."""
        torch.cuda.synchronize()
        KV.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(KV.LAUNCHES)

    def host_ms(fn, runs=3):
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return statistics.median(times) * 1e3

    def breakdown(label, n, job, ms, counts, kernel_names):
        prep = host_ms(lambda: verifier._prepare(job))
        kern = 0.0
        for k in kernel_names:
            per = results[k, n][0]
            if k == "miller_loop" and label == "batch":  # one N-lane and one 1-lane launch
                per = (results[k, n][0] + results["miller_loop_1", n][0]) / 2
            kern += per * counts[k]
        log(f"breakdown {label} N={n}: job {ms:.3f} ms = host preparation (encode + copy to the card) "
            f"{prep:.3f} ms + kernels {kern:.3f} ms (kernel-phase medians x launches) + the rest "
            f"{ms - prep - kern:.3f} ms")

    paths = {}  # (path, n) -> launch counts
    batchable = VerifyOptions(batchable=True)
    for n in JOBS:
        # the per-set path (PR 1's main path)
        job, want = sets[:n], truth[:n]
        verifier.verify_signature_sets_individually(job)  # warm-up
        got, counts = counted(lambda: verifier.verify_signature_sets_individually(job))
        if got != want:
            bad = [(i, kinds[i], g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"N={n}: {len(bad)} verdicts differ from the ground truth: {bad[:8]}")
        if min(counts[k] for k in PER_SET) == 0:
            raise AssertionError(f"N={n}: a kernel of the per-set path was never launched: {counts}")
        if verifier.verify_signature_sets(job) != all(want):
            raise AssertionError(f"N={n}: verify_signature_sets gave the wrong verdict")
        if not verifier.verify_signature_sets([s for s, w in zip(job, want) if w]):
            raise AssertionError(f"N={n}: verify_signature_sets rejected the valid sets")
        ms = host_ms(lambda: verifier.verify_signature_sets_individually(job))
        log(f"main path per-set N={n}: {sum(got)} of {n} True, every verdict equals the ground truth; "
            f"launches {json.dumps(counts)}; verify_signature_sets_individually {ms:.1f} ms = "
            f"{n / ms * 1e3:.1f} sets/s (host clock, median of 3 after a warm-up)")
        breakdown("per-set", n, job, ms, counts, PER_SET)
        paths["per_set", n] = counts
        results["sets_per_s", "per_set", n] = n / ms * 1e3

        # the RLC batch path (the system's main path)
        job = valid_sets[:n]
        verifier.verify_signature_sets(job, batchable)  # warm-up
        ok, counts = counted(lambda: verifier.verify_signature_sets(job, batchable))
        if ok is not True:
            raise AssertionError(f"N={n}: the all-valid batch was rejected")
        if counts["miller_loop"] != 2 or counts["final_one"] != 1 or counts["each_final"] != 0:
            raise AssertionError(f"N={n}: the batch did not run as one multi-pairing: {counts}")
        if min(counts[k] for k in BATCH) == 0:
            raise AssertionError(f"N={n}: a kernel of the batch path was never launched: {counts}")
        ms = host_ms(lambda: verifier.verify_signature_sets(job, batchable))
        log(f"main path batch N={n}: accepted {n} of {n} valid sets as one RLC batch; launches "
            f"{json.dumps(counts)}; verify_signature_sets(batchable=True) {ms:.1f} ms = {n / ms * 1e3:.1f} "
            f"sets/s (host clock, median of 3 after a warm-up)")
        breakdown("batch", n, job, ms, counts, BATCH)
        paths["batch", n] = counts
        results["sets_per_s", "batch", n] = n / ms * 1e3

        # the mixed job sent batchable: a job holding an infinity signature
        # must go straight to per-set verdicts
        if not any(s.signature is None for s in sets[:n]):
            raise AssertionError(f"N={n}: the mixed job holds no infinity signature")
        ok, counts = counted(lambda: verifier.verify_signature_sets(sets[:n], batchable))
        if ok is not False or counts["each_final"] != 1 or counts["final_one"] != 0:
            raise AssertionError(f"N={n}: the mixed batchable job did not go per set: {ok}, {counts}")
        log(f"main path mixed-batchable N={n}: False, routed per set (launches {json.dumps(counts)})")

    # the bisection: the all-valid 512-set job with one wrong message
    n = JOBS[-1]
    bad_job = list(valid_sets[:n])
    bad_job[BAD_SET] = sets[BAD_SET]
    want = [i != BAD_SET for i in range(n)]
    t = time.perf_counter()
    job, counts = counted(lambda: verifier.begin_job(bad_job, batchable=True))
    ok = verifier.finish_job(job)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t) * 1e3
    counts = dict(KV.LAUNCHES)
    if ok is not False or job.verdicts.tolist() != want:
        raise AssertionError(f"bisection: verdict {ok}, {int((job.verdicts != want).sum())} per-set verdicts wrong")
    leaf = verifier.bisect_leaf
    if job.bisect_depth < 2 or job.batch_retries != 1 or job.batch_sigs_success != n - leaf:
        raise AssertionError(f"bisection: depth {job.bisect_depth}, retries {job.batch_retries}, "
                             f"cleared {job.batch_sigs_success}")
    if verifier.verify_signature_sets_individually(bad_job) != want:
        raise AssertionError("bisection job: per-set verdicts differ from the ground truth")
    if verifier.verify_signature_sets(bad_job, batchable) is not False:
        raise AssertionError("bisection job: verify_signature_sets accepted a job with a bad set")
    log(f"main path bisection N={n}: one wrong message at set {BAD_SET}: batch rejected, bisected "
        f"{n} -> {n // 2} -> ... -> {leaf} (depth {job.bisect_depth}), {job.batch_sigs_success} sets cleared by "
        f"passing halves, the {leaf}-set leaf verified per set; every verdict equals the ground truth; "
        f"launches {json.dumps(counts)}; {dt:.1f} ms (host clock, one run)")

    if not verifier._device_canary():
        raise AssertionError("device canary failed")

    # -- 4. result lines -----------------------------------------------------------
    imad_per_ms = N_SM * IMAD_PER_CLK_PER_SM * sm_mhz * 1e3
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path = "batch" if name in BATCH else "per_set"
        k_ms, p_ms, err = results[name, n]
        # units of FP_MULS_PER_LANE and lanes of BYTES_PER_LANE in one launch
        if name in TAIL:
            units = lanes = 1
        elif name in ("sum_g2", "prod12"):
            units, lanes = n - 1, n  # N - 1 combines
        elif name == "mont_convert":
            units, lanes = 8 * n, n  # 8 planes per lane
        else:
            units = lanes = n
        ops_ms = KV.FP_MULS_PER_LANE[name] * KV.IMAD_PER_FP_MUL * units / imad_per_ms
        nbytes = BYTES_PER_LANE[name] * lanes + BYTES_PER_LAUNCH.get(name, 0)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[path, n][name], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "path": path, "n": n,
            "launches_by_path": {p: paths[p, n][name] for p in ("per_set", "batch")},
            "ms_n128": results[name, JOBS[0]][0], "plain_ms_n128": results[name, JOBS[0]][1],
        }
        if name == "miller_loop":
            entry["ms_1_lane"], entry["plain_ms_1_lane"] = results["miller_loop_1", n][:2]
        kernels.append(entry)
    log("main path sets/s: " + ", ".join(
        f"{p} N={j}: {results['sets_per_s', p, j]:.1f}" for p in ("per_set", "batch") for j in JOBS)
        + f" ({card}); total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
