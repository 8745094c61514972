#!/usr/bin/env python3
"""Smoke run of lodestar_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero without one.  In order:

  1. setup: the card's name and power limit; build every CUDA kernel from
     the sources in this checkout (one nvcc per source, all at once); make
     64 keypairs, 8 signing roots hashed to G2 and 512 signatures from a
     fixed seed with the port's own crypto/ copy; the 1,048,576-row pubkey
     table registered from compressed keys (row r holds key r % 64) by
     `PubkeyTable.register_compressed`, 16 KeyValidate launches of 65,536
     lanes, its planes equal to the unchecked table's, and a 128-key job
     with one key of each fault kind rejected at the first fault's
     position, leaving its table empty; a 512-set job mixing
     valid sets, wrong messages, swapped signatures, signatures at infinity
     and on-curve signatures outside G2, and the all-valid job of the same
     512 untampered signatures; their wire forms (96-byte compressed
     signatures, crypto/curves.py g2_compress), the mixed job in bytes with
     four wire-only faults (95 bytes, no compression bit, x >= p, an x with
     no y); 256 aggregate sets of K = 128 distinct table rows over one root
     (BASELINE.json config 2) and 4 sets of K = 512 (a sync committee), one
     of them missing a signer; the host ground truth (crypto/bls.py verify
     and fast_aggregate_verify) of every set;
  2. kernel phases: each of the seventeen kernel rows against its plain
     torch version on the same device inputs, bit for bit: the per-set
     path's four on the mixed job's operands and the RLC batch path's six
     (and the one-lane Miller loop of its tail) on the all-valid job's;
     mont_convert on the 4 message planes and g2_decompress of the wire
     mixed job, at N = 128 and N = 512; agg_pk on the K = 128 job (N = 256,
     K bucket 512) and hash_g2 on one 128-lane batch of the 8 roots;
     g1_keyvalidate on one 65,536-key registration chunk and on the fault
     job with 128 valid keys; seg_sum_g1 on the grouped wire batch's
     randomized pubkeys (N = 128 and 512) and seg_sum_g2 on the 128 and
     512 decompressed signatures grouped by root; the warp-per-lane pairing
     kernels at every lane count the paths give them: miller_loop at 1,
     128, 129 and 512 lanes, each_final and final_one at 1, 128 and 512,
     every verdict held against the ground truth, with the shape of each
     one's N = 512 launch as its library reports it (threads and lanes per
     block, dynamic shared memory, slots, phases and rounds per lane) and
     its ptxas figures, the same for the warp-per-lane g2_rsig_sub; agg_pk
     (one block per set) also on the K = 512 job, with its launch as its
     library reports it (blocks, threads, shared memory, tree levels).
     CUDA-event times of
     kernel (median of 5 after a warm-up) and plain version (median of 3;
     once, without a warm-up, for agg_pk, hash_g2, g1_keyvalidate and the
     warp kernels' extra lane counts, whose plain versions take seconds);
  3. main paths, each driven with the launch counts set to 0 just before
     and read just after, every verdict held against the ground truth and
     every job's host-routed set count (`job.host_sets`) 0: decoded per
     set, RLC batch, bisection and mixed-batchable; a cold
     MessageCache (one hash_g2 launch for the 8 roots, the points equal to
     crypto/hash_to_curve.py hash_to_g2, a second lookup launches
     nothing); the wire batch, wire per set, wire mixed-batchable and wire
     bisection, every wire batch through the message-grouped entry (one
     seg_sum_g1 scan, one 128-lane Miller tile; the same job timed through
     the ungrouped entry too, in turns); a wire job of 8 distinct roots
     through the ungrouped entry; the aggregate batch (256 x K = 128:
     one grouped RLC batch through agg_pk) and the K = 512 job (rejected,
     then retried per set); pre-verify aggregation of the 512 wire
     signatures by root (one 512-lane dispatch, every aggregate equal to
     the host's bytes; a group with a 95-byte member gives None), then the
     8 merged K = 64 sets verified as one batch; the grouped wire batch at
     N = 1024 and 2048 (the 512 signatures repeated, one job each), with
     each kernel's CUDA-event time inside the path and each of its kernel
     calls held against the plain version on the same inputs; sets/s and
     a breakdown for each timed path;
  4. one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.

Any mismatch or error raises, and the script exits non-zero.
"""

from __future__ import annotations

import ctypes
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
WIDE_JOBS = (1024, 2048)  # the grouped wire batch at the larger N buckets, its kernel calls held in the path
TIMED_RUNS = 5
PLAIN_RUNS = 3
BAD_SET = 323  # a wrong-message set of the mixed job (323 % 16 == 3)
# wire-only faults of the wire mixed job, at positions that are valid sets
# in the decoded pattern (inside the first 128 sets)
WIRE_FAULTS = {1: "95_bytes", 2: "no_compression_bit", 5: "x_not_below_p", 6: "x_off_curve"}
AGG_SETS, AGG_K = 256, 128  # BASELINE.json config 2: 1 signature over 128 pubkeys
SYNC_SETS, SYNC_K = 4, 512  # a block's sync-committee aggregate
SYNC_MISSING = 2  # the K = 512 set whose signature leaves out one signer
REG_CHUNK = 65536  # keys per KeyValidate launch at registration (register_compressed's device_batch)
# fault keys of the 128-key rejection job, at these positions among valid keys
KEY_FAULTS = {5: "infinity", 17: "x_off_curve", 29: "outside_G1", 41: "x_zero_order_3", 53: "x_not_below_p",
              77: "no_compression_bit", 101: "47_bytes"}

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
    "mont_convert_4": ("lodestar_tpu_torch/kernels/csrc/mont.cu", "lodestar_tpu/kernels/verify.py:454"),
    "g2_decompress": ("lodestar_tpu_torch/kernels/csrc/ingest.cu", "lodestar_tpu/kernels/ingest.py:247"),
    "agg_pk": ("lodestar_tpu_torch/kernels/csrc/aggpk.cu", "lodestar_tpu/kernels/verify.py:246"),
    "hash_g2": ("lodestar_tpu_torch/kernels/csrc/ingest.cu", "lodestar_tpu/kernels/ingest.py:219"),
    "g1_keyvalidate": ("lodestar_tpu_torch/kernels/csrc/keyvalidate.cu", "lodestar_tpu/kernels/ingest.py:309"),
    "seg_sum_g1": ("lodestar_tpu_torch/kernels/csrc/segsum.cu", "lodestar_tpu/kernels/verify.py:686"),
    "seg_sum_g2": ("lodestar_tpu_torch/kernels/csrc/segsum.cu", "lodestar_tpu/kernels/verify.py:845"),
}
PER_SET = ("mont_convert", "g2_subgroup_check", "miller_loop", "each_final")
BATCH = ("mont_convert", "g1_rpk", "g2_rsig_sub", "sum_g2", "miller_loop", "prod12", "affine_g2", "final_one")
WIRE_PER_SET = ("mont_convert_4", "g2_decompress", "g2_subgroup_check", "miller_loop", "each_final")
WIRE_BATCH = ("mont_convert_4", "g2_decompress") + BATCH[1:]
GROUPED_BATCH = WIRE_BATCH + ("seg_sum_g1",)  # a wire batch with a repeated root
AGG_BATCH = GROUPED_BATCH + ("agg_pk",)
PREAGG = ("g2_decompress", "seg_sum_g2", "affine_g2")
TAIL = ("affine_g2", "final_one")  # one lane per launch on the batch path
# the kernel wrappers of kernels/verify.py that the grouped wire batch calls
# (mont_convert there on the 4 message planes)
GROUPED_WRAPPERS = ("mont_convert", "g2_decompress", "g1_rpk", "g2_rsig_sub", "sum_g2", "seg_sum_g1", "miller_loop",
                    "prod12", "affine_g2", "final_one")
# lane counts of the warp-per-lane pairing kernels' own phase: the tail's
# one lane, the 128-lane tile, one lane past it, N = 512
WARP_LANES = (1, 128, 129, 512)
FINAL_LANES = (1, 128, 512)
# the path whose launch count is a row's "launches", and its lanes
MAIN_PATH = {name: ("batch" if name in BATCH else "per_set", JOBS[-1]) for name in KERNELS}
MAIN_PATH.update({"mont_convert_4": ("wire_batch", JOBS[-1]), "g2_decompress": ("wire_batch", JOBS[-1]),
                  "agg_pk": ("agg_batch", AGG_SETS), "hash_g2": ("cold_hash", 128),
                  "g1_keyvalidate": ("registration", REG_CHUNK), "seg_sum_g1": ("wire_batch", JOBS[-1]),
                  "seg_sum_g2": ("preagg", JOBS[-1])})
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
    "mont_convert_4": 4 * 48 * 2,
    "g2_decompress": (2 * 48 + 8) + (4 * 48 + 4),
    "hash_g2": (4 * 48 + 8) + (6 * 48 + 4),
    "g1_keyvalidate": (48 + 8) + (2 * 48 + 4),
    "seg_sum_g1": (3 * 48 + 8) + (3 * 48 + 4),  # Jacobian in and out, dead flag and group id
    "seg_sum_g2": (4 * 48 + 8) + (6 * 48 + 4),  # affine in, Jacobian out
    # agg_pk: its live rows of 96 bytes and K index and mask words in,
    # 148 bytes out (counted from the job's kmask)
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


def _aggregate_truth(args):
    from lodestar_tpu_torch.crypto import bls as GB

    keys, root, sig = args
    return GB.fast_aggregate_verify(keys, root, sig)


def _decompress(sig: bytes):
    """(decodable, point) by crypto/curves.py g2_decompress."""
    from lodestar_tpu_torch.crypto import curves as GC

    try:
        return True, GC.g2_decompress(sig)
    except ValueError:
        return False, None


def make_job(pool) -> dict:
    """Keys, roots, signatures, the mixed 512-set job and its ground truth,
    the all-valid job of the 512 untampered signatures, their wire forms
    and the aggregate jobs."""
    from lodestar_tpu_torch.bls.signature_set import SignatureSet, WireSignatureSet
    from lodestar_tpu_torch.crypto import bls as GB
    from lodestar_tpu_torch.crypto import curves as GC
    from lodestar_tpu_torch.crypto import fields as GT
    from lodestar_tpu_torch.crypto import hash_to_curve as GH

    rng = np.random.default_rng(SEED)
    sks = [GB.keygen(rng.bytes(32)) for _ in range(N_KEYS)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    roots = [rng.bytes(32) for _ in range(N_ROOTS)]
    hs = [GH.hash_to_g2(r) for r in roots]
    n = JOBS[-1]
    # aggregates: distinct table rows (row r holds key r % 64); the
    # signature is sum_k c_k sig_k, c_k the count of key k among the rows
    agg_rows = [rng.choice(TABLE_ROWS, AGG_K, replace=False) for _ in range(AGG_SETS)]
    sync_rows = [rng.choice(TABLE_ROWS, SYNC_K, replace=False) for _ in range(SYNC_SETS)]
    sync_signed = [rows[1:] if j == SYNC_MISSING else rows for j, rows in enumerate(sync_rows)]

    def scalar(rows):
        return sum(sks[r % N_KEYS] for r in rows.tolist()) % GT.R

    # set i: key i % 64 signs root i // 64 (512 distinct signatures)
    sigs = pool.map(_sign, [(sks[i % N_KEYS], hs[i // N_KEYS]) for i in range(n)]
                    + [(scalar(rows), hs[0]) for rows in agg_rows]
                    + [(scalar(rows), hs[1]) for rows in sync_signed])
    sigs, agg_sigs, sync_sigs = sigs[:n], sigs[n:n + AGG_SETS], sigs[n + AGG_SETS:]
    outside = []
    for j in range(4):
        u = GH.hash_to_field_fp2(b"outside-G2-%d" % j, 1, b"chip-smoke")[0]
        pt = GH.map_to_curve_svdw(GC.FP2_OPS, u)
        assert GC.is_on_curve(GC.FP2_OPS, pt) and not GC.g2_subgroup_check(pt)
        outside.append(pt)
    rows = rng.integers(0, TABLE_ROWS // N_KEYS, size=n) * N_KEYS
    sets, kinds, gt_args, valid_sets, extra, msg_roots = [], [], [], [], [], []
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
        msg_roots.append(msg_r)
        gt_args.append((pks[k], roots[msg_r], sig))
        if kind != "valid":  # the untampered set is not in the mixed job
            extra.append((pks[k], roots[r], sigs[i]))
    agg_args = [([pks[r % N_KEYS] for r in rows.tolist()], roots[0], sig) for rows, sig in zip(agg_rows, agg_sigs)]
    agg_args += [([pks[r % N_KEYS] for r in rows.tolist()], roots[1], sig) for rows, sig in zip(sync_rows, sync_sigs)]
    truth_async = pool.map_async(_ground_truth, gt_args + extra)
    agg_async = pool.map_async(_aggregate_truth, agg_args)

    # the wire forms
    c = GC.g2_compress
    wire_valid = [WireSignatureSet.single(s.indices[0], roots[i // N_KEYS], c(sigs[i]))
                  for i, s in enumerate(valid_sets)]
    wire_mixed = [WireSignatureSet.single(s.indices[0], roots[msg_roots[i]], c(s.signature))
                  for i, s in enumerate(sets)]
    wire_kinds = list(kinds)
    while True:  # a well-formed x with no y on E2, by trial from the seed
        x = tuple(int.from_bytes(rng.bytes(48), "big") % GT.P for _ in range(2))
        if GT.fp2_sqrt(GT.fp2_add(GT.fp2_mul(GT.fp2_sqr(x), x), GC.FP2_OPS.b_coeff)) is None:
            break
    off = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    off[0] |= 0x80
    for i, fault in WIRE_FAULTS.items():
        assert kinds[i] == "valid"
        good = wire_mixed[i].signature
        sig = {
            "95_bytes": good[:95],
            "no_compression_bit": bytes([good[0] & 0x7F]) + good[1:],
            "x_not_below_p": bytes([good[0] | 0x1F]) + b"\xff" * 47 + good[48:],
            "x_off_curve": bytes(off),
        }[fault]
        wire_mixed[i] = WireSignatureSet.single(wire_mixed[i].indices[0], wire_mixed[i].signing_root, sig)
        wire_kinds[i] = fault
    decoded = pool.map(_decompress, [s.signature for s in wire_mixed])
    wire_agg = [WireSignatureSet.aggregate(rows.tolist(), roots[0], c(sig)) for rows, sig in zip(agg_rows, agg_sigs)]
    wire_sync = [WireSignatureSet.aggregate(rows.tolist(), roots[1], c(sig))
                 for rows, sig in zip(sync_rows, sync_sigs)]

    truth = truth_async.get()
    if not all(truth[n:]):
        raise AssertionError("an untampered signature fails the ground truth")
    truth = truth[:n]
    # the wire mixed job: what crypto/curves.py decodes is the decoded
    # job's signature, whose verdict is known; what it refuses is False
    wire_truth = []
    for i, (ok, pt) in enumerate(decoded):
        if ok and pt != sets[i].signature:
            raise AssertionError(f"wire set {i} does not decode to the decoded job's signature")
        wire_truth.append(ok and truth[i])
    if [not ok for ok, _ in decoded] != [i in WIRE_FAULTS for i in range(n)]:
        raise AssertionError("the wire-only faults are not exactly the undecodable wire sets")
    agg_truth = agg_async.get()

    # compressed pubkeys, and the 128-key job with one key of each fault kind
    comp = [GC.g1_compress(pk) for pk in pks]
    x_off = x_out = None
    while x_off is None or x_out is None:  # an x with no y on E1, an x on E1 outside G1, by trial
        x = int.from_bytes(rng.bytes(48), "big") % GT.P
        y = GT.fp_sqrt((x * x * x + 4) % GT.P)
        if y is None:
            x_off = x_off if x_off is not None else x
        elif x_out is None and not GC.g1_subgroup_check((x, y)):
            x_out = x

    def x_key(x):
        out = bytearray(x.to_bytes(48, "big"))
        out[0] |= 0x80
        return bytes(out)

    rej_keys = [comp[i % N_KEYS] for i in range(128)]
    for i, fault in KEY_FAULTS.items():
        rej_keys[i] = {
            "infinity": GC.g1_compress(None),
            "x_off_curve": x_key(x_off),
            "outside_G1": x_key(x_out),
            "x_zero_order_3": x_key(0),
            "x_not_below_p": bytes([0x9F]) + b"\xff" * 47,
            "no_compression_bit": bytes([rej_keys[i][0] & 0x7F]) + rej_keys[i][1:],
            "47_bytes": rej_keys[i][:47],
        }[fault]
    return dict(
        pks=pks, roots=roots, hs=hs, sets=sets, kinds=kinds, truth=truth, valid_sets=valid_sets,
        wire_valid=wire_valid, wire_mixed=wire_mixed, wire_kinds=wire_kinds, wire_truth=wire_truth,
        wire_agg=wire_agg, agg_truth=agg_truth[:AGG_SETS], wire_sync=wire_sync, sync_truth=agg_truth[AGG_SETS:],
        comp=comp, rej_keys=rej_keys,
    )


# -- timing -------------------------------------------------------------------


def cuda_ms(fn, runs: int = TIMED_RUNS, warm: bool = True):
    """Median CUDA-event time of fn() over `runs` runs, after one warm-up
    unless `warm` is False; returns (ms, the first result)."""
    out = None
    if warm:
        out = fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        out = res if out is None else out
    return statistics.median(times), out


def ptxas_entries(report: str) -> dict:
    """Per kernel entry of a ptxas -v log: registers, static shared memory,
    cumulative stack (0 where ptxas prints none), and the largest stack
    frame and spills of its block of the log."""
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        stack = re.search(r"(\d+) bytes cumulative stack size", block)
        frames = [tuple(map(int, m)) for m in re.findall(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", block)]
        out[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
            "stack_bytes": int(stack.group(1)) if stack else 0,
            "stack_frame_bytes": max((f[0] for f in frames), default=0),
            "spill_bytes": max((f[1] + f[2] for f in frames), default=0),
        }
    return out


def ptxas_summary(report: str) -> str:
    return "; ".join(
        f"{name}: {e['registers']} registers, {e['static_smem_bytes']} B static shared, {e['stack_bytes']} B "
        f"cumulative stack, largest frame {e['stack_frame_bytes']} B, spills {e['spill_bytes']} B"
        for name, e in ptxas_entries(report).items())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2

    from lodestar_tpu_torch.bls.ingest import MessageCache, encode_pubkey_planes
    from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
    from lodestar_tpu_torch.bls.rand import make_rand_words
    from lodestar_tpu_torch.bls.signature_set import WireSignatureSet
    from lodestar_tpu_torch.bls.verifier import K_BUCKETS, N_BUCKETS, TorchBlsVerifier, VerifyOptions
    from lodestar_tpu_torch.crypto import bls as GB
    from lodestar_tpu_torch.crypto import curves as GC
    from lodestar_tpu_torch.crypto import hash_to_curve as GH
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
        d = make_job(pool)
        build.result()
    sets, kinds, truth, valid_sets = d["sets"], d["kinds"], d["truth"], d["valid_sets"]
    wire_valid, wire_mixed, wire_truth = d["wire_valid"], d["wire_mixed"], d["wire_truth"]
    log(f"setup: kernels built and data made in {time.perf_counter() - t:.1f} s "
        f"({sum(1 for k in kinds if k == 'valid')} valid of {len(sets)}; "
        f"ground truth {sum(truth)} True; {len(valid_sets)} untampered sets all True; wire mixed job "
        f"{sum(wire_truth)} True with faults {sorted(WIRE_FAULTS.values())}; {AGG_SETS} aggregates of K = {AGG_K}: "
        f"{sum(d['agg_truth'])} True; {SYNC_SETS} of K = {SYNC_K}: {d['sync_truth']})")
    ptxas = B.ptxas_report()
    for name, report in ptxas.items():
        log(f"ptxas {name}.cu: {ptxas_summary(report)}")
    warp_info = {}  # the warp-per-lane kernels' schedules and ptxas figures
    for kind, ok in zip(kinds, truth):
        if ok != (kind == "valid"):
            raise AssertionError(f"ground truth disagrees with construction for a {kind} set")
    if kinds[BAD_SET] != "wrong_message" or truth[BAD_SET]:
        raise AssertionError("the bisection job's bad set is not a failing wrong-message set")
    if not all(d["agg_truth"]) or d["sync_truth"] != [j != SYNC_MISSING for j in range(SYNC_SETS)]:
        raise AssertionError("the aggregate jobs' ground truth disagrees with construction")

    dev = torch.device("cuda")
    paths = {}  # (path, n) -> launch counts

    def counted(fn):
        """fn() with every launch count set to 0 just before; (result, counts)."""
        torch.cuda.synchronize()
        KV.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(KV.LAUNCHES)

    # -- registration: the 1M-row table from compressed keys, KeyValidate on the card
    keys = [d["comp"][r % N_KEYS] for r in range(TABLE_ROWS)]
    t = time.perf_counter()
    reg_planes, reg_flags, reg_bad = encode_pubkey_planes(keys[:REG_CHUNK])
    encode_ms = (time.perf_counter() - t) * 1e3
    table = PubkeyTable()
    t = time.perf_counter()
    idx, counts = counted(lambda: table.register_compressed(keys, device_batch=REG_CHUNK))
    reg_s = time.perf_counter() - t
    unchecked = PubkeyTable()
    unchecked.register_points_unchecked(d["pks"], tile_to=TABLE_ROWS)
    same = all(np.array_equal(getattr(table, a)[:, :TABLE_ROWS], getattr(unchecked, a)[:, :TABLE_ROWS])
               for a in ("_host_x", "_host_y"))
    if idx != list(range(TABLE_ROWS)) or not same or reg_bad.any():
        raise AssertionError(f"registration: {len(idx)} rows, planes equal to the unchecked table: {same}")
    if counts["g1_keyvalidate"] != TABLE_ROWS // REG_CHUNK or sum(counts.values()) != counts["g1_keyvalidate"]:
        raise AssertionError(f"registration: launches {counts}")
    paths["registration", REG_CHUNK] = counts
    log(f"main path registration: PubkeyTable.register_compressed of {TABLE_ROWS} compressed keys: "
        f"{counts['g1_keyvalidate']} g1_keyvalidate launches of {REG_CHUNK} lanes; every row equals "
        f"register_points_unchecked's planes bit for bit; {reg_s * 1e3:.1f} ms = {TABLE_ROWS / reg_s:.1f} keys/s "
        f"(host clock, one run: host encoding, copies and the kernel); host encoding {encode_ms:.1f} ms per "
        f"{REG_CHUNK}-key chunk (encode_pubkey_planes, numpy)")
    rej_table = PubkeyTable()
    first = min(KEY_FAULTS)
    try:
        rej_table.register_compressed(d["rej_keys"])
        raise AssertionError("registration: the fault job was accepted")
    except ValueError as e:
        if f"pubkey {first} " not in str(e) or len(rej_table):
            raise AssertionError(f"registration: fault job raised {e!r} with {len(rej_table)} rows committed")
        rej_msg = str(e)
    rej_planes, rej_flags, rej_bad = encode_pubkey_planes(d["rej_keys"])
    _, rej_ok = KV.g1_keyvalidate(torch.from_numpy(rej_planes).to(dev), torch.from_numpy(rej_flags).to(dev))
    refused = np.flatnonzero(~((rej_ok[0].cpu().numpy() != 0) & ~rej_bad)).tolist()
    if refused != sorted(KEY_FAULTS):
        raise AssertionError(f"registration: keys refused at {refused}, faults at {sorted(KEY_FAULTS)}")
    log(f"main path registration-faults: 128 keys with faults {KEY_FAULTS}: register_compressed raised "
        f"'{rej_msg}' and committed no row; refused exactly at the fault positions ({int(rej_bad.sum())} on the "
        f"host, {len(refused) - int(rej_bad.sum())} by the kernel)")
    t = time.perf_counter()
    tx, ty = table.device_planes(dev)
    torch.cuda.synchronize()
    log(f"setup: pubkey table {len(table)} rows, {table.nbytes} bytes on {torch.cuda.get_device_name(0)} "
        f"(copied to the card in {(time.perf_counter() - t) * 1e3:.1f} ms)")
    verifier = TorchBlsVerifier(table, rng=np.random.default_rng(SEED))  # device None -> the CUDA device
    jobs_begun = []  # every job the verifier begins: none may route a set to the host
    begin_job = verifier.begin_job

    def recording_begin_job(job_sets, batchable):
        job = begin_job(job_sets, batchable)
        jobs_begun.append(job)
        return job

    verifier.begin_job = recording_begin_job

    # -- 2. kernel phases --------------------------------------------------------
    results = {}  # (name, n) -> (kernel ms, plain ms, max abs err)

    def plain_and_kernel(name, n, kernel, plain, *args, plain_runs=PLAIN_RUNS, tag=None):
        """plain_runs 0: the plain version timed once, without a warm-up;
        tag: a third key of the result (a row's extra shapes)."""
        k_ms, k_out = cuda_ms(lambda: kernel(*args))
        p_ms, p_out = cuda_ms(lambda: plain(*args), max(plain_runs, 1), warm=plain_runs > 0)
        k_outs = k_out if isinstance(k_out, tuple) else (k_out,)
        p_outs = p_out if isinstance(p_out, tuple) else (p_out,)
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(k_outs, p_outs))
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(k_outs, p_outs)):
            raise AssertionError(f"{name} at N={n}: kernel differs from plain version (max {err})")
        results[(name, n) if tag is None else (name, n, tag)] = (k_ms, p_ms, err)
        how = f"median of {plain_runs}" if plain_runs else "one run"
        log(f"kernel {name} N={n}: equal to plain bit for bit; kernel {k_ms:.3f} ms (median of {TIMED_RUNS}), "
            f"plain {p_ms:.3f} ms ({how}) (CUDA events)")
        return k_out

    # KeyValidate on one registration chunk (the main path's shape), and on
    # the fault job beside 128 valid keys
    kv_x, kv_flags = torch.from_numpy(reg_planes).to(dev), torch.from_numpy(reg_flags).to(dev)
    _, kv_ok = plain_and_kernel("g1_keyvalidate", REG_CHUNK, KV.g1_keyvalidate, KV.g1_keyvalidate_plain, kv_x,
                                kv_flags, plain_runs=0)
    kv_x = torch.from_numpy(np.concatenate([rej_planes, reg_planes[:, :128]], axis=1)).to(dev)
    kv_flags = torch.from_numpy(np.concatenate([rej_flags, reg_flags[:, :128]], axis=1)).to(dev)
    _, kv_ok256 = plain_and_kernel("g1_keyvalidate", 256, KV.g1_keyvalidate, KV.g1_keyvalidate_plain, kv_x,
                                   kv_flags, plain_runs=0)
    if not bool(kv_ok.all()) or int(kv_ok256.sum()) != 256 - len(KEY_FAULTS):
        raise AssertionError(f"g1_keyvalidate: {int(kv_ok.sum())} of {REG_CHUNK} keys valid, "
                             f"{int(kv_ok256.sum())} of 256 on the fault job")
    seg_units = {}  # name -> the additions the segmented sum needs on its row's data

    def seg_needed(dead, group):
        """Live lanes less live groups: one addition per live lane after its group's first."""
        live = dead[0] == 0
        return int(live.sum()) - int(torch.unique(group[live]).numel())

    for n in JOBS:
        # the per-set path's kernels on the mixed job
        idx, kmask, planes, sig_inf, valid = verifier._prepare(sets[:n])
        m = plain_and_kernel("mont_convert", n, KV.mont_convert, KV.mont_convert_plain, planes)
        msg, sig = m[:4].reshape(2, 2, LY.NL, n), m[4:].reshape(2, 2, LY.NL, n)
        ops = KV.each_operands(tx, ty, idx, kmask, msg, sig, sig_inf != 0, valid)
        sub = plain_and_kernel("g2_subgroup_check", n, KV.g2_subgroup_check, KV.g2_subgroup_check_plain,
                               *ops["sub"])
        f1 = plain_and_kernel("miller_loop", n, KV.miller_loop, KV.miller_loop_plain, *ops["miller_pk"])
        f2 = KV.miller_loop(*ops["miller_sig"])
        if not torch.equal(f2, KV.miller_loop_plain(*ops["miller_sig"])):
            raise AssertionError(f"miller_loop (-G1, sig) at N={n}: kernel differs from plain version")
        ok = plain_and_kernel("each_final", n, KV.each_final, KV.each_final_plain, ops["live_row"], f1, f2)
        log(f"kernel outputs N={n}: {int(sub.sum())} lanes in G2, {int(ok.sum())} final exps equal to one")
        pairing_ops = (ops["miller_pk"], ops["miller_sig"], ops["live_row"])

        # the RLC batch path's kernels on the all-valid job
        idx, kmask, planes, sig_inf, valid = verifier._prepare(valid_sets[:n])
        m = KV.mont_convert(planes)
        msg, sig = m[:4].reshape(2, 2, LY.NL, n), m[4:].reshape(2, 2, LY.NL, n)
        rwords = torch.from_numpy(make_rand_words(n, np.random.default_rng(SEED + n))).to(dev)
        ops = KV.batch_operands(tx, ty, idx, kmask, msg, sig, sig_inf != 0, valid, rwords)
        rpk, rpk_inf = plain_and_kernel("g1_rpk", n, KV.g1_rpk, KV.g1_rpk_plain, *ops["g1_rpk"])
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
            raise AssertionError(f"batch kernels at N={n}: the all-valid batch does not verify")
        log(f"kernel outputs N={n}: all-valid batch: {int(sub.sum())} lanes in G2, aggregate finite, "
            f"final exp of the product equal to one")
        # its grouped G1 side: the sets of a root are one run of 64 lanes
        group, head_lanes, glive = (torch.from_numpy(a).to(dev) for a in verifier._grouping(wire_valid[:n], n))
        gops = KV.grouped_operands(ops, rpk, rpk_inf, group, head_lanes, glive)
        pts, seg_inf = plain_and_kernel("seg_sum_g1", n, KV.seg_sum_g1, KV.seg_sum_g1_plain, *gops["seg_sum_g1"])
        seg_units["seg_sum_g1", n] = seg_needed(*gops["seg_sum_g1"][1:])
        g, q, live_row = KV._group_heads(pts, seg_inf, *gops["heads"])
        ok = KV._batch_tail(KV.prod12(live_row, KV.miller_loop(g, q)), jsum, jsum_inf)
        if int(ok[0, 0]) != 1 or int(live_row.sum()) != n // N_KEYS:
            raise AssertionError(f"grouped batch kernels at N={n}: not verified ({int(live_row.sum())} groups)")
        log(f"kernel outputs N={n}: grouped: {int(live_row.sum())} group totals on one {KV.BT}-lane Miller "
            f"tile, final exp of the product equal to one")

        # the wire paths' ingest: the message planes of the all-valid job
        # (4 planes) and the signatures of the wire mixed job
        args, _ = verifier._prepare_wire(wire_valid[:n])
        plain_and_kernel("mont_convert_4", n, KV.mont_convert, KV.mont_convert_plain, args.msg)
        args, host_bad = verifier._prepare_wire(wire_mixed[:n])
        _, dec_ok = plain_and_kernel("g2_decompress", n, KV.g2_decompress, KV.g2_decompress_plain,
                                     args.sig_x, args.sig_flags)
        off = [i for i in range(n) if dec_ok[0, i] == 0]
        if off != [i for i in WIRE_FAULTS if WIRE_FAULTS[i] == "x_off_curve"]:
            raise AssertionError(f"g2_decompress at N={n}: lanes off the curve {off}")
        log(f"kernel outputs N={n}: wire mixed job: {int(host_bad.sum())} encodings refused on the host, "
            f"{n - len(off)} lanes decompressed or flagged infinity, {len(off)} x off the curve")

    # pre-verify aggregation's scan: the first 128 and all 512 wire
    # signatures, decompressed, grouped by root as aggregate_wire_signatures
    # groups them
    for n in JOBS:
        args, _ = verifier._prepare_wire(wire_valid[:n])
        xy, dec_ok = KV.g2_decompress(args.sig_x, args.sig_flags)
        bad = ((args.sig_flags[1] != 0) | (dec_ok[0] == 0))[None, :].to(torch.int32)
        group = torch.from_numpy(verifier._grouping(wire_valid[:n], n)[0]).to(dev)
        _, seg_inf = plain_and_kernel("seg_sum_g2", n, KV.seg_sum_g2, KV.seg_sum_g2_plain, xy, bad, group)
        seg_units["seg_sum_g2", n] = seg_needed(bad, group)
        if bool(seg_inf.any()) or bool(bad.any()):
            raise AssertionError("seg_sum_g2: a valid signature's running sum at infinity")

    # pubkey aggregation on the K = 128 job (K bucket 512), hash on 8 roots
    args, _ = verifier._prepare_wire(d["wire_agg"])
    k_bucket = args.idx.shape[1]
    agg_live_rows = int(args.kmask.sum())  # the rows agg_pk must read and add
    agg_live_lanes = int((args.kmask.sum(dim=1) > 0).sum())
    _, pk_inf = plain_and_kernel("agg_pk", AGG_SETS, KV.agg_pk, KV.agg_pk_plain, tx, ty, args.idx, args.kmask,
                                 plain_runs=0)
    if bool(pk_inf[0, :AGG_SETS].any()) or k_bucket != min(b for b in K_BUCKETS if b >= AGG_K):
        raise AssertionError(f"agg_pk: K bucket {k_bucket}, {int(pk_inf.sum())} aggregates at infinity")
    # one block per set: the launch as the library reports it (the last one,
    # a timed plain_and_kernel launch on this job)
    shape = (ctypes.c_int * 4)()
    B.load("aggpk").lt_agg_last_launch(shape)
    blocks, threads, smem, levels = list(shape)
    kc, lanes = min(k_bucket, KV.AGG_CHUNK), args.idx.shape[0]
    if list(shape) != KV.agg_launch_shape(lanes, k_bucket):
        raise AssertionError(f"agg_pk: last launch {list(shape)}, not {KV.agg_launch_shape(lanes, k_bucket)}")
    chunk_live = args.kmask.reshape(lanes, k_bucket // kc, kc).any(dim=2).sum(dim=1)
    # every tree addition, and one accumulation per live chunk after a set's
    # first (the accumulator of a valid aggregate is never infinity; an
    # all-masked padding set adds every chunk)
    made = torch.where(chunk_live > 0, chunk_live - 1, k_bucket // kc - 1)
    agg_done = lanes * (k_bucket // kc) * (kc - 1) + int(made.sum())
    entry_agg = next(e for k, e in ptxas_entries(ptxas["aggpk"]).items() if "agg_pk" in k)
    agg_info = {"blocks": blocks, "threads_per_block": threads, "static_smem_bytes_per_block": smem,
                "tree_levels_per_chunk": levels, "additions_done": agg_done, "ptxas": entry_agg}
    log(f"agg_pk launch N={AGG_SETS} K bucket {k_bucket}: {blocks} blocks (one per set) of {threads} threads, "
        f"{smem} B static shared memory, {levels} tree levels per chunk of {kc}; {agg_done} complete additions "
        f"made ({int(chunk_live.sum())} live chunks of {lanes * (k_bucket // kc)}); ptxas {entry_agg}")
    sargs, _ = verifier._prepare_wire(d["wire_sync"])
    _, spk_inf = plain_and_kernel("agg_pk", SYNC_SETS, KV.agg_pk, KV.agg_pk_plain, tx, ty, sargs.idx,
                                  sargs.kmask, plain_runs=0, tag="sync")
    if sargs.idx.shape[1] != SYNC_K or bool(spk_inf[0, :SYNC_SETS].any()):
        raise AssertionError(f"agg_pk on the K = {SYNC_K} job: K bucket {sargs.idx.shape[1]}")
    roots_p = d["roots"] + [d["roots"][-1]] * (KV.BT - N_ROOTS)  # padded as MessageCache pads
    us = [GH.hash_to_field_fp2(r, 2, GH.DST_G2) for r in roots_p]
    u = torch.from_numpy(np.stack([np.stack([LY.encode_plain_batch([v[i][k] for v in us]) for k in range(2)])
                                   for i in range(2)])).to(dev)
    sgn = torch.tensor([[GH._sgn0_fp2(v[i]) for v in us] for i in range(2)], dtype=torch.int32, device=dev)
    _, h_ok = plain_and_kernel("hash_g2", KV.BT, KV.hash_g2, KV.hash_g2_plain, u, sgn, plain_runs=0)
    if not bool(h_ok.all()):
        raise AssertionError("hash_g2: a lane flagged not ok")

    # the warp-per-lane pairing kernels at every lane count the paths give
    # them: the tail's one lane, the grouped 128-lane tile, one lane past
    # it, and N = 512 (the per-set mixed job's operands, sliced)
    (p1, q1), (p2, q2), live = pairing_ops
    for n in WARP_LANES:
        sl = lambda t: t[..., :n].contiguous()  # noqa: E731
        pn1, qn1, pn2, qn2 = sl(p1), sl(q1), sl(p2), sl(q2)
        f1 = plain_and_kernel("miller_loop", n, KV.miller_loop, KV.miller_loop_plain, pn1, qn1, plain_runs=0,
                              tag="lanes")
        f2 = KV.miller_loop(pn2, qn2)
        if not torch.equal(f2, KV.miller_loop_plain(pn2, qn2)):
            raise AssertionError(f"miller_loop (-G1, sig) at N={n}: kernel differs from plain version")
        if n not in FINAL_LANES:
            continue
        ok = plain_and_kernel("each_final", n, KV.each_final, KV.each_final_plain, sl(live), f1, f2,
                              plain_runs=0, tag="lanes")
        a_inf = (torch.arange(n, device=dev) % 64 == 5).to(torch.int32)[None].contiguous()
        ok1 = plain_and_kernel("final_one", n, KV.final_one, KV.final_one_plain, a_inf, f1, f2, plain_runs=0,
                               tag="lanes")
        rows = list(zip(truth[:n], live[0, :n].tolist(), ok[0].tolist(), ok1[0].tolist(), a_inf[0].tolist()))
        if any(o != int(t or not lv) for t, lv, o, _, _ in rows):
            raise AssertionError(f"each_final at N={n}: verdicts differ from the ground truth")
        if any(o1 != (0 if a else o) for _, lv, o, o1, a in rows if lv or a):
            raise AssertionError(f"final_one at N={n}: an A = O lane verified, or a verdict differs from each_final's")
    for name, source in (("miller_loop", "miller"), ("each_final", "final"), ("final_one", "tail"),
                         ("g2_rsig_sub", "randmul")):
        # the shape and program figures of the library's last launch, the
        # N = 512 one made above, as its C entry point launched it
        shape = (ctypes.c_int * 8)()
        B.load(source).lt_warp_last_launch(shape)
        lanes, blocks, threads, lpb, smem, slots, phases, rounds = list(shape)
        if lanes != WARP_LANES[-1] or blocks * lpb < lanes or threads % lpb or rounds != KV.ROUNDS_PER_LANE[name]:
            raise AssertionError(f"{name}: last launch {list(shape)} is not {WARP_LANES[-1]} lanes of "
                                 f"{KV.ROUNDS_PER_LANE[name]} rounds")
        entry = next(e for k, e in ptxas_entries(ptxas[source]).items() if name.replace("_loop", "") in k)
        warp_info[name] = {"rounds_per_lane": rounds, "fp_muls_per_lane": KV.FP_MULS_PER_LANE[name],
                           "phases_per_lane": phases, "slots_per_lane": slots, "lanes_per_block": lpb,
                           "threads_per_lane": threads // lpb, "dynamic_smem_bytes_per_block": smem,
                           "ptxas": entry}
        log(f"warp kernel {name} (its N = {lanes} launch: {blocks} blocks of {threads} threads): "
            f"{threads // lpb} threads per lane, {lpb} lanes per block; {rounds} rounds "
            f"({KV.FP_MULS_PER_LANE[name]} Fp products) in {phases} phases per lane, {slots} slots per lane, "
            f"{smem} B dynamic shared memory per block; ptxas {entry}; card ms by lanes " + ", ".join(
                f"{n}: {results[key][0]:.3f}" for n in sorted(set(WARP_LANES + JOBS))
                for key in ((name, n, "lanes"), (name, n)) if key in results and (key[2:] or name == "g2_rsig_sub")))

    # -- 3. main paths -------------------------------------------------------------
    def host_ms(fn, runs=3):
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return statistics.median(times) * 1e3

    def no_host_sets(label):
        if not jobs_begun or any(j.host_sets for j in jobs_begun):
            raise AssertionError(f"{label}: a job routed sets to the host: {[j.host_sets for j in jobs_begun]}")
        jobs_begun.clear()

    def require(label, counts, names):
        if min(counts[k] for k in names) == 0:
            raise AssertionError(f"{label}: a kernel of the path was never launched: {counts}")

    def bucket(size):
        return min(b for b in N_BUCKETS if b >= size)

    def entry_of(counts):
        """The RLC batch entry of a counted run, read from its launches (one
        final_one per batch dispatch): the grouped entry scans (seg_sum_g1),
        the ungrouped wire entry decompresses (g2_decompress) and does not
        scan, the decoded entry does neither."""
        if not counts["final_one"]:
            return None
        if counts["seg_sum_g1"]:
            return "verify_batch_device_wire_grouped"
        return "verify_batch_device_wire" if counts["g2_decompress"] else "verify_batch_device"

    def breakdown(label, n, prepare, ms, counts, names):
        """Kernel-phase medians at this N, or at the largest N where a
        kernel was not timed at this one, times the calls: a segmented
        sum's median is one call of seg_rounds launches."""
        prep = host_ms(prepare)
        kern = 0.0
        at = {k: n if (k, n) in results else JOBS[-1] for k in names + ("miller_loop_1",)}
        for k in names:
            per = results[k, at[k]][0]
            if k == "miller_loop" and "batch" in label:  # one N-lane and one 1-lane launch
                per = (per + results["miller_loop_1", at[k]][0]) / 2
            calls = counts[k] / KV.seg_rounds(bucket(n)) if k in ("seg_sum_g1", "seg_sum_g2") else counts[k]
            kern += per * calls
        elsewhere = sorted({f"{k} at N={m}" for k, m in at.items() if m != n and k in names})
        log(f"breakdown {label} N={n}: job {ms:.3f} ms = host preparation (encode + copy to the card) "
            f"{prep:.3f} ms + kernels {kern:.3f} ms (kernel-phase medians x launches"
            + (f"; {', '.join(elsewhere)}" if elsewhere else "") + f") + the rest {ms - prep - kern:.3f} ms")

    batchable = VerifyOptions(batchable=True)
    for n in JOBS:
        # the per-set path (PR 1's main path)
        job, want = sets[:n], truth[:n]
        verifier.verify_signature_sets_individually(job)  # warm-up
        got, counts = counted(lambda: verifier.verify_signature_sets_individually(job))
        if got != want:
            bad = [(i, kinds[i], g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"N={n}: {len(bad)} verdicts differ from the ground truth: {bad[:8]}")
        require(f"per-set N={n}", counts, PER_SET)
        if verifier.verify_signature_sets(job) != all(want):
            raise AssertionError(f"N={n}: verify_signature_sets gave the wrong verdict")
        if not verifier.verify_signature_sets([s for s, w in zip(job, want) if w]):
            raise AssertionError(f"N={n}: verify_signature_sets rejected the valid sets")
        ms = host_ms(lambda: verifier.verify_signature_sets_individually(job))
        log(f"main path per-set N={n}: {sum(got)} of {n} True, every verdict equals the ground truth; "
            f"launches {json.dumps(counts)}; verify_signature_sets_individually {ms:.1f} ms = "
            f"{n / ms * 1e3:.1f} sets/s (host clock, median of 3 after a warm-up)")
        breakdown("per-set", n, lambda: verifier._prepare(job), ms, counts, PER_SET)
        paths["per_set", n] = counts
        results["sets_per_s", "per_set", n] = n / ms * 1e3

        # the RLC batch path on decoded sets
        job = valid_sets[:n]
        verifier.verify_signature_sets(job, batchable)  # warm-up
        ok, counts = counted(lambda: verifier.verify_signature_sets(job, batchable))
        if ok is not True:
            raise AssertionError(f"N={n}: the all-valid batch was rejected")
        if counts["miller_loop"] != 2 or counts["final_one"] != 1 or counts["each_final"] != 0:
            raise AssertionError(f"N={n}: the batch did not run as one multi-pairing: {counts}")
        require(f"batch N={n}", counts, BATCH)
        ms = host_ms(lambda: verifier.verify_signature_sets(job, batchable))
        log(f"main path batch N={n}: accepted {n} of {n} valid sets as one RLC batch; launches "
            f"{json.dumps(counts)}; verify_signature_sets(batchable=True) {ms:.1f} ms = {n / ms * 1e3:.1f} "
            f"sets/s (host clock, median of 3 after a warm-up)")
        breakdown("batch", n, lambda: verifier._prepare(job), ms, counts, BATCH)
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
    no_host_sets("decoded paths")

    def bisection(label, n, bad_job, want_entry):
        """A 512-set job with one wrong message at BAD_SET: batch rejected,
        bisected to the leaf, exact verdicts in submission order."""
        want = [i != BAD_SET for i in range(n)]
        t = time.perf_counter()
        job, _ = counted(lambda: verifier.begin_job(bad_job, batchable=True))
        ok = verifier.finish_job(job)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        counts = dict(KV.LAUNCHES)
        # the RLC batches: the job, then both halves of each failing half
        # above the leaf (n a power of two); a grouped one scans
        # seg_rounds of its bucket
        sizes, m = [n], n
        while m > verifier.bisect_leaf:
            m //= 2
            sizes += [m, m]
        rounds = sum(KV.seg_rounds(bucket(size)) for size in sizes)
        grouped = want_entry == "verify_batch_device_wire_grouped"
        if (entry_of(counts) != want_entry or counts["final_one"] != len(sizes)
                or counts["seg_sum_g1"] != (rounds if grouped else 0)):
            raise AssertionError(f"{label}: not {len(sizes)} batches through {want_entry}: launches {counts}")
        if ok is not False or job.verdicts.tolist() != want:
            raise AssertionError(f"{label}: verdict {ok}, {int((job.verdicts != want).sum())} per-set verdicts wrong")
        leaf = verifier.bisect_leaf
        if job.bisect_depth < 2 or job.batch_retries != 1 or job.batch_sigs_success != n - leaf:
            raise AssertionError(f"{label}: depth {job.bisect_depth}, retries {job.batch_retries}, "
                                 f"cleared {job.batch_sigs_success}")
        if verifier.verify_signature_sets_individually(bad_job) != want:
            raise AssertionError(f"{label} job: per-set verdicts differ from the ground truth")
        if verifier.verify_signature_sets(bad_job, batchable) is not False:
            raise AssertionError(f"{label} job: verify_signature_sets accepted a job with a bad set")
        log(f"main path {label} N={n}: one wrong message at set {BAD_SET}: batch rejected, bisected "
            f"{n} -> {n // 2} -> ... -> {leaf} (depth {job.bisect_depth}), {job.batch_sigs_success} sets cleared by "
            f"passing halves, the {leaf}-set leaf verified per set; every verdict equals the ground truth; "
            f"{len(sizes)} batches through {want_entry}; launches {json.dumps(counts)}; {dt:.1f} ms (host clock, "
            f"one run)")
        no_host_sets(label)
        return counts

    n = JOBS[-1]
    bad_job = list(valid_sets[:n])
    bad_job[BAD_SET] = sets[BAD_SET]
    paths["bisection", n] = bisection("bisection", n, bad_job, "verify_batch_device")

    # the cold message cache: the 8 roots hashed in one 128-lane launch
    cache = MessageCache(device=dev)
    t = time.perf_counter()
    pts, counts = counted(lambda: cache.get_many(d["roots"]))
    cold_ms = (time.perf_counter() - t) * 1e3
    if pts != d["hs"] or counts["hash_g2"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"cold MessageCache: points equal hash_to_g2: {pts == d['hs']}; launches {counts}")
    again, counts2 = counted(lambda: cache.get_many(d["roots"]))
    if again != d["hs"] or sum(counts2.values()) != 0 or cache.hits != N_ROOTS:
        raise AssertionError(f"warm MessageCache: launches {counts2}, hits {cache.hits}")
    log(f"main path cold-hash: MessageCache.get_many of {N_ROOTS} roots: one hash_g2 launch, every point "
        f"equals crypto/hash_to_curve.py hash_to_g2; {cold_ms:.1f} ms (host clock, one run, host hash_to_field "
        f"included); the second lookup launched nothing")
    paths["cold_hash", KV.BT] = counts
    verifier.messages = cache

    for n in JOBS:
        # the wire batch: the all-valid job as wire bytes
        job = wire_valid[:n]
        verifier.verify_signature_sets(job, batchable)  # warm-up
        ok, counts = counted(lambda: verifier.verify_signature_sets(job, batchable))
        if ok is not True:
            raise AssertionError(f"wire N={n}: the all-valid wire batch was rejected")
        if counts["miller_loop"] != 2 or counts["final_one"] != 1 or counts["each_final"] != 0 or counts["hash_g2"]:
            raise AssertionError(f"wire N={n}: the batch did not run as one multi-pairing: {counts}")
        if entry_of(counts) != "verify_batch_device_wire_grouped" or counts["seg_sum_g1"] != KV.seg_rounds(n):
            raise AssertionError(f"wire N={n}: entry {entry_of(counts)}, seg_sum_g1 launches {counts['seg_sum_g1']}")
        require(f"wire batch N={n}", counts, GROUPED_BATCH)
        ms = host_ms(lambda: verifier.verify_signature_sets(job, batchable))
        # the same job through the ungrouped entry, then grouped again: the
        # two entries compared on one card, in turns
        verifier._grouping = lambda job_sets, lanes: None
        try:
            ms_ungrouped = host_ms(lambda: verifier.verify_signature_sets(job, batchable))
        finally:
            del verifier._grouping
        ms_again = host_ms(lambda: verifier.verify_signature_sets(job, batchable))
        log(f"main path wire-batch N={n}: accepted {n} of {n} wire sets as one RLC batch through the grouped "
            f"entry ({n // N_KEYS} roots: one {KV.BT}-lane Miller tile and the one-lane tail; one "
            f"{entry_of(counts)}); launches {json.dumps(counts)}; {ms:.1f} ms = {n / ms * 1e3:.1f} sets/s (host "
            f"clock, median of 3 after a warm-up); the same job through the ungrouped entry {ms_ungrouped:.3f} ms, "
            f"then grouped again {ms_again:.3f} ms (medians of 3)")
        breakdown("wire-batch", n, lambda: verifier._prepare_wire(job), ms, counts, GROUPED_BATCH)
        paths["wire_batch", n] = counts
        results["sets_per_s", "wire_batch", n] = n / ms * 1e3

        # the wire per-set path on the wire mixed job
        job, want = wire_mixed[:n], wire_truth[:n]
        verifier.verify_signature_sets_individually(job)  # warm-up
        got, counts = counted(lambda: verifier.verify_signature_sets_individually(job))
        if got != want:
            bad = [(i, d["wire_kinds"][i], g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"wire N={n}: {len(bad)} verdicts differ from the ground truth: {bad[:8]}")
        require(f"wire per-set N={n}", counts, WIRE_PER_SET)
        ms = host_ms(lambda: verifier.verify_signature_sets_individually(job))
        log(f"main path wire-per-set N={n}: {sum(got)} of {n} True, every verdict equals the ground truth; "
            f"launches {json.dumps(counts)}; {ms:.1f} ms = {n / ms * 1e3:.1f} sets/s (host clock, median of 3 "
            f"after a warm-up)")
        breakdown("wire-per-set", n, lambda: verifier._prepare_wire(job), ms, counts, WIRE_PER_SET)
        paths["wire_per_set", n] = counts
        results["sets_per_s", "wire_per_set", n] = n / ms * 1e3

        # the wire mixed job sent batchable: malformed encodings void the batch
        ok, counts = counted(lambda: verifier.verify_signature_sets(job, batchable))
        if ok is not False or counts["each_final"] != 1 or entry_of(counts) is not None:
            raise AssertionError(f"wire N={n}: the mixed batchable job did not go per set: {ok}, {counts}")
        log(f"main path wire-mixed-batchable N={n}: False, routed per set before any batch entry (its "
            f"malformed encodings void the batch; launches {json.dumps(counts)})")
    no_host_sets("wire paths")

    # 8 sets of 8 distinct roots: no root repeats, so the ungrouped entry
    job = [wire_valid[r * N_KEYS] for r in range(N_ROOTS)]
    ok, counts = counted(lambda: verifier.verify_signature_sets(job, batchable))
    if (ok is not True or entry_of(counts) != "verify_batch_device_wire" or counts["final_one"] != 1
            or counts["miller_loop"] != 2):
        raise AssertionError(f"ungrouped wire batch: verdict {ok}, entry {entry_of(counts)}, launches {counts}")
    require("ungrouped wire batch", counts, WIRE_BATCH)
    log(f"main path wire-batch-ungrouped N={len(job)}: {N_ROOTS} distinct roots, accepted as one RLC batch "
        f"through the ungrouped entry ({entry_of(counts)}); launches {json.dumps(counts)}")
    paths["wire_batch_ungrouped", len(job)] = counts
    no_host_sets("ungrouped wire batch")

    n = JOBS[-1]
    bad_job = list(wire_valid[:n])
    bad_job[BAD_SET] = wire_mixed[BAD_SET]
    paths["wire_bisection", n] = bisection("wire-bisection", n, bad_job, "verify_batch_device_wire_grouped")

    # the aggregate batch: 256 sets of K = 128 over one root
    job = d["wire_agg"]
    verifier.verify_signature_sets(job, batchable)  # warm-up
    ok, counts = counted(lambda: verifier.verify_signature_sets(job, batchable))
    if ok is not True or counts["agg_pk"] != 1 or counts["final_one"] != 1 or counts["each_final"] != 0:
        raise AssertionError(f"aggregate batch: verdict {ok}, launches {counts}")
    if entry_of(counts) != "verify_batch_device_wire_grouped" or counts["seg_sum_g1"] != KV.seg_rounds(bucket(AGG_SETS)):
        raise AssertionError(f"aggregate batch: entry {entry_of(counts)}, launches {counts}")
    require("aggregate batch", counts, AGG_BATCH)
    ms = host_ms(lambda: verifier.verify_signature_sets(job, batchable))
    log(f"main path aggregate-batch N={AGG_SETS} K={AGG_K}: accepted as one RLC batch through agg_pk (K bucket "
        f"{k_bucket}) and the grouped entry (one root; {entry_of(counts)}); launches "
        f"{json.dumps(counts)}; {ms:.1f} ms = {AGG_SETS / ms * 1e3:.1f} sets/s = "
        f"{AGG_SETS * AGG_K / ms * 1e3:.1f} pubkeys (signers' signatures)/s (host clock, median of 3 after a "
        f"warm-up)")
    breakdown("aggregate-batch", AGG_SETS, lambda: verifier._prepare_wire(job), ms, counts, AGG_BATCH)
    paths["agg_batch", AGG_SETS] = counts
    results["sets_per_s", "agg_batch", AGG_SETS] = AGG_SETS / ms * 1e3
    results["pubkeys_per_s", "agg_batch", AGG_SETS] = AGG_SETS * AGG_K / ms * 1e3

    # the K = 512 job: one set misses a signer, so the batch fails and the
    # 4-set job (under the bisection leaf) is retried per set
    job, want = d["wire_sync"], d["sync_truth"]
    ok, counts = counted(lambda: verifier.verify_signature_sets(job, batchable))
    sync_job = verifier.begin_job(job, batchable=True)
    verifier.finish_job(sync_job)
    if (ok is not False or sync_job.verdicts.tolist() != want or sync_job.batch_retries != 1
            or counts["final_one"] != 1 or counts["each_final"] != 1 or counts["agg_pk"] != 2):
        raise AssertionError(f"K = {SYNC_K} job: verdict {ok}, per set {sync_job.verdicts}, launches {counts}")
    if verifier.verify_signature_sets_individually(job) != want:
        raise AssertionError(f"K = {SYNC_K} job: per-set verdicts differ from the ground truth")
    log(f"main path sync-aggregate N={SYNC_SETS} K={SYNC_K}: batch rejected, retried per set: verdicts {want} "
        f"equal the ground truth; launches {json.dumps(counts)}")
    paths["sync_aggregate", SYNC_SETS] = counts
    no_host_sets("aggregate paths")

    # pre-verify aggregation: the 512 wire signatures by root, one dispatch
    n = JOBS[-1]
    groups = [[s.signature for s in wire_valid[r * N_KEYS:(r + 1) * N_KEYS]] for r in range(N_ROOTS)]
    host_aggs = [verifier._aggregate_wire_host(g) for g in groups]
    t = time.perf_counter()
    aggs, counts = counted(lambda: verifier.aggregate_wire_signatures(groups))
    agg_ms = (time.perf_counter() - t) * 1e3
    if aggs != host_aggs or None in aggs:
        raise AssertionError(f"pre-verify aggregation: {sum(a == b for a, b in zip(aggs, host_aggs))} of "
                             f"{N_ROOTS} aggregates equal the host's")
    if (counts["g2_decompress"], counts["seg_sum_g2"], counts["affine_g2"]) != (1, KV.seg_rounds(n), 1):
        raise AssertionError(f"pre-verify aggregation: not one {n}-lane dispatch: {counts}")
    require("pre-verify aggregation", counts, PREAGG)
    paths["preagg", n] = counts
    bad_group = [wire_valid[0].signature, wire_valid[1].signature[:95]]
    if verifier.aggregate_wire_signatures([bad_group]) != [None]:
        raise AssertionError("pre-verify aggregation: a group with a 95-byte member was aggregated")
    merged = [WireSignatureSet.aggregate([s.indices[0] for s in wire_valid[r * N_KEYS:(r + 1) * N_KEYS]],
                                         d["roots"][r], aggs[r]) for r in range(N_ROOTS)]
    merged_truth = [GB.fast_aggregate_verify([d["pks"][i % N_KEYS] for i in s.indices], s.signing_root,
                                             GC.g2_decompress(s.signature)) for s in merged]
    ok, counts2 = counted(lambda: verifier.verify_signature_sets(merged, batchable))
    if (not all(merged_truth) or ok is not True or counts2["agg_pk"] != 1 or counts2["final_one"] != 1
            or entry_of(counts2) != "verify_batch_device_wire"):
        raise AssertionError(f"merged sets: truth {merged_truth}, verdict {ok}, entry {entry_of(counts2)}, "
                             f"launches {counts2}")
    log(f"main path preagg N={n}: aggregate_wire_signatures of {N_ROOTS} groups of {N_KEYS} wire signatures: "
        f"every aggregate equals the host's bytes (_aggregate_wire_host); launches {json.dumps(counts)}; "
        f"{agg_ms:.1f} ms (host clock, one run, compression on the host included); a group with a 95-byte member "
        f"gave None; the {N_ROOTS} merged sets (K = {N_KEYS}, ground truth all True) accepted as one RLC batch "
        f"({entry_of(counts2)}; launches {json.dumps(counts2)})")
    no_host_sets("merged sets")

    def kernel_ms_in_path(fn):
        """fn() once with each kernel wrapper of GROUPED_WRAPPERS timed by
        CUDA events around its call, the card drained before each (so a
        time is that call's launches alone); (result, name -> ms summed over
        the wrapper's calls, the calls as (name, inputs, outputs), copied
        after each call outside its timing).  Raises unless every wrapper
        was called through the patch."""
        real = {name: getattr(KV, name) for name in GROUPED_WRAPPERS}
        times, calls = {}, []

        def timed(name, f):
            def run(*args):
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = f(*args)
                b.record()
                b.synchronize()
                times[name] = times.get(name, 0.0) + a.elapsed_time(b)
                outs = out if isinstance(out, tuple) else (out,)
                calls.append((name, tuple(x.clone() if torch.is_tensor(x) else x for x in args),
                              tuple(o.clone() for o in outs)))
                return out
            return run

        try:
            for name, f in real.items():
                setattr(KV, name, timed(name, f))
            out = fn()
        finally:
            for name, f in real.items():
                setattr(KV, name, f)
        if set(times) != set(GROUPED_WRAPPERS):
            raise AssertionError(f"wrappers the timed run did not call through the patch: "
                                 f"{sorted(set(GROUPED_WRAPPERS) - set(times))}")
        return out, times, calls

    def hold_calls(label, calls):
        """Each recorded kernel call against its plain version on the same
        inputs, bit for bit (one untimed plain run each); -> seconds."""
        t = time.perf_counter()
        for name, args, k_outs in calls:
            p_out = getattr(KV, name + "_plain")(*args)
            p_outs = p_out if isinstance(p_out, tuple) else (p_out,)
            if len(p_outs) != len(k_outs) or not all(torch.equal(a, b) for a, b in zip(k_outs, p_outs)):
                shapes = [tuple(x.shape) for x in args if torch.is_tensor(x)]
                raise AssertionError(f"{label}: {name} on inputs {shapes} differs from its plain version")
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # the grouped wire batch at the larger N buckets: the 512 signatures
    # repeated, one job of n sets (max_job_sets raised to the largest bucket)
    wide = TorchBlsVerifier(table, rng=np.random.default_rng(SEED + 1), max_job_sets=N_BUCKETS[-1])
    wide.messages = cache
    wide_begin = wide.begin_job

    def wide_recording_begin_job(job_sets, batchable):
        job = wide_begin(job_sets, batchable)
        jobs_begun.append(job)
        return job

    wide.begin_job = wide_recording_begin_job
    wide_ms = {}  # n -> {"ms", "sets_per_s", "kernel_ms"}
    for n in WIDE_JOBS:
        job = [wire_valid[i % JOBS[-1]] for i in range(n)]
        wide.verify_signature_sets(job, batchable)  # warm-up
        ok, counts = counted(lambda: wide.verify_signature_sets(job, batchable))
        if (ok is not True or counts["final_one"] != 1 or counts["miller_loop"] != 2
                or entry_of(counts) != "verify_batch_device_wire_grouped" or counts["seg_sum_g1"] != KV.seg_rounds(n)):
            raise AssertionError(f"wire N={n}: verdict {ok}, entry {entry_of(counts)}, launches {counts}")
        require(f"wire batch N={n}", counts, GROUPED_BATCH)
        ms = host_ms(lambda: wide.verify_signature_sets(job, batchable))
        ok, kms, calls = kernel_ms_in_path(lambda: wide.verify_signature_sets(job, batchable))
        if ok is not True:
            raise AssertionError(f"wire N={n}: the instrumented run rejected the batch")
        held_s = hold_calls(f"wire N={n}", calls)
        wide_ms[n] = {"ms": ms, "sets_per_s": n / ms * 1e3, "kernel_ms": kms}
        results["sets_per_s", "wire_batch", n] = n / ms * 1e3
        paths["wire_batch", n] = counts
        log(f"main path wire-batch N={n}: the 512 wire sets repeated, accepted as one RLC batch through the grouped "
            f"entry; launches {json.dumps(counts)}; {ms:.1f} ms = {n / ms * 1e3:.1f} sets/s (host clock, median of "
            f"3 after a warm-up); kernel ms in the path (one instrumented run, CUDA events, the card drained "
            f"before each call; mont_convert on 4 planes; miller_loop the {KV.BT}-lane tile and the one-lane "
            f"tail): " + ", ".join(f"{k} {v:.3f}" for k, v in kms.items()) + f"; sum {sum(kms.values()):.3f}; "
            f"each of its {len(calls)} kernel calls equal to its plain version on the same inputs bit for bit "
            f"({', '.join(name for name, _, _ in calls)}; {held_s:.1f} s)")
    no_host_sets("wide wire batches")

    if not verifier._device_canary():
        raise AssertionError("device canary failed")

    # -- 4. result lines -----------------------------------------------------------
    imad_per_ms = N_SM * IMAD_PER_CLK_PER_SM * sm_mhz * 1e3

    def bound(name, n):
        """(bound ms, what bounds it, units of FP_MULS_NEEDED, lanes) of one
        launch at n lanes: the products the function needs (not the ones
        the kernel makes: KV.FP_MULS_NEEDED against FP_MULS_PER_LANE) over
        the card's IMAD rate, or its bytes over the memory rate."""
        lanes = n
        if name in TAIL:
            units = lanes = 1
        elif name in ("sum_g2", "prod12"):
            units = n - 1  # N - 1 combines
        elif name in ("mont_convert", "mont_convert_4"):
            units = (8 if name == "mont_convert" else 4) * n  # planes per lane
        elif name == "agg_pk":
            units = agg_live_rows - agg_live_lanes  # one addition per live row after a lane's first
        elif name in ("seg_sum_g1", "seg_sum_g2"):
            units = seg_units[name, n]  # one addition per live lane after its group's first
        else:
            units = n
        ops_ms = KV.FP_MULS_NEEDED[name] * KV.IMAD_PER_FP_MUL * units / imad_per_ms
        if name == "agg_pk":
            nbytes = agg_live_rows * 2 * 48 + n * (k_bucket * 8 + 3 * 48 + 4)
        else:
            nbytes = BYTES_PER_LANE[name] * lanes + BYTES_PER_LAUNCH.get(name, 0)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), units, lanes

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path, n = MAIN_PATH[name]
        k_ms, p_ms, err = results[name, n]
        bound_ms, bound_by, units, _ = bound(name, n)
        if name in ("seg_sum_g1", "seg_sum_g2"):
            done = KV.seg_rounds(n) * n  # one addition per lane and round
        elif name == "agg_pk":
            done = agg_done  # every tree addition and the accumulations of live chunks
        elif name in ("sum_g2", "prod12"):
            done = max(n, KV.BT) - 1
        else:
            done = units
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[path, n][name], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "path": path, "n": n,
            "fp_muls_needed": KV.FP_MULS_NEEDED[name] * units, "fp_muls_done": KV.FP_MULS_PER_LANE[name] * done,
            "launches_by_path": {f"{p} N={pn}": c[name] for (p, pn), c in paths.items()},
        }
        if name == "agg_pk":
            entry["live_rows"], entry["k_bucket"] = agg_live_rows, k_bucket
            entry.update(agg_info)
            entry["ms_k512_job"], entry["plain_ms_k512_job"] = results[name, SYNC_SETS, "sync"][:2]
        if (name, JOBS[0]) in results and n != JOBS[0]:
            entry["ms_n128"], entry["plain_ms_n128"] = results[name, JOBS[0]][:2]
            entry["bound_ms_n128"] = bound(name, JOBS[0])[0]
        if name == "miller_loop":
            entry["ms_1_lane"], entry["plain_ms_1_lane"] = results["miller_loop_1", n][:2]
            entry["bound_ms_1_lane"] = bound(name, 1)[0]
        if name == "g1_keyvalidate":
            entry["ms_256"], entry["plain_ms_256"] = results[name, 256][:2]
            entry["bound_ms_256"] = bound(name, 256)[0]
        if name in ("seg_sum_g1", "seg_sum_g2"):
            entry["additions_needed"] = seg_units[name, n]
        if name in warp_info:  # the warp-per-lane kernels
            entry.update(warp_info[name])
        if (name, 1, "lanes") in results:  # the pairing kernels: every lane count of their own phase
            timed = [m for m in WARP_LANES if (name, m, "lanes") in results]
            entry["ms_by_lanes"] = {m: results[name, m, "lanes"][0] for m in timed}
            entry["plain_ms_by_lanes"] = {m: results[name, m, "lanes"][1] for m in timed}
            entry["bound_ms_by_lanes"] = {m: bound("each_final" if name == "final_one" else name, m)[0]
                                          for m in timed}
            entry["ms_per_round_1_lane"] = results[name, 1, "lanes"][0] / entry["rounds_per_lane"]
        elif name in warp_info:
            entry["ms_per_round"] = k_ms / entry["rounds_per_lane"]
        wrapper = "mont_convert" if name == "mont_convert_4" else name
        if name in GROUPED_BATCH and wrapper in GROUPED_WRAPPERS:
            entry["ms_in_grouped_wire_batch_by_n"] = {m: w["kernel_ms"].get(wrapper) for m, w in wide_ms.items()}
        kernels.append(entry)
    log("main path sets/s: " + ", ".join(
        f"{p} N={j}: {results['sets_per_s', p, j]:.1f}" for p in ("per_set", "batch", "wire_per_set", "wire_batch")
        for j in JOBS + (WIDE_JOBS if p == "wire_batch" else ()))
        + f", agg_batch N={AGG_SETS} K={AGG_K}: {results['sets_per_s', 'agg_batch', AGG_SETS]:.1f} "
        f"({results['pubkeys_per_s', 'agg_batch', AGG_SETS]:.1f} pubkeys/s); registration {TABLE_ROWS / reg_s:.1f} "
        f"keys/s ({card}); "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
