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
     lanes, its planes equal to the unchecked table's, its time split into
     host encoding, kernel (CUDA events) and the rest, and a 128-key job
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
  2. kernel phases: each of the fifteen kernels against its plain torch
     version on the same device inputs, bit for bit: the per-set path's
     three on the mixed job's operands and the RLC batch path's six (and
     the one-lane Miller loop of its tail) on the all-valid job's, the
     heading kernel of each taking the job's plain limb planes and making
     its Montgomery ingest (g2_subgroup_check per set, g2_rsig_sub in the
     batch: the work of _k_mont8), each also timed on Montgomery points
     (the wire paths' launch, without the ingest); g2_decompress of the
     wire mixed job with its 4 message planes (the work of _k_mont4) and
     without them, at N = 128 and N = 512; the Montgomery planes each
     heading kernel writes held against mont_convert_plain on the card
     (the rows of _k_mont8 and _k_mont4 read those launches); agg_pk on the K = 128 job (N = 256,
     K bucket 512) and hash_g2 (one warp per lane) on 128 and 512 distinct
     roots as MessageCache encodes them, every point hash_to_g2 of its
     root, with its 512-lane launch as its library reports it;
     g1_keyvalidate on one 65,536-key registration chunk and on the fault
     job beside 128 keys made from E(Fp)'s cofactor components (points of
     each prime order dividing h1, their sums with a key of G1, the
     cofactor part [r] Q, curve points; both sort flags), every verdict the
     oracle's, with its launch shape, occupancy and ptxas figures;
     seg_sum_g1 on the grouped wire batch's randomized pubkeys (N = 128 and 512) and seg_sum_g2 on the 128 and
     512 decompressed signatures grouped by root, and both scans (one warp
     per lane and round) at 1, 33, 512, 1024 and 2048 lanes (those
     operands repeated), each call's launches (one per round of the scan)
     and launch as the library reports them; the warp-per-lane pairing
     kernels at every lane count the paths give them: miller_loop at 1,
     128, 129 and 512 lanes, each_final and final_one at 1, 128 and 512,
     every verdict held against the ground truth, with the shape of each
     one's N = 512 launch as its library reports it under the kernel's
     name (threads and lanes per block, dynamic shared memory, slots,
     phases and rounds per lane) and its ptxas figures, the same for the
     warp-per-lane g2_rsig_sub, and for the warp-per-lane g1_rpk,
     g2_decompress and g2_subgroup_check also at 1, 128, 129 and 512 lanes
     (the batch's, the wire mixed job's and the per-set mixed job's
     operands, sliced), g1_rpk also on agg_pk's Jacobian
     aggregates (Z != 1) with lanes at infinity and zero scalars; the
     warp-per-addition lane sum sum_g2 at 1, 2, 3, 128, 129, 512, 1024 and
     2048 lanes with excluded lanes, a doubling and a P + (-P) at its
     tree's first level, each call's launches (held against
     SUM_LAUNCHES) and first launch as its library reports them;
     affine_g2 at the tail's one lane and on a 128-lane tile with lanes
     flagged infinity and Z = 0; the warp-per-product lane product prod12
     at 1, 128, 129, 512, 1024 and 2048 lanes with dead lanes, each call's
     launches (held against PROD_LAUNCHES) and first launch; agg_pk
     (one block per set) also on the K = 512 job, with its launch as its
     library reports it (blocks, threads, shared memory, tree levels).
     CUDA-event times of
     kernel (median of 5 after a warm-up) and plain version (once, without
     a warm-up: the BLS kernels' plain versions take seconds a call, and
     the script's time limit is shared with every later phase; the
     conversions' plain versions, milliseconds, median of 3);
  3. main paths, each driven with the launch counts set to 0 just before
     and read just after (the per-set, batch, wire batch and wire per-set
     jobs' counts held exactly: no launch of a conversion of its own),
     every verdict held against the ground truth and
     every job's host-routed set count (`job.host_sets`) 0: decoded per
     set, RLC batch, bisection and mixed-batchable; cold MessageCaches of
     the 8 roots and of 128 and 512 new ones (one hash_g2 launch each, the
     points equal to crypto/hash_to_curve.py hash_to_g2, a second lookup
     launches nothing; each time split into the host's hash_to_field, the
     kernel and the host's affine conversion); the wire batch, wire per set, wire mixed-batchable and wire
     bisection, every wire batch through the message-grouped entry (one
     seg_sum_g1 scan, one 128-lane Miller tile; the same job timed through
     the ungrouped entry too, in turns); a wire job of 8 distinct roots
     through the ungrouped entry; the aggregate batch (256 x K = 128:
     one grouped RLC batch through agg_pk) and the K = 512 job (rejected,
     then retried per set); pre-verify aggregation of the 512 wire
     signatures by root (one 512-lane dispatch, every aggregate equal to
     the host's bytes; a group with a 95-byte member gives None), then the
     8 merged K = 64 sets verified as one batch; the grouped wire batch at
     N = 1024 and 2048 (the 512 signatures repeated, one job each); the
     aggregate batch, the K = 512 job, the aggregation, the merged sets and
     the N = 1024 and 2048 batches each run once more with each kernel's
     CUDA-event time inside the path and each of its kernel calls held
     against the plain version on the same inputs; every call of g1_rpk,
     g2_decompress, sum_g2, affine_g2, prod12, hash_g2, g2_subgroup_check,
     seg_sum_g1 and seg_sum_g2 that a main-path run or a bisection makes
     is copied and, after the last path, held against the plain versions
     (one plain run per call of the reductions and scans, one per other
     kernel over all the calls' lanes); sets/s and a breakdown for each timed
     path, its kernels timed inside one more run of the path, as the path
     launches them; the main paths' breakers never tripped and sent no set
     to the host;
  4. service phases, through `create_bls_service(TorchBlsVerifier(table))`
     as a node drives it: the service flood (bench.py's pipeline probe
     shape: 2,048 distinct single-key wire sets in 8 waves from 4 submitter
     threads, each published twice, one in 64 signed over another root, 2
     critical-lane submissions a wave and a non-batchable 4-set job beside
     them, after a 128-set warm-up), every verdict right, the breaker closed
     with no host-fallback set, every kernel of FLOOD_KERNELS launched
     (counted from the service's construction), and its `service` line
     (flushes by reason, fill ratio, aggregation factor, sets/s, the
     critical submissions' count, p50, nearest-rank p99 and maximum
     submit-to-verdict ms, jobs begun, launches); then the breaker phase: a second
     verifier whose wire batch entries fail once with a CUDA launch failure
     trips to host verdicts (equal to the truth), the canary closes it on
     the card, a 128-set job runs on the device, and its `breaker` line;
  5. the node: the port's BeaconNode (queues, processor, fork choice,
     store, chain config) building its own TorchBlsVerifier over the
     1,048,576-row table, fed one mainnet slot: the port's EpochCache over
     every row as an active validator (64 committees of 512 at a capella
     slot), one AttestationData a committee with its signing root from the
     port's get_attestation_data_signing_root (the last committee votes for
     a block not yet imported), one signature a (root, key) pair signed on
     the host, one attester in 512 signing the next committee's root, 1,024
     exact re-publishes, everything through on_gossip_attestation in a
     shuffled slot order, arriving evenly over the 4 s between the
     attestation and aggregation deadlines (NODE_INTERVALS_PER_SLOT), the
     queue shedding by its own rules, then drain_verdicts; the block imported and the
     parked committee released and drained; the 64 committees' full
     aggregates (K = 512) through the node's service on the critical lane;
     the accepted votes into the fork choice and its head over 1,048,576
     equal balances.  Checks: every validator seen as its signature says
     unless each of its messages was shed, the shed sizes and the stale
     end they come from as the queue's rule gives, the parking and release,
     every aggregate True, no set on the host, every
     kernel of NODE_KERNELS launched (counted from 0 just before the first
     publish) and the first call of each launched kernel equal to its
     plain version, the head and its weights as constructed; its `node`
     line.  `python3 chip_smoke.py --node-only` registers its own table and
     runs this phase alone (its lines, no result line);
  6. the hash forest: the port's StateRootEngine on a 1,048,576-validator
     registry state (HtrState: mainnet-like columns, balances, inactivity
     scores, both participation lists, slashings) with the card's
     DeviceMerkleBackend, and in step a second engine on the host path
     (hashlib): the cold root, one slot (256 validator records, 256
     balances, 32,768 participation flags) and an epoch boundary (every
     balance and inactivity score, the participation rotation); each root
     equal to the host's, each of hash_pairs, forest_sweep and
     validator_roots launched exactly as the dirty sets and the level gate
     give (`htr_expected`), no host level, the breaker closed; every
     kernel call of the path (the sweeps with each level's live lanes),
     and each kernel alone (hash_pairs at 1 to 1,048,576 pairs,
     forest_sweep on the slot's (40, 512) plan with its live lanes, on it
     without them and with dead lanes, and on the (40, 1) chain of one
     live lane, validator_roots at 512 and 1,048,576 rows), held against
     its plain version on the card; the bounds from each kernel's SASS
     (cuobjdump), its instructions counted pipe by pipe, the sweep's the
     larger of that and its chain floor (40 levels x one hash's dependent
     critical path at ALU_LATENCY_CLK), with this build's lone-warp floor
     (its instructions at one warp's share of each pipe) printed beside
     it; its `htr` line.
     `python3 chip_smoke.py --htr-only` runs this phase alone (its lines,
     no result line);
  7. the slasher: the port's SlasherService (no chain, no db, history
     4,096 epochs, chunk 16) with its span planes on the card, sized once
     to 1,048,576 validators (two int32 planes of 16 GiB); 4 epochs in
     which every validator attests once (2,048 committees of 512, 64 a
     slot, one aggregate IndexedAttestation each, through
     ingest_attestation: 4 flushes an epoch), on_finalized(2) (both planes
     shifted on the card), then planted offences: a double vote, a surround
     and a surrounded vote, the old-source attack (a vote whose source
     lies below the window base and which surrounds the attacker's votes
     still in the window, found on the host, then an inner vote) and a
     double proposal; the
     detections by kind and offender equal to the planted ones and to the
     port's NaiveAttesterSlasher's over the same stream; 4,096 sampled
     rows and every offender's row of the card's planes equal to a numpy
     SpanState fed the same applies; every apply that can change a cell
     carried by exactly one span_update launch (TorchSpanState defers
     them into one span_update_many launch a drain), each drain one
     launch, at most SLASHER_LAUNCHES_PER_FLUSH launches in each flush
     (the launches outside flushes reported apart), the drains by reason and the flushes' time split into apply, lookup,
     drain and the rest; the kernel alone against its plain version on
     65,536 x 4,096 planes (512 rows, every row with t = H - 1, a source
     below the window, source = target, no row) and, as a flush drains
     it, 512 committees of 512 in one launch on 262,144 x 4,096 planes;
     its `slasher` line.  `python3 chip_smoke.py --slasher-only` runs
     this phase alone;
  8. the chain: the port's BeaconChain (state transition, regen, memory
     governor with its default budget, op pools, block production, fork
     choice, a BeaconDb) over a 1,048,576-validator altair genesis made by
     the port's create_genesis_state from the table's keys, its signatures
     through create_bls_service(TorchBlsVerifier(table)), its state roots
     through the card's DeviceMerkleBackend; the blocks at slots 29 to 33
     (32 crosses the epoch boundary) made by the chain's own
     produce_block from its pools (the previous slot's 64 committees of
     512 as full aggregates, a full sync aggregate from four subnet
     contributions), signed with the proposers' keys and imported by
     process_block; before the last imports, a copy with one attestation's
     signature swapped for another committee's (refused by the signature
     leg, its batch bisected on the card) and one with a wrong state root
     (refused by the state-root leg), neither moving the head nor leaving
     a fork-choice node.  Checks: every block imported, the head the last
     one, each post-state's root equal to a second StateRootEngine's on
     the host path (in step), no set on the host, no signature checked
     inside the state transition, no tree level on the host, the breakers
     closed, every kernel of CHAIN_KERNELS and CHAIN_SHA launched (counted
     from 0 just before the genesis) and every kernel call of the phase
     equal to its plain version (`hold_chain_calls`); its `chain block`
     lines (the chain's named phases, the view's committee caches, sets,
     import and host-root ms) and its `chain` line (cold root, sync
     committee on the host, rejections, launches, calls held, the
     governor's resident bytes, evictions and demotions, wall time).
     `python3 chip_smoke.py --chain-only` registers its own table and runs
     this phase alone (its lines, no result line);
  9. one JSON line {"kernels": [...]} (each BLS row with its launches in
     the node phase and, where the phase launched it, its first call's
     hold; every row with its launches in the chain phase and the calls of
     it held there) and, last, {"ok": true, "device": ...}.

Any mismatch or error raises, and the script exits non-zero.
"""

from __future__ import annotations

import bisect
import ctypes
import gc
import itertools
import json
import math
import multiprocessing as mp
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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
# G1's cofactor h1 = prod l^k over these primes; the 256-lane KeyValidate
# call holds 128 keys made from E(Fp)'s cofactor components (COFACTOR_KINDS
# points, both sort flags of each) beside the fault job
H1_PRIMES = {3: 1, 11: 2, 10177: 2, 859267: 2, 52437899: 2}
COFACTOR_KINDS = [("order", ell) for ell in H1_PRIMES] * 4 + [("g1_plus_order", ell) for ell in H1_PRIMES] * 4 + [
    ("cofactor_part", 0)] * 8 + [("g1_plus_cofactor_part", 0)] * 8 + [("on_curve", 0)] * 8
# fault keys of the 128-key rejection job, at these positions among valid keys
KEY_FAULTS = {5: "infinity", 17: "x_off_curve", 29: "outside_G1", 41: "x_zero_order_3", 53: "x_not_below_p",
              77: "no_compression_bit", 101: "47_bytes"}

# NVIDIA H100 SXM (data sheet): HBM3 rate; 32-bit IMAD issue rate per SM
# (CUDA programming guide, compute capability 9.0 throughput table)
PEAK_BYTES_PER_S = 3.35e12
IMAD_PER_CLK_PER_SM = 64
N_SM = 132

# TPU kernel each CUDA kernel replaces, and its source in this checkout.
# The Montgomery ingest (_k_mont8 on the decoded paths, _k_mont4 on the wire
# paths) has no kernel of its own: the kernel that heads each path makes it
# in its first phase, and the two rows read that kernel's launch on their
# main path (FUSED).
KERNELS = {
    "mont_convert": ("lodestar_tpu_torch/kernels/csrc/randmul.cu", "lodestar_tpu/kernels/verify.py:116"),
    "g2_subgroup_check": ("lodestar_tpu_torch/kernels/csrc/subgroup.cu", "lodestar_tpu/kernels/verify.py:190"),
    "miller_loop": ("lodestar_tpu_torch/kernels/csrc/miller.cu", "lodestar_tpu/kernels/verify.py:269"),
    "each_final": ("lodestar_tpu_torch/kernels/csrc/final.cu", "lodestar_tpu/kernels/verify.py:328"),
    "g1_rpk": ("lodestar_tpu_torch/kernels/csrc/randmul.cu", "lodestar_tpu/kernels/verify.py:155"),
    "g2_rsig_sub": ("lodestar_tpu_torch/kernels/csrc/randmul.cu", "lodestar_tpu/kernels/verify.py:169"),
    "sum_g2": ("lodestar_tpu_torch/kernels/csrc/reduce.cu", "lodestar_tpu/kernels/verify.py:196"),
    "prod12": ("lodestar_tpu_torch/kernels/csrc/reduce.cu", "lodestar_tpu/kernels/verify.py:285"),
    "affine_g2": ("lodestar_tpu_torch/kernels/csrc/tail.cu", "lodestar_tpu/kernels/verify.py:231"),
    "final_one": ("lodestar_tpu_torch/kernels/csrc/tail.cu", "lodestar_tpu/kernels/verify.py:312"),
    "mont_convert_4": ("lodestar_tpu_torch/kernels/csrc/ingest.cu", "lodestar_tpu/kernels/verify.py:454"),
    "g2_decompress": ("lodestar_tpu_torch/kernels/csrc/ingest.cu", "lodestar_tpu/kernels/ingest.py:247"),
    "agg_pk": ("lodestar_tpu_torch/kernels/csrc/aggpk.cu", "lodestar_tpu/kernels/verify.py:246"),
    "hash_g2": ("lodestar_tpu_torch/kernels/csrc/ingest.cu", "lodestar_tpu/kernels/ingest.py:219"),
    "g1_keyvalidate": ("lodestar_tpu_torch/kernels/csrc/keyvalidate.cu", "lodestar_tpu/kernels/ingest.py:309"),
    "seg_sum_g1": ("lodestar_tpu_torch/kernels/csrc/segsum.cu", "lodestar_tpu/kernels/verify.py:686"),
    "seg_sum_g2": ("lodestar_tpu_torch/kernels/csrc/segsum.cu", "lodestar_tpu/kernels/verify.py:845"),
}
# the launch that makes each ingest row's work on its main path, and the
# planes it converts per lane (the decoded per-set path's is
# g2_subgroup_check's)
FUSED = {"mont_convert": "g2_rsig_sub", "mont_convert_4": "g2_decompress"}
INGEST_PLANES = {"mont_convert": 8, "mont_convert_4": 4}
PER_SET = ("g2_subgroup_check", "miller_loop", "each_final")
BATCH = ("g1_rpk", "g2_rsig_sub", "sum_g2", "miller_loop", "prod12", "affine_g2", "final_one")
WIRE_PER_SET = ("g2_decompress", "g2_subgroup_check", "miller_loop", "each_final")
WIRE_BATCH = ("g2_decompress",) + BATCH
GROUPED_BATCH = WIRE_BATCH + ("seg_sum_g1",)  # a wire batch with a repeated root
AGG_BATCH = GROUPED_BATCH + ("agg_pk",)
PREAGG = ("g2_decompress", "seg_sum_g2", "affine_g2")
TAIL = ("affine_g2", "final_one")  # one lane per launch on the batch path
# the kernel wrappers of kernels/verify.py that the grouped wire batch calls
GROUPED_WRAPPERS = ("g2_decompress", "g1_rpk", "g2_rsig_sub", "sum_g2", "seg_sum_g1", "miller_loop", "prod12",
                    "affine_g2", "final_one")
AGG_WRAPPERS = GROUPED_WRAPPERS + ("agg_pk",)  # the aggregate batch (one root)
MERGED_WRAPPERS = tuple(w for w in AGG_WRAPPERS if w != "seg_sum_g1")  # the merged sets (distinct roots)
PER_SET_WRAPPERS = ("g2_subgroup_check", "each_final")  # besides g2_decompress, miller_loop
# lane counts of the warp-per-lane pairing kernels' own phase: the tail's
# one lane, the 128-lane tile, one lane past it, N = 512
WARP_LANES = (1, 128, 129, 512)
FINAL_LANES = (1, 128, 512)
# lane counts of the lane sum's tree (the tree's edges: one lane, a pair, an
# odd count; a 128-lane tile and one lane past it; the paths' N = 512, 1024
# and 2048) and of the affine conversion (the tail's one lane, the
# pre-verify aggregation's 128-lane tile)
SUM_LANES = (1, 2, 3, 128, 129, 512, 1024, 2048)
# the launches one sum makes at each of them, 32 elements per block to one
# partial until one is left (csrc/reduce.cu), against which the launches
# that its entry point reports are held
SUM_LAUNCHES = {1: 1, 2: 1, 3: 1, 128: 2, 129: 2, 512: 2, 1024: 2, 2048: 3}
AFFINE_LANES = (1, 128)
# lane counts of the Fp12 lane product's tree: one lane, the grouped paths'
# 128-lane tile and one lane past it, the ungrouped batches' N = 512, 1024
# and 2048; the launches one product makes at each (as the lane sum's)
PROD_LANES = (1, 128, 129, 512, 1024, 2048)
PROD_LAUNCHES = {1: 1, 128: 2, 129: 2, 512: 2, 1024: 2, 2048: 3}
# lane counts of the segmented scans' own phase (one lane, one past two
# blocks of 16, the paths' N = 512, 1024 and 2048): one launch per round
# of the scan at each, held against the launches the entry points report
SEG_LANES = (1, 33, 512, 1024, 2048)
# distinct signing roots of the cold MessageCache runs: the 8 roots of the
# jobs (one 128-lane batch) and new roots filling one and four batches; the
# kernel phase holds hash_g2 on the last two
HASH_ROOTS = (N_ROOTS, 128, 512)
# the path whose launch count is a row's "launches", and its lanes
MAIN_PATH = {name: ("batch" if name in BATCH else "per_set", JOBS[-1]) for name in KERNELS}
MAIN_PATH.update({"mont_convert": ("batch", JOBS[-1]),
                  "mont_convert_4": ("wire_batch", JOBS[-1]), "g2_decompress": ("wire_batch", JOBS[-1]),
                  "agg_pk": ("agg_batch", AGG_SETS), "hash_g2": ("cold_hash", 128),
                  "g1_keyvalidate": ("registration", REG_CHUNK), "seg_sum_g1": ("wire_batch", JOBS[-1]),
                  "seg_sum_g2": ("preagg", JOBS[-1])})
# bytes each kernel must move per lane (per launch for the reductions'
# one output and the tail): inputs read once, outputs written once; the
# heading kernels as their main paths launch them, with the ingest's
# planes in (plain) and out (Montgomery)
BYTES_PER_LANE = {
    "g2_subgroup_check": (8 * 48 + 4) + (4 + 8 * 48),
    "miller_loop": 7 * 48 + 12 * 48,
    "each_final": 4 + 24 * 48 + 4,
    "g1_rpk": (3 * 48 + 4 + 16) + (3 * 48 + 4),
    "g2_rsig_sub": (8 * 48 + 4 + 16) + (6 * 48 + 4 + 4 + 4 * 48),
    "sum_g2": 6 * 48 + 4,
    "prod12": 4 + 12 * 48,
    "affine_g2": (6 * 48 + 4) + (4 * 48 + 4),
    "final_one": 4 + 24 * 48 + 4,
    "g2_decompress": (2 * 48 + 8 + 4 * 48) + (4 * 48 + 4 + 4 * 48),
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


def _hash_to_g2(root: bytes):
    from lodestar_tpu_torch.crypto import hash_to_curve as GH

    return GH.hash_to_g2(root)


def _ground_truth(args):
    from lodestar_tpu_torch.crypto import bls as GB

    pk, root, sig = args
    return GB.verify(pk, root, sig)


def _aggregate_truth(args):
    from lodestar_tpu_torch.crypto import bls as GB

    keys, root, sig = args
    return GB.fast_aggregate_verify(keys, root, sig)


def _cofactor_keys(args):
    """Both sort flags of one point made from E(Fp)'s cofactor components
    ([#E / l^k] Q of order l, with a key of G1 added, the cofactor part
    [r] Q, or Q itself, Q a curve point from the seed), each with its
    verdict by the oracle (g1_decompress and the [r]P subgroup check)."""
    import random

    from lodestar_tpu_torch.crypto import curves as GC
    from lodestar_tpu_torch.crypto import fields as GT

    (kind, ell), seed, pk = args
    rng = random.Random(seed)

    def on_curve():
        while True:
            x = rng.randrange(GT.P)
            y = GT.fp_sqrt((x * x * x + 4) % GT.P)
            if y is not None:
                return x, y

    n_e = GT.H1_COFACTOR * GT.R  # #E(Fp)
    pt = None
    while pt is None:  # Q's component may be 0
        pt = q = on_curve()
        if kind.endswith("order"):
            pt = GC.scalar_mul(GC.FP_OPS, q, n_e // ell ** H1_PRIMES[ell])
        elif kind.endswith("cofactor_part"):
            pt = GC.scalar_mul(GC.FP_OPS, q, GT.R)
    if kind.startswith("g1_plus_"):
        pt = GC.affine_add(GC.FP_OPS, pk, pt)
    c = GC.g1_compress(pt)
    keys = [c, bytes([c[0] ^ 0x20]) + c[1:]]
    return [(k, GC.g1_subgroup_check(GC.g1_decompress(k))) for k in keys]


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
    sks = make_keys(rng)
    pks = [GB.sk_to_pk(sk) for sk in sks]
    roots = [rng.bytes(32) for _ in range(N_ROOTS)]
    hs = [GH.hash_to_g2(r) for r in roots]
    hash_roots = [rng.bytes(32) for _ in range(HASH_ROOTS[-1])]  # distinct from the jobs' roots
    hash_async = pool.map_async(_hash_to_g2, hash_roots)
    assert np.prod([ell**k for ell, k in H1_PRIMES.items()], dtype=object) == GT.H1_COFACTOR
    cof_async = pool.map_async(_cofactor_keys, [(kind, rng.bytes(16), pks[i % N_KEYS])
                                                for i, kind in enumerate(COFACTOR_KINDS)])
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
    cof = cof_async.get()
    return dict(
        sks=sks, pks=pks, roots=roots, hs=hs, sets=sets, kinds=kinds, truth=truth, valid_sets=valid_sets,
        wire_valid=wire_valid, wire_mixed=wire_mixed, wire_kinds=wire_kinds, wire_truth=wire_truth,
        wire_agg=wire_agg, agg_truth=agg_truth[:AGG_SETS], wire_sync=wire_sync, sync_truth=agg_truth[AGG_SETS:],
        comp=comp, rej_keys=rej_keys, hash_roots=hash_roots, hash_pts=hash_async.get(),
        cof_keys=[k for pair in cof for k, _ in pair], cof_truth=[v for pair in cof for _, v in pair],
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


# -- the service phases: create_bls_service(TorchBlsVerifier(table)) -----------

# the service flood, after bench.py's _probe_pipeline / _probe_effective_atts
# shape (bench.py:1012-1014, BENCH_PREAGG_DUP): distinct single-key wire
# attestations in waves, each published twice, two block-critical
# submissions a wave, from submitter threads
FLOOD_SETS = 2048
FLOOD_WAVES = 8
FLOOD_DUP = 2
FLOOD_THREADS = 4
FLOOD_BAD = 64  # one set in 64 carries the signature of the same key over another root
WARM_SETS = 128
SIDE_SETS = 4  # the non-batchable job riding alongside
BREAKER_SETS, BREAKER_BAD = 8, 5
# first table rows of the flood's critical sets, the side job, the warm-up
# and the breaker job (row r holds key r % N_KEYS); the flood takes rows
# from 0
CRIT_ROW, SIDE_ROW, WARM_ROW, BREAKER_ROW = FLOOD_SETS, 2 * FLOOD_SETS, 4 * FLOOD_SETS, 6 * FLOOD_SETS
# every kernel the flood must reach: the cold roots' hash (warm-up), the
# RLC batches (grouped: seg_sum_g1), the merged layers (agg_pk), the
# pre-verify sums (seg_sum_g2), and the bisection leaves' and the side
# job's per-set path (g2_subgroup_check, each_final)
FLOOD_KERNELS = ("hash_g2", "g2_decompress", "g1_rpk", "g2_rsig_sub", "seg_sum_g1", "sum_g2", "miller_loop",
                 "prod12", "affine_g2", "final_one", "seg_sum_g2", "agg_pk", "g2_subgroup_check", "each_final")


def _wire_set(d, row: int, root: int, signed: int):
    """Row `row` (key row % N_KEYS) over root `root`, with that key's
    signature over root `signed` (one of make_job's signatures: key k over
    root r is wire_valid[r * N_KEYS + k])."""
    from lodestar_tpu_torch.bls.signature_set import WireSignatureSet

    n_keys = len(d["wire_valid"]) // len(d["roots"])
    sig = d["wire_valid"][signed * n_keys + row % n_keys].signature
    return WireSignatureSet.single(row, d["roots"][root], sig)


def _flood_set(d, j: int):
    """(set j, its verdict by construction): row j over root j % N_ROOTS;
    one set in FLOOD_BAD signed over the next root."""
    r, n = j % len(d["roots"]), len(d["roots"])
    bad = j % FLOOD_BAD == FLOOD_BAD - 1
    return _wire_set(d, j, r, (r + 1) % n if bad else r), not bad


def _percentile(xs, q):
    """The nearest-rank q-quantile: the smallest sample with at least a q
    share of the samples at or below it (below 100 samples, p99 is the
    largest)."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)] if xs else None


def _breaker_clean(sup, label):
    if sup.trip_count or sup.m_host_fallback_sets.value or sup.m_failures.label_values():
        raise AssertionError(f"{label}: the breaker tripped or fell back to the host: {sup.status()}, "
                             f"{sup.m_host_fallback_sets.value} host-fallback sets")


def service_flood(table, d, card: str, device=None) -> dict:
    """The flood through create_bls_service(TorchBlsVerifier(table)); raises
    unless every verdict is right, the breaker stayed closed with no
    host-fallback set and every kernel of FLOOD_KERNELS launched."""
    from lodestar_tpu_torch.bls.pipeline import create_bls_service
    from lodestar_tpu_torch.bls.verifier import TorchBlsVerifier, VerifyOptions
    from lodestar_tpu_torch.kernels import verify as KV

    torch.cuda.synchronize()
    KV.reset_launches()  # counted from the service's construction
    verifier = TorchBlsVerifier(table, device=device)  # OS CSPRNG randomizers, the default breaker
    begun = []
    begin = verifier.begin_job

    def recording_begin_job(job_sets, batchable):
        job = begin(job_sets, batchable)
        begun.append(job)
        return job

    verifier.begin_job = recording_begin_job
    svc = create_bls_service(verifier)
    try:
        warm = [s for s, ok in map(lambda j: _flood_set(d, j), range(WARM_ROW, WARM_ROW + 2 * WARM_SETS)) if ok]
        if svc.verify_signature_sets(warm[:WARM_SETS], VerifyOptions(batchable=True)) is not True:
            raise AssertionError("service flood: the warm-up job was rejected")
        svc.reset_flush_stats()
        base = svc.agg_stats()
        flood = [_flood_set(d, j) for j in range(FLOOD_SETS)]
        crit = [_flood_set(d, j) for j in range(CRIT_ROW, CRIT_ROW + 2 * FLOOD_WAVES)]
        side = [_flood_set(d, j) for j in range(SIDE_ROW, SIDE_ROW + SIDE_SETS)]
        lat = []

        def submit(items):
            out = []
            for s, ok, critical in items:
                while not svc.can_accept_work():
                    time.sleep(0.001)
                t0 = time.perf_counter()
                fut = svc.verify_signature_sets_async([s], VerifyOptions(batchable=True, priority=critical))
                if critical:
                    fut.add_done_callback(lambda _f, t0=t0: lat.append(time.perf_counter() - t0))
                out.append((fut, ok))
            return out

        per_wave = FLOOD_SETS // FLOOD_WAVES
        t1 = time.perf_counter()
        side_fut = svc.verify_signature_sets_async([s for s, _ in side], VerifyOptions())
        futs = []
        with ThreadPoolExecutor(FLOOD_THREADS) as pool:
            for w in range(FLOOD_WAVES):
                items = [(s, ok, False) for s, ok in flood[w * per_wave:(w + 1) * per_wave] for _ in range(FLOOD_DUP)]
                items += [(s, ok, True) for s, ok in crit[2 * w:2 * w + 2]]
                for part in pool.map(submit, [items[i::FLOOD_THREADS] for i in range(FLOOD_THREADS)]):
                    futs += part
            wrong = sum(fut.result(timeout=600) != ok for fut, ok in futs)
            side_ok = side_fut.result(timeout=600)
        dt = time.perf_counter() - t1
        torch.cuda.synchronize()
        counts = dict(KV.LAUNCHES)
        stats = svc.agg_stats()
        status = svc.breaker_status()
        records = svc.flush_stats()
        fill = svc.mean_fill_ratio()
        _breaker_clean(verifier.supervisor, "service flood")
    finally:
        svc.close()
    if wrong or side_ok is not all(ok for _, ok in side):
        raise AssertionError(f"service flood: {wrong} of {len(futs)} verdicts wrong, side job {side_ok}")
    if status["state"] != "closed" or any(j.host_sets or j.host_mode for j in begun):
        raise AssertionError(f"service flood: breaker {status['state']}, a job routed sets to the host")
    missing = [k for k in FLOOD_KERNELS if not counts[k]]
    if missing:
        raise AssertionError(f"service flood: kernels never launched: {missing} ({counts})")
    reasons = {}
    for rec in records:
        reasons[rec["reason"]] = reasons.get(rec["reason"], 0) + 1
    flood_stats = {k: stats[k] - base[k] for k in stats}
    line = {
        "sets": len(futs) + SIDE_SETS, "distinct_sets": FLOOD_SETS + len(crit) + SIDE_SETS,
        "bad_sets": sum(not ok for _, ok in flood), "waves": FLOOD_WAVES, "threads": FLOOD_THREADS,
        "flushes_by_reason": reasons, "preagg_flushes": flood_stats["flushes"], "mean_fill_ratio": fill,
        "mean_aggregation_factor": flood_stats["contributions"] / flood_stats["sets"],
        "preagg": flood_stats, "flood_s": dt, "effective_sets_per_s": (len(futs) + SIDE_SETS) / dt,
        "distinct_sets_per_s": (FLOOD_SETS + len(crit) + SIDE_SETS) / dt,
        "critical_n": len(lat), "critical_p50_ms": _percentile(lat, 0.5) * 1e3,
        "critical_p99_ms": _percentile(lat, 0.99) * 1e3, "critical_max_ms": max(lat) * 1e3,
        "jobs_begun": len(begun), "launches": {k: v for k, v in counts.items() if v},
        "breaker": status["state"], "host_fallback_sets": verifier.supervisor.m_host_fallback_sets.value,
        "card": card,
    }
    log("service " + json.dumps(line))
    return line


def breaker_phase(table, d, card: str, device=None) -> dict:
    """A trip on the card and its recovery: the first call of either wire
    batch entry raises a CUDA launch failure; the job's verdicts come from
    the host, the breaker opens with outcome `error`; without the fault the
    canary runs on the card and closes it, and a WARM_SETS-set job runs on
    the device with no further host fallback."""
    from lodestar_tpu_torch.bls.pipeline import create_bls_service
    from lodestar_tpu_torch.bls.supervisor import DeviceSupervisor
    from lodestar_tpu_torch.bls.verifier import TorchBlsVerifier, VerifyOptions
    from lodestar_tpu_torch.kernels import verify as KV
    from lodestar_tpu_torch.utils.metrics import BlsPoolMetrics

    metrics = BlsPoolMetrics()
    sup = DeviceSupervisor(registry=metrics.registry, backoff_initial_s=0.05, auto_probe=False)
    verifier = TorchBlsVerifier(table, device=device, metrics=metrics, supervisor=sup)
    begun = []
    begin = verifier.begin_job

    def recording_begin_job(job_sets, batchable):
        job = begin(job_sets, batchable)
        begun.append(job)
        return job

    verifier.begin_job = recording_begin_job
    # 8 sets over 2 roots; set BREAKER_BAD signed over the other root
    sets = [_wire_set(d, BREAKER_ROW + i, i % 2, (i + (i == BREAKER_BAD)) % 2) for i in range(BREAKER_SETS)]
    truth = [i != BREAKER_BAD for i in range(BREAKER_SETS)]
    entries = ("verify_batch_device_wire", "verify_batch_device_wire_grouped")
    real = {name: getattr(KV, name) for name in entries}
    calls = [0]

    def faulty(name):
        def entry(*args):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("CUDA error: unspecified launch failure")
            return real[name](*args)
        return entry

    critical = VerifyOptions(batchable=True, priority=True)  # the critical lane: no pre-verify aggregation
    svc = create_bls_service(verifier)
    try:
        for name in entries:
            setattr(KV, name, faulty(name))
        try:
            t = time.perf_counter()
            ok = svc.verify_signature_sets(sets, critical)
            trip_ms = (time.perf_counter() - t) * 1e3
        finally:
            for name, f in real.items():
                setattr(KV, name, f)
        st = sup.status()
        fallback = sup.m_host_fallback_sets.value
        if (calls[0] != 1 or ok is not False or len(begun) != 1 or not begun[0].host_mode
                or begun[0].verdicts.tolist() != truth):
            raise AssertionError(f"breaker: entry calls {calls[0]}, verdict {ok}, jobs {len(begun)}")
        if st["state"] != "open" or st["last_failure"]["outcome"] != "error" or fallback != BREAKER_SETS:
            raise AssertionError(f"breaker: {st} with {fallback} host-fallback sets after the fault")
        time.sleep(0.1)  # past the jittered 0.05 s backoff
        torch.cuda.synchronize()
        KV.reset_launches()
        t = time.perf_counter()
        sup.poll()
        canary_ms = (time.perf_counter() - t) * 1e3
        canary_counts = dict(KV.LAUNCHES)
        if sup.status()["state"] != "closed" or not canary_counts["each_final"]:
            raise AssertionError(f"breaker: after the canary {sup.status()}, launches {canary_counts}")
        job = d["wire_valid"][:WARM_SETS]
        KV.reset_launches()
        t = time.perf_counter()
        ok = svc.verify_signature_sets(job, critical)
        torch.cuda.synchronize()
        job_ms = (time.perf_counter() - t) * 1e3
        job_counts = dict(KV.LAUNCHES)
        state = sup.status()["state"]
    finally:
        svc.close()
    if ok is not True or sup.m_host_fallback_sets.value != fallback or state != "closed" or not job_counts["final_one"]:
        raise AssertionError(f"breaker: the job after recovery gave {ok}, {sup.m_host_fallback_sets.value} "
                             f"host-fallback sets, breaker {state}, launches {job_counts}")
    line = {
        "outcome": st["last_failure"]["outcome"], "seam": st["last_failure"]["seam"], "sets_on_host": fallback,
        "trip_job_ms": trip_ms, "canary_ms": canary_ms, "canary_launches": {k: v for k, v in canary_counts.items() if v},
        "state_after": state, "job_after_sets": len(job), "job_after_ms": job_ms,
        "job_after_launches": {k: v for k, v in job_counts.items() if v}, "card": card,
    }
    log("breaker " + json.dumps(line))
    return line


# -- the hash forest: the state-root engine on the card -----------------------

HTR_VALIDATORS = 1 << 20  # a mainnet-scale registry
HTR_SLOT_RECORDS = 256  # validator records a slot changes (sweep)
HTR_SLOT_BALANCES = 256  # balances a slot changes (sweep)
HTR_SLOT_FLAGS = 32768  # participation flags a slot sets: one slot's committees at 1M validators
HTR_PAIR_SIZES = (1, 1024, 262144, HTR_VALIDATORS)  # hash_pairs alone: a lane, the level gate, the balances' level 0, the pubkey roots
HTR_ROOT_SIZES = (512, HTR_VALIDATORS)  # validator_roots alone
FAR_FUTURE_EPOCH = 2**64 - 1
SLASHINGS_VECTOR = 8192  # EPOCHS_PER_SLASHINGS_VECTOR, mainnet
HTR_SOURCE = "lodestar_tpu_torch/kernels/csrc/sha256.cu"
HTR_KERNELS = {  # wrapper -> (its CUDA kernel, the JAX function it replaces)
    "hash_pairs": ("lt_sha256_pairs_kernel", "lodestar_tpu/kernels/sha256.py:166"),
    "forest_sweep": ("lt_sha256_sweep_kernel", "lodestar_tpu/kernels/sha256.py:184"),
    "validator_roots": ("lt_sha256_validators_kernel", "lodestar_tpu/kernels/sha256.py:293"),
}
# the columnar fields of the stand-in state, in BeaconState's order
HTR_FIELDS = ("validators", "balances", "slashings", "previous_epoch_participation", "current_epoch_participation",
              "inactivity_scores")
# Hopper's integer pipes, lanes per SM and clock (CUDA programming guide,
# compute capability 9.0 throughput table; the pipes as Nsight Compute's
# metrics reference splits them): the ALU pipe runs shifts, logic, adds,
# compares and byte permutes; the FMA pipe runs IMAD and IMUL beside it;
# the four schedulers issue one warp instruction each a clock.  VIADD is
# taken on the FMA pipe: were it on the ALU pipe the bound would only rise,
# so the bound stays a floor either way.
PIPE_LANES_PER_CLK_PER_SM = {"alu": 64, "fma": 64, "issue": 128}
_FMA_PIPE = ("IMAD", "IMUL", "VIADD")
# SASS mnemonics that are no integer or logic operation of the hash
_NON_ALU = ("LDG", "STG", "LDS", "STS", "LDC", "BRA", "EXIT", "BAR", "NOP", "BSSY", "BSYNC", "S2R", "S2UR",
            "RET", "CALL", "WARPSYNC")


class HtrState:
    """The state the engine is handed: the six columnar fields of a
    BeaconState's registry, made from a seed with numpy.  Its container
    names only those fields; the engine never calls a columnar field's type."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        raw = rng.integers(0, 256, (n, 48), dtype=np.uint8).tobytes()
        self.pubkeys = [raw[i * 48:(i + 1) * 48] for i in range(n)]
        creds = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        creds[:, 0] = rng.integers(0, 2, n)  # BLS (0x00) and execution (0x01) credentials
        creds[creds[:, 0] == 1, 1:12] = 0
        raw = creds.tobytes()
        self.withdrawal_credentials = [raw[i * 32:(i + 1) * 32] for i in range(n)]
        gwei = 10**9
        self.effective_balance = np.full(n, 32 * gwei, np.uint64)
        low = rng.random(n) < 0.02
        self.effective_balance[low] = (rng.integers(16, 32, int(low.sum())) * gwei).astype(np.uint64)
        self.slashed = rng.random(n) < 0.001
        self.activation_eligibility_epoch = rng.integers(0, 250_000, n).astype(np.uint64)
        self.activation_epoch = self.activation_eligibility_epoch + rng.integers(1, 5_000, n).astype(np.uint64)
        self.exit_epoch = np.full(n, FAR_FUTURE_EPOCH, np.uint64)
        self.withdrawable_epoch = np.full(n, FAR_FUTURE_EPOCH, np.uint64)
        exited = np.nonzero((rng.random(n) < 0.01) | self.slashed)[0]
        self.exit_epoch[exited] = self.activation_epoch[exited] + rng.integers(256, 50_000, exited.size).astype(np.uint64)
        self.withdrawable_epoch[exited] = self.exit_epoch[exited] + np.uint64(256)
        self.balances = (self.effective_balance + rng.integers(0, gwei, n).astype(np.uint64)).astype(np.uint64)
        self.inactivity_scores = np.where(rng.random(n) < 0.05, rng.integers(1, 200, n), 0).astype(np.uint64)
        self.previous_epoch_participation = rng.integers(0, 8, n).astype(np.uint8)
        self.current_epoch_participation = rng.integers(0, 8, n).astype(np.uint8)
        self.slashings = np.zeros(SLASHINGS_VECTOR, np.uint64)
        self.slashings[rng.integers(0, SLASHINGS_VECTOR, 16)] = np.uint64(32 * gwei)

    def _container(self):
        class _Container:
            fields = [(name, None) for name in HTR_FIELDS]

        return _Container


def htr_tree_launches(dirty: np.ndarray, depth: int, min_rows: int, lanes: int):
    """(hash_pairs, forest_sweep) launches of one ChunkTree update with
    these dirty leaves: one sweep for a batch of at most `lanes`, else one
    hash_pairs launch for each level whose dirty parents reach `min_rows`."""
    idx = np.unique(dirty)
    if idx.size == 0:
        return 0, 0
    if idx.size <= lanes and depth > 0:
        return 0, 1
    launches = 0
    for _ in range(depth):
        idx = np.unique(idx >> 1)
        launches += idx.size >= min_rows
    return launches, 0


def htr_expected(before, after, cold: bool, min_rows: int, lanes: int, rotated: bool = False) -> dict:
    """The launches of one state root, from the dirty sets of the columns
    (`before` and `after`: dicts of numpy columns; `rotated`: the engine
    took the participation-rotation hint) and the level gate."""
    reg = 2**40
    depth = {"validators": 40, "balances": (reg * 8 // 32 - 1).bit_length(),
             "inactivity_scores": (reg * 8 // 32 - 1).bit_length(),
             "previous_epoch_participation": (reg // 32 - 1).bit_length(),
             "current_epoch_participation": (reg // 32 - 1).bit_length(),
             "slashings": (SLASHINGS_VECTOR * 8 // 32 - 1).bit_length()}
    per_chunk = {"balances": 4, "inactivity_scores": 4, "slashings": 4, "previous_epoch_participation": 32,
                 "current_epoch_participation": 32}
    out = {"hash_pairs": 0, "forest_sweep": 0, "validator_roots": 0}
    changed = 0
    n = after["balances"].shape[0]
    for name in HTR_FIELDS:
        if name == "validators":
            rows = np.arange(n) if cold else np.nonzero(np.any(
                [before[c] != after[c] for c in ("effective_balance", "slashed", "activation_eligibility_epoch",
                                                 "activation_epoch", "exit_epoch", "withdrawable_epoch")], axis=0))[0]
            if cold:
                out["hash_pairs"] += n >= min_rows  # the pubkey roots
            if rows.size:
                out["validator_roots"] += 1
        elif cold:
            rows = np.arange(-(-after[name].shape[0] // per_chunk[name]))
        else:
            old = before[name]
            if rotated and name in ("previous_epoch_participation", "current_epoch_participation"):
                # the engine swapped the two trees: each is diffed against the other list
                old = before["current_epoch_participation" if name.startswith("previous")
                             else "previous_epoch_participation"]
            rows = np.unique(np.nonzero(old != after[name])[0] // per_chunk[name])
        hp, sw = htr_tree_launches(rows, depth[name], min_rows, lanes)
        out["hash_pairs"] += hp
        out["forest_sweep"] += sw
        changed += bool(rows.size)
    if cold or changed:
        out["forest_sweep"] += 1  # the top tree over the fields' roots: at most 6 dirty chunks
    return out


def sass_pipe_counts(sass: str) -> dict:
    """Instructions of each kernel in a SASS listing (cuobjdump -sass), by
    pipe: "alu" and "fma" the integer and logic instructions on each
    (_FMA_PIPE on the FMA pipe, the rest but loads, stores, constant loads,
    control flow, special-register reads and uniform-datapath instructions
    on the ALU pipe), "issue" all of them; "mix" the integer ones by
    mnemonic."""
    import collections

    out, mix, cur = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            mix[cur] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur:
            mix[cur][m.group(1).split(".")[0]] += 1
    for fn, c in mix.items():
        name = next((k for k, (kernel, _) in HTR_KERNELS.items() if kernel in fn), fn)
        ints = {op: n for op, n in c.items() if op not in _NON_ALU and not op.startswith("U")}
        fma = sum(n for op, n in ints.items() if op in _FMA_PIPE)
        out[name] = {"alu": sum(ints.values()) - fma, "fma": fma, "issue": sum(c.values()),
                     "mix": dict(sorted(ints.items(), key=lambda kv: -kv[1]))}
    return out


def sass_clocks(counts: dict) -> float:
    """SM clocks that one SM needs to issue these instructions (one entry
    of sass_pipe_counts): the busiest pipe at its rate."""
    return max(counts[pipe] / lanes for pipe, lanes in PIPE_LANES_PER_CLK_PER_SM.items())


def sass_text(so_path: str) -> str:
    """The SASS listing of a built library (cuobjdump -sass)."""
    from lodestar_tpu_torch.kernels import build as B

    return subprocess.run([os.path.join(os.path.dirname(B.nvcc()), "cuobjdump"), "-sass", so_path],
                          check=True, capture_output=True, text=True).stdout


# Hopper's fixed-latency integer and logic instructions (IADD3, LOP3, SHF,
# IMAD, MOV, PRMT, ...): clocks from issue to a dependent instruction's issue
ALU_LATENCY_CLK = 4


def sass_chain_cycles(sass: str, kernel: str) -> int:
    """One thread's dependent critical path through a kernel of a SASS
    listing, in clocks: each integer or logic instruction (as
    sass_pipe_counts counts them) issues when its source registers are
    ready and makes its destination ready ALU_LATENCY_CLK later; loads,
    stores, constant reads and control flow take no time (the chain is the
    arithmetic).  For straight-line code such as one hash."""
    regs = lambda text: re.findall(r"\b(U?R\d+|U?P\d+)\b", text)  # noqa: E731
    ready, depth, cur = {}, 0, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if not m or not cur or kernel not in cur:
            continue
        op = m.group(2).split(".")[0]
        operands = [o for o in m.group(3).split(",") if o.strip()]
        alu = op not in _NON_ALU and not op.startswith("U")
        srcs = [r for o in operands[1:] for r in regs(o)] + regs(m.group(1) or "")
        start = max((ready.get(r, 0) for r in srcs), default=0)
        if alu or op.startswith("LD") or op.startswith("S2"):  # a store's first operand is its address
            for r in regs(operands[0]) if operands else ():
                ready[r] = start + (ALU_LATENCY_CLK if alu else 0)
        depth = max(depth, start + (ALU_LATENCY_CLK if alu else 0))
    return depth


def htr_phase(card: str, sm_mhz: float) -> tuple:
    """The hash-forest phase: the port's StateRootEngine on the card and,
    in step, a second engine on the host path (hashlib) over one
    HTR_VALIDATORS-validator registry state: a cold root, one slot and one
    epoch boundary; each root equal to the host's, each kernel's launches
    exactly the ones the dirty sets and the level gate give, no host level,
    the breaker closed; every kernel call of the path and each kernel alone
    at HTR_PAIR_SIZES / the slot's sweep plan / HTR_ROOT_SIZES held against
    its plain version on the card.  Returns (htr line, kernel rows)."""
    from lodestar_tpu_torch.kernels import build as B
    from lodestar_tpu_torch.kernels import sha256 as SK
    from lodestar_tpu_torch.ssz import device_backend as DB
    from lodestar_tpu_torch.state_transition import StateRootEngine

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    backend = DB.DeviceMerkleBackend()  # the card (the kernels are built here unless built before)
    t = time.perf_counter()
    state = HtrState(HTR_VALIDATORS, SEED)
    card_engine, host_engine = StateRootEngine(), StateRootEngine()
    min_rows, lanes = backend.min_level_rows, SK.HTR_SWEEP_LANES
    log(f"htr: backend on the card in {t - t_phase:.1f} s, {HTR_VALIDATORS} validators made in "
        f"{time.perf_counter() - t:.1f} s")

    # every wrapper call of the card path: its CUDA-event time (the output's
    # allocation, the launch and the kernel) and copies of its operands and
    # result, held against the plain version afterwards
    calls = {name: [] for name in HTR_KERNELS}
    real = {name: getattr(SK, name) for name in HTR_KERNELS}

    def recorder(name):
        def run(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = real[name](*args)
            b.record()
            calls[name].append((a, b, tuple(x.clone() for x in args), out.clone()))
            return out
        return run

    columns = ("effective_balance", "slashed", "activation_eligibility_epoch", "activation_epoch", "exit_epoch",
               "withdrawable_epoch", "balances", "inactivity_scores", "slashings", "previous_epoch_participation",
               "current_epoch_participation")

    def snapshot():
        return {c: getattr(state, c).copy() for c in columns}

    steps = {}

    def step(label, cold=False, rotated=False, before=None):
        expected = htr_expected(before, snapshot(), cold, min_rows, lanes, rotated)
        for name in HTR_KERNELS:
            setattr(SK, name, recorder(name))
        first = {name: len(c) for name, c in calls.items()}
        try:
            DB.set_backend(backend)
            torch.cuda.synchronize()
            SK.reset_launches()
            dispatch_s = backend.m_seconds.value
            t = time.perf_counter()
            root = card_engine.hash_tree_root(state)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t) * 1e3
            dispatch_ms = (backend.m_seconds.value - dispatch_s) * 1e3
            launches = dict(SK.LAUNCHES)
        finally:
            for name, f in real.items():
                setattr(SK, name, f)
            DB.set_backend(None)
        t = time.perf_counter()
        host_root = host_engine.hash_tree_root(state)
        host_ms = (time.perf_counter() - t) * 1e3
        DB.reset_backend()
        if root != host_root:
            raise AssertionError(f"htr {label}: the card's root {root.hex()} differs from the host's {host_root.hex()}")
        if launches != expected:
            raise AssertionError(f"htr {label}: launches {launches}, the dirty sets give {expected}")
        sup = backend.supervisor.status()
        if backend.m_host_levels.value or sup["state"] != "closed" or sup["last_failure"] is not None:
            raise AssertionError(f"htr {label}: {backend.m_host_levels.value} host levels, breaker {sup}")
        kernel_ms = {name: sum(a.elapsed_time(b) for a, b, _, _ in calls[name][first[name]:]) for name in HTR_KERNELS}
        steps[label] = {"card_ms": card_ms, "dispatch_ms": dispatch_ms, "host_ms": host_ms, "launches": launches,
                        "kernel_ms_in_path": kernel_ms, "root": root.hex()}
        log(f"htr {label}: card {card_ms:.1f} ms (in dispatches {dispatch_ms:.1f} ms, in the wrappers "
            f"{sum(kernel_ms.values()):.3f} ms, launches {launches}), host {host_ms:.1f} ms, roots equal")

    # 1. cold root
    step("cold", cold=True)
    rng = np.random.default_rng(SEED + 14)
    # 2. one slot: validator records (one slashed), balances, participation flags
    before = snapshot()
    rows = rng.choice(HTR_VALIDATORS, HTR_SLOT_RECORDS, replace=False)
    state.effective_balance[rows[: HTR_SLOT_RECORDS // 2]] -= np.uint64(10**9)
    state.exit_epoch[rows[HTR_SLOT_RECORDS // 2:]] = np.uint64(262_000)
    state.withdrawable_epoch[rows[HTR_SLOT_RECORDS // 2:]] = np.uint64(262_256)
    state.slashed[rows[0]] = True
    state.balances[rng.choice(HTR_VALIDATORS, HTR_SLOT_BALANCES, replace=False)] += np.uint64(12_345)
    flags = rng.choice(HTR_VALIDATORS, HTR_SLOT_FLAGS, replace=False)
    state.current_epoch_participation[flags] |= np.uint8(7)
    step("slot", before=before)
    # 3. an epoch boundary: rewards and penalties on every balance, every
    # inactivity score moves, the participation lists rotate
    before = snapshot()
    state.balances = (state.balances + rng.integers(1, 20_000, HTR_VALIDATORS).astype(np.uint64)).astype(np.uint64)
    state.inactivity_scores = (state.inactivity_scores + np.uint64(1)).astype(np.uint64)
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = np.zeros(HTR_VALIDATORS, np.uint8)
    card_engine.note_participation_rotation()
    host_engine.note_participation_rotation()
    step("epoch", rotated=True, before=before)
    path_s = time.perf_counter() - t_phase

    # every kernel call of the card path against its plain version
    t = time.perf_counter()
    held = {}
    for name, recs in calls.items():
        if not recs:
            raise AssertionError(f"htr: the path launched no {name}")
        plain = getattr(SK, name + "_plain")
        for _, _, args, out in recs:
            if not torch.equal(plain(*args), out):
                raise AssertionError(f"htr: a {name} call of the path ({tuple(args[0].shape)}) differs from its plain "
                                     f"version")
        held[name] = {"calls": len(recs), "rows": sum(int(r[2][0].shape[0]) for r in recs)}
    # the slot's validators sweep: the path's first sweep over the registry's 40 levels
    sweep_plan = next(r[2] for r in calls["forest_sweep"] if r[2][0].shape[0] == 40)
    log(f"htr: every call of the path equal to its plain version ({held}; {time.perf_counter() - t:.1f} s)")

    # each kernel alone at the path's shapes, against its plain version
    t = time.perf_counter()
    words = lambda shape: SK.to_tensor(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32), dev)  # noqa: E731
    alone = {}

    def hold(name, args, plain_runs=PLAIN_RUNS):
        k_ms, k_out = cuda_ms(lambda: getattr(SK, name)(*args))
        p_ms, p_out = cuda_ms(lambda: getattr(SK, name + "_plain")(*args), runs=plain_runs, warm=False)
        err = int((k_out.to(torch.int64) - p_out.to(torch.int64)).abs().max()) if k_out.numel() else 0
        if err or not torch.equal(k_out, p_out):
            raise AssertionError(f"htr: {name} at {tuple(args[0].shape)} differs from its plain version")
        return k_ms, p_ms, err

    for n in HTR_PAIR_SIZES:
        alone["hash_pairs", n] = hold("hash_pairs", (words((n, 16)),))
    # without live counts (every lane hashed, JAX's semantics), every odd
    # lane's digest dropped
    dead = [x.clone() for x in sweep_plan[:3]]
    dead[1][:, 1::2] = dead[1].shape[1] + 3

    def live_lanes(plan):
        """Lanes whose digest the plan uses: with live counts their sum,
        else those scattered into the next level, and the root."""
        if len(plan) > 3:
            return int(plan[3].sum())
        lane = plan[1]
        return int((lane[:-1] < lane.shape[1]).sum()) + 1

    # the chain alone: 40 levels of one live lane, each digest the next row's half
    k_sweep = sweep_plan[0].shape[0]
    one_lane = (words((k_sweep, 1, 16)), torch.zeros((k_sweep, 1), dtype=torch.int32, device=dev),
                torch.from_numpy(rng.integers(0, 2, (k_sweep, 1)).astype(np.int32)).to(dev),
                torch.ones(k_sweep, dtype=torch.int32, device=dev))
    live = {"slot_plan": live_lanes(sweep_plan), "dead_lanes": live_lanes(dead), "one_lane": k_sweep}
    alone["forest_sweep", "slot_plan"] = hold("forest_sweep", sweep_plan)
    alone["forest_sweep", "dead_lanes"] = hold("forest_sweep", tuple(dead))
    alone["forest_sweep", "one_lane"] = hold("forest_sweep", one_lane)
    if sweep_plan[3].tolist() != sorted(sweep_plan[3].tolist(), reverse=True) or int(sweep_plan[3][-1]) != 1:
        raise AssertionError(f"htr: the slot plan's live lanes {sweep_plan[3].tolist()}")
    for n in HTR_ROOT_SIZES:
        cols = [words((n, 8)), words((n, 8))] + [words((n, 2)) for _ in range(5)]
        cols.append(SK.to_tensor(rng.integers(0, 2, n).astype(np.uint32), dev))
        alone["validator_roots", n] = hold("validator_roots", cols)
    log(f"htr: each kernel alone equal to its plain version ({time.perf_counter() - t:.1f} s)")

    # bounds: each kernel's SASS instructions, pipe by pipe, over the card's
    # rate for that pipe (the busiest pipe), or its bytes over the memory rate
    listing = sass_text(str(B.build_all()["sha256"]))
    sass = sass_pipe_counts(listing)
    ptxas = ptxas_entries(B.ptxas_report()["sha256"])
    clk_per_ms = sm_mhz * 1e3
    per_hash = sass_clocks(sass["hash_pairs"])  # one hash, straight-line code
    per_validator = sass_clocks(sass["validator_roots"])  # seven hashes and the packing, straight-line
    # the sweep's chain floor: its K levels are K dependent hashes, so no
    # design beats K x one hash's dependent critical path.  Beside it, this
    # build's own floor for a lone warp: its instructions at one warp's
    # share of each pipe (an SM's 4 sub-partitions each issue one warp
    # instruction a clock to 16-lane ALU and FMA pipes: 128 x sass_clocks),
    # which follows the compiler's instruction mix and is not the bound
    chain_clk = sass_chain_cycles(listing, HTR_KERNELS["hash_pairs"][0])
    warp_clk = 128 * per_hash
    chain_floor_ms = k_sweep * chain_clk / clk_per_ms
    one_warp_issue_ms = k_sweep * max(chain_clk, warp_clk) / clk_per_ms
    log(f"htr: forest_sweep chain floor {chain_floor_ms:.6f} ms ({k_sweep} x {chain_clk} clk at {sm_mhz:.0f} MHz), "
        f"this build's lone-warp issue floor {one_warp_issue_ms:.6f} ms ({k_sweep} x {max(chain_clk, warp_clk)} clk), "
        f"the ({k_sweep}, 1) one-lane sweep {alone['forest_sweep', 'one_lane'][0]:.6f} ms, "
        f"the slot plan {alone['forest_sweep', 'slot_plan'][0]:.6f} ms")

    def bound(name, n):
        if name == "hash_pairs":
            clocks, nbytes = n * per_hash, n * (64 + 32)
        elif name == "forest_sweep":  # the live lanes' hashes, their pairs, maps and digests
            clocks, nbytes = n * per_hash, n * (64 + 8 + 32)
        else:
            clocks, nbytes = n * per_validator, n * (2 * 32 + 5 * 8 + 4 + 32)
        ops_ms, bytes_ms = clocks / N_SM / clk_per_ms, nbytes / PEAK_BYTES_PER_S * 1e3
        if name == "forest_sweep":  # the larger of the throughput bound and the chain floor (operations both)
            ops_ms = max(ops_ms, chain_floor_ms)
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"

    rows_out = []
    path_shape = {"hash_pairs": HTR_VALIDATORS, "forest_sweep": "slot_plan", "validator_roots": HTR_VALIDATORS}
    for name, (kernel, replaces) in HTR_KERNELS.items():
        shape = path_shape[name]
        k_ms, p_ms, err = alone[name, shape]
        b_ms, b_by = bound(name, live["slot_plan"] if name == "forest_sweep" else shape)
        entry = {
            "name": name, "route": "cuda", "source": HTR_SOURCE, "replaces": replaces,
            "launches": sum(s["launches"][name] for s in steps.values()), "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "path": "state_root", "n": shape,
            "launches_by_step": {label: s["launches"][name] for label, s in steps.items()},
            "ms_in_path_by_step": {label: s["kernel_ms_in_path"][name] for label, s in steps.items()},
            "path_calls_held": held[name],
            "ms_by_size": {str(key[1]): v[0] for key, v in alone.items() if key[0] == name},
            "plain_ms_by_size": {str(key[1]): v[1] for key, v in alone.items() if key[0] == name},
            "bound_ms_by_size": {str(key[1]): bound(name, live.get(key[1], key[1]))[0]
                                 for key in alone if key[0] == name},
            "sass_instructions": {pipe: sass[name][pipe] for pipe in PIPE_LANES_PER_CLK_PER_SM},
            "sass_int_mix": sass[name]["mix"], "pipe_lanes_per_clk_per_sm": PIPE_LANES_PER_CLK_PER_SM,
            "ptxas": next((v for k, v in ptxas.items() if kernel in k), None), "card": card,
        }
        entry.update({"launches_per_flush": None, "applies_per_launch": None, "live": None,
                      "chain_floor_ms": None, "one_lane_ms": None})
        if name == "forest_sweep":
            entry.update({
                "live": sweep_plan[3].tolist(), "live_lanes_slot_plan": live["slot_plan"],
                "plan_shape": list(sweep_plan[0].shape[:2]), "chain_floor_ms": chain_floor_ms,
                "one_lane_ms": alone[name, "one_lane"][0], "bound_kind": "chain floor" if b_ms == chain_floor_ms
                else "throughput", "throughput_bound_ms": max(live["slot_plan"] * per_hash / N_SM / clk_per_ms,
                                                              live["slot_plan"] * (64 + 8 + 32) / PEAK_BYTES_PER_S * 1e3),
                "chain_clk_per_hash": chain_clk, "one_warp_clk_per_hash": warp_clk,
                "one_warp_issue_floor_ms": one_warp_issue_ms,
                "alu_latency_clk": ALU_LATENCY_CLK, "sm_mhz": sm_mhz,
            })
        if name == "validator_roots":
            entry["note"] = "its first phase is pack_validator_blocks_device (lodestar_tpu/kernels/sha256.py:250)"
        rows_out.append(entry)
    line = {"validators": HTR_VALIDATORS, "min_level_rows": min_rows, "sweep_lanes": lanes, "steps": steps,
            "breaker": backend.supervisor.status()["state"], "host_fallback_levels": backend.m_host_levels.value,
            "dispatches": backend.dispatches, "peak_dispatch_bytes": backend.peak_dispatch_bytes,
            "path_s": path_s, "phase_s": time.perf_counter() - t_phase, "card": card}
    log("htr " + json.dumps(line))
    return line, rows_out


# -- the slasher: SlasherService with its span planes on the card ----------------

SLASHER_VALIDATORS = 1 << 20  # every validator of a mainnet-scale registry
SLASHER_HISTORY = 4096  # slasher_history_length (node.py:79, the Lighthouse default)
SLASHER_CHUNK = 16
SLASHER_EPOCHS = 4
SLASHER_COMMITTEE = 512  # 1,048,576 / 32 slots / 64 committees (MAX_COMMITTEES_PER_SLOT)
SLASHER_COMMITTEES_PER_SLOT = 64
SLASHER_FINALIZED = 2
SLASHER_SAMPLE_ROWS = 4096  # rows of the card's planes held against the numpy SpanState
SLASHER_ALONE_ROWS = 65536  # planes of the kernel-alone check: 65,536 x 4,096
SLASHER_ALONE_SELECTED = 512
SLASHER_FLUSH_DATAS = 512  # the flush drain: a flush's (max_batch) committees, one launch
SLASHER_LAUNCHES_PER_FLUSH = 3  # the most a flush may make: the batch drains at a row cap, an overlap or a read
SPANS_SOURCE = "lodestar_tpu_torch/kernels/csrc/spans.cu"
SPANS_REPLACES = "lodestar_tpu/slasher/device.py:39"


def _slasher_att(validators, slot: int, index: int, head: bytes, source: int, target: int) -> dict:
    return {
        "attesting_indices": validators,
        "data": {
            "slot": slot, "index": index, "beacon_block_root": head,
            "source": {"epoch": source, "root": source.to_bytes(32, "little")},
            "target": {"epoch": target, "root": (target + 1000).to_bytes(32, "little")},
        },
        "signature": b"\x00" * 96,
    }


def _slasher_block(slot: int, proposer: int, graffiti: bytes) -> dict:
    from lodestar_tpu_torch import params as TP

    body = {
        "randao_reveal": b"\x00" * 96,
        "eth1_data": {"deposit_root": b"\x00" * 32, "deposit_count": 0, "block_hash": b"\x00" * 32},
        "graffiti": graffiti, "proposer_slashings": [], "attester_slashings": [], "attestations": [],
        "deposits": [], "voluntary_exits": [],
        "sync_aggregate": {"sync_committee_bits": [False] * TP.SYNC_COMMITTEE_SIZE,
                           "sync_committee_signature": bytes([0xC0]) + b"\x00" * 95},
    }
    return {"message": {"slot": slot, "proposer_index": proposer, "parent_root": b"\x01" * 32,
                        "state_root": b"\x02" * 32, "body": body}, "signature": b"\x00" * 96}


def spans_bound_ms(rows: int, h: int, s_col: int, t_col: int) -> float:
    """The span update's least time: the cells it must read and may
    write, (min columns + max columns) x rows x 4 B, each read once and
    written once, over the memory rate."""
    from lodestar_tpu_torch.kernels import spans as SP

    n_min, n_max = SP.cells_updated(h, s_col, t_col)
    return (n_min + n_max) * rows * 4 * 2 / PEAK_BYTES_PER_S * 1e3


def slasher_phase(card: str, dev=None) -> tuple:
    """The slasher phase: the port's SlasherService (no chain, no db,
    history SLASHER_HISTORY, chunk SLASHER_CHUNK) with its span planes on
    the card, sized once to SLASHER_VALIDATORS rows; SLASHER_EPOCHS epochs
    in which every validator attests once (committees of 512, 64 a slot,
    one aggregate IndexedAttestation each, through ingest_attestation),
    then on_finalized(SLASHER_FINALIZED), which shifts both planes on the
    card; then planted offences (a double vote, a surround, a surrounded
    vote, the old-source attack, a double proposal).  Checks: the
    detections by kind and offender equal the planted ones and the port's
    NaiveAttesterSlasher's over the same stream; SLASHER_SAMPLE_ROWS
    sampled rows and every offender's row of the card's planes equal a
    numpy SpanState fed the same applies; the kernel's launches equal the
    applies that can change a cell; the kernel alone equals its plain
    version on SLASHER_ALONE_ROWS x SLASHER_HISTORY planes.  Returns
    (slasher line, kernel rows)."""
    from lodestar_tpu_torch.chain.op_pools import attester_slashing_intersection
    from lodestar_tpu_torch.kernels import build as B
    from lodestar_tpu_torch.kernels import spans as SP
    from lodestar_tpu_torch.slasher import NaiveAttesterSlasher, SlasherService, SpanState, TorchSpanState
    from lodestar_tpu_torch.slasher.batch import MAX_SPAN_SENTINEL, MIN_SPAN_SENTINEL

    t_phase = time.perf_counter()
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    v_all, h = SLASHER_VALIDATORS, SLASHER_HISTORY
    rng = np.random.default_rng(SEED + 15)
    svc = SlasherService(chain=None, db=None, history_length=h, chunk_size=SLASHER_CHUNK,
                         device=None if dev.type == "cuda" else dev)
    spans = svc.attester.spans
    if not isinstance(spans, TorchSpanState) or spans.device.type != dev.type:
        raise AssertionError(f"slasher: span planes on {getattr(spans, 'device', None)}, not {dev.type}")
    svc.start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    spans.ensure_validators(v_all)
    torch.cuda.synchronize()
    growth_ms = (time.perf_counter() - t) * 1e3
    if spans.num_validators != v_all:
        raise AssertionError(f"slasher: planes of {spans.num_validators} rows, not {v_all}")
    plane_gib = 2 * spans.min_spans.numel() * 4 / 2**30

    # offenders: a (double vote), b (surround), c (surrounded), d (the
    # old-source attack: online every epoch, so its regular votes of
    # epochs 2.. outlive the finalization and its old-source vote
    # surrounds them), and a double-proposing proposer
    a, b, c, d, proposer = (int(x) for x in rng.choice(v_all, 5, replace=False))
    sample = np.unique(np.concatenate([rng.choice(v_all, SLASHER_SAMPLE_ROWS, replace=False), [a, b, c, d]]))
    local = np.full(v_all, -1, np.int64)
    local[sample] = np.arange(sample.size)
    mirror = SpanState(num_validators=sample.size, history_length=h, chunk_size=SLASHER_CHUNK)

    # the path's hooks: the applies fed to the numpy mirror, their host
    # time, the launches they should make, the lookups, the flushes
    # the drains' host time (the launch and its rows' copy) is taken out of
    # the apply, lookup or window shift that made them
    acc = {"applies": 0, "changing_applies": 0, "apply_s": 0.0, "lookups": 0, "lookup_s": 0.0, "advance_s": 0.0,
           "drain_s": 0.0, "drain_in_flush_s": 0.0, "in_flush": False}
    flush_s, flush_launches, batches, found, drains_outside = [], [], [], [], {}
    real_apply, real_lookup, real_advance, real_drain = spans.apply, spans.lookup, spans.advance_base, spans.drain
    real_batch, real_emit_a, real_emit_p = svc.attester.process_batch, svc._emit_attester, svc._emit_proposer

    def timed(fn, key, *args):
        d0, t0 = acc["drain_s"], time.perf_counter()
        out = fn(*args)
        acc[key] += time.perf_counter() - t0 - (acc["drain_s"] - d0)
        return out

    def drain(reason):
        t0, n0 = time.perf_counter(), SP.LAUNCHES["span_update"]
        real_drain(reason)
        dt = time.perf_counter() - t0
        acc["drain_s"] += dt
        acc["drain_in_flush_s"] += dt if acc["in_flush"] else 0.0
        if not acc["in_flush"] and SP.LAUNCHES["span_update"] > n0:
            drains_outside[reason] = drains_outside.get(reason, 0) + 1

    def apply(rows, s, t):
        sc, tc = s - spans.base_epoch, t - spans.base_epoch
        acc["applies"] += 1
        acc["changing_applies"] += int(len(rows) > 0 and SP.touched_columns(h, sc, tc) > 0)
        timed(real_apply, "apply_s", rows, s, t)
        lr = local[np.asarray(rows, np.int64)]
        mirror.apply(lr[lr >= 0], s, t)

    def lookup(rows, s):
        acc["lookups"] += 1
        return timed(real_lookup, "lookup_s", rows, s)

    def advance_base(new_base):
        timed(lambda: (real_advance(new_base), torch.cuda.synchronize()), "advance_s")
        mirror.advance_base(new_base)

    def process_batch(batch):
        batches.append(batch)
        t0, n0 = time.perf_counter(), SP.LAUNCHES["span_update"]
        acc["in_flush"] = True
        try:
            out = real_batch(batch)
        finally:
            acc["in_flush"] = False
        flush_s.append(time.perf_counter() - t0)
        flush_launches.append(SP.LAUNCHES["span_update"] - n0)
        return out

    def emit_attester(kind, slashing):
        found.append((kind, tuple(attester_slashing_intersection(slashing))))
        return real_emit_a(kind, slashing)

    def emit_proposer(slashing):
        m = slashing["signed_header_1"]["message"]
        found.append(("double_propose", (int(m["slot"]), int(m["proposer_index"]))))
        return real_emit_p(slashing)

    spans.apply, spans.lookup, spans.advance_base, spans.drain = apply, lookup, advance_base, drain
    svc.attester.process_batch, svc._emit_attester, svc._emit_proposer = process_batch, emit_attester, emit_proposer

    # the traffic: every validator once an epoch, 2,048 committees of 512
    t = time.perf_counter()
    epochs = []
    n_slots = SLASHER_VALIDATORS // (SLASHER_COMMITTEE * SLASHER_COMMITTEES_PER_SLOT)
    for e in range(1, SLASHER_EPOCHS + 1):
        committees = np.sort(rng.permutation(v_all).reshape(-1, SLASHER_COMMITTEE), axis=1)
        heads = [rng.bytes(32) for _ in range(n_slots)]
        atts = []
        for ci, members in enumerate(committees.tolist()):
            slot, index = e * n_slots + ci // SLASHER_COMMITTEES_PER_SLOT, ci % SLASHER_COMMITTEES_PER_SLOT
            atts.append(_slasher_att(members, slot, index, heads[ci // SLASHER_COMMITTEES_PER_SLOT], e - 1, e))
        epochs.append(atts)
    make_s = time.perf_counter() - t

    # the path, counted: every count set to 0 just before, read just after
    torch.cuda.synchronize()
    SP.reset_launches()
    t_path = time.perf_counter()
    n_ingested = 0
    for atts in epochs:
        for att in atts:
            svc.ingest_attestation(att)
            n_ingested += 1
        svc.flush()
    torch.cuda.synchronize()
    traffic_s = time.perf_counter() - t_path
    n_before_final = len(batches)
    t = time.perf_counter()
    svc.on_finalized(SLASHER_FINALIZED)
    torch.cuda.synchronize()
    finalize_ms = (time.perf_counter() - t) * 1e3
    if spans.base_epoch != SLASHER_FINALIZED:
        raise AssertionError(f"slasher: window base {spans.base_epoch} after on_finalized({SLASHER_FINALIZED})")
    # the planted offences: first halves, a flush, second halves, a flush
    e5 = (SLASHER_EPOCHS + 1) * n_slots
    a_committee = next(x for x in epochs[-1] if a in x["attesting_indices"])
    double = _slasher_att([a], a_committee["data"]["slot"], a_committee["data"]["index"], b"\xdd" * 32,
                          SLASHER_EPOCHS - 1, SLASHER_EPOCHS)
    firsts = [double, _slasher_att([b], e5, 0, b"\xb1" * 32, 5, 10), _slasher_att([c], e5, 1, b"\xc1" * 32, 4, 12),
              _slasher_att([d], e5, 2, b"\xd1" * 32, 1, 14)]  # d's source 1 is below the window base 2
    seconds = [_slasher_att([b], e5 + 1, 0, b"\xb2" * 32, 4, 12), _slasher_att([c], e5 + 1, 1, b"\xc2" * 32, 6, 8),
               _slasher_att([d], e5 + 1, 2, b"\xd2" * 32, 7, 9)]
    for half in (firsts, seconds):
        for att in half:
            svc.ingest_attestation(att)
            n_ingested += 1
        svc.flush()
    svc.ingest_block(_slasher_block(e5 + 3, proposer, b"\x00" * 32))
    svc.ingest_block(_slasher_block(e5 + 3, proposer, b"\x42" * 32))
    spans.min_spans  # a read of the planes: drains what the last flush left pending
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches, carried = SP.LAUNCHES["span_update"], SP.APPLIES["span_update"]
    drains = {k: v for k, v in spans.drains.items() if v}
    svc.stop()  # memory-only store: no snapshot, no plane leaves the card

    # d's old-source vote (1, 14) surrounds each of its regular votes
    # (e - 1, e) that outlives the finalization (e >= SLASHER_FINALIZED)
    # and has a source above 1; they are found on the host (the vote's
    # source lies below the window base)
    d_surrounds = [("surround", (d,)) for e in range(SLASHER_FINALIZED, SLASHER_EPOCHS + 1) if 1 < e - 1 and e < 14]
    planted = sorted([("double_vote", (a,)), ("surround", (b,)), ("surrounded", (c,)), ("surrounded", (d,)),
                      ("double_propose", (e5 + 3, proposer))] + d_surrounds)
    if sorted(found) != planted:
        raise AssertionError(f"slasher: detections {sorted(found)}, planted {planted}")
    want_counts = {"double_vote": 1, "surround": 1 + len(d_surrounds), "surrounded": 2, "double_propose": 1}
    if svc.detections != want_counts:
        raise AssertionError(f"slasher: detections by kind {svc.detections}, planted {want_counts}")
    # every apply that can change a cell rides in exactly one launch: the
    # launches carried as many applies as there were, each drain made one
    # launch, and no flush made more than SLASHER_LAUNCHES_PER_FLUSH (the
    # drains at the window shift and the final read fall outside flushes)
    n_flush = len(flush_s)
    outside = launches - sum(flush_launches)
    if outside != sum(drains_outside.values()):
        raise AssertionError(f"slasher: {outside} launches outside flushes, drains there {drains_outside}")
    if carried != acc["changing_applies"] or sum(drains.values()) != launches or not launches:
        raise AssertionError(f"slasher: {launches} span_update launches carried {carried} applies, the applies that "
                             f"can change a cell {acc['changing_applies']}, drains {drains}")
    if max(flush_launches) > SLASHER_LAUNCHES_PER_FLUSH:
        raise AssertionError(f"slasher: span_update launches by flush {flush_launches}, at most "
                             f"{SLASHER_LAUNCHES_PER_FLUSH} a flush")
    log(f"slasher: {acc['applies']} applies ({acc['changing_applies']} can change a cell) in {launches} launches: "
        f"{flush_launches} by flush, {outside} outside flushes {drains_outside}; drains by reason {drains}")

    # the port's naive detector over the same stream
    t = time.perf_counter()
    naive, naive_found = NaiveAttesterSlasher(), []
    for i, batch in enumerate(batches):
        if i == n_before_final:
            naive.prune(SLASHER_FINALIZED)
        naive_found += [(k, tuple(attester_slashing_intersection(sl))) for k, sl in naive.process_batch(batch)]
    naive_s = time.perf_counter() - t
    if sorted(naive_found) != [p for p in planted if p[0] != "double_propose"]:
        raise AssertionError(f"slasher: the naive detector found {sorted(naive_found)}")

    # the card's planes against the numpy mirror on the sampled rows
    t = time.perf_counter()
    idx = torch.from_numpy(sample).to(dev)
    card_min, card_max = spans.min_spans[idx].cpu().numpy(), spans.max_spans[idx].cpu().numpy()
    if not (np.array_equal(card_min, mirror.min_spans) and np.array_equal(card_max, mirror.max_spans)):
        bad = np.nonzero((card_min != mirror.min_spans).any(1) | (card_max != mirror.max_spans).any(1))[0]
        raise AssertionError(f"slasher: {bad.size} sampled rows differ from numpy's (first {int(sample[bad[0]])})")
    moved = int((mirror.max_spans != int(MAX_SPAN_SENTINEL)).sum() + (mirror.min_spans != int(MIN_SPAN_SENTINEL)).sum())
    rows_check_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    status = svc.status()
    del svc, spans, idx
    real_apply = real_lookup = real_advance = real_drain = real_batch = real_emit_a = real_emit_p = None
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel alone on SLASHER_ALONE_ROWS x h planes against its plain version
    t = time.perf_counter()
    n_alone = SLASHER_ALONE_ROWS
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)  # made on the card: 2 GiB of planes
    mn0 = torch.randint(-4, 4000, (n_alone, h), generator=gen, device=dev, dtype=torch.int32)
    mx0 = torch.randint(-4, 4000, (n_alone, h), generator=gen, device=dev, dtype=torch.int32)
    mn0[mn0 > 3900] = int(MIN_SPAN_SENTINEL)
    mx0[mx0 > 3900] = int(MAX_SPAN_SENTINEL)
    mn, mx = mn0.clone(), mx0.clone()
    sel = torch.from_numpy(np.sort(rng.choice(n_alone, SLASHER_ALONE_SELECTED, replace=False))).to(dev)
    every = torch.arange(n_alone, dtype=torch.int64, device=dev)
    last_s, last_t = SLASHER_EPOCHS - 1, SLASHER_EPOCHS  # the path's widest apply: epoch 4 at window base 0
    cases = {
        "path": (sel, last_s, last_t),
        "rows_512": (sel, 1000, 3000),
        "every_row_t_last": (every, h // 2, h - 1),
        "source_below": (sel, -5, 2000),
        "source_eq_target": (sel, 1500, 1500),
        "empty": (torch.zeros(0, dtype=torch.int64, device=dev), 3, 10),
        "launch_floor": (sel[:1], 1, 1),  # one row, one cell
    }
    alone, max_err = {}, 0

    def time_runs(fn, reset):
        """Median CUDA-event ms of TIMED_RUNS calls, the planes reset from
        the originals before each, so every run writes."""
        times = []
        for _ in range(TIMED_RUNS):
            reset()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            fn()
            ev1.record()
            ev1.synchronize()
            times.append(ev0.elapsed_time(ev1))
        return statistics.median(times)

    def reset():
        mn.copy_(mn0)
        mx.copy_(mx0)

    for name, (rows, s_col, t_col) in cases.items():
        mask = torch.zeros(n_alone, dtype=torch.bool, device=dev)
        mask[rows] = True
        before = SP.LAUNCHES["span_update"]
        SP.span_update(mn, mx, rows, s_col, t_col)
        torch.cuda.synchronize()
        made = SP.LAUNCHES["span_update"] - before
        want_min, want_max = SP.span_update_planes_plain(mn0, mx0, mask, s_col, t_col)
        err = max(int((mn.to(torch.int64) - want_min).abs().max()), int((mx.to(torch.int64) - want_max).abs().max()))
        max_err = max(max_err, err)
        if err or not (torch.equal(mn, want_min) and torch.equal(mx, want_max)):
            raise AssertionError(f"slasher: span_update alone ({name}) differs from its plain version")
        if made != int(rows.numel() > 0 and SP.touched_columns(h, s_col, t_col) > 0):
            raise AssertionError(f"slasher: span_update alone ({name}) made {made} launches")
        del want_min, want_max
        k_ms = time_runs(lambda: SP.span_update(mn, mx, rows, s_col, t_col), reset)
        p_ms, _ = cuda_ms(lambda: SP.span_update_planes_plain(mn0, mx0, mask, s_col, t_col), runs=PLAIN_RUNS)
        n_rows = int(torch.unique(rows).numel())
        alone[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": spans_bound_ms(n_rows, h, s_col, t_col),
                       "rows": n_rows, "s_col": s_col, "t_col": t_col, "datas": 1,
                       "cells_per_row": SP.cells_updated(h, s_col, t_col)}
        reset()
    del mn, mx, mn0, mx0
    torch.cuda.empty_cache()

    # the flush drain: one launch of a flush's 512 disjoint committees of
    # 512 at the path's widest columns, on planes of those 262,144 rows,
    # against the plain version data after data
    v_flush = SLASHER_FLUSH_DATAS * SLASHER_COMMITTEE
    mn0 = torch.randint(-4, 4000, (v_flush, h), generator=gen, device=dev, dtype=torch.int32)
    mx0 = torch.randint(-4, 4000, (v_flush, h), generator=gen, device=dev, dtype=torch.int32)
    mn, mx = mn0.clone(), mx0.clone()
    committees = np.sort(rng.permutation(v_flush).reshape(SLASHER_FLUSH_DATAS, SLASHER_COMMITTEE), axis=1)
    rows = torch.from_numpy(committees.reshape(-1)).to(dev)
    seg = np.arange(SLASHER_FLUSH_DATAS + 1, dtype=np.int64) * SLASHER_COMMITTEE
    s_cols, t_cols = [last_s] * SLASHER_FLUSH_DATAS, [last_t] * SLASHER_FLUSH_DATAS

    def plain_flush():
        pm, px = mn0, mx0
        for d in range(SLASHER_FLUSH_DATAS):
            mask = torch.zeros(v_flush, dtype=torch.bool, device=dev)
            mask[rows[seg[d] : seg[d + 1]]] = True
            pm, px = SP.span_update_planes_plain(pm, px, mask, s_cols[d], t_cols[d])
        return pm, px

    before = SP.LAUNCHES["span_update"], SP.APPLIES["span_update"]
    SP.span_update_many(mn, mx, rows, seg, s_cols, t_cols)
    torch.cuda.synchronize()
    made = SP.LAUNCHES["span_update"] - before[0], SP.APPLIES["span_update"] - before[1]
    if made != (1, SLASHER_FLUSH_DATAS):
        raise AssertionError(f"slasher: the flush drain made {made} (launches, applies carried)")
    p_ms, (want_min, want_max) = cuda_ms(plain_flush, runs=1, warm=False)
    err = max(int((mn.to(torch.int64) - want_min).abs().max()), int((mx.to(torch.int64) - want_max).abs().max()))
    max_err = max(max_err, err)
    if err or not (torch.equal(mn, want_min) and torch.equal(mx, want_max)):
        raise AssertionError("slasher: span_update_many (the flush drain) differs from its plain version")
    del want_min, want_max
    k_ms = time_runs(lambda: SP.span_update_many(mn, mx, rows, seg, s_cols, t_cols), reset)
    # the launch alone: the plan already on the card, no host preparation
    plan = SP.span_plan(mn, mx, seg, np.array(s_cols, np.int64), np.array(t_cols, np.int64))
    args, lib = plan.args(mn, mx, rows), B.load("spans")
    torch.cuda.synchronize()

    def launch():
        if lib.lt_span_update_many(*args, torch.cuda.current_stream().cuda_stream):
            raise AssertionError("slasher: lt_span_update_many refused the flush drain")

    launch_ms = time_runs(launch, reset)
    cells = sum(SP.cells_updated(h, last_s, last_t))
    alone["flush_drain"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": spans_bound_ms(v_flush, h, last_s, last_t),
                            "rows": v_flush, "s_col": last_s, "t_col": last_t, "datas": SLASHER_FLUSH_DATAS,
                            "cells_per_row": SP.cells_updated(h, last_s, last_t), "launch_ms": launch_ms,
                            # each row's cells sit in one 32-byte sector, read and written
                            "sector_bound_ms": v_flush * -(-cells * 4 // 32) * 32 * 2 / PEAK_BYTES_PER_S * 1e3}
    del mn, mx, mn0, mx0, rows, plan
    torch.cuda.empty_cache()
    alone_s = time.perf_counter() - t
    log(f"slasher: span_update alone equal to its plain version on {n_alone} x {h} planes and the flush drain on "
        f"{v_flush} x {h}, "
        + ", ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f}, bound {v['bound_ms']:.6f})"
                    for k, v in alone.items()) + f" ({alone_s:.1f} s)")

    line = {
        "validators": v_all, "history": h, "chunk": SLASHER_CHUNK, "epochs": SLASHER_EPOCHS,
        "committee": SLASHER_COMMITTEE, "attestations": n_ingested, "applies": acc["applies"],
        "kernel_launches": launches, "applies_carried": carried, "drains_by_reason": drains,
        "launches_per_flush": launches / n_flush, "launches_by_flush": flush_launches,
        "launches_outside_flushes": outside, "drains_outside_flushes": drains_outside,
        "applies_changing_no_cell": acc["applies"] - acc["changing_applies"],
        "lookups": acc["lookups"], "flushes": n_flush,
        "flush_ms_p50": statistics.median(flush_s) * 1e3, "flush_ms_max": max(flush_s) * 1e3,
        "atts_per_s_ingest_and_flush": SLASHER_EPOCHS * len(epochs[0]) / traffic_s,
        "validator_votes_per_s": sum(len(x["attesting_indices"]) for ep in epochs for x in ep) / traffic_s,
        "plane_gib": plane_gib, "peak_allocated_gib": peak_gib, "growth_ms": growth_ms,
        "advance_ms": acc["advance_s"] * 1e3, "on_finalized_ms": finalize_ms,
        "detections": dict(status["detections"]), "planted_equal": True, "naive_equal": True,
        "sampled_rows": int(sample.size), "sampled_cells_moved": moved,
        "time_s": {"make_traffic": make_s, "traffic_ingest_and_flush": traffic_s, "path": path_s,
                   "in_flush": sum(flush_s), "in_apply": acc["apply_s"], "in_lookup": acc["lookup_s"],
                   "in_drain": acc["drain_s"], "in_flush_drain": acc["drain_in_flush_s"],
                   "in_flush_rest": sum(flush_s) - acc["apply_s"] - acc["lookup_s"] - acc["drain_in_flush_s"],
                   "naive": naive_s,
                   "rows_check": rows_check_s, "kernel_alone": alone_s},
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    log("slasher " + json.dumps(line))
    ptxas = ptxas_entries(B.ptxas_report()["spans"]) if dev.type == "cuda" else {}
    drained = alone["flush_drain"]
    row = {
        "name": "span_update", "route": "cuda", "source": SPANS_SOURCE, "replaces": SPANS_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": drained["ms"], "plain_ms": drained["plain_ms"],
        "bound_ms": drained["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "path": "slasher", "n": "flush_drain",
        "launch_floor_ms": alone["launch_floor"]["ms"],
        "launches_per_flush": launches / n_flush, "applies_per_launch": carried / launches,
        "live": None, "chain_floor_ms": None, "one_lane_ms": None,
        "most_launches_in_a_flush": max(flush_launches), "launches_outside_flushes": outside,
        "drains_by_reason": drains,
        "ms_by_case": {k: v["ms"] for k, v in alone.items()},
        "plain_ms_by_case": {k: v["plain_ms"] for k, v in alone.items()},
        "bound_ms_by_case": {k: v["bound_ms"] for k, v in alone.items()},
        "flush_drain_sector_bound_ms": drained["sector_bound_ms"],
        "flush_drain_launch_ms": drained["launch_ms"],
        "case_shapes": {k: {"rows": v["rows"], "datas": v["datas"], "s_col": v["s_col"], "t_col": v["t_col"],
                            "min_max_columns": v["cells_per_row"]} for k, v in alone.items()},
        "planes": [SLASHER_ALONE_ROWS, h], "flush_drain_planes": [SLASHER_FLUSH_DATAS * SLASHER_COMMITTEE, h],
        "ptxas": {k: v for k, v in ptxas.items() if "lt_span_update_kernel" in k} or None, "card": card,
    }
    return line, [row]


# -- the node ------------------------------------------------------------------

NODE_EPOCH = 194_048 + 100  # a capella epoch of MAINNET_CHAIN_CONFIG (capella from 194,048)
NODE_SLOT_IN_EPOCH = 7
NODE_BAD_EVERY = 512  # one attester a committee signs the next committee's root
NODE_REPUBLISH = 1024  # exact re-publishes of attestations already sent
# a slot's subnet attestations arrive evenly over the 4 s from the attestation
# deadline to the aggregation deadline, 1/3 and 2/3 of the slot: consensus-specs
# phase0 validator.md, "Attesting" and "Attestation aggregation" (the fork
# choice's INTERVALS_PER_SLOT = 3)
NODE_INTERVALS_PER_SLOT = 3
NODE_BALANCE = 32 * 10**9  # every validator's effective balance, Gwei
# the kernels the node's path must launch: the cold roots' hash, the
# pre-verify aggregation's sums, the RLC batch of the aggregated and the
# committee sets (agg_pk)
NODE_KERNELS = ("hash_g2", "g2_decompress", "seg_sum_g2", "affine_g2", "agg_pk", "g1_rpk", "g2_rsig_sub", "sum_g2",
                "miller_loop", "prod12", "final_one")
# every wrapper the phase may call, its first call held against its plain version
NODE_HELD = NODE_KERNELS + ("seg_sum_g1", "g2_subgroup_check", "each_final")


def _sign_wire(args):
    """[sk] H(m) compressed (crypto/curves.py g2_compress)."""
    from lodestar_tpu_torch.crypto import curves as GC

    sk, h = args
    return GC.g2_compress(GC.scalar_mul(GC.FP2_OPS, h, sk))


def make_keys(rng) -> list:
    """The script's N_KEYS secret keys, the first draws of `rng`."""
    from lodestar_tpu_torch.crypto import bls as GB

    return [GB.keygen(rng.bytes(32)) for _ in range(N_KEYS)]


def shed_audit(sheds, pulls, n_published, outside, opts, max_ratio) -> list:
    """A LIFO queue's sheds, dropped by an escalating ratio, against its
    rules; -> the size of each overflow's shed.  `sheds` holds (stamp,
    publish index, index of the publish during which it was shed) for each
    shed message, `pulls` (stamp, publish index) for each pulled one, the
    stamps from one counter; `outside` the publish indices held outside
    the queue while the others arrived (parked for their block).  Raises
    unless every shed happened during a publish, each overflow shed its
    ratio of the queue one past its length (the start ratio, then a step
    more each time, at most `max_ratio`; each overflow at this length
    sheds at least one), from the stale end (every message pulled after a
    shed, the outside ones apart, was published after it), none of the
    outside ones, and every publish was pulled or shed once."""
    by_publish = {}
    for _, _, at in sheds:
        by_publish[at] = by_publish.get(at, 0) + 1
    sizes = [by_publish[at] for at in sorted(by_publish, key=lambda at: -1 if at is None else at)]
    want, ratio = [], opts.drop.start
    for _ in sizes:
        want.append(int((opts.max_length + 1) * ratio))
        ratio = min(max_ratio, ratio + opts.drop.step)
    later_min, pull_stamps, min_from = n_published, [], []
    for st, i in sorted(pulls, reverse=True):
        if i not in outside:
            later_min = min(later_min, i)
        pull_stamps.append(st)
        min_from.append(later_min)
    pull_stamps.reverse()
    min_from.reverse()
    stale = []
    for st, i, _ in sheds:
        k = bisect.bisect_right(pull_stamps, st)
        if k < len(pull_stamps) and min_from[k] < i:
            stale.append(i)
    shed_ids, pulled_ids = [i for _, i, _ in sheds], [i for _, i in pulls]
    if (None in by_publish or sizes != want or stale or any(i in outside for i in shed_ids)
            or sorted(pulled_ids + shed_ids) != list(range(n_published))):
        raise AssertionError(f"sheds {sizes} (the rule gives {want}), {len(stale)} not from the stale end, "
                             f"{sum(i in outside for i in shed_ids)} held outside the queue, "
                             f"{None in by_publish} outside a publish; {len(pulled_ids)} pulled + "
                             f"{len(shed_ids)} shed of {n_published} published")
    return sizes


def node_phase(table, keys, sks, card: str, dev=None) -> tuple:
    """The port's BeaconNode over `table` (row r registered from `keys[r]`,
    the compressed key of secret key `sks[r % N_KEYS]`), fed one mainnet slot of subnet attestations: the port's
    EpochCache over every row of the table as an active validator
    (committees_per_slot committees of the slot), one AttestationData a
    committee (the last one votes for a block the fork choice does not know
    yet), signing roots from get_attestation_data_signing_root on a
    BeaconStateView of MAINNET_CHAIN_CONFIG at a capella slot, one
    attester in NODE_BAD_EVERY signing the next committee's root,
    NODE_REPUBLISH exact re-publishes, everything through
    on_gossip_attestation in a shuffled slot order at the arrival times of
    a slot (evenly over SECONDS_PER_SLOT / NODE_INTERVALS_PER_SLOT; each
    publish tagged with its index as its peer), the attestation queue
    shedding as its rules say, then drain_verdicts; then the block, the
    parked committee released and drained; then each committee's full
    aggregate through the node's service on its critical lane; then the
    accepted votes into the fork choice and its head.  Raises unless every
    verdict, shed, park, release and the head are as constructed and as
    the queue's rules give, no set went to the host, every kernel of
    NODE_KERNELS launched, and the first call of each kernel equals its
    plain version.
    Returns (node line, launches, {kernel: (max abs err, lanes held)})."""
    from lodestar_tpu_torch.bls.verifier import VerifyOptions
    from lodestar_tpu_torch.config import MAINNET_CHAIN_CONFIG
    from lodestar_tpu_torch.crypto import fields as GT
    from lodestar_tpu_torch.kernels import verify as KV
    from lodestar_tpu_torch.network.gossip_queues import GOSSIP_QUEUE_OPTS, MAX_DROP_RATIO, GossipType
    from lodestar_tpu_torch.node import BeaconNode, NodeOptions
    from lodestar_tpu_torch.params import SECONDS_PER_SLOT, SLOTS_PER_EPOCH
    from lodestar_tpu_torch.state_transition import (BeaconStateView, EpochCache,
                                                     get_attestation_data_signing_root,
                                                     get_indexed_attestation_signature_set)
    from lodestar_tpu_torch.types import AttestationData

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 16)
    cfg = MAINNET_CHAIN_CONFIG
    slot = NODE_EPOCH * SLOTS_PER_EPOCH + NODE_SLOT_IN_EPOCH
    n_val = len(keys)
    if len(table) != n_val:
        raise AssertionError(f"node: a table of {len(table)} rows for {n_val} keys")

    # committees: the port's EpochCache over every row as an active validator
    t = time.perf_counter()
    cache = EpochCache(keys, NODE_EPOCH, rng.bytes(32))
    cps = cache.committees_per_slot
    committees = [cache.get_beacon_committee(slot, i).tolist() for i in range(cps)]
    members = [v for c in committees for v in c]
    if cps < 2 or len(set(members)) != len(members) or len(members) != n_val // SLOTS_PER_EPOCH:
        raise AssertionError(f"node: {cps} committees, {len(members)} attesters of {n_val} validators")
    cache_s = time.perf_counter() - t

    # blocks: P, and two children at the slot before: H (known), B (imported later)
    hexroot = lambda: rng.bytes(32).hex()  # noqa: E731
    genesis, p_root, h_root, b_root = hexroot(), hexroot(), hexroot(), hexroot()
    parked_c = cps - 1
    source = {"epoch": NODE_EPOCH - 1, "root": bytes.fromhex(p_root)}
    target = {"epoch": NODE_EPOCH, "root": rng.bytes(32)}
    view = BeaconStateView(config=cfg, slot=slot, epoch_cache=cache)
    if cfg.get_fork_name(slot).value != "capella":
        raise AssertionError(f"node: slot {slot} is in {cfg.get_fork_name(slot)}, not capella")
    datas = [{"slot": slot, "index": c, "beacon_block_root": bytes.fromhex(b_root if c == parked_c else h_root),
              "source": source, "target": target} for c in range(cps)]
    roots = [get_attestation_data_signing_root(view, dt) for dt in datas]
    data_keys = [AttestationData.hash_tree_root(dt) for dt in datas]
    if len(set(roots)) != cps:
        raise AssertionError("node: two committees share a signing root")

    # signatures: one a (root, key) pair that occurs, and each committee's aggregate
    bad_pos = [int(rng.integers(0, len(com))) for com in committees]
    signed = {}  # validator -> the committee whose root it signs
    for c, com in enumerate(committees):
        for j, v in enumerate(com):
            signed[v] = (c + 1) % cps if j == bad_pos[c] else c
    bad = {committees[c][bad_pos[c]] for c in range(cps)}
    pairs = sorted({(signed[v], v % N_KEYS) for v in members})
    agg_scalars = [sum(sks[v % N_KEYS] for v in com) % GT.R for com in committees]
    t = time.perf_counter()
    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        hs = pool.map(_hash_to_g2, roots)
        wire = pool.map(_sign_wire, [(sks[k], hs[r]) for r, k in pairs] + [(s, hs[c]) for c, s in
                                                                               enumerate(agg_scalars)])
    sign_s = time.perf_counter() - t
    sig_of_pair = dict(zip(pairs, wire[:len(pairs)]))
    agg_sigs = wire[len(pairs):]
    log(f"node setup: EpochCache over {n_val} validators in {cache_s:.1f} s ({cps} committees of "
        f"{len(committees[0])} at slot {slot}, {len(members)} attesters); {len(pairs)} (root, key) signatures and "
        f"{cps} committee aggregates signed on the host in {sign_s:.1f} s ({min(8, os.cpu_count() or 1)} processes)")

    # the gossip: originals in a shuffled order, re-publishes after their originals
    comm_of = {v: c for c, com in enumerate(committees) for v in com}
    perm = rng.permutation(len(members))
    originals = [members[i] for i in perm]
    pos = {v: i for i, v in enumerate(originals)}
    others = [v for v in members if v not in bad]
    reps = sorted(bad) + [others[i] for i in rng.choice(len(others), NODE_REPUBLISH - len(bad), replace=False)]
    keyed = [((i, 0), v) for i, v in enumerate(originals)]
    keyed += [((int(rng.integers(pos[v] + 1, len(originals) + 1)), 1), v) for v in reps]
    order = [v for _, v in sorted(keyed, key=lambda kv: kv[0])]

    arrival_s = SECONDS_PER_SLOT / NODE_INTERVALS_PER_SLOT
    node = BeaconNode(cfg, table, genesis_root=genesis, opts=NodeOptions(device=dev))
    try:
        verifier = node.bls.verifier
        begun = []
        begin = verifier.begin_job

        def recording_begin_job(job_sets, batchable):
            job = begin(job_sets, batchable)
            begun.append(job)
            return job

        verifier.begin_job = recording_begin_job
        fc = node.fork_choice
        fc.on_block(slot - 2, p_root, genesis)
        fc.on_block(slot - 1, h_root, p_root)
        q = node.processor.queues[GossipType.beacon_attestation]
        q_opts = GOSSIP_QUEUE_OPTS[GossipType.beacon_attestation]

        # instrumentation, through the node's and the queue's observers and
        # the processor's worker: each publish carries its index in `order`
        # as its peer; each pull and each shed is stamped from one counter,
        # with the publish during which it happened; each verdict's time
        # against its seen_at
        stamp, publishing = itertools.count(), [None]
        pulls, sheds, lat = [], [], []
        worker = node.processor.worker

        def stamped_worker(msg):
            pulls.append((next(stamp), msg.peer_id))
            worker(msg)

        node.processor.worker = stamped_worker
        q.on_drop = lambda msg: sheds.append((next(stamp), msg.peer_id, publishing[0]))
        node.on_verdict = lambda v, seen_at, fut: lat.append((time.time() - seen_at, time.perf_counter(), v,
                                                              fut.result()))

        # the first call of each kernel the phase launches, recorded for the
        # hold (its tensor operands copied before it runs); the calls by
        # operand count (with or without the Montgomery ingest's plain planes)
        first_calls, rec_lock, kv_orig, arity = {}, threading.Lock(), {}, {}

        def first_call(name, f):
            def run(*args):
                with rec_lock:
                    n = sum(a is not None for a in args)
                    arity[name, n] = arity.get((name, n), 0) + 1
                    first = name not in first_calls
                    if first:
                        first_calls[name] = None
                if not first:
                    return f(*args)
                ins = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                out = f(*args)
                outs = out if isinstance(out, tuple) else (out,)
                first_calls[name] = (ins, tuple(o.clone() for o in outs))
                return out
            return run

        for name in NODE_HELD:
            kv_orig[name] = getattr(KV, name)
            setattr(KV, name, first_call(name, kv_orig[name]))
        try:
            torch.cuda.synchronize()
            KV.reset_launches()
            max_depth = 0
            t0 = time.perf_counter()
            for i, v in enumerate(order):
                due = t0 + i * arrival_s / len(order)
                while time.perf_counter() < due:  # between arrivals the processor pulls what the service takes
                    node.processor.execute_work()
                    time.sleep(min(0.0005, max(0.0, due - time.perf_counter())))
                c = comm_of[v]
                publishing[0] = i
                node.on_gossip_attestation(v, slot, data_keys[c], roots[c], sig_of_pair[signed[v], v % N_KEYS],
                                           block_root=b_root if c == parked_c else h_root, peer_id=i)
                max_depth = max(max_depth, len(q))
            publishing[0] = None
            t_published = time.perf_counter()
            while len(q):
                node.processor.execute_work()
                time.sleep(0.0005)
            parked = node.processor.awaiting_count
            accepted_first = node.drain_verdicts(timeout=600)
            # the block: imported, the parked committee released and drained
            fc.on_block(slot - 1, b_root, p_root)
            node.processor.on_block_processed(slot, b_root)
            released = parked - node.processor.awaiting_count
            while len(q):
                node.processor.execute_work()
                time.sleep(0.0005)
            accepted_second = node.drain_verdicts(timeout=600)
            jobs_gossip = len(begun)
            # the committees' aggregates on the critical lane, as block import sends them
            t1 = time.perf_counter()
            agg_sets = [get_indexed_attestation_signature_set(view, cache.get_indexed_attestation(
                {"aggregation_bits": [True] * len(com), "data": datas[c], "signature": agg_sigs[c]}))
                for c, com in enumerate(committees)]
            agg_futs = [node.bls.verify_signature_sets_async([s], VerifyOptions(batchable=True, priority=True))
                        for s in agg_sets]
            agg_ok = [f.result(timeout=600) for f in agg_futs]
            agg_s = time.perf_counter() - t1
            torch.cuda.synchronize()
            counts = dict(KV.LAUNCHES)
            # (a verdict's observer runs just after its waiter wakes: read them all now)
            t_gossip_end = max(t for _, t, _, _ in lat)
        finally:
            for name, f in kv_orig.items():
                setattr(KV, name, f)
        # the fused rows: the heading kernels' launches that made the ingest
        # (the decoded paths' 8 planes, the wire paths' 4 message planes)
        counts["mont_convert"] = arity.get(("g2_rsig_sub", 4), 0) + arity.get(("g2_subgroup_check", 3), 0)
        counts["mont_convert_4"] = arity.get(("g2_decompress", 3), 0)
        path_s = time.perf_counter() - t0
        stats = node.processor.stats
        agg_stats = node.bls.agg_stats()
        factor = node.bls.mean_aggregation_factor()
        status = node.bls.breaker_status()
        host_sets = verifier.supervisor.m_host_fallback_sets.value
        _breaker_clean(verifier.supervisor, "node")

        parked_ids = {i for i, v in enumerate(order) if comm_of[v] == parked_c}
        sizes = shed_audit(sheds, pulls, len(order), parked_ids, q_opts, MAX_DROP_RATIO)
        pulled_ids = [i for _, i in pulls]
        if stats.dropped != len(sheds) or stats.submitted != len(pulls) or max_depth > q_opts.max_length:
            raise AssertionError(f"node: processor dropped {stats.dropped} and submitted {stats.submitted}; "
                                 f"{len(sheds)} shed, {len(pulls)} pulled; queue peak {max_depth} of "
                                 f"{q_opts.max_length}")

        # the verdicts: a validator with a message left is verified once and
        # seen as its signature says
        left = {order[i] for i in pulled_ids}
        want_seen = left - bad
        seen_wrong = [v for v in members if node.seen_attesters.is_known(NODE_EPOCH, v) != (v in want_seen)]
        verdict_wrong = [v for _, _, v, ok in lat if ok != (v not in bad)]
        if accepted_first + accepted_second != len(want_seen) or seen_wrong or verdict_wrong:
            raise AssertionError(f"node: {accepted_first} + {accepted_second} accepted, constructed "
                                 f"{len(want_seen)}; {len(seen_wrong)} validators seen and {len(verdict_wrong)} "
                                 f"verdicts against their signature")
        if sorted(v for _, _, v, _ in lat) != sorted(left):
            raise AssertionError(f"node: {len(lat)} submissions for {len(left)} validators with a message left")
        expected_parked = sum(comm_of[v] == parked_c for v in order)
        if (stats.past_slot, stats.reprocess_rejected, stats.reprocess_expired) != (0, 0, 0) \
                or parked != expected_parked or released != expected_parked \
                or stats.reprocess_parked != expected_parked:
            raise AssertionError(f"node: parked {parked} / {stats.reprocess_parked}, released {released}, "
                                 f"expected {expected_parked}; past slot {stats.past_slot}, rejected "
                                 f"{stats.reprocess_rejected}, expired {stats.reprocess_expired}")
        if agg_ok != [True] * cps:
            raise AssertionError(f"node: committee aggregates {agg_ok}")
        if host_sets or status["state"] != "closed" or any(j.host_sets or j.host_mode for j in begun):
            raise AssertionError(f"node: breaker {status['state']}, {host_sets} host-fallback sets")
        missing = [k for k in NODE_KERNELS if not counts[k]]
        if missing:
            raise AssertionError(f"node: kernels never launched: {missing} ({counts})")

        # the first call of each launched kernel against its plain version
        t = time.perf_counter()
        held = {}
        for name, call in sorted(first_calls.items()):
            if call is None:
                raise AssertionError(f"node: the first call of {name} did not return")
            args, k_outs = call
            p_out = getattr(KV, name + "_plain")(*args)
            p_outs = p_out if isinstance(p_out, tuple) else (p_out,)
            if len(p_outs) != len(k_outs):
                raise AssertionError(f"node: {name} gave {len(k_outs)} outputs, its plain version {len(p_outs)}")
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
                      for a, b in zip(k_outs, p_outs))
            if err or not all(torch.equal(a, b) for a, b in zip(k_outs, p_outs)):
                raise AssertionError(f"node: the first call of {name} differs from its plain version (max {err})")
            # the call's lanes: the reductions' inputs, the others' outputs (agg_pk's first operand is the table)
            held[name] = (err, int((args[0] if name in ("sum_g2", "prod12") else k_outs[0]).shape[-1]))
        unheld = [k for k, n in counts.items() if n and k not in held and k in NODE_HELD]
        if unheld:
            raise AssertionError(f"node: launched but not held: {unheld}")
        torch.cuda.synchronize()
        held_s = time.perf_counter() - t

        # the accepted votes into the fork choice, then its head
        t = time.perf_counter()
        for v in sorted(want_seen):
            fc.on_attestation(v, NODE_EPOCH, b_root if comm_of[v] == parked_c else h_root)
        fc.set_balances(np.full(n_val, NODE_BALANCE, np.int64))
        votes_s = time.perf_counter() - t
        t = time.perf_counter()
        head = fc.update_head()
        head_ms = (time.perf_counter() - t) * 1e3
        votes_b = sum(comm_of[v] == parked_c for v in want_seen)
        weights = {r: fc.get_node(r).weight for r in (p_root, h_root, b_root)}
        want_w = {p_root: len(want_seen) * NODE_BALANCE, h_root: (len(want_seen) - votes_b) * NODE_BALANCE,
                  b_root: votes_b * NODE_BALANCE}
        # the heavier child of P, the larger root on a tie (proto_array.py's tiebreak)
        want_head = max((want_w[h_root], h_root), (want_w[b_root], b_root))[1]
        if head != want_head or weights != want_w:
            raise AssertionError(f"node: head {head} (want {want_head}), weights {weights} (want {want_w})")
    finally:
        node.close()

    dt = t_gossip_end - t0
    lat_all = [x for x, _, _, _ in lat]
    lat_unparked = [x for x, _, v, _ in lat if comm_of[v] != parked_c]
    sets_begun = sum(len(j.sets) for j in begun[:jobs_gossip])
    line = {
        "validators": n_val, "slot": slot, "fork": cfg.get_fork_name(slot).value, "committees": cps,
        "committee_size": len(committees[0]), "attestations": len(members), "published": len(order),
        "bad": len(bad), "republished": len(reps), "arrival_window_s": arrival_s,
        "arrivals_per_s": len(order) / arrival_s, "publish_s": t_published - t0,
        "dropped": stats.dropped, "shed_events": sizes, "validators_all_shed": len(members) - len(left),
        "queue_peak": max_depth, "queue_max_length": q_opts.max_length, "verified": len(lat),
        "accepted": accepted_first + accepted_second, "deduped": len(pulls) - len(lat),
        "parked": parked, "released": released,
        "gossip_s": dt, "verdicts_per_s": len(lat) / dt, "pulled_per_s": len(pulls) / dt,
        "verdict_latency_p50_ms": _percentile(lat_all, 0.5) * 1e3,
        "verdict_latency_p99_ms": _percentile(lat_all, 0.99) * 1e3,
        "verdict_latency_unparked_p50_ms": _percentile(lat_unparked, 0.5) * 1e3,
        "verdict_latency_unparked_p99_ms": _percentile(lat_unparked, 0.99) * 1e3,
        "jobs_begun": jobs_gossip, "sets_per_job": sets_begun / max(jobs_gossip, 1),
        "aggregation_factor": factor, "preagg": agg_stats,
        "committee_aggregates": {"sets": cps, "k": len(committees[0]), "all_true": all(agg_ok), "s": agg_s,
                                 "jobs_begun": len(begun) - jobs_gossip},
        "launches": {k: v for k, v in counts.items() if v}, "first_calls_held": {k: v[1] for k, v in held.items()},
        "held_s": held_s, "host_fallback_sets": host_sets, "breaker": status["state"],
        "fork_choice": {"head": head, "votes_s": votes_s, "head_ms": head_ms, "balances": n_val},
        "epoch_cache_s": cache_s, "signing_s": sign_s, "path_s": path_s,
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    log("node " + json.dumps(line))
    return line, counts, held



CHAIN_VALIDATORS = 1 << 20  # the node phase's registry: row r holds key r % N_KEYS
CHAIN_SLOTS = (29, 30, 31, 32, 33)  # the block at 32 crosses the epoch boundary: its pre-state runs process_epoch
CHAIN_TAMPERED_SLOT = 33  # the two rejected copies are made of this slot's block
CHAIN_SWAPPED = (3, 7)  # the tampered copy's attestation 3 carries attestation 7's signature
# the kernels the phase must launch: the block's sets as one RLC batch of
# wire sets (K = 512 aggregates through agg_pk), the bisection of the
# tampered copy, the state roots' three SHA-256 kernels
CHAIN_KERNELS = ("g2_decompress", "hash_g2", "agg_pk", "g1_rpk", "g2_rsig_sub", "sum_g2", "miller_loop", "prod12",
                 "affine_g2", "final_one", "g2_subgroup_check", "each_final")
CHAIN_SHA = tuple(HTR_KERNELS)
CHAIN_LANE_WISE = ("g2_decompress", "hash_g2", "g1_rpk", "g2_rsig_sub", "miller_loop", "affine_g2", "final_one",
                   "g2_subgroup_check", "each_final")  # a lane's result depends on that lane's inputs alone


def _merged_sweeps(calls):
    """The forest_sweep calls of one depth K as one plain run's operands:
    each call's live rows of each level placed one after another (its
    scatter map shifted by the rows before it at the level above), so the
    merged plan hashes exactly what every call hashes.  Returns (pairs,
    dst_lane, dst_half, live, [(call, level) -> offset])."""
    k = calls[0][0][0].shape[0]
    dev = calls[0][0][0].device
    lives = []
    for (pairs, dst_lane, dst_half, *rest), _ in calls:
        b = pairs.shape[1]
        lv = rest[0].tolist() if rest and rest[0] is not None else [b] * k
        lives.append([min(max(int(n), 0), b) for n in lv])
    width = max(1, max(sum(lv[level] for lv in lives) for level in range(k)))
    pairs_m = torch.zeros((k, width, 16), dtype=torch.int32, device=dev)
    lane_m = torch.full((k, width), -1, dtype=torch.int32, device=dev)
    half_m = torch.zeros((k, width), dtype=torch.int32, device=dev)
    offsets = []
    base = [0] * k
    for ((pairs, dst_lane, dst_half, *_), _), lv in zip(calls, lives):
        offsets.append(list(base))
        for level in range(k):
            n, o = lv[level], base[level]
            pairs_m[level, o:o + n] = pairs[level, :n]
            if level + 1 < k:
                lane = dst_lane[level, :n].to(torch.int64)
                # a row the call drops (outside the next level's live rows) stays dropped
                keep = (lane >= 0) & (lane < lv[level + 1])
                lane_m[level, o:o + n] = torch.where(keep, lane + base[level + 1], -1).to(torch.int32)
                half_m[level, o:o + n] = dst_half[level, :n]
        base = [b + lv[level] for level, b in enumerate(base)]
    live_m = torch.tensor(base, dtype=torch.int32, device=dev)
    return pairs_m, lane_m, half_m, live_m, offsets, lives


def hold_chain_calls(calls, KV, SK) -> dict:
    """Every recorded kernel call of the chain phase against its plain
    version on the same inputs: the lane-wise BLS kernels' calls side by
    side in one plain run per kernel and operand pattern, agg_pk's sets
    side by side over the one table (one run per K bucket), the
    reductions one plain run per call, hash_pairs' and validator_roots'
    rows side by side, forest_sweep's calls of one depth merged into one
    plain run.  Raises on the first difference; returns {kernel: (calls,
    lanes)}."""
    held = {}

    def differ(name, k_outs, p_outs):
        if len(p_outs) != len(k_outs):
            raise AssertionError(f"chain: {name} gave {len(k_outs)} outputs, its plain version {len(p_outs)}")
        for a, b in zip(k_outs, p_outs):
            if not torch.equal(a, b):
                err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                raise AssertionError(f"chain: a call of {name} differs from its plain version (max {err})")

    for name, recs in calls.items():
        if not recs:
            continue
        lanes = 0
        if name in CHAIN_LANE_WISE:
            for pattern in sorted({tuple(a is None for a in r[0]) for r in recs}):
                part = [r for r in recs if tuple(a is None for a in r[0]) == pattern]
                args = [None if none else torch.cat([r[0][i] for r in part], dim=-1)
                        for i, none in enumerate(pattern)]
                while args and args[-1] is None:
                    args.pop()
                k_outs = [torch.cat([r[1][i] for r in part], dim=-1) for i in range(len(part[0][1]))]
                p_out = getattr(KV, name + "_plain")(*args)
                differ(name, k_outs, p_out if isinstance(p_out, tuple) else (p_out,))
                lanes += k_outs[0].shape[-1]
        elif name == "agg_pk":  # (table_x, table_y, idx [N, K], kmask [N, K]): a set's sum is its rows' alone
            for k in sorted({r[0][2].shape[1] for r in recs}):
                part = [r for r in recs if r[0][2].shape[1] == k]
                if any(r[0][0].data_ptr() != part[0][0][0].data_ptr() for r in part):
                    raise AssertionError("chain: agg_pk called on two tables")
                idx = torch.cat([r[0][2] for r in part], dim=0)
                kmask = torch.cat([r[0][3] for r in part], dim=0)
                k_outs = [torch.cat([r[1][i] for r in part], dim=-1) for i in range(len(part[0][1]))]
                differ(name, k_outs, KV.agg_pk_plain(part[0][0][0], part[0][0][1], idx, kmask))
                lanes += idx.shape[0]
        elif name in ("hash_pairs", "validator_roots"):
            args = [torch.cat([r[0][i] for r in recs], dim=0) for i in range(len(recs[0][0]))]
            k_out = torch.cat([r[1][0] for r in recs], dim=0)
            differ(name, (k_out,), (getattr(SK, name + "_plain")(*args),))
            lanes = k_out.shape[0]
        elif name == "forest_sweep":
            for k in sorted({r[0][0].shape[0] for r in recs}):
                part = [r for r in recs if r[0][0].shape[0] == k]
                pairs, lane, half, live, offsets, lives = _merged_sweeps(part)
                merged = SK.forest_sweep_plain(pairs, lane, half, live)
                for (_, (k_out,)), offs, lv in zip(part, offsets, lives):
                    for level in range(k):
                        n, o = lv[level], offs[level]
                        if not torch.equal(k_out[level, :n], merged[level, o:o + n]):
                            raise AssertionError(f"chain: a forest_sweep call (K = {k}) differs from its plain "
                                                 f"version at level {level}")
                lanes += int(live.sum())
        else:  # the reductions: one plain run a call
            for args, k_outs in recs:
                p_out = getattr(KV, name + "_plain")(*args)
                differ(name, k_outs, p_out if isinstance(p_out, tuple) else (p_out,))
                lanes += args[0].shape[-1]
        held[name] = (len(recs), int(lanes))
    return held


def chain_phase(table, keys, sks, card: str, dev=None) -> tuple:
    """Block import on the card: the port's BeaconChain over a
    CHAIN_VALIDATORS-validator altair genesis made by the port's
    create_genesis_state (pubkeys `keys`, row r the key of sks[r % N_KEYS];
    MAINNET_CHAIN_CONFIG with altair from epoch 0), its signatures through
    create_bls_service(TorchBlsVerifier(table)), its state roots through the
    card's DeviceMerkleBackend, its default memory governor and a BeaconDb.
    The blocks at CHAIN_SLOTS are made by the chain's own produce_block from
    its pools (the aggregated pool holding the previous slot's committees,
    each one full aggregate of 512; four sync contributions of 128, a full
    sync aggregate), signed with the proposers' keys and imported by
    process_block; before the last one imports, a copy with one
    attestation's signature swapped for another committee's (refused by the
    signature leg, the batch bisected on the card) and one with a wrong
    state root (refused by the state-root leg), neither moving the head nor
    leaving a fork-choice node.  Each imported post-state's root is held
    against a second StateRootEngine on the host path, in step; every kernel
    call of the phase against its plain version (`hold_chain_calls`).
    Raises unless every block imports, the head is the last block, no set
    went to the host, the transition checked no signature itself, no tree
    level was hashed on the host, the breakers stayed closed and every
    kernel of CHAIN_KERNELS and CHAIN_SHA launched.
    Returns (chain line, launches)."""
    from lodestar_tpu_torch.bls import create_bls_service
    from lodestar_tpu_torch.bls.verifier import TorchBlsVerifier
    from lodestar_tpu_torch.chain.chain import BeaconChain
    from lodestar_tpu_torch.config import MAINNET_CHAIN_CONFIG, create_chain_config
    from lodestar_tpu_torch.crypto import bls as GB
    from lodestar_tpu_torch.crypto import fields as GT
    from lodestar_tpu_torch.db import BeaconDb
    from lodestar_tpu_torch.kernels import sha256 as SK
    from lodestar_tpu_torch.kernels import verify as KV
    from lodestar_tpu_torch.params import DOMAIN_BEACON_ATTESTER, DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO, \
        DOMAIN_SYNC_COMMITTEE, SLOTS_PER_EPOCH, SYNC_COMMITTEE_SUBNET_COUNT, ForkName
    from lodestar_tpu_torch.ssz import device_backend as DB
    from lodestar_tpu_torch.ssz import uint64
    from lodestar_tpu_torch.state_transition import StateRootEngine, accessors as AC, block as BK, \
        genesis as GEN, signature_sets as SS
    from lodestar_tpu_torch.state_transition.slot import process_slots
    from lodestar_tpu_torch.types import AttestationData, BeaconBlockAltair

    t_phase = time.perf_counter()
    if len(table) != len(keys) or len(keys) != CHAIN_VALIDATORS:
        raise AssertionError(f"chain: a table of {len(table)} rows for {len(keys)} keys")
    cfg = create_chain_config(MAINNET_CHAIN_CONFIG, fork_epochs={ForkName.altair: 0})
    sk_of = {keys[k]: sks[k] for k in range(N_KEYS)}
    backend = DB.DeviceMerkleBackend(device=dev)
    DB.set_backend(backend)
    verifier = TorchBlsVerifier(table, device=dev)
    service = create_bls_service(verifier)
    BK.reset_host_signature_checks()

    # every kernel call of the phase: operands and results copied for the hold
    calls = {name: [] for name in NODE_HELD + CHAIN_SHA}
    real = {name: getattr(KV, name) for name in NODE_HELD}
    real.update({name: getattr(SK, name) for name in CHAIN_SHA})
    rec_lock = threading.Lock()

    def recorder(name):
        f = real[name]

        # agg_pk's first two operands are the table's planes, which no call writes: kept, not copied
        kept = 2 if name == "agg_pk" else 0

        def run(*args):
            ins = tuple(a.clone() if torch.is_tensor(a) and i >= kept else a for i, a in enumerate(args))
            out = f(*args)
            outs = out if isinstance(out, tuple) else (out,)
            with rec_lock:
                calls[name].append((ins, tuple(o.clone() for o in outs)))
            return out
        return run

    # the chain's named phases, the view's committee caches and the sets, per import
    phases, views, n_sets = [], [], []
    timer = type("PhaseTimer", (), {"observe": lambda self, name, s: phases.append((name, s))})()
    real_from_state, real_sets = SS.BeaconStateView.from_state.__func__, SS.get_block_signature_sets
    real_sync = GEN.get_next_sync_committee
    sync_s = []

    def from_state(cls, state):
        t = time.perf_counter()
        out = real_from_state(cls, state)
        views.append(time.perf_counter() - t)
        return out

    def block_sets(view, signed_block, *a, **kw):
        out = real_sets(view, signed_block, *a, **kw)
        n_sets.append(len(out))
        return out

    def sync_committee(state):
        t = time.perf_counter()
        out = real_sync(state)
        sync_s.append(time.perf_counter() - t)
        return out

    pool = mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1))
    db_dir = tempfile.TemporaryDirectory(prefix="chain_db_")
    chain = None
    for name in NODE_HELD:
        setattr(KV, name, recorder(name))
    for name in CHAIN_SHA:
        setattr(SK, name, recorder(name))
    SS.BeaconStateView.from_state = classmethod(from_state)
    SS.get_block_signature_sets = block_sets
    GEN.get_next_sync_committee = sync_committee
    try:
        torch.cuda.synchronize()
        KV.reset_launches()
        SK.reset_launches()
        t = time.perf_counter()
        anchor = GEN.create_genesis_state(cfg, keys)
        genesis_s = time.perf_counter() - t
        t = time.perf_counter()
        anchor_root = anchor.hash_tree_root()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t) * 1e3
        db = BeaconDb(os.path.join(db_dir.name, "chain"))
        t = time.perf_counter()
        chain = BeaconChain(cfg, anchor, db=db, bls_verifier=service)
        chain.phase_timer = timer
        chain_s = time.perf_counter() - t
        log(f"chain setup: genesis of {len(keys)} validators in {genesis_s:.1f} s (the sync committee's 512 keys "
            f"aggregated on the host in {sum(sync_s):.1f} s), its cold root {cold_ms:.1f} ms on the card, "
            f"BeaconChain in {chain_s:.1f} s")

        host_engine = StateRootEngine()
        blocks, rejected, per_block, host_ms = [], [], [], []

        def leg_check(seen):
            """True unless the import ran every named phase."""
            return set(seen["phases_ms"]) < {"validation", "signature_verify", "stf", "state_root", "fork_choice"}

        def signed(block):
            pre = chain.head_state
            root = cfg.compute_signing_root(BeaconBlockAltair.hash_tree_root(block),
                                            cfg.get_domain(block["slot"], DOMAIN_BEACON_PROPOSER, block["slot"]))
            return {"message": block, "signature": GB.sign_bytes(sk_of[pre.pubkeys[block["proposer_index"]]], root)}

        def import_(signed_block, seen):
            """process_block; `seen` gets the named phases it completed and its ms."""
            first = len(phases)
            t = time.perf_counter()
            try:
                return chain.process_block(signed_block, timely=True)
            finally:
                seen["ms"] = (time.perf_counter() - t) * 1e3
                seen["phases_ms"] = {k: v * 1e3 for k, v in phases[first:]}

        t_path = time.perf_counter()
        sign_s = produce_s = 0.0
        for slot in CHAIN_SLOTS:
            # the pools: the previous slot's committees and the sync committee's contributions
            t = time.perf_counter()
            att_slot = slot - 1
            head = chain.head_state
            head_root = chain.get_head_root()
            chain.aggregated_attestation_pool = type(chain.aggregated_attestation_pool)()
            cps = AC.get_committee_count_per_slot(head, att_slot // SLOTS_PER_EPOCH)
            datas, roots, scalars = [], [], []
            for index in range(cps):
                data = chain.produce_attestation_data(index, att_slot)
                committee = AC.get_beacon_committee(head, att_slot, index)
                datas.append((data, len(committee)))
                roots.append(cfg.compute_signing_root(AttestationData.hash_tree_root(data), cfg.get_domain(
                    att_slot, DOMAIN_BEACON_ATTESTER, att_slot)))
                scalars.append(sum(sks[int(v) % N_KEYS] for v in committee) % GT.R)
            seats = head.current_sync_committee["pubkeys"]
            size = len(seats) // SYNC_COMMITTEE_SUBNET_COUNT
            roots.append(cfg.compute_signing_root(head_root, cfg.get_domain(att_slot, DOMAIN_SYNC_COMMITTEE,
                                                                            att_slot)))
            for sub in range(SYNC_COMMITTEE_SUBNET_COUNT):
                scalars.append(sum(sk_of[pk] for pk in seats[sub * size:(sub + 1) * size]) % GT.R)
            hs = pool.map(_hash_to_g2, roots)
            # the cps committees' scalars sign their roots, the four subnets' the one sync root (roots[cps])
            wire = pool.map(_sign_wire, [(s, hs[min(i, cps)]) for i, s in enumerate(scalars)])
            for (data, n), sig in zip(datas, wire[:cps]):
                chain.aggregated_attestation_pool.add({"aggregation_bits": [True] * n, "data": data,
                                                       "signature": sig})
            for sub, sig in enumerate(wire[cps:]):
                chain.sync_contribution_pool.add({"slot": att_slot, "beacon_block_root": head_root,
                                                  "subcommittee_index": sub, "aggregation_bits": [True] * size,
                                                  "signature": sig})
            # the proposer's randao reveal, then the block from the pools; within the
            # head's epoch the head state names the slot's proposer, across it the
            # state is advanced
            epoch = slot // SLOTS_PER_EPOCH
            if head.slot // SLOTS_PER_EPOCH == epoch:
                proposer = AC.get_proposer_indices_for_epoch(head, epoch)[slot % SLOTS_PER_EPOCH]
            else:
                pre = head.clone()
                process_slots(pre, slot)
                proposer = AC.get_beacon_proposer_index(pre)
                del pre
            reveal = GB.sign_bytes(sk_of[head.pubkeys[proposer]], cfg.compute_signing_root(
                uint64.hash_tree_root(epoch), cfg.get_domain(slot, DOMAIN_RANDAO, slot)))
            sign_s += time.perf_counter() - t
            t = time.perf_counter()
            block = chain.produce_block(slot, reveal)
            produce_s += time.perf_counter() - t
            body = block["body"]
            if block["proposer_index"] != proposer:
                raise AssertionError(f"chain: the block at {slot} names proposer {block['proposer_index']}, the "
                                     f"reveal was signed by {proposer}")
            if (len(body["attestations"]) != cps or not all(all(a["aggregation_bits"]) for a in body["attestations"])
                    or not all(body["sync_aggregate"]["sync_committee_bits"])):
                raise AssertionError(f"chain: the block at {slot} carries {len(body['attestations'])} attestations "
                                     f"of {cps} committees, sync bits {sum(body['sync_aggregate']['sync_committee_bits'])}")
            head_before, nodes_before = chain.head_root_hex, len(chain.fork_choice.proto.nodes)
            if slot == CHAIN_TAMPERED_SLOT:
                a, b = CHAIN_SWAPPED
                atts = list(body["attestations"])
                atts[a] = dict(atts[a], signature=atts[b]["signature"])
                for label, copy, want in (
                        ("signature", dict(block, body=dict(body, attestations=atts)),
                         (ValueError, "block signature verification failed")),
                        ("state_root", dict(block, state_root=b"\x01" * 32),
                         (BK.BlockProcessError, "state root mismatch"))):
                    sets_before, seen = len(n_sets), {}
                    try:
                        import_(signed(copy), seen)
                        raise AssertionError(f"chain: the {label} copy of block {slot} imported")
                    except want[0] as e:
                        if not str(e).startswith(want[1]):
                            raise
                        # the leg that refused it: the first named phase that did not complete
                        legs = ("validation", "signature_verify", "stf", "state_root")
                        leg = next(x for x in legs if x not in seen["phases_ms"])
                        rejected.append({"copy": label, "leg": leg, "error": str(e)[:80],
                                         "sets": n_sets[sets_before] if len(n_sets) > sets_before else 0, **seen})
                    if chain.head_root_hex != head_before or len(chain.fork_choice.proto.nodes) != nodes_before:
                        raise AssertionError(f"chain: the {label} copy moved the head or left a fork-choice node")
            seen = {}
            root = import_(signed(block), seen)
            if leg_check(seen) or chain.head_root_hex != root.hex():
                raise AssertionError(f"chain: block {slot} imported but the head is {chain.head_root_hex}")
            # the post-state's root on the host path, in step
            post = chain.head_state
            DB.set_backend(None)
            try:
                t = time.perf_counter()
                host_root = host_engine.hash_tree_root(post)
                host_ms.append((time.perf_counter() - t) * 1e3)
            finally:
                DB.set_backend(backend)
            if host_root != block["state_root"]:
                raise AssertionError(f"chain: block {slot}'s state root {block['state_root'].hex()} differs from "
                                     f"the host path's {host_root.hex()}")
            blocks.append(root)
            per_block.append({"slot": slot, "phases_ms": seen["phases_ms"], "view_ms": views[-1] * 1e3,
                              "sets": n_sets[-1], "import_ms": seen["ms"], "host_root_ms": host_ms[-1]})
            log(f"chain block {slot}: " + json.dumps(per_block[-1]))
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t_path
        counts = {k: v for k, v in KV.LAUNCHES.items()}
        counts.update(SK.LAUNCHES)
        host_checks = BK.host_signature_checks()
        governor = chain.memory_governor.status()
    finally:
        for name in NODE_HELD:
            setattr(KV, name, real[name])
        for name in CHAIN_SHA:
            setattr(SK, name, real[name])
        SS.BeaconStateView.from_state = classmethod(real_from_state)
        SS.get_block_signature_sets = real_sets
        GEN.get_next_sync_committee = real_sync
        pool.close()
        pool.join()
        service.close()
        if chain is not None and chain.db is not None:
            chain.db.close()
        db_dir.cleanup()
        DB.reset_backend()

    # the fused rows: the heading kernels' launches that made the ingest
    counts["mont_convert"] = sum(1 for args, _ in calls["g2_rsig_sub"] if len(args) > 3 and args[3] is not None) \
        + sum(1 for args, _ in calls["g2_subgroup_check"] if len(args) > 2 and args[2] is not None)
    counts["mont_convert_4"] = sum(1 for args, _ in calls["g2_decompress"] if len(args) > 2 and args[2] is not None)
    host_sets = verifier.supervisor.m_host_fallback_sets.value
    _breaker_clean(verifier.supervisor, "chain")
    sup = backend.supervisor.status()
    if chain.head_root_hex != blocks[-1].hex() or len(blocks) != len(CHAIN_SLOTS):
        raise AssertionError(f"chain: head {chain.head_root_hex}, {len(blocks)} blocks imported")
    if [r["leg"] for r in rejected] != ["signature_verify", "state_root"]:
        raise AssertionError(f"chain: rejections {rejected}")
    if host_sets or host_checks or backend.m_host_levels.value or sup["state"] != "closed":
        raise AssertionError(f"chain: {host_sets} host-fallback sets, {host_checks} host signature checks in the "
                             f"transition, {backend.m_host_levels.value} host tree levels, breaker {sup['state']}")
    missing = [k for k in CHAIN_KERNELS + CHAIN_SHA if not counts.get(k)]
    if missing:
        raise AssertionError(f"chain: kernels never launched: {missing} ({counts})")
    unrecorded = [k for k in NODE_HELD + CHAIN_SHA if counts.get(k, 0) and not calls[k]]
    if unrecorded:
        raise AssertionError(f"chain: launched outside the recorded wrappers: {unrecorded}")

    t = time.perf_counter()
    held = hold_chain_calls(calls, KV, SK)
    torch.cuda.synchronize()
    held_s = time.perf_counter() - t
    del calls
    line = {
        "validators": len(keys), "slots": list(CHAIN_SLOTS), "fork": "altair", "card": card,
        "anchor_root": anchor_root.hex(), "head": blocks[-1].hex(),
        "genesis_s": genesis_s, "sync_committee_host_s": sync_s, "cold_root_ms": cold_ms, "chain_init_s": chain_s,
        "blocks": per_block, "rejected": rejected, "pools_and_signing_s": sign_s, "produce_s": produce_s,
        "launches": {k: v for k, v in counts.items() if v}, "held": held, "held_s": held_s,
        "host_fallback_sets": host_sets, "host_signature_checks_in_stf": host_checks,
        "host_tree_levels": backend.m_host_levels.value, "breaker": sup["state"],
        "governor": {k: governor[k] for k in ("budget_bytes", "resident_bytes", "plane_bytes", "column_bytes",
                                              "spill_bytes", "evictions", "pressure_events", "entries")},
        "path_s": path_s, "phase_s": time.perf_counter() - t_phase,
    }
    log("chain " + json.dumps(line))
    return line, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2

    from lodestar_tpu_torch.bls import ingest as IN
    from lodestar_tpu_torch.bls.ingest import MessageCache, encode_pubkey_planes, hash_field_planes, jacobian_to_affine
    from lodestar_tpu_torch.bls import pubkey_table as PT
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
    if "--htr-only" in sys.argv[1:]:  # the hash-forest phase alone: its lines, no result line
        _, rows = htr_phase(card, sm_mhz)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if "--slasher-only" in sys.argv[1:]:  # the slasher phase alone: its lines, no result line
        _, rows = slasher_phase(card)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if "--node-only" in sys.argv[1:] or "--chain-only" in sys.argv[1:]:
        # the node phase or the chain phase alone, over its own table: its lines, no result line
        t = time.perf_counter()
        with ThreadPoolExecutor(1) as builder:
            build = builder.submit(B.build_all)
            sks = make_keys(np.random.default_rng(SEED))
            comp = [GC.g1_compress(GB.sk_to_pk(sk)) for sk in sks]
            build.result()
        keys = [comp[r % N_KEYS] for r in range(TABLE_ROWS)]
        table = PubkeyTable()
        if table.register_compressed(keys, device_batch=REG_CHUNK) != list(range(TABLE_ROWS)):
            raise AssertionError("node: the table's registration")
        log(f"{sys.argv[1][2:-5]} setup: kernels built, {TABLE_ROWS} keys registered in "
            f"{time.perf_counter() - t:.1f} s")
        if "--chain-only" in sys.argv[1:]:
            line, counts = chain_phase(table, keys, sks, card)
            print(json.dumps({"kernels": [{"name": k, "route": "cuda", "chain_launches": n, "calls_held": held[0],
                                           "lanes_held": held[1]}
                                          for k, n in counts.items() if n for held in [line["held"].get(k, (0, 0))]]}),
                  flush=True)
            return 0
        _, counts, held = node_phase(table, keys, sks, card)
        print(json.dumps({"kernels": [{"name": k, "route": "cuda", "launches": counts[k], "max_abs_err": e,
                                       "first_call_lanes_held": lanes} for k, (e, lanes) in held.items()]}),
              flush=True)
        return 0

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
    path_kms = {}  # (path, n) -> kernel wrapper -> ms in the path (one instrumented run)

    # every call of the redesigned warp kernels that a main-path run makes
    # (inputs and outputs copied on the stream), held at the end of the
    # main paths against the plain versions
    path_calls = {"g1_rpk": [], "g2_decompress": [], "affine_g2": [], "sum_g2": [], "prod12": [], "hash_g2": [],
                  "g2_subgroup_check": [], "seg_sum_g1": [], "seg_sum_g2": []}
    REDUCTIONS = ("sum_g2", "prod12", "seg_sum_g1", "seg_sum_g2")  # a lane's result depends on other lanes
    recording = [False]

    def recorder(name, f):
        def run(*args):
            out = f(*args)
            if recording[0]:
                outs = out if isinstance(out, tuple) else (out,)
                path_calls[name].append((tuple(a.clone() for a in args), tuple(o.clone() for o in outs)))
            return out
        return run

    for name in path_calls:
        setattr(KV, name, recorder(name, getattr(KV, name)))

    def recorded(fn):
        """fn() with the main-path calls of path_calls' kernels recorded."""
        was, recording[0] = recording[0], True
        try:
            return fn()
        finally:
            recording[0] = was

    def counted(fn):
        """fn() with every launch count set to 0 just before; (result, counts)."""
        torch.cuda.synchronize()
        KV.reset_launches()
        out = recorded(fn)
        torch.cuda.synchronize()
        return out, dict(KV.LAUNCHES)

    # -- registration: the 1M-row table from compressed keys, KeyValidate on the card
    keys = [d["comp"][r % N_KEYS] for r in range(TABLE_ROWS)]
    t = time.perf_counter()
    reg_planes, reg_flags, reg_bad = encode_pubkey_planes(keys[:REG_CHUNK])
    encode_ms = (time.perf_counter() - t) * 1e3
    table = PubkeyTable()
    # the registration's split: host encoding (host clock, summed over the
    # chunks), the kernel (CUDA events around each launch) and the rest
    reg_encode_ms, reg_events = [0.0], []
    encode_orig, kv_orig = PT.encode_pubkey_planes, KV.g1_keyvalidate

    def timed_encode(chunk):
        t0 = time.perf_counter()
        out = encode_orig(chunk)
        reg_encode_ms[0] += (time.perf_counter() - t0) * 1e3
        return out

    def timed_kv(x, flags):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = kv_orig(x, flags)
        b.record()
        reg_events.append((a, b))
        return out

    PT.encode_pubkey_planes, KV.g1_keyvalidate = timed_encode, timed_kv
    try:
        t = time.perf_counter()
        idx, counts = counted(lambda: table.register_compressed(keys, device_batch=REG_CHUNK))
        reg_s = time.perf_counter() - t
    finally:
        PT.encode_pubkey_planes, KV.g1_keyvalidate = encode_orig, kv_orig
    reg_kernel_ms = sum(a.elapsed_time(b) for a, b in reg_events)
    reg_split = {"total_ms": reg_s * 1e3, "host_encoding_ms": reg_encode_ms[0], "kernel_ms": reg_kernel_ms,
                 "rest_ms": reg_s * 1e3 - reg_encode_ms[0] - reg_kernel_ms, "chunks": len(reg_events)}
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
        f"(host clock, one run) = host encoding {reg_encode_ms[0]:.1f} ms (encode_pubkey_planes, numpy, summed over "
        f"{len(reg_events)} chunks; {encode_ms:.1f} ms for one chunk alone) + kernel {reg_kernel_ms:.3f} ms (CUDA "
        f"events around each launch) + the rest {reg_split['rest_ms']:.1f} ms (copies, the verdicts' reads, "
        f"appending the planes)")
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

    def plain_and_kernel(name, n, kernel, plain, *args, plain_runs=0, tag=None):
        """plain_runs 0: the plain version timed once, without a warm-up
        (seconds a call for these kernels), else the median of plain_runs
        after a warm-up; tag: a third key of the result (a row's extra
        shapes)."""
        k_ms, k_out = cuda_ms(lambda: kernel(*args))
        p_ms, p_out = cuda_ms(lambda: plain(*args), max(plain_runs, 1), warm=plain_runs > 0)
        k_outs = k_out if isinstance(k_out, tuple) else (k_out,)
        p_outs = p_out if isinstance(p_out, tuple) else (p_out,)
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(k_outs, p_outs))
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(k_outs, p_outs)):
            raise AssertionError(f"{name} at N={n}: kernel differs from plain version (max {err})")
        results[(name, n) if tag is None else (name, n, tag)] = (k_ms, p_ms, err)
        how = f"median of {plain_runs}" if plain_runs else "one run"
        log(f"kernel {name} N={n}{'' if tag is None else f' ({tag})'}: equal to plain bit for bit; kernel "
            f"{k_ms:.3f} ms (median of {TIMED_RUNS}), "
            f"plain {p_ms:.3f} ms ({how}) (CUDA events)")
        return k_out

    # KeyValidate on one registration chunk (the main path's shape), and on
    # the fault job beside 128 keys made from E(Fp)'s cofactor components
    kv_x, kv_flags = torch.from_numpy(reg_planes).to(dev), torch.from_numpy(reg_flags).to(dev)
    _, kv_ok = plain_and_kernel("g1_keyvalidate", REG_CHUNK, KV.g1_keyvalidate, KV.g1_keyvalidate_plain, kv_x,
                                kv_flags, plain_runs=0)
    cof_planes, cof_flags, cof_bad = encode_pubkey_planes(d["cof_keys"])
    kv_x = torch.from_numpy(np.concatenate([rej_planes, cof_planes], axis=1)).to(dev)
    kv_flags = torch.from_numpy(np.concatenate([rej_flags, cof_flags], axis=1)).to(dev)
    _, kv_ok256 = plain_and_kernel("g1_keyvalidate", 256, KV.g1_keyvalidate, KV.g1_keyvalidate_plain, kv_x,
                                   kv_flags, plain_runs=0)
    want256 = [int(i not in KEY_FAULTS) for i in range(128)] + [int(v) for v in d["cof_truth"]]
    if not bool(kv_ok.all()) or cof_bad.any() or kv_ok256[0].tolist() != want256:
        raise AssertionError(f"g1_keyvalidate: {int(kv_ok.sum())} of {REG_CHUNK} keys valid; on the fault job and "
                             f"the cofactor keys {kv_ok256[0].tolist()} where the oracle says {want256}")
    kv_shape = torch.zeros(4, dtype=torch.int32)
    if B.load("keyvalidate").lt_kv_launch_shape(kv_shape.data_ptr()) != 0:
        raise AssertionError("g1_keyvalidate: lt_kv_launch_shape failed")
    threads, smem, per_sm, slots = kv_shape.tolist()
    kv_blocks = -(-REG_CHUNK // threads)
    kv_info = {"threads_per_block": threads, "dynamic_smem_bytes_per_block": smem, "slots_per_lane": slots,
               "blocks_per_sm_occupancy_api": per_sm, "warps_per_sm_occupancy_api": per_sm * threads // 32,
               "blocks": kv_blocks, "warps_per_sm_from_grid": kv_blocks * threads / 32 / N_SM,
               "waves": kv_blocks / (per_sm * N_SM), "cofactor_keys": len(d["cof_keys"]),
               "cofactor_keys_in_g1": sum(d["cof_truth"]),
               "ptxas": next(e for k, e in ptxas_entries(ptxas["keyvalidate"]).items() if "keyvalidate" in k)}
    log(f"kernel g1_keyvalidate: the fault job (refused exactly at {sorted(KEY_FAULTS)}) and {len(d['cof_keys'])} "
        f"keys from E(Fp)'s cofactor components ({sum(d['cof_truth'])} in G1 by the oracle's [r]P), every verdict "
        f"the oracle's; launch {threads} threads a block, {smem} B dynamic shared memory a block ({slots} slots a "
        f"lane), {per_sm} blocks ({per_sm * threads // 32} warps) an SM by "
        f"cudaOccupancyMaxActiveBlocksPerMultiprocessor; {REG_CHUNK} lanes = {kv_blocks} blocks, "
        f"{kv_info['warps_per_sm_from_grid']:.2f} warps an SM from the grid, {kv_info['waves']:.2f} waves; "
        f"ptxas {kv_info['ptxas']}")
    seg_units = {}  # (name, n[, "lanes"]) -> the additions the segmented sum needs on the call's data
    seg_made = {}  # the same -> the additions the kernel makes (where neither operand is infinity)

    def seg_needed(dead, group):
        """Live lanes less live groups: one addition per live lane after its group's first."""
        live = dead[0] == 0
        return int(live.sum()) - int(torch.unique(group[live]).numel())

    sweep = {}  # name -> (operands, flag output) at N = 512, for the lane sweep of g1_rpk and g2_decompress
    affine_steps = {}  # the timed affine_g2 call's key -> its inversions' binary-GCD steps on its data
    ingest = {}  # (row, n, path) -> (max abs err, mont_convert_plain's ms on the same planes)

    def ingest_held(row, n, path, got, plain_in):
        """The Montgomery planes a heading kernel wrote against
        mont_convert_plain of its plain input planes, on the card, bit for
        bit (the rows of _k_mont8 and _k_mont4)."""
        p_ms, want = cuda_ms(lambda: tuple(KV.mont_convert_plain(x) for x in plain_in), PLAIN_RUNS)
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, want))
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{row} ({FUSED.get(row)} on the {path} path) at N={n}: the Montgomery planes "
                                 f"differ from mont_convert_plain's (max {err})")
        ingest[row, n, path] = (err, p_ms)
        log(f"kernel {row} N={n} ({path}): the Montgomery planes the heading kernel wrote equal mont_convert_plain's "
            f"bit for bit; mont_convert_plain {p_ms:.3f} ms on the same planes (median of {PLAIN_RUNS})")

    for n in JOBS:
        # the per-set path's kernels on the mixed job: g2_subgroup_check
        # takes the plain signature and message and makes the path's
        # Montgomery ingest (_k_mont8); timed first on the Montgomery points
        # (the wire per-set path's launch, without the ingest)
        idx, kmask, planes, sig_inf, valid = verifier._prepare(sets[:n])
        msg_p, sig_p = KV._decoded_inputs(idx, kmask, planes, n)
        ops = KV.each_operands(tx, ty, idx, kmask, msg_p, sig_p, sig_inf != 0, valid, plain=True)
        plain_and_kernel("g2_subgroup_check", n, KV.g2_subgroup_check, KV.g2_subgroup_check_plain,
                         KV.mont_convert_plain(ops["sub"][0]), ops["sub"][1], plain_runs=0, tag="no_ingest")
        sub_out = plain_and_kernel("g2_subgroup_check", n, KV.g2_subgroup_check, KV.g2_subgroup_check_plain,
                                   *ops["sub"])
        ingest_held("mont_convert", n, "per_set", sub_out[1:], (ops["sub"][0], ops["sub"][2]))
        sub, miller_pk, miller_sig = KV.each_miller_operands(ops, sub_out)
        sweep["g2_subgroup_check"] = (ops["sub"], sub)
        f1 = plain_and_kernel("miller_loop", n, KV.miller_loop, KV.miller_loop_plain, *miller_pk)
        f2 = KV.miller_loop(*miller_sig)
        if not torch.equal(f2, KV.miller_loop_plain(*miller_sig)):
            raise AssertionError(f"miller_loop (-G1, sig) at N={n}: kernel differs from plain version")
        ok = plain_and_kernel("each_final", n, KV.each_final, KV.each_final_plain, ops["live_row"], f1, f2)
        log(f"kernel outputs N={n}: {int(sub.sum())} lanes in G2, {int(ok.sum())} final exps equal to one")
        pairing_ops = (miller_pk, miller_sig, ops["live_row"])

        # the RLC batch path's kernels on the all-valid job: g2_rsig_sub
        # makes the path's ingest (_k_mont8), timed first on the Montgomery
        # signature (the wire paths' launch)
        idx, kmask, planes, sig_inf, valid = verifier._prepare(valid_sets[:n])
        msg_p, sig_p = KV._decoded_inputs(idx, kmask, planes, n)
        rwords = torch.from_numpy(make_rand_words(n, np.random.default_rng(SEED + n))).to(dev)
        ops = KV.batch_operands(tx, ty, idx, kmask, msg_p, sig_p, sig_inf != 0, valid, rwords, plain=True)
        rpk, rpk_inf = plain_and_kernel("g1_rpk", n, KV.g1_rpk, KV.g1_rpk_plain, *ops["g1_rpk"])
        sweep["g1_rpk"] = (ops["g1_rpk"], rpk_inf)
        rs_ops = ops["g2_rsig_sub"]
        plain_and_kernel("g2_rsig_sub", n, KV.g2_rsig_sub, KV.g2_rsig_sub_plain, KV.mont_convert_plain(rs_ops[0]),
                         *rs_ops[1:3], plain_runs=0, tag="no_ingest")
        rs = plain_and_kernel("g2_rsig_sub", n, KV.g2_rsig_sub, KV.g2_rsig_sub_plain, *rs_ops)
        (rsig, rsig_inf, sub), msg = rs[:3], KV.batch_msg(ops, rs)
        ingest_held("mont_convert", n, "batch", (msg,), (rs_ops[3],))
        excl = (~ops["live"])[None, :].to(torch.int32) | rsig_inf
        sweep["sum_g2"] = (rsig, excl)
        jsum, jsum_inf = plain_and_kernel("sum_g2", n, KV.sum_g2, KV.sum_g2_plain, rsig, excl)
        f_msg = KV.miller_loop(rpk, msg)
        sweep["prod12"] = (ops["live_row"], f_msg)
        fprod = plain_and_kernel("prod12", n, KV.prod12, KV.prod12_plain, ops["live_row"], f_msg)
        a, a_inf = plain_and_kernel("affine_g2", n, KV.affine_g2, KV.affine_g2_plain, jsum, jsum_inf)
        affine_steps[n] = KV.affine_g2_gcd_steps(jsum)
        fa = plain_and_kernel("miller_loop_1", n, KV.miller_loop, KV.miller_loop_plain, KV._neg_g1(dev, 1), a)
        ok = plain_and_kernel("final_one", n, KV.final_one, KV.final_one_plain, a_inf, fprod, fa)
        if int(ok[0, 0]) != 1 or int(a_inf[0, 0]) != 0 or not bool(sub.all()):
            raise AssertionError(f"batch kernels at N={n}: the all-valid batch does not verify")
        log(f"kernel outputs N={n}: all-valid batch: {int(sub.sum())} lanes in G2, aggregate finite, "
            f"final exp of the product equal to one")
        # its grouped G1 side: the sets of a root are one run of 64 lanes
        group, head_lanes, glive = (torch.from_numpy(a).to(dev) for a in verifier._grouping(wire_valid[:n], n))
        gops = KV.grouped_operands(ops, msg, rpk, rpk_inf, group, head_lanes, glive)
        pts, seg_inf = plain_and_kernel("seg_sum_g1", n, KV.seg_sum_g1, KV.seg_sum_g1_plain, *gops["seg_sum_g1"])
        seg_units["seg_sum_g1", n] = seg_needed(*gops["seg_sum_g1"][1:])
        seg_made["seg_sum_g1", n] = KV.seg_additions("seg_sum_g1", *gops["seg_sum_g1"])
        sweep["seg_sum_g1"] = gops["seg_sum_g1"]
        g, q, live_row = KV._group_heads(pts, seg_inf, *gops["heads"])
        ok = KV._batch_tail(KV.prod12(live_row, KV.miller_loop(g, q)), jsum, jsum_inf)
        if int(ok[0, 0]) != 1 or int(live_row.sum()) != n // N_KEYS:
            raise AssertionError(f"grouped batch kernels at N={n}: not verified ({int(live_row.sum())} groups)")
        log(f"kernel outputs N={n}: grouped: {int(live_row.sum())} group totals on one {KV.BT}-lane Miller "
            f"tile, final exp of the product equal to one")

        # the wire paths' ingest: the signatures of the wire mixed job and
        # its 4 message planes (_k_mont4's work), timed first without the
        # messages (the pre-verify aggregation's launch)
        args, host_bad = verifier._prepare_wire(wire_mixed[:n])
        msg_w = args.msg.reshape(2, 2, LY.NL, n)
        plain_and_kernel("g2_decompress", n, KV.g2_decompress, KV.g2_decompress_plain, args.sig_x, args.sig_flags,
                         plain_runs=0, tag="no_ingest")
        _, dec_ok, msg_m = plain_and_kernel("g2_decompress", n, KV.g2_decompress, KV.g2_decompress_plain,
                                            args.sig_x, args.sig_flags, msg_w)
        ingest_held("mont_convert_4", n, "wire_batch", (msg_m,), (msg_w,))
        sweep["g2_decompress"] = ((args.sig_x, args.sig_flags, msg_w), dec_ok)
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
        seg_made["seg_sum_g2", n] = KV.seg_additions("seg_sum_g2", xy, bad, group)
        sweep["seg_sum_g2"] = (xy, bad, group)
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
    # r pk on agg_pk's Jacobian aggregates (Z != 1, the aggregate batch's
    # input), with lanes at infinity and zero scalars among them
    agg_p, _ = KV.agg_pk(tx, ty, args.idx, args.kmask)
    lane = torch.arange(agg_p.shape[-1], device=dev)
    e_inf = (lane % 37 == 3).to(torch.int32)[None].contiguous()
    e_r = sweep["g1_rpk"][0][2][:, :agg_p.shape[-1]].clone()
    e_r[:, lane % 41 == 7] = 0
    _, e_out_inf = plain_and_kernel("g1_rpk", agg_p.shape[-1], KV.g1_rpk, KV.g1_rpk_plain, agg_p, e_inf, e_r,
                                    plain_runs=0, tag="jacobian")
    if not torch.equal(e_out_inf, (e_inf | (e_r == 0).all(dim=0, keepdim=True)).to(torch.int32)):
        raise AssertionError("g1_rpk on agg_pk's aggregates: a lane's infinity flag is not p_inf or r == 0")
    # the hash on 128 and 512 distinct roots, encoded as MessageCache
    # encodes them; every point hash_to_g2 of its root
    hash_steps = {}  # lanes -> the binary GCD's outer steps of the call's inversions
    hash_root_muls = {}  # lanes -> the square roots' chain products the call's data needs
    for n in HASH_ROOTS[1:]:
        u, sgn = (torch.from_numpy(a).to(dev) for a in hash_field_planes(d["hash_roots"][:n]))
        hash_steps[n], hash_root_muls[n] = KV.hash_g2_gcd_steps(u), KV.hash_g2_root_muls(u)
        h_out, h_ok = plain_and_kernel("hash_g2", n, KV.hash_g2, KV.hash_g2_plain, u, sgn, plain_runs=0)
        if not bool(h_ok.all()) or jacobian_to_affine(h_out, n) != d["hash_pts"][:n]:
            raise AssertionError(f"hash_g2 at N={n}: a lane flagged not ok, or a point is not hash_to_g2's")
    log(f"kernel outputs hash_g2: {', '.join(map(str, HASH_ROOTS[1:]))} distinct roots, every lane ok, every "
        f"point equal to crypto/hash_to_curve.py hash_to_g2 of its root")

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
    # r pk on the all-valid batch's operands and the decompression on the
    # wire mixed job's (every kind of lane: points, infinity, x off the
    # curve), sliced to the same lane counts; the verdicts of the slices
    # are the N = 512 run's
    for n in WARP_LANES:
        sl = lambda t: t[..., :n].contiguous()  # noqa: E731
        for name, (kernel, plain) in (("g1_rpk", (KV.g1_rpk, KV.g1_rpk_plain)),
                                      ("g2_decompress", (KV.g2_decompress, KV.g2_decompress_plain)),
                                      ("g2_subgroup_check", (KV.g2_subgroup_check, KV.g2_subgroup_check_plain))):
            operands, flags = sweep[name]
            out_n = plain_and_kernel(name, n, kernel, plain, *map(sl, operands), plain_runs=0, tag="lanes")
            flags_n = out_n[0] if name == "g2_subgroup_check" else out_n[1]
            if not torch.equal(flags_n, sl(flags)):
                raise AssertionError(f"{name} at N={n}: flags differ from the N = {JOBS[-1]} run's")
    for name, source in (("miller_loop", "miller"), ("each_final", "final"), ("final_one", "tail"),
                         ("g2_rsig_sub", "randmul"), ("g1_rpk", "randmul"), ("g2_decompress", "ingest"),
                         ("hash_g2", "ingest"), ("g2_subgroup_check", "subgroup")):
        # the shape and program figures of the last launch of the
        # library's kernel `name`, the N = 512 one made above (hash_g2's:
        # its 512-root batch), as its C entry point launched it
        shape = (ctypes.c_int * 8)()
        if B.load(source).lt_warp_last_launch(name.encode(), shape) != 0:
            raise AssertionError(f"{name}: {source} reports no launch of it")
        lanes, blocks, threads, lpb, smem, slots, phases, rounds = list(shape)
        want = HASH_ROOTS[-1] if name == "hash_g2" else WARP_LANES[-1]
        if lanes != want or blocks * lpb < lanes or threads % lpb or rounds != KV.ROUNDS_PER_LANE[name]:
            raise AssertionError(f"{name}: last launch {list(shape)} is not {want} lanes of "
                                 f"{KV.ROUNDS_PER_LANE[name]} rounds")
        entry = next(e for k, e in ptxas_entries(ptxas[source]).items() if name.replace("_loop", "") in k)
        warp_info[name] = {"rounds_per_lane": rounds, "fp_muls_per_lane": KV.FP_MULS_PER_LANE[name],
                           "phases_per_lane": phases, "slots_per_lane": slots, "lanes_per_block": lpb,
                           "threads_per_lane": threads // lpb, "dynamic_smem_bytes_per_block": smem,
                           "ptxas": entry}
        ingest_words = ""
        if (name, want, "no_ingest") in results:  # the heading kernels: the launch without the ingest beside it
            skip = (KV.INGEST_ROUNDS, KV.INGEST_MULS) if name in ("g2_subgroup_check", "g2_rsig_sub") else (0, 0)
            warp_info[name].update({
                "ingest_planes_per_lane": 4 if name == "g2_decompress" else 8,
                "rounds_per_lane_without_ingest": rounds - skip[0],
                "fp_muls_per_lane_without_ingest": KV.FP_MULS_PER_LANE[name] - skip[1],
                "ms_by_n_without_ingest": {m: results[name, m, "no_ingest"][0] for m in JOBS},
                "ms_by_n_with_ingest": {m: results[name, m][0] for m in JOBS}})
            ingest_words = (f"; with the Montgomery ingest of {warp_info[name]['ingest_planes_per_lane']} planes a "
                            f"lane against without it: {rounds} / {rounds - skip[0]} "
                            f"rounds, card ms " + ", ".join(f"N={m}: {results[name, m][0]:.3f} / "
                                                            f"{results[name, m, 'no_ingest'][0]:.3f}" for m in JOBS))
        log(f"warp kernel {name} (its N = {lanes} launch: {blocks} blocks of {threads} threads): "
            f"{threads // lpb} threads per lane, {lpb} lanes per block; {rounds} rounds "
            f"({KV.FP_MULS_PER_LANE[name]} Fp products) in {phases} phases per lane, {slots} slots per lane, "
            f"{smem} B dynamic shared memory per block; ptxas {entry}; card ms by lanes " + ", ".join(
                f"{n}: {results[key][0]:.3f}" for n in sorted(set(WARP_LANES + JOBS))
                for key in ((name, n, "lanes"), (name, n))
                if key in results and (key[2:] or (name, n, "lanes") not in results)) + ingest_words)

    # the lane sum's tree at every lane count of SUM_LANES: the N = 512
    # batch's r_i sig_i repeated, with excluded lanes, lanes 0 and 1 equal
    # (a doubling at the first level) and lane 3 the negation of lane 2
    # (infinity there); each call relaunches the kernel on the partials
    from lodestar_tpu_torch.kernels import fp2 as F2

    rsig, excl = sweep["sum_g2"]
    sum_launches = {}  # lanes -> the launches one call made, as the entry point reports them
    for n in SUM_LANES:
        idx = torch.arange(n, device=dev) % rsig.shape[-1]
        pts, ex = rsig[..., idx].contiguous(), excl[..., idx].contiguous()
        ex[0, 5::7] = 1
        if n >= 2:
            pts[..., 1] = pts[..., 0]
            ex[0, :2] = 0
        if n >= 4:
            pts[..., 3] = pts[..., 2]
            pts[1, ..., 3:4] = LY.digits_to_planes(F2.neg2(LY.planes_to_digits(pts[1, ..., 2:3].contiguous())))
            ex[0, 2:4] = 0
        _, s_inf = plain_and_kernel("sum_g2", n, KV.sum_g2, KV.sum_g2_plain, pts, ex, plain_runs=0, tag="lanes")
        before = KV.LAUNCHES["sum_g2"]
        KV.sum_g2(pts, ex)
        launches = KV.LAUNCHES["sum_g2"] - before
        shape = (ctypes.c_int * 8)()
        if B.load("reduce").lt_warp_last_launch(b"sum_g2", shape) != 0:
            raise AssertionError("sum_g2: reduce reports no launch of it")
        lanes, blocks, threads, span, smem, slots, phases, rounds = list(shape)
        sum_launches[n] = launches
        if (launches != SUM_LAUNCHES[n] or [lanes, blocks, threads, span] != [n, -(-n // 32), 32 * 16, 32]
                or rounds != KV.ROUNDS_PER_LANE["sum_g2"]):
            raise AssertionError(f"sum_g2 at N={n}: {launches} launches a call, first launch {list(shape)}")
        if n == JOBS[-1]:
            entry = next(e for k, e in ptxas_entries(ptxas["reduce"]).items() if "sum_tree" in k)
            warp_info["sum_g2"] = {"rounds_per_addition": rounds, "fp_muls_per_addition": KV.FP_MULS_PER_LANE["sum_g2"],
                                   "phases_per_addition": phases, "slots_per_warp": slots, "warps_per_block": threads // 32,
                                   "elements_per_block": span, "dynamic_smem_bytes_per_block": smem, "ptxas": entry}
        log(f"sum_g2 N={n}: {launches} launches (first: {blocks} blocks of {threads} threads, {span} elements per "
            f"block), {(n - 1).bit_length()} tree levels, {n - 1} complete additions; sum "
            f"{'infinity' if int(s_inf[0, 0]) else 'finite'}")
    e = warp_info["sum_g2"]
    log(f"warp kernel sum_g2: one warp per complete addition, {e['warps_per_block']} warps ({e['elements_per_block']} "
        f"elements) per block; {e['rounds_per_addition']} rounds ({e['fp_muls_per_addition']} Fp products) in "
        f"{e['phases_per_addition']} phases per addition, {e['slots_per_warp']} slots per warp, "
        f"{e['dynamic_smem_bytes_per_block']} B dynamic shared memory per block; ptxas {e['ptxas']}; card ms by lanes "
        + ", ".join(f"{n}: {results['sum_g2', n, 'lanes'][0]:.3f}" for n in SUM_LANES))

    # the affine conversion at the tail's one lane (the batch's aggregate)
    # and on a 128-lane tile with lanes flagged infinity and lanes with Z = 0
    jsum1, jsum1_inf = KV.sum_g2(rsig, excl)
    for n in AFFINE_LANES:
        if n == 1:
            p, p_inf = jsum1, jsum1_inf
        else:
            p, p_inf = rsig[..., :n].clone(), torch.zeros((1, n), dtype=torch.int32, device=dev)
            p_inf[0, 3::16] = 1
            p[2, ..., 5::16] = 0
            p[2, ..., 3::32] = 0
        _, a_inf = plain_and_kernel("affine_g2", n, KV.affine_g2, KV.affine_g2_plain, p, p_inf, plain_runs=0,
                                    tag="lanes")
        affine_steps[n, "lanes"] = KV.affine_g2_gcd_steps(p)
        want = (p_inf[0] != 0) | (p[2] == 0).reshape(-1, n).all(dim=0)
        if a_inf[0].tolist() != want.to(torch.int32).tolist():
            raise AssertionError(f"affine_g2 at N={n}: infinity flags are not the flagged and Z = 0 lanes")
    shape = (ctypes.c_int * 8)()
    if B.load("tail").lt_warp_last_launch(b"affine_g2", shape) != 0:
        raise AssertionError("affine_g2: tail reports no launch of it")
    lanes, blocks, threads, lpb, smem, slots, phases, rounds = list(shape)
    if lanes != AFFINE_LANES[-1] or blocks * lpb < lanes or rounds != KV.ROUNDS_PER_LANE["affine_g2"]:
        raise AssertionError(f"affine_g2: last launch {list(shape)}")
    entry = next(e for k, e in ptxas_entries(ptxas["tail"]).items() if "affine" in k)
    warp_info["affine_g2"] = {"rounds_per_lane": rounds, "fp_muls_per_lane": KV.FP_MULS_PER_LANE["affine_g2"],
                              "phases_per_lane": phases, "slots_per_lane": slots, "lanes_per_block": lpb,
                              "threads_per_lane": threads // lpb, "dynamic_smem_bytes_per_block": smem,
                              "ptxas": entry}
    log(f"warp kernel affine_g2 (its N = {lanes} launch: {blocks} blocks of {threads} threads): {threads // lpb} "
        f"threads per lane, {lpb} lanes per block; {rounds} rounds (one the binary-GCD inversion; "
        f"{KV.FP_MULS_PER_LANE['affine_g2']} Fp products) in {phases} phases per lane, {slots} slots per lane, {smem} B "
        f"dynamic shared memory per block; ptxas {entry}; card ms by lanes "
        + ", ".join(f"{n}: {results['affine_g2', n, 'lanes'][0]:.3f}" for n in AFFINE_LANES))

    # the Fp12 lane product's tree at every lane count of PROD_LANES: the
    # N = 512 batch's Miller values repeated, every seventh lane dead; each
    # call relaunches the kernel on the partials
    live_row, f_msg = sweep["prod12"]
    prod_launches = {}  # lanes -> the launches one call made, as the entry point reports them
    for n in PROD_LANES:
        idx = torch.arange(n, device=dev) % f_msg.shape[-1]
        f, live = f_msg[..., idx].contiguous(), live_row[..., idx].contiguous()
        live[0, 3::7] = 0
        plain_and_kernel("prod12", n, KV.prod12, KV.prod12_plain, live, f, plain_runs=0, tag="lanes")
        before = KV.LAUNCHES["prod12"]
        KV.prod12(live, f)
        prod_launches[n] = KV.LAUNCHES["prod12"] - before
        shape = (ctypes.c_int * 8)()
        if B.load("reduce").lt_warp_last_launch(b"prod12", shape) != 0:
            raise AssertionError("prod12: reduce reports no launch of it")
        lanes, blocks, threads, span, smem, slots, phases, rounds = list(shape)
        if (prod_launches[n] != PROD_LAUNCHES[n] or [lanes, blocks, threads, span] != [n, -(-n // 32), 32 * 16, 32]
                or rounds != KV.ROUNDS_PER_LANE["prod12"]):
            raise AssertionError(f"prod12 at N={n}: {prod_launches[n]} launches a call, first launch {list(shape)}")
        if n == JOBS[-1]:
            entry = next(e for k, e in ptxas_entries(ptxas["reduce"]).items() if "prod_tree" in k)
            warp_info["prod12"] = {"rounds_per_product": rounds, "fp_muls_per_product": KV.FP_MULS_PER_LANE["prod12"],
                                   "phases_per_product": phases, "slots_per_warp": slots,
                                   "warps_per_block": threads // 32, "elements_per_block": span,
                                   "dynamic_smem_bytes_per_block": smem, "ptxas": entry}
    e = warp_info["prod12"]
    log(f"warp kernel prod12: one warp per Fp12 product, {e['warps_per_block']} warps ({e['elements_per_block']} "
        f"elements) per block; {e['rounds_per_product']} rounds ({e['fp_muls_per_product']} Fp products) in "
        f"{e['phases_per_product']} phases per product, {e['slots_per_warp']} slots per warp, "
        f"{e['dynamic_smem_bytes_per_block']} B dynamic shared memory per block; ptxas {e['ptxas']}; card ms by lanes "
        + ", ".join(f"{n}: {results['prod12', n, 'lanes'][0]:.3f} ({prod_launches[n]} launches)" for n in PROD_LANES))

    # the segmented scans at every lane count of SEG_LANES: the grouped wire
    # batch's N = 512 operands (G1) and the aggregation's (G2) repeated,
    # each copy its own groups; one launch per round, as the entry point
    # reports them, and each call's launch as its library records it
    seg_launches = {}  # (name, lanes) -> the launches one call made
    for name, (kernel, plain), key in (("seg_sum_g1", (KV.seg_sum_g1, KV.seg_sum_g1_plain), "seg_g1"),
                                       ("seg_sum_g2", (KV.seg_sum_g2, KV.seg_sum_g2_plain), "seg_g2")):
        pts0, dead0, group0 = sweep[name]
        m0 = group0.shape[0]
        for n in SEG_LANES:
            idx = torch.arange(n, device=dev)
            args = (pts0[..., idx % m0].contiguous(), dead0[..., idx % m0].contiguous(),
                    (group0[idx % m0] + (idx // m0) * (int(group0.max()) + 1)).to(torch.int32).contiguous())
            plain_and_kernel(name, n, kernel, plain, *args, plain_runs=0, tag="lanes")
            before = KV.LAUNCHES[name]
            kernel(*args)
            seg_launches[name, n] = KV.LAUNCHES[name] - before
            seg_units[name, n, "lanes"] = seg_needed(*args[1:])
            seg_made[name, n, "lanes"] = KV.seg_additions(name, *args)
            shape = (ctypes.c_int * 8)()
            if B.load("segsum").lt_warp_last_launch(name.encode(), shape) != 0:
                raise AssertionError(f"{name}: segsum reports no launch of it")
            lanes, blocks, threads, wpb, smem, slots, phases, rounds = list(shape)
            w = KV.seg_warps(n)
            if (seg_launches[name, n] != KV.seg_rounds(n) or [lanes, blocks, threads, wpb] != [n, -(-n // w), 32 * w, w]
                    or rounds != KV.ROUNDS_PER_LANE[name]):
                raise AssertionError(f"{name} at N={n}: {seg_launches[name, n]} launches a call, launch {list(shape)}")
            if n == JOBS[-1]:
                entry = next(e for k, e in ptxas_entries(ptxas["segsum"]).items() if key in k)
                warp_info[name] = {"rounds_per_addition": rounds, "fp_muls_per_addition": KV.FP_MULS_PER_LANE[name],
                                   "phases_per_addition": phases, "slots_per_warp": slots, "warps_per_block": wpb,
                                   "dynamic_smem_bytes_per_block": smem, "ptxas": entry}
        e = warp_info[name]
        log(f"warp kernel {name}: one warp per lane and round of the scan (a lane whose operand is infinity copies "
            f"the other), {e['warps_per_block']} warps per block at N = {JOBS[-1]}; {e['rounds_per_addition']} rounds "
            f"({e['fp_muls_per_addition']} Fp products) in {e['phases_per_addition']} phases per addition, "
            f"{e['slots_per_warp']} slots per warp, {e['dynamic_smem_bytes_per_block']} B dynamic shared memory per "
            f"block; ptxas {e['ptxas']}; card ms by lanes " + ", ".join(
                f"{n}: {results[name, n, 'lanes'][0]:.3f} ({seg_launches[name, n]} launches, "
                f"{seg_made[name, n, 'lanes']} additions made, {seg_units[name, n, 'lanes']} needed)"
                for n in SEG_LANES))

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

    def job_launches(path, n):
        """Every launch one job of a path makes, by wrapper: its kernels and
        no conversion launch of their own (the heading kernel makes the
        Montgomery ingest); the lane sum and the lane product relaunch on
        their partials (SUM_LAUNCHES, PROD_LAUNCHES), the grouped entry's
        product runs on the BT-lane tile and its scan once per round."""
        per_set = {"g2_subgroup_check": 1, "miller_loop": 2, "each_final": 1}
        batch = {"g1_rpk": 1, "g2_rsig_sub": 1, "sum_g2": SUM_LAUNCHES[n], "miller_loop": 2,
                 "prod12": PROD_LAUNCHES[n], "affine_g2": 1, "final_one": 1}
        return {"per_set": per_set, "batch": batch, "wire_per_set": dict(per_set, g2_decompress=1),
                "wire_batch": dict(batch, g2_decompress=1, prod12=PROD_LAUNCHES[KV.BT],
                                   seg_sum_g1=KV.seg_rounds(n))}[path]

    def exact(label, counts, path, n):
        """The job's launches are exactly `job_launches`; -> their total."""
        got, want = {k: v for k, v in counts.items() if v}, job_launches(path, n)
        if got != want:
            raise AssertionError(f"{label}: launches {got}, not {want}")
        return sum(got.values())

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

    def breakdown(label, n, prepare, ms, kms):
        """The job's time split into host preparation, the kernels as the
        path launches them (kms: each wrapper's CUDA-event ms summed over
        its calls in one instrumented run of the path, kernel_ms_in_path)
        and the rest."""
        prep = host_ms(prepare)
        kern = sum(kms.values())
        log(f"breakdown {label} N={n}: job {ms:.3f} ms = host preparation (encode + copy to the card) "
            f"{prep:.3f} ms + kernels {kern:.3f} ms (in the path: one instrumented run, CUDA events, the card "
            f"drained before each call; " + ", ".join(f"{k} {v:.3f}" for k, v in kms.items())
            + f") + the rest {ms - prep - kern:.3f} ms")

    def in_path(fn, names):
        """kernel ms in the path of fn() for the path's kernel wrappers `names`."""
        return kernel_ms_in_path(fn, tuple(names))[1]

    def kernel_ms_in_path(fn, wrappers=GROUPED_WRAPPERS):
        """fn() once with each kernel wrapper of `wrappers` timed by CUDA
        events around its call, the card drained before each (so a time is
        that call's launches alone); (result, name -> ms summed over the
        wrapper's calls, the calls as (name, inputs, outputs), copied after
        each call outside its timing).  Raises unless every wrapper was
        called through the patch."""
        real = {name: getattr(KV, name) for name in wrappers}
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
        if set(times) != set(wrappers):
            raise AssertionError(f"wrappers the timed run did not call through the patch: "
                                 f"{sorted(set(wrappers) - set(times))}")
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

    def held_in_path(label, fn, wrappers):
        """fn() once more through kernel_ms_in_path, then each of its kernel
        calls held against its plain version; -> (fn's result, the log's
        words on it, name -> ms in the path)."""
        out, kms, calls = kernel_ms_in_path(fn, wrappers)
        held_s = hold_calls(label, calls)
        return out, (f"kernel ms in the path (one instrumented run, CUDA events, the card drained before each "
                     f"call): " + ", ".join(f"{k} {v:.3f}" for k, v in kms.items()) + f"; each of its "
                     f"{len(calls)} kernel calls equal to its plain version on the same inputs bit for bit "
                     f"({', '.join(name for name, _, _ in calls)}; {held_s:.1f} s)"), kms

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
        total = exact(f"per-set N={n}", counts, "per_set", n)
        if verifier.verify_signature_sets(job) != all(want):
            raise AssertionError(f"N={n}: verify_signature_sets gave the wrong verdict")
        if not verifier.verify_signature_sets([s for s, w in zip(job, want) if w]):
            raise AssertionError(f"N={n}: verify_signature_sets rejected the valid sets")
        ms = host_ms(lambda: verifier.verify_signature_sets_individually(job))
        log(f"main path per-set N={n}: {sum(got)} of {n} True, every verdict equals the ground truth; "
            f"launches {json.dumps(counts)} ({total} in all, g2_subgroup_check making the Montgomery ingest); "
            f"verify_signature_sets_individually {ms:.1f} ms = "
            f"{n / ms * 1e3:.1f} sets/s (host clock, median of 3 after a warm-up)")
        breakdown("per-set", n, lambda: verifier._prepare(job), ms,
                  in_path(lambda: verifier.verify_signature_sets_individually(job), PER_SET))
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
        total = exact(f"batch N={n}", counts, "batch", n)
        ms = host_ms(lambda: verifier.verify_signature_sets(job, batchable))
        log(f"main path batch N={n}: accepted {n} of {n} valid sets as one RLC batch; launches "
            f"{json.dumps(counts)} ({total} in all, g2_rsig_sub making the Montgomery ingest); "
            f"verify_signature_sets(batchable=True) {ms:.1f} ms = {n / ms * 1e3:.1f} "
            f"sets/s (host clock, median of 3 after a warm-up)")
        breakdown("batch", n, lambda: verifier._prepare(job), ms,
                  in_path(lambda: verifier.verify_signature_sets(job, batchable), BATCH))
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
        ok = recorded(lambda: verifier.finish_job(job))
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

    # the cold message cache: the 8 roots hashed in one 128-lane launch, then
    # 128 and 512 new roots in one launch each; each lookup's time split into
    # the host's hash_to_field and encoding, the kernel (CUDA events) and the
    # host's affine conversion
    cold_split = {}  # roots -> {"total", "host_hash_to_field", "kernel", "host_affine"} ms

    def split_timed(fn):
        """fn() with the three parts of MessageCache._hash_batch_device timed."""
        parts, real = {}, (IN.hash_field_planes, KV.hash_g2, IN.jacobian_to_affine)

        def host(name, f):
            def run(*args):
                t0 = time.perf_counter()
                out = f(*args)
                parts[name] = (time.perf_counter() - t0) * 1e3
                return out
            return run

        def kernel(*args):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = real[1](*args)
            b.record()
            b.synchronize()
            parts["kernel"] = a.elapsed_time(b)
            return out

        IN.hash_field_planes, KV.hash_g2 = host("host_hash_to_field", real[0]), kernel
        IN.jacobian_to_affine = host("host_affine", real[2])
        try:
            t0 = time.perf_counter()
            out = fn()
            parts["total"] = (time.perf_counter() - t0) * 1e3
        finally:
            IN.hash_field_planes, KV.hash_g2, IN.jacobian_to_affine = real
        return out, parts

    for n_roots in HASH_ROOTS:
        roots, want = ((d["roots"], d["hs"]) if n_roots == N_ROOTS
                       else (d["hash_roots"][:n_roots], d["hash_pts"][:n_roots]))
        cache = MessageCache(device=dev)
        (pts, parts), counts = counted(lambda: split_timed(lambda: cache.get_many(roots)))
        if pts != want or counts["hash_g2"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"cold MessageCache of {n_roots} roots: points equal hash_to_g2: {pts == want}; "
                                 f"launches {counts}")
        again, counts2 = counted(lambda: cache.get_many(roots))
        if again != want or sum(counts2.values()) != 0 or cache.hits != n_roots:
            raise AssertionError(f"warm MessageCache: launches {counts2}, hits {cache.hits}")
        cold_split[n_roots] = parts
        lanes = -(-n_roots // KV.BT) * KV.BT
        log(f"main path cold-hash: MessageCache.get_many of {n_roots} roots: one hash_g2 launch of {lanes} lanes, "
            f"every point equals crypto/hash_to_curve.py hash_to_g2; {parts['total']:.1f} ms (host clock, one run) "
            f"= host hash_to_field and encoding {parts['host_hash_to_field']:.1f} ms + hash_g2 {parts['kernel']:.3f} "
            f"ms (CUDA events) + host affine conversion {parts['host_affine']:.1f} ms + the rest "
            f"{parts['total'] - parts['host_hash_to_field'] - parts['kernel'] - parts['host_affine']:.1f} ms; the "
            f"second lookup launched nothing")
        if n_roots == N_ROOTS:
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
        total = exact(f"wire batch N={n}", counts, "wire_batch", n)
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
            f"{entry_of(counts)}); launches {json.dumps(counts)} ({total} in all, g2_decompress making the "
            f"Montgomery ingest of the messages); {ms:.1f} ms = {n / ms * 1e3:.1f} sets/s (host "
            f"clock, median of 3 after a warm-up); the same job through the ungrouped entry {ms_ungrouped:.3f} ms, "
            f"then grouped again {ms_again:.3f} ms (medians of 3)")
        path_kms["wire_batch", n] = in_path(lambda: verifier.verify_signature_sets(job, batchable), GROUPED_BATCH)
        breakdown("wire-batch", n, lambda: verifier._prepare_wire(job), ms, path_kms["wire_batch", n])
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
        total = exact(f"wire per-set N={n}", counts, "wire_per_set", n)
        ms = host_ms(lambda: verifier.verify_signature_sets_individually(job))
        log(f"main path wire-per-set N={n}: {sum(got)} of {n} True, every verdict equals the ground truth; "
            f"launches {json.dumps(counts)} ({total} in all); {ms:.1f} ms = {n / ms * 1e3:.1f} sets/s (host clock, "
            f"median of 3 "
            f"after a warm-up)")
        breakdown("wire-per-set", n, lambda: verifier._prepare_wire(job), ms,
                  in_path(lambda: verifier.verify_signature_sets_individually(job), WIRE_PER_SET))
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
    ok, held, agg_kms = held_in_path("aggregate batch", lambda: verifier.verify_signature_sets(job, batchable),
                                     AGG_WRAPPERS)
    if ok is not True:
        raise AssertionError("aggregate batch: the instrumented run rejected the batch")
    log(f"main path aggregate-batch N={AGG_SETS} K={AGG_K}: accepted as one RLC batch through agg_pk (K bucket "
        f"{k_bucket}) and the grouped entry (one root; {entry_of(counts)}); launches "
        f"{json.dumps(counts)}; {ms:.1f} ms = {AGG_SETS / ms * 1e3:.1f} sets/s = "
        f"{AGG_SETS * AGG_K / ms * 1e3:.1f} pubkeys (signers' signatures)/s (host clock, median of 3 after a "
        f"warm-up); " + held)
    breakdown("aggregate-batch", AGG_SETS, lambda: verifier._prepare_wire(job), ms, agg_kms)
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
    ok, held, _ = held_in_path(f"K = {SYNC_K} job", lambda: verifier.verify_signature_sets(job, batchable),
                               AGG_WRAPPERS + PER_SET_WRAPPERS)
    if ok is not False:
        raise AssertionError(f"K = {SYNC_K} job: the instrumented run gave {ok}")
    log(f"main path sync-aggregate N={SYNC_SETS} K={SYNC_K}: batch rejected, retried per set: verdicts {want} "
        f"equal the ground truth; launches {json.dumps(counts)}; " + held)
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
    aggs2, held_agg, _ = held_in_path("pre-verify aggregation", lambda: verifier.aggregate_wire_signatures(groups),
                                      PREAGG)
    if aggs2 != host_aggs:
        raise AssertionError("pre-verify aggregation: the instrumented run's aggregates differ from the host's")
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
    ok, held_merged, _ = held_in_path("merged sets", lambda: verifier.verify_signature_sets(merged, batchable),
                                      MERGED_WRAPPERS)
    if ok is not True:
        raise AssertionError("merged sets: the instrumented run rejected the batch")
    log(f"main path preagg N={n}: aggregate_wire_signatures of {N_ROOTS} groups of {N_KEYS} wire signatures: "
        f"every aggregate equals the host's bytes (_aggregate_wire_host); launches {json.dumps(counts)}; "
        f"{agg_ms:.1f} ms (host clock, one run, compression on the host included); {held_agg}; a group with a "
        f"95-byte member gave None; the {N_ROOTS} merged sets (K = {N_KEYS}, ground truth all True) accepted as one "
        f"RLC batch ({entry_of(counts2)}; launches {json.dumps(counts2)}; {held_merged})")
    no_host_sets("merged sets")

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
    for n in WIDE_JOBS:
        job = [wire_valid[i % JOBS[-1]] for i in range(n)]
        wide.verify_signature_sets(job, batchable)  # warm-up
        ok, counts = counted(lambda: wide.verify_signature_sets(job, batchable))
        if (ok is not True or counts["final_one"] != 1 or counts["miller_loop"] != 2
                or entry_of(counts) != "verify_batch_device_wire_grouped" or counts["seg_sum_g1"] != KV.seg_rounds(n)):
            raise AssertionError(f"wire N={n}: verdict {ok}, entry {entry_of(counts)}, launches {counts}")
        require(f"wire batch N={n}", counts, GROUPED_BATCH)
        exact(f"wire batch N={n}", counts, "wire_batch", n)
        ms = host_ms(lambda: wide.verify_signature_sets(job, batchable))
        ok, kms, calls = kernel_ms_in_path(lambda: wide.verify_signature_sets(job, batchable))
        if ok is not True:
            raise AssertionError(f"wire N={n}: the instrumented run rejected the batch")
        held_s = hold_calls(f"wire N={n}", calls)
        path_kms["wire_batch", n] = kms
        results["sets_per_s", "wire_batch", n] = n / ms * 1e3
        paths["wire_batch", n] = counts
        log(f"main path wire-batch N={n}: the 512 wire sets repeated, accepted as one RLC batch through the grouped "
            f"entry; launches {json.dumps(counts)}; {ms:.1f} ms = {n / ms * 1e3:.1f} sets/s (host clock, median of "
            f"3 after a warm-up); kernel ms in the path (one instrumented run, CUDA events, the card drained "
            f"before each call; miller_loop the {KV.BT}-lane tile and the one-lane "
            f"tail): " + ", ".join(f"{k} {v:.3f}" for k, v in kms.items()) + f"; sum {sum(kms.values()):.3f}; "
            f"each of its {len(calls)} kernel calls equal to its plain version on the same inputs bit for bit "
            f"({', '.join(name for name, _, _ in calls)}; {held_s:.1f} s)")
        breakdown("wire-batch", n, lambda: wide._prepare_wire(job), ms, kms)
    no_host_sets("wide wire batches")

    # every recorded main-path call of the redesigned kernels against its
    # plain version: the lane sum's calls one plain run each, the others'
    # lanes side by side in one plain run per kernel (a lane's result
    # depends on that lane's inputs alone)
    t = time.perf_counter()
    for name, recs in path_calls.items():
        if not recs:
            raise AssertionError(f"{name}: no main-path run called it")
        sizes = [r[0][0].shape[-1] for r in recs]
        if name in REDUCTIONS:  # one plain run per call
            hold_calls("main path calls", [(name, args, outs) for args, outs in recs])
            warp_info[name]["main_path_calls_held"] = {"calls": len(recs), "lanes": sum(sizes)}
            continue
        # the calls side by side, those with the ingest's operands (plain
        # planes) apart from those on Montgomery points
        for arity in sorted({len(r[0]) for r in recs}):
            part = [r for r in recs if len(r[0]) == arity]
            psizes = [r[0][0].shape[-1] for r in part]
            args = [torch.cat([r[0][i] for r in part], dim=-1) for i in range(arity)]
            k_outs = [torch.cat([r[1][i] for r in part], dim=-1) for i in range(len(part[0][1]))]
            p_outs = getattr(KV, name + "_plain")(*args)
            p_outs = p_outs if isinstance(p_outs, tuple) else (p_outs,)
            if len(p_outs) != len(k_outs):
                raise AssertionError(f"{name}: {len(k_outs)} outputs, its plain version {len(p_outs)}")
            bad = torch.zeros(sum(psizes), dtype=torch.bool, device=dev)
            for k, p_out in zip(k_outs, p_outs):
                bad |= (k != p_out).reshape(-1, k.shape[-1]).any(dim=0)
            if bool(bad.any()):
                lane = int(bad.nonzero()[0])
                call = int(np.searchsorted(np.cumsum(psizes), lane, side="right"))
                raise AssertionError(f"{name}: main-path call {call} of {len(part)} with {arity} operands "
                                     f"(N = {psizes[call]}) differs from its plain version")
        warp_info[name]["main_path_calls_held"] = {"calls": len(recs), "lanes": sum(sizes),
                                                   "calls_by_operands": {a: sum(len(r[0]) == a for r in recs)
                                                                         for a in sorted({len(r[0]) for r in recs})}}
    log("main path calls of the redesigned warp kernels: " + ", ".join(
        f"{name} {len(recs)} calls ({sum(r[0][0].shape[-1] for r in recs)} lanes)" for name, recs in
        path_calls.items()) + f", every one made by a counted main-path run or a bisection, each equal to its "
        f"plain version bit for bit (sum_g2, prod12 and the scans one plain run per call, the others one plain run "
        f"per kernel over the calls' lanes side by side; {time.perf_counter() - t:.1f} s)")

    if not verifier._device_canary():
        raise AssertionError("device canary failed")
    for v, label in ((verifier, "main paths"), (wide, "wide wire batches")):
        _breaker_clean(v.supervisor, label)

    # -- 4. service phases --------------------------------------------------------
    t = time.perf_counter()
    service_flood(table, d, card)
    breaker_phase(table, d, card)
    log(f"service phases: {time.perf_counter() - t:.1f} s")

    # -- 5. the node --------------------------------------------------------------
    node_line, node_counts, node_held = node_phase(table, keys, d["sks"], card)
    paths["node", node_line["attestations"]] = node_counts
    log(f"node phase: {node_line['phase_s']:.1f} s")

    # -- 6. the hash forest ------------------------------------------------------
    htr_line, htr_rows = htr_phase(card, sm_mhz)
    log(f"hash forest phase: {htr_line['phase_s']:.1f} s")

    # -- 7. the slasher (32 GiB of span planes: the earlier phases' tensors released first)
    gc.collect()
    torch.cuda.empty_cache()
    slasher_line, slasher_rows = slasher_phase(card)
    log(f"slasher phase: {slasher_line['phase_s']:.1f} s")

    # -- 8. the chain (the slasher's 32 GiB of planes released first) ------------
    gc.collect()
    torch.cuda.empty_cache()
    chain_line, chain_counts = chain_phase(table, keys, d["sks"], card)
    log(f"chain phase: {chain_line['phase_s']:.1f} s")

    # -- 9. result lines -----------------------------------------------------------
    imad_per_ms = N_SM * IMAD_PER_CLK_PER_SM * sm_mhz * 1e3

    def needed_muls(name, n, units):
        """Fp products the function needs on a call at n lanes of units."""
        return KV.FP_MULS_NEEDED[name] * units + (hash_root_muls[n] if name == "hash_g2" else 0)

    def bound(name, n, tail_lane=True):
        """(bound ms, what bounds it, units of FP_MULS_NEEDED, lanes) of one
        call at n lanes (the tail's kernels on one lane of an N-set job
        unless tail_lane is False): the products the function needs (not
        the ones the kernel makes: KV.FP_MULS_NEEDED against
        FP_MULS_PER_LANE; hash_g2's square-root chains as the call's data
        needs them, and affine_g2's and hash_g2's inversions as the binary
        GCD's multiplies on the call's data) over the card's IMAD rate, or
        its bytes over the memory rate."""
        lanes = n
        if name in TAIL and tail_lane:
            units = lanes = 1
        elif name in ("sum_g2", "prod12"):
            units = n - 1  # N - 1 combines
        elif name == "agg_pk":
            units = agg_live_rows - agg_live_lanes  # one addition per live row after a lane's first
        elif name in ("seg_sum_g1", "seg_sum_g2"):
            # one addition per live lane after its group's first
            units = seg_units[(name, n) if tail_lane else (name, n, "lanes")]
        else:
            units = n
        ops_ms = needed_muls(name, n, units) * KV.IMAD_PER_FP_MUL / imad_per_ms
        if name == "affine_g2":
            ops_ms += affine_steps[n if tail_lane else (n, "lanes")] * KV.GCD_IMAD_PER_STEP / imad_per_ms
        if name == "hash_g2":
            ops_ms += hash_steps[n] * KV.GCD_IMAD_PER_STEP / imad_per_ms
        if name == "agg_pk":
            nbytes = agg_live_rows * 2 * 48 + n * (k_bucket * 8 + 3 * 48 + 4)
        else:
            nbytes = BYTES_PER_LANE[name] * lanes + BYTES_PER_LAUNCH.get(name, 0)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), units, lanes

    def ingest_bound(row, n):
        """The bound of the Montgomery ingest alone at n lanes: its products
        (one per plane) over the IMAD rate, or its planes in and out over
        the memory rate."""
        planes = INGEST_PLANES[row] * n
        return max(planes * KV.IMAD_PER_FP_MUL / imad_per_ms, planes * 2 * 48 / PEAK_BYTES_PER_S * 1e3)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path, n = MAIN_PATH[name]
        host = FUSED.get(name, name)  # an ingest row reads the launch that makes its work
        k_ms, p_ms, err = results[host, n]
        bound_ms, bound_by, units, _ = bound(host, n)
        if name in FUSED:
            entry = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": paths[path, n][host], "max_abs_err": ingest[name, n, path][0],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "path": path, "n": n, "fused_into": host,
                "fused_into_by_path": {"batch": "g2_rsig_sub", "per_set": "g2_subgroup_check"}
                if name == "mont_convert" else {"wire_batch": "g2_decompress"},
                "ingest_planes_per_lane": INGEST_PLANES[name],
                "ms_without_ingest": results[host, n, "no_ingest"][0],
                "ingest_marginal_ms": k_ms - results[host, n, "no_ingest"][0],
                "ingest_plain_ms": ingest[name, n, path][1], "ingest_bound_ms": ingest_bound(name, n),
                "ingest_held": {f"{p} N={m}": {"max_abs_err": e, "mont_convert_plain_ms": pm}
                                for (r, m, p), (e, pm) in ingest.items() if r == name},
                "fp_muls_needed": needed_muls(host, n, units), "fp_muls_done": KV.FP_MULS_PER_LANE[host] * units,
                "launches_by_path": {f"{p} N={pn}": c[host] for (p, pn), c in paths.items()},
                "node_launches": node_counts[name],
            }
            if (host, JOBS[0]) in results:
                entry["ms_n128"], entry["plain_ms_n128"] = results[host, JOBS[0]][:2]
                entry["bound_ms_n128"] = bound(host, JOBS[0])[0]
            if host in GROUPED_WRAPPERS:
                entry["ms_in_grouped_wire_batch_by_n"] = {m: kms.get(host) for (p, m), kms in path_kms.items()
                                                          if p == "wire_batch"}
            kernels.append(entry)
            continue
        if name in ("seg_sum_g1", "seg_sum_g2"):
            done = seg_made[name, n]  # one addition per lane and round where neither operand is infinity
        elif name == "agg_pk":
            done = agg_done  # every tree addition and the accumulations of live chunks
        elif name == "sum_g2":
            done = n - 1  # the tree's complete additions
        elif name == "prod12":
            done = n - 1  # the tree's products
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
            "fp_muls_needed": needed_muls(name, n, units), "fp_muls_done": KV.FP_MULS_PER_LANE[name] * done,
            "launches_by_path": {f"{p} N={pn}": c[name] for (p, pn), c in paths.items()},
            "node_launches": node_counts[name],
        }
        if name in node_held:  # the node phase's first call of the kernel, held against its plain version
            entry["node_first_call_held"] = {"max_abs_err": node_held[name][0], "lanes": node_held[name][1]}
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
            # the bound on the [r]P design's need (KV.R_CHAIN_NEEDED), the yardstick before
            for m, key in ((n, "bound_ms_r_chain_need"), (256, "bound_ms_256_r_chain_need")):
                entry[key] = max(KV.R_CHAIN_NEEDED * m * KV.IMAD_PER_FP_MUL / imad_per_ms,
                                 BYTES_PER_LANE[name] * m / PEAK_BYTES_PER_S * 1e3)
            entry["registration_split_ms"] = reg_split
            entry.update(kv_info)
        if name in ("seg_sum_g1", "seg_sum_g2"):
            entry["additions_needed"], entry["additions_made"] = seg_units[name, n], seg_made[name, n]
        if name in ("affine_g2", "hash_g2"):  # the inversions' multiplies, which fp_muls_needed leaves out
            steps = (affine_steps if name == "affine_g2" else hash_steps)[n]
            entry["gcd_steps"], entry["gcd_imad"] = steps, steps * KV.GCD_IMAD_PER_STEP
        if name == "hash_g2":
            entry["ms_512"], entry["plain_ms_512"] = results[name, 512][:2]
            entry["bound_ms_512"] = bound(name, 512)[0]
            entry["cold_cache_ms_by_roots"] = cold_split
            entry["root_chain_muls_needed"] = hash_root_muls[n]  # within fp_muls_needed
        if name in warp_info:  # the warp-per-lane kernels
            entry.update(warp_info[name])
        if (name, 1, "lanes") in results:  # every lane count of the kernel's own sweep
            timed = [m for m in WARP_LANES + SUM_LANES + AFFINE_LANES + PROD_LANES + SEG_LANES
                     if (name, m, "lanes") in results]
            timed = sorted(set(timed))
            entry["ms_by_lanes"] = {m: results[name, m, "lanes"][0] for m in timed}
            entry["plain_ms_by_lanes"] = {m: results[name, m, "lanes"][1] for m in timed}
            entry["bound_ms_by_lanes"] = {m: bound("each_final" if name == "final_one" else name, m, False)[0]
                                          for m in timed}
            if name in ("sum_g2", "prod12"):
                entry["tree_levels_by_lanes"] = {m: (m - 1).bit_length() for m in timed}
                entry["launches_per_call_by_lanes"] = {m: (sum_launches if name == "sum_g2" else prod_launches)[m]
                                                       for m in timed}
                entry["ms_per_level"] = k_ms / (n - 1).bit_length()
            elif name in ("seg_sum_g1", "seg_sum_g2"):
                entry["launches_per_call_by_lanes"] = {m: seg_launches[name, m] for m in timed}
                entry["additions_made_by_lanes"] = {m: seg_made[name, m, "lanes"] for m in timed}
                entry["ms_per_round_of_scan"] = k_ms / KV.seg_rounds(n)
            else:
                entry["ms_per_round_1_lane"] = results[name, 1, "lanes"][0] / entry["rounds_per_lane"]
        elif name in warp_info:
            entry["ms_per_round"] = k_ms / entry["rounds_per_lane"]
        if name in GROUPED_BATCH and name in GROUPED_WRAPPERS:
            entry["ms_in_grouped_wire_batch_by_n"] = {m: kms.get(name) for (p, m), kms in path_kms.items()
                                                      if p == "wire_batch"}
        kernels.append(entry)
    log("main path sets/s: " + ", ".join(
        f"{p} N={j}: {results['sets_per_s', p, j]:.1f}" for p in ("per_set", "batch", "wire_per_set", "wire_batch")
        for j in JOBS + (WIDE_JOBS if p == "wire_batch" else ()))
        + f", agg_batch N={AGG_SETS} K={AGG_K}: {results['sets_per_s', 'agg_batch', AGG_SETS]:.1f} "
        f"({results['pubkeys_per_s', 'agg_batch', AGG_SETS]:.1f} pubkeys/s); registration {TABLE_ROWS / reg_s:.1f} "
        f"keys/s ({card}); "
        f"total {time.perf_counter() - t_start:.1f} s")
    kernels.extend(htr_rows)
    kernels.extend(slasher_rows)
    for entry in kernels:  # the chain phase's launches and the calls of it held against the plain versions
        entry["chain_launches"] = chain_counts.get(entry["name"], 0)
        calls_lanes = chain_line["held"].get(entry["name"])
        if calls_lanes:
            entry["chain_calls_held"], entry["chain_lanes_held"] = calls_lanes
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
