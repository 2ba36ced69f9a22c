#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's commit-, light-header and BLS
aggregate-commit verification paths, of lane-sharded commit
verification over a device set, of the light client, of blocksync
catch-up and of consensus in one process, on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. environment: the card's name and power limit, torch.version.cuda, nvcc;
2. build: compiles the kernels from the six sources in
   ``cometbft_tpu_torch/csrc`` (one nvcc per source, all at once) and
   prints each function's registers, stack frame, spills and shared
   memory from ``-Xptxas -v`` (``ptxas_usage``);
3. kernels: each kernel against its plain PyTorch version on the card, on
   the same inputs at the main path's shapes (valid, tampered and ZIP-215
   edge lanes; RLC accept, reject, garbage padding and torsion batches),
   and against the pure-Python oracle; then one seeded random batch per
   entry of ``SWEEP_LANES`` (up to 32,000 lanes, phase 11's largest
   window; ``SWEEP_SIGNED`` distinct signed lanes, tiled above that)
   through every kernel and its plain version,
   and a ragged RLC batch (lanes of one, two and three SHA-512 blocks,
   NB = 3; also with a padding lane's active count 0, and with a lane's
   count cut short, a reject) at both ``LANE_LAYOUTS``; then the merkle
   kernels ``sha256_leaves`` (10,000 one-block and 10,000 two-block
   leaves), ``merkle_level`` (5,000 pairs), ``merkle_tree`` (every level
   of trees of ``MERKLE_TREES`` leaves, against the plain level loop and
   hashlib) and ``merkle_tree_leaves`` (the leaves and every level in
   one call, at 10,000 and 2,048 one-block, two-block and mixed leaves
   and at ``MERKLE_LEAF_TREES`` leaves) against their plain versions and
   hashlib, and the roots and proofs of a seeded sweep of trees
   (``MERKLE_SWEEP`` leaves, and leaves over 118 bytes) on the kernel
   route against hashlib; mismatches must be 0;
4. commit: the main path, ``VerifyCommit``, ``VerifyCommitLight`` and
   ``VerifyCommitLightTrusting`` on commits signed by 150 and 1,000
   validators (keys from a fixed seed), plus a tampered commit that must
   raise ``ErrInvalidSignature`` at the tampered lane.  The launch
   counters are zeroed just before and read just after: every kernel
   must have launched and no plain version may have run;
5. throughput: 10,000 lanes (the 1,000 signed lanes tiled against a
   10,000-row validator table) through the RLC and the per-lane kernels;
   the device time of each of the RLC verdict's stages (``RLC_STAGES``)
   here and at phase 3's 150 lanes, and the ladder stage's chain floor
   (``chain_floor``);
6. light, 150 validators: ``verify_sequential_batched`` over a linked
   chain of ``LIGHT_HEADERS`` headers, each fully signed (BASELINE
   configs[2], cut from 1,000 headers for signing time);
7. light, 10,000 validators: headers linked by ``ValidatorSet.hash()``
   on the kernel route; ``verify_adjacent``, ``verify_non_adjacent``,
   ``verify_sequential_batched``, ``VerifyCommit`` and the set's hash,
   a forged validator set (``ErrInvalidHeader``) and a tampered
   signature (``ErrBatchItemInvalid`` with its item and height); then
   the host parts of one ``VerifyCommit`` timed apart
   (``verify_commit_parts``: the columns, the sign-bytes rows by the
   native encoder and by the per-lane loop it replaced, ``host_pad``,
   the dispatch, the rest), the encoder's rows held byte for byte
   against ``Commit.vote_sign_bytes`` over every lane;
8. BLS, 10,000 validators, all BLS, every 50th absent: two linked
   headers whose commits carry one aggregate signature each (one
   signature under the signers' summed secret); ``VerifyCommitLight``
   (cold, with the per-set table build, then 20 calls), ``VerifyCommit``
   and ``verify_adjacent``, a wrong aggregate (``ErrInvalidSignature`` on
   the first aggregate lane) and a stray bitmap bit
   (``ErrInvalidCommit``); the host pairings timed alone; then the G1
   fold ``aggregate_g1_masked`` against its plain version on the card
   (``BLS_ROWS`` rows with empty, single, random, cancelling and doubled
   masks, ``BLS_RAGGED`` rows with random, full and last-row masks, and
   the main path's table, also against the host library's sum; timed at
   ``BLS_ROWS_TIMED`` rows too).  The host BLS library builds with
   ``g++`` first;
9. mesh, ``MESH_SHARDS`` shards of one card (the device set
   ``[cuda:0] * 4``; then again over distinct cards, one shard each,
   where more than one is visible), reusing phase 7's 10,000-validator commit and phase 6's
   chain: ``VerifyCommit`` (one sharded RLC dispatch: one shard-sums
   call per distinct card, one combine, no single-device verdict),
   p50/min/max over 20
   calls beside the single-device p50, ``verify_commits_light_batched``
   over the 127 headers of phase 6, and a tampered commit whose sharded
   per-lane route names the same lane as the single-device route; then
   the sharded RLC verdict (K7: ``ed25519_rlc_sums`` and
   ``ed25519_rlc_combine``) against its plain version and against K6a's
   single-device verdict on the same inputs and z, over valid lanes, a
   bad lane in each shard, garbage padding, a ragged last shard, fewer
   lanes than shards, and ZIP-215 edge lanes (window sums as points),
   and on one card over ``K7_SPLITS`` (1 to 4 shards of 10,000 lanes,
   150 lanes over 4); the one-shard ``rlc_sums_gather`` against the
   plain version's first shard; the sums timed as the verdict runs them
   (no index check): one 2,500-lane shard alone, and four shards of one
   card in one call;
10. light client (``phase_light_client``; it runs after phase 8, while
   the key pool is open): ``light.Client`` over providers of prebuilt
   blocks, (a) sequential over phase 6's chain, (b) skipping over
   ``SKIP_HEIGHTS`` heights of 150 validators, one replaced every
   ``SKIP_ROTATE_EVERY`` (the client bisects; commits signed when first
   served), (c) skipping over phase 7's 10,000-validator headers, (d)
   the divergence detector against a witness forked above ``FORK_AT``
   (``DivergenceError`` naming it, evidence to both sides) and a
   lagging witness dropped after ``MAX_WITNESS_LAG_STRIKES`` calls; each
   case's p50, min and max with a new client and store a call, fetches,
   and one traced call of (a) and (c);
11. blocksync (``phase_blocksync``, run after phase 10 while the key
   pool is open): a source node of ``BS_VALS`` validators (BASELINE
   configs[3]'s width) makes ``BS_HEIGHTS`` heights with the port's
   ``BlockExecutor``, each commit signed in the pool; a new node catches
   up from its serving ``BlocksyncReactor`` over a loopback switch
   (``LoopSwitch``: peers, broadcast and report_peer; the messages, the
   codec and the part sets are the port's), windows of up to 32 commits
   in one device call each: (a) clean, its stores byte for byte and its
   state the source's, ``BS_RUNS`` timed runs, the last with the host
   stages timed (``stage_timers``), then one traced; (b) a lying peer whose block
   ``BS_BAD_AT`` carries a forged vouch: reported ``bad_block``, the two
   heights fetched again from the honest server, the store the source's,
   K5b launched; (c) the same commits verified in windows against one
   ``VerifyCommitLight`` a commit, p50 of 5 calls each;
12. consensus (``phase_consensus``): in-process networks of the port's
   consensus (``testing.make_inproc_network(device=cuda:0)``), every
   signature check through the verification scheduler on the card: (a)
   ``CS_SMALL`` validators, a tx injected a node, to height
   ``CS_SMALL_HEIGHT`` (one block hash a height everywhere, every tx
   committed and in every kvstore); (b) ``CS_VALS`` validators at power
   10 to height ``CS_HEIGHT`` (block 3's last commit has every lane),
   with each height's first and last commit, rounds, the scheduler's
   flushes, cache hits and misses and one-lane device checks, the
   messages delivered, and the device busy share of heights 2 onwards
   (``profile_call``); (c) WAL crash recovery at ``CS_SMALL``.  The
   pure-Python oracle's calls are counted over the run (must be 0), and
   every stored commit of (a) and (b) is re-checked by it afterwards;
   one one-lane device check is timed alone.

Phases 4, 6, 7, 8, 9, 10, 11 and 12 are the main path: the launch counters
are zeroed just before each and read just after; each phase's kernels
must have launched, no plain version may have run, and neither
standalone hash kernel (``OFF_PATH``: the RLC lane stage hashes its
lanes, the tree call its leaves) may have launched (phase 8 also no
Ed25519 kernel).
Keys and signatures of the light and BLS phases are made in a process
pool over ``os.cpu_count()`` workers with the port's own
signers; the script prints the seconds of each fixture and phase.  The
fold's bound counts the integer instructions of the fold's first CUDA
version (``G1_INT_PER_ADD``, ``G1_INT_PER_MUL``), so that it measures
the same work whatever the kernel.  Phase 5 also holds the table kernel
``ed25519_tables`` against its plain version at ``TABLE_SIZES``
validators and times it at 10,000 and 150 at both ``LANE_LAYOUTS``.

``python3 chip_smoke.py --mesh-cards`` on a host with two or more cards
runs only phases 1, 2 and 9, over the first ``MESH_SHARDS`` cards, one
shard each: the cross-card copy of the partial sums and the overlap of
the cards, which one card cannot show.  ``python3 chip_smoke.py
--blocksync`` runs only phases 1 and 2, phase 3's sweep and phase 11;
``python3 chip_smoke.py --consensus`` the same with phase 12 (both
options together run both phases).

The line before the last is a JSON object with one entry per kernel
(launches on the main path, max_abs_err, times, bound); the last line is
the device line.  Without a CUDA device the script exits 2 and prints no
result; it never falls back to the CPU.  It imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 memory rate
INT_LANES_PER_SM = 64            # 32-bit integer lanes per SM per clock
SHA512_OPS_PER_BLOCK = 5520      # 32-bit integer ops per compression
SC_REDUCE_PRODUCTS = 78          # 13 folds x 6 digit products
MUL_MOD_L_PRODUCTS = 91          # 7 x 13 limb products
FE_MUL_PRODUCTS = 100            # 32 x 32 -> 64-bit products per field mul
# 32-bit integer instructions per SHA-256 compression on sm_90, where a
# 3-input logic function is one LOP3, a 3-operand add one IADD3 (K a
# constant-bank operand) and a rotate one funnel shift: 64 rounds of 14
# (Sigma1 4, Ch 1, Sigma0 4, Maj 1, 4 adds) and 48 schedule steps of 10
# (sigma0 4, sigma1 4, 2 adds), plus 8 feed-forward adds; checked
# against the built kernel's SASS by scripts/sha256_sass_count.py
SHA256_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8
# 32-bit integer ALU instructions of one RCB15 addition and of one
# Montgomery product of the G1 fold's first CUDA version (a thread an
# addition, a launch a level; its SASS, counted by the script
# scripts/blsg1_sass_count.py that went with it: one addition 15,470,
# its 14 calls of a 966-instruction fp_mul included): the work the
# fold's bound counts, frozen so that the bound does not move with the
# kernel's code
G1_INT_PER_ADD = 15_470
G1_INT_PER_MUL = 966

CHAIN_ID = "smoke-chain"
SIZES = (150, 1000)              # validators of the commit phase
LANES = 10_000                   # lanes of the throughput phase
REPS = 20                        # timed calls per measurement
# lanes of the sweep's batches; 32,000 is phase 11's window (32 commits
# of 1,000 validators), the largest batch the port runs
SWEEP_LANES = (1, 77, 128, 129, 300, 640, 32_000)
SWEEP_SIGNED = 640               # distinct signed lanes, tiled above this
COMMIT_KERNELS = ("ed25519_tables", "ed25519_verify_gather",
                  "ed25519_rlc_gather")
# the hash kernels that stand alone behind their public wrappers, checked
# and timed in phase 3, which the main path never launches (the RLC lane
# stage hashes its lanes, the merkle tree call its leaves)
OFF_PATH = ("sha512_scalar", "sha256_leaves")
BLS_KERNELS = ("aggregate_g1_masked",)
MESH_KERNELS = ("ed25519_rlc_sums", "ed25519_rlc_combine")
# K6a's launches, in order: (stage, kernel); the lane stage hashes too
RLC_STAGES = (("lane", "rlc_lane_kernel"),
              ("partials", "rlc_window_partials_kernel"),
              ("fold", "rlc_fold_kernel"), ("zs", "rlc_zs_sum_kernel"),
              ("comb", "rlc_comb_kernel"), ("ladder", "rlc_ladder_kernel"))
# the ladder stage's quad point operations: 255 doublings, 64 window
# additions and the comb's, and the R-window prologue (about one)
LADDER_OPS = 255 + 65 + 1
# lanes a block of the lane stage, as ops/rlc.py:lane_block picks them
LANE_LAYOUTS = (16, 32)
# the __global__ functions behind each C entry, for the -Xptxas -v lines
# (a template's instances by their arguments)
_LANE_KERNELS = tuple(f"rlc_lane_kernel<{n}>" for n in LANE_LAYOUTS)
ENTRY_KERNELS = {
    "sha512_scalar": ("sha512_scalar_kernel",),
    "ed25519_tables": tuple(f"ed25519_tables_kernel<{n}>"
                            for n in LANE_LAYOUTS),
    "ed25519_verify_gather": ("ed25519_verify_gather_kernel",),
    "ed25519_rlc_gather": _LANE_KERNELS + tuple(k for _, k in RLC_STAGES[1:]),
    "ed25519_rlc_sums": _LANE_KERNELS + tuple(k for _, k in RLC_STAGES[1:4]),
    "ed25519_rlc_combine": ("rlc_combine_ladder_kernel",),
    "sha256_leaves": ("sha256_leaves_kernel",),
    "merkle_level": ("merkle_subtree_kernel",),
    "merkle_tree": ("merkle_subtree_kernel",),
    "merkle_tree_leaves": ("merkle_leaves_kernel", "merkle_subtree_kernel"),
    "aggregate_g1_masked": ("g1_fold_kernel", "fp_mul"),
}
MESH_SHARDS = 4                  # shards of the mesh phase, one card each
# (lanes, shards) of K7's shard-count checks on one card
K7_SPLITS = ((10_000, 1), (10_000, 2), (10_000, 3), (150, 4))
MERKLE_LEAVES = 10_000           # leaves of the merkle kernel phase
MERKLE_SWEEP = (1, 63, 64, 2047, 2048, 2049, 4097, 10_000)  # tree sizes
MERKLE_TREES = (2048, 2049, 4097, 10_000, 16_384)  # whole-tree checks
# trees of the fused call's checks, beside 10,000 and 2,048 leaves: one
# leaf, a subtree run of 256 and one either side, one past two launches
MERKLE_LEAF_TREES = (1, 255, 256, 257, 65_537)
# message lengths of the ragged RLC batch: one, two and three SHA-512
# blocks after R || A
RAGGED_SPANS = ((0, 48), (48, 176), (176, 304))
LIGHT_VALS = 150                 # validators of the 150-validator light phase
LIGHT_HEADERS = 128              # its chain (BASELINE configs[2]: 1,000)
BIG_VALS = 10_000                # validators of the 10k light phase
SKIP_HEIGHTS = 1_000             # heights of phase 10 (b) (BASELINE configs[2])
SKIP_ROTATE_EVERY = 5            # (b): a validator replaced every 5 heights
FORK_AT = 100                    # (d): the witness's fork above this height
FORK_SKEW_NS = 777               # (d): the fork's timestamps, skewed by this
TRUSTING_PERIOD_NS = 14 * 24 * 3600 * 10**9
LIGHT_T0 = 1_700_000_000_000_000_000
BLS_VALS = 10_000                # validators of the BLS phase, all BLS
BLS_ABSENT_EVERY = 50            # every 50th lane absent: 9,800 signers
BLS_ROWS = (1, 3, 64, 1000)      # table rows of the G1 fold's checks
BLS_RAGGED = (200, 16_385)       # and an absentee fold's size, 2^14 + 1
BLS_ROWS_TIMED = 200             # the fold also timed at this size
BS_VALS = 1_000                  # validators of phase 11 (BASELINE configs[3])
# its source chain (configs[3]: 50,000 blocks, cut to what the phase's
# time allows): three windows of 32 and the tail, signed by the native
# signer (crypto/keys.py) in the pool
BS_HEIGHTS = 97
BS_BAD_AT = 40                   # (b): this block's last commit is forged
BS_RUNS = 3                      # (a): timed catch-ups
BS_T0 = 1_700_000_000_000_000_000
# validators of the table kernel's checks: ragged, and both sides of the
# lane stage's 16/32 crossover (ops/rlc.py:QUAD_LANES_BELOW)
TABLE_SIZES = (1, 17, 33, 7999, 8000, 10_000)


def _run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def _sync():
    import torch

    torch.cuda.synchronize()


def time_cuda(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def time_host(fn) -> float:
    """Wall ms of one synchronized call."""
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    return (time.perf_counter() - t0) * 1e3


def time_enqueue(fn, reps: int) -> float:
    """Median host ms of ``reps`` calls of ``fn`` from an idle card until
    it returns, its device work still queued (a call that reads a result
    on the host waits for it)."""
    walls = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    _sync()
    return statistics.median(walls)


def time_host_spread(fn, reps: int) -> dict:
    """Wall ms of ``reps`` synchronized calls of ``fn``: p50, min, max and
    every call, with the CPU ms of the calling thread and the ms the
    garbage collector ran inside each call."""
    import gc

    pauses, start = [], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append((time.perf_counter() - start[0]) * 1e3)

    walls, cpus, gcs = [], [], []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(reps):
            pauses.clear()
            c0 = time.thread_time()
            walls.append(time_host(fn))
            cpus.append((time.thread_time() - c0) * 1e3)
            gcs.append(sum(pauses))
    finally:
        gc.callbacks.remove(on_gc)
    return {"p50_ms": statistics.median(walls), "min_ms": min(walls),
            "max_ms": max(walls), "all_ms": walls, "cpu_ms": cpus,
            "gc_ms": gcs}


def _spread(t: dict) -> str:
    cpu = sorted(t["cpu_ms"])
    return (f"p50 {t['p50_ms']:.2f} ms (min {t['min_ms']:.2f}, max "
            f"{t['max_ms']:.2f}, {len(t['all_ms'])} calls; thread CPU "
            f"{cpu[0]:.2f}-{cpu[-1]:.2f} ms; gc in a call up to "
            f"{max(t['gc_ms']):.2f} ms)")


# ----------------------------------------------------------------- fixtures

class Fixtures:
    """Keys, validator sets and commits made with the port's own signer
    from a fixed seed; every signature is made once."""

    def __init__(self, n_keys: int):
        from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

        t0 = time.perf_counter()
        self.privs = [Ed25519PrivKey.from_secret(b"chip-smoke-%d" % i)
                      for i in range(n_keys)]
        self.key_seconds = time.perf_counter() - t0
        self._sigs: dict = {}
        self.ts0 = 1_700_000_000_000_000_000

    def commit(self, n_vals: int, height: int = 7):
        from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
        from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                     Commit, CommitSig)
        from cometbft_tpu_torch.types.validator_set import (Validator,
                                                            ValidatorSet)

        privs = self.privs[:n_vals]
        by_addr = {p.pub_key().address(): (i, p) for i, p in enumerate(privs)}
        vals = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
        bid = BlockID(hashlib.sha256(b"block%d" % height).digest(),
                      PartSetHeader(1, hashlib.sha256(b"parts").digest()))
        sigs = []
        for v in vals.validators:
            i, _ = by_addr[v.address]
            sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                                  self.ts0 + i, b""))
        commit = Commit(height, 0, bid, sigs)
        for lane, v in enumerate(vals.validators):
            i, p = by_addr[v.address]
            msg = commit.vote_sign_bytes(CHAIN_ID, lane)
            key = (i, msg)
            if key not in self._sigs:
                self._sigs[key] = p.sign(msg)
            commit.signatures[lane].signature = self._sigs[key]
        return vals, commit


def lane_arrays(vals, commit):
    """(pubs, sigs, msgs, lens) numpy rows of every lane of a commit."""
    import numpy as np

    pubs, _ = vals.dense()
    n = commit.size()
    msgs, lens = _loop_rows(commit, range(n))
    sigs = np.frombuffer(b"".join(cs.signature for cs in commit.signatures),
                         np.uint8).reshape(n, 64)
    return np.array(pubs), sigs.copy(), msgs, lens


# ------------------------------------------------- light fixtures (a pool)

def _derive_keys(secrets):
    """Pool worker: 64-byte private keys (seed || pubkey) from secrets."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    return [Ed25519PrivKey.from_secret(s).bytes() for s in secrets]


def _sign_all(task):
    """Pool worker: one validator's signatures over its messages."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    raw, msgs = task
    priv = Ed25519PrivKey(raw)
    return [priv.sign(m) for m in msgs]


def _bls_keys(secrets):
    """Pool worker: (secret scalar, compressed public key) per secret, as
    ``Bls12381PrivKey.from_secret`` derives them."""
    from cometbft_tpu_torch.crypto import bls12381 as B

    out = []
    for s in secrets:
        sk = B.keygen(s.ljust(48, b"\x9b"))
        out.append((sk, B.sk_to_pk(sk)))
    return out


def pool_keys(pool, n: int) -> list:
    """n private keys from the fixed secrets b"chip-smoke-<i>"."""
    secrets = [b"chip-smoke-%d" % i for i in range(n)]
    chunks = [secrets[i:i + 250] for i in range(0, n, 250)]
    return [k for part in pool.map(_derive_keys, chunks) for k in part]


def light_chain(pool, keys, n_headers: int, dev):
    """A linked chain of headers at heights 1..n_headers under one
    validator set (the keys at power 10), each commit signed by every
    validator, with its own timestamp per lane.  The validators hash
    is ``ValidatorSet.hash`` on ``dev`` (the kernel route from 2,048
    validators).  Returns (validator set, light blocks)."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.light import LightBlock
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.header import Header
    from cometbft_tpu_torch.types.validator_set import (Validator,
                                                        ValidatorSet)

    pubs = [Ed25519PrivKey(k).pub_key() for k in keys]
    key_of = {pk.address(): k for pk, k in zip(pubs, keys)}
    vals = ValidatorSet([Validator(pk, 10) for pk in pubs])
    vh = vals.hash(dev)
    blocks, prev = [], BlockID()
    for h in range(1, n_headers + 1):
        header = Header(chain_id=CHAIN_ID, height=h,
                        time_ns=LIGHT_T0 + h * 10**9, last_block_id=prev,
                        validators_hash=vh, next_validators_hash=vh,
                        proposer_address=vals.validators[0].address)
        bid = BlockID(header.hash(), PartSetHeader(1, b"\x5a" * 32))
        commit = Commit(h, 0, bid, [
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                      header.time_ns + 1 + lane % 997, b"")
            for lane, v in enumerate(vals.validators)])
        blocks.append(LightBlock(header, commit, vals))
        prev = bid
    tasks = [(key_of[v.address],
              [lb.commit.vote_sign_bytes(CHAIN_ID, lane) for lb in blocks])
             for lane, v in enumerate(vals.validators)]
    sigs = pool.map(_sign_all, tasks,
                    chunksize=max(1, len(tasks) // (8 * os.cpu_count())))
    for lane, row in enumerate(sigs):
        for lb, sig in zip(blocks, row):
            lb.commit.signatures[lane].signature = sig
    return vals, blocks


# --------------------------------------------------------------- edge lanes

def _torsion8(ref, rng):
    while True:
        pt = ref.pt_decompress_zip215(rng.bytes(32))
        if pt is None:
            continue
        t = ref.pt_mul(ref.L, pt)
        if not ref.pt_equal(t, ref.IDENTITY) and \
           not ref.pt_equal(ref.pt_mul(4, t), ref.IDENTITY):
            return t


def edge_cases(rng):
    """ZIP-215 edge lanes as (pub, msg, sig): a mixed-order key, the
    non-canonical identity key with R = [r]B and S = r, the same key
    with a small-order R and S = 0, a non-square key, an x = 0 key with
    the sign bit set, and an S >= L signature."""
    from cometbft_tpu_torch.crypto import _ed25519_py as ref

    L, P = ref.L, ref.P
    out = []
    t8 = _torsion8(ref, rng)
    seed = rng.bytes(32)
    h0 = hashlib.sha512(seed).digest()
    a_sc = ref._clamp(h0[:32])
    mixed = ref.pt_compress(ref.pt_add(ref.pt_mul(a_sc, ref.BASE), t8))
    m = rng.bytes(50)
    r_sc = ref.sc_reduce64(hashlib.sha512(h0[32:] + m).digest())
    r_enc = ref.pt_compress(ref.pt_mul(r_sc, ref.BASE))
    k_sc = ref.sc_reduce64(hashlib.sha512(r_enc + mixed + m).digest())
    out.append((mixed, m, r_enc + ((r_sc + k_sc * a_sc) % L).to_bytes(
        32, "little")))
    ident_nc = (1 + P).to_bytes(32, "little")
    r2 = int.from_bytes(rng.bytes(32), "little") % L
    out.append((ident_nc, b"whatever",
                ref.pt_compress(ref.pt_mul(r2, ref.BASE))
                + r2.to_bytes(32, "little")))
    out.append((ident_nc, b"x", ref.pt_compress(t8) + bytes(32)))
    while True:
        cand = bytearray(rng.bytes(32))
        cand[31] &= 127
        if ref.pt_decompress_zip215(bytes(cand)) is None:
            break
    out.append((bytes(cand), b"m", out[0][2]))
    out.append(((1 | (1 << 255)).to_bytes(32, "little"), b"y",
                ref.pt_compress(t8) + bytes(32)))
    sd = rng.bytes(32)
    pk = ref.public_key_from_seed(sd)
    good = ref.sign(sd, b"s")
    s_int = int.from_bytes(good[32:], "little")
    out.append((pk, b"s", good[:32] + (s_int + L).to_bytes(32, "little")))
    return out


# ------------------------------------------------------------------- phases

def phase_kernels(fx, dev, reps, rec):
    """Every kernel against its plain version (and the oracle) at the
    main path's shapes.  Fills ``rec[name]`` with max_abs_err, mismatches,
    ms and plain_ms; raises on any mismatch."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.crypto.batch import _padded_lane_args
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc, sha512

    rng = np.random.default_rng(2026)
    vals, commit = fx.commit(150)
    pubs, sigs, msgs, lens = lane_arrays(vals, commit)
    edges = edge_cases(rng)
    n_edge = len(edges)

    # validator table: the 150-validator set with its last rows replaced
    # by the edge keys
    tab_pubs = pubs.copy()
    for j, (pk, _, _) in enumerate(edges):
        tab_pubs[150 - n_edge + j] = np.frombuffer(pk, np.uint8)
    pub_t = torch.from_numpy(tab_pubs).to(dev)

    def tables_plain():
        return ed._prepare_plain(pub_t)

    tab_k, ok_k = ed.prepare_pubkey_tables(pub_t)
    tab_p, ok_p = tables_plain()
    err = int((ed.tables_canonical(tab_k).long()
               - ed.tables_canonical(tab_p).long()).abs().max())
    mism = int((ok_k != ok_p).sum())
    want_ok = [ref.pt_decompress_zip215(bytes(r)) is not None
               for r in tab_pubs]
    mism += sum(int(a) != b for a, b in zip(ok_k.tolist(), want_ok))
    rec["ed25519_tables"].update(
        max_abs_err=err, mismatches=mism,
        ms=time_cuda(lambda: ed.prepare_pubkey_tables(pub_t), reps),
        plain_ms=time_host(tables_plain), shape=f"N={tab_pubs.shape[0]}")

    # per-lane lanes: the Light shape at 150 validators (101 lanes), with
    # tampered and edge lanes at the front
    n_lanes = 101
    lane_pub, lane_sig, lane_msg, lane_idx = [], [], [], []
    for i in range(n_lanes):
        lane_pub.append(pubs[i].tobytes())
        lane_sig.append(sigs[i].tobytes())
        lane_msg.append(msgs[i, :lens[i]].tobytes())
        lane_idx.append(i)
    for j, (pk, m, s) in enumerate(edges):        # edge lanes
        k = 10 + j
        lane_pub[k], lane_msg[k], lane_sig[k] = pk, m, s
        lane_idx[k] = 150 - n_edge + j
    s = bytearray(lane_sig[1]); s[40] ^= 1; lane_sig[1] = bytes(s)
    s = bytearray(lane_sig[2]); s[3] ^= 4; lane_sig[2] = bytes(s)
    lane_msg[3] = lane_msg[3] + b"!"
    lane_idx[4] = 5                                 # wrong key row
    lane_pub[4] = tab_pubs[5].tobytes()
    want = [ref.verify_zip215(lane_pub[i], lane_msg[i], lane_sig[i])
            for i in range(n_lanes)]
    args = _lanes_to_tensors(lane_pub, lane_sig, lane_msg, dev)
    idx_t = torch.tensor(lane_idx, dtype=torch.int32, device=dev)

    def verify_plain():
        return ed._verify_gather_plain(tab_k, ok_k, idx_t, *args)

    got_k = ed.verify_padded_gather(tab_k, ok_k, idx_t, *args)
    got_p = verify_plain()
    mism = int((got_k != got_p).sum()) + sum(
        int(a) != b for a, b in zip(got_k.tolist(), want))
    rec["ed25519_verify_gather"].update(
        max_abs_err=int((got_k.long() - got_p.long()).abs().max()),
        mismatches=mism,
        ms=time_cuda(lambda: ed.verify_padded_gather(tab_k, ok_k, idx_t,
                                                     *args), reps),
        plain_ms=time_host(verify_plain), shape=f"B={n_lanes}",
        expected_rejects=sum(not w for w in want),
        device_ms=_kernel_ms(profile_call(
            lambda: ed.verify_padded_gather(tab_k, ok_k, idx_t, *args),
            reps)["kernels_ms"], "ed25519_verify_gather"))

    # sha512_scalar at the VerifyCommit shape (150 lanes)
    rb, sb, blocks, active = _padded_lane_args(
        pubs, sigs[:, :32], sigs[:, 32:], msgs, lens, dev)
    h_k = sha512.sha512_scalar(blocks, active)
    h_p = sha512._sha512_scalar_plain(blocks, active)
    h_want = [int.from_bytes(hashlib.sha512(
        sigs[i, :32].tobytes() + pubs[i].tobytes()
        + msgs[i, :lens[i]].tobytes()).digest(), "little") % ref.L
        for i in range(150)]
    mism = int((h_k != h_p).any(1).sum()) + sum(
        int.from_bytes(bytes(h_k[i].tolist()), "little") != h_want[i]
        for i in range(150))
    rec["sha512_scalar"].update(
        max_abs_err=int((h_k.long() - h_p.long()).abs().max()),
        mismatches=mism,
        ms=time_cuda(lambda: sha512._sha512_scalar(blocks, active), reps),
        ms_checked=time_cuda(lambda: sha512.sha512_scalar(blocks, active),
                             reps),
        plain_ms=time_host(
            lambda: sha512._sha512_scalar_plain(blocks, active)),
        shape=f"B=150 NB={blocks.shape[1]}")

    # RLC at the VerifyCommit shape: accept, reject, garbage padding
    # lanes with z = 0, and a batch whose lanes are ZIP-215 torsion cases
    idx150 = torch.arange(150, dtype=torch.int32, device=dev)
    tab_v, ok_v = ed.prepare_pubkey_tables(torch.from_numpy(pubs).to(dev))
    z = torch.from_numpy(rlc.host_rlc_coeffs(150, rng_bytes=rng.bytes(
        16 * 150))).to(dev)
    cases = [("valid", (tab_v, ok_v, idx150, rb, sb, blocks, active, z),
              True)]
    sb_bad = sb.clone(); sb_bad[77, 0] ^= 1
    cases.append(("tampered", (tab_v, ok_v, idx150, rb, sb_bad, blocks,
                               active, z), False))
    rb_pad = rb.clone(); rb_pad[140:] = 0xFF
    sb_pad = sb.clone(); sb_pad[141:] = 0xFF
    z_pad = z.clone(); z_pad[140:] = 0
    cases.append(("garbage padding", (tab_v, ok_v, idx150, rb_pad, sb_pad,
                                      blocks, active, z_pad), True))
    rb_act = rb.clone(); rb_act[5] = 0xFF
    cases.append(("garbage active lane", (tab_v, ok_v, idx150, rb_act, sb,
                                          blocks, active, z), False))
    tor = [e for e in edges if ref.verify_zip215(*e)]
    t_pub = [p for p, _, _ in tor] + [pubs[i].tobytes()
                                       for i in range(150 - len(tor))]
    t_sig = [s for _, _, s in tor] + [sigs[i].tobytes()
                                       for i in range(150 - len(tor))]
    t_msg = [m for _, m, _ in tor] + [msgs[i, :lens[i]].tobytes()
                                       for i in range(150 - len(tor))]
    t_tab, t_ok = ed.prepare_pubkey_tables(torch.from_numpy(np.stack(
        [np.frombuffer(p, np.uint8) for p in t_pub])).to(dev))
    cases.append(("torsion edges", (t_tab, t_ok, idx150,
                                    *_lanes_to_tensors(t_pub, t_sig, t_msg,
                                                       dev), z), True))
    mism, verdicts = 0, {}
    for name, a, expect in cases:
        k = bool(rlc.verify_batch_rlc_gather(*a))
        p = bool(rlc._rlc_plain(*a))
        verdicts[name] = (k, p, expect)
        mism += (k != p) + (k != expect)
    rec["ed25519_rlc_gather"].update(
        max_abs_err=int(any(k != p for k, p, _ in verdicts.values())),
        mismatches=mism,
        ms=time_cuda(lambda: rlc.verify_batch_rlc_gather(*cases[0][1]),
                     reps),
        plain_ms=time_host(lambda: rlc._rlc_plain(*cases[0][1])),
        shape="B=150", verdicts=verdicts)
    stages = rlc_stage_ms(lambda: rlc.verify_batch_rlc_gather(*cases[0][1]),
                          reps)
    rec["ed25519_rlc_gather"].update(stages_ms=stages,
                                     device_ms=stages["sum"])
    return {"blocks_nb": int(blocks.shape[1])}


def phase_sweep(fx, dev, rec):
    """One seeded random batch per entry of SWEEP_LANES (one lane to 250
    blocks of 128; at most SWEEP_SIGNED distinct signed lanes, tiled
    above that), each kernel against its plain version on the card:
    random keys, messages and tampered lanes (the tampered verdicts from
    the oracle), random encodings in the table, and RLC batches with
    every lane active and with the bad lanes and a few more as garbage
    padding, the lane stage at each of ``LANE_LAYOUTS`` lanes a block;
    then the ragged RLC batch (:func:`ragged_rlc`).  Adds to
    ``rec[name]["mismatches"]``."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc, sha512

    mism = dict.fromkeys(COMMIT_KERNELS + ("sha512_scalar",), 0)
    for seed, n in enumerate(SWEEP_LANES):
        rng = np.random.default_rng(1000 + seed)
        keys = rng.choice(len(fx.privs), size=min(n, 64), replace=False)
        m_lanes = min(n, SWEEP_SIGNED)   # signed lanes, tiled up to n
        pick = keys[rng.integers(0, len(keys), size=m_lanes)]
        pubs, msgs, sigs = [], [], []
        for k in pick:
            m = rng.bytes(int(rng.integers(0, 200)))
            pubs.append(fx.privs[k].pub_key().bytes())
            msgs.append(m)
            sigs.append(fx.privs[k].sign(m))
        bad = rng.random(m_lanes) < 0.1
        for i in np.flatnonzero(bad):
            if rng.random() < 0.5:
                s = bytearray(sigs[i])
                s[rng.integers(0, 64)] ^= 1 << int(rng.integers(0, 8))
                sigs[i] = bytes(s)
            else:
                msgs[i] += b"\x00"
        want = [not bad[i] or ref.verify_zip215(pubs[i], msgs[i], sigs[i])
                for i in range(m_lanes)]
        tile = np.arange(n) % m_lanes
        pick, bad = pick[tile], bad[tile]
        pubs, msgs, sigs, want = ([x[i] for i in tile]
                                  for x in (pubs, msgs, sigs, want))

        rows = [fx.privs[k].pub_key().bytes() for k in keys]
        row_of = {r: j for j, r in enumerate(rows)}
        rows += [rng.bytes(32) for _ in range(16)]
        pub_t = torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8)
                                 .reshape(-1, 32).copy()).to(dev)
        tab_k, ok_k = ed.prepare_pubkey_tables(pub_t)
        tab_p, ok_p = ed._prepare_plain(pub_t)
        mism["ed25519_tables"] += int((ok_k != ok_p).sum()) + int(
            (ed.tables_canonical(tab_k) != ed.tables_canonical(tab_p))
            .flatten(1).any(1).sum())

        idx = torch.tensor([row_of[pk] for pk in pubs], dtype=torch.int32,
                           device=dev)
        rb, sb, blocks, active = _lanes_to_tensors(pubs, sigs, msgs, dev)
        h_k = sha512.sha512_scalar(blocks, active)
        h_p = sha512._sha512_scalar_plain(blocks, active)
        mism["sha512_scalar"] += int((h_k != h_p).any(1).sum())

        lane = (tab_k, ok_k, idx, rb, sb, blocks, active)
        v_k = ed.verify_padded_gather(*lane)
        v_p = ed._verify_gather_plain(*lane)
        mism["ed25519_verify_gather"] += int((v_k != v_p).sum()) + sum(
            a != b for a, b in zip(v_k.tolist(), want))

        z = rlc.host_rlc_coeffs(n, rng_bytes=rng.bytes(16 * n))
        pad = bad | (rng.random(n) < 0.05)
        z_pad = rlc.host_rlc_coeffs(n, ~pad, rng_bytes=rng.bytes(16 * n))
        pad_t = torch.from_numpy(pad).to(dev)
        rb_pad, sb_pad = rb.clone(), sb.clone()
        garbage = torch.from_numpy(np.frombuffer(
            rng.bytes(64 * int(pad.sum())), np.uint8).reshape(-1, 2, 32)
            .copy()).to(dev)
        rb_pad[pad_t], sb_pad[pad_t] = garbage[:, 0], garbage[:, 1]
        for args, expect in (
                ((*lane, torch.from_numpy(z).to(dev)), all(want)),
                ((tab_k, ok_k, idx, rb_pad, sb_pad, blocks, active,
                  torch.from_numpy(z_pad).to(dev)), True)):
            p = bool(rlc._rlc_plain(*args))
            for lpb in LANE_LAYOUTS:
                with lane_layout(lpb):
                    k = bool(rlc.verify_batch_rlc_gather(*args))
                mism["ed25519_rlc_gather"] += (k != p) + (k != expect)
    ragged = ragged_rlc(fx, dev)
    rec["ed25519_rlc_gather"]["ragged_mismatches"] = ragged
    mism["ed25519_rlc_gather"] += sum(ragged.values())
    for k, m in mism.items():
        rec[k]["mismatches"] += m
        rec[k]["sweep_mismatches"] = m
    return mism


def ragged_rlc(fx, dev) -> dict:
    """The RLC verdict over a batch whose lanes hash one, two and three
    SHA-512 blocks (``RAGGED_SPANS``, NB = 3) in one call, at each of
    ``LANE_LAYOUTS`` lanes a block, against the plain version: all lanes
    active (accept), a padding lane (z = 0) with active count 0 (accept),
    and a three-block lane's count cut to two (reject: h is then the
    digest of its first two blocks).  Mismatches by case."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc

    rng = np.random.default_rng(1100)
    n = 96
    keys = [fx.privs[i % 32] for i in range(n)]
    msgs = [rng.bytes(int(rng.integers(*RAGGED_SPANS[i % 3])))
            for i in range(n)]
    pubs = [k.pub_key().bytes() for k in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    rb, sb, blocks, active = _lanes_to_tensors(pubs, sigs, msgs, dev)
    if blocks.shape[1] != 3 or sorted(set(active.tolist())) != [1, 2, 3]:
        raise AssertionError("ragged batch: not one, two and three blocks")
    pub_t = torch.from_numpy(np.frombuffer(b"".join(pubs[:32]), np.uint8)
                             .reshape(32, 32).copy()).to(dev)
    tab, ok = ed.prepare_pubkey_tables(pub_t)
    idx = torch.arange(n, dtype=torch.int32, device=dev) % 32
    z = torch.from_numpy(rlc.host_rlc_coeffs(n, rng_bytes=rng.bytes(
        16 * n))).to(dev)
    pad = np.arange(n) != 40
    z_pad = torch.from_numpy(rlc.host_rlc_coeffs(n, pad, rng_bytes=rng.bytes(
        16 * n))).to(dev)
    act_pad, act_cut = active.clone(), active.clone()
    act_pad[40] = 0
    act_cut[int(torch.nonzero(active == 3)[0])] = 2
    cases = {"all active": (active, z, True),
             "padding lane active 0": (act_pad, z_pad, True),
             "count cut short": (act_cut, z, False)}
    mism = {}
    for name, (act, zz, expect) in cases.items():
        args = (tab, ok, idx, rb, sb, blocks, act, zz)
        p = bool(rlc._rlc_plain(*args))
        for lpb in LANE_LAYOUTS:
            with lane_layout(lpb):
                k = bool(rlc.verify_batch_rlc_gather(*args))
            mism[f"{name}, {lpb} a block"] = (k != p) + (k != expect)
    return mism


def _lanes_to_tensors(pubs_b, sigs_b, msgs_b, dev):
    import numpy as np

    from cometbft_tpu_torch.crypto.batch import _padded_lane_args

    n = len(pubs_b)
    maxlen = max(max(len(m) for m in msgs_b), 1)
    msgs = np.zeros((n, maxlen), np.uint8)
    lens = np.array([len(m) for m in msgs_b], np.int64)
    for i, m in enumerate(msgs_b):
        msgs[i, :len(m)] = np.frombuffer(m, np.uint8)
    pubs = np.stack([np.frombuffer(p, np.uint8) for p in pubs_b])
    sigs = np.stack([np.frombuffer(s, np.uint8) for s in sigs_b])
    return _padded_lane_args(pubs, sigs[:, :32], sigs[:, 32:], msgs, lens,
                             dev)


def phase_commit(fx, dev, reps):
    """The main path.  Returns (launches, per_call launches, latencies)."""
    import copy

    from cometbft_tpu_torch.crypto.batch import RLC_MIN_LANES
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.types import validation as V

    sets = {n: fx.commit(n) for n in SIZES}
    tampered = {}
    for n, (vals, commit) in sets.items():
        c = copy.deepcopy(commit)
        bad = (n * 2) // 3 - 7
        c.signatures[bad].signature = bytes(64)
        tampered[n] = (c, bad)

    def calls(n):
        vals, commit = sets[n]
        return [
            ("VerifyCommit", lambda: V.VerifyCommit(
                CHAIN_ID, vals, commit.block_id, commit.height, commit,
                device=dev)),
            ("VerifyCommitLight", lambda: V.VerifyCommitLight(
                CHAIN_ID, vals, commit.block_id, commit.height, commit,
                device=dev)),
            ("VerifyCommitLightTrusting", lambda: V.VerifyCommitLightTrusting(
                CHAIN_ID, vals, commit, device=dev)),
        ]

    per_call = {}
    _build.reset_launches()                    # the main path starts here
    for n in SIZES:
        for name, fn in calls(n):
            before = dict(_build.LAUNCHES)
            fn()
            per_call[f"{name}@{n}"] = {
                k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v - before.get(k, 0)}
        vals, commit = sets[n]
        c, bad = tampered[n]
        before = dict(_build.LAUNCHES)
        try:
            V.VerifyCommit(CHAIN_ID, vals, c.block_id, c.height, c,
                           device=dev)
        except V.ErrInvalidSignature as e:
            if e.idx != bad:
                raise AssertionError(
                    f"tampered lane {bad} reported as {e.idx}") from e
        else:
            raise AssertionError("tampered commit verified")
        per_call[f"VerifyCommit(tampered)@{n}"] = {
            k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
            if v - before.get(k, 0)}
    _sync()
    launches = dict(_build.LAUNCHES)           # ... and ends here
    plain = dict(_build.PLAIN_CALLS)
    missing = [k for k in COMMIT_KERNELS if not launches.get(k)]
    off = {k: launches[k] for k in OFF_PATH if launches.get(k)}
    if missing or plain or off:
        raise AssertionError(f"main path: kernels not launched {missing}, "
                             f"plain versions run {plain}, standalone hash "
                             f"kernels launched {off}")
    for n in SIZES:
        # Light stops once more than 2/3 of the (equal) power is counted
        light_lanes = (2 * n) // 3 + 1
        want = {"VerifyCommit": "ed25519_rlc_gather",
                "VerifyCommitLight": (
                    "ed25519_rlc_gather" if light_lanes >= RLC_MIN_LANES
                    else "ed25519_verify_gather")}
        for fn_name, kernel in want.items():
            if not per_call[f"{fn_name}@{n}"].get(kernel):
                raise AssertionError(f"{fn_name}@{n} did not launch {kernel}")
    lat = {}
    for n in SIZES:
        for name, fn in calls(n):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            lat[f"{name}@{n}"] = statistics.median(ts)
    return launches, per_call, lat, sets


def phase_throughput(sets, dev, n_lanes, reps):
    """10k lanes: the 1,000 signed lanes tiled against a 10,000-row
    table.  Kernel rates from CUDA events; the host-inclusive rate of the
    dense entry point from the wall clock."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc

    n_keys = max(sets)
    vals, commit = sets[n_keys]
    pubs, sigs, msgs, lens = lane_arrays(vals, commit)
    reps_t = -(-n_lanes // n_keys)
    big_pubs = np.tile(pubs, (reps_t, 1))[:n_lanes]
    lane = np.arange(n_lanes) % n_keys
    l_sigs, l_msgs, l_lens = sigs[lane], msgs[lane], lens[lane]
    pub_t = torch.from_numpy(big_pubs.copy()).to(dev)
    tables_ms = time_host(lambda: ed.prepare_pubkey_tables(pub_t))
    tab, ok = ed.prepare_pubkey_tables(pub_t)
    idx = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    rb, sb, blocks, active = batch._padded_lane_args(
        big_pubs, l_sigs[:, :32], l_sigs[:, 32:], l_msgs, l_lens, dev)
    z = torch.from_numpy(rlc.host_rlc_coeffs(n_lanes)).to(dev)
    if not bool(rlc.verify_batch_rlc_gather(tab, ok, idx, rb, sb, blocks,
                                            active, z)):
        raise AssertionError("10k-lane RLC verdict rejected a valid batch")
    per = ed.verify_padded_gather(tab, ok, idx, rb, sb, blocks, active)
    if not bool(per.all()):
        raise AssertionError("10k-lane per-lane kernel rejected a lane")
    rlc_ms = time_cuda(lambda: rlc.verify_batch_rlc_gather(
        tab, ok, idx, rb, sb, blocks, active, z), reps, warm=1)
    lane_ms = time_cuda(lambda: ed.verify_padded_gather(
        tab, ok, idx, rb, sb, blocks, active), reps, warm=1)
    from cometbft_tpu_torch.ops import sha512

    # the standalone sha512_scalar at the RLC verdict's shape, without the
    # index check of its public wrapper (the verdict hashes in its lane
    # stage)
    at_10k = {
        "sha512_scalar": (lambda: sha512._sha512_scalar(blocks, active),
                          "sha512_scalar_kernel"),
        "ed25519_tables": (lambda: ed.prepare_pubkey_tables(pub_t),
                           "ed25519_tables_kernel"),
        "ed25519_verify_gather": (lambda: ed.verify_padded_gather(
            tab, ok, idx, rb, sb, blocks, active), "ed25519_verify_gather"),
        "ed25519_rlc_gather": (lambda: rlc.verify_batch_rlc_gather(
            tab, ok, idx, rb, sb, blocks, active, z), "rlc_"),
    }
    ms_10k, device_10k = {}, {}
    for k, (fn, prefix) in at_10k.items():
        ms_10k[k] = time_cuda(fn, reps, warm=1)
        device_10k[k] = device_ms_of(fn, prefix, reps)[0]
    tables = table_checks(big_pubs, dev, REPS)
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ok_all, _ = batch.verify_dense(big_pubs, l_sigs, l_msgs, l_lens,
                                       device=dev, valset_pubs=big_pubs,
                                       scope=np.arange(n_lanes))
        wall.append((time.perf_counter() - t0) * 1e3)
        if not ok_all:
            raise AssertionError("10k-lane dense verify rejected")
    stages_10k = rlc_stage_ms(at_10k["ed25519_rlc_gather"][0], reps)
    checked_10k = time_cuda(lambda: sha512.sha512_scalar(blocks, active),
                            reps, warm=1)
    return {"lanes": n_lanes, "tables_ms": tables_ms, "tables": tables,
            "rlc_ms": rlc_ms,
            "sha512_checked_ms_10k": checked_10k,
            "rlc_stages_ms_10k": stages_10k,
            "per_lane_ms": lane_ms, "dense_wall_p50_ms": statistics.median(wall),
            "rlc_sig_per_s": n_lanes / rlc_ms * 1e3,
            "per_lane_sig_per_s": n_lanes / lane_ms * 1e3,
            "dense_sig_per_s": n_lanes / statistics.median(wall) * 1e3,
            "nb": int(blocks.shape[1]), "ms_10k": ms_10k,
            "device_ms_10k": device_10k}


def table_checks(pubs, dev, reps) -> dict:
    """The table kernel against its plain version on the card at
    TABLE_SIZES validators (the first rows of ``pubs``), rows mod p and
    ok bits (mismatched rows or bits by size; raises on any), and its
    time at 10,000 and 150 validators at each of LANE_LAYOUTS, its
    chain floor at each (one full block alone: the decode's chain and
    the quads' tables), and at one, two and three full blocks of 32 an
    SM (CUDA events over ``reps`` calls)."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.ops import ed25519 as ed

    mism = {}
    for n in TABLE_SIZES:
        pub_t = torch.from_numpy(pubs[:n].copy()).to(dev)
        tab_k, ok_k = ed.prepare_pubkey_tables(pub_t)
        tab_p, ok_p = ed._prepare_plain(pub_t)
        mism[n] = int((ed.tables_canonical(tab_k)
                       != ed.tables_canonical(tab_p)).flatten(1).any(1)
                      .sum()) + int((ok_k != ok_p).sum())
    if any(mism.values()):
        raise AssertionError(f"ed25519_tables mismatches by size: {mism}")

    def ms_at(n, lpb):
        pub_t = torch.from_numpy(np.resize(pubs, (n, 32))).to(dev)
        with lane_layout(lpb):
            return time_cuda(lambda: ed.prepare_pubkey_tables(pub_t), reps)

    layouts = {f"N={n} LPB={lpb}": ms_at(n, lpb) for n in (10_000, 150)
               for lpb in LANE_LAYOUTS}
    floor = {f"LPB={lpb}": ms_at(lpb, lpb) for lpb in LANE_LAYOUTS}
    # one, two and three full blocks of 32 an SM: where the SMs' sharing
    # of blocks starts to cost
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = {f"N={32 * sms * m} ({m} a SM)": ms_at(32 * sms * m, 32)
              for m in (1, 2, 3)}
    return {"mismatches": mism, "ms_by_layout": layouts,
            "chain_floor_ms": floor, "ms_by_blocks_per_sm": per_sm}


@contextlib.contextmanager
def lane_layout(lpb: int):
    """The RLC lane stage and the table kernel at ``lpb`` lanes a block
    whatever the lane count (``ops/rlc.py:lane_block``), inside the
    block."""
    from cometbft_tpu_torch.ops import rlc

    chosen = rlc.lane_block
    rlc.lane_block = lambda b: lpb
    try:
        yield
    finally:
        rlc.lane_block = chosen


def _kernel_ms(kernels_ms: dict, prefix: str):
    """Device ms per call of the kernels named ``prefix...`` in a
    :func:`profile_call` result (a template instance's name may start
    with its return type), or None where the profiler saw none."""
    hits = [v for k, v in kernels_ms.items()
            if k.removeprefix("void ").startswith(prefix)]
    return sum(hits) if hits else None


def device_ms_of(fn, prefix: str, reps: int):
    """Device ms per call of the kernels named ``prefix...`` over two
    traces of ``reps`` calls of ``fn``, the larger kept (a trace may lose
    events), and the kernels of that trace."""
    best, kernels = None, {}
    for _ in range(2):
        k = profile_call(fn, reps)["kernels_ms"]
        v = _kernel_ms(k, prefix)
        if v is not None and (best is None or v > best):
            best, kernels = v, k
    return best, kernels


def rlc_stage_ms(fn, reps: int) -> dict:
    """Device ms per call of each stage kernel of K6a (``RLC_STAGES``)
    in ``reps`` traced calls of ``fn``, and their sum."""
    kernels = profile_call(fn, reps, top=None)["kernels_ms"]
    out = {}
    for stage, name in RLC_STAGES:
        hits = [v for k, v in kernels.items()
                if k.removeprefix("void ").startswith((name + "(",
                                                       name + "<"))
                or k == name]
        out[stage] = sum(hits) if hits else None
    known = [v for v in out.values() if v is not None]
    out["sum"] = sum(known) if known else None
    return out


def chain_floor(stages: dict):
    """K6a's latency floor from the ladder stage's device time: ms per
    quad point operation (its ``LADDER_OPS`` operations, each two product
    latencies and two gathers) times the 255 doublings any width-1
    combination of the 64 windows needs.  None without the stage."""
    if stages.get("ladder") is None:
        return None
    per_op = stages["ladder"] / LADDER_OPS
    return {"ns_per_op": per_op * 1e6, "floor_ms": 255 * per_op}


def ptxas_usage(log: str) -> dict:
    """Registers, stack frame, spills and shared memory of every function
    in an ``nvcc -Xptxas -v`` log, by unmangled name."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?_Z(\d+)(\w+)", line)
        if m:
            name = m.group(2)[:int(m.group(1))]
            t = re.match(r"ILi(\d+)EE", m.group(2)[int(m.group(1)):])
            cur = out.setdefault(name + (f"<{t.group(1)}>" if t else ""), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    return out


def _rand_leaves(rng, n: int, lo: int, hi: int) -> list:
    return [rng.bytes(int(k)) for k in rng.integers(lo, hi, size=n)]


def phase_merkle(dev, reps, rec):
    """The merkle kernels against their plain versions on the card, at
    the main path's shapes, then a seeded sweep of tree sizes through
    the kernel route against hashlib (roots and every proof).  Fills
    ``rec`` for ``sha256_leaves``, ``merkle_level``, ``merkle_tree`` and
    ``merkle_tree_leaves``; returns the extra timings."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import sha256 as S

    rng = np.random.default_rng(2027)
    info = {"leaves_ms": {}}

    def leaf_args(items):
        blocks, active = merkle._leaf_blocks(items)
        return (torch.from_numpy(blocks.view(np.int32)).to(dev),
                torch.from_numpy(active).to(dev))

    # sha256_leaves as the tree calls it (digest words into a slice of a
    # larger level buffer): 10,000 one-block leaves (validator encodings
    # are 36 to 46 bytes), 10,000 two-block leaves (CommitSigs), 2,048
    # leaves; the rows around the slice must stay as they were
    mism, err = 0, 0
    for name, n, lo, hi in (("10000x1", MERKLE_LEAVES, 0, 55),
                            ("10000x2", MERKLE_LEAVES, 55, 119),
                            ("2048x1", 2048, 36, 47)):
        items = _rand_leaves(rng, n, lo, hi)
        bt, at = leaf_args(items)
        buf = torch.full((n + 8, 8), 0x5A5A5A5A, dtype=torch.int32,
                         device=dev)
        out = buf[3:3 + n]
        got = S.sha256_leaf_words(bt, at, out=out)
        plain = S._as_int32(S._leaf_state_plain(bt, at))
        mism += int((got != plain).any(1).sum())
        mism += int((torch.cat([buf[:3], buf[3 + n:]]) != 0x5A5A5A5A).sum())
        err = max(err, int((got.long() - plain.long()).abs().max()))
        host = S.words_to_bytes(got.cpu().numpy().view(np.uint32))
        mism += sum(host[i].tobytes() != merkle.leaf_hash(it)
                    for i, it in enumerate(items))
        mism += int((S.sha256_blocks(bt, at).cpu().numpy() != host).sum())
        info["leaves_ms"][name] = {
            "ms": time_cuda(lambda: S.sha256_leaf_words(bt, at, out=out),
                            reps),
            "device_ms": profile_call(
                lambda: S.sha256_leaf_words(bt, at, out=out),
                reps)["kernels_ms"],
            "plain_ms": time_host(
                lambda: S._as_int32(S._leaf_state_plain(bt, at))),
            "nb": int(bt.shape[1]), "blocks": int(at.sum())}
        if name == "10000x1":
            main_leaves = (bt, at)
    m = info["leaves_ms"]["10000x1"]
    rec["sha256_leaves"].update(
        device_ms=_kernel_ms(m["device_ms"], "sha256_leaves_kernel"),
        max_abs_err=err, mismatches=mism, ms=m["ms"],
        plain_ms=m["plain_ms"], shape=f"B={MERKLE_LEAVES} NB=1",
        bound_inputs=(int(main_leaves[1].sum()), MERKLE_LEAVES, 1))

    # merkle_level: 5,000 pairs
    kids = torch.from_numpy(np.frombuffer(rng.bytes(32 * MERKLE_LEAVES),
                                          np.int32).reshape(-1, 8)
                            .copy()).to(dev)
    got = S.merkle_level(kids)
    plain = S._merkle_level_plain(kids)
    mism = int((got != plain).any(1).sum())
    words = S.words_to_bytes(kids.cpu().numpy())
    par = S.words_to_bytes(got.cpu().numpy())
    mism += sum(par[i].tobytes() != merkle.inner_hash(
        words[2 * i].tobytes(), words[2 * i + 1].tobytes())
        for i in range(0, MERKLE_LEAVES // 2, 97))
    rec["merkle_level"].update(
        max_abs_err=int((got.long() - plain.long()).abs().max()),
        mismatches=mism,
        ms=time_cuda(lambda: S.merkle_level(kids), reps),
        plain_ms=time_host(lambda: S._merkle_level_plain(kids)),
        shape=f"n={MERKLE_LEAVES} ({MERKLE_LEAVES // 2} pairs)",
        bound_inputs=(MERKLE_LEAVES,))
    rec["merkle_level"]["device_ms"] = _kernel_ms(profile_call(
        lambda: S.merkle_level(kids), reps)["kernels_ms"],
        "merkle_subtree_kernel")

    # merkle_tree: every level of whole trees of random leaf digests,
    # against the plain level loop on the card and hashlib's level order
    mism, err, info["trees"] = 0, 0, {}
    for n in MERKLE_TREES:
        leaves = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32)
        rows = S.tree_rows(n)
        buf = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
        buf[:n] = torch.from_numpy(S.bytes_to_words(leaves).view(
            np.int32)).to(dev)
        plain = S._merkle_tree_plain(buf.clone(), n)
        before = _build.LAUNCHES["merkle_tree"]
        got = S.merkle_tree(buf, n)
        calls = _build.LAUNCHES["merkle_tree"] - before
        lv = [r.tobytes() for r in leaves]
        want = []
        while True:
            want += lv
            if len(lv) == 1:
                break
            lv = [merkle.inner_hash(lv[2 * i], lv[2 * i + 1])
                  for i in range(len(lv) // 2)] + lv[len(lv) - len(lv) % 2:]
        host = S.words_to_bytes(got.cpu().numpy().view(np.uint32))
        bad = (int((got != plain).any(1).sum())
               + sum(host[i].tobytes() != w for i, w in enumerate(want))
               + int(calls != 1))
        mism += bad
        err = max(err, int((got.long() - plain.long()).abs().max()))
        info["trees"][n] = {"levels": len(merkle._level_widths(n)),
                            "mismatches": bad}
        if n == MERKLE_LEAVES:
            tree = (buf, n)
    buf, n = tree
    prof = profile_call(lambda: S.merkle_tree(buf, n), reps)
    rec["merkle_tree"].update(
        max_abs_err=err, mismatches=mism,
        ms=time_cuda(lambda: S.merkle_tree(buf, n), reps),
        device_ms=_kernel_ms(prof["kernels_ms"], "merkle_subtree_kernel"),
        plain_ms=time_host(lambda: S._merkle_tree_plain(buf, n)),
        shape=f"n={n} ({len(merkle._level_widths(n)) - 1} levels)",
        bound_inputs=(n,))

    # merkle_tree_leaves, the tree's route: the leaves and every level in
    # one call, against the leaves' plain version followed by the tree's
    # and against hashlib's level order, at 10,000 and 2,048 one-block,
    # two-block and mixed leaves and at MERKLE_LEAF_TREES leaves; one C
    # call a tree
    mism, err, info["leaf_trees"] = 0, 0, {}
    shapes = [(f"{n}x{kind}", n, lo, hi) for n in (MERKLE_LEAVES, 2048)
              for kind, lo, hi in (("1", 0, 55), ("2", 55, 119),
                                   ("mixed", 0, 119))]
    shapes += [(str(n), n, 0, 119) for n in MERKLE_LEAF_TREES]
    for name, n, lo, hi in shapes:
        items = _rand_leaves(rng, n, lo, hi)
        bt, at = leaf_args(items)
        before = _build.LAUNCHES["merkle_tree_leaves"]
        got = S.merkle_tree_leaves(bt, at)
        calls = _build.LAUNCHES["merkle_tree_leaves"] - before
        plain = torch.empty_like(got)
        plain[:n] = S._as_int32(S._leaf_state_plain(bt, at))
        S._merkle_tree_plain(plain, n)
        host = S.words_to_bytes(got.cpu().numpy().view(np.uint32))
        want = [r for lv in merkle._levels_hashlib(items) for r in lv]
        bad = (int((got != plain).any(1).sum()) + int(calls != 1)
               + sum(h.tobytes() != w for h, w in zip(host, want))
               + abs(len(host) - len(want)))
        mism += bad
        err = max(err, int((got.long() - plain.long()).abs().max()))
        info["leaf_trees"][name] = {"nb": int(bt.shape[1]),
                                    "mismatches": bad}
        if name == f"{MERKLE_LEAVES}x1":
            fused = (bt, at, got)

    bt, at, got = fused
    n = bt.shape[0]

    def fused_plain():
        lv = torch.empty_like(got)
        lv[:n] = S._as_int32(S._leaf_state_plain(bt, at))
        return S._merkle_tree_plain(lv, n)

    rec["merkle_tree_leaves"].update(
        max_abs_err=err, mismatches=mism,
        ms=time_cuda(lambda: S.merkle_tree_leaves(bt, at, got), reps),
        device_ms=_kernel_ms(profile_call(
            lambda: S.merkle_tree_leaves(bt, at, got), reps)["kernels_ms"],
            "merkle_"),
        plain_ms=time_host(fused_plain),
        shape=f"n={n} one-block leaves "
              f"({len(merkle._level_widths(n)) - 1} levels above them)",
        bound_inputs=(int(at.sum()), n, int(bt.shape[1])))

    # whole trees, wall clock: the kernel route against hashlib's level
    # loop on the same items (the 2,048-leaf threshold was sized on a TPU)
    info["tree_ms"] = {}
    for n in (2048, MERKLE_LEAVES):
        items = _rand_leaves(rng, n, 36, 47)
        info["tree_ms"][n] = {
            "kernel_route": statistics.median(time_host(
                lambda: merkle.hash_from_byte_slices_fast(items, device=dev))
                for _ in range(reps)),
            "hashlib_levels": statistics.median(time_host(
                lambda: merkle._levels_hashlib(items)[-1][0])
                for _ in range(reps))}

    # the tree sweep: kernel route (from 2,048 leaves) against hashlib
    sweep = {}
    cases = [(n, _rand_leaves(rng, n, 0, 119)) for n in MERKLE_SWEEP]
    cases.append((3000, _rand_leaves(rng, 3000, 119, 300)))
    for n, items in cases:
        before = dict(_build.LAUNCHES)
        root = merkle.hash_from_byte_slices_fast(items, device=dev)
        proot, proofs = merkle.proofs_from_byte_slices(items, device=dev)
        launched = {k: v - before.get(k, 0)
                    for k, v in _build.LAUNCHES.items()
                    if v - before.get(k, 0)}
        want_root, want = merkle.proofs_from_byte_slices_reference(items)
        bad = (int(root != merkle.hash_from_byte_slices(items))
               + int(root != want_root) + int(proot != want_root)
               + sum(a != b for a, b in zip(proofs, want))
               + abs(len(proofs) - len(want)))
        long_leaves = max(map(len, items), default=0) > 118
        key = f"{n}{' long' if long_leaves else ''}"
        want_launch = n >= merkle.MERKLE_KERNEL_MIN_LEAVES
        # one tree call a tree (root, then proofs): with its leaves, or
        # over leaves hashed on the host
        call = "merkle_tree" if long_leaves else "merkle_tree_leaves"
        if launched.get(call, 0) != 2 * want_launch or \
                set(launched) - {call}:
            raise AssertionError(f"tree of {key} leaves took the wrong "
                                 f"route: launches {launched}")
        sweep[key] = bad
    if _build.PLAIN_CALLS:
        raise AssertionError(f"plain versions ran: {dict(_build.PLAIN_CALLS)}")
    for k in ("merkle_tree_leaves", "merkle_tree"):
        rec[k]["sweep_mismatches"] = sum(sweep.values())
        rec[k]["mismatches"] += sum(sweep.values())
    info["sweep"] = sweep
    return info


def _expect_raise(fn, cls, check=None):
    try:
        fn()
    except cls as e:
        if check is not None and not check(e):
            raise AssertionError(f"{cls.__name__} with the wrong details: "
                                 f"{e}") from e
        return str(e)
    raise AssertionError(f"expected {cls.__name__}, nothing raised")


def profile_call(fn, calls: int = 1, top=8, verdicts: bool = False,
                 warm=None) -> dict:
    """Wall time of ``calls`` synchronized calls of ``fn`` and the device
    time of what they ran, by name (the ``top`` longest, or all for
    None), from ``torch.profiler`` (a first traced call of ``warm``, by
    default ``fn``, whose trace is dropped, warms the tracer up: the
    first events of a process's first trace were missing on the card;
    device time is None when the profiler saw no device activity).
    Times are per call.  With ``verdicts`` also the device ms of each
    RLC verdict traced, in order (:func:`_window_verdicts_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _sync()
    with profile(activities=acts):
        (warm or fn)()
        _sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies), not the host ops
        # that launched them
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels[e.key[:60]] = dev_us / 1e3 / calls
    busy = sum(kernels.values()) if kernels else None
    out = {"wall_ms": wall, "device_ms": busy,
           "device_busy_share": None if busy is None else busy / wall,
           "kernels_ms": dict(sorted(kernels.items(),
                                     key=lambda kv: -kv[1])[:top])}
    if verdicts:
        out["verdicts_ms"] = _window_verdicts_ms(prof)
    return out


def _path_launches(fn, required):
    """Run ``fn`` as a main-path run: counters zeroed just before, read
    just after; every kernel in ``required`` must have launched, no
    plain version may have run and no ``OFF_PATH`` kernel launched."""
    from cometbft_tpu_torch.ops import _build

    _build.reset_launches()
    out = fn()
    _sync()
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    missing = [k for k in required if not launches.get(k)]
    off = {k: launches[k] for k in OFF_PATH if launches.get(k)}
    if missing or plain or off:
        raise AssertionError(f"main path: kernels not launched {missing}, "
                             f"plain versions run {plain}, standalone hash "
                             f"kernels launched {off}")
    return launches, out


def phase_light150(pool, keys, dev, reps):
    """``verify_sequential_batched`` over a chain of LIGHT_HEADERS headers
    fully signed by LIGHT_VALS validators: one dispatch of the light lanes
    of LIGHT_HEADERS - 1 headers."""
    from cometbft_tpu_torch.light import verify_sequential_batched

    t0 = time.perf_counter()
    _, chain = light_chain(pool, keys[:LIGHT_VALS], LIGHT_HEADERS, dev)
    fixture_s = time.perf_counter() - t0
    now = chain[-1].header.time_ns + 10**9

    def run():
        verify_sequential_batched(CHAIN_ID, chain[0], chain[1:],
                                  TRUSTING_PERIOD_NS, now, device=dev)

    t0 = time.perf_counter()
    launches, _ = _path_launches(run, ("ed25519_tables",
                                       "ed25519_rlc_gather"))
    first_s = time.perf_counter() - t0
    lanes = (LIGHT_HEADERS - 1) * ((2 * LIGHT_VALS) // 3 + 1)
    return launches, {
        "fixture_s": fixture_s, "first_call_s": first_s,
        "headers": LIGHT_HEADERS - 1, "lanes": lanes,
        "wall": time_host_spread(run, reps),
        "profile": profile_call(run)}, chain


def phase_light10k(pool, keys, dev, reps):
    """The light path at BIG_VALS validators: every call once as the main
    path (with a forged set and a tampered signature), then p50s."""
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.light import (ErrInvalidHeader, LightBlock,
                                          verify_adjacent,
                                          verify_non_adjacent,
                                          verify_sequential_batched)
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.types.validator_set import (Validator,
                                                        ValidatorSet)

    t0 = time.perf_counter()
    vals, (h1, h2, h3) = light_chain(pool, keys[:BIG_VALS], 3, dev)
    fixture_s = time.perf_counter() - t0
    now = h3.header.time_ns + 10**9
    period = TRUSTING_PERIOD_NS
    forged = LightBlock(h2.header, h2.commit, ValidatorSet(
        [Validator(v.pub_key, v.voting_power + (i == 0))
         for i, v in enumerate(vals.validators)]))
    bad_lane = 100                    # inside the light scope (6,667 lanes)
    commit = copy.deepcopy(h3.commit)
    sig = bytearray(commit.signatures[bad_lane].signature)
    sig[7] ^= 0x20
    commit.signatures[bad_lane].signature = bytes(sig)
    tampered = LightBlock(h3.header, commit, vals)

    calls = {
        "ValidatorSet.hash": lambda: vals.hash(dev),
        "verify_adjacent": lambda: verify_adjacent(
            CHAIN_ID, h1, h2, period, now, device=dev),
        "verify_non_adjacent": lambda: verify_non_adjacent(
            CHAIN_ID, h1, h3, period, now, device=dev),
        "verify_sequential_batched": lambda: verify_sequential_batched(
            CHAIN_ID, h1, [h2, h3], period, now, device=dev),
        "VerifyCommit": lambda: V.VerifyCommit(
            CHAIN_ID, vals, h2.commit.block_id, h2.height, h2.commit,
            device=dev),
    }

    def main_path():
        from cometbft_tpu_torch.ops import _build

        per_call = {}
        for name, fn in calls.items():
            before = dict(_build.LAUNCHES)
            fn()
            per_call[name] = {k: v - before.get(k, 0)
                              for k, v in _build.LAUNCHES.items()
                              if v - before.get(k, 0)}
        if vals.hash(dev) != h2.header.validators_hash:
            raise AssertionError("kernel-route valset hash changed")
        _expect_raise(lambda: verify_adjacent(
            CHAIN_ID, h1, forged, period, now, device=dev), ErrInvalidHeader)
        _expect_raise(lambda: verify_sequential_batched(
            CHAIN_ID, h1, [h2, tampered], period, now, device=dev),
            V.ErrBatchItemInvalid,
            lambda e: (e.item, e.height, type(e.cause).__name__,
                       getattr(e.cause, "idx", None))
            == (1, 3, "ErrInvalidSignature", bad_lane))
        return per_call

    t0 = time.perf_counter()
    launches, per_call = _path_launches(main_path, (
        "merkle_tree_leaves", *COMMIT_KERNELS))
    first_s = time.perf_counter() - t0
    wall = {name: time_host_spread(fn, reps) for name, fn in calls.items()}
    items = [v.simple_encode() for v in vals.validators]
    host = {
        "simple_encode": statistics.median(time_host(
            lambda: [v.simple_encode() for v in vals.validators])
            for _ in range(reps)),
        "tree_kernel_route": statistics.median(time_host(
            lambda: merkle.hash_from_byte_slices_fast(items, device=dev))
            for _ in range(reps)),
        "tree_hashlib_levels": statistics.median(time_host(
            lambda: merkle._levels_hashlib(items)[-1][0])
            for _ in range(reps)),
    }
    if merkle._levels_hashlib(items)[-1][0] != vals.hash(dev):
        raise AssertionError("hashlib and kernel-route valset roots differ")
    return launches, {
        "fixture_s": fixture_s, "first_path_s": first_s,
        "per_call_launches": per_call, "wall": wall, "host_ms": host,
        "verify_commit_parts_ms": verify_commit_parts(vals, h2.commit, dev,
                                                      reps),
        "profile_verify_adjacent": profile_call(calls["verify_adjacent"]),
        "profile_verify_commit": profile_call(calls["VerifyCommit"],
                                              reps // 4),
        "profile_valset_hash": profile_call(calls["ValidatorSet.hash"])}, \
        (vals, h2), (h1, h2, h3)


def _loop_rows(commit, scope):
    """Sign-bytes rows of lanes ``scope`` built lane by lane with
    ``Commit.vote_sign_bytes`` (the route the native encoder replaced),
    timed beside it and held against it."""
    import numpy as np

    msgs_b = [commit.vote_sign_bytes(CHAIN_ID, int(i)) for i in scope]
    width = max((len(m) for m in msgs_b), default=0)
    msgs = np.zeros((len(msgs_b), width), np.uint8)
    lens = np.zeros((len(msgs_b),), np.int64)
    for j, m in enumerate(msgs_b):
        msgs[j, :len(m)] = np.frombuffer(m, np.uint8)
        lens[j] = len(m)
    return msgs, lens


def verify_commit_parts(vals, commit, dev, reps) -> dict:
    """The host parts of one ``VerifyCommit`` at the set's size, each
    timed alone (median ms of ``reps`` calls): the commit's columns
    (``dense_columns``), its sign-bytes rows by the native encoder and by
    the per-lane loop, the SHA-512 padding of R || A || M (``host_pad``),
    the dispatch (``verify_dense`` with its packing, copies, kernels and
    verdict read), and the call itself; "rest" is the call less columns,
    encoder rows and dispatch.  The encoder's rows must equal the loop's
    byte for byte over every lane."""
    import numpy as np

    from cometbft_tpu_torch.crypto import batch as cryptobatch
    from cometbft_tpu_torch.ops import sha512 as sha
    from cometbft_tpu_torch.types import validation as V

    pubs, _ = vals.dense()
    flags, ts, sigmat, _ = commit.dense_columns()
    scope = np.nonzero(flags != 1)[0]
    msgs, lens = V._dense_build_rows(CHAIN_ID, commit, ts, flags, scope)
    lmsgs, llens = _loop_rows(commit, scope)
    rows_equal = bool(np.array_equal(lens, llens) and all(
        bytes(msgs[i, :lens[i]]) == bytes(lmsgs[i, :llens[i]])
        for i in range(scope.size)) and not any(
        msgs[i, lens[i]:].any() for i in range(scope.size)))
    if not rows_equal:
        raise AssertionError("encoder rows differ from Commit.vote_sign_bytes")
    rs, ss = sigmat[scope, :32], sigmat[scope, 32:]

    def pad():
        hin = np.zeros((scope.size, 64 + msgs.shape[1]), np.uint8)
        hin[:, :32] = rs
        hin[:, 32:64] = pubs[scope]
        hin[:, 64:] = msgs
        nb = sha.max_blocks_for_len(64 + int(lens.max()))
        return sha.host_pad(hin, 64 + lens, nb)

    parts = {
        "dense_columns": lambda: commit.dense_columns(),
        "rows_native": lambda: V._dense_build_rows(CHAIN_ID, commit, ts,
                                                    flags, scope),
        "rows_per_lane_loop": lambda: _loop_rows(commit, scope),
        "host_pad": pad,
        "dispatch_verify_dense": lambda: cryptobatch.verify_dense(
            np.ascontiguousarray(pubs[scope]),
            np.ascontiguousarray(sigmat[scope]), msgs, lens, device=dev,
            valset_pubs=pubs, scope=scope),
        "VerifyCommit": lambda: V.VerifyCommit(
            CHAIN_ID, vals, commit.block_id, commit.height, commit,
            device=dev),
    }
    out = {k: statistics.median(time_host(fn) for _ in range(reps))
           for k, fn in parts.items()}
    out["rest"] = out["VerifyCommit"] - out["dense_columns"] - \
        out["rows_native"] - out["dispatch_verify_dense"]
    out["lanes"] = int(scope.size)
    out["stride"] = int(msgs.shape[1])
    out["rows_equal"] = rows_equal
    return out


# ------------------------------------------------- phase 10: light client

def smoke_provider(blocks, name, signer=None):
    """A ``light.Provider`` over prebuilt light blocks: counts fetches
    (the heights, in order), records reported evidence, and hands each
    served block to ``signer`` (which signs its commit the first time)."""
    from cometbft_tpu_torch.light import ErrLightBlockNotFound, Provider

    class SmokeProvider(Provider):
        def __init__(self):
            self.by_height = {lb.height: lb for lb in blocks}
            self.tip = max(self.by_height)
            self.fetched: list = []
            self.reported: list = []

        def id(self):
            return name

        async def light_block(self, height):
            self.fetched.append(height)
            lb = self.by_height.get(self.tip if height == 0 else height)
            if lb is None:
                raise ErrLightBlockNotFound(f"{name}: no light block at "
                                            f"height {height}")
            if signer is not None:
                signer(lb)
            return lb

        async def report_evidence(self, evidence):
            self.reported.append(evidence)

    return SmokeProvider()


class LazySigner:
    """Signs a light block's commit (every lane, in the pool) the first
    time a provider serves it; the signatures stay in the block."""

    def __init__(self, pool, key_of):
        self.pool, self.key_of = pool, key_of
        self.blocks = 0
        self.seconds = 0.0

    def __call__(self, lb):
        sigs = lb.commit.signatures
        if sigs[0].signature:
            return
        t0 = time.perf_counter()
        tasks = [(self.key_of[cs.validator_address],
                  [lb.commit.vote_sign_bytes(CHAIN_ID, lane)])
                 for lane, cs in enumerate(sigs)]
        for cs, row in zip(sigs, self.pool.map(
                _sign_all, tasks,
                chunksize=max(1, len(tasks) // (4 * os.cpu_count())))):
            cs.signature = row[0]
        self.blocks += 1
        self.seconds += time.perf_counter() - t0


def _unsigned_block(vals, vh, nvh, height, time_ns, prev):
    from cometbft_tpu_torch.light import LightBlock
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.header import Header

    header = Header(chain_id=CHAIN_ID, height=height, time_ns=time_ns,
                    last_block_id=prev, validators_hash=vh,
                    next_validators_hash=nvh,
                    proposer_address=vals.validators[0].address)
    bid = BlockID(header.hash(), PartSetHeader(1, b"\x5a" * 32))
    return LightBlock(header, Commit(height, 0, bid, [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, time_ns + 1 + lane % 997,
                  b"") for lane, v in enumerate(vals.validators)]), vals)


def rotating_chain(keys, n_vals: int, n_headers: int, every: int):
    """Headers 1..n_headers under n_vals validators (power 10), the
    longest-serving one replaced by a fresh key every ``every`` heights
    (the set updated with ``update_with_change_set``); commits unsigned.
    Returns (blocks, address -> private key)."""
    import collections

    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.validator_set import (Validator,
                                                        ValidatorSet)

    pubs = [Ed25519PrivKey(k).pub_key() for k in keys]
    key_of = {pk.address(): k for pk, k in zip(pubs, keys)}
    vals = ValidatorSet([Validator(pk, 10) for pk in pubs[:n_vals]])
    serving = collections.deque(pubs[:n_vals])
    fresh = iter(pubs[n_vals:])
    vh = vals.hash("cpu")                  # 150 leaves: hashlib anyway
    blocks, prev = [], BlockID()
    for h in range(1, n_headers + 1):
        nxt, nvh = vals, vh
        if h % every == 0:
            new = next(fresh)
            nxt = vals.copy()
            nxt.update_with_change_set([Validator(serving.popleft(), 0),
                                        Validator(new, 10)])
            serving.append(new)
            nvh = nxt.hash("cpu")
        blocks.append(_unsigned_block(vals, vh, nvh, h,
                                      LIGHT_T0 + h * 10**9, prev))
        prev = blocks[-1].commit.block_id
        vals, vh = nxt, nvh
    return blocks, key_of


def forked_chain(chain, fork_at: int, skew_ns: int):
    """``chain``'s blocks through ``fork_at``, then blocks of the same
    validators with timestamps skewed by ``skew_ns``, linked to the
    fork's own block ids; the fork's commits unsigned."""
    blocks = list(chain[:fork_at])
    prev = chain[fork_at - 1].commit.block_id
    for lb in chain[fork_at:]:
        h = lb.header
        blocks.append(_unsigned_block(lb.validators, h.validators_hash,
                                      h.next_validators_hash, h.height,
                                      h.time_ns + skew_ns, prev))
        prev = blocks[-1].commit.block_id
    return blocks


def light_client_host_ms(lb150, lb10k, reps) -> dict:
    """Median host ms of what the client does around the kernels, at 150
    and 10,000 validators: the store's codec (``pack`` of a light block
    as ``TrustedStore.save`` writes it, ``unpack`` as ``latest`` reads
    it), and a validator set's construction with the one proposer
    increment it runs, and that increment alone."""
    from cometbft_tpu_torch.types import codec
    from cometbft_tpu_torch.types.validator_set import (Validator,
                                                        ValidatorSet)

    out = {}
    for tag, lb in (("150", lb150), ("10k", lb10k)):
        d = {"h": lb.header, "c": lb.commit, "v": lb.validators}
        raw = codec.pack(d)
        vals = [Validator(v.pub_key, v.voting_power)
                for v in lb.validators.validators]
        fresh = ValidatorSet(vals)
        for name, fn in (
                ("pack", lambda: codec.pack(d)),
                ("unpack", lambda: codec.unpack(raw)),
                ("valset_new", lambda: ValidatorSet(vals)),
                ("increment_1", lambda: fresh.increment_proposer_priority(1))):
            out[f"{name}_{tag}"] = statistics.median(
                time_host(fn) for _ in range(reps))
        out[f"stored_bytes_{tag}"] = len(raw)
    return out


def phase_light_client(pool, keys, chain150, blocks10k, dev, reps):
    """Phase 10: ``light.Client`` over smoke providers, four cases, each
    run once as the main path (counters zeroed just before, read just
    after), then timed with a new client and a new ``MemDB`` a call:

    (a) sequential, 150 validators: trust height 1 of phase 6's chain,
        verify to LIGHT_HEADERS; the store holds every height;
    (b) skipping, 150 validators, SKIP_HEIGHTS heights, a validator
        replaced every SKIP_ROTATE_EVERY heights: the jump from 1 loses
        the 1/3 overlap and the client bisects; commits signed when first
        served (the main-path run is the warm-up);
    (c) skipping, BIG_VALS validators, phase 7's headers: trust 1, jump
        to the last (one ``verify_non_adjacent`` at full width);
    (d) detector, 150 validators: a witness serving phase 6's chain
        forked above FORK_AT (skewed timestamps, signed lazily) must
        raise ``DivergenceError`` naming it, with evidence to both sides;
        a witness that never has the height is dropped after
        ``MAX_WITNESS_LAG_STRIKES`` calls."""
    import asyncio

    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.light import (SEQUENTIAL, Client,
                                          DivergenceError, TrustedStore,
                                          TrustOptions)
    from cometbft_tpu_torch.light.detector import MAX_WITNESS_LAG_STRIKES
    from cometbft_tpu_torch.storage.db import MemDB, height_key

    loop = asyncio.new_event_loop()
    fixture_s = {}
    t0 = time.perf_counter()
    skip_chain, skip_keys = rotating_chain(
        keys[:LIGHT_VALS + SKIP_HEIGHTS // SKIP_ROTATE_EVERY], LIGHT_VALS,
        SKIP_HEIGHTS, SKIP_ROTATE_EVERY)
    skip_signer = LazySigner(pool, skip_keys)
    fixture_s["b_chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fork = forked_chain(chain150, FORK_AT, FORK_SKEW_NS)
    fork_signer = LazySigner(pool, {
        Ed25519PrivKey(k).pub_key().address(): k
        for k in keys[:LIGHT_VALS]})
    fixture_s["d_fork"] = time.perf_counter() - t0

    def client(blocks, mode="skipping", witnesses=(), signer=None):
        primary = smoke_provider(blocks, "primary", signer)
        return Client(CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, 1,
                                             blocks[0].header.hash()),
                      primary, witnesses=list(witnesses),
                      store=TrustedStore(MemDB()), mode=mode, device=dev,
                      now_ns=lambda: blocks[-1].header.time_ns + 10**9)

    def case_a():
        c = client(chain150, SEQUENTIAL)
        lb = loop.run_until_complete(
            c.verify_light_block_at_height(LIGHT_HEADERS))
        keys_ = [k for k, _ in c.store.db.iterate()]
        if lb is not chain150[-1] or keys_ != [
                height_key(b"lb/", h) for h in range(1, LIGHT_HEADERS + 1)]:
            raise AssertionError("(a): store does not hold every height")
        return c.primary.fetched

    def case_b():
        c = client(skip_chain, signer=skip_signer)
        lb = loop.run_until_complete(
            c.verify_light_block_at_height(SKIP_HEIGHTS))
        fetched = c.primary.fetched
        if lb is not skip_chain[-1] or len(fetched) > SKIP_HEIGHTS // 20 \
                or len(set(fetched)) < 4:
            raise AssertionError(f"(b): fetched {fetched}")
        return fetched

    def case_c():
        c = client(blocks10k)
        lb = loop.run_until_complete(
            c.verify_light_block_at_height(blocks10k[-1].height))
        if lb is not blocks10k[-1] or c.primary.fetched != [1, 3]:
            raise AssertionError(f"(c): fetched {c.primary.fetched}")
        return c.primary.fetched

    def case_d():
        forked = smoke_provider(fork, "forked", fork_signer)
        laggard = smoke_provider(chain150[:2], "laggard")
        c = client(chain150, SEQUENTIAL, (forked, laggard))
        try:
            loop.run_until_complete(
                c.verify_light_block_at_height(LIGHT_HEADERS))
            raise AssertionError("(d): no DivergenceError")
        except DivergenceError as e:
            err = e
        ok = (err.witness_id == "forked" and err.common_height == FORK_AT
              and [ev.conflicting_height for ev in forked.reported]
              == [FORK_AT + 1]
              and [ev.conflicting_height for ev in c.primary.reported]
              == [FORK_AT + 1]
              and forked.reported[0].conflicting_header_hash
              == chain150[FORK_AT].header.hash()
              and c.primary.reported[0].conflicting_header_hash
              == fork[FORK_AT].header.hash()
              and c.store.get(LIGHT_HEADERS) is None)
        if not ok:
            raise AssertionError(f"(d): {err}")
        # the lag strikes: a witness stuck at height 2 beside an honest one
        laggard = smoke_provider(chain150[:2], "laggard")
        honest = smoke_provider(chain150, "honest")
        c = client(chain150, witnesses=(laggard, honest))
        present = []
        for h in range(LIGHT_HEADERS - MAX_WITNESS_LAG_STRIKES + 1,
                       LIGHT_HEADERS + 1):
            present.append([w.id() for w in c.witnesses])
            loop.run_until_complete(c.verify_light_block_at_height(h))
        if present[-1] != ["laggard", "honest"] or \
                [w.id() for w in c.witnesses] != ["honest"]:
            raise AssertionError(f"(d): witnesses {present}, then "
                                 f"{[w.id() for w in c.witnesses]}")
        return {"error": str(err), "forked_fetched": len(forked.fetched),
                "witnesses_by_call": present}

    cases = {"a_sequential150": case_a, "b_skipping150": case_b,
             "c_skipping10k": case_c, "d_detector150": case_d}
    first = {}

    def main_path():
        out = {}
        for name, fn in cases.items():
            t1 = time.perf_counter()
            out[name] = fn()
            first[name] = time.perf_counter() - t1
        return out

    t0 = time.perf_counter()
    launches, results = _path_launches(main_path, (
        "ed25519_tables", "ed25519_verify_gather", "ed25519_rlc_gather",
        "merkle_tree_leaves"))
    first_s = time.perf_counter() - t0
    wall = {"a_sequential150": time_host_spread(case_a, reps),
            "b_skipping150": time_host_spread(case_b, reps),
            "c_skipping10k": time_host_spread(case_c, reps),
            "d_detector150": time_host_spread(case_d, max(3, reps // 4))}
    prof = {"a_sequential150": profile_call(case_a),
            "c_skipping10k": profile_call(case_c)}
    loop.close()
    return launches, {
        "host_ms": light_client_host_ms(chain150[-1], blocks10k[-1],
                                        max(3, reps // 4)),
        "fixture_s": fixture_s, "first_path_s": first_s,
        "first_call_s": first, "signed_blocks": {
            "b": skip_signer.blocks, "d": fork_signer.blocks},
        "signing_s": {"b": skip_signer.seconds, "d": fork_signer.seconds},
        "fetched_b": results["b_skipping150"],
        "fetches": {k: len(v) for k, v in results.items()
                    if isinstance(v, list)},
        "detector": results["d_detector150"], "wall": wall,
        "profile": prof}


def _window_points(rows):
    """(96, 40) cached window rows on any device -> 96 affine points."""
    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.ops import fe

    out = []
    for r in rows.cpu().tolist():
        ypx, ymx, z2 = (fe.int_from_limbs(r[k:k + 10]) for k in (0, 10, 20))
        zi = pow(z2 % ref.P, ref.P - 2, ref.P)
        out.append(((ypx - ymx) * zi % ref.P, (ypx + ymx) * zi % ref.P))
    return out


def mesh_cases(vals, commit, dev, d):
    """K7's check cases as (name, lane args, expected verdict): the
    10,000 lanes of ``commit`` through the set's table, a bad lane in
    each shard's position, garbage padding lanes (z = 0), a ragged last
    shard, fewer lanes than shards, and 150 lanes carrying the ZIP-215
    edge lanes (valid torsion cases, then the invalid ones) through their
    own keys' table."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.crypto.batch import _padded_lane_args
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc

    rng = np.random.default_rng(2027)
    pubs, sigs, msgs, lens = lane_arrays(vals, commit)
    n = pubs.shape[0]
    tab, ok = ed.prepare_pubkey_tables(torch.from_numpy(pubs).to(dev))
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    rb, sb, blocks, active = _padded_lane_args(
        pubs, sigs[:, :32], sigs[:, 32:], msgs, lens, dev)
    z = torch.from_numpy(rlc.host_rlc_coeffs(
        n, rng_bytes=rng.bytes(16 * n))).to(dev)
    lanes = (idx, rb, sb, blocks, active, z)

    def cut(b):
        return (tab, ok, *[t[:b] for t in lanes])

    cases = [("valid", cut(n), True)]
    step = -(-n // d)
    for s in range(d):
        sb_bad = sb.clone()
        sb_bad[s * step + 17, 0] ^= 1
        cases.append((f"bad lane in shard {s}",
                      (tab, ok, idx, rb, sb_bad, blocks, active, z), False))
    rb_pad, sb_pad, z_pad = rb.clone(), sb.clone(), z.clone()
    rb_pad[n - 100:] = 0xFF
    sb_pad[n - 99:] = 0xFF
    z_pad[n - 100:] = 0
    cases.append(("garbage padding", (tab, ok, idx, rb_pad, sb_pad, blocks,
                                      active, z_pad), True))
    cases.append(("ragged last shard", cut(n - 2), True))
    cases.append(("fewer lanes than shards", cut(d - 1), True))
    edges = edge_cases(rng)
    for name, sel in (("torsion edges",
                       [e for e in edges if ref.verify_zip215(*e)]),
                      ("invalid edges",
                       [e for e in edges if not ref.verify_zip215(*e)])):
        k = 150 - len(sel)
        e_pub = [p for p, _, _ in sel] + [pubs[i].tobytes() for i in range(k)]
        e_sig = [s for _, _, s in sel] + [sigs[i].tobytes() for i in range(k)]
        e_msg = [m for _, m, _ in sel] + [msgs[i, :lens[i]].tobytes()
                                          for i in range(k)]
        e_tab, e_ok = ed.prepare_pubkey_tables(torch.from_numpy(np.stack(
            [np.frombuffer(p, np.uint8) for p in e_pub])).to(dev))
        cases.append((name, (e_tab, e_ok, idx[:150],
                             *_lanes_to_tensors(e_pub, e_sig, e_msg, dev),
                             z[:150]), name == "torsion edges"))
    return cases


def phase_mesh_kernels(cases, shards, reps, rec):
    """K7 on the card against its plain version, over the devices
    ``shards`` (the cases lie on the first), and on the first card alone
    over ``K7_SPLITS``: per case the sharded verdict, the kernels'
    per-shard outputs (one sums call per distinct device, as the verdict
    runs them, gathered on the first) and verdict, the plain version's,
    and K6a's single-device verdict on the same inputs and z; the
    one-shard ``rlc_sums_gather`` against the plain first shard.  Window
    sums compare as points, sums of z*s mod L and ok bytes exactly.
    Fills ``rec`` for the two kernels and returns the whole verdict's
    times."""
    from cometbft_tpu_torch.ops import rlc
    from cometbft_tpu_torch.parallel.mesh import (batch_mesh, replicate,
                                                  shard_bounds,
                                                  split_by_device)

    dev = shards[0]

    def shard(args, lo, hi):
        return (*args[:2], *[t[lo:hi] for t in args[2:]])

    def sums_kernel(args, devs):
        tabs, oks = replicate(args[0], devs), replicate(args[1], devs)
        bufs = {x: rlc.rlc_sums_buffers(len(devs), x)
                for x in dict.fromkeys(devs)}
        for x, slots, offs, lanes in split_by_device(devs, *args[2:]):
            rlc._rlc_sums_card(tabs[x], oks[x], *lanes, offs, slots,
                               bufs[x])
        out = rlc.rlc_sums_buffers(len(devs), dev)
        for s, x in enumerate(devs):
            for o, t in zip(out, bufs[x]):
                o[s] = t[s].to(dev)
        return out

    def sums_plain(args, n):
        out = rlc.rlc_sums_buffers(n, dev)
        for s, (lo, hi) in enumerate(shard_bounds(args[2].shape[0], n)):
            rlc._store_sums_plain(*shard(args, lo, hi), out, s)
        return out

    def points_differ(a, b):
        return sum(x != y for x, y in zip(_window_points(a),
                                          _window_points(b)))

    valid = cases[0][1]
    runs = [(name, args, expect, tuple(shards))
            for name, args, expect in cases]
    for b, n in K7_SPLITS:
        runs.append((f"{b} lanes, {n} shard{'s' * (n > 1)} of one card",
                     shard(valid, 0, b), True, (dev,) * n))
    mism = {"verdict": 0, "window points": 0, "zs": 0, "ok": 0,
            "one shard": 0}
    zs_err, verdicts = 0, {}
    for name, args, expect, devs in runs:
        n = len(devs)
        fn = rlc.make_verify_batch_rlc_sharded(batch_mesh(devs), gather=True)
        k, p = sums_kernel(args, devs), sums_plain(args, n)
        v = [bool(fn(*args)), bool(rlc.rlc_combine(*k)),
             bool(rlc._rlc_combine_plain(*p)), bool(rlc.rlc_combine(*p)),
             bool(rlc._rlc_combine_plain(*k)),
             bool(rlc.verify_batch_rlc_gather(*args))]
        verdicts[name] = v + [expect]
        mism["verdict"] += sum(x != expect for x in v)
        for s in range(n):
            mism["window points"] += points_differ(k.sums[s], p.sums[s])
        mism["zs"] += int((k.zs != p.zs).any(1).sum())
        mism["ok"] += int((k.ok != p.ok).sum())
        zs_err = max(zs_err, int((k.zs.long() - p.zs.long()).abs().max()),
                     int((k.ok.long() - p.ok.long()).abs().max()))
        lo, hi = shard_bounds(args[2].shape[0], n)[0]
        one = rlc.rlc_sums_gather(*shard(args, lo, hi))
        mism["one shard"] += (points_differ(one.sums[0], p.sums[0])
                              + int((one.zs[0] != p.zs[0]).any())
                              + int(one.ok[0] != p.ok[0]))
    # the sums as the verdict runs them (no index check): one shard of
    # ceil(b / 4) lanes alone, and all four shards of one card in one call
    b = valid[2].shape[0]
    d = MESH_SHARDS
    lo, hi = shard_bounds(b, d)[0]
    one = shard(valid, lo, hi)
    buf1, buf4 = rlc.rlc_sums_buffers(1, dev), rlc.rlc_sums_buffers(d, dev)
    offs = [lo for lo, _ in shard_bounds(b, d)] + [b]

    def sums_one():
        rlc._rlc_sums_card(*one, [0, hi - lo], [0], buf1)

    def sums_card():
        rlc._rlc_sums_card(*valid, offs, list(range(d)), buf4)

    k = sums_kernel(valid, tuple(shards))
    p_ms = {"sums": time_host(lambda: rlc._store_sums_plain(
        *one, rlc.rlc_sums_buffers(1, dev), 0)),
        "combine": time_host(lambda: rlc._rlc_combine_plain(*k))}
    fn = rlc.make_verify_batch_rlc_sharded(batch_mesh(shards), gather=True)
    # device ms of the combine from one trace of the whole verdict (a
    # trace of the combine alone lost events on the card); the sums'
    # lane stage hashes the lanes, as their bound counts
    prof = profile_call(lambda: fn(*valid), reps)
    combine_ms = _kernel_ms(prof["kernels_ms"], "rlc_combine")
    sums_dev = {}
    for key, f in (("one", sums_one), ("card", sums_card)):
        kms = profile_call(f, reps, top=None)["kernels_ms"]
        st = {stage: _kernel_ms(kms, name) for stage, name in
              RLC_STAGES[:4]}
        st["sum"] = (None if None in st.values() else sum(st.values()))
        sums_dev[key] = st
    n_mism = sum(mism.values())
    rec["ed25519_rlc_sums"].update(
        max_abs_err=zs_err, mismatches=n_mism - mism["verdict"],
        ms=time_cuda(sums_one, reps), device_ms=sums_dev["one"]["sum"],
        card_ms=time_cuda(sums_card, reps),
        card_device_ms=sums_dev["card"]["sum"], stages_ms=sums_dev,
        plain_ms=p_ms["sums"],
        shape=f"one shard of {hi - lo} lanes alone (B={b}, D={d}); card: "
              f"{d} shards of one card in one call",
        cases=mism)
    rec["ed25519_rlc_combine"].update(
        max_abs_err=int(mism["verdict"] > 0), mismatches=mism["verdict"],
        ms=time_cuda(lambda: rlc.rlc_combine(*k), reps),
        device_ms=combine_ms, plain_ms=p_ms["combine"],
        shape=f"D={len(shards)}", verdicts=verdicts)
    return {"lanes": b, "shards": len(shards),
            "ms": time_cuda(lambda: fn(*valid), reps),
            "device_ms": prof["device_ms"],
            "device_kernels_ms": prof["kernels_ms"],
            "plain_ms": d * p_ms["sums"] + p_ms["combine"],
            "k6a_ms": time_cuda(lambda: rlc.verify_batch_rlc_gather(*valid),
                                reps),
            "enqueue_ms": time_enqueue(lambda: fn(*valid), reps),
            "k6a_enqueue_ms": time_enqueue(
                lambda: rlc.verify_batch_rlc_gather(*valid), reps)}


def phase_mesh(fx10k, chain150, shards, reps, rec):
    """The main path over the device set ``shards`` (MESH_SHARDS shards
    of one card, or distinct cards): ``VerifyCommit`` at 10,000
    validators (one sharded RLC dispatch: a shard-sums call per distinct
    card, one combine, no single-device verdict),
    ``verify_commits_light_batched`` over the 150-validator chain's
    headers, and a tampered commit whose sharded per-lane route names the
    same lane as the single-device route; then K7 against its plain
    version.  The device set is cleared however the phase ends."""
    from cometbft_tpu_torch.crypto import batch, plan
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.types import validation as V

    vals, h2 = fx10k
    commit = h2.commit
    bad = commit.size() * 43 // 100     # lane 4,300 of 10,000
    tampered = copy.deepcopy(commit)
    sig = bytearray(tampered.signatures[bad].signature)
    sig[9] ^= 0x40
    tampered.signatures[bad].signature = bytes(sig)
    items = [(lb.commit.block_id, lb.height, lb.commit)
             for lb in chain150[1:]]
    lanes150 = len(items) * ((2 * LIGHT_VALS) // 3 + 1)

    def verify_commit(device=None, c=commit):
        V.VerifyCommit(CHAIN_ID, vals, c.block_id, h2.height, c,
                       device=device)

    def main_path():
        runs = {}
        for name, fn, cls in (
                ("VerifyCommit@10k", verify_commit, None),
                (f"verify_commits_light_batched@{LIGHT_VALS}",
                 lambda: V.verify_commits_light_batched(
                     CHAIN_ID, chain150[0].validators, items), None),
                ("VerifyCommit(tampered)@10k",
                 lambda: verify_commit(c=tampered), V.ErrInvalidSignature)):
            before = dict(_build.LAUNCHES)
            batch.DISPATCHES.clear()
            if cls is None:
                fn()
            else:
                _expect_raise(fn, cls, lambda e: e.idx == bad)
            runs[name] = ({k: v - before.get(k, 0)
                           for k, v in _build.LAUNCHES.items()
                           if v - before.get(k, 0)}, dict(batch.DISPATCHES))
        return runs

    dev, d = shards[0], len(shards)
    plan.set_devices(shards)
    try:
        launches, runs = _path_launches(main_path, (
            "ed25519_rlc_sums", "ed25519_rlc_combine",
            "ed25519_verify_gather"))
        for name in ("VerifyCommit@10k",
                     f"verify_commits_light_batched@{LIGHT_VALS}"):
            launched, disp = runs[name]
            if (disp != {"rlc_gather_sharded": 1}
                    or launched.get("ed25519_rlc_sums") != len(set(shards))
                    or launched.get("ed25519_rlc_combine") != 1
                    or "ed25519_rlc_gather" in launched
                    or "ed25519_verify_gather" in launched):
                raise AssertionError(f"{name} under the device set: "
                                     f"{runs[name]}")
        if runs["VerifyCommit(tampered)@10k"][1] != {
                "rlc_gather_sharded": 1, "gather_sharded": 1}:
            raise AssertionError(f"tampered: {runs['VerifyCommit(tampered)@10k']}")
        sharded = time_host_spread(verify_commit, reps)
        single = time_host_spread(lambda: verify_commit(dev), reps)
        batched = time_host_spread(lambda: V.verify_commits_light_batched(
            CHAIN_ID, chain150[0].validators, items), reps // 4)
        prof = profile_call(verify_commit, reps // 4)
    finally:
        plan.set_devices(None)
    # the single-device route names the same lane
    _expect_raise(lambda: verify_commit(dev, tampered),
                  V.ErrInvalidSignature, lambda e: e.idx == bad)
    t0 = time.perf_counter()
    verdict = phase_mesh_kernels(mesh_cases(vals, commit, dev, d), shards,
                                 reps, rec)
    return launches, {
        "shards": [str(x) for x in shards], "cards": len(set(shards)),
        "runs": runs, "sharded": sharded, "single": single,
        "batched150": batched, "batched150_lanes": lanes150,
        "profile_verify_commit": prof,
        "verdict": verdict, "kernel_check_s": time.perf_counter() - t0}


def visible_cards() -> list:
    """The first MESH_SHARDS visible cards, one shard each."""
    import torch

    return [torch.device("cuda", i)
            for i in range(min(torch.cuda.device_count(), MESH_SHARDS))]


def report_mesh(mesh, launches, k7, card):
    """Print phase 9's results, ``k7`` the kernel record it filled, and
    fail on any K7 mismatch."""
    n, cards = len(mesh["shards"]), mesh["cards"]
    where = f"{n} shards on {cards} card{'s' * (cards > 1)}"
    print(f"mesh: {where} {mesh['shards']} (kernel check "
          f"{mesh['kernel_check_s']:.1f} s); launches {launches}")
    for k, (launched, disp) in mesh["runs"].items():
        print(f"launches {k}, {where}: {launched}, dispatches {disp}")
    print(f"VerifyCommit@{BIG_VALS}, {where}: "
          f"{_spread(mesh['sharded'])}  [{card}]")
    print(f"VerifyCommit@{BIG_VALS}, one device (same run): "
          f"{_spread(mesh['single'])}  [{card}]")
    print(f"verify_commits_light_batched@{LIGHT_VALS} "
          f"({mesh['batched150_lanes']} lanes), {where}: "
          f"{_spread(mesh['batched150'])}  [{card}]")
    prof = mesh["profile_verify_commit"]
    print(f"profile VerifyCommit@{BIG_VALS}, {where}: wall "
          f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']} ms, "
          f"kernels {prof['kernels_ms']}")
    mv = mesh["verdict"]
    print(f"K7 sharded verdict, {mv['lanes']} lanes, {where}: "
          f"{mv['ms']:.3f} ms, device {mv['device_ms']} ms "
          f"{mv['device_kernels_ms']}; K6a on the same inputs "
          f"{mv['k6a_ms']:.3f} ms; plain {mv['plain_ms']:.1f} ms; host "
          f"enqueue {mv['enqueue_ms']:.3f} ms (K6a {mv['k6a_enqueue_ms']:.3f})"
          f"  [{card}]")
    for k in MESH_KERNELS:
        r = k7[k]
        print(f"kernel {k} [{r['shape']}]: mismatches {r['mismatches']}, "
              f"max_abs_err {r['max_abs_err']}, {r['ms']:.4f} ms, device "
              f"{r['device_ms']} ms, plain {r['plain_ms']:.1f} ms  [{card}]")
    r = k7["ed25519_rlc_sums"]
    print(f"K7 sums, {MESH_SHARDS} shards of one card in one call: "
          f"{r['card_ms']:.4f} ms, device {r['card_device_ms']} ms; stages "
          f"(one shard alone, and the card's call), device ms: "
          f"{r['stages_ms']}  [{card}]")
    print(f"K7 mismatches by kind {k7['ed25519_rlc_sums']['cases']}; "
          "verdicts (sharded, kernels, plain, kernel combine of plain "
          "sums, plain combine of kernel sums, K6a, expected): "
          f"{k7['ed25519_rlc_combine']['verdicts']}")
    if any(k7[k]["mismatches"] for k in MESH_KERNELS):
        raise AssertionError(f"K7 mismatches, {where}: "
                             f"{k7['ed25519_rlc_sums']['cases']}")


def default_route(vals, h2):
    """With no device set on a host with several cards, ``device=None``
    shards over all of them: ``VerifyCommit`` through the set's table,
    and the uncached dense verify of the same lanes, valid and with one
    tampered lane, which the per-lane route must name."""
    import numpy as np

    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.types import validation as V

    pubs, sigs, msgs, lens = lane_arrays(vals, h2.commit)
    bad = pubs.shape[0] * 7 // 9      # lane 7,777 of 10,000
    sigs_bad = sigs.copy()
    sigs_bad[bad, 40] ^= 1
    batch.DISPATCHES.clear()
    V.VerifyCommit(CHAIN_ID, vals, h2.commit.block_id, h2.height, h2.commit)
    ok, _ = batch.verify_dense(pubs, sigs, msgs, lens)
    ok_bad, out_bad = batch.verify_dense(pubs, sigs_bad, msgs, lens)
    disp = dict(batch.DISPATCHES)
    want = {"rlc_gather_sharded": 1, "rlc_sharded": 2, "verify_sharded": 1}
    named = np.flatnonzero(~out_bad).tolist()
    if not ok or ok_bad or named != [bad] or disp != want:
        raise AssertionError(f"default route: ok {ok}, tampered ok {ok_bad}"
                             f", named {named[:5]}, dispatches {disp}")
    return {"dispatches": disp, "named": named}


def mesh_cards(card, record):
    """``--mesh-cards``: phase 9 alone over distinct cards, on the light
    phases' 150- and 10,000-validator fixtures (the cross-card copy of
    the partial sums and the overlap of the cards)."""
    cards = visible_cards()
    if len(cards) < 2:
        raise RuntimeError("--mesh-cards needs two or more visible cards")
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count()) as pool:
        keys = pool_keys(pool, BIG_VALS)
        _, chain150 = light_chain(pool, keys[:LIGHT_VALS], LIGHT_HEADERS,
                                  cards[0])
        vals, (_, h2, _) = light_chain(pool, keys, 3, cards[0])
    print(f"fixtures {time.perf_counter() - t0:.1f} s over "
          f"{os.cpu_count()} workers")
    t0 = time.perf_counter()
    k7 = {k: {} for k in MESH_KERNELS}
    launches, mesh = phase_mesh((vals, h2), chain150, cards, REPS, k7)
    print(f"mesh phase over {len(cards)} cards "
          f"{time.perf_counter() - t0:.1f} s")
    report_mesh(mesh, launches, k7, card)
    mesh["default_route"] = default_route(vals, h2)
    print(f"device=None with no device set, {len(cards)} cards: "
          f"{mesh['default_route']}")
    if record:
        os.makedirs(os.path.dirname(os.path.abspath(record)), exist_ok=True)
        with open(record, "w") as f:
            json.dump({"card": card, "mesh": mesh, "k7": k7}, f, indent=1,
                      default=str)


def bls_chain(pool, dev):
    """Two linked headers signed by BLS_VALS BLS validators (power 10),
    every BLS_ABSENT_EVERY-th lane absent and the others folded into the
    aggregate.  A same-message aggregate is one signature under the sum
    of the signers' secrets mod r (byte-identical to aggregating their
    signatures, ``tests/test_torch_bls.py``).  Returns (validator set,
    light blocks, signer lanes)."""
    from cometbft_tpu_torch.crypto import bls12381 as B
    from cometbft_tpu_torch.light import LightBlock
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_AGGREGATE,
                                                 Commit, CommitSig,
                                                 signer_bitmap)
    from cometbft_tpu_torch.types.header import Header
    from cometbft_tpu_torch.types.validator_set import (Validator,
                                                        ValidatorSet)

    secrets = [b"chip-smoke-bls-%d" % i for i in range(BLS_VALS)]
    chunks = [secrets[i:i + 250] for i in range(0, BLS_VALS, 250)]
    keys = [k for part in pool.map(_bls_keys, chunks) for k in part]
    sk_of = {}
    validators = []
    for sk, pk in keys:
        pub = B.Bls12381PubKey(pk)
        sk_of[pub.address()] = sk
        validators.append(Validator(pub, 10))
    vals = ValidatorSet(validators)
    vh = vals.hash(dev)
    signers = [i for i in range(BLS_VALS) if i % BLS_ABSENT_EVERY]
    total = sum(sk_of[vals.validators[i].address] for i in signers) % B.R
    blocks, prev = [], BlockID()
    for h in (1, 2):
        header = Header(chain_id=CHAIN_ID, height=h,
                        time_ns=LIGHT_T0 + h * 10**9, last_block_id=prev,
                        validators_hash=vh, next_validators_hash=vh,
                        proposer_address=vals.validators[0].address)
        bid = BlockID(header.hash(), PartSetHeader(1, b"\x5a" * 32))
        lanes = [CommitSig() for _ in range(BLS_VALS)]
        for i in signers:
            lanes[i] = CommitSig(BLOCK_ID_FLAG_AGGREGATE,
                                 vals.validators[i].address,
                                 header.time_ns + 1 + i % 997, b"")
        commit = Commit(h, 0, bid, lanes)
        commit.agg_signature = B.sign(total, commit.aggregate_sign_bytes(
            CHAIN_ID))
        commit.agg_signers = signer_bitmap(signers, BLS_VALS)
        blocks.append(LightBlock(header, commit, vals))
        prev = bid
    return vals, blocks, signers


def phase_bls_kernel(vals, signers, dev, reps, rec):
    """The G1 fold against its plain version on the card, exactly on the
    (3, 32) limbs: BLS_ROWS rows with empty, single, random, cancelling
    (a point and its negation) and doubled (one point in two rows)
    masks, BLS_RAGGED rows (the set's points, repeated past BLS_VALS)
    with random, full and last-row masks, then the main path's table
    (BLS_VALS rows, BLS_ABSENT_EVERY-th absent), also against the host
    library's sum of the selected points.  Times the main path's table
    and BLS_ROWS_TIMED rows.  Fills ``rec["aggregate_g1_masked"]``."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import bls12381 as B
    from cometbft_tpu_torch.crypto import blsagg
    from cometbft_tpu_torch.ops import blsg1 as G

    rng = np.random.default_rng(2029)
    tbl = blsagg.valset_table(vals)
    pts = [tbl.affine[i] for i in range(BLS_VALS)]

    def words_of(rows):
        limbs = np.stack([G.limbs_from_xy(p) for p in rows])
        return G.words_from_limbs(torch.from_numpy(limbs)).to(dev)

    mism, err, cases = 0, 0, {}

    def check(name, words, mask, want_inf=None):
        nonlocal mism, err
        m = torch.from_numpy(mask.astype(np.int32)).to(dev)
        k = G.g1_masked_sum(words, m)
        p = G._masked_sum_plain(words, m)
        bad = int(not torch.equal(k, p))
        err = max(err, int((k.long() - p.long()).abs().max()))
        xy = G.xy_from_projective(k.cpu().numpy())
        if want_inf is not None:
            bad += int((xy is None) != want_inf)
        mism += bad
        cases[name] = bad
        return xy, m

    for r in BLS_ROWS:
        rows = list(pts[:r])
        if r >= 3:
            rows[r - 2], rows[r - 1] = B.negate_affine(rows[0]), rows[1]
        words = words_of(rows)
        single = np.zeros(r, bool)
        single[r // 2] = True
        check(f"{r} empty", words, np.zeros(r, bool), True)
        check(f"{r} single", words, single, False)
        check(f"{r} random", words, rng.random(r) < 0.5)
        if r >= 3:
            cancel = np.zeros(r, bool)
            cancel[[0, r - 2]] = True
            check(f"{r} cancelling", words, cancel, True)
            double = np.zeros(r, bool)
            double[[1, r - 1]] = True
            check(f"{r} doubled", words, double, False)
    timed = {}
    for r in BLS_RAGGED:
        words = words_of([pts[i % BLS_VALS] for i in range(r)])
        last = np.zeros(r, bool)
        last[-1] = True
        _, m = check(f"{r} random", words, rng.random(r) < 0.5)
        check(f"{r} all", words, np.ones(r, bool), False)
        check(f"{r} last", words, last, False)
        if r == BLS_ROWS_TIMED:
            timed[r] = time_cuda(lambda: G.g1_masked_sum(words, m), reps)
    sel = np.zeros(BLS_VALS, bool)
    sel[signers] = True
    words = words_of(pts)
    xy, m = check(f"{BLS_VALS} main", words, sel, False)
    if xy != B.aggregate_affine([pts[i] for i in signers]):
        mism += 1
        cases[f"{BLS_VALS} main vs host"] = 1
    device, kernels_ms = device_ms_of(lambda: G.g1_masked_sum(words, m),
                                      "g1_", reps)
    rec["aggregate_g1_masked"].update(
        max_abs_err=err, mismatches=mism, sweep_mismatches=0, cases=cases,
        ms=time_cuda(lambda: G.g1_masked_sum(words, m), reps),
        device_ms=device, device_kernels_ms=kernels_ms, ms_by_rows=timed,
        plain_ms=time_host(lambda: G._masked_sum_plain(words, m)),
        shape=f"R={BLS_VALS} (padded to "
              f"{1 << (BLS_VALS - 1).bit_length()}), {len(signers)} "
              "selected",
        bound_inputs=(BLS_VALS, len(signers)))


def phase_bls(pool, dev, reps, rec):
    """BLS aggregate commits at BLS_VALS validators: the main path once
    (cold: the per-set table is built in the first call), with a wrong
    aggregate and a stray bitmap bit, then p50s, the host pairings' share
    and the fold's checks against its plain version."""
    import copy as _copy

    from cometbft_tpu_torch.crypto import bls12381 as B
    from cometbft_tpu_torch.crypto import blsagg
    from cometbft_tpu_torch.light import verify_adjacent
    from cometbft_tpu_torch.types import validation as V

    t0 = time.perf_counter()
    vals, (h1, h2), signers = bls_chain(pool, dev)
    fixture_s = time.perf_counter() - t0
    now = h2.header.time_ns + 10**9
    c2 = h2.commit
    wrong = _copy.deepcopy(c2)
    wrong.agg_signature = h1.commit.agg_signature
    stray = _copy.deepcopy(c2)
    bm = bytearray(c2.agg_signers)
    bm[0] |= 1                        # lane 0 is absent
    stray.agg_signers = bytes(bm)
    lanes0 = c2.aggregate_lanes()[0]
    calls = {
        "VerifyCommitLight": lambda: V.VerifyCommitLight(
            CHAIN_ID, vals, c2.block_id, c2.height, c2, device=dev),
        "VerifyCommit": lambda: V.VerifyCommit(
            CHAIN_ID, vals, c2.block_id, c2.height, c2, device=dev),
        "verify_adjacent": lambda: verify_adjacent(
            CHAIN_ID, h1, h2, TRUSTING_PERIOD_NS, now, device=dev),
    }
    cold = {}

    def main_path():
        from cometbft_tpu_torch.ops import _build

        per_call = {}
        for name, fn in calls.items():
            before = dict(_build.LAUNCHES)
            t = time.perf_counter()
            fn()
            cold[name] = (time.perf_counter() - t) * 1e3
            per_call[name] = {k: v - before.get(k, 0)
                              for k, v in _build.LAUNCHES.items()
                              if v - before.get(k, 0)}
        _expect_raise(lambda: V.VerifyCommitLight(
            CHAIN_ID, vals, wrong.block_id, wrong.height, wrong,
            device=dev), V.ErrInvalidSignature,
            lambda e: e.idx == lanes0)
        _expect_raise(lambda: V.VerifyCommitLight(
            CHAIN_ID, vals, stray.block_id, stray.height, stray,
            device=dev), V.ErrInvalidCommit)
        return per_call

    t0 = time.perf_counter()
    launches, per_call = _path_launches(main_path, (
        "aggregate_g1_masked", "merkle_tree_leaves"))
    first_s = time.perf_counter() - t0
    ed = {k: launches[k] for k in COMMIT_KERNELS if launches.get(k)}
    if ed:
        raise AssertionError(f"the all-BLS path launched Ed25519 kernels {ed}")
    if per_call["VerifyCommitLight"] != {"aggregate_g1_masked": 1}:
        raise AssertionError("VerifyCommitLight launched "
                             f"{per_call['VerifyCommitLight']}")
    wall = {name: time_host_spread(fn, reps) for name, fn in calls.items()}
    tbl = blsagg.valset_table(vals)
    agg_pk = B.aggregate_affine([tbl.affine[i] for i in signers])
    msg = c2.aggregate_sign_bytes(CHAIN_ID)
    pair = time_host_spread(
        lambda: B.verify_aggregate_affine(agg_pk, msg, c2.agg_signature),
        reps)
    prof = profile_call(calls["VerifyCommitLight"], max(1, reps // 4))
    phase_bls_kernel(vals, signers, dev, reps, rec)
    return launches, {
        "fixture_s": fixture_s, "first_path_s": first_s,
        "cold_ms": cold, "per_call_launches": per_call, "wall": wall,
        "pairings": pair, "pairing_share": pair["p50_ms"]
        / wall["VerifyCommitLight"]["p50_ms"],
        "profile_verify_commit_light": prof, "signers": len(signers)}


# ------------------------------------------------------------------- bounds

# ------------------------------------------------- phase 11: blocksync

class LoopPeer:
    """One side of a loopback connection: ``send`` hands the bytes to the
    other reactor's ``receive`` on the next turn of the loop."""

    def __init__(self, peer_id, remote, back):
        self.id = peer_id
        self._remote = remote          # the reactor that receives
        self._back = back              # the peer it sees us as

    def send(self, channel_id, msg):
        import asyncio

        asyncio.get_running_loop().call_soon(self._remote.receive,
                                             channel_id, self._back, msg)
        return True


class LoopSwitch:
    """The syncing reactor's switch, joined to serving reactors in the
    same event loop: ``peers``, ``broadcast`` and ``report_peer`` only
    (harness code, not ``p2p/switch.py``; the messages, the codec and the
    part sets are the port's).  ``on_drop`` runs after a peer is
    dropped."""

    def __init__(self, reactor, name="sync"):
        self.reactor = reactor
        self.name = name
        self.peers = {}
        self.reports = []
        self.on_drop = None
        reactor.set_switch(self)

    def connect(self, server, server_id):
        to_server = LoopPeer(server_id, server, None)
        to_server._back = LoopPeer(self.name, self.reactor, to_server)
        self.peers[server_id] = to_server
        server.add_peer(to_server._back)
        self.reactor.add_peer(to_server)

    def broadcast(self, channel_id, msg):
        for p in list(self.peers.values()):
            p.send(channel_id, msg)

    def report_peer(self, peer_id, event, detail=None, disconnect=False):
        self.reports.append((peer_id, event))
        if disconnect and peer_id in self.peers:
            self.reactor.remove_peer(self.peers.pop(peer_id), detail)
            if self.on_drop is not None:
                self.on_drop(peer_id)


class SourceChain:
    """Phase 11's source node: BS_VALS validators at power 10 (the keys
    of ``pool_keys``), heights 1..BS_HEIGHTS made by the port's
    ``BlockExecutor`` (``create_proposal_block``, then ``apply_block``,
    which validates each block and verifies its last commit on the
    card), each height's commit signed in the pool by every validator
    before the next height is proposed."""

    def __init__(self, pool, keys, dev, loop):
        from cometbft_tpu_torch.abci import Application, LocalClient
        from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
        from cometbft_tpu_torch.mempool import NopMempool
        from cometbft_tpu_torch.sm import BlockExecutor
        from cometbft_tpu_torch.storage import (BlockStore, MemDB, State,
                                                StateStore)
        from cometbft_tpu_torch.types.block_id import BlockID
        from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                     Commit, CommitSig,
                                                     ExtendedCommit,
                                                     ExtendedCommitSig)
        from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                      GenesisValidator)

        self.dev, self.loop = dev, loop
        pubs = [Ed25519PrivKey(k).pub_key() for k in keys]
        key_of = {pk.address(): k for pk, k in zip(pubs, keys)}
        self.doc = GenesisDoc(CHAIN_ID, genesis_time_ns=BS_T0, validators=[
            GenesisValidator(pk, 10) for pk in pubs])
        self.doc.validate_and_complete()
        self.bdb, sdb = MemDB(), MemDB()
        ex = BlockExecutor(StateStore(sdb), BlockStore(self.bdb),
                           LocalClient(Application()), NopMempool(),
                           device=dev)
        state = State.from_genesis(self.doc)
        ex.state_store.save(state)
        last_ext = ExtendedCommit(0, 0, BlockID(), [])
        self.sign_s = self.apply_s = self.propose_s = 0.0
        self.state_records = {}        # height -> the stored state record
        self.parts = {}
        for h in range(1, BS_HEIGHTS + 1):
            t0 = time.perf_counter()
            block, parts = loop.run_until_complete(ex.create_proposal_block(
                h, state, last_ext, state.validators.get_proposer().address,
                BS_T0 + h * 10**9))
            bid = BlockID(block.hash(), parts.header())
            commit = Commit(h, 0, bid, [
                CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                          block.header.time_ns + 1 + lane, b"")
                for lane, v in enumerate(state.validators.validators)])
            t1 = time.perf_counter()
            tasks = [(key_of[v.address],
                      [commit.vote_sign_bytes(CHAIN_ID, lane)])
                     for lane, v in enumerate(state.validators.validators)]
            sigs = pool.map(_sign_all, tasks, chunksize=max(
                1, len(tasks) // (4 * os.cpu_count())))
            for cs, (sig,) in zip(commit.signatures, sigs):
                cs.signature = sig
            t2 = time.perf_counter()
            ex.block_store.save_block(block, parts, commit)
            state = loop.run_until_complete(ex.apply_block(state, bid, block))
            self.state_records[h] = sdb.get(b"S/state")
            self.parts[h] = parts
            last_ext = ExtendedCommit(h, 0, bid, [
                ExtendedCommitSig(cs) for cs in commit.signatures])
            self.propose_s += t1 - t0
            self.sign_s += t2 - t1
            self.apply_s += time.perf_counter() - t2
        self.state = state
        self.store = ex.block_store

    def liar_db(self) -> dict:
        """The source's records with block BS_BAD_AT's last commit (the
        vouch for BS_BAD_AT - 1) carrying one flipped signature bit."""
        from cometbft_tpu_torch.storage.db import height_key
        from cometbft_tpu_torch.types import codec

        blk = self.store.load_block(BS_BAD_AT)
        sig = bytearray(blk.last_commit.signatures[7].signature)
        sig[9] ^= 0x10
        blk.last_commit.signatures[7].signature = bytes(sig)
        db = dict(self.bdb._data)
        db[height_key(b"B/", BS_BAD_AT)] = codec.pack(blk)
        return db

    def server(self, records: dict, name: str):
        from cometbft_tpu_torch.blocksync import BlocksyncReactor
        from cometbft_tpu_torch.storage import BlockStore, MemDB

        db = MemDB()
        db._data.update(records)
        return BlocksyncReactor(None, BlockStore(db), self.state,
                                device=self.dev, name=name)

    def catch_up(self, liar: bool = False, stages: dict | None = None
                 ) -> dict:
        """A new node with empty stores blocksyncs from genesis until
        ``synced``: from the honest server, or from the liar first, the
        honest server connected when the liar is dropped.  With
        ``stages`` the host stages are timed into it
        (:func:`stage_timers`)."""
        import asyncio

        from cometbft_tpu_torch.abci import Application, LocalClient
        from cometbft_tpu_torch.blocksync import BlocksyncReactor
        from cometbft_tpu_torch.mempool import NopMempool
        from cometbft_tpu_torch.sm import BlockExecutor
        from cometbft_tpu_torch.storage import (BlockStore, MemDB, State,
                                                StateStore)

        async def main():
            ex = BlockExecutor(StateStore(MemDB()), BlockStore(MemDB()),
                               LocalClient(Application()), NopMempool(),
                               device=self.dev)
            state = State.from_genesis(self.doc)
            ex.state_store.save(state)
            applied = []
            inner = ex.apply_block

            async def apply_block(st, bid, block, **kw):
                applied.append(block.header.height)
                return await inner(st, bid, block, **kw)

            ex.apply_block = apply_block
            sync = BlocksyncReactor(ex, ex.block_store, state,
                                    fast_sync=True, device=self.dev,
                                    no_peers_grace=30.0)
            sw = LoopSwitch(sync)
            honest = self.server(self.bdb._data, "honest")
            liar_srv = self.server(self.liar_db(), "liar") if liar else None
            timers = (stage_timers(stages, ex) if stages is not None
                      else contextlib.nullcontext())
            with timers:
                t0 = time.perf_counter()
                await sync.start()
                if liar:
                    sw.on_drop = lambda pid: sw.connect(honest, "honest")
                    sw.connect(liar_srv, "liar")
                else:
                    sw.connect(honest, "honest")
                await asyncio.wait_for(sync.synced.wait(), 120)
                wall = time.perf_counter() - t0
                await sync.stop()
            return {"wall_s": wall, "ex": ex, "state": sync.state,
                    "reports": sw.reports, "applied": applied}

        return self.loop.run_until_complete(main())

    def check(self, out: dict) -> None:
        """The synced node holds heights 1..BS_HEIGHTS - 1 (the tip is
        left to consensus): every block, meta and commit byte for byte
        the source's, and the source's state at that height."""
        from cometbft_tpu_torch.storage.db import height_key

        last = BS_HEIGHTS - 1
        got = out["ex"].block_store.db._data
        src = self.bdb._data
        want_keys = {height_key(p, h) for p in (b"B/", b"M/")
                     for h in range(1, last + 1)}
        want_keys |= {height_key(b"C/", h) for h in range(1, last)}
        bad = [k for k in want_keys if got.get(k) != src.get(k)]
        extra = set(got) - want_keys - {b"SC", b"BSJ"}
        if bad or extra or got[b"SC"] != src[height_key(b"C/", last)]:
            raise AssertionError(f"phase 11: synced store differs at "
                                 f"{sorted(bad)[:4]}, extra {extra}")
        st = out["state"]
        rec = out["ex"].state_store.db.get(b"S/state")
        if st.last_block_height != last or rec != self.state_records[last]:
            raise AssertionError(f"phase 11: synced state at "
                                 f"{st.last_block_height} differs from the "
                                 "source's")

    def items(self) -> list:
        """The commits of heights 1..BS_HEIGHTS - 1 as the window verifies
        them: (block id, height, the next block's last commit)."""
        from cometbft_tpu_torch.types.block_id import BlockID

        out = []
        for h in range(1, BS_HEIGHTS):
            blk, nxt = self.store.load_block(h), self.store.load_block(h + 1)
            out.append((BlockID(blk.hash(), self.parts[h].header()), h,
                        nxt.last_commit))
        return out


@contextlib.contextmanager
def stage_timers(stages: dict, ex):
    """Time the host stages of a catch-up by wrapping the names the
    reactor calls (module globals of ``blocksync/reactor.py``, the
    executor's ``apply_block``, the store's ``save_block``); each call's
    ms goes to ``stages[name]``.  The serve pack is the ``codec.pack``
    of the event loop's thread, the part-set pack the worker's."""
    import threading
    import types as _types

    from cometbft_tpu_torch.blocksync import reactor as R
    from cometbft_tpu_torch.types.header import Block

    main = threading.main_thread()

    def timed(name, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stages.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
        return wrap

    saved = {n: getattr(R, n) for n in ("codec", "PartSet", "validate_block",
                                        "verify_commits_light_batched")}
    block_hash = Block.hash

    def hash_(self):
        if threading.current_thread() is main:
            return block_hash(self)
        return timed("Block.hash", block_hash)(self)

    def verify(chain_id, vals, items, **kw):
        stages.setdefault("window blocks", []).append(len(items))
        return timed("window verify", saved["verify_commits_light_batched"])(
            chain_id, vals, items, **kw)

    codec = saved["codec"]

    def pack(obj):
        name = ("serve pack" if threading.current_thread() is main
                else "part-set pack")
        return timed(name, codec.pack)(obj)

    R.codec = _types.SimpleNamespace(
        pack=pack, unpack=timed("receive unpack", codec.unpack))
    R.PartSet = _types.SimpleNamespace(
        from_data=timed("PartSet.from_data", saved["PartSet"].from_data))
    R.validate_block = timed("validate_block", saved["validate_block"])
    R.verify_commits_light_batched = verify
    Block.hash = hash_
    inner_apply, inner_save = ex.apply_block, ex.block_store.save_block

    async def apply_block(*a, **k):
        t0 = time.perf_counter()
        try:
            return await inner_apply(*a, **k)
        finally:
            stages.setdefault("apply_block", []).append(
                (time.perf_counter() - t0) * 1e3)

    ex.apply_block = apply_block
    ex.block_store.save_block = timed("save_block", inner_save)
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(R, n, v)
        Block.hash = block_hash
        ex.apply_block = inner_apply
        del ex.block_store.save_block


def _window_verdicts_ms(prof) -> list:
    """Device ms of each RLC verdict in a trace, in time order: the
    launches from one lane stage to the next summed."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name.removeprefix("void ").startswith("rlc_")),
                 key=lambda e: e.time_range.start)
    out = []
    for e in evs:
        if e.name.removeprefix("void ").startswith("rlc_lane_kernel") \
                or not out:
            out.append(0.0)
        out[-1] += e.time_range.elapsed_us() / 1e3
    return out


def phase_blocksync(pool, keys, dev, reps):
    """Phase 11: blocksync catch-up at BS_VALS validators (BASELINE
    configs[3]'s width) over a loopback switch, on the card:

    (a) a new node syncs BS_HEIGHTS - 1 heights from the source's
        serving reactor, windows of up to ``BATCH_WINDOW`` commits a
        device call; stores and state checked against the source;
        BS_RUNS timed runs, the last with the host stages timed
        (:func:`stage_timers`), then one traced with ``torch.profiler``;
    (b) the liar serves block BS_BAD_AT with one flipped signature in its
        last commit: the node applies 1..BS_BAD_AT - 2, reports the liar
        (``bad_block``), fetches BS_BAD_AT - 1 and BS_BAD_AT again from
        the honest server (connected when the liar is dropped) and ends
        with the source's store; the RLC verdict rejects the window and
        the per-lane ladder (K5b) names the lane;
    (c) the same BS_HEIGHTS - 1 commits verified in windows of
        ``BATCH_WINDOW`` through ``verify_commits_light_batched`` and one
        by one through ``VerifyCommitLight`` (the reference's way,
        ``reactor.go:495``), p50 of ``reps`` calls each.

    The counters are zeroed just before the first run of (a) and read
    just after (b): the main path."""
    import asyncio

    from cometbft_tpu_torch.blocksync import BATCH_WINDOW
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.types.validation import (
        VerifyCommitLight, verify_commits_light_batched)

    loop = asyncio.new_event_loop()
    t0 = time.perf_counter()
    src = SourceChain(pool, keys[:BS_VALS], dev, loop)
    fixture_s = time.perf_counter() - t0
    print(f"blocksync fixture: {BS_HEIGHTS} heights of {BS_VALS} in "
          f"{fixture_s:.1f} s (signing {src.sign_s:.1f} s over "
          f"{os.cpu_count()} workers, proposals {src.propose_s:.1f} s, "
          f"apply {src.apply_s:.1f} s)")
    runs, per_run = [], {}

    def main_path():
        before = dict(cbatch.DISPATCHES)
        a = src.catch_up()
        src.check(a)
        runs.append(a["wall_s"])
        per_run["a"] = dict(_build.LAUNCHES)
        per_run["a_dispatches"] = {
            k: v - before.get(k, 0) for k, v in cbatch.DISPATCHES.items()
            if v - before.get(k, 0)}
        b = src.catch_up(liar=True)
        src.check(b)
        want = list(range(1, BS_HEIGHTS))
        if b["reports"] != [("liar", "bad_block")] or b["applied"] != want:
            raise AssertionError(f"phase 11 (b): reports {b['reports']}, "
                                 f"applied {b['applied'][:45]}...")
        per_run["b"] = {k: v - per_run["a"].get(k, 0)
                        for k, v in _build.LAUNCHES.items()
                        if v - per_run["a"].get(k, 0)}
        if not per_run["b"].get("ed25519_verify_gather"):
            raise AssertionError("phase 11 (b): the per-lane ladder (K5b) "
                                 "did not launch")
        return b

    t0 = time.perf_counter()
    launches, b = _path_launches(main_path, (
        "ed25519_tables", "ed25519_rlc_gather", "ed25519_verify_gather"))
    main_s = time.perf_counter() - t0
    stages: dict = {}
    for run in range(BS_RUNS - 1):
        out = src.catch_up(stages=stages if run == BS_RUNS - 2 else None)
        src.check(out)
        runs.append(out["wall_s"])
    items = src.items()
    vals = src.state.validators
    prof = profile_call(lambda: src.check(src.catch_up()), top=None,
                        verdicts=True, warm=lambda: (
                            verify_commits_light_batched(
                                CHAIN_ID, vals, items[:2], device=dev)))
    windows = [items[i:i + BATCH_WINDOW]
               for i in range(0, len(items), BATCH_WINDOW)]

    def batched():
        for w in windows:
            verify_commits_light_batched(CHAIN_ID, vals, w, device=dev)

    def one_by_one():
        for bid, h, c in items:
            VerifyCommitLight(CHAIN_ID, vals, bid, h, c, device=dev)

    batched()
    one_by_one()
    cmp = {"batched": time_host_spread(batched, reps),
           "one_by_one": time_host_spread(one_by_one, reps)}
    loop.close()
    med = {k: statistics.median(v) for k, v in stages.items()
           if k != "window blocks"}
    return launches, {
        "fixture_s": fixture_s, "sign_s": src.sign_s,
        "propose_s": src.propose_s, "apply_s": src.apply_s,
        "main_path_s": main_s, "wall_s": runs,
        "per_run_launches": per_run, "liar": b["reports"],
        "liar_wall_s": b["wall_s"],
        "profile": prof,
        "stages_ms": med, "stage_calls": {k: len(v)
                                          for k, v in stages.items()},
        "window_blocks": stages.get("window blocks"),
        "verify_ms": cmp, "windows": len(windows)}


def report_blocksync(bs, launches, card) -> None:
    """Phase 11's lines."""
    walls = sorted(bs["wall_s"])
    p50 = statistics.median(walls)
    blocks = BS_HEIGHTS - 1
    lanes = blocks * (2 * BS_VALS // 3 + 1)
    print(f"blocksync (phase 11): fixture {bs['fixture_s']:.1f} s (signing "
          f"{bs['sign_s']:.1f} s), main path {bs['main_path_s']:.1f} s, "
          f"phase {bs.get('phase_s', 0.0):.1f} s; launches {launches}")
    print(f"blocksync (a) catch-up of {blocks} blocks of {BS_VALS}: wall p50 "
          f"{p50:.3f} s (min {walls[0]:.3f}, max {walls[-1]:.3f}, "
          f"{len(walls)} runs), {blocks / p50:.1f} blocks/s, "
          f"{blocks * BS_VALS / p50:.0f} sig-verifies/s ({blocks * BS_VALS} "
          f"vouching signatures; {lanes} lanes verified, "
          f"{lanes / p50:.0f}/s)  [{card}]")
    print(f"blocksync launches by run: {bs['per_run_launches']}")
    prof = bs["profile"]
    print(f"profile blocksync (a): wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']} ms (busy {prof['device_busy_share']}), "
          f"verdicts device ms {prof.get('verdicts_ms')}, kernels "
          f"{prof['kernels_ms']}  [{card}]")
    print(f"blocksync host stages, median ms a call ({bs['stage_calls']} "
          f"calls; windows of {bs['window_blocks']} blocks): "
          f"{bs['stages_ms']}  [{card}]")
    print(f"blocksync (b) lying peer: wall {bs['liar_wall_s']:.3f} s, "
          f"reports {bs['liar']}; launches "
          f"{bs['per_run_launches'].get('b')}  [{card}]")
    v = bs["verify_ms"]
    print(f"blocksync (c) {blocks} commits of {BS_VALS}: batched in "
          f"{bs['windows']} windows {_spread(v['batched'])}; one by one "
          f"(VerifyCommitLight) {_spread(v['one_by_one'])}  [{card}]")


# ------------------------------------------------- phase 12: consensus

CS_SMALL = 4                     # (a), (c): validators
CS_SMALL_HEIGHT = 6              # (a): a full proposer rotation and more
CS_VALS = 150                    # (b): BASELINE configs[1]'s commit width
CS_HEIGHT = 3                    # (b): block 3 carries a 150-lane commit
CS_TIMEOUT_S = 240               # a part's wait for its heights


def _oracle_counter():
    """Wrap the pure-Python ZIP-215 oracle so that its calls are counted
    (every port path must verify on the card: the count must stay 0);
    returns (counter, restore)."""
    from cometbft_tpu_torch.crypto import _ed25519_py

    orig = _ed25519_py.verify_zip215
    calls = [0]

    def counting(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    _ed25519_py.verify_zip215 = counting

    def restore():
        _ed25519_py.verify_zip215 = orig

    return calls, restore


def _commit_round(node, h: int):
    """The round height ``h`` committed in at ``node``."""
    c = node.block_store.load_block_commit(h)
    if c is None:
        seen = node.block_store.load_seen_commit()
        c = seen if seen is not None and seen.height == h else None
    return None if c is None else c.round


def _check_agreement(net, top: int) -> None:
    """Every node stores the same block hash at heights 1..top."""
    for h in range(1, top + 1):
        hs = {n.block_store.load_block(h).hash() for n in net.nodes}
        if len(hs) != 1:
            raise AssertionError(f"phase 12: fork at height {h}: "
                                 f"{len(hs)} hashes")


def _oracle_recheck(node, top: int) -> int:
    """Every signature of ``node``'s stored commits of heights 1..top,
    re-verified by the pure-Python oracle; returns the count."""
    from cometbft_tpu_torch.crypto import _ed25519_py

    checked = 0
    for h in range(1, top + 1):
        # the harness never stores its genesis state: height 1's set is
        # the genesis set
        vals = node.state_store.load_validators(h) or node.state.validators
        c = node.block_store.load_block_commit(h)
        if c is None:
            c = node.block_store.load_seen_commit()
        if c is None or c.height != h:
            raise AssertionError(f"phase 12: no stored commit at {h}")
        for i, cs in enumerate(c.signatures):
            if cs.is_absent():
                continue
            pub = vals.get_by_index(i).pub_key.bytes()
            if not _ed25519_py.verify_zip215(
                    pub, c.vote_sign_bytes(CHAIN_ID, i), cs.signature):
                raise AssertionError(f"phase 12: stored commit {h} lane {i} "
                                     "fails the oracle")
            checked += 1
    return checked


async def _watch_heights(net, top: int, t0: float, seen: dict) -> None:
    """Poll every node until all have committed ``top``: for each height
    the seconds (since ``t0``) at which the first and the last node
    committed it, and the highest round any node reached in it."""
    import asyncio

    first, last, rounds = (seen.setdefault(k, {})
                           for k in ("first", "last", "max_round"))
    while True:
        hs = [n.block_store.height() for n in net.nodes]
        now = time.perf_counter() - t0
        for n, h in zip(net.nodes, hs):
            first.setdefault(h, now)
            r = n.consensus.rs
            rounds[r.height] = max(rounds.get(r.height, 0), r.round)
        for h in range(1, min(hs) + 1):
            last.setdefault(h, now)
        if min(hs) >= top:
            return
        await asyncio.sleep(0.005)


def phase_consensus(dev):
    """Phase 12: consensus in one process on the card, every signature
    check through the verification scheduler on ``dev``:

    (a) CS_SMALL validators, one tx injected a node, to height
        CS_SMALL_HEIGHT: every node stores the same block hash at every
        height, every tx is committed and held by every node's kvstore;
    (b) CS_VALS validators at power 10 to height CS_HEIGHT: block
        CS_HEIGHT's last commit carries every validator's lane; the wall
        and the rounds of each height, the scheduler's tallies, and the
        device busy share of heights 2..CS_HEIGHT (``profile_call``);
    (c) WAL crash recovery at CS_SMALL validators: node 0 stopped and
        isolated, the others pass its height, node 0 restarts from its
        WAL and stores, and every node agrees two heights later.

    The launch counters are zeroed just before and read just after the
    three parts (the main path), the pure-Python oracle must not be
    called in them, and afterwards every stored commit of (a) and (b) is
    re-checked by it."""
    import asyncio
    import tempfile

    from cometbft_tpu_torch.config import ConsensusConfig, MS
    from cometbft_tpu_torch.config import test_consensus_config as tcc
    from cometbft_tpu_torch.consensus import WAL, ConsensusState
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import scheduler as vsched
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.testing import make_inproc_network

    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    out: dict = {}
    keep: dict = {}

    async def part_a():
        net = await make_inproc_network(CS_SMALL, chain_id=CHAIN_ID,
                                        device=dev)
        try:
            t0 = time.perf_counter()
            await net.start()
            for i, node in enumerate(net.nodes):
                await node.mempool.check_tx(b"k%d=v%d" % (i, i))
            await net.wait_for_height(CS_SMALL_HEIGHT, timeout=CS_TIMEOUT_S)
            wall = time.perf_counter() - t0
            stats = vsched.get_scheduler().stats()
        finally:
            await net.stop()
        _check_agreement(net, CS_SMALL_HEIGHT)
        want = {b"k%d=v%d" % (i, i) for i in range(CS_SMALL)}
        got = {bytes(tx) for h in range(1, CS_SMALL_HEIGHT + 1)
               for tx in net.nodes[0].block_store.load_block(h).data.txs}
        if not want <= got:
            raise AssertionError(f"phase 12 (a): txs {want - got} never "
                                 "committed")
        for n in net.nodes:
            for i in range(CS_SMALL):
                if n.app.state.get(b"k%d" % i) != b"v%d" % i:
                    raise AssertionError(f"phase 12 (a): {n.name}'s kvstore "
                                         f"lacks k{i}")
        keep["a"] = net
        return {"wall_s": wall, "heights": CS_SMALL_HEIGHT,
                "rounds": [_commit_round(net.nodes[0], h)
                           for h in range(1, CS_SMALL_HEIGHT + 1)],
                "scheduler": stats}

    def part_b():
        # the node's default propose, prevote and precommit timeouts (3,
        # 1, 1 s): 150 nodes share one interpreter, so a height's
        # messages take far longer to go round than the test timeouts
        cfg = ConsensusConfig(timeout_commit=100 * MS)
        t0 = time.perf_counter()
        net = run(make_inproc_network(CS_VALS, chain_id=CHAIN_ID,
                                      config=cfg, device=dev))
        setup = time.perf_counter() - t0
        sched = vsched.get_scheduler()
        seen: dict = {}
        try:
            t0 = time.perf_counter()
            run(net.start())
            run(asyncio.wait_for(_watch_heights(net, 1, t0, seen),
                                 CS_TIMEOUT_S))
            s1, d1 = sched.stats(), dict(net.delivered)

            def rest():
                run(asyncio.wait_for(_watch_heights(net, CS_HEIGHT, t0,
                                                    seen), CS_TIMEOUT_S))

            prof = profile_call(rest, top=6, warm=lambda: None)
            stats = sched.stats()
        finally:
            run(net.stop())
        marks = seen["last"]
        top = CS_HEIGHT
        _check_agreement(net, top)
        last = net.nodes[0].block_store.load_block(top).last_commit
        n_commit = sum(cs.is_commit() for cs in last.signatures)
        if len(last.signatures) != CS_VALS or n_commit * 3 <= 2 * CS_VALS:
            raise AssertionError(f"phase 12 (b): block {top}'s last commit "
                                 f"has {n_commit} of {len(last.signatures)}"
                                 " lanes")
        keep["b"] = net
        return {"setup_s": setup, "heights_s": marks,
                "per_height_s": [marks[h] - marks[h - 1]
                                 for h in range(2, top + 1)],
                "rounds": [_commit_round(net.nodes[0], h)
                           for h in range(1, top + 1)],
                "first_commit_s": seen["first"],
                "max_round": seen["max_round"],
                "last_commit_lanes": n_commit, "scheduler_h1": s1,
                "delivered_h1": d1, "delivered": dict(net.delivered),
                "scheduler": stats, "profile": prof}

    async def part_c(wal_dir):
        net = await make_inproc_network(CS_SMALL, chain_id=CHAIN_ID,
                                        wal_dir=wal_dir, device=dev)
        try:
            t0 = time.perf_counter()
            await net.start()
            await net.wait_for_height(2, timeout=CS_TIMEOUT_S)
            victim = net.nodes[0]
            await victim.consensus.stop()
            net.isolate(victim.name)
            stopped_at = victim.block_store.height()
            await net.wait_for_height(stopped_at + 1, timeout=CS_TIMEOUT_S,
                                      nodes=net.nodes[1:])
            cs2 = ConsensusState(
                tcc(), victim.state_store.load(),
                victim.consensus.block_exec, victim.block_store,
                wal=WAL(victim.wal_path), priv_validator=victim.pv,
                event_bus=victim.event_bus, name="node0r")
            victim.consensus = cs2
            net._wire(victim)
            net.heal(victim.name)
            await cs2.start()
            target = max(n.block_store.height() for n in net.nodes) + 2
            await net.wait_for_height(target, timeout=CS_TIMEOUT_S)
            wall = time.perf_counter() - t0
        finally:
            await net.stop()
        _check_agreement(net, target)
        return {"wall_s": wall, "stopped_at": stopped_at, "target": target}

    calls, restore = _oracle_counter()
    before = dict(cbatch.DISPATCHES)
    t_ph = time.perf_counter()

    def main_path():
        out["a"] = run(part_a())
        out["b"] = part_b()
        with tempfile.TemporaryDirectory() as d:
            out["c"] = run(part_c(d))
        return out

    try:
        launches, _ = _path_launches(main_path, ("ed25519_tables",
                                                 "ed25519_verify_gather"))
    finally:
        restore()
    out["main_path_s"] = time.perf_counter() - t_ph
    out["oracle_calls"] = calls[0]
    if calls[0]:
        raise AssertionError(f"phase 12: the host oracle was called "
                             f"{calls[0]} times on the path")
    out["dispatches"] = {k: v - before.get(k, 0)
                         for k, v in cbatch.DISPATCHES.items()
                         if v - before.get(k, 0)}
    t0 = time.perf_counter()
    out["oracle_rechecked"] = {
        "a": _oracle_recheck(keep["a"].nodes[0], CS_SMALL_HEIGHT),
        "b": _oracle_recheck(keep["b"].nodes[0], CS_HEIGHT)}
    out["recheck_s"] = time.perf_counter() - t0
    # one one-lane device check alone (the scheduler's sync and uncached
    # route), as a reference for the per-height counts above
    priv = Ed25519PrivKey.from_secret(b"chip-smoke-0")
    msg = b"one lane" * 16
    sig = priv.sign(msg)

    def one_lane():
        bv = cbatch.create_batch_verifier(dev)
        bv.add(priv.pub_key(), msg, sig)
        if not bv.verify()[0]:
            raise AssertionError("phase 12: one-lane check rejected")

    out["one_lane"] = time_host_spread(one_lane, 20)
    loop.close()
    return launches, out


def report_consensus(cs, launches, card) -> None:
    """Phase 12's lines."""
    a, b, c = cs["a"], cs["b"], cs["c"]
    print(f"consensus (phase 12): main path {cs['main_path_s']:.1f} s; "
          f"launches {launches}; dispatches {cs['dispatches']}; oracle "
          f"calls on the path {cs['oracle_calls']}, stored lanes "
          f"re-checked by it afterwards {cs['oracle_rechecked']} in "
          f"{cs['recheck_s']:.1f} s")
    print(f"consensus (a) {CS_SMALL} validators to height {a['heights']}: "
          f"{a['wall_s']:.2f} s, rounds {a['rounds']}; scheduler "
          f"{a['scheduler']}  [{card}]")
    per = b["per_height_s"]
    print(f"consensus (b) {CS_VALS} validators to height {CS_HEIGHT}: setup "
          f"{b['setup_s']:.1f} s, height 1 at {b['heights_s'][1]:.2f} s, "
          f"then {[round(x, 3) for x in per]} s a height; rounds "
          f"{b['rounds']}; block {CS_HEIGHT}'s last commit "
          f"{b['last_commit_lanes']} lanes  [{card}]")
    st = b["scheduler"]
    spans = {h: (round(b["first_commit_s"][h], 3), round(t, 3))
             for h, t in b["heights_s"].items() if h <= CS_HEIGHT}
    print(f"consensus (b) per height, first and last node's commit (s from "
          f"start): {spans}; highest round a node reached: "
          f"{b['max_round']}; messages delivered {b['delivered']} (by "
          f"height 1: {b['delivered_h1']})  [{card}]")
    print(f"consensus (b) scheduler: flushes {st['batches']}, lanes a flush "
          f"{st['mean_batch_lanes']:.2f} (max {st['max_batch_lanes']}), "
          f"cache hits {st['cache_hits']}, misses {st['cache_misses']}, "
          f"one-lane device checks {st['single_checks']} (at height 1: "
          f"{b['scheduler_h1']['single_checks']})  [{card}]")
    prof = b["profile"]
    print(f"profile consensus (b) heights 2-{CS_HEIGHT}: wall "
          f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']} ms (busy "
          f"{prof['device_busy_share']}), kernels {prof['kernels_ms']}  "
          f"[{card}]")
    print(f"consensus (c) WAL recovery at {CS_SMALL}: node 0 stopped at "
          f"height {c['stopped_at']}, all agree at {c['target']} in "
          f"{c['wall_s']:.2f} s  [{card}]")
    print(f"one-lane device check (BatchVerifier, 1 lane): "
          f"{_spread(cs['one_lane'])}  [{card}]")


def op_counts():
    """Field multiplications of each group operation, counted by running
    the plain versions on one lane on the CPU."""
    import torch

    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import fe, group

    enc = torch.tensor([list(ref.pt_compress(ref.BASE))], dtype=torch.uint8)
    counts = {}

    def count(name, fn):
        n0 = fe.MUL_COUNT.n
        out = fn()
        counts[name] = fe.MUL_COUNT.n - n0
        return out

    p, _ = count("decompress", lambda: group.decompress_zip215(enc))
    count("table", lambda: ed._build_neg_table(p))
    c = count("cache", lambda: group.cache(p))
    count("dbl", lambda: group.dbl(p))
    count("add_cached", lambda: group.add_cached(p, c))
    count("add_niels", lambda: group.add_niels(
        p, group.Niels(c.ypx, c.ymx, c.t2d)))
    count("add_cc", lambda: group.add_cc(c, c))
    count("is_identity", lambda: group.is_identity(p))
    return counts


def bounds(c, b_verify, b_rlc, n_tab, nb, distinct_rows, rate_ops):
    """Least time per kernel call on this card at the main path's shapes:
    the larger of bytes moved / HBM rate and counted integer operations /
    the integer rate."""
    ladder = 64 * (4 * c["dbl"] + c["add_niels"] + c["add_cached"])
    tail = c["cache"] + c["add_cached"] + 3 * c["dbl"]
    sha_ops = nb * SHA512_OPS_PER_BLOCK + SC_REDUCE_PRODUCTS
    lane_in = 32 + 32 + nb * 128 + 4 + 4          # rb, sb, blocks, active, idx
    row = 16 * 4 * 10 * 4 + 1                      # a table row and its ok
    work = {
        "ed25519_tables": (
            n_tab * (c["decompress"] + c["table"]) * FE_MUL_PRODUCTS,
            n_tab * (32 + row)),
        "sha512_scalar": (b_rlc * sha_ops,
                          b_rlc * (nb * 128 + 4 + 32)),
        "ed25519_verify_gather": (
            b_verify * ((c["decompress"] + ladder + tail + c["is_identity"])
                        * FE_MUL_PRODUCTS + sha_ops),
            b_verify * (lane_in + 1) + distinct_rows["verify"] * row),
        "ed25519_rlc_gather": (
            b_rlc * ((c["decompress"] + c["table"]) * FE_MUL_PRODUCTS
                     + sha_ops + 2 * (MUL_MOD_L_PRODUCTS + SC_REDUCE_PRODUCTS))
            + 96 * (b_rlc - 1) * c["add_cc"] * FE_MUL_PRODUCTS
            + (ladder + 32 * c["add_cached"] + 3 * c["dbl"]
               + c["is_identity"]) * FE_MUL_PRODUCTS,
            b_rlc * (lane_in + 16) + distinct_rows["rlc"] * row + 1),
    }
    out = {}
    for k, (ops, nbytes) in work.items():
        t_ops = ops / rate_ops * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[k] = (max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)
    return out


def _bound(ops, nbytes, rate_ops):
    """(least ms, what binds it, ops, bytes) of ``ops`` integer operations
    over the integer rate against ``nbytes`` over the HBM rate."""
    t_ops = ops / rate_ops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, nbytes)


def mesh_bounds(c, b, d, nb, rate_ops):
    """Least time of K7 at the mesh phase's shapes: one shard's stages 1-4
    (K6a's, with h, over its ceil(b/d) lanes and their table rows), the
    d shards of one card in one call, the combine (96 (d - 1) add_cc and
    the ladder over d shards' outputs), and the whole verdict: K6a's
    stages over the b lanes plus the combine."""
    ladder = (64 * (4 * c["dbl"] + c["add_niels"] + c["add_cached"])
              + 32 * c["add_cached"] + 3 * c["dbl"] + c["is_identity"])
    sha_ops = nb * SHA512_OPS_PER_BLOCK + SC_REDUCE_PRODUCTS
    lane_bytes = 32 + 32 + nb * 128 + 4 + 4 + 16 + 16 * 4 * 10 * 4 + 1
    part = 96 * 40 * 4 + 32 + 1         # a shard's sums, zs and ok

    def stages(n):
        return (n * ((c["decompress"] + c["table"]) * FE_MUL_PRODUCTS
                     + sha_ops + 2 * (MUL_MOD_L_PRODUCTS + SC_REDUCE_PRODUCTS))
                + 96 * max(n - 1, 0) * c["add_cc"] * FE_MUL_PRODUCTS)

    s = -(-b // d)
    combine = (96 * (d - 1) * c["add_cc"] + ladder) * FE_MUL_PRODUCTS
    return {"ed25519_rlc_sums": _bound(stages(s), s * lane_bytes + part,
                                       rate_ops),
            # all d shards of one card in one call
            "sums_card": _bound(d * stages(s), b * lane_bytes + d * part,
                                rate_ops),
            "ed25519_rlc_combine": _bound(combine, d * part + 1, rate_ops),
            "rlc_sharded": _bound(stages(b) + combine, b * lane_bytes + 1,
                                  rate_ops)}


def merkle_bounds(rec, rate_ops):
    """Least time of the merkle kernels at the phase's main shapes:
    counted SHA-256 operations over the integer rate against bytes (each
    input read once, each output written once) over the HBM rate.  The
    fused tree call counts the leaves' work and the tree's: its leaf
    blocks and active counts read once, every level (``tree_rows``) of
    digest words written once."""
    from cometbft_tpu_torch.ops import sha256 as S

    blocks, b, nb = rec["sha256_leaves"]["bound_inputs"]
    (n,) = rec["merkle_level"]["bound_inputs"]
    (t,) = rec["merkle_tree"]["bound_inputs"]
    f_blocks, f, f_nb = rec["merkle_tree_leaves"]["bound_inputs"]
    work = {"sha256_leaves": (blocks * SHA256_OPS_PER_BLOCK,
                              b * (nb * 64 + 4) + b * 32),
            "merkle_level": ((n // 2) * 2 * SHA256_OPS_PER_BLOCK,
                             n * 32 + (n + 1) // 2 * 32),
            # a tree of t leaves has t - 1 inner nodes, two blocks each
            "merkle_tree": ((t - 1) * 2 * SHA256_OPS_PER_BLOCK,
                            S.tree_rows(t) * 32),
            "merkle_tree_leaves": (
                (f_blocks + (f - 1) * 2) * SHA256_OPS_PER_BLOCK,
                f * (f_nb * 64 + 4) + S.tree_rows(f) * 32)}
    out = {}
    for k, (ops, nbytes) in work.items():
        t_ops = ops / rate_ops * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[k] = (max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)
    return out


def bls_bound(rec, rate_ops):
    """Least time of the fold at the main path's shape: every level's
    additions (n2 - 1 in all) and the conversions (two per selected row
    in, three out) at the first version's integer counts
    (``G1_INT_PER_ADD``, ``G1_INT_PER_MUL``) over the integer rate,
    against the table, mask and output bytes over the HBM rate."""
    r, selected = rec["aggregate_g1_masked"]["bound_inputs"]
    n2 = 1 << max(0, (r - 1).bit_length())
    ops = ((n2 - 1) * G1_INT_PER_ADD
           + (2 * selected + 3) * G1_INT_PER_MUL)
    nbytes = r * 2 * 12 * 4 + r * 4 + 3 * 32 * 4
    t_ops = ops / rate_ops * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"aggregate_g1_masked": (
        max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
        ops, nbytes)}


# --------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--record", default=None,
                    help="also write the full record as JSON to this path")
    ap.add_argument("--mesh-cards", action="store_true",
                    help="run only the build and phase 9 over the first "
                    f"{MESH_SHARDS} visible cards, one shard each (needs "
                    "two or more)")
    ap.add_argument("--blocksync", action="store_true",
                    help="run only the build, the kernel sweep and phase 11")
    ap.add_argument("--consensus", action="store_true",
                    help="run only the build, the kernel sweep and phase 12")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cometbft_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    clock = _run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                  "--format=csv,noheader,nounits"]).splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"nvcc: {_run([_build._nvcc(), '--version']).splitlines()[-1]}")
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(clock)
    rate_ops = props.multi_processor_count * INT_LANES_PER_SM * sm_mhz * 1e6
    print(f"device: {props.name}, {props.multi_processor_count} SMs, max SM "
          f"clock {sm_mhz:.0f} MHz -> {rate_ops / 1e12:.2f} T int32 ops/s")

    t0 = time.perf_counter()
    for k in _build.KERNELS:
        _build.load(k)
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")
    usage = ptxas_usage(_build.build_log())
    for name, u in sorted(usage.items()):
        print(f"  ptxas {name}: {u.get('registers')} registers, "
              f"{u.get('stack')} bytes stack, spill stores "
              f"{u.get('spill_stores')} / loads {u.get('spill_loads')}, "
              f"{u.get('smem')} bytes smem")
    fused = {n: usage.get(n) for n in (*_LANE_KERNELS,
                                       *ENTRY_KERNELS["merkle_tree_leaves"])}
    spills = any(u is None or u.get("stack") or u.get("spill_stores")
                 or u.get("spill_loads") for u in fused.values())
    print(f"ptxas of the stages that hash (spills or stack: {spills}): "
          f"{fused}")

    if args.mesh_cards:
        mesh_cards(card, args.record)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    t0 = time.perf_counter()
    fx = Fixtures(max(SIZES))
    print(f"fixtures: {len(fx.privs)} keys in {fx.key_seconds:.1f} s")
    if args.blocksync or args.consensus:
        rec = {k: {"mismatches": 0} for k in _build.KERNELS}
        t0 = time.perf_counter()
        sweep = phase_sweep(fx, dev, rec)
        print(f"sweep: {len(SWEEP_LANES)} random batches of {SWEEP_LANES} "
              f"lanes in {time.perf_counter() - t0:.1f} s, mismatches "
              f"{sweep}")
        if any(sweep.values()):
            raise AssertionError(f"sweep mismatches: {sweep}")
        part = {}
        if args.blocksync:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(os.cpu_count()) as pool:
                keys = pool_keys(pool, BS_VALS)
                bs_launches, bs = phase_blocksync(pool, keys, dev, 5)
            report_blocksync(bs, bs_launches, card)
            part["blocksync"] = bs
        if args.consensus:
            t0 = time.perf_counter()
            cs_launches, cs = phase_consensus(dev)
            cs["phase_s"] = time.perf_counter() - t0
            report_consensus(cs, cs_launches, card)
            part["consensus"] = cs
        if args.record:
            os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                        exist_ok=True)
            with open(args.record, "w") as f:
                json.dump({"card": card, **part}, f, indent=1, default=str)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    rec = {k: {"name": k, "route": "cuda"} for k in _build.KERNELS}
    sources = {"sha256_leaves": ("csrc/sha256.cu",
                                 "cometbft_tpu/ops/sha256.py:115"),
               "merkle_level": ("csrc/sha256.cu",
                                "cometbft_tpu/ops/sha256.py:135"),
               "merkle_tree": ("csrc/sha256.cu",
                               "cometbft_tpu/ops/sha256.py:135"),
               "merkle_tree_leaves": ("csrc/sha256.cu",
                                      "cometbft_tpu/ops/sha256.py:115"),
               "sha512_scalar": ("csrc/sha512_scalar.cu",
                                 "cometbft_tpu/ops/sha512.py:165"),
               "ed25519_tables": ("csrc/ed25519_tables.cu",
                                  "cometbft_tpu/ops/ed25519.py:112"),
               "ed25519_verify_gather": ("csrc/ed25519_verify.cu",
                                         "cometbft_tpu/ops/ed25519.py:170"),
               "ed25519_rlc_gather": ("csrc/ed25519_rlc.cu",
                                      "cometbft_tpu/ops/rlc.py:221"),
               "ed25519_rlc_sums": ("csrc/ed25519_rlc.cu",
                                    "cometbft_tpu/ops/rlc.py:232"),
               "ed25519_rlc_combine": ("csrc/ed25519_rlc.cu",
                                       "cometbft_tpu/ops/rlc.py:290"),
               "aggregate_g1_masked": ("csrc/blsg1.cu",
                                       "cometbft_tpu/ops/blsg1.py:169")}
    for k, (src, rep) in sources.items():
        rec[k]["source"] = "cometbft_tpu_torch/" + src
        rec[k]["replaces"] = rep

    info = phase_kernels(fx, dev, REPS, rec)
    t0 = time.perf_counter()
    sweep = phase_sweep(fx, dev, rec)
    print(f"sweep: {len(SWEEP_LANES)} random batches of {SWEEP_LANES} "
          f"lanes in {time.perf_counter() - t0:.1f} s, mismatches {sweep}")
    t0 = time.perf_counter()
    mk = phase_merkle(dev, REPS, rec)
    print(f"merkle: kernels and tree sweep in {time.perf_counter() - t0:.1f} "
          f"s; sweep mismatches {mk['sweep']}")
    for k, v in mk["leaves_ms"].items():
        print(f"  sha256_leaves {k}: {v['ms']:.4f} ms (plain "
              f"{v['plain_ms']:.1f} ms; device {v['device_ms']})  [{card}]")
    print(f"  device ms per call (profiler): sha256_leaves "
          f"{rec['sha256_leaves']['device_ms']}, merkle_level "
          f"{rec['merkle_level']['device_ms']}")
    mt = rec["merkle_tree"]
    print(f"  merkle_tree, one call per tree: {mk['trees']}; at "
          f"{mt['shape']}: {mt['ms']:.4f} ms (CUDA events), device "
          f"{mt['device_ms']} ms, plain {mt['plain_ms']:.1f} ms  [{card}]")
    mf = rec["merkle_tree_leaves"]
    print(f"  merkle_tree_leaves, one call per tree with its leaves: "
          f"{mk['leaf_trees']}; at {mf['shape']}: {mf['ms']:.4f} ms (CUDA "
          f"events), device {mf['device_ms']} ms, plain "
          f"{mf['plain_ms']:.1f} ms  [{card}]")
    print(f"  trees, wall p50 ms: {mk['tree_ms']}  [{card}]")
    early = {k: r for k, r in rec.items()
             if k not in BLS_KERNELS + MESH_KERNELS}
    bad = {k: r["mismatches"] for k, r in early.items() if r["mismatches"]}
    for k, r in early.items():
        print(f"kernel {k} [{r['shape']}]: mismatches {r['mismatches']}, "
              f"max_abs_err {r['max_abs_err']}, {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.1f} ms)")
    print(f"rlc verdicts (kernel, plain, expected): "
          f"{rec['ed25519_rlc_gather']['verdicts']}")
    print(f"K5b ed25519_verify_gather at B=101: "
          f"{rec['ed25519_verify_gather']['ms']:.4f} ms, device "
          f"{rec['ed25519_verify_gather']['device_ms']} ms  [{card}]")
    print(f"K6a stages at B=150, device ms: "
          f"{rec['ed25519_rlc_gather']['stages_ms']}  [{card}]")
    if bad:
        raise AssertionError(f"kernel phase mismatches: {bad}")

    t0 = time.perf_counter()
    launches, per_call, lat, sets = phase_commit(fx, dev, REPS)
    for k, v in per_call.items():
        print(f"launches {k}: {v}")
    for k, v in lat.items():
        print(f"p50 {k}: {v:.2f} ms  [{card}]")

    tp = phase_throughput(sets, dev, LANES, REPS // 4)
    print(f"throughput {tp['lanes']} lanes [{card}]: RLC kernel "
          f"{tp['rlc_sig_per_s']:.0f} sig/s ({tp['rlc_ms']:.2f} ms), "
          f"per-lane kernel {tp['per_lane_sig_per_s']:.0f} sig/s "
          f"({tp['per_lane_ms']:.2f} ms), dense entry with host packing "
          f"{tp['dense_sig_per_s']:.0f} sig/s "
          f"(p50 {tp['dense_wall_p50_ms']:.1f} ms), table build "
          f"{tp['tables_ms']:.2f} ms")
    for k in tp["ms_10k"]:
        print(f"  {k} at {tp['lanes']} lanes: {tp['ms_10k'][k]:.4f} ms, "
              f"device {tp['device_ms_10k'][k]} ms  [{card}]")
    print(f"K6a stages at B={tp['lanes']}, device ms: "
          f"{tp['rlc_stages_ms_10k']}  [{card}]")
    print(f"K5a ed25519_tables mismatches by N: "
          f"{tp['tables']['mismatches']}; ms by layout (CUDA events): "
          f"{tp['tables']['ms_by_layout']}; chain floor, one block: "
          f"{tp['tables']['chain_floor_ms']}; blocks of 32 a SM: "
          f"{tp['tables']['ms_by_blocks_per_sm']}  [{card}]")
    print(f"sha512_scalar at {tp['lanes']} lanes through its checked public "
          f"wrapper: {tp['sha512_checked_ms_10k']:.4f} ms  [{card}]")
    floors = {"B=150": chain_floor(rec["ed25519_rlc_gather"]["stages_ms"]),
              f"B={tp['lanes']}": chain_floor(tp["rlc_stages_ms_10k"])}
    for shape, f in floors.items():
        if f is not None:
            print(f"K6a chain floor at {shape}: 255 doublings x "
                  f"{f['ns_per_op']:.1f} ns (ladder stage over {LADDER_OPS}"
                  f" quad operations) = {f['floor_ms']:.4f} ms  [{card}]")
    print(f"phases 4-5: {time.perf_counter() - t0:.1f} s")

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count()) as pool:
        t0 = time.perf_counter()
        keys = pool_keys(pool, BIG_VALS)
        print(f"light fixtures: {len(keys)} keys in "
              f"{time.perf_counter() - t0:.1f} s over {os.cpu_count()} "
              f"workers")
        t0 = time.perf_counter()
        l150_launches, l150, chain150 = phase_light150(pool, keys, dev,
                                                       REPS)
        print(f"light {LIGHT_VALS}: fixture {l150['fixture_s']:.1f} s, "
              f"phase {time.perf_counter() - t0:.1f} s; launches "
              f"{l150_launches}")
        print(f"verify_sequential_batched@{LIGHT_VALS} "
              f"({l150['headers']} headers, {l150['lanes']} lanes): "
              f"{_spread(l150['wall'])}  [{card}]")
        t0 = time.perf_counter()
        l10k_launches, l10k, fx10k, blocks10k = phase_light10k(
            pool, keys, dev, REPS)
        print(f"light {BIG_VALS}: fixture {l10k['fixture_s']:.1f} s, phase "
              f"{time.perf_counter() - t0:.1f} s; launches {l10k_launches}")
        t0 = time.perf_counter()
        from cometbft_tpu_torch import native
        from cometbft_tpu_torch.crypto import bls12381

        bls12381.sk_to_pk(1)              # build and self-test the library
        print(f"host library: bls12381 built in "
              f"{native.BUILD_SECONDS['bls12381']:.1f} s with g++")
        bls_launches, bls = phase_bls(pool, dev, REPS, rec)
        print(f"bls {BLS_VALS}: fixture {bls['fixture_s']:.1f} s, phase "
              f"{time.perf_counter() - t0:.1f} s; {bls['signers']} signers; "
              f"launches {bls_launches}")
        t0 = time.perf_counter()
        lc_launches, lc = phase_light_client(pool, keys, chain150, blocks10k,
                                             dev, REPS)
        lc["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bs_launches, bs = phase_blocksync(pool, keys, dev, 5)
        bs["phase_s"] = time.perf_counter() - t0
    report_blocksync(bs, bs_launches, card)
    t0 = time.perf_counter()
    cs_launches, cs = phase_consensus(dev)
    cs["phase_s"] = time.perf_counter() - t0
    report_consensus(cs, cs_launches, card)
    print(f"light client (phase 10): fixtures {lc['fixture_s']}, first "
          f"calls {lc['first_call_s']} s, phase {lc['phase_s']:.1f} s; "
          f"launches {lc_launches}")
    print(f"light client host ms (median): {lc['host_ms']}  [{card}]")
    print(f"light client: fetches by case {lc['fetches']}; (b) fetched "
          f"{lc['fetched_b']}; blocks signed when first served "
          f"{lc['signed_blocks']} in {lc['signing_s']} s; (d) "
          f"{lc['detector']}")
    for k, v in lc["wall"].items():
        print(f"light client {k}: {_spread(v)}  [{card}]")
    for k, v in lc["profile"].items():
        print(f"profile light client {k}: wall {v['wall_ms']:.2f} ms, device "
              f"{v['device_ms']} ms (busy {v['device_busy_share']}), kernels "
              f"{v['kernels_ms']}  [{card}]")
    for k, v in bls["per_call_launches"].items():
        print(f"launches {k}@bls{BLS_VALS}: {v}")
    print(f"cold (first call, table built) ms: {bls['cold_ms']}  [{card}]")
    for k, v in bls["wall"].items():
        print(f"{k}@bls{BLS_VALS}: {_spread(v)}  [{card}]")
    print(f"two pairings (verify_aggregate_affine): {_spread(bls['pairings'])};"
          f" {100 * bls['pairing_share']:.1f}% of the VerifyCommitLight p50"
          f"  [{card}]")
    k9 = rec["aggregate_g1_masked"]
    print(f"kernel aggregate_g1_masked [{k9['shape']}]: mismatches "
          f"{k9['mismatches']} {k9['cases']}, max_abs_err "
          f"{k9['max_abs_err']}, {k9['ms']:.4f} ms, device {k9['device_ms']} "
          f"ms {k9['device_kernels_ms']}, plain {k9['plain_ms']:.1f} ms; "
          f"ms by rows {k9['ms_by_rows']}  [{card}]")
    if k9["mismatches"]:
        raise AssertionError(f"G1 fold mismatches: {k9['cases']}")
    t0 = time.perf_counter()
    mesh_launches, mesh = phase_mesh(fx10k, chain150, [dev] * MESH_SHARDS,
                                     REPS, rec)
    print(f"mesh phase {time.perf_counter() - t0:.1f} s")
    report_mesh(mesh, mesh_launches, rec, card)
    if torch.cuda.device_count() > 1:
        t0 = time.perf_counter()
        cards = visible_cards()
        k7_cards = {k: {} for k in MESH_KERNELS}
        _, mesh["across_cards"] = phase_mesh(fx10k, chain150, cards, REPS,
                                             k7_cards)
        print(f"mesh phase over {len(cards)} cards "
              f"{time.perf_counter() - t0:.1f} s")
        report_mesh(mesh["across_cards"], None, k7_cards, card)
    else:
        print(f"mesh: {MESH_SHARDS} shards on 1 card; cross-card copy not "
              "exercised")
    mv = mesh["verdict"]
    for k, v in l10k["per_call_launches"].items():
        print(f"launches {k}@{BIG_VALS}: {v}")
    for k, v in l10k["wall"].items():
        print(f"{k}@{BIG_VALS}: {_spread(v)}  [{card}]")
    print(f"host@{BIG_VALS} (p50 ms): {l10k['host_ms']}  [{card}]")
    print(f"VerifyCommit@{BIG_VALS} host parts (median ms; encoder rows "
          f"equal the per-lane rows: "
          f"{l10k['verify_commit_parts_ms']['rows_equal']}): "
          f"{l10k['verify_commit_parts_ms']}  [{card}]")
    for name, prof in (("VerifyCommitLight@bls10k",
                        bls["profile_verify_commit_light"]),
                       ("verify_sequential_batched@150", l150["profile"]),
                       ("verify_adjacent@10k",
                        l10k["profile_verify_adjacent"]),
                       ("VerifyCommit@10k", l10k["profile_verify_commit"]),
                       ("ValidatorSet.hash@10k",
                        l10k["profile_valset_hash"])):
        print(f"profile {name}: wall {prof['wall_ms']:.2f} ms, device "
              f"{prof['device_ms']} ms, kernels {prof['kernels_ms']}")
    paths = {"commit": launches, f"light{LIGHT_VALS}": l150_launches,
             f"light{BIG_VALS}": l10k_launches, f"bls{BLS_VALS}": bls_launches,
             f"mesh{MESH_SHARDS}": mesh_launches,
             "light_client": lc_launches, "blocksync": bs_launches,
             "consensus": cs_launches}

    c = op_counts()
    print(f"field multiplications per group op: {c}")
    bd = bounds(c, b_verify=101, b_rlc=150, n_tab=150, nb=info["blocks_nb"],
                distinct_rows={"verify": 101, "rlc": 150},
                rate_ops=rate_ops)
    bd.update(merkle_bounds(rec, rate_ops))
    bd_10k = bounds(c, b_verify=LANES, b_rlc=LANES, n_tab=LANES, nb=tp["nb"],
                    distinct_rows={"verify": LANES, "rlc": LANES},
                    rate_ops=rate_ops)
    bd.update(bls_bound(rec, rate_ops))
    bd_mesh = mesh_bounds(c, mv["lanes"], mv["shards"], tp["nb"], rate_ops)
    bd.update({k: bd_mesh[k] for k in MESH_KERNELS})
    mv["bound_ms"], mv["bound_by"] = bd_mesh["rlc_sharded"][:2]
    print(f"bound K7 sharded verdict: {bd_mesh['rlc_sharded'][2]:.3e} int "
          f"ops, {bd_mesh['rlc_sharded'][3]} bytes -> {mv['bound_ms']:.4f} "
          f"ms ({mv['bound_by']})")
    kernels = []
    for k, r in rec.items():
        bound_ms, by, ops, nbytes = bd[k]
        print(f"bound {k}: {ops:.3e} int ops, {nbytes} bytes -> "
              f"{bound_ms:.4f} ms ({by})")
        kernels.append({
            "name": k, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": sum(p.get(k, 0) for p in paths.values()),
            "launches_by_path": {n: p.get(k, 0) for n, p in paths.items()},
            "max_abs_err": r["max_abs_err"], "mismatches": r["mismatches"],
            "sweep_mismatches": r.get("sweep_mismatches"),
            "ms": r["ms"], "device_ms": r.get("device_ms"),
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None, "shape": r["shape"],
            **({"ms_10k": tp["ms_10k"][k],
                "device_ms_10k": tp["device_ms_10k"][k],
                "bound_ms_10k": bd_10k[k][0]}
               if k in tp["ms_10k"] else {}),
            **({"stages_ms": r["stages_ms"],
                "stages_ms_10k": tp["rlc_stages_ms_10k"],
                "chain_floor": floors}
               if k == "ed25519_rlc_gather" else {}),
            **({"ms_checked": r["ms_checked"],
                "ms_checked_10k": tp["sha512_checked_ms_10k"]}
               if k == "sha512_scalar" else {}),
            **({"card_ms": r["card_ms"],
                "card_device_ms": r["card_device_ms"],
                "card_bound_ms": bd_mesh["sums_card"][0]}
               if k == "ed25519_rlc_sums" else {}),
            **({"ptxas": {n: usage.get(n) for n in ENTRY_KERNELS[k]}}
               if k in ENTRY_KERNELS else {})})
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump({"card": card, "kernels": kernels,
                       "per_call": per_call, "p50_ms": lat,
                       "throughput": tp, "op_counts": c, "merkle": mk,
                       "light150": l150, "light10k": l10k, "bls": bls,
                       "light_client": lc, "blocksync": bs,
                       "consensus": cs,
                       "mesh": mesh, "build_log": _build.build_log(),
                       "ptxas": usage}, f, indent=1,
                      default=str)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
