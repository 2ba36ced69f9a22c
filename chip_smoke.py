#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's commit-, light-header and BLS
aggregate-commit verification paths, of lane-sharded commit
verification over a device set, of the light client, of blocksync
catch-up, of consensus in one process, of the networked node over
loopback TCP, of BASELINE configs[4]'s mixed-key commits, of the RPC
surface with light-client serving, of statesync, of discovery under
faults (networks/chaos.toml), of networks/ci.toml run whole with one
process per node through the command line, of the scenario lab (the
curated suite up to 100 nodes and the 50-node statesync fleet), of
multi-process verification over ``torch.distributed`` and the warm boot,
and of the gRPC transports (an app over gRPC, the node's gRPC services)
and the SQL event sink, on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. environment: the card's name and power limit, torch.version.cuda, nvcc;
2. build: compiles the kernels from the six sources in
   ``cometbft_tpu_torch/csrc`` (one nvcc per source, all at once) into
   the kernel bundle (``crypto/aotbundle.py``: absent in a fresh
   checkout, so built; its nvcc seconds, status and capability are
   printed) and prints each function's registers, stack frame, spills
   and shared memory from ``-Xptxas -v`` (``ptxas_usage``);
3. kernels: each kernel against its plain PyTorch version on the card, on
   the same inputs at the main path's shapes (valid, tampered and ZIP-215
   edge lanes; RLC accept, reject, garbage padding and torsion batches),
   and against the pure-Python oracle; then one seeded random batch per
   entry of ``SWEEP_LANES`` (up to 64,032 lanes against 1,000 keys,
   phase 15 (b)'s batch; ``SWEEP_SIGNED`` distinct signed lanes, tiled
   above that)
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
   (cold, with the per-set table build, then ``REPS`` calls), ``VerifyCommit``
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
   one one-lane device check is timed alone;
13. the networked node (``phase_node``): port ``Node``s in one process,
   each with its own loopback listener, secret connections (the
   challenge checked on the card) and MConnections, full mesh, from the
   repo's e2e manifests: (a) ``networks/ci.toml``'s 4 validators to
   height ``ND_CI_HEIGHT`` with ``ND_TXS`` txs injected on node 0 and a
   full node (``fast_sync``) started at height ``ND_FULL_AT``; (b)
   ci.toml's kill:5 / restart:7 of validator02 from its home is phase
   17's, where chaos.toml has the same perturbation; (c) ``networks/large.toml``'s 12
   validators at their skewed powers with ``ND_LARGE_LATENCY_MS`` of
   emulated latency to height ``ND_LARGE_HEIGHT``, validator08 on the
   native database (its blocks read back from its files after the stop);
   (d) vote extensions at 4 validators.  Each part's wall and rounds a height, the mesh's
   wall, the bytes sent and received a height, the scheduler's tallies
   and (a), (c) the device busy share; the oracle's calls counted (must
   be 0) and every stored commit re-checked by it afterwards;
14. BASELINE configs[4] (``phase_stress``): 10,000 validators, the
   first 1,000 secp256k1, each signing a precommit and an extension
   (keys and signatures from the native signers in the pool): (a) the
   20,000 lanes in one batch verifier (Ed25519 lanes on the card,
   secp256k1 lanes on host threads), tampered lanes caught at their
   indices, sigs/s, the parts timed apart, the device busy share; (b)
   ``VerifyCommit`` and ``VerifyCommitLight`` of the mixed 10,000-lane
   commit, a bad secp256k1 lane rejected at its index,
   ``ValidatorSet.hash`` through the tree kernel against hashlib; (c)
   a mixed-key network (one secp256k1 validator of four) to height 3;
   (d) the native host tree against the hashlib level loop at 64 to
   2,047 leaves; (e) is validator08 of phase 13 (c);
15. the RPC surface and light serving (``phase_rpc``, after phase 14
   in a fresh process with a key pool of its own, ``--child rpc``, so
   that the collector sees its objects only): (a) ci.toml's 4 validators, each with an
   ``RPCServer``, to height ``ND_CI_HEIGHT``: ``ND_TXS`` txs through
   ``broadcast_tx_commit`` over HTTP (overload sheds retried and
   counted), ``tx`` proofs, ``tx_search``, ``block_search``, WebSocket
   subscriptions to NewBlock and Tx, ``abci_query`` proofs through
   ``ProofOperators``, the same ``block``/``commit``/``validators`` on
   all four nodes, each route's p50, min and max; (d) on those nodes
   ``light.Client`` over ``RPCProvider``s (sequential, skipping),
   ``run_light_proxy``'s verified answers and a forged primary refused;
   (b) a ``LightServeTier`` behind an ``RPCServer`` over the stores of
   a source chain as phase 11's (``BS_VALS``, BASELINE configs[3]'s
   width; its light scope of ``RPC_ANCHORS`` anchors is phase 3's
   largest sweep batch):
   ``light_blocks`` and ``light_verify`` of ``RPC_ANCHORS`` heights cold
   and warm (one K6a launch over every anchor's lanes, the memo), a
   tampered anchor refused with K5b naming its lane, validator proofs;
   (c) ``RPC_BIG_HEIGHTS`` heights of ``BIG_VALS`` validators (configs[4]'s
   width): the validator tree by ``merkle_tree_leaves``, its root and
   ``RPC_PROOF_SAMPLE`` proofs against hashlib, ``light_verify`` of the
   anchors.  K5a, K5b, K6a and ``merkle_tree_leaves`` must launch; the
   oracle's calls must be 0.
16. statesync (``phase_statesync``, after phase 15 in a fresh process of
   its own, ``--child statesync``): (a) ci.toml's 4 validators from a
   genesis ``app_state`` of at least 128 chunks; a fresh node whose
   state provider's light client reads validator01's RPC restores a
   snapshot and follows consensus (no fallback to genesis, the restored
   keys over ``abci_query``, equal blocks, ``consensus_timeline``,
   ``dump_incidents`` and the doctor's report over RPC), then inspect
   mode over validator01's home serves its blocks; (b) 1,000 validators
   and 200,000 genesis keys (a 61 MiB snapshot): a source node's 40
   heights, a fresh node restores about 980 chunks over a secret
   connection (the light client on the card, the app hash by
   ``merkle_tree_leaves``) and blocksyncs to the tip; its readings
   (discovery, light verification, transfer, apply, app hash,
   blocksync, busy share, gc).  K5a, K6a and ``merkle_tree_leaves``
   must launch; every launch's shape is recorded and each kernel is
   held against its plain version at those shapes (the tree at (b)'s
   leaves also against hashlib, roots and proofs).
17. discovery and faults (``phase_chaos``, after phase 16 in a fresh
   process of its own, ``--child chaos``: the fault plane is
   process-wide): ``networks/chaos.toml``'s seed and 4 validators, which
   dial only the seed and find each other through pex, 20 ms of emulated
   latency, drop-mode connection fuzzing from 5 s after each connection
   opens; joiner01 blocksyncs from height 4 and is voted in by a ``val:``
   tx at 6; validator02 stopped at 5 and restarted from its home at 7;
   validator03 partitioned from 8 to 9 (``p2p.send.drop`` and
   ``p2p.recv.drop`` armed with ``node=validator03``); light01 verifies
   to height 12 over RPC; 15 txs/s of load for 25 s; validator04's app
   and key in another process (``--serve-remote``: an ``ABCIServer`` and
   a signer dialling the node's ``SignerListener``).  Every live node at
   12 or more with equal blocks, the joiner in the set from two heights
   after the block that carried its ``val:`` tx and signing, light01's headers
   the chain's, every accepted tx in every app (the remote one over
   ``abci_query``), every app's calls legal, each of validator04's votes
   and proposals signed once remotely, the books and the seed's
   hang-ups, the partition's drops in the plane's log; its readings
   (heights, discovery, tear-downs, fuzz decisions, bytes, the signer's
   and the socket app's round trips, busy share).  K5a and K5b must
   launch; every launch's shape is recorded and each held against its
   plain version there.
18. one process per node (``phase_e2e``, in a fresh process of its own,
   ``--child e2e``, beside phase 17): ``E2E_MANIFEST`` (networks/ci.toml)
   whole through the port's ``e2e.Runner``, every node and the light
   daemon a ``python -m cometbft_tpu_torch`` process on the card:
   4 validators, validator02 SIGKILLed at 5 and restarted from its home
   at 7, validator03 SIGSTOPped at 8 and resumed at 9, full01
   blocksyncing from 4, light01 (``light``) from 6, 20 txs/s of load for
   20 s; the runner's invariants (every live node at 12 with one block
   hash, light01's verified header the chain's), then ``load`` and
   ``load-report`` as processes, every process's ``/metrics``, and after
   the stop ``doctor`` on validator02's home.  Each node's launch
   counters (``crypto_kernel_calls_total`` on its ``/metrics``) must show
   K5a and K5b launched, and no process a plain version or a standalone
   hash kernel; the lane and key counts of the kernel-dispatch series
   are held against the plain versions here.  Readings: start-up (spawn
   to RPC), a height's wall (between commit times) and round,
   catch-ups, light01's first verified header, the load's latency, the
   card's utilization (``nvidia-smi``) and each process's allocator
   memory.
19. the scenario lab (``phase_sim``, in a fresh process of its own,
   ``--child sim``, beside phases 12-13): programs of ``SIM_REFERENCE``
   (``tests/torch_sim_reference.json``, the JAX package's verdicts
   written on the CPU by ``python tests/torch_sim_fixtures.py
   --write``), in the whole run ``SIM_WHOLE`` (megamix-100,
   bls-mixed-lab-12, asym-cut-gray-25 and fleet-bootstrap-50, for the
   time limit), with ``--sim`` every one: the eight
   curated scenarios (partitions, a one-way cut, gray failures, an
   equivocator, an amnesiac, a spammer, tx flooders, a crash with a
   wiped restart, a mixed BLS/Ed25519 set; 12 to 100 nodes) and the
   statesync fleets (fleet-bootstrap-50: 10 validators, 4 seeds, 40
   bootstrappers under drop and delay faults, one seed serving corrupt
   chunks), each loaded from its dict and run on ``cuda:0`` on the
   virtual clock, then the first again.  Each verdict must equal the
   file's field by field (and each scenario's fault signature),
   ``bench.py``'s checks of a verdict hold, the replay is identical,
   K5a, K5b and K9 launch with no plain call and no oracle call, and
   every launch of K5a and K5b (a seeded sample of K9's) recomputed by
   the plain versions on the card gives 0 mismatches.  Readings: a
   program's wall, virtual seconds per real second, one-lane checks and
   their mean ms, launches by kernel, busy share (CUDA events around
   each launch).
20. multi-host verification and warm boot (``phase_multihost``, then
   ``phase_warmboot`` twice, each in a fresh process of its own,
   ``--child multihost``, ``warm_on``, ``warm_off``, beside phases
   12-13): (a) phase 3's 1,000 signed lanes tiled to ``LANES`` against a
   ``LANES``-row table, and the same with lane ``MH_BAD_LANE`` (the
   first of rank 1's at 2 and at 4 ranks) bad, and ``MH_PAIRS`` merkle
   pairs, through ``parallel/mesh.py``'s ``sharded_kernel`` of every
   kind (``verify``, ``gather``, ``rlc``, ``rlc_gather``,
   ``merkle_level``) by ``MH_WORLDS`` ranks, each a process
   (``--multihost-rank``) on ``cuda:0`` of one gloo group from
   ``init_multihost``: every rank's results equal, equal to the route of
   one process (over one shard, and over as many shards), the RLC
   verdicts to K6a's, the bad lane pinned alone, ``merkle_level`` equal
   to hashlib; each rank's launches held against the plain versions on
   the card (K5b and K5a on a sample of its lanes, K7's sums on them,
   K7's combine on the gathered stack, K8b on a sample of its pairs);
   readings: a verdict's p50 over ``REPS`` calls, its all-gathers' ms,
   the rendezvous; (b) two processes that have not touched the card make
   a ``WB_VALS``-validator commit, then one runs the node's warm boot
   (``node/node.py:warm_boot``: the bundle loaded, the warmup) and the
   other the bundle's load alone, each then ``WB_CALLS``
   ``VerifyCommit`` calls: the bundle ``loaded``, its load seconds, the
   first and fifth call's wall; the warmup's shapes against the plain
   versions.  Phase 18's nodes must report their bundle ``loaded`` on
   ``/status``;
21. the gRPC transports and the SQL event sink (``phase_grpc``, in a
   fresh process of its own, ``--child grpc``, beside phases 12-13):
   ``GR_POWERS`` validators in one process over TCP to height
   ``GR_TOP``, validator04's app a process of its own serving the
   kvstore over gRPC (``abci kvstore --grpc``), validator01 serving the
   node's gRPC services and a ``PsqlEventSink`` over ``sqlite3`` on its
   event bus: the services' blocks and block results equal JSON-RPC's
   at every height, the retain height set and read back, the
   latest-height stream each committed height once in order and its
   subscription gone when the client leaves, the sink a row a height and
   a row a committed tx; readings: the gRPC app's calls (phase 17 reads
   the socket app's), each method's p50, the stream's lag.

The fresh processes of phases 15-21 start right after the build
(``--after``): each reaches the card and loads the kernels (phase 20
(b)'s only import, so that their boot is timed from a process that has
not touched the card), then waits for its turn, so that its set-up
overlaps the phases before it.  In the whole run phases 15 and 16, one
after the other, run beside phases 12 and 13 (``fresh_beside``), and
phases 19 and 20, one after the other, beside them on a thread of their
own, and phase 21 on a third: all are
host-bound, the card busy under 2% of their time; phase 16's timing of
the tree kernel at 200,000 leaves then shares the card with phase 13's
one-lane launches, and phase 20's readings, after phase 19's, share
the host and the card with phase 16 (and with phases 12-13 where they
outlast phase 19).  Phase
18 runs beside phase 17 the same way, its ports from ``E2E_BASE_PORT``
(below the kernel's ephemeral range, where phase 17's nodes bind).

Phases 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20 and 21
are the main path: the launch counters are zeroed just before each and read
just after (phase 18's are its processes' own counters, which start at 0
with each process and are read over ``/metrics`` before the stop; phase
20's are its ranks' and its warm-boot processes');
each phase's kernels
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
``python3 chip_smoke.py --consensus`` the same with phase 12, ``--node``
with phase 13, ``--stress`` with phase 14, ``--rpc`` with phase 15 (its
fixtures built in it: the 1,000-validator source chain and 10,000 keys),
``--statesync`` with phase 16 (options together run their phases;
``--stress --node`` gives phase 14 its part (e)); ``--chaos`` runs only
phases 1, 2 and 17; ``--e2e [MANIFEST]`` only phases 1, 2 and 18 (over
networks/ci.toml unless MANIFEST names another); ``--sim`` only phases
1, 2 and 19; ``--multihost`` only phases 1, 2 and 20; ``--grpc`` only
phases 1, 2 and 21 (with ``--chaos``, phase 17's socket app beside).

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
import gc
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

# when this module was loaded: a child phase's set-up is timed from here
_T_LOADED = time.perf_counter()

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
# timed calls per measurement (cut from 20, as ST_REPS and RPC_REPS, to
# keep the whole smoke well inside its limit on slower hosts)
REPS = 5
# lanes of the sweep's batches; 32,000 is phase 11's window (32 commits
# of 1,000 validators), 64,032 phase 15 (b)'s light_verify (96 anchors of
# 667 lanes of 1,000 validators), the largest batch the port runs
SWEEP_LANES = (1, 77, 128, 129, 300, 640, 32_000, 64_032)
# keys in an entry's table (64 where not listed): phase 15 (b)'s set
SWEEP_KEYS = {64_032: 1_000}
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
BS_RUNS = 2                      # (a): timed catch-ups (cut from 3 for
                                 # the smoke's time limit)
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
    """One seeded random batch per entry of SWEEP_LANES (one lane to 501
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
        keys = rng.choice(len(fx.privs), size=SWEEP_KEYS.get(n, min(n, 64)),
                          replace=False)
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
                 warm=None, host: bool = True) -> dict:
    """Wall time of ``calls`` synchronized calls of ``fn`` and the device
    time of what they ran, by name (the ``top`` longest, or all for
    None), from ``torch.profiler`` (a first traced call of ``warm``, by
    default ``fn``, whose trace is dropped, warms the tracer up: the
    first events of a process's first trace were missing on the card;
    device time is None when the profiler saw no device activity).
    Times are per call.  With ``verdicts`` also the device ms of each
    RLC verdict traced, in order (:func:`_window_verdicts_ms`).  With
    ``host=False`` only the device is traced (no host op is recorded: a
    minute of a node network's Python would be a large trace to keep
    and to sum)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host \
        else [ProfilerActivity.CUDA]
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
                                              reps),
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
            "d_detector150": time_host_spread(case_d, reps)}
    prof = {"a_sequential150": profile_call(case_a),
            "c_skipping10k": profile_call(case_c)}
    loop.close()
    return launches, {
        "host_ms": light_client_host_ms(chain150[-1], blocks10k[-1],
                                        reps),
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
            CHAIN_ID, chain150[0].validators, items), reps)
        prof = profile_call(verify_commit, reps)
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
    prof = profile_call(calls["VerifyCommitLight"], reps)
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
        self.state_store = ex.state_store

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


# ------------------------------------------------ phase 13: the node

ND_CI_POWERS = (10, 10, 10, 10)  # networks/ci.toml: validator01..04
ND_CI_HEIGHT = 10                # (a), (b): heights every node reaches
ND_TXS = 8                       # (a): txs injected on node 0 only
ND_FULL_AT = 4                   # (a): full01's start_at
ND_LARGE_POWERS = (40, 25, 15, 10, 10, 10, 5, 5, 5, 5, 5, 5)  # large.toml
ND_LARGE_LATENCY_MS = 10.0       # (c): large.toml's emulated latency
ND_LARGE_HEIGHT = 6              # (c)
ND_EXT_HEIGHT = 4                # (d): vote extensions from height 1
ND_NATIVE_AT = 7                 # (c): validator08, on the native database
ND_TIMEOUT_S = 240               # a part's wait for its heights


def _nd_genesis(powers, tag: bytes, ext_height: int = 0):
    """A genesis of validators at ``powers`` (keys from ``tag``) and
    their signers."""
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.priv_validator import MockPV

    pvs = [MockPV.from_secret(tag + b"%d" % i) for i in range(len(powers))]
    doc = GenesisDoc(chain_id=CHAIN_ID, validators=[
        GenesisValidator(pv.get_pub_key(), p) for pv, p in zip(pvs, powers)])
    doc.consensus_params.feature.vote_extensions_enable_height = ext_height
    return doc, pvs


async def _nd_node(doc, pv, name: str, dev, *, home=None, fast_sync=False,
                   latency_ms: float = 0.0, db_backend: str = "logdb",
                   rpc_laddr: str = "", app=None,
                   discovery_s: float | None = None, grpc_laddr: str = "",
                   grpc_app: str = "", **kw):
    """A port ``Node`` of the kvstore app (``app``, else a new one; with
    ``grpc_app``, the ABCI gRPC server at that ``host:port``) on
    ``dev``: the JAX package's test timeouts, a loopback listener on port
    0, ``db_backend`` stores under ``home`` (else in memory), an RPC
    server on ``rpc_laddr`` and the gRPC services on ``grpc_laddr`` (none
    by default), a statesync discovery round of ``discovery_s`` (else
    the default), the configuration validated; ``kw`` goes to
    ``Node.create``."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import Config, test_consensus_config
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.p2p import NodeKey

    cfg = Config(consensus=test_consensus_config())
    cfg.base.device = str(dev)
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = rpc_laddr
    cfg.p2p.emulated_latency_ms = latency_ms
    cfg.storage.db_backend = db_backend if home else "memdb"
    if discovery_s is not None:
        cfg.statesync.discovery_time_s = discovery_s
    cfg.rpc.grpc_laddr = grpc_laddr
    if grpc_app:
        cfg.base.abci = "grpc"
        cfg.base.proxy_app = f"tcp://{grpc_app}"
    cfg.validate()
    return await Node.create(
        doc, None if grpc_app else app or KVStoreApplication(device=dev),
        priv_validator=pv,
        config=cfg, node_key=NodeKey.from_secret(b"smoke-" + name.encode()),
        home=home, fast_sync=fast_sync, name=name, **kw)


async def _nd_dial(a, targets, walls: list) -> None:
    """``a`` dials ``targets`` (persistent) all at once, as a node dials
    its persistent peers at start; each dial's wall (TCP connect, the
    secret handshake with its device check, the node-info exchange) is
    appended to ``walls``."""
    import asyncio

    async def one(b):
        t0 = time.perf_counter()
        await a.dial_peer(b.listen_addr, persistent=True)
        walls.append(time.perf_counter() - t0)

    await asyncio.gather(*(one(b) for b in targets))


async def _nd_mesh(nodes, walls: list) -> float:
    """Full mesh: i dials j for i < j, every dial at once; returns the
    mesh's wall."""
    import asyncio

    t0 = time.perf_counter()
    await asyncio.gather(*(_nd_dial(a, nodes[i + 1:], walls)
                           for i, a in enumerate(nodes)))
    return time.perf_counter() - t0


def _nd_traffic(nodes) -> dict:
    """Bytes the nodes' live MConnections sent and received (framed
    packets, flowrate counters) and their per-channel payload bytes."""
    sent = recv = 0
    by_chan: dict = {}
    for n in nodes:
        for p in n.switch.peers.values():
            t = p.mconn.telemetry()
            sent += t["send_bytes_total"]
            recv += t["recv_bytes_total"]
            for name, c in t["channels"].items():
                by_chan[name] = by_chan.get(name, 0) + c["sent_bytes"]
    return {"sent": sent, "recv": recv, "sent_payload_by_channel": by_chan}


def _nd_summary(nodes, top: int, walls, mesh_s, seen, wall_s,
                sched_stats) -> dict:
    traffic = _nd_traffic(nodes)
    marks = seen.get("last", {})
    return {
        "heights": top, "wall_s": wall_s,
        "per_height_s": [marks[h] - marks[h - 1] for h in range(2, top + 1)
                         if h in marks and h - 1 in marks],
        "mean_height_s": ((marks[top] - marks[1]) / (top - 1)
                          if top in marks and 1 in marks else None),
        "rounds": [_commit_round(nodes[0], h) for h in range(1, top + 1)],
        "max_round": seen.get("max_round"),
        "dials": len(walls), "mesh_s": mesh_s,
        "dial_p50_ms": 1e3 * statistics.median(walls) if walls else None,
        "bytes_sent_per_height": traffic["sent"] / top,
        "bytes_recv_per_height": traffic["recv"] / top,
        "payload_by_channel": traffic["sent_payload_by_channel"],
        "scheduler": sched_stats}


def _nd_agree(nodes, top: int, part: str) -> None:
    for h in range(1, top + 1):
        hs = {n.block_store.load_block(h).hash() for n in nodes}
        if len(hs) != 1:
            raise AssertionError(f"phase 13 ({part}): fork at height {h}")


async def _nd_refuses_conflict(pv) -> bool:
    """Whether the file signer refuses a message for its last height,
    round and step that differs from what it signed."""
    from cometbft_tpu_torch.privval import DoubleSignError
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.vote import (PRECOMMIT_TYPE, PREVOTE_TYPE,
                                               Proposal, Vote)

    bid = BlockID(b"\x42" * 32, PartSetHeader(1, b"\x43" * 32))
    try:
        if pv.step == 1:
            await pv.sign_proposal(CHAIN_ID, Proposal(
                height=pv.height, round=pv.round, pol_round=-1,
                block_id=bid, timestamp_ns=1))
        else:
            await pv.sign_vote(CHAIN_ID, Vote(
                type=PREVOTE_TYPE if pv.step == 2 else PRECOMMIT_TYPE,
                height=pv.height, round=pv.round, block_id=bid,
                timestamp_ns=1, validator_address=pv.get_pub_key().address(),
                validator_index=1), False)
    except DoubleSignError:
        return True
    return False


def _nd_recheck_target(node, doc):
    """What ``_oracle_recheck`` reads of a node: its stores, and the
    genesis set for heights the state store holds no set for."""
    from types import SimpleNamespace

    from cometbft_tpu_torch.storage.statestore import State

    return SimpleNamespace(block_store=node.block_store,
                           state_store=node.state_store,
                           state=State.from_genesis(doc))


def phase_node(dev):
    """Phase 13: the networked node over loopback TCP on the card, from
    the repo's e2e manifests (``networks/ci.toml``, ``large.toml``):
    port ``Node``s in one process, each with its own listener, secret
    connections (the challenge checked on the card) and MConnections,
    full mesh, the JAX package's test timeouts:

    (a) ci.toml's 4 validators, MemDB: ``ND_TXS`` txs injected on node
        0 only, to height ``ND_CI_HEIGHT``; at height ``ND_FULL_AT`` a
        fifth, non-validator node (full01, ``fast_sync``) blocksyncs,
        switches to consensus and follows two heights past its switch;
    (b) ci.toml's kill:5 and restart:7 of validator02 from its home
        is phase 17's (the same perturbation in chaos.toml, with its
        checks of the LogDB stores, the WAL and the ``FilePV`` files);
    (c) large.toml's 12 validators at their skewed powers with
        ``ND_LARGE_LATENCY_MS`` of emulated latency, to height
        ``ND_LARGE_HEIGHT``, validator08 (``ND_NATIVE_AT``) on the native
        database: its blocks read while it runs and from its files
        after the stop equal the others' (phase 14 (e));
    (d) vote extensions from height 1 at 4 validators to height
        ``ND_EXT_HEIGHT``: a stored extended commit carries 3 or more
        extension signatures.

    Each part reports the wall and rounds of each height, the dials'
    wall, the bytes sent and received a height, the scheduler's tallies
    and the device busy share of its main stretch (``profile_call``).
    The launch counters are zeroed just before and read just after the
    four parts; the pure-Python oracle's calls are counted (must be 0),
    then every stored commit is re-checked by it."""
    import asyncio
    import tempfile
    from types import SimpleNamespace

    from cometbft_tpu_torch.crypto import scheduler as vsched
    from cometbft_tpu_torch.p2p import secret_connection as psc

    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    out: dict = {}
    keep: dict = {}

    def watch(nodes, top, t0, seen):
        run(asyncio.wait_for(_watch_heights(SimpleNamespace(nodes=nodes),
                                            top, t0, seen), ND_TIMEOUT_S))

    def stop(nodes):
        for n in nodes:
            run(n.stop())

    def part_a():
        doc, pvs = _nd_genesis(ND_CI_POWERS, b"nd-ci")
        nodes = [run(_nd_node(doc, pv, f"validator0{i + 1}", dev))
                 for i, pv in enumerate(pvs)]
        full = run(_nd_node(doc, None, "full01", dev, fast_sync=True))
        walls, seen = [], {}
        try:
            t0 = time.perf_counter()
            for n in nodes:
                run(n.start())
            mesh_s = run(_nd_mesh(nodes, walls))
            for i in range(ND_TXS):
                run(nodes[0].mempool.check_tx(b"ci%d=tx%d" % (i, i)))
            watch(nodes, ND_FULL_AT, t0, seen)
            t_full = time.perf_counter()
            run(full.start())
            run(_nd_dial(full, nodes, walls))

            def switched():
                async def wait():
                    while full.consensus_reactor.wait_sync:
                        await asyncio.sleep(0.005)
                run(asyncio.wait_for(wait(), ND_TIMEOUT_S))

            switched()
            t_switch = time.perf_counter() - t_full
            h_switch = full.height()
            top = max(ND_CI_HEIGHT, max(n.height() for n in nodes) + 2)
            everyone = nodes + [full]

            def rest():
                # the heights' marks from the validators; then full01
                watch(nodes, top, t0, seen)
                watch([full], top, t0, {})

            prof = profile_call(rest, top=6, warm=lambda: None)
            wall = time.perf_counter() - t0
            stats = vsched.get_scheduler().stats()
            summary = _nd_summary(everyone, top, walls, mesh_s, seen, wall,
                                  stats)
        finally:
            stop(nodes + [full])
        _nd_agree(nodes + [full], top, "a")
        want = {b"ci%d=tx%d" % (i, i) for i in range(ND_TXS)}
        got = {bytes(tx) for h in range(1, top + 1)
               for tx in nodes[1].block_store.load_block(h).data.txs}
        if not want <= got:
            raise AssertionError(f"phase 13 (a): txs {want - got} never "
                                 "committed")
        keep["a"] = (nodes[1], doc, top)
        return {**summary, "full_switch_s": t_switch,
                "full_switch_height": h_switch, "profile": prof}

    def part_c(tmp):
        doc, pvs = _nd_genesis(ND_LARGE_POWERS, b"nd-large")
        # large.toml: validator08 keeps its stores in the native database
        v08_home = os.path.join(tmp, "validator08")
        nodes = [run(_nd_node(doc, pv, f"validator{i + 1:02d}", dev,
                              latency_ms=ND_LARGE_LATENCY_MS,
                              home=v08_home if i == ND_NATIVE_AT else None,
                              db_backend="native"))
                 for i, pv in enumerate(pvs)]
        v08 = nodes[ND_NATIVE_AT]
        walls, seen = [], {}
        try:
            t0 = time.perf_counter()
            for n in nodes:
                run(n.start())
            mesh_s = run(_nd_mesh(nodes, walls))
            watch(nodes, 1, t0, seen)
            prof = profile_call(
                lambda: watch(nodes, ND_LARGE_HEIGHT, t0, seen), top=6,
                warm=lambda: None)
            wall = time.perf_counter() - t0
            stats = vsched.get_scheduler().stats()
            summary = _nd_summary(nodes, ND_LARGE_HEIGHT, walls, mesh_s,
                                  seen, wall, stats)
            # validator08's blocks read from its native store while open
            live = {h: v08.block_store.load_block(h).hash()
                    for h in range(1, ND_LARGE_HEIGHT + 1)}
            backend = type(v08.block_store.db).__name__
        finally:
            stop(nodes)
        others = [n for n in nodes if n is not v08]
        _nd_agree(others, ND_LARGE_HEIGHT, "c")
        from cometbft_tpu_torch.storage import BlockStore
        from cometbft_tpu_torch.storage.nativedb import NativeDB

        db = NativeDB(os.path.join(v08_home, "data", "blockstore.db"))
        try:
            stored = {h: BlockStore(db).load_block(h).hash()
                      for h in range(1, ND_LARGE_HEIGHT + 1)}
        finally:
            db.close()
        want = {h: others[0].block_store.load_block(h).hash()
                for h in range(1, ND_LARGE_HEIGHT + 1)}
        if backend != "NativeDB" or live != want or stored != want:
            raise AssertionError(
                f"phase 13 (c) / 14 (e): validator08 on {backend} disagrees "
                "with the other validators")
        keep["c"] = (nodes[0], doc, ND_LARGE_HEIGHT)
        return {**summary, "first_commit_s": seen["first"],
                "last_commit_s": seen["last"], "profile": prof,
                "native": {"backend": backend, "heights": ND_LARGE_HEIGHT,
                           "agree": True}}

    def part_d():
        doc, pvs = _nd_genesis(ND_CI_POWERS, b"nd-ext", ext_height=1)
        nodes = [run(_nd_node(doc, pv, f"ext0{i + 1}", dev))
                 for i, pv in enumerate(pvs)]
        walls, seen = [], {}
        try:
            t0 = time.perf_counter()
            for n in nodes:
                run(n.start())
            mesh_s = run(_nd_mesh(nodes, walls))
            watch(nodes, ND_EXT_HEIGHT, t0, seen)
            wall = time.perf_counter() - t0
            stats = vsched.get_scheduler().stats()
            summary = _nd_summary(nodes, ND_EXT_HEIGHT, walls, mesh_s,
                                  seen, wall, stats)
        finally:
            stop(nodes)
        _nd_agree(nodes, ND_EXT_HEIGHT, "d")
        n_ext = 0
        for n in nodes:
            ext = n.block_store.load_block_extended_commit(ND_EXT_HEIGHT - 1)
            if ext is not None and ext.ensure_extensions(True):
                n_ext = max(n_ext, sum(
                    1 for e in ext.extended_signatures
                    if e.commit_sig.is_commit() and e.extension_signature))
        if n_ext < 3:
            raise AssertionError(f"phase 13 (d): {n_ext} extension "
                                 "signatures in a stored extended commit")
        keep["d"] = (nodes[0], doc, ND_EXT_HEIGHT)
        return {**summary, "extension_signatures": n_ext}

    # the process's first trace starts slowly (seconds): start it here,
    # not while a network's timers run
    profile_call(_sync, warm=_sync)
    calls, restore = _oracle_counter()
    checks0 = sum(psc.HANDSHAKE_CHECKS.values())
    t_ph = time.perf_counter()

    def main_path():
        out["a"] = part_a()
        with tempfile.TemporaryDirectory() as d:
            out["c"] = part_c(d)
        out["d"] = part_d()
        return out

    try:
        launches, _ = _path_launches(main_path, ("ed25519_tables",
                                                 "ed25519_verify_gather"))
    finally:
        restore()
    out["main_path_s"] = time.perf_counter() - t_ph
    out["handshake_checks"] = sum(psc.HANDSHAKE_CHECKS.values()) - checks0
    out["oracle_calls"] = calls[0]
    if calls[0]:
        raise AssertionError(f"phase 13: the host oracle was called "
                             f"{calls[0]} times on the path")
    t0 = time.perf_counter()
    out["oracle_rechecked"] = {
        k: _oracle_recheck(_nd_recheck_target(node, doc), top)
        for k, (node, doc, top) in keep.items()}
    out["recheck_s"] = time.perf_counter() - t0
    loop.close()
    return launches, out


def report_node(nd, launches, card) -> None:
    """Phase 13's lines."""
    print(f"node (phase 13): main path {nd['main_path_s']:.1f} s; launches "
          f"{launches}; handshake device checks {nd['handshake_checks']}; "
          f"oracle calls on the path {nd['oracle_calls']}, stored lanes "
          f"re-checked by it afterwards {nd['oracle_rechecked']} in "
          f"{nd['recheck_s']:.1f} s")
    names = {"a": f"ci.toml {len(ND_CI_POWERS)} validators + full01",
             "c": f"large.toml {len(ND_LARGE_POWERS)} validators, "
                  f"{ND_LARGE_LATENCY_MS:g} ms latency",
             "d": "vote extensions at 4"}
    for k in ("a", "c", "d"):
        p = nd[k]
        per = p["per_height_s"]
        st = p["scheduler"]
        print(f"node ({k}) {names[k]} to height {p['heights']}: "
              f"{p['wall_s']:.2f} s, a height {[round(x, 3) for x in per]} "
              f"s (mean over heights 2-{p['heights']}: "
              f"{p['mean_height_s'] or 0:.3f}); "
              f"rounds {p['rounds']}; mesh of {p['dials']} dials in "
              f"{p['mesh_s']:.3f} s (a dial p50 {p['dial_p50_ms']:.1f} "
              f"ms); "
              f"bytes a height sent {p['bytes_sent_per_height']:.0f}, "
              f"received {p['bytes_recv_per_height']:.0f}  [{card}]")
        print(f"node ({k}) scheduler: flushes {st['batches']}, lanes a "
              f"flush {st['mean_batch_lanes']:.2f}, cache hits "
              f"{st['cache_hits']}, misses {st['cache_misses']}, one-lane "
              f"device checks {st['single_checks']}; payload by channel "
              f"{p['payload_by_channel']}  [{card}]")
        if "profile" in p:
            prof = p["profile"]
            print(f"profile node ({k}): wall {prof['wall_ms']:.1f} ms, "
                  f"device {prof['device_ms']} ms (busy "
                  f"{prof['device_busy_share']}), kernels "
                  f"{prof['kernels_ms']}  [{card}]")
    a = nd["a"]
    print(f"node (a) full01 started at height {ND_FULL_AT}, switched to "
          f"consensus at height {a['full_switch_height']} after "
          f"{a['full_switch_s']:.2f} s  [{card}]")
    print(f"node (d) extension signatures in a stored extended commit: "
          f"{nd['d']['extension_signatures']}")


# ------------------------------------- phase 14: BASELINE configs[4] on the card

ST_VALS = 10_000                 # BASELINE configs[4]: 10,000 validators
ST_SECP = 1_000                  # the first 10% hold secp256k1 keys
ST_CHAIN = "stress"              # bench.py:_child_stress's commit
ST_HEIGHT = 5
ST_REPS = 5                      # timed calls of each (a), (b) measurement
ST_TREE_LEAVES = (64, 256, 1000, 2047)   # (d): the host tree routes
ST_TREE_REPS = 20
ST_CS_HEIGHT = 3                 # (c): the mixed-key network's top
ST_RECHECK_EVERY = 20            # (a)'s lanes the oracles re-check: 1 in 20


def _stress_msgs(i: int):
    """Validator i's precommit and extension sign bytes (chain "stress",
    height 5, round 0, as ``bench.py:_child_stress`` builds them)."""
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.canonical import (
        canonical_vote_extension_sign_bytes, canonical_vote_sign_bytes)
    from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE

    bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
    return (canonical_vote_sign_bytes(ST_CHAIN, PRECOMMIT_TYPE, ST_HEIGHT, 0,
                                      bid, 1_700_000_000_000_000_000 + i),
            canonical_vote_extension_sign_bytes(ST_CHAIN, ST_HEIGHT, 0,
                                                b"ext%d" % i))


def _stress_sign(task):
    """Pool worker: validators lo..hi-1 of configs[4], the first
    ``n_secp`` of the set secp256k1, as (key type, public key, precommit
    signature, extension signature), keys and signatures from the native
    signers."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey

    lo, hi, n_secp = task
    out = []
    for i in range(lo, hi):
        cls = Secp256k1PrivKey if i < n_secp else Ed25519PrivKey
        priv = cls.from_secret(b"stress%d" % i)
        sb, eb = _stress_msgs(i)
        out.append((priv.type(), priv.pub_key().bytes(), priv.sign(sb),
                    priv.sign(eb)))
    return out


def _flip(sig: bytes, at: int = 40) -> bytes:
    return sig[:at] + bytes([sig[at] ^ 1]) + sig[at + 1:]


def _oracle_verify(pub, msg: bytes, sig: bytes) -> bool:
    """The pure-Python oracles: ZIP-215 for Ed25519, big-int ECDSA for
    secp256k1."""
    from cometbft_tpu_torch.crypto import _ed25519_py, _secp256k1_py

    if pub.type() == "secp256k1":
        return len(sig) == 64 and _secp256k1_py.verify(
            pub.bytes(), msg, int.from_bytes(sig[:32], "big"),
            int.from_bytes(sig[32:], "big"))
    return _ed25519_py.verify_zip215(pub.bytes(), msg, sig)


def phase_stress(pool, dev):
    """Phase 14: BASELINE configs[4] on the card ("10k-validator
    ExtendedCommit w/ vote extensions + secp256k1 mixed keys"):

    (a) the stress batch: ``ST_VALS`` validators, the first ``ST_SECP``
        secp256k1 (``from_secret(b"stress%d")``), the rest Ed25519, each
        signing a precommit and an extension: 20,000 lanes in one
        ``create_batch_verifier()`` on the card (Ed25519 lanes in one
        device call, secp256k1 lanes on host threads meanwhile), every
        lane ok; one tampered Ed25519 and one tampered secp256k1 lane
        caught at their indices; sigs/s and p50 over ``ST_REPS`` calls,
        the host secp256k1 lanes alone (on the host threads and on one
        thread), the Ed25519 lanes alone, and the device busy share;
    (b) a ``ST_VALS``-validator mixed ``Commit`` of the same keys and
        precommits: ``VerifyCommit`` and ``VerifyCommitLight`` p50 over
        ``ST_REPS`` calls, a commit with a bad secp256k1 lane rejected at
        its lane, ``ValidatorSet.hash`` of the mixed set through the tree
        kernel equal to hashlib;
    (c) consensus in one process on the card: validator 0 secp256k1,
        three Ed25519, to height ``ST_CS_HEIGHT``, the secp256k1
        signature in the stored commits;
    (d) the host trees: native (``kv_merkle_levels``, ``kv_merkle_root``)
        against the hashlib level loop at ``ST_TREE_LEAVES`` leaves of
        the set's validator encodings, equal roots and levels, median of
        ``ST_TREE_REPS`` calls each.

    (e), validator08 of phase 13 (c) on the native database, is reported
    with phase 13.  The launch counters are zeroed just before (a)-(c)'s
    first calls and read just after (the main path); the Ed25519 oracle
    must not be called there, and afterwards one lane in
    ``ST_RECHECK_EVERY`` of (a) and every stored lane of (c) are
    re-checked by the pure-Python oracles."""
    import asyncio

    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.crypto.keys import pub_key_from_type_bytes
    from cometbft_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey
    from cometbft_tpu_torch.testing import make_inproc_network
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.priv_validator import MockPV
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    out: dict = {}
    t0 = time.perf_counter()
    spans = [(lo, min(lo + 250, ST_VALS), ST_SECP)
             for lo in range(0, ST_VALS, 250)]
    rows = [r for part in pool.map(_stress_sign, spans) for r in part]
    pubs = [pub_key_from_type_bytes(kt, pk) for kt, pk, _, _ in rows]
    items = []
    for i, (_, _, s1, s2) in enumerate(rows):
        sb, eb = _stress_msgs(i)
        items += [(pubs[i], sb, s1), (pubs[i], eb, s2)]
    out["fixture_s"] = time.perf_counter() - t0
    secp_lanes = [j for j, it in enumerate(items)
                  if it[0].type() == "secp256k1"]
    ed_items = [it for it in items if it[0].type() == "ed25519"]
    secp_raw = [(items[j][0].bytes(), items[j][1], items[j][2])
                for j in secp_lanes]
    out["lanes"] = {"all": len(items), "secp256k1": len(secp_lanes),
                    "ed25519": len(ed_items)}

    def batch(its):
        bv = cbatch.create_batch_verifier(dev)
        for it in its:
            bv.add(*it)
        return bv.verify()

    bad_ed = 2 * ((ST_SECP + ST_VALS) // 2)    # a precommit lane, Ed25519
    bad_secp = 2 * 17 + 1                  # an extension lane, secp256k1
    tampered = list(items)
    for j in (bad_ed, bad_secp):
        p, m, sg = tampered[j]
        tampered[j] = (p, m, _flip(sg))

    # (b)'s commit: the set sorted by address, lane of validator i signed
    # by its precommit (the same sign bytes)
    bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
    vals = ValidatorSet([Validator(p, 10) for p in pubs])
    index = {p.address(): i for i, p in enumerate(pubs)}
    sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                      1_700_000_000_000_000_000 + index[v.address],
                      rows[index[v.address]][2]) for v in vals.validators]
    commit = Commit(ST_HEIGHT, 0, bid, sigs)
    bad_lane = next(k for k, v in enumerate(vals.validators)
                    if v.pub_key.type() == "secp256k1")
    bad_commit = Commit(ST_HEIGHT, 0, bid, [
        CommitSig(c.block_id_flag, c.validator_address, c.timestamp_ns,
                  _flip(c.signature) if k == bad_lane else c.signature)
        for k, c in enumerate(sigs)])
    encodings = [v.simple_encode() for v in vals.validators]
    want_hash = merkle.hash_from_byte_slices(encodings)

    def verify_commit():
        V.VerifyCommit(ST_CHAIN, vals, bid, ST_HEIGHT, commit, device=dev)

    def verify_light():
        V.VerifyCommitLight(ST_CHAIN, vals, bid, ST_HEIGHT, commit,
                            device=dev)

    def rejected(fn_name):
        try:
            getattr(V, fn_name)(ST_CHAIN, vals, bid, ST_HEIGHT, bad_commit,
                                device=dev)
        except V.ErrInvalidSignature as e:
            return e.idx
        return None

    loop = asyncio.new_event_loop()
    cs_top = {}

    def part_c():
        def pv_factory(i):
            if i == 0:
                return MockPV(Secp256k1PrivKey.from_secret(b"mixsecp%d" % i))
            return MockPV.from_secret(b"mixed%d" % i)

        async def go():
            net = await make_inproc_network(4, chain_id=CHAIN_ID, device=dev,
                                            pv_factory=pv_factory)
            try:
                t1 = time.perf_counter()
                await net.start()
                await net.wait_for_height(ST_CS_HEIGHT, timeout=CS_TIMEOUT_S)
                wall = time.perf_counter() - t1
            finally:
                await net.stop()
            _check_agreement(net, ST_CS_HEIGHT)
            return net, wall

        net, wall = loop.run_until_complete(go())
        node = net.nodes[0]
        c3 = node.block_store.load_block(ST_CS_HEIGHT).last_commit
        vs = node.state_store.load_validators(ST_CS_HEIGHT - 1)
        kinds = sorted({vs.get_by_index(k).pub_key.type()
                        for k, cs in enumerate(c3.signatures)
                        if cs.is_commit()})
        if kinds != ["ed25519", "secp256k1"]:
            raise AssertionError(f"phase 14 (c): block {ST_CS_HEIGHT}'s "
                                 f"last commit holds {kinds} lanes")
        cs_top["node"] = node
        return {"wall_s": wall, "lane_kinds": kinds,
                "height": node.block_store.height()}

    calls, restore = _oracle_counter()
    host0 = dict(cbatch.HOST_LANES)

    def main_path():
        ok, lanes = batch(items)
        if not ok or not all(lanes):
            raise AssertionError(f"phase 14 (a): {lanes.count(False)} of "
                                 f"{len(lanes)} lanes rejected")
        ok, lanes = batch(tampered)
        caught = [j for j, v in enumerate(lanes) if not v]
        if ok or caught != sorted((bad_ed, bad_secp)):
            raise AssertionError(f"phase 14 (a): tampered lanes caught at "
                                 f"{caught}, want {[bad_secp, bad_ed]}")
        out["caught"] = caught
        verify_commit()
        verify_light()
        out["rejected_at"] = {f: rejected(f) for f in
                              ("VerifyCommit", "VerifyCommitLight")}
        if set(out["rejected_at"].values()) != {bad_lane}:
            raise AssertionError(f"phase 14 (b): bad lane {bad_lane} "
                                 f"rejected at {out['rejected_at']}")
        got = vals.hash(dev)
        if got != want_hash:
            raise AssertionError("phase 14 (b): ValidatorSet.hash differs "
                                 "from hashlib")
        out["c"] = part_c()

    t0 = time.perf_counter()
    try:
        launches, _ = _path_launches(main_path, (
            "ed25519_tables", "ed25519_rlc_gather", "ed25519_verify_gather",
            "merkle_tree_leaves"))
    finally:
        restore()
    out["main_path_s"] = time.perf_counter() - t0
    out["oracle_calls"] = calls[0]
    if calls[0]:
        raise AssertionError(f"phase 14: the Ed25519 oracle was called "
                             f"{calls[0]} times on the path")
    out["host_lanes_main_path"] = {
        k: v - host0.get(k, 0) for k, v in cbatch.HOST_LANES.items()}

    # (a) timed
    out["batch"] = time_host_spread(lambda: batch(items), ST_REPS)
    out["sigs_per_s"] = len(items) / out["batch"]["p50_ms"] * 1e3
    out["ed25519_only"] = time_host_spread(lambda: batch(ed_items), ST_REPS)
    out["secp_threads"] = time_host_spread(
        lambda: native.secp256k1_verify_lanes(secp_raw).result(), ST_REPS)
    chunk = native.SECP_CHUNK
    native.SECP_CHUNK = len(secp_raw)
    try:
        out["secp_one_thread"] = time_host_spread(
            lambda: native.secp256k1_verify_lanes(secp_raw).result(), 3)
    finally:
        native.SECP_CHUNK = chunk
    out["profile_batch"] = profile_call(lambda: batch(items))
    # (b) timed
    out["verify_commit"] = time_host_spread(verify_commit, ST_REPS)
    out["verify_commit_light"] = time_host_spread(verify_light, ST_REPS)
    out["valset_hash"] = time_host_spread(lambda: vals.hash(dev), ST_REPS)
    out["profile_verify_commit"] = profile_call(verify_commit)
    # (d) the host tree routes
    trees = {}
    for n in ST_TREE_LEAVES:
        leaves = encodings[:n]
        lv_h = merkle._levels_hashlib(leaves)
        lv_n = native.merkle_levels(leaves)
        if lv_h != lv_n or native.merkle_root(leaves) != lv_h[-1][0] or \
                lv_h[-1][0] != merkle.hash_from_byte_slices(leaves):
            raise AssertionError(f"phase 14 (d): native tree differs at {n}")

        def med(fn):
            ts = []
            for _ in range(ST_TREE_REPS):
                t1 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t1) * 1e3)
            return statistics.median(ts)

        trees[n] = {
            "levels_hashlib_ms": med(lambda: merkle._levels_hashlib(leaves)),
            "levels_native_ms": med(lambda: native.merkle_levels(leaves)),
            "root_native_ms": med(lambda: native.merkle_root(leaves))}
        trees[n]["faster"] = ("native" if trees[n]["levels_native_ms"]
                              < trees[n]["levels_hashlib_ms"] else "hashlib")
    out["trees"] = trees
    out["sha_ni"] = "sha_ni" in native._host_id()
    # the oracles over (a)'s lanes and (c)'s stored commits
    t0 = time.perf_counter()
    sample = range(0, len(items), ST_RECHECK_EVERY)
    bad = [j for j in sample if not _oracle_verify(*items[j])]
    if bad:
        raise AssertionError(f"phase 14: oracle rejects lanes {bad[:5]}")
    node = cs_top["node"]
    rechecked = 0
    for h in range(1, ST_CS_HEIGHT + 1):
        vs = node.state_store.load_validators(h) or node.state.validators
        c = node.block_store.load_block_commit(h) or \
            node.block_store.load_seen_commit()
        for k, cs in enumerate(c.signatures):
            if cs.is_absent():
                continue
            if not _oracle_verify(vs.get_by_index(k).pub_key,
                                  c.vote_sign_bytes(CHAIN_ID, k),
                                  cs.signature):
                raise AssertionError(f"phase 14 (c): stored commit {h} "
                                     f"lane {k} fails the oracle")
            rechecked += 1
    out["oracle_rechecked"] = {"a": len(sample), "c": rechecked}
    out["recheck_s"] = time.perf_counter() - t0
    loop.close()
    return launches, out


def report_stress(st, launches, card, nd=None) -> None:
    """Phase 14's lines ((e) from phase 13's part (c))."""
    print(f"stress (phase 14): {st.get('phase_s', 0.0):.1f} s; fixture "
          f"{st['fixture_s']:.1f} s (native signers in the pool), main path "
          f"{st['main_path_s']:.1f} s; "
          f"lanes {st['lanes']}; launches {launches}; host lanes on the "
          f"path {st['host_lanes_main_path']}; Ed25519 oracle calls on the "
          f"path {st['oracle_calls']}; re-checked by the oracles "
          f"{st['oracle_rechecked']} in {st['recheck_s']:.1f} s")
    print(f"stress (a) {st['lanes']['all']} lanes in one batch verifier: "
          f"{st['sigs_per_s']:.0f} sigs/s, {_spread(st['batch'])}; "
          f"tampered lanes caught at {st['caught']}  [{card}]")
    print(f"stress (a) apart: Ed25519 lanes alone {_spread(st['ed25519_only'])}"
          f"; secp256k1 lanes on host threads "
          f"{_spread(st['secp_threads'])}; on one thread "
          f"{_spread(st['secp_one_thread'])}  [{card}]")
    prof = st["profile_batch"]
    print(f"profile stress (a): wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']} ms (busy {prof['device_busy_share']}), "
          f"kernels {prof['kernels_ms']}  [{card}]")
    print(f"stress (b) VerifyCommit@{ST_VALS} mixed: "
          f"{_spread(st['verify_commit'])}; VerifyCommitLight: "
          f"{_spread(st['verify_commit_light'])}; bad secp256k1 lane "
          f"rejected at {st['rejected_at']}  [{card}]")
    print(f"stress (b) ValidatorSet.hash@{ST_VALS} mixed (tree kernel, "
          f"equal to hashlib): {_spread(st['valset_hash'])}  [{card}]")
    prof = st["profile_verify_commit"]
    print(f"profile stress (b) VerifyCommit: wall {prof['wall_ms']:.1f} ms,"
          f" device {prof['device_ms']} ms (busy "
          f"{prof['device_busy_share']}), kernels {prof['kernels_ms']}  "
          f"[{card}]")
    c = st["c"]
    print(f"stress (c) mixed-key consensus, 4 validators (1 secp256k1) to "
          f"height {ST_CS_HEIGHT}: {c['wall_s']:.2f} s; lanes of block "
          f"{ST_CS_HEIGHT}'s last commit {c['lane_kinds']}  [{card}]")
    for n, t in st["trees"].items():
        print(f"stress (d) host tree at {n} leaves (median of "
              f"{ST_TREE_REPS}): hashlib levels {t['levels_hashlib_ms']:.3f}"
              f" ms, native levels {t['levels_native_ms']:.3f} ms, native "
              f"root {t['root_native_ms']:.3f} ms; faster {t['faster']}  "
              f"[{card}]")
    print(f"stress (d) merkle.py's route from 64 leaves: native; host CPU "
          f"has SHA-NI: {st['sha_ni']}")
    if nd is not None and "native" in nd.get("c", {}):
        e = nd["c"]["native"]
        print(f"stress (e) = node (c): validator08 on the native database "
              f"({e['backend']}), {e['heights']} heights, every block equal "
              f"to the other 11 validators' while running and read back "
              f"from its files after the stop: {e['agree']}  [{card}]")


RPC_ANCHORS = 96                 # (b): heights a request serves, anchors
RPC_BIG_HEIGHTS = 4              # (c): heights of BIG_VALS validators
RPC_PROOF_SAMPLE = 1000          # (c): validator proofs checked by hashlib
RPC_BAD_ANCHOR = 40              # (b): the anchor whose lane RPC_BAD_LANE
RPC_BAD_LANE = 7                 #      carries a flipped signature bit
RPC_COLD_RUNS = 3                # (b): cold light_verify calls, new tiers
RPC_REPS = 5                     # timed calls of a route or a warm call
RPC_KERNELS = ("ed25519_tables", "ed25519_rlc_gather",
               "ed25519_verify_gather", "merkle_tree_leaves")


async def _rpc_submit(cli, method: str, sheds: list, **params):
    """A tx route called as a client would: the node's overload shed
    (-32099, the loop's lag past ``rpc.overload_shed_lag_s``) and the
    admission gate's 503 (-32000) are retried after a pause; each is
    counted in ``sheds``."""
    import asyncio

    from cometbft_tpu_torch.rpc import RPCError

    for _ in range(200):
        try:
            return await cli.call(method, **params)
        except RPCError as e:
            if e.code not in (-32099, -32000):
                raise
            sheds.append(e.code)
            await asyncio.sleep(0.1)
    raise AssertionError(f"phase 15: {method} shed 200 times")


async def _rpc_timed(cli, method: str, reps: int, **params) -> dict:
    """p50, min and max ms of ``reps`` calls of one route over HTTP."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        await cli.call(method, **params)
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"p50": statistics.median(ts), "min": min(ts), "max": max(ts)}


def _ms(fn) -> float:
    """Wall ms of one call of ``fn``."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _rpc_spread(ts: list) -> dict:
    return {"p50": statistics.median(ts), "min": min(ts), "max": max(ts),
            "n": len(ts)}


def _min_lanes(commit, vals) -> int:
    """Lanes of a commit's light scope: its signed lanes in order until
    their power passes two thirds of the set's."""
    needed = vals.total_voting_power() * 2 // 3
    tally = lanes = 0
    for cs, v in zip(commit.signatures, vals.validators):
        if not cs.is_commit():
            continue
        tally += v.voting_power
        lanes += 1
        if tally > needed:
            break
    return lanes


class _LightStores:
    """Block and state store views over light blocks (part (c)): what
    the serving tier reads of a node's stores."""

    def __init__(self, blocks):
        from types import SimpleNamespace

        self.by_h = {lb.height: lb for lb in blocks}
        self._ns = SimpleNamespace

    def base(self):
        return min(self.by_h)

    def height(self):
        return max(self.by_h)

    def load_block(self, h):
        lb = self.by_h.get(h)
        return None if lb is None else self._ns(
            header=lb.header, data=self._ns(txs=[]))

    def load_block_commit(self, h):
        lb = self.by_h.get(h)
        return None if lb is None else lb.commit

    def load_block_meta(self, h):
        lb = self.by_h.get(h)
        return None if lb is None else self._ns(block_id=lb.commit.block_id)

    def load_seen_commit(self):
        return None

    def load_validators(self, h):
        lb = self.by_h.get(h)
        return None if lb is None else lb.validators


def _serve(tier):
    """An ``RPCServer`` over a serving tier alone (the light routes)."""
    from types import SimpleNamespace

    from cometbft_tpu_torch.rpc import RPCServer

    return RPCServer(SimpleNamespace(light_serve=tier, config=None,
                                     event_bus=None, home=None))


def phase_rpc(pool, keys, dev):
    """Phase 15: the RPC surface and light-client serving on the card,
    in a process of its own (:func:`phase_fresh`).

    (a) ``networks/ci.toml``'s 4 validators, each with an ``RPCServer``
        on its own loopback port, meshed before consensus, to height
        ``ND_CI_HEIGHT``: ``ND_TXS`` txs through ``broadcast_tx_commit``
        over HTTP (sheds retried and counted), ``tx`` with its proof,
        ``tx_search``, ``block_search``, a ``WSClient`` on
        ``tm.event='NewBlock'`` and one on ``tm.event='Tx'``,
        ``abci_query`` proofs through ``ProofOperators`` against the next
        header's app hash, ``light_proofs`` of the txs, ``block``,
        ``commit`` and ``validators`` equal on all four nodes, each
        route's p50, min and max over HTTP;
    (d) while they run: ``light.Client`` over ``RPCProvider``s,
        sequential and skipping to the tip, ``run_light_proxy``'s
        verified ``block``, ``commit`` and ``abci_query``, and a primary
        serving a forged header refused;
    (b) a ``LightServeTier`` behind an ``RPCServer`` over the stores of
        phase 11's ``BS_VALS``-validator source chain (BASELINE
        configs[3]'s width, built here): ``light_blocks`` of
        ``RPC_ANCHORS`` heights cold and warm, ``light_verify`` of
        ``RPC_ANCHORS`` anchors cold (one K6a launch; ``RPC_COLD_RUNS``
        new tiers) and from the memo, a batch with one flipped signature
        bit (that anchor refused, K5b naming its lane, every other
        anchor ok), ``light_proofs`` of the validators (the native tree)
        and of the (empty) tx list against the header's hashes, the
        device busy share of a cold verify;
    (c) ``RPC_BIG_HEIGHTS`` heights of ``BIG_VALS`` validators (BASELINE
        configs[4]'s width): ``light_proofs(kind="validator")`` builds
        the tree with ``merkle_tree_leaves`` (root = validators_hash,
        ``RPC_PROOF_SAMPLE`` proofs checked by hashlib), and
        ``light_verify`` of the ``RPC_BIG_HEIGHTS`` anchors.

    The counters are zeroed just before (a) and read just after (c):
    K5a, K5b, K6a and ``merkle_tree_leaves`` must have launched, no plain
    version and no ``OFF_PATH`` kernel; the pure-Python oracle's calls
    must be 0."""
    import asyncio
    import random

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto.merkle import (Proof, ProofOp,
                                                  ProofOperators)
    from cometbft_tpu_torch.light import (SEQUENTIAL, SKIPPING, Client,
                                          LightClientError, LightServeTier,
                                          RPCProvider, TrustOptions,
                                          run_light_proxy)
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.rpc import HTTPClient, RPCServer, WSClient
    from cometbft_tpu_torch.rpc import core as rcore
    from cometbft_tpu_torch.rpc.json import from_jsonable, jsonable
    from cometbft_tpu_torch.types.header import tx_hash

    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    out: dict = {}
    t0 = time.perf_counter()
    src = SourceChain(pool, keys[:BS_VALS], dev, loop)
    big_vals, big = light_chain(pool, keys[:BIG_VALS], RPC_BIG_HEIGHTS, dev)
    out["fixture_s"] = time.perf_counter() - t0
    print(f"rpc fixture: {BS_HEIGHTS} heights of {BS_VALS} and "
          f"{RPC_BIG_HEIGHTS} of {BIG_VALS} in {out['fixture_s']:.1f} s")
    marks: dict = {}

    def mark(part):
        marks[part] = dict(_build.LAUNCHES)

    def part_ad():
        doc, pvs = _nd_genesis(ND_CI_POWERS, b"rpc-ci")
        nodes = [run(_nd_node(doc, pv, f"validator0{i + 1}", dev,
                              rpc_laddr="tcp://127.0.0.1:0"))
                 for i, pv in enumerate(pvs)]
        try:
            t_a = time.perf_counter()
            for n in nodes:
                run(n.start(consensus=False))
            walls: list = []
            run(_nd_mesh(nodes, walls))
            for n in nodes:
                run(n.start_consensus())
            a = run(_part_a(nodes))
            a["wall_s"] = time.perf_counter() - t_a
            mark("a")
            t_d = time.perf_counter()
            d = run(_part_d(nodes, a["top"]))
            d["wall_s"] = time.perf_counter() - t_d
            mark("d")
        finally:
            for n in nodes:
                run(n.stop())
        return a, d

    async def _part_a(nodes):
        sheds: list = []
        clis = [HTTPClient(*n.rpc_addr) for n in nodes]
        ws_blk = await WSClient.connect(*nodes[1].rpc_addr)
        await ws_blk.subscribe("tm.event='NewBlock'")
        ws_tx = await WSClient.connect(*nodes[2].rpc_addr)
        await ws_tx.subscribe("tm.event='Tx'")
        seen = {"blocks": [], "txs": []}

        async def pump(ws, key):
            while True:
                e = await ws.next_event(timeout=ND_TIMEOUT_S)
                v = e["data"]["value"]
                seen[key].append(v["block"]["hdr"]["h"] if key == "blocks"
                                 else e["events"]["tx.hash"])

        pumps = [asyncio.ensure_future(pump(ws_blk, "blocks")),
                 asyncio.ensure_future(pump(ws_tx, "txs"))]
        txs = [b"rpc%d=val%d" % (i, i) for i in range(ND_TXS)]
        senders = [HTTPClient(*nodes[i % 4].rpc_addr) for i in range(ND_TXS)]
        t0 = time.perf_counter()
        res = await asyncio.gather(*(
            _rpc_submit(c, "broadcast_tx_commit", sheds, tx=tx.hex())
            for c, tx in zip(senders, txs)))
        commit_s = time.perf_counter() - t0
        for c in senders:
            await c.close()
        if any(r["tx_result"]["code"] for r in res):
            raise AssertionError(f"phase 15 (a): a tx failed: {res}")
        tx_h = {tx: r["height"] for tx, r in zip(txs, res)}

        async def reach(h):
            while min(n.height() for n in nodes) < h:
                await asyncio.sleep(0.01)

        top = max(ND_CI_HEIGHT, max(tx_h.values()) + 2)
        await asyncio.wait_for(reach(top), ND_TIMEOUT_S)
        await asyncio.sleep(0.5)             # the last events land
        for p in pumps:
            p.cancel()
        await ws_blk.close()
        await ws_tx.close()
        v0 = nodes[0]
        checked = {"tx_proofs": 0, "query_proofs": 0, "tx_search": 0}
        for i, (tx, h) in enumerate(tx_h.items()):
            cli = clis[i % 4]
            r = await cli.call("tx", hash=tx_hash(tx).hex(), prove=True)
            header = v0.block_store.load_block(h).header
            pf = r["proof"]["proof"]
            proof = Proof(pf["total"], pf["index"],
                          bytes.fromhex(pf["leaf_hash"]),
                          tuple(bytes.fromhex(x) for x in pf["aunts"]))
            if r["height"] != h or not proof.verify(header.data_hash,
                                                    tx_hash(tx)):
                raise AssertionError(f"phase 15 (a): tx proof of {tx}")
            checked["tx_proofs"] += 1
            key = tx.split(b"=")[0]
            found = await cli.call("tx_search",
                                   query=f"app.key='{key.decode()}'")
            if [t["hash"] for t in found["txs"]] != [r["hash"]]:
                raise AssertionError(f"phase 15 (a): tx_search {found}")
            checked["tx_search"] += 1
            q = (await cli.call("abci_query", data=key.hex(),
                                prove=True))["response"]
            await asyncio.wait_for(reach(q["height"] + 1), ND_TIMEOUT_S)
            nxt = v0.block_store.load_block(q["height"] + 1).header
            ProofOperators.decode([
                ProofOp(o["type"], bytes.fromhex(o["key"]),
                        bytes.fromhex(o["data"]))
                for o in q["proof_ops"]]).verify(
                nxt.app_hash, [key], bytes.fromhex(q["value"]))
            checked["query_proofs"] += 1
        allp = await clis[0].call("tx_search", query="tx.height >= 1",
                                  per_page=100)
        if allp["total_count"] != len(txs):
            raise AssertionError(f"phase 15 (a): tx_search total {allp}")
        blocks = await clis[1].call(
            "block_search", query=f"block.height >= 1 AND block.height <= "
            f"{top}", per_page=100)
        if blocks["heights"] != list(range(1, top + 1)):
            raise AssertionError(f"phase 15 (a): block_search {blocks}")
        for h in sorted(set(tx_h.values())):
            pr = await clis[3].call("light_proofs", height=h, kind="tx")
            if pr["root"] != v0.block_store.load_block(h).header \
                    .data_hash.hex():
                raise AssertionError(f"phase 15 (a): tx proofs at {h}")
        agree = 0
        for h in range(1, top):
            # one JSON-RPC batch a node: block, commit and validators
            calls = [(route, {"height": h})
                     for route in ("block", "commit", "validators")]
            got = [await c.call_batch(calls) for c in clis]
            if any(g != got[0] for g in got[1:]) or any(
                    isinstance(x, Exception) for x in got[0]):
                raise AssertionError(f"phase 15 (a): block, commit or "
                                     f"validators at {h} differ")
            agree += len(calls)
        first = seen["blocks"][0] if seen["blocks"] else None
        if first is None or seen["blocks"] != list(
                range(first, first + len(seen["blocks"]))) or \
                seen["blocks"][-1] < top:
            raise AssertionError(f"phase 15 (a): NewBlock events "
                                 f"{seen['blocks']}")
        if sorted(seen["txs"]) != sorted(tx_hash(t).hex() for t in txs):
            raise AssertionError(f"phase 15 (a): Tx events {seen['txs']}")
        h_mid = sorted(tx_h.values())[0]
        routes = {}
        for route, params in (
                ("health", {}), ("status", {}), ("block", {"height": h_mid}),
                ("header", {"height": h_mid}),
                ("commit", {"height": h_mid}),
                ("validators", {"height": h_mid}),
                ("tx", {"hash": tx_hash(txs[0]).hex(), "prove": True}),
                ("tx_search", {"query": "tx.height >= 1"}),
                ("block_search", {"query": "block.height >= 1"}),
                ("abci_query", {"data": b"rpc0".hex(), "prove": True}),
                ("light_block", {"height": h_mid}),
                ("light_proofs", {"height": h_mid, "kind": "tx"})):
            routes[route] = await _rpc_timed(clis[0], route, RPC_REPS,
                                             **params)
        for c in clis:
            await c.close()
        return {"top": top, "tx_heights": sorted(tx_h.values()),
                "commit_wall_s": commit_s, "sheds": len(sheds),
                "shed_codes": sorted(set(sheds)), "checked": checked,
                "agree_checks": agree, "ws_blocks": len(seen["blocks"]),
                "ws_txs": len(seen["txs"]), "routes_ms": routes,
                "traffic": _nd_traffic(nodes)}

    async def _part_d(nodes, top):
        v0 = nodes[0]
        trust = TrustOptions(TRUSTING_PERIOD_NS, 1,
                             v0.block_store.load_block(1).hash())
        # the tip when (d) starts: the chain moves on meanwhile, so a
        # sequential client chasing the moving tip has no fixed work
        tip_h = min(n.height() for n in nodes)
        modes = {}
        for mode in (SEQUENTIAL, SKIPPING):
            t0 = time.perf_counter()
            primary = RPCProvider(*v0.rpc_addr, "primary")
            c = Client(CHAIN_ID, trust, primary,
                       witnesses=[RPCProvider(*nodes[1].rpc_addr, "w1")],
                       mode=mode, device=dev)
            lb = await c.verify_light_block_at_height(tip_h)
            if lb.header.hash() != v0.block_store.load_block(tip_h).hash():
                raise AssertionError(f"phase 15 (d): {mode} verified "
                                     "another header")
            modes[mode] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "tip": tip_h,
                           "trusted": len(c.store.db._data),
                           "served_in_one_call":
                               primary._has_light_block is True}
        t0 = time.perf_counter()
        moved = await c.update()               # skipping to the live tip
        modes["update"] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "tip": moved.height if moved else None,
                           "trusted": len(c.store.db._data),
                           "served_in_one_call": True}
        server, paddr = await run_light_proxy(c, HTTPClient(*v0.rpc_addr))
        try:
            pc = HTTPClient(*paddr)
            blk = await pc.call("block", height=top - 1)
            cm = await pc.call("commit", height=top - 1)
            q = await pc.call("abci_query", path="/key",
                              data=b"rpc1".hex())
            if not (blk["verified"] and cm["verified"] and q["verified"]) \
                    or bytes.fromhex(q["response"]["value"]) != b"val1":
                raise AssertionError("phase 15 (d): proxy answers")
            proxy_ms = await _rpc_timed(pc, "commit", RPC_REPS,
                                        height=top - 1)
            await pc.close()
        finally:
            await server.close()

        async def forged(env, height=None):
            res = copy.deepcopy(await rcore.light_block(env, height))
            res["light_block"]["header"]["ah"] = {"~b": "77" * 32}
            return res

        liar = RPCServer(v0, routes={"light_block": forged})
        laddr = await liar.listen()
        try:
            c = Client(CHAIN_ID, trust, RPCProvider(*laddr, "liar"),
                       device=dev)
            try:
                await c.verify_light_block_at_height(top - 2)
                refused = None
            except LightClientError as e:
                refused = type(e).__name__
        finally:
            await liar.close()
        if refused is None:
            raise AssertionError("phase 15 (d): a forged header was "
                                 "trusted")
        return {"modes": modes, "proxy_commit_ms": proxy_ms,
                "forged_refused": refused}

    def part_b():
        heights = list(range(1, RPC_ANCHORS + 1))
        commits = {h: src.store.load_block_commit(h) for h in heights}
        anchors = [{"height": h, "commit": jsonable(commits[h])}
                   for h in heights]
        vals = src.state.validators
        lanes = sum(_min_lanes(commits[h], vals) for h in heights)
        if SWEEP_KEYS.get(lanes) != len(vals):
            raise AssertionError(
                f"phase 15 (b): {lanes} lanes of {len(vals)} keys is not "
                f"a shape of phase 3's sweep ({SWEEP_KEYS})")

        # the serving node's clock just past its tip: the trusting
        # period's window holds the whole chain (the fixture's block times
        # are fixed, so the wall clock would put them out of it)
        tip_ns = src.store.load_block(BS_HEIGHTS).header.time_ns

        def tier():
            return LightServeTier(src.store, src.state_store, CHAIN_ID,
                                  device=dev,
                                  now_ns=lambda: tip_ns + 60 * 10**9)

        async def main():
            t = tier()
            srv = _serve(t)
            cli = HTTPClient(*await srv.listen())
            try:
                r = {}
                t0 = time.perf_counter()
                lbs = await cli.call("light_blocks", heights=heights)
                r["light_blocks_cold_ms"] = (time.perf_counter() - t0) * 1e3
                for e in lbs["light_blocks"]:
                    blk = src.store.load_block(e["height"])
                    if e["light_block"]["header"] != jsonable(blk.header):
                        raise AssertionError("phase 15 (b): light block "
                                             f"{e['height']}")
                r["light_blocks_warm_ms"] = await _rpc_timed(
                    cli, "light_blocks", RPC_REPS, heights=heights)
                if t.stats()["header_hits"] < RPC_ANCHORS * RPC_REPS:
                    raise AssertionError("phase 15 (b): warm light_blocks "
                                         f"missed the cache: {t.stats()}")
                # the tier alone, without HTTP and JSON
                r["light_blocks_warm_direct_ms"] = _rpc_spread(
                    [_ms(lambda: t.light_blocks(heights))
                     for _ in range(RPC_REPS)])
                r["verify_cold_direct_ms"] = _ms(
                    lambda: tier().verify_commits(anchors))
                r["anchor_decode_ms"] = _ms(
                    lambda: [from_jsonable(a["commit"]) for a in anchors])
                k6a = _build.LAUNCHES.get("ed25519_rlc_gather", 0)
                disp = dict(cbatch.DISPATCHES)
                t0 = time.perf_counter()
                v = await cli.call("light_verify", anchors=anchors)
                cold = [(time.perf_counter() - t0) * 1e3]
                r["cold_k6a_launches"] = _build.LAUNCHES.get(
                    "ed25519_rlc_gather", 0) - k6a
                r["cold_dispatches"] = {
                    k: n - disp.get(k, 0) for k, n in
                    cbatch.DISPATCHES.items() if n - disp.get(k, 0)}
                if v["ok"] != RPC_ANCHORS or r["cold_k6a_launches"] != 1:
                    raise AssertionError(f"phase 15 (b): cold verify "
                                         f"{v['ok']} ok, K6a launches "
                                         f"{r['cold_k6a_launches']}")
                k6a = _build.LAUNCHES.get("ed25519_rlc_gather", 0)
                memo = await _rpc_timed(cli, "light_verify", RPC_REPS,
                                        anchors=anchors)
                again = await cli.call("light_verify", anchors=anchors)
                if not all(x["cached"] for x in again["results"]) or \
                        _build.LAUNCHES.get("ed25519_rlc_gather", 0) != k6a:
                    raise AssertionError("phase 15 (b): the memo missed")
                r["memo_ms"] = memo
                for _ in range(RPC_COLD_RUNS - 1):
                    t2 = tier()
                    s2 = _serve(t2)
                    c2 = HTTPClient(*await s2.listen())
                    t0 = time.perf_counter()
                    await c2.call("light_verify", anchors=anchors)
                    cold.append((time.perf_counter() - t0) * 1e3)
                    await c2.close()
                    await s2.close()
                r["cold_ms"] = _rpc_spread(cold)
                bad = copy.deepcopy(anchors)
                sig = bad[RPC_BAD_ANCHOR]["commit"]["sigs"][RPC_BAD_LANE]
                raw = bytearray.fromhex(sig["sig"]["~b"])
                raw[9] ^= 0x10
                sig["sig"]["~b"] = raw.hex()
                tb = tier()
                sb = _serve(tb)
                cb = HTTPClient(*await sb.listen())
                k5b = _build.LAUNCHES.get("ed25519_verify_gather", 0)
                t0 = time.perf_counter()
                vb = await cb.call("light_verify", anchors=bad)
                r["tampered_ms"] = (time.perf_counter() - t0) * 1e3
                r["tampered_k5b_launches"] = _build.LAUNCHES.get(
                    "ed25519_verify_gather", 0) - k5b
                oks = [x["ok"] for x in vb["results"]]
                want = [i != RPC_BAD_ANCHOR for i in range(RPC_ANCHORS)]
                err = vb["results"][RPC_BAD_ANCHOR].get("error", "")
                if oks != want or f"#{RPC_BAD_LANE}" not in err or \
                        not r["tampered_k5b_launches"]:
                    raise AssertionError(f"phase 15 (b): tampered batch "
                                         f"{vb['ok']} ok, error {err!r}")
                r["tampered_error"] = err
                await cb.close()
                await sb.close()
                h = RPC_ANCHORS
                header = src.store.load_block(h).header
                t0 = time.perf_counter()
                pv = await cli.call("light_proofs", height=h,
                                    kind="validator")
                r["validator_proofs_cold_ms"] = (time.perf_counter() -
                                                 t0) * 1e3
                if pv["root"] != header.validators_hash.hex() or \
                        pv["total"] != BS_VALS:
                    raise AssertionError("phase 15 (b): validator root")
                for p in pv["proofs"]:
                    pr = Proof(p["total"], p["index"],
                               bytes.fromhex(p["leaf_hash"]),
                               tuple(bytes.fromhex(x) for x in p["aunts"]))
                    enc = vals.validators[p["index"]].simple_encode()
                    if not pr.verify(header.validators_hash, enc):
                        raise AssertionError("phase 15 (b): validator "
                                             f"proof {p['index']}")
                r["validator_proofs_warm_ms"] = await _rpc_timed(
                    cli, "light_proofs", RPC_REPS, height=h,
                    kind="validator")
                pt = await cli.call("light_proofs", height=h, kind="tx")
                if pt["root"] != header.data_hash.hex():
                    raise AssertionError("phase 15 (b): tx root")
                r["tx_proofs_total"] = pt["total"]
                r["stats"] = t.stats()
                return r
            finally:
                await cli.close()
                await srv.close()

        t0 = time.perf_counter()
        r = run(main())
        r["wall_s"] = time.perf_counter() - t0
        r["lanes"] = lanes
        p50 = r["cold_ms"]["p50"] / 1e3
        r["anchors_per_s"] = RPC_ANCHORS / p50
        r["sig_verifies_per_s"] = lanes / p50

        def cold_verify():
            t2 = tier()

            async def go():
                s2 = _serve(t2)
                c2 = HTTPClient(*await s2.listen())
                try:
                    await c2.call("light_verify", anchors=anchors)
                finally:
                    await c2.close()
                    await s2.close()
            run(go())

        # the tracer warmed on a one-anchor verify of a new tier
        r["profile"] = profile_call(cold_verify, top=6, warm=lambda: (
            tier().verify_commits(anchors[:1])))
        mark("b")
        return r

    def part_c():
        vh = big[0].header.validators_hash
        anchors = [{"height": lb.height, "commit": jsonable(lb.commit)}
                   for lb in big]
        lanes = sum(_min_lanes(lb.commit, big_vals) for lb in big)
        sample = sorted(random.Random(15).sample(range(BIG_VALS),
                                                 RPC_PROOF_SAMPLE))

        async def main():
            stores = _LightStores(big)
            tip_ns = big[-1].header.time_ns
            t = LightServeTier(stores, stores, CHAIN_ID, device=dev,
                               now_ns=lambda: tip_ns + 60 * 10**9)
            srv = _serve(t)
            cli = HTTPClient(*await srv.listen())
            try:
                r = {}
                tl = _build.LAUNCHES.get("merkle_tree_leaves", 0)
                t0 = time.perf_counter()
                pv = await cli.call("light_proofs", height=1,
                                    kind="validator", indexes=sample)
                r["validator_proofs_cold_ms"] = (time.perf_counter() -
                                                 t0) * 1e3
                r["tree_launches"] = _build.LAUNCHES.get(
                    "merkle_tree_leaves", 0) - tl
                if pv["root"] != vh.hex() or pv["total"] != BIG_VALS or \
                        not r["tree_launches"]:
                    raise AssertionError("phase 15 (c): validator tree")
                for p in pv["proofs"]:
                    pr = Proof(p["total"], p["index"],
                               bytes.fromhex(p["leaf_hash"]),
                               tuple(bytes.fromhex(x) for x in p["aunts"]))
                    enc = big_vals.validators[p["index"]].simple_encode()
                    if not pr.verify(vh, enc):
                        raise AssertionError("phase 15 (c): proof "
                                             f"{p['index']}")
                r["proofs_checked"] = len(pv["proofs"])
                r["validator_proofs_warm_ms"] = await _rpc_timed(
                    cli, "light_proofs", RPC_REPS, height=1,
                    kind="validator", indexes=sample)
                k6a = _build.LAUNCHES.get("ed25519_rlc_gather", 0)
                t0 = time.perf_counter()
                v = await cli.call("light_verify", anchors=anchors)
                r["verify_cold_ms"] = (time.perf_counter() - t0) * 1e3
                r["verify_k6a_launches"] = _build.LAUNCHES.get(
                    "ed25519_rlc_gather", 0) - k6a
                if v["ok"] != RPC_BIG_HEIGHTS:
                    raise AssertionError(f"phase 15 (c): verify {v}")
                r["verify_memo_ms"] = await _rpc_timed(
                    cli, "light_verify", RPC_REPS, anchors=anchors)
                r["stats"] = t.stats()
                return r
            finally:
                await cli.close()
                await srv.close()

        t0 = time.perf_counter()
        r = run(main())
        r["wall_s"] = time.perf_counter() - t0
        r["lanes"] = lanes
        mark("c")
        return r

    calls, restore = _oracle_counter()
    # the phase's collections, timed
    gc_t = {"collections": [0, 0, 0], "s": [0.0, 0.0, 0.0], "t0": 0.0}

    def gc_timer(phase, info):
        if phase == "start":
            gc_t["t0"] = time.perf_counter()
        else:
            g = info["generation"]
            gc_t["collections"][g] += 1
            gc_t["s"][g] += time.perf_counter() - gc_t["t0"]

    gc.collect()
    gc_t["tracked"] = len(gc.get_objects())
    gc.callbacks.append(gc_timer)
    try:
        def main_path():
            a, d = part_ad()
            return {"a": a, "d": d, "b": part_b(), "c": part_c()}

        t0 = time.perf_counter()
        launches, parts = _path_launches(main_path, RPC_KERNELS)
        out["main_path_s"] = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(gc_timer)
        restore()
        loop.close()
    out["gc"] = {"tracked_objects": gc_t["tracked"],
                 "collections": gc_t["collections"], "s": gc_t["s"]}
    out.update(parts)
    out["oracle_calls"] = calls[0]
    if calls[0]:
        raise AssertionError(f"phase 15: the oracle ran {calls[0]} times")
    prev: dict = {}
    out["launches_by_part"] = {}
    for part in ("a", "d", "b", "c"):
        cur = marks.get(part, {})
        out["launches_by_part"][part] = {
            k: v - prev.get(k, 0) for k, v in cur.items()
            if v - prev.get(k, 0)}
        prev = cur
    return launches, out


_PRESPAWNED: dict = {}           # name -> the child waiting for its go


def _build_file(name: str) -> str:
    """``name`` in the checkout's ``build/`` (which git ignores)."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, name)


def _child_paths(name: str):
    return (_build_file(f"chip_smoke_{name}.json"),
            _build_file(f"chip_smoke_{name}.go"))


def _stop_prespawned() -> None:
    for proc in list(_PRESPAWNED.values()):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _PRESPAWNED.clear()


def prespawn(names, whole: bool = False) -> None:
    """Start the children of :func:`phase_fresh` ahead of their turn
    (``--after GO``): each imports, reaches the card and loads the built
    kernels, then waits for its go file, so that its set-up overlaps the
    phases before it.  A child never given its go is killed at exit.
    ``whole``: the whole run's children (phase 19 runs ``SIM_WHOLE``)."""
    import atexit

    if not _PRESPAWNED:
        atexit.register(_stop_prespawned)
    for name in names:
        path, go = _child_paths(name)
        for f in (path, go):
            if os.path.exists(f):
                os.remove(f)
        _PRESPAWNED[name] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", name,
             path, "--after", go,
             *(("--e2e", E2E_MANIFEST) if name == "e2e" else ()),
             *(("--sim-programs", ",".join(SIM_WHOLE))
               if name == "sim" and whole else ())])


def phase_fresh(name: str):
    """Phase ``name`` of ``CHILD_PHASES`` in a fresh process (``--child
    NAME PATH``, with a key pool of its own): its fixtures are built
    there, so the collector and the caches hold that phase's objects
    only, as a node's process holds its own and not those of the smoke's
    earlier phases.  The child :func:`prespawn` started is given its go
    and waited for (and killed at exit if the smoke fails meanwhile).
    Returns the launches and the record that the child wrote;
    ``phase_s`` runs from the go."""
    import torch

    torch.cuda.empty_cache()
    sys.stdout.flush()
    path, go = _child_paths(name)
    proc = _PRESPAWNED[name]
    t0 = time.perf_counter()
    open(go, "w").close()
    if proc.wait(timeout=600):
        raise subprocess.CalledProcessError(proc.returncode, proc.args)
    _PRESPAWNED.pop(name)
    t1 = time.perf_counter()
    with open(path) as f:
        d = json.load(f)
    d["record"]["phase_s"] = t1 - t0
    # the child's exit after it wrote its record
    d["record"]["exit_s"] = time.time() - os.path.getmtime(path) - (
        time.perf_counter() - t1)
    return d["launches"], d["record"]


def fresh_beside(names):
    """Phases ``names`` (:func:`phase_fresh`), one after another, on a
    thread of their own, while the caller runs its next phases: the
    fresh-process phases that read no kernel's time run beside the
    in-process node phases, both host-bound with the card idle over 98%
    of the time, and the run's wall shrinks by the shorter of the two.
    The children write their records to files and print little, so
    their output and the caller's do not interleave within a line.
    Returns a function that waits for them and returns their (launches,
    record) pairs in order, raising the first one's failure."""
    import threading

    out, err = [], []

    def run():
        try:
            for name in names:
                out.append(phase_fresh(name))
        except BaseException as e:          # re-raised by join()
            err.append(e)

    sys.stdout.flush()
    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join()
        if err:
            raise err[0]
        return out
    return join


def run_child(name: str, path: str, dev) -> None:
    """The child of :func:`phase_fresh`: phase ``name`` over the kernels
    built, its launches and record written as JSON to ``path``."""
    fn, n_keys = CHILD_PHASES[name]
    if n_keys:
        with multiprocessing.get_context("spawn").Pool(
                os.cpu_count()) as pool:
            launches, record = fn(pool, pool_keys(pool, n_keys), dev)
    else:
        launches, record = fn(None, [], dev)
    with open(path, "w") as f:
        json.dump({"launches": launches, "record": record}, f, default=str)


def report_rpc(rp, launches, card) -> None:
    """Phase 15's lines."""
    a, b, c, d = rp["a"], rp["b"], rp["c"], rp["d"]
    print(f"rpc (phase 15): main path {rp['main_path_s']:.1f} s (fixture "
          f"{rp['fixture_s']:.1f} s); launches {launches}; by part "
          f"{rp['launches_by_part']}; oracle calls {rp['oracle_calls']}; "
          f"gc: {rp['gc']['tracked_objects']} objects tracked at the start, "
          f"collections "
          f"by generation {rp['gc']['collections']} taking "
          f"{[round(x, 3) for x in rp['gc']['s']]} s")
    print(f"rpc (a) ci.toml {len(ND_CI_POWERS)} validators with RPC to "
          f"height {a['top']}: {a['wall_s']:.1f} s; {ND_TXS} "
          f"broadcast_tx_commit in {a['commit_wall_s']:.2f} s at heights "
          f"{a['tx_heights']}, sheds retried {a['sheds']} "
          f"{a['shed_codes']}; checked {a['checked']}, agreement checks "
          f"{a['agree_checks']}; websocket NewBlock events "
          f"{a['ws_blocks']}, Tx events {a['ws_txs']}  [{card}]")
    for route, t in a["routes_ms"].items():
        print(f"rpc (a) route {route}: p50 {t['p50']:.2f} ms, min "
              f"{t['min']:.2f}, max {t['max']:.2f}  [{card}]")
    for mode, m in d["modes"].items():
        print(f"rpc (d) light client {mode} over RPCProvider: "
              f"{m['ms']:.1f} ms, to height {m['tip']}, trusted "
              f"blocks {m['trusted']}, one call a block "
              f"{m['served_in_one_call']}  [{card}]")
    print(f"rpc (d) proxy commit p50 {d['proxy_commit_ms']['p50']:.2f} ms; "
          f"forged header refused: {d['forged_refused']}  [{card}]")
    print(f"rpc (b) {BS_VALS} validators: light_blocks of {RPC_ANCHORS} "
          f"heights cold {b['light_blocks_cold_ms']:.1f} ms, warm p50 "
          f"{b['light_blocks_warm_ms']['p50']:.1f} ms (min "
          f"{b['light_blocks_warm_ms']['min']:.1f}, max "
          f"{b['light_blocks_warm_ms']['max']:.1f}; the tier alone "
          f"{b['light_blocks_warm_direct_ms']['p50']:.2f}); header cache "
          f"hits {b['stats']['header_hits']}, misses "
          f"{b['stats']['header_misses']}  [{card}]")
    print(f"rpc (b) light_verify of {RPC_ANCHORS} anchors, host parts: the "
          f"tier alone cold {b['verify_cold_direct_ms']:.1f} ms, of which "
          f"decoding the anchors' commits {b['anchor_decode_ms']:.1f} ms  "
          f"[{card}]")
    print(f"rpc (b) light_verify of {RPC_ANCHORS} anchors ({b['lanes']} "
          f"lanes, K6a launches {b['cold_k6a_launches']}, dispatches "
          f"{b['cold_dispatches']}): cold p50 {b['cold_ms']['p50']:.1f} ms "
          f"(min {b['cold_ms']['min']:.1f}, max {b['cold_ms']['max']:.1f}, "
          f"{b['cold_ms']['n']} new tiers), {b['anchors_per_s']:.0f} "
          f"anchors/s, {b['sig_verifies_per_s']:.0f} sig-verifies/s; memo "
          f"p50 {b['memo_ms']['p50']:.2f} ms (min {b['memo_ms']['min']:.2f}, "
          f"max {b['memo_ms']['max']:.2f})  [{card}]")
    prof = b["profile"]
    print(f"rpc (b) profile cold light_verify: wall {prof['wall_ms']:.1f} "
          f"ms, device {prof['device_ms']} ms (busy "
          f"{prof['device_busy_share']}), kernels {prof['kernels_ms']}  "
          f"[{card}]")
    print(f"rpc (b) tampered anchor {RPC_BAD_ANCHOR} lane {RPC_BAD_LANE}: "
          f"{b['tampered_error']!r}, K5b launches "
          f"{b['tampered_k5b_launches']}, {b['tampered_ms']:.1f} ms; "
          f"validator proofs ({BS_VALS} leaves) cold "
          f"{b['validator_proofs_cold_ms']:.1f} ms, warm p50 "
          f"{b['validator_proofs_warm_ms']['p50']:.2f} ms  [{card}]")
    print(f"rpc (c) {BIG_VALS} validators: {c['proofs_checked']} validator "
          f"proofs, tree launches {c['tree_launches']}, cold "
          f"{c['validator_proofs_cold_ms']:.1f} ms, warm p50 "
          f"{c['validator_proofs_warm_ms']['p50']:.2f} ms; light_verify of "
          f"{RPC_BIG_HEIGHTS} anchors ({c['lanes']} lanes, K6a launches "
          f"{c['verify_k6a_launches']}) {c['verify_cold_ms']:.1f} ms, memo "
          f"p50 {c['verify_memo_ms']['p50']:.2f} ms  [{card}]")


# ------------------------------------------------ phase 16: statesync

SS_BALLAST_CHUNKS = 128          # (a): genesis app_state of >= 128 chunks
SS_BALLAST_KEYS = 27_000         # (a): keys of 16 bytes, 300-byte values
SS_A_FOLLOW = 3                  # (a): heights followed past the restore
SS_VALS = BS_VALS                # (b): BASELINE configs[3]'s width
SS_KEYS = 200_000                # (b): genesis keys, 16 bytes (about
#                                  64 MiB of snapshot at 300-byte values)
SS_VALUE_BYTES = 300
SS_HEIGHTS = 40                  # (b): the source chain's heights
SS_BLOCKSYNC = 14                # (b): heights blocksynced past the
#                                  snapshot (the tip is left to consensus)
SS_KERNELS = ("ed25519_tables", "ed25519_rlc_gather", "merkle_tree_leaves")
SS_TIMEOUT_S = 240               # a part's wait for its restore or heights


def _ss_app_state(n: int, seed: int) -> bytes:
    """Genesis ``app_state`` of ``n`` keys: 16 hex characters each (the
    key index), values of ``SS_VALUE_BYTES`` hex characters from a
    seeded generator; the kvstore's ``init_chain`` loads it."""
    import numpy as np

    raw = np.random.default_rng(seed).bytes(n * SS_VALUE_BYTES // 2).hex()
    w = SS_VALUE_BYTES
    return json.dumps({"%016x" % i: raw[i * w:(i + 1) * w]
                       for i in range(n)}).encode()


@contextlib.contextmanager
def launch_shapes(seen: dict):
    """Record the shape of the tensor each kernel launch is given (the
    keys of a table build, the lanes of a verdict, the leaves and blocks
    of a tree) into ``seen[name]``, a set."""
    from cometbft_tpu_torch.ops import _build

    inner = _build.launch

    def launch(name, t, *args):
        seen.setdefault(name, set()).add(tuple(t.shape))
        return inner(name, t, *args)

    _build.launch = launch
    try:
        yield seen
    finally:
        _build.launch = inner


@contextlib.contextmanager
def launch_events(out: dict):
    """Record a pair of CUDA events around each kernel launch on the
    launching stream into ``out[name]`` (their elapsed time is the
    launch's device time; read after a synchronisation)."""
    import torch

    from cometbft_tpu_torch.ops import _build

    inner = _build.launch

    def launch(name, t, *args):
        stream = torch.cuda.current_stream(t.device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        try:
            return inner(name, t, *args)
        finally:
            b.record(stream)
            out.setdefault(name, []).append((a, b))

    _build.launch = launch
    try:
        yield out
    finally:
        _build.launch = inner
        _sync()


class _Stamps:
    """Wall stamps of a state-syncing node's restore: wraps its syncer's
    ``_restore`` and ``_obtain_manifest``, its ``add_chunk``, its state
    provider's light calls and its app's chunk applies and app hash."""

    def __init__(self, node, app):
        self.t = {}
        self.light_s = 0.0
        self.apply_s = 0.0
        self.hash_s = []
        self.chunk_bytes = 0
        self.chunks = 0
        self.snapshot_chunks = None
        sy = node.syncer
        prov = sy.provider
        for name in ("_restore", "_obtain_manifest"):
            self._wrap_async(sy, name)
        inner_add = sy.add_chunk

        def add_chunk(*a, **kw):
            self.chunks += 1
            self.chunk_bytes += len(a[4])
            self.t.setdefault("first_chunk", time.perf_counter())
            self.t["last_chunk"] = time.perf_counter()
            return inner_add(*a, **kw)

        sy.add_chunk = add_chunk
        for name in ("app_hash", "state", "commit"):
            inner = getattr(prov, name)

            async def timed(h, _inner=inner):
                t0 = time.perf_counter()
                try:
                    return await _inner(h)
                finally:
                    self.light_s += time.perf_counter() - t0

            setattr(prov, name, timed)
        inner_apply = app.apply_snapshot_chunk

        async def apply(*a, **kw):
            if app._restoring is not None:
                self.snapshot_chunks = app._restoring.chunks
            t0 = time.perf_counter()
            try:
                return await inner_apply(*a, **kw)
            finally:
                self.apply_s += time.perf_counter() - t0

        app.apply_snapshot_chunk = apply
        inner_hash = app._compute_app_hash

        def app_hash():
            t0 = time.perf_counter()
            try:
                return inner_hash()
            finally:
                self.hash_s.append(time.perf_counter() - t0)

        app._compute_app_hash = app_hash

    def _wrap_async(self, obj, name):
        inner = getattr(obj, name)

        async def wrapped(*a, **kw):
            self.t.setdefault(name + "_in", time.perf_counter())
            try:
                return await inner(*a, **kw)
            finally:
                self.t[name + "_out"] = time.perf_counter()

        setattr(obj, name, wrapped)

    def readings(self, t_start: float, t_done: float) -> dict:
        t = self.t
        xfer = t["last_chunk"] - t["_obtain_manifest_out"]
        restore_hash = self.hash_s[-1] if self.hash_s else None
        return {
            "restored_s": t_done - t_start,
            "discovery_s": t["_restore_in"] - t_start,
            "light_verify_s": self.light_s,
            "manifest_s": t["_obtain_manifest_out"]
            - t["_obtain_manifest_in"],
            "transfer_s": xfer, "chunks": self.chunks,
            "chunk_mb": self.chunk_bytes / 2**20,
            "mb_per_s": self.chunk_bytes / 2**20 / xfer if xfer > 0
            else None,
            "chunks_per_s": self.chunks / xfer if xfer > 0 else None,
            "snapshot_chunks": self.snapshot_chunks,
            "apply_s": self.apply_s - (restore_hash or 0.0),
            "app_hash_s": restore_hash}


def _ss_check_trees(leaf_shapes: set, items_b: list, dev) -> dict:
    """``merkle_tree_leaves`` against its plain version and hashlib: on
    (b)'s restored leaves (the root and every proof of the kernel route
    against those of hashlib's levels; timed there, CUDA events over
    ``REPS`` calls, the profiler's device ms and one plain call), and on
    seeded random one-block leaves at every other (leaves, blocks) shape
    the path launched."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.ops import sha256 as S

    def check(items):
        blocks, active = merkle._leaf_blocks(items)
        bt = torch.from_numpy(blocks.view(np.int32)).to(dev)
        at = torch.from_numpy(active).to(dev)
        got = S.merkle_tree_leaves(bt, at)
        n = len(items)
        plain = torch.empty_like(got)
        plain[:n] = S._as_int32(S._leaf_state_plain(bt, at))
        S._merkle_tree_plain(plain, n)
        host = S.words_to_bytes(got.cpu().numpy().view(np.uint32))
        levels = merkle._levels_hashlib(items)
        want = [r for lv in levels for r in lv]
        bad = (int((got != plain).any(1).sum())
               + sum(h.tobytes() != w for h, w in zip(host, want))
               + abs(len(host) - len(want)))
        return (tuple(bt.shape), bad,
                int((got.long() - plain.long()).abs().max()), levels,
                (bt, at, got))

    out = {"shapes": {}}
    t0 = time.perf_counter()
    shape, bad, err, levels, (bt, at, got) = check(items_b)
    root, proofs = merkle.proofs_from_byte_slices(items_b, device=dev)
    want_root, want = merkle._proofs_from_levels(levels, len(items_b))
    bad_proofs = int(root != want_root) + sum(
        a != b for a, b in zip(proofs, want)) + abs(len(proofs) - len(want))
    n = len(items_b)

    def plain_tree():
        lv = torch.empty_like(got)
        lv[:n] = S._as_int32(S._leaf_state_plain(bt, at))
        return S._merkle_tree_plain(lv, n)

    out["restored"] = {
        "leaves": n, "shape": shape, "mismatches": bad,
        "proof_mismatches": bad_proofs,
        "ms": time_cuda(lambda: S.merkle_tree_leaves(bt, at, got), REPS),
        "device_ms": _kernel_ms(profile_call(
            lambda: S.merkle_tree_leaves(bt, at, got), REPS)["kernels_ms"],
            "merkle_"),
        "plain_ms": time_host(plain_tree),
        "bound_inputs": (int(at.sum()), n, int(bt.shape[1])),
        "check_s": time.perf_counter() - t0}
    out["max_abs_err"] = err
    rng = np.random.default_rng(1606)
    for n, nb, _ in sorted(leaf_shapes - {shape}):
        if nb != 1:
            raise AssertionError(f"phase 16: a tree of {n} leaves of "
                                 f"{nb} blocks, not checked")
        _, bad_n, err, _, _ = check(_rand_leaves(rng, n, 0, 55))
        out["shapes"][n] = bad_n
        out["max_abs_err"] = max(out["max_abs_err"], err)
    out["mismatches"] = bad + bad_proofs + sum(out["shapes"].values())
    return out


def _ss_check_lanes(seen: dict, privs, dev) -> dict:
    """K5a at every key count the path built a table of, K5b at every
    lane count it checked lane by lane and K6a at every lane count of
    its RLC verdicts, each against its plain version on the card: one
    seeded batch of the largest lane count (``SWEEP_SIGNED`` distinct
    lanes signed by the pool's keys with messages of vote sign bytes'
    lengths, tiled; one in ten with a flipped signature bit, its verdict
    from the oracle), each smaller shape a prefix of it, the per-lane
    plain version over the largest K5b shape once.  K6a runs each shape
    twice, on the untampered lanes (an accept) and with one lane
    tampered (a reject), each verdict against the expected one; the
    plain RLC verdict runs once a shape, the reject and the accept in
    turn."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import _ed25519_py as ref
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc

    rng = np.random.default_rng(1616)
    mism = dict.fromkeys(("ed25519_tables", "ed25519_verify_gather",
                          "ed25519_rlc_gather"), 0)
    tables = sorted(s[0] for s in seen.get("ed25519_tables", ()))
    for n in tables:
        rows = [privs[i % len(privs)].pub_key().bytes() if i % 8 else
                rng.bytes(32) for i in range(n)]
        pub_t = torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8)
                                 .reshape(-1, 32).copy()).to(dev)
        tab_k, ok_k = ed.prepare_pubkey_tables(pub_t)
        tab_p, ok_p = ed._prepare_plain(pub_t)
        mism["ed25519_tables"] += int((ok_k != ok_p).sum()) + int(
            (ed.tables_canonical(tab_k) != ed.tables_canonical(tab_p))
            .flatten(1).any(1).sum())
    per_lane = sorted({s[0] for s in seen.get("ed25519_verify_gather", ())})
    verdicts = sorted({s[0] for s in seen.get("ed25519_rlc_gather", ())})
    n = max(per_lane + verdicts, default=0)
    if n:
        keys = privs[:min(n, len(privs))]
        m_lanes = min(n, SWEEP_SIGNED)
        pick = rng.integers(0, len(keys), size=m_lanes)
        msgs = [rng.bytes(int(rng.integers(100, 160))) for _ in pick]
        pubs = [keys[k].pub_key().bytes() for k in pick]
        sigs = [keys[k].sign(m) for k, m in zip(pick, msgs)]
        bad = rng.random(m_lanes) < 0.1
        sigs_bad = list(sigs)
        for i in np.flatnonzero(bad):
            s = bytearray(sigs[i])
            s[rng.integers(0, 64)] ^= 1 << int(rng.integers(0, 8))
            sigs_bad[i] = bytes(s)
        want = [not bad[i] or ref.verify_zip215(pubs[i], msgs[i],
                                                 sigs_bad[i])
                for i in range(m_lanes)]
        tile = np.arange(n) % m_lanes
        pubs, msgs, sigs, sigs_bad, want = ([x[i] for i in tile] for x in (
            pubs, msgs, sigs, sigs_bad, want))
        rows = [k.pub_key().bytes() for k in keys]
        row_of = {r: j for j, r in enumerate(rows)}
        pub_t = torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8)
                                 .reshape(-1, 32).copy()).to(dev)
        tab, ok = ed.prepare_pubkey_tables(pub_t)
        idx = torch.tensor([row_of[p] for p in pubs], dtype=torch.int32,
                           device=dev)
        rb, sb, blocks, active = _lanes_to_tensors(pubs, sigs, msgs, dev)
        rb_bad, sb_bad, _, _ = _lanes_to_tensors(pubs, sigs_bad, msgs, dev)
        lanes = (tab, ok, idx, rb_bad, sb_bad, blocks, active)
        top = max(per_lane, default=0)
        v_p = ed._verify_gather_plain(*(t[:top] if i >= 2 else t
                                        for i, t in enumerate(lanes)))
        for m in per_lane:
            v_k = ed.verify_padded_gather(*(t[:m] if i >= 2 else t
                                            for i, t in enumerate(lanes)))
            mism["ed25519_verify_gather"] += int((v_k != v_p[:m]).sum()) \
                + sum(a != b for a, b in zip(v_k.tolist(), want))
        for j, m in enumerate(verdicts):
            z = torch.from_numpy(rlc.host_rlc_coeffs(
                m, rng_bytes=rng.bytes(16 * m))).to(dev)
            one_bad = sb[:m].clone()
            one_bad[m // 2, 5] ^= 0x20
            for case, (s_t, expect) in enumerate(((sb[:m], True),
                                                  (one_bad, False))):
                args = (tab, ok, idx[:m], rb[:m], s_t, blocks[:m],
                        active[:m], z)
                k = bool(rlc.verify_batch_rlc_gather(*args))
                mism["ed25519_rlc_gather"] += k != expect
                if case == j % 2:
                    mism["ed25519_rlc_gather"] += \
                        k != bool(rlc._rlc_plain(*args))
    return {"tables": tables, "per_lane": per_lane, "verdicts": verdicts,
            "mismatches": mism}


def phase_statesync(pool, keys, dev):
    """Phase 16: statesync on the card, in a process of its own
    (:func:`phase_fresh`), all nodes in it on one event loop.

    (a) ``networks/ci.toml``'s 4 validators over loopback TCP (homes,
        RPC servers, the JAX package's test timeouts) from a genesis
        whose ``app_state`` holds ``SS_BALLAST_KEYS`` keys (at least
        ``SS_BALLAST_CHUNKS`` chunks of snapshot): a fresh ``Node`` with
        ``state_sync_provider=StateProvider(Client(..., RPCProvider))``,
        its trusted header taken from validator01's RPC, restores a
        snapshot and follows consensus ``SS_A_FOLLOW`` heights; no
        fallback to genesis (``block_store.base() > 1``), the restored
        keys over ``abci_query``, equal block hashes, the
        ``consensus_timeline`` and ``dump_incidents`` routes in the JAX
        package's shape, ``/status`` with the doctor's report; then
        inspect mode over validator01's home serves ``status``,
        ``block`` and ``validators`` as the live node did;
    (b) ``SS_VALS`` validators (BASELINE configs[3]'s width, keys of the
        pool): a source node (no consensus started) whose
        ``KVStoreApplication`` on the card gets ``SS_KEYS`` keys through
        genesis and makes ``SS_HEIGHTS`` heights with the port's
        ``BlockExecutor`` (each commit signed in the pool, each app hash
        a ``merkle_tree_leaves`` call); its first ``list_snapshots``
        (every retained height serialized) timed; its snapshots above
        ``SS_HEIGHTS - SS_BLOCKSYNC`` dropped (the static chain has no
        headers above its tip to prove them); a fresh node restores
        the newest one over a secret connection (its light client
        walking from height 2 on the card, about 1,000 chunks, the app
        hash over every key by ``merkle_tree_leaves``), blocksyncs to the
        tip and must hold the source's blocks and app hash.

    The counters are zeroed just before (a) and read just after (b):
    K5a, K6a and ``merkle_tree_leaves`` must launch, no plain version and
    no ``OFF_PATH`` kernel; the oracle's calls must be 0.  Every launch's
    shape is recorded (:func:`launch_shapes`), and each kernel is then
    held against its plain version at every shape the path ran."""
    import asyncio
    import tempfile

    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.light import Client, RPCProvider, TrustOptions
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.rpc import HTTPClient
    from cometbft_tpu_torch.rpc.inspect import run_inspect
    from cometbft_tpu_torch.statesync import StateProvider
    from cometbft_tpu_torch.storage import State
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig,
                                                 ExtendedCommit,
                                                 ExtendedCommitSig)
    from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                  GenesisValidator)

    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    out: dict = {}
    keep: dict = {}

    async def wait_for(cond, what):
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > SS_TIMEOUT_S:
                raise AssertionError(f"phase 16: timed out waiting for "
                                     f"{what}")
            await asyncio.sleep(0.01)

    async def statesyncer(doc, name, rpc_addr, trust_h, trust_hash, **kw):
        light = Client(CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, trust_h,
                                              trust_hash),
                       RPCProvider(*rpc_addr, "primary"), device=dev)
        # a discovery round long enough for the dials and the first
        # offers (the serving apps pack their snapshots then)
        return await _nd_node(doc, None, name, dev,
                              rpc_laddr="tcp://127.0.0.1:0",
                              discovery_s=2.0,
                              state_sync_provider=StateProvider(light, doc),
                              **kw)

    def part_a(tmp):
        doc, pvs = _nd_genesis(ND_CI_POWERS, b"ss-ci")
        doc.app_state = _ss_app_state(SS_BALLAST_KEYS, 1601)
        homes = [os.path.join(tmp, f"validator0{i + 1}") for i in range(4)]
        nodes = [run(_nd_node(doc, pv, f"validator0{i + 1}", dev,
                              home=homes[i], rpc_laddr="tcp://127.0.0.1:0"))
                 for i, pv in enumerate(pvs)]
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication

        fapp = KVStoreApplication(device=dev)
        fresh, walls = None, []
        try:
            for n in nodes:
                run(n.start(consensus=False))
            run(_nd_mesh(nodes, walls))
            for n in nodes:
                run(n.start_consensus())
            for i in range(ND_TXS):
                run(nodes[0].mempool.check_tx(b"ss%d=tx%d" % (i, i)))
            run(wait_for(lambda: min(n.height() for n in nodes) >= 4,
                         "(a)'s height 4"))
            lb2 = run(RPCProvider(*nodes[0].rpc_addr).light_block(2))
            fresh = run(statesyncer(doc, "fresh", nodes[0].rpc_addr, 2,
                                    lb2.header.hash(), app=fapp))
            fresh.config.instrumentation.tracing = True
            stamps = _Stamps(fresh, fapp)
            t0 = time.perf_counter()
            run(fresh.start())
            run(_nd_dial(fresh, nodes, walls))
            run(asyncio.wait_for(fresh.statesync_done, SS_TIMEOUT_S))
            t_done = time.perf_counter()
            restored_s = t_done - t0
            snap_h = fresh.block_store.base()
            if fresh.statesync_error is not None or snap_h <= 1:
                raise AssertionError(f"phase 16 (a): no restore (base "
                                     f"{snap_h}, {fresh.statesync_error})")
            top = max(n.height() for n in nodes) + SS_A_FOLLOW
            everyone = nodes + [fresh]
            run(wait_for(lambda: min(n.height() for n in everyone) >= top,
                         f"(a)'s height {top}"))
            follow_s = time.perf_counter() - t0 - restored_s
            cli = HTTPClient(*fresh.rpc_addr)
            q = run(cli.call("abci_query", path="/key",
                             data=(b"%016x" % 7).hex()))
            txq = run(cli.call("abci_query", path="/key",
                               data=b"ss0".hex()))
            tl = run(cli.call("consensus_timeline", n=4))
            inc = run(cli.call("dump_incidents"))
            st = run(cli.call("status"))
            vcli = HTTPClient(*nodes[0].rpc_addr)
            live = {r: run(vcli.call(r, height=top))
                    for r in ("block", "validators")}
            vst = run(vcli.call("status"))
            vinc = run(vcli.call("dump_incidents"))
            tallies = dict(fresh.syncer.tallies)
        finally:
            for n in nodes + ([fresh] if fresh else []):
                run(n.stop())
        _nd_agree(nodes, top, "16 (a)")
        for h in range(snap_h + 1, top + 1):
            if fresh.block_store.load_block(h).hash() != \
                    nodes[0].block_store.load_block(h).hash():
                raise AssertionError(f"phase 16 (a): the restored node's "
                                     f"block {h} differs")
        want_val = json.loads(doc.app_state)["%016x" % 7].encode()
        shape_ok = (
            set(tl) == {"enabled", "buffered", "phases", "buckets",
                        "waterfalls"}
            and tl["phases"] == ["propose", "gossip", "prevote",
                                 "precommit", "commit"]
            and tl["buckets"] == ["gossip_wait", "verify", "app", "wal",
                                  "idle"]
            and tl["waterfalls"]
            and set(tl["waterfalls"][0]) == {
                "node", "height", "rounds", "complete", "catchup",
                "wall0_ns", "total_s", "phases", "marks", "buckets"}
            and set(inc) == set(vinc) == {"enabled", "incident_dir",
                                          "trips", "incidents"}
            and vinc["enabled"] and vinc["incidents"] == [])
        if bytes.fromhex(q["response"]["value"]) != want_val or \
                bytes.fromhex(txq["response"]["value"]) != b"tx0" or \
                not shape_ok or st["doctor"] is None or \
                not st["doctor"]["ok"] or not vst["doctor"]["ok"]:
            raise AssertionError(f"phase 16 (a): restored keys, timeline "
                                 f"{sorted(tl)}, incidents {inc}, doctor "
                                 f"{st['doctor']}")
        icfg = nodes[0].config

        async def inspect():
            server, addr = await run_inspect(homes[0], icfg, doc)
            try:
                ic = HTTPClient(*addr)
                return {"status": await ic.call("status"),
                        **{r: await ic.call(r, height=top)
                           for r in ("block", "validators")}}
            finally:
                await server.close()
                server.env.node.close()

        seen = run(inspect())
        if seen["block"] != live["block"] or \
                seen["validators"] != live["validators"] or \
                seen["status"]["sync_info"]["latest_block_height"] < \
                vst["sync_info"]["latest_block_height"] or \
                seen["status"]["node_info"]["network"] != \
                vst["node_info"]["network"] or \
                not seen["status"]["doctor"]["ok"]:
            raise AssertionError("phase 16 (a): inspect mode serves "
                                 "another chain than the live node")
        readings = stamps.readings(t0, t_done)
        chunks = readings["snapshot_chunks"]
        if chunks is None or chunks < SS_BALLAST_CHUNKS:
            raise AssertionError(f"phase 16 (a): a snapshot of {chunks} "
                                 "chunks restored")
        return {"snapshot_height": snap_h, "top": top,
                "restored_s": restored_s, "follow_s": follow_s,
                "chunks": chunks, "tallies": tallies, "readings": readings,
                "waterfalls": len(tl["waterfalls"]),
                "doctor": st["doctor"], "inspect": "equal"}

    def part_b():
        privs = [Ed25519PrivKey(k) for k in keys]
        pubs = [p.pub_key() for p in privs]
        key_of = {pk.address(): k for pk, k in zip(pubs, keys)}
        # block times a second apart ending a minute ago: the light
        # client's trusting period and clock drift hold them to now
        t_gen = time.time_ns() - (SS_HEIGHTS + 60) * 10**9
        doc = GenesisDoc(CHAIN_ID, genesis_time_ns=t_gen, validators=[
            GenesisValidator(pk, 10) for pk in pubs])
        t0 = time.perf_counter()
        doc.app_state = _ss_app_state(SS_KEYS, 1602)
        doc.validate_and_complete()
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication

        app = KVStoreApplication(device=dev)
        src = run(_nd_node(doc, None, "source", dev, app=app,
                           rpc_laddr="tcp://127.0.0.1:0"))
        r = {"genesis_s": time.perf_counter() - t0}
        fresh = None
        try:
            ex = src.block_exec
            state = src.state_store.load()
            last_ext = ExtendedCommit(0, 0, BlockID(), [])
            t0 = time.perf_counter()
            sign_s = 0.0
            for h in range(1, SS_HEIGHTS + 1):
                block, parts = run(ex.create_proposal_block(
                    h, state, last_ext,
                    state.validators.get_proposer().address,
                    t_gen + h * 10**9))
                bid = BlockID(block.hash(), parts.header())
                commit = Commit(h, 0, bid, [
                    CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                              block.header.time_ns + 1 + lane, b"")
                    for lane, v in enumerate(state.validators.validators)])
                t1 = time.perf_counter()
                tasks = [(key_of[v.address],
                          [commit.vote_sign_bytes(CHAIN_ID, lane)])
                         for lane, v in
                         enumerate(state.validators.validators)]
                sigs = pool.map(_sign_all, tasks, chunksize=max(
                    1, len(tasks) // (4 * os.cpu_count())))
                for cs, (sig,) in zip(commit.signatures, sigs):
                    cs.signature = sig
                sign_s += time.perf_counter() - t1
                ex.block_store.save_block(block, parts, commit)
                state = run(ex.apply_block(state, bid, block))
                last_ext = ExtendedCommit(h, 0, bid, [
                    ExtendedCommitSig(cs) for cs in commit.signatures])
            r["source_s"] = time.perf_counter() - t0
            r["source_sign_s"] = sign_s
            t0 = time.perf_counter()
            snaps = run(app.list_snapshots())
            r["first_list_snapshots_s"] = time.perf_counter() - t0
            r["retained_heights"] = len(snaps)
            r["snapshot_mb"] = snaps[-1].chunks * 64 / 1024
            snap_h = SS_HEIGHTS - SS_BLOCKSYNC
            for h in [h for h in app.snapshots if h > snap_h]:
                del app.snapshots[h]
            run(src.start(consensus=False))
            lb2 = run(RPCProvider(*src.rpc_addr).light_block(2))
            fapp = KVStoreApplication(device=dev)
            fresh = run(statesyncer(doc, "fresh-b", src.rpc_addr, 2,
                                    lb2.header.hash(), app=fapp))
            stamps = _Stamps(fresh, fapp)
            gc0 = gc.get_stats()[2]["collections"]

            async def sync():
                t_start = time.perf_counter()
                await fresh.start()
                await fresh.dial_peer(src.listen_addr, persistent=True)
                await asyncio.wait_for(fresh.statesync_done, SS_TIMEOUT_S)
                t_done = time.perf_counter()
                await asyncio.wait_for(
                    fresh.blocksync_reactor.synced.wait(), SS_TIMEOUT_S)
                return t_start, t_done, time.perf_counter()

            times = {}

            def go():
                times["t"] = run(sync())

            prof = profile_call(go, top=6, warm=lambda: None)
            t_start, t_done, t_synced = times["t"]
            r["gc_full_collections"] = gc.get_stats()[2]["collections"] - gc0
            if fresh.statesync_error is not None or \
                    fresh.block_store.base() != snap_h:
                raise AssertionError(f"phase 16 (b): restored at base "
                                     f"{fresh.block_store.base()}, "
                                     f"{fresh.statesync_error}")
            r.update(stamps.readings(t_start, t_done))
            r["snapshot_height"] = snap_h
            r["tallies"] = dict(fresh.syncer.tallies)
            blocks = fresh.height() - snap_h
            r["blocksync_blocks"] = blocks
            r["blocksync_s"] = t_synced - t_done
            r["blocks_per_s"] = blocks / r["blocksync_s"]
            r["profile"] = prof
            if fresh.height() < SS_HEIGHTS - 1:
                raise AssertionError(f"phase 16 (b): blocksync stopped at "
                                     f"{fresh.height()}")
            for h in range(snap_h + 1, fresh.height() + 1):
                if fresh.block_store.load_block(h).hash() != \
                        src.block_store.load_block(h).hash():
                    raise AssertionError(f"phase 16 (b): block {h} differs")
            want = src.state_store.load_finalize_block_response(
                fresh.height())
            if fresh.state_store.load_finalize_block_response(
                    fresh.height()) != want or \
                    fapp.height != fresh.height() or len(fapp.state) != \
                    SS_KEYS:
                raise AssertionError("phase 16 (b): the restored app "
                                     "differs from the source's")
            from cometbft_tpu_torch.crypto.merkle import kv_leaf

            keep["leaves_b"] = [kv_leaf(k, fapp.state[k])
                                for k in sorted(fapp.state)]
        finally:
            for n in ([fresh] if fresh else []) + [src]:
                run(n.stop())
        return r

    profile_call(_sync, warm=_sync)
    calls, restore = _oracle_counter()
    seen: dict = {}
    t_ph = time.perf_counter()

    def main_path():
        with tempfile.TemporaryDirectory() as d:
            out["a"] = part_a(d)
        out["b"] = part_b()
        return out

    try:
        with launch_shapes(seen):
            launches, _ = _path_launches(main_path, SS_KERNELS)
    finally:
        restore()
    out["main_path_s"] = time.perf_counter() - t_ph
    out["oracle_calls"] = calls[0]
    if calls[0]:
        raise AssertionError(f"phase 16: the host oracle was called "
                             f"{calls[0]} times on the path")
    out["shapes"] = {k: sorted(v) for k, v in seen.items()}
    t0 = time.perf_counter()
    privs = [Ed25519PrivKey(k) for k in keys]
    trees = _ss_check_trees(seen.get("merkle_tree_leaves", set()),
                            keep["leaves_b"], dev)
    lanes = _ss_check_lanes(seen, privs, dev)
    out["checks"] = {"trees": trees, "lanes": lanes,
                     "check_s": time.perf_counter() - t0}
    bad = {k: m for k, m in lanes["mismatches"].items() if m}
    if trees["mismatches"]:
        bad["merkle_tree_leaves"] = trees["mismatches"]
    if bad:
        raise AssertionError(f"phase 16: kernels against their plain "
                             f"versions at the path's shapes: {bad}")
    loop.close()
    return launches, out


def report_statesync(ss, launches, card) -> None:
    """Phase 16's lines."""
    a, b, ck = ss["a"], ss["b"], ss["checks"]
    print(f"statesync (phase 16): {ss['phase_s']:.1f} s in its process, "
          f"main path {ss['main_path_s']:.1f} s; launches {launches}; "
          f"oracle calls on the path {ss['oracle_calls']}")
    print(f"statesync (a) ci.toml 4 validators, {a['chunks']} chunks: "
          f"restored at height {a['snapshot_height']} in "
          f"{a['restored_s']:.2f} s, followed to {a['top']} in "
          f"{a['follow_s']:.2f} s; tallies {a['tallies']}; timeline "
          f"waterfalls {a['waterfalls']}; inspect {a['inspect']}  [{card}]")
    print(f"statesync (b) {SS_VALS} validators, {SS_KEYS} keys: genesis "
          f"{b['genesis_s']:.1f} s, source {SS_HEIGHTS} heights "
          f"{b['source_s']:.1f} s (signing {b['source_sign_s']:.1f} s), "
          f"first list_snapshots of {b['retained_heights']} heights "
          f"{b['first_list_snapshots_s']:.2f} s; snapshot "
          f"{b['snapshot_mb']:.1f} MiB  [{card}]")
    print(f"statesync (b) restore at height {b['snapshot_height']}: "
          f"{b['restored_s']:.2f} s = discovery {b['discovery_s']:.2f}, "
          f"light verification {b['light_verify_s']:.2f}, manifest "
          f"{b['manifest_s']:.2f}, transfer {b['transfer_s']:.2f} s of "
          f"{b['chunks']} chunks ({b['chunk_mb']:.1f} MiB, "
          f"{b['mb_per_s']:.1f} MiB/s, {b['chunks_per_s']:.0f} chunks/s), "
          f"apply {b['apply_s']:.2f}, app hash {b['app_hash_s']:.3f}; "
          f"tallies {b['tallies']}  [{card}]")
    print(f"statesync (b) blocksync {b['blocksync_blocks']} blocks in "
          f"{b['blocksync_s']:.2f} s ({b['blocks_per_s']:.2f} blocks/s); "
          f"full gc collections {b['gc_full_collections']}; profile wall "
          f"{b['profile']['wall_ms']:.0f} ms, device "
          f"{b['profile']['device_ms']} ms (busy "
          f"{b['profile']['device_busy_share']}), kernels "
          f"{b['profile']['kernels_ms']}  [{card}]")
    print(f"statesync shapes {ss['shapes']}")
    print(f"statesync checks: merkle_tree_leaves {ck['trees']['restored']}"
          f" (ms: CUDA events, device ms: the profiler, plain: one call);"
          f" other trees {ck['trees']['shapes']}; K5a tables "
          f"{ck['lanes']['tables']}, K5b lanes {ck['lanes']['per_lane']}, "
          f"K6a lanes {ck['lanes']['verdicts']}: mismatches "
          f"{ck['lanes']['mismatches']} in {ck['check_s']:.1f} s  [{card}]")


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

# the phases that run in a fresh process of their own (phase_fresh):
# name -> (phase, keys of its pool)
# ------------------------- phase 17: networks/chaos.toml, discovery and faults

CX_POWERS = (10, 10, 10, 10)     # chaos.toml: validator01..04
CX_TOP = 12                      # chaos.toml's final_height
CX_LATENCY_MS = 20.0             # its emulated_latency_ms
CX_FUZZ_AFTER_S = 5.0            # runner.py: fuzz from 5 s after connect
CX_FUZZ_SEED = 17                # every node's fuzz_seed, and the plane's
CX_JOINER_AT = 4                 # joiner01's start_at
CX_VALSET_AT, CX_JOINER_POWER = 6, 15   # [validator_update.6] joiner01 = 15
CX_KILL_AT, CX_RESTART_AT = 5, 7  # validator02's kill:5, restart:7
CX_PART_AT, CX_HEAL_AT = 8, 9    # validator03's pause:8, resume:9
CX_LIGHT_AT = 6                  # light01's start_at
CX_LOAD_RATE, CX_LOAD_S, CX_TX_BYTES = 15.0, 25.0, 96   # [load]
CX_STALL_GRACE_S = 10.0          # runner.py: a recovery fires after this
CX_TIMEOUT_S = 240               # the phase's wait for its heights
CX_CHECK_KEYS = 64               # keys of the kernels' checks at the shapes
# pex's ensure-peers period (p2p.pex_interval_seconds): chaos.toml keeps
# the default 30 s (PERF.md section 6 has a run at 5 s beside it)
CX_PEX_INTERVAL_S = 30.0


def _cx_counter_total(c) -> float:
    """The sum of a counter over its label sets."""
    return sum(c._values.values())


def serve_remote(listener: str, home: str) -> None:
    """Phase 17's out-of-process pair (``--serve-remote``), one process:
    validator04's kvstore (``RecordingApp``) behind an ``ABCIServer`` on a
    free port, written to ``home/abci_port``, and its ``FilePV`` (the key
    and state files under ``home``) behind a signer that dials the node's
    ``SignerListener`` at ``listener`` and redials.  On SIGTERM it writes
    ``home/record.json``: every sign request by (height, round, type or
    "proposal"), the double-sign refusals, the app's calls and its
    grammar check."""
    import asyncio
    import signal

    from cometbft_tpu_torch.abci.grammar import RecordingApp
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.abci.server import ABCIServer
    from cometbft_tpu_torch.privval import (DoubleSignError, FilePV,
                                            serve_dialer)

    host, _, port = listener.rpartition(":")
    signed, refusals = [], []

    async def main():
        app = RecordingApp(KVStoreApplication(device="cuda:0"))
        server = ABCIServer(app, port=0)
        await server.start()
        pv = FilePV.load(os.path.join(home, "priv_validator_key.json"),
                         os.path.join(home, "priv_validator_state.json"))
        vote_in, prop_in = pv.sign_vote, pv.sign_proposal

        async def sign_vote(chain_id, vote, sign_extension):
            try:
                await vote_in(chain_id, vote, sign_extension)
            except DoubleSignError as e:
                refusals.append(str(e))
                raise
            signed.append((vote.height, vote.round, vote.type))

        async def sign_proposal(chain_id, proposal):
            try:
                await prop_in(chain_id, proposal)
            except DoubleSignError as e:
                refusals.append(str(e))
                raise
            signed.append((proposal.height, proposal.round, "proposal"))

        pv.sign_vote, pv.sign_proposal = sign_vote, sign_proposal
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                      stop.set)
        dialer = asyncio.create_task(serve_dialer(pv, host, int(port),
                                                  retry_interval=0.1))
        with open(os.path.join(home, "abci_port.tmp"), "w") as f:
            f.write(str(server.port))
        os.replace(os.path.join(home, "abci_port.tmp"),
                   os.path.join(home, "abci_port"))
        await stop.wait()
        dialer.cancel()
        await server.stop()
        try:
            grammar = app.check()
        except Exception as e:       # recorded, judged by the phase
            grammar = f"{type(e).__name__}: {e}"
        with open(os.path.join(home, "record.json"), "w") as f:
            json.dump({"signed": signed, "refusals": refusals,
                       "calls": len(app.calls), "grammar_heights": grammar,
                       "app_height": app.inner.height}, f)

    asyncio.run(main())


def phase_chaos(pool, keys, dev):
    """Phase 17: ``networks/chaos.toml`` on the card, in a process of its
    own (:func:`phase_fresh`, ``--child chaos``: the fault plane is
    process-wide), every node a port ``Node`` over loopback TCP on
    ``dev``, configured as the JAX package's e2e runner configures them
    (``cometbft_tpu/e2e/runner.py:93-128``): 20 ms of emulated latency,
    drop-mode connection fuzzing from 5 s after each connection opens
    (``fuzz_prob_drop_rw`` 0.01, ``fuzz_seed`` ``CX_FUZZ_SEED``), the JAX
    package's test timeouts.  seed01 runs in seed mode; validator01-04
    dial only it (as the JAX package's ``cmd`` dials seeds) and find each
    other through pex.  Perturbations by the network's height, as the
    runner applies them: joiner01 (``fast_sync``) starts at 4 and is
    voted in at 6 with power 15 by a ``val:`` tx; validator02 is stopped
    at 5 and restarted from its home (LogDB stores, WAL, ``FilePV``
    files, the same listen address) at 7; validator03's pause:8 /
    resume:9 is a partition (``p2p.send.drop`` and ``p2p.recv.drop``
    armed with ``node=validator03`` from 8 to 9: a SIGSTOP needs one
    process per node); light01 starts at 6 (``light.Client`` over the
    validators' ``RPCProvider``s, sequential to height 12); load of 15
    txs/s for 25 s of 96-byte txs through ``broadcast_tx_async``.  An
    addition chaos.toml does not state: validator04's kvstore and its
    key run in one other process (``--serve-remote``: an ``ABCIServer``
    and a ``FilePV`` behind a signer that dials the node's
    ``SignerListener``).

    Checks: every live node at ``CX_TOP`` or more with equal blocks;
    joiner01 in the set and signing commits; light01's headers the
    chain's; every accepted load tx in every app (the remote one over
    ``abci_query``); every app's calls legal (``RecordingApp.check``);
    each of validator04's votes and proposals signed once by the remote
    signer, no refusal; each validator's book holding the others; the
    seed's hang-ups; the partition's drops in the plane's event log.
    K5a and K5b must launch and no plain version run; the oracle's calls
    must be 0, then every stored commit is re-checked by it; every
    launch's shape is recorded and K5a and K5b held against their plain
    versions there (:func:`_ss_check_lanes`)."""
    import asyncio
    import base64
    import shutil
    import signal
    import tempfile

    import numpy as np

    from cometbft_tpu_torch.abci.client import SocketClient
    from cometbft_tpu_torch.abci.grammar import RecordingApp
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.cmd import dial_until_up
    from cometbft_tpu_torch.config import Config, test_consensus_config
    from cometbft_tpu_torch.crypto import scheduler as vsched
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.libs import failures
    from cometbft_tpu_torch.light import (SEQUENTIAL, Client, RPCProvider,
                                          TrustOptions)
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.p2p import NodeKey
    from cometbft_tpu_torch.p2p import secret_connection as psc
    from cometbft_tpu_torch.p2p.metrics import p2p_metrics
    from cometbft_tpu_torch.p2p.switch import Switch
    from cometbft_tpu_torch.privval import FilePV, SignerListener
    from cometbft_tpu_torch.rpc import HTTPClient
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.priv_validator import MockPV

    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    out: dict = {"pex_interval_s": CX_PEX_INTERVAL_S}
    keep: dict = {}
    # the process's plane, armed (with no rule) as CMT_CHAOS would arm a
    # node's process; the partition's rules are armed and disarmed on it
    failures.configure(enabled=True, seed=CX_FUZZ_SEED)

    names = [f"validator0{i + 1}" for i in range(len(CX_POWERS))]
    pvs = [MockPV.from_secret(b"cx-" + n.encode()) for n in names]
    jpv = MockPV.from_secret(b"cx-joiner01")
    doc = GenesisDoc(chain_id=CHAIN_ID, validators=[
        GenesisValidator(pv.get_pub_key(), p)
        for pv, p in zip(pvs, CX_POWERS)])

    # the tallies the readings read, from wrappers of the switch and the
    # socket client (class level: every node of the phase)
    teardowns: dict = {}
    adds = [0]
    hangups = [0]
    app_ms: list = []
    sw_err, sw_add, sw_hang = (Switch.stop_peer_for_error, Switch._add_peer,
                               Switch.stop_peer_gracefully)
    sc_call = SocketClient.call

    async def stop_peer_for_error(self, peer, err):
        if peer.id in self.peers:
            k = type(err).__name__
            teardowns[k] = teardowns.get(k, 0) + 1
        return await sw_err(self, peer, err)

    async def add_peer(self, *a, **kw):
        p = await sw_add(self, *a, **kw)
        adds[0] += 1
        return p

    async def stop_gracefully(self, peer):
        hangups[0] += 1
        return await sw_hang(self, peer)

    async def timed_call(self, method, **params):
        t0 = time.perf_counter()
        try:
            return await sc_call(self, method, **params)
        finally:
            app_ms.append((time.perf_counter() - t0) * 1e3)

    Switch.stop_peer_for_error = stop_peer_for_error
    Switch._add_peer = add_peer
    Switch.stop_peer_gracefully = stop_gracefully
    SocketClient.call = timed_call

    def config(seed_mode=False, laddr="tcp://127.0.0.1:0", home=None,
               rpc=True):
        cfg = Config(consensus=test_consensus_config())
        cfg.base.device = str(dev)
        cfg.p2p.laddr = laddr
        cfg.rpc.laddr = "tcp://127.0.0.1:0" if rpc else ""
        cfg.p2p.emulated_latency_ms = CX_LATENCY_MS
        cfg.p2p.seed_mode = seed_mode
        cfg.p2p.pex_interval_seconds = CX_PEX_INTERVAL_S
        cfg.p2p.test_fuzz = True
        cfg.p2p.fuzz_start_after_s = CX_FUZZ_AFTER_S
        cfg.p2p.fuzz_seed = CX_FUZZ_SEED
        cfg.storage.db_backend = "logdb" if home else "memdb"
        return cfg

    async def make(name, pv, cfg, app, home=None, fast_sync=False):
        cfg.validate()
        return await Node.create(
            doc, app, priv_validator=pv, config=cfg,
            node_key=NodeKey.from_secret(b"cx-" + name.encode()),
            home=home, fast_sync=fast_sync, name=name)

    async def dial_seed(n, seed_addr):
        """The starter's seed dial (``cmd.dial_until_up``): retried, not
        persistent."""
        await dial_until_up(n, seed_addr, False)

    def file_pv(home):
        kp = os.path.join(home, "config", "priv_validator_key.json")
        sp = os.path.join(home, "data", "priv_validator_state.json")
        return kp, sp

    async def scenario(tmp):
        r: dict = {}
        t0 = time.perf_counter()
        listener, proc, rhome = keep["listener"], *keep["remote"]
        await listener.wait_for_signer(timeout=120.0)
        port_file = os.path.join(rhome, "abci_port")
        while not os.path.exists(port_file):
            if proc.poll() is not None:
                raise AssertionError("phase 17: the remote app and signer "
                                     f"exited with {proc.returncode}")
            await asyncio.sleep(0.05)
        with open(port_file) as f:
            abci_port = int(f.read())
        # what the main path waited for the remote pair
        r["remote_wait_s"] = time.perf_counter() - t0
        sign_ms = []
        for meth in ("sign_vote", "sign_proposal"):
            inner = getattr(listener, meth)

            async def timed(*a, _inner=inner, **kw):
                t1 = time.perf_counter()
                try:
                    return await _inner(*a, **kw)
                finally:
                    sign_ms.append((time.perf_counter() - t1) * 1e3)

            setattr(listener, meth, timed)

        seed = await make("seed01", None, config(seed_mode=True, rpc=False),
                          RecordingApp(KVStoreApplication(device=dev)))
        homes = {n: os.path.join(tmp, n) for n in names}
        v02_pv = FilePV(pvs[1].priv_key, *file_pv(homes["validator02"]))
        v02_pv.save_key()
        v02_pv._save_state()
        apps = {n: RecordingApp(KVStoreApplication(device=dev))
                for n in ("validator01", "validator02", "validator03")}
        nodes = {}
        for i, n in enumerate(names):
            if n == "validator04":
                cfg = config()
                cfg.base.abci = "socket"
                cfg.base.proxy_app = f"127.0.0.1:{abci_port}"
                nodes[n] = await make(n, listener, cfg, None)
            elif n == "validator02":
                nodes[n] = await make(n, v02_pv, config(home=homes[n]),
                                      apps[n], home=homes[n])
            else:
                nodes[n] = await make(n, pvs[i], config(), apps[n])
        live = dict(nodes)
        all_nodes = [seed] + list(nodes.values())
        keep["nodes"] = all_nodes
        await seed.start()
        seed_addr = seed.listen_addr
        t_start = time.perf_counter()
        for n in nodes.values():
            n.config.p2p.seeds = seed_addr
            await n.start()
        r["start_s"] = t_start - t0
        await asyncio.gather(*(dial_seed(n, seed_addr)
                               for n in nodes.values()))
        ids = {n: nodes[n].node_key.id for n in names}

        marks, rounds = {}, {}
        events = {}
        stamps = {"discovery_s": None, "met_all_s": None}
        met = {n: set() for n in names}      # peers each validator has had
        heights_by_minute = []
        v01 = nodes["validator01"]
        cli = HTTPClient(*v01.rpc_addr)
        sheds: list = []
        accepted: dict = {}
        load_done = asyncio.Event()

        async def load():
            """runner.py _drive_load: 15 txs/s for 25 s, 96 bytes each."""
            rng = np.random.default_rng(1717)
            end = time.perf_counter() + CX_LOAD_S
            i = 0
            while time.perf_counter() < end:
                key = b"e2e%06d" % i
                tx = key + b"=" + rng.bytes(CX_TX_BYTES).hex().encode()[
                    :CX_TX_BYTES - len(key) - 1]
                await _rpc_submit(cli, "broadcast_tx_async", sheds,
                                  tx=tx.hex())
                accepted[key] = tx[len(key) + 1:]
                i += 1
                await asyncio.sleep(1.0 / CX_LOAD_RATE)
            load_done.set()

        light_out: dict = {}

        async def light01():
            trust = TrustOptions(TRUSTING_PERIOD_NS, 1,
                                 v01.block_store.load_block(1).hash())
            c = Client(CHAIN_ID, trust,
                       RPCProvider(*v01.rpc_addr, "primary"),
                       witnesses=[RPCProvider(*nodes[w].rpc_addr, w)
                                  for w in ("validator03", "validator04")],
                       mode=SEQUENTIAL, device=dev)
            t1 = time.perf_counter()
            for h in range(2, CX_TOP + 1):
                # the primary and both witnesses past h
                while min(nodes[n].height() for n in (
                        "validator01", "validator03", "validator04")) \
                        < h + 1:
                    await asyncio.sleep(0.02)
                lb = await c.verify_light_block_at_height(h)
                light_out[h] = lb.header.hash()
            light_out["s"] = time.perf_counter() - t1

        async def valset_tx():
            pk = jpv.get_pub_key().bytes()
            tx = b"val:" + base64.b64encode(pk) + b"!" + \
                b"%0*d" % (len(str(CX_JOINER_POWER)) + 1, CX_JOINER_POWER)
            vcli = HTTPClient(*v01.rpc_addr)
            try:
                res = await _rpc_submit(vcli, "broadcast_tx_sync", sheds,
                                        tx=tx.hex())
            finally:
                await vcli.close()
            if res.get("code", 0) != 0:
                raise AssertionError(f"phase 17: valset tx rejected {res}")
            keep["valset_tx"] = tx

        tasks = [asyncio.create_task(load())]
        joiner = None
        stopped_at = None
        v02_addr = nodes["validator02"].listen_addr
        schedule = [(CX_JOINER_AT, "start", "joiner01"),
                    (CX_KILL_AT, "kill", "validator02"),
                    (CX_VALSET_AT, "valset", "joiner01"),
                    (CX_LIGHT_AT, "start", "light01"),
                    (CX_RESTART_AT, "restart", "validator02"),
                    (CX_PART_AT, "pause", "validator03"),
                    (CX_HEAL_AT, "resume", "validator03")]
        last_perturb = time.perf_counter()
        deadline = time.perf_counter() + CX_TIMEOUT_S
        next_minute = t_start + 60.0
        while True:
            now = time.perf_counter()
            h = v01.height()
            for hh in range(1, h + 1):
                if hh not in marks:
                    marks[hh] = now - t_start
                    rounds[hh] = _commit_round(v01, hh)
            for n in names:
                if n in live:
                    met[n] |= set(live[n].switch.peers)
            if stamps["discovery_s"] is None and all(
                    set(ids.values()) - {ids[n]} <= set(live[n].switch.peers)
                    for n in names if n in live):
                stamps["discovery_s"] = now - t_start
            if stamps["met_all_s"] is None and all(
                    set(ids.values()) - {ids[n]} <= met[n] for n in names):
                stamps["met_all_s"] = now - t_start
            if "v02_back" in stamps and "v02_caught_s" not in stamps and \
                    live["validator02"].height() >= min(
                        x.height() for n, x in live.items()
                        if n != "validator02"):
                # the restarted node caught up with the others
                stamps["v02_caught_s"] = now - stamps["v02_back"]
            if now >= next_minute:
                heights_by_minute.append(h)
                next_minute += 60.0
            fired = True
            while fired:
                fired = False
                for i, (at, action, who) in enumerate(schedule):
                    earlier = any(w == who for _, _, w in schedule[:i])
                    due = at <= h or (action in ("restart", "resume")
                                      and not earlier
                                      and now - last_perturb
                                      > CX_STALL_GRACE_S)
                    if not due:
                        continue
                    schedule.pop(i)
                    events[f"{action} {who}"] = {"height": h,
                                                 "s": now - t_start}
                    if action == "start" and who == "joiner01":
                        apps[who] = RecordingApp(
                            KVStoreApplication(device=dev))
                        joiner = await make("joiner01", jpv, config(),
                                            apps[who], fast_sync=True)
                        await joiner.start()
                        live["joiner01"] = joiner
                        keep["nodes"].append(joiner)
                        tasks.append(asyncio.create_task(
                            dial_seed(joiner, seed_addr)))
                    elif action == "start":
                        tasks.append(asyncio.create_task(light01()))
                    elif action == "valset":
                        await valset_tx()
                    elif action == "kill":
                        victim = live.pop(who)
                        await victim.stop()
                        stopped_at = victim.height()
                    elif action == "restart":
                        pv = FilePV.load(*file_pv(homes[who]))
                        keep["v02_pv"] = pv
                        app = RecordingApp(KVStoreApplication(device=dev))
                        apps[who] = app
                        back = await make(who, pv, config(
                            home=homes[who], laddr=f"tcp://{v02_addr}"),
                            app, home=homes[who])
                        replayed = (await back.app_conns.query.info()
                                    ).last_block_height
                        r["v02"] = {"stopped_at": stopped_at,
                                    "restarted_at": back.height(),
                                    "app_replayed_to": replayed}
                        if back.height() != stopped_at or \
                                replayed != stopped_at:
                            raise AssertionError(
                                f"phase 17: validator02 restarted at "
                                f"{back.height()}, its app replayed to "
                                f"{replayed}, stopped at {stopped_at}")
                        await back.start()
                        stamps["v02_back"] = time.perf_counter()
                        live[who] = back
                        nodes[who] = back
                        keep["nodes"].append(back)
                        tasks.append(asyncio.create_task(
                            dial_seed(back, seed_addr)))
                    elif action == "pause":
                        failures.arm(f"p2p.send.drop:node={who}")
                        failures.arm(f"p2p.recv.drop:node={who}")
                    elif action == "resume":
                        failures.disarm("p2p.send.drop")
                        failures.disarm("p2p.recv.drop")
                    last_perturb = time.perf_counter()
                    fired = True
                    break
            for t in tasks:
                if t.done() and t.exception() is not None:
                    raise t.exception()
            if not schedule and load_done.is_set() and \
                    min(n.height() for n in live.values()) >= CX_TOP and \
                    "s" in light_out:
                break
            if now > deadline:
                raise AssertionError(
                    f"phase 17: deadline at height {h} (pex every "
                    f"{CX_PEX_INTERVAL_S:g} s): heights each minute "
                    f"{heights_by_minute}, pending {schedule}, live "
                    f"{ {n: x.height() for n, x in live.items()} }")
            await asyncio.sleep(0.01)
        r["load_s"] = time.perf_counter() - t_start
        # every accepted tx committed everywhere: in-process apps read
        # directly, validator04's remote app over abci_query
        vcli = HTTPClient(*nodes["validator04"].rpc_addr)

        async def remote_has(key):
            res = await vcli.call("abci_query", path="/key", data=key.hex())
            return bytes.fromhex(res["response"]["value"])

        missing = dict(accepted)
        while missing:
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 17: {len(missing)} accepted "
                                     "txs never committed")
            for k in list(missing):
                if all(a.inner.state.get(k) == accepted[k]
                       for a in apps.values()) and \
                        await remote_has(k) == accepted[k]:
                    missing.pop(k)
            await asyncio.sleep(0.05)
        r["scheduler"] = vsched.get_scheduler().stats()
        top = min(n.height() for n in live.values())
        r["top"] = top
        await vcli.close()
        await cli.close()
        for t in tasks:
            t.cancel()
        # JSON-safe: the record crosses to the parent process
        r.update(per_height_s=[marks[h] - marks[h - 1]
                               for h in range(2, CX_TOP + 1)],
                 rounds=[rounds.get(h) for h in range(1, CX_TOP + 1)],
                 events=events, heights_by_minute=heights_by_minute,
                 discovery_s=stamps["discovery_s"],
                 met_all_s=stamps["met_all_s"],
                 v02_restart_to_caught_up_s=stamps.get("v02_caught_s"),
                 light={"s": light_out["s"], "headers": CX_TOP - 1},
                 accepted=len(accepted), sheds=len(sheds),
                 sign_ms=sign_ms)
        keep["light"] = light_out
        keep["live"] = live
        keep["apps"] = apps
        keep["accepted"] = accepted
        keep["listener"] = listener
        keep["ids"] = ids
        return r

    def start_remote(tmp):
        """validator04's app and key, in a process of their own, started
        first: its start-up overlaps the tracer's warm-up."""
        rhome = os.path.join(tmp, "remote")
        os.makedirs(rhome)
        rpv = FilePV(pvs[3].priv_key,
                     os.path.join(rhome, "priv_validator_key.json"),
                     os.path.join(rhome, "priv_validator_state.json"))
        rpv.save_key()
        rpv._save_state()
        listener = SignerListener()
        keep["listener"] = listener
        lhost, lport = run(listener.listen())
        keep["remote"] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-remote",
             f"{lhost}:{lport}", rhome]), rhome)

    def stop_remote():
        proc = keep["remote"][0]
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)

    tmp = tempfile.mkdtemp(prefix="chaos", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    t_ph = time.perf_counter()
    out["setup_s"] = t_ph - _T_LOADED
    start_remote(tmp)
    try:
        profile_call(_sync, warm=_sync, host=False)
    except BaseException:
        stop_remote()
        raise
    calls, restore = _oracle_counter()
    checks0 = sum(psc.HANDSHAKE_CHECKS.values())
    seen: dict = {}

    def main_path():
        box = {}

        def go():
            box["r"] = run(scenario(tmp))

        try:
            box["profile"] = profile_call(go, top=6, warm=lambda: None,
                                          host=False)
        finally:
            for n in keep.get("nodes", []):
                run(n.stop())
            run(keep["listener"].close())
            stop_remote()
        return box

    try:
        with launch_shapes(seen):
            launches, box = _path_launches(
                main_path, ("ed25519_tables", "ed25519_verify_gather"))
    finally:
        restore()
        Switch.stop_peer_for_error, Switch._add_peer = sw_err, sw_add
        Switch.stop_peer_gracefully = sw_hang
        SocketClient.call = sc_call
    r = box["r"]
    out.update(r)
    out["profile"] = box["profile"]
    out["main_path_s"] = time.perf_counter() - t_ph
    out["handshake_checks"] = sum(psc.HANDSHAKE_CHECKS.values()) - checks0
    out["oracle_calls"] = calls[0]
    if calls[0]:
        raise AssertionError(f"phase 17: the host oracle was called "
                             f"{calls[0]} times on the path")
    live, apps, top = keep["live"], keep["apps"], r["top"]
    if top < CX_TOP:
        raise AssertionError(f"phase 17: live nodes at {top}")
    for h in range(1, top + 1):
        if len({n.block_store.load_block(h).hash()
                for n in live.values()}) != 1:
            raise AssertionError(f"phase 17: fork at height {h}")
    # joiner01: in the set from two heights after the block that carried
    # its val: tx (an update a block returns sets the validators of the
    # height after next), and signing commits
    jaddr = jpv.get_pub_key().address()
    v01 = live["validator01"]
    carried = [h for h in range(1, top + 1)
               if keep["valset_tx"] in v01.block_store.load_block(h).data.txs]
    in_set = [h for h in range(1, top + 1)
              if v01.state_store.load_validators(h) is not None and
              v01.state_store.load_validators(h).get_by_address(jaddr)
              [1] is not None]
    if len(carried) != 1 or in_set != list(range(carried[0] + 2, top + 1)):
        raise AssertionError(f"phase 17: joiner01's val: tx in blocks "
                             f"{carried}, joiner01 in the set at {in_set}")
    j_signed = []
    for h in range(in_set[0], top + 1):
        c = v01.block_store.load_block_commit(h)
        if c is None:
            continue
        vals = v01.state_store.load_validators(h)
        idx = vals.get_by_address(jaddr)[0]
        if not c.signatures[idx].is_absent():
            j_signed.append(h)
    if not j_signed:
        raise AssertionError("phase 17: joiner01 signed no commit")
    out["joiner"] = {"tx_in_block": carried[0], "in_set_from": in_set[0],
                     "signed_commits": j_signed,
                     "switched_to_consensus":
                         not live["joiner01"].consensus_reactor.wait_sync}
    # light01: the chain's headers
    bad = [h for h in range(2, CX_TOP + 1)
           if keep["light"][h] != v01.block_store.load_block(h).hash()]
    if bad:
        raise AssertionError(f"phase 17: light01 verified other headers at "
                             f"{bad}")
    # every accepted load tx in every in-process app (the remote app's
    # were read over abci_query)
    for n, a in apps.items():
        lost = [k for k, v in keep["accepted"].items()
                if a.inner.state.get(k) != v]
        if lost:
            raise AssertionError(f"phase 17: {n}'s app lacks {len(lost)} "
                                 "accepted txs")
    # the grammar of every app, the remote one from its record
    grammar = {n: a.check() for n, a in apps.items()}
    proc, rhome = keep["remote"]
    with open(os.path.join(rhome, "record.json")) as f:
        rrec = json.load(f)
    if not isinstance(rrec["grammar_heights"], int) or \
            rrec["grammar_heights"] < top:
        raise AssertionError(f"phase 17: the remote app's calls "
                             f"{rrec['grammar_heights']}")
    grammar["validator04 (remote)"] = rrec["grammar_heights"]
    out["grammar_heights"] = grammar
    # the remote signer: each vote and proposal signed once, no refusal
    signed = [tuple(s) for s in rrec["signed"]]
    if rrec["refusals"] or len(set(signed)) != len(signed) or not signed:
        raise AssertionError(f"phase 17: remote signer signed {len(signed)}"
                             f" ({len(set(signed))} distinct), refusals "
                             f"{rrec['refusals'][:3]}")
    out["remote"] = {"signed": len(signed),
                     "proposals": sum(1 for s in signed
                                      if s[2] == "proposal"),
                     "refusals": 0, "app_calls": rrec["calls"],
                     "app_height": rrec["app_height"],
                     "listener_round_trips": len(r["sign_ms"])}
    # books: each validator holds the others it learned through the seed
    ids = keep["ids"]
    books = {}
    for n in (x for x in live if x.startswith("validator")):
        held = {i for i, _ in live[n].addr_book.sample(1000)}
        books[n] = sorted(m for m, i in ids.items() if i in held)
        if set(ids) - {n} - set(books[n]):
            raise AssertionError(f"phase 17: {n}'s book lacks "
                                 f"{set(ids) - {n} - set(books[n])}")
    out["books"] = books
    if not hangups[0]:
        raise AssertionError("phase 17: the seed never hung up")
    # the plane's log: the partition's drops
    ev = failures.events()
    drops = {s: sum(1 for e in ev if e["site"] == s
                    and e.get("node") == "validator03")
             for s in ("p2p.send.drop", "p2p.recv.drop")}
    if not all(drops.values()):
        raise AssertionError(f"phase 17: partition drops {drops}")
    fuzz = {}
    for n in keep["nodes"]:
        for k, v in n.transport.fuzz_config.counts.items():
            fuzz[k] = fuzz.get(k, 0) + v
    mets = p2p_metrics()
    out.update(
        hangups=hangups[0], partition_drops=drops, fuzz=fuzz,
        teardowns=teardowns, peer_adds=adds[0],
        payload_sent=_cx_counter_total(mets.peer_send_bytes),
        payload_recv=_cx_counter_total(mets.peer_recv_bytes),
        app_ms=app_ms, v02_refuses_conflict=run(_nd_refuses_conflict(
            keep["v02_pv"])))
    if not out["v02_refuses_conflict"]:
        raise AssertionError("phase 17: validator02's FilePV signed a "
                             "conflicting message")
    t0 = time.perf_counter()
    out["oracle_rechecked"] = {
        n: _oracle_recheck(_nd_recheck_target(live[n], doc), top)
        for n in ("validator01", "validator02", "joiner01")}
    out["recheck_s"] = time.perf_counter() - t0
    out["shapes"] = {k: sorted(v) for k, v in seen.items()}
    t0 = time.perf_counter()
    privs = [Ed25519PrivKey.from_secret(b"cx-check%d" % i)
             for i in range(CX_CHECK_KEYS)]
    lanes = _ss_check_lanes(seen, privs, dev)
    out["checks"] = {"lanes": lanes, "check_s": time.perf_counter() - t0}
    bad = {k: m for k, m in lanes["mismatches"].items() if m}
    if bad:
        raise AssertionError(f"phase 17: kernels against their plain "
                             f"versions at the path's shapes: {bad}")
    out["checks_s"] = time.perf_counter() - t_ph - out["main_path_s"]
    shutil.rmtree(tmp, ignore_errors=True)
    loop.close()
    return launches, out


def report_chaos(cx, launches, card) -> None:
    """Phase 17's lines."""
    per, rounds = cx["per_height_s"], cx["rounds"]
    print(f"chaos (phase 17): {cx['phase_s']:.1f} s in its process (set-up "
          f"{cx['setup_s']:.1f} s, main path {cx['main_path_s']:.1f} s, "
          f"checks {cx['checks_s']:.1f} s, exit {cx['exit_s']:.1f} s); pex "
          f"every "
          f"{cx['pex_interval_s']:g} s; launches {launches}; handshake "
          f"device checks {cx['handshake_checks']}; oracle calls on the "
          f"path {cx['oracle_calls']}, stored lanes re-checked by it "
          f"afterwards {cx['oracle_rechecked']} in {cx['recheck_s']:.1f} s")
    print(f"chaos heights 1-{CX_TOP}: a height "
          f"{[round(x, 3) for x in per]} s (mean over 2-{CX_TOP} "
          f"{statistics.mean(per):.3f}); rounds {rounds}, heights with "
          f"round > 0 {[h + 1 for h, x in enumerate(rounds) if x]}; top "
          f"{cx['top']} after {cx['load_s']:.1f} s; heights each minute "
          f"{cx['heights_by_minute']}  [{card}]")
    print(f"chaos discovery: every validator a peer of every other at "
          f"once after {cx['discovery_s']} s, each having met every other "
          f"after {cx['met_all_s']} s; peers added {cx['peer_adds']}, "
          f"tear-downs {cx['teardowns']}, seed hang-ups {cx['hangups']}; "
          f"fuzz decisions {cx['fuzz']}; partition drops "
          f"{cx['partition_drops']}; books {cx['books']}  [{card}]")
    top = cx["top"]
    print(f"chaos traffic: payload bytes a height sent "
          f"{cx['payload_sent'] / top:.0f}, received "
          f"{cx['payload_recv'] / top:.0f}; load {cx['accepted']} txs "
          f"accepted, sheds {cx['sheds']}; events {cx['events']}  [{card}]")
    sm, am = cx["sign_ms"], cx["app_ms"]
    print(f"chaos remote: signer round trips {len(sm)} p50 "
          f"{statistics.median(sm):.2f} ms max {max(sm):.2f} ms; socket "
          f"app calls {len(am)} p50 {statistics.median(am):.3f} ms max "
          f"{max(am):.2f} ms; {cx['remote']}; grammar heights "
          f"{cx['grammar_heights']}; joiner01 {cx['joiner']}; light01 "
          f"verified 2-{CX_TOP} in {cx['light']['s']:.2f} s; validator02 "
          f"{cx['v02']}, restart to caught up "
          f"{cx['v02_restart_to_caught_up_s']} s, conflicting sign refused "
          f"{cx['v02_refuses_conflict']}  [{card}]")
    prof = cx["profile"]
    print(f"profile chaos: wall {prof['wall_ms']:.0f} ms, device "
          f"{prof['device_ms']} ms (busy {prof['device_busy_share']}), "
          f"kernels {prof['kernels_ms']}  [{card}]")
    ck = cx["checks"]["lanes"]
    print(f"chaos shapes {cx['shapes']}; K5a tables {ck['tables']}, K5b "
          f"lanes {ck['per_lane']}: mismatches {ck['mismatches']} in "
          f"{cx['checks']['check_s']:.1f} s  [{card}]")


E2E_MANIFEST = os.path.join("networks", "ci.toml")   # --e2e MANIFEST
# the runner's first port (three a node): below the kernel's ephemeral
# range, where every in-process node of phases 12-17 binds port 0
E2E_BASE_PORT = 26900
E2E_DEADLINE_S = 240             # the runner's deadline
E2E_LOAD_RATE, E2E_LOAD_S, E2E_TX_BYTES = 20.0, 5.0, 64  # `load`, after
E2E_SETTLE_HEIGHTS = 3           # heights past the load before its report
# dispatch kind -> kernel, for the shapes held against the plain versions
E2E_KINDS = {"tables": "ed25519_tables", "gather": "ed25519_verify_gather",
             "rlc_gather": "ed25519_rlc_gather"}
E2E_NODE_KERNELS = ("ed25519_tables", "ed25519_verify_gather")  # every node


def dispatch_series(text: str) -> dict:
    """The kernel-dispatch series of a ``/metrics`` text
    (``crypto/batch.py:_note_dispatch``): kind -> {"lanes": {lane count:
    first dispatch s}, "count": dispatches, "seconds": their wall}."""
    import re

    out = {}
    for ln in text.splitlines():
        m = re.match(r"(crypto_kernel_first_dispatch_seconds|"
                     r"crypto_kernel_dispatch_seconds_count|"
                     r"crypto_kernel_dispatch_seconds_sum)\{([^}]*)\} (\S+)$",
                     ln)
        if not m:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2)))
        k = out.setdefault(labels["kind"],
                           {"lanes": {}, "count": 0, "seconds": 0.0})
        v = float(m.group(3))
        if m.group(1) == "crypto_kernel_first_dispatch_seconds":
            k["lanes"][int(labels["lanes"])] = v
            k["count"] += 1
            k["seconds"] += v
        elif m.group(1).endswith("_count"):
            k["count"] += int(v)
        else:
            k["seconds"] += v
    return out


def process_counters(text: str) -> dict:
    """A process's kernel calls and allocator memory from its ``/metrics``
    text (``crypto/batch.py``): {"cuda": {kernel: launches}, "plain":
    {kernel: plain runs}, "memory_mib": {device/kind: MiB}}."""
    import re

    out = {"cuda": {}, "plain": {}, "memory_mib": {}}
    for m in re.finditer(r'^crypto_kernel_calls_total\{kernel="(\w+)",'
                         r'route="(\w+)"\} (\S+)$', text, re.M):
        out[m.group(2)][m.group(1)] = int(float(m.group(3)))
    for m in re.finditer(r'^torch_cuda_memory_bytes\{device="([^"]+)",'
                         r'kind="(\w+)"\} (\S+)$', text, re.M):
        out["memory_mib"][f"{m.group(1)}/{m.group(2)}"] = (
            float(m.group(3)) / 2**20)
    return out


def _rpc_get(port: int, path: str, timeout: float = 10.0) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read().decode()


def _rpc_height(port: int) -> int:
    return json.loads(_rpc_get(port, "/status"))["result"]["sync_info"][
        "latest_block_height"]


def phase_e2e(pool, keys, dev):
    """Phase 18: an e2e manifest (``E2E_MANIFEST``, networks/ci.toml
    unless ``--e2e`` names another) run whole through the port's
    ``e2e.Runner``, the code ``python -m cometbft_tpu_torch e2e`` runs:
    every node and the light daemon an OS process of its own started as
    ``python -m cometbft_tpu_torch ... start`` (``light``) on the card
    (no ``--device``: the card is the default), the JAX package's e2e
    timeouts, the manifest's perturbations as real signals (SIGKILL and
    a restart from the home, SIGSTOP and SIGCONT) and its load.  After
    the runner's invariants (every live node at the final height with
    one block hash, the light daemon's verified header the chain's),
    before the stop: ``load`` at ``E2E_LOAD_RATE`` txs/s for
    ``E2E_LOAD_S`` s and ``load-report`` as processes against the
    runner's primary, every process's ``/metrics``.  After the stop:
    ``doctor`` (report-only) as a process on the home of the node the
    schedule killed.  The load tools and the doctor are the runner's own
    command line (``Runner._cli``).

    Each process's launches are its ``crypto_kernel_calls_total``
    (``ops/_build.py``'s ``LAUNCHES``, added where a kernel launches, and
    ``PLAIN_CALLS``), which start at 0 with the process, read from its
    ``/metrics`` just before the stop: a restarted node's counts are its
    last process's.  Every node must have launched K5a and K5b, no
    process may have run a plain version or launched an ``OFF_PATH``
    kernel.  The lane and key counts of the kernel-dispatch series'
    ``lanes`` labels are then held against the plain versions in this
    process (:func:`_ss_check_lanes`).  Readings: each process's
    start-up (spawn to RPC answering), each height's wall (between its
    commit time and the previous height's, each the BFT time of the
    header after it: the median of the commit's precommit timestamps)
    and round, a restarted or
    late node's catch-up to the height the runner last logged, the light
    daemon's first verified header, the load's latency, the card's
    utilization (``nvidia-smi``, every process on the card), each
    process's allocator memory and dispatch wall."""
    import asyncio
    import random
    import shutil

    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.e2e import Runner, free_port_base, load_manifest
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.rpc import HTTPClient, RPCError
    from cometbft_tpu_torch.rpc.json import from_jsonable

    root = os.path.dirname(os.path.abspath(__file__))
    man_path = os.path.join(root, E2E_MANIFEST)
    m = load_manifest(man_path)
    stem = os.path.splitext(os.path.basename(man_path))[0]
    base_dir = os.path.join(root, "build", f"e2e_{stem}")
    base_port = free_port_base(3 * len(m.nodes), start=E2E_BASE_PORT)
    t_ph = time.perf_counter()
    out: dict = {"manifest": E2E_MANIFEST, "base_port": base_port,
                 "setup_s": t_ph - _T_LOADED}
    spawns: dict = {}       # name -> [{at_height, rpc_s, caught_up_s...}]
    top = [0]               # the height the runner last logged
    tasks: list = []
    events: list = []
    t0 = [time.perf_counter()]
    retry = (OSError, EOFError, ValueError, RPCError, asyncio.TimeoutError)

    async def probe(r, name, ent, proc):
        """Spawn to RPC answering; then a light daemon's first verified
        header, or a late or restarted node's catch-up to the height the
        runner had logged when the node's RPC answered."""
        cli = HTTPClient("127.0.0.1", r.rpc_port(name))
        light = r.m.nodes[name].mode == "light"
        try:
            while True:
                if proc.poll() is not None:
                    ent["exited"] = proc.returncode
                    return
                try:
                    await asyncio.wait_for(cli.call("status"), 2.0)
                    break
                except retry:
                    await asyncio.sleep(0.05)
            ent["rpc_s"] = time.perf_counter() - ent["t"]
            if light:
                while True:
                    try:
                        await asyncio.wait_for(cli.call("header"), 10.0)
                        break
                    except retry:
                        await asyncio.sleep(0.1)
                ent["first_header_s"] = time.perf_counter() - ent["t"]
            elif ent["at_height"] > 1:
                target = top[0]
                while True:
                    try:
                        st = await asyncio.wait_for(cli.call("status"), 2.0)
                        if st["sync_info"]["latest_block_height"] >= target:
                            break
                    except retry:
                        pass
                    if proc.poll() is not None:
                        return
                    await asyncio.sleep(0.1)
                ent["caught_up_s"] = time.perf_counter() - ent["t"]
                ent["caught_up_to"] = target
        finally:
            await cli.close()

    class TimedRunner(Runner):
        def _spawn(self, name):
            super()._spawn(name)
            ent = {"at_height": top[0], "t": time.perf_counter(),
                   "at_s": time.perf_counter() - t0[0]}
            spawns.setdefault(name, []).append(ent)
            tasks.append(asyncio.get_running_loop().create_task(
                probe(self, name, ent, self.procs[name])))

    def log(msg):
        if msg.startswith("[e2e] height "):
            top[0] = int(msg.split()[-1])
        else:
            events.append((round(time.perf_counter() - t0[0], 3), top[0],
                           msg))

    def cli(*argv, timeout=120.0):
        """A command of the runner's command line as a process."""
        p = subprocess.run(runner._cli(*argv), cwd=root, capture_output=True,
                           text=True, timeout=timeout)
        return p.returncode, p.stdout, p.stderr

    runner = TimedRunner(m, base_dir, base_port=base_port, log=log,
                         rng=random.Random(18))
    runner.setup()
    primary = runner.rpc_port(runner._primary_name())

    async def go():
        t0[0] = time.perf_counter()
        try:
            report = await runner.run(deadline_s=E2E_DEADLINE_S)
            out["run_s"] = time.perf_counter() - t0[0]
            return report
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu,memory.used",
         "--format=csv,noheader,nounits", "-lms", "250"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        try:
            report = asyncio.run(go())
        finally:
            smi.terminate()
            smi_out = smi.communicate(timeout=30)[0]
        out["report"] = report
        # every context on the card as nvidia-smi lists it; its pids are
        # not this namespace's, so the lines stay unattributed
        out["compute_apps"] = _run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"]).splitlines()
        # the load tools as processes against the primary
        t1 = time.perf_counter()
        rc, lo, le = cli("load", "--rpc", f"127.0.0.1:{primary}",
                         "--rate", str(E2E_LOAD_RATE), "--duration",
                         str(E2E_LOAD_S), "--size", str(E2E_TX_BYTES))
        if rc:
            raise AssertionError(f"phase 18: load exited {rc}: {le[-2000:]}")
        load = json.loads(lo)
        h0 = _rpc_height(primary)
        while _rpc_height(primary) < h0 + E2E_SETTLE_HEIGHTS:
            if time.perf_counter() - t1 > 120:
                raise AssertionError("phase 18: the chain stopped after "
                                     "the load")
            time.sleep(0.1)
        rc, ro, re_ = cli("load-report", "--rpc", f"127.0.0.1:{primary}",
                          "--run-id", load["run_id"])
        if rc:
            raise AssertionError(f"phase 18: load-report exited {rc}: "
                                 f"{re_[-2000:]}")
        load_report = json.loads(ro)
        out["load"], out["load_report"] = load, load_report
        out["load_s"] = time.perf_counter() - t1
        if load["errors"] or load_report["txs"] != load["sent"]:
            raise AssertionError(f"phase 18: load {load}, committed "
                                 f"{load_report['txs']}")
        # a height's commit time is the next header's (BFT time: the
        # median of the commit's precommit timestamps)
        heads = {}
        for h in range(1, m.final_height + 2):
            res = json.loads(_rpc_get(primary, f"/commit?height={h}"))[
                "result"]
            heads[h] = (from_jsonable(res["header"]).time_ns,
                        from_jsonable(res["commit"]).round)
        # every live process's counters and dispatch series, and each
        # node's kernel bundle from its warm boot
        series, calls, bundles = {}, {}, {}
        for name, proc in runner.procs.items():
            if proc.poll() is None:
                text = _rpc_get(runner.rpc_port(name), "/metrics")
                series[name] = dispatch_series(text)
                calls[name] = process_counters(text)
                if m.nodes[name].mode != "light":
                    bundles[name] = json.loads(_rpc_get(
                        runner.rpc_port(name), "/status"))["result"][
                        "compile_bundle"]
        out["lifetime_s"] = {n: time.perf_counter() - s[-1]["t"]
                             for n, s in spawns.items()}
    finally:
        runner.stop()
    out["main_path_s"] = time.perf_counter() - t_ph
    killed = [n for n in runner.names
              if any(a == "kill" for _, a in m.nodes[n].schedule())]
    victim = killed[0] if killed else runner._primary_name()
    rc, do, de = cli("--home", runner.home(victim), "doctor")
    try:
        doctor = json.loads(do)
    except ValueError:
        doctor = {"stdout": do[-2000:], "stderr": de[-2000:]}
    out["doctor"] = {"node": victim, "rc": rc, "ok": doctor.get("ok"),
                     "refused": doctor.get("refused")}
    if rc:
        raise AssertionError(f"phase 18: doctor on {victim}'s home exited "
                             f"{rc}: {doctor}")

    out["compile_bundle"] = {
        n: {k: b.get(k) for k in ("status", "load_s", "warm_s", "kernels")}
        for n, b in bundles.items()}
    if any(b.get("status") != "loaded" for b in bundles.values()):
        raise AssertionError(f"phase 18: kernel bundles not loaded at the "
                             f"nodes' warm boot: {bundles}")
    unread = {n: sorted(set(_build.KERNELS) - set(c["cuda"])
                        | set(_build.KERNELS) - set(c["plain"]))
              for n, c in calls.items()}
    plain = {n: {k: v for k, v in c["plain"].items() if v}
             for n, c in calls.items()}
    off = {n: {k: c["cuda"][k] for k in OFF_PATH if c["cuda"].get(k)}
           for n, c in calls.items()}
    nodes = [n for n in calls if m.nodes[n].mode != "light"]
    missing = {n: [k for k in E2E_NODE_KERNELS if not calls[n]["cuda"][k]]
               for n in nodes}
    if (any(unread.values()) or any(plain.values()) or any(off.values())
            or any(missing.values()) or len(nodes) < 2):
        raise AssertionError(
            f"phase 18: kernels not launched in the node processes "
            f"{missing}, plain versions run {plain}, standalone hash "
            f"kernels launched {off}, counters not served {unread}")
    launches = {k: sum(c["cuda"][k] for c in calls.values())
                for k in _build.KERNELS}
    out["launches_by_process"] = {
        n: {k: v for k, v in c["cuda"].items() if v}
        for n, c in calls.items()}
    out["memory_mib"] = {n: c["memory_mib"] for n, c in calls.items()}
    out["series"] = series

    # readings
    out["per_height_s"] = [[h, (heads[h + 1][0] - heads[h][0]) / 1e9]
                           for h in range(2, m.final_height + 1)]
    out["rounds"] = [[h, heads[h][1]] for h in range(2, m.final_height + 1)]
    out["startup_s"] = {n: [e.get("rpc_s") for e in s]
                        for n, s in spawns.items()}
    out["catch_up"] = {n: [(e["at_height"], e.get("caught_up_s"),
                            e.get("caught_up_to")) for e in s
                           if e["at_height"] > 1]
                       for n, s in spawns.items()
                       if m.nodes[n].mode != "light"}
    out["light"] = {n: {"startup_s": s[0].get("rpc_s"),
                        "first_header_s": s[0].get("first_header_s"),
                        "at_height": s[0]["at_height"]}
                    for n, s in spawns.items()
                    if m.nodes[n].mode == "light"}
    util = [[float(x) for x in ln.split(",")] for ln in smi_out.splitlines()
            if ln.count(",") == 1]
    out["utilization"] = {
        "samples": len(util),
        "mean_pct": statistics.mean(u[0] for u in util) if util else None,
        "max_pct": max(u[0] for u in util) if util else None,
        "max_memory_mib": max(u[1] for u in util) if util else None}
    out["dispatch_wall_share"] = {
        n: sum(v["seconds"] for v in s.values()) / out["lifetime_s"][n]
        for n, s in series.items()}
    out["events"] = events

    t1 = time.perf_counter()
    seen = {k: {(n,) for s in series.values()
                for n in s.get(kind, {}).get("lanes", {})}
            for kind, k in E2E_KINDS.items()}
    out["shapes"] = {k: sorted(v) for k, v in seen.items()}
    privs = [Ed25519PrivKey.from_secret(b"e2e-check%d" % i)
             for i in range(CX_CHECK_KEYS)]
    lanes = _ss_check_lanes(seen, privs, dev)
    out["checks"] = {"lanes": lanes, "check_s": time.perf_counter() - t1}
    bad = {k: v for k, v in lanes["mismatches"].items() if v}
    if bad:
        raise AssertionError(f"phase 18: kernels against their plain "
                             f"versions at the processes' shapes: {bad}")
    shutil.rmtree(base_dir, ignore_errors=True)
    return launches, out


def report_e2e(e2e, launches, card) -> None:
    """Phase 18's lines."""
    walls = [s for _, s in e2e["per_height_s"]]
    tops = [h for h, _ in e2e["per_height_s"]]
    print(f"e2e (phase 18) {e2e['manifest']}: {e2e['phase_s']:.1f} s in "
          f"its process (set-up {e2e['setup_s']:.1f} s, main path "
          f"{e2e['main_path_s']:.1f} s, runner to its invariants "
          f"{e2e['run_s']:.1f} s); launches "
          f"{ {k: v for k, v in launches.items() if v} } (every other "
          f"kernel 0); by process {e2e['launches_by_process']}  [{card}]")
    print(f"e2e invariants: {e2e['report']}")
    print(f"e2e heights 2-{max(tops, default=0)}, between commit times: a "
          f"height {[round(x, 3) for x in walls]} s (mean "
          f"{statistics.mean(walls) if walls else float('nan'):.3f}); "
          f"rounds {e2e['rounds']}  [{card}]")
    print(f"e2e warm boot by node (/status compile_bundle): "
          f"{e2e['compile_bundle']}  [{card}]")
    print(f"e2e start-up, spawn to RPC answering, s: {e2e['startup_s']}; "
          f"catch-up (spawned at height, s, to height) {e2e['catch_up']}; "
          f"light {e2e['light']}  [{card}]")
    lr = e2e["load_report"]
    print(f"e2e load: {e2e['load']['sent']} txs sent at "
          f"{E2E_LOAD_RATE:g}/s, {lr['txs']} committed, latency p50 "
          f"{lr['p50_s']} s max {lr['max_s']} s; report {lr}  [{card}]")
    print(f"e2e card: utilization.gpu (nvidia-smi, every process) "
          f"{e2e['utilization']}; allocator MiB by process "
          f"{e2e['memory_mib']}; nvidia-smi's contexts (pid, MiB; pids "
          f"unattributed) {e2e['compute_apps']}; dispatch wall share by "
          f"process "
          f"{ {n: round(v, 5) for n, v in e2e['dispatch_wall_share'].items()} }"
          f"; busy share traced in a node process: not measured  [{card}]")
    print(f"e2e doctor {e2e['doctor']}; events {e2e['events']}")
    ck = e2e["checks"]["lanes"]
    print(f"e2e shapes {e2e['shapes']}; K5a tables {ck['tables']}, K5b "
          f"lanes {ck['per_lane']}, K6a {ck['verdicts']}: mismatches "
          f"{ck['mismatches']} in {e2e['checks']['check_s']:.1f} s  [{card}]")


# ------------------------------------------------ phase 19: the scenario lab

# the JAX package's verdicts, written on the CPU by
# ``python tests/torch_sim_fixtures.py --write`` (the script reads the
# file; it imports nothing of the JAX package)
SIM_REFERENCE = os.path.join("tests", "torch_sim_reference.json")
# the programs phase 19 runs (None: every one of the file, the eight
# curated scenarios and both statesync programs; ``--sim``)
SIM_NAMES = None
# the whole run's cut, for its time limit (PERF.md section 4): the
# largest scenario, the mixed-key one, one of 25 nodes and the 50-node
# fleet; no program's size is cut
SIM_WHOLE = ("asym-cut-gray-25", "bls-mixed-lab-12", "megamix-100",
             "fleet-bootstrap-50")
SIM_KERNELS = ("ed25519_tables", "ed25519_verify_gather",
               "aggregate_g1_masked")
SIM_RECHECK_G9 = 24              # K9 launches re-checked (a seeded sample)


def _sim_capture():
    """Wrap the wrappers of K5a, K5b and K9 so that each launch's inputs
    and outputs are kept (on the card) for :func:`_sim_recheck`.
    Returns (kept, restore)."""
    import torch

    from cometbft_tpu_torch.ops import blsg1 as G
    from cometbft_tpu_torch.ops import ed25519 as ed

    kept = {k: [] for k in SIM_KERNELS}
    inner = (ed.prepare_pubkey_tables, ed.verify_padded_gather,
             G.g1_masked_sum)

    def tables(pub):
        tab, ok = inner[0](pub)
        kept["ed25519_tables"].append((pub.clone(), tab.clone(), ok.clone()))
        return tab, ok

    def gather(tab, ok_a, idx, *lanes):
        out = inner[1](tab, ok_a, idx, *lanes)
        rows = idx.long()          # the lanes' rows only, not the set's
        kept["ed25519_verify_gather"].append((
            (tab[rows], ok_a[rows],
             torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device),
             *(a.clone() for a in lanes)), out.clone()))
        return out

    def fold(words, mask):
        out = inner[2](words, mask)
        kept["aggregate_g1_masked"].append(
            (words.clone(), mask.clone(), out.clone()))
        return out

    ed.prepare_pubkey_tables, ed.verify_padded_gather = tables, gather
    G.g1_masked_sum = fold

    def restore():
        ed.prepare_pubkey_tables, ed.verify_padded_gather = inner[:2]
        G.g1_masked_sum = inner[2]

    return kept, restore


def _sim_recheck(kept: dict) -> dict:
    """Every kept launch of K5a and of K5b recomputed by the plain
    versions on the card, all keys in one call and all lanes in one
    (each lane with its own table rows, blocks zero-padded to the widest
    launch's count: the plain version reads a lane's active blocks
    only), and a seeded sample of ``SIM_RECHECK_G9`` K9 launches: tables
    compared canonical, verdicts and folds exactly.  Mismatches count
    keys, lanes and folds."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.ops import blsg1 as G
    from cometbft_tpu_torch.ops import ed25519 as ed

    rng = np.random.default_rng(1919)
    mism = dict.fromkeys(SIM_KERNELS, 0)
    checked = dict.fromkeys(SIM_KERNELS, 0)
    k5a = kept["ed25519_tables"]
    if k5a:
        pub = torch.cat([p for p, _, _ in k5a])
        tab = torch.cat([t for _, t, _ in k5a])
        ok = torch.cat([o for _, _, o in k5a])
        tab_p, ok_p = ed._prepare_plain(pub)
        mism["ed25519_tables"] = int(((ok != ok_p) | (
            ed.tables_canonical(tab) != ed.tables_canonical(tab_p))
            .flatten(1).any(1)).sum())
        checked["ed25519_tables"] = pub.shape[0]
    k5b = kept["ed25519_verify_gather"]
    if k5b:
        nb = max(a[5].shape[1] for a, _ in k5b)

        def padded(blocks):
            extra = nb - blocks.shape[1]
            return blocks if not extra else torch.cat(
                [blocks, blocks.new_zeros((blocks.shape[0], extra, 32))], 1)

        tab = torch.cat([a[0] for a, _ in k5b])
        ok_a = torch.cat([a[1] for a, _ in k5b])
        rb, sb, active = (torch.cat([a[i] for a, _ in k5b])
                          for i in (3, 4, 6))
        blocks = torch.cat([padded(a[5]) for a, _ in k5b])
        out = torch.cat([o for _, o in k5b])
        idx = torch.arange(out.shape[0], dtype=torch.int32,
                           device=out.device)
        out_p = ed._verify_gather_plain(tab, ok_a, idx, rb, sb, blocks,
                                        active)
        mism["ed25519_verify_gather"] = int((out != out_p).sum())
        checked["ed25519_verify_gather"] = out.shape[0]
    k9 = kept["aggregate_g1_masked"]
    if len(k9) > SIM_RECHECK_G9:
        k9 = [k9[i] for i in sorted(rng.choice(len(k9), SIM_RECHECK_G9,
                                               replace=False))]
    for words, mask, out in k9:
        out_p = G._masked_sum_plain(words, mask)
        mism["aggregate_g1_masked"] += int(not torch.equal(out, out_p))
        checked["aggregate_g1_masked"] += 1
    shapes = {
        "ed25519_tables": sorted({tuple(p.shape) for p, _, _ in
                                  kept["ed25519_tables"]}),
        "ed25519_verify_gather": sorted({
            (a[2].shape[0], a[5].shape[1]) for a, _ in
            kept["ed25519_verify_gather"]}),
        "aggregate_g1_masked": sorted({
            (w.shape[0], int(m.sum())) for w, m, _ in
            kept["aggregate_g1_masked"]})}
    return {"mismatches": mism, "checked": checked,
            "launches_kept": {k: len(v) for k, v in kept.items()},
            "shapes": shapes}


def _sim_expect(kind: str, v: dict, d: dict) -> list:
    """The checks ``bench.py --mode scenarios`` and ``--mode statesync``
    hold (``bench.py:1377-1460``, ``:1840-1863``), on one verdict."""
    bad = []
    if kind == "scenario":
        if not v["fork_free"]:
            bad.append("fork")
        if not v["reached_target"]:
            bad.append(f"stuck at {v['common_height']}")
        return bad
    n = d["n_bootstrappers"]
    t = v["syncer_tallies"]
    if v["completed"] != n:
        bad.append(f"only {v['completed']} of {n} completed")
    if t.get("restore_resets", 0):
        bad.append("a corrupt chunk caused a restore reset")
    if t.get("chunk_hash_mismatches", 0) < 1:
        bad.append("no corrupt chunk caught")
    if len(v["byzantine_banned_by"]) < n:
        bad.append(f"byzantine seed banned by "
                   f"{len(v['byzantine_banned_by'])} of {n}")
    if not v["restored_state_matches_chain"]:
        bad.append("a restored app's state is not the chain's")
    return bad


def _json_diff(want, got, path="") -> str | None:
    """The first field where two JSON values differ, or None."""
    if isinstance(want, dict) and isinstance(got, dict):
        for k in sorted(set(want) | set(got), key=str):
            d = _json_diff(want.get(k), got.get(k), f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(want, list) and isinstance(got, list) and \
            len(want) == len(got):
        for i, (a, b) in enumerate(zip(want, got)):
            d = _json_diff(a, b, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if want == got else f"{path}: want {want!r}, got {got!r}"


def phase_sim(pool, keys, dev):
    """Phase 19: the scenario lab (``cometbft_tpu_torch/sim``) on the
    card, in a process of its own (:func:`phase_fresh`, ``--child sim``:
    the fault plane, the clock seam and the flight recorder are
    process-wide).  Every program of ``SIM_REFERENCE`` in ``SIM_NAMES``
    (all ten unless cut: the eight curated scenarios of 12 to 100 nodes
    and both statesync programs, fleet-bootstrap-50's 10 validators, 4
    seeds and 40 bootstrappers among them) runs from its dict through
    the port's ``run_scenario``/``chaos_signature_of`` and
    ``run_statesync_scenario`` on ``dev``, then the first again.

    Checks: each verdict equal to the file's (the JAX package's, field
    by field) and each scenario's fault signature too; the first
    program's second run gives the same verdict JSON and signature;
    ``bench.py``'s checks of a verdict (:func:`_sim_expect`).  K5a, K5b
    and K9 must launch and no plain version run; the oracle's calls
    must be 0; every launch of K5a and of K5b, and a seeded sample of
    K9's, is recomputed by the plain versions on the card with 0
    mismatches (:func:`_sim_recheck`).  Readings: the wall of each
    program, virtual seconds per real second, one-lane checks
    (``crypto/batch.py:device_call``) and their mean ms, launches by
    kernel, and the device's busy share: each launch's device time
    between two CUDA events recorded around it (:func:`launch_events`;
    the profiler's trace of the whole phase took a minute to read),
    summed, over the programs' wall."""
    import torch

    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sim import scenario as S
    from cometbft_tpu_torch.sim import statesync_lab as L

    t_ph = time.perf_counter()
    out: dict = {"setup_s": t_ph - _T_LOADED}
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, SIM_REFERENCE)) as f:
        ref = json.load(f)
    progs = [("scenario", e) for e in ref["scenarios"]] + \
        [("statesync", e) for e in ref["statesync"]]
    if SIM_NAMES is not None:
        progs = [p for p in progs if p[1]["dict"]["name"] in SIM_NAMES]
    required = [k for k in SIM_KERNELS if k != "aggregate_g1_masked" or
                any("bls12_381" in p[1]["dict"].get("key_types", ())
                    for p in progs)]
    calls, restore_oracle = _oracle_counter()
    kept, restore_capture = _sim_capture()
    dcall = {"n": 0, "s": 0.0}
    inner_dc = cb.device_call

    def device_call(fn):
        t0 = time.perf_counter()
        try:
            return inner_dc(fn)
        finally:
            dcall["n"] += 1
            dcall["s"] += time.perf_counter() - t0

    cb.device_call = device_call
    runs: list = []

    def run_one(kind, e):
        n0, s0 = dcall["n"], dcall["s"]
        l0 = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        if kind == "scenario":
            v, sig = S.chaos_signature_of(S.Scenario.from_dict(e["dict"]),
                                          device=dev)
            sig = [list(x) for x in sig]
        else:
            v = L.run_statesync_scenario(
                L.StatesyncScenario.from_dict(e["dict"]), device=dev)
            sig = None
        wall = time.perf_counter() - t0
        n = dcall["n"] - n0
        runs.append({
            "name": e["dict"]["name"], "kind": kind, "wall_s": wall,
            "virtual_s": v["virtual_duration_s"],
            "virtual_per_real": v["virtual_duration_s"] / wall,
            "checks": n, "check_ms": (dcall["s"] - s0) * 1e3 / max(n, 1),
            "check_share": (dcall["s"] - s0) / wall,
            "launches": {k: _build.LAUNCHES.get(k, 0) - l0.get(k, 0)
                         for k in _build.KERNELS
                         if _build.LAUNCHES.get(k, 0) - l0.get(k, 0)}})
        return v, sig

    def main_path():
        box = {"verdicts": []}
        t0 = time.perf_counter()
        for kind, e in progs:
            box["verdicts"].append(run_one(kind, e))
        kind, e = progs[0]
        box["replay"] = run_one(kind, e)
        box["wall_s"] = time.perf_counter() - t0
        return box

    events: dict = {}
    try:
        with launch_events(events):
            launches, box = _path_launches(main_path, required)
    finally:
        cb.device_call = inner_dc
        restore_capture()
        restore_oracle()
    out["main_path_s"] = time.perf_counter() - t_ph
    out["runs"] = runs
    device = {k: sum(a.elapsed_time(b) for a, b in v)
              for k, v in events.items()}
    out["device"] = {"wall_s": box["wall_s"], "kernels_ms": device,
                     "busy_share": sum(device.values()) / 1e3
                     / box["wall_s"]}
    out["oracle_calls"] = calls[0]
    out["programs"] = [e["dict"]["name"] for _, e in progs]
    bad = []
    if calls[0]:
        bad.append(f"the host oracle was called {calls[0]} times")
    diffs = {}
    for (kind, e), (v, sig) in zip(progs, box["verdicts"]):
        name = e["dict"]["name"]
        d = _json_diff(e["verdict"], v)
        if d:
            diffs[name] = d
        if sig is not None and sig != e["signature"]:
            diffs[name + " signature"] = \
                f"{len(sig)} entries, want {len(e['signature'])}"
        for b in _sim_expect(kind, v, e["dict"]):
            bad.append(f"{name}: {b}")
    v1, sig1 = box["verdicts"][0]
    v2, sig2 = box["replay"]
    out["replay_identical"] = (json.dumps(v1, sort_keys=True) ==
                               json.dumps(v2, sort_keys=True)
                               and sig1 == sig2)
    if not out["replay_identical"]:
        bad.append(f"{progs[0][1]['dict']['name']}: replay diverged "
                   f"({_json_diff(v1, v2)})")
    out["verdict_diffs"] = diffs
    if diffs:
        bad.append(f"verdicts differ from {SIM_REFERENCE}: {diffs}")
    t0 = time.perf_counter()
    out["checks"] = _sim_recheck(kept)
    out["checks"]["check_s"] = time.perf_counter() - t0
    m = {k: x for k, x in out["checks"]["mismatches"].items() if x}
    if m:
        bad.append(f"kernels against their plain versions on the path's "
                   f"inputs: {m}")
    del kept
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("phase 19: " + "; ".join(bad))
    out["checks_s"] = time.perf_counter() - t_ph - out["main_path_s"]
    return launches, out


def report_sim(sm, launches, card) -> None:
    """Phase 19's lines."""
    print(f"sim (phase 19): {sm['phase_s']:.1f} s in its process (set-up "
          f"{sm['setup_s']:.1f} s, main path {sm['main_path_s']:.1f} s, "
          f"checks {sm['checks_s']:.1f} s, exit {sm['exit_s']:.1f} s); "
          f"programs {sm['programs']}; launches {launches}; oracle calls "
          f"{sm['oracle_calls']}; every verdict the reference's, replay "
          f"identical {sm['replay_identical']}")
    for r in sm["runs"]:
        print(f"sim {r['name']}: wall {r['wall_s']:.2f} s for "
              f"{r['virtual_s']} virtual s ({r['virtual_per_real']:.3f} "
              f"virtual s/s); one-lane checks {r['checks']}, "
              f"{r['check_ms']:.3f} ms each, {100 * r['check_share']:.1f}% "
              f"of the wall; launches {r['launches']}  [{card}]")
    ck = sm["checks"]
    print(f"sim kernels against their plain versions on the path's inputs: "
          f"keys, lanes and folds re-checked {ck['checked']} over "
          f"launches {ck['launches_kept']}, mismatches "
          f"{ck['mismatches']} in {ck['check_s']:.1f} s; shapes "
          f"{ck['shapes']}  [{card}]")
    dv = sm["device"]
    virt = sum(r["virtual_s"] for r in sm["runs"])
    print(f"sim device: the programs' wall {dv['wall_s']:.1f} s, kernel "
          f"device ms (CUDA events around each launch) {dv['kernels_ms']},"
          f" busy {dv['busy_share']:.5f}; {virt:.2f} virtual s "
          f"({virt / dv['wall_s']:.3f} virtual s/s)  [{card}]")


# ------------------------------- phase 20: multi-host and warm boot

MH_WORLDS = (2, 4)               # (a): ranks, each a process on cuda:0
MH_BAD_LANE = 5_000              # (a): rank 1's first lane at 2 and 4 ranks
MH_PAIRS = 5_000                 # (a): merkle_level's pairs
MH_SAMPLE = 64                   # (a): a rank's lanes held against plain
MH_TIMEOUT_S = 300               # (a): a group's wait for its ranks
MH_KERNELS = ("ed25519_tables", "ed25519_verify_gather",
              "ed25519_rlc_sums", "ed25519_rlc_combine", "merkle_level")
WB_VALS = BIG_VALS               # (b): the warm-boot processes' set
WB_CALLS = 5                     # (b): VerifyCommit calls after the boot
WARM_CHILDREN = ("warm_on", "warm_off")   # reach the card after the go


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mh_args(T, tab, ok, kind: str, bad: bool):
    """The arguments of ``sharded_kernel(kind)`` over phase 20 (a)'s
    tensors ``T`` (the bad lane's S flipped when ``bad``)."""
    import torch

    n = T["rb"].shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=T["rb"].device)
    lanes = (T["rb"], T["sb_bad"] if bad else T["sb"], T["blocks"],
             T["active"])
    return {"verify": (T["pub"], *lanes),
            "gather": (tab, ok, idx, *lanes),
            "rlc": (T["pub"], *lanes, T["z"]),
            "rlc_gather": (tab, ok, idx, *lanes, T["z"]),
            "merkle_level": (T["left"], T["right"])}[kind]


def _mh_cases(kind: str):
    return ("valid",) if kind == "merkle_level" else ("valid", "bad")


def multihost_rank(port: int, rank: int, world: int, src: str, dst: str,
                   dev) -> None:
    """A rank of phase 20 (a) (``--multihost-rank``): the kernels loaded,
    ``init_multihost`` over gloo on ``dev``, the set's table built, then
    with the launch counters at 0 every kind of ``sharded_kernel`` over
    the whole batch ``REPS`` times (valid, and with the bad lane), each
    call's wall and its collectives' seconds; then, not counted, this
    rank's kernels against their plain versions on the card: K5b and K5a
    at ``MH_SAMPLE`` of its lanes (the bad one among them where it holds
    it), K7's sums on those lanes, K7's combine on the gathered stack,
    ``merkle_level`` on ``MH_SAMPLE`` of its pairs.  Writes its results
    and record to ``dst``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cometbft_tpu_torch.crypto import aotbundle
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc
    from cometbft_tpu_torch.ops import sha256 as sha
    from cometbft_tpu_torch.parallel import init_multihost
    from cometbft_tpu_torch.parallel import mesh as M

    rec = {"rank": rank, "world": world,
           "import_s": time.perf_counter() - _T_LOADED}
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    rec["context_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in _build.KERNELS:
        _build.load(k)
    rec["load_s"], rec["bundle"] = (time.perf_counter() - t0,
                                    aotbundle.info()["status"])
    t0 = time.perf_counter()
    mesh = init_multihost(f"127.0.0.1:{port}", world, rank, device=dev,
                          timeout_s=MH_TIMEOUT_S)
    rec["rendezvous_s"] = time.perf_counter() - t0
    data = np.load(src)
    T = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
    tab, ok = ed.prepare_pubkey_tables(T["pub"])
    fns = {k: M.sharded_kernel(k, mesh=mesh) for k in M.KINDS}
    torch.cuda.synchronize()
    dist.barrier(group=mesh.group)
    _build.reset_launches()
    out, ms, gather_ms = {}, {}, {}
    for kind in M.KINDS:
        for case in _mh_cases(kind):
            args = _mh_args(T, tab, ok, kind, case == "bad")
            walls, gathers = [], []
            for _ in range(REPS):
                g0, t0 = M.GATHER_STATS["seconds"], time.perf_counter()
                r = fns[kind](*args)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
                gathers.append(1e3 * (M.GATHER_STATS["seconds"] - g0))
            out[f"{kind}/{case}"] = r.cpu().numpy()
            ms[f"{kind}/{case}"], gather_ms[f"{kind}/{case}"] = walls, gathers
    rec["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    rec["plain"] = {k: v for k, v in _build.PLAIN_CALLS.items() if v}
    rec["ms"], rec["gather_ms"] = ms, gather_ms
    rec["gather_bytes"] = M.GATHER_STATS["bytes"]

    # not counted: this rank's launches against the plain versions
    n = T["rb"].shape[0]
    lo, hi = M.shard_bounds(n, world)[rank]
    rng = np.random.default_rng(20 + rank)
    pick = set(rng.choice(np.arange(lo, hi), MH_SAMPLE - 1, replace=False)
               .tolist()) if hi > lo else set()
    if lo <= MH_BAD_LANE < hi:
        pick.add(MH_BAD_LANE)
    s = torch.tensor(sorted(pick), dtype=torch.long, device=dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    lane = [t[s] for t in (idx, T["rb"], T["sb_bad"], T["blocks"],
                           T["active"])]
    mism = {}
    pv = ed._verify_gather_plain(tab, ok, *lane).cpu().numpy()
    mism["ed25519_verify_gather"] = int(
        (pv != out["gather/bad"][s.cpu().numpy()]).sum())
    kt, kok = ed.prepare_pubkey_tables(T["pub"][s])
    pt, pok = ed._prepare_plain(T["pub"][s])
    mism["ed25519_tables"] = int(
        ((ed.tables_canonical(kt) != ed.tables_canonical(pt)).flatten(1)
         .any(1) | (kok != pok)).sum())
    sums_args = (tab, ok, idx[s], T["rb"][s], T["sb"][s], T["blocks"][s],
                 T["active"][s], T["z"][s])
    ks = rlc.rlc_sums_gather(*sums_args)
    ps = rlc._store_sums_plain(*sums_args, rlc.rlc_sums_buffers(1, dev), 0)
    mism["ed25519_rlc_sums"] = (
        sum(a != b for a, b in zip(_window_points(ks.sums[0]),
                                   _window_points(ps.sums[0])))
        + int((ks.zs != ps.zs).sum()) + int((ks.ok != ps.ok).sum()))
    stack = rlc.rlc_sums_buffers(world, dev)
    rlc._rlc_sums_card(tab, ok, idx[lo:hi], T["rb"][lo:hi],
                       T["sb"][lo:hi], T["blocks"][lo:hi],
                       T["active"][lo:hi], T["z"][lo:hi], [0, hi - lo],
                       [rank], stack)
    mesh.gather_slots(*stack)
    kv = bool(rlc.rlc_combine(*stack))
    mism["ed25519_rlc_combine"] = int(
        kv != bool(rlc._rlc_combine_plain(*stack))) + int(
        kv != bool(out["rlc_gather/valid"]))
    plo, phi = M.shard_bounds(MH_PAIRS, world)[rank]
    sp = torch.arange(plo, min(phi, plo + MH_SAMPLE), device=dev)
    kp = sha.merkle_inner_level(T["left"][sp], T["right"][sp])
    pp = sha._merkle_level_plain(torch.stack(
        [T["left"][sp], T["right"][sp]], 1).reshape(-1, 8))
    mism["merkle_level"] = int((kp != pp).any(1).sum())
    rec["mismatches"] = mism
    dist.barrier(group=mesh.group)
    np.savez(dst, record=np.array(json.dumps(rec)), **out)


def phase_multihost(pool, keys, dev):
    """Phase 20 (a): phase 3's 1,000 signed lanes tiled to ``LANES``
    against a ``LANES``-row table (and with lane ``MH_BAD_LANE``'s S
    flipped), ``MH_PAIRS`` seeded merkle pairs; the single-process route
    of each kind on the card, then ``MH_WORLDS`` ranks as processes of
    one gloo group on ``dev`` (``multihost_rank``).  Every rank's results
    equal, and equal to the single-process route, to the sharded route
    of one process over as many shards, and (RLC) to K6a's one verdict;
    the RLC verdict false with the bad lane, the per-lane kinds false at
    it alone; ``merkle_level`` equal to hashlib.  Returns the ranks'
    launches (summed over ranks and groups) and the readings."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc
    from cometbft_tpu_torch.ops import sha256 as sha
    from cometbft_tpu_torch.parallel import mesh as M

    t_ph = time.perf_counter()
    fx = Fixtures(max(SIZES))
    vals, commit = fx.commit(max(SIZES))
    pubs, sigs, msgs, lens = lane_arrays(vals, commit)
    lane = np.arange(LANES) % pubs.shape[0]
    rb, sb, blocks, active = batch._padded_lane_args(
        pubs[lane], sigs[lane, :32], sigs[lane, 32:], msgs[lane], lens[lane],
        "cpu")
    sb_bad = sb.clone()
    sb_bad[MH_BAD_LANE, 0] ^= 1
    rng = np.random.default_rng(2020)
    arrays = {"pub": pubs[lane], "rb": rb.numpy(), "sb": sb.numpy(),
              "sb_bad": sb_bad.numpy(), "blocks": blocks.numpy(),
              "active": active.numpy(),
              "z": rlc.host_rlc_coeffs(LANES, rng_bytes=rng.bytes(16 * LANES)),
              "left": rng.integers(-2**31, 2**31, (MH_PAIRS, 8), np.int32),
              "right": rng.integers(-2**31, 2**31, (MH_PAIRS, 8), np.int32)}
    src = _build_file("chip_smoke_multihost_in.npz")
    np.savez(src, **arrays)
    hashed = np.stack([sha.bytes_to_words(np.frombuffer(hashlib.sha256(
        b"\x01" + l.tobytes() + r.tobytes()).digest(), np.uint8))
        for l, r in zip(sha.words_to_bytes(arrays["left"].view(np.uint32)),
                        sha.words_to_bytes(arrays["right"].view(np.uint32)))
    ]).view(np.int32)
    T = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    tab, ok = ed.prepare_pubkey_tables(T["pub"])
    idx = torch.arange(LANES, dtype=torch.int32, device=dev)

    def route(mesh):
        return {f"{k}/{c}": M.sharded_kernel(k, mesh=mesh)(
            *_mh_args(T, tab, ok, k, c == "bad")).cpu().numpy()
            for k in M.KINDS for c in _mh_cases(k)}

    single = route(M.batch_mesh([dev]))
    k6a = {c: bool(rlc.verify_batch_rlc_gather(
        tab, ok, idx, T["rb"], T["sb_bad"] if c == "bad" else T["sb"],
        T["blocks"], T["active"], T["z"])) for c in ("valid", "bad")}
    want_lanes = np.ones(LANES, bool)
    want_lanes[MH_BAD_LANE] = False
    bad = []
    for c in ("valid", "bad"):
        for k in ("rlc", "rlc_gather"):
            if bool(single[f"{k}/{c}"]) != (c == "valid") or \
                    k6a[c] != (c == "valid"):
                bad.append(f"single {k}/{c}")
        for k in ("verify", "gather"):
            want = want_lanes if c == "bad" else np.ones(LANES, bool)
            if not np.array_equal(single[f"{k}/{c}"], want):
                bad.append(f"single {k}/{c}")
    if not np.array_equal(single["merkle_level/valid"], hashed):
        bad.append("single merkle_level against hashlib")
    if bad:
        raise AssertionError(f"phase 20 (a): the single-process route: {bad}")
    setup_s = time.perf_counter() - t_ph

    launches, groups = {}, {}
    for world in MH_WORLDS:
        in_proc = route(M.batch_mesh([dev] * world))
        port, t0 = _free_port(), time.perf_counter()
        dsts = [_build_file(f"chip_smoke_multihost_{world}_{r}.npz")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-rank",
             str(port), str(r), str(world), src, d],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r, d in enumerate(dsts)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MH_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError(f"phase 20 (a): a rank of {world} failed: "
                                 f"{[l[-3000:] for l in logs]}")
        ranks = [np.load(d) for d in dsts]
        recs = [json.loads(str(r["record"])) for r in ranks]
        diff = [f"rank {i} {key}" for i, r in enumerate(ranks)
                for key in single
                if not np.array_equal(r[key], single[key])
                or not np.array_equal(r[key], in_proc[key])]
        mism = {k: sum(r["mismatches"][k] for r in recs) for k in MH_KERNELS}
        plain = [r["plain"] for r in recs if r["plain"]]
        unlaunched = [k for k in MH_KERNELS
                      if not sum(r["launches"].get(k, 0) for r in recs)]
        if diff or any(mism.values()) or plain or unlaunched or any(
                r["bundle"] != "loaded" for r in recs):
            raise AssertionError(
                f"phase 20 (a) over {world} ranks: results unlike one "
                f"process's {diff}, against the plain versions {mism}, "
                f"plain versions run {plain}, kernels not launched "
                f"{unlaunched}, bundles {[r['bundle'] for r in recs]}")
        for r in recs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        r0 = recs[0]
        groups[world] = {
            "wall_s": time.perf_counter() - t0,
            "p50_ms": {k: statistics.median(v) for k, v in r0["ms"].items()},
            "gather_p50_ms": {k: statistics.median(v)
                              for k, v in r0["gather_ms"].items()},
            "rendezvous_s": [r["rendezvous_s"] for r in recs],
            "import_s": [r["import_s"] for r in recs],
            "context_s": [r["context_s"] for r in recs],
            "load_s": [r["load_s"] for r in recs],
            "launches_by_rank": [r["launches"] for r in recs],
            "gather_bytes": r0["gather_bytes"], "mismatches": mism}
    return launches, {"setup_s": setup_s, "groups": groups, "k6a": k6a,
                      "main_path_s": time.perf_counter() - t_ph}


def phase_warmboot(dev, warm: bool):
    """Phase 20 (b), in a fresh process that has not touched the card: a
    ``WB_VALS``-validator set and its commit made, the card reached, then
    with ``warm`` the node's warm boot (``node/node.py:warm_boot``: the
    bundle loaded, the warmup), without it the bundle's load alone; then
    ``WB_CALLS`` ``VerifyCommit`` calls, each's wall.  Not counted: the
    warmup's shapes (1 and ``RLC_MIN_LANES`` lanes of its invalid lanes)
    against the plain versions.  First, the seconds of
    ``ops/_build.py:generated_headers``, which a process's first launch
    paid before the bundle."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.config import BaseConfig
    from cometbft_tpu_torch.crypto import aotbundle
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.node.node import warm_boot
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import rlc
    from cometbft_tpu_torch.types import validation as V

    rec = {"warm": warm}
    # what a process's first launch spent before the bundle, generating
    # the constants headers to find its build directory (host work; the
    # kernels' path reads none of the caches it fills)
    t0 = time.perf_counter()
    _build.generated_headers()
    rec["headers_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fx = Fixtures(WB_VALS)
    vals, commit = fx.commit(WB_VALS)
    rec["fixture_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    rec["context_s"] = time.perf_counter() - t0
    _build.reset_launches()
    t0 = time.perf_counter()
    if warm:
        info = warm_boot(BaseConfig(), dev, len(vals.validators))
    else:
        info = aotbundle.load(device=dev)
    rec["boot_s"] = time.perf_counter() - t0
    rec.update({k: info.get(k) for k in ("status", "load_s", "warm_s",
                                         "warm_shapes", "kernels")})
    walls = []
    for _ in range(WB_CALLS):
        t0 = time.perf_counter()
        V.VerifyCommit(CHAIN_ID, vals, commit.block_id, commit.height,
                       commit, device=dev)
        walls.append(time.perf_counter() - t0)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    rec["launches"] = launches
    rec["walls_s"], rec["first_s"], rec["fifth_s"] = walls, walls[0], walls[-1]
    need = ("ed25519_tables", "ed25519_rlc_gather") + (
        ("ed25519_verify_gather",) if warm else ())
    plain = {k: v for k, v in _build.PLAIN_CALLS.items() if v}
    if info["status"] != "loaded" or plain or not all(
            launches.get(k) for k in need):
        raise AssertionError(f"phase 20 (b): bundle {info}, launches "
                             f"{launches} (need {need}), plain {plain}")
    mism = {}
    for n in (1, batch.RLC_MIN_LANES):
        pub = torch.zeros((n, 32), dtype=torch.uint8, device=dev)
        tab, ok = ed.prepare_pubkey_tables(pub)
        tab_p, ok_p = ed._prepare_plain(pub)
        zeros = np.zeros((n, 32), np.uint8)
        ones = zeros.copy()
        ones[:, 0] = 1
        msg_len = 2 * 128 - 64 - 17
        lanes = batch._padded_lane_args(zeros, zeros, ones,
                                        np.zeros((n, msg_len), np.uint8),
                                        np.full((n,), msg_len), dev)
        idx = torch.zeros((n,), dtype=torch.int32, device=dev)
        kv = ed.verify_padded_gather(tab, ok, idx, *lanes)
        pv = ed._verify_gather_plain(tab, ok, idx, *lanes)
        mism[n] = (int((ed.tables_canonical(tab) != ed.tables_canonical(
            tab_p)).flatten(1).any(1).sum()) + int((kv != pv).sum())
            + int(bool(kv.any())))
        if n >= batch.RLC_MIN_LANES:
            z = torch.from_numpy(rlc.host_rlc_coeffs(n)).to(dev)
            mism[n] += int(bool(rlc.verify_batch_rlc_gather(
                tab, ok, idx, *lanes, z)) != bool(rlc._rlc_plain(
                    tab, ok, idx, *lanes, z)))
    rec["mismatches"] = mism
    if any(mism.values()):
        raise AssertionError(f"phase 20 (b): warm shapes against their "
                             f"plain versions: {mism}")
    return launches, rec


def phase_warm_on(pool, keys, dev):
    return phase_warmboot(dev, True)


def phase_warm_off(pool, keys, dev):
    return phase_warmboot(dev, False)


def report_multihost(mh, launches, warm, card) -> None:
    """Phase 20's lines."""
    print(f"multihost (phase 20 a): {mh['phase_s']:.1f} s in its process "
          f"(set-up {mh['setup_s']:.1f} s); launches {launches}; K6a "
          f"verdicts {mh['k6a']}; every rank's results one process's, the "
          f"bad lane {MH_BAD_LANE} pinned, merkle_level hashlib's")
    for world, g in mh["groups"].items():
        print(f"multihost {world} ranks on one card (gloo): group wall "
              f"{g['wall_s']:.1f} s; verdict p50 ms {g['p50_ms']}; gather "
              f"p50 ms {g['gather_p50_ms']} ({g['gather_bytes']} bytes a "
              f"rank); rendezvous s {g['rendezvous_s']}; import s "
              f"{g['import_s']}; context s {g['context_s']}; bundle loaded in s "
              f"{g['load_s']}; "
              f"mismatches against plain {g['mismatches']}  [{card}]")
    print(f"multihost against one process: K6a 1.143 ms (PR 16), the "
          f"sharded verdict in one process 2.079 ms (PR 6)")
    for w in warm:
        print(f"warm boot (phase 20 b) device_warmup={w['warm']}: bundle "
              f"{w['status']} in {w['load_s']} s ({w['kernels']} kernels), "
              f"boot {w['boot_s']:.3f} s (warmup {w['warm_s']} s, "
              f"{w['warm_shapes']} shapes), context {w['context_s']:.2f} s, "
              f"the headers the load no longer generates "
              f"{w['headers_s']:.2f} s; "
              f"VerifyCommit@{WB_VALS} first "
              f"{1e3 * w['first_s']:.2f} ms, fifth {1e3 * w['fifth_s']:.2f} "
              f"ms, all {[round(1e3 * x, 2) for x in w['walls_s']]} ms; "
              f"launches {w['launches']}; warm shapes against plain "
              f"{w['mismatches']}  [{card}]")


# ---------------- phase 21: the gRPC transports and the SQL event sink

GR_POWERS = (10, 10, 10, 10)     # ci.toml's 4 validators
GR_TOP = 6                       # heights every node reaches
GR_TXS = 8                       # txs injected on validator01
GR_RETAIN = 2                    # the pruning service's retain height
GR_REPS = 5                      # timed calls of version and get-retain
GR_TIMEOUT_S = 240               # the phase's wait for its heights
GR_APP_WAIT_S = 120              # the app process's wait to answer


def grpc_app_cmd(port: int) -> list:
    """validator04's app: the kvstore served over gRPC on the card by
    the port's command line."""
    return [sys.executable, "-m", "cometbft_tpu_torch", "abci", "kvstore",
            "--grpc", "--port", str(port)]


def _p50_max(ms: list) -> dict:
    return {"n": len(ms), "p50": statistics.median(ms) if ms else None,
            "max": max(ms) if ms else None}


def phase_grpc(pool, keys, dev):
    """Phase 21: the gRPC transports (the port's own HTTP/2,
    ``libs/_h2.py``, and gRPC, ``libs/_grpc.py``) and the SQL event sink
    on the card: ``GR_POWERS`` validators as port ``Node``s in one
    process over loopback TCP, the JAX package's test timeouts, to
    height ``GR_TOP`` (``GR_TXS`` txs injected on validator01).
    validator04's app is a process of its own, ``python -m
    cometbft_tpu_torch abci kvstore --grpc`` on the card
    (``grpc_app_cmd``), reached over gRPC (``base.abci = "grpc"``);
    validator01 serves JSON-RPC and the gRPC services
    (``rpc.grpc_laddr``), and a ``PsqlEventSink`` over ``sqlite3``
    follows its event bus through the node's ``IndexerService``.

    Checked: the heights agree; ``GRPCServicesClient``'s block and block
    results at every height equal JSON-RPC's ``/block`` and
    ``/block_results``; the retain height ``GR_RETAIN`` set and read
    back; the latest-height stream, opened before consensus starts,
    yields each committed height once, in order, and its event-bus
    subscription goes once the client leaves the stream; the sink holds
    one ``blocks`` row a height validator01 committed and one
    ``tx_results`` row a committed tx, every injected tx among them.
    Readings: validator04's app calls (p50, max; phase 17 reads the
    socket app's), each service method's p50, the stream's lag behind
    validator01's NewBlock event, the wall and rounds of each height.
    The launch counters are zeroed just before and read just after the
    network's run: K5a and K5b must have launched (validator04's votes
    are checked on the card like every other node's); the host oracle
    must not be called."""
    import asyncio
    import signal
    import sqlite3
    from types import SimpleNamespace

    from cometbft_tpu_torch.abci.grpc import GRPCClient
    from cometbft_tpu_torch.crypto import scheduler as vsched
    from cometbft_tpu_torch.indexer import IndexerService
    from cometbft_tpu_torch.indexer.psql import PsqlEventSink
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.rpc.grpc import GRPCServicesClient

    loop = asyncio.new_event_loop()
    run = loop.run_until_complete
    out: dict = {}
    app_ms: list = []
    grpc_call = GRPCClient.call

    async def timed_call(self, method, **params):
        t0 = time.perf_counter()
        try:
            return await grpc_call(self, method, **params)
        finally:
            app_ms.append((time.perf_counter() - t0) * 1e3)

    port = _free_port()
    log_path = _build_file("chip_smoke_grpc_app.log")
    t_spawn = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            grpc_app_cmd(port), stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    async def app_up():
        client = await GRPCClient.connect(port=port)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(
                        f"phase 21: the app process exited with "
                        f"{proc.returncode} (log: {log_path})")
                try:
                    return await client.echo("up")
                except Exception:        # not listening yet
                    await asyncio.sleep(0.1)
        finally:
            await client.close()

    doc, pvs = _nd_genesis(GR_POWERS, b"gr")
    names = [f"validator0{i + 1}" for i in range(len(pvs))]
    sink = PsqlEventSink(conn=sqlite3.connect(":memory:"),
                         chain_id=CHAIN_ID)
    nodes: list = []
    keep: dict = {}

    def subs(node) -> list:
        return [k for k in node.event_bus._subs
                if k.startswith("grpc-latest-height")]

    async def wait_for(cond, timeout):
        async def poll():
            while not cond():
                await asyncio.sleep(0.005)
        await asyncio.wait_for(poll(), timeout)

    def network():
        for i, pv in enumerate(pvs[:-1]):
            nodes.append(run(_nd_node(
                doc, pv, names[i], dev,
                rpc_laddr="tcp://127.0.0.1:0" if i == 0 else "",
                grpc_laddr="tcp://127.0.0.1:0" if i == 0 else "")))
        run(asyncio.wait_for(app_up(), GR_APP_WAIT_S))
        out["app_up_s"] = time.perf_counter() - t_spawn
        nodes.append(run(_nd_node(doc, pvs[-1], names[-1], dev,
                                  grpc_app=f"127.0.0.1:{port}")))
        v01 = nodes[0]
        svc = IndexerService(v01.event_bus, sink, sink.block_indexer(),
                             name="grpc.idx")
        keep["svc"] = svc
        run(svc.start())
        committed_at: dict = {}
        publish = v01.event_bus.publish

        def stamped(event_type, data, attrs=None):
            if event_type == "NewBlock":
                committed_at[data["block"].header.height] = \
                    time.perf_counter()
            return publish(event_type, data, attrs)

        v01.event_bus.publish = stamped
        walls, seen = [], {}
        t0 = time.perf_counter()
        for n in nodes:
            run(n.start(consensus=False))
        mesh_s = run(_nd_mesh(nodes, walls))
        client = run(GRPCServicesClient.connect("127.0.0.1",
                                                v01.grpc_server.port))
        keep["client"] = client
        stream = client.latest_height_stream()
        first = run(stream.__anext__())["height"]
        streamed: list = []

        async def follow():
            async for item in stream:
                streamed.append((item["height"], time.perf_counter()))

        follower = loop.create_task(follow())
        for n in nodes:
            run(n.start_consensus())
        for i in range(GR_TXS):
            run(v01.mempool.check_tx(b"gr%d=tx%d" % (i, i)))
        run(asyncio.wait_for(_watch_heights(SimpleNamespace(nodes=nodes),
                                            GR_TOP, t0, seen),
                             GR_TIMEOUT_S))
        run(wait_for(lambda: streamed and streamed[-1][0] >= GR_TOP, 60))
        wall = time.perf_counter() - t0
        summary = _nd_summary(nodes, GR_TOP, walls, mesh_s, seen, wall,
                              vsched.get_scheduler().stats())
        # before the retain height below lets validator01 prune
        _nd_agree(nodes, GR_TOP, "phase 21")
        # leaving the stream: RST_STREAM(CANCEL), the server's generator
        # closed, its subscription gone
        t_leave = time.perf_counter()
        follower.cancel()
        run(asyncio.wait([follower]))
        run(wait_for(lambda: not subs(v01), 10))
        out["subscription_gone_s"] = time.perf_counter() - t_leave
        heights = [first] + [h for h, _ in streamed]
        if heights[1:] != list(range(first + 1, heights[-1] + 1)):
            raise AssertionError(f"phase 21: the stream yielded {heights}")
        lag = [(t - committed_at[h]) * 1e3 for h, t in streamed]
        out["stream"] = {"heights": heights, "lag_ms": _p50_max(lag)}

        # the services against JSON-RPC, at every height
        rpc = HTTPClient(*v01.rpc_addr)
        ms: dict = {"GetByHeight": [], "GetBlockResults": [],
                    "GetVersion": [], "SetBlockRetainHeight": [],
                    "GetBlockRetainHeight": []}

        async def timed(name, call):
            t = time.perf_counter()
            res = await call
            ms[name].append((time.perf_counter() - t) * 1e3)
            return res

        async def services():
            for h in range(1, GR_TOP + 1):
                got = await timed("GetByHeight",
                                  client.get_block_by_height(h))
                if got != await rpc.call("block", height=h):
                    raise AssertionError(f"phase 21: GetByHeight({h}) "
                                         "differs from /block")
                got = await timed("GetBlockResults",
                                  client.get_block_results(h))
                if got != await rpc.call("block_results", height=h):
                    raise AssertionError(f"phase 21: GetBlockResults({h}) "
                                         "differs from /block_results")
            for _ in range(GR_REPS):
                out["version"] = await timed("GetVersion",
                                             client.get_version())
            set_ = await timed("SetBlockRetainHeight",
                               client.set_block_retain_height(GR_RETAIN))
            for _ in range(GR_REPS):
                got = await timed("GetBlockRetainHeight",
                                  client.get_block_retain_height())
            if set_["data_companion_retain_height"] != GR_RETAIN or \
                    got["pruning_service_retain_height"] != GR_RETAIN:
                raise AssertionError(f"phase 21: retain height {set_}, "
                                     f"read back {got}")
            await rpc.close()

        run(services())
        out["services_ms"] = {k: _p50_max(v) for k, v in ms.items()}
        return summary

    calls, restore = _oracle_counter()
    GRPCClient.call = timed_call
    t_ph = time.perf_counter()
    try:
        launches, summary = _path_launches(
            network, ("ed25519_tables", "ed25519_verify_gather"))
        out["main_path_s"] = time.perf_counter() - t_ph
    finally:
        GRPCClient.call = grpc_call
        restore()
        if "client" in keep:
            run(keep["client"].close())
        for n in nodes:
            run(n.stop())
        if "svc" in keep:
            # the pump's last events, then the sink's rows
            top = nodes[0].block_store.height()

            def pumped():
                cur = sink.conn.cursor()
                cur.execute("SELECT MAX(height) FROM blocks")
                return (cur.fetchone()[0] or 0) >= top

            try:
                run(wait_for(pumped, 10))
            finally:
                run(keep["svc"].stop())
        proc.send_signal(signal.SIGINT)     # the command line's clean stop
        out["app_exit"] = proc.wait(timeout=30)
    out.update(summary)
    out["oracle_calls"] = calls[0]
    if calls[0]:
        raise AssertionError(f"phase 21: the host oracle was called "
                             f"{calls[0]} times on the path")
    cur = sink.conn.cursor()
    cur.execute("SELECT height FROM blocks ORDER BY height")
    rows = [h for (h,) in cur.fetchall()]
    cur.execute("SELECT tx_result FROM tx_results")
    txs = [bytes.fromhex(json.loads(r)["tx"]) for (r,) in cur.fetchall()]
    # validator01's heights; the txs from validator02, which keeps every
    # block (validator01 prunes below the retain height)
    top = nodes[0].block_store.height()
    committed = [bytes(tx) for h in range(1, top + 1)
                 for tx in nodes[1].block_store.load_block(h).data.txs]
    want = {b"gr%d=tx%d" % (i, i) for i in range(GR_TXS)}
    if rows != list(range(1, top + 1)) or sorted(txs) != sorted(committed) \
            or not want <= set(txs):
        raise AssertionError(f"phase 21: the sink holds heights {rows} and "
                             f"{len(txs)} txs; validator01 committed "
                             f"{top} heights, {len(committed)} txs")
    out["sink"] = {"blocks": len(rows), "tx_results": len(txs),
                   "heights": top}
    out["app_ms"] = _p50_max(app_ms)
    sink.close()
    loop.close()
    return launches, out


def report_grpc(gr, launches, card, cx=None) -> None:
    """Phase 21's lines (with phase 17's socket app beside, where it
    ran)."""
    print(f"grpc (phase 21): main path {gr['main_path_s']:.1f} s; launches "
          f"{launches}; the app process answered {gr['app_up_s']:.1f} s "
          f"after its spawn, exited {gr['app_exit']}; oracle calls "
          f"{gr['oracle_calls']}")
    per = gr["per_height_s"]
    print(f"grpc {len(GR_POWERS)} validators (validator04's app over gRPC) "
          f"to height {gr['heights']}: {gr['wall_s']:.2f} s, a height "
          f"{[round(x, 3) for x in per]} s (mean over heights "
          f"2-{gr['heights']}: {gr['mean_height_s'] or 0:.3f}); rounds "
          f"{gr['rounds']}  [{card}]")
    a = gr["app_ms"]
    line = (f"grpc app calls {a['n']}: p50 {a['p50']:.3f} ms, max "
            f"{a['max']:.2f} ms")
    if cx is not None:
        am = cx["app_ms"]
        line += (f"; socket app (phase 17) calls {len(am)}: p50 "
                 f"{statistics.median(am):.3f} ms, max {max(am):.2f} ms")
    print(line + f"  [{card}]")
    sv = {k: round(v["p50"], 3) for k, v in gr["services_ms"].items()}
    st = gr["stream"]
    print(f"grpc services p50 ms {sv}; equal to JSON-RPC at heights "
          f"1-{GR_TOP}; retain height {GR_RETAIN} read back; stream "
          f"{st['heights']}, lag behind NewBlock p50 "
          f"{st['lag_ms']['p50']:.3f} ms, max {st['lag_ms']['max']:.3f} "
          f"ms; subscription gone {gr['subscription_gone_s'] * 1e3:.1f} ms "
          f"after the client left; sink {gr['sink']}  [{card}]")


CHILD_PHASES = {"rpc": (phase_rpc, BIG_VALS),
                "statesync": (phase_statesync, SS_VALS),
                "chaos": (phase_chaos, 0),
                "e2e": (phase_e2e, 0),
                "sim": (phase_sim, 0),
                "multihost": (phase_multihost, 0),
                "warm_on": (phase_warm_on, 0),
                "warm_off": (phase_warm_off, 0),
                "grpc": (phase_grpc, 0)}


def main(argv=None) -> int:
    global _T_LOADED, E2E_MANIFEST, SIM_NAMES
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
    ap.add_argument("--node", action="store_true",
                    help="run only the build, the kernel sweep and phase 13")
    ap.add_argument("--stress", action="store_true",
                    help="run only the build, the kernel sweep and phase 14 "
                    "(with --node, also its part (e) in phase 13)")
    ap.add_argument("--rpc", action="store_true",
                    help="run only the build, the kernel sweep and phase 15")
    ap.add_argument("--statesync", action="store_true",
                    help="run only the build, the kernel sweep and phase 16")
    ap.add_argument("--chaos", action="store_true",
                    help="run only the build and phase 17")
    ap.add_argument("--e2e", nargs="?", const=E2E_MANIFEST, default=None,
                    metavar="MANIFEST",
                    help="run only the build and phase 18 over MANIFEST "
                    f"(default {E2E_MANIFEST})")
    ap.add_argument("--sim", action="store_true",
                    help="run only the build and phase 19 (every program "
                    f"of {SIM_REFERENCE})")
    ap.add_argument("--multihost", action="store_true",
                    help="run only the build and phase 20 (multi-host "
                    "verification over torch.distributed, warm boot)")
    ap.add_argument("--grpc", action="store_true",
                    help="run only the build and phase 21 (the gRPC "
                    "transports and the SQL event sink)")
    ap.add_argument("--multihost-rank", nargs=5, default=None,
                    metavar=("PORT", "RANK", "WORLD", "IN", "OUT"),
                    help="run one rank of phase 20 (a) (how phase 20 "
                    "starts its ranks)")
    ap.add_argument("--sim-programs", default=None, metavar="NAMES",
                    help="with --child sim: the comma-separated programs "
                    "phase 19 runs (how the whole run passes SIM_WHOLE)")
    ap.add_argument("--serve-remote", nargs=2, metavar=("LISTENER", "DIR"),
                    default=None,
                    help="serve phase 17's remote app and signer (how "
                    "phase 17 starts that process)")
    ap.add_argument("--after", default=None, metavar="GO",
                    help="with --child: reach the card and load the "
                    "kernels, then wait for the file GO before the phase "
                    "(how the whole run starts its children ahead)")
    ap.add_argument("--child", nargs=2, metavar=("NAME", "PATH"),
                    default=None,
                    help="run only phase NAME (rpc: 15, statesync: 16, "
                    "chaos: 17, e2e: 18, sim: 19, multihost: 20 (a), "
                    "warm_on and warm_off: 20 (b), grpc: 21), "
                    "over the kernels built, and write its launches and "
                    "record as JSON to PATH (how the other runs start "
                    "those phases, each in a fresh process)")
    args = ap.parse_args(argv)
    if args.e2e:
        E2E_MANIFEST = args.e2e
    if args.sim_programs:
        SIM_NAMES = tuple(args.sim_programs.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cometbft_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    if args.serve_remote:
        serve_remote(*args.serve_remote)
        return 0
    if args.multihost_rank:
        port, rank, world, src, dst = args.multihost_rank
        multihost_rank(int(port), int(rank), int(world), src, dst, dev)
        return 0
    if args.child:
        if args.after:
            if args.child[0] not in WARM_CHILDREN:
                torch.zeros(1, device=dev)
                for k in _build.KERNELS:
                    _build.load(k)
            while not os.path.exists(args.after):
                time.sleep(0.02)
            _T_LOADED = time.perf_counter()     # the phase starts here
        run_child(*args.child, dev)
        # the record is written: skip the interpreter's teardown of the
        # phase's objects (the card's context, idle worker threads)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
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

    from cometbft_tpu_torch.crypto import aotbundle

    t0 = time.perf_counter()
    for k in _build.KERNELS:
        _build.load(k)
    bundle = aotbundle.info()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_dir()}); "
          f"kernel bundle {bundle['status']}, nvcc "
          f"{bundle.get('build_s', 0.0):.1f} s, load "
          f"{bundle.get('load_s', 0.0):.3f} s, {bundle['kernels']} kernels, "
          f"capability {bundle.get('capability')}")
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
    if args.multihost:
        prespawn(("multihost",) + WARM_CHILDREN)
        mh_launches, mh = phase_fresh("multihost")
        warm = [phase_fresh(n) for n in WARM_CHILDREN]
        report_multihost(mh, mh_launches, [w for _, w in warm], card)
        if args.record:
            os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                        exist_ok=True)
            with open(args.record, "w") as f:
                json.dump({"card": card, "build": bundle, "multihost": mh,
                           "warm_boot": [w for _, w in warm]}, f, indent=1,
                          default=str)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    swept = args.blocksync or args.consensus or args.node or args.stress \
        or args.rpc or args.statesync
    prespawn([n for n, on in (("rpc", args.rpc),
                              ("statesync", args.statesync),
                              ("chaos", args.chaos),
                              ("e2e", args.e2e),
                              ("sim", args.sim),
                              ("grpc", args.grpc)) if on])
    if swept:
        fx = Fixtures(max(SIZES))
        print(f"fixtures: {len(fx.privs)} keys in {fx.key_seconds:.1f} s")
    if swept or args.chaos or args.e2e or args.sim or args.grpc:
        rec = {k: {"mismatches": 0} for k in _build.KERNELS}
        t0 = time.perf_counter()
        if swept:
            sweep = phase_sweep(fx, dev, rec)
            print(f"sweep: {len(SWEEP_LANES)} random batches of "
                  f"{SWEEP_LANES} lanes in {time.perf_counter() - t0:.1f} "
                  f"s, mismatches {sweep}")
            if any(sweep.values()):
                raise AssertionError(f"sweep mismatches: {sweep}")
        part = {}
        if args.rpc:
            rp_launches, rp = phase_fresh("rpc")
        if args.statesync:
            ss_launches, ss = phase_fresh("statesync")
        if args.chaos:
            cx_launches, cx = phase_fresh("chaos")
        if args.e2e:
            e2e_launches, e2e = phase_fresh("e2e")
        if args.sim:
            sm_launches, sm = phase_fresh("sim")
        if args.grpc:
            gr_launches, gr = phase_fresh("grpc")
        if args.blocksync or args.stress:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(os.cpu_count()) as pool:
                if args.blocksync:
                    keys = pool_keys(pool, BS_VALS)
                    bs_launches, bs = phase_blocksync(pool, keys, dev, 5)
                if args.stress:
                    t0 = time.perf_counter()
                    st_launches, st = phase_stress(pool, dev)
                    st["phase_s"] = time.perf_counter() - t0
            if args.blocksync:
                report_blocksync(bs, bs_launches, card)
                part["blocksync"] = bs
        if args.consensus:
            t0 = time.perf_counter()
            cs_launches, cs = phase_consensus(dev)
            cs["phase_s"] = time.perf_counter() - t0
            report_consensus(cs, cs_launches, card)
            part["consensus"] = cs
        if args.node:
            t0 = time.perf_counter()
            nd_launches, nd = phase_node(dev)
            nd["phase_s"] = time.perf_counter() - t0
            report_node(nd, nd_launches, card)
            part["node"] = nd
        if args.stress:
            report_stress(st, st_launches, card, part.get("node"))
            part["stress"] = st
        if args.rpc:
            report_rpc(rp, rp_launches, card)
            part["rpc"] = rp
        if args.statesync:
            report_statesync(ss, ss_launches, card)
            part["statesync"] = ss
        if args.chaos:
            report_chaos(cx, cx_launches, card)
            part["chaos"] = cx
        if args.e2e:
            report_e2e(e2e, e2e_launches, card)
            part["e2e"] = e2e
        if args.sim:
            report_sim(sm, sm_launches, card)
            part["sim"] = sm
        if args.grpc:
            report_grpc(gr, gr_launches, card, part.get("chaos"))
            part["grpc"] = gr
        if args.record:
            os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                        exist_ok=True)
            with open(args.record, "w") as f:
                json.dump({"card": card, **part}, f, indent=1, default=str)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # the fresh processes of phases 15-21 reach the card meanwhile (the
    # warm-boot processes only after their go)
    prespawn(("rpc", "statesync", "chaos", "e2e", "sim", "multihost",
              "grpc") + WARM_CHILDREN, whole=True)
    fx = Fixtures(max(SIZES))
    print(f"fixtures: {len(fx.privs)} keys in {fx.key_seconds:.1f} s")
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

    tp = phase_throughput(sets, dev, LANES, REPS)
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
        t0 = time.perf_counter()
        st_launches, st = phase_stress(pool, dev)
        st["phase_s"] = time.perf_counter() - t0
    # phase 18 runs beside phase 17: both host-bound, their own ports
    t_beside = time.perf_counter()
    join_e2e = fresh_beside(("e2e",))
    cx_launches, cx = phase_fresh("chaos")
    t_cx = time.perf_counter() - t_beside
    ((e2e_launches, e2e),) = join_e2e()
    print(f"phase 17 beside 18: {time.perf_counter() - t_beside:.1f} s "
          f"(phase 17 {t_cx:.1f} s, phase 18 {e2e['phase_s']:.1f} s; one "
          f"after another {t_cx + e2e['phase_s']:.1f} s)")
    report_blocksync(bs, bs_launches, card)
    # phases 15 and 16, phases 19 and 20, and phase 21 run beside phases
    # 12 and 13
    t_beside = time.perf_counter()
    join_fresh = fresh_beside(("rpc", "statesync"))
    join_sim = fresh_beside(("sim", "multihost") + WARM_CHILDREN)
    join_grpc = fresh_beside(("grpc",))
    t0 = time.perf_counter()
    cs_launches, cs = phase_consensus(dev)
    cs["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nd_launches, nd = phase_node(dev)
    nd["phase_s"] = time.perf_counter() - t0
    t_nodes = time.perf_counter() - t_beside
    (rp_launches, rp), (ss_launches, ss) = join_fresh()
    (sm_launches, sm), (mh_launches, mh), *warm = join_sim()
    ((gr_launches, gr),) = join_grpc()
    mh_s = mh["phase_s"] + sum(w["phase_s"] for _, w in warm)
    beside_s = time.perf_counter() - t_beside
    alone = t_nodes + rp["phase_s"] + ss["phase_s"] + sm["phase_s"] + mh_s \
        + gr["phase_s"]
    print(f"phases 12-13 beside 15-16, 19-20 and 21: {beside_s:.1f} s "
          f"(phases 12-13 {t_nodes:.1f} s, 15-16 "
          f"{rp['phase_s'] + ss['phase_s']:.1f} s, 19 {sm['phase_s']:.1f} "
          f"s, 20 {mh_s:.1f} s, 21 {gr['phase_s']:.1f} s; one after "
          f"another {alone:.1f} s)")
    report_consensus(cs, cs_launches, card)
    report_node(nd, nd_launches, card)
    report_stress(st, st_launches, card, nd)
    report_rpc(rp, rp_launches, card)
    report_statesync(ss, ss_launches, card)
    report_chaos(cx, cx_launches, card)
    report_e2e(e2e, e2e_launches, card)
    report_sim(sm, sm_launches, card)
    report_multihost(mh, mh_launches, [w for _, w in warm], card)
    report_grpc(gr, gr_launches, card, cx)
    wb_launches = {k: sum(w["launches"].get(k, 0) for _, w in warm)
                   for k in _build.KERNELS}
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
             "consensus": cs_launches, "node": nd_launches,
             "stress": st_launches, "rpc": rp_launches,
             "statesync": ss_launches, "chaos": cx_launches,
             "e2e": e2e_launches, "sim": sm_launches,
             "multihost": mh_launches, "warm_boot": wb_launches,
             "grpc": gr_launches}

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
    k8_ss = ss["checks"]["trees"]["restored"]
    bd_ss = merkle_bounds({**rec, "merkle_tree_leaves": {
        "bound_inputs": k8_ss["bound_inputs"]}}, rate_ops)
    print(f"bound merkle_tree_leaves at {k8_ss['leaves']} leaves "
          f"(statesync): {bd_ss['merkle_tree_leaves'][2]:.3e} int ops, "
          f"{bd_ss['merkle_tree_leaves'][3]} bytes -> "
          f"{bd_ss['merkle_tree_leaves'][0]:.4f} ms "
          f"({bd_ss['merkle_tree_leaves'][1]})")
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
            **({"shape_statesync": f"n={k8_ss['leaves']} one-block "
                                   "leaves (phase 16 (b))",
                "ms_statesync": k8_ss["ms"],
                "device_ms_statesync": k8_ss["device_ms"],
                "plain_ms_statesync": k8_ss["plain_ms"],
                "bound_ms_statesync": bd_ss[k][0]}
               if k == "merkle_tree_leaves" else {}),
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
                       "consensus": cs, "node": nd, "stress": st,
                       "rpc": rp, "statesync": ss, "chaos": cx,
                       "e2e": e2e, "sim": sm, "mesh": mesh,
                       "multihost": mh, "warm_boot": [w for _, w in warm],
                       "grpc": gr, "build": bundle,
                       "build_log": _build.build_log(),
                       "ptxas": usage}, f, indent=1,
                      default=str)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
