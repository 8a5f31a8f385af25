"""On-card smoke test of raft_tpu_torch, the PyTorch/CUDA port.

    python chip_smoke.py

Needs one CUDA card; exits non-zero (printing no result) without one.
Phases, each of which fails the run on any mismatch:

  1. device: name, count, nvidia-smi name and power limit;
  2. build every kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, compared exactly (integers), with CUDA-event
     times of the kernel, the plain version and, where one exists, a
     single PyTorch library call, beside the kernel's bound. The Raft
     expand kernels (raft_guard, raft_apply, raft_fold) are held the same
     way on a chunk of the depth-20 Raft.cfg frontier and on chunks of
     reachable RaftFsync, FlexibleRaft and five-server states; chunk_sort
     on a chunk of the Raft.cfg path and of the five-server path;
     canon_tiered (memo cold and warm) and canon_signatures on a chunk of
     the depth-9 five-server frontier, canon_signatures on the Raft.cfg
     chunk too; sim_pick and raft_sim_check on a full-width FLEX5
     simulate step, raft_predicates on the FLEX5 walks and a Raft.cfg
     chunk, hash_rows on that chunk's valid successor rows; the pull
     kernels (pull_guard, pull_apply, pull_fold, pull_sim_check,
     pull_predicates) on a chunk of reachable PullRaft states and one of
     Variant2 states from the card's own BFS frontiers, and on edge rows
     built from them (full bags, logs at max_log, count-0 records); the
     KRaft kernels (kraft_guard, kraft_apply, kraft_fold, kraft_sim_check,
     kraft_predicates) the same way on a chunk of the KRaft.cfg frontier at
     its widest wave (depth 33) and on edge rows (responses whose mleader
     is Nil and not among them), with canon_memo on its successor rows and
     their server-permuted copies,
     canon_tiered and canon_signatures on a chunk of five-server KRaft
     states, and kraft_sim_check and kraft_predicates on one move of a
     65,536-walk KRaft simulate;
  4. the main path: standard-raft Raft.cfg (inline text) checked through
     the function the CLI calls, on cuda, to exhaustion — 8,664,032
     distinct / 30,708,266 total / depth 48 / 19,514 terminal, no
     violation — with every kernel's launch count read around that run:
     each kernel of the path launched, the per-chunk kernels once per
     chunk, and neither the plain ``RaftModel.expand`` nor a torch sort
     called (both counted by wrapping them for the length of the run);
  4b. five-server Raft with SYMMETRY (BASELINE.json's second
     configuration, msg_slots 64) to RAFT5_DEPTH through the same
     function, held the same way (canon_tiered in canon_memo's place),
     its depth counts equal to the reference's pinned ones through depth
     11; distinct/s and peak device memory reported;
  4c. the pull family on the main path: the PullRaft stand-in (PULL_CFG,
     BASELINE.json's fourth configuration) exhausted through the same
     function with its depth counts, distinct, total, terminal and
     coverage equal to the reference's (scripts/pin_pull_counts.py) and
     the pull kernels once per chunk, no Raft expand kernel; Variant2
     exhausted and held to its pin, and card against CPU at
     PULL2_SMALL_DEPTH; the deepest journal state's trace replayed through
     the guard and apply on the card and on the CPU;
  4d. KRaft.cfg on the main path: exhausted through the same function, its
     depth counts held to the reference's through the pinned depth 30
     (scripts/pin_kraft_counts.py), exhausted again at twice the chunk with
     identical final counts, the KRaft kernels once per chunk and no Raft
     or pull expand kernel, the deepest journal state's trace replayed on
     the card and the CPU, and card against CPU at KRAFT_SMALL_DEPTH;
  5. FlexibleRaft with quorums that need not intersect (3 servers,
     ElectionQuorumSize 2, ReplicationQuorumSize 1): the
     LeaderHasAllAckedValues violation, its gid, depth and trace on the
     card equal the CPU run's;
  5b. RaftFsync (3 servers, the reference cfg's fsync policy) to depth
     24, and 5c. five-server FlexibleRaft at the published quorums to
     FLEX5_DEPTH: counts, depth counts and coverage on the card equal the
     CPU run's;
  6. where the time goes: Raft.cfg to depth 20, five-server Raft to the
     pinned depth 11 (its distinct, total, depth counts and coverage equal
     to the reference's), the PullRaft stand-in's exhaustion and KRaft.cfg
     to its pinned depth 30 (held to the reference's), each once
     untraced (wall per chunk) and once under torch.profiler (device time
     per chunk by kernel group, the device's busy share);
  7. simulate: FlexibleRaft's quorum violation (walk, depth, trace) and
     five-server FlexibleRaft for SMALL_MOVES moves (behaviors, steps,
     final states, journals) at SMALL_WALKS walks, card against CPU; then
     five-server FlexibleRaft at the published quorums with SIM_WALKS
     walks for SIM_MOVES moves through the CLI's function, raft_guard,
     sim_pick, raft_apply and raft_sim_check once per move, raft_predicates
     once (the initial states) and no plain expand, and a profiled window
     of 20 moves;
  7b. simulate the pull family: the PullRaft stand-in at SMALL_WALKS walks
     for SMALL_MOVES moves, card against CPU (behaviors, steps, final
     states, journals); then SIM_WALKS walks of at most SIM_DEPTH steps for
     PULL_SIM_MOVES moves through the CLI's function, pull_guard,
     sim_pick, pull_apply and pull_sim_check once per move, pull_predicates
     once, and a profiled window of 20 moves;
  7c. simulate KRaft.cfg the same way (KRAFT_SIM_MOVES moves), through
     kraft_guard, sim_pick, kraft_apply and kraft_sim_check;
  8. liveness: the two-server graph of tests/test_liveness.py (states and
     edge arrays) card against CPU; then Raft.cfg's constants at
     MaxElections LIVE_ELECTIONS with PROPERTY ValuesNotStuck through the
     CLI's function, its graph and verdict, the per-chunk kernels once per
     chunk, raft_predicates once per property instance and held exactly
     against its plain version on the graph's states (the row of the
     kernel table); 8b. the same for KRaft: the two-server graph of
     tests/test_liveness_families.py card against CPU, then KRaft.cfg's
     constants at MaxElections KRAFT_LIVE_ELECTIONS through kraft_guard,
     kraft_apply and kraft_predicates;
  9. the kernel table as one JSON line, the card's name and power limit,
     and the result line.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

RAFT_CFG = """\
\\* standard-raft/Raft.cfg
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Server = { n1, n2, n3 }
    Value = { v1 }
    Follower = Follower
    Candidate = Candidate
    Leader = Leader
    Nil = Nil
    RequestVoteRequest = RequestVoteRequest
    RequestVoteResponse = RequestVoteResponse
    AppendEntriesRequest = AppendEntriesRequest
    AppendEntriesResponse = AppendEntriesResponse
    MaxElections = 2
    MaxRestarts = 0
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
"""

# FlexibleRaft with 3 servers: ElectionQuorumSize + ReplicationQuorumSize
# <= 3, so the quorums need not intersect and an acked value can be lost.
# (The published FlexibleRaft.cfg has 5 servers, which need the S >= 5
# symmetry canon the port does not have yet.)
FLEX_CFG = RAFT_CFG.replace(
    "    MaxRestarts = 0\n",
    "    MaxRestarts = 0\n    ElectionQuorumSize = 2\n    ReplicationQuorumSize = 1\n")

# RaftFsync with 3 servers and the fsync policy of the reference cfg
# (RaftFsync.cfg:24-26)
FSYNC_CFG = RAFT_CFG.replace(
    "    MaxElections = 2\n    MaxRestarts = 0\n",
    "    MaxElections = 1\n    MaxRestarts = 1\n"
    "    LeaderFsyncBeforeAppendEntries = FALSE\n"
    "    LeaderFsyncBeforeIncludeInQuorum = TRUE\n"
    "    FollowerFsyncBeforeReply = TRUE\n")
FSYNC_DEPTH = 20

# BASELINE.json's second configuration (scripts/bench_rows.py row 2):
# standard-raft with 5 servers, 5 values, MaxElections 4, MaxRestarts 0
RAFT5_CFG = RAFT_CFG.replace(
    "\\* standard-raft/Raft.cfg", "\\* standard-raft/Raft.tla, 5 servers (BASELINE.json)").replace(
    "    v1 = v1\n    Server = { n1, n2, n3 }\n    Value = { v1 }\n",
    "    n4 = n4\n    n5 = n5\n    v1 = v1\n    v2 = v2\n    v3 = v3\n    v4 = v4\n"
    "    v5 = v5\n    Server = { n1, n2, n3, n4, n5 }\n    Value = { v1, v2, v3, v4, v5 }\n",
).replace("    MaxElections = 2\n", "    MaxElections = 4\n")
RAFT5_SLOTS = 64  # W = 334 lanes, A = 129 candidates
# five servers enable about 16 actions per state (15.6 on average at depth
# 8, 17 at most), so a wave overflows the engine's default worklist of 16
# lanes per state and is redone at 32 (VC = 131,072; the redone chunks
# count as chunks). The frontier may grow to 26,497,024 rows of 1,336 B,
# the seen run and the journal to 2^26 (depth 14 adds about 25M states)
RAFT5_CAPS = dict(max_frontier_cap=26_497_024, max_seen_cap=1 << 26, max_journal_cap=1 << 26)
# the reference's dense DeviceBFS through depth 11 (scripts/pin_raft5_counts.py;
# the same distinct and total as BENCH_ROWS.json row2 records)
RAFT5_PIN = dict(
    depth_counts=[1, 1, 3, 10, 39, 159, 697, 3031, 12903, 52642, 203798, 743095],
    distinct=1_016_379, total=4_152_443,
    coverage=[[0, 0, 0], [52283, 261304, 39599], [174, 174, 173], [111, 470, 425],
              [0, 0, 0], [111, 404, 245], [269535, 1917037, 395174],
              [271648, 1704842, 438985], [177083, 268189, 141756], [1, 1, 1],
              [19, 20, 19], [1, 1, 1]],
)
# the depth of the five-server run (phase 4b; it goes past the pinned
# depth, whose counts it is held to), of the sample for phase 3, and of
# the five-server FlexibleRaft card-vs-CPU run (phase 5c). Device memory,
# not time, bounds RAFT5_DEPTH: depth 14 takes about 6 s and 68 GiB at
# peak on one H100 80GB (its 24,815,622-row frontier, 33 GB, is held
# twice), and depth 15's frontier (about 3x as many rows, some 100 GB)
# would not fit once
RAFT5_DEPTH = 14
RAFT5_SAMPLE_DEPTH = 9
FLEX5_DEPTH = 8
# FlexibleRaft at the published quorums (FlexibleRaft.cfg: 5 servers,
# ElectionQuorumSize 3, ReplicationQuorumSize 4) with 2 values,
# MaxElections 2 and MaxRestarts 0
FLEX5_CFG = RAFT5_CFG.replace(
    "standard-raft/Raft.tla, 5 servers (BASELINE.json)",
    "flexible-raft/FlexibleRaft.tla, the published quorums").replace(
    "    v3 = v3\n    v4 = v4\n    v5 = v5\n", "").replace(
    "    Value = { v1, v2, v3, v4, v5 }\n", "    Value = { v1, v2 }\n").replace(
    "    MaxElections = 4\n    MaxRestarts = 0\n",
    "    MaxElections = 2\n    MaxRestarts = 0\n    ElectionQuorumSize = 3\n"
    "    ReplicationQuorumSize = 4\n")

# simulate (phase 7): FlexibleRaft at the published quorums (FLEX5_CFG) with
# SIM_WALKS walks of at most SIM_DEPTH steps (the reference README's
# --sim-depth example) for SIM_MOVES lock-step moves (max_steps =
# SIM_MOVES * SIM_WALKS transitions); the message slots are the first of
# SIM_SLOTS under which no chosen lane overflows its bag. The card-vs-CPU
# runs take SMALL_WALKS walks
SIM_WALKS = 65_536
SIM_DEPTH = 50
SIM_MOVES = 200
SIM_SLOTS = (64, 80, 96, 112, 128)
SMALL_WALKS = 1024
SMALL_MOVES = 100
# liveness (phase 8): Raft.cfg's constants with PROPERTY ValuesNotStuck
# (symmetry off: the checker builds the full-state graph), cut to
# MaxElections LIVE_ELECTIONS: at MaxElections 2 the graph passes the
# checker's 8,000,000-state cap (scripts/liveness_full_graph.py builds it
# with the cap raised); and the two-server configuration of
# tests/test_liveness.py for the card-vs-CPU run
LIVE_ELECTIONS = 1
LIVE_CFG = RAFT_CFG + "PROPERTY\n    ValuesNotStuck\n"
LIVE_SMALL_CFG = LIVE_CFG.replace("    n3 = n3\n", "").replace(
    "Server = { n1, n2, n3 }", "Server = { n1, n2 }")

# PullRaft (BASELINE.json's fourth configuration): PullRaft.cfg as SURVEY.md
# records it, 3 servers and Value = {v1, v2} with v2 undeclared (the
# lenient parse declares it), MaxElections 2 and MaxRestarts 0 standing in
# for constants the repo does not hold (the bounds of Raft.cfg and
# KRaft.cfg); msg_slots 64, the registry's default (W = 259, A = 85;
# Variant2 W = 289). PullRaftVariant2.cfg is the same file
PULL_CFG = RAFT_CFG.replace("\\* standard-raft/Raft.cfg", "\\* pull-raft/PullRaft.cfg").replace(
    "    Value = { v1 }\n", "    Value = { v1, v2 }\n").replace(
    "    AppendEntriesRequest = AppendEntriesRequest\n"
    "    AppendEntriesResponse = AppendEntriesResponse\n",
    "    PullEntriesRequest = PullEntriesRequest\n"
    "    PullEntriesResponse = PullEntriesResponse\n"
    "    LeaderNotifyRequest = LeaderNotifyRequest\n")
# the reference's dense DeviceBFS on the stand-ins, both exhausted
# (scripts/pin_pull_counts.py; PullRaft's distinct, depth and terminal are
# BENCH_ROWS.json row4's)
PULL_PIN = dict(
    depth_counts=[1, 1, 3, 7, 18, 40, 86, 169, 323, 592, 1065, 1845, 3108, 5030, 7803, 11545,
                  16312, 22020, 28460, 35460, 43058, 51341, 60071, 68771, 76855, 83540, 87948,
                  89698, 88660, 84418, 76490, 64686, 49174, 31696, 16092, 5892, 1366, 152],
    distinct=1_113_796, total=3_233_465, terminal=10_094, exhausted=True,
    coverage=[[0, 0, 0], [62471, 97414, 19309], [1821, 3664, 1343], [378996, 425610, 55409],
              [543836, 632662, 156136], [47432, 47472, 43992], [155294, 165664, 20560],
              [17052, 17052, 13068], [290620, 318364, 137896], [295852, 295852, 46986],
              [672834, 829818, 328009], [341286, 382840, 274467], [17052, 17052, 16620]],
)
PULL2_PIN = dict(
    depth_counts=[1, 1, 3, 7, 17, 34, 65, 115, 215, 420, 824, 1505, 2575, 4138, 6301, 9210,
                  13074, 18104, 24297, 31433, 39302, 47954, 57474, 67724, 78471, 89246, 98963,
                  106289, 110290, 110640, 107502, 101652, 93380, 81642, 65244, 45344, 25884,
                  11270, 3328, 504],
    distinct=1_454_442, total=3_993_435, terminal=14_644, exhausted=True,
    coverage=[[0, 0, 0], [59508, 104406, 17177], [1667, 3345, 1185], [489406, 547086, 95287],
              [767932, 938652, 129244], [17527, 17534, 15577], [186575, 200182, 6874],
              [24654, 24654, 5628], [340704, 367324, 206270], [310340, 336139, 209761],
              [804326, 973068, 488482], [413046, 456390, 268444], [24654, 24654, 10512]],
)
# the depths of phase 3's frontier samples (near each widest frontier), of
# the Variant2 card-vs-CPU run, and the pull simulate's moves
PULL_SAMPLE_DEPTH = 27
PULL2_SAMPLE_DEPTH = 29
PULL2_SMALL_DEPTH = 12
PULL_SIM_MOVES = 100

# KRaft.cfg (SURVEY.md:95; the invariant order of tests/test_kraft.py's cfg
# check): 3 servers, 1 value, MaxElections 2, MaxRestarts 0, VIEW +
# SYMMETRY, four invariants; msg_slots 80, the registry's default (W = 291,
# view 289, A = 98)
KRAFT_CFG = """\
\\* pull-raft/KRaft.cfg
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Server = { n1, n2, n3 }
    Value = { v1 }
    Unattached = Unattached
    Voted = Voted
    Follower = Follower
    Candidate = Candidate
    Leader = Leader
    IllegalState = IllegalState
    Nil = Nil
    RequestVoteRequest = RequestVoteRequest
    RequestVoteResponse = RequestVoteResponse
    BeginQuorumRequest = BeginQuorumRequest
    BeginQuorumResponse = BeginQuorumResponse
    FetchRequest = FetchRequest
    FetchResponse = FetchResponse
    MaxElections = 2
    MaxRestarts = 0
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
    NeverTwoLeadersInSameEpoch
    NoIllegalState
"""
# the reference's dense DeviceBFS on KRaft.cfg through depth 30, its
# frontier still growing (scripts/pin_kraft_counts.py, 1,551 s on the CPU)
KRAFT_PIN = dict(
    depth_counts=[1, 1, 3, 6, 15, 29, 60, 122, 278, 610, 1236, 2306, 4079, 6987, 11740, 19493,
                  31827, 50575, 77725, 114911, 163171, 223430, 295949, 380243, 476751, 585569,
                  705921, 837106, 975788, 1115183, 1247236],
    distinct=7_328_351, total=20_482_286, terminal=1_566, exhausted=False,
    coverage=[[0, 0, 0], [1755, 3397, 1421], [2464814, 2715741, 249859],
              [2223036, 2275183, 260216], [47441, 47441, 25831], [543070, 545285, 70524],
              [2046222, 2257142, 399606], [74449, 74449, 50046], [2432046, 2766572, 1440292],
              [2032533, 2233086, 315449], [3614552, 4438688, 2188890],
              [2587898, 3023064, 2236637], [66690, 66690, 66690], [35547, 35547, 22889]],
)
# five-server KRaft (the canon_tiered sample of phase 3): KRaft.cfg with
# servers n1..n5, sampled KRAFT5_SAMPLE_DEPTH levels deep
KRAFT5_CFG = KRAFT_CFG.replace(
    "\\* pull-raft/KRaft.cfg", "\\* pull-raft/KRaft.tla, 5 servers").replace(
    "    n3 = n3\n", "    n3 = n3\n    n4 = n4\n    n5 = n5\n").replace(
    "{ n1, n2, n3 }", "{ n1, n2, n3, n4, n5 }")
KRAFT5_SAMPLE_DEPTH = 8
# the depths of phase 3's sample (the widest wave, 1,473,631 states of the
# exhaustion's 51 levels) and of the card-vs-CPU run, the KRaft simulate's
# moves, and the KRaft liveness run's MaxElections (its full-state graph
# at 2 passes the checker's 8,000,000-state cap: at 1 it has 10,468
# states, and symmetry reduces MaxElections 2 to 19,841,843)
KRAFT_SAMPLE_DEPTH = 33
KRAFT_SMALL_DEPTH = 12
KRAFT_SIM_MOVES = 100
KRAFT_LIVE_ELECTIONS = 1
KRAFT_LIVE_CFG = KRAFT_CFG + "PROPERTY\n    ValuesNotStuck\n"
# tests/test_liveness_families.py's two-server graph (MaxElections 1)
KRAFT_LIVE_SMALL_CFG = KRAFT_LIVE_CFG.replace("    n3 = n3\n", "").replace(
    "{ n1, n2, n3 }", "{ n1, n2 }").replace("MaxElections = 2", "MaxElections = 1")

# (distinct, total, depth, terminal) of Raft.cfg: exhausted, and at depth
# 20 (the sample and trace runs), pinned from the reference's dense path
EXHAUSTED = (8_664_032, 30_708_266, 48, 19_514)
DEPTH20 = (250_016, 719_677, 20, 20)

MEM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
# H100 SXM 32-bit integer ops/s: 64 INT32 lanes per SM, half the 128 FP32
# lanes behind the 67 TFLOP/s float32 rate (an upper rate, so a lower bound)
INT32_OPS = 33.5e12
CHUNK = 4096
# device kernel names of each hand-written kernel (csrc/*.cu)
KERNEL_NAMES = {
    "canon_memo": ("canon_memo_kernel", "memo_insert_kernel"),
    "probe_runs": ("probe_runs_kernel",),
    "compact_append": ("ct_count", "ct_scan", "ct_scatter", "ct_fill", "append_rows_kernel"),
    "merge_runs": ("merge_runs_kernel",),
    "raft_guard": ("raft_guard_kernel",),
    "raft_apply": ("raft_apply_kernel",),
    "raft_fold": ("raft_fold_lanes", "raft_fold_viol"),
    "chunk_sort": ("cs_tile_sort", "cs_merge", "cs_flags", "cs_emit"),
    "canon_tiered": ("canon_tiered_kernel", "ct_memo_insert"),
    "canon_signatures": ("canon_signatures_kernel",),
    "sim_pick": ("sim_pick_kernel",),
    "raft_predicates": ("raft_predicates_kernel",),
    "raft_sim_check": ("raft_sim_check_kernel",),
    "hash_rows": ("hash_rows_kernel",),
    "pull_guard": ("pull_guard_kernel",),
    "pull_apply": ("pull_apply_kernel",),
    "pull_fold": ("pull_fold_lanes", "pull_fold_viol"),
    "pull_predicates": ("pull_predicates_kernel",),
    "pull_sim_check": ("pull_sim_check_kernel",),
    "kraft_guard": ("kraft_guard_kernel",),
    "kraft_apply": ("kraft_apply_kernel",),
    "kraft_fold": ("kraft_fold_lanes", "kraft_fold_viol"),
    "kraft_predicates": ("kraft_predicates_kernel",),
    "kraft_sim_check": ("kraft_sim_check_kernel",),
}
# the kernels each path launches (canon_signatures serves the checks only)
RAFT3_PATH = ("canon_memo", "probe_runs", "compact_append", "merge_runs", "raft_guard",
              "raft_apply", "raft_fold", "chunk_sort")
RAFT5_PATH = tuple(k if k != "canon_memo" else "canon_tiered" for k in RAFT3_PATH)
PULL_PATH = tuple(k.replace("raft_", "pull_") for k in RAFT3_PATH)
KRAFT_PATH = tuple(k.replace("raft_", "kraft_") for k in RAFT3_PATH)
# state fields the invariants of the cfgs here read (NoLogDivergence,
# LeaderHasAllAckedValues; KRaft.cfg's also NeverTwoLeadersInSameEpoch and
# NoIllegalState): the part of a row a family's fold must load
INVARIANT_FIELDS = ("currentTerm", "state", "log_term", "log_value", "commitIndex", "acked")
FOLD_FIELDS = {"raft": INVARIANT_FIELDS, "pull": INVARIANT_FIELDS,
               "kraft": ("currentEpoch", "state", "leader", "log_epoch", "log_value",
                         "highWatermark", "acked")}
# and the liveness predicate ValueAllOrNothing (raft_predicates)
LIVENESS_FIELDS = ("electionCtr", "state", "log_value", "log_len")
# the kernels of the simulate and liveness paths (simulate's
# raft_predicates launch is the initial states' check)
SIM_PATH = ("raft_guard", "sim_pick", "raft_apply", "raft_sim_check", "raft_predicates")
LIVE_PATH = ("raft_guard", "compact_append", "raft_apply", "hash_rows", "raft_predicates")
# the spec families of phases 4c/4d, 7b/7c and (KRaft) 8b: the cfg text,
# each spec with its pin and phase 3's sample depth (the first spec's
# kernels timed, its exhaustion the counted main path), the card-vs-CPU
# run, a second chunk size for a pin that stops short of exhaustion, the
# full-width simulate's moves, and a five-server cfg for the tiered canon
PULL_FAM = dict(prefix="pull", tag="4c", sim_tag="7b", cfg=PULL_CFG, lenient=True,
                specs=(("PullRaft", PULL_PIN, PULL_SAMPLE_DEPTH),
                       ("PullRaftVariant2", PULL2_PIN, PULL2_SAMPLE_DEPTH)),
                small=("PullRaftVariant2", PULL2_SMALL_DEPTH), path=PULL_PATH,
                sim_moves=PULL_SIM_MOVES)
KRAFT_FAM = dict(prefix="kraft", tag="4d", sim_tag="7c", cfg=KRAFT_CFG, lenient=False,
                 specs=(("KRaft", KRAFT_PIN, KRAFT_SAMPLE_DEPTH),),
                 small=("KRaft", KRAFT_SMALL_DEPTH), path=KRAFT_PATH, second_chunk=2 * CHUNK,
                 sim_moves=KRAFT_SIM_MOVES, five_cfg=KRAFT5_CFG, five_depth=KRAFT5_SAMPLE_DEPTH)
# integer operations of one threefry2x32 block: 20 rounds of an add, a
# rotate (two shifts and an or) and a xor, and 6 key injections of 3 adds
THREEFRY_OPS = 20 * 5 + 6 * 3


def setup_servers(text: str) -> list[str]:
    from raft_tpu_torch.utils.cfg import parse_cfg

    return parse_cfg("x.cfg", text=text).server_like("Server")


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unavailable"


def time_ms(torch, fn, iters: int = 20, setup=None) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` warm calls; ``setup``
    runs before each call outside the timed window."""
    for _ in range(2):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if setup:
            setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def exact(torch, a, b) -> float:
    """max |a - b| (0.0 iff equal); fails the run when they differ."""
    if torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs().max().item()
    return max(d, 1.0)


def probe_sectors(torch, q, runs, int64_max):
    """Replays probe_runs' lower-bound searches (its early exit at the
    first hit included) with torch ops on the queries' device: returns
    (fresh [n], distinct 32-byte sectors of the runs the searches read,
    search steps)."""
    fresh = q != int64_max
    sectors = steps = 0
    for r in runs:
        n = r.numel()
        lo, hi = torch.zeros_like(q), torch.full_like(q, n)
        touched = []
        while True:
            a = fresh & (lo < hi)
            if not bool(a.any()):
                break
            mid = (lo + hi) >> 1
            touched.append(mid[a] >> 2)
            steps += int(a.sum())
            less = r[mid.clamp(max=n - 1)] < q
            lo = torch.where(a & less, mid + 1, lo)
            hi = torch.where(a & ~less, mid, hi)
        fin = fresh & (lo < n)
        touched.append(lo[fin] >> 2)
        sectors += torch.unique(torch.cat(touched)).numel()
        fresh = fresh & ~(fin & (r[lo.clamp(max=n - 1)] == q))
    return fresh, sectors, steps


def family_of(model) -> str:
    """The kernel-name prefix of a model's family ("raft", "pull")."""
    return model.KERNELS["guard"].name.rsplit("_", 1)[0]


def expand_puts(torch, model, batch, valid, rank):
    """The message puts the valid lanes of a [C, A] guard grid over the
    [C, W] rows ``batch`` make, counted from the data: RequestVote makes
    S - 1 (its chain), RequestVotePair, AppendEntries and
    SendPullEntriesRequest and SendFetchRequest one, a BecomeLeader of the
    pull family one per peer it notifies (every peer in Variant2, the peers
    that did not vote for it in PullRaft), KRaft's BecomeLeader S - 1, and a
    message whose receipt replies one."""
    S, dev = model.p.n_servers, valid.device
    names = [b[0] for b in model.bindings]
    mask = lambda groups: torch.tensor([n in groups for n in names], device=dev)  # noqa: E731
    puts = (valid & mask(("RequestVote",))).sum() * (S - 1)
    puts = puts + (valid & mask(("RequestVotePair", "AppendEntries",
                                 "SendPullEntriesRequest"))).sum()
    fam = family_of(model)
    if fam == "raft":
        from raft_tpu_torch.models.raft import R_ACCEPT_AE, R_HANDLE_RVREQ, R_REJECT_AE

        replies = (R_HANDLE_RVREQ, R_REJECT_AE, R_ACCEPT_AE)
    elif fam == "kraft":
        from raft_tpu_torch.models import kraft as kr

        replies = (kr.K_HANDLE_RVREQ, kr.K_HANDLE_BQREQ, kr.K_REJECT_FETCH,
                   kr.K_DIVERGING_FETCH, kr.K_ACCEPT_FETCH)
        puts = puts + (valid & mask(("BecomeLeader",))).sum() * (S - 1) + (
            valid & mask(("SendFetchRequest",))).sum()
    else:
        from raft_tpu_torch.models.pull_raft import R_ACCEPT_PULL, R_HANDLE_RVREQ, R_REJECT_PULL

        replies = (R_HANDLE_RVREQ, R_REJECT_PULL, R_ACCEPT_PULL)
        off = names.index("BecomeLeader")
        bl = valid[:, off:off + S]  # BecomeLeader(i) of server i
        if model.p.variant2:
            sends = torch.full((S,), S - 1, device=dev)
        else:
            vg = model.layout.get(batch, "votesGranted")  # [C, S]
            bits = (vg.unsqueeze(-1) >> torch.arange(S, device=dev)) & 1  # [C, i, j]
            sends = (S - 1) - (bits.sum(-1) - torch.diagonal(bits, dim1=1, dim2=2))
        puts = puts + (bl * sends).sum()
    return puts + (valid & sum(rank == r for r in replies).bool()).sum()


def expand_kernels(torch, bfs, pool, rng, timed: bool) -> dict:
    """The family's guard, apply and fold kernels (raft_* or pull_*)
    against their plain versions on one chunk of CHUNK states drawn from
    ``pool`` (states of ``bfs``'s model), at the engine's worklist width,
    exactly; the fold gets the chunk's real new lanes (canonical
    fingerprints deduplicated against ``bfs``'s seen run). With ``timed``,
    also the CUDA-event times of each kernel and its plain version and the
    bounds. Returns {kernel: row}."""
    from raft_tpu_torch.checker.util import I32_MAX, compact_indices
    from raft_tpu_torch.ops.expand import apply, apply_plain, fold, fold_plain, guard, guard_plain
    from raft_tpu_torch.ops.hashing import INT64_MAX

    model, dev = bfs.model, bfs.device
    fam = family_of(model)
    C, VC, A, W = CHUNK, bfs.VC, model.A, model.layout.W
    M = model.p.msg_slots
    K = len(model.ACTION_NAMES)
    batch = torch.from_numpy(np.ascontiguousarray(pool[rng.integers(0, len(pool), C)])).to(dev)
    zcov = lambda: torch.zeros((K, 3), dtype=torch.int64, device=dev)  # noqa: E731
    errs = []
    for n_live in (C - 1000, C):  # a dead chunk tail, then a full chunk
        cov_k, cov_p = zcov(), zcov()
        gk = guard(model, batch, n_live, cov_k)
        gp = guard_plain(model, batch, n_live, cov_p)
        errs += [exact(torch, a, b) for a, b in zip(gk, gp)] + [exact(torch, cov_k, cov_p)]
    valid, rank, _ovf, scal = gk
    sel, n_valid = compact_indices(valid.reshape(-1), VC, C * A)
    check(int(n_valid) <= VC, f"{int(n_valid)} valid lanes exceed the {VC}-lane worklist")
    flatc = apply(model, batch, sel)
    errs.append(exact(torch, flatc, apply_plain(model, batch, sel)))
    memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    fps, _ = bfs.canon.fingerprints_memo(flatc, sel < C * A, memo)
    new, _ = bfs._st_dedup(fps, [bfs._seen])
    jcount = torch.tensor([123_456], dtype=torch.int64, device=dev)
    invs = bfs.invariants
    fold_args = dict(cov=None, sel=sel, valid=valid, rank=rank)
    outs = []
    for fold_fn in (fold, fold_plain):
        viol = torch.full((len(invs),), I32_MAX, dtype=torch.int64, device=dev)
        fold_args["cov"] = zcov()
        fold_fn(model, flatc, new, jcount, viol, invs, **fold_args)
        outs.append((viol, fold_args["cov"]))
    errs += [exact(torch, outs[0][0], outs[1][0]), exact(torch, outs[0][1], outs[1][1])]
    err = max(errs)
    check(err == 0.0, f"{model.name}: {fam}_guard/{fam}_apply/{fam}_fold differ from their "
          "plain versions")
    n_new = int(new.sum())
    print(f"[3] {model.name}: {fam}_guard, {fam}_apply, {fam}_fold exact on {C} states "
          f"({int(n_valid)} valid lanes, {n_new} new, first bad journal index "
          f"{outs[0][0].tolist()})")
    if not timed:
        return {}
    # bounds. guard: the state rows read, valid/rank/ovf written; its
    # operations at least 3 per bag slot (two equality compares and an
    # order compare) for every put a valid lane makes (expand_puts)
    puts = expand_puts(torch, model, batch, valid, rank)
    spec_len = model.kernel_spec(dev)[0].numel()
    guard_bytes = C * W * 4 + C * A * 6 + (spec_len + 4 * A) * 4
    guard_ops = 3 * M * int(puts)
    # apply: the worklist and each source row read once, the block written
    n_src = torch.unique(sel[sel < C * A] // A).numel()
    apply_bytes = VC * 4 + n_src * W * 4 + VC * W * 4
    # fold: new read for every lane; a lane that is not new stops there,
    # so only the new lanes read sel, then the valid and rank it points
    # at, and the invariants' fields of their rows
    inv_lanes = sum(model.layout.fields[f].size for f in FOLD_FIELDS[fam])
    fold_bytes = VC + n_new * (4 + 1 + 4 + 4 * inv_lanes)
    cov, viol = zcov(), torch.full((len(invs),), I32_MAX, dtype=torch.int64, device=dev)
    rows = {
        f"{fam}_guard": dict(
            ms=time_ms(torch, lambda: guard(model, batch, C, cov), iters=50),
            plain_ms=time_ms(torch, lambda: guard_plain(model, batch, C, cov), iters=5),
            bound_ms=max(guard_bytes / MEM_BPS, guard_ops / INT32_OPS) * 1e3,
            bound_by="operations" if guard_ops / INT32_OPS > guard_bytes / MEM_BPS else "bytes",
            puts=int(puts)),
        f"{fam}_apply": dict(
            ms=time_ms(torch, lambda: apply(model, batch, sel), iters=50),
            plain_ms=time_ms(torch, lambda: apply_plain(model, batch, sel), iters=5),
            bound_ms=apply_bytes / MEM_BPS * 1e3, bound_by="bytes"),
        f"{fam}_fold": dict(
            ms=time_ms(torch, lambda: fold(model, flatc, new, jcount, viol, invs, cov=cov,
                                                sel=sel, valid=valid, rank=rank), iters=50),
            plain_ms=time_ms(torch, lambda: fold_plain(
                model, flatc, new, jcount, viol, invs, cov=cov, sel=sel, valid=valid,
                rank=rank), iters=20),
            bound_ms=fold_bytes / MEM_BPS * 1e3, bound_by="bytes"),
    }
    for r in rows.values():
        r.update(library_ms=None, max_abs_err=err)
    if fam != "raft":
        return rows
    # the run emit's torch.sort (PERF.md kernel table row 6) at VC lanes:
    # keys read once, keys (and the int64 index) written once
    key_bytes = VC * 8
    rows["torch_sort"] = dict(
        keys=VC, sort_ms=time_ms(torch, lambda: torch.sort(fps), iters=50),
        sort_bound_ms=2 * key_bytes / MEM_BPS * 1e3,
        sort_idx_ms=time_ms(torch, lambda: torch.sort(fps, stable=True), iters=50),
        sort_idx_bound_ms=3 * key_bytes / MEM_BPS * 1e3, bound_by="bytes")
    return rows


def chunk_lanes(torch, bfs, pool, rng):
    """One chunk of CHUNK states drawn from ``pool`` through the engine's
    own stages: the successor rows and their valid mask (guard, compact,
    apply), their canonical fingerprints (a fresh 2^21-row memo) and
    their fresh flags against ``bfs``'s seen run."""
    from raft_tpu_torch.checker.util import probe_runs
    from raft_tpu_torch.ops.hashing import INT64_MAX

    dev = bfs.device
    batch = torch.from_numpy(np.ascontiguousarray(pool[rng.integers(0, len(pool), CHUNK)])).to(dev)
    cov = torch.zeros((len(bfs.model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    ex = bfs._st_expand(batch, 0, CHUNK, cov)
    flatc, selv = ex[0], ex[2]
    check(not bool(ex[8]), "the sampled chunk overflows its worklist")
    memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    fps, _ = bfs._st_canon(flatc, selv, memo)
    return flatc, selv, fps, probe_runs(fps, [bfs._seen])


def chunk_sort_row(torch, fps, fresh, run_len, timed: bool) -> dict:
    """chunk_sort against its plain version (the two torch.sort calls it
    replaces) on one chunk, exactly; with ``timed`` the times, torch.sort
    with the index as the library call, and the bound: keys (8 B) and
    fresh (1 B) read once, new (1 B) and the run (8 B) written once."""
    from raft_tpu_torch.checker.util import chunk_sort, chunk_sort_plain
    from raft_tpu_torch.ops.hashing import INT64_MAX

    nk, rk = chunk_sort(fps, fresh, run_len)
    np_, rp = chunk_sort_plain(fps, fresh, run_len)
    err = max(exact(torch, nk, np_), exact(torch, rk, rp))
    check(err == 0.0, "chunk_sort differs from its plain version")
    n = fps.numel()
    print(f"[3] chunk_sort exact on {n} lanes ({int(nk.sum())} new, "
          f"{int((fps == INT64_MAX).sum())} at the sentinel)")
    if not timed:
        return {}
    return dict(
        ms=time_ms(torch, lambda: chunk_sort(fps, fresh, run_len), iters=50),
        plain_ms=time_ms(torch, lambda: chunk_sort_plain(fps, fresh, run_len), iters=50),
        library_ms=time_ms(torch, lambda: torch.sort(fps, stable=True), iters=50),
        bound_ms=(n * 8 + n + n + run_len * 8) / MEM_BPS * 1e3, bound_by="bytes",
        max_abs_err=err, lanes=n)


def tier_pairs(torch, canon, states):
    """Per lane of ``states``, counted from its data: the fmix32 pairs of
    its signatures, of one hash of its view (the raw key, or one permuted
    hash: K non-bag lanes + 3 words per occupied slot) and the number of
    its admissible permutations."""
    lay, S, R = canon.layout, canon.S, 3
    occ = (states[:, lay.sl("msg_hi")] != 1 << 30).sum(1)
    kinds = [f.kind for f in lay.fields.values() if f.offset < canon.VL]
    ps_lanes = sum(f.size for f in lay.fields.values()
                   if f.kind == "per_server" and f.offset < canon.VL)
    n_val, n_bm, n_pair = (kinds.count(k) for k in
                           ("per_server_val", "server_bitmask", "per_server_pair"))
    NF = len(canon._host["fields"])  # the message server fields
    per_state = (ps_lanes + S * kinds.count("per_server") + 2 * S * (n_val + n_bm)
                 + (S + 2 * S * (S - 1)) * n_pair + R * (S * n_val + S * S * n_bm
                                                         + 2 * S * S * n_pair + S))
    sig = per_state + occ * (3 + NF + R * (3 + 2 * NF))
    ssig = canon.signatures_plain(states)[:, canon._tensors(states.device)["inv"]]
    n_adm = (ssig[..., 1:] >= ssig[..., :-1]).all(dim=-1).sum(1)
    return sig, canon._K + 3 * occ, n_adm


def tiered_rows(torch, canon, flatc, selv, timed: bool) -> dict:
    """canon_tiered (memo cold, then warm) and canon_signatures against
    their plain versions on one chunk's successor rows, exactly; with
    ``timed`` their times and bounds (operations: ~12 integer ops per
    fmix32 of the two streams of every pair tier_pairs counts; bytes: the
    view lanes read once, each memo row the lanes map to read and written
    once, the outputs written once)."""
    from raft_tpu_torch.ops.hashing import INT64_MAX, memo_slot

    dev = flatc.device
    memo_k = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    memo_p = memo_k.clone()
    errs, hits = [], []
    for _ in range(2):  # cold, then warm
        fk, hk = canon.fingerprints_memo_cuda(flatc, selv, memo_k)
        fp, hp = canon.fingerprints_memo_plain(flatc, selv, memo_p)
        errs += [exact(torch, fk, fp), exact(torch, memo_k, memo_p)]
        check(int(hk) == int(hp), f"canon_tiered hit counts {int(hk)} != {int(hp)}")
        hits.append(int(hk))
    sk, sp = canon.signatures(flatc), canon.signatures_plain(flatc)
    err_sig = exact(torch, sk, sp)
    check(max(errs) == 0.0, "canon_tiered differs from its plain version")
    check(err_sig == 0.0, "canon_signatures differs from its plain version")
    n = int(selv.sum())
    sig, one_hash, n_adm = tier_pairs(torch, canon, flatc)
    adm = n_adm[selv]
    print(f"[3] canon_tiered, canon_signatures exact on {flatc.shape[0]} lanes ({n} valid; "
          f"memo hits cold {hits[0]}, warm {hits[1]}); admissible permutations per valid "
          f"lane: mean {adm.double().mean().item():.3f}, max {int(adm.max())}, "
          f"{int((adm > 1).sum())} lanes with ties")
    if not timed:
        return {}
    B, VL = flatc.shape[0], canon.VL
    slots = torch.unique(memo_slot(canon.raw_fingerprints(flatc[selv]), memo_k.shape[0])).numel()
    io_bytes = B * VL * 4 + B + 2 * slots * 16 + B * 8
    # every lane hashes its raw key; a cold valid lane also its signatures
    # and one permuted hash per admissible permutation; canon_signatures
    # computes every lane's signatures
    raw_ops = 24 * int(one_hash.sum())
    cold_ops = raw_ops + 24 * int((sig + one_hash * n_adm)[selv].sum())
    sig_ops = 24 * int(sig.sum())
    reset = lambda: memo_k.fill_(INT64_MAX)  # noqa: E731
    return {
        "canon_tiered": dict(
            ms=time_ms(torch, lambda: canon.fingerprints_memo_cuda(flatc, selv, memo_k),
                       setup=reset),
            plain_ms=time_ms(torch, lambda: canon.fingerprints_memo_plain(flatc, selv, memo_k),
                             iters=3, setup=reset),
            warm_ms=time_ms(torch, lambda: canon.fingerprints_memo_cuda(flatc, selv, memo_k)),
            bound_ms=max(io_bytes / MEM_BPS, cold_ops / INT32_OPS) * 1e3,
            bound_by="operations" if cold_ops / INT32_OPS > io_bytes / MEM_BPS else "bytes",
            warm_bound_ms=max(io_bytes / MEM_BPS, raw_ops / INT32_OPS) * 1e3, library_ms=None,
            max_abs_err=max(errs), lanes=B),
        "canon_signatures": dict(
            ms=time_ms(torch, lambda: canon.signatures(flatc)),
            plain_ms=time_ms(torch, lambda: canon.signatures_plain(flatc), iters=3),
            bound_ms=max((B * VL * 4 + B * canon.S * 8) / MEM_BPS, sig_ops / INT32_OPS) * 1e3,
            bound_by="operations" if sig_ops / INT32_OPS > (B * VL * 4 + B * canon.S * 8)
            / MEM_BPS else "bytes",
            library_ms=None, max_abs_err=err_sig, lanes=B),
    }


def field_lanes(model, fields) -> int:
    return sum(model.layout.fields[f].size for f in set(fields))


def bound(b, o=0) -> tuple[float, str]:
    """(ms, what bounds it) for ``b`` bytes moved and ``o`` integer ops."""
    return max(b / MEM_BPS, o / INT32_OPS) * 1e3, ("operations" if o / INT32_OPS >
                                                   b / MEM_BPS else "bytes")


def sim_rows(torch, model3, rows3, succ3) -> dict:
    """sim_pick and raft_sim_check against their plain versions on one
    full-width FLEX5 step (SIM_WALKS walks ten steps from Init, msg_slots
    RAFT5_SLOTS), raft_predicates on the FLEX5 walks and on the Raft.cfg
    chunk ``rows3`` (``model3``'s states), hash_rows on the Raft.cfg
    chunk's valid successor rows ``succ3``, each exactly; the CUDA-event
    times, plain times and bounds of sim_pick, raft_sim_check and
    hash_rows (raft_predicates' row comes from the liveness phase).
    Returns {kernel: row}."""
    from raft_tpu_torch.__main__ import load_setup
    from raft_tpu_torch.checker.simulate import Simulator, sim_pick, sim_pick_plain
    from raft_tpu_torch.ops import prng
    from raft_tpu_torch.ops.expand import (
        predicates, predicates_plain, sim_check, sim_check_plain,
    )
    from raft_tpu_torch.ops.hashing import hash_lanes, hash_rows

    setup = load_setup("FlexibleRaft.cfg", text=FLEX5_CFG, msg_slots=RAFT5_SLOTS)
    model, invs = setup.model, setup.invariants
    sim = Simulator(model, invs, walks=SIM_WALKS, max_behavior_depth=SIM_DEPTH, seed=1,
                    device="cuda")
    sim.start()
    for _ in range(10):
        sim.step()
    R, A, W = SIM_WALKS, model.A, model.layout.W
    states, dev = sim.states, sim.states.device
    valid, _rank, ovf, _ = model.chunk_guards(states, R, sim.cov)
    key, n_init = prng.split(sim.rng)[1], sim.init_pool.shape[0]
    zstats = lambda: torch.zeros(4, dtype=torch.int64, device=dev)  # noqa: E731
    sk, sp = zstats(), zstats()
    pk, pp = sim_pick(valid, ovf, key, n_init, sk), sim_pick_plain(valid, ovf, key, n_init, sp)
    err_pick = max([exact(torch, a, b) for a, b in zip(pk, pp)] + [exact(torch, sk, sp)])
    check(err_pick == 0.0, "sim_pick differs from its plain version")
    chosen, moved, sel, ridx = pk
    nxt = model.chunk_apply(states, sel)
    n_moved = int(moved.sum())

    def settle(fn):
        args = [t.clone() for t in (nxt, sim.depth, sim.journal, sim.jlen)]
        st = zstats()
        out = fn(model, states, args[0], moved, chosen, ridx, sim.init_pool, args[1],
                 SIM_DEPTH, args[2], args[3], invs, st)
        return list(out) + args + [st[2:]]

    err_check = max(exact(torch, a, b) for a, b in zip(settle(sim_check),
                                                       settle(sim_check_plain)))
    check(err_check == 0.0, "raft_sim_check differs from its plain version")
    names5 = tuple(invs) + tuple(q for _l, _p, q in model.liveness["ValuesNotStuck"])
    names3 = tuple(q for _l, _p, q in model3.liveness["ValuesNotStuck"]) + (
        "LeaderHasAllAckedValues", "NoLogDivergence")
    err_pred = max(exact(torch, predicates(m, r, n), predicates_plain(m, r, n))
                   for m, r, n in ((model, states, names5), (model3, rows3, names3)))
    check(err_pred == 0.0, "raft_predicates differs from its plain version")
    err_hash = exact(torch, hash_rows(succ3), hash_lanes(succ3))
    check(err_hash == 0.0 and exact(torch, hash_rows(succ3, 7), hash_lanes(succ3, 7)) == 0.0,
          "hash_rows differs from its plain version")
    print(f"[3] sim_pick, raft_sim_check exact on a FLEX5 step of {R} walks ({n_moved} moved); "
          f"raft_predicates exact on the walks ({len(names5)} predicates) and on {len(rows3)} "
          f"Raft.cfg states ({len(names3)}); hash_rows exact on {len(succ3)} Raft.cfg "
          "successor rows (families 0 and 7)")
    # bounds. sim_pick: the valid grid and the chosen lanes' ovf read, four
    # outputs written; three threefry blocks a walk
    pick_bytes = R * A + n_moved + R * (4 + 1 + 4 + 4)
    pick_ops = 3 * THREEFRY_OPS * R
    # raft_sim_check: each moved walk's invariant fields read, the per-walk
    # inputs read and outputs written, a journal entry per moved walk, and
    # a row read and written per walk that restarts or did not move
    done = settle(sim_check)[1]
    copied = int((done | ~moved).sum())
    check_bytes = (4 * n_moved * field_lanes(model, INVARIANT_FIELDS) + R * (1 + 4 * 5)
                   + R * (4 + 1 + 4 + 4) + 4 * n_moved + 2 * 4 * W * copied)
    # hash_rows: the rows read once, 8 bytes written; about 30 operations a
    # lane (two fmix32 of ~12, the salts' multiply-adds and the xor)
    nh, Wh = succ3.shape
    hash_bytes, hash_ops = nh * Wh * 4 + nh * 8, 30 * nh * Wh

    stats = zstats()
    # the settle updates its inputs in place: each timed call starts from
    # the step's tensors again (the copy is outside the timed window)
    base = (nxt, sim.depth, sim.journal, sim.jlen)
    work = [t.clone() for t in base]

    def reset():
        for w, t in zip(work, base):
            w.copy_(t)

    def settle_work(fn):
        return fn(model, states, work[0], moved, chosen, ridx, sim.init_pool, work[1],
                  SIM_DEPTH, work[2], work[3], invs, stats)

    rows = {
        "sim_pick": dict(
            ms=time_ms(torch, lambda: sim_pick(valid, ovf, key, n_init, stats), iters=50),
            plain_ms=time_ms(torch, lambda: sim_pick_plain(valid, ovf, key, n_init, stats),
                             iters=10),
            max_abs_err=err_pick, walks=R),
        "raft_sim_check": dict(
            ms=time_ms(torch, lambda: settle_work(sim_check), iters=20, setup=reset),
            plain_ms=time_ms(torch, lambda: settle_work(sim_check_plain), iters=5,
                             setup=reset),
            max_abs_err=err_check, walks=R),
        "hash_rows": dict(
            ms=time_ms(torch, lambda: hash_rows(succ3), iters=50),
            plain_ms=time_ms(torch, lambda: hash_lanes(succ3), iters=10),
            max_abs_err=err_hash, rows=nh),
    }
    for k, (b, o) in (("sim_pick", (pick_bytes, pick_ops)), ("raft_sim_check", (check_bytes, 0)),
                      ("hash_rows", (hash_bytes, hash_ops))):
        rows[k]["bound_ms"], rows[k]["bound_by"] = bound(b, o)
        rows[k]["library_ms"] = None
    return rows


def edge_pool(model, pool, rng) -> np.ndarray:
    """Edge rows built from 1,024 reachable states of ``pool``: their bags
    filled (free slots take keys that sort first, counts 0 to 2, so puts
    overflow), every log at max_log with no value acked (so a
    ClientRequest and an accepted success response overflow it), and every
    count at 0 (records in the domain that only a count-0 rule can take).
    For a family whose records carry the Nil-able ``mleader`` (KRaft), also
    copies whose responses name a random leader or Nil."""
    from raft_tpu_torch.ops.packing import EMPTY

    lay, M, L = model.layout, model.p.msg_slots, model.p.max_log
    hs, ls, cs = lay.sl("msg_hi"), lay.sl("msg_lo"), lay.sl("msg_cnt")
    base = pool[rng.integers(0, len(pool), 1024)]
    full = base.copy()
    for r in full:
        keys = set(zip(r[hs].tolist(), r[ls].tolist())) - {(EMPTY, EMPTY)}
        while len(keys) < M:
            keys.add((0, int(rng.integers(0, 1 << 20))))
        keys = sorted(keys)
        r[hs], r[ls] = [k[0] for k in keys], [k[1] for k in keys]
        r[cs] = rng.integers(0, 3, M)
    maxlog = base.copy()
    maxlog[:, lay.sl("log_len")] = L
    maxlog[:, lay.sl("acked")] = 0
    zero = base.copy()
    zero[:, cs] = 0
    parts = [full, maxlog, zero]
    pk = model.packer
    if "mleader" in pk.fields:
        lead = base.copy()
        S = model.p.n_servers
        for r in lead:
            keys = {}
            for h, lo_, c in zip(r[hs].tolist(), r[ls].tolist(), r[cs].tolist()):
                if h == EMPTY:
                    continue
                if pk.unpack(h, lo_, "mtype") % 2 == 0:  # the responses (RVResp, FetchResp)
                    h, lo_ = pk.replace(h, lo_, "mleader", int(rng.integers(0, S + 1)))
                keys[(int(h), int(lo_))] = c
            keys = sorted(keys.items())
            bag = np.full((3, M), EMPTY)
            bag[2] = 0
            bag[:, :len(keys)] = [[k[0][0] for k in keys], [k[0][1] for k in keys],
                                  [k[1] for k in keys]]
            r[hs], r[ls], r[cs] = bag
        parts.append(lead)
    return np.ascontiguousarray(np.concatenate(parts))


def settle_rows(torch, model, states, nxt, pick, init_pool, depth, journal, jlen, invs,
                timed: bool, what: str) -> dict:
    """The family's sim_check against its plain version on one simulate
    move from the walks ``states`` (``pick`` is sim_pick's (chosen, moved,
    sel, ridx), ``nxt`` the apply's rows; the settle updates ``depth``,
    ``journal`` and ``jlen``, so each call starts from copies), and its
    predicates kernel over the walks' rows for every registered invariant,
    each exactly; with ``timed`` the times and the bounds. Returns
    {kernel: row}."""
    from raft_tpu_torch.ops.expand import predicates, predicates_plain, sim_check, sim_check_plain

    fam, dev = family_of(model), states.device
    R, W = states.shape
    chosen, moved, _sel, ridx = pick
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    base = (nxt, depth, journal, jlen)
    work = [t.clone() for t in base]

    def reset():
        for w, t in zip(work, base):
            w.copy_(t)

    def settle_work(fn):
        return fn(model, states, work[0], moved, chosen, ridx, init_pool, work[1], SIM_DEPTH,
                  work[2], work[3], invs, stats)

    def settle(fn):
        reset()
        out = settle_work(fn)
        return [t.clone() for t in list(out) + work] + [stats[2:].clone()]

    err_check = max(exact(torch, a, b) for a, b in zip(settle(sim_check),
                                                       settle(sim_check_plain)))
    check(err_check == 0.0, f"{fam}_sim_check differs from its plain version ({what})")
    names = tuple(model.invariants)
    err_pred = exact(torch, predicates(model, states, names),
                     predicates_plain(model, states, names))
    check(err_pred == 0.0, f"{fam}_predicates differs from its plain version ({what})")
    n_moved = int(moved.sum())
    print(f"[3] {model.name}: {fam}_sim_check exact on {what} of {R} walks ({n_moved} moved); "
          f"{fam}_predicates exact on them ({len(names)} invariants)")
    if not timed:
        return {}
    # bounds as raft_sim_check's (sim_rows); the predicates read each
    # walk's invariant fields and write a flag per invariant
    done = settle(sim_check)[1]
    copied = int((done | ~moved).sum())
    check_bytes = (4 * n_moved * field_lanes(model, FOLD_FIELDS[fam]) + R * (1 + 4 * 5)
                   + R * (4 + 1 + 4 + 4) + 4 * n_moved + 2 * 4 * W * copied)
    pred_bytes = 4 * R * field_lanes(model, FOLD_FIELDS[fam]) + R * len(invs)
    rows = {
        f"{fam}_sim_check": dict(
            ms=time_ms(torch, lambda: settle_work(sim_check), iters=20, setup=reset),
            plain_ms=time_ms(torch, lambda: settle_work(sim_check_plain), iters=5,
                             setup=reset),
            max_abs_err=err_check, walks=R),
        f"{fam}_predicates": dict(
            ms=time_ms(torch, lambda: predicates(model, states, invs), iters=50),
            plain_ms=time_ms(torch, lambda: predicates_plain(model, states, invs), iters=10),
            max_abs_err=err_pred, rows=R),
    }
    for k, b in ((f"{fam}_sim_check", check_bytes), (f"{fam}_predicates", pred_bytes)):
        rows[k]["bound_ms"], rows[k]["bound_by"] = bound(b)
        rows[k]["library_ms"] = None
    return rows


def step_rows(torch, model, batch, rng):
    """settle_rows on a simulate move over the walks ``batch`` (sampled
    frontier or edge rows): the guard, sim_pick and the apply, then the
    check and settle of the moved walks at random depths below SIM_DEPTH
    with random journals, some full."""
    from raft_tpu_torch.checker.simulate import sim_pick
    from raft_tpu_torch.ops.expand import apply, guard

    dev = batch.device
    R = batch.shape[0]
    cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    valid, _rank, ovf, _ = guard(model, batch, R, cov)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    pick = sim_pick(valid, ovf, (12345, 678), 1, stats)
    nxt = apply(model, batch, pick[2])
    init_pool = torch.from_numpy(model.init_states()).to(dev)
    gen = torch.Generator().manual_seed(int(rng.integers(0, 1 << 30)))
    depth = torch.randint(0, SIM_DEPTH, (R,), generator=gen, dtype=torch.int32).to(dev)
    J = SIM_DEPTH + 1
    journal = torch.randint(0, model.A, (R, J), generator=gen, dtype=torch.int32).to(dev)
    jlen = (depth + 1).contiguous()
    jlen[::13] = J
    settle_rows(torch, model, batch, nxt, pick, init_pool, depth, journal, jlen,
                ("LeaderHasAllAckedValues", "NoLogDivergence"), False, "a sampled move")


def family_sim_rows(torch, fam) -> dict:
    """The family's sim_check and predicates at the shape its simulate
    runs them: one move of a Simulator of the family's first spec with
    SIM_WALKS walks ten moves from Init (seed 1) and the cfg's invariants,
    checked exactly and timed (settle_rows). Returns {kernel: row}."""
    from raft_tpu_torch.__main__ import load_setup
    from raft_tpu_torch.checker.simulate import Simulator, sim_pick
    from raft_tpu_torch.ops import prng

    setup = load_setup(f"{fam['specs'][0][0]}.cfg", text=fam["cfg"], lenient=fam["lenient"])
    model = setup.model
    sim = Simulator(model, setup.invariants, walks=SIM_WALKS, max_behavior_depth=SIM_DEPTH,
                    seed=1, device="cuda")
    sim.start()
    for _ in range(10):
        sim.step()
    states = sim.states
    valid, _rank, ovf, _ = model.chunk_guards(states, SIM_WALKS, sim.cov)
    stats = torch.zeros(4, dtype=torch.int64, device=states.device)
    pick = sim_pick(valid, ovf, prng.split(sim.rng)[1], sim.init_pool.shape[0], stats)
    nxt = model.chunk_apply(states, pick[2])
    return settle_rows(torch, model, states, nxt, pick, sim.init_pool, sim.depth, sim.journal,
                       sim.jlen, setup.invariants, True, "a full-width simulate move")


def canon_memo_rows(torch, bfs, flatc, selv):
    """canon_memo against its plain version on a chunk's successor rows of
    ``bfs``'s model and their server-permuted copies (the model's message
    remap kinds), memo cold then warm, exactly; the permuted rows keep
    their fingerprints. Prints the cold kernel time."""
    from raft_tpu_torch.ops.hashing import INT64_MAX
    from raft_tpu_torch.ops.symmetry import msg_perm_spec, permute_states

    model, canon, dev = bfs.model, bfs.canon, flatc.device
    base = flatc[selv].cpu().numpy()
    sigmas = list(itertools.permutations(range(model.p.n_servers)))[1:]
    perm = np.concatenate([
        permute_states(model.layout, model.packer, part, np.asarray(sigma),
                       msg_perm_spec(model))
        for part, sigma in zip(np.array_split(base, len(sigmas)), sigmas)])
    rows = torch.from_numpy(np.ascontiguousarray(np.concatenate([base, perm]))).to(dev)
    valid = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    memo_k = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    memo_p = memo_k.clone()
    errs = []
    for _ in range(2):  # cold, then warm
        fk, hk = canon.fingerprints_memo_cuda(rows, valid, memo_k)
        fp, hp = canon.fingerprints_memo_plain(rows, valid, memo_p)
        errs += [exact(torch, fk, fp), exact(torch, memo_k, memo_p), float(int(hk) != int(hp))]
    n = len(base)
    check(max(errs) == 0.0, f"{model.name}: canon_memo differs from its plain version")
    check(torch.equal(fk[:n], fk[n:]), f"{model.name}: permuted states changed their "
          "fingerprints")
    ms = time_ms(torch, lambda: canon.fingerprints_memo_cuda(rows[:n], valid[:n], memo_k),
                 setup=lambda: memo_k.fill_(INT64_MAX))
    print(f"[3] {model.name}: canon_memo exact on {n} successor rows and their permuted "
          f"copies (the message remap {canon.spec}); cold {ms:.4f} ms")


def family_kernel_rows(torch, rng, fam) -> dict:
    """Phase 3 for a spec family: its guard, apply, fold, sim_check and
    predicates against their plain versions, exactly, on a CHUNK of
    reachable states sampled from the card's own BFS frontier of each of
    the family's specs (the first one's expand kernels timed) and on edge
    rows built from them; canon_memo on its successor rows; the family's
    five-server configuration's canon_tiered and canon_signatures where it
    has one; then its sim_check and predicates at its simulate's own width
    (family_sim_rows, timed). Returns {kernel: row}."""
    from raft_tpu_torch.__main__ import run_check

    rows = {}
    for k, (spec, pin, depth) in enumerate(fam["specs"]):
        t = time.perf_counter()
        _, bfs, res = run_family(fam, spec, "cuda", depth)
        n = min(depth + 1, len(pin["depth_counts"]))
        check(res.depth_counts[:n] == pin["depth_counts"][:n],
              f"{spec} sample depth counts {res.depth_counts}")
        pool = bfs.frontier_rows.cpu().numpy()
        print(f"[3] sampled the depth-{depth} {spec} frontier ({len(pool)} states) in "
              f"{time.perf_counter() - t:.1f} s")
        rows.update(expand_kernels(torch, bfs, pool, rng, timed=k == 0))
        edge = edge_pool(bfs.model, pool, rng)
        expand_kernels(torch, bfs, edge, rng, timed=False)
        if k == 0:
            flatc, selv, _fps, _fresh = chunk_lanes(torch, bfs, pool, rng)
            canon_memo_rows(torch, bfs, flatc, selv)
        batch = torch.from_numpy(np.ascontiguousarray(
            pool[rng.integers(0, len(pool), CHUNK)])).to(bfs.device)
        step_rows(torch, bfs.model, batch, rng)
        step_rows(torch, bfs.model, torch.from_numpy(edge).to(bfs.device), rng)
        del bfs
    if "five_cfg" in fam:
        t = time.perf_counter()
        _, bfs, _res = run_check(f"{fam['specs'][0][0]}.cfg", text=fam["five_cfg"],
                                 device="cuda", chunk=CHUNK, max_depth=fam["five_depth"])
        pool = bfs.frontier_rows.cpu().numpy()
        print(f"[3] sampled the depth-{fam['five_depth']} five-server {bfs.model.name} frontier "
              f"({len(pool)} states) in {time.perf_counter() - t:.1f} s")
        flatc, selv, _fps, _fresh = chunk_lanes(torch, bfs, pool, rng)
        tiered_rows(torch, bfs.canon, flatc, selv, timed=False)
        del bfs
    rows.update(family_sim_rows(torch, fam))
    return rows


def run_family(fam, spec, device, depth, chunk=CHUNK):
    """run_check (the CLI's function) of one of the family's specs on its
    cfg text (the pull stand-in parsed leniently: the parse declares its
    v2)."""
    from raft_tpu_torch.__main__ import run_check

    return run_check(f"{spec}.cfg", text=fam["cfg"], device=device, chunk=chunk,
                     max_depth=depth, lenient=fam["lenient"])


def family_main_phase(torch, fam) -> dict:
    """A spec family on the main path: its first spec exhausted through
    ``run_check`` (the CLI's function) with the launch counts of its path
    and its counts held to the pin (all of them where the pin is
    exhausted, the depth counts through the pinned depth where it is
    not); the deepest journal state's trace replayed on the card and on
    the CPU; where the family has a second chunk size, the exhaustion
    repeated at it with identical final counts (a check of the levels past
    a pin); the family's other specs exhausted and held to their pins; and
    card against CPU at a small depth."""
    from raft_tpu_torch.checker.util import replay_chain

    tag, t0 = fam["tag"], time.perf_counter()
    report = {}
    for k, (spec, pin, _depth) in enumerate(fam["specs"]):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if k == 0:
            setup, bfs, res, wall, launches, n_expand, n_sort = counted_run(
                torch, f"{spec}.cfg", fam["cfg"], lenient=fam["lenient"])
        else:
            t = time.perf_counter()
            setup, bfs, res = run_family(fam, spec, "cuda", None)
            wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        chunks = sum(-(-n // CHUNK) for n in res.depth_counts) + bfs.redone_chunks
        model = setup.model
        print(f"[{tag}] {spec}: distinct={res.distinct} total={res.total} depth={res.depth} "
              f"terminal={res.terminal} exhausted={res.exhausted} in {wall:.2f} s "
              f"({res.distinct / wall:.0f} distinct/s, {chunks} chunks, "
              f"{wall * 1e3 / chunks:.2f} ms/chunk), peak device memory "
              f"{peak / 2**30:.2f} GiB (W = {model.layout.W}, A = {model.A})")
        run = {"distinct": res.distinct, "total": res.total, "depth": res.depth,
               "terminal": res.terminal, "seconds": wall, "distinct_per_s": res.distinct / wall,
               "chunks": chunks, "ms_per_chunk": wall * 1e3 / chunks, "peak_device_bytes": peak}
        check(res.violation is None and res.exhausted, f"{spec}: {res.violation}, "
              f"exhausted {res.exhausted}")
        got = dict(depth_counts=res.depth_counts, distinct=res.distinct, total=res.total,
                   terminal=res.terminal, coverage=res.coverage)
        if pin["exhausted"]:
            check(got == {key: pin[key] for key in got},
                  f"{spec} counts {got} != the reference's {pin}")
            held = "counts, depth counts and coverage"
        else:
            n_pin = len(pin["depth_counts"])
            check(res.depth_counts[:n_pin] == pin["depth_counts"],
                  f"{spec} depth counts {res.depth_counts[:n_pin]} != the reference's")
            held = f"depth counts through the pinned depth {n_pin - 1}"
        print(f"[{tag}] {spec}: {held} equal the reference's")
        if k:
            report[spec] = run
            del bfs
            continue
        report.update(run, launches=launches, depth_counts=res.depth_counts)
        check_path(launches, fam["path"], chunks, n_expand, n_sort, tag)
        # the deepest journal state's trace (no invariant of these cfgs fails)
        init, chain = bfs.journal_chain(res.distinct - 1)
        tg, tc = (replay_chain(model, d, init, chain) for d in ("cuda", "cpu"))
        check(tg == tc and len(tg) == res.depth + 1, f"{spec}: the replayed traces differ")
        print(f"[{tag}] {spec}: the {len(tg)}-state trace of gid {res.distinct - 1} (last step "
              f"{tg[-1][0]}) replays equal on the card and the CPU")
        del bfs
        if fam.get("second_chunk"):
            torch.cuda.empty_cache()
            t = time.perf_counter()
            _, bfs2, res2 = run_family(fam, spec, "cuda", None, chunk=fam["second_chunk"])
            wall2 = time.perf_counter() - t
            got2 = (res2.distinct, res2.total, res2.depth, res2.terminal, res2.depth_counts,
                    res2.coverage, res2.exhausted)
            check(got2 == (res.distinct, res.total, res.depth, res.terminal, res.depth_counts,
                           res.coverage, True),
                  f"{spec} at chunk {fam['second_chunk']}: {got2[:4]} != "
                  f"{(res.distinct, res.total, res.depth, res.terminal)}")
            print(f"[{tag}] {spec} exhausted again at chunk {fam['second_chunk']} in "
                  f"{wall2:.2f} s: identical distinct, total, depth, terminal, depth counts "
                  "and coverage")
            report["second_chunk"] = {"chunk": fam["second_chunk"], "seconds": wall2}
            del bfs2
    spec, depth = fam["small"]
    runs = {}
    for d in ("cuda", "cpu"):
        t = time.perf_counter()
        runs[d] = (run_family(fam, spec, d, depth, chunk=1024)[2], time.perf_counter() - t)
    (sg, t_card), (sc, t_cpu) = runs["cuda"], runs["cpu"]
    check((sg.distinct, sg.total, sg.terminal, sg.depth_counts, sg.coverage)
          == (sc.distinct, sc.total, sc.terminal, sc.depth_counts, sc.coverage),
          f"{spec}: card and CPU differ")
    print(f"[{tag}] {spec} to depth {depth}: distinct={sg.distinct} total={sg.total}, depth "
          f"counts and coverage: card == CPU (card {t_card:.1f} s, CPU {t_cpu:.1f} s)")
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({f"{fam['prefix']}_run": report}))
    return report


def family_simulate_phase(torch, fam) -> dict:
    """A spec family simulated: its first spec on the card against the CPU
    at SMALL_WALKS walks for SMALL_MOVES moves, then at SIM_WALKS walks for
    the family's moves through ``run_simulate`` (the CLI's function) with
    its launch counts, and a profiled window of its moves."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.__main__ import load_setup, run_simulate
    from raft_tpu_torch.checker.simulate import Simulator

    tag, pre, t0 = fam["sim_tag"], fam["prefix"], time.perf_counter()
    spec = fam["specs"][0][0]
    kw = dict(text=fam["cfg"], max_behavior_depth=SIM_DEPTH, seed=0, lenient=fam["lenient"])
    small = {}
    for d in ("cuda", "cpu"):
        t = time.perf_counter()
        _, sim, res = run_simulate(f"{spec}.cfg", device=d, walks=SMALL_WALKS,
                                   max_steps=SMALL_MOVES * SMALL_WALKS, **kw)
        small[d] = (sim, res, time.perf_counter() - t)
    (sg, fg, t_card), (sc, fc, t_cpu) = small["cuda"], small["cpu"]
    check(fg.violation is None and fc.violation is None
          and (fg.behaviors, fg.steps) == (fc.behaviors, fc.steps),
          f"simulate {spec}: card {(fg.behaviors, fg.steps, fg.violation)} != CPU "
          f"{(fc.behaviors, fc.steps, fc.violation)}")
    for a in ("states", "depth", "journal", "jlen"):
        check(torch.equal(getattr(sg, a).cpu(), getattr(sc, a)), f"simulate {spec}: {a} differ")
    print(f"[{tag}] simulate {spec} ({SMALL_WALKS} walks, {SMALL_MOVES} moves): behaviors="
          f"{fg.behaviors} steps={fg.steps}, final states and journals: card == CPU "
          f"(card {t_card:.1f} s, CPU {t_cpu:.1f} s)")
    del small, sg, sc
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moves_max = fam["sim_moves"]
    (setup, sim, res), wall, launches, n_expand, _ = counted(
        torch, lambda: run_simulate(f"{spec}.cfg", device="cuda", walks=SIM_WALKS,
                                    max_steps=moves_max * SIM_WALKS, **kw))
    peak = torch.cuda.max_memory_allocated()
    moves = sim.moves
    path = tuple(k.replace("raft_", f"{pre}_") for k in SIM_PATH)
    for k in path[:4]:
        check(launches[k] == moves, f"simulate {spec}: {launches[k]} {k} launches != "
              f"{moves} moves")
    check(launches[f"{pre}_predicates"] == 1,
          f"simulate {spec}: {launches[f'{pre}_predicates']} {pre}_predicates launches != 1")
    for k in set(KERNEL_NAMES) - set(path):
        check(launches[k] == 0, f"simulate {spec}: {k} launched off its path")
    check(n_expand == 0, f"simulate {spec}: the plain expand ran {n_expand} times")
    check(res.violation is None and res.steps >= moves_max * SIM_WALKS, f"{res}")
    report = {"W": setup.model.layout.W, "A": setup.model.A, "walks": SIM_WALKS,
              "moves": moves, "steps": res.steps, "behaviors": res.behaviors, "seconds": wall,
              "steps_per_s": res.steps / wall, "wall_ms_per_move": wall * 1e3 / moves,
              "peak_device_bytes": peak, "launches": launches}
    print(f"[{tag}] simulate {spec} full width: {SIM_WALKS} walks, {moves} moves, "
          f"steps={res.steps} behaviors={res.behaviors} in {wall:.2f} s "
          f"({res.steps / wall:.0f} steps/s, {report['wall_ms_per_move']:.3f} ms per move), "
          f"peak device memory {peak / 2**30:.2f} GiB; {pre}_guard, sim_pick, {pre}_apply, "
          f"{pre}_sim_check once per move, {pre}_predicates once")
    del sim
    setup = load_setup(f"{spec}.cfg", text=fam["cfg"], lenient=fam["lenient"])
    sim = Simulator(setup.model, setup.invariants, walks=SIM_WALKS, max_behavior_depth=SIM_DEPTH,
                    seed=0, device="cuda")
    sim.start()
    for _ in range(10):
        sim.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        sim.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            sim.step()
        torch.cuda.synchronize()
    report["trace"] = {"moves": 20, "wall_ms_per_move": untraced * 1e3 / 20}
    dt = device_time(torch, prof)
    if dt is None:
        report["trace"]["device"] = "not measured: the tracer saw no device activity"
    else:
        busy, groups = dt
        report["trace"].update({
            "device_ms_per_move": busy / 20, "device_busy_share_untraced": busy / (untraced * 1e3),
            "device_ms_per_move_by_group": {
                k: v / 20 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}})
    del sim
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({f"{pre}_simulate": report}))
    print(f"[{tag}] {spec} simulate phase {report['phase_s']:.1f} s")
    return report


def counted(torch, fn):
    """``fn()`` on the card with every kernel's count set to 0 just before
    and read just after, the plain expands (RaftModel's, PullRaftModel's,
    KRaftModel's) and torch's sorts counted by wrapping them for the length
    of the call. Returns (fn's
    result, wall s, launches, expand calls, sort calls)."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.models.kraft import KRaftModel
    from raft_tpu_torch.models.pull_raft import PullRaftModel
    from raft_tpu_torch.models.raft import RaftModel

    models = (RaftModel, PullRaftModel, KRaftModel)
    calls = {"expand": 0, "sort": 0}
    saved = {"expand": tuple(m.expand for m in models),
             "sort": (torch.sort, torch.argsort, torch.Tensor.sort, torch.Tensor.argsort)}

    def counting(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for m, f in zip(models, saved["expand"]):
        m.expand = counting(f, "expand")
    torch.sort, torch.argsort = (counting(f, "sort") for f in saved["sort"][:2])
    torch.Tensor.sort, torch.Tensor.argsort = (counting(f, "sort") for f in saved["sort"][2:])
    kernels.reset_counts()
    try:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
    finally:
        for m, f in zip(models, saved["expand"]):
            m.expand = f
        torch.sort, torch.argsort = saved["sort"][:2]
        torch.Tensor.sort, torch.Tensor.argsort = saved["sort"][2:]
    return out, wall, launches, calls["expand"], calls["sort"]


def counted_run(torch, cfg_name, text, **kw):
    """run_check (the CLI's function) through ``counted``. Returns (setup,
    bfs, res, wall s, launches, expand calls, sort calls)."""
    from raft_tpu_torch.__main__ import run_check

    out, wall, launches, n_expand, n_sort = counted(
        torch, lambda: run_check(cfg_name, text=text, device="cuda", chunk=CHUNK, **kw))
    return (*out, wall, launches, n_expand, n_sort)


def check_path(launches, path, chunks, expand_calls, sort_calls, name):
    """Every kernel of ``path`` launched, the per-chunk kernels once per
    chunk, the canon and the family's fold once more for the initial
    states, no kernel off the path (another family's among them), and
    neither the plain expand nor a torch sort on the path."""
    fam = next(k for k in path if k.endswith("_guard")).rsplit("_", 1)[0]
    for k in path:
        check(launches[k] > 0, f"{name}: kernel {k} was never launched on the path")
    for k in ("probe_runs", f"{fam}_guard", f"{fam}_apply", "chunk_sort"):
        check(launches[k] == chunks, f"{name}: {launches[k]} {k} launches != {chunks} chunks")
    fold = f"{fam}_fold"
    check(launches[fold] == chunks + 1,
          f"{name}: {launches[fold]} {fold} launches != {chunks} chunks + 1")
    canon = path[0]
    check(launches[canon] == chunks + 1,
          f"{name}: {launches[canon]} {canon} launches != {chunks} chunks + 1")
    for k in set(KERNEL_NAMES) - set(path):
        check(launches[k] == 0, f"{name}: {k} launched off its path")
    check(expand_calls == 0, f"{name}: the plain expand ran {expand_calls} times")
    check(sort_calls == 0, f"{name}: torch sorted {sort_calls} times on the chunk path")
    print(f"[{name}] {fam}_guard, {fam}_apply, probe_runs, chunk_sort: one launch per chunk; "
          f"{canon}, {fold}: one per chunk and one for the initial states; no kernel off the "
          f"path; the plain expand called {expand_calls} times, torch sorts {sort_calls}")


def trace_run(torch, cfg_name, text, depth, want, **kw) -> dict:
    """The CLI's function to ``depth`` (None: to exhaustion) once untraced (wall per chunk) and
    once under torch.profiler (device time per chunk by kernel group, the
    device's busy share); both runs' (distinct, total, depth, terminal)
    must equal ``want``."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.__main__ import run_check

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, b, r = run_check(cfg_name, text=text, device="cuda", chunk=CHUNK, max_depth=depth,
                            **kw)
        torch.cuda.synchronize()
        got = (r.distinct, r.total, r.depth, r.terminal)
        check(got == want, f"{cfg_name} depth-{depth} counts {got} != {want}")
        # an exhausted run also expands its last frontier
        waves = r.depth_counts if r.exhausted else r.depth_counts[:-1]
        chunks = sum(-(-n // CHUNK) for n in waves) + b.redone_chunks
        return time.perf_counter() - t, chunks, r

    wall, chunks, res = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced, _, _ = run()
    trace = {"depth": depth, "chunks": chunks, "wall_ms_per_chunk": wall * 1e3 / chunks,
             "traced_wall_ms_per_chunk": traced * 1e3 / chunks,
             "distinct_per_s_untraced": res.distinct / wall}
    dt = device_time(torch, prof)
    if dt is None:
        trace["device"] = "not measured: the tracer saw no device activity"
    else:
        busy, groups = dt
        trace.update({
            "device_ms_per_chunk": busy / chunks,
            "device_busy_share_untraced": busy / (wall * 1e3),
            "device_busy_share_traced": busy / (traced * 1e3),
            "device_ms_per_chunk_by_group": {
                k: v / chunks for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        })
    return trace, res


def device_time(torch, prof) -> tuple[float, dict] | None:
    """(busy ms, ms by kernel group) of the CUDA activity in a trace, or
    None where the tracer saw no device activity."""
    spans, groups = [], {}
    for ev in prof.events():
        us = ev.time_range.elapsed_us()
        if ev.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        # a whole-word match: raft_apply_kernel is a substring of kraft's
        g = next((k for k, names in KERNEL_NAMES.items()
                  if any(re.search(rf"(?<!\w){n}(?!\w)", ev.name) for n in names)), None)
        if g is None:
            g = "torch sort" if "sort" in ev.name.lower() else "other torch"
        groups[g] = groups.get(g, 0.0) + us / 1e3
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, groups


def simulate_phase(torch) -> dict:
    """Phase 7: simulate on the card against the CPU at SMALL_WALKS walks
    (FlexibleRaft's quorum violation; five-server FlexibleRaft for
    SMALL_MOVES moves), then the full-width FLEX5 run through
    ``run_simulate`` (the CLI's function) with its launch counts, and a
    profiled window of its steps."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.__main__ import load_setup, run_simulate
    from raft_tpu_torch.checker.simulate import Simulator

    t0 = time.perf_counter()

    def small(text, device, moves, slots=None):
        return run_simulate("FlexibleRaft.cfg", text=text, device=device, msg_slots=slots,
                            walks=SMALL_WALKS, max_behavior_depth=SIM_DEPTH, seed=0,
                            max_steps=moves * SMALL_WALKS)

    (_, _, vg), (_, _, vc) = (small(FLEX_CFG, d, SMALL_MOVES) for d in ("cuda", "cpu"))
    check(vg.violation is not None and vg.violation.invariant == "LeaderHasAllAckedValues",
          f"simulate FlexibleRaft: expected a LeaderHasAllAckedValues violation, got "
          f"{vg.violation}")
    check(vg.violation == vc.violation and vg.trace == vc.trace
          and (vg.behaviors, vg.steps) == (vc.behaviors, vc.steps),
          f"simulate FlexibleRaft: card {vg.violation} != CPU {vc.violation}")
    print(f"[7] simulate FlexibleRaft ({SMALL_WALKS} walks): {vg.violation.invariant} violated "
          f"by walk {vg.violation.walk} at depth {vg.violation.depth} after {vg.steps} steps, "
          f"{len(vg.trace)}-state trace: card == CPU")
    t = time.perf_counter()
    _, sg, fg = small(FLEX5_CFG, "cuda", SMALL_MOVES, RAFT5_SLOTS)
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    _, sc, fc = small(FLEX5_CFG, "cpu", SMALL_MOVES, RAFT5_SLOTS)
    t_cpu = time.perf_counter() - t
    check(fg.violation is None and fc.violation is None
          and (fg.behaviors, fg.steps) == (fc.behaviors, fc.steps),
          f"simulate FLEX5: card {(fg.behaviors, fg.steps, fg.violation)} != CPU "
          f"{(fc.behaviors, fc.steps, fc.violation)}")
    for a in ("states", "depth", "journal", "jlen"):
        check(torch.equal(getattr(sg, a).cpu(), getattr(sc, a)), f"simulate FLEX5: {a} differ")
    print(f"[7] simulate FLEX5 ({SMALL_WALKS} walks, {SMALL_MOVES} moves): behaviors="
          f"{fg.behaviors} steps={fg.steps}, final states and journals: card == CPU "
          f"(card {t_card:.1f} s, CPU {t_cpu:.1f} s)")
    del sg, sc

    # the full-width run: the first message-slot count under which no
    # chosen lane overflows its bag
    for slots in SIM_SLOTS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            (setup, sim, res), wall, launches, n_expand, _ = counted(
                torch, lambda: run_simulate(
                    "FlexibleRaft.cfg", text=FLEX5_CFG, device="cuda", msg_slots=slots,
                    walks=SIM_WALKS, max_behavior_depth=SIM_DEPTH, seed=0,
                    max_steps=SIM_MOVES * SIM_WALKS))
            break
        except OverflowError as e:
            print(f"[7] simulate FLEX5 at msg_slots {slots}: {e}")
    else:
        fail(f"simulate FLEX5 overflows every message-slot count of {SIM_SLOTS}")
    peak = torch.cuda.max_memory_allocated()
    moves = sim.moves
    for k in SIM_PATH[:4]:
        check(launches[k] == moves, f"simulate: {launches[k]} {k} launches != {moves} moves")
    check(launches["raft_predicates"] == 1,
          f"simulate: {launches['raft_predicates']} predicates launches != 1 (the "
          "initial states' check)")
    for k in set(KERNEL_NAMES) - set(SIM_PATH):
        check(launches[k] == 0, f"simulate: {k} launched off its path")
    check(n_expand == 0, f"simulate: the plain RaftModel.expand ran {n_expand} times")
    check(res.violation is None and res.steps >= SIM_MOVES * SIM_WALKS and res.behaviors > 0,
          f"simulate FLEX5: {res}")
    check(bool((sim.depth < SIM_DEPTH).all()) and bool((sim.jlen == sim.depth + 1).all()),
          "simulate FLEX5: walk depths or journal lengths out of range")
    report = {"msg_slots": slots, "W": setup.model.layout.W, "A": setup.model.A,
              "walks": SIM_WALKS, "moves": moves, "steps": res.steps,
              "behaviors": res.behaviors, "seconds": wall, "steps_per_s": res.steps / wall,
              "wall_ms_per_move": wall * 1e3 / moves, "peak_device_bytes": peak,
              "launches": launches}
    print(f"[7] simulate FLEX5 full width: {SIM_WALKS} walks, msg_slots {slots} (W = "
          f"{report['W']}, A = {report['A']}), {moves} moves, steps={res.steps} behaviors="
          f"{res.behaviors} in {wall:.2f} s ({res.steps / wall:.0f} steps/s, "
          f"{report['wall_ms_per_move']:.3f} ms per move), peak device memory "
          f"{peak / 2**30:.2f} GiB; raft_guard, sim_pick, raft_apply, raft_sim_check once per "
          f"move, raft_predicates once, RaftModel.expand called {n_expand} times")
    del sim

    # where a move's time goes: 20 moves untraced, then 20 under the profiler
    setup = load_setup("FlexibleRaft.cfg", text=FLEX5_CFG, msg_slots=slots)
    sim = Simulator(setup.model, setup.invariants, walks=SIM_WALKS,
                    max_behavior_depth=SIM_DEPTH, seed=0, device="cuda")
    sim.start()
    for _ in range(10):
        sim.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        sim.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(20):
            sim.step()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t
    report["trace"] = {"moves": 20, "wall_ms_per_move": untraced * 1e3 / 20,
                       "traced_wall_ms_per_move": traced * 1e3 / 20}
    dt = device_time(torch, prof)
    if dt is None:
        report["trace"]["device"] = "not measured: the tracer saw no device activity"
    else:
        busy, groups = dt
        report["trace"].update({
            "device_ms_per_move": busy / 20, "device_busy_share_untraced": busy / (untraced * 1e3),
            "device_ms_per_move_by_group": {
                k: v / 20 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}})
    del sim
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"simulate": report}))
    print(f"[7] simulate phase {report['phase_s']:.1f} s")
    return report


# the liveness runs of phases 8 (Raft) and 8b (KRaft): the two-server
# card-vs-CPU configuration and its message slots, and the big run's cfg
# text at its MaxElections
LIVE_RAFT = dict(prefix="raft", tag="8", spec="Raft", small_cfg=LIVE_SMALL_CFG, small_slots=16,
                 cfg=LIVE_CFG, elections=LIVE_ELECTIONS, small_holds=True)
LIVE_KRAFT = dict(prefix="kraft", tag="8b", spec="KRaft", small_cfg=KRAFT_LIVE_SMALL_CFG,
                  small_slots=16, cfg=KRAFT_LIVE_CFG, elections=KRAFT_LIVE_ELECTIONS)


def liveness_phase(torch, live) -> dict:
    """Phase 8 (8b): a family's liveness graph on the card against the CPU
    on its two-server configuration, then its cfg's constants with
    PROPERTY ValuesNotStuck at ``live["elections"]`` through
    ``run_liveness`` (the CLI's function) with its launch counts; the
    family's predicates kernel held exactly against its plain version on
    the graph's states and timed there (the Raft row of the kernel
    table)."""
    from raft_tpu_torch.__main__ import run_liveness

    t0, tag, pre, spec = time.perf_counter(), live["tag"], live["prefix"], live["spec"]
    cfg_name = f"{spec}.cfg"
    runs = [run_liveness(cfg_name, text=live["small_cfg"], device=d, chunk=256,
                         msg_slots=live["small_slots"]) for d in ("cuda", "cpu")]
    (_, cg, rg), (_, cc, rc) = runs
    check((rg.distinct, rg.total_edges, rg.violation) == (rc.distinct, rc.total_edges,
                                                          rc.violation),
          f"liveness two servers {spec}: card {(rg.distinct, rg.total_edges, rg.violation)} "
          f"!= CPU {(rc.distinct, rc.total_edges, rc.violation)}")
    for a in ("_esrc", "_edst", "_ecand"):
        check(np.array_equal(getattr(cg, a), getattr(cc, a)), f"liveness {spec}: {a} differ")
    check(torch.equal(cg._states.cpu(), cc._states), f"liveness {spec}: graph states differ")
    small_verdict = "holds" if rg.violation is None else "VIOLATED"
    check(rg.violation is None or not live.get("small_holds"),
          f"liveness two-server {spec}: ValuesNotStuck {small_verdict}")
    print(f"[{tag}] liveness two-server {spec}: {rg.distinct} states / {rg.total_edges} edges, "
          f"ValuesNotStuck {small_verdict}: states, edge arrays and verdict card == CPU")
    del runs, cg, cc
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    text = live["cfg"].replace("    MaxElections = 2\n",
                               f"    MaxElections = {live['elections']}\n")
    (setup, checker, res), wall, launches, n_expand, _ = counted(
        torch, lambda: run_liveness(cfg_name, text=text, device="cuda", chunk=CHUNK))
    peak = torch.cuda.max_memory_allocated()
    chunks, model = checker.chunks, setup.model
    for k in (f"{pre}_guard", "compact_append", f"{pre}_apply"):
        check(launches[k] == chunks, f"liveness {spec}: {launches[k]} {k} launches != "
              f"{chunks} chunks")
    check(launches["hash_rows"] == chunks + 1,
          f"liveness {spec}: {launches['hash_rows']} hash_rows launches != {chunks} chunks + 1")
    q_names = tuple(q for _l, _p, q in model.liveness["ValuesNotStuck"])
    check(launches[f"{pre}_predicates"] == len(q_names),
          f"liveness {spec}: {launches[f'{pre}_predicates']} {pre}_predicates launches != "
          f"{len(q_names)} property instances")
    path = tuple(k.replace("raft_", f"{pre}_") for k in LIVE_PATH)
    for k in set(KERNEL_NAMES) - set(path):
        check(launches[k] == 0, f"liveness {spec}: {k} launched off its path")
    check(n_expand == 0, f"liveness {spec}: the plain expand ran {n_expand} times")
    verdict = ("holds" if res.violation is None else
               f"VIOLATED ({res.violation.instance}; prefix {len(res.violation.prefix) - 1}, "
               f"loop {len(res.violation.cycle)})")
    check(res.violation is None, f"liveness {spec}: ValuesNotStuck {verdict}")
    report = {"max_elections": live["elections"], "states": res.distinct,
              "edges": res.total_edges, "seconds": wall, "chunks": chunks,
              "verdict": verdict, "peak_device_bytes": peak, "launches": launches,
              "two_server": {"states": rg.distinct, "edges": rg.total_edges,
                             "verdict": small_verdict}}
    print(f"[{tag}] liveness {spec} (MaxElections {live['elections']}): graph {res.distinct} "
          f"states / {res.total_edges} edges in {wall:.2f} s ({chunks} chunks), "
          f"ValuesNotStuck {verdict}; peak device memory {peak / 2**30:.2f} GiB")
    # the predicates kernel as the path calls it: one predicate over the
    # graph's states. Bound: the fields ValueAllOrNothing reads, one bool
    # written
    from raft_tpu_torch.ops.expand import predicates, predicates_plain

    states = checker._states
    err = max(exact(torch, predicates(model, states, (q,)),
                    predicates_plain(model, states, (q,))) for q in q_names)
    check(err == 0.0, f"{pre}_predicates differs from its plain version on the liveness graph")
    n = states.shape[0]
    b, by = bound(4 * n * field_lanes(model, LIVENESS_FIELDS) + n)
    report[f"{pre}_predicates"] = dict(
        ms=time_ms(torch, lambda: predicates(model, states, q_names[:1]), iters=50),
        plain_ms=time_ms(torch, lambda: predicates_plain(model, states, q_names[:1]),
                         iters=10),
        max_abs_err=err, rows=n, bound_ms=b, bound_by=by, library_ms=None)
    print(f"[{tag}] {pre}_predicates exact on the graph's {n} states ({len(q_names)} predicates)")
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({f"liveness_{spec}": report}))
    print(f"[{tag}] liveness {spec} phase {report['phase_s']:.1f} s")
    return report


def main() -> int:
    t_start = time.perf_counter()
    phase_start = {}  # phase -> its start on the host clock

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import raft_tpu_torch next to chip_smoke.py: {e}")
    from raft_tpu_torch import kernels
    from raft_tpu_torch.__main__ import run_check
    from raft_tpu_torch.checker.lsm import merge_runs, merge_runs_plain
    from raft_tpu_torch.checker.util import (
        append_rows, append_rows_plain, compact_indices, dense_prefix_sel,
        probe_runs, probe_runs_plain,
    )
    from raft_tpu_torch.ops.hashing import INT64_MAX, memo_slot
    from raft_tpu_torch.ops.packing import EMPTY
    from raft_tpu_torch.ops.symmetry import permute_states
    from raft_tpu_torch.utils.cfg import parse_cfg

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_start["1"] = time.perf_counter()
    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[1] device: {name} (count {count}); nvidia-smi: {smi}")

    phase_start["2"] = time.perf_counter()
    # ---- 2. build ----
    t = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t
    print(f"[2] built {len(kernels.ALL)} kernels from {len(logs)} sources in {build_s:.1f} s")
    for k, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {k}: {line.strip()}", file=sys.stderr)

    cfg = parse_cfg("Raft.cfg", text=RAFT_CFG)
    check(cfg.init == "Init" and cfg.next == "Next", "cfg INIT/NEXT")
    check(cfg.view == "view" and cfg.symmetry == "symmServers", "cfg VIEW/SYMMETRY")
    check(cfg.invariants == ["LeaderHasAllAckedValues", "NoLogDivergence"], "cfg invariants")
    check(cfg.server_like("Server") == ["n1", "n2", "n3"], "cfg servers")
    check(cfg.constants["MaxElections"] == 2 and cfg.constants["MaxRestarts"] == 0,
          "cfg constants")

    phase_start["3"] = time.perf_counter()
    # ---- 3. kernels against their plain versions ----
    rows = {}
    rng = np.random.default_rng(0)

    # canon_memo: reachable Raft.cfg rows from the port's own BFS to depth
    # 20, and their server-permuted copies, through a 2^21 memo
    t = time.perf_counter()
    setup20, bfs20, res20 = run_check("Raft.cfg", text=RAFT_CFG, device="cuda",
                                      chunk=CHUNK, max_depth=20)
    check((res20.distinct, res20.total, res20.depth, res20.terminal) == DEPTH20,
          f"depth-20 sample run counts {res20.distinct}/{res20.total}/{res20.depth}/"
          f"{res20.terminal} != {DEPTH20}")
    model = setup20.model
    canon = bfs20.canon
    VC = bfs20.VC
    pool = bfs20.frontier_rows.cpu().numpy()
    print(f"[3] sampled the depth-20 frontier ({len(pool)} states) in "
          f"{time.perf_counter() - t:.1f} s")
    base = pool[rng.integers(0, len(pool), VC)]
    sigmas = list(itertools.permutations(range(model.p.n_servers)))
    perm_rows = np.concatenate([
        permute_states(model.layout, model.packer, part, sigma)
        for part, sigma in zip(np.array_split(base, len(sigmas)), sigmas)
    ])
    st_base = torch.from_numpy(np.ascontiguousarray(base)).to(dev)
    st_perm = torch.from_numpy(np.ascontiguousarray(perm_rows)).to(dev)
    valid = torch.ones(VC, dtype=torch.bool, device=dev)
    memo_k = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    memo_p = memo_k.clone()
    errs, hits = [], []
    for states in (st_base, st_perm, st_base, st_perm):  # cold, then warm (hits)
        fk, hk = canon.fingerprints_memo_cuda(states, valid, memo_k)
        fp, hp = canon.fingerprints_memo_plain(states, valid, memo_p)
        torch.cuda.synchronize()
        errs += [exact(torch, fk, fp), exact(torch, memo_k, memo_p)]
        check(int(hk) == int(hp), f"canon_memo hit counts {int(hk)} != {int(hp)}")
        hits.append(int(hk))
        if states is st_perm:
            check(torch.equal(fk, fk_base), "permuted states changed their fingerprints")
        else:
            fk_base = fk
    check(max(errs) == 0.0, "canon_memo differs from its plain version")
    # warm passes hit except where another raw key evicted the row
    check(hits[0] < VC // 2 and min(hits[2:]) > VC // 2, f"memo hits per pass {hits}")
    occ = (st_base[:, model.layout.sl("msg_hi")] != EMPTY).sum().item()
    K, P = canon._K, canon.P
    # the timed pass is cold (every lane misses): fmix32 pairs over the raw
    # hash (K lanes + 3 per occupied slot) and P permuted hashes of every
    # lane; ~12 integer ops each
    cold_ops = 2 * 12 * ((VC * K + 3 * occ) * (1 + P))
    # the VL view lanes of each state and the valid mask read once, each
    # memo row the lanes map to read once and written once (16 B), the
    # fps written once
    slots = torch.unique(memo_slot(canon.raw_fingerprints(st_base), memo_k.shape[0])).numel()
    cold_bytes = VC * canon.VL * 4 + VC + 2 * slots * 16 + VC * 8
    reset = lambda: memo_k.fill_(INT64_MAX)  # noqa: E731
    rows["canon_memo"] = dict(
        ms=time_ms(torch, lambda: canon.fingerprints_memo_cuda(st_base, valid, memo_k),
                   setup=reset),
        plain_ms=time_ms(torch, lambda: canon.fingerprints_memo_plain(st_base, valid, memo_k),
                         iters=5, setup=reset),
        warm_ms=time_ms(torch, lambda: canon.fingerprints_memo_cuda(st_base, valid, memo_k)),
        bound_ms=max(cold_bytes / MEM_BPS, cold_ops / INT32_OPS) * 1e3,
        bound_by="operations" if cold_ops / INT32_OPS > cold_bytes / MEM_BPS else "bytes",
        library_ms=None, max_abs_err=max(errs),
    )

    # probe_runs: a 2^24-lane seen run plus ladder runs, half the queries present
    def sorted_run(n_real, size):
        v = torch.randint(-(1 << 62), 1 << 62, (n_real,), dtype=torch.int64, device=dev)
        pad = torch.full((size - n_real,), INT64_MAX, dtype=torch.int64, device=dev)
        return torch.cat([torch.sort(v).values, pad])

    seen = sorted_run(8_000_000, 1 << 24)
    ladder = [sorted_run(n // 2, n) for n in (VC, VC << 1, VC << 2)]
    runs = [seen] + ladder
    present = torch.cat([seen[:8_000_000], *[r[: r.numel() // 2] for r in ladder]])
    q = torch.randint(-(1 << 62), 1 << 62, (VC,), dtype=torch.int64, device=dev)
    pick = torch.randint(0, present.numel(), (VC // 2,), device=dev)
    q[: VC // 2] = present[pick]
    q[-16:] = INT64_MAX
    q = q[torch.randperm(VC, device=dev)]
    pk, pp = probe_runs(q, runs), probe_runs_plain(q, runs)
    err = exact(torch, pk, pp)
    check(err == 0.0, "probe_runs differs from its plain version")
    check(0.45 * VC < (~pk).sum().item() < 0.55 * VC, "probe_runs: about half present")
    # the queries read and the flags written once, plus the distinct
    # 32-byte sectors of the runs that the searches of these queries read;
    # ~6 integer ops per search step
    fresh, sectors, steps = probe_sectors(torch, q, runs, INT64_MAX)
    check(torch.equal(fresh, pk), "probe_runs differs from the replayed searches")
    probe_bytes = VC * 8 + VC + sectors * 32
    probe_ops = 6 * steps
    rows["probe_runs"] = dict(
        ms=time_ms(torch, lambda: probe_runs(q, runs), iters=50),
        plain_ms=time_ms(torch, lambda: probe_runs_plain(q, runs), iters=20),
        library_ms=time_ms(torch, lambda: torch.searchsorted(seen, q), iters=50),
        bound_ms=max(probe_bytes / MEM_BPS, probe_ops / INT32_OPS) * 1e3,
        bound_by="operations" if probe_ops / INT32_OPS > probe_bytes / MEM_BPS else "bytes",
        max_abs_err=err,
    )
    print(f"[3] probe_runs: {sectors} sectors of the runs read by {steps} search steps")

    # compact_append: the [C*A] valid mask -> worklist, then a row append
    # at a cursor just below capacity so the overflow fires
    A, W = model.A, model.layout.W
    n_mask = CHUNK * A
    mask = torch.rand(n_mask, device=dev) < 0.06
    sk, ck = compact_indices(mask, VC, n_mask)
    sp, cp = dense_prefix_sel(mask, VC, n_mask)
    err_i = max(exact(torch, sk, sp), exact(torch, ck, cp))
    new = torch.rand(VC, device=dev) < 0.3
    esel, n_new = compact_indices(new, VC, VC)
    src = torch.randint(0, 1 << 30, (VC, W), dtype=torch.int32, device=dev)
    fcap = 1 << 18
    cursor = torch.tensor([fcap - 100], dtype=torch.int64, device=dev)
    buf_k = torch.randint(0, 1 << 30, (fcap + VC, W), dtype=torch.int32, device=dev)
    buf_p = buf_k.clone()
    append_rows(buf_k, src, esel, cursor, fcap)
    append_rows_plain(buf_p, src, esel, cursor, fcap)
    check(bool(cursor[0] + n_new > fcap), "the append at capacity must overflow")
    err_r = exact(torch, buf_k, buf_p)
    check(max(err_i, err_r) == 0.0, "compact_append differs from its plain version")
    nn = int(n_new)
    rows["compact_append"] = dict(
        ms=time_ms(torch, lambda: compact_indices(mask, VC, n_mask), iters=50),
        plain_ms=time_ms(torch, lambda: dense_prefix_sel(mask, VC, n_mask), iters=50),
        library_ms=time_ms(torch, lambda: torch.nonzero(mask), iters=50),
        bound_ms=(n_mask + VC * 4) / MEM_BPS * 1e3, bound_by="bytes",
        max_abs_err=max(err_i, err_r),
        rows_ms=time_ms(torch, lambda: append_rows(buf_k, src, esel, cursor, fcap), iters=50),
        rows_plain_ms=time_ms(torch, lambda: append_rows_plain(buf_k, src, esel, cursor, fcap),
                              iters=50),
        rows_bound_ms=(VC * 4 + nn * W * 4 + VC * W * 4) / MEM_BPS * 1e3,
    )

    # merge_runs: the seen merge at 2^24 + 2^22 lanes (truncating), and a
    # padding merge
    top = sorted_run(1 << 21, 1 << 22)
    mk = merge_runs(seen, top, 1 << 24)
    mp = merge_runs_plain(seen, top, 1 << 24)
    err = exact(torch, mk, mp)
    err = max(err, exact(torch, merge_runs(ladder[0], ladder[1], 1 << 19),
                         merge_runs_plain(ladder[0], ladder[1], 1 << 19)))
    check(err == 0.0, "merge_runs differs from its plain version")
    rows["merge_runs"] = dict(
        ms=time_ms(torch, lambda: merge_runs(seen, top, 1 << 24)),
        plain_ms=time_ms(torch, lambda: merge_runs_plain(seen, top, 1 << 24)),
        library_ms=time_ms(torch, lambda: torch.sort(torch.cat([seen, top])).values[: 1 << 24]),
        bound_ms=((1 << 24) + (1 << 22) + (1 << 24)) * 8 / MEM_BPS * 1e3,
        bound_by="bytes", max_abs_err=err,
    )
    del seen, ladder, runs, present, top, mk, mp, buf_k, buf_p, src, memo_k, memo_p

    # the Raft expand kernels: a chunk of the depth-20 Raft.cfg frontier
    # (timed), then chunks of reachable RaftFsync, FlexibleRaft and
    # five-server states
    rows.update(expand_kernels(torch, bfs20, pool, rng, timed=True))
    sort_row = rows.pop("torch_sort")
    for cfg_name, text, depth in (("RaftFsync.cfg", FSYNC_CFG, FSYNC_DEPTH),
                                  ("FlexibleRaft.cfg", FLEX_CFG, None)):
        _, b, r = run_check(cfg_name, text=text, device="cuda", chunk=CHUNK, max_depth=depth)
        expand_kernels(torch, b, b.frontier_rows.cpu().numpy(), rng, timed=False)
        del b

    # chunk_sort on a chunk of the Raft.cfg main path (timed); canon_tiered,
    # canon_signatures and chunk_sort on a chunk of the five-server frontier
    # at depth RAFT5_SAMPLE_DEPTH (timed)
    flatc3, selv3, fps3, fresh3 = chunk_lanes(torch, bfs20, pool, rng)
    rows["chunk_sort"] = chunk_sort_row(torch, fps3, fresh3, bfs20.R0, timed=True)
    # the signatures are defined for any server count: canon_signatures on
    # the Raft.cfg chunk too (its canon stays canon_memo's full-S! min)
    check(exact(torch, canon.signatures(flatc3), canon.signatures_plain(flatc3)) == 0.0,
          "canon_signatures differs from its plain version at three servers")
    print(f"[3] canon_signatures exact on the Raft.cfg chunk ({flatc3.shape[0]} lanes)")
    # the simulate and liveness kernels: a full-width FLEX5 step, a chunk
    # of the depth-20 frontier and its valid successor rows
    rows3 = torch.from_numpy(np.ascontiguousarray(pool[rng.integers(0, len(pool), CHUNK)]))
    rows.update(sim_rows(torch, model, rows3.to(dev), flatc3[selv3].contiguous()))
    del flatc3
    del bfs20
    t = time.perf_counter()
    _, bfs5s, r5s = run_check("Raft.cfg", text=RAFT5_CFG, device="cuda", chunk=CHUNK,
                              msg_slots=RAFT5_SLOTS, max_depth=RAFT5_SAMPLE_DEPTH,
                              caps=RAFT5_CAPS)
    check(r5s.depth_counts == RAFT5_PIN["depth_counts"][:RAFT5_SAMPLE_DEPTH + 1],
          f"five-server sample depth counts {r5s.depth_counts}")
    pool5 = bfs5s.frontier_rows.cpu().numpy()
    print(f"[3] sampled the depth-{RAFT5_SAMPLE_DEPTH} five-server frontier ({len(pool5)} "
          f"states) in {time.perf_counter() - t:.1f} s")
    expand_kernels(torch, bfs5s, pool5, rng, timed=False)
    flatc5, selv5, fps5, fresh5 = chunk_lanes(torch, bfs5s, pool5, rng)
    rows.update(tiered_rows(torch, bfs5s.canon, flatc5, selv5, timed=True))
    sort5 = chunk_sort_row(torch, fps5, fresh5, bfs5s.R0, timed=True)
    del bfs5s, flatc5
    # the pull and KRaft kernels: chunks of the PullRaft, Variant2 and
    # KRaft.cfg frontiers, and edge rows
    rows.update(family_kernel_rows(torch, rng, PULL_FAM))
    rows.update(family_kernel_rows(torch, rng, KRAFT_FAM))
    for k, r in rows.items():
        print(f"[3] {k}: exact; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; warm (all hits) {r['warm_ms']:.4f} ms" if "warm_ms" in r else "")
              + (f", bound {r['warm_bound_ms']:.4f} ms" if "warm_bound_ms" in r else "")
              + (f"; append_rows {r['rows_ms']:.4f} ms vs plain {r['rows_plain_ms']:.4f}"
                 f" ms, bound {r['rows_bound_ms']:.4f} ms" if "rows_ms" in r else ""))
    print(json.dumps({"chunk_sort_five_servers": sort5}))
    print(json.dumps({"simulate_liveness_kernels": {
        k: rows[k] for k in ("sim_pick", "raft_sim_check", "hash_rows")}}))

    phase_start["4"] = time.perf_counter()
    # ---- 4. the main path ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    setup, bfs, res, wall, launches, expand_calls, sort_calls = counted_run(
        torch, "Raft.cfg", RAFT_CFG)
    got = (res.distinct, res.total, res.depth, res.terminal)
    chunks = sum(-(-n // CHUNK) for n in res.depth_counts) + bfs.redone_chunks
    print(f"[4] Raft.cfg: distinct={res.distinct} total={res.total} depth={res.depth} "
          f"terminal={res.terminal} exhausted={res.exhausted} in {wall:.2f} s "
          f"({res.distinct / wall:.0f} distinct/s, {chunks} chunks, "
          f"{wall * 1e3 / chunks:.2f} ms/chunk), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, memo hits {bfs.memo_hits}")
    print(json.dumps({"launches": launches}))
    check(res.violation is None, f"unexpected violation {res.violation}")
    check(res.exhausted and got == EXHAUSTED, f"exhaustion counts {got} != {EXHAUSTED}")
    check_path(launches, RAFT3_PATH, chunks, expand_calls, sort_calls, "4")
    del bfs

    phase_start["4b"] = time.perf_counter()
    # ---- 4b. five-server Raft with SYMMETRY to RAFT5_DEPTH ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, bfs5, res5, wall5, launches5, expand5, sort5_calls = counted_run(
        torch, "Raft.cfg", RAFT5_CFG, msg_slots=RAFT5_SLOTS, max_depth=RAFT5_DEPTH,
        caps=RAFT5_CAPS)
    chunks5 = sum(-(-n // CHUNK) for n in res5.depth_counts[:-1]) + bfs5.redone_chunks
    peak5 = torch.cuda.max_memory_allocated()
    print(f"[4b] five-server Raft: distinct={res5.distinct} total={res5.total} "
          f"depth={res5.depth} in {wall5:.2f} s ({res5.distinct / wall5:.0f} distinct/s, "
          f"{chunks5} chunks, {bfs5.redone_chunks} of them redone after a worklist overflow, "
          f"{wall5 * 1e3 / chunks5:.2f} ms/chunk), peak device memory "
          f"{peak5 / 2**30:.2f} GiB, frontier {res5.depth_counts[-1]} rows of "
          f"{bfs5.W * 4} B, memo hits {bfs5.memo_hits}")
    print(json.dumps({"five_server_run": {
        "depth_counts": res5.depth_counts, "distinct": res5.distinct, "total": res5.total,
        "seconds": wall5, "distinct_per_s": res5.distinct / wall5, "chunks": chunks5,
        "redone_chunks": bfs5.redone_chunks, "lanes_per_state": bfs5.VC // CHUNK,
        "peak_device_bytes": peak5, "launches": launches5}}))
    check(res5.violation is None and res5.depth == RAFT5_DEPTH,
          f"five-server run: violation {res5.violation}, depth {res5.depth}")
    pin = RAFT5_PIN["depth_counts"]
    check(res5.depth_counts[:len(pin)] == pin,
          f"five-server depth counts {res5.depth_counts[:len(pin)]} != the reference's {pin}")
    check_path(launches5, RAFT5_PATH, chunks5, expand5, sort5_calls, "4b")
    del bfs5

    phase_start["4c"] = time.perf_counter()
    # ---- 4c. the pull family on the main path ----
    pull_report = family_main_phase(torch, PULL_FAM)

    phase_start["4d"] = time.perf_counter()
    # ---- 4d. KRaft.cfg on the main path ----
    kraft_report = family_main_phase(torch, KRAFT_FAM)

    phase_start["5"] = time.perf_counter()
    # ---- 5. FlexibleRaft's quorum violation: card vs CPU ----
    def small_run(cfg_name, text, device, depth=None, **kw):
        return run_check(cfg_name, text=text, device=device, chunk=1024, max_depth=depth,
                         **kw)[2]

    vg, vc = (small_run("FlexibleRaft.cfg", FLEX_CFG, d) for d in ("cuda", "cpu"))
    check(vg.violation is not None and vg.violation.invariant == "LeaderHasAllAckedValues",
          f"FlexibleRaft: expected a LeaderHasAllAckedValues violation, got {vg.violation}")
    check(vg.violation == vc.violation, f"violation {vg.violation} != {vc.violation}")
    check(vg.trace == vc.trace and len(vg.trace) == vg.violation.depth + 1,
          "violation traces differ between the card and the CPU")
    check((vg.distinct, vg.total, vg.depth_counts) == (vc.distinct, vc.total, vc.depth_counts),
          "FlexibleRaft counts differ between the card and the CPU")
    print(f"[5] FlexibleRaft: LeaderHasAllAckedValues violated at depth {vg.violation.depth}, "
          f"gid {vg.violation.global_id}, {len(vg.trace)}-state trace, {vg.distinct} distinct: "
          "card == CPU")

    phase_start["5b"] = time.perf_counter()
    # ---- 5b. RaftFsync to FSYNC_DEPTH, 5c. five-server FlexibleRaft to
    # FLEX5_DEPTH: card vs CPU ----
    for tag, cfg_name, text, depth, kw in (
            ("5b", "RaftFsync.cfg", FSYNC_CFG, FSYNC_DEPTH, {}),
            ("5c", "FlexibleRaft.cfg", FLEX5_CFG, FLEX5_DEPTH,
             dict(msg_slots=RAFT5_SLOTS, caps=RAFT5_CAPS))):
        t = time.perf_counter()
        fg = small_run(cfg_name, text, "cuda", depth, **kw)
        t_card = time.perf_counter() - t
        t = time.perf_counter()
        fc = small_run(cfg_name, text, "cpu", depth, **kw)
        t_cpu = time.perf_counter() - t
        got = (fg.distinct, fg.total, fg.depth, fg.terminal)
        check(fg.violation is None and fc.violation is None
              and got == (fc.distinct, fc.total, fc.depth, fc.terminal),
              f"{cfg_name} counts {got} != CPU {(fc.distinct, fc.total, fc.depth, fc.terminal)}")
        check(fg.depth_counts == fc.depth_counts and fg.coverage == fc.coverage,
              f"{cfg_name} depth counts or coverage differ between the card and the CPU")
        print(f"[{tag}] {cfg_name} ({len(setup_servers(text))} servers) to depth {depth}: "
              f"distinct={fg.distinct} total={fg.total} terminal={fg.terminal}, depth counts "
              f"and coverage: card == CPU (card {t_card:.1f} s, CPU {t_cpu:.1f} s)")

    phase_start["6"] = time.perf_counter()
    # ---- 6. where the time goes: Raft.cfg to depth 20 and five-server Raft
    # to the pinned depth, each untraced, then traced ----
    traces = {}
    traces["raft"], _ = trace_run(torch, "Raft.cfg", RAFT_CFG, 20, DEPTH20)
    pin_depth = len(RAFT5_PIN["depth_counts"]) - 1
    traces["raft5"], r5 = trace_run(
        torch, "Raft.cfg", RAFT5_CFG, pin_depth,
        (RAFT5_PIN["distinct"], RAFT5_PIN["total"], pin_depth, 0),
        msg_slots=RAFT5_SLOTS, caps=RAFT5_CAPS)
    check(r5.depth_counts == RAFT5_PIN["depth_counts"] and r5.coverage == RAFT5_PIN["coverage"],
          "five-server depth counts or coverage at the pinned depth differ from the reference's")
    traces["pull"], _ = trace_run(
        torch, "PullRaft.cfg", PULL_CFG, None,
        (PULL_PIN["distinct"], PULL_PIN["total"], len(PULL_PIN["depth_counts"]) - 1,
         PULL_PIN["terminal"]), lenient=True)
    print(f"[6] Raft.cfg depth 20: {traces['raft']['chunks']} chunks, "
          f"{traces['raft']['wall_ms_per_chunk']:.3f} ms/chunk wall; five-server Raft depth "
          f"{pin_depth}: distinct, total, depth counts and coverage equal the reference's, "
          f"{traces['raft5']['chunks']} chunks, {traces['raft5']['wall_ms_per_chunk']:.3f} "
          "ms/chunk wall")
    print(json.dumps({"trace": traces["raft"]}))
    print(json.dumps({"trace_five_servers": traces["raft5"]}))
    print(json.dumps({"trace_pull": traces["pull"]}))
    kpin = len(KRAFT_PIN["depth_counts"]) - 1
    traces["kraft"], rk = trace_run(
        torch, "KRaft.cfg", KRAFT_CFG, kpin,
        (KRAFT_PIN["distinct"], KRAFT_PIN["total"], kpin, KRAFT_PIN["terminal"]))
    check(rk.depth_counts == KRAFT_PIN["depth_counts"] and rk.coverage == KRAFT_PIN["coverage"],
          "KRaft depth counts or coverage at the pinned depth differ from the reference's")
    print(f"[6] KRaft.cfg depth {kpin}: distinct, total, depth counts and coverage equal the "
          f"reference's, {traces['kraft']['chunks']} chunks, "
          f"{traces['kraft']['wall_ms_per_chunk']:.3f} ms/chunk wall")
    print(json.dumps({"trace_kraft": traces["kraft"]}))

    phase_start["7"] = time.perf_counter()
    # ---- 7. simulate ----
    sim_report = simulate_phase(torch)

    phase_start["7b"] = time.perf_counter()
    # ---- 7b. simulate the pull family ----
    pull_sim_report = family_simulate_phase(torch, PULL_FAM)

    phase_start["7c"] = time.perf_counter()
    # ---- 7c. simulate KRaft ----
    kraft_sim_report = family_simulate_phase(torch, KRAFT_FAM)

    phase_start["8"] = time.perf_counter()
    # ---- 8. liveness ----
    live_report = liveness_phase(torch, LIVE_RAFT)
    rows["raft_predicates"] = live_report.pop("raft_predicates")

    phase_start["8b"] = time.perf_counter()
    # ---- 8b. KRaft liveness ----
    kraft_live_report = liveness_phase(torch, LIVE_KRAFT)
    kraft_live_report.pop("kraft_predicates")

    phase_start["9"] = time.perf_counter()
    # ---- 9. results ----
    meta = {
        "canon_memo": ("raft_tpu_torch/csrc/canon_memo.cu", "raft_tpu/ops/symmetry.py:1230"),
        "probe_runs": ("raft_tpu_torch/csrc/probe_runs.cu", "raft_tpu/checker/util.py:21"),
        "compact_append": ("raft_tpu_torch/csrc/compact_append.cu",
                           "raft_tpu/checker/util.py:48"),
        "merge_runs": ("raft_tpu_torch/csrc/merge_runs.cu",
                       "raft_tpu/checker/device_bfs.py:285"),
        "raft_guard": ("raft_tpu_torch/csrc/raft_expand.cu", "raft_tpu/models/base.py:332"),
        "raft_apply": ("raft_tpu_torch/csrc/raft_expand.cu", "raft_tpu/models/base.py:426"),
        "raft_fold": ("raft_tpu_torch/csrc/raft_fold.cu",
                      "raft_tpu/checker/device_bfs.py:501"),
        "chunk_sort": ("raft_tpu_torch/csrc/chunk_sort.cu",
                       "raft_tpu/checker/device_bfs.py:413"),
        "canon_tiered": ("raft_tpu_torch/csrc/canon_tiered.cu",
                         "raft_tpu/ops/symmetry.py:1081"),
        "canon_signatures": ("raft_tpu_torch/csrc/canon_tiered.cu",
                             "raft_tpu/ops/symmetry.py:581"),
        "sim_pick": ("raft_tpu_torch/csrc/sim_step.cu", "raft_tpu/checker/simulate.py:66"),
        "raft_predicates": ("raft_tpu_torch/csrc/raft_predicates.cu",
                            "raft_tpu/checker/liveness.py:254"),
        "raft_sim_check": ("raft_tpu_torch/csrc/raft_predicates.cu",
                           "raft_tpu/checker/simulate.py:93"),
        "hash_rows": ("raft_tpu_torch/csrc/hash_rows.cu", "raft_tpu/checker/liveness.py:108"),
        "pull_guard": ("raft_tpu_torch/csrc/pull_expand.cu", "raft_tpu/models/pull_raft.py:667"),
        "pull_apply": ("raft_tpu_torch/csrc/pull_expand.cu", "raft_tpu/models/base.py:426"),
        "pull_fold": ("raft_tpu_torch/csrc/pull_fold.cu", "raft_tpu/checker/device_bfs.py:501"),
        "pull_sim_check": ("raft_tpu_torch/csrc/pull_predicates.cu",
                           "raft_tpu/checker/simulate.py:93"),
        "pull_predicates": ("raft_tpu_torch/csrc/pull_predicates.cu",
                            "raft_tpu/checker/simulate.py:142"),
        "kraft_guard": ("raft_tpu_torch/csrc/kraft_expand.cu", "raft_tpu/models/kraft.py:857"),
        "kraft_apply": ("raft_tpu_torch/csrc/kraft_expand.cu", "raft_tpu/models/base.py:426"),
        "kraft_fold": ("raft_tpu_torch/csrc/kraft_fold.cu",
                       "raft_tpu/checker/device_bfs.py:501"),
        "kraft_sim_check": ("raft_tpu_torch/csrc/kraft_predicates.cu",
                            "raft_tpu/checker/simulate.py:93"),
        "kraft_predicates": ("raft_tpu_torch/csrc/kraft_predicates.cu",
                             "raft_tpu/checker/simulate.py:142"),
    }
    # launches: each kernel's count on the path that runs it (Raft.cfg's
    # for the kernels both paths share, liveness' for raft_predicates,
    # whose row is timed there; the PullRaft stand-in's exhaustion for the
    # pull expand and fold, its simulate for pull_sim_check and
    # pull_predicates; KRaft.cfg's exhaustion and simulate likewise for the
    # kraft kernels); canon_signatures serves the checks
    path_launches = {**{k: launches[k] for k in RAFT3_PATH},
                     "canon_tiered": launches5["canon_tiered"], "canon_signatures": 0,
                     "sim_pick": sim_report["launches"]["sim_pick"],
                     "raft_sim_check": sim_report["launches"]["raft_sim_check"],
                     "raft_predicates": live_report["launches"]["raft_predicates"],
                     "hash_rows": live_report["launches"]["hash_rows"],
                     **{k: pull_report["launches"][k] for k in PULL_PATH if k.startswith("pull_")},
                     **{k: pull_sim_report["launches"][k]
                        for k in ("pull_sim_check", "pull_predicates")},
                     **{k: kraft_report["launches"][k] for k in KRAFT_PATH
                        if k.startswith("kraft_")},
                     **{k: kraft_sim_report["launches"][k]
                        for k in ("kraft_sim_check", "kraft_predicates")}}
    table = [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": path_launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for k, r in rows.items()
    ]
    check(len(table) == len(KERNEL_NAMES), f"{len(table)} kernels in the table")
    tags = list(phase_start)
    phase_s = {t: round(phase_start[n] - phase_start[t], 1) for t, n in zip(tags, tags[1:])}
    print(json.dumps({"phase_seconds": phase_s}))
    print(f"[9] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"torch_sort": sort_row}))
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
