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
     reachable RaftFsync, FlexibleRaft and five-server states (raft_apply,
     like kraft_apply and the reconfiguration applies below, is the group
     apply, G threads a worklist lane, printed with G, its warps an SM,
     registers, stack bytes and its bound's bytes and operations); chunk_dedup
     on a synthetic chunk (half its lanes present) against a 2^24-lane seen
     run and three ladder runs, on a chunk of the Raft.cfg path and on one
     of the five-server path against their seen runs;
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
     65,536-walk KRaft simulate; the reconfiguration kernels (reconfig_*
     for RaftWithReconfigAddRemove, joint_* for JointConsensus) the same
     way on a chunk of each four-server cfg's frontier at a wide wave and
     on edge rows that take every receipt arm, the snapshot pair and the
     config appends (tests/test_torch_kernels_cuda.py config_edge_rows),
     with canon_memo's general path (N-word keys, the server_bitmask
     kind, up to 24 remap fields) on their successor rows and permuted
     copies; their apply (the group apply, G threads a worklist lane) also
     printed with G, its resident warps an SM, its registers and stack
     bytes and its bound's bytes and operations; canon_tiered's general
     path (memo cold and warm, fingerprint seeds 0 and 0x5EED5EED) and
     canon_signatures on a chunk of each five-server reconfiguration cfg's
     frontier (ADDREMOVE5_CFG, JOINT5_CFG: 5- and 7-word keys, member-set
     fields, log fields of several lanes a server; timed, with the family's
     guard, apply and fold, the apply timed) and on their server-permuted
     copies;
     raft_guard and raft_apply with the network-fault groups at
     Raft.cfg's width (A = 165) on a chunk of its --net-faults frontier
     (timed) and on edge rows with count-0, -1 and -2 records (both fault
     groups fire; a count-2 record's duplicate and a count-0 record's
     faults refused); raft_guard and pull_guard of fleet-packed models on
     rows whose c_<name> lanes lie below the static maximum (timed);
     owner_route (the sharded engine's owner route) on a chunk of the
     Raft.cfg path at D = 1, 2, 4 and 8, with the path's route cap and one
     that overflows at D = 8 (timed at D = 1);
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
  4e, 4f. the reconfiguration specs on the main path (ADDREMOVE_CFG,
     JOINT_CFG: the reference cfgs' four servers, 112 message slots):
     AddRemove to its LeaderHasAllAckedValues violation at depth 21
     (RECONFIG_VIOLATION), JointConsensus to depth 18, the deepest its
     frontier fits in 80 GB; each with its depth counts and coverage held to
     the reference's (scripts/pin_reconfig_counts.py) through the pinned
     depth, again at half the chunk with identical results, its family's
     kernels once per chunk and no other family's expand, the
     counterexample's (or the deepest journal state's) trace replayed on
     the card and the CPU, and card against CPU at the reference tests'
     three-server constants;
  4h. Raft.cfg with --net-faults (DuplicateMessage and DropMessage) to
     NF_DEPTH through the same function: the Raft kernels once per chunk,
     both fault actions fired, its depth counts held to the reference's
     through the pinned depth 15 (scripts/pin_net_faults_counts.py), again
     at twice the chunk with identical results, the deepest journal state's
     trace replayed on the card and the CPU, and card against CPU at the
     two-server constants of tests/test_net_faults.py;
  4i. five-server AddRemove (ADDREMOVE5_CFG) to ADDREMOVE5_DEPTH through
     the same function: the reconfig_* kernels and canon_tiered (in
     canon_memo's place) once per chunk, its depth counts held to the
     reference's through the pinned depth 13 (scripts/pin_reconfig_counts.py
     --servers 5), the deepest journal state's trace replayed on the card
     and the CPU; at the pinned depth its depth counts and coverage equal
     the reference's, once untraced and once traced (device time by kernel
     group), the same at half the chunk through the port's parity_gate, and
     its collision_audit (seeds 0 and 0x5EED5EED) passing at AUDIT5_DEPTH;
     five-server JointConsensus (JOINT5_CFG) card against CPU at
     JOINT5_SMALL_DEPTH (the card run counted: joint_* and canon_tiered);
  4j. Raft.cfg by the sharded engine (ShardedBFS, --checker sharded) at
     D = 1 over NCCL through the CLI's function, exhausted at phase 4's
     counts and depth counts, its enabled/fired coverage and new-distinct
     total equal to DeviceBFS's, the path's kernels once per chunk with
     owner_route among them and two all_to_all_single calls a chunk; a
     checkpoint at depth SHARD_CKPT_DEPTH resumed to the same counts;
     two-server Raft checkpointed on the card at D = 1 and resumed on the
     CPU at D = 2 (gloo) with the counts of the card's uninterrupted run;
     FlexibleRaft's violation at DeviceBFS's depth with its trace replayed
     on the card and the CPU; Raft.cfg to depth 20 untraced and under
     torch.profiler (device ms a chunk by kernel group, the exchange's
     NCCL kernels and copies among them);
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
     to its pinned depth 30 (held to the reference's), and the two
     reconfiguration cfgs to their pinned depths (held likewise), and
     Raft.cfg with --net-faults to its pinned depth 15 (its depth counts and
     coverage held to the reference's), each once untraced (wall per
     chunk) and once under torch.profiler (device time per chunk by kernel
     group, the device's busy share);
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
  7d, 7e. simulate the two reconfiguration cfgs the same way
     (CONFIG_SIM_MOVES moves), the card against the CPU on their
     three-server cfgs at CONFIG_SMALL_SIM walks and moves;
  8. liveness: the two-server graph of tests/test_liveness.py (states and
     edge arrays) card against CPU; then Raft.cfg's constants at
     MaxElections LIVE_ELECTIONS with PROPERTY ValuesNotStuck through the
     CLI's function, its graph and verdict, the per-chunk kernels once per
     chunk, raft_predicates once per property instance and held exactly
     against its plain version on the graph's states (the row of the
     kernel table); 8b. the same for KRaft: the two-server graph of
     tests/test_liveness_families.py card against CPU, then KRaft.cfg's
     constants at MaxElections KRAFT_LIVE_ELECTIONS through kraft_guard,
     kraft_apply and kraft_predicates; 8c. PROPERTY
     ReconfigurationCompletes at MaxElections 0: AddRemove's graph card
     against CPU, JointConsensus' held to the port's CPU run, each through
     its family's guard, apply and predicates (P and Q);
  7g. simulate Raft.cfg with --net-faults the same way (NF_SIM_MOVES
     moves), the card against the CPU at the two-server constants;
  9. fleet sweeps through run_sweep (the sweep CLI's function) on the
     card: Raft.cfg's constants at MaxElections {1, 2} exhausted (one packed
     group; the MaxElections-2 job at Raft.cfg's pinned counts), the PullRaft
     stand-in at MaxElections {1, 2} (its MaxElections-2 job at the
     reference's counts), Raft.cfg's at MaxElections {1, 2} x MaxRestarts
     {0, 1} and a KRaft.cfg job to SWEEP_DEPTH (every job equal to a serial
     card run of its constants), and manifests/kraft_reconfig_sim.json's
     simulate group through sweep_main; one model per group, the families'
     kernels and no plain expand;
  10. the kernel table as one JSON line (each kernel, owner_route's row
     with 4j's launches, the network-fault
     and fleet-lane rows of the Raft and pull guards and applies, and the
     five-server reconfiguration rows of canon_tiered and
     canon_signatures), the card's name and power limit, and the result
     line.
"""

from __future__ import annotations

import itertools
import json
import math
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

# the reconfiguration specs (phases 3, 4e, 4f, 6, 7d, 7e, 8c): the
# reference cfgs' four servers (SURVEY.md:91-92) with stand-ins for the
# constants the repo does not hold (Value = {v1}, MaxElections 1,
# MaxRestarts 0, MaxValuesPerTerm 1: JointConsensus.cfg's bounds), the
# three invariants, 112 message slots (the registry's default). AddRemove's
# MaxClusterSize is absent, as in the reference cfg: the lenient parse
# repairs it to |Server| = 4
ADDREMOVE_CFG = """\
\\* standard-raft/RaftWithReconfigAddRemove.cfg
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    n4 = n4
    v1 = v1
    Server = { n1, n2, n3, n4 }
    Value = { v1 }
    InitClusterSize = 3
    MinClusterSize = 2
    MaxAddReconfigs = 1
    MaxRemoveReconfigs = 1
    IncludeThesisBug = FALSE
    MaxElections = 1
    MaxRestarts = 0
    MaxValuesPerTerm = 1
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
    MaxOneReconfigurationAtATime
"""
JOINT_CFG = ADDREMOVE_CFG.replace(
    "RaftWithReconfigAddRemove.cfg", "RaftWithReconfigJointConsensus.cfg").replace(
    "    MinClusterSize = 2\n    MaxAddReconfigs = 1\n    MaxRemoveReconfigs = 1\n"
    "    IncludeThesisBug = FALSE\n", "    MaxReconfigs = 2\n    ReconfigType = 2\n")


def _three_servers(text: str) -> str:
    """A four-server reconfiguration cfg at three servers, two of them in
    the initial cluster."""
    return text.replace("    n4 = n4\n", "").replace(
        "{ n1, n2, n3, n4 }", "{ n1, n2, n3 }").replace(
        "InitClusterSize = 3", "InitClusterSize = 2")


# the card-against-CPU runs at the reference tests' three-server constants
# (tests/test_reconfig_add_remove.py:41-45: MaxClusterSize repaired to 3;
# tests/test_reconfig_joint.py:35-38: MaxReconfigs 1)
ADDREMOVE_SMALL_CFG = _three_servers(ADDREMOVE_CFG)
JOINT_SMALL_CFG = _three_servers(JOINT_CFG).replace("MaxReconfigs = 2", "MaxReconfigs = 1")
CONFIG_SMALL_DEPTH = 4
# the liveness runs (phase 8c): PROPERTY ReconfigurationCompletes at
# MaxElections 0 (tests/test_liveness_families.py:71-75 and :95-99)
ADDREMOVE_LIVE_CFG = ADDREMOVE_SMALL_CFG.replace("MaxElections = 1", "MaxElections = 0").replace(
    "MaxRemoveReconfigs = 1", "MaxRemoveReconfigs = 0") + "PROPERTY\n    ReconfigurationCompletes\n"
JOINT_LIVE_CFG = JOINT_SMALL_CFG.replace("MaxElections = 1", "MaxElections = 0").replace(
    "ReconfigType = 2", "ReconfigType = 3") + "PROPERTY\n    ReconfigurationCompletes\n"
# the port's CPU run of JOINT_LIVE_CFG (scripts/pin_reconfig_liveness.py:
# msg_slots 40, chunk 256, 2,938 s on 8 cores): the JAX checker cannot
# build this graph (tests/test_liveness_families.py:82-91), and the port's
# checker equals the JAX one on AddRemove's (tests/test_torch_reconfig_bfs.py)
JOINT_LIVE_PIN = dict(states=3_141_844, edges=5_873_605, holds=True)
# the reference's dense DeviceBFS on the four-server cfgs
# (scripts/pin_reconfig_counts.py): AddRemove through depth 17 (the oracle's
# depths 0-7: 1, 6, 27, 91, 251, 602, 1294, 2558), JointConsensus through
# depth 14 (1, 5, 24, 90, 271, 711, 1679, 3712); neither exhausts
RECONFIG_PIN = dict(
    depth_counts=[1, 6, 27, 91, 251, 602, 1294, 2558, 4790, 8633, 15210, 26257, 44664, 76025,
                  131746, 234259, 424063, 770466],
    distinct=1_740_943, total=4_506_928, terminal=1_399, exhausted=False,
    coverage=[[0, 0, 0], [644837, 1171904, 398812], [79877, 177232, 27064], [27580, 27580, 17318],
              [441473, 534410, 210495], [223741, 250225, 128920], [140260, 147788, 20173],
              [81919, 81920, 28802], [350894, 462959, 120891], [437910, 526175, 336471],
              [308526, 352201, 233418], [249856, 286265, 121321], [27207, 35403, 10212],
              [61157, 227577, 52391], [77445, 77492, 14373], [72183, 72195, 7214],
              [43635, 43637, 5416], [31964, 31964, 7651]],
)
JOINT_PIN = dict(
    depth_counts=[1, 5, 24, 90, 271, 711, 1679, 3712, 8030, 17777, 40720, 93539, 207150, 433257,
                  855483],
    distinct=1_662_449, total=4_747_116, terminal=88, exhausted=False,
    coverage=[[0, 0, 0], [611787, 1193308, 295840], [29395, 68287, 10132], [15721, 15721, 10310],
              [312857, 357511, 125524], [101322, 112850, 62066], [207333, 280483, 39314],
              [34619, 34619, 14856], [499821, 795051, 129158], [419004, 516092, 387860],
              [297878, 326098, 250811], [202970, 222946, 110379], [66867, 205395, 67378],
              [36368, 36368, 10011], [353691, 410704, 98659], [123905, 123905, 35019],
              [47759, 47777, 15131]],
)
# the card's runs. AddRemove breaks LeaderHasAllAckedValues at depth 21
# (RECONFIG_VIOLATION: ResetWithSameIdentity empties a voter's log, and a
# server without the acked value is elected by the old configuration's
# quorum; the reference's model takes the same 21 steps,
# tests/test_torch_reconfig_bfs.py), where BFS stops; JointConsensus runs to
# depth 18, the deepest its frontier fits in 80 GB (depth 19's, some 16 M
# rows of 4,168 bytes held twice, would not). The frontier buffers grow x4
# to their caps and are held twice: 12,582,912 rows of 2,940 bytes and
# 9,502,720 of 4,168 (70.7 and 75.9 GiB at peak). Also the sample depths
# of phase 3 (a wide wave) and the simulate's moves
RECONFIG_DEPTH = 21
RECONFIG_VIOLATION = ("LeaderHasAllAckedValues", 21)
JOINT_DEPTH = 18
RECONFIG_SAMPLE_DEPTH = 11
JOINT_SAMPLE_DEPTH = 10
RECONFIG_CAPS = dict(max_frontier_cap=12_582_912, max_seen_cap=1 << 26, max_journal_cap=1 << 26)
JOINT_CAPS = dict(RECONFIG_CAPS, max_frontier_cap=9_502_720)
CONFIG_SIM_MOVES = 100
CONFIG_SMALL_SIM = (64, 20)  # the card-against-CPU simulate: walks, moves

# the reconfiguration specs at five servers (phases 3, 4i): the four-server
# cfgs with n5 added (five voters, the usual production size of a Raft
# cluster; the reference cfgs stop at four, SURVEY.md:91-92, so these stand
# in as five-server Raft does). AddRemove's MaxClusterSize is repaired to
# |Server| = 5 as the four-server cfg's is, and MaxAddReconfigs is 2 so the
# three-member cluster can grow to all five servers. 112 message slots (W =
# 929, view 922, A = 232, 5-word keys, 15 remap fields; JointConsensus W =
# 1,227, view 1,221, A = 307, 7-word keys, 24 fields): canon_tiered's
# general path
def _five_servers(text: str) -> str:
    return text.replace("    n4 = n4\n", "    n4 = n4\n    n5 = n5\n").replace(
        "{ n1, n2, n3, n4 }", "{ n1, n2, n3, n4, n5 }")


ADDREMOVE5_CFG = _five_servers(ADDREMOVE_CFG).replace("MaxAddReconfigs = 1", "MaxAddReconfigs = 2")
JOINT5_CFG = _five_servers(JOINT_CFG)
# the reference's dense DeviceBFS on both (scripts/pin_reconfig_counts.py
# --servers 5 [--joint] --budget 600: AddRemove through depth 13 in 878.2 s,
# JointConsensus through depth 11 in 787.8 s, on 8 CPU cores; neither
# exhausts)
ADDREMOVE5_PIN = dict(
    depth_counts=[1, 6, 27, 91, 251, 602, 1294, 2558, 4790, 8634, 15221, 26339, 45132, 78190],
    distinct=183_136, total=458_294, terminal=81, exhausted=False,
    coverage=[[0, 0, 0], [68123, 114887, 39193], [9736, 20016, 2877], [5376, 5376, 3419],
              [45366, 53874, 22051], [25193, 27850, 14778], [18025, 19948, 3958],
              [4831, 4831, 2199], [37512, 50889, 14995], [44306, 52044, 36684],
              [27309, 29979, 22160], [23583, 26502, 11050], [6020, 12619, 2253],
              [4388, 14116, 3407], [11239, 11390, 2339], [7973, 7973, 790], [4500, 4500, 536],
              [1499, 1499, 446]],
)
JOINT5_PIN = dict(
    depth_counts=[1, 5, 24, 90, 271, 711, 1679, 3730, 8300, 19721, 49897, 125912],
    distinct=210_341, total=511_224, terminal=4, exhausted=False,
    coverage=[[0, 0, 0], [66911, 120315, 43603], [5960, 13237, 2081], [2873, 2873, 1994],
              [30965, 36319, 16906], [13564, 14691, 8690], [26044, 36271, 8202],
              [3108, 3108, 1307], [48373, 90296, 19537], [36182, 41363, 35091],
              [25031, 27089, 21956], [15299, 16674, 7439], [7543, 47808, 20031],
              [2548, 2548, 1000], [35669, 46109, 20241], [8685, 8685, 1763], [3837, 3837, 499]],
)
# the card's runs: AddRemove to ADDREMOVE5_DEPTH (4i), the deepest that fits
# 80 GB: depth 20 is 14,318,640 distinct in about 9 s, its 6,742,993-row
# frontier of 3,716 bytes held twice in buffers of ADDREMOVE5_CAPS's 9 x 2^20
# rows; depth 21's (about 12.6 M rows) would not fit. Phase 3's sample
# depths (wide waves: 140,061 and 299,270 states); JointConsensus card
# against CPU to JOINT5_SMALL_DEPTH (chunk 256); the collision audit's depth
ADDREMOVE5_DEPTH = 20
ADDREMOVE5_SAMPLE_DEPTH = 14
JOINT5_SAMPLE_DEPTH = 12
ADDREMOVE5_CAPS = dict(max_frontier_cap=9_437_184, max_seen_cap=1 << 26, max_journal_cap=1 << 26)
JOINT5_SMALL_DEPTH = 5
AUDIT5_DEPTH = 10
AUDIT_SEED = 0x5EED5EED  # the collision audit's second hash family

# KRaftWithReconfig (phases 3, 4g, 6, 7f, 8d): the reference cfg's constants
# as SURVEY.md:96 records them (its Value = {v1, v2} names the undeclared v2,
# which the lenient parse declares), with MaxElections 2 (KRaft.cfg's,
# SURVEY.md:95) standing in for the value the repo does not record;
# SYMMETRY symmHostsAndValues, the cfg's five invariants, 40 message slots
# (the registry's default): NS = 5 identity slots, W = 479, A = 145, 3-word
# keys, 12 (sigma, tau) canon pairs
KRAFT_RECONFIG_CFG = """\
\\* pull-raft/KRaftWithReconfig.cfg
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Hosts = { n1, n2, n3 }
    Value = { v1, v2 }
    InitClusterSize = 3
    MinClusterSize = 2
    MaxClusterSize = 4
    MaxSpawnedServers = 5
    MaxElections = 2
    MaxRestarts = 1
    MaxValuesPerEpoch = 1
    MaxAddReconfigs = 1
    MaxRemoveReconfigs = 1
INIT Init
NEXT Next
VIEW view
SYMMETRY symmHostsAndValues
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
    NeverTwoLeadersInSameEpoch
    NoIllegalState
    StatesMatchRoles
"""
# the card-against-CPU runs: manifests/kraft_reconfig_sim.json's constants
# (the reference tests' SMALLP, tests/test_kraft_reconfig.py:199-204)
KRECONFIG_SMALL_CFG = KRAFT_RECONFIG_CFG.replace("Value = { v1, v2 }", "Value = { v1 }").replace(
    "InitClusterSize = 3", "InitClusterSize = 2").replace(
    "MaxClusterSize = 4", "MaxClusterSize = 3").replace(
    "MaxSpawnedServers = 5", "MaxSpawnedServers = 4").replace(
    "MaxElections = 2", "MaxElections = 1")
KRECONFIG_SMALL_DEPTH = 4
# the liveness universe of tests/test_liveness_families.py:151-156 (428
# states) with both of the spec's properties (phase 8d)
KRECONFIG_LIVE_CFG = KRECONFIG_SMALL_CFG.replace("    n3 = n3\n", "").replace(
    "{ n1, n2, n3 }", "{ n1, n2 }").replace("MaxClusterSize = 3", "MaxClusterSize = 2").replace(
    "MaxRestarts = 1", "MaxRestarts = 0").replace(
    "MaxSpawnedServers = 4", "MaxSpawnedServers = 2") + (
    "PROPERTY\n    ValuesNotStuck\n    ReconfigurationNotStuck\n")
KRECONFIG_LIVE_PIN = dict(states=428, edges=544)  # the reference's LivenessChecker
# the reference's dense DeviceBFS of KRAFT_RECONFIG_CFG through depth 8
# (scripts/pin_kraft_reconfig_counts.py; the space does not exhaust)
KRECONFIG_PIN = dict(
    depth_counts=[1, 9, 65, 406, 2119, 9401, 37413, 139080, 490500],
    distinct=678_994, total=1_774_806, terminal=0, exhausted=False,
    coverage=[[45417, 197426, 37258], [123297, 235360, 15798], [137590, 294941, 184433],
              [74285, 91413, 69947], [7616, 7616, 6153], [74596, 152461, 17659],
              [147641, 220517, 113073], [4, 4, 4], [46369, 52724, 50257],
              [2863, 2863, 2732], [5363, 9407, 8134], [107125, 153303, 27140],
              [17682, 18247, 14991], [0, 0, 0], [57107, 61972, 52657],
              [40415, 125040, 29371], [15635, 15740, 13834], [1601, 1601, 1583],
              [300, 300, 297], [31, 31, 31], [44613, 133839, 33641]],
)
# the card's BFS depth (4g): depth 11, 23,965,041 distinct in about 10 s,
# its frontier 16,335,799 rows of 1,916 bytes held twice (depth 12's, about
# 3x that, would not fit 80 GB); the frontier cap a power of two above it.
# Phase 3 samples the same, widest, wave; the simulate's moves (7f; the
# card-against-CPU run takes the manifest's 128 walks)
KRECONFIG_DEPTH = 11
KRECONFIG_SAMPLE_DEPTH = 11
KRECONFIG_CAPS = dict(max_frontier_cap=1 << 24, max_seen_cap=1 << 26, max_journal_cap=1 << 26)
KRECONFIG_SIM_MOVES = 100
KRECONFIG_SMALL_SIM = (128, 20)

# --net-faults (phases 3, 4h, 6, 7g): Raft.cfg with DuplicateMessage and
# DropMessage (Raft.tla:508-523, at most max_msg_copies = 2 copies of a
# record), msg_slots 48 (W = 192, A = 69 + 2 * 48 = 165). The reference's
# dense DeviceBFS through depth 15 (scripts/pin_net_faults_counts.py: 657.7 s
# on 8 CPU cores; the space does not exhaust on the CPU; ranks 12 and 13 of
# the coverage are the two fault actions)
NF_PIN = dict(
    depth_counts=[1, 1, 5, 22, 92, 310, 904, 2297, 5481, 12584, 28903, 67769, 163195, 398099,
                  968953, 2329619],
    distinct=3_978_235, total=20_966_486, terminal=148, exhausted=False,
    coverage=[[0, 0, 0], [39552, 79700, 3751], [169165, 173561, 29180],
              [554408, 558023, 34409], [27387, 27387, 8795], [722340, 878918, 82041],
              [907938, 1886574, 33460], [1411546, 2633618, 141578], [1081069, 1532433, 97990],
              [227201, 248510, 35087], [464951, 528912, 96774], [315846, 327277, 85373],
              [1608177, 5002599, 991413], [1646871, 7088973, 2338383]],
)
# the card's BFS depth (4h), the deepest that fits 80 GB: depth 18,
# 51,989,664 distinct in about 7 s and 50 GiB (its 29,628,803-row frontier of
# 768-byte rows, in buffers of 2^25 rows held twice); depth 19 would pass the
# 2^26-lane seen run and add a frontier of some 69 M rows. With the
# capacities it needs; phase 3's sample depth; the
# card-against-CPU runs at tests/test_net_faults.py:18-21's constants (two
# servers, MaxElections 1, 12 message slots) to NF_SMALL_DEPTH (628 states)
# and for SMALL_WALKS walks over SMALL_MOVES moves; the simulate's moves
NF_DEPTH = 18
NF_CAPS = dict(max_frontier_cap=1 << 25, max_seen_cap=1 << 26, max_journal_cap=1 << 26)
NF_SAMPLE_DEPTH = 12
NF_SMALL_CFG = RAFT_CFG.replace("    n3 = n3\n", "").replace(
    "Server = { n1, n2, n3 }", "Server = { n1, n2 }").replace(
    "MaxElections = 2", "MaxElections = 1")
NF_SMALL_DEPTH = 12
NF_SIM_MOVES = 100

# the sweep (phase 9): fleet manifests run by ``run_sweep`` on the card,
# DeviceBFS's queue arm. (a) Raft.cfg's constants with MaxElections {1, 2},
# exhausted: one packed group whose MaxElections-2 job is Raft.cfg itself
# (EXHAUSTED); (b) the PullRaft stand-in's (PULL_CFG) with MaxElections
# {1, 2}: its MaxElections-2 job is PULL_PIN; (c) Raft.cfg's with
# MaxElections {1, 2} x MaxRestarts {0, 1} to SWEEP_DEPTH, each job equal
# to a serial card run of its own constants, and a KRaft.cfg job (a serial
# group); (d) manifests/kraft_reconfig_sim.json as it stands (a simulate
# group) through the sweep CLI
SWEEP_DEPTH = 16


def sweep_manifest(text: str, spec: str, grid: dict, slots: int, jobs=()) -> dict:
    """A fleet manifest with a cfg text's constants and invariants as its
    defaults, ``grid`` over them, and extra explicit ``jobs``."""
    from raft_tpu_torch.utils.cfg import ModelValue, parse_cfg

    cfg = parse_cfg(f"{spec}.cfg", text=text, lenient=True)
    consts = {k: ([x.name for x in v] if isinstance(v, tuple) else v)
              for k, v in cfg.constants.items()
              if not isinstance(v, ModelValue)}  # declarations (n1 = n1) are implied
    return {"spec": spec, "defaults": {"constants": consts, "invariants": cfg.invariants,
                                       "msg_slots": slots},
            "grid": grid, "jobs": list(jobs)}


# (distinct, total, depth, terminal) of Raft.cfg: exhausted, and at depth
# 20 (the sample and trace runs), pinned from the reference's dense path
EXHAUSTED = (8_664_032, 30_708_266, 48, 19_514)
DEPTH20 = (250_016, 719_677, 20, 20)

# the sharded engine (phase 4j): Raft.cfg at D = 1 over NCCL with the
# capacities of DeviceBFS's defaults (so both engines run the same
# geometry); a checkpoint at SHARD_CKPT_DEPTH resumed on the card; two-
# server Raft (SHARD_SMALL_CFG) checkpointed on the card at D = 1 at
# SHARD_SMALL_DEPTH and resumed on the CPU at D = 2 (gloo)
SHARD_CAPS = dict(frontier_cap=1 << 18, seen_cap=1 << 22, journal_cap=1 << 22,
                  max_frontier_cap=1 << 22, max_seen_cap=1 << 25, max_journal_cap=1 << 25)
SHARD_CKPT_DEPTH = 10
SHARD_SMALL_CFG = RAFT_CFG.replace("    n3 = n3\n", "").replace(
    "Server = { n1, n2, n3 }", "Server = { n1, n2 }")
SHARD_SMALL_DEPTH = 8

MEM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
# H100 SXM 32-bit integer ops/s: 64 INT32 lanes per SM, half the 128 FP32
# lanes behind the 67 TFLOP/s float32 rate (an upper rate, so a lower bound)
INT32_OPS = 33.5e12
CHUNK = 4096
# the most frontier rows phase 3 copies to the host from one sampled wave
POOL_ROWS = 1 << 21
# device kernel names of each hand-written kernel (csrc/*.cu)
KERNEL_NAMES = {
    "canon_memo": ("canon_memo_kernel", "memo_insert_kernel"),
    "chunk_dedup": ("cd_count", "cd_scatter", "cd_sort_probe"),
    "compact_append": ("ct_count", "ct_scan", "ct_scatter", "ct_fill", "append_rows_kernel"),
    "merge_runs": ("merge_runs_kernel",),
    # raft_nf_*: the same kernels built with the network-fault groups
    "raft_guard": ("raft_guard_kernel", "raft_nf_guard_kernel"),
    "raft_apply": ("raft_apply_kernel", "raft_nf_apply_kernel"),
    "raft_fold": ("raft_fold_lanes", "raft_fold_viol"),
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
    "slot_canon": ("slot_canon_kernel",),
    "owner_route": ("or_hist", "or_scan", "or_rank", "or_fill"),
    **{f"{fam}_{role}": names for fam in ("reconfig", "joint", "kreconfig") for role, names in (
        ("guard", (f"{fam}_guard_kernel",)), ("apply", (f"{fam}_apply_kernel",)),
        ("fold", (f"{fam}_fold_lanes", f"{fam}_fold_viol")),
        ("predicates", (f"{fam}_predicates_kernel",)),
        ("sim_check", (f"{fam}_sim_check_kernel",)))},
}
# the kernels each path launches (canon_signatures serves the checks only)
RAFT3_PATH = ("canon_memo", "chunk_dedup", "compact_append", "merge_runs", "raft_guard",
              "raft_apply", "raft_fold")
RAFT5_PATH = tuple(k if k != "canon_memo" else "canon_tiered" for k in RAFT3_PATH)
SHARDED_PATH = RAFT3_PATH + ("owner_route",)
PULL_PATH = tuple(k.replace("raft_", "pull_") for k in RAFT3_PATH)
KRAFT_PATH = tuple(k.replace("raft_", "kraft_") for k in RAFT3_PATH)
RECONFIG_PATH = tuple(k.replace("raft_", "reconfig_") for k in RAFT3_PATH)
JOINT_PATH = tuple(k.replace("raft_", "joint_") for k in RAFT3_PATH)
RECONFIG5_PATH = tuple(k if k != "canon_memo" else "canon_tiered" for k in RECONFIG_PATH)
JOINT5_PATH = tuple(k if k != "canon_memo" else "canon_tiered" for k in JOINT_PATH)
KRECONFIG_PATH = ("slot_canon",) + tuple(k.replace("raft_", "kreconfig_")
                                         for k in RAFT3_PATH[1:])
# state fields the invariants of the cfgs here read (NoLogDivergence,
# LeaderHasAllAckedValues; KRaft.cfg's also NeverTwoLeadersInSameEpoch and
# NoIllegalState): the part of a row a family's fold must load
INVARIANT_FIELDS = ("currentTerm", "state", "log_term", "log_value", "commitIndex", "acked")
FOLD_FIELDS = {"raft": INVARIANT_FIELDS, "pull": INVARIANT_FIELDS,
               "kraft": ("currentEpoch", "state", "leader", "log_epoch", "log_value",
                         "highWatermark", "acked")}
for _fam, _extra in (("reconfig", ("cmem", "cmembers")), ("joint", ("old", "new", "members"))):
    FOLD_FIELDS[_fam] = ("currentTerm", "state", "commitIndex", "log_len", "acked") + tuple(
        f"log_{n}" for n in ("term", "cmd", "val", "cid") + _extra)
FOLD_FIELDS["kreconfig"] = ("used", "state", "role", "leader", "currentEpoch", "highWatermark",
                            "acked") + tuple(f"log_{n}" for n in (
                                "cmd", "epoch", "val", "cfgid", "who", "members"))
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
# the reconfiguration specs: each its own family (AddRemove's reconfig_*,
# JointConsensus' joint_* kernels), run to a depth, not exhausted, with the
# card against the CPU at three servers
RECONFIG_FAM = dict(prefix="reconfig", tag="4e", sim_tag="7d", cfg=ADDREMOVE_CFG, lenient=True,
                    specs=(("RaftWithReconfigAddRemove", RECONFIG_PIN, RECONFIG_SAMPLE_DEPTH),),
                    small=("RaftWithReconfigAddRemove", CONFIG_SMALL_DEPTH),
                    small_cfg=ADDREMOVE_SMALL_CFG, path=RECONFIG_PATH, depth=RECONFIG_DEPTH,
                    caps=RECONFIG_CAPS, second_chunk=CHUNK // 2, sim_moves=CONFIG_SIM_MOVES,
                    small_sim=CONFIG_SMALL_SIM, violation=RECONFIG_VIOLATION,
                    five_cfg=ADDREMOVE5_CFG, five_depth=ADDREMOVE5_SAMPLE_DEPTH,
                    five_tag="addremove5", memo_tag="addremove4")
JOINT_FAM = dict(RECONFIG_FAM, prefix="joint", tag="4f", sim_tag="7e", cfg=JOINT_CFG,
                 specs=(("RaftWithReconfigJointConsensus", JOINT_PIN, JOINT_SAMPLE_DEPTH),),
                 small=("RaftWithReconfigJointConsensus", CONFIG_SMALL_DEPTH),
                 small_cfg=JOINT_SMALL_CFG, path=JOINT_PATH, depth=JOINT_DEPTH, caps=JOINT_CAPS,
                 violation=None, five_cfg=JOINT5_CFG, five_depth=JOINT5_SAMPLE_DEPTH,
                 five_tag="joint5", memo_tag="joint4")
# five-server AddRemove on the main path (4i): to a depth, its depth counts
# held to the pin, no second chunk here (the parity gate runs it at the
# pinned depth) and no card-against-CPU run of its own (five-server
# JointConsensus takes that, five_reconfig_phase)
ADDREMOVE5_FAM = dict({k: v for k, v in RECONFIG_FAM.items()
                       if not k.startswith(("small", "five", "second", "memo"))},
                      tag="4i", cfg=ADDREMOVE5_CFG,
                      specs=(("RaftWithReconfigAddRemove", ADDREMOVE5_PIN,
                              ADDREMOVE5_SAMPLE_DEPTH),),
                      path=RECONFIG5_PATH, depth=ADDREMOVE5_DEPTH, caps=ADDREMOVE5_CAPS,
                      violation=None)
# KRaftWithReconfig: its own family (kreconfig_* and the slot canon), run to a
# depth, with the card against the CPU at the SMALLP constants, symmetry on
# and off
KRECONFIG_FAM = dict(prefix="kreconfig", tag="4g", sim_tag="7f", cfg=KRAFT_RECONFIG_CFG,
                     lenient=True,
                     specs=(("KRaftWithReconfig", KRECONFIG_PIN, KRECONFIG_SAMPLE_DEPTH),),
                     small=("KRaftWithReconfig", KRECONFIG_SMALL_DEPTH),
                     small_cfg=KRECONFIG_SMALL_CFG, small_nosym=True, path=KRECONFIG_PATH,
                     depth=KRECONFIG_DEPTH, caps=KRECONFIG_CAPS, second_chunk=CHUNK // 2,
                     sim_moves=KRECONFIG_SIM_MOVES, small_sim=KRECONFIG_SMALL_SIM, violation=None)
# Raft.cfg with --net-faults: the Raft family's kernels on the main path to
# NF_DEPTH, both fault actions fired, again at twice the chunk, card against
# CPU at the two-server constants
NF_FAM = dict(prefix="raft", tag="4h", sim_tag="7g", cfg=RAFT_CFG, lenient=False, net_faults=True,
              specs=(("Raft", NF_PIN, NF_SAMPLE_DEPTH),), small=("Raft", NF_SMALL_DEPTH),
              small_cfg=NF_SMALL_CFG, small_slots=12, path=RAFT3_PATH, depth=NF_DEPTH,
              caps=NF_CAPS, second_chunk=2 * CHUNK, sim_moves=NF_SIM_MOVES, violation=None,
              must_fire=("DuplicateMessage", "DropMessage"))
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
    """Replays a lower-bound search of each query in each run in turn (the
    early exit at the first hit included) with torch ops on the queries'
    device: returns
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


def key_words(model) -> int:
    """The words of a message key: a WidePacker family's n_words; Raft,
    KRaft and the pull family pack theirs in two (hi, lo)."""
    return getattr(model, "n_words", 2)


def expand_puts(torch, model, batch, valid, rank):
    """The message puts the valid lanes of a [C, A] guard grid over the
    [C, W] rows ``batch`` make, counted from the data: RequestVote makes
    S - 1 (its chain), RequestVotePair, AppendEntries and
    SendPullEntriesRequest and SendFetchRequest one, a BecomeLeader of the
    pull family one per peer it notifies (every peer in Variant2, the peers
    that did not vote for it in PullRaft), KRaft's BecomeLeader S - 1, a
    reconfiguration spec's RequestVote one per other member and its
    SendSnapshot one, and a message whose receipt replies one."""
    S, dev = model.p.n_servers, valid.device
    names = [b[0] for b in model.bindings]
    mask = lambda groups: torch.tensor([n in groups for n in names], device=dev)  # noqa: E731
    puts = (valid & mask(("RequestVote",))).sum() * (S - 1)
    puts = puts + (valid & mask(("RequestVotePair", "AppendEntries",
                                 "SendPullEntriesRequest"))).sum()
    fam = family_of(model)
    if fam == "kreconfig":
        from raft_tpu_torch.models import kraft_reconfig as kr

        # RequestVote and BecomeLeader put one request per other member of
        # the sender's config; SendFetchRequest, StartNewServer and
        # SendJoinRequest one each
        members = model.layout.get(batch, "cfg_members")  # [C, NS]
        sizes = ((members.unsqueeze(-1) >> torch.arange(S, device=dev)) & 1).sum(-1)
        puts = (valid & mask(("SendFetchRequest", "StartNewServer", "SendJoinRequest"))).sum()
        for group in ("RequestVote", "BecomeLeader"):
            off = names.index(group)
            puts = puts + (valid[:, off:off + S] * (sizes - 1).clamp(min=0)).sum()
        replies = (kr.KR_HANDLE_RVREQ, kr.KR_REJECT_FETCH, kr.KR_DIVERGING_FETCH,
                   kr.KR_ACCEPT_FETCH_VOTER, kr.KR_ACCEPT_FETCH_OBSERVER, kr.KR_ACCEPT_JOIN,
                   kr.KR_REJECT_JOIN)
    elif fam in ("reconfig", "joint"):
        from raft_tpu_torch.models import config_common as cc

        # RequestVote puts one request per member but itself: recount
        members = model.layout.get(batch, "config_members")  # [C, S]
        sizes = ((members.unsqueeze(-1) >> torch.arange(S, device=dev)) & 1).sum(-1)
        off = names.index("RequestVote")
        puts = (valid[:, off:off + S] * (sizes - 1).clamp(min=0)).sum() + (
            valid & mask(("AppendEntries", "SendSnapshot"))).sum()
        replies = (cc.R_HANDLE_RVREQ, cc.R_REJECT_AE, cc.R_ACCEPT_AE, cc.R_HANDLE_SNAPREQ)
    elif fam == "raft":
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
    from raft_tpu_torch.ops.expand import (
        apply, apply_occupancy, apply_plain, fold, fold_plain, guard, guard_occupancy,
        guard_plain,
    )
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
    fps, _ = bfs._st_canon(flatc, sel < C * A, memo)
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
    occ = guard_occupancy(model)
    if occ is not None:
        # the group guard (csrc/expand_driver.cuh EXPAND_KERNELS_GROUP): its
        # launch shape, and its bound recounted with the operations counted
        # per key word, 3 a bag slot and key word of each put
        guard_ops = 3 * M * key_words(model) * int(puts)
        b, by = bound(guard_bytes, guard_ops)
        rows[f"{fam}_guard"].update(bound_ms=b, bound_by=by, bytes=guard_bytes,
                                    operations=guard_ops, per="state", **occ)
    occ = apply_occupancy(model)
    if occ is not None:
        # a group apply (csrc/expand_driver.cuh EXPAND_KERNELS_GROUP_APPLY):
        # its launch shape, and its bound recounted with the operations
        # beside the bytes, 3 a bag slot and key word of each put the
        # worklist's lanes make (the guard's puts: sel holds every valid lane)
        apply_ops = 3 * M * key_words(model) * int(puts)
        b, by = bound(apply_bytes, apply_ops)
        rows[f"{fam}_apply"].update(bound_ms=b, bound_by=by, bytes=apply_bytes,
                                    operations=apply_ops, **occ)
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
    apply) and their canonical fingerprints (a fresh 2^21-row memo)."""
    from raft_tpu_torch.ops.hashing import INT64_MAX

    dev = bfs.device
    batch = torch.from_numpy(np.ascontiguousarray(pool[rng.integers(0, len(pool), CHUNK)])).to(dev)
    cov = torch.zeros((len(bfs.model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    ex = bfs._st_expand(batch, 0, CHUNK, cov)
    flatc, selv = ex[0], ex[2]
    check(not bool(ex[8]), "the sampled chunk overflows its worklist")
    memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    fps, _ = bfs._st_canon(flatc, selv, memo)
    return flatc, selv, fps


def chunk_dedup_row(torch, fps, runs, run_len, timed: bool) -> dict:
    """chunk_dedup against its plain version (the probe and the two
    torch.sort calls it replaces) on one chunk and its runs, exactly, with
    and without the order. With ``timed`` also: its run against the
    replayed lower-bound searches of the chunk's distinct real keys; the
    CUDA-event times of the kernel, the plain version and the library sum
    (torch.sort, stable, with the index, plus torch.searchsorted of every
    lane on each run) with each part; the wrapper's host time a call
    (Python only, no sync, 50 calls); the CUDA launches of one call (a
    profile's kernels); and the bound: the keys (8 B) read once, new (1 B)
    and the run (8 B) written once, plus the 32-byte run sectors those
    searches read (bytes) or ~6 integer operations a search step."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.checker.util import chunk_dedup, chunk_dedup_plain
    from raft_tpu_torch.ops.hashing import INT64_MAX

    nk, rk = chunk_dedup(fps, runs, run_len)
    nko, rko, ok = chunk_dedup(fps, runs, run_len, with_order=True)
    np_, rp, op = chunk_dedup_plain(fps, runs, run_len, with_order=True)
    err = max(exact(torch, a, b) for a, b in ((nk, np_), (rk, rp), (nko, np_), (rko, rp),
                                              (ok, op)))
    check(err == 0.0, "chunk_dedup differs from its plain version")
    n, n_new = fps.numel(), int(nk.sum())
    distinct = torch.unique(fps[fps != INT64_MAX])
    print(f"[3] chunk_dedup exact on {n} lanes against {len(runs)} runs ({n_new} new, "
          f"{distinct.numel()} distinct real keys, "
          f"{int((fps == INT64_MAX).sum())} at the sentinel)")
    if not timed:
        return {}
    fresh, sectors, steps = probe_sectors(torch, distinct, runs, INT64_MAX)
    check(torch.equal(rk[:n_new], distinct[fresh]),
          "chunk_dedup's run differs from the replayed searches")
    nbytes = n * 8 + n + run_len * 8 + sectors * 32
    ops = 6 * steps
    parts = {"sort": lambda: torch.sort(fps, stable=True)}
    for i, r in enumerate(runs):
        parts[f"searchsorted_run{i}"] = lambda r=r: torch.searchsorted(r, fps)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(50):
        chunk_dedup(fps, runs, run_len)
    host_us = (time.perf_counter() - t) / 50 * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk_dedup(fps, runs, run_len)
        torch.cuda.synchronize()
    cuda = [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    return dict(
        ms=time_ms(torch, lambda: chunk_dedup(fps, runs, run_len), iters=50),
        plain_ms=time_ms(torch, lambda: chunk_dedup_plain(fps, runs, run_len), iters=50),
        library_ms=time_ms(torch, lambda: [f() for f in parts.values()], iters=50),
        library_parts_ms={k: time_ms(torch, f, iters=50) for k, f in parts.items()},
        bound_ms=max(nbytes / MEM_BPS, ops / INT32_OPS) * 1e3,
        bound_by="operations" if ops / INT32_OPS > nbytes / MEM_BPS else "bytes",
        max_abs_err=err, lanes=n, runs=len(runs), new=n_new, distinct=distinct.numel(),
        sectors=sectors, steps=steps, host_us_a_call=host_us,
        launches_a_call=(sum(any(k in nm for k in KERNEL_NAMES["chunk_dedup"]) for nm in cuda)
                         if cuda else "not measured: the tracer saw no device activity"))


def owner_route_rows(torch, bfs, pool, rng) -> dict:
    """owner_route against its plain version (the reference's routing in
    torch) on one chunk of the Raft.cfg main path (the depth-20 frontier's
    successor rows, their canonical fingerprints, the worklist and the
    guard's ranks), exactly, at D in {1, 2, 4, 8}: with the path's route
    cap (RC = VC, no overflow) and with one small enough that a block
    overflows at D = 8. Timed at D = 1, the main path's shape."""
    from raft_tpu_torch.ops.hashing import INT64_MAX
    from raft_tpu_torch.parallel.route import owner_route, owner_route_plain

    dev = bfs.device
    batch = torch.from_numpy(np.ascontiguousarray(pool[rng.integers(0, len(pool), CHUNK)])).to(dev)
    cov = torch.zeros((len(bfs.model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    ex = bfs._st_expand(batch, 0, CHUNK, cov)
    flatc, sel, selv, _valid, rank = ex[:5]
    memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    fps, _ = bfs._st_canon(flatc, selv, memo)
    VC, W = flatc.shape
    A = bfs.A
    n_valid = int(selv.sum())
    small = max(1, n_valid // 8 * 9 // 10)
    lgid0 = 123_456
    errs = []
    for D in (1, 2, 4, 8):
        for RC in (VC, small):
            got = owner_route(fps, flatc, sel, rank, lgid0, A, D, RC)
            want = owner_route_plain(fps, flatc, sel, rank, lgid0, A, D, RC)
            torch.cuda.synchronize()
            errs += [exact(torch, g, w) for g, w in zip(got, want)]
            ovf, routed = int(want[2][0]), int(want[2][1])
            if RC == VC:
                check(ovf == 0 and routed == n_valid, f"owner_route D={D}: {routed} of "
                      f"{n_valid} lanes routed, overflow bits {ovf}")
            elif D == 8:
                check(ovf == 4, f"owner_route D=8 RC={small}: no route overflow")
    check(max(errs) == 0.0, "owner_route differs from its plain version")
    print(f"[3] owner_route exact at D = 1, 2, 4, 8 on a Raft.cfg chunk ({n_valid} of {VC} lanes "
          f"valid; RC = {VC} and {small}, the latter overflowing)")
    # bytes: the VC fingerprints read, and of the routed (valid) lanes only
    # their rows of W words, sel and rank; the D * RC payload rows of W + 3
    # words and D * RC fingerprints written (unfilled slots too: the output
    # is zero-filled, as the reference's scatter is); ops: a u64 modulus and
    # the partition's counting (~40) a lane, an index computation a written
    # word
    D, RC = 1, VC
    bm, by = bound(VC * 8 + n_valid * (W * 4 + 8) + D * RC * (W + 3) * 4 + D * RC * 8,
                   VC * 40 + D * RC * (W + 3))
    return {"owner_route": dict(
        ms=time_ms(torch, lambda: owner_route(fps, flatc, sel, rank, lgid0, A, D, RC), iters=50),
        plain_ms=time_ms(torch, lambda: owner_route_plain(fps, flatc, sel, rank, lgid0, A, D, RC),
                         iters=10),
        library_ms=None, bound_ms=bm, bound_by=by, max_abs_err=max(errs), lanes=VC,
        valid=n_valid)}


def tier_pairs(torch, canon, states):
    """Per lane of ``states``, counted from its data: the fmix32 pairs of
    its signatures, of one hash of its view (the raw key, or one permuted
    hash: K non-bag lanes + NW + 1 streams per occupied slot, NW key words
    and the count) and the number of its admissible permutations. A
    signature round folds each record's server fields: one pair a plain or
    Nil-able field, one a member of a member set, and one more a field for
    its scatter; the record's hash (NW + 1 pairs) is counted each round."""
    S, R, h = canon.S, 3, canon._host
    M, NW = h["M"], len(h["stream_offs"])
    words = [states[:, o:o + M].to(torch.int64) for o in h["stream_offs"]]
    occ_m = words[0] != 1 << 30
    occ = occ_m.sum(1)
    gathers = torch.zeros_like(occ)
    for (_w, shift, mask, kind), k in zip(h["fields"], h["field_streams"]):
        val = (words[k] >> shift) & mask
        if kind == 2:  # server_bitmask: one pair a member below S
            val = val & ((1 << S) - 1)
            pop = sum((val >> q) & 1 for q in range(S))
        else:
            pop = torch.ones_like(val)
        gathers += torch.where(occ_m, pop, 0).sum(1)
    NF = len(h["fields"])
    kinds = [kind for kind, _off, _lanes in canon._sig_fields]
    ps_lanes = sum(len(lanes) for kind, _off, lanes in canon._sig_fields if kind == "per_server")
    n_val, n_bm, n_pair = (kinds.count(k) for k in
                           ("per_server_val", "server_bitmask", "per_server_pair"))
    per_state = (ps_lanes + S * kinds.count("per_server") + 2 * S * (n_val + n_bm)
                 + (S + 2 * S * (S - 1)) * n_pair + R * (S * n_val + S * S * n_bm
                                                         + 2 * S * S * n_pair + S))
    sig = per_state + occ * (NW + 1 + NF + R * (NW + 1 + NF)) + R * gathers
    ssig = canon.signatures_plain(states)[:, canon._tensors(states.device)["inv"]]
    n_adm = (ssig[..., 1:] >= ssig[..., :-1]).all(dim=-1).sum(1)
    return sig, canon._K + (NW + 1) * occ, n_adm


def tiered_rows(torch, canon, flatc, selv, timed: bool) -> dict:
    """canon_tiered (memo cold, then warm) and canon_signatures against
    their plain versions on one chunk's successor rows, exactly, and the
    occupancy canon_tiered's build reaches at this layout; with ``timed``
    their times and bounds (operations: ~12 integer ops per fmix32 of the
    two streams of every pair tier_pairs counts; bytes: the view lanes
    read once, each memo row the lanes map to read and written once, the
    outputs written once). canon_tiered works on valid lanes only, so its
    bounds count the valid lanes' rows and raw hashes; the count over every
    lane (the bound of the one-thread-a-lane kernel before it) is kept
    beside them (``*_all_lanes_ms``)."""
    from raft_tpu_torch.ops.hashing import INT64_MAX, memo_slot

    dev = flatc.device
    occ = canon.occupancy(dev)
    print(f"[3] canon_tiered, {'general' if canon.tier_general() else '2-word'} build at "
          f"{canon.VL} view lanes: a tile of {occ['G']} threads a state, {occ['threads']} "
          f"threads and {occ['smem_bytes']} shared bytes a block, {occ['blocks_per_sm']} "
          f"blocks = {occ['warps_per_sm']} warps an SM "
          "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
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
    # a valid lane's row read and raw key hashed; a cold valid lane also
    # its signatures and one permuted hash per admissible permutation; the
    # mask read and the fingerprints written for every lane. canon_signatures
    # reads every row and computes every lane's signatures
    io_bytes = n * VL * 4 + B + 2 * slots * 16 + B * 8
    io_all = B * VL * 4 + B + 2 * slots * 16 + B * 8
    raw_ops = 24 * int(one_hash[selv].sum())
    raw_all = 24 * int(one_hash.sum())
    miss_ops = 24 * int((sig + one_hash * n_adm)[selv].sum())
    sig_ops = 24 * int(sig.sum())
    cold, cold_by = bound(io_bytes, raw_ops + miss_ops)
    sig_b, sig_by = bound(B * VL * 4 + B * canon.S * 8, sig_ops)
    reset = lambda: memo_k.fill_(INT64_MAX)  # noqa: E731
    return {
        "canon_tiered": dict(
            ms=time_ms(torch, lambda: canon.fingerprints_memo_cuda(flatc, selv, memo_k),
                       setup=reset),
            plain_ms=time_ms(torch, lambda: canon.fingerprints_memo_plain(flatc, selv, memo_k),
                             iters=3, setup=reset),
            warm_ms=time_ms(torch, lambda: canon.fingerprints_memo_cuda(flatc, selv, memo_k)),
            bound_ms=cold, bound_by=cold_by, warm_bound_ms=bound(io_bytes, raw_ops)[0],
            bound_all_lanes_ms=bound(io_all, raw_all + miss_ops)[0],
            warm_bound_all_lanes_ms=bound(io_all, raw_all)[0], library_ms=None,
            max_abs_err=max(errs), lanes=B, valid=n, warps_per_sm=occ["warps_per_sm"]),
        "canon_signatures": dict(
            ms=time_ms(torch, lambda: canon.signatures(flatc)),
            plain_ms=time_ms(torch, lambda: canon.signatures_plain(flatc), iters=3),
            bound_ms=sig_b, bound_by=sig_by, library_ms=None, max_abs_err=err_sig, lanes=B),
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
    copies whose responses name a random leader or Nil. A reconfiguration
    spec's rows are tests/test_torch_kernels_cuda.py's config_edge_rows of
    them (every receipt arm, snapshots, config appends), KRaftWithReconfig's
    its kreconfig_edge_rows (every receipt arm, full bags, logs at max_log,
    spawned servers' first fetches and joins)."""
    from raft_tpu_torch.ops.packing import EMPTY

    base = pool[rng.integers(0, len(pool), 1024)]
    if family_of(model) == "kreconfig":
        from test_torch_kernels_cuda import kreconfig_edge_rows

        return kreconfig_edge_rows(model, base, seed=int(rng.integers(0, 1 << 20)))
    if "msg_w0" in model.layout.fields:  # the reconfiguration specs' N-word bags
        from test_torch_kernels_cuda import config_edge_rows

        return config_edge_rows(model, base, seed=int(rng.integers(0, 1 << 20)))
    lay, M, L = model.layout, model.p.msg_slots, model.p.max_log
    hs, ls, cs = lay.sl("msg_hi"), lay.sl("msg_lo"), lay.sl("msg_cnt")
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


def kreconfig_arms(torch, model, edge):
    """KRaftWithReconfig's guard over every row of ``edge`` (edge_pool's
    rows, kreconfig_forced_rows last) and its apply over every valid lane
    of the forced rows, each against its plain version, exactly. Fails
    unless every disjunct of Next is valid on some row and every receipt
    arm fired on the row built for it: a spawned server's first fetch with
    mepoch 0, a join of a fresh identity (accepted, and overflowing the
    leader's log at max_log), the three FetchResponse arms (UnknownMember
    among them) and the success response that overflows max_log."""
    from raft_tpu_torch.checker.util import compact_indices
    from raft_tpu_torch.ops.expand import apply, apply_plain, guard, guard_plain
    from test_torch_kernels_cuda import kreconfig_forced_rows, kreconfig_missing_arms

    rows = torch.from_numpy(edge).to("cuda")
    C, A, K = rows.shape[0], model.A, len(model.ACTION_NAMES)
    covs = [torch.zeros((K, 3), dtype=torch.int64, device=rows.device) for _ in range(2)]
    gk = guard(model, rows, C, covs[0])
    gp = guard_plain(model, rows, C, covs[1])
    errs = [exact(torch, a, b) for a, b in zip(gk, gp)] + [exact(torch, *covs)]
    n_forced = len(kreconfig_forced_rows(model)[0])
    mask = gk[0].clone()
    mask[:C - n_forced] = False
    sel, n_sel = compact_indices(mask.reshape(-1), int(mask.sum()), C * A)
    errs.append(exact(torch, apply(model, rows, sel), apply_plain(model, rows, sel)))
    check(max(errs) == 0.0, "kreconfig_guard/kreconfig_apply differ from their plain versions "
          "on the edge rows")
    missing = kreconfig_missing_arms(model, *gk[:3])
    check(not missing, f"{model.name} edge rows: no lane fired {missing}")
    print(f"[3] {model.name}: kreconfig_guard exact on all {C} edge rows, kreconfig_apply on "
          f"the {int(n_sel)} valid lanes of the {n_forced} forced rows; all {K} disjuncts and "
          "every receipt arm fired (a spawned server's mepoch-0 fetch, a fresh join accepted "
          "and overflowing max_log, UnknownMember)")


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


def memo_worklist(torch, canon, flatc, selv, label) -> dict:
    """canon_memo on a chunk's worklist as the path gives it (the valid
    prefix, then the invalid tail): against its plain version, memo cold
    then warm, exactly (fingerprints, INT64_MAX on every invalid lane, memo
    rows, hit counts); its build's launch shape and occupancy; its cold and
    warm times and their bounds on the valid lanes: cold, the raw key and P
    permuted hashes of each (K non-bag lanes + NW + 1 per occupied slot,
    ~12 integer ops per fmix32 of each stream pair), or the bytes (each
    valid row read once, the mask read and the fingerprints written for
    every lane, each memo row the lanes map to read and written once); warm,
    the raw keys alone and each memo row read."""
    from raft_tpu_torch.ops.hashing import INT64_MAX, memo_slot

    dev = flatc.device
    occ = canon.occupancy(dev)
    memo_k = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    memo_p = memo_k.clone()
    errs, hits = [], []
    for _ in range(2):  # cold, then warm
        fk, hk = canon.fingerprints_memo_cuda(flatc, selv, memo_k)
        fp, hp = canon.fingerprints_memo_plain(flatc, selv, memo_p)
        errs += [exact(torch, fk, fp), exact(torch, memo_k, memo_p), float(int(hk) != int(hp))]
        hits.append(int(hk))
    check(max(errs) == 0.0 and bool((fk[~selv] == INT64_MAX).all()),
          f"{label}: canon_memo differs from its plain version on the worklist")
    check(hits[1] > hits[0], f"{label}: canon_memo memo hits cold {hits[0]}, warm {hits[1]}")
    fn = lambda: canon.fingerprints_memo_cuda(flatc, selv, memo_k)  # noqa: E731
    cold = time_ms(torch, fn, setup=lambda: memo_k.fill_(INT64_MAX))
    fn()
    warm = time_ms(torch, fn)
    B, n = flatc.shape[0], int(selv.sum())
    st = flatc[selv]
    h = canon._host
    M, NW, w0 = h["M"], len(h["stream_offs"]), h["stream_offs"][0]
    occ_slots = int((st[:, w0:w0 + M] != 1 << 30).sum())
    raw_ops = 24 * (n * canon._K + (NW + 1) * occ_slots)
    slots = torch.unique(memo_slot(canon.raw_fingerprints(st), memo_k.shape[0])).numel()
    io = n * canon.VL * 4 + B + B * 8
    cold_b, cold_by = bound(io + 2 * slots * 16, raw_ops * (1 + canon.P))
    warm_b, warm_by = bound(io + slots * 16, raw_ops)
    print(f"[3] {label}: canon_memo, {'general' if canon.memo_general() else '2-word'} build at "
          f"{canon.VL} view lanes: a tile of {occ['G']} threads a state, {occ['threads']} "
          f"threads and {occ['smem_bytes']} shared bytes a block, {occ['blocks_per_sm']} blocks = "
          f"{occ['warps_per_sm']} warps an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor); "
          f"exact on the worklist ({n} valid of {B} lanes, hits cold {hits[0]}, warm "
          f"{hits[1]}): cold {cold:.4f} ms (bound {cold_b:.4f}, {cold_by}), warm {warm:.4f} ms "
          f"(bound {warm_b:.4f}, {warm_by})")
    return dict(valid=n, lanes=B, cold_ms=cold, warm_ms=warm, cold_bound_ms=cold_b,
                cold_bound_by=cold_by, warm_bound_ms=warm_b, warm_bound_by=warm_by,
                occupancy=occ, max_abs_err=max(errs))


def canon_memo_rows(torch, bfs, flatc, selv, tag=None) -> dict:
    """canon_memo (canon_tiered at five servers) against its plain version
    on a chunk's successor rows of ``bfs``'s model and their
    server-permuted copies (the model's message remap kinds), memo cold
    then warm, exactly; the permuted rows keep their fingerprints. Prints
    the kernel's cold and warm time on the valid rows and the cold bound:
    bytes, each row and the mask read once, each memo row the rows map to
    read and written once, the fingerprints written; operations, ~12
    integer ops per fmix32 of each stream pair: canon_memo hashes every row
    raw and under all P permutations (K non-bag lanes + NW + 1 per occupied
    slot each), canon_tiered as tier_pairs counts it. canon_memo is also
    held on the chunk's worklist itself (memo_worklist). With ``tag``
    (canon_memo's general path) returns its row ``canon_memo[tag]`` of the
    kernels line: the cold time on the valid rows, its plain version's, the
    cold bound, and the worklist's figures."""
    from raft_tpu_torch.ops.hashing import INT64_MAX, memo_slot
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
    kernel = "canon_tiered" if canon.prune else "canon_memo"
    check(max(errs) == 0.0, f"{model.name}: {kernel} differs from its plain version")
    check(torch.equal(fk[:n], fk[n:]), f"{model.name}: permuted states changed their "
          "fingerprints")
    ms = time_ms(torch, lambda: canon.fingerprints_memo_cuda(rows[:n], valid[:n], memo_k),
                 setup=lambda: memo_k.fill_(INT64_MAX))
    warm = time_ms(torch, lambda: canon.fingerprints_memo_cuda(rows[:n], valid[:n], memo_k))
    h, st = canon._host, rows[:n]
    M, NW = h["M"], len(h["stream_offs"])
    if canon.prune:
        sig, one_hash, n_adm = tier_pairs(torch, canon, st)
        ops = 24 * int((one_hash + sig + one_hash * n_adm).sum())
    else:
        w0 = h["stream_offs"][0]
        occ = int((st[:, w0:w0 + M] != 1 << 30).sum())
        ops = 24 * (n * canon._K + (NW + 1) * occ) * (1 + canon.P)
    slots = torch.unique(memo_slot(canon.raw_fingerprints(st), memo_k.shape[0])).numel()
    b, by = bound(n * canon.VL * 4 + n + 2 * slots * 16 + n * 8, ops)
    print(f"[3] {model.name} ({model.p.n_servers} servers): {kernel} exact on {n} successor "
          f"rows and their permuted copies (the message remap {canon.spec}); cold {ms:.4f} ms, "
          f"warm {warm:.4f} ms, bound {b:.4f} ms ({by})")
    if canon.prune:
        return {}
    work = memo_worklist(torch, canon, flatc, selv, model.name)
    if tag is None:
        return {}
    plain = time_ms(torch, lambda: canon.fingerprints_memo_plain(rows[:n], valid[:n], memo_p),
                    iters=3, setup=lambda: memo_p.fill_(INT64_MAX))
    return {f"canon_memo[{tag}]": dict(ms=ms, warm_ms=warm, plain_ms=plain, bound_ms=b,
                                       bound_by=by, library_ms=None, max_abs_err=max(errs),
                                       worklist=work)}


def slot_canon_rows(torch, bfs, flatc, selv) -> dict:
    """slot_canon against its plain version (PyTorch on the card) on a
    chunk's successor rows as the path calls it (the worklist with its
    valid mask), exactly, symmetry on and off; the valid rows' host- and
    value-permuted copies (each (sigma, tau) pair's remapped, slot-sorted
    rows) keep their fingerprints. Timed on the chunk, with its bound: the
    valid rows' view lanes and the mask read, the fingerprints written,
    against about 24 INT32 operations a lane of each pair's hash, 3 a lane
    of its view build and the bag re-sort at the work a sort needs,
    M x ceil(log2 M) compare-exchanges of NW words (a compare and a select
    a word); beside it the same bound on the work the kernel itself does
    (``own_bound_ms``). Prints the kernel's tile, block shape and warps an
    SM."""
    model, dev = bfs.model, flatc.device
    canon = bfs.canon
    errs = []
    for symmetry in (True, False):
        c = model.make_canonicalizer(symmetry)
        errs.append(exact(torch, c.fingerprints_cuda(flatc, selv),
                          torch.where(selv, c.fingerprints_plain(flatc), (1 << 63) - 1)))
    check(max(errs) == 0.0, "slot_canon differs from its plain version")
    base = flatc[selv]
    n = base.shape[0]
    parts = torch.arange(n, device=dev) % (canon.P - 1) + 1  # each row under one other pair
    perm = base.clone()
    for k in range(1, canon.P):
        pick = parts == k
        perm[pick] = canon.canon_rows(base[pick], k)
    check(torch.equal(canon.fingerprints(perm), canon.fingerprints(base)),
          "slot_canon: permuted copies changed their fingerprints")
    VL, M, NW = model.layout.view_len, model.p.msg_slots, model.n_words
    nb = flatc.shape[0]
    sort_ops = 2 * NW * M * math.ceil(math.log2(M))
    b, by = bound(n * VL * 4 + nb + nb * 8, n * canon.P * (24 * VL + sort_ops + 3 * VL))
    # the work the kernel itself does on these rows: sigma's lanes once a
    # sigma, each pair's log values, acked and occupied keys (c of them, each
    # ranked among the c at NW compares), the unused slots once a row
    S, L, V = model.NS, model.p.max_log, model.p.n_values
    c = (base[:, model.layout.sl("msg_w0")] != 1 << 30).sum(1)
    nsig, ntau = len(canon.sig_table), len(canon.tau_table)
    terms = (nsig * (21 * S + 5 * S * L + S * S)
             + canon.P * (S * L + V + (NW + 1) * c) + (NW + 1) * (M - c))
    own_ops = int((24 * terms + 2 * NW * canon.P * c * c).sum())
    own_b, own_by = bound(n * VL * 4 + nb + nb * 8, own_ops)
    occ = canon.occupancy(dev)
    row = dict(ms=time_ms(torch, lambda: canon.fingerprints(flatc, selv), iters=20),
               plain_ms=time_ms(torch, lambda: canon.fingerprints_plain(base), iters=3),
               bound_ms=b, bound_by=by, library_ms=None, max_abs_err=max(errs), rows=n,
               pairs=canon.P, own_bound_ms=own_b, own_bound_by=own_by,
               occupied_slots=float(c.float().mean()), occupancy=occ)
    print(f"[3] {model.name}: slot_canon exact on the worklist, {n} valid successor rows of "
          f"{nb} lanes (symmetry on, {canon.P} pairs, and off) and their permuted copies; "
          f"{row['ms']:.4f} ms (bound {b:.4f}, {by}; the kernel's own work "
          f"{own_b:.4f}, {own_by}, {row['occupied_slots']:.1f} occupied slots a row); a tile of "
          f"{occ['G']} threads a row in sub-tiles of {occ['sub_tile']}, {occ['threads']} threads "
          f"and {occ['smem_bytes']} shared bytes a block, {occ['blocks_per_sm']} blocks = "
          f"{occ['warps_per_sm']} warps an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    return {"slot_canon": row}


def family_kernel_rows(torch, rng, fam) -> dict:
    """Phase 3 for a spec family: its guard, apply, fold, sim_check and
    predicates against their plain versions, exactly, on a CHUNK of
    reachable states sampled from the card's own BFS frontier of each of
    the family's specs (the first one's expand kernels timed) and on edge
    rows built from them; canon_memo on its successor rows; the family's
    five-server configuration's canon_tiered and canon_signatures where it
    has one; then its sim_check and predicates at its simulate's own width
    (family_sim_rows, timed). Returns {kernel: row}."""
    rows = {}
    for k, (spec, pin, depth) in enumerate(fam["specs"]):
        t = time.perf_counter()
        _, bfs, res = run_family(fam, spec, "cuda", depth)
        n = min(depth + 1, len(pin["depth_counts"]))
        check(res.depth_counts[:n] == pin["depth_counts"][:n],
              f"{spec} sample depth counts {res.depth_counts}")
        fr = bfs.frontier_rows
        if fr.shape[0] > POOL_ROWS:  # a wide wave: a sample of it from the phase's rng
            pick = np.sort(rng.choice(fr.shape[0], POOL_ROWS, replace=False))
            fr = fr[torch.from_numpy(pick).to(fr.device)]
        pool = fr.cpu().numpy()
        print(f"[3] sampled the depth-{depth} {spec} frontier ({bfs.frontier_rows.shape[0]} "
              f"states; {len(pool)} kept) in {time.perf_counter() - t:.1f} s")
        del fr
        rows.update(expand_kernels(torch, bfs, pool, rng, timed=k == 0))
        edge = edge_pool(bfs.model, pool, rng)
        expand_kernels(torch, bfs, edge, rng, timed=False)
        if family_of(bfs.model) == "kreconfig":
            kreconfig_arms(torch, bfs.model, edge)
        if k == 0:
            flatc, selv, _fps = chunk_lanes(torch, bfs, pool, rng)
            if bfs._use_memo:
                rows.update(canon_memo_rows(torch, bfs, flatc, selv, fam.get("memo_tag")))
            else:  # KRaftWithReconfig's slot canon, timed
                rows.update(slot_canon_rows(torch, bfs, flatc, selv))
        batch = torch.from_numpy(np.ascontiguousarray(
            pool[rng.integers(0, len(pool), CHUNK)])).to(bfs.device)
        step_rows(torch, bfs.model, batch, rng)
        step_rows(torch, bfs.model, torch.from_numpy(edge).to(bfs.device), rng)
        del bfs
    if "five_cfg" in fam:
        rows.update(five_canon_rows(torch, rng, fam))
    rows.update(family_sim_rows(torch, fam))
    return rows


def five_canon_rows(torch, rng, fam) -> dict:
    """canon_tiered and canon_signatures against their plain versions on a
    chunk of the family's five-server cfg's frontier at its ``five_depth``
    (a sample of POOL_ROWS rows of a wide wave). For the reconfiguration
    specs (``five_tag``: canon_tiered's general path) the family's expand
    kernels are held on the same frontier, and the canon also timed (the rows
    ``canon_tiered[tag]``, ``canon_signatures[tag]``), checked again under
    the collision audit's second hash family, and on the valid rows'
    server-permuted copies, which keep their fingerprints."""
    from raft_tpu_torch.ops.symmetry import Canonicalizer

    t = time.perf_counter()
    _, bfs, _res = run_family(fam, fam["specs"][0][0], "cuda", fam["five_depth"],
                              text=fam["five_cfg"])
    fr = bfs.frontier_rows
    if fr.shape[0] > POOL_ROWS:
        pick = np.sort(rng.choice(fr.shape[0], POOL_ROWS, replace=False))
        fr = fr[torch.from_numpy(pick).to(fr.device)]
    pool = fr.cpu().numpy()
    print(f"[3] sampled the depth-{fam['five_depth']} five-server {bfs.model.name} frontier "
          f"({bfs.frontier_rows.shape[0]} states) in {time.perf_counter() - t:.1f} s")
    del fr
    tag = fam.get("five_tag")
    if tag:  # the family's expand kernels at five servers too, the apply timed
        apply_row = expand_kernels(torch, bfs, pool, rng, timed=True)[f"{fam['prefix']}_apply"]
    flatc, selv, _fps = chunk_lanes(torch, bfs, pool, rng)
    if not tag:
        tiered_rows(torch, bfs.canon, flatc, selv, timed=False)
        return {}
    rows = {f"{k}[{tag}]": r for k, r in
            tiered_rows(torch, bfs.canon, flatc, selv, timed=True).items()}
    rows[f"{fam['prefix']}_apply[{tag}]"] = apply_row
    tiered_rows(torch, Canonicalizer.for_model(bfs.model, seed=AUDIT_SEED), flatc, selv,
                timed=False)
    canon_memo_rows(torch, bfs, flatc, selv)
    return rows


def net_fault_kernel_rows(torch, rng) -> dict:
    """Phase 3 for --net-faults at Raft.cfg's full width (A = 165):
    raft_guard, raft_apply and raft_fold against their plain versions on a
    CHUNK of the card's own depth-NF_SAMPLE_DEPTH frontier (timed: the rows
    ``raft_guard[net_faults]``, ``raft_apply[net_faults]``) and on edge rows
    (tests/test_torch_kernels_cuda.py's net_fault_rows: count-1 records,
    count-2 ones whose duplicate is refused, count-0 ones both faults refuse
    while the record stays, counts out of range), on which both fault
    groups must fire and the guard's whole grid equal the plain one."""
    from test_torch_kernels_cuda import net_fault_rows

    from raft_tpu_torch.ops.expand import guard, guard_plain
    from raft_tpu_torch.ops.packing import EMPTY

    fam, t = NF_FAM, time.perf_counter()
    _, bfs, res = run_family(fam, "Raft", "cuda", NF_SAMPLE_DEPTH)
    check(res.depth_counts == NF_PIN["depth_counts"][:NF_SAMPLE_DEPTH + 1],
          f"net-faults sample depth counts {res.depth_counts}")
    model = bfs.model
    check(model.A == 165, f"Raft.cfg with --net-faults has A = {model.A}, not 165")
    pool = bfs.frontier_rows.cpu().numpy()
    print(f"[3] sampled the depth-{NF_SAMPLE_DEPTH} Raft.cfg --net-faults frontier ({len(pool)} "
          f"states) in {time.perf_counter() - t:.1f} s")
    rows = {f"{k}[net_faults]": r for k, r in expand_kernels(torch, bfs, pool, rng, timed=True)
            .items() if k in ("raft_guard", "raft_apply")}
    edge = net_fault_rows(model, pool[rng.integers(0, len(pool), 1024)],
                          seed=int(rng.integers(0, 1 << 20)))
    bfs._set_worklist(64)  # full bags of count-1 records enable 2 * M fault lanes a row
    expand_kernels(torch, bfs, edge, rng, timed=False)
    # the whole edge grid: every row, both fault groups, the counts 0, 1, 2
    st = torch.from_numpy(edge).to(bfs.device)
    K = len(model.ACTION_NAMES)
    covs = [torch.zeros((K, 3), dtype=torch.int64, device=bfs.device) for _ in range(2)]
    gk, gp = guard(model, st, len(edge), covs[0]), guard_plain(model, st, len(edge), covs[1])
    check(all(torch.equal(a, b) for a, b in zip(gk, gp)) and torch.equal(*covs),
          "raft_guard differs from its plain version on the net-fault edge rows")
    M, lay = model.p.msg_slots, model.layout
    valid = gk[0].cpu().numpy()
    dup, drop = valid[:, model.A - 2 * M:model.A - M], valid[:, model.A - M:]
    occ = edge[:, lay.sl("msg_hi")] != EMPTY
    cnt = edge[:, lay.sl("msg_cnt")]
    for c, want in ((0, (False, False)), (1, (True, True)), (2, (False, True))):
        hit = occ & (cnt == c)
        check(hit.any() and (dup[hit] == want[0]).all() and (drop[hit] == want[1]).all(),
              f"net-fault edge rows: count-{c} records (dup, drop) != {want}")
    check(dup.any() and drop.any(), "a fault group never fired on the edge rows")
    print(f"[3] Raft.cfg --net-faults: raft_guard exact on all {len(edge)} edge rows (count-0, "
          f"-1 and -2 records; DuplicateMessage on {int(dup.sum())} lanes, DropMessage on "
          f"{int(drop.sum())})")
    del bfs
    return rows


def fleet_kernel_rows(torch, rng) -> dict:
    """Phase 3 for the fleet lanes: raft_guard (the packed Raft.cfg group of
    phase 9(c), MaxElections and MaxRestarts lanes) and pull_guard (the
    packed PullRaft stand-in of 9(b), the MaxElections lane) with
    raft_apply/pull_apply and the folds against their plain versions on a
    CHUNK of packed states from the card's own BFS of all the group's jobs
    at once, their c_<name> lanes redrawn below the static maximum
    (tests/test_torch_kernels_cuda.py's fleet_rows); the guards timed (the
    rows ``raft_guard[fleet]`` and ``pull_guard[fleet]``)."""
    from test_torch_kernels_cuda import fleet_rows

    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.fleet import build_packed, group_jobs, parse_manifest_obj

    rows = {}
    for obj, depth in ((sweep_manifest(RAFT_CFG, "Raft", {"MaxElections": [1, 2],
                                                          "MaxRestarts": [0, 1]}, 48), 14),
                       (sweep_manifest(PULL_CFG, "PullRaft", {"MaxElections": [1, 2]}, 64),
                        PULL_SAMPLE_DEPTH)):
        t = time.perf_counter()
        (group,) = group_jobs(parse_manifest_obj(obj, "<phase 3>"))
        model = build_packed(group)
        bfs = DeviceBFS(model, invariants=group.setups[0].invariants, chunk=CHUNK,
                        device="cuda", max_frontier_cap=1 << 23)
        bfs.run(max_depth=depth)  # every job of the group at once (no fleet_select)
        fr = bfs.frontier_rows
        if fr.shape[0] > POOL_ROWS:
            pick = np.sort(rng.choice(fr.shape[0], POOL_ROWS, replace=False))
            fr = fr[torch.from_numpy(pick).to(fr.device)]
        pool = fleet_rows(model, fr.cpu().numpy(), seed=int(rng.integers(0, 1 << 20)))
        fam = family_of(model)
        print(f"[3] sampled the depth-{depth} packed {model.name} frontier of "
              f"{len(group.jobs)} jobs ({bfs.frontier_rows.shape[0]} states; lanes "
              f"{list(group.dyn_consts)} redrawn) in {time.perf_counter() - t:.1f} s")
        rows[f"{fam}_guard[fleet]"] = expand_kernels(torch, bfs, pool, rng,
                                                     timed=True)[f"{fam}_guard"]
        del bfs, fr
    return rows


def run_family(fam, spec, device, depth, chunk=CHUNK, text=None, msg_slots=None):
    """run_check (the CLI's function) of one of the family's specs on its
    cfg text or ``text`` (the pull stand-in and AddRemove parsed
    leniently: the parse declares PullRaft's v2 and repairs AddRemove's
    MaxClusterSize), with the family's capacities and network faults."""
    from raft_tpu_torch.__main__ import run_check

    return run_check(f"{spec}.cfg", text=text or fam["cfg"], device=device, chunk=chunk,
                     max_depth=depth, lenient=fam["lenient"], caps=fam.get("caps"),
                     net_faults=fam.get("net_faults", False), msg_slots=msg_slots)


def family_main_phase(torch, fam) -> dict:
    """A spec family on the main path: its first spec exhausted through
    ``run_check`` (the CLI's function) with the launch counts of its path
    and its counts held to the pin (all of them where the pin is
    exhausted, the depth counts through the pinned depth where it is
    not); the deepest journal state's trace replayed on the card and on
    the CPU; where the family has a second chunk size, the exhaustion
    repeated at it with identical final counts (a check of the levels past
    a pin); the family's other specs exhausted and held to their pins; and
    card against CPU at a small depth (on the family's small cfg where it
    has one). A family with a ``depth`` (the reconfiguration specs) runs to
    that depth, not to exhaustion, with its capacities."""
    from raft_tpu_torch.checker.util import replay_chain

    tag, t0 = fam["tag"], time.perf_counter()
    report = {}
    for k, (spec, pin, _depth) in enumerate(fam["specs"]):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        depth = fam.get("depth")
        if k == 0:
            setup, bfs, res, wall, launches, n_expand, n_sort = counted_run(
                torch, f"{spec}.cfg", fam["cfg"], lenient=fam["lenient"], max_depth=depth,
                caps=fam.get("caps"), net_faults=fam.get("net_faults", False))
        else:
            t = time.perf_counter()
            setup, bfs, res = run_family(fam, spec, "cuda", depth)
            wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        # an exhausted run also expands its last frontier
        waves = res.depth_counts if res.exhausted else res.depth_counts[:-1]
        chunks = sum(-(-n // CHUNK) for n in waves) + bfs.redone_chunks
        model = setup.model
        print(f"[{tag}] {spec}: distinct={res.distinct} total={res.total} depth={res.depth} "
              f"terminal={res.terminal} exhausted={res.exhausted} in {wall:.2f} s "
              f"({res.distinct / wall:.0f} distinct/s, {chunks} chunks, "
              f"{wall * 1e3 / chunks:.2f} ms/chunk), peak device memory "
              f"{peak / 2**30:.2f} GiB (W = {model.layout.W}, A = {model.A})")
        run = {"distinct": res.distinct, "total": res.total, "depth": res.depth,
               "terminal": res.terminal, "seconds": wall, "distinct_per_s": res.distinct / wall,
               "chunks": chunks, "ms_per_chunk": wall * 1e3 / chunks, "peak_device_bytes": peak}
        want_viol = fam.get("violation") if k == 0 else None
        got_viol = res.violation and (res.violation.invariant, res.violation.depth)
        check(got_viol == want_viol and (
            res.exhausted if depth is None else res.depth == depth),
            f"{spec}: violation {got_viol} (expected {want_viol}), exhausted {res.exhausted}, "
            f"depth {res.depth}")
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
        for action in fam.get("must_fire", ()) if k == 0 else ():
            r = model.ACTION_NAMES.index(action)
            check(res.coverage[r][1] > 0, f"{spec}: {action} never fired")
            print(f"[{tag}] {spec}: {action} fired {res.coverage[r][1]} times, "
                  f"{res.coverage[r][2]} of them to a new state")
        if k:
            report[spec] = run
            del bfs
            continue
        report.update(run, launches=launches, depth_counts=res.depth_counts)
        check_path(launches, fam["path"], chunks, n_expand, n_sort, tag,
                   replayed=len(res.trace) - 1 if res.violation else 0)
        # the violation's trace, else the deepest journal state's
        gid = res.violation.global_id if res.violation else res.distinct - 1
        init, chain = bfs.journal_chain(gid)
        tg, tc = (replay_chain(model, d, init, chain) for d in ("cuda", "cpu"))
        check(tg == tc and len(tg) == res.depth + 1, f"{spec}: the replayed traces differ")
        if res.violation:
            inv = res.violation.invariant
            last = torch.from_numpy(model.encode(tc[-1][1])[None])
            check(tg == res.trace and not bool(model.invariants[inv](last)[0]),
                  f"{spec}: the counterexample does not replay to a state that breaks {inv}")
        print(f"[{tag}] {spec}: the {len(tg)}-state trace of gid {gid} (last step "
              f"{tg[-1][0]}) replays equal on the card and the CPU"
              + (f", and its last state breaks {res.violation.invariant} on the CPU"
                 if res.violation else ""))
        report["violation"] = got_viol and [*got_viol, gid]
        del bfs
        if fam.get("second_chunk"):
            torch.cuda.empty_cache()
            t = time.perf_counter()
            _, bfs2, res2 = run_family(fam, spec, "cuda", depth, chunk=fam["second_chunk"])
            wall2 = time.perf_counter() - t
            got2 = (res2.distinct, res2.total, res2.depth, res2.terminal, res2.depth_counts,
                    res2.coverage, res2.exhausted, res2.violation)
            check(got2 == (res.distinct, res.total, res.depth, res.terminal, res.depth_counts,
                           res.coverage, res.exhausted, res.violation),
                  f"{spec} at chunk {fam['second_chunk']}: {got2[:4]} != "
                  f"{(res.distinct, res.total, res.depth, res.terminal)}")
            print(f"[{tag}] {spec} run again at chunk {fam['second_chunk']} in "
                  f"{wall2:.2f} s: identical distinct, total, depth, terminal, depth counts, "
                  "coverage and violation")
            report["second_chunk"] = {"chunk": fam["second_chunk"], "seconds": wall2}
            del bfs2
    spec, depth = fam.get("small", (None, None))
    small = fam.get("small_cfg") or fam["cfg"]
    texts = {"": small} if spec else {}
    if fam.get("small_nosym"):  # and with the SYMMETRY line taken out
        texts[" (symmetry off)"] = "\n".join(
            ln for ln in small.splitlines() if not ln.startswith("SYMMETRY")) + "\n"
    for what, text in texts.items():
        runs = {}
        for d in ("cuda", "cpu"):
            t = time.perf_counter()
            runs[d] = (run_family(fam, spec, d, depth, chunk=1024, text=text,
                                  msg_slots=fam.get("small_slots"))[2],
                       time.perf_counter() - t)
        (sg, t_card), (sc, t_cpu) = runs["cuda"], runs["cpu"]
        check((sg.distinct, sg.total, sg.terminal, sg.depth_counts, sg.coverage)
              == (sc.distinct, sc.total, sc.terminal, sc.depth_counts, sc.coverage),
              f"{spec}{what}: card and CPU differ")
        print(f"[{tag}] {spec} to depth {depth}{what}: distinct={sg.distinct} total={sg.total}, "
              f"depth counts and coverage: card == CPU (card {t_card:.1f} s, CPU {t_cpu:.1f} s)")
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({f"{fam['prefix']}_run": report}))
    return report


def five_reconfig_phase(torch) -> dict:
    """Phase 4i: five-server AddRemove on the main path (family_main_phase:
    counted, held to the pin, its trace replayed); at the pinned depth its
    depth counts and coverage held to the reference's through trace_run
    (untraced, then traced), the same workload at half the chunk through
    the port's parity_gate, and the collision audit at AUDIT5_DEPTH; then
    five-server JointConsensus on the card (counted) against the CPU."""
    from raft_tpu_torch.__main__ import load_setup
    from raft_tpu_torch.checker.audit import collision_audit
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.parity import parity_gate

    t0 = time.perf_counter()
    report = family_main_phase(torch, ADDREMOVE5_FAM)
    spec, pin, _d = ADDREMOVE5_FAM["specs"][0]
    dpin = len(pin["depth_counts"]) - 1
    trace, rp = trace_run(torch, f"{spec}.cfg", ADDREMOVE5_CFG, dpin,
                          (pin["distinct"], pin["total"], dpin, pin["terminal"]), lenient=True,
                          caps=ADDREMOVE5_CAPS)
    check(rp.depth_counts == pin["depth_counts"] and rp.coverage == pin["coverage"],
          f"five-server {spec} depth counts or coverage at the pinned depth differ from the "
          "reference's")
    print(f"[4i] five-server {spec} depth {dpin}: distinct, total, depth counts and coverage "
          f"equal the reference's, {trace['chunks']} chunks, "
          f"{trace['wall_ms_per_chunk']:.3f} ms/chunk wall")
    print(json.dumps({"trace_addremove5": trace}))
    setup = load_setup(f"{spec}.cfg", text=ADDREMOVE5_CFG, lenient=True)
    t = time.perf_counter()
    checkers = tuple(DeviceBFS(setup.model, invariants=setup.invariants, chunk=c,
                               frontier_cap=c * 16, device="cuda", **ADDREMOVE5_CAPS)
                     for c in (CHUNK, CHUNK // 2))
    gate = parity_gate(checkers=checkers, depth=dpin)
    check(gate.ok and gate.counts[0] == pin["depth_counts"], f"five-server {spec}: {gate}")
    print(f"[4i] {gate} in {time.perf_counter() - t:.1f} s")
    del checkers
    t = time.perf_counter()
    audit = collision_audit(setup.model, setup.invariants, depth=AUDIT5_DEPTH, chunk=CHUNK,
                            seeds=(0, AUDIT_SEED), device="cuda")
    check(audit.ok and audit.counts[0] == pin["depth_counts"][:AUDIT5_DEPTH + 1],
          f"five-server {spec}: {audit}")
    print(f"[4i] {audit} in {time.perf_counter() - t:.1f} s")
    report.update(trace=trace, parity_gate=str(gate), collision_audit=str(audit))
    # five-server JointConsensus: the card (counted) against the CPU, chunk
    # 256 (the CPU's plain expand grid grows with the chunk, not the frontier)
    jspec = "RaftWithReconfigJointConsensus"

    def joint5(device):
        return run_family(ADDREMOVE5_FAM, jspec, device, JOINT5_SMALL_DEPTH, chunk=256,
                          text=JOINT5_CFG)[2]

    jg, t_card, jl, n_expand, n_sort = counted(torch, lambda: joint5("cuda"))
    t = time.perf_counter()
    jc = joint5("cpu")
    t_cpu = time.perf_counter() - t
    got = (jg.distinct, jg.total, jg.terminal, jg.depth_counts, jg.coverage)
    check(jg.violation is None and got == (jc.distinct, jc.total, jc.terminal, jc.depth_counts,
                                           jc.coverage),
          f"five-server {jspec}: card {got[:3]} != CPU {(jc.distinct, jc.total, jc.terminal)}")
    n_pin = min(len(JOINT5_PIN["depth_counts"]), JOINT5_SMALL_DEPTH + 1)
    check(jg.depth_counts[:n_pin] == JOINT5_PIN["depth_counts"][:n_pin],
          f"five-server {jspec} depth counts {jg.depth_counts} != the reference's")
    for k in JOINT5_PATH:
        check(jl[k] > 0, f"five-server {jspec}: kernel {k} was never launched")
    for k in set(KERNEL_NAMES) - set(JOINT5_PATH):
        check(jl[k] == 0, f"five-server {jspec}: {k} launched off its path")
    check(n_expand == 0 and n_sort == 0,
          f"five-server {jspec}: the plain expand ran {n_expand} times, torch sorted {n_sort}")
    print(f"[4i] five-server {jspec} to depth {JOINT5_SMALL_DEPTH}: distinct={jg.distinct} "
          f"total={jg.total}, depth counts and coverage: card == CPU == the reference's (card "
          f"{t_card:.1f} s, {jl['canon_tiered']} canon_tiered launches; CPU {t_cpu:.1f} s)")
    report["joint5"] = {"distinct": jg.distinct, "total": jg.total, "launches": jl,
                        "card_s": t_card, "cpu_s": t_cpu}
    # and at its pinned depth: depth counts and coverage held to the reference's
    jpin = len(JOINT5_PIN["depth_counts"]) - 1
    jtrace, rj = trace_run(torch, f"{jspec}.cfg", JOINT5_CFG, jpin,
                           (JOINT5_PIN["distinct"], JOINT5_PIN["total"], jpin,
                            JOINT5_PIN["terminal"]), lenient=True, caps=ADDREMOVE5_CAPS)
    check(rj.depth_counts == JOINT5_PIN["depth_counts"] and rj.coverage == JOINT5_PIN["coverage"],
          f"five-server {jspec} depth counts or coverage at the pinned depth differ from the "
          "reference's")
    print(f"[4i] five-server {jspec} depth {jpin}: distinct, total, depth counts and coverage "
          f"equal the reference's, {jtrace['chunks']} chunks, "
          f"{jtrace['wall_ms_per_chunk']:.3f} ms/chunk wall")
    print(json.dumps({"trace_joint5": jtrace}))
    report["joint5"]["trace"] = jtrace
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"addremove5_run": {k: v for k, v in report.items() if k != "launches"}}))
    return report


def family_simulate_phase(torch, fam) -> dict:
    """A spec family simulated: its first spec on the card against the CPU
    at SMALL_WALKS walks for SMALL_MOVES moves (a reconfiguration family:
    its small cfg at its own walks and moves), then at SIM_WALKS walks for
    the family's moves through ``run_simulate`` (the CLI's function) with
    its launch counts, and a profiled window of its moves."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.__main__ import load_setup, run_simulate
    from raft_tpu_torch.checker.simulate import Simulator

    tag, pre, t0 = fam["sim_tag"], fam["prefix"], time.perf_counter()
    spec = fam["specs"][0][0]
    kw = dict(text=fam["cfg"], max_behavior_depth=SIM_DEPTH, seed=0, lenient=fam["lenient"],
              net_faults=fam.get("net_faults", False))
    small = {}
    walks, moves_small = fam.get("small_sim", (SMALL_WALKS, SMALL_MOVES))
    for d in ("cuda", "cpu"):
        t = time.perf_counter()
        _, sim, res = run_simulate(f"{spec}.cfg", device=d, walks=walks,
                                   max_steps=moves_small * walks,
                                   **dict(kw, text=fam.get("small_cfg", fam["cfg"]),
                                          msg_slots=fam.get("small_slots")))
        small[d] = (sim, res, time.perf_counter() - t)
    (sg, fg, t_card), (sc, fc, t_cpu) = small["cuda"], small["cpu"]
    check(fg.violation is None and fc.violation is None
          and (fg.behaviors, fg.steps) == (fc.behaviors, fc.steps),
          f"simulate {spec}: card {(fg.behaviors, fg.steps, fg.violation)} != CPU "
          f"{(fc.behaviors, fc.steps, fc.violation)}")
    for a in ("states", "depth", "journal", "jlen"):
        check(torch.equal(getattr(sg, a).cpu(), getattr(sc, a)), f"simulate {spec}: {a} differ")
    print(f"[{tag}] simulate {spec} ({walks} walks, {moves_small} moves): behaviors="
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
    setup = load_setup(f"{spec}.cfg", text=fam["cfg"], lenient=fam["lenient"],
                       net_faults=fam.get("net_faults", False))
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
    KRaftModel's, the reconfiguration models') and torch's sorts counted by
    wrapping them for the length of the call. Returns (fn's
    result, wall s, launches, expand calls, sort calls)."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.models.config_common import ConfigRaftCommon
    from raft_tpu_torch.models.kraft import KRaftModel
    from raft_tpu_torch.models.kraft_reconfig import KRaftReconfigModel
    from raft_tpu_torch.models.pull_raft import PullRaftModel
    from raft_tpu_torch.models.raft import RaftModel

    models = (RaftModel, PullRaftModel, KRaftModel, ConfigRaftCommon, KRaftReconfigModel)
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


def check_path(launches, path, chunks, expand_calls, sort_calls, name, replayed=0):
    """Every kernel of ``path`` launched, the per-chunk kernels once per
    chunk (the guard and apply also once per step of a counterexample's
    replayed trace, ``replayed`` steps), the canon and the family's fold
    once more for the initial states, no kernel off the path (another
    family's among them), and neither the plain expand nor a torch sort on
    the path."""
    fam = next(k for k in path if k.endswith("_guard")).rsplit("_", 1)[0]
    for k in path:
        check(launches[k] > 0, f"{name}: kernel {k} was never launched on the path")
    for k, n in (("chunk_dedup", chunks), (f"{fam}_guard", chunks + replayed),
                 (f"{fam}_apply", chunks + replayed)):
        check(launches[k] == n, f"{name}: {launches[k]} {k} launches != {chunks} chunks"
              + (f" + {replayed} replayed steps" if replayed else ""))
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
    print(f"[{name}] {fam}_guard, {fam}_apply, chunk_dedup: one launch per chunk"
          + (f" (the guard and apply also one per replayed step, {replayed})" if replayed else "")
          + f"; {canon}, {fold}: one per chunk and one for the initial states; no kernel off the "
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


def device_time(torch, prof, split_exchange: bool = False) -> tuple[float, dict] | None:
    """(busy ms, ms by kernel group) of the CUDA activity in a trace, or
    None where the tracer saw no device activity. ``split_exchange``: NCCL
    kernels and device-to-device copies get groups of their own (the
    sharded engine's exchange)."""
    spans, groups = [], {}
    for ev in prof.events():
        us = ev.time_range.elapsed_us()
        if ev.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        # a whole-word match: raft_apply_kernel is a substring of kraft's
        g = next((k for k, names in KERNEL_NAMES.items()
                  if any(re.search(rf"(?<!\w){n}(?!\w)", ev.name) for n in names)), None)
        if g is None and split_exchange:
            if "nccl" in ev.name.lower():
                g = "exchange (nccl)"
            elif "memcpy dtod" in ev.name.lower():
                g = "memcpy DtoD"
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


def sharded_phase(torch, main_res) -> dict:
    """Phase 4j: Raft.cfg by ShardedBFS at D = 1 over NCCL through the
    CLI's function (run_sharded_check), exhausted: counts, depth counts
    and coverage against phase 4's DeviceBFS run ``main_res`` (enabled and
    fired per action equal; new-distinct per action follows each engine's
    discovery order and only its total is equal), the path's kernels once
    per chunk with owner_route among them, two all_to_all_single calls a
    chunk; a checkpoint at SHARD_CKPT_DEPTH resumed to the same counts;
    two-server Raft checkpointed on the card at D = 1 and resumed on the
    CPU at D = 2; FlexibleRaft's violation at DeviceBFS's depth with a
    trace replayed on the card and the CPU; one profiled run to depth 20
    (device ms a chunk by kernel group, the exchange among them)."""
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.__main__ import run_check, run_sharded_check
    from raft_tpu_torch.checker.util import replay_chain

    def sharded(text, devices=1, device="cuda", chunk=CHUNK, cfg="Raft.cfg", **kw):
        return run_sharded_check(cfg, devices, text=text, device=device, chunk=chunk,
                                 caps=SHARD_CAPS, **kw)

    a2a = {"calls": 0}
    real_a2a = dist.all_to_all_single

    def counting_a2a(*a, **k):
        a2a["calls"] += 1
        return real_a2a(*a, **k)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.all_to_all_single = counting_a2a
    try:
        (_setup, eng, res), wall, launches, n_expand, n_sort = counted(
            torch, lambda: sharded(RAFT_CFG, collect_metrics=True))
    finally:
        dist.all_to_all_single = real_a2a
    chunks = sum(-(-n // CHUNK) for n in res.depth_counts) + eng.redone_chunks
    got = (res.distinct, res.total, res.depth, res.terminal)
    peak = torch.cuda.max_memory_allocated()
    print(f"[4j] Raft.cfg by ShardedBFS, D = {eng.D} over NCCL: distinct={res.distinct} "
          f"total={res.total} depth={res.depth} terminal={res.terminal} in {wall:.2f} s, the "
          f"engine's run {res.seconds:.2f} s ({chunks} chunks, {res.seconds * 1e3 / chunks:.3f} "
          f"ms/chunk), peak device memory "
          f"{peak / 2**30:.2f} GiB, all_to_all_single calls {a2a['calls']}")
    check(eng.D == 1 and res.violation_invariant is None and res.exhausted
          and got == EXHAUSTED, f"sharded exhaustion counts {got} != {EXHAUSTED}")
    check(res.depth_counts == main_res.depth_counts, "sharded depth counts != DeviceBFS's")
    check([r[:2] for r in res.coverage] == [r[:2] for r in main_res.coverage],
          "sharded enabled/fired coverage != DeviceBFS's")
    check(sum(r[2] for r in res.coverage) == sum(r[2] for r in main_res.coverage),
          "sharded new-distinct coverage total != DeviceBFS's")
    differ = sum(a[2] != b[2] for a, b in zip(res.coverage, main_res.coverage))
    check_path(launches, SHARDED_PATH, chunks, n_expand, n_sort, "4j")
    check(launches["owner_route"] == chunks,
          f"4j: {launches['owner_route']} owner_route launches != {chunks} chunks")
    check(a2a["calls"] == 2 * chunks, f"4j: {a2a['calls']} all_to_all_single calls != 2 x "
          f"{chunks} chunks")
    routed = sum(m["a2a_lanes"] for m in res.metrics)
    print(f"[4j] depth counts equal DeviceBFS's, enabled/fired coverage equal, new-distinct "
          f"per action differs in {differ} of {len(res.coverage)} actions (fingerprint-ordered "
          f"emit), total equal; owner_route one launch per chunk, all_to_all_single two; "
          f"{routed} lanes routed")
    report = {"launches": launches, "chunks": chunks, "wall_s": wall, "run_s": res.seconds,
              "ms_per_chunk": res.seconds * 1e3 / chunks, "a2a_calls": a2a["calls"],
              "a2a_lanes": routed, "peak_device_bytes": peak,
              "coverage_new_actions_differing": differ}

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "raft.npz")
        t = time.perf_counter()
        _, _, r1 = sharded(RAFT_CFG, max_depth=SHARD_CKPT_DEPTH, checkpoint_path=ck,
                           checkpoint_every_s=0.0)
        _, _, r2 = sharded(RAFT_CFG, resume=ck)
        check(r1.depth == SHARD_CKPT_DEPTH and not r1.exhausted, "checkpointed run's depth")
        check(r2.exhausted and (r2.distinct, r2.total, r2.depth, r2.terminal) == EXHAUSTED
              and r2.depth_counts == main_res.depth_counts,
              "the resumed sharded run's counts differ from the uninterrupted run's")
        print(f"[4j] checkpoint at depth {SHARD_CKPT_DEPTH}, resumed: exhausted at the same "
              f"counts ({time.perf_counter() - t:.1f} s)")
        cks = os.path.join(tmp, "small.npz")
        t = time.perf_counter()
        _, _, sg = sharded(SHARD_SMALL_CFG, chunk=1024)
        _, _, s1 = sharded(SHARD_SMALL_CFG, chunk=1024, max_depth=SHARD_SMALL_DEPTH,
                           checkpoint_path=cks, checkpoint_every_s=0.0)
        _, ec, sc = sharded(SHARD_SMALL_CFG, devices=2, device="cpu", chunk=1024, resume=cks)
        want = (sg.distinct, sg.total, sg.depth, sg.terminal, sg.depth_counts)
        check(s1.depth == SHARD_SMALL_DEPTH and ec.D == 2 and sc.exhausted
              and (sc.distinct, sc.total, sc.depth, sc.terminal, sc.depth_counts) == want,
              "two-server Raft: the card's D = 1 checkpoint resumed on the CPU at D = 2 "
              "differs from the card's uninterrupted run")
        print(f"[4j] two-server Raft checkpointed on the card at D = 1, depth "
              f"{SHARD_SMALL_DEPTH}, resumed on the CPU at D = 2 (gloo): {sc.distinct} "
              f"distinct, depth {sc.depth}, equal ({time.perf_counter() - t:.1f} s)")

    _, _, dv = run_check("FlexibleRaft.cfg", text=FLEX_CFG, device="cuda", chunk=1024)
    fsetup, fe, fv = sharded(FLEX_CFG, chunk=1024, cfg="FlexibleRaft.cfg")
    check(dv.violation is not None and fv.violation_invariant == dv.violation.invariant
          and fv.depth == dv.violation.depth and fv.distinct == dv.distinct,
          f"FlexibleRaft: sharded {fv.violation_invariant} at depth {fv.depth} != DeviceBFS "
          f"{dv.violation}")
    init, chain = fe.journal_chain(fe.violation_site)
    cpu_trace = replay_chain(fsetup.model, torch.device("cpu"), init, chain)
    check(len(fv.trace) == fv.depth + 1 and fv.trace[0][0] == "Initial predicate"
          and fv.trace == cpu_trace, "the sharded counterexample does not replay on the CPU")
    print(f"[4j] FlexibleRaft: {fv.violation_invariant} violated at depth {fv.depth} (DeviceBFS's "
          f"depth), its {len(fv.trace)}-state trace replayed on the card and the CPU")

    def traced_run():
        """(the engine's run seconds, the call's, chunks): the call adds
        the process group's set-up and the model's build."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, e, r = sharded(RAFT_CFG, max_depth=20)
        torch.cuda.synchronize()
        check((r.distinct, r.total, r.depth, r.terminal) == DEPTH20, "sharded depth-20 counts")
        return r.seconds, time.perf_counter() - t, sum(
            -(-n // CHUNK) for n in r.depth_counts[:-1]) + e.redone_chunks

    wall20, call20, chunks20 = traced_run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced20, _, _ = traced_run()
    trace = {"depth": 20, "chunks": chunks20, "wall_ms_per_chunk": wall20 * 1e3 / chunks20,
             "call_s": call20, "traced_wall_ms_per_chunk": traced20 * 1e3 / chunks20,
             # the host ops with the most self time (the chunk is host-bound)
             "host_self_ms_per_chunk_top": {
                 ev.key: ev.self_cpu_time_total / 1e3 / chunks20
                 for ev in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]}}
    dt = device_time(torch, prof, split_exchange=True)
    if dt is None:
        trace["device"] = "not measured: the tracer saw no device activity"
    else:
        busy, groups = dt
        trace.update({
            "device_ms_per_chunk": busy / chunks20,
            "device_busy_share_untraced": busy / (wall20 * 1e3),
            "device_ms_per_chunk_by_group": {
                k: v / chunks20 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}})
    print(json.dumps({"trace_sharded": trace}))
    report["trace"] = trace
    print(json.dumps({"sharded_run": {k: v for k, v in report.items() if k != "launches"}}))
    return report


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


def reconfig_liveness_phase(torch) -> dict:
    """Phase 8c: PROPERTY ReconfigurationCompletes. AddRemove at
    MaxElections 0 (ADDREMOVE_LIVE_CFG) on the card against the CPU
    (states, edge arrays, verdict), through ``run_liveness`` (the CLI's
    function) with the card's launch counts; then JointConsensus
    (JOINT_LIVE_CFG) on the card, held to the port's CPU run
    (JOINT_LIVE_PIN: scripts/pin_reconfig_liveness.py), through joint_guard,
    joint_apply and joint_predicates (P and Q once each)."""
    from raft_tpu_torch.__main__ import run_liveness

    t0, report = time.perf_counter(), {}
    for pre, spec, text, slots in (
            ("reconfig", "RaftWithReconfigAddRemove", ADDREMOVE_LIVE_CFG, 32),
            ("joint", "RaftWithReconfigJointConsensus", JOINT_LIVE_CFG, 40)):
        torch.cuda.empty_cache()
        (setup, checker, res), wall, launches, n_expand, _ = counted(
            torch, lambda: run_liveness(f"{spec}.cfg", text=text, device="cuda", chunk=1024,
                                        msg_slots=slots, lenient=True))
        chunks = checker.chunks
        for k in (f"{pre}_guard", "compact_append", f"{pre}_apply"):
            check(launches[k] == chunks, f"liveness {spec}: {launches[k]} {k} launches != "
                  f"{chunks} chunks")
        check(launches[f"{pre}_predicates"] == 2,
              f"liveness {spec}: {launches[f'{pre}_predicates']} {pre}_predicates launches "
              "!= 2 (P and Q)")
        path = (f"{pre}_guard", "compact_append", f"{pre}_apply", "hash_rows",
                f"{pre}_predicates")
        for k in set(KERNEL_NAMES) - set(path):
            check(launches[k] == 0, f"liveness {spec}: {k} launched off its path")
        check(n_expand == 0, f"liveness {spec}: the plain expand ran {n_expand} times")
        check(res.violation is None, f"liveness {spec}: ReconfigurationCompletes violated")
        got = {"states": res.distinct, "edges": res.total_edges, "holds": True}
        if pre == "reconfig":
            t = time.perf_counter()
            _, cc_, rc_ = run_liveness(f"{spec}.cfg", text=text, device="cpu", chunk=1024,
                                       msg_slots=slots, lenient=True)
            t_cpu = time.perf_counter() - t
            check((rc_.distinct, rc_.total_edges, rc_.violation) == (
                res.distinct, res.total_edges, res.violation),
                f"liveness {spec}: card {got} != CPU {(rc_.distinct, rc_.total_edges)}")
            for a in ("_esrc", "_edst", "_ecand"):
                check(np.array_equal(getattr(checker, a), getattr(cc_, a)),
                      f"liveness {spec}: {a} differ")
            check(torch.equal(checker._states.cpu(), cc_._states),
                  f"liveness {spec}: graph states differ")
            held = f"states, edge arrays and verdict: card == CPU (CPU {t_cpu:.1f} s)"
        else:
            check(got == JOINT_LIVE_PIN, f"liveness {spec}: {got} != the CPU run's "
                  f"{JOINT_LIVE_PIN}")
            held = "states, edges and verdict equal the port's CPU run (JOINT_LIVE_PIN)"
        report[spec] = dict(got, seconds=wall, chunks=chunks, launches=launches)
        print(f"[8c] liveness {spec} (MaxElections 0): graph {res.distinct} states / "
              f"{res.total_edges} edges in {wall:.2f} s ({chunks} chunks), "
              f"ReconfigurationCompletes holds; {held}")
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"liveness_reconfiguration": report}))
    return report


def kreconfig_liveness_phase(torch) -> dict:
    """Phase 8d: KRaftWithReconfig's ValuesNotStuck and
    ReconfigurationNotStuck on the 428-state universe (KRECONFIG_LIVE_CFG)
    through ``run_liveness`` (the CLI's function) on the card, with its
    launch counts (kreconfig_predicates once per property instance), against
    the CPU (states, edge arrays, verdicts) and the reference's graph size
    (KRECONFIG_LIVE_PIN); kreconfig_predicates held exactly against its
    plain version on the graph's states for every instance."""
    from raft_tpu_torch.__main__ import run_liveness
    from raft_tpu_torch.ops.expand import predicates, predicates_plain

    t0, spec = time.perf_counter(), "KRaftWithReconfig"
    kw = dict(text=KRECONFIG_LIVE_CFG, chunk=256, msg_slots=24)
    (setup, checker, res), wall, launches, n_expand, _ = counted(
        torch, lambda: run_liveness(f"{spec}.cfg", device="cuda", **kw))
    model, chunks = setup.model, checker.chunks
    names = tuple(q for prop in model.liveness.values() for _l, _p, q in prop)
    for k in ("kreconfig_guard", "compact_append", "kreconfig_apply"):
        check(launches[k] == chunks, f"liveness {spec}: {launches[k]} {k} launches != "
              f"{chunks} chunks")
    check(launches["kreconfig_predicates"] == len(names),
          f"liveness {spec}: {launches['kreconfig_predicates']} kreconfig_predicates launches "
          f"!= {len(names)} property instances")
    path = ("kreconfig_guard", "compact_append", "kreconfig_apply", "hash_rows",
            "kreconfig_predicates")
    for k in set(KERNEL_NAMES) - set(path):
        check(launches[k] == 0, f"liveness {spec}: {k} launched off its path")
    check(n_expand == 0, f"liveness {spec}: the plain expand ran {n_expand} times")
    t = time.perf_counter()
    _, cc, rc = run_liveness(f"{spec}.cfg", device="cpu", **kw)
    t_cpu = time.perf_counter() - t
    got = {"states": res.distinct, "edges": res.total_edges}
    check(got == KRECONFIG_LIVE_PIN and res.violation is None and rc.violation is None
          and (rc.distinct, rc.total_edges) == (res.distinct, res.total_edges),
          f"liveness {spec}: card {got} ({res.violation}), CPU {(rc.distinct, rc.total_edges)}"
          f" ({rc.violation}), the reference's {KRECONFIG_LIVE_PIN}")
    for a in ("_esrc", "_edst", "_ecand"):
        check(np.array_equal(getattr(checker, a), getattr(cc, a)), f"liveness {spec}: {a} differ")
    check(torch.equal(checker._states.cpu(), cc._states), f"liveness {spec}: states differ")
    err = exact(torch, predicates(model, checker._states, names),
                predicates_plain(model, checker._states, names))
    check(err == 0.0, "kreconfig_predicates differs from its plain version on the graph")
    report = dict(got, seconds=wall, cpu_seconds=t_cpu, chunks=chunks, launches=launches,
                  instances=list(names))
    print(f"[8d] liveness {spec}: graph {res.distinct} states / {res.total_edges} edges in "
          f"{wall:.2f} s ({chunks} chunks), ValuesNotStuck and ReconfigurationNotStuck hold "
          f"({len(names)} instances, one kreconfig_predicates launch each); states, edge arrays "
          f"and verdicts card == CPU (CPU {t_cpu:.1f} s) and the reference's graph size; "
          f"kreconfig_predicates exact on the graph's states")
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"liveness_kraft_reconfig": report}))
    return report


def sweep_phase(torch) -> dict:
    """Phase 9: fleet sweeps on the card through ``run_sweep`` (the
    function the sweep CLI calls) with every kernel's count read around
    each: (a) Raft.cfg's constants at MaxElections {1, 2}, exhausted, one
    packed group, its MaxElections-2 job at Raft.cfg's pinned counts; (b)
    the PullRaft stand-in at MaxElections {1, 2}, its MaxElections-2 job
    at the reference's counts; (c) Raft.cfg's at MaxElections {1, 2} x
    MaxRestarts {0, 1} to SWEEP_DEPTH and a KRaft.cfg job (a serial group),
    each job equal to a serial card run of its own constants; (d)
    manifests/kraft_reconfig_sim.json (a simulate group) through the CLI's
    ``sweep_main``. Each sweep runs one model per group (``precompiles`` =
    groups), no plain expand and no kernel off its families' paths."""
    import contextlib
    import io

    from raft_tpu_torch.__main__ import run_check
    from raft_tpu_torch.fleet import SweepOptions, parse_manifest_obj, run_sweep
    from raft_tpu_torch.fleet.cli import sweep_main

    t0, report = time.perf_counter(), {}
    opts = SweepOptions(device="cuda", chunk=CHUNK)

    def sweep(key, obj, paths, depth=None):
        torch.cuda.empty_cache()
        opts.max_depth = depth
        res, wall, launches, n_expand, n_sort = counted(
            torch, lambda: run_sweep(parse_manifest_obj(obj, f"<9{key}>"), opts))
        allowed = set().union(*paths)
        for k in allowed:
            check(launches[k] > 0, f"9{key}: {k} was never launched")
        for k in set(KERNEL_NAMES) - allowed:
            check(launches[k] == 0, f"9{key}: {k} launched off the sweep's paths")
        check(n_expand == 0 and n_sort == 0,
              f"9{key}: the plain expand ran {n_expand} times, torch sorted {n_sort} times")
        check(res.rc == 0 and res.precompiles == res.groups,
              f"9{key}: rc {res.rc}, amortization {res.amortization}")
        jobs = {j.name: j for j in res.jobs}
        report[key] = {"seconds": wall, "amortization": res.amortization, "launches": launches,
                       "jobs": [j.to_json() for j in res.jobs]}
        print(f"[9{key}] {len(jobs)} jobs in {res.groups} groups in {wall:.2f} s: "
              + "; ".join(f"{n} {j.distinct}/{j.total}/{j.depth}/{j.terminal}"
                          for n, j in jobs.items()))
        return jobs

    def serial(text, spec, consts, depth, slots, lenient=False):
        for k, v in consts.items():
            text = re.sub(rf"{k} = \d+", f"{k} = {v}", text)
        r = run_check(f"{spec}.cfg", text=text, device="cuda", chunk=CHUNK, max_depth=depth,
                      msg_slots=slots, lenient=lenient)[2]
        return (r.distinct, r.total, r.depth, r.terminal)

    def counts(j):
        return (j.distinct, j.total, j.depth, j.terminal)

    # (a) Raft.cfg at MaxElections {1, 2}, exhausted
    jobs = sweep("a", sweep_manifest(RAFT_CFG, "Raft", {"MaxElections": [1, 2]}, 48),
                 [RAFT3_PATH])
    check(counts(jobs["Raft-MaxElections=2"]) == EXHAUSTED,
          f"9a: the MaxElections-2 job {counts(jobs['Raft-MaxElections=2'])} != {EXHAUSTED}")
    one = serial(RAFT_CFG, "Raft", {"MaxElections": 1}, None, 48)
    check(counts(jobs["Raft-MaxElections=1"]) == one, f"9a: the MaxElections-1 job != {one}")
    # (b) the PullRaft stand-in at MaxElections {1, 2}, exhausted
    jobs = sweep("b", sweep_manifest(PULL_CFG, "PullRaft", {"MaxElections": [1, 2]}, 64),
                 [PULL_PATH])
    pin = (PULL_PIN["distinct"], PULL_PIN["total"], len(PULL_PIN["depth_counts"]) - 1,
           PULL_PIN["terminal"])
    check(counts(jobs["PullRaft-MaxElections=2"]) == pin,
          f"9b: the MaxElections-2 job {counts(jobs['PullRaft-MaxElections=2'])} != {pin}")
    # (c) Raft.cfg at MaxElections {1, 2} x MaxRestarts {0, 1} and a KRaft.cfg
    # job, to SWEEP_DEPTH, each against a serial run of its constants
    kraft = sweep_manifest(KRAFT_CFG, "KRaft", {}, 80)["defaults"]
    obj = sweep_manifest(RAFT_CFG, "Raft", {"MaxElections": [1, 2], "MaxRestarts": [0, 1]}, 48,
                         jobs=[dict(kraft, name="KRaft.cfg", spec="KRaft")])
    jobs = sweep("c", obj, [RAFT3_PATH, KRAFT_PATH], depth=SWEEP_DEPTH)
    for me in (1, 2):
        for mr in (0, 1):
            name = f"Raft-MaxElections={me}-MaxRestarts={mr}"
            want = serial(RAFT_CFG, "Raft", {"MaxElections": me, "MaxRestarts": mr},
                          SWEEP_DEPTH, 48)
            check(counts(jobs[name]) == want, f"9c: {name} {counts(jobs[name])} != serial {want}")
    want = serial(KRAFT_CFG, "KRaft", {}, SWEEP_DEPTH, 80)
    check(counts(jobs["KRaft.cfg"]) == want, f"9c: the KRaft job != serial {want}")
    print(f"[9c] every job equals a serial card run of its own constants to depth {SWEEP_DEPTH}")
    # (d) the repo's simulate manifest through the CLI's sweep_main
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "manifests",
                        "kraft_reconfig_sim.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, wall, launches, n_expand, _ = counted(
            torch, lambda: sweep_main([path, "--json", "--device", "cuda"]))
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    agg = lines[-1]
    check(rc == 0 and agg["rc"] == 0 and agg["amortization"]["groups"] == 1
          and agg["amortization"]["precompiles"] == 1
          and [j["mode"] for j in lines[:-1]] == ["simulate"] * 3
          and all(j["behaviors"] > 0 for j in lines[:-1]) and n_expand == 0,
          f"9d: rc {rc}, {agg}")
    for k in ("kreconfig_guard", "kreconfig_apply", "kreconfig_sim_check", "sim_pick"):
        check(launches[k] > 0, f"9d: {k} was never launched")
    report["d"] = {"seconds": wall, "amortization": agg["amortization"], "jobs": lines[:-1]}
    print(f"[9d] {path}: rc 0, {len(lines) - 1} simulate jobs in one group in {wall:.2f} s: "
          + "; ".join(f"{j['job']} behaviors={j['behaviors']} steps={j['steps']}"
                      for j in lines[:-1]))
    report["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"sweep": report}))
    return report


def main() -> int:
    t_start = time.perf_counter()
    phase_start = {}  # phase -> its start on the host clock

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(1, os.path.join(here, "tests"))  # the reconfiguration edge rows
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import raft_tpu_torch next to chip_smoke.py: {e}")
    from raft_tpu_torch import kernels
    from raft_tpu_torch.__main__ import run_check
    from raft_tpu_torch.checker.lsm import merge_runs, merge_runs_plain
    from raft_tpu_torch.checker.util import (
        append_rows, append_rows_plain, compact_indices, dense_prefix_sel,
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
        # all hits: the raw keys alone, each memo row read once
        warm_bound_ms=max((cold_bytes - slots * 16) / MEM_BPS,
                          cold_ops / (1 + P) / INT32_OPS) * 1e3,
        library_ms=None, max_abs_err=max(errs),
    )

    # chunk_dedup: VC lanes against a 2^24-lane seen run plus ladder runs
    # of VC, 2 VC and 4 VC lanes (each half filled), half the lanes present;
    # keys over the whole int64 range, as fingerprints (uniform 64-bit
    # hashes) are
    def sorted_run(n_real, size):
        v = torch.randint(-(1 << 63), (1 << 63) - 1, (n_real,), dtype=torch.int64, device=dev)
        pad = torch.full((size - n_real,), INT64_MAX, dtype=torch.int64, device=dev)
        return torch.cat([torch.sort(v).values, pad])

    seen = sorted_run(8_000_000, 1 << 24)
    ladder = [sorted_run(n // 2, n) for n in (VC, VC << 1, VC << 2)]
    runs = [seen] + ladder
    present = torch.cat([seen[:8_000_000], *[r[: r.numel() // 2] for r in ladder]])
    q = torch.randint(-(1 << 63), (1 << 63) - 1, (VC,), dtype=torch.int64, device=dev)
    pick = torch.randint(0, present.numel(), (VC // 2,), device=dev)
    q[: VC // 2] = present[pick]
    q[-16:] = INT64_MAX
    q = q[torch.randperm(VC, device=dev)]
    rows["chunk_dedup"] = chunk_dedup_row(torch, q, runs, VC, timed=True)
    check(0.45 * VC < rows["chunk_dedup"]["new"] < 0.55 * VC, "chunk_dedup: about half present")

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

    # chunk_dedup on a chunk of the Raft.cfg main path against its seen
    # run (timed); canon_tiered, canon_signatures and chunk_dedup on a chunk
    # of the five-server frontier at depth RAFT5_SAMPLE_DEPTH (timed)
    flatc3, selv3, fps3 = chunk_lanes(torch, bfs20, pool, rng)
    # canon_memo on the chunk's worklist: its valid prefix, then the invalid tail
    rows["canon_memo"]["worklist"] = memo_worklist(torch, canon, flatc3, selv3, "Raft.cfg")
    rows["chunk_dedup"]["raft_chunk"] = chunk_dedup_row(torch, fps3, [bfs20._seen], bfs20.R0,
                                                        timed=True)
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
    rows.update(owner_route_rows(torch, bfs20, pool, rng))
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
    flatc5, selv5, fps5 = chunk_lanes(torch, bfs5s, pool5, rng)
    rows.update(tiered_rows(torch, bfs5s.canon, flatc5, selv5, timed=True))
    dedup5 = chunk_dedup_row(torch, fps5, [bfs5s._seen], bfs5s.R0, timed=True)
    del bfs5s, flatc5
    # the pull and KRaft kernels: chunks of the PullRaft, Variant2 and
    # KRaft.cfg frontiers, and edge rows
    rows.update(family_kernel_rows(torch, rng, PULL_FAM))
    rows.update(family_kernel_rows(torch, rng, KRAFT_FAM))
    rows.update(family_kernel_rows(torch, rng, RECONFIG_FAM))
    rows.update(family_kernel_rows(torch, rng, JOINT_FAM))
    rows.update(family_kernel_rows(torch, rng, KRECONFIG_FAM))
    # the network-fault arms at Raft.cfg's width, and the fleet lanes' reads
    rows.update(net_fault_kernel_rows(torch, rng))
    rows.update(fleet_kernel_rows(torch, rng))
    for k, r in rows.items():
        print(f"[3] {k}: exact; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; warm (all hits) {r['warm_ms']:.4f} ms" if "warm_ms" in r else "")
              + (f", bound {r['warm_bound_ms']:.4f} ms" if "warm_bound_ms" in r else "")
              + (f"; bounds over all {r['lanes']} lanes ({r['valid']} valid): cold "
                 f"{r['bound_all_lanes_ms']:.4f} ms, warm {r['warm_bound_all_lanes_ms']:.4f} ms; "
                 f"{r['warps_per_sm']} warps an SM" if "bound_all_lanes_ms" in r else "")
              + (f"; append_rows {r['rows_ms']:.4f} ms vs plain {r['rows_plain_ms']:.4f}"
                 f" ms, bound {r['rows_bound_ms']:.4f} ms" if "rows_ms" in r else "")
              + (f"; G {r['G']} threads a {r.get('per', 'lane')}, {r['warps_per_sm']} warps an SM "
                 f"({r['registers']} registers, {r['stack_bytes']} stack bytes a thread); bound "
                 f"from {r['bytes']} bytes ({r['bytes'] / MEM_BPS * 1e3:.4f} ms) and "
                 f"{r['operations']} operations ({r['operations'] / INT32_OPS * 1e3:.4f} ms)"
                 if "G" in r else ""))
    print(json.dumps({"chunk_dedup": rows["chunk_dedup"], "chunk_dedup_five_servers": dedup5}))
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
    raft_main = res

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

    phase_start["4e"] = time.perf_counter()
    # ---- 4e, 4f. the reconfiguration specs on the main path ----
    reconfig_report = family_main_phase(torch, RECONFIG_FAM)
    phase_start["4f"] = time.perf_counter()
    joint_report = family_main_phase(torch, JOINT_FAM)
    phase_start["4g"] = time.perf_counter()
    # ---- 4g. KRaftWithReconfig on the main path ----
    kreconfig_report = family_main_phase(torch, KRECONFIG_FAM)
    phase_start["4h"] = time.perf_counter()
    # ---- 4h. Raft.cfg with --net-faults on the main path ----
    nf_report = family_main_phase(torch, NF_FAM)

    phase_start["4i"] = time.perf_counter()
    # ---- 4i. the reconfiguration specs at five servers ----
    five_report = five_reconfig_phase(torch)

    phase_start["4j"] = time.perf_counter()
    # ---- 4j. Raft.cfg by the sharded engine at D = 1 over NCCL ----
    sharded_report = sharded_phase(torch, raft_main)

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
    for key, fam in (("reconfig", RECONFIG_FAM), ("joint", JOINT_FAM)):
        spec, pin, _d = fam["specs"][0]
        dpin = len(pin["depth_counts"]) - 1
        traces[key], rr = trace_run(
            torch, f"{spec}.cfg", fam["cfg"], dpin,
            (pin["distinct"], pin["total"], dpin, pin["terminal"]), lenient=True,
            caps=fam["caps"])
        check(rr.depth_counts == pin["depth_counts"] and rr.coverage == pin["coverage"],
              f"{spec} depth counts or coverage at the pinned depth differ from the reference's")
        print(f"[6] {spec} depth {dpin}: distinct, total, depth counts and coverage equal the "
              f"reference's, {traces[key]['chunks']} chunks, "
              f"{traces[key]['wall_ms_per_chunk']:.3f} ms/chunk wall")
        print(json.dumps({f"trace_{key}": traces[key]}))
    phase_start["6g"] = time.perf_counter()  # 4g's column
    kpin = len(KRECONFIG_PIN["depth_counts"]) - 1
    traces["kreconfig"], rr = trace_run(
        torch, "KRaftWithReconfig.cfg", KRAFT_RECONFIG_CFG, kpin,
        (KRECONFIG_PIN["distinct"], KRECONFIG_PIN["total"], kpin, KRECONFIG_PIN["terminal"]),
        lenient=True)
    check(rr.depth_counts == KRECONFIG_PIN["depth_counts"]
          and rr.coverage == KRECONFIG_PIN["coverage"],
          "KRaftWithReconfig depth counts or coverage at the pinned depth differ from the "
          "reference's")
    print(f"[6] KRaftWithReconfig depth {kpin}: distinct, total, depth counts and coverage equal "
          f"the reference's, {traces['kreconfig']['chunks']} chunks, "
          f"{traces['kreconfig']['wall_ms_per_chunk']:.3f} ms/chunk wall")
    print(json.dumps({"trace_kreconfig": traces["kreconfig"]}))
    phase_start["6h"] = time.perf_counter()  # 4h's column
    npin = len(NF_PIN["depth_counts"]) - 1
    traces["net_faults"], rn = trace_run(
        torch, "Raft.cfg", RAFT_CFG, npin,
        (NF_PIN["distinct"], NF_PIN["total"], npin, NF_PIN["terminal"]), net_faults=True)
    check(rn.depth_counts == NF_PIN["depth_counts"] and rn.coverage == NF_PIN["coverage"],
          "Raft.cfg --net-faults depth counts or coverage at the pinned depth differ from the "
          "reference's")
    print(f"[6] Raft.cfg --net-faults depth {npin}: distinct, total, depth counts and coverage "
          f"equal the reference's, {traces['net_faults']['chunks']} chunks, "
          f"{traces['net_faults']['wall_ms_per_chunk']:.3f} ms/chunk wall")
    print(json.dumps({"trace_net_faults": traces["net_faults"]}))

    phase_start["7"] = time.perf_counter()
    # ---- 7. simulate ----
    sim_report = simulate_phase(torch)

    phase_start["7b"] = time.perf_counter()
    # ---- 7b. simulate the pull family ----
    pull_sim_report = family_simulate_phase(torch, PULL_FAM)

    phase_start["7c"] = time.perf_counter()
    # ---- 7c. simulate KRaft ----
    kraft_sim_report = family_simulate_phase(torch, KRAFT_FAM)

    phase_start["7d"] = time.perf_counter()
    # ---- 7d, 7e. simulate the reconfiguration specs ----
    reconfig_sim_report = family_simulate_phase(torch, RECONFIG_FAM)
    phase_start["7e"] = time.perf_counter()
    joint_sim_report = family_simulate_phase(torch, JOINT_FAM)
    phase_start["7f"] = time.perf_counter()
    # ---- 7f. simulate KRaftWithReconfig (the mode its cfg prescribes) ----
    kreconfig_sim_report = family_simulate_phase(torch, KRECONFIG_FAM)
    phase_start["7g"] = time.perf_counter()
    # ---- 7g. simulate Raft.cfg with --net-faults ----
    family_simulate_phase(torch, NF_FAM)

    phase_start["8"] = time.perf_counter()
    # ---- 8. liveness ----
    live_report = liveness_phase(torch, LIVE_RAFT)
    rows["raft_predicates"] = live_report.pop("raft_predicates")

    phase_start["8b"] = time.perf_counter()
    # ---- 8b. KRaft liveness ----
    kraft_live_report = liveness_phase(torch, LIVE_KRAFT)
    kraft_live_report.pop("kraft_predicates")

    phase_start["8c"] = time.perf_counter()
    # ---- 8c. ReconfigurationCompletes ----
    reconfig_liveness_phase(torch)

    phase_start["8d"] = time.perf_counter()
    # ---- 8d. ValuesNotStuck and ReconfigurationNotStuck ----
    kreconfig_liveness_phase(torch)

    phase_start["9"] = time.perf_counter()
    # ---- 9. fleet sweeps ----
    sweep_report = sweep_phase(torch)

    phase_start["10"] = time.perf_counter()
    # ---- 10. results ----
    meta = {
        "canon_memo": ("raft_tpu_torch/csrc/canon_memo.cu", "raft_tpu/ops/symmetry.py:1230"),
        # canon_memo's general path (N-word keys, member-set fields, P = 24)
        # at the four-server reconfiguration shapes
        "canon_memo[addremove4]": ("raft_tpu_torch/csrc/canon_memo.cu",
                                   "raft_tpu/ops/symmetry.py:1230"),
        "canon_memo[joint4]": ("raft_tpu_torch/csrc/canon_memo.cu",
                               "raft_tpu/ops/symmetry.py:1230"),
        "chunk_dedup": ("raft_tpu_torch/csrc/chunk_dedup.cu",
                        "raft_tpu/checker/device_bfs.py:401"),
        "compact_append": ("raft_tpu_torch/csrc/compact_append.cu",
                           "raft_tpu/checker/util.py:48"),
        "merge_runs": ("raft_tpu_torch/csrc/merge_runs.cu",
                       "raft_tpu/checker/device_bfs.py:285"),
        "raft_guard": ("raft_tpu_torch/csrc/raft_expand.cu", "raft_tpu/models/base.py:332"),
        "raft_apply": ("raft_tpu_torch/csrc/raft_expand.cu", "raft_tpu/models/base.py:426"),
        "raft_fold": ("raft_tpu_torch/csrc/raft_fold.cu",
                      "raft_tpu/checker/device_bfs.py:501"),
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
        **{k: v for fam in ("reconfig", "joint") for k, v in (
            (f"{fam}_guard", (f"raft_tpu_torch/csrc/{fam}_expand.cu",
                              "raft_tpu/models/config_common.py:702")),
            (f"{fam}_apply", (f"raft_tpu_torch/csrc/{fam}_expand.cu",
                              "raft_tpu/models/base.py:426")),
            (f"{fam}_fold", (f"raft_tpu_torch/csrc/{fam}_fold.cu",
                             "raft_tpu/checker/device_bfs.py:501")),
            (f"{fam}_sim_check", (f"raft_tpu_torch/csrc/{fam}_predicates.cu",
                                  "raft_tpu/checker/simulate.py:93")),
            (f"{fam}_predicates", (f"raft_tpu_torch/csrc/{fam}_predicates.cu",
                                   "raft_tpu/checker/liveness.py:254")))},
        "kreconfig_guard": ("raft_tpu_torch/csrc/kreconfig_expand.cu",
                            "raft_tpu/models/kraft_reconfig.py:1446"),
        "kreconfig_apply": ("raft_tpu_torch/csrc/kreconfig_expand.cu",
                            "raft_tpu/models/base.py:426"),
        "kreconfig_fold": ("raft_tpu_torch/csrc/kreconfig_fold.cu",
                           "raft_tpu/checker/device_bfs.py:501"),
        "kreconfig_sim_check": ("raft_tpu_torch/csrc/kreconfig_predicates.cu",
                                "raft_tpu/checker/simulate.py:93"),
        "kreconfig_predicates": ("raft_tpu_torch/csrc/kreconfig_predicates.cu",
                                 "raft_tpu/checker/liveness.py:254"),
        "slot_canon": ("raft_tpu_torch/csrc/slot_canon.cu",
                       "raft_tpu/models/kraft_reconfig.py:2059"),
        "owner_route": ("raft_tpu_torch/csrc/owner_route.cu",
                        "raft_tpu/parallel/sharded.py:576"),
        # the network-fault groups' arms and the fleet lanes' reads in the
        # Raft and pull kernels
        "raft_guard[net_faults]": ("raft_tpu_torch/csrc/raft_expand.cu",
                                   "raft_tpu/models/raft.py:583"),
        "raft_apply[net_faults]": ("raft_tpu_torch/csrc/raft_expand.cu",
                                   "raft_tpu/models/raft.py:597"),
        "raft_guard[fleet]": ("raft_tpu_torch/csrc/raft_expand.cu",
                              "raft_tpu/models/base.py:217"),
        "pull_guard[fleet]": ("raft_tpu_torch/csrc/pull_expand.cu",
                              "raft_tpu/models/pull_raft.py:269"),
        # the group apply at the five-server reconfiguration shapes
        "reconfig_apply[addremove5]": ("raft_tpu_torch/csrc/reconfig_expand.cu",
                                       "raft_tpu/models/base.py:426"),
        "joint_apply[joint5]": ("raft_tpu_torch/csrc/joint_expand.cu",
                                "raft_tpu/models/base.py:426"),
        # canon_tiered's general path (N-word keys, member-set fields) at
        # the five-server reconfiguration shapes
        **{f"{k}[{tag}]": (meta_src, f"raft_tpu/ops/symmetry.py:{line}")
           for tag in ("addremove5", "joint5")
           for k, meta_src, line in (("canon_tiered", "raft_tpu_torch/csrc/canon_tiered.cu", 823),
                                     ("canon_signatures", "raft_tpu_torch/csrc/canon_tiered.cu",
                                      581))},
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
                        for k in ("kraft_sim_check", "kraft_predicates")},
                     **{k: rep["launches"][k] for rep, path in (
                         (reconfig_report, RECONFIG_PATH), (joint_report, JOINT_PATH))
                        for k in path if k.startswith(("reconfig_", "joint_"))},
                     **{k: rep["launches"][k] for rep, fam in (
                         (reconfig_sim_report, "reconfig"), (joint_sim_report, "joint"),
                         (kreconfig_sim_report, "kreconfig"))
                        for k in (f"{fam}_sim_check", f"{fam}_predicates")},
                     **{k: kreconfig_report["launches"][k] for k in KRECONFIG_PATH
                        if k.startswith(("kreconfig_", "slot_canon"))},
                     # 4h's run; the packed groups of sweeps 9a and 9b
                     "raft_guard[net_faults]": nf_report["launches"]["raft_guard"],
                     "raft_apply[net_faults]": nf_report["launches"]["raft_apply"],
                     "raft_guard[fleet]": sweep_report["a"]["launches"]["raft_guard"],
                     "pull_guard[fleet]": sweep_report["b"]["launches"]["pull_guard"],
                     # 4i's AddRemove run and its JointConsensus card run
                     "canon_tiered[addremove5]": five_report["launches"]["canon_tiered"],
                     "canon_tiered[joint5]": five_report["joint5"]["launches"]["canon_tiered"],
                     "canon_signatures[addremove5]": 0, "canon_signatures[joint5]": 0,
                     "reconfig_apply[addremove5]": five_report["launches"]["reconfig_apply"],
                     "joint_apply[joint5]": five_report["joint5"]["launches"]["joint_apply"],
                     # 4e's and 4f's runs
                     "canon_memo[addremove4]": reconfig_report["launches"]["canon_memo"],
                     "canon_memo[joint4]": joint_report["launches"]["canon_memo"],
                     # 4j's exhaustion
                     "owner_route": sharded_report["launches"]["owner_route"]}
    table = [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": path_launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for k, r in rows.items()
    ]
    check(len(table) == len(KERNEL_NAMES) + 12, f"{len(table)} kernels in the table")
    tags = list(phase_start)
    phase_s = {t: round(phase_start[n] - phase_start[t], 1) for t, n in zip(tags, tags[1:])}
    print(json.dumps({"phase_seconds": phase_s}))
    print(f"[10] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"torch_sort": sort_row}))
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
