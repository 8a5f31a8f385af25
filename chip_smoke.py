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
     chunk too;
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
  5. FlexibleRaft with quorums that need not intersect (3 servers,
     ElectionQuorumSize 2, ReplicationQuorumSize 1): the
     LeaderHasAllAckedValues violation, its gid, depth and trace on the
     card equal the CPU run's;
  5b. RaftFsync (3 servers, the reference cfg's fsync policy) to depth
     24, and 5c. five-server FlexibleRaft at the published quorums to
     FLEX5_DEPTH: counts, depth counts and coverage on the card equal the
     CPU run's;
  6. where the time goes: Raft.cfg to depth 20 and five-server Raft to
     the pinned depth 11 (its distinct, total, depth counts and coverage
     equal to the reference's), each once untraced (wall per chunk) and
     once under torch.profiler (device time per chunk by kernel group,
     the device's busy share);
  7. the kernel table as one JSON line, the card's name and power limit,
     and the result line.
"""

from __future__ import annotations

import itertools
import json
import os
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
FSYNC_DEPTH = 24

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
FLEX5_DEPTH = 9
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
}
# the kernels each path launches (canon_signatures serves the checks only)
RAFT3_PATH = ("canon_memo", "probe_runs", "compact_append", "merge_runs", "raft_guard",
              "raft_apply", "raft_fold", "chunk_sort")
RAFT5_PATH = tuple(k if k != "canon_memo" else "canon_tiered" for k in RAFT3_PATH)
# state fields the invariants of the cfgs here read (NoLogDivergence,
# LeaderHasAllAckedValues): the part of a row raft_fold must load
INVARIANT_FIELDS = ("currentTerm", "state", "log_term", "log_value", "commitIndex", "acked")


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


def expand_kernels(torch, bfs, pool, rng, timed: bool) -> dict:
    """raft_guard, raft_apply and raft_fold against their plain versions
    on one chunk of CHUNK states drawn from ``pool`` (reachable states of
    ``bfs``'s model), at the engine's worklist width, exactly; the fold
    gets the chunk's real new lanes (canonical fingerprints deduplicated
    against ``bfs``'s seen run). With ``timed``, also the CUDA-event
    times of each kernel and its plain version and the bounds. Returns
    {kernel: row}."""
    from raft_tpu_torch.checker.util import I32_MAX, compact_indices
    from raft_tpu_torch.models.raft import (
        R_ACCEPT_AE, R_HANDLE_RVREQ, R_REJECT_AE, SPEC_LEN,
    )
    from raft_tpu_torch.ops.expand import (
        raft_apply, raft_apply_plain, raft_fold, raft_fold_plain, raft_guard,
        raft_guard_plain,
    )
    from raft_tpu_torch.ops.hashing import INT64_MAX

    model, dev = bfs.model, bfs.device
    C, VC, A, W = CHUNK, bfs.VC, model.A, model.layout.W
    S, M = model.p.n_servers, model.p.msg_slots
    K = len(model.ACTION_NAMES)
    batch = torch.from_numpy(np.ascontiguousarray(pool[rng.integers(0, len(pool), C)])).to(dev)
    zcov = lambda: torch.zeros((K, 3), dtype=torch.int64, device=dev)  # noqa: E731
    errs = []
    for n_live in (C - 1000, C):  # a dead chunk tail, then a full chunk
        cov_k, cov_p = zcov(), zcov()
        gk = raft_guard(model, batch, n_live, cov_k)
        gp = raft_guard_plain(model, batch, n_live, cov_p)
        errs += [exact(torch, a, b) for a, b in zip(gk, gp)] + [exact(torch, cov_k, cov_p)]
    valid, rank, _ovf, scal = gk
    sel, n_valid = compact_indices(valid.reshape(-1), VC, C * A)
    check(int(n_valid) <= VC, f"{int(n_valid)} valid lanes exceed the {VC}-lane worklist")
    flatc = raft_apply(model, batch, sel)
    errs.append(exact(torch, flatc, raft_apply_plain(model, batch, sel)))
    memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
    fps, _ = bfs.canon.fingerprints_memo(flatc, sel < C * A, memo)
    new, _ = bfs._st_dedup(fps, [bfs._seen])
    jcount = torch.tensor([123_456], dtype=torch.int64, device=dev)
    invs = bfs.invariants
    fold_args = dict(cov=None, sel=sel, valid=valid, rank=rank)
    outs = []
    for fold in (raft_fold, raft_fold_plain):
        viol = torch.full((len(invs),), I32_MAX, dtype=torch.int64, device=dev)
        fold_args["cov"] = zcov()
        fold(model, flatc, new, jcount, viol, invs, **fold_args)
        outs.append((viol, fold_args["cov"]))
    errs += [exact(torch, outs[0][0], outs[1][0]), exact(torch, outs[0][1], outs[1][1])]
    err = max(errs)
    check(err == 0.0, f"{model.name}: raft_guard/raft_apply/raft_fold differ from their "
          "plain versions")
    n_new = int(new.sum())
    print(f"[3] {model.name}: raft_guard, raft_apply, raft_fold exact on {C} states "
          f"({int(n_valid)} valid lanes, {n_new} new, first bad journal index "
          f"{outs[0][0].tolist()})")
    if not timed:
        return {}
    # bounds. guard: the state rows read, valid/rank/ovf written; its
    # operations at least 3 per bag slot (two equality compares and an
    # order compare) for every put a valid lane makes (RequestVote makes
    # S - 1, RequestVotePair, AppendEntries and a replying message one)
    rv = torch.tensor([b[0] == "RequestVote" for b in model.bindings], device=dev)
    one_put = torch.tensor([b[0] in ("RequestVotePair", "AppendEntries") for b in model.bindings],
                           device=dev)
    puts = (valid & rv).sum() * (S - 1) + (valid & one_put).sum() + (
        valid & ((rank == R_HANDLE_RVREQ) | (rank == R_REJECT_AE) | (rank == R_ACCEPT_AE))).sum()
    guard_bytes = C * W * 4 + C * A * 6 + (SPEC_LEN + 4 * A) * 4
    guard_ops = 3 * M * int(puts)
    # apply: the worklist and each source row read once, the block written
    n_src = torch.unique(sel[sel < C * A] // A).numel()
    apply_bytes = VC * 4 + n_src * W * 4 + VC * W * 4
    # fold: new read for every lane; a lane that is not new stops there,
    # so only the new lanes read sel, then the valid and rank it points
    # at, and the invariants' fields of their rows
    inv_lanes = sum(model.layout.fields[f].size for f in INVARIANT_FIELDS)
    fold_bytes = VC + n_new * (4 + 1 + 4 + 4 * inv_lanes)
    cov, viol = zcov(), torch.full((len(invs),), I32_MAX, dtype=torch.int64, device=dev)
    rows = {
        "raft_guard": dict(
            ms=time_ms(torch, lambda: raft_guard(model, batch, C, cov), iters=50),
            plain_ms=time_ms(torch, lambda: raft_guard_plain(model, batch, C, cov), iters=5),
            bound_ms=max(guard_bytes / MEM_BPS, guard_ops / INT32_OPS) * 1e3,
            bound_by="operations" if guard_ops / INT32_OPS > guard_bytes / MEM_BPS else "bytes",
            puts=int(puts)),
        "raft_apply": dict(
            ms=time_ms(torch, lambda: raft_apply(model, batch, sel), iters=50),
            plain_ms=time_ms(torch, lambda: raft_apply_plain(model, batch, sel), iters=5),
            bound_ms=apply_bytes / MEM_BPS * 1e3, bound_by="bytes"),
        "raft_fold": dict(
            ms=time_ms(torch, lambda: raft_fold(model, flatc, new, jcount, viol, invs, cov=cov,
                                                sel=sel, valid=valid, rank=rank), iters=50),
            plain_ms=time_ms(torch, lambda: raft_fold_plain(
                model, flatc, new, jcount, viol, invs, cov=cov, sel=sel, valid=valid,
                rank=rank), iters=20),
            bound_ms=fold_bytes / MEM_BPS * 1e3, bound_by="bytes"),
    }
    for r in rows.values():
        r.update(library_ms=None, max_abs_err=err)
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


def counted_run(torch, cfg_name, text, **kw):
    """run_check on the card with every kernel's count set to 0 just
    before and read just after, the plain RaftModel.expand and torch's
    sorts counted by wrapping them for the length of the run. Returns
    (setup, bfs, res, wall s, launches, expand calls, sort calls)."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.__main__ import run_check
    from raft_tpu_torch.models.raft import RaftModel

    calls = {"expand": 0, "sort": 0}
    saved = {"expand": RaftModel.expand, "sort": (torch.sort, torch.argsort, torch.Tensor.sort,
                                                    torch.Tensor.argsort)}

    def counting(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    RaftModel.expand = counting(saved["expand"], "expand")
    torch.sort, torch.argsort = (counting(f, "sort") for f in saved["sort"][:2])
    torch.Tensor.sort, torch.Tensor.argsort = (counting(f, "sort") for f in saved["sort"][2:])
    kernels.reset_counts()
    try:
        t = time.perf_counter()
        setup, bfs, res = run_check(cfg_name, text=text, device="cuda", chunk=CHUNK, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
    finally:
        RaftModel.expand = saved["expand"]
        torch.sort, torch.argsort = saved["sort"][:2]
        torch.Tensor.sort, torch.Tensor.argsort = saved["sort"][2:]
    return setup, bfs, res, wall, launches, calls["expand"], calls["sort"]


def check_path(launches, path, chunks, expand_calls, sort_calls, name):
    """Every kernel of ``path`` launched, the per-chunk kernels once per
    chunk, the canon and the fold once more for the initial states, and
    neither the plain expand nor a torch sort on the path."""
    for k in path:
        check(launches[k] > 0, f"{name}: kernel {k} was never launched on the path")
    for k in ("probe_runs", "raft_guard", "raft_apply", "chunk_sort"):
        check(launches[k] == chunks, f"{name}: {launches[k]} {k} launches != {chunks} chunks")
    check(launches["raft_fold"] == chunks + 1,
          f"{name}: {launches['raft_fold']} raft_fold launches != {chunks} chunks + 1")
    canon = path[0]
    check(launches[canon] == chunks + 1,
          f"{name}: {launches[canon]} {canon} launches != {chunks} chunks + 1")
    for k in set(KERNEL_NAMES) - set(path):
        check(launches[k] == 0, f"{name}: {k} launched off its path")
    check(expand_calls == 0, f"{name}: the plain RaftModel.expand ran {expand_calls} times")
    check(sort_calls == 0, f"{name}: torch sorted {sort_calls} times on the chunk path")
    print(f"[{name}] raft_guard, raft_apply, probe_runs, chunk_sort: one launch per chunk; "
          f"{canon}, raft_fold: one per chunk and one for the initial states; "
          f"RaftModel.expand called {expand_calls} times, torch sorts {sort_calls}")


def trace_run(torch, cfg_name, text, depth, want, **kw) -> dict:
    """The CLI's function to ``depth`` once untraced (wall per chunk) and
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
        chunks = sum(-(-n // CHUNK) for n in r.depth_counts[:-1]) + b.redone_chunks
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
        g = next((k for k, names in KERNEL_NAMES.items()
                  if any(n in ev.name for n in names)), None)
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


def main() -> int:
    t_start = time.perf_counter()

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

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[1] device: {name} (count {count}); nvidia-smi: {smi}")

    # ---- 2. build ----
    t = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t
    print(f"[2] built {len(logs)} kernels in {build_s:.1f} s")
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
    flatc3, _, fps3, fresh3 = chunk_lanes(torch, bfs20, pool, rng)
    rows["chunk_sort"] = chunk_sort_row(torch, fps3, fresh3, bfs20.R0, timed=True)
    # the signatures are defined for any server count: canon_signatures on
    # the Raft.cfg chunk too (its canon stays canon_memo's full-S! min)
    check(exact(torch, canon.signatures(flatc3), canon.signatures_plain(flatc3)) == 0.0,
          "canon_signatures differs from its plain version at three servers")
    print(f"[3] canon_signatures exact on the Raft.cfg chunk ({flatc3.shape[0]} lanes)")
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
    for k, r in rows.items():
        print(f"[3] {k}: exact; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; warm (all hits) {r['warm_ms']:.4f} ms" if "warm_ms" in r else "")
              + (f", bound {r['warm_bound_ms']:.4f} ms" if "warm_bound_ms" in r else "")
              + (f"; append_rows {r['rows_ms']:.4f} ms vs plain {r['rows_plain_ms']:.4f}"
                 f" ms, bound {r['rows_bound_ms']:.4f} ms" if "rows_ms" in r else ""))
    print(json.dumps({"chunk_sort_five_servers": sort5}))

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
    print(f"[6] Raft.cfg depth 20: {traces['raft']['chunks']} chunks, "
          f"{traces['raft']['wall_ms_per_chunk']:.3f} ms/chunk wall; five-server Raft depth "
          f"{pin_depth}: distinct, total, depth counts and coverage equal the reference's, "
          f"{traces['raft5']['chunks']} chunks, {traces['raft5']['wall_ms_per_chunk']:.3f} "
          "ms/chunk wall")
    print(json.dumps({"trace": traces["raft"]}))
    print(json.dumps({"trace_five_servers": traces["raft5"]}))

    # ---- 7. results ----
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
    }
    # launches: each kernel's count on the path that runs it (Raft.cfg's
    # for the kernels both paths share); canon_signatures serves the checks
    path_launches = {**{k: launches[k] for k in RAFT3_PATH},
                     "canon_tiered": launches5["canon_tiered"], "canon_signatures": 0}
    table = [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": path_launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for k, r in rows.items()
    ]
    print(f"[7] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"torch_sort": sort_row}))
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
