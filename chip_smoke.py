"""On-card smoke test of raft_tpu_torch, the PyTorch/CUDA port.

    python chip_smoke.py

Needs one CUDA card; exits non-zero (printing no result) without one.
Phases, each of which fails the run on any mismatch:

  1. device: name, count, nvidia-smi name and power limit;
  2. build every kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, compared exactly (integers), with CUDA-event
     times of the kernel, the plain version and, where one exists, a
     single PyTorch library call, beside the kernel's bound;
     The Raft expand kernels (raft_guard, raft_apply, raft_fold) are
     held the same way on a chunk of the depth-20 Raft.cfg frontier and
     on chunks of reachable RaftFsync and FlexibleRaft states, and
     torch.sort (the run emit, still a library call) is timed beside its
     bound;
  4. the main path: standard-raft Raft.cfg (inline text) checked through
     the function the CLI calls, on cuda, to exhaustion — 8,664,032
     distinct / 30,708,266 total / depth 48 / 19,514 terminal, no
     violation — with every kernel's launch count read around that run,
     the three expand kernels launched once per chunk and the plain
     ``RaftModel.expand`` never called;
  5. FlexibleRaft with quorums that need not intersect (3 servers,
     ElectionQuorumSize 2, ReplicationQuorumSize 1): the
     LeaderHasAllAckedValues violation, its gid, depth and trace on the
     card equal the CPU run's;
  5b. RaftFsync (3 servers, the reference cfg's fsync policy) to depth
     24: counts, depth counts and coverage on the card equal the CPU
     run's;
  6. where the time goes: the same entry point to depth 20 once untimed
     by a tracer (wall per chunk) and once under torch.profiler (device
     time per chunk by kernel group, the device's busy share);
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
}
# state fields the invariants of the cfgs here read (NoLogDivergence,
# LeaderHasAllAckedValues): the part of a row raft_fold must load
INVARIANT_FIELDS = ("currentTerm", "state", "log_term", "log_value", "commitIndex", "acked")


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
    new = bfs._st_dedup(fps, [bfs._seen])
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
    from raft_tpu_torch.models.raft import RaftModel
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
    # (timed), then chunks of reachable RaftFsync and FlexibleRaft states
    rows.update(expand_kernels(torch, bfs20, pool, rng, timed=True))
    sort_row = rows.pop("torch_sort")
    for cfg_name, text, depth in (("RaftFsync.cfg", FSYNC_CFG, FSYNC_DEPTH),
                                  ("FlexibleRaft.cfg", FLEX_CFG, None)):
        _, b, r = run_check(cfg_name, text=text, device="cuda", chunk=CHUNK, max_depth=depth)
        expand_kernels(torch, b, b.frontier_rows.cpu().numpy(), rng, timed=False)
        del b
    for k, r in rows.items():
        print(f"[3] {k}: exact; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"; warm (all hits) {r['warm_ms']:.4f} ms" if "warm_ms" in r else "")
              + (f"; append_rows {r['rows_ms']:.4f} ms vs plain {r['rows_plain_ms']:.4f}"
                 f" ms, bound {r['rows_bound_ms']:.4f} ms" if "rows_ms" in r else ""))

    # ---- 4. the main path ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the plain expand (under the plain guard and apply) must not run: count
    # its calls by wrapping the method for the length of the run
    plain_expand = RaftModel.expand
    expand_calls = [0]

    def counted_expand(self, states):
        expand_calls[0] += 1
        return plain_expand(self, states)

    RaftModel.expand = counted_expand
    kernels.reset_counts()
    try:
        t = time.perf_counter()
        setup, bfs, res = run_check("Raft.cfg", text=RAFT_CFG, device="cuda", chunk=CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernels.launch_counts()
    finally:
        RaftModel.expand = plain_expand
    got = (res.distinct, res.total, res.depth, res.terminal)
    chunks = sum(-(-n // CHUNK) for n in res.depth_counts)
    print(f"[4] Raft.cfg: distinct={res.distinct} total={res.total} depth={res.depth} "
          f"terminal={res.terminal} exhausted={res.exhausted} in {wall:.2f} s "
          f"({res.distinct / wall:.0f} distinct/s, {chunks} chunks, "
          f"{wall * 1e3 / chunks:.2f} ms/chunk), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, memo hits {bfs.memo_hits}")
    print(json.dumps({"launches": launches}))
    check(res.violation is None, f"unexpected violation {res.violation}")
    check(res.exhausted and got == EXHAUSTED, f"exhaustion counts {got} != {EXHAUSTED}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was never launched on the main path")
    check(launches["probe_runs"] == chunks, f"{launches['probe_runs']} probes != {chunks} chunks")
    for k in ("raft_guard", "raft_apply"):
        check(launches[k] == chunks, f"{launches[k]} {k} launches != {chunks} chunks")
    # raft_fold: once per chunk, and once for the initial-state check
    check(launches["raft_fold"] == chunks + 1,
          f"{launches['raft_fold']} raft_fold launches != {chunks} chunks + 1")
    check(expand_calls[0] == 0, f"the plain RaftModel.expand ran {expand_calls[0]} times")
    print(f"[4] raft_guard, raft_apply: one launch per chunk; raft_fold: one per chunk and "
          f"one for the initial states; RaftModel.expand called {expand_calls[0]} times")

    # ---- 5. FlexibleRaft's quorum violation: card vs CPU ----
    def small_run(cfg_name, text, device, depth=None):
        return run_check(cfg_name, text=text, device=device, chunk=1024, max_depth=depth)[2]

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

    # ---- 5b. RaftFsync to FSYNC_DEPTH: card vs CPU ----
    t = time.perf_counter()
    fg = small_run("RaftFsync.cfg", FSYNC_CFG, "cuda", FSYNC_DEPTH)
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    fc = small_run("RaftFsync.cfg", FSYNC_CFG, "cpu", FSYNC_DEPTH)
    t_cpu = time.perf_counter() - t
    got = (fg.distinct, fg.total, fg.depth, fg.terminal)
    check(fg.violation is None and got == (fc.distinct, fc.total, fc.depth, fc.terminal),
          f"RaftFsync counts {got} != CPU {(fc.distinct, fc.total, fc.depth, fc.terminal)}")
    check(fg.depth_counts == fc.depth_counts and fg.coverage == fc.coverage,
          "RaftFsync depth counts or coverage differ between the card and the CPU")
    print(f"[5b] RaftFsync to depth {FSYNC_DEPTH}: distinct={fg.distinct} total={fg.total} "
          f"terminal={fg.terminal}, depth counts and coverage: card == CPU "
          f"(card {t_card:.1f} s, CPU {t_cpu:.1f} s)")

    # ---- 6. where the time goes: depth 20 untraced, then traced ----
    from torch.profiler import ProfilerActivity, profile

    def depth20():
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, r = run_check("Raft.cfg", text=RAFT_CFG, device="cuda", chunk=CHUNK,
                            max_depth=20)
        torch.cuda.synchronize()
        check((r.distinct, r.total, r.depth, r.terminal) == DEPTH20, "depth-20 counts")
        return time.perf_counter() - t, sum(-(-n // CHUNK) for n in r.depth_counts[:-1])

    wall20, chunks20 = depth20()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced20, _ = depth20()
    trace = {"chunks": chunks20, "wall_ms_per_chunk": wall20 * 1e3 / chunks20,
             "traced_wall_ms_per_chunk": traced20 * 1e3 / chunks20}
    dt = device_time(torch, prof)
    if dt is None:
        trace["device"] = "not measured: the tracer saw no device activity"
    else:
        busy, groups = dt
        trace.update({
            "device_ms_per_chunk": busy / chunks20,
            "device_busy_share_untraced": busy / (wall20 * 1e3),
            "device_busy_share_traced": busy / (traced20 * 1e3),
            "device_ms_per_chunk_by_group": {
                k: v / chunks20 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        })
    print(f"[6] depth 20: {chunks20} chunks, {trace['wall_ms_per_chunk']:.3f} ms/chunk wall")
    print(json.dumps({"trace": trace}))

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
    }
    table = [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
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
