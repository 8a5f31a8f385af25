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
  4. the main path: standard-raft Raft.cfg (inline text) checked through
     the function the CLI calls, on cuda, to exhaustion — 8,664,032
     distinct / 30,708,266 total / depth 48 / 19,514 terminal, no
     violation — with every kernel's launch count read around that run;
  5. an injected NoCommit invariant: the violation's depth, gid and
     trace on the card equal the CPU run's;
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
}


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
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.lsm import merge_runs, merge_runs_plain
    from raft_tpu_torch.checker.util import (
        append_rows, append_rows_plain, compact_indices, dense_prefix_sel,
        probe_runs, probe_runs_plain,
    )
    from raft_tpu_torch.models.raft import RaftModel, RaftParams
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
    kernels.reset_counts()
    t = time.perf_counter()
    setup, bfs, res = run_check("Raft.cfg", text=RAFT_CFG, device="cuda", chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels.launch_counts()
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

    # ---- 5. an injected violation: card vs CPU ----
    def no_commit_run(device):
        m = RaftModel(RaftParams(n_servers=3, n_values=1, max_elections=1,
                                 max_restarts=0, msg_slots=16))
        m.invariants["NoCommit"] = lambda s: (m.layout.get(s, "commitIndex") == 0).all(dim=1)
        return DeviceBFS(m, invariants=("NoCommit",), chunk=256, frontier_cap=1 << 14,
                         journal_cap=1 << 16, max_seen_cap=1 << 20, canon_memo_cap=1 << 16,
                         device=device).run()

    vg, vc = no_commit_run("cuda"), no_commit_run("cpu")
    check(vg.violation is not None and vg.violation == vc.violation,
          f"violation {vg.violation} != {vc.violation}")
    check(vg.trace == vc.trace, "violation traces differ between the card and the CPU")
    print(f"[5] NoCommit violated at depth {vg.violation.depth}, gid "
          f"{vg.violation.global_id}, {len(vg.trace)}-state trace: card == CPU")

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
    }
    table = [
        {"name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for k, r in rows.items()
    ]
    print(f"[7] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
