"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes (exact equality: integers). Needs a CUDA card and nvcc;
skips elsewhere. Run on the card with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which these tests do not
need and a machine with only the port's dependencies lacks.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu_torch.checker.lsm import merge_runs, merge_runs_plain
from raft_tpu_torch.checker.util import (
    append_rows, append_rows_plain, chunk_dedup, chunk_dedup_plain,
    compact_indices, dense_prefix_sel,
)
from raft_tpu_torch.models.joint_raft import JointRaftModel, JointRaftParams
from raft_tpu_torch.models.kraft import KRaftModel, KRaftParams
from raft_tpu_torch.models.raft import R_ACCEPT_AE, R_CLIENTREQUEST, RaftModel, RaftParams
from raft_tpu_torch.models.reconfig_raft import ReconfigRaftModel, ReconfigRaftParams
from raft_tpu_torch.models.pull_raft import (
    R_BECOMELEADER as R_PULL_BECOMELEADER, R_CLIENTREQUEST as R_PULL_CLIENTREQUEST,
    R_REQUESTVOTE as R_PULL_REQUESTVOTE, PullRaftModel, PullRaftParams,
)
from raft_tpu_torch.ops.expand import (
    apply, apply_occupancy, apply_plain, fold, fold_plain, guard, guard_plain,
)
from raft_tpu_torch.ops.hashing import INT64_MAX
from raft_tpu_torch.ops.packing import EMPTY
from raft_tpu_torch.ops.symmetry import permute_states
from raft_tpu_torch.parallel.route import owner_route, owner_route_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    return torch.device("cuda")


def _sorted(dev, n_real, size, gen):
    v = torch.randint(-(1 << 62), 1 << 62, (n_real,), generator=gen).to(dev)
    pad = torch.full((size - n_real,), INT64_MAX, dtype=torch.int64, device=dev)
    return torch.cat([torch.sort(v).values, pad])


@pytest.mark.parametrize("msg_slots", [16, 320])
def test_canon_memo(dev, msg_slots):
    # at 320 slots (rows of over 1,000 lanes) the rows per block shrink
    model = RaftModel(RaftParams(n_servers=3, n_values=1, max_elections=2,
                                 max_restarts=0, msg_slots=msg_slots))
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    bfs = DeviceBFS(model, chunk=256, frontier_cap=4096, max_seen_cap=1 << 20,
                    canon_memo_cap=1 << 12, device=dev)
    bfs.run(max_depth=7)
    states = bfs.frontier_rows.repeat(3, 1).contiguous()
    valid = torch.rand(states.shape[0], device=dev) < 0.9
    canon = bfs.canon
    mk = torch.full((1 << 8, 2), INT64_MAX, dtype=torch.int64, device=dev)
    mp = mk.clone()
    for _ in range(2):
        fk, hk = canon.fingerprints_memo_cuda(states, valid, mk)
        fp, hp = canon.fingerprints_memo_plain(states, valid, mp)
        assert torch.equal(fk, fp) and torch.equal(mk, mp) and int(hk) == int(hp)
    assert torch.equal(canon.fingerprints(states), canon.canon_plain(states))


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 5000])
def test_compact_indices(dev, n):
    mask = torch.rand(n, device=dev) < 0.3
    for n_out in (n, max(1, n // 7)):
        sk, ck = compact_indices(mask, n_out, n)
        sp, cp = dense_prefix_sel(mask, n_out, n)
        assert torch.equal(sk, sp) and int(ck) == int(cp)


@pytest.mark.parametrize("count", [0, 40, 64 - 10, 64 - 9, 70])
def test_append_rows(dev, count):
    gen = torch.Generator().manual_seed(1)
    new = torch.rand(16, generator=gen) < 0.6
    esel, _ = dense_prefix_sel(new, 16, 16)
    for width in (1, 9):
        src = torch.randint(0, 1 << 30, (16, width), generator=gen, dtype=torch.int32)
        buf = torch.randint(0, 1 << 30, (64 + 16, width), generator=gen, dtype=torch.int32)
        if width == 1:
            src, buf = src[:, 0].contiguous(), buf[:, 0].contiguous()
        cur = torch.tensor([count], dtype=torch.int64)
        bk = buf.to(dev)
        append_rows(bk, src.to(dev), esel.to(dev), cur.to(dev), 64)
        append_rows_plain(buf, src, esel, cur, 64)
        assert torch.equal(bk.cpu(), buf)


@pytest.mark.parametrize("target", [1, 300, 1024, 1500])
def test_merge_runs(dev, target):
    gen = torch.Generator().manual_seed(2)
    a, b = _sorted(dev, 400, 512, gen), _sorted(dev, 200, 512, gen)
    b[:100] = torch.sort(torch.cat([a[:50], b[:50]])).values
    b[:200] = torch.sort(b[:200]).values
    assert torch.equal(merge_runs(a, b, target), merge_runs_plain(a, b, target))
    assert torch.equal(merge_runs(a, a[:0], target), merge_runs_plain(a, a[:0], target))


def _dedup_runs(dev, pool, n_runs, gen):
    """n_runs sorted INT64_MAX-padded runs: each holds keys of its own and
    part of ``pool``; the first has 2^20 lanes (a seen run: its slices are
    sampled), the others 64 to 2,048 (ladder runs: staged whole)."""
    runs = []
    for r in range(n_runs):
        size = (1 << 20) if r == 0 else 64 << (r % 6)
        own = torch.randint(-(1 << 63), (1 << 63) - 1, (size // 2,), generator=gen)
        part = pool[torch.rand(len(pool), generator=gen) < 0.3 / (r + 1)]
        v = torch.unique(torch.cat([own, part]))
        v = v[v != INT64_MAX]
        pad = torch.full((size // 3 + 1,), INT64_MAX, dtype=torch.int64)
        runs.append(torch.cat([v, pad]).to(dev))
    return runs


def _dedup_equal(fps, runs, run_len):
    """chunk_dedup against chunk_dedup_plain, with and without the order,
    one launch a call."""
    from raft_tpu_torch import kernels

    before = kernels.CHUNK_DEDUP.launches
    nk, rk = chunk_dedup(fps, runs, run_len)
    nko, rko, ok = chunk_dedup(fps, runs, run_len, with_order=True)
    assert kernels.CHUNK_DEDUP.launches == before + 2
    np_, rp, op = chunk_dedup_plain(fps, runs, run_len, with_order=True)
    assert torch.equal(nk, np_) and torch.equal(rk, rp)
    assert torch.equal(nko, np_) and torch.equal(rko, rp) and torch.equal(ok, op)
    return np_


@pytest.mark.parametrize("n_runs", [0, 1, 4, 32])
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 5000, 65536, 262144])
def test_chunk_dedup(dev, n, n_runs):
    # many duplicates (a pool of n / 4 values over the whole int64 range),
    # INT64_MAX lanes, and runs holding part of the pool
    gen = torch.Generator().manual_seed(n + n_runs)
    pool = torch.randint(-(1 << 63), (1 << 63) - 1, (max(1, n // 4),), generator=gen)
    fps = pool[torch.randint(0, len(pool), (n,), generator=gen)]
    fps[torch.rand(n, generator=gen) < 0.1] = INT64_MAX
    runs = _dedup_runs(dev, pool, n_runs, gen)
    new = _dedup_equal(fps.to(dev), runs, n + 3 * (n % 2))
    if n >= 2047 and n_runs:
        assert 0 < int(new.sum()) < int((pool != INT64_MAX).sum())


@pytest.mark.parametrize("kind", ["equal", "narrow", "sentinel", "every", "ends"])
def test_chunk_dedup_skewed(dev, kind):
    # buckets far past the 2,048 pairs sorted in registers (all lanes equal;
    # every key in one bucket, merged in global scratch), all lanes at the
    # sentinel, a run holding every key, keys at a run's first and last entry
    gen = torch.Generator().manual_seed(11)
    n = 70000
    pool = torch.randint(-(1 << 63), (1 << 63) - 1, (n // 4,), generator=gen)
    runs = _dedup_runs(dev, pool, 4, gen)
    if kind == "equal":  # a key no run holds
        fps = torch.full((n,), 12345, dtype=torch.int64)
    elif kind == "narrow":
        fps = torch.randint(0, 30000, (n,), generator=gen)
        runs.append(torch.unique(fps[::3]).to(dev))
    elif kind == "sentinel":
        fps = torch.full((n,), INT64_MAX, dtype=torch.int64)
    elif kind == "every":
        fps = pool[torch.randint(0, len(pool), (n,), generator=gen)]
        runs.append(torch.unique(fps).to(dev))
    else:
        r = runs[0].cpu()
        last = r[r != INT64_MAX][-1]
        fps = torch.where(torch.rand(n, generator=gen) < 0.5, r[0], last)
    new = _dedup_equal(fps.to(dev), runs, n)
    if kind in ("sentinel", "every", "ends"):
        assert not bool(new.any())
    elif kind == "equal":
        assert int(new.sum()) == 1 and bool(new[0])


@pytest.mark.parametrize("count", [0, 54, 70])
def test_append_rows_strided(dev, count):
    gen = torch.Generator().manual_seed(3)
    pay = torch.randint(0, 1 << 30, (16, 12), generator=gen, dtype=torch.int32)
    esel, _ = dense_prefix_sel(torch.rand(16, generator=gen) < 0.6, 16, 16)
    cur = torch.tensor([count], dtype=torch.int64)
    for lo, hi in ((0, 9), (9, 10), (11, 12)):
        buf = torch.randint(0, 1 << 30, (64 + 16, hi - lo), generator=gen, dtype=torch.int32)
        if hi - lo == 1:
            buf = buf[:, 0].contiguous()
        bk = buf.to(dev)
        # a column range of the payload rows: src_stride 12, not the width
        append_rows(bk, pay.to(dev)[:, lo:hi], esel.to(dev), cur.to(dev), 64)
        append_rows(buf, pay[:, lo:hi], esel, cur, 64)
        assert torch.equal(bk.cpu(), buf)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_owner_route(dev, D):
    rng = np.random.default_rng(D)
    C, A, W, VC = 64, 20, 33, 700
    n_valid = 600
    fps = rng.integers(-(1 << 63), (1 << 63) - 1, VC, dtype=np.int64, endpoint=True)
    fps[5:20] = fps[3]
    fps[n_valid:] = INT64_MAX
    fps[100:110] = INT64_MAX
    sel = np.full(VC, C * A, np.int32)
    sel[:n_valid] = np.sort(rng.choice(C * A, n_valid, replace=False))
    flatc = rng.integers(-(1 << 31), 1 << 31, (VC, W), dtype=np.int64).astype(np.int32)
    rank = rng.integers(0, 13, (C, A), dtype=np.int64).astype(np.int32)
    args = [torch.from_numpy(a) for a in (fps, flatc, sel, rank)]
    for RC in (VC, max(1, n_valid // (2 * D))):  # the default cap, and one that overflows
        want = owner_route_plain(*args, 12345, A, D, RC)
        got = owner_route(*[a.to(dev) for a in args], 12345, A, D, RC)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert int(want[2][0]) == (4 if RC < VC else 0)


def test_sharded_d1_on_the_card_equals_the_cpu():
    """ShardedBFS at D = 1 over NCCL: the counts, coverage and the
    counterexample trace of the same run on the CPU over gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    import functools

    from raft_tpu_torch.parallel.launch import run_sharded

    params = RaftParams(n_servers=2, n_values=1, max_elections=2, max_restarts=0, msg_slots=16,
                        election_quorum=1, replication_quorum=1)
    inv = ("LeaderHasAllAckedValues", "NoLogDivergence")
    kw = dict(engine_kw=dict(invariants=inv, chunk=256, frontier_cap=1024))
    build = functools.partial(RaftModel, params)
    _, rg = run_sharded(build, 1, device="cuda", **kw)
    _, rc = run_sharded(build, 1, device="cpu", **kw)
    assert rg.violation_invariant == "LeaderHasAllAckedValues" and rg.depth == 6
    assert (rg.distinct, rg.total, rg.depth_counts, rg.coverage, rg.trace) == (
        rc.distinct, rc.total, rc.depth_counts, rc.coverage, rc.trace)


@pytest.mark.parametrize("n_servers,msg_slots", [(5, 24), (5, 320), (6, 24)])
def test_canon_tiered(dev, n_servers, msg_slots):
    """Five and six servers: canon_tiered (memo cold, then warm) and
    canon_signatures equal their plain versions on reachable states,
    their server-permuted copies, all-tied Init states and edge rows;
    at 320 slots (rows of over 1,000 lanes) the rows per block shrink."""
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    model = RaftModel(RaftParams(n_servers=n_servers, n_values=2, max_elections=2,
                                 max_restarts=0, msg_slots=msg_slots))
    bfs = DeviceBFS(model, chunk=256, frontier_cap=1 << 14, max_seen_cap=1 << 20,
                    canon_memo_cap=1 << 12, device=dev)
    init = np.repeat(model.init_states(), 64, axis=0)
    if msg_slots == 24:
        bfs.run(max_depth=6)
        rows = bfs.frontier_rows.cpu().numpy()[:600]
        sigma = [3, 1, 4, 0, 2] if n_servers == 5 else [3, 1, 5, 0, 2, 4]
        perm = permute_states(model.layout, model.packer, rows, sigma)
        parts = [init, rows, perm, edge_rows(model, rows[:100], seed=9)]
    else:
        parts = [edge_rows(model, init, seed=9)]
    states = torch.from_numpy(np.ascontiguousarray(np.concatenate(parts))).to(dev)
    canon = bfs.canon
    assert canon.prune
    valid = torch.rand(states.shape[0], device=dev) < 0.9
    mk = torch.full((1 << 8, 2), INT64_MAX, dtype=torch.int64, device=dev)
    mp = mk.clone()
    for _ in range(2):
        fk, hk = canon.fingerprints_memo_cuda(states, valid, mk)
        fp, hp = canon.fingerprints_memo_plain(states, valid, mp)
        assert torch.equal(fk, fp) and torch.equal(mk, mp) and int(hk) == int(hp)
    assert torch.equal(canon.signatures(states), canon.signatures_plain(states))
    fps = canon.fingerprints(states)
    assert torch.equal(fps, canon.canon_plain(states))
    if msg_slots == 24:
        n = len(rows)
        assert torch.equal(fps[64:64 + n], fps[64 + n:64 + 2 * n])


@pytest.mark.parametrize("params,depth", [
    (dict(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=16), 9),
    (dict(n_servers=5, n_values=5, max_elections=4, max_restarts=0, msg_slots=24), 6),
], ids=["three", "five"])
def test_wave_loop_has_no_host_sync(dev, params, depth):
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    model = RaftModel(RaftParams(**params))
    bfs = DeviceBFS(model, invariants=("LeaderHasAllAckedValues", "NoLogDivergence"),
                    chunk=256, frontier_cap=4096, max_seen_cap=1 << 20,
                    canon_memo_cap=1 << 12, device=dev)
    res = bfs.run(max_depth=depth)
    fcount = res.depth_counts[-1]
    assert fcount > bfs.chunk  # several chunks, the last one partial
    frontier = torch.zeros((bfs.FCAP + bfs.VC, bfs.W), dtype=torch.int32, device=dev)
    frontier[:fcount] = bfs.frontier_rows
    next_buf, jparent, jcand, viol, stats, cov = bfs._wave_carries()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync inside the wave raises
    try:
        ladder = bfs._run_wave(frontier, next_buf, jparent, jcand, viol, stats,
                               bfs._memo.table, cov, fcount, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(stats[0]) > 0 and any(r is not None for r in ladder)


# the three parameter sets one RaftModel serves (as tests/test_torch_raft_model.py)
VARIANTS = {
    "core": RaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=1,
                       msg_slots=16),
    "fsync": RaftParams(n_servers=3, n_values=1, max_elections=1, max_restarts=1,
                        msg_slots=16, strict_send_once=True, has_pending_response=False,
                        trunc_term_mismatch=True, has_fsync=True,
                        fsync_leader_before_ae=False, fsync_leader_quorum=True,
                        fsync_follower_reply=True),
    "flexible": RaftParams(n_servers=3, n_values=2, max_elections=2, max_restarts=0,
                           msg_slots=16, election_quorum=2, replication_quorum=2,
                           strict_send_once=True, has_pending_response=False,
                           trunc_term_mismatch=True),
    # five servers: RequestVote chains S - 1 = 4 puts, quorum masks of 5 bits
    "five": RaftParams(n_servers=5, n_values=2, max_elections=2, max_restarts=0,
                       msg_slots=24),
}
INV = ("LeaderHasAllAckedValues", "NoLogDivergence")


def edge_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """Reachable states ``st`` and edge cases built from them: copies with
    three random lanes set to small values (out-of-range indices,
    negative counts); copies whose message bag is full (so puts
    overflow); copies with every log at max_log and no value acked (so
    ClientRequest and the append of an accepted request overflow); and
    copies whose servers are scrambled (random roles, terms, logs,
    commit indices, match indices and acks) with a bag of random records
    of all four message types, their fields over their whole bit width."""
    rng = np.random.default_rng(seed)
    lay, p = model.layout, model.p
    S, L, V = p.n_servers, p.max_log, p.n_values
    hs, ls, cs = lay.sl("msg_hi"), lay.sl("msg_lo"), lay.sl("msg_cnt")
    pert = st.copy()
    for r in pert:
        r[rng.integers(0, lay.W, 3)] = rng.integers(-1, 6, 3)
    full = st[:64].copy()
    for r in full:
        keys = set(zip(r[hs].tolist(), r[ls].tolist())) - {(EMPTY, EMPTY)}
        while len(keys) < p.msg_slots:
            keys.add((0, int(rng.integers(0, 1 << 26))))
        keys = sorted(keys)[: p.msg_slots]
        r[hs] = [k[0] for k in keys]
        r[ls] = [k[1] for k in keys]
        r[cs] = rng.integers(0, 3, p.msg_slots)
    maxlog = st[:64].copy()
    maxlog[:, lay.sl("log_len")] = L
    maxlog[:, lay.sl("acked")] = 0
    scr = st[:64].copy()
    for r in scr:
        r[lay.sl("state")] = rng.integers(0, 3, S)
        r[lay.sl("currentTerm")] = rng.integers(1, 3, S)
        r[lay.sl("log_len")] = rng.integers(0, L + 1, S)
        r[lay.sl("log_term")] = rng.integers(1, 3, S * L)
        r[lay.sl("log_value")] = rng.integers(0, V + 1, S * L)
        r[lay.sl("commitIndex")] = rng.integers(0, L + 1, S)
        r[lay.sl("matchIndex")] = rng.integers(0, L + 1, S * S)
        r[lay.sl("acked")] = rng.integers(0, 3, V)
        keys = set()
        for _ in range(int(rng.integers(1, p.msg_slots // 2))):
            vals = {f: int(rng.integers(0, 1 << bits))
                    for f, (_, bits) in model.packer.fields.items()}
            keys.add(model.packer.pack(**{**vals, "mtype": int(rng.integers(1, 5))}))
        keys = sorted(keys)
        bag = np.full((3, p.msg_slots), EMPTY)
        bag[2] = 0
        bag[:, :len(keys)] = [[k[0] for k in keys], [k[1] for k in keys],
                              rng.integers(0, 3, len(keys))]
        r[hs], r[ls], r[cs] = bag
    return np.ascontiguousarray(np.concatenate([st, pert, full, maxlog, scr]).astype(np.int32))


def net_fault_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """``edge_rows`` of a model with the network-fault actions, and copies
    of its states whose occupied bag slots have their delivery counts set
    to -1..3 (count 1: both faults enabled; count max_msg_copies = 2: the
    duplicate refused; count 0: both refused, the record kept; 3 and -1:
    out of the reachable range), half of the copies also with a count on an
    EMPTY slot (no record: both refused)."""
    rng = np.random.default_rng(seed)
    lay, M = model.layout, model.p.msg_slots
    hs, cs = lay.sl("msg_hi"), lay.sl("msg_cnt")
    cnt = st.copy()
    for k, r in enumerate(cnt):
        occ = r[hs] != EMPTY
        r[cs] = np.where(occ, rng.integers(-1, 4, M), 0)
        if k % 2 and not occ.all():
            r[cs.start + int(np.argmin(occ))] = 1
    # the three counts the faults turn on, each on some row's first slot
    for k, c in enumerate((0, 1, 2)):
        cnt[k, cs.start] = c
    return np.ascontiguousarray(np.concatenate([edge_rows(model, st, seed), cnt]).astype(np.int32))


def fleet_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """States of a fleet-packed model with random job lanes and random
    dynamic-constant lanes (each ``c_<name>`` in 0..its static maximum,
    so a lane differs from the static value the unpacked guards read),
    and the election and restart counters over 0..max + 1 (so a guard's
    comparison with the lane decides it)."""
    rng = np.random.default_rng(seed)
    lay, p = model.layout, model.p
    rows = st.copy()
    n = len(rows)
    rows[:, lay.fields["fleet_job"].offset] = rng.integers(0, 4, n)
    for name in p.dyn_consts:
        rows[:, lay.fields["c_" + name].offset] = rng.integers(0, getattr(p, name) + 1, n)
    for ctr, name in (("electionCtr", "max_elections"), ("restartCtr", "max_restarts")):
        rows[:, lay.fields[ctr].offset] = rng.integers(0, getattr(p, name) + 2, n)
    return np.ascontiguousarray(rows.astype(np.int32))


def pull_edge_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """``edge_rows`` of a pull-family model's reachable states ``st``, and
    three more cases: scrambled rows whose bags hold random records of all
    five message types (LeaderNotify included), their fields over their
    whole bit width, counts 0 to 2; the same rows with every log at
    max_log (so an accepted success response overflows it); and chain
    rows, where every server is
    a follower or a candidate holding a majority of votes with an election
    left, and the bag is full or one or two slots short of full (keys
    sorted below the real ones), so the S - 1 puts of RequestVote and
    BecomeLeader overflow partway."""
    rng = np.random.default_rng(seed)
    lay, p = model.layout, model.p
    S, L, V, M = p.n_servers, p.max_log, p.n_values, p.msg_slots
    hs, ls, cs = lay.sl("msg_hi"), lay.sl("msg_lo"), lay.sl("msg_cnt")
    scr = st[:64].copy()
    for r in scr:
        r[lay.sl("state")] = rng.integers(0, 3, S)
        r[lay.sl("currentTerm")] = rng.integers(1, 3, S)
        r[lay.sl("leader")] = rng.integers(0, S + 1, S)
        r[lay.sl("log_len")] = rng.integers(0, L + 1, S)
        r[lay.sl("log_term")] = rng.integers(1, 3, S * L)
        r[lay.sl("log_value")] = rng.integers(0, V + 1, S * L)
        r[lay.sl("commitIndex")] = rng.integers(0, L + 1, S)
        r[lay.sl("matchIndex")] = rng.integers(0, L + 1, S * S)
        r[lay.sl("acked")] = rng.integers(0, 3, V)
        keys = set()
        for _ in range(int(rng.integers(1, M // 2))):
            vals = {f: int(rng.integers(0, 1 << bits))
                    for f, (_, bits) in model.packer.fields.items()}
            keys.add(model.packer.pack(**{**vals, "mtype": int(rng.integers(1, 6))}))
        keys = sorted(keys)
        bag = np.full((3, M), EMPTY)
        bag[2] = 0
        bag[:, :len(keys)] = [[k[0] for k in keys], [k[1] for k in keys],
                              rng.integers(0, 3, len(keys))]
        r[hs], r[ls], r[cs] = bag
    chain = st[:64].copy()
    for r in chain:
        roles = rng.integers(0, 2, S)  # followers and candidates
        r[lay.sl("state")] = roles
        r[lay.sl("votesGranted")] = [(1 << i) | (1 << (i + 1) % S) for i in range(S)]
        r[lay.fields["electionCtr"].offset] = 0
        keys = set(zip(r[hs].tolist(), r[ls].tolist())) - {(EMPTY, EMPTY)}
        free = int(rng.integers(0, 3))
        while len(keys) < M - free:
            keys.add((0, int(rng.integers(0, 1 << 20))))
        keys = sorted(keys)[: M - free]
        bag = np.full((3, M), EMPTY)
        bag[2] = 0
        bag[:, :len(keys)] = [[k[0] for k in keys], [k[1] for k in keys],
                              rng.integers(0, 3, len(keys))]
        r[hs], r[ls], r[cs] = bag
    full_logs = scr.copy()
    full_logs[:, lay.sl("log_len")] = L
    return np.ascontiguousarray(
        np.concatenate([edge_rows(model, st, seed), scr, full_logs, chain]).astype(np.int32))


def kraft_edge_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """Reachable KRaft states ``st`` and edge cases built from them: copies
    with three random lanes set to small values; copies whose bag is full
    or one or two slots short of full (keys sorted below the real ones,
    counts 0 to 2) with every server able to start an election or to
    become leader, so the RequestVote and BecomeLeader chains overflow
    partway; copies with every log at max_log and no value acked (a
    ClientRequest overflows); scrambled copies (random states of all six,
    epochs, Nil-able leaders and votes, pendingFetch lanes, logs, high
    watermarks, endOffset rows and acks) whose bags hold random records of
    all six types, their fields over their whole bit width and ``mleader``
    Nil or not, plus FetchResponses whose correlation matches a server's
    pendingFetch (so both CASE chains of MaybeHandleCommonResponse and
    MaybeTransition run through every arm), and the same rows with every
    log at max_log (an accepted success response overflows it); and
    re-delivery rows: a successor of each reply to a FetchRequest with
    the request's count restored, so its response is already in the bag."""
    from raft_tpu_torch.models import kraft as kr

    rng = np.random.default_rng(seed)
    lay, p, pk = model.layout, model.p, model.packer
    S, L, V, M = p.n_servers, p.max_log, p.n_values, p.msg_slots
    hs, ls, cs = lay.sl("msg_hi"), lay.sl("msg_lo"), lay.sl("msg_cnt")

    def put_bag(r, keys, free=0):
        keys = sorted(set(keys))[: M - free]
        bag = np.full((3, M), EMPTY)
        bag[2] = 0
        bag[:, :len(keys)] = [[k[0] for k in keys], [k[1] for k in keys],
                              rng.integers(0, 3, len(keys))]
        r[hs], r[ls], r[cs] = bag

    def own_keys(r):
        return set(zip(r[hs].tolist(), r[ls].tolist())) - {(EMPTY, EMPTY)}

    pert = st.copy()
    for r in pert:
        r[rng.integers(0, lay.W, 3)] = rng.integers(-1, 6, 3)
    chain = st[:64].copy()
    for r in chain:
        r[lay.sl("state")] = rng.choice([kr.UNATTACHED, kr.FOLLOWER, kr.CANDIDATE], S)
        r[lay.sl("votesGranted")] = [(1 << i) | (1 << (i + 1) % S) for i in range(S)]
        r[lay.fields["electionCtr"].offset] = 0
        keys = own_keys(r)
        free = int(rng.integers(0, 3))
        while len(keys) < M - free:
            keys.add((0, int(rng.integers(0, 1 << 20))))
        put_bag(r, keys, free)
    maxlog = st[:64].copy()
    maxlog[:, lay.sl("log_len")] = L
    maxlog[:, lay.sl("acked")] = 0
    scr = st[:96].copy()
    for r in scr:
        r[lay.sl("state")] = rng.integers(0, 6, S)
        r[lay.sl("currentEpoch")] = rng.integers(1, 4, S)
        r[lay.sl("votedFor")] = rng.integers(0, S + 1, S)
        r[lay.sl("leader")] = rng.integers(0, S + 1, S)
        r[lay.sl("pf_epoch")] = rng.integers(0, 4, S)
        r[lay.sl("pf_offset")] = rng.integers(0, L + 2, S)
        r[lay.sl("pf_lastepoch")] = rng.integers(0, 4, S)
        r[lay.sl("pf_dest")] = rng.integers(0, S + 1, S)
        r[lay.sl("log_len")] = rng.integers(0, L + 1, S)
        r[lay.sl("log_epoch")] = rng.integers(1, 4, S * L)
        r[lay.sl("log_value")] = rng.integers(0, V + 1, S * L)
        r[lay.sl("highWatermark")] = rng.integers(0, L + 1, S)
        r[lay.sl("votesGranted")] = rng.integers(0, 1 << S, S)
        r[lay.sl("endOffset")] = rng.integers(0, L + 2, S * S)
        r[lay.sl("acked")] = rng.integers(0, 3, V)
        keys = set()
        for _ in range(int(rng.integers(1, M // 3))):
            vals = {f: int(rng.integers(0, 1 << bits)) for f, (_, bits) in pk.fields.items()}
            keys.add(pk.pack(**{**vals, "mtype": int(rng.integers(1, 7))}))
        for dst in range(S):  # FetchResponses that match dst's pendingFetch
            pf = [int(r[lay.sl(f)][dst]) for f in ("pf_epoch", "pf_offset", "pf_lastepoch",
                                                    "pf_dest")]
            if pf[0] == 0:
                continue
            for _ in range(2):
                keys.add(pk.pack(
                    mtype=kr.FETCHRESP, mepoch=int(rng.integers(1, 4)), msource=(pf[3] - 1) % 4,
                    mdest=dst, mleader=int(rng.integers(0, S + 1)),
                    merror=int(rng.choice([0, 0, 1, 2, 3])), mresult=int(rng.integers(1, 4)),
                    cepoch=pf[0], cfetchOffset=pf[1], clastFetchedEpoch=pf[2],
                    nentries=int(rng.integers(0, 2)), eepoch=int(rng.integers(1, 4)),
                    evalue=int(rng.integers(1, V + 1)), mhwm=int(rng.integers(0, L + 1)),
                    mdivergingEpoch=int(rng.integers(0, 4)),
                    mdivergingEndOffset=int(rng.integers(0, L + 1))))
        put_bag(r, keys)
    full_logs = scr.copy()
    full_logs[:, lay.sl("log_len")] = L
    # re-delivery: a reply to a FetchRequest with the request's count
    # restored (the response is then in the bag, count 1)
    base = np.ascontiguousarray(np.concatenate([st, scr]).astype(np.int32))
    succs, valid, rank, _ = (x.numpy() for x in model.expand(torch.from_numpy(base)))
    replies = (kr.K_REJECT_FETCH, kr.K_DIVERGING_FETCH, kr.K_ACCEPT_FETCH)
    redo = []
    for c, a in zip(*np.nonzero(valid & np.isin(rank, replies))):
        m = model.bindings[a][1][0]
        row = succs[c, a].copy()
        key = (base[c, hs][m], base[c, ls][m])
        slot = np.nonzero((row[hs] == key[0]) & (row[ls] == key[1]))[0]
        row[cs.start + slot[0]] += 1
        redo.append(row)
        if len(redo) == 48:
            break
    return np.ascontiguousarray(np.concatenate(
        [st, pert, chain, maxlog, scr, full_logs, *([np.stack(redo)] if redo else [])]
    ).astype(np.int32))


def config_edge_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """Reachable states ``st`` of a reconfiguration model (its N-word bags)
    and edge cases built from them: copies with three random lanes set to
    small values (the snapshot sentinels -1 and -2 among them), half of
    them with a restart left (restartCtr -1); copies whose
    bag is full or one or two slots short of full (random keys, counts 0 to
    2) with every server a member able to start an election, so the
    RequestVote chains overflow partway; copies with every log at max_log
    and no value acked (ClientRequest, the config appends and an accepted
    entry overflow it); scrambled copies (random states, terms, configs,
    votes, logs of every command with random member sets, nextIndex with
    the sentinels, matchIndex, pendingResponse and acks) whose bags hold
    random records of all six types, their fields over their whole bit
    width, terms near the servers' (so every arm of the receipt fires, a
    snapshot's embedded log and an accepted entry's config install
    included); and the same scrambled rows with every count at 0."""
    rng = np.random.default_rng(seed)
    lay, p, pk = model.layout, model.p, model.packer
    S, L, V, M, NW = p.n_servers, p.max_log, p.n_values, p.msg_slots, model.n_words
    ws = [lay.sl(f"msg_w{k}") for k in range(NW)]
    cs = lay.sl("msg_cnt")

    def put_bag(r, keys, free=0):
        keys = sorted(set(keys))[: M - free]
        bag = np.full((NW + 1, M), EMPTY)
        bag[NW] = 0
        if keys:
            bag[:NW, :len(keys)] = np.array(keys).T
            bag[NW, :len(keys)] = rng.integers(0, 3, len(keys))
        for k in range(NW):
            r[ws[k]] = bag[k]
        r[cs] = bag[NW]

    def own_keys(r):
        return set(zip(*(r[w].tolist() for w in ws))) - {(EMPTY,) * NW}

    pert = st.copy()
    for r in pert:
        r[rng.integers(0, lay.view_len, 3)] = rng.integers(-2, 6, 3)
    # a restart budget left (the cfgs here have MaxRestarts 0)
    pert[::2, lay.fields["restartCtr"].offset] = -1
    chain = st[:64].copy()
    for r in chain:
        r[lay.sl("state")] = rng.choice([0, 1], S)  # Follower or Candidate
        r[lay.sl("config_members")] = (1 << S) - 1
        r[lay.fields["electionCtr"].offset] = 0
        keys = own_keys(r)
        free = int(rng.integers(0, 3))
        while len(keys) < M - free:
            keys.add(tuple(int(x) for x in rng.integers(0, 1 << 20, NW)))
        put_bag(r, keys, free)
    maxlog = st[:64].copy()
    maxlog[:, lay.sl("log_len")] = L
    maxlog[:, lay.sl("acked")] = 0
    scr = st[:96].copy()
    cmds = (1, 2, 3) if "config_joint" in lay.fields else (1, 2, 3, 4)
    for r in scr:
        r[lay.sl("state")] = rng.integers(0, 4, S)
        r[lay.sl("currentTerm")] = rng.integers(0, p.max_term + 1, S)
        r[lay.sl("votedFor")] = rng.integers(0, S + 1, S)
        r[lay.sl("votesGranted")] = rng.integers(0, 1 << S, S)
        r[lay.sl("config_members")] = rng.integers(0, 1 << S, S)
        r[lay.sl("config_committed")] = rng.integers(0, 2, S)
        for f in ("config_joint", "config_old", "config_new"):
            if f in lay.fields:
                r[lay.sl(f)] = rng.integers(0, 2 if f == "config_joint" else 1 << S, S)
        r[lay.sl("log_len")] = rng.integers(0, L + 1, S)
        r[lay.sl("log_term")] = rng.integers(1, p.max_term + 1, S * L)
        r[lay.sl("log_cmd")] = rng.choice(cmds, S * L)
        r[lay.sl("log_val")] = rng.integers(0, V + 1, S * L)
        r[lay.sl("log_cid")] = rng.integers(0, 3, S * L)
        for name in model.ENTRY_FIELDS[4:]:
            hi = S + 1 if lay.fields[f"log_{name}"].kind == "per_server_val" else 1 << S
            r[lay.sl(f"log_{name}")] = rng.integers(0, hi, S * L)
        r[lay.sl("commitIndex")] = rng.integers(0, L + 1, S)
        r[lay.sl("nextIndex")] = rng.integers(-2, L + 2, S * S)
        r[lay.sl("matchIndex")] = rng.integers(0, L + 1, S * S)
        r[lay.sl("pendingResponse")] = rng.integers(0, 1 << S, S)
        r[lay.sl("acked")] = rng.integers(0, 3, V)
        keys = set()
        for _ in range(int(rng.integers(1, M // 2))):
            vals = {f: int(rng.integers(0, 1 << bits)) for f, (_, bits) in pk.fields.items()}
            vals["mtype"] = int(rng.integers(1, 7))
            vals["mterm"] = int(rng.integers(0, p.max_term + 1))
            vals["mresult"] = int(rng.integers(1, 5))
            keys.add(pk.pack(**vals))
        put_bag(r, keys)
    zero = scr.copy()
    zero[:, cs] = 0
    return np.ascontiguousarray(np.concatenate([st, pert, chain, maxlog, scr, zero]).astype(
        np.int32))


def config_chain_pushoff_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """Copies of reachable states ``st`` of a reconfiguration model whose
    server 0 can start an election (every server a Follower and a member,
    no election spent) into a full bag whose last slot holds the
    RequestVoteRequest from 0 to 2 and whose other slots hold random keys
    below the one from 0 to 1: the chain's first put (to 1) overflows and
    pushes the key to 2 off the end, so its second put must not find it
    (the lane stays enabled, and overflows)."""
    rng = np.random.default_rng(seed)
    lay, p, pk = model.layout, model.p, model.packer
    S, L, M, NW = p.n_servers, p.max_log, p.msg_slots, model.n_words
    ws = [lay.sl(f"msg_w{k}") for k in range(NW)]
    rows = st.copy()
    for r in rows:
        r[lay.sl("state")] = 0
        r[lay.sl("config_members")] = (1 << S) - 1
        r[lay.fields["electionCtr"].offset] = 0
        ll = int(r[lay.sl("log_len")][0])
        lt = int(r[lay.sl("log_term")][ll - 1]) if ll > 0 else 0
        k1, k2 = (pk.pack(mtype=1, mterm=int(r[lay.sl("currentTerm")][0]) + 1, msource=0,
                          mdest=j, mlastLogTerm=lt, mlastLogIndex=ll) for j in (1, 2))
        assert k1 < k2
        keys = set()
        while len(keys) < M - 1:  # random keys below k1
            w = int(rng.integers(0, NW))
            if k1[w] > 0:
                keys.add(tuple(k1[:w]) + (int(rng.integers(0, k1[w])),)
                         + tuple(int(x) for x in rng.integers(0, 1 << 20, NW - w - 1)))
        bag = np.array(sorted(keys) + [k2]).T
        for k in range(NW):
            r[ws[k]] = bag[k]
        r[lay.sl("msg_cnt")] = rng.integers(0, 3, M)
    return np.ascontiguousarray(rows.astype(np.int32))


def _edge_states(model, dev, seed):
    """``edge_rows`` of reachable states (the frontiers of depths 3 to 7
    of the port's BFS on the card), on the card."""
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    parts = []
    for depth in range(3, 8):
        bfs = DeviceBFS(model, chunk=256, frontier_cap=4096, max_seen_cap=1 << 20,
                        canon_memo_cap=1 << 12, device=dev)
        bfs.run(max_depth=depth)
        parts.append(bfs.frontier_rows.cpu().numpy())
    return torch.from_numpy(edge_rows(model, np.concatenate(parts)[:400], seed)).to(dev)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_raft_guard_apply_fold(dev, name):
    model = RaftModel(VARIANTS[name])
    states = _edge_states(model, dev, seed=len(name))
    C, A = states.shape[0], model.A
    K = len(model.ACTION_NAMES)
    n_live = C - 7  # an all-dead chunk tail
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    gk = guard(model, states, n_live, cov_k)
    gp = guard_plain(model, states, n_live, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid, rank, ovf, _ = gk
    # the edge states overflow a full bag, and a log at max_log both on a
    # ClientRequest and on an accepted append (ac_ovf)
    for r in (R_CLIENTREQUEST, R_ACCEPT_AE):
        assert bool((valid & ovf & (rank == r)).any()), r
    assert not valid[n_live:].any()
    # the worklist: every valid lane, then drop lanes; and lanes of
    # disabled candidates too (their rows equal the dense expand's)
    sel, n = compact_indices(valid.reshape(-1), int(valid.sum()) + 300, C * A)
    other = torch.randint(0, C * A, (500,), device=dev, dtype=torch.int32)
    for s in (sel, other, sel[:0]):
        s = s.contiguous()
        fk, fp = apply(model, states, s), apply_plain(model, states, s)
        assert fk.shape == (s.numel(), model.layout.W) and torch.equal(fk, fp)
    flatc = apply(model, states, sel)
    new = (torch.rand(sel.numel(), device=dev) < 0.7) & (sel < C * A)
    jcount = torch.tensor([777], dtype=torch.int64, device=dev)
    invs = tuple(model.invariants)
    for s, nw in ((sel, new), (sel[:0], new[:0])):
        vk = torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
        vp, ck, cp = vk.clone(), cov_k.clone(), cov_k.clone()
        fc = flatc[: s.numel()].contiguous()
        fold(model, fc, nw, jcount, vk, invs, cov=ck, sel=s, valid=valid, rank=rank)
        fold_plain(model, fc, nw, jcount, vp, invs, cov=cp, sel=s, valid=valid,
                        rank=rank)
        assert torch.equal(vk, vp) and torch.equal(ck, cp)


def test_raft_guard_apply_wide_rows(dev):
    """A bag of 320 slots (rows over 1,000 lanes): the guard's RequestVote
    scratch is sized from the model and the group apply stages no row, so
    neither refuses it, and both still equal their plain versions."""
    model = RaftModel(dataclasses.replace(VARIANTS["core"], msg_slots=320))
    init = np.repeat(model.init_states(), 64, axis=0)
    states = torch.from_numpy(edge_rows(model, init, seed=11)).to(dev)
    C, A = states.shape[0], model.A
    assert model.layout.W > 1000
    K = len(model.ACTION_NAMES)
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    gk = guard(model, states, C, cov_k)
    gp = guard_plain(model, states, C, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid = gk[0]
    assert bool(valid.any())
    sel, _ = compact_indices(valid.reshape(-1), int(valid.sum()) + 5, C * A)
    assert torch.equal(apply(model, states, sel), apply_plain(model, states, sel))


RAFT_GROUP_VARIANTS = {
    **{name: VARIANTS[name] for name in ("core", "fsync", "flexible")},
    "net_faults": dataclasses.replace(VARIANTS["core"], net_faults=True),
}


@pytest.mark.parametrize("servers", [3, 5])
@pytest.mark.parametrize("name", list(RAFT_GROUP_VARIANTS))
def test_raft_group_apply_worklists(dev, name, servers):
    """raft_apply and its fault build raft_nf_apply (the group apply: G
    threads a worklist lane) against apply_plain on reachable and edge rows
    (full bags, logs at max_log, scrambled servers; net_fault_rows' count-0
    to -2 records for the fault build), on a BFS chunk's worklist, a
    simulate move's, an empty one and random flat ids past C * A; one
    raft_apply launch a call (the fault build counts as raft_apply) and no
    other kernel; its occupancy entry names a tile of threads a lane."""
    p = RAFT_GROUP_VARIANTS[name]
    if servers == 5:
        p = VARIANTS["five"] if name == "core" else dataclasses.replace(
            p, n_servers=5, msg_slots=24)
    model = RaftModel(p)
    states = _edge_states(model, dev, seed=servers + len(name))
    if p.net_faults:
        states = torch.from_numpy(net_fault_rows(model, states.cpu().numpy(), seed=6)).to(dev)
    check_group_apply_worklists(model, states, "raft_apply", seed=servers)
    occ = apply_occupancy(model)
    assert occ is not None and occ["G"] > 1 and occ["warps_per_sm"] > 0


def test_raft_fold_finds_first_bad_lane(dev):
    model = RaftModel(VARIANTS["core"])
    states = _edge_states(model, dev, seed=5)
    # lane 301: a leader with a current term whose log lacks an acked value
    lay = model.layout
    bad = states[0].clone()
    bad[lay.sl("state")] = torch.tensor([2, 0, 0], dtype=torch.int32)
    bad[lay.sl("currentTerm")] = 2
    bad[lay.sl("log_value")] = 0
    bad[lay.sl("acked")] = 2
    states[301] = bad
    invs = tuple(model.invariants)
    new = torch.ones(states.shape[0], dtype=torch.bool, device=dev)
    new[::3] = False
    jcount = torch.tensor([10], dtype=torch.int64, device=dev)
    vk = torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
    vp = vk.clone()
    fold(model, states, new, jcount, vk, invs)
    fold_plain(model, states, new, jcount, vp, invs)
    assert torch.equal(vk, vp)
    k = invs.index("LeaderHasAllAckedValues")
    assert int(vk[k]) <= 10 + int(new[:301].sum())


def test_unknown_invariant_raises_on_the_card(dev):
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    model = RaftModel(VARIANTS["core"])
    model.invariants["NoCommit"] = lambda s: (model.layout.get(s, "commitIndex") == 0).all(1)
    with pytest.raises(KeyError, match="no kernel predicate"):
        DeviceBFS(model, invariants=("NoCommit",), chunk=64, frontier_cap=64, device=dev)


def test_violation_trace_replay_card_equals_cpu(dev):
    """FlexibleRaft with quorums that need not intersect: the violation,
    its gid and depth, and the trace replayed through one-lane
    guard/apply launches equal the CPU run's."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    p = RaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=16,
                   election_quorum=2, replication_quorum=1, strict_send_once=True,
                   has_pending_response=False, trunc_term_mismatch=True)
    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 14, max_seen_cap=1 << 20,
                canon_memo_cap=1 << 12)
    before = kernels.RAFT_FAMILY["apply"].launches
    rg = DeviceBFS(RaftModel(p), invariants=INV, device=dev, **caps).run()
    rc = DeviceBFS(RaftModel(p), invariants=INV, device="cpu", **caps).run()
    assert rg.violation is not None and rg.violation == rc.violation
    assert rg.trace == rc.trace and len(rg.trace) == rg.violation.depth + 1
    assert (rg.distinct, rg.total, rg.depth_counts) == (rc.distinct, rc.total, rc.depth_counts)
    assert kernels.RAFT_FAMILY["apply"].launches > before


# ---------------- simulate and liveness kernels ----------------


@pytest.mark.parametrize("name", list(VARIANTS))
def test_raft_predicates(dev, name):
    """Every invariant and ValueAllOrNothing(v) of each value on edge rows
    and their successors, and rows with the election counter spent."""
    from raft_tpu_torch.ops.expand import predicates, predicates_plain

    model = RaftModel(VARIANTS[name])
    states = _edge_states(model, dev, seed=3)
    spent = states.clone()
    spent[:, model.layout.fields["electionCtr"].offset] = model.p.max_elections
    names = tuple(model.invariants) + tuple(model.predicates)
    assert any(n.startswith("ValueAllOrNothing(") for n in names)
    for rows in (states, spent, states[:0], states[:1]):
        rows = rows.contiguous()
        pk, pp = predicates(model, rows, names), predicates_plain(model, rows, names)
        assert pk.shape == (len(names), rows.shape[0]) and torch.equal(pk, pp)


@pytest.mark.parametrize("n_walks,n_cand,n_init", [(1, 5, 1), (300, 37, 1), (1000, 129, 7),
                                                   (4097, 70, 3)])
def test_sim_pick(dev, n_walks, n_cand, n_init):
    from raft_tpu_torch.checker.simulate import sim_pick, sim_pick_plain

    gen = torch.Generator().manual_seed(n_walks)
    valid = torch.rand((n_walks, n_cand), generator=gen) < 0.1
    valid[::5] = False  # walks that cannot move
    valid[1::5, -1] = True  # the last candidate enabled
    ovf = torch.rand((n_walks, n_cand), generator=gen) < 0.02
    for key in ((0, 0), (123, 4_000_000_000), (0xFFFFFFFF, 7)):
        out = []
        for fn, d in ((sim_pick, dev), (sim_pick_plain, "cpu")):
            stats = torch.zeros(4, dtype=torch.int64, device=d)
            res = fn(valid.to(d), ovf.to(d), key, n_init, stats)
            out.append([t.cpu() for t in res] + [stats[:2].cpu()])
        for a, b in zip(*out):
            assert torch.equal(a, b)


def test_raft_sim_check(dev):
    """The check and settle of one simulate step on reachable walks, with
    walks that did not move, walks at the depth cap, walks that break an
    invariant and walks whose journal is full."""
    from raft_tpu_torch.ops.expand import sim_check, sim_check_plain

    model = RaftModel(VARIANTS["core"])
    states = _edge_states(model, dev, seed=9)
    R, W = states.shape
    gen = torch.Generator().manual_seed(1)
    nxt = states[torch.randperm(R, generator=gen).to(dev)].contiguous()
    moved = (torch.rand(R, generator=gen) < 0.8).to(dev)
    nxt[~moved] = 0
    chosen = torch.randint(0, model.A, (R,), generator=gen, dtype=torch.int32).to(dev)
    init_pool = states[:3].contiguous()
    ridx = torch.randint(0, 3, (R,), generator=gen, dtype=torch.int32).to(dev)
    max_depth = 6
    depth = torch.randint(0, max_depth, (R,), generator=gen, dtype=torch.int32).to(dev)
    J = max_depth + 1
    journal = torch.randint(0, 99, (R, J), generator=gen, dtype=torch.int32).to(dev)
    jlen = (depth + 1).contiguous()
    jlen[::11] = J  # a full journal takes no more candidates
    for invs in (INV, tuple(model.invariants), ()):
        outs = []
        for fn in (sim_check, sim_check_plain):
            args = [t.clone() for t in (nxt, depth, journal, jlen)]
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            res = fn(model, states, args[0], moved, chosen, ridx, init_pool, args[1],
                     max_depth, args[2], args[3], invs, stats)
            outs.append(list(res) + args + [stats[2:]])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        inv_bad, done = outs[0][:2]
        if invs:
            assert bool((inv_bad >= 0).any()) and bool(done.any()) and not bool(done.all())


@pytest.mark.parametrize("seed", [0, 3])
def test_hash_rows(dev, seed):
    from raft_tpu_torch.ops.hashing import hash_lanes, hash_rows

    for W in (1, 31, 32, 33, 192, 334):
        rows = torch.randint(-(1 << 31), (1 << 31) - 1, (1000, W), dtype=torch.int32)
        rows[:10] = 0
        want = hash_lanes(rows, seed)
        assert torch.equal(hash_rows(rows.to(dev), seed).cpu(), want)
    assert hash_rows(rows[:0].to(dev), seed).numel() == 0


def test_simulate_and_liveness_card_equal_cpu(dev):
    """Simulation mode (the FlexibleRaft quorum violation) and the liveness
    graph on the card equal the CPU runs, through the new kernels."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.liveness import LivenessChecker
    from raft_tpu_torch.checker.simulate import Simulator

    p = RaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=32,
                   election_quorum=2, replication_quorum=1, strict_send_once=True,
                   has_pending_response=False, trunc_term_mismatch=True)
    before = kernels.SIM_PICK.launches
    runs = [Simulator(RaftModel(p), invariants=INV, walks=16, max_behavior_depth=20, seed=0,
                      device=d).run(max_steps=5000) for d in (dev, "cpu")]
    assert runs[0].violation is not None and runs[0].violation == runs[1].violation
    assert runs[0].trace == runs[1].trace
    assert (runs[0].behaviors, runs[0].steps) == (runs[1].behaviors, runs[1].steps)
    assert kernels.SIM_PICK.launches > before
    small = RaftParams(n_servers=2, n_values=1, max_elections=2, max_restarts=0, msg_slots=16)
    before = kernels.HASH_ROWS.launches
    cs = [LivenessChecker(RaftModel(small), ("ValuesNotStuck",), chunk=256, device=d)
          for d in (dev, "cpu")]
    rs = [c.run() for c in cs]
    assert (rs[0].distinct, rs[0].total_edges) == (rs[1].distinct, rs[1].total_edges) == (
        2224, 3276)
    for a in ("_esrc", "_edst", "_ecand"):
        assert np.array_equal(getattr(cs[0], a), getattr(cs[1], a))
    assert torch.equal(cs[0]._states.cpu(), cs[1]._states)
    assert rs[0].violation is None and kernels.HASH_ROWS.launches > before


# ---------------- the pull family (PullRaft, PullRaftVariant2) ----------------

PULL_VARIANTS = {
    "pull": PullRaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0,
                           msg_slots=24),
    "pull2": PullRaftParams(n_servers=3, n_values=2, max_elections=2, max_restarts=1,
                            msg_slots=24, variant2=True),
}


def _pull_edge_states(model, dev, seed):
    """``pull_edge_rows`` of reachable states (the frontiers of depths 3 to
    8 of the port's BFS on the card), on the card."""
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    parts = []
    for depth in range(3, 9):
        bfs = DeviceBFS(model, chunk=256, frontier_cap=4096, max_seen_cap=1 << 20,
                        canon_memo_cap=1 << 12, device=dev)
        bfs.run(max_depth=depth)
        parts.append(bfs.frontier_rows.cpu().numpy())
    return torch.from_numpy(pull_edge_rows(model, np.concatenate(parts)[:400], seed)).to(dev)


@pytest.mark.parametrize("name", list(PULL_VARIANTS))
def test_pull_guard_apply_fold(dev, name):
    """pull_guard, pull_apply and pull_fold against their plain versions
    on reachable and edge rows: a dead chunk tail, every valid lane then
    drop lanes, lanes of disabled candidates, and the fold with coverage."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.ops.expand import apply, apply_plain, fold, fold_plain, guard, guard_plain

    model = PullRaftModel(PULL_VARIANTS[name])
    states = _pull_edge_states(model, dev, seed=len(name))
    C, A = states.shape[0], model.A
    K = len(model.ACTION_NAMES)
    n_live = C - 7
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    before = {k.name: k.launches for k in kernels.ALL}
    gk = guard(model, states, n_live, cov_k)
    gp = guard_plain(model, states, n_live, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid, rank, ovf, _ = gk
    # the edge rows overflow: a RequestVote and a BecomeLeader chain on a
    # nearly full bag, and a ClientRequest at max_log
    for r in (R_PULL_REQUESTVOTE, R_PULL_BECOMELEADER, R_PULL_CLIENTREQUEST):
        assert bool((valid & ovf & (rank == r)).any()), r
    assert not valid[n_live:].any()
    sel, n = compact_indices(valid.reshape(-1), int(valid.sum()) + 300, C * A)
    other = torch.randint(0, C * A, (500,), device=dev, dtype=torch.int32)
    for s in (sel, other, sel[:0]):
        s = s.contiguous()
        fk, fp = apply(model, states, s), apply_plain(model, states, s)
        assert fk.shape == (s.numel(), model.layout.W) and torch.equal(fk, fp)
    flatc = apply(model, states, sel)
    new = (torch.rand(sel.numel(), device=dev) < 0.7) & (sel < C * A)
    jcount = torch.tensor([777], dtype=torch.int64, device=dev)
    invs = tuple(model.invariants)
    vk = torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
    vp, ck, cp = vk.clone(), cov_k.clone(), cov_k.clone()
    fold(model, flatc, new, jcount, vk, invs, cov=ck, sel=sel, valid=valid, rank=rank)
    fold_plain(model, flatc, new, jcount, vp, invs, cov=cp, sel=sel, valid=valid, rank=rank)
    assert torch.equal(vk, vp) and torch.equal(ck, cp)
    # the pull kernels ran, and no Raft kernel
    after = {k.name: k.launches for k in kernels.ALL}
    for k in ("pull_guard", "pull_apply", "pull_fold"):
        assert after[k] > before[k], k
    for k in ("raft_guard", "raft_apply", "raft_fold"):
        assert after[k] == before[k], k


def test_pull_fold_finds_first_bad_lane(dev):
    from raft_tpu_torch.ops.expand import fold, fold_plain

    model = PullRaftModel(PULL_VARIANTS["pull"])
    states = _pull_edge_states(model, dev, seed=5)
    # lane 301: a leader with a current term whose log lacks an acked value
    lay = model.layout
    bad = states[0].clone()
    bad[lay.sl("state")] = torch.tensor([2, 0, 0], dtype=torch.int32)
    bad[lay.sl("currentTerm")] = 2
    bad[lay.sl("log_value")] = 0
    bad[lay.sl("acked")] = 2
    states[301] = bad
    invs = tuple(model.invariants)
    new = torch.ones(states.shape[0], dtype=torch.bool, device=dev)
    new[::3] = False
    jcount = torch.tensor([10], dtype=torch.int64, device=dev)
    vk = torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
    vp = vk.clone()
    fold(model, states, new, jcount, vk, invs)
    fold_plain(model, states, new, jcount, vp, invs)
    assert torch.equal(vk, vp)
    k = invs.index("LeaderHasAllAckedValues")
    assert int(vk[k]) <= 10 + int(new[:301].sum())


@pytest.mark.parametrize("name", list(PULL_VARIANTS))
def test_pull_predicates_and_sim_check(dev, name):
    """pull_predicates on edge rows (every invariant), and pull_sim_check's
    check and settle as test_raft_sim_check holds raft_sim_check."""
    from raft_tpu_torch.ops.expand import (
        predicates, predicates_plain, sim_check, sim_check_plain,
    )

    model = PullRaftModel(PULL_VARIANTS[name])
    states = _pull_edge_states(model, dev, seed=9)
    names = tuple(model.invariants)
    for rows in (states, states[:0], states[:1]):
        rows = rows.contiguous()
        assert torch.equal(predicates(model, rows, names), predicates_plain(model, rows, names))
    R = states.shape[0]
    gen = torch.Generator().manual_seed(1)
    nxt = states[torch.randperm(R, generator=gen).to(dev)].contiguous()
    moved = (torch.rand(R, generator=gen) < 0.8).to(dev)
    nxt[~moved] = 0
    chosen = torch.randint(0, model.A, (R,), generator=gen, dtype=torch.int32).to(dev)
    init_pool = states[:3].contiguous()
    ridx = torch.randint(0, 3, (R,), generator=gen, dtype=torch.int32).to(dev)
    max_depth = 6
    depth = torch.randint(0, max_depth, (R,), generator=gen, dtype=torch.int32).to(dev)
    J = max_depth + 1
    journal = torch.randint(0, 99, (R, J), generator=gen, dtype=torch.int32).to(dev)
    jlen = (depth + 1).contiguous()
    jlen[::11] = J
    for invs in (INV, names, ()):
        outs = []
        for fn in (sim_check, sim_check_plain):
            args = [t.clone() for t in (nxt, depth, journal, jlen)]
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            res = fn(model, states, args[0], moved, chosen, ridx, init_pool, args[1],
                     max_depth, args[2], args[3], invs, stats)
            outs.append(list(res) + args + [stats[2:]])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_pull_bfs_simulate_and_replay_card_equal_cpu(dev):
    """PullRaft by BFS (counts, depth counts, coverage), its deepest
    journal state's trace replayed through one-lane guard/apply launches,
    and Variant2 by simulation (walks, final states, journals): the card
    equals the CPU, through the pull kernels."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.bfs import Violation
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.simulate import Simulator

    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 15, max_seen_cap=1 << 20,
                canon_memo_cap=1 << 12)
    kernels.reset_counts()
    runs = [DeviceBFS(PullRaftModel(PULL_VARIANTS["pull"]), invariants=INV, device=d, **caps)
            for d in (dev, "cpu")]
    rs = [b.run(max_depth=12) for b in runs]
    assert (rs[0].distinct, rs[0].total, rs[0].depth_counts, rs[0].coverage) == (
        rs[1].distinct, rs[1].total, rs[1].depth_counts, rs[1].coverage)
    deepest = Violation(invariant="deepest journal state", global_id=rs[0].distinct - 1,
                        depth=rs[0].depth)
    trace = runs[0].reconstruct_trace(deepest)
    assert len(trace) == rs[0].depth + 1 and trace == runs[1].reconstruct_trace(deepest)
    sims = [Simulator(PullRaftModel(PULL_VARIANTS["pull2"]), invariants=INV, walks=64,
                      max_behavior_depth=30, seed=3, device=d) for d in (dev, "cpu")]
    ss = [s.run(max_steps=64 * 40) for s in sims]
    assert (ss[0].behaviors, ss[0].steps, ss[0].violation) == (ss[1].behaviors, ss[1].steps,
                                                               ss[1].violation)
    for a in ("states", "depth", "journal", "jlen"):
        assert torch.equal(getattr(sims[0], a).cpu(), getattr(sims[1], a))
    counts = kernels.launch_counts()
    for k in ("pull_guard", "pull_apply", "pull_fold", "pull_predicates", "pull_sim_check"):
        assert counts[k] > 0, k
    for k in ("raft_guard", "raft_apply", "raft_fold", "raft_predicates", "raft_sim_check"):
        assert counts[k] == 0, k


# ---------------- KRaft ----------------

KRAFT_VARIANTS = {
    "kraft": KRaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0,
                         msg_slots=40),
    "kraft_restart": KRaftParams(n_servers=3, n_values=2, max_elections=2, max_restarts=1,
                                 msg_slots=40),
}
KRAFT_INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "NeverTwoLeadersInSameEpoch",
             "NoIllegalState")


def _kraft_states(model, dev, depths=range(3, 10)):
    """Reachable KRaft states (the frontiers of the port's BFS on the card),
    as numpy rows."""
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    parts = []
    for depth in depths:
        bfs = DeviceBFS(model, chunk=256, frontier_cap=1 << 13, max_seen_cap=1 << 20,
                        canon_memo_cap=1 << 12, device=dev)
        bfs.run(max_depth=depth)
        parts.append(bfs.frontier_rows.cpu().numpy()[:120])
    return np.concatenate(parts)


@pytest.mark.parametrize("name", list(KRAFT_VARIANTS))
def test_kraft_guard_apply_fold(dev, name):
    """kraft_guard, kraft_apply and kraft_fold against their plain versions
    on reachable and edge rows: a dead chunk tail, every valid lane then
    drop lanes, lanes of disabled candidates, and the fold with coverage."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.models import kraft as kr

    model = KRaftModel(KRAFT_VARIANTS[name])
    states = torch.from_numpy(kraft_edge_rows(model, _kraft_states(model, dev), seed=3)).to(dev)
    C, A = states.shape[0], model.A
    K = len(model.ACTION_NAMES)
    n_live = C - 7
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    before = kernels.launch_counts()
    gk = guard(model, states, n_live, cov_k)
    gp = guard_plain(model, states, n_live, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid, rank, ovf, _ = gk
    for r in (kr.K_REQUESTVOTE, kr.K_BECOMELEADER, kr.K_CLIENTREQUEST):
        assert bool((valid & ovf & (rank == r)).any()), r
    sel, n = compact_indices(valid.reshape(-1), int(valid.sum()) + 300, C * A)
    other = torch.randint(0, C * A, (500,), device=dev, dtype=torch.int32)
    for s in (sel, other, sel[:0]):
        s = s.contiguous()
        fk, fp = apply(model, states, s), apply_plain(model, states, s)
        assert fk.shape == (s.numel(), model.layout.W) and torch.equal(fk, fp)
    flatc = apply(model, states, sel)
    new = (torch.rand(sel.numel(), device=dev) < 0.7) & (sel < C * A)
    jcount = torch.tensor([777], dtype=torch.int64, device=dev)
    invs = tuple(model.invariants)
    vk = torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
    vp, ck, cp = vk.clone(), cov_k.clone(), cov_k.clone()
    fold(model, flatc, new, jcount, vk, invs, cov=ck, sel=sel, valid=valid, rank=rank)
    fold_plain(model, flatc, new, jcount, vp, invs, cov=cp, sel=sel, valid=valid, rank=rank)
    assert torch.equal(vk, vp) and torch.equal(ck, cp)
    after = kernels.launch_counts()
    for k in ("kraft_guard", "kraft_apply", "kraft_fold"):
        assert after[k] > before[k], k
    for k in ("raft_guard", "raft_apply", "raft_fold", "pull_guard", "pull_apply", "pull_fold"):
        assert after[k] == before[k], k


@pytest.mark.parametrize("name", list(KRAFT_VARIANTS))
def test_kraft_group_apply_worklists(dev, name):
    """kraft_apply (the group apply: G threads a worklist lane) against
    apply_plain on reachable rows and kraft_edge_rows (chains into full and
    near-full bags, logs at max_log, every arm of both CASE chains, replies
    already in the bag), on a BFS chunk's, a simulate move's, an empty and a
    random worklist, one kraft_apply launch a call and no other kernel; its
    occupancy entry names a tile of threads a lane."""
    model = KRaftModel(KRAFT_VARIANTS[name])
    states = torch.from_numpy(kraft_edge_rows(model, _kraft_states(model, dev), seed=5)).to(dev)
    check_group_apply_worklists(model, states, "kraft_apply", seed=7)
    occ = apply_occupancy(model)
    assert occ is not None and occ["G"] > 1 and occ["warps_per_sm"] > 0


@pytest.mark.parametrize("name", list(KRAFT_VARIANTS))
def test_kraft_predicates_and_sim_check(dev, name):
    """kraft_predicates on edge rows (every invariant and ValueAllOrNothing),
    and kraft_sim_check's check and settle as test_raft_sim_check holds
    raft_sim_check."""
    from raft_tpu_torch.ops.expand import predicates, predicates_plain, sim_check, sim_check_plain

    model = KRaftModel(KRAFT_VARIANTS[name])
    states = torch.from_numpy(kraft_edge_rows(model, _kraft_states(model, dev), seed=9)).to(dev)
    names = tuple(model.invariants) + tuple(model.predicates)
    for rows in (states, states[:0], states[:1]):
        rows = rows.contiguous()
        assert torch.equal(predicates(model, rows, names), predicates_plain(model, rows, names))
    R = states.shape[0]
    gen = torch.Generator().manual_seed(1)
    nxt = states[torch.randperm(R, generator=gen).to(dev)].contiguous()
    moved = (torch.rand(R, generator=gen) < 0.8).to(dev)
    nxt[~moved] = 0
    chosen = torch.randint(0, model.A, (R,), generator=gen, dtype=torch.int32).to(dev)
    init_pool = states[:3].contiguous()
    ridx = torch.randint(0, 3, (R,), generator=gen, dtype=torch.int32).to(dev)
    max_depth = 6
    depth = torch.randint(0, max_depth, (R,), generator=gen, dtype=torch.int32).to(dev)
    J = max_depth + 1
    journal = torch.randint(0, 99, (R, J), generator=gen, dtype=torch.int32).to(dev)
    jlen = (depth + 1).contiguous()
    jlen[::11] = J
    for invs in (KRAFT_INV, tuple(model.invariants), ()):
        outs = []
        for fn in (sim_check, sim_check_plain):
            args = [t.clone() for t in (nxt, depth, journal, jlen)]
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            res = fn(model, states, args[0], moved, chosen, ridx, init_pool, args[1],
                     max_depth, args[2], args[3], invs, stats)
            outs.append(list(res) + args + [stats[2:]])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n_servers", [3, 5])
def test_canon_on_kraft_rows(dev, n_servers):
    """canon_memo (three servers) and canon_tiered with canon_signatures
    (five) on KRaft rows, whose records carry the Nil-able mleader: the
    kernels equal the plain Canonicalizer, and a server permutation keeps
    the fingerprint."""
    import itertools

    from raft_tpu_torch.ops.symmetry import Canonicalizer, msg_perm_spec

    model = KRaftModel(KRaftParams(n_servers=n_servers, n_values=1, max_elections=2,
                                   max_restarts=0, msg_slots=40))
    base = _kraft_states(model, dev, depths=range(4, 12) if n_servers == 3 else range(4, 9))
    sigmas = [np.asarray(s) for s in itertools.permutations(range(n_servers))][1::5]
    perm = np.concatenate([
        permute_states(model.layout, model.packer, part, sigma, msg_perm_spec(model))
        for part, sigma in zip(np.array_split(base, len(sigmas)), sigmas)])
    states = torch.from_numpy(np.concatenate([base, perm])).to(dev)
    canon = Canonicalizer.for_model(model)
    valid = torch.rand(states.shape[0], device=dev) < 0.9
    mk = torch.full((1 << 8, 2), INT64_MAX, dtype=torch.int64, device=dev)
    mp = mk.clone()
    for _ in range(2):
        fk, hk = canon.fingerprints_memo_cuda(states, valid, mk)
        fp, hp = canon.fingerprints_memo_plain(states, valid, mp)
        assert torch.equal(fk, fp) and torch.equal(mk, mp) and int(hk) == int(hp)
    fps = canon.fingerprints(states)
    assert torch.equal(fps, canon.canon_plain(states))
    n = len(base)
    assert torch.equal(fps[:n], fps[n:])
    if n_servers == 5:
        assert torch.equal(canon.signatures(states), canon.signatures_plain(states))


def test_kraft_bfs_simulate_liveness_card_equal_cpu(dev):
    """KRaft by BFS (counts, depth counts, coverage, the violation and its
    trace with a restart allowed), by simulation (walks, final states,
    journals) and its two-server liveness graph: the card equals the CPU,
    through the KRaft kernels."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.liveness import LivenessChecker
    from raft_tpu_torch.checker.simulate import Simulator

    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 15, max_seen_cap=1 << 20,
                canon_memo_cap=1 << 12)
    kernels.reset_counts()
    for name, depth in (("kraft", 11), ("kraft_restart", 8)):
        rs = [DeviceBFS(KRaftModel(KRAFT_VARIANTS[name]), invariants=KRAFT_INV, device=d,
                        **caps).run(max_depth=depth) for d in (dev, "cpu")]
        assert (rs[0].distinct, rs[0].total, rs[0].depth_counts, rs[0].coverage,
                rs[0].violation, rs[0].trace) == (rs[1].distinct, rs[1].total,
                                                  rs[1].depth_counts, rs[1].coverage,
                                                  rs[1].violation, rs[1].trace)
    assert rs[0].violation is not None  # the restart set reaches IllegalState
    sims = [Simulator(KRaftModel(KRAFT_VARIANTS["kraft"]), invariants=KRAFT_INV, walks=64,
                      max_behavior_depth=30, seed=3, device=d) for d in (dev, "cpu")]
    ss = [s.run(max_steps=64 * 40) for s in sims]
    assert (ss[0].behaviors, ss[0].steps, ss[0].violation) == (ss[1].behaviors, ss[1].steps,
                                                               ss[1].violation)
    for a in ("states", "depth", "journal", "jlen"):
        assert torch.equal(getattr(sims[0], a).cpu(), getattr(sims[1], a))
    small = KRaftParams(n_servers=2, n_values=1, max_elections=1, max_restarts=0, msg_slots=16)
    lv = [LivenessChecker(KRaftModel(small), ("ValuesNotStuck",), chunk=256, device=d)
          for d in (dev, "cpu")]
    lr = [c.run() for c in lv]
    assert (lr[0].distinct, lr[0].total_edges, lr[0].violation) == (
        lr[1].distinct, lr[1].total_edges, lr[1].violation)
    assert torch.equal(lv[0]._states.cpu(), lv[1]._states)
    counts = kernels.launch_counts()
    for k in ("kraft_guard", "kraft_apply", "kraft_fold", "kraft_predicates", "kraft_sim_check"):
        assert counts[k] > 0, k
    for k in ("raft_guard", "raft_apply", "raft_fold", "raft_predicates", "raft_sim_check",
              "pull_guard", "pull_apply", "pull_fold"):
        assert counts[k] == 0, k


# ---------------- the reconfiguration specs ----------------

CONFIG_VARIANTS = {
    "reconfig": ReconfigRaftParams(
        n_servers=3, n_values=1, init_cluster_size=2, max_elections=1, max_restarts=0,
        max_values_per_term=1, max_add_reconfigs=1, max_remove_reconfigs=1,
        min_cluster_size=2, max_cluster_size=3, msg_slots=40),
    "joint": JointRaftParams(
        n_servers=3, n_values=1, init_cluster_size=2, max_elections=1, max_restarts=0,
        max_reconfigs=1, max_values_per_term=1, reconfig_type=2, msg_slots=40),
}
CONFIG_INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "MaxOneReconfigurationAtATime")


def _config_model(name):
    p = CONFIG_VARIANTS[name]
    return (JointRaftModel if isinstance(p, JointRaftParams) else ReconfigRaftModel)(p)


@pytest.mark.parametrize("name", list(CONFIG_VARIANTS))
def test_config_guard_apply_fold(dev, name):
    """reconfig_* / joint_* guard, apply and fold against their plain
    versions on reachable and edge rows (config_edge_rows): a dead chunk
    tail, every valid lane then drop lanes and lanes of disabled
    candidates, and the fold with coverage; no other family's kernel."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.models import config_common as cc

    model = _config_model(name)
    base = _kraft_states(model, dev, depths=range(3, 9))
    states = torch.from_numpy(config_edge_rows(model, base, seed=5)).to(dev)
    C, A = states.shape[0], model.A
    K = len(model.ACTION_NAMES)
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    before = kernels.launch_counts()
    gk = guard(model, states, C - 7, cov_k)
    gp = guard_plain(model, states, C - 7, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid, rank, ovf, _ = gk
    for r in (cc.R_REQUESTVOTE, cc.R_CLIENTREQUEST):
        assert bool((valid & ovf & (rank == r)).any()), r
    assert set(torch.unique(rank[valid]).tolist()) >= set(range(1, K))  # every disjunct but Restart
    sel, _n = compact_indices(valid.reshape(-1), int(valid.sum()) + 300, C * A)
    other = torch.randint(0, C * A, (500,), device=dev, dtype=torch.int32)
    for s in (sel, other, sel[:0]):
        s = s.contiguous()
        fk, fp = apply(model, states, s), apply_plain(model, states, s)
        assert fk.shape == (s.numel(), model.layout.W) and torch.equal(fk, fp)
    flatc = apply(model, states, sel)
    new = (torch.rand(sel.numel(), device=dev) < 0.7) & (sel < C * A)
    jcount = torch.tensor([777], dtype=torch.int64, device=dev)
    invs = tuple(model.invariants)
    vk_, vp_ = (torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
                for _ in range(2))
    ck, cp = cov_k.clone(), cov_k.clone()
    fold(model, flatc, new, jcount, vk_, invs, cov=ck, sel=sel, valid=valid, rank=rank)
    fold_plain(model, flatc, new, jcount, vp_, invs, cov=cp, sel=sel, valid=valid, rank=rank)
    assert torch.equal(vk_, vp_) and torch.equal(ck, cp)
    after = kernels.launch_counts()
    for k in ("guard", "apply", "fold"):
        assert after[f"{name}_{k}"] > before[f"{name}_{k}"], k
    for k in ("raft_guard", "pull_guard", "kraft_guard",
              "joint_guard" if name == "reconfig" else "reconfig_guard"):
        assert after[k] == before[k], k


# five-server constants (tests/test_torch_canon_tiers_wide.py PARAMS5: 5- and
# 7-word keys)
CONFIG5_VARIANTS = {
    "reconfig": dataclasses.replace(CONFIG_VARIANTS["reconfig"], n_servers=5,
                                    init_cluster_size=3, max_add_reconfigs=2,
                                    max_cluster_size=5, msg_slots=24),
    "joint": dataclasses.replace(CONFIG_VARIANTS["joint"], n_servers=5, init_cluster_size=3,
                                 max_reconfigs=2, msg_slots=24),
}


@pytest.mark.parametrize("servers", [3, 5])
@pytest.mark.parametrize("name", list(CONFIG_VARIANTS))
def test_config_group_apply_worklists(dev, name, servers):
    """reconfig_apply / joint_apply (the group apply: G threads a worklist
    lane) against apply_plain on reachable and edge rows, on the worklists
    the engines give it: a BFS chunk's (the valid lanes first, then drop
    lanes), a simulate move's (one lane a row, C = R, drops interleaved),
    an empty one and random flat ids past C * A too; each call launches the
    family's apply once and no other kernel."""
    from raft_tpu_torch import kernels

    p = (CONFIG_VARIANTS if servers == 3 else CONFIG5_VARIANTS)[name]
    model = (JointRaftModel if isinstance(p, JointRaftParams) else ReconfigRaftModel)(p)
    assert model.n_words == {(3, "reconfig"): 4, (3, "joint"): 4, (5, "reconfig"): 5,
                             (5, "joint"): 7}[servers, name]
    base = _kraft_states(model, dev, depths=range(3, 8 if servers == 3 else 6))
    states = torch.from_numpy(config_edge_rows(model, base, seed=9)).to(dev)
    check_group_apply_worklists(model, states, f"{name}_apply", seed=servers)


@pytest.mark.parametrize("servers", [3, 5])
@pytest.mark.parametrize("name", list(CONFIG_VARIANTS))
def test_config_group_guard_worklists(dev, name, servers):
    """reconfig_guard / joint_guard (the group guard: a tile of threads a
    state) against guard_plain, cov and scal included: on a BFS chunk's
    states (reachable rows, config_edge_rows and config_chain_pushoff_rows)
    with a dead tail and without, on a 65,536-walk simulate move's states,
    and on an empty chunk; each call launches the family's guard once and
    no other kernel; its occupancy entry names a tile of threads a state."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.simulate import Simulator
    from raft_tpu_torch.ops.expand import guard_occupancy

    p = (CONFIG_VARIANTS if servers == 3 else CONFIG5_VARIANTS)[name]
    model = (JointRaftModel if isinstance(p, JointRaftParams) else ReconfigRaftModel)(p)
    K = len(model.ACTION_NAMES)
    base = _kraft_states(model, dev, depths=range(3, 8 if servers == 3 else 6))
    chunk = torch.from_numpy(np.concatenate([
        config_edge_rows(model, base, seed=13),
        config_chain_pushoff_rows(model, base[:40], seed=14)])).to(dev)
    sim = Simulator(model, tuple(model.invariants), walks=65_536, max_behavior_depth=20,
                    seed=1, device=dev)
    sim.start()
    for _ in range(6):
        sim.step()
    cases = [(chunk, len(chunk)), (chunk, len(chunk) - 37), (sim.states, 65_536),
             (chunk[:0], 0)]
    for states, n_live in cases:
        cov_k = torch.randint(0, 9, (K, 3), dtype=torch.int64, device=dev)
        cov_p = cov_k.clone()
        before = kernels.launch_counts()
        gk = guard(model, states, n_live, cov_k)
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            f"{name}_guard": 1}
        gp = guard_plain(model, states, n_live, cov_p)
        for a, b in zip(gk, gp):
            assert torch.equal(a, b)
        assert torch.equal(cov_k, cov_p)
    occ = guard_occupancy(model)
    assert occ is not None and occ["G"] > 1 and occ["warps_per_sm"] > 0
    if servers == 5:
        return
    # 600 message slots: a block of fewer tiles, its rows and copies in
    # shared memory
    wide = (JointRaftModel if isinstance(p, JointRaftParams) else ReconfigRaftModel)(
        dataclasses.replace(p, msg_slots=600))
    assert guard_occupancy(wide)["threads"] < occ["threads"]
    rows = torch.from_numpy(config_edge_rows(
        wide, _kraft_states(wide, dev, depths=range(3, 6)), seed=15)).to(dev)
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    for a, b in zip(guard(wide, rows, len(rows) - 3, cov_k),
                    guard_plain(wide, rows, len(rows) - 3, cov_p)):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)


def check_group_apply_worklists(model, states, kernel: str, seed: int) -> None:
    """The group apply ``kernel`` against apply_plain on ``states`` (on the
    card), on the worklists the engines give it: a BFS chunk's (the valid
    lanes first, then drop lanes), a simulate move's (one lane a row, C = R,
    drops interleaved), an empty one and random flat ids past C * A too;
    each call launches ``kernel`` once and no other kernel."""
    from raft_tpu_torch import kernels

    dev = states.device
    C, A = states.shape[0], model.A
    cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    valid = guard(model, states, C, cov)[0]
    gen = torch.Generator().manual_seed(seed)
    bfs_sel, _n = compact_indices(valid.reshape(-1), int(valid.sum()) + 257, C * A)
    pick = (torch.rand((C, A), generator=gen).to(dev) * valid).argmax(1)
    walk = valid.any(1) & (torch.rand(C, generator=gen).to(dev) < 0.8)
    sim_sel = torch.where(walk, torch.arange(C, device=dev) * A + pick, C * A).to(torch.int32)
    rnd = torch.randint(0, C * A + 50, (700,), generator=gen, dtype=torch.int32).to(dev)
    assert bool((sim_sel == C * A).any()) and bool((sim_sel < C * A).any())
    for sel in (bfs_sel, sim_sel, bfs_sel[:0], rnd):
        sel = sel.contiguous()
        before = kernels.launch_counts()
        fk = apply(model, states, sel)
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {kernel: 1}
        fp = apply_plain(model, states, sel)
        assert fk.shape == (sel.numel(), model.layout.W) and torch.equal(fk, fp)


@pytest.mark.parametrize("name", list(CONFIG_VARIANTS))
def test_config_predicates_and_sim_check(dev, name):
    """The family's predicates kernel on edge rows (every invariant and
    ReconfigurationCompletes' P and Q), and its sim_check's check and
    settle, against their plain versions."""
    from raft_tpu_torch.ops.expand import predicates, predicates_plain, sim_check, sim_check_plain

    model = _config_model(name)
    base = _kraft_states(model, dev, depths=range(3, 9))
    states = torch.from_numpy(config_edge_rows(model, base, seed=6)).to(dev)
    names = tuple(model.invariants) + tuple(model.predicates)
    for rows in (states, states[:0], states[:1]):
        rows = rows.contiguous()
        assert torch.equal(predicates(model, rows, names), predicates_plain(model, rows, names))
    R = states.shape[0]
    gen = torch.Generator().manual_seed(2)
    nxt = states[torch.randperm(R, generator=gen).to(dev)].contiguous()
    moved = (torch.rand(R, generator=gen) < 0.8).to(dev)
    nxt[~moved] = 0
    chosen = torch.randint(0, model.A, (R,), generator=gen, dtype=torch.int32).to(dev)
    init_pool = states[:3].contiguous()
    ridx = torch.randint(0, 3, (R,), generator=gen, dtype=torch.int32).to(dev)
    depth = torch.randint(0, 6, (R,), generator=gen, dtype=torch.int32).to(dev)
    journal = torch.randint(0, 99, (R, 7), generator=gen, dtype=torch.int32).to(dev)
    jlen = (depth + 1).contiguous()
    jlen[::11] = 7
    for invs in (CONFIG_INV, tuple(model.invariants), ()):
        outs = []
        for fn in (sim_check, sim_check_plain):
            args = [t.clone() for t in (nxt, depth, journal, jlen)]
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            res = fn(model, states, args[0], moved, chosen, ridx, init_pool, args[1], 6,
                     args[2], args[3], invs, stats)
            outs.append(list(res) + args + [stats[2:]])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CONFIG_VARIANTS))
def test_canon_memo_on_config_rows(dev, name):
    """canon_memo's general path (N-word bags, the server_bitmask and
    server_nil kinds, up to 24 remap fields) on reachable reconfiguration
    rows and their server-permuted copies: the kernel equals the plain
    Canonicalizer, memo cold and warm, and the permuted rows keep their
    fingerprints."""
    import itertools

    from raft_tpu_torch.ops.symmetry import Canonicalizer, msg_perm_spec

    model = _config_model(name)
    base = _kraft_states(model, dev, depths=range(4, 10))
    sigmas = [np.asarray(s) for s in itertools.permutations(range(3))][1:]
    perm = np.concatenate([
        permute_states(model.layout, model.packer, part, sigma, msg_perm_spec(model))
        for part, sigma in zip(np.array_split(base, len(sigmas)), sigmas)])
    states = torch.from_numpy(np.concatenate([base, perm])).to(dev)
    for symmetry in (True, False):
        canon = Canonicalizer.for_model(model, symmetry=symmetry)
        valid = torch.rand(states.shape[0], device=dev) < 0.9
        mk = torch.full((1 << 8, 2), INT64_MAX, dtype=torch.int64, device=dev)
        mp = mk.clone()
        for _ in range(2):
            fk, hk = canon.fingerprints_memo_cuda(states, valid, mk)
            fp, hp = canon.fingerprints_memo_plain(states, valid, mp)
            assert torch.equal(fk, fp) and torch.equal(mk, mp) and int(hk) == int(hp)
    fps = Canonicalizer.for_model(model).fingerprints(states)
    n = len(base)
    assert torch.equal(fps[:n], fps[n:])


# the four-server cfgs' constants (chip_smoke.py ADDREMOVE_CFG, JOINT_CFG) at
# 24 message slots: canon_memo's general path at P = 24
CONFIG4_VARIANTS = {
    "reconfig": dataclasses.replace(CONFIG_VARIANTS["reconfig"], n_servers=4,
                                    init_cluster_size=3, max_cluster_size=4, msg_slots=24),
    "joint": dataclasses.replace(CONFIG_VARIANTS["joint"], n_servers=4, init_cluster_size=3,
                                 max_reconfigs=2, msg_slots=24),
}


@pytest.mark.parametrize("case", ["raft2", "raft3", "raft3_raw", "kraft3", "addremove4",
                                  "joint4", "joint4_raw", "all_invalid"])
def test_canon_memo_worklist_invalid_tail(dev, case):
    """canon_memo on a worklist as the BFS gives it (guard, compact and
    apply of a chunk of reachable states: the valid prefix, then the
    invalid tail) on both builds (the 2-word one at P = 2 and 6, KRaft's
    Nil-able kind; the general one at four servers, P = 24), symmetry on
    and off (``_raw``: the raw key), and on an all-invalid worklist: equal
    to the plain version, memo cold then warm (fingerprints, INT64_MAX on
    every invalid lane, memo rows, hit counts a state). The build reports
    its tile, block shape and at least one resident warp an SM."""
    from raft_tpu_torch.ops.symmetry import Canonicalizer

    if case.startswith(("raft", "all")):
        model = RaftModel(RaftParams(n_servers=2 if case == "raft2" else 3, n_values=1,
                                     max_elections=2, max_restarts=0, msg_slots=24))
    elif case == "kraft3":
        model = KRaftModel(KRaftParams(n_servers=3, n_values=1, max_elections=2,
                                       max_restarts=0, msg_slots=40))
    else:
        p = CONFIG4_VARIANTS["reconfig" if case == "addremove4" else "joint"]
        model = (JointRaftModel if isinstance(p, JointRaftParams) else ReconfigRaftModel)(p)
    pool = _kraft_states(model, dev, depths=range(4, 9))
    batch = torch.from_numpy(pool[np.random.default_rng(3).integers(0, len(pool), 512)]).to(dev)
    C, A = batch.shape[0], model.A
    cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    valid = guard(model, batch, C, cov)[0]
    if case == "all_invalid":
        valid = torch.zeros_like(valid)
    n_valid = int(valid.sum())
    sel, _n = compact_indices(valid.reshape(-1), n_valid + 3000, C * A)
    flatc = apply(model, batch, sel)
    selv = sel < C * A
    assert int(selv.sum()) == n_valid and not bool(selv[n_valid:].any())
    canon = Canonicalizer.for_model(model, symmetry=not case.endswith("_raw"))
    assert not canon.prune and canon.memo_general() == case.startswith(("addremove", "joint"))
    occ = canon.occupancy(dev)
    assert occ["warps_per_sm"] >= 1 and occ["threads"] % occ["G"] == 0
    print(f"{case}: G {occ['G']}, {occ['threads']} threads a block, {occ['warps_per_sm']} warps "
          "an SM")
    mk = torch.full((1 << 8, 2), INT64_MAX, dtype=torch.int64, device=dev)
    mp = mk.clone()
    hits = []
    for _ in range(2):
        fk, hk = canon.fingerprints_memo_cuda(flatc, selv, mk)
        fp, hp = canon.fingerprints_memo_plain(flatc, selv, mp)
        assert torch.equal(fk, fp) and torch.equal(mk, mp) and int(hk) == int(hp)
        hits.append(int(hk))
    assert bool((fk[~selv] == INT64_MAX).all())
    if case == "all_invalid" or case.endswith("_raw"):
        assert hits == [0, 0]
    else:
        assert hits[1] > hits[0]


# chip_smoke.py's ADDREMOVE5_CFG and JOINT5_CFG at 24 message slots
CONFIG5_VARIANTS = {
    "reconfig": dataclasses.replace(CONFIG_VARIANTS["reconfig"], n_servers=5,
                                    init_cluster_size=3, max_add_reconfigs=2,
                                    max_cluster_size=5, msg_slots=24),
    "joint": dataclasses.replace(CONFIG_VARIANTS["joint"], n_servers=5, init_cluster_size=3,
                                 max_reconfigs=2, msg_slots=24),
}


@pytest.mark.parametrize("name", list(CONFIG5_VARIANTS))
def test_canon_tiered_general_path_on_config5_rows(dev, name):
    """canon_tiered's general path and canon_signatures (5- and 7-word keys,
    member-set fields, log fields of several lanes a server) on reachable
    five-server reconfiguration rows, their server-permuted copies and edge
    rows, at fingerprint seeds 0 and 0x5EED5EED: the kernels equal the
    plain Canonicalizer, memo cold and warm, and the permuted rows keep
    their fingerprints; the family's guard, apply and fold at five servers
    equal their plain versions on the same rows."""
    import itertools

    from raft_tpu_torch.ops.symmetry import Canonicalizer, msg_perm_spec

    p = CONFIG5_VARIANTS[name]
    model = (JointRaftModel if isinstance(p, JointRaftParams) else ReconfigRaftModel)(p)
    base = _kraft_states(model, dev, depths=range(4, 10))
    sigmas = [np.asarray(s) for s in itertools.permutations(range(5))][1::7]
    perm = np.concatenate([
        permute_states(model.layout, model.packer, part, sigma, msg_perm_spec(model))
        for part, sigma in zip(np.array_split(base, len(sigmas)), sigmas)])
    edge = config_edge_rows(model, base, seed=8)
    states = torch.from_numpy(np.concatenate([base, perm, edge])).to(dev)
    for seed in (0, 0x5EED5EED):
        canon = Canonicalizer.for_model(model, seed=seed)
        assert canon.prune and canon.tier_general()
        valid = torch.rand(states.shape[0], device=dev) < 0.9
        mk = torch.full((1 << 8, 2), INT64_MAX, dtype=torch.int64, device=dev)
        mp = mk.clone()
        for _ in range(2):
            fk, hk = canon.fingerprints_memo_cuda(states, valid, mk)
            fp, hp = canon.fingerprints_memo_plain(states, valid, mp)
            assert torch.equal(fk, fp) and torch.equal(mk, mp) and int(hk) == int(hp)
        assert torch.equal(canon.signatures(states), canon.signatures_plain(states))
        fps = canon.fingerprints(states)
        n = len(base)
        assert torch.equal(fps[:n], fps[n:2 * n])
    rows = states[2 * len(base):].contiguous()
    C, A = rows.shape[0], model.A
    cov_k = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    gk, gp = guard(model, rows, C, cov_k), guard_plain(model, rows, C, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    sel, _n = compact_indices(gk[0].reshape(-1), int(gk[0].sum()) + 64, C * A)
    assert torch.equal(apply(model, rows, sel), apply_plain(model, rows, sel))


def _memo_cold_warm(canon, states, valid, dev):
    """canon_tiered against its plain version through a 256-row memo,
    cold then warm: fingerprints, memo rows and hit counts equal; returns
    (fingerprints, [cold hits, warm hits])."""
    mk = torch.full((1 << 8, 2), INT64_MAX, dtype=torch.int64, device=dev)
    mp = mk.clone()
    hits = []
    for _ in range(2):
        fk, hk = canon.fingerprints_memo_cuda(states, valid, mk)
        fp, hp = canon.fingerprints_memo_plain(states, valid, mp)
        assert torch.equal(fk, fp) and torch.equal(mk, mp) and int(hk) == int(hp)
        hits.append(int(hk))
    return fk, hits


@pytest.mark.parametrize("case", ["interleaved", "prefix", "all_invalid", "tied5", "tied6",
                                  "config5_interleaved"])
def test_canon_tiered_valid_lanes_and_ties(dev, case):
    """canon_tiered works on valid lanes only, a tile of threads a lane:
    a valid mask interleaved rather than a prefix (five-server Raft rows on
    the 2-word build, five-server AddRemove rows on the general one), a
    valid prefix (the blocks past it return at once) and an all-invalid
    batch equal the plain version, memo cold and warm, hit
    counts included; all-tied Init replicas at five and six servers (every
    one of the S! permutations admissible) give the plain full-S! min. The
    build reports at least one resident warp an SM."""
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.ops.symmetry import Canonicalizer

    if case == "config5_interleaved":
        model = ReconfigRaftModel(CONFIG5_VARIANTS["reconfig"])
        rows = _kraft_states(model, dev, depths=range(4, 10))
    else:
        n_servers = 6 if case == "tied6" else 5
        model = RaftModel(RaftParams(n_servers=n_servers, n_values=2, max_elections=2,
                                     max_restarts=0, msg_slots=24))
        if case.startswith("tied"):
            rows = np.repeat(model.init_states(), 300, axis=0)
        else:
            bfs = DeviceBFS(model, chunk=256, frontier_cap=1 << 14, max_seen_cap=1 << 20,
                            canon_memo_cap=1 << 12, device=dev)
            bfs.run(max_depth=6)
            rows = bfs.frontier_rows.cpu().numpy()[:900]
    canon = Canonicalizer.for_model(model)
    assert canon.prune and canon.tier_general() == (case == "config5_interleaved")
    assert canon.occupancy(dev)["warps_per_sm"] >= 1
    states = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    B = states.shape[0]
    if case == "all_invalid":
        valid = torch.zeros(B, dtype=torch.bool, device=dev)
    elif case.endswith("interleaved"):
        valid = torch.arange(B, device=dev) % 3 != 1
    elif case == "prefix":
        valid = torch.arange(B, device=dev) < B // 3
    else:
        valid = torch.ones(B, dtype=torch.bool, device=dev)
    fps, hits = _memo_cold_warm(canon, states, valid, dev)
    if case == "all_invalid":
        assert hits == [0, 0] and bool((fps == INT64_MAX).all())
    else:
        assert hits[1] > hits[0] and bool((fps[~valid] == INT64_MAX).all())
    if case.startswith("tied"):
        full = canon._hash(states[:, :canon.VL], remap=True).min(dim=0).values
        assert torch.equal(fps, full) and len(set(fps.tolist())) == 1


def test_config_bfs_simulate_liveness_card_equal_cpu(dev):
    """Both reconfiguration specs by BFS (counts, depth counts, coverage)
    and by simulation (walks, final states, journals), and AddRemove's
    ReconfigurationCompletes graph at MaxElections 0 (states, edges,
    verdict): the card equals the CPU, through the families' kernels."""
    import dataclasses

    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.liveness import LivenessChecker
    from raft_tpu_torch.checker.simulate import Simulator

    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 15, max_seen_cap=1 << 20,
                canon_memo_cap=1 << 12)
    kernels.reset_counts()
    for name in CONFIG_VARIANTS:
        rs = [DeviceBFS(_config_model(name), invariants=CONFIG_INV, device=d, **caps).run(
            max_depth=6) for d in (dev, "cpu")]
        assert (rs[0].distinct, rs[0].total, rs[0].depth_counts, rs[0].coverage,
                rs[0].violation) == (rs[1].distinct, rs[1].total, rs[1].depth_counts,
                                     rs[1].coverage, rs[1].violation)
        sims = [Simulator(_config_model(name), invariants=CONFIG_INV, walks=32,
                          max_behavior_depth=20, seed=4, device=d) for d in (dev, "cpu")]
        ss = [s.run(max_steps=32 * 20) for s in sims]
        assert (ss[0].behaviors, ss[0].steps, ss[0].violation) == (
            ss[1].behaviors, ss[1].steps, ss[1].violation)
        for a in ("states", "depth", "journal", "jlen"):
            assert torch.equal(getattr(sims[0], a).cpu(), getattr(sims[1], a))
    live = dataclasses.replace(CONFIG_VARIANTS["reconfig"], max_elections=0,
                               max_remove_reconfigs=0, msg_slots=32)
    lv = [LivenessChecker(ReconfigRaftModel(live), ("ReconfigurationCompletes",), chunk=256,
                          device=d) for d in (dev, "cpu")]
    lr = [c.run() for c in lv]
    assert (lr[0].distinct, lr[0].total_edges, lr[0].violation) == (
        lr[1].distinct, lr[1].total_edges, lr[1].violation)
    assert lr[0].violation is None and lr[0].distinct > 100
    for a in ("_esrc", "_edst", "_ecand"):
        assert np.array_equal(getattr(lv[0], a), getattr(lv[1], a))
    counts = kernels.launch_counts()
    for fam in CONFIG_VARIANTS:
        for k in ("guard", "apply", "fold", "predicates", "sim_check"):
            assert counts[f"{fam}_{k}"] > 0 or (fam, k) == ("joint", "predicates"), (fam, k)


# ---------------- KRaftWithReconfig (kreconfig_* and slot_canon) ----------------

def kreconfig_edge_rows(model, st: np.ndarray, seed: int) -> np.ndarray:
    """Reachable KRaftWithReconfig states ``st`` and edge cases built from
    them: copies with three random view lanes set to small values (half
    with a restart left); copies where every used slot is a voting member
    able to start an election or to win one, their bags full or one or two
    slots short (random keys), so the RequestVote and BeginQuorum chains
    overflow partway; copies with every log at max_log and no value acked
    (ClientRequest, HandleRemoveRequest, AcceptJoinRequest and an accepted
    entry overflow it); scrambled copies (random states, roles, epochs,
    leaders, votes, pending fetches, configs, endOffset rows, logs of every
    command, hwm and acks) whose bags hold records of all seven types built
    from the row (a destination slot and its epoch, FetchResponses mostly
    carrying the destination's own pending fetch as their correlation, joins
    from observers outside the config), so that every receipt arm fires;
    and the same scrambled rows with every count at 0."""
    rng = np.random.default_rng(seed)
    lay, p, pk = model.layout, model.p, model.packer
    NS, L, V, M, NW, E = (model.NS, p.max_log, p.n_values, p.msg_slots, model.n_words,
                          p.max_epoch)
    ws = [lay.sl(f"msg_w{k}") for k in range(NW)]
    cs = lay.sl("msg_cnt")
    off = {n: lay.fields[n].offset for n in lay.fields}

    def put_bag(r, keys, free=0):
        keys = sorted(set(keys))[: M - free]
        bag = np.full((NW + 1, M), EMPTY)
        bag[NW] = 0
        if keys:
            bag[:NW, :len(keys)] = np.array(keys).T
            bag[NW, :len(keys)] = rng.integers(0, 3, len(keys))
        for k in range(NW):
            r[ws[k]] = bag[k]
        r[cs] = bag[NW]

    def own_keys(r):
        return set(zip(*(r[w].tolist() for w in ws))) - {(EMPTY,) * NW}

    pert = st.copy()
    for r in pert:
        r[rng.integers(0, lay.view_len, 3)] = rng.integers(-1, 7, 3)
    pert[::2, off["restartCtr"]] = 0
    chain = st[:64].copy()
    for r in chain:
        used = r[lay.sl("used")] > 0
        mask = int(sum(1 << i for i in range(NS) if used[i]))
        r[lay.sl("role")] = np.where(used, 1, 0)
        r[lay.sl("state")] = np.where(used, rng.choice([2, 3, 0], NS), 0)
        r[lay.sl("cfg_members")] = np.where(used, mask, 0)
        r[lay.sl("votesGranted")] = np.where(rng.random(NS) < 0.5, mask, 0)
        r[off["electionCtr"]] = 0
        keys = own_keys(r)
        free = int(rng.integers(0, 3))
        while len(keys) < M - free:
            keys.add(tuple(int(x) for x in rng.integers(0, 1 << 20, NW)))
        put_bag(r, keys, free)
    maxlog = st[:64].copy()
    maxlog[:, lay.sl("log_len")] = L
    maxlog[:, lay.sl("acked")] = 0
    maxlog[:, lay.sl("highWatermark")] = L
    maxlog[:, lay.sl("cfg_committed")] = 1
    maxlog[:, off["removeCtr"]] = 0

    scr = st[:96].copy()
    bits = {f: b for f, (_o, b) in pk.fields.items()}
    for r in scr:
        used = r[lay.sl("used")] > 0
        slots = np.flatnonzero(used)
        mask = int(sum(1 << i for i in slots))
        g = lambda n: r[lay.sl(n)]  # noqa: E731
        r[lay.sl("state")] = np.where(used, rng.choice([0, 1, 2, 3, 4, 4, 5, 6, 7], NS), 0)
        r[lay.sl("role")] = np.where(used, rng.choice([1, 1, 2, 3], NS), 0)
        r[lay.sl("currentEpoch")] = rng.integers(0, E + 1, NS)
        r[lay.sl("leader")] = rng.integers(0, NS + 1, NS)
        r[lay.sl("votedFor")] = rng.integers(0, NS + 1, NS)
        r[lay.sl("votesGranted")] = rng.integers(0, mask + 1, NS) & mask
        r[lay.sl("cfg_id")] = rng.integers(0, p.max_cfg_id + 1, NS)
        r[lay.sl("cfg_members")] = rng.integers(0, mask + 1, NS) & mask
        r[lay.sl("cfg_committed")] = rng.integers(0, 2, NS)
        r[lay.sl("eo_dom")] = rng.integers(0, mask + 1, NS) & mask
        r[lay.sl("endOffset")] = rng.integers(0, L + 1, NS * NS)
        r[lay.sl("log_len")] = rng.integers(0, L + 1, NS)
        r[lay.sl("log_cmd")] = rng.choice([1, 2, 2, 3, 4], NS * L)
        r[lay.sl("log_epoch")] = np.sort(rng.integers(0, E + 1, (NS, L)), axis=1).reshape(-1)
        r[lay.sl("log_val")] = rng.integers(0, V + 1, NS * L)
        r[lay.sl("log_cfgid")] = rng.integers(0, p.max_cfg_id + 1, NS * L)
        r[lay.sl("log_who")] = rng.integers(0, NS + 1, NS * L)
        r[lay.sl("log_members")] = rng.integers(0, mask + 1, NS * L) & mask
        r[lay.sl("highWatermark")] = rng.integers(0, L + 1, NS)
        r[lay.sl("acked")] = rng.integers(0, 3, V)
        pf = rng.random(NS) < 0.6
        r[lay.sl("pf_active")] = pf
        r[lay.sl("pf_epoch")] = np.where(pf, rng.integers(0, E + 1, NS), 0)
        r[lay.sl("pf_offset")] = np.where(pf, rng.integers(0, L + 1, NS), 0)
        r[lay.sl("pf_lastepoch")] = np.where(pf, rng.integers(0, E + 1, NS), 0)
        r[lay.sl("pf_dest")] = np.where(pf, rng.integers(1, NS + 1, NS), 0)
        r[lay.sl("pf_observer")] = np.where(pf, rng.integers(0, 2, NS), 0)
        keys = set()
        for _ in range(int(rng.integers(1, M // 2))):
            dst = int(rng.choice(slots))
            src = int(rng.integers(0, NS))
            ep = int(np.clip(g("currentEpoch")[dst] + rng.choice([-1, 0, 0, 0, 1]), 0, E))
            vals = {f: int(rng.integers(0, 1 << b)) for f, b in bits.items()}
            vals.update(mtype=int(rng.integers(1, 8)), mepoch=ep, mdest=dst, msource=src,
                        merror=int(rng.choice([0, 0, 0, 1, 2, 3, 4, 5])),
                        mresult=int(rng.choice([1, 1, 2, 3])),
                        mfetchOffset=int(rng.integers(0, L + 1)),
                        mlastFetchedEpoch=int(rng.integers(0, E + 1)),
                        e_cmd=int(rng.integers(1, 5)))
            if vals["mtype"] == 5 and g("pf_active")[dst] and rng.random() < 0.8:
                vals.update(cepoch=int(g("pf_epoch")[dst]), cfetchOffset=int(g("pf_offset")[dst]),
                            clastFetchedEpoch=int(g("pf_lastepoch")[dst]),
                            cobserver=int(g("pf_observer")[dst]),
                            msource=int(g("pf_dest")[dst]) - 1)
            if vals["mtype"] == 4 and rng.random() < 0.5:  # a fetch the leader accepts
                ll, lt = int(g("log_len")[dst]), g("log_epoch").reshape(NS, L)[dst]
                k = int(rng.integers(0, ll + 1))
                vals.update(mfetchOffset=k, mlastFetchedEpoch=int(lt[k - 1]) if k else 0)
            vals = {f: v & ((1 << bits[f]) - 1) for f, v in vals.items()}
            if vals["msource"] != vals["mdest"]:
                keys.add(pk.pack(**vals))
        put_bag(r, keys)
    zero = scr.copy()
    zero[:, cs] = 0
    forced, _expect = kreconfig_forced_rows(model)
    return np.ascontiguousarray(np.concatenate([st, pert, chain, maxlog, scr, zero, forced])
                                .astype(np.int32))


def kreconfig_bag_rows(model, st, seed):
    """KRaftWithReconfig rows of ``st`` whose bags are empty (c = 0), full (c = M: random
    unique keys of random fields), hold an unused slot with a key word after
    EMPTY (word 1 = 5: ranked among the unused slots), or a slot whose word 0
    lies above EMPTY (EMPTY + 3: every slot ranked under each pair)."""
    rng = np.random.default_rng(seed)
    lay, M, NW = model.layout, model.p.msg_slots, model.n_words
    ws = [lay.sl(f"msg_w{k}") for k in range(NW)]
    cs = lay.sl("msg_cnt")
    empty, full = st[:24].copy(), st[:24].copy()
    for r in empty:
        for w in ws:
            r[w] = EMPTY
        r[cs] = 0
    for r in full:
        keys = sorted({tuple(int(x) for x in rng.integers(0, 1 << 29, NW)) for _ in range(M)})
        while len(keys) < M:
            keys = sorted(set(keys) | {tuple(int(x) for x in rng.integers(0, 1 << 29, NW))})
        bag = np.array(keys[:M]).T
        for k, w in enumerate(ws):
            r[w] = bag[k]
        r[cs] = rng.integers(0, 3, M)
    odd = []
    for r in st[:48]:
        words = np.stack([r[w] for w in ws])
        free = np.flatnonzero(words[0] == EMPTY)
        if len(free) < 2:
            continue
        a = r.copy()  # an unused slot's word 1 after EMPTY, another's count
        a[lay.fields["msg_w1"].offset + free[0]] = 5
        a[lay.fields["msg_cnt"].offset + free[-1]] = 2
        b = r.copy()  # a word 0 above EMPTY
        b[lay.fields["msg_w0"].offset + free[0]] = EMPTY + 3
        odd += [a, b]
    return np.concatenate([empty, full, np.stack(odd)]).astype(np.int32)


def kreconfig_forced_rows(model):
    """Rows built from Init that fire each receipt arm whatever states the
    rest of kreconfig_edge_rows was built from, and the ones a sample
    rarely holds: a spawned server (slot InitClusterSize, its identity's
    diskId 1, as StartNewServer mints it) whose first fetch (mepoch 0)
    reaches the leader; a join of that fresh identity accepted by the
    leader, and again with the leader's log at max_log so that the append
    overflows; the three FetchResponse arms at a follower whose pending
    fetch they answer (UnknownMember from a later epoch: the non-success
    arm that makes it an Observer), again with its log at max_log; the
    vote request, vote response, BeginQuorum and the four FetchRequest
    arms; BecomeLeader, SendJoinRequest and HandleRemoveRequest. Returns (rows [F, W] int32, expect): expect lists (row, rank,
    overflow, what), the disjunct that must be valid on some lane of that
    row, with an overflow there where ``overflow``."""
    from raft_tpu_torch.models import kraft_reconfig as kr

    lay, p, pk = model.layout, model.p, model.packer
    L, M, NW = p.max_log, p.msg_slots, model.n_words
    ics = p.init_cluster_size
    s = ics  # the first spawned slot; slot 0 leads epoch 1, slot 1 follows
    off = {n: lay.fields[n].offset for n in lay.fields}
    init = model.init_states()[0]

    def row(per=None):
        """Init with the spawned observer, then per's {(field, slot): value}."""
        r = init.copy()
        for f, v in (("used", 1), ("host", 0), ("diskId", 1), ("role", kr.R_OBSERVER),
                     ("eo_dom", (1 << ics) - 1), ("pf_active", 1), ("pf_dest", 1),
                     ("pf_observer", 1)):
            r[off[f] + s] = v
        r[off["diskIdGen"]] = 1
        for (f, i), v in (per or {}).items():
            r[off[f] + i] = v
        return r

    def fill_log(r, i, n):
        """Slot i's log: its Init entry, then appends of value 1 in epoch
        1, to length n."""
        for k in range(1, n):
            for f, v in (("cmd", kr.C_APPEND), ("epoch", 1), ("val", 1)):
                r[off[f"log_{f}"] + i * L + k] = v
        r[off["log_len"] + i] = n

    def bag(r, *msgs):
        keys = sorted(pk.pack(**m) for m in msgs)
        words = np.full((NW, M), EMPTY)
        if keys:
            words[:, :len(keys)] = np.array(keys).T
        for k in range(NW):
            r[lay.sl(f"msg_w{k}")] = words[k]
        r[lay.sl("msg_cnt")] = np.where(words[0] != EMPTY, 1, 0)
        return r

    first_fetch = dict(mtype=kr.FETCHREQ, mepoch=0, mfetchOffset=0, mlastFetchedEpoch=0,
                       mobserver=1, msource=s, mdest=0)
    join = dict(mtype=kr.JOINREQ, mepoch=1, msource=s, mdest=0)
    corr = dict(mtype=kr.FETCHRESP, msource=0, mdest=1, cepoch=1, cfetchOffset=1,
                clastFetchedEpoch=1, cobserver=0)
    pending = {("pf_active", 1): 1, ("pf_epoch", 1): 1, ("pf_offset", 1): 1,
               ("pf_lastepoch", 1): 1, ("pf_dest", 1): 1}
    resp = (dict(corr, mepoch=1, mleader=1, mresult=kr.R_DIVERGING, mdivergingEpoch=1,
                 mdivergingEndOffset=1),
            dict(corr, mepoch=1, mleader=1, mresult=kr.R_OK, nentries=1, e_cmd=kr.C_APPEND,
                 e_epoch=1, e_val=1, mhwm=1),
            dict(corr, mepoch=2, mleader=0, mresult=kr.R_NOTOK, merror=kr.E_UNKNOWN_MEMBER))
    rows, expect = [], []

    def add(r, *exp):
        expect.extend((len(rows), rk, o, what) for rk, o, what in exp)
        rows.append(r)

    add(bag(row(), first_fetch,
            dict(mtype=kr.JOINRESP, mepoch=1, mleader=1, mresult=kr.R_NOTOK,
                 merror=kr.E_NOTLEADER, msource=1, mdest=s),
            dict(mtype=kr.JOINREQ, mepoch=1, msource=s, mdest=1)),
        (kr.KR_REJECT_FETCH, False, "a spawned server's first fetch, mepoch 0"),
        (kr.KR_HANDLE_REJECT_JOIN, False, "a reject-join response, its Discard arm"),
        (kr.KR_REJECT_JOIN, False, "a join sent to a follower"))
    joined = {("currentEpoch", s): 1, ("leader", s): 1, ("pf_active", s): 0,
              ("pf_dest", s): 0, ("pf_observer", s): 0}
    add(bag(row(joined), join), (kr.KR_ACCEPT_JOIN, False, "a join of a fresh identity"))
    r = row({**joined, ("highWatermark", 0): L})
    fill_log(r, 0, L)
    add(bag(r, join), (kr.KR_ACCEPT_JOIN, True, "a fresh join at the leader's max_log"))
    add(bag(row(),
            dict(mtype=kr.FETCHREQ, mepoch=1, mfetchOffset=1, mlastFetchedEpoch=1, msource=1,
                 mdest=0),
            dict(mtype=kr.FETCHREQ, mepoch=1, mfetchOffset=3, mlastFetchedEpoch=1, msource=1,
                 mdest=0),
            dict(first_fetch, mepoch=1),
            dict(mtype=kr.BQREQ, mepoch=1, msource=0, mdest=1),
            dict(mtype=kr.RVREQ, mepoch=2, mlastLogEpoch=1, mlastLogOffset=1, msource=0,
                 mdest=1)),
        (kr.KR_ACCEPT_FETCH_VOTER, False, "a voter's fetch"),
        (kr.KR_DIVERGING_FETCH, False, "a fetch past the leader's log"),
        (kr.KR_ACCEPT_FETCH_OBSERVER, False, "an observer's fetch"),
        (kr.KR_ACCEPT_BQREQ, False, "a BeginQuorum request"),
        (kr.KR_HANDLE_RVREQ, False, "a vote request"))
    r = row(pending)
    fill_log(r, 1, 2)
    add(bag(r, *resp), (kr.KR_HANDLE_FETCH_DIV, False, "a diverging fetch response"),
        (kr.KR_HANDLE_FETCH_OK, False, "a success fetch response"),
        (kr.KR_HANDLE_FETCH_NONSUCCESS, False, "an UnknownMember fetch response"))
    r = row(pending)
    fill_log(r, 1, L)
    add(bag(r, *resp), (kr.KR_HANDLE_FETCH_OK, True, "a success response at max_log"))
    add(bag(row({("state", 1): kr.CANDIDATE, ("currentEpoch", 1): 2, ("leader", 1): 0,
                   ("votedFor", 1): 2, ("votesGranted", 1): 3}),
            dict(mtype=kr.RVRESP, mepoch=2, mvoteGranted=1, msource=0, mdest=1)),
        (kr.KR_HANDLE_RVRESP, False, "a granted vote"),
        (kr.KR_BECOMELEADER, False, "a candidate holding a quorum"))
    # the leader's committed config holds the spawned server too: a remove
    # above MinClusterSize; the observer knows the leader: its join request
    add(bag(row({**joined, ("cfg_members", 0): (1 << ics) - 1 | 1 << s})),
        (kr.KR_SENDJOIN, False, "an observer outside its config"),
        (kr.KR_HANDLE_REMOVE, False, "a remove above MinClusterSize"))
    return np.stack(rows).astype(np.int32), expect


def kreconfig_missing_arms(model, valid, rank, ovf) -> list:
    """What the guard's (valid, rank, ovf) [C, A] over kreconfig_edge_rows'
    rows (the forced rows last) lacks: each disjunct of Next valid on no
    lane, and each expectation of kreconfig_forced_rows not met on its row.
    Empty when every disjunct and every receipt arm fired."""
    forced, expect = kreconfig_forced_rows(model)
    valid, rank, ovf = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                        for x in (valid, rank, ovf))
    fired = set(np.unique(rank[valid]).tolist())
    missing = [n for k, n in enumerate(model.ACTION_NAMES) if k not in fired]
    base = valid.shape[0] - len(forced)
    for i, rk, o, what in expect:
        hit = valid[base + i] & (rank[base + i] == rk)
        if o:
            hit = hit & ovf[base + i]
        if not hit.any():
            missing.append(f"{model.ACTION_NAMES[rk]} ({what})")
    return missing


# the reference tests' SMALLP constants (tests/test_kraft_reconfig.py:199-204)
# and the 428-state liveness universe (tests/test_liveness_families.py:151-156)
KRECONFIG_P = dict(n_hosts=3, n_values=1, init_cluster_size=2, min_cluster_size=2,
                   max_cluster_size=3, max_elections=1, max_restarts=1, max_values_per_epoch=1,
                   max_add_reconfigs=1, max_remove_reconfigs=1, max_spawned_servers=4,
                   msg_slots=24)
KRECONFIG_LIVE_P = dict(KRECONFIG_P, n_hosts=2, max_cluster_size=2, max_restarts=0,
                        max_spawned_servers=2)
KRECONFIG_INV = ("NoIllegalState", "NoLogDivergence", "NeverTwoLeadersInSameEpoch",
                 "LeaderHasAllAckedValues", "StatesMatchRoles")


def _kreconfig_model(**kw):
    from raft_tpu_torch.models.kraft_reconfig import KRaftReconfigModel, KRaftReconfigParams

    return KRaftReconfigModel(KRaftReconfigParams(**dict(KRECONFIG_P, **kw)))


def test_kreconfig_guard_apply_fold(dev):
    """kreconfig_guard, kreconfig_apply and kreconfig_fold against their
    plain versions on reachable rows (the card's own BFS frontiers, through
    slot_canon) and kreconfig_edge_rows: a dead chunk tail, every valid lane
    then drop lanes and lanes of disabled candidates, and the fold with
    coverage; no other family's kernel and no canon_memo."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.models import kraft_reconfig as kr

    model = _kreconfig_model()
    base = _kraft_states(model, dev, depths=range(3, 9))
    states = torch.from_numpy(kreconfig_edge_rows(model, base, seed=5)).to(dev)
    C, A = states.shape[0], model.A
    K = len(model.ACTION_NAMES)
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    before = kernels.launch_counts()
    gk = guard(model, states, C - 7, cov_k)
    gp = guard_plain(model, states, C - 7, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid, rank, ovf, _ = gk
    for r in (kr.KR_REQUESTVOTE, kr.KR_CLIENTREQUEST):
        assert bool((valid & ovf & (rank == r)).any()), r
    # every disjunct, every receipt arm and the AcceptJoin overflow, none
    # exempt: a guard of all rows (the dead tail above holds the forced rows)
    gk = guard(model, states, C, torch.zeros_like(cov_k))
    assert kreconfig_missing_arms(model, *gk[:3]) == []
    sel, _n = compact_indices(valid.reshape(-1), int(valid.sum()) + 300, C * A)
    other = torch.randint(0, C * A, (500,), device=dev, dtype=torch.int32)
    for s in (sel, other, sel[:0]):
        s = s.contiguous()
        fk, fp = apply(model, states, s), apply_plain(model, states, s)
        assert fk.shape == (s.numel(), model.layout.W) and torch.equal(fk, fp)
    flatc = apply(model, states, sel)
    new = (torch.rand(sel.numel(), device=dev) < 0.7) & (sel < C * A)
    jcount = torch.tensor([777], dtype=torch.int64, device=dev)
    invs = tuple(model.invariants)
    vk_, vp_ = (torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
                for _ in range(2))
    ck, cp = cov_k.clone(), cov_k.clone()
    fold(model, flatc, new, jcount, vk_, invs, cov=ck, sel=sel, valid=valid, rank=rank)
    fold_plain(model, flatc, new, jcount, vp_, invs, cov=cp, sel=sel, valid=valid, rank=rank)
    assert torch.equal(vk_, vp_) and torch.equal(ck, cp)
    after = kernels.launch_counts()
    for k in ("guard", "apply", "fold"):
        assert after[f"kreconfig_{k}"] > before[f"kreconfig_{k}"], k
    for k in ("raft_guard", "pull_guard", "kraft_guard", "reconfig_guard", "joint_guard",
              "canon_memo", "canon_tiered"):
        assert after[k] == before[k], k


def test_kreconfig_group_apply_worklists(dev):
    """kreconfig_apply (the group apply: G threads a worklist lane) against
    apply_plain on reachable rows, kreconfig_edge_rows (chains into full and
    near-full bags, logs at max_log, every receipt arm) and
    kreconfig_bag_rows, on a BFS chunk's, a simulate move's, an empty and a
    random worklist, one kreconfig_apply launch a call and no other kernel;
    its occupancy entry names a group of threads a lane."""
    model = _kreconfig_model()
    base = _kraft_states(model, dev, depths=range(3, 9))
    rows = np.concatenate([kreconfig_edge_rows(model, base, seed=11),
                           kreconfig_bag_rows(model, base, seed=12)])
    states = torch.from_numpy(rows).to(dev)
    check_group_apply_worklists(model, states, "kreconfig_apply", seed=3)
    occ = apply_occupancy(model)
    assert occ is not None and occ["G"] > 1 and occ["warps_per_sm"] > 0


def test_kreconfig_predicates_and_sim_check(dev):
    """kreconfig_predicates on edge rows (every invariant and every
    ValuesNotStuck / ReconfigurationNotStuck predicate), and
    kreconfig_sim_check's check and settle, against their plain versions."""
    from raft_tpu_torch.ops.expand import predicates, predicates_plain, sim_check, sim_check_plain

    model = _kreconfig_model()
    base = _kraft_states(model, dev, depths=range(3, 9))
    states = torch.from_numpy(kreconfig_edge_rows(model, base, seed=6)).to(dev)
    names = tuple(model.invariants) + tuple(model.predicates)
    for rows in (states, states[:0], states[:1]):
        rows = rows.contiguous()
        assert torch.equal(predicates(model, rows, names), predicates_plain(model, rows, names))
    R = states.shape[0]
    gen = torch.Generator().manual_seed(2)
    nxt = states[torch.randperm(R, generator=gen).to(dev)].contiguous()
    moved = (torch.rand(R, generator=gen) < 0.8).to(dev)
    nxt[~moved] = 0
    chosen = torch.randint(0, model.A, (R,), generator=gen, dtype=torch.int32).to(dev)
    init_pool = states[:3].contiguous()
    ridx = torch.randint(0, 3, (R,), generator=gen, dtype=torch.int32).to(dev)
    depth = torch.randint(0, 6, (R,), generator=gen, dtype=torch.int32).to(dev)
    journal = torch.randint(0, 99, (R, 7), generator=gen, dtype=torch.int32).to(dev)
    jlen = (depth + 1).contiguous()
    jlen[::11] = 7
    for invs in (KRECONFIG_INV, tuple(model.invariants), ()):
        outs = []
        for fn in (sim_check, sim_check_plain):
            args = [t.clone() for t in (nxt, depth, journal, jlen)]
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            res = fn(model, states, args[0], moved, chosen, ridx, init_pool, args[1], 6,
                     args[2], args[3], invs, stats)
            outs.append(list(res) + args + [stats[2:]])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n_values", [1, 2])
def test_slot_canon(dev, n_values):
    """slot_canon against its plain version on reachable rows, their
    successors, edge rows and kreconfig_bag_rows (full and empty bags,
    unused slots out of order, a word 0 above EMPTY), symmetry on and off,
    seeds 0 and 3, without a valid mask, with a random one and with a BFS
    worklist's (a valid prefix, then an invalid tail), and on no rows; a
    host- and value-permuted copy (a pair's remapped, slot-sorted rows)
    keeps its fingerprint."""
    from raft_tpu_torch.ops.expand import apply

    model = _kreconfig_model(n_values=n_values)
    base = _kraft_states(model, dev, depths=range(3, 8))
    rows = torch.from_numpy(np.concatenate([base, kreconfig_edge_rows(model, base, seed=7),
                                            kreconfig_bag_rows(model, base, seed=8)])).to(dev)
    n = rows.shape[0]
    valid = torch.rand(n, device=dev) < 0.8
    work = torch.arange(n, device=dev) < n - n // 3  # a worklist: valid prefix, invalid tail
    for symmetry in (True, False):
        for seed in (0, 3):
            canon = model.make_canonicalizer(symmetry, seed=seed)
            for v in (None, valid, work):
                fk = canon.fingerprints(rows, v)
                fp = canon.fingerprints(rows.cpu(), None if v is None else v.cpu())
                assert torch.equal(fk.cpu(), fp), (symmetry, seed)
            assert canon.fingerprints(rows[:0]).shape == (0,)
    canon = model.make_canonicalizer(True)
    reach = torch.from_numpy(base).to(dev)
    fps = canon.fingerprints(reach)
    for k in range(canon.P):
        perm = canon.canon_rows(reach.cpu(), k).to(dev)
        assert torch.equal(canon.fingerprints(perm), fps), k


def test_kreconfig_bfs_simulate_liveness_card_equal_cpu(dev):
    """KRaftWithReconfig at the SMALLP constants by BFS to depth 5 (counts,
    depth counts, coverage; symmetry on and off) and by simulation (walks,
    final states, journals), and the 428-state liveness universe (states,
    edges, verdict): the card equals the CPU, through the family's kernels
    and slot_canon."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.liveness import LivenessChecker
    from raft_tpu_torch.checker.simulate import Simulator

    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 15, max_seen_cap=1 << 20)
    kernels.reset_counts()
    for symmetry in (True, False):
        rs = [DeviceBFS(_kreconfig_model(), invariants=KRECONFIG_INV, symmetry=symmetry,
                        device=d, **caps).run(max_depth=5) for d in (dev, "cpu")]
        assert (rs[0].distinct, rs[0].total, rs[0].depth_counts, rs[0].coverage,
                rs[0].violation) == (rs[1].distinct, rs[1].total, rs[1].depth_counts,
                                     rs[1].coverage, rs[1].violation)
    sims = [Simulator(_kreconfig_model(msg_slots=40), invariants=KRECONFIG_INV, walks=32,
                      max_behavior_depth=20, seed=4, device=d) for d in (dev, "cpu")]
    ss = [s.run(max_steps=32 * 20) for s in sims]
    assert (ss[0].behaviors, ss[0].steps, ss[0].violation) == (
        ss[1].behaviors, ss[1].steps, ss[1].violation)
    for a in ("states", "depth", "journal", "jlen"):
        assert torch.equal(getattr(sims[0], a).cpu(), getattr(sims[1], a))
    from raft_tpu_torch.models.kraft_reconfig import KRaftReconfigModel, KRaftReconfigParams

    props = ("ValuesNotStuck", "ReconfigurationNotStuck")
    lv = [LivenessChecker(KRaftReconfigModel(KRaftReconfigParams(**KRECONFIG_LIVE_P)), props,
                          chunk=256, device=d) for d in (dev, "cpu")]
    lr = [c.run() for c in lv]
    assert (lr[0].distinct, lr[0].total_edges, lr[0].violation) == (
        lr[1].distinct, lr[1].total_edges, lr[1].violation)
    assert lr[0].violation is None and lr[0].distinct == 428
    for a in ("_esrc", "_edst", "_ecand"):
        assert np.array_equal(getattr(lv[0], a), getattr(lv[1], a))
    counts = kernels.launch_counts()
    for k in ("guard", "apply", "fold", "predicates", "sim_check"):
        assert counts[f"kreconfig_{k}"] > 0, k
    assert counts["slot_canon"] > 0 and counts["canon_memo"] == counts["canon_tiered"] == 0


# ---------------- network-fault actions and fleet lanes ----------------

NF_VARIANTS = {
    "core": dataclasses.replace(VARIANTS["core"], net_faults=True),
    "fsync": dataclasses.replace(VARIANTS["fsync"], net_faults=True),
}


def _guard_apply_equal(model, states, dev):
    """raft_guard/pull_guard (with coverage) and the apply on every valid
    lane, on lanes of disabled candidates and on drop lanes, against their
    plain versions; returns the guard's (valid, rank)."""
    C, A = states.shape[0], model.A
    K = len(model.ACTION_NAMES)
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    gk = guard(model, states, C, cov_k)
    gp = guard_plain(model, states, C, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid = gk[0]
    sel, _ = compact_indices(valid.reshape(-1), int(valid.sum()) + 300, C * A)
    other = torch.randint(0, C * A, (500,), device=dev, dtype=torch.int32)
    for s in (sel, other):
        s = s.contiguous()
        assert torch.equal(apply(model, states, s), apply_plain(model, states, s))
    return gk[0], gk[1]


@pytest.mark.parametrize("name", list(NF_VARIANTS))
def test_raft_guard_apply_net_faults(dev, name):
    """DuplicateMessage and DropMessage on the card: count-1 records (both
    enabled), count-2 records (the duplicate refused), count-0 records (both
    refused, the record kept) and counts out of range, against the plain
    version; both fault ranks fire."""
    model = RaftModel(NF_VARIANTS[name])
    base = _edge_states(model, dev, seed=2).cpu().numpy()
    states = torch.from_numpy(net_fault_rows(model, base, seed=4)).to(dev)
    valid, rank = _guard_apply_equal(model, states, dev)
    for r in (model._r_dup, model._r_drop):
        assert bool((valid & (rank == r)).any()), model.ACTION_NAMES[r]


@pytest.mark.parametrize("family", ["raft", "pull"])
def test_guard_apply_fleet_lanes(dev, family):
    """A packed model's guards read MaxElections and MaxRestarts from the
    c_<name> lanes: rows whose lanes differ from the static maximum give
    the plain version's grid and successors (and, for Raft, its
    ValueAllOrNothing predicate)."""
    from raft_tpu_torch.ops.expand import predicates, predicates_plain

    if family == "raft":
        p = dataclasses.replace(VARIANTS["core"], fleet=True,
                                dyn_consts=("max_elections", "max_restarts"))
        model = RaftModel(p)
    else:
        p = dataclasses.replace(PULL_VARIANTS["pull"], max_restarts=1, fleet=True,
                                dyn_consts=("max_elections", "max_restarts"))
        model = PullRaftModel(p)
    model.fleet_bind([[1, 0], [p.max_elections, p.max_restarts]])
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    bfs = DeviceBFS(model, chunk=256, frontier_cap=4096, max_seen_cap=1 << 20,
                    canon_memo_cap=1 << 12, device=dev)
    bfs.run(max_depth=5)
    states = torch.from_numpy(fleet_rows(model, bfs.frontier_rows.cpu().numpy()[:600],
                                         seed=6)).to(dev)
    _guard_apply_equal(model, states, dev)
    if family == "raft":
        names = tuple(model.predicates)
        assert torch.equal(predicates(model, states, names),
                           predicates_plain(model, states, names))


def test_net_faults_and_fleet_runs_card_equal_cpu(dev):
    """Raft with --net-faults by BFS (counts, depth counts, coverage) and
    by simulation (walks, final states, journals), and a packed sweep of
    two jobs whose lanes differ: the card equals the CPU, through the Raft
    kernels."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.checker.device_bfs import DeviceBFS
    from raft_tpu_torch.checker.simulate import Simulator
    from raft_tpu_torch.fleet import SweepOptions, parse_manifest_obj, run_sweep

    p = RaftParams(n_servers=2, n_values=1, max_elections=1, max_restarts=0, msg_slots=12,
                   net_faults=True)
    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 15, max_seen_cap=1 << 20,
                canon_memo_cap=1 << 12)
    kernels.reset_counts()
    rs = [DeviceBFS(RaftModel(p), invariants=INV, device=d, **caps).run(max_depth=10)
          for d in (dev, "cpu")]
    assert (rs[0].distinct, rs[0].total, rs[0].depth_counts, rs[0].coverage) == (
        rs[1].distinct, rs[1].total, rs[1].depth_counts, rs[1].coverage)
    sims = [Simulator(RaftModel(p), invariants=INV, walks=64, max_behavior_depth=30, seed=1,
                      device=d) for d in (dev, "cpu")]
    ss = [s.run(max_steps=64 * 40) for s in sims]
    assert (ss[0].behaviors, ss[0].steps) == (ss[1].behaviors, ss[1].steps)
    for a in ("states", "depth", "journal", "jlen"):
        assert torch.equal(getattr(sims[0], a).cpu(), getattr(sims[1], a))
    counts = kernels.launch_counts()
    for k in ("raft_guard", "raft_apply", "raft_fold", "raft_sim_check"):
        assert counts[k] > 0, k
    mf = parse_manifest_obj({
        "spec": "Raft",
        "defaults": {"constants": {"Server": ["s1", "s2", "s3"], "Value": ["v1"],
                                   "MaxElections": 1, "MaxRestarts": 0},
                     "invariants": list(INV), "msg_slots": 24},
        "jobs": [{"name": "a"}, {"name": "b", "constants": {"MaxElections": 2,
                                                            "MaxRestarts": 1}}]})
    res = [run_sweep(mf, SweepOptions(device=d, max_depth=8, chunk=256)).to_json()["jobs"]
           for d in ("cuda", "cpu")]
    for a, b in zip(*res):
        a.pop("seconds"), b.pop("seconds")
    assert res[0] == res[1] and res[0][0]["distinct"] != res[0][1]["distinct"]
