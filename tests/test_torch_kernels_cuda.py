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
    append_rows, append_rows_plain, chunk_sort, chunk_sort_plain, compact_indices,
    dense_prefix_sel, probe_runs, probe_runs_plain,
)
from raft_tpu_torch.models.raft import R_ACCEPT_AE, R_CLIENTREQUEST, RaftModel, RaftParams
from raft_tpu_torch.ops.expand import (
    raft_apply, raft_apply_plain, raft_fold, raft_fold_plain, raft_guard, raft_guard_plain,
)
from raft_tpu_torch.ops.hashing import INT64_MAX
from raft_tpu_torch.ops.packing import EMPTY
from raft_tpu_torch.ops.symmetry import permute_states

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


def test_probe_runs(dev):
    gen = torch.Generator().manual_seed(0)
    runs = [_sorted(dev, 700, 1024, gen), _sorted(dev, 30, 64, gen)]
    q = torch.randint(-(1 << 62), 1 << 62, (2000,), generator=gen).to(dev)
    q[:500] = runs[0][:500]
    q[500:520] = runs[1][:20]
    q[-3:] = INT64_MAX
    assert torch.equal(probe_runs(q, runs), probe_runs_plain(q, runs))
    assert torch.equal(probe_runs(q, []), q != INT64_MAX)


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


@pytest.mark.parametrize("n,run_len", [(0, 0), (0, 16), (1, 1), (2047, 2048), (2048, 2048),
                                       (5000, 8192), (65536, 65536), (70000, 131072)])
def test_chunk_sort(dev, n, run_len):
    # many duplicates (a pool of n / 4 values over the whole int64 range)
    # and INT64_MAX lanes; fresh is false on the sentinels
    gen = torch.Generator().manual_seed(n)
    pool = torch.randint(-(1 << 63), (1 << 63) - 1, (max(1, n // 4),), generator=gen)
    fps = pool[torch.randint(0, len(pool), (n,), generator=gen)]
    fps[torch.rand(n, generator=gen) < 0.1] = INT64_MAX
    fresh = (torch.rand(n, generator=gen) < 0.7) & (fps != INT64_MAX)
    fps, fresh = fps.to(dev), fresh.to(dev)
    nk, rk = chunk_sort(fps, fresh, run_len)
    np_, rp = chunk_sort_plain(fps, fresh, run_len)
    assert torch.equal(nk, np_) and torch.equal(rk, rp)


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
    gk = raft_guard(model, states, n_live, cov_k)
    gp = raft_guard_plain(model, states, n_live, cov_p)
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
        fk, fp = raft_apply(model, states, s), raft_apply_plain(model, states, s)
        assert fk.shape == (s.numel(), model.layout.W) and torch.equal(fk, fp)
    flatc = raft_apply(model, states, sel)
    new = (torch.rand(sel.numel(), device=dev) < 0.7) & (sel < C * A)
    jcount = torch.tensor([777], dtype=torch.int64, device=dev)
    invs = tuple(model.invariants)
    for s, nw in ((sel, new), (sel[:0], new[:0])):
        vk = torch.full((len(invs),), 2**31 - 1, dtype=torch.int64, device=dev)
        vp, ck, cp = vk.clone(), cov_k.clone(), cov_k.clone()
        fc = flatc[: s.numel()].contiguous()
        raft_fold(model, fc, nw, jcount, vk, invs, cov=ck, sel=s, valid=valid, rank=rank)
        raft_fold_plain(model, fc, nw, jcount, vp, invs, cov=cp, sel=s, valid=valid,
                        rank=rank)
        assert torch.equal(vk, vp) and torch.equal(ck, cp)


def test_raft_guard_apply_wide_rows(dev):
    """A bag of 320 slots (rows over 1,000 lanes): the guard's RequestVote
    scratch and the apply's rows per block are sized from the model, so
    neither refuses it, and both still equal their plain versions."""
    model = RaftModel(dataclasses.replace(VARIANTS["core"], msg_slots=320))
    init = np.repeat(model.init_states(), 64, axis=0)
    states = torch.from_numpy(edge_rows(model, init, seed=11)).to(dev)
    C, A = states.shape[0], model.A
    assert model.layout.W > 1000
    K = len(model.ACTION_NAMES)
    cov_k = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    cov_p = cov_k.clone()
    gk = raft_guard(model, states, C, cov_k)
    gp = raft_guard_plain(model, states, C, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid = gk[0]
    assert bool(valid.any())
    sel, _ = compact_indices(valid.reshape(-1), int(valid.sum()) + 5, C * A)
    assert torch.equal(raft_apply(model, states, sel), raft_apply_plain(model, states, sel))


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
    raft_fold(model, states, new, jcount, vk, invs)
    raft_fold_plain(model, states, new, jcount, vp, invs)
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
    before = kernels.RAFT_APPLY.launches
    rg = DeviceBFS(RaftModel(p), invariants=INV, device=dev, **caps).run()
    rc = DeviceBFS(RaftModel(p), invariants=INV, device="cpu", **caps).run()
    assert rg.violation is not None and rg.violation == rc.violation
    assert rg.trace == rc.trace and len(rg.trace) == rg.violation.depth + 1
    assert (rg.distinct, rg.total, rg.depth_counts) == (rc.distinct, rc.total, rc.depth_counts)
    assert kernels.RAFT_APPLY.launches > before
