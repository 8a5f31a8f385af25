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
from raft_tpu_torch.models.kraft import KRaftModel, KRaftParams
from raft_tpu_torch.models.raft import R_ACCEPT_AE, R_CLIENTREQUEST, RaftModel, RaftParams
from raft_tpu_torch.models.pull_raft import (
    R_BECOMELEADER as R_PULL_BECOMELEADER, R_CLIENTREQUEST as R_PULL_CLIENTREQUEST,
    R_REQUESTVOTE as R_PULL_REQUESTVOTE, PullRaftModel, PullRaftParams,
)
from raft_tpu_torch.ops.expand import (
    apply, apply_plain, fold, fold_plain, guard, guard_plain,
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
    gk = guard(model, states, C, cov_k)
    gp = guard_plain(model, states, C, cov_p)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)
    assert torch.equal(cov_k, cov_p)
    valid = gk[0]
    assert bool(valid.any())
    sel, _ = compact_indices(valid.reshape(-1), int(valid.sum()) + 5, C * A)
    assert torch.equal(apply(model, states, sel), apply_plain(model, states, sel))


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
    before = kernels.RAFT_APPLY.launches
    rg = DeviceBFS(RaftModel(p), invariants=INV, device=dev, **caps).run()
    rc = DeviceBFS(RaftModel(p), invariants=INV, device="cpu", **caps).run()
    assert rg.violation is not None and rg.violation == rc.violation
    assert rg.trace == rc.trace and len(rg.trace) == rg.violation.depth + 1
    assert (rg.distinct, rg.total, rg.depth_counts) == (rc.distinct, rc.total, rc.depth_counts)
    assert kernels.RAFT_APPLY.launches > before


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
