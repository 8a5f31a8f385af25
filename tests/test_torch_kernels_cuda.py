"""The four CUDA kernels against their plain PyTorch versions on the card,
at small shapes (exact equality: integers). Needs a CUDA card and nvcc;
skips elsewhere. Run on the card with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which these tests do not
need and a machine with only the port's dependencies lacks.)
"""

import pytest
import torch

from raft_tpu_torch.checker.lsm import merge_runs, merge_runs_plain
from raft_tpu_torch.checker.util import (
    append_rows, append_rows_plain, compact_indices, dense_prefix_sel, probe_runs,
    probe_runs_plain,
)
from raft_tpu_torch.models.raft import RaftModel, RaftParams
from raft_tpu_torch.ops.hashing import INT64_MAX

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


def test_canon_memo(dev):
    model = RaftModel(RaftParams(n_servers=3, n_values=1, max_elections=2,
                                 max_restarts=0, msg_slots=16))
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


def test_wave_loop_has_no_host_sync(dev):
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    model = RaftModel(RaftParams(n_servers=3, n_values=1, max_elections=2,
                                 max_restarts=0, msg_slots=16))
    bfs = DeviceBFS(model, invariants=("LeaderHasAllAckedValues", "NoLogDivergence"),
                    chunk=256, frontier_cap=4096, max_seen_cap=1 << 20,
                    canon_memo_cap=1 << 12, device=dev)
    res = bfs.run(max_depth=9)
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
