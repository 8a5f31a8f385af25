"""The port's DeviceBFS (raft_tpu_torch/checker/device_bfs.py, plain
kernels on the CPU) against the JAX reference's dense DeviceBFS and the
pure-Python oracle: counts, coverage, violation gid and trace."""

import jax.numpy as jnp
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.oracle.raft_oracle import RaftOracle
from raft_tpu_torch.checker.device_bfs import CapacityOverflow, DeviceBFS
from raft_tpu_torch.models.raft import RaftModel, RaftParams as TorchRaftParams

from test_expand_sparse import DenseShim

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

INV = ("LeaderHasAllAckedValues", "NoLogDivergence")
SMALL = dict(frontier_cap=1 << 13, journal_cap=1 << 14, max_seen_cap=1 << 20,
             canon_memo_cap=1 << 12, device="cpu")


def _torch_run(kw, invariants=INV, depth=None, chunk=256, **caps):
    m = RaftModel(TorchRaftParams(**kw))
    return DeviceBFS(m, invariants=invariants, chunk=chunk, **{**SMALL, **caps}).run(
        max_depth=depth)


def test_counts_match_reference_and_oracle():
    # tests/test_checker.py:40's parameters
    kw = dict(n_servers=2, n_values=2, max_elections=2, max_restarts=1, msg_slots=24)
    res = _torch_run(kw, depth=8)
    ref = JaxDeviceBFS(DenseShim(cached_model(RaftParams(**kw))), invariants=INV,
                       chunk=256, frontier_cap=1 << 13, journal_cap=1 << 14).run(max_depth=8)
    ores = RaftOracle(2, 2, 2, 1).bfs(invariants=INV, symmetry=True, max_depth=8)
    assert res.violation is None and ref.violation is None and ores["violation"] is None
    assert (res.distinct, res.total, res.depth, res.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert res.depth_counts == ref.depth_counts == ores["depth_counts"]
    assert res.distinct == ores["distinct"] and res.total == ores["total"]
    assert res.coverage == ref.coverage


def test_raft_cfg_depth8_with_growth():
    # Raft.cfg constants; a frontier_cap of one chunk forces growth
    kw = dict(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=48)
    res = _torch_run(kw, depth=8, frontier_cap=256)
    assert (res.distinct, res.total, res.depth) == (446, 953, 8)
    ores = RaftOracle(3, 1, 2, 0).bfs(invariants=INV, symmetry=True, max_depth=8)
    assert res.depth_counts == ores["depth_counts"]
    assert not res.exhausted and res.exit_cause == "max_depth"


def test_injected_violation_matches_reference():
    kw = dict(n_servers=3, n_values=1, max_elections=1, max_restarts=0, msg_slots=16)
    jm = cached_model(RaftParams(**kw))
    jm.invariants["NoCommit"] = lambda s: jnp.all(jm.layout.get(s, "commitIndex") == 0, axis=1)
    try:
        ref = JaxDeviceBFS(DenseShim(jm), invariants=("NoCommit",), chunk=256,
                           frontier_cap=1 << 13, journal_cap=1 << 14).run()
    finally:
        del jm.invariants["NoCommit"]
    tm = RaftModel(TorchRaftParams(**kw))
    tm.invariants["NoCommit"] = lambda s: (tm.layout.get(s, "commitIndex") == 0).all(dim=1)
    res = DeviceBFS(tm, invariants=("NoCommit",), **SMALL).run()
    v, rv = res.violation, ref.violation
    assert v is not None and rv is not None
    assert (v.invariant, v.global_id, v.depth) == (rv.invariant, rv.global_id, rv.depth)
    assert res.trace == ref.trace
    assert res.violation.depth == len(res.trace) - 1
    assert any(ci > 0 for ci in res.trace[-1][1]["commitIndex"])
    assert res.distinct == ref.distinct and res.total == ref.total


def test_frontier_overflow_raises():
    kw = dict(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=48)
    with pytest.raises(CapacityOverflow) as e:
        _torch_run(kw, depth=8, chunk=64, frontier_cap=64, max_frontier_cap=64)
    assert e.value.bits & 4 and "frontier" in e.value.what


def test_worklist_overflow_redoes_the_wave():
    # 2 worklist lanes per state overflow at the first wave; each such wave
    # is redone with the lanes doubled (the reference's grow_for_overflow),
    # and the run ends exactly as one that never overflowed
    kw = dict(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=48)
    runs = []
    for vps in (2, 16):
        bfs = DeviceBFS(RaftModel(TorchRaftParams(**kw)), invariants=INV, chunk=64,
                        **{**SMALL, "valid_per_state": vps})
        runs.append((bfs, bfs.run(max_depth=8)))
    (grown, res), (plain, ref) = runs
    assert grown.redone_chunks > 0 and grown.VC > 2 * grown.chunk
    assert plain.redone_chunks == 0 and plain.VC == 16 * plain.chunk
    assert (res.distinct, res.total, res.depth, res.terminal) == (446, 953, 8, ref.terminal)
    assert res.depth_counts == ref.depth_counts and res.coverage == ref.coverage
    assert torch.equal(grown.frontier_rows, plain.frontier_rows)


def test_cpu_run_leaves_kernel_counts_alone():
    from raft_tpu_torch import kernels

    before = kernels.launch_counts()
    _torch_run(dict(n_servers=2, n_values=1, max_elections=1, max_restarts=0,
                    msg_slots=8), depth=3)
    assert kernels.launch_counts() == before
    assert torch.get_default_device().type == "cpu"


# five servers (BASELINE.json's second configuration, scripts/bench_rows.py
# row 2) with a bag of 24 slots: through depth 6 at most 6 actions put at
# most S - 1 = 4 records each, so no bag overflows
FIVE = dict(n_servers=5, n_values=5, max_elections=4, max_restarts=0, msg_slots=24)


def test_five_servers_match_reference():
    res = _torch_run(FIVE, depth=6, chunk=512)
    ref = JaxDeviceBFS(DenseShim(cached_model(RaftParams(**FIVE))), invariants=INV,
                       chunk=512, frontier_cap=1 << 13, journal_cap=1 << 14).run(max_depth=6)
    assert res.violation is None and ref.violation is None
    assert (res.distinct, res.total, res.depth, res.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert res.depth_counts == ref.depth_counts
    assert res.coverage == ref.coverage


@pytest.mark.slow
def test_five_servers_pinned_depth_counts():
    # the full-width configuration to the depth chip_smoke.py holds the
    # card to; the counts come from the reference's dense DeviceBFS
    # (scripts/pin_raft5_counts.py)
    from chip_smoke import RAFT5_PIN

    kw = dict(FIVE, msg_slots=64)
    res = _torch_run(kw, depth=len(RAFT5_PIN["depth_counts"]) - 1, chunk=2048,
                     frontier_cap=1 << 20, journal_cap=1 << 21, max_seen_cap=1 << 22,
                     canon_memo_cap=1 << 20)
    assert res.depth_counts == RAFT5_PIN["depth_counts"]
    assert (res.distinct, res.total) == (RAFT5_PIN["distinct"], RAFT5_PIN["total"])
    assert res.coverage == RAFT5_PIN["coverage"]
