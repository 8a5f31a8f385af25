"""The port's sharded engine (``parallel/sharded.py``: D gloo CPU
processes, spawned by ``parallel/launch.py``) against the reference's
``ShardedBFS`` at the same D on the conftest's virtual CPU mesh: distinct,
total, terminal, depth counts, coverage and the per-wave all-to-all lanes
on two-server Raft at D = 1, 2 and 4 (the sub-stepping cursor, growth and
the redos are held in test_torch_sharded_growth.py). The reference
runs its dense path (``DenseShim``) without its canon memo, the two
settings under which it runs on jax 0.9.0; the port keeps its memo, which
preserves values."""

import dataclasses
import functools

import jax
import pytest
import torch

from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.parallel.sharded import ShardedBFS as JaxShardedBFS
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.raft import RaftModel
from raft_tpu_torch.parallel.launch import run_sharded

from test_expand_sparse import DenseShim

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

PARAMS = RaftParams(n_servers=2, n_values=1, max_elections=1, max_restarts=0, msg_slots=16)
INV = ("LeaderHasAllAckedValues", "NoLogDivergence")
CAPS = dict(chunk=256, frontier_cap=1024, seen_cap=1 << 12)


@functools.lru_cache(maxsize=None)
def reference(D: int):
    engine = JaxShardedBFS(DenseShim(cached_model(PARAMS)), invariants=INV,
                           devices=jax.devices()[:D], canon_memo_cap=0, **CAPS)
    return engine.run(collect_metrics=True)


def build():
    return functools.partial(RaftModel, params_from_reference(dataclasses.asdict(PARAMS)))


def counts(res):
    return (res.distinct, res.total, res.terminal, res.depth, res.depth_counts,
            res.violation_invariant, res.exhausted)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_matches_reference_sharded(D):
    ref = reference(D)
    engine, res = run_sharded(build(), D, device="cpu", engine_kw=dict(invariants=INV, **CAPS),
                              run_kw=dict(collect_metrics=True))
    assert engine.D == D
    assert counts(res) == counts(ref)
    assert res.coverage == ref.coverage
    assert [m["a2a_lanes"] for m in res.metrics] == [m["a2a_lanes"] for m in ref.metrics]
    assert [m["a2a_bytes"] for m in res.metrics] == [m["a2a_bytes"] for m in ref.metrics]
    assert sum(m["a2a_lanes"] for m in res.metrics) > 0
    assert len(res.stats["shard_distinct"]) == D and sum(res.stats["shard_distinct"]) == ref.distinct
    assert res.stats["frontier_hist"] == ref.depth_counts
    assert res.stats["actions_fired"] == sum(1 for row in ref.coverage if row[1])
    # the reference's growth policy for a rebuilt engine (the supervisor's)
    assert engine.grow_for_overflow(1) is None
    assert engine.grow_for_overflow(4 | 8) == {
        "route_cap": 2 * engine.RC, "frontier_cap": 2 * engine.FCAP,
        "max_frontier_cap": max(engine.MAX_FCAP, 4 * engine.FCAP)}
