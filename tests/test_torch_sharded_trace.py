"""The port's sharded engine against the reference's ``ShardedBFS`` at
D = 2 (gloo CPU processes; the reference on the conftest's virtual CPU
mesh, dense path, no canon memo): a counterexample's depth, invariant and
trace (the journal order that picks it is the stable owner route, the
received block order and the fingerprint-ordered emit), and a family
beyond Raft, the pull family, to depth 8 (counts, depth counts, coverage,
per-wave all-to-all lanes)."""

import dataclasses
import functools

import jax
import torch

from raft_tpu.models.pull_raft import cached_model as pull_model
from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.parallel.sharded import ShardedBFS as JaxShardedBFS
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.pull_raft import PullRaftModel
from raft_tpu_torch.models.raft import RaftModel
from raft_tpu_torch.parallel.launch import run_sharded

from test_expand_sparse import DenseShim
from test_torch_pull_raft import INV as PULL_INV, PARAMS as PULL_PARAMS

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

INV = ("LeaderHasAllAckedValues", "NoLogDivergence")


def test_violation_trace_matches_reference_sharded():
    # FlexibleRaft-style quorums of one: an acked value is lost at depth 6
    params = RaftParams(n_servers=2, n_values=1, max_elections=2, max_restarts=0,
                        msg_slots=16, election_quorum=1, replication_quorum=1)
    caps = dict(chunk=256, frontier_cap=256, seen_cap=1024, journal_cap=1024)
    ref = JaxShardedBFS(DenseShim(cached_model(params)), invariants=INV,
                        devices=jax.devices()[:2], canon_memo_cap=0, **caps).run()
    pp = params_from_reference(dataclasses.asdict(params))
    _, res = run_sharded(functools.partial(RaftModel, pp), 2, device="cpu",
                         engine_kw=dict(invariants=INV, **caps))
    assert ref.violation_invariant == "LeaderHasAllAckedValues" and ref.depth == 6
    assert (res.violation_invariant, res.depth, res.distinct, res.total) == (
        ref.violation_invariant, ref.depth, ref.distinct, ref.total)
    assert res.exit_cause == "violation" and not res.exhausted
    assert len(res.trace) == 7 and res.trace[0][0] == "Initial predicate"
    assert res.trace == ref.trace  # labels and decoded states


def test_pull_family_matches_reference_sharded():
    jp = dataclasses.replace(PULL_PARAMS["pull"], max_elections=1)
    caps = dict(chunk=256, frontier_cap=1024, seen_cap=1 << 13, journal_cap=1 << 13)
    ref = JaxShardedBFS(DenseShim(pull_model(jp)), invariants=PULL_INV,
                        devices=jax.devices()[:2], canon_memo_cap=0, **caps).run(
        max_depth=8, collect_metrics=True)
    pp = params_from_reference(dataclasses.asdict(jp))
    _, res = run_sharded(functools.partial(PullRaftModel, pp), 2, device="cpu",
                         engine_kw=dict(invariants=PULL_INV, **caps),
                         run_kw=dict(max_depth=8, collect_metrics=True))
    assert ref.violation_invariant is None and res.violation_invariant is None
    assert (res.distinct, res.total, res.terminal, res.depth) == (
        ref.distinct, ref.total, ref.terminal, ref.depth)
    assert res.depth == 8 and res.distinct > 30 and res.exit_cause == "max_depth"
    assert res.depth_counts == ref.depth_counts and res.coverage == ref.coverage
    assert [m["a2a_lanes"] for m in res.metrics] == [m["a2a_lanes"] for m in ref.metrics]
