"""Pin the depth counts of the two reconfiguration specs' four-server
configurations from the JAX reference's dense DeviceBFS (the parity
anchor of the PyTorch port's reconfiguration runs).

    JAX_PLATFORMS=cpu python scripts/pin_reconfig_counts.py
        [--joint] [--budget S] [--chunk C] [--max-depth D]

RaftWithReconfigAddRemove (SURVEY.md:92): Server = {n1, n2, n3, n4},
InitClusterSize 3, MinClusterSize 2, MaxAddReconfigs 1,
MaxRemoveReconfigs 1, IncludeThesisBug FALSE, MaxClusterSize repaired to
|Server| = 4, and the stand-ins Value = {v1}, MaxElections 1,
MaxRestarts 0, MaxValuesPerTerm 1. RaftWithReconfigJointConsensus
(``--joint``, SURVEY.md:91): Server = {n1, n2, n3, n4}, InitClusterSize
3, MaxElections 1, MaxReconfigs 2, MaxValuesPerTerm 1, ReconfigType 2,
and the stand-ins Value = {v1}, MaxRestarts 0. Both with VIEW + SYMMETRY,
the invariants LeaderHasAllAckedValues, NoLogDivergence and
MaxOneReconfigurationAtATime, and 112 message slots (the registry's
default). The dense path (the sparse guard pass hidden by a model proxy,
as tests/test_expand_sparse.py's DenseShim does) runs wave by wave to
exhaustion or until ``--budget`` seconds have passed; every completed
wave is printed and the last line is a JSON object with the per-depth
counts, the distinct/total/terminal counts and the coverage at the last
completed depth.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

jax.config.update("jax_platforms", "cpu")

from raft_tpu.checker.device_bfs import DeviceBFS  # noqa: E402
from raft_tpu.models import joint_raft, reconfig_raft  # noqa: E402

ADD_REMOVE = dict(n_servers=4, n_values=1, init_cluster_size=3, max_elections=1,
                  max_restarts=0, max_values_per_term=1, max_add_reconfigs=1,
                  max_remove_reconfigs=1, min_cluster_size=2, max_cluster_size=4,
                  include_thesis_bug=False, msg_slots=112)
JOINT = dict(n_servers=4, n_values=1, init_cluster_size=3, max_elections=1, max_restarts=0,
             max_reconfigs=2, max_values_per_term=1, reconfig_type=2, msg_slots=112)
INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "MaxOneReconfigurationAtATime")


class Dense:
    """Model proxy without the sparse-apply contract (the dense path)."""

    def __init__(self, inner):
        self.__dict__["_inner"] = inner

    def __getattr__(self, name):
        if name in ("sparse_apply", "host_apply"):
            raise AttributeError(name)
        return getattr(self.__dict__["_inner"], name)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--joint", action="store_true")
    ap.add_argument("--budget", type=float, default=3600.0)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--max-depth", type=int, default=None)
    args = ap.parse_args()
    if args.joint:
        params = JOINT
        model = joint_raft.cached_model(joint_raft.JointRaftParams(**params))
    else:
        params = ADD_REMOVE
        model = reconfig_raft.cached_model(reconfig_raft.ReconfigRaftParams(**params))
    bfs = DeviceBFS(Dense(model), invariants=INV, symmetry=True, chunk=args.chunk,
                    valid_per_state=32, frontier_cap=1 << 17, max_frontier_cap=1 << 20,
                    journal_cap=1 << 21)
    t0 = time.perf_counter()
    res = bfs.run(max_depth=args.max_depth, time_budget_s=args.budget, verbose=True)
    out = dict(spec=model.name, params=params, invariants=INV, chunk=args.chunk,
               depth=res.depth, distinct=res.distinct, total=res.total,
               terminal=res.terminal, depth_counts=res.depth_counts,
               coverage=res.coverage, exhausted=res.exhausted,
               violation=None if res.violation is None else res.violation.invariant,
               seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
