"""Pin the depth counts and coverage of the full-width KRaftWithReconfig
configuration from the JAX reference (the parity anchor of the PyTorch
port's BFS of it, chip_smoke.py phase 4g).

    JAX_PLATFORMS=cpu python scripts/pin_kraft_reconfig_counts.py [--budget S]
        [--chunk C] [--max-depth D]

The configuration is chip_smoke.py's KRAFT_RECONFIG_CFG: the reference cfg's
constants as SURVEY.md:96 records them (Hosts {n1, n2, n3}, InitClusterSize
3, MinClusterSize 2, MaxClusterSize 4, MaxSpawnedServers 5, MaxRestarts 1,
MaxValuesPerEpoch 1, MaxAddReconfigs 1, MaxRemoveReconfigs 1, Value {v1, v2}
with v2 declared as the lenient parse does) with MaxElections 2 standing in
for the value the repo does not record, VIEW + SYMMETRY symmHostsAndValues,
the cfg's five invariants and 40 message slots (the registry's default):
KRaftReconfigParams(n_hosts=3, n_values=2, init_cluster_size=3,
min_cluster_size=2, max_cluster_size=4, max_elections=2, max_restarts=1,
max_values_per_epoch=1, max_add_reconfigs=1, max_remove_reconfigs=1,
max_spawned_servers=5, msg_slots=40).

It runs the reference's dense DeviceBFS (the sparse guard pass hidden by a
model proxy, as scripts/pin_pull_counts.py's Dense does) through the slot
canonicalizer: XLA compiles this model's dense expand on the CPU in seconds
(tests/test_kraft_reconfig.py's own device tests use the same engine), and
the reference oracle's interpreter (oracle/kraft_reconfig_oracle.py bfs)
agrees with it at the smaller constants (tests/test_torch_kraft_reconfig_bfs.py)
but expands a few thousand states a second, two orders of magnitude fewer.
The run goes wave by wave until ``--budget`` seconds have passed (the state
space does not exhaust on the CPU); every completed wave is printed and the
last line is a JSON object with the per-depth counts, the distinct, total
and terminal counts and the coverage at the last completed depth.
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
from raft_tpu.models.kraft_reconfig import KRaftReconfigParams, cached_model  # noqa: E402

PARAMS = dict(n_hosts=3, n_values=2, init_cluster_size=3, min_cluster_size=2,
              max_cluster_size=4, max_elections=2, max_restarts=1, max_values_per_epoch=1,
              max_add_reconfigs=1, max_remove_reconfigs=1, max_spawned_servers=5, msg_slots=40)
INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "NeverTwoLeadersInSameEpoch",
       "NoIllegalState", "StatesMatchRoles")


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
    ap.add_argument("--budget", type=float, default=600.0)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--max-depth", type=int, default=None)
    args = ap.parse_args()
    model = cached_model(KRaftReconfigParams(**PARAMS))
    bfs = DeviceBFS(Dense(model), invariants=INV, symmetry=True, chunk=args.chunk,
                    valid_per_state=32, frontier_cap=1 << 20, journal_cap=1 << 22)
    t0 = time.perf_counter()
    res = bfs.run(max_depth=args.max_depth, time_budget_s=args.budget, verbose=True)
    out = dict(spec=model.name, params=PARAMS, invariants=INV, chunk=args.chunk,
               depth=res.depth, distinct=res.distinct, total=res.total,
               terminal=res.terminal, depth_counts=res.depth_counts,
               coverage=res.coverage, exhausted=res.exhausted,
               violation=None if res.violation is None else res.violation.invariant,
               seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
