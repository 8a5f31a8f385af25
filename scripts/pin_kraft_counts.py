"""Pin the depth counts of KRaft.cfg's constants from the JAX reference's
dense DeviceBFS (the parity anchor of the PyTorch port's KRaft runs).

    JAX_PLATFORMS=cpu python scripts/pin_kraft_counts.py [--budget S]
        [--chunk C] [--max-depth D]

KRaft.cfg (SURVEY.md:95; the invariant order of tests/test_kraft.py's
cfg check): 3 servers, Value = {v1}, MaxElections 2, MaxRestarts 0, VIEW
+ SYMMETRY and the invariants LeaderHasAllAckedValues, NoLogDivergence,
NeverTwoLeadersInSameEpoch and NoIllegalState: KRaftParams(n_servers=3,
n_values=1, max_elections=2, max_restarts=0, msg_slots=80) (the
registry's default slots). The dense path (the sparse guard pass hidden
by a model proxy, as tests/test_expand_sparse.py's DenseShim does) runs
wave by wave to exhaustion or until ``--budget`` seconds have passed;
every completed wave is printed and the last line is a JSON object with
the per-depth counts, the distinct/total/terminal counts and the coverage
at the last completed depth.
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
from raft_tpu.models.kraft import KRaftParams, cached_model  # noqa: E402

PARAMS = dict(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=80)
INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "NeverTwoLeadersInSameEpoch",
       "NoIllegalState")


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
    ap.add_argument("--budget", type=float, default=3600.0)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--max-depth", type=int, default=None)
    args = ap.parse_args()
    model = cached_model(KRaftParams(**PARAMS))
    bfs = DeviceBFS(Dense(model), invariants=INV, symmetry=True, chunk=args.chunk,
                    valid_per_state=32, frontier_cap=1 << 21, journal_cap=1 << 23)
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
