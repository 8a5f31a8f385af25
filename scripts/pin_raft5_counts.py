"""Pin the depth counts of five-server Raft with VIEW + SYMMETRY from the
JAX reference's dense DeviceBFS (the parity anchor of the PyTorch port's
five-server run).

    JAX_PLATFORMS=cpu python scripts/pin_raft5_counts.py [--budget S] [--chunk C]

The configuration is BASELINE.json's second one (scripts/bench_rows.py
row 2): RaftParams(n_servers=5, n_values=5, max_elections=4,
max_restarts=0, msg_slots=64), invariants LeaderHasAllAckedValues and
NoLogDivergence. The dense path (the sparse guard pass hidden by a model
proxy, as tests/test_expand_sparse.py's DenseShim does) runs wave by wave
until ``--budget`` seconds have passed; every completed wave is printed
and the last line is a JSON object with the per-depth counts, the
distinct/total/terminal counts and the coverage at the last completed
depth.
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
from raft_tpu.models.raft import RaftParams, cached_model  # noqa: E402

PARAMS = dict(n_servers=5, n_values=5, max_elections=4, max_restarts=0, msg_slots=64)
INV = ("LeaderHasAllAckedValues", "NoLogDivergence")


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
    model = cached_model(RaftParams(**PARAMS))
    bfs = DeviceBFS(Dense(model), invariants=INV, symmetry=True, chunk=args.chunk,
                    valid_per_state=32, frontier_cap=1 << 20, journal_cap=1 << 22)
    t0 = time.perf_counter()
    res = bfs.run(max_depth=args.max_depth, time_budget_s=args.budget, verbose=True)
    out = dict(params=PARAMS, invariants=INV, chunk=args.chunk,
               depth=res.depth, distinct=res.distinct, total=res.total,
               terminal=res.terminal, depth_counts=res.depth_counts,
               coverage=res.coverage, exhausted=res.exhausted,
               violation=None if res.violation is None else res.violation.invariant,
               seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
