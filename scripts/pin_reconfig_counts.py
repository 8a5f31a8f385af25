"""Pin the depth counts of the two reconfiguration specs' four-server
configurations from the JAX reference's dense DeviceBFS (the parity
anchor of the PyTorch port's reconfiguration runs).

    JAX_PLATFORMS=cpu python scripts/pin_reconfig_counts.py
        [--joint] [--servers 4|5] [--budget S] [--chunk C] [--max-depth D]

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

``--servers 5`` pins the five-server stand-ins (chip_smoke.py's
ADDREMOVE5_CFG and JOINT5_CFG): the same cfgs with n5 added to Server,
AddRemove's MaxClusterSize repaired to |Server| = 5 and MaxAddReconfigs 2
(so the three-member cluster can grow to all five servers), at 112
message slots. The reference canonicalizes these through its signature
tiers (S >= 5), whose ``_signatures`` reads each server-valued or
member-set field as one lane a server and so raises on these layouts'
log fields (five or six lanes a server: log_cmem, log_cmembers, log_old,
log_new, log_members). This script signs such a field as the PyTorch port
does (raft_tpu_torch/ops/symmetry.py ``split_fields``): as r one-lane
fields, the c-th holding lane c of each server's row at offset
off + c * S, by calling the reference's own ``_signatures`` on the view
with those lanes regrouped (``split_signatures`` below; the reference
package is not edited). The depth counts do not depend on which canonical
form a run takes, only its fingerprints do. The pins chip_smoke.py holds
came from

    JAX_PLATFORMS=cpu python scripts/pin_reconfig_counts.py --servers 5 --budget 600
    JAX_PLATFORMS=cpu python scripts/pin_reconfig_counts.py --servers 5 --joint --budget 600

in 878.2 s (AddRemove through depth 13: 183,136 distinct, 458,294 total, 81
terminal) and 787.8 s (JointConsensus through depth 11: 210,341 / 511,224 /
4) on 8 CPU cores, one run after the other.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

jax.config.update("jax_platforms", "cpu")

from raft_tpu.checker.device_bfs import DeviceBFS  # noqa: E402
from raft_tpu.models import joint_raft, reconfig_raft  # noqa: E402
from raft_tpu.ops import symmetry as ref_symmetry  # noqa: E402

ADD_REMOVE = dict(n_servers=4, n_values=1, init_cluster_size=3, max_elections=1,
                  max_restarts=0, max_values_per_term=1, max_add_reconfigs=1,
                  max_remove_reconfigs=1, min_cluster_size=2, max_cluster_size=4,
                  include_thesis_bug=False, msg_slots=112)
JOINT = dict(n_servers=4, n_values=1, init_cluster_size=3, max_elections=1, max_restarts=0,
             max_reconfigs=2, max_values_per_term=1, reconfig_type=2, msg_slots=112)
# the five-server stand-ins (--servers 5)
ADD_REMOVE5 = dict(ADD_REMOVE, n_servers=5, max_add_reconfigs=2, max_cluster_size=5)
JOINT5 = dict(JOINT, n_servers=5)
INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "MaxOneReconfigurationAtATime")


def split_signatures(orig):
    """Wrap the reference's ``Canonicalizer._signatures``: a server-valued
    or member-set field of r > 1 lanes a server is signed as r one-lane
    fields (lane c of each server's row at offset off + c * S)."""

    def signatures(self, view, rounds=None):
        S = self.S
        order = np.arange(view.shape[1])
        fields = []
        for kind, off, shape, size in self._view_fields:
            if kind in ("per_server_val", "server_bitmask") and size > S:
                r = size // S
                fields += [(kind, off + c * S, (S,), S) for c in range(r)]
                order[off:off + size] = off + np.arange(size).reshape(S, r).T.reshape(-1)
            else:
                fields.append((kind, off, shape, size))
        if (order == np.arange(len(order))).all():
            return orig(self, view, rounds)
        saved, self._view_fields = self._view_fields, fields
        try:
            return orig(self, view[:, order], rounds)
        finally:
            self._view_fields = saved

    return signatures


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
    ap.add_argument("--servers", type=int, default=4, choices=(4, 5))
    ap.add_argument("--budget", type=float, default=3600.0)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--max-depth", type=int, default=None)
    args = ap.parse_args()
    ref_symmetry.Canonicalizer._signatures = split_signatures(
        ref_symmetry.Canonicalizer._signatures)
    if args.joint:
        params = JOINT5 if args.servers == 5 else JOINT
        model = joint_raft.cached_model(joint_raft.JointRaftParams(**params))
    else:
        params = ADD_REMOVE5 if args.servers == 5 else ADD_REMOVE
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
