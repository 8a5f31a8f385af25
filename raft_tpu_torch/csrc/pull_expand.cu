// pull_expand — the guard-first PullRaft / PullRaftVariant2 expand:
// pull_guard and pull_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/pull_raft.py:263-660 behind _expand1
// :667) for the pull family: the drivers of expand_driver.cuh (their
// contract and design) over the actions of pull_actions.cuh.
//
// Bound at the main path's shapes (C = 4096, A = 85, W = 259, VC = 65,536):
// pull_guard by bytes (the state rows read, valid/rank/ovf written) ahead
// of the bag-slot compares of the lanes that put a message; pull_apply by
// bytes, the VC x W int32 successor block it writes (68 MB).
#include "expand_driver.cuh"
#include "pull_actions.cuh"

EXPAND_KERNELS(pull, PullFamily)
