// pull_fold — the new-state coverage and the invariant fold of a PullRaft
// chunk: the drivers of fold_driver.cuh (their contract and design) over
// the invariants of pull_actions.cuh (raft_tpu/models/pull_raft.py:703-760
// and models/base.py:143), replacing raft_tpu/checker/device_bfs.py:453-460
// and :501-506 for the pull family.
#include "fold_driver.cuh"
#include "pull_actions.cuh"

FOLD_KERNELS(pull, PullFamily)
