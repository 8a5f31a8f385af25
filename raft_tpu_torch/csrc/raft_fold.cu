// raft_fold — the new-state coverage and the invariant fold of a Raft
// chunk: the drivers of fold_driver.cuh (their contract and design) over
// the invariants of raft_actions.cuh (raft_tpu/models/raft.py:894-975 and
// models/base.py:143), replacing raft_tpu/checker/device_bfs.py:453-460 and
// :501-506.
#include "fold_driver.cuh"
#include "raft_actions.cuh"

FOLD_KERNELS(raft, RaftFamily)
