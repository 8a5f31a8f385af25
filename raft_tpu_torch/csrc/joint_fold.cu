// joint_fold — the new-state coverage and the invariant fold of a
// RaftWithReconfigJointConsensus chunk: the drivers of fold_driver.cuh (their contract
// and design) over the invariants of config_actions.cuh
// (raft_tpu/models/config_common.py:682-694 with joint_raft.py's own),
// replacing raft_tpu/checker/device_bfs.py:436-460 and :501-506 for it.
#include "fold_driver.cuh"
#include "config_actions.cuh"

FOLD_KERNELS(joint, JointFamily)
