// reconfig_expand — the guard-first RaftWithReconfigAddRemove expand: reconfig_guard and
// reconfig_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/config_common.py:132-798 and
// reconfig_raft.py's hooks behind _expand1, config_common.py:702) for
// RaftWithReconfigAddRemove: the drivers of expand_driver.cuh (their
// contract and design) over the actions of config_actions.cuh.
//
// Bound at the four-server cfg's shapes (C = 4,096 rows of W int32 lanes,
// the [C, A] grid, VC = 65,536): reconfig_guard by bytes (the state rows
// read, valid/rank/ovf written) ahead of the bag-slot compares of the
// lanes that put a message (N key words each); reconfig_apply by bytes, the
// VC x W int32 successor block it writes. At W = 1,042 a block of 64 apply
// lanes would pass the shared-memory opt-in limit, so the driver halves it.
#include "expand_driver.cuh"
#include "config_actions.cuh"

EXPAND_KERNELS(reconfig, ReconfigFamily)
