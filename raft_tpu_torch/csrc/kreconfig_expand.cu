// kreconfig_expand — the guard-first KRaftWithReconfig expand: kreconfig_guard
// and kreconfig_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/kraft_reconfig.py:754-1366 behind
// _expand1 :1446) for KRaftWithReconfig: the drivers of expand_driver.cuh
// (their contract and design) over the actions of kreconfig_actions.cuh.
//
// Bound at the full cfg's shapes (NS = 5 identity slots, W = 479 int32
// lanes, A = 145 candidates, 3-word keys in 40 slots): kreconfig_guard by
// bytes (the state rows read, valid/rank/ovf written) ahead of the bag-slot
// compares of the lanes that put a message; kreconfig_apply by bytes, the
// VC x W int32 successor block it writes.
//
// kreconfig_apply is the group apply (EXPAND_KERNELS_GROUP_APPLY: a warp a
// worklist lane, no row staged in shared memory, so its warps an SM do not
// depend on W; the chain puts, the receipt's reply and the log installs
// split over the warp), kreconfig_guard the one-thread-a-lane guard.
#include "expand_driver.cuh"
#include "kreconfig_actions.cuh"

EXPAND_KERNELS_GROUP_APPLY(kreconfig, KReconfigFamily)
