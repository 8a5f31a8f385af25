// kreconfig_fold — the new-state coverage and the invariant fold of a
// KRaftWithReconfig chunk: the drivers of fold_driver.cuh (their contract
// and design) over the invariants of kreconfig_actions.cuh
// (raft_tpu/models/kraft_reconfig.py:1555-1654), replacing
// raft_tpu/checker/device_bfs.py:436-460 and :501-506 for it.
#include "fold_driver.cuh"
#include "kreconfig_actions.cuh"

FOLD_KERNELS(kreconfig, KReconfigFamily)
