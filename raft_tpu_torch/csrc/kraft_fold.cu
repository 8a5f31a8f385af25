// kraft_fold — the new-state coverage and the invariant fold of a KRaft
// chunk: the drivers of fold_driver.cuh (their contract and design) over
// the invariants of kraft_actions.cuh (raft_tpu/models/kraft.py:887-1000
// and models/base.py:143), replacing raft_tpu/checker/device_bfs.py:453-460
// and :501-506 for KRaft.
#include "fold_driver.cuh"
#include "kraft_actions.cuh"

FOLD_KERNELS(kraft, KRaftFamily)
