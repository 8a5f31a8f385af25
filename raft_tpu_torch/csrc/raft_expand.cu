// raft_expand — the guard-first Raft expand: raft_guard and raft_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/raft.py:327-835 behind _expand1 :836), as
// the sparse branch of raft_tpu/checker/device_bfs.py:346-376 calls them,
// and the enabled/fired coverage of device_bfs.py:436-452: the drivers of
// expand_driver.cuh (their contract and design) over the Raft family's
// actions of raft_actions.cuh.
//
// Bound at the main path's shapes (C = 4096, A = 69, W = 192, VC = 65,536):
// raft_guard by bytes (the state rows read, valid/rank/ovf written) ahead
// of the bag-slot compares of the lanes that put a message; raft_apply by
// bytes, the VC x W int32 successor block it writes (50 MB).
#include "expand_driver.cuh"
#include "raft_actions.cuh"

EXPAND_KERNELS(raft, RaftFamily)
