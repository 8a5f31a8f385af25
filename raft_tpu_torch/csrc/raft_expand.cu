// raft_expand — the guard-first Raft expand: raft_guard and raft_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/raft.py:327-835 behind _expand1 :836), as
// the sparse branch of raft_tpu/checker/device_bfs.py:346-376 calls them,
// and the enabled/fired coverage of device_bfs.py:436-452: the drivers of
// expand_driver.cuh (their contract and design) over the Raft family's
// actions of raft_actions.cuh.
//
// raft_guard: guard_body, a thread a (state, candidate) lane. raft_apply:
// the group apply of expand_driver.cuh (EXPAND_KERNELS_GROUP_APPLY), one
// launch a call: a tile of 16 threads (RaftFamilyT::APPLY_G) a worklist
// lane, 256 threads a block, four resident blocks asked of the register
// allocator (64 registers a thread, 32 warps an SM), the spec vector alone
// in shared memory (no row staged, so no W refuses it and its warps an SM
// do not depend on W); the tile copies the row into flatc, its lead makes
// the scalar writes, its members split the log and nextIndex/matchIndex
// rows and each bag put (RequestVote's S - 1 one after another on the
// successor's bag).
//
// Bound at the main path's shapes (C = 4096, A = 69, W = 192, VC = 65,536):
// raft_guard by bytes (the state rows read, valid/rank/ovf written) ahead
// of the bag-slot compares of the lanes that put a message; raft_apply by
// bytes, the VC x W int32 successor block it writes (50 MB), ahead of its
// operations (3 a bag slot and key word of each put).
//
// Each is built twice: raft_guard/raft_apply over RaftFamily, and
// raft_nf_guard/raft_nf_apply over RaftFaultFamily (the same actions with the
// network-fault groups, raft.py:583-608), which the raft_guard/raft_apply
// wrappers launch for a model with net_faults (kernels.Kernel.launcher).
#include "expand_driver.cuh"
#include "raft_actions.cuh"

EXPAND_KERNELS_GROUP_APPLY(raft, RaftFamily)
EXPAND_KERNELS_GROUP_APPLY(raft_nf, RaftFaultFamily)
