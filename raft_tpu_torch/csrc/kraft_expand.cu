// kraft_expand — the guard-first KRaft expand: kraft_guard and kraft_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/kraft.py:284-853 behind _expand1 :857)
// for KRaft: the drivers of expand_driver.cuh (their contract and design)
// over the actions of kraft_actions.cuh.
//
// kraft_guard: guard_body, a thread a (state, candidate) lane. kraft_apply:
// the group apply of expand_driver.cuh (EXPAND_KERNELS_GROUP_APPLY), one
// launch a call: a warp (KRaftFamily::APPLY_G = 32 threads) a worklist
// lane, 256 threads a block, four resident blocks asked of the register
// allocator (64 registers a thread, 32 warps an SM), the spec vector alone
// in shared memory; the tile copies
// the row into flatc, its lead makes the scalar writes, its members split
// the endOffset and log rows and each bag put (RequestVote's and
// BecomeLeader's S - 1 one after another on the successor's bag).
//
// Bound at KRaft.cfg's shapes (C = 4096, A = 98, W = 291, VC = 65,536):
// kraft_guard by bytes (the state rows read, valid/rank/ovf written) ahead
// of the bag-slot compares of the lanes that put a message; kraft_apply by
// bytes, the VC x W int32 successor block it writes (76 MB), ahead of its
// operations.
#include "expand_driver.cuh"
#include "kraft_actions.cuh"

EXPAND_KERNELS_GROUP_APPLY(kraft, KRaftFamily)
