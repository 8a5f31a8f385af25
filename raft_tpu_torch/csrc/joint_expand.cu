// joint_expand — the guard-first RaftWithReconfigJointConsensus expand: joint_guard and
// joint_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/config_common.py:132-798 and
// joint_raft.py's hooks behind _expand1, config_common.py:702) for
// RaftWithReconfigJointConsensus: the drivers of expand_driver.cuh (their
// contract and design) over the actions of config_actions.cuh.
//
// joint_guard: the group guard of expand_driver.cuh, one launch a call: a
// warp (G = 32 threads) a state, 256 threads a block, the spec vector and,
// a tile, its row and one chain copy in shared memory, three resident blocks
// asked of the register allocator: 80 registers a thread (48 bytes of
// stack), 24 warps an SM at the four- and five-server cfgs' widths. Each bag
// probe (AppendEntries, SendSnapshot, the receipt's reply, RequestVote's
// chain) is split over the warp, the chains one after another on its copy.
//
// joint_apply: the group apply of expand_driver.cuh, one launch a call: a
// warp (G = 32 threads) a worklist lane, 256 threads a block, the spec
// vector alone in shared memory, three resident blocks asked of the
// register allocator: 80 registers a thread (24 bytes of stack for 20 bytes
// of spills) and 24 warps an SM at every W (1,042 here; 1,227 at five
// servers). The group copies the row and splits the bag put; one lane a
// warp, so lanes on different action arms never share one, and no ordering
// of the worklist by arm is needed.
//
// Bound at the four-server cfg's shapes (C = 4,096 rows of W int32 lanes,
// the [C, A] grid, VC = 65,536): joint_guard by bytes (the state rows
// read, valid/rank/ovf written) ahead of the bag-slot compares of the
// lanes that put a message (N key words each); joint_apply by bytes: the
// worklist read, each distinct source row read once and the VC x W block
// written (65,536 x 4,168 B = 273 MB, with the rows 0.0867 ms at 3.35
// TB/s), two orders of magnitude above its operations (3 a bag slot and key
// word of each put: about 26 M, 0.0008 ms).
#include "expand_driver.cuh"
#include "config_actions.cuh"

EXPAND_KERNELS_GROUP(joint, JointFamily)
