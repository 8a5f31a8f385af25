// kraft_expand — the guard-first KRaft expand: kraft_guard and kraft_apply.
//
// Replaces raft_tpu/models/base.py:332 guards1 and :426 sparse_apply (with
// the actions of raft_tpu/models/kraft.py:284-853 behind _expand1 :857)
// for KRaft: the drivers of expand_driver.cuh (their contract and design)
// over the actions of kraft_actions.cuh.
//
// Bound at KRaft.cfg's shapes (C = 4096, A = 98, W = 291, VC = 65,536):
// kraft_guard by bytes (the state rows read, valid/rank/ovf written) ahead
// of the bag-slot compares of the lanes that put a message; kraft_apply by
// bytes, the VC x W int32 successor block it writes (76 MB).
#include "expand_driver.cuh"
#include "kraft_actions.cuh"

EXPAND_KERNELS(kraft, KRaftFamily)
