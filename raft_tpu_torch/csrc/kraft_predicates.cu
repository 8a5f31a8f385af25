// kraft_predicates — the invariants of the KRaft model and its liveness
// predicate ValueAllOrNothing(v) over rows (kraft_predicates: simulate's
// initial-state check, raft_tpu/checker/simulate.py:142, and the liveness
// graph's predicates, raft_tpu/checker/liveness.py:254), and the simulate
// step's check and settle (kraft_sim_check: raft_tpu/checker/simulate.py:
// 88-103): the drivers of predicates_driver.cuh (their contract and design)
// over kraft_actions.cuh (raft_tpu/models/kraft.py:867-1000).
#include "predicates_driver.cuh"
#include "kraft_actions.cuh"

PREDICATE_KERNELS(kraft, KRaftFamily)
