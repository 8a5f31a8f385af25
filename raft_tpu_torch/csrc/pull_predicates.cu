// pull_predicates — the invariants of the PullRaft model over rows
// (pull_predicates: simulate's initial-state check,
// raft_tpu/checker/simulate.py:142), and the simulate step's check and
// settle (pull_sim_check: raft_tpu/checker/simulate.py:88-103): the
// drivers of predicates_driver.cuh (their contract and design) over the
// invariants of pull_actions.cuh (raft_tpu/models/pull_raft.py:703-760).
#include "predicates_driver.cuh"
#include "pull_actions.cuh"

PREDICATE_KERNELS(pull, PullFamily)
