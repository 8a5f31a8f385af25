// raft_predicates — state predicates of the Raft model over rows
// (raft_predicates: the liveness graph's _eval_kernel,
// raft_tpu/checker/liveness.py:254, with ValueAllOrNothing of
// raft_tpu/models/raft.py:925-942), and the simulate step's check and
// settle (raft_sim_check: raft_tpu/checker/simulate.py:88-103): the drivers
// of predicates_driver.cuh (their contract and design) over the predicates
// of raft_actions.cuh.
#include "predicates_driver.cuh"
#include "raft_actions.cuh"

PREDICATE_KERNELS(raft, RaftFamily)
