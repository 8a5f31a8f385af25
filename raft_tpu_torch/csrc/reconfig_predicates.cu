// reconfig_predicates — the invariants of RaftWithReconfigAddRemove and the
// antecedent and consequent of its ReconfigurationCompletes over rows
// (reconfig_predicates: simulate's initial-state check,
// raft_tpu/checker/simulate.py:142, and the liveness graph's predicates,
// raft_tpu/checker/liveness.py:254), and the simulate step's check and
// settle (reconfig_sim_check: raft_tpu/checker/simulate.py:88-103): the
// drivers of predicates_driver.cuh (their contract and design) over
// config_actions.cuh (raft_tpu/models/config_common.py:682-700 and
// reconfig_raft.py's invariants and liveness).
#include "predicates_driver.cuh"
#include "config_actions.cuh"

PREDICATE_KERNELS(reconfig, ReconfigFamily)
