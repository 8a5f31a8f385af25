// kreconfig_predicates — the invariants of KRaftWithReconfig and the state
// predicates of its ValuesNotStuck and ReconfigurationNotStuck over rows
// (kreconfig_predicates: simulate's initial-state check,
// raft_tpu/checker/simulate.py:142, and the liveness graph's predicates,
// raft_tpu/checker/liveness.py:254), and the simulate step's check and
// settle (kreconfig_sim_check: raft_tpu/checker/simulate.py:88-103): the
// drivers of predicates_driver.cuh (their contract and design) over
// kreconfig_actions.cuh (raft_tpu/models/kraft_reconfig.py:1367-1444 and
// :1555-1654).
#include "predicates_driver.cuh"
#include "kreconfig_actions.cuh"

PREDICATE_KERNELS(kreconfig, KReconfigFamily)
