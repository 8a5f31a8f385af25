"""Pin JointConsensus' ReconfigurationCompletes graph from the port's CPU
run (the anchor chip_smoke.py phase 8c holds the card's graph to).

    python scripts/pin_reconfig_liveness.py [--chunk C]

The configuration is chip_smoke.py's JOINT_LIVE_CFG (the three-server
constants of tests/test_liveness_families.py:95-99: InitClusterSize 2,
MaxElections 0, MaxRestarts 0, MaxReconfigs 1, MaxValuesPerTerm 1,
ReconfigType 3, 40 message slots, PROPERTY ReconfigurationCompletes),
symmetry off as the liveness checker always runs it. The JAX checker
cannot build this graph on the CPU (XLA's compiler runs out of memory on
the joint kernels at the checker's batch shapes), and AddRemove's graph
ties the port's checker to the JAX one bit for bit
(tests/test_torch_reconfig_bfs.py), so the port's CPU run, through the
kernels' plain PyTorch versions, is the anchor. Each completed wave is
printed to stderr; the last stdout line is a JSON object with the graph's
states, edges, verdict and seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=256)
    args = ap.parse_args()

    from chip_smoke import JOINT_LIVE_CFG
    from raft_tpu_torch.__main__ import load_setup
    from raft_tpu_torch.checker.liveness import LivenessChecker

    setup = load_setup("RaftWithReconfigJointConsensus.cfg", text=JOINT_LIVE_CFG, msg_slots=40)
    t = time.perf_counter()
    checker = LivenessChecker(setup.model, setup.properties, chunk=args.chunk, device="cpu")
    res = checker.run(verbose=True)
    print(json.dumps(dict(spec=setup.model.name, properties=list(setup.properties),
                          chunk=args.chunk, states=res.distinct, edges=res.total_edges,
                          holds=res.violation is None, seconds=time.perf_counter() - t)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
