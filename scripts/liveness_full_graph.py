"""Build the full liveness graph of Raft.cfg at MaxElections 2 on the card
and check ValuesNotStuck on it.

    python scripts/liveness_full_graph.py [--max-states N] [--chunk C] [--out PATH]

The configuration is chip_smoke.py's LIVE_CFG (standard-raft Raft.cfg's
constants, 3 servers, 2 values, MaxElections 2, MaxRestarts 0, PROPERTY
ValuesNotStuck), symmetry off as the liveness checker always runs it.
``--max-states`` raises the checker's 8,000,000-state cap. Each completed
wave is printed to stderr; the last stdout line is a JSON object with the
graph's states and edges, the graph build's and the whole run's seconds,
the verdict, the peak device memory, and the card's name and power limit
(also written to ``--out``).
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
    ap.add_argument("--max-states", type=int, default=200_000_000)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "liveness_full_graph.json"))
    args = ap.parse_args()

    import torch

    from chip_smoke import LIVE_CFG, nvidia_smi
    from raft_tpu_torch.__main__ import load_setup
    from raft_tpu_torch.checker.liveness import LivenessChecker

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    card = nvidia_smi()
    print(card, file=sys.stderr)
    setup = load_setup("Raft.cfg", text=LIVE_CFG)
    checker = LivenessChecker(setup.model, setup.properties, chunk=args.chunk,
                              max_states=args.max_states, device="cuda")
    build = {}
    explore = checker._explore

    def timed_explore(verbose=False):
        t = time.perf_counter()
        explore(verbose)
        torch.cuda.synchronize()
        build["seconds"] = time.perf_counter() - t

    checker._explore = timed_explore
    torch.cuda.reset_peak_memory_stats()
    res = checker.run(verbose=True)
    v = res.violation
    report = {
        "config": "Raft.cfg constants, MaxElections 2, PROPERTY ValuesNotStuck, symmetry off",
        "W": setup.model.layout.W, "A": setup.model.A, "chunk": args.chunk,
        "chunks": checker.chunks, "states": res.distinct, "edges": res.total_edges,
        "graph_build_seconds": build["seconds"], "seconds": res.seconds,
        "verdict": "holds" if v is None else f"VIOLATED ({v.prop}[{v.instance}])",
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
