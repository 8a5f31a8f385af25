"""Time the expand kernels of several checkouts of the repo in turns, on
one card, on the same inputs: a change against its parent.

    python scripts/expand_timing.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout (the repo itself, or a parent unpacked with
``git archive`` into a git-ignored directory such as ``build/parent``),
given in the order to time them, e.g. parent, change, change, parent.
Every ROOT runs in a process of its own (the checkouts share the package
name), which builds that checkout's kernels and times, with CUDA events
(``chip_smoke.time_ms`` of that checkout): the guard, apply and fold
kernels on a 4,096-state chunk of the depth-20 Raft.cfg frontier and of
the depth-27 PullRaft stand-in frontier, and the guard and apply on one
move of a 65,536-walk five-server FlexibleRaft simulate (the shapes of
``chip_smoke.py`` phase 3 and its simulate). The inputs come from the
checkout's own engine with fixed seeds, so every checkout times the same
rows when the engines agree (their state counts are printed beside the
times). Prints one JSON line per ROOT, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ROOT)
import chip_smoke as cs
from raft_tpu_torch import kernels
from raft_tpu_torch.__main__ import load_setup, run_check
from raft_tpu_torch.checker.simulate import Simulator, sim_pick
from raft_tpu_torch.checker.util import I32_MAX, compact_indices
from raft_tpu_torch.ops import prng
from raft_tpu_torch.ops.expand import apply, fold, guard

kernels.build_all()
out = {"root": ROOT}


def chunk_times(tag, bfs):
    model, dev = bfs.model, bfs.device
    pool = bfs.frontier_rows.cpu().numpy()
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(
        np.ascontiguousarray(pool[rng.integers(0, len(pool), cs.CHUNK)])).to(dev)
    C, A, K = cs.CHUNK, model.A, len(model.ACTION_NAMES)
    cov = torch.zeros((K, 3), dtype=torch.int64, device=dev)
    valid, rank, _ovf, _ = guard(model, batch, C, cov)
    sel, _n = compact_indices(valid.reshape(-1), bfs.VC, C * A)
    flatc = apply(model, batch, sel)
    new = sel < C * A
    jcount = torch.tensor([0], dtype=torch.int64, device=dev)
    invs = bfs.invariants
    viol = torch.full((len(invs),), I32_MAX, dtype=torch.int64, device=dev)
    out[tag] = dict(
        states=len(pool), valid=int(valid.sum()),
        guard_ms=cs.time_ms(torch, lambda: guard(model, batch, C, cov), iters=50),
        apply_ms=cs.time_ms(torch, lambda: apply(model, batch, sel), iters=50),
        fold_ms=cs.time_ms(torch, lambda: fold(model, flatc, new, jcount, viol, invs, cov=cov,
                                               sel=sel, valid=valid, rank=rank), iters=50))


_, b, _ = run_check("Raft.cfg", text=cs.RAFT_CFG, device="cuda", chunk=cs.CHUNK, max_depth=20)
chunk_times("raft", b)
del b
_, b, _ = run_check("PullRaft.cfg", text=cs.PULL_CFG, device="cuda", chunk=cs.CHUNK,
                    max_depth=cs.PULL_SAMPLE_DEPTH, lenient=True)
chunk_times("pull", b)
del b
setup = load_setup("FlexibleRaft.cfg", text=cs.FLEX5_CFG, msg_slots=cs.RAFT5_SLOTS)
model = setup.model
sim = Simulator(model, setup.invariants, walks=cs.SIM_WALKS, max_behavior_depth=cs.SIM_DEPTH,
                seed=1, device="cuda")
sim.start()
for _ in range(10):
    sim.step()
states = sim.states
valid, _rank, ovf, _ = guard(model, states, cs.SIM_WALKS, sim.cov)
stats = torch.zeros(4, dtype=torch.int64, device=states.device)
pick = sim_pick(valid, ovf, prng.split(sim.rng)[1], sim.init_pool.shape[0], stats)
out["flex5_move"] = dict(
    walks=cs.SIM_WALKS, valid=int(valid.sum()),
    guard_ms=cs.time_ms(torch, lambda: guard(model, states, cs.SIM_WALKS, sim.cov), iters=50),
    apply_ms=cs.time_ms(torch, lambda: apply(model, states, pick[2]), iters=50))
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    lines = []
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", f"ROOT = {root!r}\n" + CHILD],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
