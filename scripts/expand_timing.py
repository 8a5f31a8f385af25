"""Time the expand kernels of several checkouts of the repo in turns, on
one card, on the same inputs: a change against its parent.

    python scripts/expand_timing.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout (the repo itself, or a parent unpacked with
``git archive`` into a git-ignored directory such as ``build/parent``),
given in the order to time them, e.g. parent, change, change, parent.
Every ROOT runs in a process of its own (the checkouts share the package
name), which builds that checkout's kernels and times, with CUDA events
around ITERS calls issued back to back (the card's time per call, the
host's launch work hidden behind the queue): the guard, apply and fold
kernels on a 4,096-state chunk of the depth-20 Raft.cfg frontier, of the
depth-12 Raft.cfg ``--net-faults`` frontier (``raft_nf_guard`` and
``raft_nf_apply``, the fault build), of the depth-27 PullRaft stand-in
frontier and of the depth-33 KRaft.cfg frontier,
``canon_memo`` on each chunk's worklist (cold: a fresh 2^21-row memo
before every call; warm: every lane hits), ``append_rows`` emitting the
chunk's valid rows (DeviceBFS's frontier emit), ``owner_route`` on the
Raft.cfg chunk at D = 1 (the sharded engine's route), the dedup stage
(``DeviceBFS._st_dedup``, which both the parent and the change have) on each
chunk's fingerprints against the engine's seen run plus three ladder runs
of the stage's sizes (R0, 2 R0 and 4 R0 lanes, half filled from a fixed
seed): its device ms and its host time a call (Python only, 50 calls
without a sync), the same on a chunk of the depth-9 five-server Raft
frontier (its canon ``canon_tiered``, the 2-word path, and
``canon_signatures`` on the worklist), the same on a chunk of the
depth-14 five-server AddRemove frontier (``canon_tiered``'s general path,
cold and warm, beside the reconfiguration kernels), the same on a chunk of the
depth-11 four-server AddRemove frontier (``canon_memo``'s general path, whose
fingerprints are the least of 24 permuted hashes) and of the depth-10
four-server JointConsensus frontier, the same on a chunk of the depth-11
KRaftWithReconfig frontier (the full cfg: ``slot_canon``, which has no
memo, in place of the canon's cold and warm times), and the guard and apply
on one move of a
65,536-walk simulate of five-server FlexibleRaft, of KRaft.cfg, of Raft.cfg
with ``--net-faults``, of each four-server
reconfiguration cfg and of KRaftWithReconfig's full cfg (the shapes of
``chip_smoke.py`` phase 3 and its simulates); with ptxas' stack, spill and
register figures of the Raft (both builds), KRaft, reconfiguration pair's
and KRaftWithReconfig's guard and apply kernels and of ``canon_memo``'s and
``slot_canon``'s (the seven units compiled afresh) and, where the checkout
has them, the
group guard's and the group apply's occupancy and each chunk's canon's (its
tile, block shape and warps an SM). The inputs
come from the checkout's own engine with fixed seeds, so every checkout
times the same rows when the engines agree (their state counts are printed
beside the times). Prints one JSON line per ROOT, and writes them all to
``--out``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r"""
import json, os, re, subprocess, sys, time
import numpy as np
import torch
sys.path.insert(0, ROOT)
import chip_smoke as cs
from raft_tpu_torch import kernels
from raft_tpu_torch.__main__ import load_setup, run_check
from raft_tpu_torch.checker.simulate import Simulator, sim_pick
from raft_tpu_torch.checker.util import I32_MAX, append_rows, compact_indices
from raft_tpu_torch.ops import prng
from raft_tpu_torch.ops.expand import apply, fold, guard
from raft_tpu_torch.ops.hashing import INT64_MAX

kernels.build_all()
out = {"root": ROOT}
ITERS = 100


# ptxas' figures (-Xptxas -v) of Raft's (both builds), KRaft's, the
# reconfiguration pair's and KRaftWithReconfig's guard and apply kernels and
# of canon_memo's and slot_canon's: each unit compiled afresh by the checkout's
# own nvcc command, its library written under build/raft_tpu_torch/ptxas/;
# {kernel (with its template arguments, e.g. canon_memo_kernel<0>): stack
# frame, spill stores and loads (bytes), registers}
def ptxas_figures(units=("raft_expand", "kraft_expand", "reconfig_expand", "joint_expand",
                         "kreconfig_expand", "canon_memo", "slot_canon")):
    by_unit = {k.unit: k for k in kernels.ALL}
    os.makedirs(os.path.join(kernels.BUILD_DIR, "ptxas"), exist_ok=True)
    procs = []
    for u in units:
        cmd = by_unit[u].compile_cmd()
        cmd[cmd.index("-o") + 1] = os.path.join(kernels.BUILD_DIR, "ptxas", f"lib{u}.so")
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    figs, cur = {}, None
    for proc in procs:
        for line in proc.communicate()[0].splitlines():
            m = re.search(r"Function properties for _Z(\d+)(\w+)", line)
            if m:
                name = m.group(2)[:int(m.group(1))]
                targs = re.match(r"I((?:Li\d+E)+)E", m.group(2)[int(m.group(1)):])
                args = re.findall(r"Li(\d+)E", targs.group(1)) if targs else []
                key = name + (f"<{','.join(args)}>" if args else "")
                cur = figs.setdefault(key, {}) if name.endswith("_kernel") else None
            elif cur is not None and "stack frame" in line:
                cur.update(zip(("stack", "spill_stores", "spill_loads"),
                               map(int, re.findall(r"(\d+) bytes", line))))
            elif cur is not None and "Used" in line:
                cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
                cur = None
    return figs


out["ptxas"] = ptxas_figures()
try:  # the group apply's launch shape (checkouts that have it)
    from raft_tpu_torch.ops.expand import apply_occupancy
except ImportError:
    apply_occupancy = None
try:  # the group guard's (checkouts that have it)
    from raft_tpu_torch.ops.expand import guard_occupancy
except ImportError:
    guard_occupancy = None


# mean ms per call of fn (after setup, whose own time is taken off) over
# ITERS calls queued back to back
def device_ms(fn, setup=None):
    def run(f):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(ITERS):
            f()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / ITERS
    if setup is None:
        return run(fn)
    return run(lambda: (setup(), fn())) - run(setup)


# mean host us per call of fn: Python and the launches only, no sync
def host_us(fn, calls=50):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


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
    # DeviceBFS's emit of every valid lane's row into an empty frontier
    esel, _ = compact_indices(new, bfs.VC, bfs.VC)
    nbuf = torch.zeros((2 * bfs.VC, flatc.shape[1]), dtype=torch.int32, device=dev)
    out[tag] = dict(
        states=len(pool), valid=int(valid.sum()),
        guard_ms=device_ms(lambda: guard(model, batch, C, cov)),
        apply_ms=device_ms(lambda: apply(model, batch, sel)),
        fold_ms=device_ms(lambda: fold(model, flatc, new, jcount, viol, invs, cov=cov, sel=sel,
                                       valid=valid, rank=rank)),
        append_ms=device_ms(lambda: append_rows(nbuf, flatc, esel, jcount, bfs.VC)))
    if hasattr(bfs.canon, "fingerprints_memo"):
        memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=dev)
        canon = lambda: bfs.canon.fingerprints_memo(flatc, new, memo)  # noqa: E731
        out[tag]["canon_cold_ms"] = device_ms(canon, setup=lambda: memo.fill_(INT64_MAX))
        canon()
        out[tag]["canon_warm_ms"] = device_ms(canon)
        fps = canon()[0]
    else:  # KRaftWithReconfig's slot canon: no memo
        out[tag]["canon_ms"] = device_ms(lambda: bfs.canon.fingerprints(flatc, new))
        fps = bfs.canon.fingerprints(flatc, new)
    out[tag]["canon_valid"] = int(new.sum())
    occ = guard_occupancy(model) if guard_occupancy else None
    if occ:
        out[tag]["guard_occupancy"] = occ
    occ = apply_occupancy(model) if apply_occupancy else None
    if occ:
        out[tag]["apply_occupancy"] = occ
    if hasattr(bfs.canon, "occupancy"):  # the canon's launch shape (checkouts that have it)
        out[tag]["canon_occupancy"] = bfs.canon.occupancy(dev)
    if getattr(bfs.canon, "prune", False):
        out[tag]["signatures_ms"] = device_ms(lambda: bfs.canon.signatures(flatc))
    # the dedup stage against the seen run and three half-filled ladder runs
    lrng = np.random.default_rng(1)
    runs = [bfs._seen]
    for i in range(3):
        size = bfs.R0 << i
        v = np.sort(lrng.integers(-(1 << 62), 1 << 62, size // 2))
        v = np.concatenate([v, np.full(size - size // 2, INT64_MAX)])
        runs.append(torch.from_numpy(v).to(dev))
    out[tag]["dedup_ms"] = device_ms(lambda: bfs._st_dedup(fps, runs))
    out[tag]["dedup_host_us"] = host_us(lambda: bfs._st_dedup(fps, runs))
    out[tag]["dedup_new"] = int(bfs._st_dedup(fps, runs)[0].sum())
    if tag == "raft":
        # the sharded engine's owner route of this chunk at D = 1, RC = VC
        from raft_tpu_torch.parallel.route import owner_route
        out[tag]["route_ms"] = device_ms(
            lambda: owner_route(fps, flatc, sel, rank, 0, A, 1, bfs.VC))


_, b, _ = run_check("Raft.cfg", text=cs.RAFT_CFG, device="cuda", chunk=cs.CHUNK, max_depth=20)
chunk_times("raft", b)
del b
_, b, _ = run_check("Raft.cfg", text=cs.RAFT_CFG, device="cuda", chunk=cs.CHUNK,
                    max_depth=cs.NF_SAMPLE_DEPTH, caps=cs.NF_CAPS, net_faults=True)
chunk_times("raft_nf", b)
del b
_, b, _ = run_check("PullRaft.cfg", text=cs.PULL_CFG, device="cuda", chunk=cs.CHUNK,
                    max_depth=cs.PULL_SAMPLE_DEPTH, lenient=True)
chunk_times("pull", b)
del b
_, b, _ = run_check("KRaft.cfg", text=cs.KRAFT_CFG, device="cuda", chunk=cs.CHUNK,
                    max_depth=cs.KRAFT_SAMPLE_DEPTH)
chunk_times("kraft", b)
del b
_, b, _ = run_check("Raft.cfg", text=cs.RAFT5_CFG, device="cuda", chunk=cs.CHUNK,
                    msg_slots=cs.RAFT5_SLOTS, max_depth=cs.RAFT5_SAMPLE_DEPTH, caps=cs.RAFT5_CAPS)
chunk_times("raft5", b)
del b
_, b, _ = run_check("RaftWithReconfigAddRemove.cfg", text=cs.ADDREMOVE5_CFG, device="cuda",
                    chunk=cs.CHUNK, max_depth=cs.ADDREMOVE5_SAMPLE_DEPTH, lenient=True,
                    caps=cs.RECONFIG_CAPS)
chunk_times("addremove5", b)
del b
_, b, _ = run_check("RaftWithReconfigAddRemove.cfg", text=cs.ADDREMOVE_CFG, device="cuda",
                    chunk=cs.CHUNK, max_depth=cs.RECONFIG_SAMPLE_DEPTH, lenient=True,
                    caps=cs.RECONFIG_CAPS)
chunk_times("addremove4", b)
del b
_, b, _ = run_check("RaftWithReconfigJointConsensus.cfg", text=cs.JOINT_CFG, device="cuda",
                    chunk=cs.CHUNK, max_depth=cs.JOINT_SAMPLE_DEPTH, caps=cs.JOINT_CAPS)
chunk_times("joint4", b)
del b
_, b, _ = run_check("KRaftWithReconfig.cfg", text=cs.KRAFT_RECONFIG_CFG, device="cuda",
                    chunk=cs.CHUNK, max_depth=cs.KRECONFIG_SAMPLE_DEPTH, lenient=True,
                    caps=cs.KRECONFIG_CAPS)
chunk_times("kreconfig", b)
del b


# the guard and apply on one move of a 65,536-walk simulate (ten moves from
# Init, seed 1)
def move_times(tag, spec, text, **kw):
    setup = load_setup(spec, text=text, **kw)
    model = setup.model
    sim = Simulator(model, setup.invariants, walks=cs.SIM_WALKS,
                    max_behavior_depth=cs.SIM_DEPTH, seed=1, device="cuda")
    sim.start()
    for _ in range(10):
        sim.step()
    states = sim.states
    valid, _rank, ovf, _ = guard(model, states, cs.SIM_WALKS, sim.cov)
    stats = torch.zeros(4, dtype=torch.int64, device=states.device)
    pick = sim_pick(valid, ovf, prng.split(sim.rng)[1], sim.init_pool.shape[0], stats)
    out[tag] = dict(
        walks=cs.SIM_WALKS, valid=int(valid.sum()),
        moved=int((pick[2] < cs.SIM_WALKS * model.A).sum()),
        guard_ms=device_ms(lambda: guard(model, states, cs.SIM_WALKS, sim.cov)),
        apply_ms=device_ms(lambda: apply(model, states, pick[2])))
    occ = apply_occupancy(model) if apply_occupancy else None
    if occ:
        out[tag]["apply_occupancy"] = occ
    occ = guard_occupancy(model) if guard_occupancy else None
    if occ:
        out[tag]["guard_occupancy"] = occ


move_times("flex5_move", "FlexibleRaft.cfg", cs.FLEX5_CFG, msg_slots=cs.RAFT5_SLOTS)
move_times("kraft_move", "KRaft.cfg", cs.KRAFT_CFG)
move_times("raft_nf_move", "Raft.cfg", cs.RAFT_CFG, net_faults=True)
move_times("addremove_move", "RaftWithReconfigAddRemove.cfg", cs.ADDREMOVE_CFG, lenient=True)
move_times("joint_move", "RaftWithReconfigJointConsensus.cfg", cs.JOINT_CFG)
move_times("kreconfig_move", "KRaftWithReconfig.cfg", cs.KRAFT_RECONFIG_CFG, lenient=True)
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
