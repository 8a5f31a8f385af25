"""Time canon_tiered at other tile sizes than its own, on one card, on the
same inputs: the choice of G behind csrc/canon_tiered.cu's two builds.

    python scripts/canon_groups.py [--out FILE]

Builds csrc/canon_tiered.cu with ``-DCT_G2=g2 -DCT_GGEN=gg`` (the 2-word
build's tile and the general build's) for each pair of PAIRS, one nvcc
each, all at once, into build/canon_groups/, and times each library through
the port's own wrapper (``Canonicalizer.fingerprints_memo_cuda``, the
library swapped in under ``kernels.CANON_TIERED``) with CUDA events around
ITERS calls queued back to back: cold (a fresh 2^21-row memo before each
call, its fill timed apart and taken off) and warm (every valid lane hits),
on a 4,096-state chunk's worklist of the depth-9 five-server Raft frontier
(the 2-word build) and of the depth-14 five-server AddRemove and depth-12
five-server JointConsensus frontiers (the general build), the shapes of
``chip_smoke.py`` phase 3. Every variant's fingerprints, memo and hit
counts must equal the plain version's. Prints one JSON line per variant and
build, with the occupancy each reaches
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the card's name and
power limit, and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch import kernels  # noqa: E402
from raft_tpu_torch.__main__ import run_check  # noqa: E402
from raft_tpu_torch.checker.util import compact_indices  # noqa: E402
from raft_tpu_torch.ops.expand import apply, guard  # noqa: E402
from raft_tpu_torch.ops.hashing import INT64_MAX  # noqa: E402

# (2-word tile, general tile): each build at 4 (2-word only) or 8 to 32
# threads, with repeats to show the spread
PAIRS = ((4, 8), (8, 16), (16, 32), (32, 32), (8, 32))
ITERS = 50
OUT_DIR = os.path.join(ROOT, "build", "canon_groups")


def build(pairs) -> dict:
    """One library per (g2, gg), compiled in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    base = kernels.CANON_TIERED.compile_cmd()
    procs = {}
    for g2, gg in pairs:
        so = os.path.join(OUT_DIR, f"libcanon_tiered_{g2}_{gg}.so")
        cmd = [a for a in base]
        cmd[cmd.index("-o") + 1] = so
        cmd[1:1] = [f"-DCT_G2={g2}", f"-DCT_GGEN={gg}"]
        procs[(g2, gg)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn, args in kernels._SIGNATURES["canon_tiered"].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def device_ms(fn, setup=None) -> float:
    """Mean ms per call of fn over ITERS calls queued back to back, after
    setup, whose own time is taken off."""
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


def chunk(bfs):
    """A CHUNK-state chunk of ``bfs``'s frontier through guard, compact and
    apply: (worklist rows, valid prefix)."""
    model, dev = bfs.model, bfs.device
    pool = bfs.frontier_rows.cpu().numpy()
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(
        np.ascontiguousarray(pool[rng.integers(0, len(pool), cs.CHUNK)])).to(dev)
    cov = torch.zeros((len(model.ACTION_NAMES), 3), dtype=torch.int64, device=dev)
    valid, _rank, _ovf, _ = guard(model, batch, cs.CHUNK, cov)
    sel, _n = compact_indices(valid.reshape(-1), bfs.VC, cs.CHUNK * model.A)
    return apply(model, batch, sel), sel < cs.CHUNK * model.A


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("canon_groups.py needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi()
    libs = build(PAIRS)
    chunks = {}
    _, b, _ = run_check("Raft.cfg", text=cs.RAFT5_CFG, device="cuda", chunk=cs.CHUNK,
                        msg_slots=cs.RAFT5_SLOTS, max_depth=cs.RAFT5_SAMPLE_DEPTH,
                        caps=cs.RAFT5_CAPS)
    chunks["raft5"] = (b.canon, *chunk(b))
    del b
    _, b, _ = run_check("RaftWithReconfigAddRemove.cfg", text=cs.ADDREMOVE5_CFG, device="cuda",
                        chunk=cs.CHUNK, max_depth=cs.ADDREMOVE5_SAMPLE_DEPTH, lenient=True,
                        caps=cs.RECONFIG_CAPS)
    chunks["addremove5"] = (b.canon, *chunk(b))
    del b
    _, b, _ = run_check("RaftWithReconfigJointConsensus.cfg", text=cs.JOINT5_CFG, device="cuda",
                        chunk=cs.CHUNK, max_depth=cs.JOINT5_SAMPLE_DEPTH, caps=cs.JOINT_CAPS)
    chunks["joint5"] = (b.canon, *chunk(b))
    del b
    lines = []
    for tag, (canon, rows, valid) in chunks.items():
        memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=rows.device)
        mp = memo.clone()
        want = [canon.fingerprints_memo_plain(rows, valid, mp) for _ in range(2)]
        general = canon.tier_general()
        for (g2, gg), lib in libs.items():
            kernels.CANON_TIERED._lib = lib
            memo.fill_(INT64_MAX)
            got = [canon.fingerprints_memo_cuda(rows, valid, memo) for _ in range(2)]
            exact = all(torch.equal(f, wf) and int(h) == int(wh)
                        for (f, h), (wf, wh) in zip(got, want)) and torch.equal(memo, mp)
            fn = lambda: canon.fingerprints_memo_cuda(rows, valid, memo)  # noqa: E731
            cold = device_ms(fn, setup=lambda: memo.fill_(INT64_MAX))
            fn()
            line = dict(chunk=tag, build="general" if general else "2-word",
                        G=gg if general else g2, lanes=rows.shape[0], valid=int(valid.sum()),
                        cold_ms=cold, warm_ms=device_ms(fn), exact=exact,
                        occupancy=canon.tier_occupancy(rows.device), card=smi)
            print(json.dumps(line), flush=True)
            lines.append(line)
    kernels.CANON_TIERED._lib = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0 if all(x["exact"] for x in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
