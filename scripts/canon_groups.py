"""Time canon_tiered, canon_memo or slot_canon at other tile sizes than
their own, on one card, on the same inputs: the choice of G behind
csrc/canon_tiered.cu's and csrc/canon_memo.cu's two builds and of the tile
and sub-tile of csrc/slot_canon.cu.

    python scripts/canon_groups.py [--memo | --slot] [--out FILE]

Builds csrc/canon_tiered.cu with ``-DCT_G2=g2 -DCT_GGEN=gg`` (the 2-word
build's tile and the general build's) for each pair of PAIRS, or with
``--memo`` csrc/canon_memo.cu with ``-DCM_G2=g2 -DCM_GGEN=gg`` for each pair
of MEMO_PAIRS, one nvcc each, all at once, into build/canon_groups/,
and times each library through the port's own wrapper
(``Canonicalizer.fingerprints_memo_cuda``, the library swapped in under
``kernels.CANON_TIERED`` or ``kernels.CANON_MEMO``) with CUDA events around
ITERS calls queued back to back, and with the kernels' own device time from
a torch.profiler trace (``*_kernel_ms``): cold (a fresh 2^21-row memo before
each call, its fill timed apart and taken off) and warm (every valid lane hits),
on a 4,096-state chunk's worklist: canon_tiered on the depth-9 five-server
Raft frontier (the 2-word build) and the depth-14 five-server AddRemove and
depth-12 five-server JointConsensus frontiers (the general build);
canon_memo on the depth-20 Raft.cfg, depth-27 PullRaft and depth-33
KRaft.cfg frontiers (the 2-word build) and the depth-11 four-server
AddRemove and depth-10 four-server JointConsensus frontiers (the general
build), the shapes of ``chip_smoke.py`` phase 3. Every variant's
fingerprints, memo and hit counts must equal the plain version's. Prints
one JSON line per variant and build, with the occupancy each reaches
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the card's name and
power limit, and writes them to ``--out``.

With ``--slot``: csrc/slot_canon.cu built with ``-DSC_G=g -DSC_GS=gs
-DSC_MINB=b`` (a tile of g threads a row, its sigmas split over sub-tiles
of gs, b resident blocks an SM asked of ptxas) for each of SLOT_PAIRS, its
registers and stack printed, timed the same way through
``SlotCanonicalizer.fingerprints`` on a 4,096-state chunk's worklist of the
depth-11 KRaftWithReconfig frontier (the full cfg, 12 pairs), each
variant's fingerprints equal to the plain version's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
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
MEMO_PAIRS = ((4, 4), (8, 8), (16, 16), (32, 32))
# slot_canon's (tile, sub-tile, resident blocks an SM asked of ptxas)
SLOT_PAIRS = ((32, 32, 1), (32, 16, 1), (32, 8, 1), (16, 16, 1), (16, 8, 1), (8, 8, 1),
              (8, 4, 1), (32, 16, 4), (32, 8, 4), (16, 16, 4), (16, 8, 4), (16, 8, 5),
              (16, 4, 4), (8, 4, 4))
ITERS = 50
PTXAS = {}  # each library's ptxas figures: the most registers and stack of its kernels
OUT_DIR = os.path.join(ROOT, "build", "canon_groups")


def build(kernel, pairs) -> dict:
    """One library of ``kernel``'s source per (2-word tile, general tile),
    or slot_canon's (tile, sub-tile, blocks an SM), compiled in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    base = kernel.compile_cmd()
    procs = {}
    names = {"canon_memo": ("CM_G2", "CM_GGEN"), "canon_tiered": ("CT_G2", "CT_GGEN"),
             "slot_canon": ("SC_G", "SC_GS", "SC_MINB")}[kernel.unit]
    for key in pairs:
        so = os.path.join(OUT_DIR, f"lib{kernel.unit}_{'_'.join(map(str, key))}.so")
        cmd = [a for a in base]
        cmd[cmd.index("-o") + 1] = so
        cmd[1:1] = [f"-D{n}={x}" for n, x in zip(names, key)]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        stack = re.findall(r"(\d+) bytes stack frame", out)
        PTXAS[key] = dict(registers=int(max(regs, key=int)) if regs else None,
                          stack=int(max(stack, key=int)) if stack else None)
        lib = ctypes.CDLL(so)
        for fn, args in kernels._SIGNATURES[kernel.unit].items():
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


def kernel_ms(fn, names, setup=None, calls=20) -> float:
    """Mean device ms a call of the kernels named ``names`` (the canon and
    its memo insert) in a torch.profiler trace of ``calls`` calls: the
    card's own time, which a call queued behind the wrapper's host work
    hides from device_ms where the kernel is shorter than that work."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if any(n in e.key for n in names))
    return us / 1e3 / calls


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


def slot_lines(smi) -> list:
    """slot_canon's variants on the KRaftWithReconfig chunk."""
    kernel = kernels.SLOT_CANON
    libs = build(kernel, SLOT_PAIRS)
    _, b, _ = run_check("KRaftWithReconfig.cfg", text=cs.KRAFT_RECONFIG_CFG, device="cuda",
                        chunk=cs.CHUNK, max_depth=cs.KRECONFIG_SAMPLE_DEPTH, lenient=True,
                        caps=cs.KRECONFIG_CAPS)
    canon, (rows, valid) = b.canon, chunk(b)
    del b
    want = torch.where(valid, canon.fingerprints_plain(rows), INT64_MAX)
    lines = []
    for (g, gs, minb), lib in libs.items():
        kernel._lib = lib
        fn = lambda: canon.fingerprints(rows, valid)  # noqa: E731
        line = dict(chunk="kreconfig", kernel=kernel.unit, G=g, sub_tile=gs, min_blocks=minb,
                    ptxas=PTXAS[(g, gs, minb)], lanes=rows.shape[0],
                    valid=int(valid.sum()), pairs=canon.P, exact=torch.equal(fn(), want),
                    ms=device_ms(fn), kernel_ms=kernel_ms(fn, ("slot_canon_kernel",)),
                    occupancy=canon.occupancy(rows.device), card=smi)
        print(json.dumps(line), flush=True)
        lines.append(line)
    kernel._lib = None
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--memo", action="store_true", help="canon_memo's variants")
    ap.add_argument("--slot", action="store_true", help="slot_canon's variants")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("canon_groups.py needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi()
    if args.slot:
        return write_lines(slot_lines(smi), args.out)
    kernel = kernels.CANON_MEMO if args.memo else kernels.CANON_TIERED
    libs = build(kernel, MEMO_PAIRS if args.memo else PAIRS)
    runs = ((("raft", "Raft.cfg", dict(text=cs.RAFT_CFG, max_depth=20)),
             ("pull", "PullRaft.cfg", dict(text=cs.PULL_CFG, max_depth=cs.PULL_SAMPLE_DEPTH,
                                           lenient=True)),
             ("kraft", "KRaft.cfg", dict(text=cs.KRAFT_CFG, max_depth=cs.KRAFT_SAMPLE_DEPTH)),
             ("addremove4", "RaftWithReconfigAddRemove.cfg",
              dict(text=cs.ADDREMOVE_CFG, max_depth=cs.RECONFIG_SAMPLE_DEPTH, lenient=True,
                   caps=cs.RECONFIG_CAPS)),
             ("joint4", "RaftWithReconfigJointConsensus.cfg",
              dict(text=cs.JOINT_CFG, max_depth=cs.JOINT_SAMPLE_DEPTH, caps=cs.JOINT_CAPS)))
            if args.memo else
            (("raft5", "Raft.cfg", dict(text=cs.RAFT5_CFG, msg_slots=cs.RAFT5_SLOTS,
                                        max_depth=cs.RAFT5_SAMPLE_DEPTH, caps=cs.RAFT5_CAPS)),
             ("addremove5", "RaftWithReconfigAddRemove.cfg",
              dict(text=cs.ADDREMOVE5_CFG, max_depth=cs.ADDREMOVE5_SAMPLE_DEPTH, lenient=True,
                   caps=cs.RECONFIG_CAPS)),
             ("joint5", "RaftWithReconfigJointConsensus.cfg",
              dict(text=cs.JOINT5_CFG, max_depth=cs.JOINT5_SAMPLE_DEPTH, caps=cs.JOINT_CAPS))))
    chunks = {}
    for tag, cfg, kw in runs:
        _, b, _ = run_check(cfg, device="cuda", chunk=cs.CHUNK, **kw)
        chunks[tag] = (b.canon, *chunk(b))
        del b
    lines = []
    for tag, (canon, rows, valid) in chunks.items():
        memo = torch.full((1 << 21, 2), INT64_MAX, dtype=torch.int64, device=rows.device)
        mp = memo.clone()
        want = [canon.fingerprints_memo_plain(rows, valid, mp) for _ in range(2)]
        general = canon.memo_general() if args.memo else canon.tier_general()
        for (g2, gg), lib in libs.items():
            kernel._lib = lib
            memo.fill_(INT64_MAX)
            got = [canon.fingerprints_memo_cuda(rows, valid, memo) for _ in range(2)]
            exact = all(torch.equal(f, wf) and int(h) == int(wh)
                        for (f, h), (wf, wh) in zip(got, want)) and torch.equal(memo, mp)
            fn = lambda: canon.fingerprints_memo_cuda(rows, valid, memo)  # noqa: E731
            reset = lambda: memo.fill_(INT64_MAX)  # noqa: E731
            names = (("canon_memo_kernel", "memo_insert_kernel") if args.memo else
                     ("canon_tiered_kernel", "ct_memo_insert"))
            cold = device_ms(fn, setup=reset)
            cold_k = kernel_ms(fn, names, setup=reset)
            fn()
            line = dict(chunk=tag, kernel=kernel.unit, build="general" if general else "2-word",
                        G=gg if general else g2, lanes=rows.shape[0],
                        valid=int(valid.sum()), cold_ms=cold, warm_ms=device_ms(fn),
                        cold_kernel_ms=cold_k, warm_kernel_ms=kernel_ms(fn, names),
                        exact=exact, occupancy=canon.occupancy(rows.device), card=smi)
            print(json.dumps(line), flush=True)
            lines.append(line)
    kernel._lib = None
    return write_lines(lines, args.out)


def write_lines(lines, out) -> int:
    """Write the JSON lines to ``out`` (if given); 1 unless every variant
    was exact."""
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0 if all(x["exact"] for x in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
