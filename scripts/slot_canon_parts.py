"""Where slot_canon's time goes: the kernel built with one part cut out at a
time, timed on one card on the same chunk.

    python scripts/slot_canon_parts.py

Copies raft_tpu_torch/csrc/ into build/slot_canon_parts/<cut>/ for each cut
of CUTS, patches slot_canon.cuh there (``full``: nothing; ``nobag``: the
occupied keys' remap, rank and hash skipped; ``norank``: the rank loop
skipped, every key at rank 0; ``nosigma``: the lanes that tau leaves alone
skipped), builds each with the kernel's own flags and tiles, one nvcc each,
all at once, and times each through ``SlotCanonicalizer.fingerprints`` on a
4,096-state chunk's worklist of the depth-11 KRaftWithReconfig frontier
(scripts/canon_groups.py's chunk and timers: CUDA events around calls
queued back to back, and the kernel's device time from a torch.profiler
trace). The cut builds compute wrong fingerprints: the differences between
their times and the full build's are the parts' shares. Prints the chunk's
mean occupied bag slots and one JSON line per cut with its registers.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import canon_groups as cg  # noqa: E402
import chip_smoke as cs  # noqa: E402
from raft_tpu_torch import kernels  # noqa: E402
from raft_tpu_torch.__main__ import run_check  # noqa: E402

CUTS = {
    "full": [],
    "nobag": [("      ScKey k = sc_load(v + w0, M, list[i], NW);",
               "      continue; ScKey k = sc_load(v + w0, M, list[i], NW);"),
              ("      const ScKey k = sc_load(buf, M, i, NW);",
               "      continue; const ScKey k = sc_load(buf, M, i, NW);")],
    "norank": [("      for (int u = 0; u < n; ++u) {\n        const ScKey ku = sc_load(buf,",
                "      for (int u = 0; u < 0; ++u) {\n        const ScKey ku = sc_load(buf,")],
    "nosigma": [("    for (int e = t; e < ne; e += G) {\n      const int a = taba[e],",
                 "    for (int e = t; e < 0; e += G) {\n      const int a = taba[e],")],
}
OUT_DIR = os.path.join(ROOT, "build", "slot_canon_parts")


def build() -> dict:
    """{cut: (library, registers)}, compiled in parallel."""
    src = os.path.join(ROOT, "raft_tpu_torch", "csrc")
    base = kernels.SLOT_CANON.compile_cmd()
    procs = {}
    for name, subs in CUTS.items():
        d = os.path.join(OUT_DIR, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        p = os.path.join(d, "slot_canon.cuh")
        s = open(p).read()
        for a, b in subs:
            if a not in s:
                raise RuntimeError(f"cut {name}: slot_canon.cuh no longer holds {a!r}")
            s = s.replace(a, b)
        with open(p, "w") as f:
            f.write(s)
        cmd = list(base)
        so = os.path.join(d, "libslot_canon.so")
        cmd[cmd.index("-o") + 1] = so
        cmd[-1] = os.path.join(d, "slot_canon.cu")
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn, args in kernels._SIGNATURES["slot_canon"].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, [int(r) for r in re.findall(r"Used (\d+) registers", out)])
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("slot_canon_parts.py needs a CUDA card", file=sys.stderr)
        return 1
    libs = build()
    _, b, _ = run_check("KRaftWithReconfig.cfg", text=cs.KRAFT_RECONFIG_CFG, device="cuda",
                        chunk=cs.CHUNK, max_depth=cs.KRECONFIG_SAMPLE_DEPTH, lenient=True,
                        caps=cs.KRECONFIG_CAPS)
    canon, (rows, valid) = b.canon, cg.chunk(b)
    del b
    c = (rows[valid][:, canon.model.layout.sl("msg_w0")] != 1 << 30).sum(1).float()
    print("occupied", float(c.mean()), float(c.max()))
    for name, (lib, regs) in libs.items():
        kernels.SLOT_CANON._lib = lib
        fn = lambda: canon.fingerprints(rows, valid)  # noqa: E731
        print(json.dumps(dict(cut=name, regs=regs, ms=cg.device_ms(fn),
                              kernel_ms=cg.kernel_ms(fn, ("slot_canon_kernel",)),
                              card=cs.nvidia_smi())), flush=True)
    kernels.SLOT_CANON._lib = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
