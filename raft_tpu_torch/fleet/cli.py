"""``raft_tpu_torch sweep MANIFEST.json`` — the fleet-checking subcommand
(``raft_tpu/fleet/cli.py``).

Exit code is the WORST job rc (0 clean, 2 violation), with 64 for usage
and manifest errors, 66 for a missing manifest and 5 for an unrecoverable
failure (no CUDA device, a capacity overflow); options the port does
not have yet (the host and sharded engines, sweep state and resume,
supervision, telemetry) exit 64 too. Under ``--json`` stdout carries one
summary object per job, then one fleet aggregate object (amortization
included); everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

from .driver import SweepOptions, run_sweep
from .manifest import ManifestError, parse_manifest

# the reference's options whose modules the port lacks, and what they wait for
UNPORTED_OPTIONS = {
    "state_dir": ("--state-dir", "3"), "resume": ("--resume", "3"),
    "supervise": ("--supervise", "3"), "metrics_out": ("--metrics-out", "4"),
    "metrics_every": ("--metrics-every", "4"),
}


def sweep_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="raft_tpu_torch sweep",
        description="run every job of a sweep manifest, packing layout-compatible "
        "configs into one model")
    ap.add_argument("manifest", help="sweep manifest (JSON; see README 'Fleet checking' "
                    "for the grammar)")
    ap.add_argument(
        "--engine", default="tpu", choices=["host", "tpu", "sharded"],
        help="tpu = the device queue arm (DeviceBFS, one model per group), the "
        "port's only engine; host and sharded are not ported")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (hand-written kernels, the default) or cpu (their "
                    "plain PyTorch versions)")
    ap.add_argument("--jobs", default=None, metavar="GLOB",
                    help="fnmatch filter on job names (e.g. 'Raft-*ME=1*')")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--time-budget", type=float, default=None,
                    help="per-run seconds budget (each job run)")
    ap.add_argument("--chunk", type=int, default=1024, help="frontier states per chunk")
    ap.add_argument("--state-dir", default=None, metavar="DIR", help="not ported")
    ap.add_argument("--resume", action="store_true", help="not ported")
    ap.add_argument("--supervise", nargs="?", const=5, default=None, type=int,
                    metavar="N", help="not ported")
    ap.add_argument("--metrics-out", default=None, metavar="PATH", help="not ported")
    ap.add_argument("--metrics-every", type=int, default=None, metavar="N",
                    help="not ported")
    ap.add_argument("--json", action="store_true",
                    help="stdout: one summary object per job, then the fleet "
                    "aggregate object")
    ap.add_argument("--verbose", "-v", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 64

    if args.resume and not args.state_dir:
        print("error: --resume needs --state-dir", file=sys.stderr)
        return 64
    for attr, (flag, item) in UNPORTED_OPTIONS.items():
        if getattr(args, attr) not in (None, False):
            print(f"error: {flag} is not ported to raft_tpu_torch (ROADMAP.md Queue 1 "
                  f"item {item})", file=sys.stderr)
            return 64

    try:
        mf = parse_manifest(args.manifest)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 66
    except ManifestError as e:
        print(f"manifest error: {e}", file=sys.stderr)
        return 64

    opts = SweepOptions(engine=args.engine, device=args.device, jobs_glob=args.jobs,
                        max_depth=args.max_depth, time_budget_s=args.time_budget,
                        chunk=args.chunk, verbose=args.verbose)

    from ..utils.cfg import CfgError

    try:
        res = run_sweep(mf, opts)
    except (ManifestError, CfgError) as e:
        print(f"sweep error: {e}", file=sys.stderr)
        return 64
    except (RuntimeError, OverflowError) as e:  # no CUDA device, a capacity overflow, a kernel failure
        print(f"error: {e}", file=sys.stderr)
        return 5

    for j in res.jobs:
        if args.json:
            print(json.dumps(j.to_json()))
            continue
        bits = [f"job={j.name}", f"rc={j.rc}"]
        if j.mode == "check":
            bits += [f"distinct={j.distinct}", f"total={j.total}", f"depth={j.depth}",
                     f"terminal={j.terminal}"]
            if j.violation:
                bits.append(f"VIOLATED={j.violation['invariant']}")
            if j.exit_cause:
                bits.append(f"exit={j.exit_cause}")
        else:
            bits += [f"behaviors={j.behaviors}", f"steps={j.steps}"]
            if j.violation:
                bits.append(f"VIOLATED={j.violation['invariant']}")
        print(" ".join(bits))
    am = res.amortization
    if args.json:
        print(json.dumps(res.to_json()))
    else:
        print(f"fleet: jobs={am['jobs']} groups={am['groups']} "
              f"precompiles={am['precompiles']} time={res.seconds:.2f}s rc={res.rc}")
    return res.rc
