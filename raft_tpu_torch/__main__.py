"""CLI — the `tlc` replacement, PyTorch/CUDA port.

    python -m raft_tpu_torch path/to/Raft.cfg [--device cuda|cpu] ...

Runs the device BFS on ``cuda`` (the default; ``--device cpu`` runs the
plain PyTorch versions of the kernels instead). ``-deadlock`` semantics
are the default: terminal states are reported, not errors.

Exit codes (the reference's contract, raft_tpu/__main__.py:10-24):

    0   clean run, no violations
    2   invariant violation found (the trace is printed)
    5   unrecoverable failure (capacity overflow, no CUDA device)
    64  usage/config error (bad flags, bad cfg, spec not yet ported)
    66  input file not found
"""

from __future__ import annotations

import argparse
import json
import sys


def run_check(cfg_path: str, text: str | None = None, device=None,
              chunk: int = 4096, msg_slots: int | None = None,
              max_depth: int | None = None, time_budget_s: float | None = None,
              spec: str | None = None, symmetry: bool = True,
              lenient: bool = False, verbose: bool = False, caps=None):
    """Parse a cfg (``text`` overrides reading ``cfg_path``), build the
    model and run the device BFS. Returns (setup, checker, result)."""
    from .checker.device_bfs import DeviceBFS
    from .models.registry import build_from_cfg
    from .utils.cfg import parse_cfg

    cfg = parse_cfg(cfg_path, text=text, lenient=lenient)
    for diag in cfg.diagnostics:
        print(f"config warning: {diag}", file=sys.stderr)
    setup = build_from_cfg(cfg, spec=spec, msg_slots=msg_slots)
    checker = DeviceBFS(
        setup.model,
        invariants=setup.invariants,
        symmetry=setup.symmetry and symmetry,
        chunk=chunk,
        device=device,
        **(caps or {}),
    )
    res = checker.run(max_depth=max_depth, verbose=verbose,
                      time_budget_s=time_budget_s)
    return setup, checker, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raft_tpu_torch")
    ap.add_argument("cfg", help="TLC .cfg file (the spec is inferred from its name)")
    ap.add_argument("--spec", help="spec/module name override")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (hand-written kernels, the default) or cpu "
                    "(their plain PyTorch versions)")
    ap.add_argument("--chunk", type=int, default=4096, help="frontier states per chunk")
    ap.add_argument("--msg-slots", type=int, default=None,
                    help="message-bag slot count (default 48)")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--time-budget", type=float, default=None,
                    help="stop (non-exhausted) after this many seconds")
    for cap in ("frontier", "seen", "journal"):
        ap.add_argument(f"--{cap}-cap", type=int, default=None)
        ap.add_argument(f"--max-{cap}-cap", type=int, default=None)
    ap.add_argument("--no-symmetry", action="store_true", help="ignore SYMMETRY")
    ap.add_argument("--trace-format", default="default", choices=["default", "tlc"])
    ap.add_argument("--lenient", action="store_true",
                    help="repair recoverable cfg bugs instead of failing")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON summary as the last stdout line")
    ap.add_argument("--verbose", "-v", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 64

    from .checker.device_bfs import CapacityOverflow
    from .utils.cfg import CfgError

    caps = {
        k: v for k in ("frontier_cap", "seen_cap", "journal_cap",
                       "max_frontier_cap", "max_seen_cap", "max_journal_cap")
        if (v := getattr(args, k)) is not None
    }
    try:
        setup, checker, res = run_check(
            args.cfg, device=args.device, chunk=args.chunk,
            msg_slots=args.msg_slots, max_depth=args.max_depth,
            time_budget_s=args.time_budget, spec=args.spec,
            symmetry=not args.no_symmetry, lenient=args.lenient,
            verbose=args.verbose, caps=caps,
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 66
    except (CfgError, ValueError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 64
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 64
    except CapacityOverflow as e:
        print(f"error: {e}", file=sys.stderr)
        return 5
    except RuntimeError as e:  # no CUDA device, kernel build or launch failure
        print(f"error: {e}", file=sys.stderr)
        return 5

    print(f"spec={setup.model.name} servers={setup.server_names} "
          f"values={setup.value_names} invariants={list(setup.invariants)} "
          f"device={checker.device}", file=sys.stderr)
    print(f"distinct={res.distinct} total={res.total} depth={res.depth} "
          f"terminal={res.terminal} time={res.seconds:.2f}s "
          f"({res.states_per_sec:.0f} distinct/s)")
    rc = 0
    if res.violation is not None:
        print(f"INVARIANT {res.violation.invariant} VIOLATED (depth {res.violation.depth})")
        if res.trace:
            from .utils.pprint import format_trace, format_trace_tlc

            if args.trace_format == "tlc":
                print(format_trace_tlc(res.trace, setup, res.violation.invariant))
            else:
                print(format_trace(res.trace, setup))
        rc = 2
    else:
        print("no invariant violations")
    if args.json:
        print(json.dumps({
            "distinct": res.distinct, "total": res.total, "depth": res.depth,
            "terminal": res.terminal, "seconds": res.seconds,
            "exhausted": res.exhausted, "exit_cause": res.exit_cause,
            "violation": res.violation.invariant if res.violation else None,
            "device": str(checker.device),
        }))
    return rc


if __name__ == "__main__":
    sys.exit(main())
