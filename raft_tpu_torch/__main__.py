"""CLI — the `tlc` replacement, PyTorch/CUDA port.

    python -m raft_tpu_torch path/to/Raft.cfg [--device cuda|cpu] ...
    python -m raft_tpu_torch path/to/FlexibleRaft.cfg --simulate N [--sim-walks R]
    python -m raft_tpu_torch path/to/PullRaft.cfg --lenient [--simulate N]
    python -m raft_tpu_torch path/to/KRaft.cfg [--simulate N]

Runs the device BFS on ``cuda`` (the default; ``--device cpu`` runs the
plain PyTorch versions of the kernels instead). ``-deadlock`` semantics
are the default: terminal states are reported, not errors. ``--simulate
N`` runs N random behaviors instead (TLC's ``-simulate``). A cfg's
PROPERTY lines are checked after a clean exhaustive BFS on the full
state graph (symmetry off); configurations that cannot be checked are
refused.

Exit codes (the reference's contract, raft_tpu/__main__.py:10-24):

    0   clean run, no violations
    2   invariant or temporal property violation found (the trace is printed)
    5   unrecoverable failure (capacity overflow, no CUDA device)
    64  usage/config error (bad flags, bad cfg, spec not yet ported,
        PROPERTY checking refused)
    66  input file not found
"""

from __future__ import annotations

import argparse
import json
import sys


def load_setup(cfg_path: str, text: str | None = None, spec: str | None = None,
               msg_slots: int | None = None, lenient: bool = False):
    """Parse a cfg (``text`` overrides reading ``cfg_path``) and build its
    model: the ``CheckSetup``."""
    from .models.registry import build_from_cfg
    from .utils.cfg import parse_cfg

    cfg = parse_cfg(cfg_path, text=text, lenient=lenient)
    for diag in cfg.diagnostics:
        print(f"config warning: {diag}", file=sys.stderr)
    n = len(cfg.diagnostics)
    setup = build_from_cfg(cfg, spec=spec, msg_slots=msg_slots)
    for diag in cfg.diagnostics[n:]:  # repairs made while building (AddRemove's MaxClusterSize)
        print(f"config warning: {diag}", file=sys.stderr)
    return setup


def _bfs(setup, device=None, chunk: int = 4096, max_depth: int | None = None,
         time_budget_s: float | None = None, symmetry: bool = True,
         verbose: bool = False, caps=None):
    from .checker.device_bfs import DeviceBFS

    checker = DeviceBFS(setup.model, invariants=setup.invariants,
                        symmetry=setup.symmetry and symmetry, chunk=chunk, device=device,
                        **(caps or {}))
    return checker, checker.run(max_depth=max_depth, verbose=verbose,
                                time_budget_s=time_budget_s)


def run_check(cfg_path: str, text: str | None = None, device=None,
              chunk: int = 4096, msg_slots: int | None = None,
              max_depth: int | None = None, time_budget_s: float | None = None,
              spec: str | None = None, symmetry: bool = True,
              lenient: bool = False, verbose: bool = False, caps=None):
    """Parse a cfg, build the model and run the device BFS. Returns
    (setup, checker, result)."""
    setup = load_setup(cfg_path, text, spec, msg_slots, lenient)
    checker, res = _bfs(setup, device, chunk, max_depth, time_budget_s, symmetry, verbose,
                        caps)
    return setup, checker, res


def _sim(setup, device=None, walks: int = 128, max_behavior_depth: int = 50, seed: int = 0,
         max_behaviors: int | None = None, max_steps: int | None = None,
         verbose: bool = False):
    from .checker.simulate import Simulator

    sim = Simulator(setup.model, invariants=setup.invariants, walks=walks,
                    max_behavior_depth=max_behavior_depth, seed=seed, device=device)
    return sim, sim.run(max_steps=max_steps, max_behaviors=max_behaviors, verbose=verbose)


def run_simulate(cfg_path: str, text: str | None = None, device=None,
                 msg_slots: int | None = None, walks: int = 128,
                 max_behavior_depth: int = 50, seed: int = 0,
                 max_steps: int | None = None, lenient: bool = False):
    """Parse a cfg, build the model and run simulation mode (``walks``
    random walks in lock-step, ``max_steps`` transitions in all). Returns
    (setup, simulator, result)."""
    setup = load_setup(cfg_path, text, msg_slots=msg_slots, lenient=lenient)
    sim, res = _sim(setup, device, walks, max_behavior_depth, seed, max_steps=max_steps)
    return setup, sim, res


def _live(setup, device=None, chunk: int = 4096, verbose: bool = False):
    from .checker.liveness import LivenessChecker

    checker = LivenessChecker(setup.model, setup.properties, chunk=chunk, device=device)
    return checker, checker.run(verbose=verbose)


def run_liveness(cfg_path: str, text: str | None = None, device=None, chunk: int = 4096,
                 msg_slots: int | None = None, lenient: bool = False):
    """Parse a cfg, build the model and check its PROPERTY lines on the
    full state graph (symmetry off). Returns (setup, checker, result)."""
    setup = load_setup(cfg_path, text, msg_slots=msg_slots, lenient=lenient)
    checker, res = _live(setup, device, chunk)
    return setup, checker, res


def _print_trace(trace, setup, args, violated: str | None) -> None:
    from .utils.pprint import format_trace, format_trace_tlc

    if args.trace_format == "tlc":
        print(format_trace_tlc(trace, setup, violated))
    else:
        print(format_trace(trace, setup))


def _refuse_properties(setup, args) -> str | None:
    """The reference's refusals of PROPERTY lines it cannot check
    (raft_tpu/__main__.py:316-344): the message, or None."""
    props = setup.properties
    supported = getattr(setup.model, "liveness", {})
    unknown = [p for p in props if p not in supported]
    if unknown:
        return (f"error: PROPERTY {' '.join(unknown)}: no liveness support for spec "
                f"{setup.model.name}; remove the PROPERTY line or use a supported formula "
                f"(supported: {', '.join(supported) or 'none'})")
    if args.simulate is not None:
        return ("error: PROPERTY checking needs the exhaustive device graph; run with no "
                "--simulate")
    if args.max_depth is not None or args.time_budget is not None:
        return ("error: PROPERTY checking is unsound on a partially explored graph; drop "
                "--max-depth/--time-budget")
    return None


def _simulate(setup, args) -> int:
    _, res = _sim(setup, args.device, args.sim_walks, args.sim_depth, args.seed,
                  max_behaviors=args.simulate, verbose=args.verbose)
    print(f"simulate: behaviors={res.behaviors} steps={res.steps} "
          f"time={res.seconds:.2f}s ({res.states_per_sec:.0f} states/s)")
    if res.violation:
        print(f"INVARIANT {res.violation.invariant} VIOLATED "
              f"(walk {res.violation.walk}, depth {res.violation.depth})")
        if res.trace:
            _print_trace(res.trace, setup, args, res.violation.invariant)
        return 2
    print("no invariant violations (simulation is not exhaustive)")
    return 0


def _liveness(setup, args) -> int:
    from .utils.pprint import format_lasso

    props = setup.properties
    _, live = _live(setup, args.device, args.chunk, verbose=args.verbose)
    print(f"liveness: graph {live.distinct} states / {live.total_edges} edges "
          f"(symmetry off), properties={list(props)}, {live.seconds:.2f}s")
    if live.violation:
        v = live.violation
        kind = "terminal stutter" if v.terminal else "cycle"
        print(f"PROPERTY {v.prop}[{v.instance}] VIOLATED ({kind}; prefix "
              f"{len(v.prefix) - 1} steps, loop {len(v.cycle)} steps)")
        print(format_lasso(v, setup, tlc=args.trace_format == "tlc"))
        return 2
    print("no temporal property violations")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raft_tpu_torch")
    ap.add_argument("cfg", help="TLC .cfg file (the spec is inferred from its name)")
    ap.add_argument("--spec", help="spec/module name override")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (hand-written kernels, the default) or cpu "
                    "(their plain PyTorch versions)")
    ap.add_argument("--chunk", type=int, default=4096, help="frontier states per chunk")
    ap.add_argument("--msg-slots", type=int, default=None,
                    help="message-bag slot count (default 48; 64 for the pull specs, "
                    "80 for KRaft)")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--time-budget", type=float, default=None,
                    help="stop (non-exhausted) after this many seconds")
    for cap in ("frontier", "seen", "journal"):
        ap.add_argument(f"--{cap}-cap", type=int, default=None)
        ap.add_argument(f"--max-{cap}-cap", type=int, default=None)
    ap.add_argument("--simulate", type=int, default=None, metavar="N",
                    help="simulation mode (TLC -simulate): run N random behaviors "
                    "instead of exhaustive BFS")
    ap.add_argument("--sim-depth", type=int, default=50,
                    help="max behavior length in simulation mode")
    ap.add_argument("--sim-walks", type=int, default=128,
                    help="parallel walks per device batch in simulation mode")
    ap.add_argument("--seed", type=int, default=0)
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
        setup = load_setup(args.cfg, spec=args.spec, msg_slots=args.msg_slots,
                           lenient=args.lenient)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 66
    except (CfgError, ValueError, NotImplementedError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 64
    print(f"spec={setup.model.name} servers={setup.server_names} "
          f"values={setup.value_names} invariants={list(setup.invariants)} "
          f"properties={list(setup.properties)} device={args.device}", file=sys.stderr)
    if setup.properties:
        refusal = _refuse_properties(setup, args)
        if refusal:
            print(refusal, file=sys.stderr)
            return 64

    try:
        if args.simulate is not None:
            return _simulate(setup, args)
        checker, res = _bfs(setup, device=args.device, chunk=args.chunk,
                            max_depth=args.max_depth, time_budget_s=args.time_budget,
                            symmetry=not args.no_symmetry, verbose=args.verbose, caps=caps)
        print(f"distinct={res.distinct} total={res.total} depth={res.depth} "
              f"terminal={res.terminal} time={res.seconds:.2f}s "
              f"({res.states_per_sec:.0f} distinct/s)")
        rc = 0
        if res.violation is not None:
            print(f"INVARIANT {res.violation.invariant} VIOLATED "
                  f"(depth {res.violation.depth})")
            if res.trace:
                _print_trace(res.trace, setup, args, res.violation.invariant)
            rc = 2
        else:
            print("no invariant violations")
        if rc == 0 and setup.properties:
            rc = _liveness(setup, args)
        if args.json:
            print(json.dumps({
                "distinct": res.distinct, "total": res.total, "depth": res.depth,
                "terminal": res.terminal, "seconds": res.seconds,
                "exhausted": res.exhausted, "exit_cause": res.exit_cause,
                "violation": res.violation.invariant if res.violation else None,
                "device": str(checker.device),
            }))
        return rc
    except (KeyError, ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 64
    except (CapacityOverflow, OverflowError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 5
    except RuntimeError as e:  # no CUDA device, kernel build or launch failure
        print(f"error: {e}", file=sys.stderr)
        return 5


if __name__ == "__main__":
    sys.exit(main())
