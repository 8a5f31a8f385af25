"""CLI — the `tlc` replacement, PyTorch/CUDA port.

    python -m raft_tpu_torch path/to/Raft.cfg [--device cuda|cpu] ...
    python -m raft_tpu_torch path/to/FlexibleRaft.cfg --simulate N [--sim-walks R]
    python -m raft_tpu_torch path/to/PullRaft.cfg --lenient [--simulate N]
    python -m raft_tpu_torch path/to/KRaft.cfg [--simulate N]
    python -m raft_tpu_torch path/to/Raft.cfg --net-faults [--simulate N]
    python -m raft_tpu_torch path/to/Raft.cfg --collision-audit DEPTH --coverage[=strict]
    python -m raft_tpu_torch path/to/Raft.cfg --checker sharded --devices N
    python -m raft_tpu_torch path/to/Raft.cfg --checkpoint run.npz [--resume run.npz]
    python -m raft_tpu_torch sweep MANIFEST.json [--engine tpu] [--device cuda|cpu]

Runs the device BFS on ``cuda`` (the default; ``--device cpu`` runs the
plain PyTorch versions of the kernels instead). ``-deadlock`` semantics
are the default: terminal states are reported, not errors. ``--simulate
N`` runs N random behaviors instead (TLC's ``-simulate``).
``--net-faults`` adds the Raft family's DuplicateMessage and DropMessage
actions. ``--collision-audit DEPTH`` first explores to DEPTH under two
fingerprint hash families and requires identical counts
(``checker/audit.py``); ``--coverage`` prints TLC's per-action table after
the BFS (``obs/coverage.py``). ``sweep`` runs a fleet manifest (``fleet/cli.py``). A cfg's
PROPERTY lines are checked after a clean exhaustive BFS on the full
state graph (symmetry off); configurations that cannot be checked are
refused. ``--checker`` (or ``$CHECKER``) picks the engine: ``tpu``, the
device BFS (the default), or ``sharded``, the frontier-sharded BFS over
``--devices`` shards (one process each: NCCL on the cards, gloo CPU
processes with ``--device cpu``). ``--checkpoint PATH`` saves a resumable
run (hash-verified, rotated generations) and ``--resume PATH`` continues
one; a sharded checkpoint resumes on another mesh size unless
``--no-reshard``.

Exit codes (the reference's contract, raft_tpu/__main__.py:10-24):

    0   clean run, no violations
    2   invariant or temporal property violation found (the trace is printed)
    3   --coverage=strict: an action never fired
    5   unrecoverable failure (capacity overflow, no CUDA device, no intact
        checkpoint generation)
    64  usage/config error (bad flags, bad cfg, spec or checker not yet
        ported, PROPERTY checking refused, checkpoint spec mismatch)
    66  input file not found (cfg or --resume path)
    70  the fingerprint-collision audit failed
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_setup(cfg_path: str, text: str | None = None, spec: str | None = None,
               msg_slots: int | None = None, lenient: bool = False,
               net_faults: bool = False):
    """Parse a cfg (``text`` overrides reading ``cfg_path``) and build its
    model: the ``CheckSetup`` (``net_faults``: the Raft family's
    network-fault actions)."""
    from .models.registry import build_from_cfg
    from .utils.cfg import parse_cfg

    cfg = parse_cfg(cfg_path, text=text, lenient=lenient)
    for diag in cfg.diagnostics:
        print(f"config warning: {diag}", file=sys.stderr)
    n = len(cfg.diagnostics)
    setup = build_from_cfg(cfg, spec=spec, msg_slots=msg_slots, net_faults=net_faults)
    for diag in cfg.diagnostics[n:]:  # repairs made while building (AddRemove's MaxClusterSize)
        print(f"config warning: {diag}", file=sys.stderr)
    return setup


def _bfs(setup, device=None, chunk: int = 4096, max_depth: int | None = None,
         time_budget_s: float | None = None, symmetry: bool = True,
         verbose: bool = False, caps=None, **ckpt_kw):
    from .checker.device_bfs import DeviceBFS

    checker = DeviceBFS(setup.model, invariants=setup.invariants,
                        symmetry=setup.symmetry and symmetry, chunk=chunk, device=device,
                        **(caps or {}))
    return checker, checker.run(max_depth=max_depth, verbose=verbose,
                                time_budget_s=time_budget_s, **ckpt_kw)


def run_sharded_check(cfg_path: str, devices: int, text: str | None = None, device=None,
                      chunk: int = 4096, msg_slots: int | None = None,
                      max_depth: int | None = None, time_budget_s: float | None = None,
                      spec: str | None = None, symmetry: bool = True, lenient: bool = False,
                      verbose: bool = False, caps=None, net_faults: bool = False,
                      collect_metrics: bool = False, **ckpt_kw):
    """Parse a cfg and run the sharded BFS on ``devices`` shards (one
    process each; ``ckpt_kw``: checkpoint_path, checkpoint_every_s,
    checkpoint_keep, resume, reshard). Returns (setup, rank 0's engine,
    its ShardedResult)."""
    from .parallel.launch import CfgModel, run_sharded

    setup = load_setup(cfg_path, text, spec, msg_slots, lenient, net_faults)
    build = CfgModel(cfg_path, text=text, spec=spec, msg_slots=msg_slots, lenient=lenient,
                     net_faults=net_faults)
    engine, res = run_sharded(
        build, devices, device="cuda" if device is None else device,
        engine_kw=dict(invariants=setup.invariants, symmetry=setup.symmetry and symmetry,
                       chunk=chunk, **(caps or {})),
        run_kw=dict(max_depth=max_depth, verbose=verbose, time_budget_s=time_budget_s,
                    collect_metrics=collect_metrics, **ckpt_kw))
    return setup, engine, res


def run_check(cfg_path: str, text: str | None = None, device=None,
              chunk: int = 4096, msg_slots: int | None = None,
              max_depth: int | None = None, time_budget_s: float | None = None,
              spec: str | None = None, symmetry: bool = True,
              lenient: bool = False, verbose: bool = False, caps=None,
              net_faults: bool = False):
    """Parse a cfg, build the model and run the device BFS. Returns
    (setup, checker, result)."""
    setup = load_setup(cfg_path, text, spec, msg_slots, lenient, net_faults)
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
                 max_steps: int | None = None, lenient: bool = False,
                 net_faults: bool = False):
    """Parse a cfg, build the model and run simulation mode (``walks``
    random walks in lock-step, ``max_steps`` transitions in all). Returns
    (setup, simulator, result)."""
    setup = load_setup(cfg_path, text, msg_slots=msg_slots, lenient=lenient,
                       net_faults=net_faults)
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


def _print_coverage(setup, res, args) -> int:
    """TLC-style per-action coverage table (--coverage); returns the strict
    mode's exit code (3 when an action never fired)."""
    if args.coverage is None:
        return 0
    from .obs import dead_actions, render_coverage_table

    names = getattr(setup.model, "ACTION_NAMES", ())
    print(render_coverage_table(names, res.coverage))
    return 3 if args.coverage == "strict" and dead_actions(names, res.coverage) else 0


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


# the reference's checkers that the port lacks, and the ROADMAP.md Queue 1
# item that brings each
UNPORTED_CHECKERS = {"tpu-host": 2, "oracle": 6}


def _ckpt_ident(setup, args, n_dev) -> str:
    """The checkpoint ident the run will have (for ``--resume``'s check
    before any engine is built)."""
    from .ops.symmetry import Canonicalizer

    symmetry = setup.symmetry and not args.no_symmetry
    canon = Canonicalizer.for_model(setup.model, symmetry=symmetry)
    if args.checker == "sharded":
        from .parallel.sharded import ckpt_ident

        return ckpt_ident(setup.model, canon, setup.invariants, n_dev)
    from .checker.device_bfs import ckpt_ident

    return ckpt_ident(setup.model, canon, setup.invariants)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "sweep":
        # the fleet subcommand: `raft_tpu_torch sweep MANIFEST.json`
        from .fleet.cli import sweep_main

        return sweep_main(argv[1:])
    ap = argparse.ArgumentParser(prog="raft_tpu_torch")
    ap.add_argument("cfg", help="TLC .cfg file (the spec is inferred from its name)")
    ap.add_argument("--spec", help="spec/module name override")
    ap.add_argument(
        "--checker",
        default=os.environ.get("CHECKER", "tpu"),
        choices=["tpu", "sharded", "tpu-host", "oracle"],
        help="backend: tpu (single-device BFS), sharded (multi-chip "
        "frontier-sharded BFS over a device mesh — the `tlc -workers N` "
        "replacement), tpu-host (device expansion + host dedup, the v1 "
        "driver), or oracle (pure-Python reference)",
    )
    ap.add_argument(
        "--devices",
        type=int,
        default=None,
        metavar="N",
        help="mesh size for --checker sharded (default: all visible "
        "cards; with --device cpu, N gloo CPU processes, default 1)",
    )
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
    ap.add_argument(
        "--net-faults",
        action="store_true",
        help="enable the opt-in DuplicateMessage/DropMessage network-"
        "fault actions (Raft.tla:508-523; Raft family only; duplication "
        "bounded to max_msg_copies per record)",
    )
    ap.add_argument("--collision-audit", type=int, default=None, metavar="DEPTH",
                    help="before the main run, explore to DEPTH under two independent "
                    "fingerprint hash families and require identical counts (bounds the "
                    "silent hash-collision risk; exit 70 when they differ)")
    ap.add_argument("--coverage", nargs="?", const="table", choices=["table", "strict"],
                    default=None,
                    help="after the BFS, print a TLC-style per-action coverage table "
                    "(enabled / fired / new distinct states) with a WARNING line per action "
                    "that never fired; --coverage=strict also exits 3 when one never fired")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="periodically save resumable run state (tpu and sharded checkers)")
    ap.add_argument("--checkpoint-every", type=float, default=300.0,
                    metavar="S", help="seconds between checkpoints")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume a run from a --checkpoint file (tpu and sharded checkers)")
    ap.add_argument(
        "--checkpoint-keep",
        type=int,
        default=3,
        metavar="N",
        help="checkpoint generations to rotate (PATH, PATH.gen1, ...); "
        "a torn newest generation falls back to the previous intact one",
    )
    ap.add_argument(
        "--no-reshard",
        action="store_true",
        help="refuse to resume a sharded checkpoint written on a "
        "different mesh size (default: re-route the shards by fp mod D "
        "on load — checkpoints are mesh-portable)",
    )
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

    from .resilience.errors import CapacityOverflow, CheckpointCorrupt, CheckpointMismatch
    from .utils.cfg import CfgError

    if args.checker in UNPORTED_CHECKERS:
        print(f"error: --checker {args.checker} is not ported to raft_tpu_torch "
              f"(ROADMAP.md Queue 1 item {UNPORTED_CHECKERS[args.checker]})", file=sys.stderr)
        return 64
    sharded = args.checker == "sharded"
    if args.devices is not None and not sharded:
        print("error: --devices needs --checker sharded", file=sys.stderr)
        return 64
    n_dev = args.devices
    if sharded:
        from .parallel.route import MAX_OWNERS

        visible = None
        if args.device == "cuda":
            import torch

            visible = torch.cuda.device_count()
        if n_dev is None:
            n_dev = visible if visible else 1
        if n_dev < 1 or n_dev > MAX_OWNERS or (visible is not None and n_dev > visible):
            print(f"error: --devices {n_dev}: a sharded run takes 1 to {MAX_OWNERS} shards"
                  + (f", at most the {visible} visible CUDA cards (--device cpu runs N "
                     "CPU processes)" if visible is not None else ""), file=sys.stderr)
            return 64

    caps = {
        k: v for k in ("frontier_cap", "seen_cap", "journal_cap",
                       "max_frontier_cap", "max_seen_cap", "max_journal_cap")
        if (v := getattr(args, k)) is not None
    }
    try:
        setup = load_setup(args.cfg, spec=args.spec, msg_slots=args.msg_slots,
                           lenient=args.lenient, net_faults=args.net_faults)
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
    if args.simulate is not None and args.coverage is not None:
        print("error: --coverage needs the BFS and no --simulate", file=sys.stderr)
        return 64
    if args.simulate is not None and args.collision_audit is not None:
        print("error: --collision-audit needs the BFS and no --simulate (the audit re-runs "
              "the exhaustive BFS)", file=sys.stderr)
        return 64

    if args.simulate is not None and (args.checkpoint or args.resume):
        print("error: --checkpoint/--resume need the BFS and no --simulate", file=sys.stderr)
        return 64
    if args.resume is not None and args.simulate is None:
        # fail fast, before any device work: the file exists, loads and
        # matches this run's identity
        from .resilience import ckpt as rckpt

        try:
            gen, ck_depth = rckpt.validate_resume(
                args.resume, _ckpt_ident(setup, args, n_dev), keep=args.checkpoint_keep,
                allow_reshard=sharded and not args.no_reshard)
        except FileNotFoundError as e:
            print(f"error: --resume: {e}", file=sys.stderr)
            return 66
        except CheckpointCorrupt as e:
            print(f"error: --resume: {e}", file=sys.stderr)
            for prob in e.problems:
                print(f"  {prob}", file=sys.stderr)
            return 5
        except CheckpointMismatch as e:
            print(f"error: --resume: {e}", file=sys.stderr)
            return 64
        print(f"resume: validated {args.resume} (generation {gen}, depth {ck_depth})",
              file=sys.stderr)
    ckpt_kw = dict(checkpoint_path=args.checkpoint, checkpoint_every_s=args.checkpoint_every,
                   checkpoint_keep=args.checkpoint_keep, resume=args.resume)

    try:
        if args.simulate is not None:
            return _simulate(setup, args)
        if args.collision_audit is not None:
            from .checker.audit import collision_audit

            audit = collision_audit(setup.model, invariants=setup.invariants,
                                    symmetry=setup.symmetry and not args.no_symmetry,
                                    depth=args.collision_audit, chunk=args.chunk,
                                    device=args.device, **caps)
            print(audit, file=sys.stderr)
            if not audit.ok:
                print("error: fingerprint-collision audit failed: counts differ between "
                      "hash families; results would be untrustworthy", file=sys.stderr)
                return 70
        if sharded:
            _, checker, res = run_sharded_check(
                args.cfg, n_dev, device=args.device, chunk=args.chunk, msg_slots=args.msg_slots,
                max_depth=args.max_depth, time_budget_s=args.time_budget, spec=args.spec,
                symmetry=not args.no_symmetry, lenient=args.lenient, verbose=args.verbose,
                caps=caps, net_faults=args.net_faults, reshard=not args.no_reshard, **ckpt_kw)
            viol = res.violation_invariant
            vdepth = res.depth
        else:
            checker, res = _bfs(setup, device=args.device, chunk=args.chunk,
                                max_depth=args.max_depth, time_budget_s=args.time_budget,
                                symmetry=not args.no_symmetry, verbose=args.verbose, caps=caps,
                                **ckpt_kw)
            viol = res.violation.invariant if res.violation else None
            vdepth = res.violation.depth if res.violation else None
        print(f"distinct={res.distinct} total={res.total} depth={res.depth} "
              f"terminal={res.terminal} time={res.seconds:.2f}s "
              f"({res.states_per_sec:.0f} distinct/s)"
              + (f" devices={checker.D}" if sharded else ""))
        rc = 0
        if viol is not None:
            print(f"INVARIANT {viol} VIOLATED (depth {vdepth})")
            if res.trace:
                _print_trace(res.trace, setup, args, viol)
            _print_coverage(setup, res, args)  # the violation's rc 2 outranks the strict gate
            rc = 2
        else:
            print("no invariant violations")
            cov_rc = _print_coverage(setup, res, args)
            if setup.properties:
                rc = _liveness(setup, args)
            rc = rc or cov_rc
        if args.json:
            print(json.dumps({
                "distinct": res.distinct, "total": res.total, "depth": res.depth,
                "terminal": res.terminal, "seconds": res.seconds,
                "exhausted": res.exhausted, "exit_cause": res.exit_cause,
                "violation": viol, "device": str(checker.device),
                **({"devices": checker.D} if sharded else {}),
            }))
        return rc
    except (KeyError, ValueError, NotImplementedError) as e:  # CheckpointMismatch too
        print(f"error: {e}", file=sys.stderr)
        return 64
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 66
    except (CapacityOverflow, OverflowError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 5
    except RuntimeError as e:  # no CUDA device, kernel build or launch failure
        print(f"error: {e}", file=sys.stderr)
        return 5


if __name__ == "__main__":
    sys.exit(main())
