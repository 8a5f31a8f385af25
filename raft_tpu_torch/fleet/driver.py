"""Sweep driver: manifest -> groups -> engines -> FleetResult
(``raft_tpu/fleet/driver.py``, its device queue arm).

The plan per group kind (grouping.py):

- ``packed``: one fleet-bound model (packer.build_packed) and one
  ``DeviceBFS``; ``DeviceBFS.run_fleet`` runs the jobs back to back
  through it (``fleet_select`` picks the job whose constants the initial
  states carry), so the group builds its kernels' spec once;
- ``serial``: the jobs share the first setup's model (identical params by
  construction) and run back to back;
- ``simulate``: the port's ``Simulator`` per job over the group's model.

Every group runs on ``SweepOptions.device`` (``cuda`` unless the caller
asks for the CPU). The reference's ``host`` (co-resident packed frontier,
``BFSChecker``) and ``sharded`` engines, and its sweep state, resume,
supervision and telemetry, are not ported; ``run_sweep`` refuses them
with a ManifestError (the CLI's usage exit).
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass

from .grouping import group_jobs
from .manifest import FleetManifest, ManifestError
from .packer import build_packed
from .results import FleetResult, JobResult, rc_for

ENGINES = ("host", "tpu", "sharded")
# what an engine the port lacks is waiting for
UNPORTED_ENGINES = {
    "host": "the host engine (BFSChecker) is not ported to raft_tpu_torch "
            "(ROADMAP.md Queue 1 item 2)",
    "sharded": "the sharded engine's fleet arm (run_fleet) is not ported to raft_tpu_torch "
               "(ROADMAP.md Queue 1 item 5)",
}


@dataclass
class SweepOptions:
    # the device engine (DeviceBFS, the reference's "tpu" queue arm): the
    # port's only engine, so its default
    engine: str = "tpu"
    device: str = "cuda"
    jobs_glob: str | None = None  # fnmatch filter on job names
    max_depth: int | None = None
    time_budget_s: float | None = None
    chunk: int = 1024
    verbose: bool = False


def _check_result(name: str, r) -> JobResult:
    """A CheckResult as a JobResult."""
    vd = None
    if r.violation is not None:
        vd = {"invariant": r.violation.invariant, "global_id": int(r.violation.global_id),
              "depth": int(r.violation.depth)}
    return JobResult(
        name=name, mode="check", rc=rc_for(r.exit_cause, vd), seconds=float(r.seconds),
        exit_cause=r.exit_cause, distinct=int(r.distinct), total=int(r.total),
        depth=int(r.depth), terminal=int(r.terminal), violation=vd,
        trace_len=len(r.trace) if r.trace else None)


def _engine(model, setup, opts: SweepOptions):
    from ..checker.device_bfs import DeviceBFS

    return DeviceBFS(model, invariants=setup.invariants, symmetry=setup.symmetry,
                     chunk=opts.chunk, device=opts.device)


def _run_simulate_group(group, opts, out) -> None:
    from ..checker.simulate import Simulator

    model = group.setups[0].model  # identical params: one model
    for job, setup in zip(group.jobs, group.setups):
        sim = Simulator(model, invariants=setup.invariants, walks=int(job.sim["walks"]),
                        max_behavior_depth=int(job.sim["max_behavior_depth"]),
                        seed=int(job.sim["seed"]), device=opts.device)
        r = sim.run(max_steps=job.sim["max_steps"], time_budget_s=opts.time_budget_s,
                    max_behaviors=job.sim["max_behaviors"], verbose=opts.verbose)
        vd = None
        if r.violation:
            vd = {"invariant": r.violation.invariant, "walk": int(r.violation.walk),
                  "depth": int(r.violation.depth)}
        out[job.name] = JobResult(
            name=job.name, mode="simulate", rc=2 if vd else 0, seconds=float(r.seconds),
            behaviors=int(r.behaviors), steps=int(r.steps), violation=vd,
            trace_len=len(r.trace) if r.trace else None)


def _run_serial_group(group, opts, out) -> None:
    model = group.setups[0].model  # identical params: one model
    for job, setup in zip(group.jobs, group.setups):
        r = _engine(model, setup, opts).run(max_depth=opts.max_depth, verbose=opts.verbose,
                                            time_budget_s=opts.time_budget_s)
        out[job.name] = _check_result(job.name, r)


def _run_packed_group(group, opts, out) -> None:
    names = [j.name for j in group.jobs]
    eng = _engine(build_packed(group), group.setups[0], opts)
    results = eng.run_fleet(job_names=names, max_depth=opts.max_depth,
                            verbose=opts.verbose, time_budget_s=opts.time_budget_s)
    for name, r in zip(names, results):
        out[name] = _check_result(name, r)


def run_sweep(manifest: FleetManifest, opts: SweepOptions | None = None) -> FleetResult:
    opts = opts or SweepOptions()
    if opts.engine not in ENGINES:
        raise ManifestError(f"unknown engine {opts.engine!r} (available: {ENGINES})")
    if opts.engine in UNPORTED_ENGINES:
        raise ManifestError(f"--engine {opts.engine}: {UNPORTED_ENGINES[opts.engine]}; "
                            "use --engine tpu (DeviceBFS)")
    jobs = manifest.jobs
    if opts.jobs_glob:
        jobs = [j for j in jobs if fnmatch.fnmatchcase(j.name, opts.jobs_glob)]
        if not jobs:
            raise ManifestError(
                f"{manifest.path}: --jobs {opts.jobs_glob!r} matches none of "
                f"{len(manifest.jobs)} jobs")
    mf = FleetManifest(path=manifest.path, jobs=jobs)
    groups = group_jobs(mf)
    out: dict[str, JobResult] = {}
    t0 = time.perf_counter()
    run = {"simulate": _run_simulate_group, "serial": _run_serial_group,
           "packed": _run_packed_group}
    for gi, group in enumerate(groups):
        if opts.verbose:
            print(f"fleet: group {gi + 1}/{len(groups)} kind={group.kind} "
                  f"jobs={len(group.jobs)} dyn={list(group.dyn_consts)}")
        run[group.kind](group, opts, out)
    # one model (one kernel spec build) per group that ran
    return FleetResult(jobs=[out[j.name] for j in mf.jobs], groups=len(groups),
                       precompiles=len(groups), seconds=time.perf_counter() - t0)
