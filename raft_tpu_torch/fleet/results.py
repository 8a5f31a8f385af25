"""Fleet results: per-job records and the sweep's amortization
(``raft_tpu/fleet/results.py``).

Per-job exit codes follow the CLI's convention: 0 clean, 2 invariant
violation, 4 preempted, 5 unrecoverable. The fleet's return code is the
WORST job rc, so one red job fails the sweep while the JSON still reports
every job.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def rc_for(exit_cause: str | None, violation) -> int:
    if violation is not None:
        return 2
    if exit_cause == "preempted":
        return 4
    if exit_cause == "unrecoverable":
        return 5
    return 0


@dataclass
class JobResult:
    name: str
    mode: str  # "check" | "simulate"
    rc: int
    seconds: float
    exit_cause: str | None = None
    # check mode
    distinct: int | None = None
    total: int | None = None
    depth: int | None = None
    terminal: int | None = None
    violation: dict | None = None  # {invariant, global_id, depth}
    trace_len: int | None = None
    # simulate mode
    behaviors: int | None = None
    steps: int | None = None

    def to_json(self) -> dict:
        out = {"job": self.name, "mode": self.mode, "rc": self.rc,
               "seconds": round(self.seconds, 3)}
        if self.exit_cause is not None:
            out["exit_cause"] = self.exit_cause
        for k in ("distinct", "total", "depth", "terminal", "trace_len", "behaviors", "steps"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.violation is not None:
            out["violation"] = self.violation
        return out


@dataclass
class FleetResult:
    jobs: list[JobResult] = field(default_factory=list)
    groups: int = 0
    precompiles: int = 0
    seconds: float = 0.0

    @property
    def rc(self) -> int:
        return max((j.rc for j in self.jobs), default=0)

    @property
    def amortization(self) -> dict:
        nj = len(self.jobs)
        return {
            "jobs": nj,
            "groups": self.groups,
            "precompiles": self.precompiles,
            "precompile_ratio": round(self.precompiles / nj, 4) if nj else None,
        }

    def to_json(self) -> dict:
        return {"fleet": True, "rc": self.rc, "seconds": round(self.seconds, 3),
                "amortization": self.amortization, "jobs": [j.to_json() for j in self.jobs]}
