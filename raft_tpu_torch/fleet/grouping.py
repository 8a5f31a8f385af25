"""Layout-compatibility grouping: which jobs can share one model
(``raft_tpu/fleet/grouping.py``).

Two check jobs can share one fleet-bound model exactly when every
parameter that shapes the model agrees. For the Raft and pull families
the dynamic CONSTANTS (FLEET_DYN) only feed guard comparisons and the
message packer's term width, so the group key is the params dataclass
with the dynamic fields zeroed PLUS ``bits_for(max_term)``: MaxElections 1
and 2 both need 2 term bits and land in one group; MaxElections 4 widens
the packer and splits off. Everything else that shapes the model (spec
class, variant knobs, msg_slots, server/value names, invariant set,
symmetry) is in the key verbatim, so a mismatch yields another group.

Group kinds:

- ``packed``   check jobs of a FLEET_DYN family: one fleet-bound model
  (``packer.build_packed``), its jobs queued through one ``DeviceBFS``;
- ``serial``   check jobs outside FLEET_DYN: the key is the FULL params,
  so the group's jobs share one model, run back to back;
- ``simulate`` simulate-mode jobs, grouped by full params the same way.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..models.registry import CheckSetup, build_from_cfg
from ..ops.packing import bits_for
from .manifest import FleetJob, FleetManifest, cfg_for_job

# Params classes whose lowering reads per-state dynamic constants (guards
# through FleetConstMixin._cv), with the params field of each packable
# CONSTANT; the order is the lane order.
FLEET_DYN = {
    "RaftParams": ("max_elections", "max_restarts"),
    "PullRaftParams": ("max_elections", "max_restarts"),
}


@dataclass
class FleetGroup:
    kind: str  # "packed" | "serial" | "simulate"
    jobs: list[FleetJob]
    setups: list[CheckSetup]
    # the dynamic constants that VARY across the group, in FLEET_DYN order;
    # () when all jobs agree (the fleet_job lane alone separates them)
    dyn_consts: tuple[str, ...] = ()
    # [J, len(dyn_consts)] per-job values, manifest job order
    table: np.ndarray | None = None


def build_setup(job: FleetJob, manifest_path: str = "<manifest>") -> CheckSetup:
    """One job -> one CheckSetup through the registry (a CfgError on a bad
    spec or constants propagates; the CLI maps it to exit 64)."""
    cfg = cfg_for_job(job, manifest_path)
    return build_from_cfg(cfg, spec=job.spec, msg_slots=job.msg_slots,
                          net_faults=job.net_faults)


def _group_key(job: FleetJob, setup: CheckSetup):
    p = setup.model.p
    cls = type(p).__name__
    common = (cls, type(setup.model).__name__, setup.model.name, setup.invariants,
              setup.symmetry, tuple(setup.server_names), tuple(setup.value_names))
    if job.mode == "simulate":
        return ("simulate", p) + common
    dyn = FLEET_DYN.get(cls)
    if dyn is None:
        return ("serial", p) + common
    zeroed = dataclasses.replace(p, **{n: 0 for n in dyn})
    # bits_for(max_term) is the one packer width a dynamic constant feeds:
    # keep it in the key so the zeroing cannot merge message layouts
    return ("packed", zeroed, bits_for(p.max_term)) + common


def group_jobs(manifest: FleetManifest) -> list[FleetGroup]:
    """Bucket manifest jobs into model-sharing groups, preserving manifest
    order across groups (by first member) and within them."""
    buckets: dict = {}
    order: list = []
    for job in manifest.jobs:
        setup = build_setup(job, manifest.path)
        key = _group_key(job, setup)
        if key not in buckets:
            buckets[key] = ([], [])
            order.append(key)
        buckets[key][0].append(job)
        buckets[key][1].append(setup)
    groups: list[FleetGroup] = []
    for key in order:
        jobs, setups = buckets[key]
        if key[0] != "packed":
            groups.append(FleetGroup(kind=key[0], jobs=jobs, setups=setups))
            continue
        dyn_all = FLEET_DYN[type(setups[0].model.p).__name__]
        cols = {n: [int(getattr(s.model.p, n)) for s in setups] for n in dyn_all}
        varying = tuple(n for n in dyn_all if len(set(cols[n])) > 1)
        table = np.array([[cols[n][j] for n in varying] for j in range(len(setups))],
                         dtype=np.int64).reshape(len(setups), len(varying))
        groups.append(FleetGroup(kind="packed", jobs=jobs, setups=setups,
                                 dyn_consts=varying, table=table))
    return groups
