"""Fleet manifest schema and parser (``raft_tpu/fleet/manifest.py``).

A manifest is one JSON object describing a sweep:

    {
      "spec": "Raft",                      // default spec for every job
      "defaults": {
        "constants":  {"Server": ["s1","s2","s3"], "Value": ["v1"],
                       "MaxElections": 1, "MaxRestarts": 1},
        "invariants": ["NoLogDivergence"],
        "symmetry":   true,                // default true
        "msg_slots":  24,                  // default: the spec builder's
        "mode":       "check",             // or "simulate"
        "net_faults": false,               // Raft family only
        "sim": {"walks": 128, "max_behavior_depth": 50, "seed": 0,
                "max_behaviors": null, "max_steps": 100000}
      },
      "grid": {"MaxRestarts": [1,2,3], "MaxElections": [1,2]},
      "jobs": [ {"name": "...", "constants": {...}, ...} ]
    }

``grid`` expands to the cross-product of its value lists in JSON key
order, one job per point, each point overlaid on ``defaults.constants``;
grid jobs are named ``<spec>-K1=v1-K2=v2``. ``jobs`` entries are explicit
single jobs overriding any default field. A manifest needs at least one of
grid/jobs. Every malformed-manifest path raises ManifestError (the CLI's
exit 64). The reference's per-job ``chaos`` field (fault injection) needs
the resilience modules, which are not ported: a manifest that sets it is
refused the same way.

Constant values: ints and booleans pass through; a list of strings is a
TLC model-value set (``Server = {s1, s2, s3}``); a bare string is a single
model value. ``cfg_for_job`` lowers a job to the ``utils.cfg.Cfg`` the
.cfg parser produces, so the registry serves manifests and cfg files
through one code path.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field

from ..utils.cfg import Cfg, ModelValue


class ManifestError(Exception):
    pass


MODES = ("check", "simulate")
SIM_DEFAULTS = {
    "walks": 128,
    "max_behavior_depth": 50,
    "seed": 0,
    "max_behaviors": None,
    # a simulate run loops until a bound trips; a sweep must end, so a
    # step budget is the default (null plus --time-budget overrides it)
    "max_steps": 100_000,
}


@dataclass
class FleetJob:
    name: str
    spec: str
    constants: dict
    invariants: tuple[str, ...] = ()
    symmetry: bool = True
    msg_slots: int | None = None
    mode: str = "check"
    net_faults: bool = False
    sim: dict = field(default_factory=lambda: dict(SIM_DEFAULTS))


@dataclass
class FleetManifest:
    path: str
    jobs: list[FleetJob]


def _req(obj: dict, key: str, path: str):
    if key not in obj:
        raise ManifestError(f"{path}: missing required key {key!r}")
    return obj[key]


def _check_constants(constants, path: str, where: str) -> dict:
    if not isinstance(constants, dict):
        raise ManifestError(f"{path}: {where} constants must be an object")
    for k, v in constants.items():
        ok = isinstance(v, (bool, int, str)) or (
            isinstance(v, list) and v and all(isinstance(x, str) for x in v))
        if not ok:
            raise ManifestError(
                f"{path}: {where} constant {k!r} must be an int, bool, "
                f"string, or non-empty list of strings, got {v!r}")
    return constants


def _job_from(obj: dict, defaults: dict, spec: str, path: str,
              name: str | None = None) -> FleetJob:
    spec = obj.get("spec", spec)
    if not isinstance(spec, str) or not spec:
        raise ManifestError(f"{path}: job spec must be a non-empty string")
    constants = dict(defaults.get("constants", {}))
    constants.update(obj.get("constants", {}))
    _check_constants(constants, path, f"job {name or obj.get('name')}")
    mode = obj.get("mode", defaults.get("mode", "check"))
    if mode not in MODES:
        raise ManifestError(f"{path}: mode must be one of {MODES}, got {mode!r}")
    msg_slots = obj.get("msg_slots", defaults.get("msg_slots"))
    if msg_slots is not None and (
            not isinstance(msg_slots, int) or isinstance(msg_slots, bool) or msg_slots <= 0):
        raise ManifestError(f"{path}: msg_slots must be a positive int")
    invariants = obj.get("invariants", defaults.get("invariants", []))
    if not isinstance(invariants, list) or not all(isinstance(x, str) for x in invariants):
        raise ManifestError(f"{path}: invariants must be a list of strings")
    sim = dict(SIM_DEFAULTS)
    sim.update(defaults.get("sim", {}))
    sim.update(obj.get("sim", {}))
    unknown = set(sim) - set(SIM_DEFAULTS)
    if unknown:
        raise ManifestError(f"{path}: unknown sim keys {sorted(unknown)}")
    if obj.get("chaos", defaults.get("chaos")) is not None:
        raise ManifestError(
            f"{path}: chaos (per-job fault injection) is not ported to raft_tpu_torch: "
            "it needs the resilience and observability modules (ROADMAP.md Queue 1 "
            "items 3 and 4)")
    job_name = obj.get("name", name)
    if not job_name:
        raise ManifestError(f"{path}: explicit jobs need a name")
    return FleetJob(
        name=str(job_name),
        spec=spec,
        constants=constants,
        invariants=tuple(invariants),
        symmetry=bool(obj.get("symmetry", defaults.get("symmetry", True))),
        msg_slots=msg_slots,
        mode=mode,
        net_faults=bool(obj.get("net_faults", defaults.get("net_faults", False))),
        sim=sim,
    )


def parse_manifest_obj(obj, path: str = "<manifest>") -> FleetManifest:
    if not isinstance(obj, dict):
        raise ManifestError(f"{path}: manifest must be a JSON object")
    unknown = set(obj) - {"spec", "defaults", "grid", "jobs"}
    if unknown:
        raise ManifestError(f"{path}: unknown manifest keys {sorted(unknown)}")
    spec = _req(obj, "spec", path)
    if not isinstance(spec, str) or not spec:
        raise ManifestError(f"{path}: spec must be a non-empty string")
    defaults = obj.get("defaults", {})
    if not isinstance(defaults, dict):
        raise ManifestError(f"{path}: defaults must be an object")
    _check_constants(defaults.get("constants", {}), path, "defaults")

    jobs: list[FleetJob] = []
    grid = obj.get("grid", {})
    if grid:
        if not isinstance(grid, dict) or not all(isinstance(v, list) and v
                                                 for v in grid.values()):
            raise ManifestError(f"{path}: grid must map constant names to non-empty lists")
        keys = list(grid)  # JSON key order = sweep order
        for point in itertools.product(*(grid[k] for k in keys)):
            pc = dict(zip(keys, point))
            name = spec + "-" + "-".join(f"{k}={v}" for k, v in pc.items())
            jobs.append(_job_from({"constants": pc}, defaults, spec, path, name=name))
    for jo in obj.get("jobs", []):
        if not isinstance(jo, dict):
            raise ManifestError(f"{path}: jobs entries must be objects")
        jobs.append(_job_from(jo, defaults, spec, path))
    if not jobs:
        raise ManifestError(f"{path}: manifest has no jobs (grid or jobs)")
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ManifestError(f"{path}: duplicate job names {dup}")
    return FleetManifest(path=path, jobs=jobs)


def parse_manifest(path: str) -> FleetManifest:
    with open(path) as fh:
        try:
            obj = json.load(fh)
        except ValueError as e:
            raise ManifestError(f"{path}: not valid JSON ({e})") from e
    return parse_manifest_obj(obj, path=path)


def cfg_for_job(job: FleetJob, manifest_path: str = "<manifest>") -> Cfg:
    """Lower a manifest job to the Cfg the registry builders take: the
    manifest is a programmatic .cfg, one per job."""
    consts: dict = {}
    model_values: list[str] = []
    for k, v in job.constants.items():
        if isinstance(v, list):
            consts[k] = tuple(ModelValue(x) for x in v)
            model_values.extend(v)
        elif isinstance(v, str):
            consts[k] = ModelValue(v)
            model_values.append(v)
        else:
            consts[k] = v
    return Cfg(
        path=f"{manifest_path}#{job.name}",
        constants=consts,
        symmetry="fleet-manifest" if job.symmetry else None,
        invariants=list(job.invariants),
        model_values=model_values,
    )
