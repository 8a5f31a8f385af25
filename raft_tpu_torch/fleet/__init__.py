"""raft_tpu_torch.fleet — the sweep driver: many configs, one engine.

Counterpart of ``raft_tpu/fleet/``: a manifest names N (spec x CONSTANTS)
jobs; ``grouping.py`` buckets them by packed-state-layout compatibility;
each packed group runs as ONE fleet-bound model through one ``DeviceBFS``
(the queue arm, ``DeviceBFS.run_fleet``: the jobs back to back through the
same kernels), serial groups share one model, simulate groups run the
port's ``Simulator``. The CLI subcommand is ``raft_tpu_torch sweep
MANIFEST.json``.

    from raft_tpu_torch.fleet import parse_manifest, run_sweep, SweepOptions
    res = run_sweep(parse_manifest("sweep.json"), SweepOptions(device="cuda"))
    print(res.rc, res.amortization)

The reference's host engine (co-resident packed frontier) and sharded
engine, and its sweep state, resume, supervision, chaos and telemetry,
are not ported: the port refuses them (usage error).
"""

from .driver import SweepOptions, run_sweep
from .grouping import FLEET_DYN, FleetGroup, group_jobs
from .manifest import (
    FleetJob,
    FleetManifest,
    ManifestError,
    cfg_for_job,
    parse_manifest,
    parse_manifest_obj,
)
from .packer import build_packed
from .results import FleetResult, JobResult

__all__ = [
    "FLEET_DYN",
    "FleetGroup",
    "FleetJob",
    "FleetManifest",
    "FleetResult",
    "JobResult",
    "ManifestError",
    "SweepOptions",
    "build_packed",
    "cfg_for_job",
    "group_jobs",
    "parse_manifest",
    "parse_manifest_obj",
    "run_sweep",
]
