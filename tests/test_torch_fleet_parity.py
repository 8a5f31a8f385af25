"""Every job of a packed fleet run of the port (one fleet-bound model, the
jobs queued through one DeviceBFS on the CPU) against the JAX reference's
dense serial run of the same constants, at tests/test_fleet.py's
STD_DEPTH, for both packable families (the reference's guard-first path is
broken under the installed jax, so its DeviceBFS runs through
``DenseShim``; each of its runs compiles its own program, hence a file of
its own).
"""

import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.fleet.grouping import build_setup as jax_build_setup
from raft_tpu.fleet.manifest import parse_manifest_obj as jax_parse
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.fleet import (
    SweepOptions, build_packed, group_jobs, parse_manifest_obj, run_sweep,
)

from test_expand_sparse import DenseShim
from test_fleet import STD_DEPTH, STD_MANIFEST
from test_torch_fleet import PULL_MANIFEST

# one intra-op thread: tier-1 runs several test workers side by side
torch.set_num_threads(1)

# both lanes vary between the two jobs: one packed group, dyn_consts
# (max_elections, max_restarts)
LANES_MANIFEST = dict(STD_MANIFEST, grid={}, jobs=[
    {"name": "me1-mr0"}, {"name": "me2-mr1", "constants": {"MaxElections": 2, "MaxRestarts": 1}}])


def _reference_serial(obj, depth):
    """The reference's dense DeviceBFS of each job's own constants."""
    out = {}
    mf = jax_parse(obj, "<t>")
    for job in mf.jobs:
        s = jax_build_setup(job, mf.path)
        out[job.name] = JaxDeviceBFS(
            DenseShim(s.model), invariants=s.invariants, symmetry=s.symmetry, chunk=256,
            valid_per_state=32, frontier_cap=1 << 12, seen_cap=1 << 14,
            journal_cap=1 << 14).run(max_depth=depth)
    return out


@pytest.mark.parametrize("which", ["raft", "pull"])
def test_packed_jobs_equal_reference_serial(which):
    """Each job of a packed port run (one DeviceBFS, the jobs queued)
    equals the reference's serial run of its constants at STD_DEPTH:
    counts, depth counts, coverage; the sweep's JobResults agree."""
    obj = LANES_MANIFEST if which == "raft" else PULL_MANIFEST
    mf = parse_manifest_obj(obj, "<t>")
    (g,) = group_jobs(mf)
    assert g.kind == "packed" and len(g.dyn_consts) == (2 if which == "raft" else 1)
    eng = DeviceBFS(build_packed(g), invariants=g.setups[0].invariants,
                    symmetry=g.setups[0].symmetry, chunk=256, frontier_cap=1 << 12,
                    journal_cap=1 << 14, max_seen_cap=1 << 20, canon_memo_cap=1 << 12,
                    device="cpu")
    names = [j.name for j in g.jobs]
    got = eng.run_fleet(job_names=names, max_depth=STD_DEPTH)
    ref = _reference_serial(obj, STD_DEPTH)
    for name, r in zip(names, got):
        s = ref[name]
        assert (r.distinct, r.total, r.depth, r.terminal) == (
            s.distinct, s.total, s.depth, s.terminal), name
        assert r.depth_counts == s.depth_counts and r.coverage == s.coverage, name
    assert got[0].distinct != got[1].distinct  # the lanes really separate the jobs
    res = run_sweep(mf, SweepOptions(device="cpu", max_depth=STD_DEPTH, chunk=256))
    assert res.rc == 0 and res.amortization == {
        "jobs": 2, "groups": 1, "precompiles": 1, "precompile_ratio": 0.5}
    for jr in res.jobs:
        s = ref[jr.name]
        assert (jr.distinct, jr.total, jr.depth, jr.terminal) == (
            s.distinct, s.total, s.depth, s.terminal)
        assert jr.exit_cause == "max_depth"
