"""Fleet checking in the port (raft_tpu_torch/fleet/ and the fleet lanes of
models/base.py FleetConstMixin) against the JAX reference's raft_tpu.fleet.

Manifest parsing, grouping and the packed layout must equal the
reference's; the device code's lane reads (csrc/raft_actions.cuh,
pull_actions.cuh, built for the CPU with g++) must equal the reference's
dense expand of its own packed model on rows whose lanes differ from the
static maximum; a packed job's counterexample must be its standalone
run's; the sweep CLI's exit codes follow the reference's. (Each job of a
packed run against the reference's serial run of its constants:
tests/test_torch_fleet_parity.py.)
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from raft_tpu.fleet import cli as jax_cli
from raft_tpu.fleet.grouping import group_jobs as jax_group_jobs
from raft_tpu.fleet.manifest import (
    ManifestError as JaxManifestError, cfg_for_job as jax_cfg_for_job,
    parse_manifest_obj as jax_parse,
)
from raft_tpu.fleet.packer import build_packed as jax_build_packed
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.checker.simulate import Simulator
from raft_tpu_torch.fleet import (
    FLEET_DYN, ManifestError, SweepOptions, build_packed, cfg_for_job, group_jobs,
    parse_manifest_obj, run_sweep,
)
from raft_tpu_torch.fleet.cli import sweep_main

from test_fleet import SM_MANIFEST, STD_MANIFEST
from test_torch_actions_host import DRIVER as RAFT_DRIVER, _ptr, build_host_lib
from test_torch_kernels_cuda import fleet_rows
from test_torch_pull_actions_host import DRIVER as PULL_DRIVER

# one intra-op thread: tier-1 runs several test workers side by side
torch.set_num_threads(1)

# tests/test_fleet.py's mixed manifest (test_grouping_mixed_specs_and_modes)
MIXED_MANIFEST = {
    "spec": "Raft",
    "defaults": {
        "constants": {"Server": ["s1", "s2"], "Value": ["v1"],
                      "MaxElections": 1, "MaxRestarts": 0},
        "msg_slots": 16,
    },
    "jobs": [
        {"name": "r1"},
        {"name": "r2", "constants": {"MaxElections": 2}},
        {"name": "p1", "spec": "PullRaft", "msg_slots": 24},
        {"name": "sim1", "mode": "simulate"},
    ],
}
# tests/test_fleet.py's explicit-jobs manifest (test_explicit_jobs_override_defaults)
EXPLICIT_MANIFEST = {
    "spec": "Raft",
    "defaults": {
        "constants": {"Server": ["s1", "s2"], "Value": ["v1"],
                      "MaxElections": 1, "MaxRestarts": 0},
        "sim": {"walks": 7},
    },
    "jobs": [
        {"name": "a", "mode": "simulate", "sim": {"seed": 3}},
        {"name": "b", "constants": {"MaxElections": 2}, "symmetry": False,
         "net_faults": True},
    ],
}
WIDE_MANIFEST = dict(STD_MANIFEST, grid={"MaxElections": [1, 2, 4]})
MANIFESTS = {"std": STD_MANIFEST, "mixed": MIXED_MANIFEST, "explicit": EXPLICIT_MANIFEST,
             "wide": WIDE_MANIFEST}
PULL_MANIFEST = {
    "spec": "PullRaft",
    "defaults": {
        "constants": {"Server": ["s1", "s2"], "Value": ["v1"],
                      "MaxElections": 1, "MaxRestarts": 1},
        "invariants": ["NoLogDivergence", "LeaderHasAllAckedValues"],
        "msg_slots": 24,
    },
    "grid": {"MaxElections": [1, 2]},
}
# tests/test_fleet.py's violating grid (test_fleet_violation_trace_parity):
# single-vote quorums lose an acked value at MaxElections 2
FLEX_MANIFEST = {
    "spec": "FlexibleRaft",
    "defaults": {"constants": {"Server": ["s1", "s2"], "Value": ["v1"], "MaxRestarts": 0,
                               "ElectionQuorumSize": 1, "ReplicationQuorumSize": 1},
                 "invariants": ["LeaderHasAllAckedValues"], "msg_slots": 24},
    "grid": {"MaxElections": [1, 2]},
}
JOB_FIELDS = ("name", "spec", "constants", "invariants", "symmetry", "msg_slots", "mode",
              "net_faults", "sim")


@pytest.mark.parametrize("which", list(MANIFESTS))
def test_manifest_and_groups_match_reference(which):
    obj = MANIFESTS[which]
    mine, ref = parse_manifest_obj(obj, "<t>"), jax_parse(obj, "<t>")
    for a, b in zip(mine.jobs, ref.jobs, strict=True):
        assert {f: getattr(a, f) for f in JOB_FIELDS} == {f: getattr(b, f) for f in JOB_FIELDS}
        ca, cb = cfg_for_job(a, "m.json"), jax_cfg_for_job(b, "m.json")
        assert (ca.path, ca.symmetry, ca.invariants, ca.model_values) == (
            cb.path, cb.symmetry, cb.invariants, cb.model_values)
        assert {k: repr(v) for k, v in ca.constants.items()} == {
            k: repr(v) for k, v in cb.constants.items()}
    assert set(FLEET_DYN) == {"RaftParams", "PullRaftParams"}
    gm, gr = group_jobs(mine), jax_group_jobs(ref)
    assert [(g.kind, [j.name for j in g.jobs], g.dyn_consts) for g in gm] == [
        (g.kind, [j.name for j in g.jobs], g.dyn_consts) for g in gr]
    for a, b in zip(gm, gr):
        assert (a.table is None and b.table is None) or np.array_equal(a.table, b.table)


@pytest.mark.parametrize("obj,msg", [
    ({"spec": "Raft"}, "no jobs"),
    ({"grid": {"MaxElections": [1]}}, "missing required key 'spec'"),
    ({"spec": "Raft", "gird": {}}, "unknown manifest keys"),
    ({"spec": "Raft", "grid": {"MaxElections": []}}, "non-empty lists"),
    ({"spec": "Raft", "jobs": [{"name": "a", "mode": "walk"}]}, "mode"),
    ({"spec": "Raft", "jobs": [{"name": "a", "msg_slots": 0}]}, "msg_slots"),
    ({"spec": "Raft", "jobs": [{"constants": {}}]}, "need a name"),
    ({"spec": "Raft", "jobs": [{"name": "a"}, {"name": "a"}]}, "duplicate job names"),
    ({"spec": "Raft", "jobs": [{"name": "a", "sim": {"wlks": 1}}]}, "unknown sim keys"),
    ({"spec": "Raft", "jobs": [{"name": "a", "constants": {"Server": [1, 2]}}]}, "constant"),
])
def test_manifest_errors_match_reference(obj, msg):
    with pytest.raises(ManifestError, match=msg) as mine:
        parse_manifest_obj(obj, "<t>")
    with pytest.raises(JaxManifestError) as ref:
        jax_parse(obj, "<t>")
    assert str(mine.value) == str(ref.value)


def test_packed_model_matches_reference():
    """The packed layout (the lanes after the bag, before the first aux
    field), the job-major initial states and fleet_select, for both
    families."""
    for obj in (STD_MANIFEST, PULL_MANIFEST):
        (g,), (rg,) = group_jobs(parse_manifest_obj(obj)), jax_group_jobs(jax_parse(obj))
        tm, jm = build_packed(g), jax_build_packed(rg)
        assert tm.name == jm.name and tm.p == type(tm.p)(**dataclasses.asdict(jm.p))
        assert {k: (f.offset, f.kind, f.shape) for k, f in tm.layout.fields.items()} == {
            k: (f.offset, f.kind, f.shape) for k, f in jm.layout.fields.items()}
        assert tm.layout.view_len == jm.layout.view_len
        assert np.array_equal(tm.init_states(), np.asarray(jm.init_states()))
        tm.fleet_select(1)
        jm.fleet_select(1)
        assert np.array_equal(tm.init_states(), np.asarray(jm.init_states()))
        assert tm.fleet_job_of(tm.init_states()).tolist() == [1]
        tm.fleet_select(None)
        jm.fleet_select(None)
        with pytest.raises(ValueError, match="exceeds static param"):
            tm.fleet_bind(np.asarray(g.table) + 5)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return {"raft": build_host_lib(tmp_path_factory, RAFT_DRIVER, "fleet_raft"),
            "pull": build_host_lib(tmp_path_factory, PULL_DRIVER, "fleet_pull")}


@pytest.mark.parametrize("family", ["raft", "pull"])
def test_lane_reads_match_reference(host_libs, family):
    """The plain expand and the device code of a packed model on rows whose
    c_<name> lanes differ from the static maximum (and random counters)
    equal the reference's dense expand of its packed model; the
    ValueAllOrNothing predicate of the Raft family reads the lane too."""
    obj = STD_MANIFEST if family == "raft" else PULL_MANIFEST
    (g,), (rg,) = group_jobs(parse_manifest_obj(obj)), jax_group_jobs(jax_parse(obj))
    tm, jm = build_packed(g), jax_build_packed(rg)
    B = 128  # one batch shape: one compile of the reference's expand
    front = np.asarray(jm.init_states())
    pool = [front]
    for _ in range(4):
        pad = np.concatenate([front, np.repeat(front[-1:], B - len(front), axis=0)])
        succs, valid, _, _ = (np.array(x) for x in jax.device_get(jm.expand(pad)))
        valid[len(front):] = False
        front = np.unique(succs[valid], axis=0)[:B // 2]
        pool.append(front)
    pool = np.concatenate(pool)
    rows = fleet_rows(tm, np.concatenate([pool, pool[: 2 * B - len(pool)]]), seed=3)
    want = [np.asarray(x) for x in jax.device_get(jm.expand(rows))]
    got = [x.numpy() for x in tm.expand(torch.from_numpy(rows))]
    for label, w, gg in zip(("succs", "valid", "rank", "ovf"), want, got):
        assert np.array_equal(w, gg), label
    spec, cand, _ = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu"))
    lib = host_libs[family]
    C, A, W = len(rows), tm.A, tm.layout.W
    for write in (0, 1):
        succ = np.zeros((C, A, W), np.int32)
        valid, rank = np.zeros((C, A), bool), np.zeros((C, A), np.int32)
        ovf = np.zeros((C, A), bool)
        lib.host_expand(_ptr(rows), C, _ptr(spec), _ptr(cand), A, write, _ptr(succ),
                        _ptr(valid), _ptr(rank), _ptr(ovf))
        for label, w, gg in zip(("valid", "rank", "ovf"), want[1:], (valid, rank, ovf)):
            assert np.array_equal(w, gg), (label, write)
        if write:
            assert np.array_equal(want[0], succ)
    # the lanes decide: Restart and RequestVote rows whose validity differs
    # from the static maximum's
    lay = tm.layout
    ec = rows[:, lay.fields["electionCtr"].offset]
    c_me = rows[:, lay.fields["c_max_elections"].offset]
    assert ((ec < tm.p.max_elections) & (ec >= c_me)).any()
    if family == "raft":
        names = [q for _l, _p, q in tm.liveness["ValuesNotStuck"]]
        _, _, ids = tm.kernel_spec("cpu", names)
        for (_l, _p, jq), pid in zip(jm.liveness["ValuesNotStuck"], ids.tolist()):
            ok = np.zeros(C, bool)
            lib.host_predicate(_ptr(rows), C, _ptr(spec), pid, _ptr(ok))
            assert np.array_equal(ok, np.asarray(jq(rows)))
            assert np.array_equal(ok, tm.predicates[names[0]](torch.from_numpy(rows)).numpy())


def test_serial_and_simulate_groups():
    """A non-packable spec runs as a serial group on one model, and a
    simulate job gives the port Simulator's own result."""
    obj = {
        "spec": "KRaft",
        "defaults": {"constants": {"Server": ["s1", "s2"], "Value": ["v1"],
                                   "MaxElections": 1, "MaxRestarts": 0},
                     "msg_slots": 24, "invariants": ["NoLogDivergence"]},
        "jobs": [{"name": "k1"}, {"name": "k2", "symmetry": False},
                 {"name": "ksim", "mode": "simulate",
                  "sim": {"walks": 8, "max_steps": 64, "seed": 2}}],
    }
    mf = parse_manifest_obj(obj, "<t>")
    assert [g.kind for g in group_jobs(mf)] == ["serial", "serial", "simulate"]
    res = run_sweep(mf, SweepOptions(device="cpu", max_depth=3, chunk=256))
    by = {j.name: j for j in res.jobs}
    assert res.rc == 0 and res.groups == 3 and res.precompiles == 3
    assert by["k2"].distinct > by["k1"].distinct  # symmetry off: more states
    setup = group_jobs(mf)[2].setups[0]
    sim = Simulator(setup.model, invariants=setup.invariants, walks=8,
                    max_behavior_depth=50, seed=2, device="cpu").run(max_steps=64)
    assert (by["ksim"].behaviors, by["ksim"].steps) == (sim.behaviors, sim.steps)


def test_packed_violation_trace_equals_serial():
    """A packed job that breaks an invariant reports its standalone run's
    shortest counterexample: the violation, the action labels and the
    decoded states (which, as the reference's decode, leave out the fleet
    lanes)."""
    mf = parse_manifest_obj(FLEX_MANIFEST, "<t>")
    (g,) = group_jobs(mf)
    caps = dict(chunk=256, frontier_cap=1 << 12, journal_cap=1 << 14, max_seen_cap=1 << 20,
                canon_memo_cap=1 << 12, device="cpu")
    packed = DeviceBFS(build_packed(g), invariants=g.setups[0].invariants, **caps).run_fleet(
        job_names=[j.name for j in g.jobs])
    for r, s in zip(packed, g.setups, strict=True):
        want = DeviceBFS(s.model, invariants=s.invariants, **caps).run()
        assert r.violation == want.violation and r.depth_counts == want.depth_counts
        assert r.trace == want.trace
    assert packed[0].violation is None and packed[1].violation is not None
    assert not any(k == "fleet_job" or k.startswith("c_") for _l, st in packed[1].trace
                   for k in st)


def test_sweep_cli_exit_codes_match_reference(tmp_path, capsys):
    missing = str(tmp_path / "nope.json")
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    unknown = tmp_path / "unknown.json"
    unknown.write_text(json.dumps({"spec": "Bogus", "jobs": [{"name": "a", "constants": {
        "Server": ["s1"], "Value": ["v1"], "MaxElections": 1, "MaxRestarts": 0}}]}))
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps(SM_MANIFEST))
    for argv, rc in (([missing], 66), ([str(bad)], 64), ([str(unknown)], 64),
                     ([str(ok), "--resume"], 64)):
        assert sweep_main(argv + ["--device", "cpu"]) == rc == jax_cli.sweep_main(argv)
    # the engines and options the port lacks: usage errors naming what they wait for
    chaos = tmp_path / "chaos.json"
    chaos.write_text(json.dumps(dict(SM_MANIFEST, defaults=dict(
        SM_MANIFEST["defaults"], chaos="crash=2"))))
    capsys.readouterr()
    for argv in ([str(ok), "--engine", "host"], [str(ok), "--engine", "sharded"],
                 [str(ok), "--state-dir", str(tmp_path)], [str(ok), "--supervise"],
                 [str(ok), "--metrics-out", "m.jsonl"], [str(chaos)]):
        assert sweep_main(argv + ["--device", "cpu"]) == 64, argv
        assert "ROADMAP.md Queue 1 item" in capsys.readouterr().err, argv
    # a violating job: the sweep's rc is the worst job's (2); --json lines
    flex = tmp_path / "flex.json"
    flex.write_text(json.dumps(FLEX_MANIFEST))
    assert sweep_main([str(flex), "--device", "cpu", "--json", "--chunk", "256"]) == 2
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x]
    assert [x["job"] for x in lines[:-1]] == ["FlexibleRaft-MaxElections=1",
                                             "FlexibleRaft-MaxElections=2"]
    assert [x["rc"] for x in lines[:-1]] == [0, 2]
    assert lines[-1]["fleet"] is True and lines[-1]["rc"] == 2
    assert lines[-1]["amortization"]["precompiles"] == 1
