"""The port's engines on KRaftWithReconfig against the JAX package, on the
CPU (tolerance: none; counts and states are integers):

  - DeviceBFS through the slot canon at the reference tests' SMALLP
    constants to depth 4, symmetry on and off: the reference oracle's
    ``bfs`` (oracle/kraft_reconfig_oracle.py:1447: distinct and depth
    counts, as tests/test_kraft_reconfig.py:245 holds the JAX engine) and
    the reference's dense DeviceBFS (distinct, total, terminal, depth
    counts, coverage);
  - the liveness graph of ValuesNotStuck and ReconfigurationNotStuck on
    the 428-state universe (tests/test_liveness_families.py:151-156): the
    reference's LivenessChecker's states, edge arrays, predicates and
    verdict;
  - the Simulator on the manifests/kraft_reconfig_sim.json constants: the
    reference's behaviors, steps and final states for the same seed;
  - the CLI: BFS, --simulate and the PROPERTY run on that universe.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.checker.liveness import LivenessChecker as JaxLiveness
from raft_tpu.checker.simulate import Simulator as JaxSimulator
from raft_tpu.models import kraft_reconfig as ref_kr
from raft_tpu_torch.__main__ import main
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.checker.liveness import LivenessChecker
from raft_tpu_torch.checker.simulate import Simulator

from test_expand_sparse import DenseShim
from test_torch_cli import KRAFT_RECONFIG_SMALL
from test_torch_kraft_reconfig import SMALLP, oracle, port_model

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

INV = ("NoIllegalState", "NoLogDivergence", "NeverTwoLeadersInSameEpoch",
       "LeaderHasAllAckedValues", "StatesMatchRoles")
# the 428-state universe (tests/test_liveness_families.py:151-156)
LIVEP = dataclasses.replace(SMALLP, n_hosts=2, max_cluster_size=2, max_restarts=0,
                            max_spawned_servers=2)
PROPS = ("ValuesNotStuck", "ReconfigurationNotStuck")


@pytest.mark.parametrize("symmetry", [True, False])
def test_device_bfs_matches_oracle_and_dense_engine(symmetry):
    depth = 4
    res = DeviceBFS(port_model(SMALLP), invariants=INV, symmetry=symmetry, chunk=128,
                    frontier_cap=1 << 11, journal_cap=1 << 13, max_seen_cap=1 << 16,
                    device="cpu").run(max_depth=depth)
    ora = oracle(SMALLP).bfs(invariants=(), symmetry=symmetry, max_depth=depth)
    assert res.violation is None
    assert (res.distinct, res.depth_counts) == (ora["distinct"], ora["depth_counts"])
    ref = JaxDeviceBFS(DenseShim(ref_kr.cached_model(SMALLP)), invariants=INV,
                       symmetry=symmetry, chunk=128, frontier_cap=1 << 11,
                       journal_cap=1 << 13).run(max_depth=depth)
    assert (res.distinct, res.total, res.depth, res.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert res.depth_counts == ref.depth_counts and res.coverage == ref.coverage
    assert res.distinct > 1000


def test_liveness_graph_and_verdict_equal_reference():
    jm = ref_kr.cached_model(LIVEP)
    tm = port_model(LIVEP)
    jc = JaxLiveness(jm, PROPS, chunk=256)
    jr = jc.run()
    tc = LivenessChecker(tm, PROPS, chunk=256, device="cpu")
    tr = tc.run()
    assert (tr.distinct, tr.total_edges) == (jr.distinct, jr.total_edges) == (428, 544)
    for a in ("_esrc", "_edst", "_ecand"):
        assert np.array_equal(getattr(jc, a), getattr(tc, a)), a
    assert np.array_equal(jc._states, tc._states.numpy())
    assert tr.violation is None and jr.violation is None
    for prop in PROPS:
        for (_l, _p, q), (_jl, _jp, fn) in zip(tm.liveness[prop], jm.liveness[prop]):
            assert np.array_equal(tc._eval(q), np.asarray(fn(jc._states))), q


def test_simulator_equals_reference():
    """The manifest's constants (manifests/kraft_reconfig_sim.json), 16
    walks of depth 12 from seed 7: the same behaviors, steps and final
    states."""
    jp = dataclasses.replace(SMALLP, msg_slots=40)
    kw = dict(invariants=INV[:4], walks=16, max_behavior_depth=12, seed=7)
    jres = JaxSimulator(ref_kr.cached_model(jp), **kw).run(max_behaviors=24)
    sim = Simulator(port_model(jp), device="cpu", **kw)
    res = sim.run(max_behaviors=24)
    assert (res.behaviors, res.steps, res.violation) == (jres.behaviors, jres.steps, None)
    assert res.steps > 100


def test_cli_bfs_simulate_and_property(tmp_path, capsys):
    cfg = tmp_path / "KRaftWithReconfig.cfg"
    cfg.write_text(KRAFT_RECONFIG_SMALL.replace("Value = { v1, v2 }", "Value = { v1 }"))
    base = [str(cfg), "--device", "cpu", "--msg-slots", "24", "--chunk", "128"]
    assert main(base + ["--max-depth", "3"]) == 0
    out = capsys.readouterr()
    # the oracle's depth-3 count (1 + 8 + 46 + 223)
    assert "distinct=278" in out.out and "no invariant violations" in out.out, out.out + out.err
    assert main(base + ["--simulate", "16", "--sim-walks", "4", "--sim-depth", "10"]) == 0
    assert "no invariant violations" in capsys.readouterr().out
    live = tmp_path / "live" / "KRaftWithReconfig.cfg"
    live.parent.mkdir()
    live.write_text(KRAFT_RECONFIG_SMALL.replace("Value = { v1, v2 }", "Value = { v1 }").replace(
        "    n3 = n3\n", "").replace("{ n1, n2, n3 }", "{ n1, n2 }").replace(
        "MaxClusterSize = 3", "MaxClusterSize = 2").replace("MaxRestarts = 1", "MaxRestarts = 0")
        .replace("MaxSpawnedServers = 4", "MaxSpawnedServers = 2")
        + "PROPERTY\n    ValuesNotStuck\n    ReconfigurationNotStuck\n")
    assert main([str(live), "--device", "cpu", "--msg-slots", "24", "--chunk", "256"]) == 0
    out = capsys.readouterr().out
    assert "liveness: graph 428 states / 544 edges" in out, out
    assert "no temporal property violations" in out
