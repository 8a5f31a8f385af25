"""Liveness checking of the port (raft_tpu_torch.checker.liveness) against
the JAX package's LivenessChecker on the CPU: the same full-state graph
(gids, edge arrays), the same verdicts and the same lassos of planted
``[]<>Q`` and ``P ~> Q`` violations; the collision audit; and the CLI's
PROPERTY handling (a checked run and the reference's exit-64 refusals)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.checker.liveness import LivenessChecker as JaxLiveness
from raft_tpu.models.raft import LEADER, RaftParams, cached_model
from raft_tpu.ops.hashing import hash_lanes as jax_hash_lanes
from raft_tpu_torch.checker.liveness import LivenessChecker
from raft_tpu_torch.convert import fps_to_u64, params_from_reference
from raft_tpu_torch.models.raft import RaftModel
from raft_tpu_torch.ops.hashing import hash_rows

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# tests/test_liveness.py's configuration
SMALL = RaftParams(n_servers=2, n_values=1, max_elections=2, max_restarts=0, msg_slots=16)
CFG = """\
CONSTANTS
    n1 = n1
    n2 = n2
    v1 = v1
    Server = { n1, n2 }
    Value = { v1 }
    MaxElections = 2
    MaxRestarts = 0
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
PROPERTY
    ValuesNotStuck
"""


@pytest.fixture(scope="module")
def pair():
    """(reference model, its checker, port model): one reference checker
    serves every test, so its jitted passes compile once."""
    jm = cached_model(SMALL)
    tm = RaftModel(params_from_reference(dataclasses.asdict(SMALL)))
    return jm, JaxLiveness(jm, ("ValuesNotStuck",), chunk=256), tm


def _run_both(pair, props):
    jm, jc, tm = pair
    jc.properties = props
    tc = LivenessChecker(tm, props, chunk=256, device="cpu")
    return jc, jc.run(), tc, tc.run()


def _same_violation(a, b):
    if a is None or b is None:
        return a is None and b is None
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def test_graph_and_verdict_equal_reference(pair):
    jc, jr, tc, tr = _run_both(pair, ("ValuesNotStuck",))
    assert (tr.distinct, tr.total_edges) == (jr.distinct, jr.total_edges) == (2224, 3276)
    for a in ("_esrc", "_edst", "_ecand"):
        assert np.array_equal(getattr(jc, a), getattr(tc, a)), a
    assert np.array_equal(jc._states, tc._states.numpy())
    assert tc._n_init == jc._n_init
    assert jr.violation is None and tr.violation is None  # ValuesNotStuck holds here
    # the predicate over the whole graph, port against reference
    jm, _, tm = pair
    for (lab, _p, q), (jlab, _jp, jq) in zip(tm.liveness["ValuesNotStuck"],
                                             jm.liveness["ValuesNotStuck"]):
        assert lab == jlab
        assert np.array_equal(tc._eval(q), np.asarray(jq(jc._states)))


def test_planted_always_eventually_same_lasso(pair):
    """[]<>(no value anywhere) fails once a value sticks: the same lasso."""
    jm, _, tm = pair
    lay = jm.layout
    jm.liveness["NeverAnyValue"] = [
        ("v1", None, jax.jit(lambda s: jnp.all(lay.get(s, "log_value") == 0, axis=(1, 2))))]
    tm.predicates["NeverAnyValue"] = lambda s: torch.all(
        (tm.layout.get(s, "log_value") == 0).flatten(1), dim=1)
    tm.liveness["NeverAnyValue"] = [("v1", None, "NeverAnyValue")]
    try:
        _, jr, _, tr = _run_both(pair, ("NeverAnyValue",))
    finally:
        del jm.liveness["NeverAnyValue"], tm.liveness["NeverAnyValue"]
    assert tr.violation is not None and _same_violation(tr.violation, jr.violation)
    assert tr.violation.prefix[0][0] == "Initial predicate"


def test_planted_leads_to_same_lasso(pair):
    """(a leader exists) ~> FALSE: the P path of the search, same lasso."""
    jm, _, tm = pair
    lay = jm.layout
    jm.liveness["LeaderDoom"] = [
        ("", jax.jit(lambda s: jnp.any(lay.get(s, "state") == LEADER, axis=1)),
         jax.jit(lambda s: jnp.zeros(s.shape[:-1], dtype=bool)))]
    tm.predicates["HasLeader"] = lambda s: torch.any(tm.layout.get(s, "state") == LEADER, dim=1)
    tm.predicates["Never"] = lambda s: torch.zeros(s.shape[0], dtype=torch.bool)
    tm.liveness["LeaderDoom"] = [("", "HasLeader", "Never")]
    try:
        _, jr, _, tr = _run_both(pair, ("LeaderDoom",))
    finally:
        del jm.liveness["LeaderDoom"], tm.liveness["LeaderDoom"]
    assert tr.violation is not None and _same_violation(tr.violation, jr.violation)
    assert any(any(s == LEADER for s in st["state"]) for _a, st in tr.violation.prefix)


def test_audit_seed(pair):
    """The audit family's full-state hash equals the reference's seeded
    hash_lanes; an audit passes, and seed 0 is refused."""
    _, _, tm = pair
    tc = LivenessChecker(tm, ("ValuesNotStuck",), chunk=256, device="cpu")
    res = tc.run(audit_seed=5)
    assert (res.distinct, res.total_edges, res.violation) == (2224, 3276, None)
    rows = tc._states[::7]
    want = np.asarray(jax_hash_lanes(rows.numpy(), seed=5))
    assert np.array_equal(fps_to_u64(hash_rows(rows, 5)), want)
    assert not np.array_equal(fps_to_u64(hash_rows(rows, 0)), want)
    with pytest.raises(ValueError, match="audit_seed must be nonzero"):
        tc.run(audit_seed=0)


def test_unknown_property_and_default_device(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="no liveness support"):
        LivenessChecker(tm, ("NoSuchProperty",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LivenessChecker(tm, ("ValuesNotStuck",))


def _cli(capsys, path, *args):
    """The CLI in-process: (exit code, stdout, stderr)."""
    from raft_tpu_torch.__main__ import main

    rc = main([str(path), "--device", "cpu", "--msg-slots", "16", "--chunk", "256",
               "--frontier-cap", "4096", *args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_checks_property(tmp_path, capsys):
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(CFG)
    rc, out, err = _cli(capsys, cfg)
    assert rc == 0, err
    assert "no invariant violations" in out
    assert ("liveness: graph 2224 states / 3276 edges (symmetry off), "
            "properties=['ValuesNotStuck']") in out
    assert "no temporal property violations" in out


@pytest.mark.parametrize("case", ["unknown", "simulate", "max_depth", "time_budget"])
def test_cli_refuses_property_rc64(tmp_path, capsys, case):
    cfg = tmp_path / "Raft.cfg"
    text = CFG.replace("ValuesNotStuck", "NoSuchProperty") if case == "unknown" else CFG
    cfg.write_text(text)
    extra = {"unknown": [], "simulate": ["--simulate", "4"], "max_depth": ["--max-depth", "3"],
             "time_budget": ["--time-budget", "5"]}[case]
    rc, out, err = _cli(capsys, cfg, *extra)
    assert rc == 64, out + err
    want = {"unknown": "no liveness support for spec Raft",
            "simulate": "PROPERTY checking needs the exhaustive device graph",
            "max_depth": "PROPERTY checking is unsound on a partially explored graph",
            "time_budget": "PROPERTY checking is unsound on a partially explored graph"}[case]
    assert want in err
