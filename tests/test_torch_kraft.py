"""The port's KRaft (raft_tpu_torch/models/kraft.py, the plain versions of
the KRaft kernels) against the JAX reference, bit for bit, on the CPU:

  - the layout and message packer, field for field;
  - the batched expand against the dense ``jax.vmap(_expand1)`` on
    reachable states and on edge rows (succs, valid, rank, ovf), and the
    guard grid and the worklist apply against the dense grid and the
    reference's ``sparse_apply``;
  - every registered invariant and ValueAllOrNothing, decode/encode, the
    initial state and the action labels;
  - the printer on KRaft states (the reference's fails on them: its
    ``format_state`` reads ``currentTerm``);
  - the CLI: BFS, ``--simulate`` and ``PROPERTY ValuesNotStuck`` run, and
    a violation's trace states equal the reference's.

The canonical fingerprints, the BFS engine and the liveness graph are held
in tests/test_torch_kraft_bfs.py (a file of its own, so that the two share
the test workers).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.models.kraft import KRaftParams, cached_model
from raft_tpu.oracle.kraft_oracle import KRaftOracle
from raft_tpu_torch.__main__ import main
from raft_tpu_torch.checker.util import dense_prefix_sel
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models import kraft as kr
from raft_tpu_torch.models.kraft import KRaftModel
from raft_tpu_torch.ops.expand import apply, guard
from raft_tpu_torch.utils.pprint import format_state, format_trace

from conftest import collect_states
from test_expand_sparse import DenseShim
from test_torch_kernels_cuda import kraft_edge_rows

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# tests/test_kraft.py's PARAMS
PARAMS = {
    "kraft": KRaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0,
                         msg_slots=56),
    "kraft_restart": KRaftParams(n_servers=3, n_values=2, max_elections=2, max_restarts=1,
                                 msg_slots=64),
}
# KRaft.cfg's invariants (tests/test_kraft.py's cfg check)
INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "NeverTwoLeadersInSameEpoch",
       "NoIllegalState")


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, port model, reachable batch, its dense (succs, valid,
    rank, ovf) as numpy)."""
    jp = PARAMS[name]
    jm = cached_model(jp)
    tm = KRaftModel(params_from_reference(dataclasses.asdict(jp)))
    oracle = KRaftOracle(jp.n_servers, jp.n_values, jp.max_elections, jp.max_restarts)
    batch = np.stack([jm.encode(s) for s in collect_states(oracle, 8, cap=120)])
    batch = batch.astype(np.int32)
    return jm, tm, batch, [np.array(x) for x in jax.device_get(jm.expand(batch))]


@functools.lru_cache(maxsize=None)
def _edges(name):
    """kraft_edge_rows of the reachable batch and their dense expand."""
    jm, tm, batch, _ = _pair(name)
    rows = kraft_edge_rows(tm, batch, seed=len(name))
    return rows, [np.array(x) for x in jax.device_get(jm.expand(rows))]


@pytest.mark.parametrize("name", list(PARAMS))
def test_layout_and_packer_match_reference(name):
    jm, tm, _batch, _dense = _pair(name)
    assert {k: (f.kind, f.offset, f.shape) for k, f in tm.layout.fields.items()} == {
        k: (f.kind, f.offset, f.shape) for k, f in jm.layout.fields.items()}
    assert (tm.layout.W, tm.layout.view_len) == (jm.layout.W, jm.layout.view_len)
    assert tm.packer.fields == jm.packer.fields
    assert tm.bindings == jm.bindings and tm.A == jm.A
    assert tm.ACTION_NAMES == jm.ACTION_NAMES and tm.name == jm.name
    assert (tm.msg_server_fields, tm.msg_server_nil_fields) == (
        jm.msg_server_fields, jm.msg_server_nil_fields)


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("rows", ["reachable", "edge"])
def test_expand_bit_identical(name, rows):
    _jm, tm, batch, want = _pair(name)
    if rows == "edge":
        batch, want = _edges(name)
    got = [x.numpy() for x in tm.expand(torch.from_numpy(batch))]
    for label, w, g in zip(("succs", "valid", "rank", "ovf"), want, got):
        assert w.shape == g.shape and np.array_equal(w, g), label
    assert want[1].sum() > len(batch)  # the batch really has enabled actions
    if rows == "edge":
        # every disjunct fires somewhere, and the three that overflow do
        fired = set(np.unique(want[2][want[1]]).tolist())
        assert fired == set(range(len(tm.ACTION_NAMES))), fired
        hit = want[1] & want[3]
        for r in (kr.K_REQUESTVOTE, kr.K_BECOMELEADER, kr.K_CLIENTREQUEST,
                  kr.K_HANDLE_FETCH_OK):
            assert (hit & (want[2] == r)).any(), r


@pytest.mark.parametrize("name", list(PARAMS))
def test_guard_and_apply_match_reference(name):
    jm, tm, batch, (_succs, valid, rank, ovf) = _pair(name)
    C = len(batch)
    assert [(g.name, g.off, g.n) for g in tm.sparse_groups()] == [
        (g.name, g.off, g.n) for g in jm.sparse_groups()]
    n_live = C - 5
    cov = torch.zeros((len(tm.ACTION_NAMES), 3), dtype=torch.int64)
    gv, gr, go, scal = guard(tm, torch.from_numpy(batch), n_live, cov)
    live = np.arange(C) < n_live
    want_v = valid & live[:, None]
    assert np.array_equal(gv.numpy(), want_v)
    assert np.array_equal(gr.numpy(), rank) and np.array_equal(go.numpy(), ovf)
    assert scal.tolist() == [int(want_v.sum()), int((live & ~want_v.any(1)).sum()),
                             int((want_v & ovf).any())]
    sel, n = dense_prefix_sel(torch.from_numpy(valid.reshape(-1).copy()),
                              int(valid.sum()) + 9, C * jm.A)
    sel = sel.numpy()
    selv = sel < C * jm.A
    plan = jm.sparse_plan(C, len(sel))
    ref, apply_ovf = jax.device_get(jax.jit(jm.sparse_apply, static_argnums=3)(
        jnp.asarray(batch), jnp.asarray(sel), jnp.asarray(selv), plan))
    got = apply(tm, torch.from_numpy(batch), torch.from_numpy(sel)).numpy()
    assert not apply_ovf and np.array_equal(got, np.asarray(ref))
    assert not got[~selv].any() and got[selv].any()


@pytest.mark.parametrize("name", list(PARAMS))
def test_invariants_predicates_init_decode_encode(name):
    jm, tm, batch, (succs, *_rest) = _pair(name)
    edge, (esuccs, *_e) = _edges(name)
    flat = succs.reshape(-1, jm.layout.W)[::3]
    for states in (batch, flat, edge, esuccs.reshape(-1, jm.layout.W)[::5]):
        for inv in jm.invariants:
            want = np.asarray(jm.invariants[inv](states))
            assert np.array_equal(tm.invariants[inv](torch.from_numpy(states)).numpy(), want), inv
        for (lab, _p, q), v in zip(tm.liveness["ValuesNotStuck"], range(tm.p.n_values)):
            want = np.asarray(jm._live_value_all_or_nothing(v, states))
            assert np.array_equal(tm.predicates[q](torch.from_numpy(states)).numpy(), want), lab
    assert set(tm.invariants) == set(jm.invariants)
    assert [lab for lab, _p, _q in tm.liveness["ValuesNotStuck"]] == [
        lab for lab, _p, _q in jm.liveness["ValuesNotStuck"]]
    assert np.array_equal(tm.init_states(), jm.init_states())
    for row in batch[:40]:
        st = tm.decode(row)
        assert st == jm.decode(row)
        assert np.array_equal(tm.encode(st), jm.encode(st)) and np.array_equal(tm.encode(st), row)
    assert [tm.action_label(r, c) for c in range(tm.A) for r in (2, 13)] == [
        jm.action_label(r, c) for c in range(jm.A) for r in (2, 13)]


def test_printer_prints_kraft_states():
    _jm, tm, batch, _dense = _pair("kraft")
    setup = type("Setup", (), {"server_names": tm.server_names, "value_names": tm.value_names,
                               "model": tm})()
    rows, rng = batch, np.random.default_rng(0)
    deep = [batch]
    for _ in range(6):  # random successors six steps past the batch
        succs, valid, _rank, _ovf = tm.expand(torch.from_numpy(rows))
        nxt = succs[valid].numpy()
        rows = nxt[rng.choice(len(nxt), min(len(nxt), 150), replace=False)]
        deep.append(rows)
    texts = [format_state(setup, tm.decode(row)) for row in np.concatenate(deep)]
    assert all("/\\ currentEpoch = (s1 :> " in t for t in texts)
    joined = "\n".join(texts)
    for word in ("Unattached", "pendingFetch", "highWatermark", "endOffset",
                 "correlation |-> [", "[epoch |-> ", "mleader |-> "):
        assert word in joined, word
    trace = format_trace([("Initial predicate", tm.decode(batch[0])),
                          ("RequestVote(0,)", tm.decode(batch[1]))], setup)
    assert trace.count("State ") == 2


# KRaft.cfg's constants (SURVEY.md:95), with the cfg's four invariants
KRAFT_CFG = """\
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Server = { n1, n2, n3 }
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
    NeverTwoLeadersInSameEpoch
    NoIllegalState
"""


def _cli(capsys, path, *args):
    """The CLI's ``main`` in this process: (rc, stdout, stderr)."""
    rc = main([str(path), "--device", "cpu", "--chunk", "256", "--msg-slots", "40",
               "--frontier-cap", "4096", *args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_bfs_simulate_and_liveness(tmp_path, capsys):
    cfg = tmp_path / "KRaft.cfg"
    cfg.write_text(KRAFT_CFG)
    rc, out, err = _cli(capsys, cfg, "--max-depth", "8")
    assert rc == 0, err
    assert "spec=KRaft" in err and "no invariant violations" in out
    assert "distinct=515 total=1009 depth=8" in out
    rc, out, err = _cli(capsys, cfg, "--simulate", "8", "--sim-walks", "4", "--sim-depth", "12")
    assert rc == 0, err
    assert "no invariant violations" in out
    prop = tmp_path / "KRaft2.cfg"
    prop.write_text(KRAFT_CFG.replace("    n3 = n3\n", "").replace(
        "{ n1, n2, n3 }", "{ n1, n2 }").replace("MaxElections = 2", "MaxElections = 1")
        + "PROPERTY\n    ValuesNotStuck\n")
    rc, out, err = _cli(capsys, prop, "--spec", "KRaft")
    assert rc == 0, err
    assert "liveness: graph" in out and "no temporal property violations" in out


def test_violation_trace_equals_reference(tmp_path, capsys):
    """With a restart allowed, a server reaches IllegalState at depth 6
    (TransitionToFollower in an epoch it already follows, KRaft.tla:344-349):
    the port's violation and trace states equal the reference's dense
    engine's, and the CLI prints the trace (exit 2)."""
    jp = dataclasses.replace(PARAMS["kraft"], max_restarts=1, msg_slots=40)
    caps = dict(chunk=256, frontier_cap=1 << 12, journal_cap=1 << 14)
    ref = JaxDeviceBFS(DenseShim(cached_model(jp)), invariants=INV, **caps).run(max_depth=8)
    from raft_tpu_torch.checker.device_bfs import DeviceBFS

    tm = KRaftModel(params_from_reference(dataclasses.asdict(jp)))
    res = DeviceBFS(tm, invariants=INV, max_seen_cap=1 << 18, canon_memo_cap=1 << 12,
                    device="cpu", **caps).run(max_depth=8)
    assert ref.violation is not None and res.violation is not None
    assert (res.violation.invariant, res.violation.depth, res.violation.global_id) == (
        ref.violation.invariant, ref.violation.depth, ref.violation.global_id)
    assert res.violation.invariant == "NoIllegalState" and res.violation.depth == 6
    assert [st for _lab, st in res.trace] == [st for _lab, st in ref.trace]
    assert [lab for lab, _st in res.trace] == [lab for lab, _st in ref.trace]
    cfg = tmp_path / "KRaft.cfg"
    cfg.write_text(KRAFT_CFG.replace("MaxRestarts = 0", "MaxRestarts = 1"))
    rc, out, err = _cli(capsys, cfg)
    assert rc == 2, err
    assert "INVARIANT NoIllegalState VIOLATED (depth 6)" in out
    assert sum(line.startswith("State ") for line in out.splitlines()) == 7
    assert "state = (s1 :> IllegalState" in out or ":> IllegalState" in out
