"""The port's reconfiguration models (raft_tpu_torch/models/config_common.py,
reconfig_raft.py and joint_raft.py: the plain versions of the reconfig_*
and joint_* kernels) against the JAX reference, bit for bit, on the CPU
(tolerance: none; every value is an integer):

  - the layouts and the N-word message packers, field for field, at the
    three-server test constants and at the four-server cfgs' (4 and 6
    words);
  - ``wide_bag_put`` against the reference's (raft_tpu/ops/bag.py:33);
  - the batched expand against the dense ``jax.vmap(_expand1)`` on
    reachable states and on edge rows (succs, valid, rank, ovf), the guard
    grid and the worklist apply against the dense grid;
  - every registered invariant, ReconfigurationCompletes' P and Q,
    decode/encode, the initial state and the action labels;
  - the printer on reconfiguration states;
  - the registry: the AddRemove cfg without MaxClusterSize fails a strict
    parse naming it and a lenient one repairs it; the CLI runs both specs
    by BFS, ``--simulate`` and ``PROPERTY ReconfigurationCompletes``.

The JAX expand is compiled for batches of 8 states (larger batches of the
joint model exhaust the host's memory in XLA's CPU compiler). The
canonical fingerprints, the BFS engine and the liveness graph are held in
tests/test_torch_reconfig_bfs.py.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models import joint_raft as ref_joint
from raft_tpu.models import reconfig_raft as ref_ar
from raft_tpu.oracle.joint_oracle import JointRaftOracle
from raft_tpu.oracle.reconfig_oracle import ReconfigRaftOracle
from raft_tpu.ops import bag as ref_bag
from raft_tpu_torch.__main__ import main
from raft_tpu_torch.checker.util import dense_prefix_sel
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models import config_common as cc
from raft_tpu_torch.models.joint_raft import JointRaftModel
from raft_tpu_torch.models.reconfig_raft import ReconfigRaftModel
from raft_tpu_torch.ops import bag
from raft_tpu_torch.ops.expand import apply, guard
from raft_tpu_torch.ops.packing import EMPTY
from raft_tpu_torch.utils.cfg import CfgError, parse_cfg
from raft_tpu_torch.utils.pprint import format_state, format_trace

from conftest import collect_states
from test_torch_kernels_cuda import config_edge_rows

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# the three-server constants of tests/test_reconfig_add_remove.py:41-45 and
# tests/test_reconfig_joint.py:35-38, at 40 message slots
PARAMS = {
    "reconfig": ref_ar.ReconfigRaftParams(
        n_servers=3, n_values=1, init_cluster_size=2, max_elections=1, max_restarts=0,
        max_values_per_term=1, max_add_reconfigs=1, max_remove_reconfigs=1,
        min_cluster_size=2, max_cluster_size=3, msg_slots=40),
    "joint": ref_joint.JointRaftParams(
        n_servers=3, n_values=1, init_cluster_size=2, max_elections=1, max_restarts=0,
        max_reconfigs=1, max_values_per_term=1, reconfig_type=2, msg_slots=40),
}
# the four-server cfgs' constants (chip_smoke.py ADDREMOVE_CFG, JOINT_CFG)
PARAMS4 = {
    "reconfig": dataclasses.replace(PARAMS["reconfig"], n_servers=4, init_cluster_size=3,
                                    max_cluster_size=4, msg_slots=112),
    "joint": dataclasses.replace(PARAMS["joint"], n_servers=4, init_cluster_size=3,
                                 max_reconfigs=2, msg_slots=112),
}
BATCH = 8  # the JAX expand's compiled batch


def _models(jp):
    if isinstance(jp, ref_joint.JointRaftParams):
        return ref_joint.cached_model(jp), JointRaftModel(
            params_from_reference(dataclasses.asdict(jp)))
    return ref_ar.cached_model(jp), ReconfigRaftModel(
        params_from_reference(dataclasses.asdict(jp)))


def _oracle(jp):
    if isinstance(jp, ref_joint.JointRaftParams):
        return JointRaftOracle(jp.n_servers, jp.n_values, jp.init_cluster_size,
                               jp.max_elections, jp.max_restarts, jp.max_reconfigs,
                               jp.max_values_per_term, jp.reconfig_type)
    return ReconfigRaftOracle(jp.n_servers, jp.n_values, jp.init_cluster_size,
                              jp.max_elections, jp.max_restarts, jp.max_values_per_term,
                              jp.max_add_reconfigs, jp.max_remove_reconfigs,
                              jp.min_cluster_size, jp.max_cluster_size)


def dense_expand(jm, rows):
    """The reference's dense expand of ``rows``, BATCH rows a call (the
    last batch padded with copies of its last row)."""
    outs = []
    for off in range(0, len(rows), BATCH):
        part = rows[off:off + BATCH]
        n = len(part)
        if n < BATCH:
            part = np.concatenate([part, np.repeat(part[-1:], BATCH - n, axis=0)])
        outs.append([np.array(x)[:n] for x in jax.device_get(jm.expand(part))])
    return [np.concatenate(x) for x in zip(*outs)]


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, port model, reachable batch, its dense (succs, valid,
    rank, ovf) as numpy)."""
    jp = PARAMS[name]
    jm, tm = _models(jp)
    batch = np.stack([jm.encode(s) for s in collect_states(_oracle(jp), 8, cap=96)])
    batch = batch.astype(np.int32)
    return jm, tm, batch, dense_expand(jm, batch)


@functools.lru_cache(maxsize=None)
def _edges(name):
    """config_edge_rows of the reachable batch and their dense expand."""
    jm, tm, batch, _ = _pair(name)
    rows = config_edge_rows(tm, batch, seed=len(name))
    return rows, dense_expand(jm, rows)


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("size", [3, 4])
def test_layout_and_packer_match_reference(name, size):
    jp = PARAMS[name] if size == 3 else PARAMS4[name]
    jm, tm = _models(jp)
    assert {k: (f.kind, f.offset, f.shape) for k, f in tm.layout.fields.items()} == {
        k: (f.kind, f.offset, f.shape) for k, f in jm.layout.fields.items()}
    assert (tm.layout.W, tm.layout.view_len) == (jm.layout.W, jm.layout.view_len)
    assert tm.packer.fields == jm.packer.fields and tm.n_words == jm.n_words
    assert tm.bindings == jm.bindings and tm.A == jm.A
    assert tm.ACTION_NAMES == jm.ACTION_NAMES and tm.name == jm.name
    assert tm.msg_perm_spec == jm.msg_perm_spec
    if size == 4:  # the four-server cfgs' key widths and lane counts
        assert (tm.n_words, tm.layout.W, tm.A) == {"reconfig": (4, 735, 192),
                                                   "joint": (6, 1042, 224)}[name]


@pytest.mark.parametrize("n_words", [2, 4, 6])
def test_wide_bag_put_matches_reference(n_words):
    rng = np.random.default_rng(n_words)
    M, B = 12, 64
    words = np.full((B, n_words, M), EMPTY, np.int32)
    for b in range(B):  # sorted unique keys, empties last, every fourth bag full
        keys = set()
        n = M if b % 4 == 0 else int(rng.integers(0, M))
        while len(keys) < n:
            keys.add(tuple(rng.integers(0, 4, n_words).tolist()))
        if keys:
            words[b, :, :n] = np.array(sorted(keys)).T
    cnt = np.where(words[:, 0] != EMPTY, rng.integers(0, 3, (B, M)), 0).astype(np.int32)
    key = rng.integers(0, 4, (B, n_words)).astype(np.int32)
    for b in range(1, B, 2):  # every other key already in its bag (when not empty)
        if words[b, 0, 0] != EMPTY:
            key[b] = words[b, :, int(rng.integers(0, (words[b, 0] != EMPTY).sum()))]
    got = bag.wide_bag_put([torch.from_numpy(words[:, k]) for k in range(n_words)],
                           torch.from_numpy(cnt), [torch.from_numpy(key[:, k])
                                                   for k in range(n_words)])
    put = jax.vmap(lambda w, c, k: ref_bag.wide_bag_put(list(w), c, tuple(k)))
    want = jax.device_get(put(words, cnt, key))
    for k in range(n_words):
        assert np.array_equal(got[0][k].numpy(), np.asarray(want[0][k]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[2]).any() and np.asarray(want[3]).any()


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
        fired = set(np.unique(want[2][want[1]]).tolist())
        assert fired == set(range(len(tm.ACTION_NAMES))), fired


@pytest.mark.parametrize("name", list(PARAMS))
def test_guard_and_apply_match_dense(name):
    jm, tm, batch, (succs, valid, rank, ovf) = _pair(name)
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
    sel, _n = dense_prefix_sel(torch.from_numpy(valid.reshape(-1).copy()),
                               int(valid.sum()) + 9, C * jm.A)
    sel = sel.numpy()
    selv = sel < C * jm.A
    got = apply(tm, torch.from_numpy(batch), torch.from_numpy(sel)).numpy()
    flat = succs.reshape(C * jm.A, -1)
    assert np.array_equal(got[selv], flat[sel[selv]]) and not got[~selv].any()


@pytest.mark.parametrize("name", list(PARAMS))
def test_invariants_predicates_init_decode_encode(name):
    jm, tm, batch, (succs, *_rest) = _pair(name)
    edge, (esuccs, *_e) = _edges(name)
    p_ref, q_ref = jm.liveness["ReconfigurationCompletes"][0][1:]
    for states in (batch, succs.reshape(-1, jm.layout.W)[::3], edge,
                   esuccs.reshape(-1, jm.layout.W)[::5]):
        st = torch.from_numpy(np.ascontiguousarray(states))
        for inv in jm.invariants:
            want = np.asarray(jm.invariants[inv](states))
            assert np.array_equal(tm.invariants[inv](st).numpy(), want), inv
        assert np.array_equal(tm.predicates["ReconfigurationCompletes.P"](st).numpy(),
                              np.asarray(p_ref(states)))
        assert np.array_equal(tm.predicates["ReconfigurationCompletes.Q"](st).numpy(),
                              np.asarray(q_ref(states)))
    assert set(tm.invariants) == set(jm.invariants)
    assert [x[0] for x in tm.liveness["ReconfigurationCompletes"]] == [
        x[0] for x in jm.liveness["ReconfigurationCompletes"]]
    assert np.array_equal(tm.init_states(), jm.init_states())
    for row in batch[:40]:
        st = tm.decode(row)
        assert st == jm.decode(row)
        assert np.array_equal(tm.encode(st), jm.encode(st)) and np.array_equal(tm.encode(st), row)
    assert [tm.action_label(r, c) for c in range(tm.A) for r in (1, 15)] == [
        jm.action_label(r, c) for c in range(jm.A) for r in (1, 15)]


def test_printer_prints_reconfiguration_states():
    texts = []
    for name in PARAMS:
        _jm, tm, batch, (succs, valid, _r, _o) = _pair(name)
        setup = type("Setup", (), {"server_names": ["n1", "n2", "n3"], "value_names": ["v1"],
                                   "model": tm})()
        rows = np.concatenate([batch, succs[valid]])
        texts += [format_state(setup, tm.decode(row)) for row in rows]
        trace = format_trace([("Initial predicate", tm.decode(batch[0])),
                              ("RequestVote(0,)", tm.decode(batch[1]))], setup)
        assert trace.count("State ") == 2
    joined = "\n".join(texts)
    for word in ("/\\ config = (n1 :> [id |-> 1, members |-> {n1, n2}, committed |-> TRUE]",
                 "jointConsensus |-> FALSE", "[command |-> InitClusterCommand, term |-> 1",
                 "[command |-> NewConfigCommand", "[command |-> AddServerCommand",
                 "[command |-> OldNewConfigCommand", "mlog |-> <<[command |-> ",
                 "mmembers |-> {n1, n2", "[command |-> AppendCommand, term |-> 1, value |-> v1]"):
        assert word in joined, word


ADDREMOVE_CFG = """\
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Server = { n1, n2, n3 }
    Value = { v1 }
    InitClusterSize = 2
    MinClusterSize = 2
    MaxAddReconfigs = 1
    MaxRemoveReconfigs = 1
    IncludeThesisBug = FALSE
    MaxElections = 1
    MaxRestarts = 0
    MaxValuesPerTerm = 1
INIT Init
NEXT Next
VIEW view
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
    MaxOneReconfigurationAtATime
"""
JOINT_CFG = ADDREMOVE_CFG.replace("    MinClusterSize = 2\n", "    MaxReconfigs = 1\n").replace(
    "    MaxAddReconfigs = 1\n    MaxRemoveReconfigs = 1\n", "").replace(
    "IncludeThesisBug = FALSE", "ReconfigType = 2")


def test_registry_diagnoses_missing_max_cluster_size():
    from raft_tpu_torch.models.registry import build_from_cfg

    strict = parse_cfg("RaftWithReconfigAddRemove.cfg", text=ADDREMOVE_CFG)
    with pytest.raises(CfgError, match=r"MaxClusterSize \(RaftWithReconfigAddRemove.tla:88\)"):
        build_from_cfg(strict)
    lenient = parse_cfg("RaftWithReconfigAddRemove.cfg", text=ADDREMOVE_CFG, lenient=True)
    setup = build_from_cfg(lenient)
    assert setup.model.p.max_cluster_size == 3 and setup.model.p.msg_slots == 112
    assert any("defaulting it to |Server| = 3" in d for d in lenient.diagnostics)
    given = parse_cfg("RaftWithReconfigAddRemove.cfg",
                      text=ADDREMOVE_CFG.replace("IncludeThesisBug", "MaxClusterSize = 3\n    "
                                                 "IncludeThesisBug"))
    assert build_from_cfg(given).model.p.max_cluster_size == 3 and not given.diagnostics
    joint = build_from_cfg(parse_cfg("RaftWithReconfigJointConsensus.cfg", text=JOINT_CFG))
    assert dataclasses.asdict(joint.model.p) == {**dataclasses.asdict(PARAMS["joint"]),
                                                 "msg_slots": 112}
    assert (joint.model.name, joint.model.p.reconfig_type, joint.invariants) == (
        "RaftWithReconfigJointConsensus", 2,
        ("LeaderHasAllAckedValues", "NoLogDivergence", "MaxOneReconfigurationAtATime"))


def test_cli_runs_both_reconfiguration_specs(tmp_path, capsys):
    ar = tmp_path / "RaftWithReconfigAddRemove.cfg"
    ar.write_text(ADDREMOVE_CFG)
    assert main([str(ar), "--device", "cpu", "--msg-slots", "32"]) == 64
    assert "MaxClusterSize" in capsys.readouterr().err
    rc = main([str(ar), "--lenient", "--device", "cpu", "--msg-slots", "32", "--chunk", "128",
               "--max-depth", "3"])
    out = capsys.readouterr()
    # the reference oracle (python -m raft_tpu ... --checker oracle) agrees
    assert rc == 0 and "distinct=45 total=60 depth=3" in out.out, out.out + out.err
    jc = tmp_path / "RaftWithReconfigJointConsensus.cfg"
    jc.write_text(JOINT_CFG)
    rc = main([str(jc), "--device", "cpu", "--msg-slots", "32", "--simulate", "16",
               "--sim-walks", "4", "--sim-depth", "8", "--seed", "1"])
    out = capsys.readouterr()
    assert rc == 0 and "no invariant violations" in out.out, out.out + out.err
    # the PROPERTY path (the reference's graph and verdict at MaxAddReconfigs 1
    # are held in tests/test_torch_reconfig_bfs.py)
    live = tmp_path / "RaftWithReconfigAddRemove.cfg"
    live.write_text(ADDREMOVE_CFG.replace("MaxElections = 1", "MaxElections = 0").replace(
        "MaxRemoveReconfigs = 1", "MaxRemoveReconfigs = 0").replace(
        "MaxAddReconfigs = 1", "MaxAddReconfigs = 0") + "PROPERTY\n"
        "    ReconfigurationCompletes\n")
    rc = main([str(live), "--lenient", "--device", "cpu", "--msg-slots", "32", "--chunk", "128"])
    out = capsys.readouterr()
    assert rc == 0 and "no temporal property violations" in out.out, out.out + out.err


def test_edge_rows_exercise_every_bag_shape():
    _jm, tm, batch, _ = _pair("joint")
    rows = config_edge_rows(tm, batch, seed=1)
    w0 = tm.layout.get(rows, "msg_w0")
    assert (w0 != EMPTY).all(axis=1).any()  # some bags full
    assert (tm.layout.get(rows, "msg_cnt")[(w0 != EMPTY)] == 0).any()
    assert (tm.layout.get(rows, "nextIndex") == cc.PENDING_SNAP_RESPONSE).any()
