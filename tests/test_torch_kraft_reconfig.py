"""The port's KRaftWithReconfig model (raft_tpu_torch/models/kraft_reconfig.py:
the plain versions of the kreconfig_* kernels) against the JAX reference,
bit for bit, on the CPU (tolerance: none; every value is an integer):

  - the layout, the 3-word message packer and the bindings, field for
    field, at the reference tests' SMALLP constants and at the full cfg's
    (SURVEY.md:96, with the MaxElections stand-in of 2);
  - ``wide_bag_sort`` against the reference's (raft_tpu/ops/bag.py:27);
  - the batched expand against the dense ``jax.vmap(_expand1)`` on
    reachable states (random walks of the reference oracle) and on edge
    rows that fire every receipt arm (succs, valid, rank, ovf), the guard
    grid and the worklist apply against the dense grid;
  - every invariant, the ValuesNotStuck and ReconfigurationNotStuck state
    predicates, the initial state, decode/encode and the action labels;
  - the printer on KRaftWithReconfig states and traces;
  - the registry (a strict parse of the cfg names the undeclared v2, a
    lenient one builds the full-width model) and ``params_from_reference``.

The JAX expand is compiled once, for batches of BATCH states. The slot
canon is held in tests/test_torch_kraft_reconfig_canon.py, the engines in
tests/test_torch_kraft_reconfig_bfs.py.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models import kraft_reconfig as ref_kr
from raft_tpu.oracle.kraft_reconfig_oracle import KRaftReconfigOracle
from raft_tpu.ops import bag as ref_bag
from raft_tpu_torch.checker.util import dense_prefix_sel
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models import kraft_reconfig as kr
from raft_tpu_torch.ops import bag
from raft_tpu_torch.ops.expand import apply, guard
from raft_tpu_torch.ops.packing import EMPTY
from raft_tpu_torch.utils.cfg import CfgError, parse_cfg
from raft_tpu_torch.utils.pprint import format_state, format_trace

from test_torch_kernels_cuda import kreconfig_edge_rows, kreconfig_missing_arms

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# tests/test_kraft_reconfig.py:199-204
SMALLP = ref_kr.KRaftReconfigParams(
    n_hosts=3, n_values=1, init_cluster_size=2, min_cluster_size=2, max_cluster_size=3,
    max_elections=1, max_restarts=1, max_values_per_epoch=1, max_add_reconfigs=1,
    max_remove_reconfigs=1, max_spawned_servers=4, msg_slots=24)
# the full cfg (chip_smoke.py KRAFT_RECONFIG_CFG): SURVEY.md:96's constants,
# MaxElections 2 standing in for the unrecorded value, 40 message slots
FULLP = ref_kr.KRaftReconfigParams(
    n_hosts=3, n_values=2, init_cluster_size=3, min_cluster_size=2, max_cluster_size=4,
    max_elections=2, max_restarts=1, max_values_per_epoch=1, max_add_reconfigs=1,
    max_remove_reconfigs=1, max_spawned_servers=5, msg_slots=40)
PARAMS = {"small": SMALLP, "full": FULLP}
BATCH = 64  # the JAX expand's compiled batch

KRAFT_RECONFIG_CFG = """\
CONSTANTS
    n1 = n1
    n2 = n2
    n3 = n3
    v1 = v1
    Hosts = { n1, n2, n3 }
    Value = { v1, v2 }
    InitClusterSize = 3
    MinClusterSize = 2
    MaxClusterSize = 4
    MaxSpawnedServers = 5
    MaxElections = 2
    MaxRestarts = 1
    MaxValuesPerEpoch = 1
    MaxAddReconfigs = 1
    MaxRemoveReconfigs = 1
INIT Init
NEXT Next
VIEW view
SYMMETRY symmHostsAndValues
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
    NeverTwoLeadersInSameEpoch
    NoIllegalState
    StatesMatchRoles
"""


def oracle(jp) -> KRaftReconfigOracle:
    return KRaftReconfigOracle(**{k: v for k, v in dataclasses.asdict(jp).items()
                                  if k != "msg_slots"})


def port_model(jp) -> kr.KRaftReconfigModel:
    return kr.KRaftReconfigModel(params_from_reference(dataclasses.asdict(jp)))


def walk_states(jp, walks: int, depth: int, seed: int) -> list:
    """Distinct states the reference oracle reaches on random walks from
    Init (the joins, removals and spawned servers a shallow BFS misses)."""
    o = oracle(jp)
    rng = np.random.default_rng(seed)
    seen = {}
    for _ in range(walks):
        st = o.init_state()
        for _d in range(depth):
            succ = o.successors(st)
            if not succ:
                break
            st = succ[int(rng.integers(len(succ)))][1]
            seen.setdefault(o.serialize_full(st), st)
    return list(seen.values())


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
def reachable(name="small"):
    """(JAX model, port model, reachable rows)."""
    jp = PARAMS[name]
    jm, tm = ref_kr.cached_model(jp), port_model(jp)
    states = walk_states(jp, 24, 40, seed=0)[::4]
    return jm, tm, np.stack([jm.encode(s) for s in states]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model, port model, reachable batch, its dense (succs, valid,
    rank, ovf))."""
    jm, tm, batch = reachable()
    return jm, tm, batch, dense_expand(jm, batch)


@functools.lru_cache(maxsize=None)
def _edges():
    """kreconfig_edge_rows of the reachable batch and their dense expand."""
    jm, tm, batch = reachable()
    rows = kreconfig_edge_rows(tm, batch, seed=1)
    return rows, dense_expand(jm, rows)


@pytest.mark.parametrize("name", list(PARAMS))
def test_layout_packer_bindings_match_reference(name):
    jp = PARAMS[name]
    jm, tm = ref_kr.cached_model(jp), port_model(jp)
    assert {k: (f.kind, f.offset, f.shape) for k, f in tm.layout.fields.items()} == {
        k: (f.kind, f.offset, f.shape) for k, f in jm.layout.fields.items()}
    assert (tm.layout.W, tm.layout.view_len) == (jm.layout.W, jm.layout.view_len)
    assert tm.packer.fields == jm.packer.fields and tm.n_words == jm.packer.n_words
    assert tm.bindings == jm.bindings and tm.A == jm.A
    assert tm.ACTION_NAMES == jm.ACTION_NAMES and tm.name == jm.name
    assert [(g.name, g.off, g.n) for g in tm.sparse_groups()] == [
        (g.name, g.off, g.n) for g in jm.sparse_groups()]
    if name == "full":  # the shapes of the full cfg's width
        assert (tm.NS, tm.p.max_log, tm.layout.W, tm.layout.view_len, tm.A, tm.n_words,
                tm.p.msg_slots) == (5, 6, 479, 472, 145, 3, 40)
        assert len(tm.make_canonicalizer(True).sigmas) == 12


@pytest.mark.parametrize("n_words", [2, 3])
def test_wide_bag_sort_matches_reference(n_words):
    """The port's sort equals lax.sort on bags of unique keys in any slot
    order (lax.sort is not stable: a bag's keys are unique and its unused
    slots equal, which this holds rather than assumes)."""
    rng = np.random.default_rng(n_words)
    M, B = 16, 48
    words = np.full((B, n_words, M), EMPTY, np.int32)
    cnt = np.zeros((B, M), np.int32)
    for b in range(B):
        keys = set()
        n = M if b % 5 == 0 else int(rng.integers(0, M))
        while len(keys) < n:
            keys.add(tuple(rng.integers(0, 9, n_words).tolist()))
        perm = rng.permutation(M)
        if keys:
            words[b, :, :n] = np.array(sorted(keys)).T
            cnt[b, :n] = rng.integers(0, 4, n)
        words[b], cnt[b] = words[b][:, perm], cnt[b][perm]
        occ = words[b, 0] != EMPTY
        assert len(set(map(tuple, words[b][:, occ].T))) == occ.sum()  # unique keys
    got = bag.wide_bag_sort([torch.from_numpy(words[:, k]) for k in range(n_words)],
                            torch.from_numpy(cnt))
    srt = jax.vmap(lambda w, c: ref_bag.wide_bag_sort(list(w), c))
    want = jax.device_get(srt(words, cnt))
    for k in range(n_words):
        assert np.array_equal(got[0][k].numpy(), np.asarray(want[0][k]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("rows", ["reachable", "edge"])
def test_expand_bit_identical(rows):
    _jm, tm, batch, want = _pair()
    if rows == "edge":
        batch, want = _edges()
    got = [x.numpy() for x in tm.expand(torch.from_numpy(batch))]
    for label, w, g in zip(("succs", "valid", "rank", "ovf"), want, got):
        assert w.shape == g.shape and np.array_equal(w, g), label
    assert want[1].sum() > len(batch)  # the batch really has enabled actions
    if rows == "edge":  # every disjunct and receipt arm fires, the puts and appends overflow
        assert set(np.unique(want[2][want[1]]).tolist()) == set(range(len(tm.ACTION_NAMES)))
        assert kreconfig_missing_arms(tm, *want[1:]) == []
        hit = want[1] & want[3]
        for r in (kr.KR_REQUESTVOTE, kr.KR_BECOMELEADER, kr.KR_CLIENTREQUEST,
                  kr.KR_HANDLE_REMOVE, kr.KR_ACCEPT_JOIN, kr.KR_HANDLE_FETCH_OK):
            assert (hit & (want[2] == r)).any(), r


def test_guard_and_apply_match_dense():
    _jm, tm, batch, (succs, valid, rank, ovf) = _pair()
    C = len(batch)
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
                               int(valid.sum()) + 9, C * tm.A)
    sel = sel.numpy()
    selv = sel < C * tm.A
    got = apply(tm, torch.from_numpy(batch), torch.from_numpy(sel)).numpy()
    flat = succs.reshape(C * tm.A, -1)
    assert np.array_equal(got[selv], flat[sel[selv]]) and not got[~selv].any()


def test_invariants_predicates_init_decode_encode():
    jm, tm, batch, (succs, *_rest) = _pair()
    edge, (esuccs, *_e) = _edges()
    for states in (batch, succs.reshape(-1, jm.layout.W)[::3], edge,
                   esuccs.reshape(-1, jm.layout.W)[::5]):
        st = torch.from_numpy(np.ascontiguousarray(states))
        for inv in jm.invariants:
            want = np.asarray(jm.invariants[inv](states))
            assert np.array_equal(tm.invariants[inv](st).numpy(), want), inv
        for prop, insts in jm.liveness.items():
            for (label, _p, fn), (tlabel, tp, q) in zip(insts, tm.liveness[prop]):
                assert (label, None) == (tlabel, tp)
                assert np.array_equal(tm.predicates[q](st).numpy(), np.asarray(fn(states))), q
    assert set(tm.invariants) == set(jm.invariants)
    assert {p: len(v) for p, v in tm.liveness.items()} == {
        p: len(v) for p, v in jm.liveness.items()}
    assert np.array_equal(tm.init_states(), jm.init_states())
    for row in np.concatenate([batch, succs[_pair()[3][1]][::7]]):
        st = tm.decode(row)
        assert st == jm.decode(row)
        assert np.array_equal(tm.encode(st), jm.encode(st))
    for row in batch:
        assert np.array_equal(tm.encode(tm.decode(row)), row)
    assert [tm.action_label(r, c) for c in range(tm.A) for r in (2, 13)] == [
        jm.action_label(r, c) for c in range(jm.A) for r in (2, 13)]


def test_printer_prints_kraft_reconfig_states_and_trace():
    _jm, tm, batch, (succs, valid, _r, _o) = _pair()
    setup = type("Setup", (), {"server_names": ["n1", "n2", "n3"], "value_names": ["v1"],
                               "model": tm})()
    rows = np.concatenate([batch, succs[valid][::3]])
    texts = [format_state(setup, tm.decode(row)) for row in rows]
    # the oracle's states print the same way (a decoded state is one)
    texts += [format_state(setup, st) for st in walk_states(SMALLP, 48, 40, seed=2)[::5]]
    joined = "\n".join(texts)
    for word in ("/\\ servers = {[host |-> n1, diskId |-> 0]",
                 "/\\ role = ([host |-> n1, diskId |-> 0] :> Voter",
                 "Observer", "/\\ config = ([host |-> n1, diskId |-> 0] :> [id |-> 1, members |-> ",
                 "committed |-> TRUE]", "/\\ endOffset = ", "[command |-> InitClusterCommand",
                 "[command |-> AddServerCommand", "mtype |-> JoinRequest",
                 "[command |-> RemoveServerCommand", "mtype |-> FetchRequest",
                 "mobserver |-> TRUE", "/\\ pendingFetch = "):
        assert word in joined, word
    trace = format_trace([("Initial predicate", tm.decode(batch[0])),
                          ("StartNewServer(2, 0)", tm.decode(batch[1]))], setup)
    assert trace.count("State ") == 2 and "StartNewServer" in trace


def test_registry_strict_and_lenient_and_convert():
    from raft_tpu_torch.models.registry import build_from_cfg

    with pytest.raises(CfgError, match="undeclared model value 'v2'"):
        parse_cfg("KRaftWithReconfig.cfg", text=KRAFT_RECONFIG_CFG)
    cfg = parse_cfg("KRaftWithReconfig.cfg", text=KRAFT_RECONFIG_CFG, lenient=True)
    setup = build_from_cfg(cfg)
    assert dataclasses.asdict(setup.model.p) == dataclasses.asdict(FULLP)
    assert setup.model.name == "KRaftWithReconfig" and setup.symmetry
    assert setup.invariants == ("LeaderHasAllAckedValues", "NoLogDivergence",
                                "NeverTwoLeadersInSameEpoch", "NoIllegalState",
                                "StatesMatchRoles")
    assert setup.server_names == ["n1", "n2", "n3"] and setup.value_names == ["v1", "v2"]
    assert build_from_cfg(cfg, msg_slots=48).model.p.msg_slots == 48
    for jp in PARAMS.values():  # the reference's dataclass round-trips
        tp = params_from_reference(dataclasses.asdict(jp))
        assert isinstance(tp, kr.KRaftReconfigParams)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert (tp.max_log, tp.max_epoch, tp.max_cfg_id) == (jp.max_log, jp.max_epoch,
                                                             jp.max_cfg_id)
