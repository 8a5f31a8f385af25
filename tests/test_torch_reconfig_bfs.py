"""The reconfiguration specs' canonical fingerprints, BFS engine and
liveness graph on the CPU against the JAX reference.

Their message keys are N int32 words (the ``msg_word`` layout kind) and
carry member sets (``server_bitmask`` fields: ``mmembers``, a log entry's
``cmembers`` or old/new/members sets) and AddRemove's Nil-able ``cmem``
(``server_nil``), all remapped by the canon before the bag is hashed. So
the v5 fingerprints (hashv=5, wl=3) of reachable states and random
successors, whose bags hold AppendEntries and SnapshotRequests with those
fields, and of their server-permuted copies, must equal the reference
``Canonicalizer``'s (with and without symmetry, through the memo too); a
canon without the bitmask remap splits a permuted pair; the canon refuses
nine servers. Then the port's DeviceBFS against the reference's dense
DeviceBFS (counts, depth counts, terminal, coverage) at three servers
(five: tests/test_torch_reconfig5_bfs.py), and ReconfigurationCompletes on AddRemove at MaxElections 0
(graph, edge arrays, P and Q over the graph, verdict) against the
reference's LivenessChecker; and the four-server AddRemove counterexample
the card's BFS finds at depth 21, replayed step by step through the
reference's model. Tolerance: none (integers and hashes).
"""

import dataclasses
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.checker.liveness import LivenessChecker as JaxLiveness
from raft_tpu.models import reconfig_raft as ref_ar
from raft_tpu.ops.symmetry import Canonicalizer as JaxCanonicalizer
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.checker.liveness import LivenessChecker
from raft_tpu_torch.convert import fps_from_u64, params_from_reference
from raft_tpu_torch.models.reconfig_raft import ReconfigRaftModel, ReconfigRaftParams
from raft_tpu_torch.ops.hashing import INT64_MAX
from raft_tpu_torch.ops.symmetry import Canonicalizer, msg_perm_spec, permute_states

from test_expand_sparse import DenseShim
from test_torch_reconfig import PARAMS, PARAMS4, _models, _pair, dense_expand

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

INV = ("LeaderHasAllAckedValues", "NoLogDivergence", "MaxOneReconfigurationAtATime")


@functools.lru_cache(maxsize=None)
def _states(name):
    """(JAX model, port model, states, permuted states): the reachable
    batch and random successors up to eight steps past it (bags with
    AppendEntries, snapshots and config entries), and a server-permuted
    copy of every state (one permutation per block)."""
    jm, tm, batch, _ = _pair(name)
    rng = np.random.default_rng(len(name))
    rows, parts = batch[:40], [batch]
    for _ in range(8):
        succs, valid, _rank, _ovf = tm.expand(torch.from_numpy(rows))
        nxt = succs[valid].numpy()
        rows = nxt[rng.choice(len(nxt), min(len(nxt), 40), replace=False)]
        parts.append(rows)
    base = np.concatenate(parts)
    sigmas = [np.asarray(s) for s in itertools.permutations(range(tm.p.n_servers))][1:]
    perm = np.concatenate([
        permute_states(tm.layout, tm.packer, part, sigma, msg_perm_spec(tm))
        for part, sigma in zip(np.array_split(base, len(sigmas)), sigmas)])
    return jm, tm, np.ascontiguousarray(base), np.ascontiguousarray(perm)


def _bitmask_records(tm, states):
    """How many occupied slots carry a nonzero member set in a bitmask
    field (a SnapshotRequest's mmembers or an entry's set)."""
    words = tuple(tm.layout.get(states, f"msg_w{k}") for k in range(tm.n_words))
    occ = words[0] != (1 << 30)
    fields = [f for f, kind in msg_perm_spec(tm) if kind == "server_bitmask"]
    return int(sum(((tm.packer.unpack(words, f) > 0) & occ).sum() for f in fields))


@pytest.mark.parametrize("name", list(PARAMS))
def test_fingerprints_match_reference_canonicalizer(name):
    jm, tm, base, perm = _states(name)
    assert _bitmask_records(tm, base) > 50
    states = np.concatenate([base, perm])
    canon = {}
    for symmetry in (True, False):
        jc = JaxCanonicalizer.for_model(jm, symmetry=symmetry, seed=0)
        tc = Canonicalizer.for_model(tm, symmetry=symmetry, seed=0)
        assert tc.spec == jc.msg_perm_spec
        want = fps_from_u64(np.asarray(jax.device_get(jc.fingerprints(states))))
        assert torch.equal(tc.canon_plain(torch.from_numpy(states)), want)
        canon[symmetry] = want
        if symmetry:  # a server permutation keeps the canonical fingerprint
            n = len(base)
            assert torch.equal(want[:n], want[n:])
            assert len(set(want[:n].tolist())) > n // 3  # the states are not all one
    # the memo path (a cold, then a warm 256-row table; the highest lane wins)
    tc = Canonicalizer.for_model(tm)
    memo = torch.full((256, 2), INT64_MAX, dtype=torch.int64)
    valid = torch.from_numpy(np.arange(len(states)) % 7 != 3)
    for _ in range(2):
        fps, _hits = tc.fingerprints_memo_plain(torch.from_numpy(states), valid, memo)
        assert torch.equal(fps, torch.where(valid, canon[True], INT64_MAX))


@pytest.mark.parametrize("name", list(PARAMS))
def test_fingerprints_without_the_bitmask_remap_differ(name):
    """The remap matters: a canon that treats the member sets as opaque
    fields gives some permuted pair different fingerprints."""
    _jm, tm, base, perm = _states(name)
    spec = tuple((f, k) for f, k in msg_perm_spec(tm) if k != "server_bitmask")
    plain = Canonicalizer(tm.layout, tm.packer, spec=spec)
    a, b = (plain.canon_plain(torch.from_numpy(x)) for x in (base, perm))
    assert not torch.equal(a, b)


def test_canon_refuses_nine_servers():
    # the five-server canon (canon_tiered, CT_MAX_S) takes up to 8 servers
    p = ReconfigRaftParams(n_servers=9, n_values=1, init_cluster_size=3, max_elections=1,
                           max_restarts=0, max_values_per_term=1, max_add_reconfigs=1,
                           max_remove_reconfigs=1, min_cluster_size=2, max_cluster_size=9,
                           msg_slots=8)
    with pytest.raises(NotImplementedError, match="at most 8 servers"):
        Canonicalizer.for_model(ReconfigRaftModel(p))


@pytest.mark.parametrize("name", list(PARAMS))
def test_device_bfs_matches_reference_dense_engine(name):
    jm, tm = _models(PARAMS[name])
    depth = 6
    ref = JaxDeviceBFS(DenseShim(jm), invariants=INV, chunk=8, frontier_cap=1 << 11,
                       journal_cap=1 << 13).run(max_depth=depth)
    res = DeviceBFS(tm, invariants=INV, chunk=64, frontier_cap=1 << 11, journal_cap=1 << 13,
                    max_seen_cap=1 << 16, canon_memo_cap=1 << 12, device="cpu").run(
        max_depth=depth)
    assert res.violation is None and ref.violation is None
    assert (res.distinct, res.total, res.depth, res.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert res.depth_counts == ref.depth_counts and res.coverage == ref.coverage
    assert res.distinct > 200


def test_reconfiguration_completes_equals_reference():
    """AddRemove's ReconfigurationCompletes at MaxElections 0 (the spec's
    own mode, tests/test_liveness_families.py:71-75): the same graph
    (states, edge arrays), P and Q over it and verdict (it holds)."""
    jp = ref_ar.ReconfigRaftParams(
        n_servers=3, n_values=1, init_cluster_size=2, max_elections=0, max_restarts=0,
        max_values_per_term=1, max_add_reconfigs=1, max_remove_reconfigs=0,
        min_cluster_size=2, max_cluster_size=3, msg_slots=32)
    jm = ref_ar.cached_model(jp)
    tm = ReconfigRaftModel(params_from_reference(dataclasses.asdict(jp)))
    prop = ("ReconfigurationCompletes",)
    jc = JaxLiveness(jm, prop, chunk=256)
    jr = jc.run()
    tc = LivenessChecker(tm, prop, chunk=256, device="cpu")
    tr = tc.run()
    assert (tr.distinct, tr.total_edges) == (jr.distinct, jr.total_edges) and tr.distinct > 100
    for a in ("_esrc", "_edst", "_ecand"):
        assert np.array_equal(getattr(jc, a), getattr(tc, a)), a
    assert np.array_equal(jc._states, tc._states.numpy())
    assert tr.violation is None and jr.violation is None
    (_l, p, q), (_jl, jp_fn, jq_fn) = tm.liveness[prop[0]][0], jm.liveness[prop[0]][0]
    assert np.array_equal(tc._eval(p), np.asarray(jp_fn(jc._states)))
    assert np.array_equal(tc._eval(q), np.asarray(jq_fn(jc._states)))


# The card's BFS of chip_smoke.py's four-server AddRemove cfg stops at depth
# 21 on LeaderHasAllAckedValues (gid 14,321,947): the candidates its
# journal records from the initial state (the reference's pin reaches depth
# 17 only, so the reference's model replays the trace instead)
ADDREMOVE_COUNTEREXAMPLE = (35, 12, 20, 66, 80, 80, 80, 82, 80, 16, 49, 22, 84, 81, 16, 77, 6, 85,
                            85, 86, 10)


def test_addremove_counterexample_replays_in_reference():
    """Each step of the counterexample is an enabled candidate of the
    reference's dense expand with the port's successor, and only the last
    state breaks LeaderHasAllAckedValues (ResetWithSameIdentity empties a
    voter's log; a server without the acked value wins the old
    configuration's quorum)."""
    jm, tm = _models(PARAMS4["reconfig"])
    row = jm.init_states()[:1].astype(np.int32)
    inv = "LeaderHasAllAckedValues"
    for k, cand in enumerate(ADDREMOVE_COUNTEREXAMPLE):
        succs, valid, _rank, ovf = dense_expand(jm, row)
        got = tm.expand(torch.from_numpy(row))[0].numpy()
        assert valid[0, cand] and not ovf[0, cand], k
        assert np.array_equal(got[0, cand], succs[0, cand]), k
        row = np.ascontiguousarray(succs[:1, cand])
        last = k == len(ADDREMOVE_COUNTEREXAMPLE) - 1
        assert bool(np.asarray(jm.invariants[inv](row))[0]) != last, k
        assert bool(tm.invariants[inv](torch.from_numpy(row))[0]) != last, k
    assert tm.action_label(3, ADDREMOVE_COUNTEREXAMPLE[-1]) == "BecomeLeader(2,)"
