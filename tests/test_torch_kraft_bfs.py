"""KRaft's canonical fingerprints, BFS engine and liveness graph on the CPU
against the JAX reference.

KRaft's message records carry ``mleader`` (0 = Nil, i + 1 = server i), a
Nil-able server field the canon remaps by the ``server_nil`` kind after
``msource`` and ``mdest`` (the reference's ``msg_perm_spec``; the field
order salts the signatures). So the v5 fingerprints of KRaft states whose
bags hold ``mleader`` records, Nil and not, and of their server-permuted
copies, must equal the reference ``Canonicalizer``'s at three servers (the
full-S! memo path) and at five (the signature-tiered path, also through
the device code of csrc/canon_tiers.cuh compiled for the host). Then the
port's DeviceBFS against the reference's dense DeviceBFS (counts, depth
counts, terminal, coverage), and the two-server liveness graph and verdict
against the reference's LivenessChecker.
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
from raft_tpu.models.kraft import KRaftParams, cached_model
from raft_tpu.ops.symmetry import Canonicalizer as JaxCanonicalizer
from raft_tpu.oracle.kraft_oracle import KRaftOracle
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.checker.liveness import LivenessChecker
from raft_tpu_torch.convert import fps_from_u64, params_from_reference
from raft_tpu_torch.models.kraft import KRaftModel
from raft_tpu_torch.ops.symmetry import Canonicalizer, msg_perm_spec, permute_states

from conftest import collect_states
from test_expand_sparse import DenseShim
from test_torch_canon_tiers import _host_run, lib  # noqa: F401 - lib is a fixture
from test_torch_kraft import INV, PARAMS

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

LAYOUTS = {
    "three": KRaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0,
                         msg_slots=56),
    "five": KRaftParams(n_servers=5, n_values=1, max_elections=2, max_restarts=0,
                        msg_slots=48),
}


@functools.lru_cache(maxsize=None)
def _states(layout):
    """(JAX model, port model, states): reachable states and random
    successors up to nine (three servers) or eighteen (five) steps past
    them (so bags hold RequestVote and Fetch responses with mleader Nil and
    not), and a server-permuted copy of every state (one permutation per
    block)."""
    jp = LAYOUTS[layout]
    jm = cached_model(jp)
    tm = KRaftModel(params_from_reference(dataclasses.asdict(jp)))
    oracle = KRaftOracle(jp.n_servers, jp.n_values, jp.max_elections, jp.max_restarts)
    rows = np.stack([jm.encode(s) for s in collect_states(oracle, 5, cap=40)]).astype(np.int32)
    rng = np.random.default_rng(len(layout))
    parts = [rows]
    for _ in range(9 if jp.n_servers == 3 else 18):
        succs, valid, _rank, _ovf = tm.expand(torch.from_numpy(rows))
        nxt = succs[valid].numpy()
        rows = nxt[rng.choice(len(nxt), min(len(nxt), 40), replace=False)]
        parts.append(rows)
    base = np.concatenate(parts)
    sigmas = [np.asarray(s) for s in itertools.permutations(range(jp.n_servers))][1::7]
    perm = np.concatenate([
        permute_states(tm.layout, tm.packer, part, sigma, msg_perm_spec(tm))
        for part, sigma in zip(np.array_split(base, len(sigmas)), sigmas)])
    return jm, tm, np.ascontiguousarray(base), np.ascontiguousarray(perm)


def _mleaders(tm, states):
    """The mleader values of the states' occupied bag slots."""
    lay = tm.layout
    hi, lo = lay.get(states, "msg_hi"), lay.get(states, "msg_lo")
    occ = hi != (1 << 30)
    return tm.packer.unpack(hi, lo, "mleader")[occ & (tm.packer.unpack(hi, lo, "mtype") % 2 == 0)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fingerprints_match_reference_canonicalizer(layout):
    jm, tm, base, perm = _states(layout)
    leaders = _mleaders(tm, base)
    assert (leaders == 0).any() and (leaders > 0).any()  # Nil and non-Nil mleader records
    assert msg_perm_spec(tm) == (("msource", "server"), ("mdest", "server"),
                                 ("mleader", "server_nil"))
    states = np.concatenate([base, perm])
    for symmetry in (True, False):
        jc = JaxCanonicalizer.for_model(jm, symmetry=symmetry, seed=0)
        tc = Canonicalizer.for_model(tm, symmetry=symmetry, seed=0)
        assert tc.spec == jc.msg_perm_spec
        want = fps_from_u64(np.asarray(jax.device_get(jc.fingerprints(states))))
        assert torch.equal(tc.canon_plain(torch.from_numpy(states)), want)
        assert torch.equal(tc.fingerprints(torch.from_numpy(states)), want)
        if symmetry:  # a server permutation keeps the canonical fingerprint
            n = len(base)
            assert torch.equal(want[:n], want[n:])
            assert len(set(want[:n].tolist())) > n // 3  # the states are not all one
    if layout == "five":
        jsig = np.asarray(jax.device_get(jc._signatures(states)))
        tsig = Canonicalizer.for_model(tm).signatures_plain(torch.from_numpy(states))
        assert torch.equal(tsig, fps_from_u64(jsig.reshape(-1)).reshape(tsig.shape))


def test_fingerprints_without_the_nil_remap_differ():
    """The remap matters: a canon that treats mleader as an opaque field
    gives some permuted pair different fingerprints."""
    _jm, tm, base, perm = _states("three")
    plain = Canonicalizer(tm.layout, tm.packer, spec=(("msource", "server"),
                                                      ("mdest", "server")))
    a, b = (plain.canon_plain(torch.from_numpy(x)) for x in (base, perm))
    assert not torch.equal(a, b)


def test_host_compiled_tiers_on_kraft_states(lib):  # noqa: F811 - the fixture
    jm, tm, base, perm = _states("five")
    states = np.concatenate([base, perm])
    tc = Canonicalizer.for_model(tm)
    sig, raw, canon = _host_run(lib, tc, states)
    assert torch.equal(sig, tc.signatures_plain(torch.from_numpy(states)))
    assert torch.equal(raw, tc.raw_fingerprints(torch.from_numpy(states)))
    assert torch.equal(canon, tc.canon_plain(torch.from_numpy(states)))


@pytest.mark.parametrize("name", list(PARAMS))
def test_device_bfs_matches_reference_dense_engine(name):
    jp = dataclasses.replace(PARAMS[name], max_elections=1)
    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 15)
    ref = JaxDeviceBFS(DenseShim(cached_model(jp)), invariants=INV, **caps).run(max_depth=8)
    tm = KRaftModel(params_from_reference(dataclasses.asdict(jp)))
    res = DeviceBFS(tm, invariants=INV, max_seen_cap=1 << 20, canon_memo_cap=1 << 12,
                    device="cpu", **caps).run(max_depth=8)
    # the restart set reaches IllegalState at depth 6: the same violation
    assert (res.violation and dataclasses.astuple(res.violation)) == (
        ref.violation and dataclasses.astuple(ref.violation))
    assert (res.distinct, res.total, res.depth, res.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert res.depth_counts == ref.depth_counts and res.coverage == ref.coverage
    assert res.distinct > 50


def test_liveness_graph_and_verdict_equal_reference():
    """The two-server graph of tests/test_liveness_families.py with
    ValuesNotStuck (symmetry off): the same states, edge arrays, verdict,
    and predicate values over the graph."""
    jp = KRaftParams(2, 1, 1, 0, msg_slots=16)
    jm = cached_model(jp)
    tm = KRaftModel(params_from_reference(dataclasses.asdict(jp)))
    jc = JaxLiveness(jm, ("ValuesNotStuck",), chunk=256)
    jr = jc.run()
    tc = LivenessChecker(tm, ("ValuesNotStuck",), chunk=256, device="cpu")
    tr = tc.run()
    assert (tr.distinct, tr.total_edges) == (jr.distinct, jr.total_edges)
    for a in ("_esrc", "_edst", "_ecand"):
        assert np.array_equal(getattr(jc, a), getattr(tc, a)), a
    assert np.array_equal(jc._states, tc._states.numpy())
    assert (tr.violation is None) == (jr.violation is None)
    for (lab, _p, q), (jlab, _jp, jq) in zip(tm.liveness["ValuesNotStuck"],
                                             jm.liveness["ValuesNotStuck"]):
        assert lab == jlab
        assert np.array_equal(tc._eval(q), np.asarray(jq(jc._states)))
