"""The port's network-fault actions (``--net-faults``: DuplicateMessage and
DropMessage, Raft.tla:508-523) against the JAX reference.

The reference's dense ``jax.vmap(_expand1)`` with ``net_faults=True`` is
the anchor (its guard-first path is broken under the installed jax, so
the reference's engines run through ``DenseShim``): the port's plain
expand and the device code of csrc/raft_actions.cuh (built for the CPU
with g++, as tests/test_torch_actions_host.py does) on reachable states
and on rows whose delivery counts cover 0, 1, max_msg_copies and beyond
(the device code's group apply too, with serial groups of 1 to 32);
the port's DeviceBFS on the CPU against the reference's dense DeviceBFS;
the registry's and the CLI's gate for the specs without the actions.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.models.registry import build_from_cfg as jax_build_from_cfg
from raft_tpu.utils.cfg import CfgError as JaxCfgError, parse_cfg as jax_parse_cfg
from raft_tpu_torch.__main__ import main as cli_main
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.raft import GROUP_IDS, SPEC_SCALARS, RaftModel
from raft_tpu_torch.models.registry import NET_FAULT_SPECS, build_from_cfg
from raft_tpu_torch.ops.packing import EMPTY
from raft_tpu_torch.utils.cfg import CfgError, parse_cfg

from test_expand_sparse import DenseShim
from test_torch_actions_host import (  # noqa: F401 - lib: the g++-built device code
    _ptr, check_group_apply, lib,
)
from test_torch_kernels_cuda import net_fault_rows

# one intra-op thread: tier-1 runs several test workers side by side
torch.set_num_threads(1)

# tests/test_net_faults.py:18-21
PARAMS = RaftParams(n_servers=2, n_values=1, max_elections=1, max_restarts=0, msg_slots=12,
                    net_faults=True)
VARIANTS = {
    "pair": PARAMS,
    "core": RaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=1, msg_slots=16,
                       net_faults=True),
    # RaftFsync: the fault ranks follow its 14-entry table
    "fsync": RaftParams(n_servers=3, n_values=1, max_elections=1, max_restarts=1, msg_slots=16,
                        strict_send_once=True, has_pending_response=False,
                        trunc_term_mismatch=True, has_fsync=True, fsync_leader_quorum=True,
                        fsync_follower_reply=True, net_faults=True),
}
INV = ("LeaderHasAllAckedValues", "NoLogDivergence")
RAFT_CFG = """\
CONSTANTS
    s1 = s1
    s2 = s2
    v1 = v1
    Server = { s1, s2 }
    Value = { v1 }
    MaxElections = 1
    MaxRestarts = 0
SYMMETRY symmServers
INVARIANT
    LeaderHasAllAckedValues
    NoLogDivergence
"""


def _reachable(jm, waves: int = 5, cap: int = 240) -> np.ndarray:
    """Distinct states of the reference's first dense waves (raw rows, so
    records at every delivery count the faults reach)."""
    front = np.asarray(jm.init_states())
    seen = {r.tobytes(): r for r in front}
    B = 128
    for _ in range(waves):
        nxt = []
        for off in range(0, len(front), B):
            part = front[off:off + B]
            pad = np.concatenate([part, np.repeat(part[-1:], B - len(part), axis=0)])
            succs, valid, _, _ = (np.array(x) for x in jax.device_get(jm.expand(pad)))
            valid[len(part):] = False
            for row in succs[valid]:
                if row.tobytes() not in seen:
                    seen[row.tobytes()] = row
                    nxt.append(row)
        if not nxt:
            break
        front = np.array(nxt[:cap], dtype=np.int32)
    rows = np.array(list(seen.values()), dtype=np.int32)
    return rows[np.random.default_rng(0).permutation(len(rows))[:cap]]


_cache: dict = {}


def _pair(name):
    if name not in _cache:
        jp = VARIANTS[name]
        jm = cached_model(jp)
        tm = RaftModel(params_from_reference(dataclasses.asdict(jp)))
        _cache[name] = (jm, tm, net_fault_rows(tm, _reachable(jm), seed=len(name)))
    return _cache[name]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_action_table_matches_reference(name):
    jm, tm, _ = _pair(name)
    assert tm.ACTION_NAMES == jm.ACTION_NAMES and tm.bindings == jm.bindings
    assert tm.A == jm.A and (tm._r_dup, tm._r_drop) == (jm._r_dup, jm._r_drop)
    assert (tm._r_dup, tm._r_drop) == ((14, 15) if tm.p.has_fsync else (12, 13))
    spec, cand, _ = tm.kernel_spec("cpu")
    sv = dict(zip(SPEC_SCALARS, spec.tolist()))
    assert sv["net_faults"] == 1 and sv["max_msg_copies"] == 2
    assert sv["c_max_elections"] == sv["c_max_restarts"] == -1  # no fleet lanes
    M = tm.p.msg_slots
    tail = cand[-2 * M:].numpy()
    assert tail[:M, 0].tolist() == [GROUP_IDS["DuplicateMessage"]] * M
    assert tail[M:, 0].tolist() == [GROUP_IDS["DropMessage"]] * M
    assert tail[:M, 1].tolist() == list(range(M)) == tail[M:, 1].tolist()
    assert set(tail[:M, 3]) == {tm._r_dup} and set(tail[M:, 3]) == {tm._r_drop}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_expand_bit_identical(name):
    jm, tm, rows = _pair(name)
    want = [np.asarray(x) for x in jax.device_get(jm.expand(rows))]
    got = [x.numpy() for x in tm.expand(torch.from_numpy(rows))]
    for label, w, g in zip(("succs", "valid", "rank", "ovf"), want, got):
        assert np.array_equal(w, g), label
    valid, rank = want[1], want[2]
    for r in (tm._r_dup, tm._r_drop):
        assert (valid & (rank == r)).any(), tm.ACTION_NAMES[r]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_device_code_matches_reference(lib, name):  # noqa: F811
    """ra_action<false> (the guard) and ra_action<true> (the apply) of
    csrc/raft_actions.cuh over every (state, candidate) pair equal the
    reference's dense expand, the fault groups' lanes included."""
    jm, tm, rows = _pair(name)
    want = [np.asarray(x) for x in jax.device_get(jm.expand(rows))]
    spec, cand, _ = (np.ascontiguousarray(t.numpy()) for t in tm.kernel_spec("cpu"))
    C, A, W = len(rows), tm.A, tm.layout.W
    for write in (0, 1):
        succ = np.zeros((C, A, W), np.int32)
        valid, rank = np.zeros((C, A), bool), np.zeros((C, A), np.int32)
        ovf = np.zeros((C, A), bool)
        lib.host_expand(_ptr(rows), C, _ptr(spec), _ptr(cand), A, write, _ptr(succ),
                        _ptr(valid), _ptr(rank), _ptr(ovf))
        for label, w, g in zip(("valid", "rank", "ovf"), want[1:], (valid, rank, ovf)):
            assert np.array_equal(w, g), (label, write)
        if write:
            assert np.array_equal(want[0], succ)


@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_group_apply_matches_reference(lib, name, G):  # noqa: F811
    """RaftFaultFamily::apply, the action of the card's raft_nf_apply (a tile
    of G threads a worklist lane), with a serial group of G members, equals
    the reference's dense expand on every (state, candidate) pair, the fault
    groups' lanes included."""
    jm, tm, rows = _pair(name)
    want = [np.asarray(x) for x in jax.device_get(jm.expand(rows))]
    check_group_apply(lib, tm, rows, want, G, 1)
    valid, rank = want[1], want[2]
    for r in (tm._r_dup, tm._r_drop):
        assert (valid & (rank == r)).any(), tm.ACTION_NAMES[r]


def test_fault_semantics():
    """Duplicate: count 1 -> 2, refused at max_msg_copies; drop: count - 1,
    the count-0 record kept in the domain and refused again; neither fires
    on an empty slot nor overflows."""
    _, tm, rows = _pair("pair")
    lay, M = tm.layout, tm.p.msg_slots
    hs, cs = lay.sl("msg_hi"), lay.sl("msg_cnt")
    dup = slice(tm.A - 2 * M, tm.A - M)
    drop = slice(tm.A - M, tm.A)
    succs, valid, rank, ovf = (x.numpy() for x in tm.expand(torch.from_numpy(rows)))
    assert not ovf[:, dup].any() and not ovf[:, drop].any()
    occ, cnt = rows[:, hs] != EMPTY, rows[:, cs]
    assert np.array_equal(valid[:, dup], occ & (cnt >= 1) & (cnt < 2))
    assert np.array_equal(valid[:, drop], occ & (cnt >= 1))
    for c, want_dup, want_drop in ((0, False, False), (1, True, True), (2, False, True)):
        r = int(np.nonzero(occ[:, 0] & (cnt[:, 0] == c))[0][0])
        assert valid[r, dup][0] == want_dup and valid[r, drop][0] == want_drop, c
    b, m = np.argwhere(valid[:, drop])[0]
    after = succs[b, tm.A - M + m]
    assert after[cs][m] == rows[b, cs][m] - 1 and np.array_equal(after[hs], rows[b, hs])
    b, m = np.argwhere(valid[:, dup])[0]
    assert succs[b, tm.A - 2 * M + m][cs][m] == rows[b, cs][m] + 1


def test_device_bfs_matches_reference():
    """The port's DeviceBFS on the CPU against the reference's dense
    DeviceBFS at tests/test_net_faults.py's constants to depth 4: counts,
    depth counts and coverage, both fault actions fired."""
    depth = 4
    caps = dict(chunk=256, valid_per_state=32, frontier_cap=1 << 12, journal_cap=1 << 14)
    ref = JaxDeviceBFS(DenseShim(cached_model(PARAMS)), invariants=INV, symmetry=True,
                       seen_cap=1 << 14, **caps).run(max_depth=depth)
    tm = RaftModel(params_from_reference(dataclasses.asdict(PARAMS)))
    got = DeviceBFS(tm, invariants=INV, symmetry=True, max_seen_cap=1 << 20,
                    canon_memo_cap=1 << 12, device="cpu", **caps).run(max_depth=depth)
    assert (got.distinct, got.total, got.depth, got.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert got.depth_counts == ref.depth_counts and got.coverage == ref.coverage
    assert got.violation is None and ref.violation is None
    for r in (tm._r_dup, tm._r_drop):
        assert got.coverage[r][1] > 0, tm.ACTION_NAMES[r]


@pytest.mark.parametrize("spec", ["PullRaft", "KRaft", "RaftWithReconfigAddRemove"])
def test_registry_gate_matches_reference(spec):
    """--net-faults is refused for every spec outside the Raft family, with
    the reference's message."""
    assert NET_FAULT_SPECS == ("Raft", "FlexibleRaft", "RaftFsync")
    with pytest.raises(CfgError) as got:
        build_from_cfg(parse_cfg("x.cfg", text=RAFT_CFG), spec=spec, net_faults=True)
    with pytest.raises(JaxCfgError) as want:
        jax_build_from_cfg(jax_parse_cfg("x.cfg", text=RAFT_CFG), spec=spec, net_faults=True)
    assert str(got.value) == str(want.value)
    assert "only lowered for the Raft family" in str(got.value)


def test_cli_net_faults(tmp_path, capsys):
    """The CLI: BFS with --net-faults on the CPU prints the reference's
    counts (the depth-4 run above: 12 distinct); a non-Raft spec exits 64."""
    cfg = tmp_path / "Raft.cfg"
    cfg.write_text(RAFT_CFG)
    args = [str(cfg), "--device", "cpu", "--net-faults", "--msg-slots", "12", "--chunk", "256",
            "--max-depth", "4", "--json"]
    assert cli_main(args) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "distinct=12 total=17 depth=4" in out[0]
    assert cli_main(args + ["--spec", "PullRaft"]) == 64
    assert "only lowered for the Raft family" in capsys.readouterr().err
