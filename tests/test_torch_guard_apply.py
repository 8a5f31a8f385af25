"""The guard-first expand of the port (raft_tpu_torch/ops/expand.py: the
plain versions of the Raft family's guard, apply and fold) against the JAX
reference, bit for bit, for the core, fsync and flexible parameter sets:

  - the binding groups (``sparse_groups``) against the reference's;
  - the guard grid against the valid/rank/ovf of the dense
    ``jax.vmap(_expand1)`` (``guards1`` itself does not build under the
    installed jax; the dense path equals it by construction,
    raft_tpu/models/base.py:251-263);
  - the apply against the reference's ``RaftModel.sparse_apply`` at the
    same worklist, drop lanes included;
  - the fold against the reference's formulas
    (raft_tpu/checker/device_bfs.py:442-460,501-506);
  - a FlexibleRaft run whose quorums do not intersect, against the JAX
    dense engine: the same violation, gid, depth, trace and counts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.checker.util import I32_MAX, dense_prefix_sel
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.raft import RaftModel
from raft_tpu_torch.ops.expand import apply, fold, guard

from test_expand_sparse import DenseShim
from test_torch_raft_model import VARIANTS, _pair as _make_pair

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

INV = ("LeaderHasAllAckedValues", "NoLogDivergence")


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, port model, reachable batch, its dense (succs, valid,
    rank, ovf) as numpy), shared by this file's tests."""
    jm, tm, batch = _make_pair(name)
    return jm, tm, batch, [np.array(x) for x in jax.device_get(jm.expand(batch))]


def _worklist(valid: np.ndarray, extra_drops: int) -> np.ndarray:
    """sel of the valid lanes in lane order, then ``extra_drops`` drop
    lanes (C * A), as the engine's compaction lays them out."""
    C, A = valid.shape
    sel, n = dense_prefix_sel(torch.from_numpy(valid.reshape(-1).copy()),
                              int(valid.sum()) + extra_drops, C * A)
    assert int(n) == valid.sum()
    return sel.numpy()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sparse_groups_match_reference(name):
    jm, tm, _batch, _dense = _pair(name)
    got, want = tm.sparse_groups(), jm.sparse_groups()
    assert [(g.name, g.off, g.n) for g in got] == [(g.name, g.off, g.n) for g in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.params, w.params), g.name
    assert sum(g.n for g in got) == tm.A


@pytest.mark.parametrize("name", list(VARIANTS))
def test_guard_matches_dense_reference(name):
    jm, tm, batch, (_succs, valid, rank, ovf) = _pair(name)
    n_live = len(batch) - 5  # an all-dead chunk tail
    cov = torch.zeros((len(tm.ACTION_NAMES), 3), dtype=torch.int64)
    gv, gr, go, scal = guard(tm, torch.from_numpy(batch), n_live, cov)
    live = np.arange(len(batch)) < n_live
    want_v = valid & live[:, None]
    assert np.array_equal(gv.numpy(), want_v)
    assert np.array_equal(gr.numpy(), rank)
    assert np.array_equal(go.numpy(), ovf)
    assert scal.tolist() == [int(want_v.sum()), int((live & ~want_v.any(1)).sum()),
                             int((want_v & ovf).any())]
    # enabled / fired coverage: the reference's segment sums (device_bfs.py:442-452)
    K = len(tm.ACTION_NAMES)
    en = (rank[:, :, None] == np.arange(K)) & want_v[:, :, None]
    fired = np.bincount(np.where(want_v, rank, K).reshape(-1), minlength=K + 1)[:K]
    assert np.array_equal(cov[:, 0].numpy(), en.any(axis=1).sum(0))
    assert np.array_equal(cov[:, 1].numpy(), fired)
    assert not cov[:, 2].any()
    assert want_v.sum() > len(batch)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_apply_matches_reference_sparse_apply(name):
    jm, tm, batch, (_succs, valid, _rank, _ovf) = _pair(name)
    C = len(batch)
    sel = _worklist(valid, extra_drops=9)
    selv = sel < C * jm.A
    plan = jm.sparse_plan(C, len(sel))
    want, apply_ovf = jax.device_get(jax.jit(jm.sparse_apply, static_argnums=3)(
        jnp.asarray(batch), jnp.asarray(sel), jnp.asarray(selv), plan))
    got = apply(tm, torch.from_numpy(batch), torch.from_numpy(sel)).numpy()
    assert not apply_ovf
    assert np.array_equal(got, np.asarray(want))
    assert not got[~selv].any() and got[selv].any()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fold_matches_reference_formulas(name):
    jm, tm, batch, (_succs, valid, rank, _ovf) = _pair(name)
    C, A = batch.shape[0], jm.A
    sel = _worklist(valid, extra_drops=9)
    flatc = apply(tm, torch.from_numpy(batch), torch.from_numpy(sel))
    rng = np.random.default_rng(3)
    new = (rng.random(len(sel)) < 0.6) & (sel < C * A)
    jcount = 1234
    invariants = tuple(jm.invariants)
    K = len(tm.ACTION_NAMES)
    # the reference's formulas, in jax
    rk = jnp.where(valid, rank, K)
    flat_rk = jnp.concatenate([rk.reshape(-1), jnp.full((1,), K, rk.dtype)])[sel]
    new_k = jax.ops.segment_sum(jnp.asarray(new, jnp.int64), jnp.where(new, flat_rk, K),
                                num_segments=K + 1)[:K]
    npos = jnp.cumsum(new) - 1
    jidx = jnp.where(new, jcount + npos, I32_MAX)
    want_viol = [int(jnp.min(jnp.where(new & ~jm.invariants[n](flatc.numpy()), jidx, I32_MAX)))
                 for n in invariants]
    cov = torch.zeros((K, 3), dtype=torch.int64)
    viol = torch.full((len(invariants),), I32_MAX, dtype=torch.int64)
    fold(tm, flatc, torch.from_numpy(new), torch.tensor([jcount]), viol, invariants,
              cov=cov, sel=torch.from_numpy(sel), valid=torch.from_numpy(valid),
              rank=torch.from_numpy(rank))
    assert viol.tolist() == want_viol
    assert np.array_equal(cov[:, 2].numpy(), np.asarray(new_k))
    assert not cov[:, :2].any() and cov[:, 2].sum() == new.sum()


def test_flexible_quorum_violation_matches_reference():
    # ElectionQuorumSize 2 + ReplicationQuorumSize 1 <= 3 servers: the
    # quorums need not intersect, so a value acked by one server can be
    # missing from a later leader's log
    jp = RaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=16,
                    election_quorum=2, replication_quorum=1, strict_send_once=True,
                    has_pending_response=False, trunc_term_mismatch=True)
    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 14)
    ref = JaxDeviceBFS(DenseShim(cached_model(jp)), invariants=INV, **caps).run()
    tm = RaftModel(params_from_reference(dataclasses.asdict(jp)))
    res = DeviceBFS(tm, invariants=INV, max_seen_cap=1 << 20, canon_memo_cap=1 << 12,
                    device="cpu", **caps).run()
    v, rv = res.violation, ref.violation
    assert v is not None and v.invariant == "LeaderHasAllAckedValues"
    assert (v.invariant, v.global_id, v.depth) == (rv.invariant, rv.global_id, rv.depth)
    assert res.trace == ref.trace and len(res.trace) == v.depth + 1
    assert (res.distinct, res.total, res.depth_counts) == (
        ref.distinct, ref.total, ref.depth_counts)
