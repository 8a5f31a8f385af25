"""The pull family's canonical fingerprints and BFS engine on the CPU
against the JAX reference: the v5 fingerprints of reachable PullRaft and
PullRaftVariant2 states against the reference's Canonicalizer (the
family's server-valued fields are state fields of the kinds the canon
already remaps, leader and votedFor per_server_val, votesGranted
server_bitmask, the vle_* pairs per_server_pair; its message keys name
servers only in msource and mdest, so no canon needs a message remap), and
the port's DeviceBFS against the reference's dense DeviceBFS (counts,
depth counts, terminal, coverage)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_tpu.checker.device_bfs import DeviceBFS as JaxDeviceBFS
from raft_tpu.models.pull_raft import cached_model
from raft_tpu.ops.symmetry import Canonicalizer as JaxCanonicalizer
from raft_tpu_torch.checker.device_bfs import DeviceBFS
from raft_tpu_torch.convert import fps_from_u64, params_from_reference
from raft_tpu_torch.models.pull_raft import PullRaftModel
from raft_tpu_torch.ops.symmetry import Canonicalizer

from test_expand_sparse import DenseShim
from test_torch_pull_raft import INV, PARAMS, _pair

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["pull", "pull2_restart"])
def test_fingerprints_match_reference_canonicalizer(name):
    jm, tm, batch, (succs, valid, *_rest) = _pair(name)
    states = np.concatenate([batch, succs[valid][:200]])
    for symmetry in (True, False):
        jc = JaxCanonicalizer.for_model(jm, symmetry=symmetry, seed=0)
        tc = Canonicalizer.for_model(tm, symmetry=symmetry, seed=0)
        want = fps_from_u64(np.asarray(jax.device_get(jc.fingerprints(states))))
        assert torch.equal(tc.canon_plain(torch.from_numpy(states)), want)
        assert torch.equal(tc.fingerprints(torch.from_numpy(states)), want)
    # no message remap beyond msource/mdest: the reference declares none
    assert getattr(jm, "msg_perm_spec", None) is None
    assert not getattr(jm, "msg_server_nil_fields", ())


@pytest.mark.parametrize("name", ["pull", "pull2_restart"])
def test_device_bfs_matches_reference_dense_engine(name):
    jp = dataclasses.replace(PARAMS[name], max_elections=1)
    caps = dict(chunk=256, frontier_cap=1 << 13, journal_cap=1 << 15)
    ref = JaxDeviceBFS(DenseShim(cached_model(jp)), invariants=INV, **caps).run(max_depth=8)
    tm = PullRaftModel(params_from_reference(dataclasses.asdict(jp)))
    res = DeviceBFS(tm, invariants=INV, max_seen_cap=1 << 20, canon_memo_cap=1 << 12,
                    device="cpu", **caps).run(max_depth=8)
    assert ref.violation is None and res.violation is None
    assert (res.distinct, res.total, res.depth, res.terminal) == (
        ref.distinct, ref.total, ref.depth, ref.terminal)
    assert res.depth_counts == ref.depth_counts and res.coverage == ref.coverage
    assert res.depth == 8 and res.distinct > 30
