"""The port's batched Raft expand and invariants (raft_tpu_torch/models/raft.py)
against the JAX reference's ``jax.vmap(RaftModel._expand1)`` on reachable
state batches, bit for bit, for the three specs one RaftModel serves."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.oracle.raft_oracle import oracle_for
from raft_tpu_torch.convert import params_from_reference
from raft_tpu_torch.models.raft import RaftModel as TorchRaftModel

from conftest import collect_states

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

VARIANTS = {
    "core": RaftParams(n_servers=3, n_values=1, max_elections=2, max_restarts=1,
                       msg_slots=16),
    "fsync": RaftParams(n_servers=3, n_values=1, max_elections=1, max_restarts=1,
                        msg_slots=16, strict_send_once=True, has_pending_response=False,
                        trunc_term_mismatch=True, has_fsync=True,
                        fsync_leader_before_ae=True, fsync_leader_quorum=True,
                        fsync_follower_reply=True),
    "flexible": RaftParams(n_servers=3, n_values=2, max_elections=2, max_restarts=0,
                           msg_slots=16, election_quorum=2, replication_quorum=2,
                           strict_send_once=True, has_pending_response=False,
                           trunc_term_mismatch=True),
    # five servers: RequestVote chains S - 1 = 4 puts; FlexibleRaft at the
    # published quorums (ElectionQuorumSize 3, ReplicationQuorumSize 4)
    "five": RaftParams(n_servers=5, n_values=2, max_elections=2, max_restarts=0,
                       msg_slots=24),
    "flexible5": RaftParams(n_servers=5, n_values=2, max_elections=2, max_restarts=0,
                            msg_slots=24, election_quorum=3, replication_quorum=4,
                            strict_send_once=True, has_pending_response=False,
                            trunc_term_mismatch=True),
}


def _pair(name):
    jp = VARIANTS[name]
    jm = cached_model(jp)
    tm = TorchRaftModel(params_from_reference(dataclasses.asdict(jp)))
    states = collect_states(oracle_for(jp), 8, cap=120)
    batch = np.stack([jm.encode(s) for s in states]).astype(np.int32)
    return jm, tm, batch


@pytest.mark.parametrize("name", list(VARIANTS))
def test_expand_bit_identical(name):
    jm, tm, batch = _pair(name)
    assert tm.A == jm.A and tm.layout.W == jm.layout.W
    assert {k: (f.offset, f.shape) for k, f in tm.layout.fields.items()} == {
        k: (f.offset, f.shape) for k, f in jm.layout.fields.items()}
    want = [np.asarray(x) for x in jax.device_get(jm.expand(batch))]
    got = [x.numpy() for x in tm.expand(torch.from_numpy(batch))]
    for label, w, g in zip(("succs", "valid", "rank", "ovf"), want, got):
        assert w.shape == g.shape, label
        assert np.array_equal(w, g), label
    assert want[1].sum() > len(batch)  # the batch really has enabled actions


@pytest.mark.parametrize("name", list(VARIANTS))
def test_invariants_bit_identical(name):
    jm, tm, batch = _pair(name)
    succs = np.array(jax.device_get(jm.expand(batch))[0]).reshape(-1, jm.layout.W)
    for states in (batch, succs):
        for inv in jm.invariants:
            want = np.asarray(jm.invariants[inv](states))
            got = tm.invariants[inv](torch.from_numpy(states)).numpy()
            assert np.array_equal(want, got), inv


@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_decode_encode(name):
    jm, tm, batch = _pair(name)
    assert np.array_equal(jm.init_states(), tm.init_states())
    for row in batch[:40]:
        st = tm.decode(row)
        assert st == jm.decode(row)
        assert np.array_equal(tm.encode(st), row)
    assert [tm.action_label(0, c) for c in range(tm.A)] == [
        jm.action_label(0, c) for c in range(jm.A)]
