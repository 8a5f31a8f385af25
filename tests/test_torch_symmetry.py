"""The port's canonicalizer (raft_tpu_torch/ops/symmetry.py, plain PyTorch
version of the canon_memo kernel) against the JAX reference's
``Canonicalizer._fingerprints`` and ``fingerprints_memo``, bit for bit."""

import itertools

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models.raft import RaftParams, cached_model
from raft_tpu.ops.symmetry import Canonicalizer as JaxCanonicalizer
from raft_tpu.oracle.raft_oracle import oracle_for
from raft_tpu_torch.convert import fps_from_u64
from raft_tpu_torch.models.raft import RaftModel, RaftParams as TorchRaftParams
from raft_tpu_torch.ops.hashing import INT64_MAX
from raft_tpu_torch.ops.symmetry import Canonicalizer, permute_states

from conftest import collect_states

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

PARAMS = {
    2: dict(n_servers=2, n_values=2, max_elections=2, max_restarts=1, msg_slots=24),
    3: dict(n_servers=3, n_values=1, max_elections=2, max_restarts=0, msg_slots=16),
}


def _setup(S):
    jm = cached_model(RaftParams(**PARAMS[S]))
    tm = RaftModel(TorchRaftParams(**PARAMS[S]))
    states = collect_states(oracle_for(jm.p), 8, cap=100)
    return jm, tm, np.stack([jm.encode(s) for s in states]).astype(np.int32)


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("symmetry", [True, False])
def test_fingerprints_bit_identical(S, seed, symmetry):
    jm, tm, batch = _setup(S)
    jc = JaxCanonicalizer.for_model(jm, symmetry=symmetry, seed=seed)
    tc = Canonicalizer.for_model(tm, symmetry=symmetry, seed=seed)
    want = fps_from_u64(np.asarray(jax.device_get(jc.fingerprints(batch))))
    assert torch.equal(tc.canon_plain(torch.from_numpy(batch)), want)
    assert torch.equal(tc.fingerprints(torch.from_numpy(batch)), want)
    want_raw = fps_from_u64(np.asarray(jax.device_get(jc.raw_fingerprints(batch))))
    assert torch.equal(tc.raw_fingerprints(torch.from_numpy(batch)), want_raw)


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_memo_path_bit_identical(S, seed):
    jm, tm, batch = _setup(S)
    jc = JaxCanonicalizer.for_model(jm, symmetry=True, seed=seed)
    tc = Canonicalizer.for_model(tm, symmetry=True, seed=seed)
    valid = np.ones(len(batch), bool)
    valid[::5] = False
    jmemo = np.full((64, 2), np.uint64(0xFFFFFFFFFFFFFFFF))
    jfps, _, _ = jax.device_get(jc.fingerprints_memo(batch, valid, jmemo))
    tmemo = torch.full((64, 2), INT64_MAX, dtype=torch.int64)
    tb, tv = torch.from_numpy(batch), torch.from_numpy(valid)
    cold, cold_hits = tc.fingerprints_memo(tb, tv, tmemo)
    assert torch.equal(cold, fps_from_u64(np.asarray(jfps)))
    assert int(cold_hits) == 0
    # the second pass hits the rows the first one wrote, with equal values
    warm, warm_hits = tc.fingerprints_memo(tb, tv, tmemo)
    assert torch.equal(warm, cold) and int(warm_hits) > 0
    filled = tmemo[:, 0] != INT64_MAX
    assert int(filled.sum()) > 0  # every written row is a consistent (raw, fp) pair
    raw = tc.raw_fingerprints(tb)
    for key, fp in tmemo[filled].tolist():
        lane = int(torch.nonzero((raw == key) & tv)[0])
        assert fp == int(cold[lane])


@pytest.mark.parametrize("S", [2, 3])
def test_permuted_states_share_fingerprints(S):
    _, tm, batch = _setup(S)
    tc = Canonicalizer.for_model(tm, symmetry=True)
    base = tc.canon_plain(torch.from_numpy(batch))
    for sigma in itertools.permutations(range(S)):
        perm = permute_states(tm.layout, tm.packer, batch, sigma)
        assert torch.equal(tc.canon_plain(torch.from_numpy(perm)), base)
    plain = Canonicalizer.for_model(tm, symmetry=False)
    moved = permute_states(tm.layout, tm.packer, batch, np.roll(np.arange(S), 1))
    assert not torch.equal(plain.canon_plain(torch.from_numpy(moved)),
                           plain.canon_plain(torch.from_numpy(batch)))


def test_five_servers_with_symmetry():
    # five servers take the signature-admissible min (the reference's
    # tiers, ``prune``): equal to the JAX reference and orbit-invariant
    kw = dict(n_servers=5, n_values=1, max_elections=1, max_restarts=0, msg_slots=16)
    jm = cached_model(RaftParams(**kw))
    tm = RaftModel(TorchRaftParams(**kw))
    states = collect_states(oracle_for(jm.p), 4, cap=40)
    batch = np.stack([jm.encode(s) for s in states]).astype(np.int32)
    tc = Canonicalizer.for_model(tm, symmetry=True)
    assert tc.prune and tc.P == 120
    jc = JaxCanonicalizer.for_model(jm, symmetry=True)
    got = tc.fingerprints(torch.from_numpy(batch))
    assert torch.equal(got, fps_from_u64(np.asarray(jax.device_get(jc.fingerprints(batch)))))
    perm = permute_states(tm.layout, tm.packer, batch, [2, 0, 4, 1, 3])
    assert torch.equal(tc.fingerprints(torch.from_numpy(perm)), got)
    assert not Canonicalizer.for_model(tm, symmetry=False).prune  # the raw hash needs no tiers
