"""The five-server canonical fingerprint of the reconfiguration specs
(raft_tpu_torch/ops/symmetry.py and csrc/canon_tiers.cuh's general path:
N-word message keys, member-set bitmask fields, server-valued and
member-set fields of several lanes a server) against the JAX reference,
bit for bit (tolerance: none; every value is an integer or a hash).

The reference's ``Canonicalizer._signatures`` reads a server-valued or
member-set field as one lane a server and raises on these layouts' log
fields (r lanes a server). The port signs such a field as r one-lane
fields, the c-th holding lane c of each server's row under the salt offset
off + c * S (``split_fields``); the reference's own ``_signatures`` on the
view with those lanes regrouped into r S-lane fields (``split_signatures``,
the same wrapping scripts/pin_reconfig_counts.py applies) is the reference
the port's signatures are held to. The canonical fingerprint is the min of
the reference's hash of the materialized permuted view (``_perm_hash``)
over the permutations that sort those signatures, at fingerprint seeds 0
and 0x5EED5EED.

The samples are reachable states of five-server RaftWithReconfigAddRemove
(MaxAddReconfigs 2, MaxClusterSize 5) and RaftWithReconfigJointConsensus
(MaxReconfigs 2) from the reference's oracle (breadth first near Init,
then random walks 18 steps deep), and their server-permuted copies.
"""

import functools
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from raft_tpu.models import joint_raft as ref_joint
from raft_tpu.models import reconfig_raft as ref_ar
from raft_tpu.ops.symmetry import Canonicalizer as JaxCanonicalizer
from raft_tpu_torch.convert import fps_from_u64
from raft_tpu_torch.ops.hashing import INT64_MAX
from raft_tpu_torch.ops.symmetry import (
    TIER_HEADER, Canonicalizer, msg_perm_spec, permute_states,
)

from conftest import collect_states
from test_torch_canon_tiers import _host_run, lib  # noqa: F401 (the host-compiled device code)
from test_torch_reconfig import _models, _oracle

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)

# chip_smoke.py's ADDREMOVE5_CFG and JOINT5_CFG at 24 message slots (the
# walks' bags hold at most a dozen records)
PARAMS5 = {
    "reconfig": ref_ar.ReconfigRaftParams(
        n_servers=5, n_values=1, init_cluster_size=3, max_elections=1, max_restarts=0,
        max_values_per_term=1, max_add_reconfigs=2, max_remove_reconfigs=1,
        min_cluster_size=2, max_cluster_size=5, msg_slots=24),
    "joint": ref_joint.JointRaftParams(
        n_servers=5, n_values=1, init_cluster_size=3, max_elections=1, max_restarts=0,
        max_reconfigs=2, max_values_per_term=1, reconfig_type=2, msg_slots=24),
}
SEEDS = (0, 0x5EED5EED)
CASES = [(n, s) for n in PARAMS5 for s in SEEDS]
IDS = [f"{n}-seed{s:x}" for n, s in CASES]


def split_signatures(orig):
    """Wrap the reference's ``Canonicalizer._signatures``: a field of r > 1
    lanes a server is read as r one-lane fields, its own code run on the
    view with lane c of each server's row regrouped at off + c * S (the
    wrapping scripts/pin_reconfig_counts.py applies)."""

    def signatures(self, view, rounds=None):
        S = self.S
        order = np.arange(view.shape[1])
        fields = []
        for kind, off, shape, size in self._view_fields:
            if kind in ("per_server_val", "server_bitmask") and size > S:
                r = size // S
                fields += [(kind, off + c * S, (S,), S) for c in range(r)]
                order[off:off + size] = off + np.arange(size).reshape(S, r).T.reshape(-1)
            else:
                fields.append((kind, off, shape, size))
        saved, self._view_fields = self._view_fields, fields
        try:
            return orig(self, view[:, order], rounds)
        finally:
            self._view_fields = saved

    return signatures


def split_reference(jc):
    """The reference canonicalizer ``jc`` with split signatures."""
    jc._signatures = types.MethodType(split_signatures(type(jc)._signatures), jc)
    return jc


@functools.lru_cache(maxsize=None)
def _sample(name):
    """(JAX model, port model, states, permuted states)."""
    jp = PARAMS5[name]
    jm, tm = _models(jp)
    oracle = _oracle(jp)
    rng = np.random.default_rng(1)
    states = collect_states(oracle, 10, cap=40)
    for _ in range(24):
        s = oracle.init_state()
        for d in range(18):
            succ = oracle.successors(s)
            if not succ:
                break
            s = succ[rng.integers(len(succ))][1]
            if d % 3 == 2:
                states.append(s)
    base = np.stack([jm.encode(s) for s in states]).astype(np.int32)
    sigmas = [np.asarray(p) for p in itertools.permutations(range(5))][1:]
    pick = rng.choice(len(sigmas), 12, replace=False)
    perm = np.concatenate([
        permute_states(tm.layout, tm.packer, part, sigmas[k], msg_perm_spec(tm))
        for part, k in zip(np.array_split(base, len(pick)), pick)])
    return jm, tm, np.ascontiguousarray(base), np.ascontiguousarray(perm)


def _batch(name) -> np.ndarray:
    _jm, _tm, base, perm = _sample(name)
    return np.concatenate([base, perm])


@functools.lru_cache(maxsize=None)
def _ref_signatures(name) -> torch.Tensor:
    """The split reference's signatures of _batch(name) (enc int64; they do
    not depend on the fingerprint seed)."""
    jm = _sample(name)[0]
    jc = split_reference(JaxCanonicalizer.for_model(jm, symmetry=True, seed=0))
    view = jax.numpy.asarray(_batch(name)[:, :jc.VL])
    return fps_from_u64(np.asarray(jax.device_get(jc._signatures(view))))


@functools.lru_cache(maxsize=None)
def _ref_fps(name, seed) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw keys, canonical fingerprints) of _batch(name) by the reference:
    its raw view hash, and the min of its hash of each permuted view over
    the permutations that sort the signatures ascending."""
    jm, tm = _sample(name)[:2]
    jc = JaxCanonicalizer.for_model(jm, symmetry=True, seed=seed)
    batch = _batch(name)
    perms = np.array(list(itertools.permutations(range(5))))
    sig = _ref_signatures(name).numpy()
    ssig = sig[:, np.argsort(perms, axis=1)]  # [B, P, S]: the signature landing at each index
    adm = (ssig[..., 1:] >= ssig[..., :-1]).all(-1)
    rows, lane = [], []
    for p in range(len(perms)):
        idx = np.nonzero(adm[:, p])[0]
        if len(idx):
            rows.append(permute_states(tm.layout, tm.packer, batch[idx], perms[p],
                                       msg_perm_spec(tm)))
            lane.append(idx)
    rows, lane = np.concatenate(rows), np.concatenate(lane)
    h = fps_from_u64(np.asarray(jax.device_get(jax.jit(jc._perm_hash)(rows[:, :jc.VL]))))
    canon = torch.full((len(batch),), INT64_MAX, dtype=torch.int64)
    canon.scatter_reduce_(0, torch.from_numpy(lane), h, reduce="amin")
    raw = fps_from_u64(np.asarray(jax.device_get(jc.raw_fingerprints(batch))))
    return raw, canon


def _port(name, seed=0) -> Canonicalizer:
    return Canonicalizer.for_model(_sample(name)[1], seed=seed)


def test_reference_signatures_refuse_multi_lane_fields():
    # the reason for split_fields: the reference's own _signatures cannot
    # read a log field of five lanes a server
    jm = _sample("reconfig")[0]
    jc = JaxCanonicalizer.for_model(jm, symmetry=True, seed=0)
    with pytest.raises((TypeError, ValueError), match="broadcast"):
        jc._signatures(jax.numpy.asarray(_batch("reconfig")[:8, :jc.VL]))


@pytest.mark.parametrize("name", list(PARAMS5))
def test_layout_takes_the_general_path(name):
    tc = _port(name)
    spec = tc.tier_spec()
    hdr = dict(zip(TIER_HEADER, spec[:len(TIER_HEADER)].tolist()))
    assert tc.prune and hdr["general"] == 1 and hdr["len"] == len(spec)
    assert hdr["n_words"] == _sample(name)[1].n_words
    assert hdr["n_fields"] == len(tc.spec) > 4
    assert any(k == "server_bitmask" for _f, k in tc.spec)


@pytest.mark.parametrize("name", list(PARAMS5))
def test_signatures_match_split_reference(name):
    got = _port(name).signatures(torch.from_numpy(_batch(name)))
    assert torch.equal(got, _ref_signatures(name))


@pytest.mark.parametrize("name", list(PARAMS5))
def test_signatures_equivariant(name):
    # sig(perm(x))[sigma[i]] == sig(x)[i]
    _jm, tm, base, _perm = _sample(name)
    tc = _port(name)
    sig = tc.signatures_plain(torch.from_numpy(base))
    for sigma in ([1, 2, 3, 4, 0], [4, 3, 2, 1, 0], [0, 2, 1, 4, 3]):
        psig = tc.signatures_plain(torch.from_numpy(
            permute_states(tm.layout, tm.packer, base, sigma, msg_perm_spec(tm))))
        assert torch.equal(psig[:, sigma], sig)


@pytest.mark.parametrize("name,seed", CASES, ids=IDS)
def test_canon_and_memo_match_reference(name, seed):
    tc = _port(name, seed)
    batch = torch.from_numpy(_batch(name))
    raw, want = _ref_fps(name, seed)
    assert torch.equal(tc.raw_fingerprints(batch), raw)
    got = tc.canon_plain(batch)
    assert torch.equal(got, want)
    n = len(batch) // 2  # permuted copies share the fingerprints of their originals
    assert torch.equal(got[:n], got[n:]) and len(set(got[:n].tolist())) > n // 3
    # the memo path: cold, then warm (a 256-row table; the highest lane wins)
    memo = torch.full((256, 2), INT64_MAX, dtype=torch.int64)
    valid = torch.from_numpy(np.arange(len(batch)) % 7 != 3)
    hits = []
    for _ in range(2):
        fps, n_hit = tc.fingerprints_memo_plain(batch, valid, memo)
        assert torch.equal(fps, torch.where(valid, want, INT64_MAX))
        hits.append(int(n_hit))
    assert hits[0] < hits[1]


def test_sample_has_ties_and_member_sets():
    # lanes whose signatures tie (several admissible permutations) and
    # lanes totally ordered; bags holding member-set records
    for name in PARAMS5:
        _jm, tm, base, _perm = _sample(name)
        sig = _ref_signatures(name)[:len(base)]
        ties = (sig.sort(dim=1).values.diff(dim=1) == 0).any(dim=1)
        assert 0 < int(ties.sum()) < len(base)
        words = tuple(tm.layout.get(base, f"msg_w{k}") for k in range(tm.n_words))
        occ = words[0] != (1 << 30)
        bm = [f for f, kind in msg_perm_spec(tm) if kind == "server_bitmask"]
        assert sum(int(((tm.packer.unpack(words, f) > 0) & occ).sum()) for f in bm) > 20


@pytest.mark.parametrize("name,seed", CASES, ids=IDS)
def test_host_compiled_tiers_match_reference(lib, name, seed):  # noqa: F811
    sig, raw, canon = _host_run(lib, _port(name, seed), _batch(name))
    ref_raw, ref_canon = _ref_fps(name, seed)
    assert torch.equal(sig, _ref_signatures(name))
    assert torch.equal(raw, ref_raw)
    assert torch.equal(canon, ref_canon)


@pytest.mark.parametrize("G", [1, 4, 8, 32])
@pytest.mark.parametrize("name", list(PARAMS5))
def test_host_group_shares_match_reference(lib, name, G):  # noqa: F811
    # the general build's group (G = 16 threads on the card) splits every
    # hash and signature sum over G shares; combined they equal the
    # reference's bits
    sig, raw, canon = _host_run(lib, _port(name, 0), _batch(name), G)
    ref_raw, ref_canon = _ref_fps(name, 0)
    assert torch.equal(sig, _ref_signatures(name))
    assert torch.equal(raw, ref_raw)
    assert torch.equal(canon, ref_canon)


@pytest.mark.parametrize("name", list(PARAMS5))
def test_canon_without_the_bitmask_remap_differs(name):
    """The remap matters at five servers too: a canon that treats the
    member sets as opaque fields splits some permuted pair."""
    _jm, tm, base, perm = _sample(name)
    spec = tuple((f, k) for f, k in msg_perm_spec(tm) if k != "server_bitmask")
    plain = Canonicalizer(tm.layout, tm.packer, spec=spec)
    a, b = (plain.canon_plain(torch.from_numpy(x)) for x in (base, perm))
    assert not torch.equal(a, b)
