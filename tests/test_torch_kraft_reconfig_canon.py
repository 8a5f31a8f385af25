"""The port's slot canonicalizer (raft_tpu_torch/ops/slot_canon.py: the plain
version of the slot_canon kernel) against the reference's
``SlotCanonicalizer`` (raft_tpu/models/kraft_reconfig.py:2017), on the CPU
(tolerance: none; fingerprints are integers):

  - fingerprints equal the reference's on reachable states and their
    successors, at the SMALLP constants and at the full cfg's (12 (sigma,
    tau) pairs), symmetry on and off, at seed 0 and a nonzero seed;
  - a host- and value-permuted copy (a pair's remapped, slot-sorted rows)
    keeps its fingerprint, in both packages;
  - each remap kind is needed: a canon that leaves out the slot + 1
    reference map, the bitmask map, the endOffset axes or the value map tau
    splits some permuted pair (no message remap crashes anything, so only
    such a test shows one missing).
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu_torch.convert import fps_to_u64

from test_torch_kraft_reconfig import _pair, reachable

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)


def _rows(name):
    jm, tm, batch = reachable(name)
    if name == "small":
        _jm, _tm, _b, (succs, valid, _r, _o) = _pair()
        batch = np.concatenate([batch, succs[valid][::3]])
    return jm, tm, np.ascontiguousarray(batch)


@pytest.mark.parametrize("name", ["small", "full"])
@pytest.mark.parametrize("symmetry", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_fingerprints_match_reference(name, symmetry, seed):
    jm, tm, rows = _rows(name)
    want = np.asarray(jax.device_get(jm.make_canonicalizer(symmetry, seed=seed).fingerprints(
        rows)))
    canon = tm.make_canonicalizer(symmetry, seed=seed)
    assert canon.P == (12 if name == "full" and symmetry else 6 if symmetry else 1)
    got = canon.fingerprints(torch.from_numpy(rows))
    assert np.array_equal(fps_to_u64(got), want)
    valid = torch.from_numpy(np.arange(len(rows)) % 3 != 0)
    masked = canon.fingerprints(torch.from_numpy(rows), valid)
    assert torch.equal(masked[valid], got[valid]) and (masked[~valid] == (1 << 63) - 1).all()


def _copies(tm, rows):
    """Each reachable row under each (sigma, tau) pair: the pair's
    remapped, slot-sorted rows (a relabeled state)."""
    canon = tm.make_canonicalizer(True)
    st = torch.from_numpy(rows)
    return [canon.canon_rows(st, k) for k in range(canon.P)]


@pytest.mark.parametrize("name", ["small", "full"])
def test_permuted_copies_keep_fingerprints(name):
    jm, tm, rows = _rows(name)
    canon = tm.make_canonicalizer(True)
    fps = canon.fingerprints(torch.from_numpy(rows))
    ref = jm.make_canonicalizer(True)
    for k, copy in enumerate(_copies(tm, rows)):
        assert torch.equal(canon.fingerprints(copy), fps), k
        assert np.array_equal(np.asarray(jax.device_get(ref.fingerprints(copy.numpy()))),
                              fps_to_u64(fps)), k
    assert len(set(fps.tolist())) > len(rows) // 2


@pytest.mark.parametrize("kind", ["refmap", "maskmap", "endOffset", "tau"])
def test_each_remap_kind_is_needed(kind):
    """A canon without one remap kind gives some permuted copy of a full-cfg
    reachable state another fingerprint than the state's."""
    _jm, tm, rows = _rows("full")
    copies = _copies(tm, rows)
    canon = tm.make_canonicalizer(True)
    if kind == "refmap":
        canon.refmap = lambda x, inv: x
    elif kind == "maskmap":
        canon.maskmap = lambda mask, order: mask
    elif kind == "endOffset":
        canon.eo_perm = lambda eo, order: eo
    else:
        canon.valmap = lambda val, cmd, tau: val
        canon.tauperm = lambda acked, tau: acked
    fps = canon.fingerprints(torch.from_numpy(rows))
    split = sum(int((canon.fingerprints(c) != fps).sum()) for c in copies)
    assert split > 0, kind
