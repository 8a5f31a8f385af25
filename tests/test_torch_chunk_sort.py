"""The port's per-chunk sort (raft_tpu_torch/checker/util.py
chunk_sort_plain, and chunk_dedup, which probes the runs first) against
the JAX reference's formulas: the first occurrence of _st_dedup
(raft_tpu/checker/device_bfs.py:413-420, ``sort_u64_with_idx``) and the
R0 run emit of _st_finish (:495, ``sort_u64``), bit for bit, on chunks
with many duplicates and sentinel lanes. A numpy replay of one sort of
(key, lane) pairs must give the same answer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.hashing import U64_MAX, ne_u64, sort_u64, sort_u64_with_idx
from raft_tpu_torch.checker.util import chunk_dedup, chunk_sort_plain
from raft_tpu_torch.convert import fps_from_u64
from raft_tpu_torch.ops.hashing import INT64_MAX

# one intra-op thread: tier-1 runs several test workers side by side, and
# torch's default thread pool per worker oversubscribes the CPU
torch.set_num_threads(1)


def _chunk(n: int, seed: int):
    """u64 fingerprints drawn from a small pool (many duplicates, values
    across the whole u64 range, both halves of the sign split) with
    U64_MAX sentinel lanes, a seen run holding about 30% of the pool
    (U64_MAX-padded) and the fresh mask it gives: real and not seen."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, max(1, n // 4), dtype=np.uint64)
    pool[: len(pool) // 8] = np.uint64(0)  # u64 0 and its neighbours
    fps = pool[rng.integers(0, len(pool), n)]
    fps[rng.random(n) < 0.1] = U64_MAX
    seen = np.unique(pool[rng.random(len(pool)) < 0.3])
    seen = seen[seen != U64_MAX]
    run = np.concatenate([seen, np.full(len(seen) // 2 + 1, U64_MAX, np.uint64)])
    fresh = (fps != U64_MAX) & ~np.isin(fps, seen)
    return fps, fresh, run


def _reference(fps, fresh, run_len):
    rf, order = sort_u64_with_idx(jnp.asarray(fps))
    first_s = jnp.concatenate([jnp.ones((1,), bool), ne_u64(rf[1:], rf[:-1])])
    first = jnp.zeros(len(fps), bool).at[order].set(first_s)
    new = jnp.asarray(fresh) & first
    run = sort_u64(jnp.where(new, jnp.asarray(fps), U64_MAX))
    new, run = jax.device_get((new, run))
    run = np.concatenate([run, np.full(run_len - len(fps), U64_MAX, np.uint64)])
    return torch.from_numpy(np.array(new)), fps_from_u64(run)


def _one_sort(fps, fresh, run_len):
    """The kernel's design in numpy: one sort of (key, lane) pairs; new
    where the key differs from its left neighbour and the lane is fresh;
    the run compacts the sorted keys of the new lanes."""
    order = np.lexsort((np.arange(len(fps)), fps))
    sk = fps[order]
    first_s = np.ones(len(fps), bool)
    first_s[1:] = sk[1:] != sk[:-1]
    ns = first_s & fresh[order]
    new = np.zeros(len(fps), bool)
    new[order] = ns
    run = np.full(run_len, U64_MAX, np.uint64)
    run[: ns.sum()] = sk[ns]
    return torch.from_numpy(new), fps_from_u64(run)


@pytest.mark.parametrize("n,run_len,seed", [(1, 1, 0), (2048, 2048, 1), (5000, 8192, 2),
                                            (65536, 65536, 3)])
def test_chunk_sort_matches_reference(n, run_len, seed):
    fps, fresh, seen = _chunk(n, seed)
    want_new, want_run = _reference(fps, fresh, run_len)
    t_fps, t_fresh = fps_from_u64(fps), torch.from_numpy(fresh)
    for new, run in (chunk_sort_plain(t_fps, t_fresh, run_len),
                     chunk_dedup(t_fps, [fps_from_u64(seen)], run_len)):
        assert torch.equal(new, want_new) and torch.equal(run, want_run)
    new, run = _one_sort(fps, fresh, run_len)
    assert torch.equal(new, want_new) and torch.equal(run, want_run)
    assert int(want_new.sum()) < n or n == 1  # the duplicates were found


def test_chunk_sort_all_equal_and_all_sentinel():
    for v in (np.uint64(12345), U64_MAX):
        fps = np.full(3000, v, np.uint64)
        fresh = np.full(3000, v != U64_MAX)
        for new, run in (chunk_sort_plain(fps_from_u64(fps), torch.from_numpy(fresh), 4096),
                         chunk_dedup(fps_from_u64(fps), [], 4096)):
            assert int(new.sum()) == int(v != U64_MAX) and bool(new[0]) == (v != U64_MAX)
            assert int((run != INT64_MAX).sum()) == int(v != U64_MAX)


def test_chunk_sort_refuses_a_short_run():
    fps, _fresh, seen = _chunk(100, 4)
    with pytest.raises(ValueError, match="run_len"):
        chunk_dedup(fps_from_u64(fps), [fps_from_u64(seen)], 50)
